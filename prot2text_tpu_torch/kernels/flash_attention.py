"""K1: bias-free masked flash-attention forward (CUDA C++, sm_90a).

Replaces prot2text_tpu/kernels/flash_attention.py `flash_attention_masked`
(forward: `_fwd_masked_kernel` / `_flash_masked_fwd_impl`).  The kernel is
`csrc/flash_attention.cu`; its header states what bounds it on the card and
what the design does about that.  `flash_attention_masked_plain` is the
plain PyTorch version of the same function: CPU tensors run it, and the
chip smoke test holds the kernel against it.

Contract (as the JAX kernel): q (B, H, Sq, D) pre-scaled; k, v (B, Hkv, Skv,
D) with Hkv dividing H; kv_start/kv_len (B,) int32 — the valid keys of row
b are [kv_start[b], kv_start[b] + kv_len[b]), and `causal` additionally
requires col <= row on sequence index.  Masked weights are exactly 0; a row
with no valid key gives o = 0 and lse = -1e30.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_masked_plain(q, k, v, kv_start, kv_len, causal=False):
    """Plain PyTorch K1 → (o (B, H, Sq, D) in q's dtype, lse (B, H, Sq) f32).
    fp32 logits, -1e30 masking, weights rounded to v's dtype before P·V."""
    B, H, Sq, _ = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rep = H // Hkv
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.repeat_interleave(rep, dim=1)
    logits = torch.matmul(q.float(), kf.transpose(-1, -2))   # (B,H,Sq,Skv)
    cols = torch.arange(Skv, device=q.device)
    start = kv_start.to(torch.int64)[:, None]
    ok = (cols >= start) & (cols < start + kv_len.to(torch.int64)[:, None])
    ok = ok[:, None, None, :]
    if causal:
        rows = torch.arange(Sq, device=q.device)
        ok = ok & (cols[None, :] <= rows[:, None])[None, None]
    logits = torch.where(ok, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0.0, 1.0, l)
    o = torch.matmul(p.to(v.dtype).float(), vf.float()) / safe
    lse = (m + torch.log(safe))[..., 0]
    return o.to(q.dtype), lse


def _check(q, k, v, kv_start, kv_len):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"K1 kernel needs CUDA tensors, got {dev}")
    for name, t in (("k", k), ("v", v), ("kv_start", kv_start),
                    ("kv_len", kv_len)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K1 takes bfloat16 or float32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if D not in HEAD_DIMS:
        raise ValueError(f"K1 head_dim must be one of {HEAD_DIMS}, got {D}")
    if Sq == 0 or k.shape[2] == 0:
        raise ValueError("empty sequence")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous head dim")
    for name, t in (("kv_start", kv_start), ("kv_len", kv_len)):
        if t.dtype != torch.int32 or t.shape != (B,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B,) int32 tensor")


def flash_attention_masked_fwd(q, k, v, kv_start, kv_len, *,
                               causal: bool = False):
    """K1 → (o (B, H, Sq, D), lse (B, H, Sq) f32).  CPU tensors run the
    plain version; CUDA tensors launch the kernel (or raise).  On CUDA, o
    is a (B, H, Sq, D) view of a (B, Sq, H, D) buffer, so the caller's
    transpose back to (B, Sq, H*D) is free."""
    if q.device.type == "cpu":
        return flash_attention_masked_plain(q, k, v, kv_start, kv_len, causal)
    _check(q, k, v, kv_start, kv_len)
    B, H, Sq, D = q.shape
    o = torch.empty((B, Sq, H, D), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *o.stride()[:3])
    lib = _build.library()
    err = lib.p2t_flash_masked_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_start.data_ptr(),
        kv_len.data_ptr(), o.data_ptr(), lse.data_ptr(),
        ctypes.addressof(strides), B, H, k.shape[1], Sq, k.shape[2], D,
        int(causal), _build.dtype_code(q.dtype), _build.stream_of(q))
    _build.check(err, "p2t_flash_masked_fwd")
    flash_attention_masked_fwd.launches += 1
    return o, lse


flash_attention_masked_fwd.launches = 0


def flash_attention_masked(q, k, v, kv_start, kv_len, *,
                           causal: bool = False):
    """K1's output only (the JAX `flash_attention_masked` forward)."""
    return flash_attention_masked_fwd(q, k, v, kv_start, kv_len,
                                      causal=causal)[0]
