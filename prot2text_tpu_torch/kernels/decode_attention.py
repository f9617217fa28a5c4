"""K2: grouped-query decode attention over the stacked KV cache (CUDA C++).

Replaces prot2text_tpu/kernels/decode_attention.py `decode_attention_stacked`
(`_kernel`).  The kernel is `csrc/decode_attention.cu`; its header states
what bounds it (cache bytes), what the design does about that, and its known
limit (B*Hkv blocks underfill the SMs; split-T is the next step).
`decode_attention_stacked_plain` is the plain PyTorch version.

Contract (as the JAX kernel): qg (B, Hkv, rep, D) pre-scaled; ck_all/cv_all
(L, B, Hkv, T, D) read-only; kv_mask (B, T) 0/1 over already-written slots;
k_new/v_new (B, Hkv, D) the current token, folded in as one extra logit
column; `layer` a host int.  Returns (B, Hkv, rep, D) in qg's dtype.
"""

from __future__ import annotations

import torch

from . import _build

NEG = float(torch.finfo(torch.float32).min)
HEAD_DIMS = (16, 32, 64, 128)
MAX_REP = 8


def decode_attention_stacked_plain(qg, ck_all, cv_all, kv_mask, k_new, v_new,
                                   layer: int):
    ck = ck_all[layer].float()
    cv = cv_all[layer]
    q = qg.float()
    logits = torch.einsum("bkrd,bktd->bkrt", q, ck)
    logits = torch.where(kv_mask[:, None, None, :] > 0, logits, NEG)
    ln = (q * k_new.float()[:, :, None, :]).sum(dim=-1)       # (B, Hkv, rep)
    m = torch.maximum(logits.amax(dim=-1), ln)
    el = torch.exp(logits - m[..., None])
    en = torch.exp(ln - m)
    denom = el.sum(dim=-1) + en
    a = torch.einsum("bkrt,bktd->bkrd", el.to(cv.dtype).float(), cv.float())
    a = a + en[..., None] * v_new.float()[:, :, None, :]
    return (a / denom[..., None]).to(qg.dtype)


def _check(qg, ck_all, cv_all, kv_mask, k_new, v_new, layer):
    dev = qg.device
    if dev.type != "cuda":
        raise ValueError(f"K2 kernel needs CUDA tensors, got {dev}")
    ts = (("ck_all", ck_all), ("cv_all", cv_all), ("kv_mask", kv_mask),
          ("k_new", k_new), ("v_new", v_new))
    for name, t in ts:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, qg on {dev}")
    if qg.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K2 takes bfloat16 or float32, got {qg.dtype}")
    for name, t in (("ck_all", ck_all), ("cv_all", cv_all),
                    ("k_new", k_new), ("v_new", v_new)):
        if t.dtype != qg.dtype:
            raise TypeError(f"{name} is {t.dtype}, qg is {qg.dtype}")
    if qg.dim() != 4 or ck_all.dim() != 5 or cv_all.shape != ck_all.shape:
        raise ValueError("qg must be (B, Hkv, rep, D) and ck_all/cv_all "
                         "(L, B, Hkv, T, D) alike")
    L, B, Hkv, T, D = ck_all.shape
    rep = qg.shape[2]
    if qg.shape != (B, Hkv, rep, D):
        raise ValueError(f"qg {tuple(qg.shape)} vs cache "
                         f"{tuple(ck_all.shape)}")
    if k_new.shape != (B, Hkv, D) or v_new.shape != (B, Hkv, D):
        raise ValueError("k_new/v_new must be (B, Hkv, D)")
    if kv_mask.shape != (B, T) or kv_mask.dtype != torch.int32:
        raise ValueError("kv_mask must be (B, T) int32")
    if D not in HEAD_DIMS or not 1 <= rep <= MAX_REP:
        raise ValueError(f"K2 takes head_dim in {HEAD_DIMS} and 1..{MAX_REP} "
                         f"query heads per kv head, got D={D} rep={rep}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    for name, t in (("qg", qg),) + ts:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ck_all.data_ptr() % 16 or cv_all.data_ptr() % 16:
        raise ValueError("cache buffers must be 16-byte aligned")


def decode_attention_stacked(qg, ck_all, cv_all, kv_mask, k_new, v_new,
                             layer: int):
    """K2.  CPU tensors run the plain version; CUDA tensors launch the
    kernel (or raise).  Layer `layer` is read in place by pointer offset."""
    if qg.device.type == "cpu":
        return decode_attention_stacked_plain(qg, ck_all, cv_all, kv_mask,
                                              k_new, v_new, layer)
    layer = int(layer)
    _check(qg, ck_all, cv_all, kv_mask, k_new, v_new, layer)
    L, B, Hkv, T, D = ck_all.shape
    out = torch.empty_like(qg)
    off = layer * ck_all.stride(0) * ck_all.element_size()
    lib = _build.library()
    err = lib.p2t_decode_attention(
        qg.data_ptr(), ck_all.data_ptr() + off, cv_all.data_ptr() + off,
        kv_mask.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        out.data_ptr(), B, Hkv, qg.shape[2], T, D,
        _build.dtype_code(qg.dtype), _build.stream_of(qg))
    _build.check(err, "p2t_decode_attention")
    decode_attention_stacked.launches += 1
    return out


decode_attention_stacked.launches = 0
