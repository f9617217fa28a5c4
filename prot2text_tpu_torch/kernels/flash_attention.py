"""K1 and K5: bias-free masked flash attention, forward and backward; K6:
flash attention with an additive bias, forward (CUDA C++, sm_90a).

Replaces prot2text_tpu/kernels/flash_attention.py `flash_attention_masked`:
K1 is its forward (`_fwd_masked_kernel` / `_flash_masked_fwd_impl`), kernel
`csrc/flash_attention.cu`; K5 its backward (`_flash_masked_bwd_impl` with
`_bwd_masked_dq_kernel` / `_bwd_masked_dkv_kernel`), kernel
`csrc/flash_attention_bwd.cu` (bf16 over the tensor-core body
`csrc/flash_attention_bwd.cuh`, f32 on a SIMT body).  Each header states
what bounds the kernel on the card and what the design does about that.
`flash_attention_masked_plain` / `flash_attention_masked_bwd_plain` are the
plain PyTorch versions of the same functions: CPU tensors run them, and the
chip smoke test holds the kernels against them.  `flash_attention_masked`
is differentiable: a `torch.autograd.Function` whose forward is K1 and whose
backward is K5, as the JAX `custom_vjp` pairs the two Pallas kernels.

K6 replaces the forward of `flash_attention_tpu` (`_fwd_kernel` /
`_flash_fwd`), kernel `csrc/flash_attention_bias.cu`: attention through an
explicit fp32 bias (the serving prefix install over [seeded prefix ‖
suffix] cache columns; the ESMC encoder under `attn_impl="flash"`).  K6b
replaces its backward (`_flash_bwd` with `_bwd_dq_kernel` /
`_bwd_dkv_kernel`), kernel `csrc/flash_attention_bias_bwd.cu`.
`flash_attention_bias` pairs the two in a `torch.autograd.Function`, as the
JAX `custom_vjp` does; the bias gets no gradient.

Contract of K1/K5 (as the JAX kernel): q (B, H, Sq, D) pre-scaled; k, v (B,
Hkv, Skv, D) with Hkv dividing H; kv_start/kv_len (B,) int32 — the valid
keys of row b are [kv_start[b], kv_start[b] + kv_len[b]), and `causal`
additionally requires col <= row on sequence index. Masked weights are
exactly 0; a row with no valid key gives o = 0 and lse = -1e30.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)


def _visible(kv_start, kv_len, Sq, Skv, causal, device):
    """(B, 1, Sq|1, Skv) bool: key col lies in row b's run [and col <= row]."""
    cols = torch.arange(Skv, device=device)
    start = kv_start.to(torch.int64)[:, None]
    ok = (cols >= start) & (cols < start + kv_len.to(torch.int64)[:, None])
    ok = ok[:, None, None, :]
    if causal:
        rows = torch.arange(Sq, device=device)
        ok = ok & (cols[None, :] <= rows[:, None])[None, None]
    return ok


def flash_attention_masked_plain(q, k, v, kv_start, kv_len, causal=False):
    """Plain PyTorch K1 → (o (B, H, Sq, D) in q's dtype, lse (B, H, Sq) f32).
    fp32 logits, -1e30 masking, weights rounded to v's dtype before P·V."""
    B, H, Sq, _ = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rep = H // Hkv
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.repeat_interleave(rep, dim=1)
    logits = torch.matmul(q.float(), kf.transpose(-1, -2))   # (B,H,Sq,Skv)
    ok = _visible(kv_start, kv_len, Sq, Skv, causal, q.device)
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
        raise ValueError(f"K1/K5 need CUDA tensors, got {dev}")
    for name, t in (("k", k), ("v", v), ("kv_start", kv_start),
                    ("kv_len", kv_len)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K1/K5 take bfloat16 or float32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if D not in HEAD_DIMS:
        raise ValueError(f"K1/K5 head_dim must be one of {HEAD_DIMS}, got {D}")
    if Sq == 0 or k.shape[2] == 0:
        raise ValueError("empty sequence")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous head dim")
    for name, t in (("kv_start", kv_start), ("kv_len", kv_len)):
        if t.dtype != torch.int32 or t.shape != (B,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B,) int32 tensor")


def _aligned16(t) -> bool:
    """The base pointer and each (batch, head, sequence) stride of t are
    multiples of 16 bytes."""
    isz = t.element_size()
    return t.data_ptr() % 16 == 0 and not any(s * isz % 16
                                              for s in t.stride()[:3])


def _check_aligned(what, **tensors):
    """The bf16 tensor-core bodies (csrc/flash_attention_fwd.cuh, K5's
    csrc/flash_attention_bwd.cuh) copy q, k and v in 16-byte chunks
    (cp.async): each base pointer and each (batch, head, sequence) stride
    must be a multiple of 16 bytes."""
    for name, t in tensors.items():
        isz = t.element_size()
        if not _aligned16(t):
            raise ValueError(
                f"{what}: bf16 {name} must be 16-byte aligned (data_ptr % 16 "
                f"= {t.data_ptr() % 16}, strides {tuple(t.stride())} of "
                f"{isz}-byte elements)")


def flash_attention_masked_fwd(q, k, v, kv_start, kv_len, *,
                               causal: bool = False):
    """K1 → (o (B, H, Sq, D), lse (B, H, Sq) f32).  CPU tensors run the
    plain version; CUDA tensors launch the kernel (or raise): bf16 the
    tensor-core body, which needs q/k/v 16-byte aligned, f32 the SIMT body.
    On CUDA, o is a (B, H, Sq, D) view of a (B, Sq, H, D) buffer, so the
    caller's transpose back to (B, Sq, H*D) is free."""
    if q.device.type == "cpu":
        return flash_attention_masked_plain(q, k, v, kv_start, kv_len, causal)
    _check(q, k, v, kv_start, kv_len)
    if q.dtype == torch.bfloat16:
        _check_aligned("K1", q=q, k=k, v=v)
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


def flash_attention_masked_bwd_plain(q, k, v, o, lse, do, kv_start, kv_len,
                                     causal=False):
    """Plain PyTorch K5 → (dq, dk, dv) in the inputs' dtypes: P recomputed
    in fp32 from the lse and masked explicitly, Δ = rowsum(dO∘O), dS =
    P∘(dP − Δ); dk/dv are computed per query head (repeat_kv) and summed
    over each GQA group."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rep = H // Hkv
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    logits = torch.matmul(qf, kf.transpose(-1, -2))          # (B,H,Sq,Skv)
    ok = _visible(kv_start, kv_len, Sq, Skv, causal, q.device)
    p = torch.where(ok, torch.exp(logits - lse[..., None]), 0.0)
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = dk.view(B, Hkv, rep, Skv, D).sum(dim=2)
    dv = dv.view(B, Hkv, rep, Skv, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _grad_operand(do):
    """dO as K5 reads it.  Autograd may hand over any view: the expanded
    gradient of a sum, or a slice off a 16-byte boundary.  A head dim that
    is not contiguous, or a bf16 view the tensor-core body cannot copy in
    16-byte chunks (cp.async), is copied into a fresh (B, H, S, D) buffer;
    any other view is taken as it is."""
    if do.stride(-1) == 1 and (do.dtype != torch.bfloat16
                               or _aligned16(do)):
        return do
    return do.clone(memory_format=torch.contiguous_format)


def flash_attention_masked_bwd(q, k, v, o, lse, do, kv_start, kv_len, *,
                               causal: bool = False):
    """K5 → (dq, dk, dv) with the layouts of q, k, v.  CPU tensors run the
    plain version; CUDA tensors launch the kernels (or raise): bf16 the
    tensor-core body, which needs q/k/v 16-byte aligned, f32 the SIMT
    body.  q/k/v/kv_start/kv_len follow K1's contract; o and lse are K1's
    outputs, do the gradient of o.  Strided inputs are taken as they come
    (K1's o and the dO autograd hands back are views of (B, Sq, H, D)
    buffers); a dO `_grad_operand` rejects is copied."""
    if q.device.type == "cpu":
        return flash_attention_masked_bwd_plain(q, k, v, o, lse, do, kv_start,
                                                kv_len, causal)
    _check(q, k, v, kv_start, kv_len)
    B, H, Sq, D = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} / do {tuple(do.shape)} must "
                         f"match q {tuple(q.shape)}")
    if do.device != q.device or o.device != q.device:
        raise ValueError("o and do must lie on q's device")
    if do.dtype != q.dtype or o.dtype != q.dtype:
        raise TypeError("o and do must have q's dtype")
    if (lse.dtype != torch.float32 or lse.shape != (B, H, Sq)
            or not lse.is_contiguous()):
        raise ValueError("lse must be a contiguous (B, H, Sq) float32 tensor")
    if q.dtype == torch.bfloat16:
        _check_aligned("K5", q=q, k=k, v=v)
    do = _grad_operand(do)
    # Δ = rowsum(dO∘O): one fp32 torch reduction, as XLA computed it beside
    # the TPU kernels; the dQ and dK/dV kernels both read it
    delta = (do.float() * o.float()).sum(dim=-1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    strides = (ctypes.c_int64 * 21)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3])
    lib = _build.library()
    err = lib.p2t_flash_masked_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), kv_start.data_ptr(),
        kv_len.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        ctypes.addressof(strides), B, H, k.shape[1], Sq, k.shape[2], D,
        int(causal), _build.dtype_code(q.dtype), _build.stream_of(q))
    _build.check(err, "p2t_flash_masked_bwd")
    flash_attention_masked_bwd.launches += 1
    return dq, dk, dv


flash_attention_masked_bwd.launches = 0


class _FlashAttentionMasked(torch.autograd.Function):
    """K1 forward, K5 backward (the JAX `_flash_masked` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_start, kv_len, causal):
        o, lse = flash_attention_masked_fwd(q, k, v, kv_start, kv_len,
                                            causal=causal)
        ctx.save_for_backward(q, k, v, o, lse, kv_start, kv_len)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_start, kv_len = ctx.saved_tensors
        dq, dk, dv = flash_attention_masked_bwd(
            q, k, v, o, lse, do, kv_start, kv_len, causal=ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention_masked(q, k, v, kv_start, kv_len, *,
                           causal: bool = False):
    """The JAX `flash_attention_masked`: K1's output, differentiable in q, k
    and v through K5."""
    return _FlashAttentionMasked.apply(q, k, v, kv_start, kv_len, causal)


# ---------------------------------------------------------------------------
# K6: additive-bias flash attention, forward


def flash_attention_bias_plain(q, k, v, bias):
    """Plain PyTorch K6 → (o (B, H, Sq, D) in q's dtype, lse (B, H, Sq) f32).
    q (B, H, Sq, D) pre-scaled; k, v (B, Hkv, Skv, D); bias fp32 additive,
    broadcastable to (B, H, Sq, Skv).  As the TPU kernel: the running max
    starts at -1e30, so a row whose logits all lie below it (bias
    finfo(f32).min everywhere) gets o = 0 and lse = -1e30; the weights are
    rounded to v's dtype before P·V."""
    rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.repeat_interleave(rep, dim=1)
    logits = torch.matmul(q.float(), kf.transpose(-1, -2)) + bias.float()
    m = logits.amax(dim=-1, keepdim=True).clamp(min=NEG_INF)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0.0, 1.0, l)
    o = torch.matmul(p.to(v.dtype).float(), vf.float()) / safe
    return o.to(q.dtype), (m + torch.log(safe))[..., 0]


def _check_bias(q, k, v, bias):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"K6 needs CUDA tensors, got {dev}")
    for name, t in (("k", k), ("v", v), ("bias", bias)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K6 takes bfloat16 or float32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if bias.dtype != torch.float32:
        raise TypeError(f"K6's bias must be float32, got {bias.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if D not in HEAD_DIMS:
        raise ValueError(f"K6 head_dim must be one of {HEAD_DIMS}, got {D}")
    if Sq == 0 or Skv == 0:
        raise ValueError("empty sequence")
    if (bias.dim() != 4 or bias.shape[0] not in (1, B)
            or bias.shape[1] not in (1, H) or bias.shape[2] not in (1, Sq)
            or bias.shape[3] != Skv):
        raise ValueError(f"bias {tuple(bias.shape)} must broadcast as (B|1, "
                         f"H|1, Sq|1, Skv) = ({B}, {H}, {Sq}, {Skv})")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")


def flash_attention_bias_fwd(q, k, v, bias):
    """K6 → (o (B, H, Sq, D), lse (B, H, Sq) f32).  CPU tensors run the
    plain version; CUDA tensors launch the kernel (or raise): bf16 the
    tensor-core body, which needs q/k/v 16-byte aligned, f32 the SIMT body.
    The bias is read through its broadcast strides; on CUDA, o is a (B, H,
    Sq, D) view of a (B, Sq, H, D) buffer, as K1's."""
    if q.device.type == "cpu":
        return flash_attention_bias_plain(q, k, v, bias)
    _check_bias(q, k, v, bias)
    if q.dtype == torch.bfloat16:
        _check_aligned("K6", q=q, k=k, v=v)
    B, H, Sq, D = q.shape
    b = bias.expand(B, bias.shape[1], Sq, k.shape[2])
    b_sh = b.stride(1) if b.shape[1] == H and H > 1 else 0
    o = torch.empty((B, Sq, H, D), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 15)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *o.stride()[:3],
                                    b.stride(0), b_sh, b.stride(2))
    lib = _build.library()
    err = lib.p2t_flash_bias_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), b.data_ptr(), o.data_ptr(),
        lse.data_ptr(), ctypes.addressof(strides), B, H, k.shape[1], Sq,
        k.shape[2], D, _build.dtype_code(q.dtype), _build.stream_of(q))
    _build.check(err, "p2t_flash_bias_fwd")
    flash_attention_bias_fwd.launches += 1
    return o, lse


flash_attention_bias_fwd.launches = 0


def flash_attention_bias_bwd_plain(q, k, v, bias, o, lse, do):
    """Plain PyTorch K6b → (dq, dk, dv) in the inputs' dtypes, as the TPU
    backward computes them: P = exp(q·kᵀ + bias − lse) in fp32 and NOT
    rounded to v's dtype (the forward rounds it before P·V, the backward
    does not), Δ = rowsum(dO∘O), dS = P∘(dO·Vᵀ − Δ), dQ = dS·K, dK = dSᵀ·Q,
    dV = Pᵀ·dO, every product in fp32; dk/dv are computed per query head
    and summed over each grouped-query group.  No bias gradient."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rep = H // Hkv
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    logits = torch.matmul(qf, kf.transpose(-1, -2)) + bias.float()
    p = torch.exp(logits - lse[..., None])
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = dk.view(B, Hkv, rep, Skv, D).sum(dim=2)
    dv = dv.view(B, Hkv, rep, Skv, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bias_bwd(q, k, v, bias, o, lse, do):
    """K6b → (dq, dk, dv) with the layouts of q, k, v.  CPU tensors run the
    plain version; CUDA tensors launch the dQ and dK/dV kernels (or raise).
    q/k/v/bias follow K6's contract; o and lse are K6's outputs, do the
    gradient of o.  Strided q/k/v/o/do are taken as they come (ESMC hands
    over transposes of (B, S, H, D) buffers); only a head dim that is not
    contiguous is copied.  The bias is read through its broadcast
    strides."""
    if q.device.type == "cpu":
        return flash_attention_bias_bwd_plain(q, k, v, bias, o, lse, do)
    _check_bias(q, k, v, bias)
    B, H, Sq, D = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} / do {tuple(do.shape)} must "
                         f"match q {tuple(q.shape)}")
    if do.device != q.device or o.device != q.device:
        raise ValueError("o and do must lie on q's device")
    if do.dtype != q.dtype or o.dtype != q.dtype:
        raise TypeError("o and do must have q's dtype")
    if (lse.dtype != torch.float32 or lse.shape != (B, H, Sq)
            or not lse.is_contiguous()):
        raise ValueError("lse must be a contiguous (B, H, Sq) float32 tensor")
    if do.stride(-1) != 1:          # e.g. the expanded gradient of a sum
        do = do.contiguous()
    # Δ = rowsum(dO∘O): one fp32 torch reduction, as XLA computed it beside
    # the TPU kernels; the dQ and dK/dV kernels both read it
    delta = (do.float() * o.float()).sum(dim=-1).contiguous()
    b = bias.expand(B, bias.shape[1], Sq, k.shape[2])
    b_sh = b.stride(1) if b.shape[1] == H and H > 1 else 0
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    strides = (ctypes.c_int64 * 24)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
        b.stride(0), b_sh, b.stride(2))
    lib = _build.library()
    err = lib.p2t_flash_bias_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), b.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), ctypes.addressof(strides), B, H,
        k.shape[1], Sq, k.shape[2], D, _build.dtype_code(q.dtype),
        _build.stream_of(q))
    _build.check(err, "p2t_flash_bias_bwd")
    flash_attention_bias_bwd.launches += 1
    return dq, dk, dv


flash_attention_bias_bwd.launches = 0


class _FlashAttentionBias(torch.autograd.Function):
    """K6 forward, K6b backward (the JAX `flash_attention_tpu` custom VJP);
    the bias gets no gradient, as there."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        o, lse = flash_attention_bias_fwd(q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bias_bwd(q, k, v, bias, o, lse, do)
        return dq, dk, dv, None


def flash_attention_bias(q, k, v, bias):
    """The JAX `flash_attention_tpu`: K6's output, differentiable in q, k
    and v through K6b."""
    return _FlashAttentionBias.apply(q, k, v, bias)
