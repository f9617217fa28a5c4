"""K2, K4 and K9a: grouped-query decode attention over the stacked KV cache
(CUDA C++).

K2 replaces prot2text_tpu/kernels/decode_attention.py
`decode_attention_stacked` (`_kernel`), kernel `csrc/decode_attention.cu`:
the cache is read-only and the slot write is K3's, after the layer loop
(lockstep generation).  K4 replaces `decode_attention_stacked_write`
(`_kernel_write`) and K9a `decode_attention_stacked_write_prefix`
(`_kernel_write_p`), kernel `csrc/decode_attention_write.cu`: the same
attention fused with the in-place write of each row's current k/v into its
own slot `slots[b]` of layer `layer` (continuous-batching serving), K9a
with a read-only shared-prefix operand (L, 1, Hkv, Pc, D) gated per row by
`pmask`, columns ordered [prefix ‖ cache ‖ current].  Each kernel's header
states what bounds it and what its design does about that.  The `_plain`
functions are the plain PyTorch versions.

Contract (as the JAX kernels): qg (B, Hkv, rep, D) pre-scaled; ck_all/
cv_all (L, B, Hkv, T, D); kv_mask (B, T) 0/1 over already-written slots
(K4/K9a: the slot being written must still be 0); k_new/v_new (B, Hkv, D)
the current token, folded in as one extra logit column; `layer` a host
int.  Returns (B, Hkv, rep, D) in qg's dtype.  Masked columns take no
weight and are never read by the kernels, so a stale or scratch column
cannot leak a NaN.  JAX donates the cache and returns the updated copy;
K4 and K9a update ck_all/cv_all in place and return only the attention.
"""

from __future__ import annotations

import torch

from . import _build

NEG = float(torch.finfo(torch.float32).min)
HEAD_DIMS = (16, 32, 64, 128)
MAX_REP = 8


def _attend_plain(qg, ck, cv, mask, k_new, v_new):
    """[cache columns ‖ current token] attention: ck/cv (B, Hkv, T, D),
    mask (B, T).  Masked columns get logit finfo(f32).min and their values
    are zeroed, so no stale value reaches the output."""
    ok = mask[:, None, :, None] > 0
    ck = torch.where(ok, ck, 0).float()
    cv = torch.where(ok, cv, 0)
    q = qg.float()
    logits = torch.einsum("bkrd,bktd->bkrt", q, ck)
    logits = torch.where(mask[:, None, None, :] > 0, logits, NEG)
    ln = (q * k_new.float()[:, :, None, :]).sum(dim=-1)       # (B, Hkv, rep)
    m = torch.maximum(logits.amax(dim=-1), ln)
    el = torch.exp(logits - m[..., None])
    en = torch.exp(ln - m)
    denom = el.sum(dim=-1) + en
    a = torch.einsum("bkrt,bktd->bkrd", el.to(cv.dtype).float(), cv.float())
    a = a + en[..., None] * v_new.float()[:, :, None, :]
    return (a / denom[..., None]).to(qg.dtype)


def decode_attention_stacked_plain(qg, ck_all, cv_all, kv_mask, k_new, v_new,
                                   layer: int):
    return _attend_plain(qg, ck_all[layer], cv_all[layer], kv_mask, k_new,
                         v_new)


def _check(qg, ck_all, cv_all, kv_mask, k_new, v_new, layer):
    dev = qg.device
    if dev.type != "cuda":
        raise ValueError(f"decode attention (K2/K4/K9a) needs CUDA tensors, "
                         f"got {dev}")
    ts = (("ck_all", ck_all), ("cv_all", cv_all), ("kv_mask", kv_mask),
          ("k_new", k_new), ("v_new", v_new))
    for name, t in ts:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, qg on {dev}")
    if qg.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"decode attention takes bfloat16 or float32, got "
                        f"{qg.dtype}")
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
        raise ValueError(f"decode attention takes head_dim in {HEAD_DIMS} "
                         f"and 1..{MAX_REP} query heads per kv head, got "
                         f"D={D} rep={rep}")
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


def _slots(slots, B: int, device):
    """A host int, a 0-dim or a (B,) integer tensor → (B,) int32 on
    `device` (the TPU kernels broadcast a scalar slot the same way)."""
    if not torch.is_tensor(slots):
        return torch.full((B,), int(slots), dtype=torch.int32, device=device)
    if slots.dim() == 0:
        slots = slots.expand(B)
    if slots.shape != (B,) or slots.dtype.is_floating_point:
        raise ValueError(f"slots must be a scalar or (B,) integers, got "
                         f"{tuple(slots.shape)} {slots.dtype}")
    return slots.to(device=device, dtype=torch.int32).contiguous()


def _write_slots_plain(ck_all, cv_all, k_new, v_new, layer, slots):
    B = k_new.shape[0]
    bidx = torch.arange(B, device=ck_all.device)
    slots = _slots(slots, B, ck_all.device).long()
    ck_all[layer, bidx, :, slots] = k_new.to(ck_all.dtype)
    cv_all[layer, bidx, :, slots] = v_new.to(cv_all.dtype)


def decode_attention_stacked_write_plain(qg, ck_all, cv_all, kv_mask, k_new,
                                         v_new, layer: int, slots):
    """Plain K4: K2's attention, then ck_all/cv_all[layer, b, :, slots[b]]
    = k_new/v_new[b] in place."""
    a = decode_attention_stacked_plain(qg, ck_all, cv_all, kv_mask, k_new,
                                       v_new, layer)
    _write_slots_plain(ck_all, cv_all, k_new, v_new, layer, slots)
    return a


def decode_attention_stacked_write_prefix_plain(qg, ck_all, cv_all, kv_mask,
                                                k_new, v_new, layer: int,
                                                slots, pk_all, pv_all, pmask):
    """Plain K9a: the prefix's columns broadcast to every row and
    concatenated before the cache's, one softmax over [prefix ‖ cache ‖
    current], then K4's slot write."""
    B = qg.shape[0]
    pk = pk_all[layer].to(ck_all.dtype).expand(B, -1, -1, -1)
    pv = pv_all[layer].to(cv_all.dtype).expand(B, -1, -1, -1)
    a = _attend_plain(qg, torch.cat([pk, ck_all[layer]], dim=2),
                      torch.cat([pv, cv_all[layer]], dim=2),
                      torch.cat([pmask, kv_mask], dim=1), k_new, v_new)
    _write_slots_plain(ck_all, cv_all, k_new, v_new, layer, slots)
    return a


def decode_attention_stacked_write(qg, ck_all, cv_all, kv_mask, k_new, v_new,
                                   layer: int, slots):
    """K4: decode attention + in-place write of row b's k/v into slot
    slots[b] (a scalar slot is broadcast) of layer `layer`.  CPU tensors run
    the plain version; CUDA tensors launch the kernel (or raise)."""
    if qg.device.type == "cpu":
        return decode_attention_stacked_write_plain(
            qg, ck_all, cv_all, kv_mask, k_new, v_new, layer, slots)
    layer = int(layer)
    slots = _slots(slots, qg.shape[0], qg.device)
    _check(qg, ck_all, cv_all, kv_mask, k_new, v_new, layer)
    out = _launch_write(qg, ck_all, cv_all, kv_mask, k_new, v_new, layer,
                        slots, None, None, None)
    decode_attention_stacked_write.launches += 1
    return out


decode_attention_stacked_write.launches = 0


def decode_attention_stacked_write_prefix(qg, ck_all, cv_all, kv_mask, k_new,
                                          v_new, layer: int, slots, pk_all,
                                          pv_all, pmask):
    """K9a: K4 plus the shared prefix pk_all/pv_all (L, 1, Hkv, Pc, D),
    read-only, gated per row by pmask (B, Pc) int32.  CPU tensors run the
    plain version; CUDA tensors launch the kernel (or raise)."""
    if qg.device.type == "cpu":
        return decode_attention_stacked_write_prefix_plain(
            qg, ck_all, cv_all, kv_mask, k_new, v_new, layer, slots, pk_all,
            pv_all, pmask)
    layer = int(layer)
    slots = _slots(slots, qg.shape[0], qg.device)
    _check(qg, ck_all, cv_all, kv_mask, k_new, v_new, layer)
    L, B, Hkv, T, D = ck_all.shape
    if pk_all.dim() != 5 or pk_all.shape[:3] != (L, 1, Hkv) \
            or pk_all.shape[4] != D or pv_all.shape != pk_all.shape:
        raise ValueError(f"prefix must be (L, 1, Hkv, Pc, D) = ({L}, 1, "
                         f"{Hkv}, Pc, {D}), got {tuple(pk_all.shape)} and "
                         f"{tuple(pv_all.shape)}")
    Pc = pk_all.shape[3]
    for name, t in (("pk_all", pk_all), ("pv_all", pv_all)):
        if t.device != qg.device or t.dtype != qg.dtype \
                or not t.is_contiguous() or Pc == 0:
            raise ValueError(f"K9a: {name} must be a non-empty contiguous "
                             f"{qg.dtype} tensor on {qg.device}")
    if pmask.shape != (B, Pc) or pmask.dtype != torch.int32 \
            or pmask.device != qg.device or not pmask.is_contiguous():
        raise ValueError(f"K9a: pmask must be a contiguous ({B}, {Pc}) int32 "
                         f"tensor on {qg.device}")
    out = _launch_write(qg, ck_all, cv_all, kv_mask, k_new, v_new, layer,
                        slots, pk_all, pv_all, pmask)
    decode_attention_stacked_write_prefix.launches += 1
    return out


decode_attention_stacked_write_prefix.launches = 0


def _launch_write(qg, ck_all, cv_all, kv_mask, k_new, v_new, layer, slots,
                  pk_all, pv_all, pmask):
    L, B, Hkv, T, D = ck_all.shape
    out = torch.empty_like(qg)
    off = layer * ck_all.stride(0) * ck_all.element_size()
    if pk_all is None:
        pk = pv = pm = None
        Pc = 0
    else:
        Pc = pk_all.shape[3]
        poff = layer * pk_all.stride(0) * pk_all.element_size()
        pk, pv = pk_all.data_ptr() + poff, pv_all.data_ptr() + poff
        pm = pmask.data_ptr()
    lib = _build.library()
    err = lib.p2t_decode_attention_write(
        qg.data_ptr(), ck_all.data_ptr() + off, cv_all.data_ptr() + off,
        kv_mask.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        slots.data_ptr(), pk, pv, pm, out.data_ptr(), B, Hkv, qg.shape[2],
        T, Pc, D, _build.dtype_code(qg.dtype), _build.stream_of(qg))
    _build.check(err, "p2t_decode_attention_write")
    return out
