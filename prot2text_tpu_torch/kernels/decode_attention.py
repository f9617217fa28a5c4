"""K2, K4 and K9a: grouped-query decode attention over the stacked KV cache
(CUDA C++); K7, K9b, K8 and K9c, their int8-cache counterparts (after the
bf16 section below).

K2 replaces prot2text_tpu/kernels/decode_attention.py
`decode_attention_stacked` (`_kernel`), kernel `csrc/decode_attention.cu`:
the cache is read-only and the slot write is K3's, after the layer loop
(JAX's default lockstep step; the port's lockstep step takes K4 per layer,
JAX's fused-write route, so no model path of the port calls K2).  K4 replaces `decode_attention_stacked_write`
(`_kernel_write`) and K9a `decode_attention_stacked_write_prefix`
(`_kernel_write_p`), kernel `csrc/decode_attention_write.cu`: the same
attention fused with the in-place write of each row's current k/v into its
own slot `slots[b]` of layer `layer` (continuous-batching serving), K9a
with a read-only shared-prefix operand (L, 1, Hkv, Pc, D) gated per row by
`pmask`, columns ordered [prefix ‖ cache ‖ current].  K4 and K9a also take
the sequence-leading (L, T, B, Hkv, D) "tbkd" cache (`layout="tbkd"`),
read and written at its strides, K9a with the sequence-leading prefix
(L, Pc, 1, Hkv, D) read at its own: the D = 64 decode step's attention and
slot write, where JAX's tbkd step attends by einsum (the prefix
concatenated, prot2text_tpu/models/decoder.py:789-812) and writes after
the layer loop; their plain versions on tbkd are that einsum route
(`_tbkd_decode_attention`) followed by the layer's slot write.  On bf16
all three run one column-split cluster body,
`csrc/decode_attention_split.cuh` (column policy `CacheCols` for K2 and
K4, `PrefixCols` for K9a; K2 writes nothing), one launch a call; f32 runs
the SIMT bodies of the two `.cu` files.  bf16
K7, K8, K9b and K9c up to 32 query rows run the same body with int8 tiles
(below).  A shape the body refuses (more column tiles than its blocks may
own) raises; nothing falls back to another body.  Each kernel's header
states what bounds it and what its design does about that.  The `_plain`
functions are the plain PyTorch versions.

Contract (as the JAX kernels): qg (B, Hkv, rep, D) pre-scaled; ck_all/
cv_all (L, B, Hkv, T, D); kv_mask (B, T) 0/1 over already-written slots
(K4/K9a: the slot being written is still 0 on every engine path; where
it is 1 the attention reads the slot's old value, and the write follows);
k_new/v_new (B, Hkv, D) the current token, folded in as one extra logit
column; `layer` a host int.  Returns (B, Hkv, rep, D) in qg's dtype.
Masked columns take no weight and are never read by the kernels, so a
stale or scratch column cannot leak a NaN.  JAX donates the cache and
returns the updated copy; K4 and K9a update ck_all/cv_all in place and
return only the attention.  The bf16 body copies the caches with 16-byte
`cp.async`, so every operand must be contiguous and the caches 16-byte
aligned (`_check`).
"""

from __future__ import annotations

import torch

from . import _build

NEG = float(torch.finfo(torch.float32).min)
HEAD_DIMS = (16, 32, 64, 128)
MAX_REP = 8
LAYOUTS = ("bktd", "tbkd")      # K4's and K9a's cache layouts (K2: bktd)


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


def _dims(ck_all, layout: str):
    """(L, B, Hkv, T, D) of a bktd (L, B, Hkv, T, D) or tbkd (L, T, B, Hkv,
    D) stacked cache."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if layout == "tbkd":
        L, T, B, Hkv, D = ck_all.shape
        return L, B, Hkv, T, D
    return tuple(ck_all.shape)


def _check(qg, ck_all, cv_all, kv_mask, k_new, v_new, layer,
           layout: str = "bktd"):
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
        shape = "(L, T, B, Hkv, D)" if layout == "tbkd" else \
            "(L, B, Hkv, T, D)"
        raise ValueError(f"qg must be (B, Hkv, rep, D) and ck_all/cv_all "
                         f"{shape} alike")
    L, B, Hkv, T, D = _dims(ck_all, layout)
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
    kernel (or raise): bf16 the column-split cluster body, f32 the SIMT
    body.  Layer `layer` is read in place by pointer offset."""
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


def _write_slots_plain(ck_all, cv_all, k_new, v_new, layer, slots,
                       layout: str = "bktd"):
    B = k_new.shape[0]
    bidx = torch.arange(B, device=ck_all.device)
    slots = _slots(slots, B, ck_all.device).long()
    at = ((layer, slots, bidx) if layout == "tbkd"
          else (layer, bidx, slice(None), slots))
    ck_all[at] = k_new.to(ck_all.dtype)
    cv_all[at] = v_new.to(cv_all.dtype)


def _tbkd_decode_attention(qg, ck, cv, kv_mask, k, v):
    """Grouped decode attention over a stale tbkd layer cache (T, B, Hkv, D)
    plus the current token's logit, as JAX's einsum route over that layout
    (prot2text_tpu/models/decoder.py:1063-1090): fp32 logits with the
    finfo.min bias of unwritten slots, fp32 softmax, the stale weights cast
    to the cache's dtype and the current one to v's.  The body of plain K4
    on a tbkd cache (`decode_attention_stacked_write_plain(...,
    layout="tbkd")`), so the port's tbkd lockstep step computes on the CPU
    what JAX's computes.  Returns (B, Hkv, rep, D) in qg's dtype."""
    T = ck.shape[0]
    neg = torch.finfo(torch.float32).min
    bias = torch.where(kv_mask > 0, 0.0, neg)[:, None, None, :]
    logits_old = torch.einsum("bkrd,tbkd->bkrt", qg.float(), ck.float())
    logit_new = torch.einsum("bkrd,bkd->bkr", qg.float(),
                             k.to(qg.dtype).float())[..., None]
    w = torch.softmax(torch.cat([logits_old + bias, logit_new], dim=-1),
                      dim=-1)
    a = torch.einsum("bkrt,tbkd->bkrd", w[..., :T].to(cv.dtype).float(),
                     cv.float()).to(qg.dtype)
    return a + (w[..., T:].to(v.dtype) * v[:, :, None, :]).to(qg.dtype)


def decode_attention_stacked_write_plain(qg, ck_all, cv_all, kv_mask, k_new,
                                         v_new, layer: int, slots, *,
                                         layout: str = "bktd"):
    """Plain K4: K2's attention, then ck_all/cv_all[layer, b, :, slots[b]]
    = k_new/v_new[b] in place.  On a tbkd cache (L, T, B, Hkv, D):
    `_tbkd_decode_attention` over layer `layer`, then ck_all/cv_all[layer,
    slots[b], b] = k_new/v_new[b] (the lockstep step's scalar slot: K12's
    write of that layer)."""
    _dims(ck_all, layout)
    if layout == "tbkd":
        a = _tbkd_decode_attention(qg, ck_all[layer], cv_all[layer],
                                   kv_mask, k_new, v_new)
    else:
        a = decode_attention_stacked_plain(qg, ck_all, cv_all, kv_mask,
                                           k_new, v_new, layer)
    _write_slots_plain(ck_all, cv_all, k_new, v_new, layer, slots, layout)
    return a


def decode_attention_stacked_write_prefix_plain(qg, ck_all, cv_all, kv_mask,
                                                k_new, v_new, layer: int,
                                                slots, pk_all, pv_all, pmask,
                                                *, layout: str = "bktd"):
    """Plain K9a: the prefix's columns broadcast to every row and
    concatenated before the cache's, one softmax over [prefix ‖ cache ‖
    current], then K4's slot write.  On a tbkd cache the prefix is
    sequence-leading (L, Pc, 1, Hkv, D), concatenated along T as JAX's
    `_pfx_cat` does (prot2text_tpu/models/decoder.py:805-812), and the
    attention is `_tbkd_decode_attention`'s."""
    _dims(ck_all, layout)
    B = qg.shape[0]
    mask = torch.cat([pmask, kv_mask], dim=1)
    if layout == "tbkd":
        pk = pk_all[layer].to(ck_all.dtype).expand(-1, B, -1, -1)
        pv = pv_all[layer].to(cv_all.dtype).expand(-1, B, -1, -1)
        a = _tbkd_decode_attention(qg, torch.cat([pk, ck_all[layer]]),
                                   torch.cat([pv, cv_all[layer]]), mask,
                                   k_new, v_new)
    else:
        pk = pk_all[layer].to(ck_all.dtype).expand(B, -1, -1, -1)
        pv = pv_all[layer].to(cv_all.dtype).expand(B, -1, -1, -1)
        a = _attend_plain(qg, torch.cat([pk, ck_all[layer]], dim=2),
                          torch.cat([pv, cv_all[layer]], dim=2), mask,
                          k_new, v_new)
    _write_slots_plain(ck_all, cv_all, k_new, v_new, layer, slots, layout)
    return a


def decode_attention_stacked_write(qg, ck_all, cv_all, kv_mask, k_new, v_new,
                                   layer: int, slots, *,
                                   layout: str = "bktd"):
    """K4: decode attention + in-place write of row b's k/v into slot
    slots[b] (a scalar slot is broadcast) of layer `layer`.  `layout`
    "tbkd" takes the sequence-leading (L, T, B, Hkv, D) cache of the D = 64
    lockstep step (JAX's K4 takes bktd only; its tbkd step attends by
    einsum and writes with K12 after the layer loop): the kernels read and
    write the layer at its strides, and the output is bit-identical to the
    bktd launch on the permuted cache.  CPU tensors run the plain version;
    CUDA tensors launch the kernel (or raise): bf16 the column-split
    cluster body, f32 the SIMT body."""
    if qg.device.type == "cpu":
        return decode_attention_stacked_write_plain(
            qg, ck_all, cv_all, kv_mask, k_new, v_new, layer, slots,
            layout=layout)
    layer = int(layer)
    slots = _slots(slots, qg.shape[0], qg.device)
    _check(qg, ck_all, cv_all, kv_mask, k_new, v_new, layer, layout)
    out = _launch_write(qg, ck_all, cv_all, kv_mask, k_new, v_new, layer,
                        slots, None, None, None, layout)
    decode_attention_stacked_write.launches += 1
    return out


decode_attention_stacked_write.launches = 0


def decode_attention_stacked_write_prefix(qg, ck_all, cv_all, kv_mask, k_new,
                                          v_new, layer: int, slots, pk_all,
                                          pv_all, pmask, *,
                                          layout: str = "bktd"):
    """K9a: K4 plus the shared prefix pk_all/pv_all, read-only, gated per
    row by pmask (B, Pc) int32.  The prefix follows the cache's `layout`:
    (L, 1, Hkv, Pc, D) beside a bktd cache, sequence-leading (L, Pc, 1,
    Hkv, D) beside a tbkd one (JAX's, prot2text_tpu/models/decoder.py:
    805-812), read in place at its strides, and the output is
    bit-identical to the bktd launch on the permuted cache and prefix.
    CPU tensors run the plain version; CUDA tensors launch the kernel (or
    raise): bf16 the column-split cluster body, f32 the SIMT body."""
    if qg.device.type == "cpu":
        return decode_attention_stacked_write_prefix_plain(
            qg, ck_all, cv_all, kv_mask, k_new, v_new, layer, slots, pk_all,
            pv_all, pmask, layout=layout)
    layer = int(layer)
    slots = _slots(slots, qg.shape[0], qg.device)
    _check(qg, ck_all, cv_all, kv_mask, k_new, v_new, layer, layout)
    L, B, Hkv, T, D = _dims(ck_all, layout)
    tbkd = layout == "tbkd"
    Pc = (pk_all.shape[1] if tbkd else pk_all.shape[3]) \
        if pk_all.dim() == 5 else -1
    want = (L, Pc, 1, Hkv, D) if tbkd else (L, 1, Hkv, Pc, D)
    if pk_all.shape != want or pv_all.shape != want:
        shape = "(L, Pc, 1, Hkv, D)" if tbkd else "(L, 1, Hkv, Pc, D)"
        raise ValueError(f"prefix must be {shape} with (L, Hkv, D) = ({L}, "
                         f"{Hkv}, {D}), got {tuple(pk_all.shape)} and "
                         f"{tuple(pv_all.shape)}")
    for name, t in (("pk_all", pk_all), ("pv_all", pv_all)):
        if t.device != qg.device or t.dtype != qg.dtype \
                or not t.is_contiguous() or Pc == 0:
            raise ValueError(f"K9a: {name} must be a non-empty contiguous "
                             f"{qg.dtype} tensor on {qg.device}")
    if pmask.shape != (B, Pc) or pmask.dtype != torch.int32 \
            or pmask.device != qg.device or not pmask.is_contiguous():
        raise ValueError(f"K9a: pmask must be a contiguous ({B}, {Pc}) int32 "
                         f"tensor on {qg.device}")
    if qg.dtype == torch.bfloat16 and (pk_all.data_ptr() % 16
                                       or pv_all.data_ptr() % 16):
        # the bf16 body copies prefix rows in 16-byte chunks (cp.async)
        raise ValueError("K9a: bf16 prefix buffers must be 16-byte aligned")
    out = _launch_write(qg, ck_all, cv_all, kv_mask, k_new, v_new, layer,
                        slots, pk_all, pv_all, pmask, layout)
    decode_attention_stacked_write_prefix.launches += 1
    return out


decode_attention_stacked_write_prefix.launches = 0


def _launch_write(qg, ck_all, cv_all, kv_mask, k_new, v_new, layer, slots,
                  pk_all, pv_all, pmask, layout: str = "bktd"):
    L, B, Hkv, T, D = _dims(ck_all, layout)
    tbkd = layout == "tbkd"
    # element strides of the layer slice: (b, kv head) slab, column; of the
    # prefix's: kv head, column
    slab, col = (D, B * Hkv * D) if tbkd else (T * D, D)
    out = torch.empty_like(qg)
    off = layer * ck_all.stride(0) * ck_all.element_size()
    if pk_all is None:
        pk = pv = pm = None
        Pc = phead = pcol = 0
    else:
        Pc = pmask.shape[1]
        phead, pcol = (D, Hkv * D) if tbkd else (Pc * D, D)
        poff = layer * pk_all.stride(0) * pk_all.element_size()
        pk, pv = pk_all.data_ptr() + poff, pv_all.data_ptr() + poff
        pm = pmask.data_ptr()
    lib = _build.library()
    err = lib.p2t_decode_attention_write(
        qg.data_ptr(), ck_all.data_ptr() + off, cv_all.data_ptr() + off,
        kv_mask.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        slots.data_ptr(), pk, pv, pm, out.data_ptr(), B, Hkv, qg.shape[2],
        T, Pc, D, slab, col, phead, pcol, _build.dtype_code(qg.dtype),
        _build.stream_of(qg))
    _build.check(err, "p2t_decode_attention_write")
    return out


# ---------------------------------------------------------------------------
# int8 KV cache: K7 and K9b (one token per row), K8 and K9c (a G-token
# speculative chunk per row), kernels csrc/decode_attention_write_q.cu and
# csrc/decode_attention_verify.cu.  bf16 q with at most SPLIT_ROWS query
# rows (`int8_split_route`) runs the cluster-split tensor-core body
# csrc/decode_attention_split.cuh (policies Int8Cache and ChunkWrite: int8
# tiles converted to bf16 in shared memory, all G·rep rows of a kv head in
# one block; column policy CacheCols for K7/K8, PrefixCols for K9b/K9c);
# f32 q, and a call past SPLIT_ROWS rows, run the SIMT body
# csrc/decode_attention_q.cuh, its only users.  The route is the shape's,
# never a launch's outcome: a call on the card launches its body or raises.
#
# Contract (as the JAX kernels): qg (B, Hkv, G·rep, D) pre-scaled, row
# g·rep + r = chunk token g, head replica r (G = 1: (B, Hkv, rep, D));
# ck_all/cv_all (L, B, Hkv, T, D) int8 and sk_all/sv_all (L, B, Hkv, T)
# fp32, all four updated IN PLACE (JAX donates them and returns the
# updated copies); kv_mask (B, T) 0/1 over already-written columns (the
# columns written now must be 0); k_new_q/v_new_q the current tokens'
# exact-integer fp32 values from `models.quant.quantize_kv`, (B, Hkv, D)
# for K7/K9b and (B, Hkv, G, D) for K8/K9c, with k_new_s/v_new_s scales
# (B, Hkv[, G]); `layer` a host int; slots a scalar or (B,) first written
# column per row.  The prefix variants add pk_all/pv_all (L, 1, Hkv, Pc, D)
# int8 with psk_all/psv_all (L, 1, Hkv, Pc) fp32, read-only, and pmask
# (B, Pc).  Returns the attention in qg's dtype.  The split body copies
# the int8 slabs with 16-byte cp.async: caches and prefix 16-byte aligned
# (contiguous tensors of D in HEAD_DIMS are).
#
# Numerics, kept by the plain versions so that in fp32 they match the JAX
# kernels in interpret mode, and by both CUDA bodies: int8 → float (bf16 in
# the split body) exact; a cache column's logit is the fp32 q·k_int times
# its k scale; its weight times its v scale is rounded to bf16 before ·V;
# the current tokens' own columns stay fp32 (K7/K9b: q·(kq·ks); K8/K9c:
# (q·kq)·ks; chunk columns causal by token).
# ---------------------------------------------------------------------------

MAX_CHUNK = 32                  # K8/K9c: chunk tokens G
MAX_ROWS = 256                  # query rows G·rep (csrc kQMaxRows)
SPLIT_ROWS = 32                 # the split body's rows (csrc split::kMaxRows)


def int8_split_route(dtype, rows: int, prefix: bool) -> bool:
    """Whether an int8-pool attention call on the card runs the
    cluster-split tensor-core body (True) or the SIMT body (False): bf16
    q and rows = G·rep <= SPLIT_ROWS query rows, with the shared prefix
    (K9b, K9c: column policy PrefixCols) or without it (K7, K8:
    CacheCols); the rule `split::int8_takes` applies in the C entry
    points.  Past the body's column limit (more than 256 tiles of 64
    columns a block, a cluster of 4: Pc + T > 65536) the split route
    raises."""
    del prefix                  # either column policy takes the same rows
    return dtype == torch.bfloat16 and rows <= SPLIT_ROWS


def split_resident_clusters(int8: bool, rows: int, D: int,
                            prefix: bool = True) -> int:
    """How many clusters of the cluster-split body's instantiation the card
    holds at once (`cudaOccupancyMaxActiveClusters`): int8, bf16 K9b/K9c's
    (prefix) or K7/K8's at `rows` query rows; else bf16 K9a's (prefix) or
    K4's.  A launch of B·Hkv clusters above it runs the rest as a second
    wave.  Card only."""
    import ctypes

    n = ctypes.c_int()
    lib = _build.library()
    if int8:
        err = lib.p2t_decode_split_int8_resident(int(prefix), rows, D,
                                                 ctypes.addressof(n))
    else:
        err = lib.p2t_decode_split_bf16_resident(int(prefix), D,
                                                 ctypes.addressof(n))
    _build.check(err, "split_resident_clusters")
    return n.value


def _attend_q_plain(qg, ck, cv, sk, sv, mask, kq, vq, ks, vs, *,
                    dequant_first: bool):
    """[cache columns ‖ chunk columns] attention over one layer: ck/cv
    (B, Hkv, T, D) int8, sk/sv (B, Hkv, T), mask (B, T); kq/vq
    (B, Hkv, G, D), ks/vs (B, Hkv, G).  Masked cache columns take no
    weight and their values are zeroed."""
    G = kq.shape[2]
    GR = qg.shape[2]
    rep = GR // G
    q = qg.float()
    ok = mask[:, None, :] > 0                                  # (B, 1, T)
    ckf = torch.where(ok[..., None], ck, 0).float()
    cvf = torch.where(ok[..., None], cv, 0).float()
    logits = torch.einsum("bkrd,bktd->bkrt", q, ckf) * torch.where(
        ok, sk, 0)[:, :, None, :]
    logits = torch.where(ok[:, :, None, :], logits, NEG)
    if dequant_first:
        ln = torch.einsum("bkrd,bkgd->bkrg", q, kq * ks[..., None])
    else:
        ln = torch.einsum("bkrd,bkgd->bkrg", q, kq) * ks[:, :, None, :]
    rowg = torch.arange(GR, device=qg.device)[:, None] // rep
    colg = torch.arange(G, device=qg.device)[None, :]
    ln = torch.where(colg <= rowg, ln, NEG)
    m = torch.maximum(logits.amax(dim=-1), ln.amax(dim=-1))
    el = torch.exp(logits - m[..., None])
    en = torch.exp(ln - m[..., None])
    denom = el.sum(dim=-1) + en.sum(dim=-1)
    w = (el * torch.where(ok, sv, 0)[:, :, None, :]).to(torch.bfloat16)
    a = torch.einsum("bkrt,bktd->bkrd", w.float(), cvf)
    a = a + torch.einsum("bkrg,bkgd->bkrd", en * vs[:, :, None, :], vq)
    return (a / denom[..., None]).to(qg.dtype)


def _write_chunk_plain(ck_all, cv_all, sk_all, sv_all, kq, vq, ks, vs,
                       layer, slots):
    """Columns slots[b] + g of layer `layer` ← the chunk's int8 k/v and
    scales, in place."""
    B, _, G, _ = kq.shape
    T = ck_all.shape[3]
    cols = _slots(slots, B, ck_all.device).long()[:, None] + torch.arange(
        G, device=ck_all.device)
    if int(cols.min()) < 0 or int(cols.max()) >= T:
        raise ValueError(f"written columns must lie in [0, {T})")
    bidx = torch.arange(B, device=ck_all.device)[:, None]
    ck_all[layer, bidx, :, cols] = kq.transpose(1, 2).to(torch.int8)
    cv_all[layer, bidx, :, cols] = vq.transpose(1, 2).to(torch.int8)
    sk_all[layer, bidx, :, cols] = ks.transpose(1, 2).float()
    sv_all[layer, bidx, :, cols] = vs.transpose(1, 2).float()


def _with_prefix(ck, cv, sk, sv, mask, pk_all, pv_all, psk_all, psv_all,
                 pmask, layer):
    """The prefix's columns broadcast to every row and concatenated before
    the cache's: one softmax over [prefix ‖ cache ‖ chunk]."""
    B = mask.shape[0]
    return (torch.cat([pk_all[layer].expand(B, -1, -1, -1), ck], dim=2),
            torch.cat([pv_all[layer].expand(B, -1, -1, -1), cv], dim=2),
            torch.cat([psk_all[layer].expand(B, -1, -1), sk], dim=2),
            torch.cat([psv_all[layer].expand(B, -1, -1), sv], dim=2),
            torch.cat([pmask, mask], dim=1))


def decode_attention_stacked_write_q_plain(qg, ck_all, cv_all, sk_all,
                                           sv_all, kv_mask, k_new_q, v_new_q,
                                           k_new_s, v_new_s, layer: int,
                                           slots):
    """Plain K7: attention over the int8 layer + the current token, then
    the token's int8 k/v and scales written at slots[b] in place."""
    args = (k_new_q[:, :, None], v_new_q[:, :, None], k_new_s[:, :, None],
            v_new_s[:, :, None])
    a = _attend_q_plain(qg, ck_all[layer], cv_all[layer], sk_all[layer],
                        sv_all[layer], kv_mask, *args, dequant_first=True)
    _write_chunk_plain(ck_all, cv_all, sk_all, sv_all, *args, layer, slots)
    return a


def decode_attention_stacked_write_q_prefix_plain(
        qg, ck_all, cv_all, sk_all, sv_all, kv_mask, k_new_q, v_new_q,
        k_new_s, v_new_s, layer: int, slots, pk_all, pv_all, psk_all,
        psv_all, pmask):
    """Plain K9b: K7 with the int8 prefix's columns first."""
    args = (k_new_q[:, :, None], v_new_q[:, :, None], k_new_s[:, :, None],
            v_new_s[:, :, None])
    cat = _with_prefix(ck_all[layer], cv_all[layer], sk_all[layer],
                       sv_all[layer], kv_mask, pk_all, pv_all, psk_all,
                       psv_all, pmask, layer)
    a = _attend_q_plain(qg, *cat, *args, dequant_first=True)
    _write_chunk_plain(ck_all, cv_all, sk_all, sv_all, *args, layer, slots)
    return a


def decode_attention_stacked_verify_qc_plain(qg, ck_all, cv_all, sk_all,
                                             sv_all, kv_mask, k_new_q,
                                             v_new_q, k_new_s, v_new_s,
                                             layer: int, slots):
    """Plain K8: G·rep rows over [int8 layer ‖ causal chunk], then the
    chunk's G int8 rows and scales written at [slots[b], slots[b] + G)."""
    args = (k_new_q, v_new_q, k_new_s, v_new_s)
    a = _attend_q_plain(qg, ck_all[layer], cv_all[layer], sk_all[layer],
                        sv_all[layer], kv_mask, *args, dequant_first=False)
    _write_chunk_plain(ck_all, cv_all, sk_all, sv_all, *args, layer, slots)
    return a


def decode_attention_stacked_verify_qc_prefix_plain(
        qg, ck_all, cv_all, sk_all, sv_all, kv_mask, k_new_q, v_new_q,
        k_new_s, v_new_s, layer: int, slots, pk_all, pv_all, psk_all,
        psv_all, pmask):
    """Plain K9c: K8 with the int8 prefix's columns first."""
    args = (k_new_q, v_new_q, k_new_s, v_new_s)
    cat = _with_prefix(ck_all[layer], cv_all[layer], sk_all[layer],
                       sv_all[layer], kv_mask, pk_all, pv_all, psk_all,
                       psv_all, pmask, layer)
    a = _attend_q_plain(qg, *cat, *args, dequant_first=False)
    _write_chunk_plain(ck_all, cv_all, sk_all, sv_all, *args, layer, slots)
    return a


def _check_q(name, qg, ck_all, cv_all, sk_all, sv_all, kv_mask, kq, vq, ks,
             vs, layer, G, prefix):
    """The CUDA wrappers' checks; G None: one token a row (K7, K9b), its
    k/v (B, Hkv, D) and scales (B, Hkv), taken as they are (no view: the
    host path is most of an eager call)."""
    one = G is None
    G = 1 if one else G
    dev = qg.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if qg.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: qg must be bfloat16 or float32, got "
                        f"{qg.dtype}")
    if ck_all.dim() != 5 or cv_all.shape != ck_all.shape:
        raise ValueError(f"{name}: ck_all/cv_all must be (L, B, Hkv, T, D) "
                         f"alike")
    L, B, Hkv, T, D = ck_all.shape
    GR = qg.shape[2] if qg.dim() == 4 else -1
    if qg.shape != (B, Hkv, GR, D) or GR % G or not 1 <= G <= MAX_CHUNK \
            or GR > MAX_ROWS:
        raise ValueError(f"{name}: qg {tuple(qg.shape)} vs cache "
                         f"{tuple(ck_all.shape)} and G={G}")
    new = (B, Hkv) if one else (B, Hkv, G)
    want = [("ck_all", ck_all, torch.int8, (L, B, Hkv, T, D)),
            ("cv_all", cv_all, torch.int8, (L, B, Hkv, T, D)),
            ("sk_all", sk_all, torch.float32, (L, B, Hkv, T)),
            ("sv_all", sv_all, torch.float32, (L, B, Hkv, T)),
            ("kv_mask", kv_mask, torch.int32, (B, T)),
            ("k_new_q", kq, torch.float32, new + (D,)),
            ("v_new_q", vq, torch.float32, new + (D,)),
            ("k_new_s", ks, torch.float32, new),
            ("v_new_s", vs, torch.float32, new)]
    if prefix is not None:
        pk_all, pv_all, psk_all, psv_all, pmask = prefix
        Pc = pk_all.shape[3] if pk_all.dim() == 5 else 0
        if Pc == 0:
            raise ValueError(f"{name}: prefix must be (L, 1, Hkv, Pc>0, D)")
        want += [("pk_all", pk_all, torch.int8, (L, 1, Hkv, Pc, D)),
                 ("pv_all", pv_all, torch.int8, (L, 1, Hkv, Pc, D)),
                 ("psk_all", psk_all, torch.float32, (L, 1, Hkv, Pc)),
                 ("psv_all", psv_all, torch.float32, (L, 1, Hkv, Pc)),
                 ("pmask", pmask, torch.int32, (B, Pc))]
    for n, t, dt, shape in want:
        if t.dtype != dt or t.shape != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be a contiguous {dt} tensor "
                             f"of shape {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not qg.is_contiguous():
        raise ValueError(f"{name}: qg must be contiguous")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim must be in {HEAD_DIMS}, got {D}")
    if not 0 <= layer < L:
        raise ValueError(f"{name}: layer {layer} out of range [0, {L})")


def _launch_q(entry, qg, ck_all, cv_all, sk_all, sv_all, kv_mask, kq, vq,
              ks, vs, layer, slots, prefix, G):
    L, B, Hkv, T, D = ck_all.shape
    out = torch.empty_like(qg)

    def at(t):                       # layer `layer` of a stacked tensor
        return t.data_ptr() + layer * t.stride(0) * t.element_size()

    if prefix is None:
        pptr = [None] * 5
        Pc = 0
    else:
        pk_all, pv_all, psk_all, psv_all, pmask = prefix
        pptr = [at(pk_all), at(pv_all), at(psk_all), at(psv_all),
                pmask.data_ptr()]
        Pc = pk_all.shape[3]
    lib = _build.library()
    dims = [B, Hkv, qg.shape[2] // G] + ([G] if entry.endswith("verify")
                                         else [])
    err = getattr(lib, entry)(
        qg.data_ptr(), at(ck_all), at(cv_all), at(sk_all), at(sv_all),
        kv_mask.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), slots.data_ptr(), *pptr, out.data_ptr(), *dims, T, Pc,
        D, _build.dtype_code(qg.dtype), _build.stream_of(qg))
    _build.check(err, entry)
    return out


def decode_attention_stacked_write_q(qg, ck_all, cv_all, sk_all, sv_all,
                                     kv_mask, k_new_q, v_new_q, k_new_s,
                                     v_new_s, layer: int, slots):
    """K7: int8-cache decode attention + in-place int8 slot write of row
    b's current token at slots[b] (a scalar slot is broadcast: lockstep
    generation).  CPU tensors run the plain version; CUDA tensors launch
    the kernel (or raise): bf16 q within SPLIT_ROWS rows the split body's
    CacheCols + Int8Cache instantiation (`int8_split_route`), f32 q or more
    rows the SIMT body.  A slot outside [0, T) is not written (the plain
    version raises on one)."""
    if qg.device.type == "cpu":
        return decode_attention_stacked_write_q_plain(
            qg, ck_all, cv_all, sk_all, sv_all, kv_mask, k_new_q, v_new_q,
            k_new_s, v_new_s, layer, slots)
    layer = int(layer)
    args = (k_new_q, v_new_q, k_new_s, v_new_s)
    _check_q("K7", qg, ck_all, cv_all, sk_all, sv_all, kv_mask, *args, layer,
             None, None)
    out = _launch_q("p2t_decode_attention_write_q", qg, ck_all, cv_all,
                    sk_all, sv_all, kv_mask, *args, layer,
                    _slots(slots, qg.shape[0], qg.device), None, 1)
    decode_attention_stacked_write_q.launches += 1
    return out


decode_attention_stacked_write_q.launches = 0


def decode_attention_stacked_write_q_prefix(
        qg, ck_all, cv_all, sk_all, sv_all, kv_mask, k_new_q, v_new_q,
        k_new_s, v_new_s, layer: int, slots, pk_all, pv_all, psk_all,
        psv_all, pmask):
    """K9b: K7 plus the int8 shared prefix, read-only, gated per row by
    pmask.  CPU tensors run the plain version; CUDA tensors launch the
    kernel (or raise): the split body where `int8_split_route` holds, the
    SIMT body otherwise."""
    if qg.device.type == "cpu":
        return decode_attention_stacked_write_q_prefix_plain(
            qg, ck_all, cv_all, sk_all, sv_all, kv_mask, k_new_q, v_new_q,
            k_new_s, v_new_s, layer, slots, pk_all, pv_all, psk_all,
            psv_all, pmask)
    layer = int(layer)
    args = (k_new_q, v_new_q, k_new_s, v_new_s)
    prefix = (pk_all, pv_all, psk_all, psv_all, pmask)
    _check_q("K9b", qg, ck_all, cv_all, sk_all, sv_all, kv_mask, *args,
             layer, None, prefix)
    out = _launch_q("p2t_decode_attention_write_q", qg, ck_all, cv_all,
                    sk_all, sv_all, kv_mask, *args, layer,
                    _slots(slots, qg.shape[0], qg.device), prefix, 1)
    decode_attention_stacked_write_q_prefix.launches += 1
    return out


decode_attention_stacked_write_q_prefix.launches = 0


def _chunk_slots(slots, B, G, T, slots_max, device):
    """(B,) int32 chunk starts on `device`; raises unless every chunk ends
    inside the cache (slots[b] + G <= T).  `slots_max`, when the caller
    knows it, spares the device→host read of the largest start."""
    slots = _slots(slots, B, device)
    hi = int(slots.max()) if slots_max is None else int(slots_max)
    if hi + G > T:
        raise ValueError(f"chunk start {hi} + G={G} exceeds the cache width "
                         f"T={T}")
    return slots


def decode_attention_stacked_verify_qc(qg, ck_all, cv_all, sk_all, sv_all,
                                       kv_mask, k_new_q, v_new_q, k_new_s,
                                       v_new_s, layer: int, slots, *,
                                       slots_max=None):
    """K8: chunk-verify attention over the int8 cache + in-place write of
    the chunk's G int8 rows and scales at [slots[b], slots[b] + G).  CPU
    tensors run the plain version; CUDA tensors launch the kernel (or
    raise, also when a chunk would end past the cache): bf16 q within
    SPLIT_ROWS = G·rep rows the split body's CacheCols + Int8Cache
    instantiation (`int8_split_route`), f32 q or more rows the SIMT
    body."""
    if qg.device.type == "cpu":
        return decode_attention_stacked_verify_qc_plain(
            qg, ck_all, cv_all, sk_all, sv_all, kv_mask, k_new_q, v_new_q,
            k_new_s, v_new_s, layer, slots)
    layer = int(layer)
    G = k_new_q.shape[2]
    args = (k_new_q, v_new_q, k_new_s, v_new_s)
    _check_q("K8", qg, ck_all, cv_all, sk_all, sv_all, kv_mask, *args, layer,
             G, None)
    slots = _chunk_slots(slots, qg.shape[0], G, ck_all.shape[3], slots_max,
                         qg.device)
    out = _launch_q("p2t_decode_attention_verify", qg, ck_all, cv_all,
                    sk_all, sv_all, kv_mask, *args, layer, slots, None, G)
    decode_attention_stacked_verify_qc.launches += 1
    return out


decode_attention_stacked_verify_qc.launches = 0


def decode_attention_stacked_verify_qc_prefix(
        qg, ck_all, cv_all, sk_all, sv_all, kv_mask, k_new_q, v_new_q,
        k_new_s, v_new_s, layer: int, slots, pk_all, pv_all, psk_all,
        psv_all, pmask, *, slots_max=None):
    """K9c: K8 plus the int8 shared prefix, read-only, gated per row by
    pmask.  CPU tensors run the plain version; CUDA tensors launch the
    kernel (or raise): the split body where `int8_split_route` holds, the
    SIMT body otherwise."""
    if qg.device.type == "cpu":
        return decode_attention_stacked_verify_qc_prefix_plain(
            qg, ck_all, cv_all, sk_all, sv_all, kv_mask, k_new_q, v_new_q,
            k_new_s, v_new_s, layer, slots, pk_all, pv_all, psk_all,
            psv_all, pmask)
    layer = int(layer)
    G = k_new_q.shape[2]
    args = (k_new_q, v_new_q, k_new_s, v_new_s)
    prefix = (pk_all, pv_all, psk_all, psv_all, pmask)
    _check_q("K9c", qg, ck_all, cv_all, sk_all, sv_all, kv_mask, *args,
             layer, G, prefix)
    slots = _chunk_slots(slots, qg.shape[0], G, ck_all.shape[3], slots_max,
                         qg.device)
    out = _launch_q("p2t_decode_attention_verify", qg, ck_all, cv_all,
                    sk_all, sv_all, kv_mask, *args, layer, slots, prefix, G)
    decode_attention_stacked_verify_qc_prefix.launches += 1
    return out


decode_attention_stacked_verify_qc_prefix.launches = 0
