"""K15h-K15l: the int8 KV-cache probes of `scripts/probe_int8_kv.py` (CUDA
C++, `csrc/probe_int8_kv.cu`), with their plain PyTorch versions.

- K15h `f32_to_int8_store` (`:38 p1_f32_to_int8_store`): o =
  int8(clip(round(mult·x), -127, 127)), round half to even;
- K15i `int8_select` (`:50 p2_int8_select`): o = where(row index == row, a,
  b) over (rows, cols) int8;
- K15j `int8_group_rmw` (`:62 p3_dynamic_int8_group_rmw`): in place,
  cache[b, h, slot, :] = kn[b, h, :] on an int8 (B, Hkv, T, D) cache;
- K15k `int8_to_bf16_matmul` (`:96 p4_int8_to_bf16_matmul`): logits = (q @
  bf16(c)ᵀ) · s, q (Q, D) bf16, c (T, D) int8, s (1, T) f32 → (Q, T) f32,
  on the tensor cores (`mma.sync`, D a multiple of 16);
- K15l `f32_scale_row_rmw` (`:116 p5_f32_scale_row_rmw`): in place,
  s[b, h, slot] = sn[b, h] on an f32 (B, Hkv, T) scale row.

K15j and K15l take `slot` as a one-element int32 tensor on the buffer's
device, read by the kernel (the Pallas kernels prefetched it as a scalar):
the wrappers never sync it to the host.  A slot outside [0, T) writes
nothing.  K15h, K15i, K15j and K15l move words of up to 16 bytes in
chained launches; at the probes' sizes each is about a launch, so their
wrappers keep the host path short: one device comparison a tensor, shape
arithmetic instead of a view, `empty_like` for an output (no shape,
dtype and device to parse), and the launch on the raw stream.  The
probes' TPU kernels p3 and p5 alias operand 1 (`kn`, `sn`) to the output
where the cache is operand 2, so under JAX 0.9 they raise before running;
the port writes the cache, as the probes' asserts intend.
"""

from __future__ import annotations

import torch

from . import _build


def f32_to_int8_store_plain(x, mult: float = 4.0):
    return torch.clamp(torch.round(x.float() * mult), -127, 127).to(
        torch.int8)


def int8_select_plain(a, b, row: int = 7):
    rows = torch.arange(a.shape[0], device=a.device)[:, None]
    return torch.where(rows == row, a, b)


def _slot_in_range(slot, T: int):
    s = int(slot.reshape(-1)[0])
    return s if 0 <= s < T else None


def int8_group_rmw_plain(cache, kn, slot):
    s = _slot_in_range(slot, cache.shape[-2])
    if s is not None:
        cache[..., s, :] = kn.reshape(cache.shape[:-2] + (cache.shape[-1],))
    return cache


def int8_to_bf16_matmul_plain(q, c, s):
    return torch.matmul(q.to(torch.bfloat16).float(),
                        c.float().t()) * s.reshape(1, -1).float()


def f32_scale_row_rmw_plain(s, sn, slot):
    col = _slot_in_range(slot, s.shape[-1])
    if col is not None:
        s[..., col] = sn.reshape(s.shape[:-1])
    return s


def _cuda(name, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: every operand must be a contiguous "
                             f"tensor on {dev}")


def _slot(name, slot, dev):
    if (slot.dtype != torch.int32 or slot.numel() != 1
            or slot.device != dev):
        raise ValueError(f"{name}: slot must be one int32 value on {dev}, "
                         f"got {slot.dtype} {tuple(slot.shape)} on "
                         f"{slot.device}")


def f32_to_int8_store(x, mult: float = 4.0):
    """K15h: int8(clip(round(mult·x), -127, 127)) of an f32 tensor.  CPU
    tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if x.is_cpu:
        return f32_to_int8_store_plain(x, mult)
    _cuda("K15h", x)
    n = x.numel()
    if x.dtype != torch.float32 or n == 0:
        raise TypeError(f"K15h: x must be a non-empty float32 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    out = torch.empty_like(x, dtype=torch.int8)     # x is contiguous
    err = _build.library().p2t_int8_quantize_store(
        x.data_ptr(), out.data_ptr(), n, float(mult), _build.stream_of(x))
    _build.check(err, "p2t_int8_quantize_store")
    f32_to_int8_store.launches += 1
    return out


f32_to_int8_store.launches = 0


def int8_select(a, b, row: int = 7):
    """K15i: row `row` of a, every other row of b, (rows, cols) int8 (a
    row outside [0, rows) gives b).  CPU tensors run the plain version;
    CUDA tensors launch the kernel (or raise)."""
    if a.is_cpu:
        return int8_select_plain(a, b, row)
    _cuda("K15i", a, b)
    shape = a.shape
    if (a.dtype != torch.int8 or b.dtype != torch.int8 or len(shape) != 2
            or b.shape != shape or shape[0] * shape[1] == 0):
        raise ValueError(f"K15i: a and b must be (rows, cols) int8 of one "
                         f"shape, got {a.dtype} {tuple(shape)}, {b.dtype} "
                         f"{tuple(b.shape)}")
    rows, cols = shape
    row = int(row)
    out = torch.empty_like(a)                       # a is contiguous
    err = _build.library().p2t_int8_select_row(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), rows, cols,
        row if 0 <= row < rows else -1, _build.stream_of(a))
    _build.check(err, "p2t_int8_select_row")
    int8_select.launches += 1
    return out


int8_select.launches = 0


def int8_group_rmw(cache, kn, slot):
    """K15j, in place: cache (B, Hkv, T, D) int8 gets kn (B·Hkv rows of D:
    (Hkv, D) or (B, Hkv, D)) at slot `slot` (one int32 on the cache's
    device, read by the kernel); returns cache.  CPU tensors run the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if cache.device.type == "cpu":
        return int8_group_rmw_plain(cache, kn, slot)
    _cuda("K15j", cache, kn)
    _slot("K15j", slot, cache.device)
    shape = cache.shape
    if cache.dtype != torch.int8 or kn.dtype != torch.int8 or \
            len(shape) != 4 or kn.numel() != shape[0] * shape[1] * shape[3]:
        raise ValueError(f"K15j: cache must be (B, Hkv, T, D) int8 and kn "
                         f"its B·Hkv·D int8 values, got {cache.dtype} "
                         f"{tuple(shape)}, {kn.dtype} {tuple(kn.shape)}")
    B, H, T, D = shape
    err = _build.library().p2t_int8_group_row_write(
        cache.data_ptr(), kn.data_ptr(), slot.data_ptr(), B * H, T, D,
        _build.stream_of(cache))
    _build.check(err, "p2t_int8_group_row_write")
    int8_group_rmw.launches += 1
    return cache


int8_group_rmw.launches = 0


LOGITS_MAX_D = 512          # csrc kLogitMaxD


def int8_to_bf16_matmul(q, c, s):
    """K15k: (q (Q, D) bf16 @ bf16(c (T, D) int8)ᵀ) · s (T values, f32) →
    (Q, T) f32.  CPU tensors run the plain version; CUDA tensors launch the
    tensor-core kernel (or raise: D a multiple of 16 up to LOGITS_MAX_D, q
    and c 16-byte aligned)."""
    if q.device.type == "cpu":
        return int8_to_bf16_matmul_plain(q, c, s)
    _cuda("K15k", q, c, s)
    if (q.dtype != torch.bfloat16 or c.dtype != torch.int8
            or s.dtype != torch.float32 or q.dim() != 2 or c.dim() != 2
            or q.shape[1] != c.shape[1] or s.numel() != c.shape[0]
            or q.numel() == 0 or c.numel() == 0):
        raise ValueError(f"K15k: q (Q, D) bf16, c (T, D) int8 and s (T,) "
                         f"f32, got {q.dtype} {tuple(q.shape)}, {c.dtype} "
                         f"{tuple(c.shape)}, {s.dtype} {tuple(s.shape)}")
    Q, D = q.shape
    T = c.shape[0]
    if D % 16 or D > LOGITS_MAX_D:
        raise ValueError(f"K15k: D must be a multiple of 16 up to "
                         f"{LOGITS_MAX_D} (16-byte c rows), got {D}")
    for name, t in (("q", q), ("c", c)):
        if t.data_ptr() % 16:
            raise ValueError(f"K15k: {name} must be 16-byte aligned "
                             f"(cp.async), got address {t.data_ptr():#x}")
    out = torch.empty((Q, T), dtype=torch.float32, device=q.device)
    err = _build.library().p2t_int8_kv_logits(
        q.data_ptr(), c.data_ptr(), s.data_ptr(), out.data_ptr(), Q, T, D,
        _build.stream_of(q))
    _build.check(err, "p2t_int8_kv_logits")
    int8_to_bf16_matmul.launches += 1
    return out


int8_to_bf16_matmul.launches = 0


def f32_scale_row_rmw(s, sn, slot):
    """K15l, in place: s (B, Hkv, T) f32 gets sn (B·Hkv values: (Hkv, 1) or
    (B, Hkv)) at column `slot` (one int32 on s's device, read by the
    kernel); returns s.  CPU tensors run the plain version; CUDA tensors
    launch the kernel (or raise)."""
    if s.device.type == "cpu":
        return f32_scale_row_rmw_plain(s, sn, slot)
    _cuda("K15l", s, sn)
    _slot("K15l", slot, s.device)
    shape = s.shape
    if (s.dtype != torch.float32 or sn.dtype != torch.float32
            or len(shape) != 3 or sn.numel() != shape[0] * shape[1]):
        raise ValueError(f"K15l: s must be (B, Hkv, T) f32 and sn its B·Hkv "
                         f"f32 values, got {s.dtype} {tuple(shape)}, "
                         f"{sn.dtype} {tuple(sn.shape)}")
    B, H, T = shape
    err = _build.library().p2t_scale_column_write(
        s.data_ptr(), sn.data_ptr(), slot.data_ptr(), B * H, T,
        _build.stream_of(s))
    _build.check(err, "p2t_scale_column_write")
    f32_scale_row_rmw.launches += 1
    return s


f32_scale_row_rmw.launches = 0
