"""K15a-K15g: the weight-quantized matmul variants of the TPU probe scripts
(CUDA C++), with the native int4 packer and the plain PyTorch versions.

Each kernel replaces an in-file Pallas kernel of a probe under `scripts/`:

- K15a `chunk_mm` (`scripts/bench_lmhead3.py:65`): int8 weight, converted
  to bf16 in chunks of `bc` k rows;
- K15b `mm_i4f` (`bench_int4_unpack.py:96`): split-half int4 bytes
  (`pack_int4`), unpacked in f32 arithmetic (floor);
- K15c `mm_i4n` (`bench_int4_unpack.py:138`): a native int4 weight
  (`pack_int4_native`);
- K15d `mm_i4p` (`bench_int4_planes.py:95`): K10's nibble planes over a
  tile sweep;
- K15e `mm_i4and` (`bench_int4_single.py:86`): split-half bytes unpacked
  with an AND;
- K15f `mm_i8i8` (`bench_int8_mxu.py:102`): int8 x int8 -> int32, exact,
  on the int8 tensor cores (`csrc/int8_mma.cu`);
- K15g `mm_mix` (`bench_int8_mxu.py:156`): bf16 x int8 -> f32, no scale.

K15a-K15e are K10/K14's few-row TMA body (`csrc/quant_matmul.cuh`) with a
weight policy each (`csrc/probe_quant_matmul.cu`) that varies only the
strategy its probe varies, on K10/K14's grid (`quant_matmul.
few_rows_tiling`; K15d maps its block width and K slice onto it); shapes
TMA cannot describe (`quant_matmul.few_fit`) take the same policies on the
ragged route (`csrc/quant_matmul_ragged.cuh`), as K10/K14 do.  K15g runs
K14's many-row body `csrc/quant_matmul_rows.cuh` (wgmma, 128 rows of a
block, the grid from `quant_matmul.rows_tiling`)
with no scale and an f32 output, at any K and N % 4 == 0 (a shape its TMA
boxes cannot take runs on a zero-padded copy); K15f runs the same body's
integer policy (`S8W` in `csrc/int8_mma.cu`: int8 x as it is, s8 wgmma,
int32 sums), on the same rule at 128 k values a tile (`i8_tiling`), its
weight zero-padded to N % 16 == 0 where needed (`_i8_weight`); the
sources state what bounds them.

Contract (as the probes' kernels): x (R, K) bfloat16 (the plain versions
take any float x and round it to bf16 first); y = (x @ q) * scale in fp32,
returned as bf16 (K15a-e), f32 without a scale (K15g) or the exact int32
product of int8 x (K15f).  The integer weights are exact in bf16, so only
the order of the fp32 sums and the output's rounding separate a kernel from
its plain version.

The native int4 layout is the port's own (a JAX `jnp.int4` array has no
byte layout a host can see): k rows 2i and 2i + 1 of column n in the low
and high nibble of byte [i, n], two's complement, so each byte is one
bf16 pair of the kernel's tensor-core fragment (CUTLASS's `int4b_t`
packing, two values per byte along the axis the kernel consumes in pairs).
"""

from __future__ import annotations

import torch

from . import _build
from . import quant_matmul as qm
from .quant_matmul import _splits, unpack_int4_planes

CHUNK_ROWS = (32, 64, 128, 256)     # K15a's bc: k rows converted per chunk
PLANE_BLOCK_COLS = (128, 256)       # K15d: output columns per block
MIX_BLOCK_ROWS = 128                # K15g: rows a block of the many-row body
I8_TILE_K = 128                     # K15f: k values a tile (128 int8 bytes)
# variant → (C variant code, weight dtype, k values per stored row, the
# quant_matmul format whose shape rule and bits it takes)
_VARIANTS = {
    "K15a": (0, torch.int8, 1, "int8"),
    "K15b": (1, torch.int8, 2, "bytes"),
    "K15c": (2, torch.int8, 2, "bytes"),
    "K15d": (3, torch.int32, 8, "planes"),
    "K15e": (4, torch.int8, 2, "bytes"),
    "K15f": (None, torch.int8, 1, "int8"),
    "K15g": (None, torch.int8, 1, "int8"),
}


def pack_int4_native(q):
    """q: (..., K, N) integers in [-8, 7] → (..., K/2, N) int8: byte [..., i,
    n] = (q[..., 2i, n] & 0xF) | (q[..., 2i + 1, n] << 4)."""
    K = q.shape[-2]
    if K % 2:
        raise ValueError(f"pack_int4_native needs an even K, got K={K}")
    q = q.to(torch.int8)
    return (q[..., 0::2, :] & 0xF) | (q[..., 1::2, :] << 4)


def unpack_int4_native(packed):
    """Inverse of `pack_int4_native`: (..., K/2, N) int8 → (..., K, N) int8
    in [-8, 7] (sign-extended nibbles: even rows (b << 28) >> 28, odd rows
    b >> 4)."""
    p = packed.to(torch.int32)
    lo, hi = (p << 28) >> 28, p >> 4
    out = torch.stack([lo, hi], dim=-2)            # (..., K/2, 2, N)
    return out.reshape(*p.shape[:-2], 2 * p.shape[-2],
                       p.shape[-1]).to(torch.int8)


def unpack_int4_floor(packed):
    """K15b's unpack of split-half bytes in f32 arithmetic (the probe's
    `_mm_i4f_kernel`): hi = floor(w / 16), lo = w - 16·hi, lo -= 16 where
    lo >= 8; (..., K/2, N) int8 → (..., K, N) float32 [lo rows; hi rows]."""
    wf = packed.float()
    hi = torch.floor(wf * (1.0 / 16.0))
    lo = wf - hi * 16.0
    lo = lo - torch.where(lo >= 8.0, 16.0, 0.0)
    return torch.cat([lo, hi], dim=-2)


def unpack_int4_and(packed):
    """K15e's AND unpack of split-half bytes (the probe's
    `_mm_i4and_kernel`): lo_u = w & 0xF, hi = (w - lo_u) / 16, lo = lo_u -
    16 where lo_u >= 8; (..., K/2, N) int8 → (..., K, N) float32."""
    lo_u = (packed & 0xF).float()
    hi = (packed.float() - lo_u) * (1.0 / 16.0)
    lo = lo_u - torch.where(lo_u >= 8.0, 16.0, 0.0)
    return torch.cat([lo, hi], dim=-2)


def _plain(x, w, scale):
    """(bf16(x) · w) · scale in fp32, as bf16; w holds exact integers."""
    y = torch.matmul(x.to(torch.bfloat16).float(), w.float())
    return (y * scale.reshape(-1).float()).to(torch.bfloat16)


def chunk_mm_plain(x, w_q, scale):
    return _plain(x, w_q, scale)


def mm_i4f_plain(x, wp, scale):
    return _plain(x, unpack_int4_floor(wp), scale)


def mm_i4n_plain(x, w4, scale):
    return _plain(x, unpack_int4_native(w4), scale)


def mm_i4p_plain(x, wp, scale):
    return _plain(x, unpack_int4_planes(wp), scale)


def mm_i4and_plain(x, wp, scale):
    return _plain(x, unpack_int4_and(wp), scale)


def mm_i8i8_plain(x, w):
    """The exact int32 product: every partial sum is an integer below 2^53,
    so float64 holds it exactly on either device."""
    return torch.matmul(x.double(), w.double()).to(torch.int32)


def mm_mix_plain(x, w):
    return torch.matmul(x.to(torch.bfloat16).float(), w.float())


def _check(name, x, w, scale, kid, xdtype=torch.bfloat16):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if x.dtype != xdtype:
        raise TypeError(f"{name}: x must be {xdtype}, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] == 0 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (R > 0, K) "
                         f"tensor, got {tuple(x.shape)}")
    _, wdt, per, _ = _VARIANTS[kid]
    if w.dtype != wdt or w.dim() != 2 or not w.is_contiguous():
        raise ValueError(f"{name}: the weight must be a contiguous "
                         f"({f'K/{per}' if per > 1 else 'K'}, N) {wdt} "
                         f"tensor, got {w.dtype} {tuple(w.shape)}")
    K, N = w.shape[0] * per, w.shape[1]
    if x.shape[1] != K:
        raise ValueError(f"{name}: x has K={x.shape[1]}, the weight {K}")
    if N % 4 or w.data_ptr() % 16:
        raise ValueError(f"{name}: N must be a multiple of 4 and the weight "
                         f"16-byte aligned (N={N})")
    if scale is not None and (scale.dtype != torch.float32
                              or scale.numel() != N
                              or not scale.is_contiguous()):
        raise ValueError(f"{name}: scale must hold N={N} contiguous float32 "
                         f"values, got {scale.dtype} {tuple(scale.shape)}")
    for n, t in (("weight", w), ("scale", scale)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: {n} on {t.device}, x on {dev}")


def _launch(kid, x, w, scale, param: int = 0, tiling=None, splits=None):
    """One K15a-e launch into a new (R, N) bf16 output: the few-row TMA
    body where `quant_matmul.few_fit` holds for the variant's format, on
    `tiling` (columns, cluster, stages; default K10/K14's
    `few_rows_tiling`), else the ragged route with `splits` slices of K
    (default `_splits`) and their fp32 scratch."""
    R, K = x.shape
    N = w.shape[-1]
    code, _, _, fmt = _VARIANTS[kid]
    bits = qm._FORMATS[fmt][2]
    out = torch.empty((R, N), dtype=torch.bfloat16, device=x.device)
    lib = _build.library()
    if qm.few_fit(fmt, K, N, w.data_ptr()):
        _, ck, stages = tiling or qm.few_rows_tiling(R, K, N, bits)
        if kid == "K15a":                   # a chunk's tiles, and one more
            stages = max(stages, param // qm.FEW_TILE_K[8] + 1)
        x = qm._aligned(x)
        err = lib.p2t_probe_quant_matmul_few(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), R,
            K, N, code, param, ck, stages, _build.stream_of(x))
        _build.check(err, f"p2t_probe_quant_matmul_few ({kid})")
        return out
    if splits is None:
        splits = _splits(R, K, N, bits)
    partial = (torch.empty((splits, R, N), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    err = lib.p2t_probe_quant_matmul(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), R, K, N, code,
        param, splits, _build.stream_of(x))
    _build.check(err, f"p2t_probe_quant_matmul ({kid})")
    return out


def chunk_mm(x, w_q, scale, bc: int = 256):
    """K15a: x (R, K) bf16 · w_q (K, N) int8 · scale (N,), the weight
    converted in chunks of `bc` k rows (32, 64, 128 or 256) → (R, N) bf16.
    CPU tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if x.device.type == "cpu":
        return chunk_mm_plain(x, w_q, scale)
    if bc not in CHUNK_ROWS:
        raise ValueError(f"K15a: bc must be one of {CHUNK_ROWS}, got {bc}")
    _check("K15a", x, w_q, scale, "K15a")
    out = _launch("K15a", x, w_q, scale, bc)
    chunk_mm.launches += 1
    return out


chunk_mm.launches = 0


def mm_i4f(x, wp, scale):
    """K15b: x (R, K) bf16 · unpack(wp (K/2, N) int8 split-half bytes) ·
    scale (N,), each byte unpacked in f32 arithmetic → (R, N) bf16.  CPU
    tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if x.device.type == "cpu":
        return mm_i4f_plain(x, wp, scale)
    _check("K15b", x, wp, scale, "K15b")
    out = _launch("K15b", x, wp, scale)
    mm_i4f.launches += 1
    return out


mm_i4f.launches = 0


def mm_i4n(x, w4, scale):
    """K15c: x (R, K) bf16 · unpack(w4 (K/2, N) int8, `pack_int4_native`)
    · scale (N,) → (R, N) bf16.  CPU tensors run the plain version; CUDA
    tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return mm_i4n_plain(x, w4, scale)
    _check("K15c", x, w4, scale, "K15c")
    out = _launch("K15c", x, w4, scale)
    mm_i4n.launches += 1
    return out


mm_i4n.launches = 0


def _check_split_k8(split_k8):
    if split_k8 is not None and (split_k8 <= 0 or split_k8 % 4):
        raise ValueError(f"K15d: split_k8 must be a positive multiple of 4 "
                         f"(a 32-k step is 4 word rows), got {split_k8}")


def plane_splits(K: int, split_k8: int | None, R: int, N: int) -> int:
    """K15d's split of K on the few-row TMA body, the cluster: `split_k8`
    word rows (8·split_k8 k values) a rank, as far as the body's cluster of
    `FEW_MAX_CLUSTER` and non-empty ranks allow; None: K10's rule
    (`few_rows_tiling`)."""
    _check_split_k8(split_k8)
    if split_k8 is None:
        return qm.few_rows_tiling(R, K, N, 4)[1]
    tiles = -(-K // qm.FEW_TILE_K[4])
    ck = min(qm.FEW_MAX_CLUSTER, tiles, -(-(K // 8) // split_k8))
    while ck > 1 and (ck - 1) * -(-tiles // ck) >= tiles:
        ck -= 1
    return ck


def _ragged_plane_splits(K: int, split_k8: int | None, R: int,
                         N: int) -> int:
    """K15d's slices of K on the ragged route: `split_k8` word rows per
    block, or K10's ragged rule when None."""
    if split_k8 is None:
        return _splits(R, K, N, 4)
    steps = -(-K // 32)
    per = min(steps, split_k8 // 4)
    return -(-steps // per)


def mm_i4p(x, wp, scale, block_cols: int = 128, split_k8: int | None = None):
    """K15d: x (R, K) bf16 · unpack(wp (K/8, N) int32 nibble planes) ·
    scale (N,) → (R, N) bf16 (K10's function), tiled by `block_cols`
    output columns per block (128 or 256) and `split_k8` word rows of K
    per cluster rank (`plane_splits`; None: K10's grid, on which at 128
    columns it is K10, bit for bit).  CPU tensors run the plain version;
    CUDA tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return mm_i4p_plain(x, wp, scale)
    if block_cols not in PLANE_BLOCK_COLS:
        raise ValueError(f"K15d: block_cols must be one of "
                         f"{PLANE_BLOCK_COLS}, got {block_cols}")
    _check_split_k8(split_k8)
    _check("K15d", x, wp, scale, "K15d")
    R, K = x.shape
    N = wp.shape[1]
    ck = plane_splits(K, split_k8, R, N)
    out = _launch("K15d", x, wp, scale, block_cols,
                  qm.few_rows_tiling(R, K, N, 4, block_cols, ck),
                  _ragged_plane_splits(K, split_k8, R, N))
    mm_i4p.launches += 1
    return out


mm_i4p.launches = 0


def mm_i4and(x, wp, scale):
    """K15e: x (R, K) bf16 · unpack(wp (K/2, N) int8 split-half bytes) ·
    scale (N,), each byte unpacked with an AND → (R, N) bf16.  CPU tensors
    run the plain version; CUDA tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return mm_i4and_plain(x, wp, scale)
    _check("K15e", x, wp, scale, "K15e")
    out = _launch("K15e", x, wp, scale)
    mm_i4and.launches += 1
    return out


mm_i4and.launches = 0


def _mix_operands(x, w):
    """K15g's operands as the many-row body takes them: where `quant_matmul.
    rows_fit` fails (its TMA boxes need K % 8 == 0 and N % 16 == 0), x and
    w zero-padded to the next such K and N (the zero products leave every
    sum as it was; the caller drops the padded columns)."""
    K, N = w.shape
    if qm.rows_fit("int8", K, N, w.data_ptr()):
        return x, w
    Kp, Np = -(-K // 8) * 8, -(-N // 16) * 16
    xp = x.new_zeros((x.shape[0], Kp))
    xp[:, :K] = x
    wp = w.new_zeros((Kp, Np))
    wp[:K, :N] = w
    return xp, wp


def mm_mix(x, w):
    """K15g: x (R, K) bf16 · w (K, N) int8 → (R, N) f32, no scale, on the
    many-row body at 128 rows a block (`quant_matmul.rows_tiling` picks the
    rest of its grid; a K or N the body's copies cannot take runs on a
    zero-padded copy, `_mix_operands`).  CPU tensors run the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return mm_mix_plain(x, w)
    _check("K15g", x, w, None, "K15g")
    R, N = x.shape[0], w.shape[1]
    xk, wk = _mix_operands(x, w)
    tiling = qm.rows_tiling(R, xk.shape[1], wk.shape[1],
                            qm._sm_count(x.device.index or 0),
                            bm=MIX_BLOCK_ROWS)
    out = torch.empty((R, wk.shape[1]), dtype=torch.float32, device=x.device)
    qm.rows_matmul(xk, wk.data_ptr(), None, out, "int8", tiling)
    mm_mix.launches += 1
    return out if wk.shape[1] == N else out[:, :N].contiguous()


mm_mix.launches = 0


def i8_tiling(R: int, K: int, N: int, sms: int = 132):
    """K15f's grid on the many-row body: (rows a block, columns a block, K
    split over a cluster) by K14's rule (`quant_matmul.rows_tiling`, rows
    following R) at `I8_TILE_K` k values a tile."""
    return qm.rows_tiling(R, K, N, sms, tile_k=I8_TILE_K)


def _i8_weight(w):
    """K15f's weight as the body's TMA box takes it: as it is where N % 16
    == 0 (the row stride), else zero-padded to the next multiple of 16
    columns (the zero columns' sums are dropped by the caller)."""
    K, N = w.shape
    if N % 16 == 0:
        return w
    wp = w.new_zeros((K, -(-N // 16) * 16))
    wp[:, :N] = w
    return wp


def mm_i8i8(x, w, tiling=None):
    """K15f: x (R, K) int8 · w (K, N) int8 → (R, N) int32, exact, on the
    many-row body's s8 wgmma policy (K % 16 == 0, N % 4 == 0; `tiling`
    (bm, bn, ck), default `i8_tiling`).  CPU tensors run the plain version;
    CUDA tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return mm_i8i8_plain(x, w)
    _check("K15f", x, w, None, "K15f", xdtype=torch.int8)
    R, K = x.shape
    if K % 16 or x.data_ptr() % 16:
        raise ValueError(f"K15f: K must be a multiple of 16 and x 16-byte "
                         f"aligned (K={K})")
    N = w.shape[1]
    wk = _i8_weight(w)
    Np = wk.shape[1]
    bm, bn, ck = tiling or i8_tiling(R, K, Np,
                                     qm._sm_count(x.device.index or 0))
    out = torch.empty((R, Np), dtype=torch.int32, device=x.device)
    err = _build.library().p2t_int8_mma(
        x.data_ptr(), wk.data_ptr(), out.data_ptr(), R, K, Np, bm, bn, ck,
        _build.stream_of(x))
    _build.check(err, "p2t_int8_mma")
    mm_i8i8.launches += 1
    return out if Np == N else out[:, :N].contiguous()


mm_i8i8.launches = 0
