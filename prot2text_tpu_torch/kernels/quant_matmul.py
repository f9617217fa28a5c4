"""K10, K11 and K14: weight-quantized matmuls for serving and decoding
(CUDA C++), with the int4 packers and the plain PyTorch versions.

K10 replaces prot2text_tpu/kernels/quant_matmul.py
`quant_matmul_int4_planes` (`_mm_i4p_kernel`) and
`quant_matmul_int4_planes_stacked` (`_mm_i4p_stacked_kernel`); K11a
replaces `quant_matmul_int4` (`_mm_i4_kernel`) and
`quant_matmul_int4_stacked` (`_mm_i4_stacked_kernel`), the split-half
bytes; K11b replaces `quant_matmul_int4_pairs` (`_mm_i4w_kernel`) and
`quant_matmul_int4_pairs_stacked` (`_mm_i4w_stacked_kernel`), the bf16-pair
words; K14 replaces `quant_matmul_int8` (`_mm_i8_kernel`) and
`quant_matmul_int8_stacked` (`_mm_i8_stacked_kernel`).  Three routes carry
them, each body's header stating what bounds it and what its design does
about that (`route` is the rule):

- up to `FEW_ROWS` rows, the few-row TMA body `csrc/quant_matmul.cuh`
  (entry `p2t_quant_matmul_few` in `csrc/quant_matmul.cu`, K11's
  instantiations in `csrc/quant_matmul_int4.cu`): the weight streams
  through a TMA ring in shared memory, x is staged once per block, K is
  split over a thread-block cluster summed through distributed shared
  memory, on the grid that `few_rows_tiling` picks; one launch, no scratch;
- above `FEW_ROWS` rows, the many-row `wgmma` body
  `csrc/quant_matmul_rows.cuh` (entry `csrc/quant_matmul_rows.cu`, K11's
  instantiations in `csrc/quant_matmul_rows_int4.cu`) on the grid that
  `rows_tiling` picks;
- at every row count, where TMA cannot describe the weight (`few_fit` /
  `rows_fit`: a row stride off 16 bytes, an int4 K off the 64-value tile,
  an unaligned base, or an x slice past a block's shared memory), the
  ragged route `csrc/quant_matmul_ragged.cuh`: the body the few-row calls
  ran before, whose split of K goes through an fp32 scratch buffer and a
  second launch.  It is chosen by the shape alone, never on a failure,
  and no projection of the port's models (Qwen3-14B, Llama-3.1-8B, ESMC)
  takes it.

The TPU's stacked variants exist because a Pallas operand must be a
materialized buffer; here the stacked wrappers pass layer `layer`'s base
pointer into the (L, ...) buffer, so both entry points share each body.
The decode path needs only the unstacked wrappers: `models/transformer.py
linear` hands them each layer's zero-copy view of the stacked buffer
(`layer_views`); the stacked ones keep the JAX package's names.

Contract (as the JAX kernels): x (R, K) float32 or bfloat16, ROUNDED TO
BF16 before the product; W int4 planes (K/8, N) int32 — nibble j of word
[k8, n] holds w[k8 + j·K/8, n] (`pack_int4_planes`) —, split-half bytes
(K/2, N) int8 — byte [k2, n] holds w[k2, n] low and w[k2 + K/2, n] high
(`pack_int4`) —, bf16-pair words (K/8, N) int32 — bits [4p, 4p+4) hold
w[k8 + 2p·K/8, n] + 8, bits [16+4p, 20+4p) w[k8 + (2p+1)·K/8, n] + 8
(`pack_int4_pairs`) — or int8 (K, N); scale (1, N) or (N,) float32
(stacked: (L, 1, N)); fp32 accumulation, the scale applied in the fp32
epilogue, the result (R, N) in x's dtype.  The integer values are exact in
bf16, so only x's rounding and the order of the sums separate the kernel
from its plain version.  JAX's TPU pairs kernel instead removes the words'
+136 bf16 bias as 136·rowsum(x) in its epilogue, a cancellation of about
4e-6 of max|y| (its `:410-424`); the port's kernel and plain version are
exact.  The three int4 formats build the same tensor-core fragments in
each body and take the same grid, so on the same integers K11a and K11b
equal K10 bit for bit wherever they take the same route (the ragged one:
K % 8 == 0).

The decoder calls all four on a bf16 x at every row count, and on an f32
x for at most `QUANT_KERNEL_ROWS` rows (`models/transformer.py linear`);
the kernels themselves take any R and any N.
"""

from __future__ import annotations

import functools

import torch

from . import _build

# rows at or below which the decoder's projections of an f32 x take their
# kernels (prot2text_tpu/models/transformer.py:97-128, decoder.py:491-525)
QUANT_KERNEL_ROWS = 256
# rows at or below which the kernels run the few-row body; above, the
# many-row body (the crossover measured on an H100: PERF.md §6,
# scripts/sweep_quant_rows.py)
FEW_ROWS = 8
# the few-row TMA body (csrc/quant_matmul.cuh): k values of a ring stage
# by the weight's bits (8 KB at 128 columns either way), the ring's bytes a
# block (4 stages), a block's shared memory, the largest (portable) cluster
FEW_TILE_K = {4: 128, 8: 64}
FEW_RING_BYTES = 32 * 1024
FEW_SMEM = 232448
FEW_MAX_CLUSTER = 8
# the many-row body (csrc/quant_matmul_rows.cuh): k values of a tile, the
# rows (wgmma's N) and columns of a block, the K splits of a cluster and
# the K tiles a cluster rank sums at least
ROWS_TILE_K = 64
ROWS_BLOCK_ROWS = (64, 128, 256)
ROWS_BLOCK_COLS = (256, 128)
ROWS_CLUSTERS = (1, 2, 4, 8)
ROWS_MIN_TILES = 16
_BLOCK_COLS = 128               # csrc/quant_matmul_ragged.cuh kBlockCols
_BLOCK_ROWS = 64                # at most 8 MMA tiles of 8 rows per block
_STEP_K = {4: 32, 8: 16}        # k values per K step (Fmt::kStepK)
# weight format → (dtype, k values per stored row, bits, the ragged route's
# C entry point and its format argument, the many-row body's format code
# (csrc/quant_matmul_rows.cuh rows::Format), the few-row body's
# (csrc/quant_matmul_ragged.cuh Format))
_FORMATS = {
    "planes": (torch.int32, 8, 4, "p2t_quant_matmul", 4, 1, 0),
    "int8": (torch.int8, 1, 8, "p2t_quant_matmul", 8, 0, 3),
    "bytes": (torch.int8, 2, 4, "p2t_quant_matmul_int4", 0, 2, 2),
    "pairs": (torch.int32, 8, 4, "p2t_quant_matmul_int4", 1, 3, 1),
}
_TARGET_BLOCKS = 792            # about six resident blocks per SM
_MIN_SPLIT_STEPS = 8            # K steps per slice: 256 (int4) / 128 k


def _pick_block(dim: int, candidates):
    for c in candidates:
        if dim % c == 0:
            return c
    return None


def supports_quant_matmul(K: int, N: int, bits: int = 8) -> bool:
    """The TPU kernels' tiling gate (prot2text_tpu/kernels/quant_matmul.py:
    79): N a multiple of 128 and K (int4 split-half: K/2) of 32."""
    Keff = K // 2 if bits == 4 else K
    return (_pick_block(N, (1024, 512, 256, 128)) is not None
            and _pick_block(Keff, (1024, 512, 256, 128, 64, 32))
            is not None)


def supports_quant_matmul_planes(K: int, N: int) -> bool:
    """The nibble-plane kernel's gate (`:86`): K % 8 == 0, N a multiple of
    128 and K/8 of 8."""
    return (K % 8 == 0
            and _pick_block(N, (1024, 512, 256, 128)) is not None
            and _pick_block(K // 8, (256, 128, 64, 32, 16, 8)) is not None)


# the bf16-pair words tile as the planes do (K/8 words per column)
supports_quant_matmul_pairs = supports_quant_matmul_planes


def pack_int4(q):
    """q: (..., K, N) integers in [-8, 7] → (..., K/2, N) int8 split-half
    bytes: byte [..., k, n] = (q[..., k, n] & 0xF) | (q[..., k + K/2, n]
    << 4) (bit-identical to the JAX packer)."""
    K = q.shape[-2]
    if K % 2:
        raise ValueError(f"pack_int4 needs an even K, got K={K}")
    q = q.to(torch.int8)
    return (q[..., :K // 2, :] & 0xF) | (q[..., K // 2:, :] << 4)


def unpack_int4(packed):
    """Inverse of `pack_int4`: (..., K/2, N) int8 → (..., K, N) int8 in
    [-8, 7] (sign-extended nibbles: low (b << 28) >> 28, high b >> 4)."""
    p = packed.to(torch.int32)
    return torch.cat([(p << 28) >> 28, p >> 4], dim=-2).to(torch.int8)


def pack_int4_pairs(q):
    """q: (..., K, N) integers in [-8, 7] → (..., K/8, N) int32 bf16-pair
    words: plane j = rows [j·K/8, (j+1)·K/8) plus 8, plane 2p in bits
    [4p, 4p+4) and plane 2p+1 in bits [16+4p, 20+4p) (bit-identical to the
    JAX packer)."""
    K = q.shape[-2]
    if K % 8:
        raise ValueError(f"pack_int4_pairs needs K % 8 == 0, got K={K}")
    K8 = K // 8
    qb = (q.to(torch.int32) + 8) & 0xF
    out = torch.zeros(q.shape[:-2] + (K8, q.shape[-1]), dtype=torch.int32,
                      device=q.device)
    for p in range(4):
        out |= qb[..., 2 * p * K8:(2 * p + 1) * K8, :] << (4 * p)
        out |= qb[..., (2 * p + 1) * K8:(2 * p + 2) * K8, :] << (16 + 4 * p)
    return out


def unpack_int4_pairs(packed):
    """Inverse of `pack_int4_pairs`: (..., K/8, N) int32 → (..., K, N) int8
    in [-8, 7]."""
    planes = []
    for p in range(4):
        planes.append(((packed >> (4 * p)) & 0xF) - 8)
        planes.append(((packed >> (16 + 4 * p)) & 0xF) - 8)
    return torch.cat(planes, dim=-2).to(torch.int8)


def pack_int4_planes(q):
    """q: (..., K, N) integers in [-8, 7] → (..., K/8, N) int32 words whose
    nibble j holds q[..., k8 + j·K/8, :] (bit-identical to the JAX
    packer)."""
    K = q.shape[-2]
    if K % 8:
        raise ValueError(f"pack_int4_planes needs K % 8 == 0, got K={K}")
    K8 = K // 8
    qs = q.to(torch.int32) & 0xF
    out = torch.zeros(q.shape[:-2] + (K8, q.shape[-1]), dtype=torch.int32,
                      device=q.device)
    for j in range(8):
        out |= qs[..., j * K8:(j + 1) * K8, :] << (4 * j)
    return out


def unpack_int4_planes(packed):
    """Inverse of `pack_int4_planes`: (..., K/8, N) int32 → (..., K, N)
    int8 in [-8, 7] (sign-extended nibbles: (w << (28 - 4j)) >> 28)."""
    return torch.cat([((packed << (28 - 4 * j)) >> 28).to(torch.int8)
                      for j in range(8)], dim=-2)


def _plain(x, w, scale):
    """(bf16(x) · w) · scale in fp32, in x's dtype; w holds exact ints."""
    y = torch.matmul(x.to(torch.bfloat16).float(), w.float())
    return (y * scale.reshape(-1).float()).to(x.dtype)


def quant_matmul_int4_planes_plain(x, w_planes, scale):
    return _plain(x, unpack_int4_planes(w_planes), scale)


def quant_matmul_int4_planes_stacked_plain(x, w_planes_all, scale_all,
                                           layer: int):
    return quant_matmul_int4_planes_plain(x, w_planes_all[layer],
                                          scale_all[layer])


def quant_matmul_int4_plain(x, w_packed, scale):
    return _plain(x, unpack_int4(w_packed), scale)


def quant_matmul_int4_stacked_plain(x, w_packed_all, scale_all, layer: int):
    return quant_matmul_int4_plain(x, w_packed_all[layer], scale_all[layer])


def quant_matmul_int4_pairs_plain(x, w_pairs, scale):
    return _plain(x, unpack_int4_pairs(w_pairs), scale)


def quant_matmul_int4_pairs_stacked_plain(x, w_pairs_all, scale_all,
                                          layer: int):
    return quant_matmul_int4_pairs_plain(x, w_pairs_all[layer],
                                         scale_all[layer])


def quant_matmul_int8_plain(x, w_q, scale):
    return _plain(x, w_q, scale)


def quant_matmul_int8_stacked_plain(x, w_q_all, scale_all, layer: int):
    return quant_matmul_int8_plain(x, w_q_all[layer], scale_all[layer])


def _steps(K: int, bits: int) -> int:
    return -(-K // _STEP_K[bits])


def _splits(R: int, K: int, N: int, bits: int) -> int:
    """The ragged route's slices of K across blocks: enough that about
    `_TARGET_BLOCKS` blocks run, each slice at least `_MIN_SPLIT_STEPS`
    steps, the partial sums (written and read once more) at most a quarter
    of the weight bytes, no empty slice."""
    steps = _steps(K, bits)
    blocks = -(-R // _BLOCK_ROWS) * -(-N // _BLOCK_COLS)
    weight_bytes = K * N // (2 if bits == 4 else 1)
    s = max(1, min(-(-_TARGET_BLOCKS // blocks), steps // _MIN_SPLIT_STEPS,
                   weight_bytes // (16 * R * N)))
    per = -(-steps // s)
    return -(-steps // per)


def _check(name, x, w, scale, fmt, stacked, layer):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 2 or x.shape[0] == 0 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (R > 0, K) "
                         f"tensor, got {tuple(x.shape)}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError(f"{name} has no backward: a product whose x "
                         f"requires grad takes the dequantized weight "
                         f"(models/transformer.py linear)")
    wdt, per = _FORMATS[fmt][:2]
    lead = 1 if stacked else 0
    if w.dtype != wdt or w.dim() != 2 + lead or not w.is_contiguous():
        raise ValueError(f"{name}: the weight must be a contiguous "
                         f"{'(L, ' if stacked else '('}"
                         f"{f'K/{per}' if per > 1 else 'K'}, N) {wdt} "
                         f"tensor, got {w.dtype} {tuple(w.shape)}")
    K = w.shape[-2] * per
    N = w.shape[-1]
    if x.shape[1] != K:
        raise ValueError(f"{name}: x has K={x.shape[1]}, the weight {K}")
    if stacked:
        L = w.shape[0]
        if scale.dtype != torch.float32 or scale.shape not in (
                (L, 1, N), (L, N)) or not scale.is_contiguous():
            raise ValueError(f"{name}: scale must be a contiguous ({L}, 1, "
                             f"{N}) float32 tensor, got {scale.dtype} "
                             f"{tuple(scale.shape)}")
        if not 0 <= layer < L:
            raise ValueError(f"{name}: layer {layer} out of range [0, {L})")
    elif (scale.dtype != torch.float32 or scale.numel() != N
            or not scale.is_contiguous()):
        raise ValueError(f"{name}: scale must hold N={N} contiguous float32 "
                         f"values, got {scale.dtype} {tuple(scale.shape)}")
    for n, t in (("weight", w), ("scale", scale)):
        if t.device != dev:
            raise ValueError(f"{name}: {n} on {t.device}, x on {dev}")


def _pointers(w, scale, layer):
    """Base pointers of layer `layer` of w and scale (None: unstacked)."""
    w_ptr, s_ptr = w.data_ptr(), scale.data_ptr()
    if layer is not None:
        w_ptr += layer * w.stride(0) * w.element_size()
        s_ptr += layer * w.shape[-1] * scale.element_size()
    return w_ptr, s_ptr


@functools.lru_cache(maxsize=4096)
def rows_tiling(R: int, K: int, N: int, sms: int = 132,
                bm: int | None = None,
                tile_k: int = ROWS_TILE_K) -> tuple[int, int, int]:
    """The many-row body's grid: (rows a block, columns a block, K split
    over a cluster), the one rule for K10, K14, K15f and K15g, fitted to
    the card (PERF.md §6, `scripts/sweep_quant_rows.py`); `tile_k` is a
    tile's k values (K15f's int8 x: 128).  Rows: 64 up to 64 rows (a
    verify round), 128 up to 128, above that 256 unless 128 pads fewer
    rows (`bm` fixes them).  Columns: 128 at 64 rows (two blocks fit an
    SM), 256 at 128 rows where that still gives `sms` / 8 blocks (x is
    read once per column block), 128 at 256 rows (registers).  K is split
    over the largest cluster whose ranks keep `ROWS_MIN_TILES` K tiles
    each, within one wave at 128 rows and up to four at 64; where that
    leaves fewer than `sms` / 2 blocks, ranks of half as many tiles."""
    tiles = -(-K // tile_k)
    if bm is None:
        if R <= 64:
            bm = 64
        elif R <= 128:
            bm = 128
        else:
            bm = 256 if 2 * -(-R // 256) <= -(-R // 128) else 128
    rb = -(-R // bm)
    if bm == 128 and rb * -(-N // 256) >= sms // 8:
        bn = 256
    else:
        bn = 128
    blocks = rb * -(-N // bn)
    cap = 4 * 2 * sms if bm == 64 else sms

    def split(min_tiles):
        return max(c for c in ROWS_CLUSTERS
                   if c == 1 or (tiles >= c * min_tiles
                                 and blocks * c <= cap))

    ck = split(ROWS_MIN_TILES)
    if blocks * ck < sms // 2:
        ck = split(ROWS_MIN_TILES // 2)
    return bm, bn, ck


def rows_fit(fmt: str, K: int, N: int, w_ptr: int) -> bool:
    """The shape rule of the many-row body, whose copies are TMA boxes
    (row strides multiples of 16 bytes): int8 with K % 8 == 0 (x's rows)
    and N % 16 == 0 (the weight's); the int4 formats with K % 64 == 0
    (whole tiles of 8 word rows, x read in their tile order), nibble planes
    and bf16-pair words with N % 4 == 0 (int32 words), split-half bytes
    with N % 16 == 0 (byte rows); the weight (the layer's base) 16-byte
    aligned.  Anything else takes the few-row body at every R."""
    if fmt == "int8":
        shape = K % 8 == 0 and N % 16 == 0
    else:
        shape = K % 64 == 0 and N % (16 if fmt == "bytes" else 4) == 0
    return shape and w_ptr % 16 == 0


@functools.lru_cache(maxsize=4096)
def few_rows_tiling(R: int, K: int, N: int, bits: int = 4, bn: int = 128,
                    ck: int | None = None):
    """The few-row TMA body's grid: (columns a block, K split over a
    cluster, ring stages), or None where x's slice cannot fit a block's
    shared memory.  One rule for K10, K11a, K11b, K14 and K15a-e (`bits` 4
    for the int4 formats, 8 for int8: a stage's k values).  A block holds
    `bn` columns and 8 rows (16 above 8, a row block each), a ring of
    `FEW_RING_BYTES` in stages of `FEW_TILE_K` (3 at least), x's K slice in
    bf16 and, where K is split, the buffer that receives the ranks'
    partials.  K is split over the largest cluster up to `FEW_MAX_CLUSTER`
    (`ck` fixes it) whose ranks all hold a tile and whose block fits: on
    an H100 the largest was the fastest at every Qwen3-14B projection, in
    every format (PERF.md §6, `scripts/sweep_quant_rows.py`), whole waves
    or not, since each block's stream is paced by its own latency and more,
    shorter blocks overlap more of it."""
    tile = FEW_TILE_K[bits]
    tiles = -(-K // tile)
    rows = 8 if R <= 8 else 16
    stage = tile * bn * bits // 8
    stages = max(3, FEW_RING_BYTES // stage)
    units = rows * bn // 4                   # float4s of a block's partial
    top = min(tiles, FEW_MAX_CLUSTER)
    for c in range(top, 0, -1) if ck is None else (ck,):
        per = -(-tiles // c)
        if not 1 <= c <= top or (c - 1) * per >= tiles:
            continue
        recv = c * -(-units // c) * 16 if c > 1 else 0
        smem = (1024 + stages * stage + recv
                + rows * (per * 2 * tile + 64) + 16 * stages)
        if smem <= FEW_SMEM:
            return bn, c, stages
    return None


def few_fit(fmt: str, K: int, N: int, w_ptr: int) -> bool:
    """The shape rule of the few-row TMA body: the many-row body's
    (`rows_fit`: TMA boxes of 128-byte rows, row strides multiples of 16
    bytes, whole 64-k tiles for the int4 formats, a 16-byte-aligned
    weight), for the int4 formats N % 32 == 0 (planes' and pairs' stage is
    one box of 32-word column groups; bytes follow, so that the three
    formats take one route and one grid), and x's K slice of 16 rows within
    a block's shared memory at some cluster (K up to ~44k).  Anything else
    takes the ragged route."""
    bits = _FORMATS[fmt][2]
    return (rows_fit(fmt, K, N, w_ptr) and (bits == 8 or N % 32 == 0)
            and few_rows_tiling(16, K, N, bits=bits) is not None)


def route(fmt: str, R: int, K: int, N: int, w_ptr: int,
          few_rows: bool = False) -> str:
    """Which body a call takes, by its shape alone: "few" (the few-row TMA
    body) up to `FEW_ROWS` rows (at any R with `few_rows`) where `few_fit`
    holds, "rows" (the many-row body) above it where `rows_fit` holds, else
    "ragged" (csrc/quant_matmul_ragged.cuh)."""
    if few_rows or R <= FEW_ROWS:
        return "few" if few_fit(fmt, K, N, w_ptr) else "ragged"
    return "rows" if rows_fit(fmt, K, N, w_ptr) else "ragged"


def _aligned(x):
    """x itself when it is 16-byte aligned (the TMA bodies read it in 16-byte
    runs), else an aligned copy."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rows_matmul(x, w_ptr: int, s_ptr: int | None, out, fmt: str,
                tiling=None):
    """One launch of the many-row body on weight format `fmt` (a key of
    `_FORMATS`): x (R, K) bf16 (copied when it is not 16-byte aligned),
    the weight's and scale's base pointers (scale None: no scale), out (R,
    N) f32 or bf16 allocated by the caller; `tiling` (bm, bn, Ck), default
    `rows_tiling`.  For the int4 formats the body first writes x in their
    tile-local k order to a scratch copy allocated here (so that a tile of
    x is one TMA box)."""
    R, K = x.shape
    N = out.shape[1]
    x = _aligned(x)
    bits, code = _FORMATS[fmt][2], _FORMATS[fmt][5]
    xp = torch.empty_like(x) if bits == 4 else None
    bm, bn, ck = tiling or rows_tiling(R, K, N,
                                       _sm_count(x.device.index or 0))
    err = _build.library().p2t_quant_matmul_rows(
        x.data_ptr(), None if xp is None else xp.data_ptr(), w_ptr, s_ptr,
        out.data_ptr(), R, K, N, code, bm, bn, ck,
        _build.dtype_code(out.dtype), _build.stream_of(x))
    _build.check(err, "p2t_quant_matmul_rows")
    return out


def few_matmul(x, w_ptr: int, s_ptr: int, out, fmt: str, tiling=None):
    """One launch of the few-row TMA body on weight format `fmt` (a key of
    `_FORMATS`, where `few_fit` holds): x (R, K) f32 or bf16 (copied when
    it is not 16-byte aligned), the weight's and scale's base pointers, out
    (R, N) in x's dtype allocated by the caller; `tiling` (columns, cluster,
    stages), default `few_rows_tiling`."""
    R, K = x.shape
    N = out.shape[1]
    x = _aligned(x)
    _, ck, stages = tiling or few_rows_tiling(R, K, N, _FORMATS[fmt][2])
    err = _build.library().p2t_quant_matmul_few(
        x.data_ptr(), w_ptr, s_ptr, out.data_ptr(), R, K, N,
        _FORMATS[fmt][6], ck, stages, _build.dtype_code(x.dtype),
        _build.stream_of(x))
    _build.check(err, "p2t_quant_matmul_few")
    return out


def _launch(x, w, scale, fmt, layer, few_rows: bool = False):
    """One kernel over layer `layer` of w/scale (layer None: unstacked), on
    the body `route` names (`few_rows`: the few-row body or the ragged
    route at any R): the few-row TMA body on `few_rows_tiling`'s grid, the
    many-row body (x rounded to bf16 first, the output in x's dtype) on
    `rows_tiling`'s, or the ragged route with `_splits` slices of K and
    their fp32 scratch."""
    R, K = x.shape
    N = w.shape[-1]
    w_ptr, s_ptr = _pointers(w, scale, layer)
    bits, entry, code = _FORMATS[fmt][2:5]
    way = route(fmt, R, K, N, w_ptr, few_rows)
    out = torch.empty((R, N), dtype=x.dtype, device=x.device)
    if way == "rows":
        if x.dtype != torch.bfloat16:
            x = x.to(torch.bfloat16)
        return rows_matmul(x, w_ptr, s_ptr, out, fmt)
    if way == "few":
        return few_matmul(x, w_ptr, s_ptr, out, fmt)
    splits = _splits(R, K, N, bits)
    partial = (torch.empty((splits, R, N), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    err = getattr(_build.library(), entry)(
        x.data_ptr(), w_ptr, s_ptr, out.data_ptr(),
        None if partial is None else partial.data_ptr(), R, K, N, code,
        splits, _build.dtype_code(x.dtype), _build.stream_of(x))
    _build.check(err, entry)
    return out


def _few_rows(x, w, scale, fmt: str, layer: int | None = None):
    """The few-row body at any R (the ragged route where `few_fit` fails;
    no launch counted): the reference that K15a (bc 128), K15b/K15e (the
    bytes) and K15d share their fragments and grid with, for the card
    checks that hold them bit for bit."""
    _check("few-row body", x, w, scale, fmt, layer is not None, layer)
    return _launch(x, w, scale, fmt, layer, few_rows=True)


def quant_matmul_int4_planes(x, w_planes, scale):
    """K10: x (R, K) · unpack(w_planes (K/8, N) int32) · scale (N,).  CPU
    tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if x.device.type == "cpu":
        return quant_matmul_int4_planes_plain(x, w_planes, scale)
    _check("K10", x, w_planes, scale, "planes", False, None)
    out = _launch(x, w_planes, scale, "planes", None)
    quant_matmul_int4_planes.launches += 1
    return out


quant_matmul_int4_planes.launches = 0


def quant_matmul_int4_planes_stacked(x, w_planes_all, scale_all, layer: int):
    """K10 over layer `layer` of w_planes_all (L, K/8, N) and scale_all
    (L, 1, N), read in place by pointer offset.  CPU tensors run the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return quant_matmul_int4_planes_stacked_plain(x, w_planes_all,
                                                      scale_all, layer)
    layer = int(layer)
    _check("K10", x, w_planes_all, scale_all, "planes", True, layer)
    out = _launch(x, w_planes_all, scale_all, "planes", layer)
    quant_matmul_int4_planes_stacked.launches += 1
    return out


quant_matmul_int4_planes_stacked.launches = 0


def quant_matmul_int4(x, w_packed, scale):
    """K11a: x (R, K) · unpack(w_packed (K/2, N) int8 split-half bytes) ·
    scale (N,).  CPU tensors run the plain version; CUDA tensors launch the
    kernel (or raise)."""
    if x.device.type == "cpu":
        return quant_matmul_int4_plain(x, w_packed, scale)
    _check("K11a", x, w_packed, scale, "bytes", False, None)
    out = _launch(x, w_packed, scale, "bytes", None)
    quant_matmul_int4.launches += 1
    return out


quant_matmul_int4.launches = 0


def quant_matmul_int4_stacked(x, w_packed_all, scale_all, layer: int):
    """K11a over layer `layer` of w_packed_all (L, K/2, N) int8 and
    scale_all (L, 1, N), read in place by pointer offset.  CPU tensors run
    the plain version; CUDA tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return quant_matmul_int4_stacked_plain(x, w_packed_all, scale_all,
                                               layer)
    layer = int(layer)
    _check("K11a", x, w_packed_all, scale_all, "bytes", True, layer)
    out = _launch(x, w_packed_all, scale_all, "bytes", layer)
    quant_matmul_int4_stacked.launches += 1
    return out


quant_matmul_int4_stacked.launches = 0


def quant_matmul_int4_pairs(x, w_pairs, scale):
    """K11b: x (R, K) · unpack(w_pairs (K/8, N) int32 bf16-pair words) ·
    scale (N,), exact.  CPU tensors run the plain version; CUDA tensors
    launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return quant_matmul_int4_pairs_plain(x, w_pairs, scale)
    _check("K11b", x, w_pairs, scale, "pairs", False, None)
    out = _launch(x, w_pairs, scale, "pairs", None)
    quant_matmul_int4_pairs.launches += 1
    return out


quant_matmul_int4_pairs.launches = 0


def quant_matmul_int4_pairs_stacked(x, w_pairs_all, scale_all, layer: int):
    """K11b over layer `layer` of w_pairs_all (L, K/8, N) int32 and
    scale_all (L, 1, N), read in place by pointer offset.  CPU tensors run
    the plain version; CUDA tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return quant_matmul_int4_pairs_stacked_plain(x, w_pairs_all,
                                                     scale_all, layer)
    layer = int(layer)
    _check("K11b", x, w_pairs_all, scale_all, "pairs", True, layer)
    out = _launch(x, w_pairs_all, scale_all, "pairs", layer)
    quant_matmul_int4_pairs_stacked.launches += 1
    return out


quant_matmul_int4_pairs_stacked.launches = 0


def quant_matmul_int8(x, w_q, scale):
    """K14: x (R, K) · w_q (K, N) int8 · scale (N,).  CPU tensors run the
    plain version; CUDA tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return quant_matmul_int8_plain(x, w_q, scale)
    _check("K14", x, w_q, scale, "int8", False, None)
    out = _launch(x, w_q, scale, "int8", None)
    quant_matmul_int8.launches += 1
    return out


quant_matmul_int8.launches = 0


def quant_matmul_int8_stacked(x, w_q_all, scale_all, layer: int):
    """K14 over layer `layer` of w_q_all (L, K, N) int8 and scale_all
    (L, 1, N).  CPU tensors run the plain version; CUDA tensors launch the
    kernel (or raise)."""
    if x.device.type == "cpu":
        return quant_matmul_int8_stacked_plain(x, w_q_all, scale_all, layer)
    layer = int(layer)
    _check("K14", x, w_q_all, scale_all, "int8", True, layer)
    out = _launch(x, w_q_all, scale_all, "int8", layer)
    quant_matmul_int8_stacked.launches += 1
    return out


quant_matmul_int8_stacked.launches = 0
