"""K10 and K14: weight-quantized matmuls for serving (CUDA C++), with the
int4 nibble-plane packers and the plain PyTorch versions.

K10 replaces prot2text_tpu/kernels/quant_matmul.py
`quant_matmul_int4_planes` (`_mm_i4p_kernel`) and
`quant_matmul_int4_planes_stacked` (`_mm_i4p_stacked_kernel`); K14
replaces `quant_matmul_int8` (`_mm_i8_kernel`) and `quant_matmul_int8_stacked`
(`_mm_i8_stacked_kernel`).  Both are one kernel, `csrc/quant_matmul.cu`,
whose header states what bounds it and what its design does about that.
The TPU's stacked variants exist because a Pallas operand must be a
materialized buffer; here the stacked wrappers pass layer `layer`'s base
pointer into the (L, ...) buffer, so both entry points share one body.  The
serving path needs only the unstacked wrappers: `models/transformer.py
linear` hands them each layer's zero-copy view of the stacked buffer
(`layer_views`); the stacked ones keep the JAX package's names.

Contract (as the JAX kernels): x (R, K) float32 or bfloat16, ROUNDED TO
BF16 before the product; W int4 planes (K/8, N) int32 — nibble j of word
[k8, n] holds w[k8 + j·K/8, n] (`pack_int4_planes`) — or int8 (K, N);
scale (1, N) or (N,) float32 (stacked: (L, 1, N)); fp32 accumulation, the
scale applied in the fp32 epilogue, the result (R, N) in x's dtype.  The
int4/int8 values are exact in bf16, so only x's rounding and the order of
the sums separate the kernel from its plain version.

The serving path calls the kernels for at most `QUANT_KERNEL_ROWS` rows
(`models/transformer.py linear`), as the JAX package does on the TPU; the
kernels themselves take any R and any N.
"""

from __future__ import annotations

import torch

from . import _build

# rows at or below which the decoder's quantized projections take K10/K14
# (prot2text_tpu/models/transformer.py:97-128, decoder.py:491-525)
QUANT_KERNEL_ROWS = 256
_BLOCK_COLS = 128               # csrc/quant_matmul.cu kBlockCols
_BLOCK_ROWS = 64                # at most 8 MMA tiles of 8 rows per block
_STEP_K = {4: 32, 8: 16}        # k values per K step (Fmt::kStepK)
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


def quant_matmul_int8_plain(x, w_q, scale):
    return _plain(x, w_q, scale)


def quant_matmul_int8_stacked_plain(x, w_q_all, scale_all, layer: int):
    return quant_matmul_int8_plain(x, w_q_all[layer], scale_all[layer])


def _steps(K: int, bits: int) -> int:
    return -(-K // _STEP_K[bits])


def _splits(R: int, K: int, N: int, bits: int) -> int:
    """Slices of K across blocks: enough that about `_TARGET_BLOCKS` blocks
    run, each slice at least `_MIN_SPLIT_STEPS` steps, the fp32 partial
    sums (written and read once more) at most a quarter of the weight
    bytes, no empty slice."""
    steps = _steps(K, bits)
    blocks = -(-R // _BLOCK_ROWS) * -(-N // _BLOCK_COLS)
    weight_bytes = K * N // (2 if bits == 4 else 1)
    s = max(1, min(-(-_TARGET_BLOCKS // blocks), steps // _MIN_SPLIT_STEPS,
                   weight_bytes // (16 * R * N)))
    per = -(-steps // s)
    return -(-steps // per)


def _check(name, x, w, scale, bits, stacked, layer):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 2 or x.shape[0] == 0 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (R > 0, K) "
                         f"tensor, got {tuple(x.shape)}")
    wdt = torch.int32 if bits == 4 else torch.int8
    lead = 1 if stacked else 0
    if w.dtype != wdt or w.dim() != 2 + lead or not w.is_contiguous():
        raise ValueError(f"{name}: the weight must be a contiguous "
                         f"{'(L, ' if stacked else '('}"
                         f"{'K/8' if bits == 4 else 'K'}, N) {wdt} tensor, "
                         f"got {w.dtype} {tuple(w.shape)}")
    K = w.shape[-2] * (8 if bits == 4 else 1)
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


def _launch(x, w, scale, bits, layer):
    """One kernel over layer `layer` of w/scale (layer None: unstacked)."""
    R, K = x.shape
    N = w.shape[-1]
    w_ptr, s_ptr = w.data_ptr(), scale.data_ptr()
    if layer is not None:
        w_ptr += layer * w.stride(0) * w.element_size()
        s_ptr += layer * N * scale.element_size()
    splits = _splits(R, K, N, bits)
    out = torch.empty((R, N), dtype=x.dtype, device=x.device)
    partial = (torch.empty((splits, R, N), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    lib = _build.library()
    err = lib.p2t_quant_matmul(
        x.data_ptr(), w_ptr, s_ptr, out.data_ptr(),
        None if partial is None else partial.data_ptr(), R, K, N, bits,
        splits, _build.dtype_code(x.dtype), _build.stream_of(x))
    _build.check(err, "p2t_quant_matmul")
    return out


def quant_matmul_int4_planes(x, w_planes, scale):
    """K10: x (R, K) · unpack(w_planes (K/8, N) int32) · scale (N,).  CPU
    tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if x.device.type == "cpu":
        return quant_matmul_int4_planes_plain(x, w_planes, scale)
    _check("K10", x, w_planes, scale, 4, False, None)
    out = _launch(x, w_planes, scale, 4, None)
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
    _check("K10", x, w_planes_all, scale_all, 4, True, layer)
    out = _launch(x, w_planes_all, scale_all, 4, layer)
    quant_matmul_int4_planes_stacked.launches += 1
    return out


quant_matmul_int4_planes_stacked.launches = 0


def quant_matmul_int8(x, w_q, scale):
    """K14: x (R, K) · w_q (K, N) int8 · scale (N,).  CPU tensors run the
    plain version; CUDA tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return quant_matmul_int8_plain(x, w_q, scale)
    _check("K14", x, w_q, scale, 8, False, None)
    out = _launch(x, w_q, scale, 8, None)
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
    _check("K14", x, w_q_all, scale_all, 8, True, layer)
    out = _launch(x, w_q_all, scale_all, 8, layer)
    quant_matmul_int8_stacked.launches += 1
    return out


quant_matmul_int8_stacked.launches = 0
