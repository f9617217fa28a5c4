"""Quantization helpers (counterpart of prot2text_tpu/models/quant.py).

`quantize_kv` is the int8 KV cache's per-vector scheme.  The weight
quantizers cover the serving CLI's `--model_dtype int8/int4` (the
reference's `--torch_dtype int8/int4`): per-output-channel symmetric
weights with fp32 scales on the frozen towers' projections.

`quantize_params` rewrites every targeted kernel leaf:
  bits=8 → {kernel_q (..., din, dout) int8, scale (..., 1, dout) f32},
           multiplied by K14 at few rows (`models/transformer.py linear`);
  bits=4 → by `int4_format`, as in JAX, a quarter of the bf16 bytes:
    "planes" (the default) {kernel_q4p (..., din/8, dout) int32, scale},
             the nibble-plane words of `kernels/quant_matmul.
             pack_int4_planes`, multiplied by K10;
    "pairs"  {kernel_q4w (..., din/8, dout) int32, scale}, the bf16-pair
             words of `pack_int4_pairs`, multiplied by K11b (exact on the
             GPU; JAX's TPU kernel is not, its `kernels/quant_matmul.py:
             410-424`);
    "bytes"  {kernel_q4 (..., din/2, dout) int8, scale}, the split-half
             bytes of `pack_int4`, multiplied by K11a — also every
             format's fallback when din % 8 != 0 but din is even;
  an odd din keeps int4 values in int8 storage ({kernel_q, scale}).
Embeddings, norms and biases stay in their float dtype.
"""

from __future__ import annotations

import re
from typing import Any

import torch

from ..kernels.quant_matmul import (
    pack_int4, pack_int4_pairs, pack_int4_planes, unpack_int4,
    unpack_int4_pairs, unpack_int4_planes,
)
from .weights import tree_leaves

DEFAULT_TARGETS = (
    r"(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj|lm_head)"
    r"/kernel$",
    r"(qkv|out_proj|ffn_in|ffn_out|attn_out|query|key|value|intermediate"
    r"|output)/kernel$",
)
# int4 leaf key → (packer, unpacker, contraction rows a stored row holds);
# each format's din rule is `_int4_key`, its inverse `unpacked_in_dim`
INT4_FORMATS = {
    "kernel_q4p": (pack_int4_planes, unpack_int4_planes, 8),
    "kernel_q4w": (pack_int4_pairs, unpack_int4_pairs, 8),
    "kernel_q4": (pack_int4, unpack_int4, 2),
}
# layers of a stacked (L, ...) kernel leaf quantized at once: bounds the
# fp32 transient (a whole (40, 5120, 17408) leaf is 14.3 GB in fp32)
_LAYER_CHUNK = 4


def quantize_kv(x, qmax: float = 127.0):
    """Per-vector symmetric int8 quantization over the LAST dim (one scale
    per KV head vector — the granularity of the int8 KV cache,
    `infer/kvcache.init_kv_cache(kv_bits=8)`).

    Returns (q, scale): q holds EXACT INTEGER values in fp32 (the cache
    stores them as int8; the fused kernels take the fp32 form), scale is
    fp32 with the last dim dropped; x ≈ q * scale[..., None].
    `torch.round` rounds half to even, as `jnp.round` does."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1), min=1e-8) / qmax
    q = torch.clamp(torch.round(x32 / scale[..., None]), -qmax, qmax)
    return q, scale


def quantize_leaf(w, bits: int = 8):
    """(..., din, dout) float → integer values in int8 storage and
    per-(…, dout) fp32 scales (symmetric, per output channel).  bits=4
    values lie in [-7, 7] and are returned unpacked."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=-2, keepdim=True)          # (..., 1, dout)
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.clamp(absmax, min=1e-8) / qmax
    q = torch.clamp(torch.round(w32 / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def _int4_key(din: int, int4_format: str) -> str:
    """The leaf key JAX's `quantize_params` gives an int4 kernel of this
    contraction dim (prot2text_tpu/models/quant.py:113-128): planes or
    pairs words when din % 8 == 0, else split-half bytes when din is even,
    else int8 storage."""
    if din % 8 == 0 and int4_format in ("planes", "pairs"):
        return "kernel_q4p" if int4_format == "planes" else "kernel_q4w"
    return "kernel_q4" if din % 2 == 0 else "kernel_q"


def unpacked_in_dim(key: str, shape) -> int:
    """The contraction dim din of a kernel leaf stored under `key` with
    `shape` (..., rows, dout): rows · 8 for the int4 words (`kernel_q4p`,
    `kernel_q4w`), rows · 2 for the split-half bytes (`kernel_q4`), rows
    for `kernel_q` and `kernel`; the inverse of `_int4_key`'s packing."""
    return shape[-2] * (INT4_FORMATS[key][2] if key in INT4_FORMATS else 1)


def _quantize_kernel(w, bits: int, int4_format: str) -> dict:
    """One kernel leaf → {kernel_q | kernel_q4p | kernel_q4w | kernel_q4,
    scale}.  A stacked (L, ...) leaf is quantized `_LAYER_CHUNK` layers at
    a time, which gives the same result as the whole leaf at once: the
    scales are per (layer, column)."""
    key = _int4_key(w.shape[-2], int4_format) if bits == 4 else "kernel_q"
    pack = INT4_FORMATS[key][0] if key in INT4_FORMATS else None

    def one(t):
        q, s = quantize_leaf(t, bits)
        return (q if pack is None else pack(q)), s

    if w.dim() < 3:
        q, scale = one(w)
    else:
        L = w.shape[0]
        for i in range(0, L, _LAYER_CHUNK):
            qi, si = one(w[i:i + _LAYER_CHUNK])
            if i == 0:
                q = qi.new_empty((L,) + qi.shape[1:])
                scale = si.new_empty((L,) + si.shape[1:])
            q[i:i + _LAYER_CHUNK] = qi
            scale[i:i + _LAYER_CHUNK] = si
    return {key: q, "scale": scale}


def quantize_params(params: Any, bits: int = 8,
                    int4_format: str = "planes") -> Any:
    """A new tree in which every `kernel` leaf that `DEFAULT_TARGETS` names
    (path ending in `<target>/kernel`, joined by "/" as in JAX) becomes
    {kernel_q, scale} (bits=8) or, for bits=4, {kernel_q4p | kernel_q4w |
    kernel_q4, scale} by `int4_format` "planes" | "pairs" | "bytes" and
    the contraction dim, as JAX's (`_int4_key`); the node's other leaves (a
    bias) are kept."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if int4_format not in ("planes", "pairs", "bytes"):
        raise ValueError(f"int4_format must be planes, pairs or bytes, got "
                         f"{int4_format!r}")
    pats = [re.compile(p) for p in DEFAULT_TARGETS]

    def walk(node, prefix):
        if not isinstance(node, dict):
            return node
        w = node.get("kernel")
        if (torch.is_tensor(w) and w.dim() >= 2
                and any(p.search(prefix + "/kernel") for p in pats)):
            new = _quantize_kernel(w, bits, int4_format)
            new.update((k, v) for k, v in node.items() if k != "kernel")
            return new
        return {k: walk(v, f"{prefix}/{k}") for k, v in node.items()}

    return walk(params, "")


def dequantize_leaf(q, scale, dtype=torch.bfloat16):
    """(q · scale) in fp32, then `dtype`; q holds int8 values (int4 planes
    are unpacked first: `dequantize_kernel`)."""
    return (q.float() * scale).to(dtype)


def unpack_kernel(p: dict) -> torch.Tensor:
    """The integer (…, din, dout) int8 weight of a quantized linear leaf
    dict ({kernel_q | kernel_q4p | kernel_q4w | kernel_q4, scale}), its
    scale not applied."""
    key = next((k for k in INT4_FORMATS if k in p), None)
    return p["kernel_q"] if key is None else INT4_FORMATS[key][1](p[key])


def dequantize_kernel(p: dict, dtype) -> torch.Tensor:
    """The float (…, din, dout) kernel of a quantized linear leaf dict
    ({kernel_q | kernel_q4p | kernel_q4w | kernel_q4, scale}) in `dtype`."""
    return dequantize_leaf(unpack_kernel(p), p["scale"], dtype)


def quantized_bytes(params: Any) -> int:
    """Bytes of every tensor leaf of a (quantized or float) tree."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))
