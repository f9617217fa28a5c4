"""Quantization helpers (counterpart of prot2text_tpu/models/quant.py).

`quantize_kv` is the int8 KV cache's per-vector scheme.  The weight
quantizers cover the serving CLI's `--model_dtype int8/int4` (the
reference's `--torch_dtype int8/int4`): per-output-channel symmetric
weights with fp32 scales on the frozen towers' projections.

`quantize_params` rewrites every targeted kernel leaf:
  bits=8 → {kernel_q (..., din, dout) int8, scale (..., 1, dout) f32},
           multiplied by K14 at few rows (`models/transformer.py linear`);
  bits=4 → {kernel_q4p (..., din/8, dout) int32, scale}: the nibble-plane
           words of `kernels/quant_matmul.pack_int4_planes`, multiplied by
           K10.  A quarter of the bf16 bytes.
The JAX package's other int4 formats — the opt-in bf16-pair words
(`int4_format="pairs"`) and the split-half bytes (`"bytes"`, also its
automatic fallback when din % 8 != 0 but din is even) — belong to kernel
K11, which is not ported (ROADMAP.md §2): they raise.  Embeddings, norms
and biases stay in their float dtype.
"""

from __future__ import annotations

import re
from typing import Any

import torch

from ..kernels.quant_matmul import pack_int4_planes, unpack_int4_planes
from .weights import tree_leaves

DEFAULT_TARGETS = (
    r"(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj|lm_head)"
    r"/kernel$",
    r"(qkv|out_proj|ffn_in|ffn_out|attn_out|query|key|value|intermediate"
    r"|output)/kernel$",
)
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


def _k11(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is an int4 format of kernel K11, not ported yet (ROADMAP.md "
        f"§2); the port quantizes int4 to nibble planes (K10)")


def _quantize_kernel(w, bits: int) -> dict:
    """One kernel leaf → {kernel_q | kernel_q4p, scale}.  A stacked (L, ...)
    leaf is quantized `_LAYER_CHUNK` layers at a time, which gives the same
    result as the whole leaf at once: the scales are per (layer, column)."""
    din = w.shape[-2]
    planes = bits == 4 and din % 8 == 0
    if bits == 4 and not planes and din % 2 == 0:
        raise _k11(f"int4 over din={din} (not a multiple of 8: the JAX "
                   f"package's split-half 'bytes' fallback)")

    def one(t):
        q, s = quantize_leaf(t, bits)
        return (pack_int4_planes(q) if planes else q), s

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
    return {"kernel_q4p" if planes else "kernel_q": q, "scale": scale}


def quantize_params(params: Any, bits: int = 8,
                    int4_format: str = "planes") -> Any:
    """A new tree in which every `kernel` leaf that `DEFAULT_TARGETS` names
    (path ending in `<target>/kernel`, joined by "/" as in JAX) becomes {kernel_q, scale}
    (bits=8) or {kernel_q4p, scale} (bits=4, nibble planes); the node's
    other leaves (a bias) are kept.  A din that is odd keeps int4 values in
    int8 storage ({kernel_q, scale}), as in JAX; `int4_format` "pairs" or
    "bytes" raises (kernel K11)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if bits == 4 and int4_format != "planes":
        raise _k11(f"int4_format={int4_format!r}")
    pats = [re.compile(p) for p in DEFAULT_TARGETS]

    def walk(node, prefix):
        if not isinstance(node, dict):
            return node
        w = node.get("kernel")
        if (torch.is_tensor(w) and w.dim() >= 2
                and any(p.search(prefix + "/kernel") for p in pats)):
            new = _quantize_kernel(w, bits)
            new.update((k, v) for k, v in node.items() if k != "kernel")
            return new
        return {k: walk(v, f"{prefix}/{k}") for k, v in node.items()}

    return walk(params, "")


def dequantize_leaf(q, scale, dtype=torch.bfloat16):
    """(q · scale) in fp32, then `dtype`; q holds int8 values (int4 planes
    are unpacked first: `dequantize_kernel`)."""
    return (q.float() * scale).to(dtype)


def dequantize_kernel(p: dict, dtype) -> torch.Tensor:
    """The float (…, din, dout) kernel of a quantized linear leaf dict
    ({kernel_q | kernel_q4p, scale}) in `dtype`."""
    q = (unpack_int4_planes(p["kernel_q4p"]) if "kernel_q4p" in p
         else p["kernel_q"])
    return dequantize_leaf(q, p["scale"], dtype)


def quantized_bytes(params: Any) -> int:
    """Bytes of every tensor leaf of a (quantized or float) tree."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))
