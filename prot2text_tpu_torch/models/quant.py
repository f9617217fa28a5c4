"""Quantization helpers (counterpart of prot2text_tpu/models/quant.py).

Only `quantize_kv` is ported: the int8 KV cache's per-vector scheme.  The
weight quantizers (int8/int4 frozen towers, kernels K10/K11/K14) are not
ported yet (ROADMAP.md §1 item 12).
"""

from __future__ import annotations

import torch


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
