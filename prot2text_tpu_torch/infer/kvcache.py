"""Preallocated KV cache (counterpart of prot2text_tpu/infer/kvcache.py).

One layout for every head dim: (L, B, Hkv, T, D), batch dims leading, so a
layer's (B, Hkv, T, D) block and every (b, kv-head) row run are contiguous
for K2 and every slot row is contiguous for K3.  (The JAX package's D=64
"tbkd" layout answered a TPU lane-tiling constraint that the GPU lacks.)
"""

from __future__ import annotations

import torch

from ..models.decoder import DecoderConfig


def init_kv_cache(cfg: DecoderConfig, batch_size: int, max_length: int, *,
                  device, dtype=torch.float32, kv_bits=None):
    """{"k", "v"} (L, B, Hkv, T, D) zeros in `dtype`; kv_bits=8 allocates
    the QUANTIZED cache instead: int8 k/v plus per-(head, token) fp32
    scales "k_scale"/"v_scale" (L, B, Hkv, T) initialised to 1.0
    (`models/quant.quantize_kv` granularity).  Callers size T % 32 == 0 as
    the JAX package does for its int8 tile groups."""
    shape = (cfg.num_layers, batch_size, cfg.num_kv_heads, max_length,
             cfg.head_dim)
    if kv_bits is None:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kv_bits != 8:
        raise ValueError(f"kv_bits must be 8 or None, got {kv_bits}")
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.ones(shape[:-1], device=device),
            "v_scale": torch.ones(shape[:-1], device=device)}
