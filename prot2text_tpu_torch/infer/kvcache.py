"""Preallocated KV cache (counterpart of prot2text_tpu/infer/kvcache.py).

Two layouts, as in the JAX package (`models/decoder.kv_cache_layout`):
  * "bktd" (L, B, Hkv, T, D), batch dims leading: a layer's (B, Hkv, T, D)
    block and every (b, kv-head) row run are contiguous for K4 and its
    slot write.  The dense cache of a head dim on the 128 grid
    (Llama-3.1-8B, Qwen3-14B), every int8 cache, and the serving pool at
    every head dim;
  * "tbkd" (L, T, B, Hkv, D), sequence leading: the dense lockstep cache of
    other head dims (Llama-3.2-1B's 64).  A layer's slot is one contiguous
    run of B·Hkv·D elements, which K12 writes.
"""

from __future__ import annotations

import torch

from ..models.decoder import DecoderConfig, resolve_layout


def init_kv_cache(cfg: DecoderConfig, batch_size: int, max_length: int, *,
                  device, dtype=torch.float32, kv_bits=None, layout=None):
    """{"k", "v"} zeros in `dtype`, laid out as `layout` ("bktd" or "tbkd";
    None: `kv_cache_layout(cfg)`).  kv_bits=8 allocates the QUANTIZED
    cache instead, always (L, B, Hkv, T, D): int8 k/v plus per-(head,
    token) fp32 scales "k_scale"/"v_scale" (L, B, Hkv, T) initialised to
    1.0 (`models/quant.quantize_kv` granularity).  JAX refuses int8 at a
    head dim off the 128 grid (prot2text_tpu/infer/kvcache.py:43-45); the
    port takes it at every D.  Callers size T % 32 == 0 as the JAX package
    does for its int8 tile groups."""
    L, Hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    if kv_bits is not None and kv_bits != 8:
        raise ValueError(f"kv_bits must be 8 or None, got {kv_bits}")
    if resolve_layout(cfg, kv_bits is not None, layout) == "tbkd":
        shape = (L, max_length, batch_size, Hkv, D)
    else:
        shape = (L, batch_size, Hkv, max_length, D)
    if kv_bits is None:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.ones(shape[:-1], device=device),
            "v_scale": torch.ones(shape[:-1], device=device)}
