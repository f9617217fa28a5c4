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
    if kv_bits is not None:
        raise NotImplementedError("int8 KV cache (kv_bits) is not ported yet "
                                  "(ROADMAP.md §1 item 11, kernel K7)")
    shape = (cfg.num_layers, batch_size, cfg.num_kv_heads, max_length,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
