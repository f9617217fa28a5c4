"""Plain attention (counterpart of prot2text_tpu/kernels/attention.py).

`dot_product_attention` is the attention the JAX package runs as XLA
(`_xla_attention`): fp32 logits + additive bias, fp32 softmax, weights cast
to v's dtype for ·V.  The bidirectional ESM2 encoder uses it.

The JAX `masked_flash_padded` has no counterpart: it padded S to the
128-row Mosaic grid around K1, and the CUDA K1 masks its ragged edge tiles
itself, so the decoder calls `flash_attention.flash_attention_masked`
directly.
"""

from __future__ import annotations

import torch


def dot_product_attention(q, k, v, bias):
    """q, k, v: (B, H, S, D) with equal H; bias: fp32 additive, broadcastable
    to (B, H, Sq, Skv)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits + bias.float()
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights.to(v.dtype), v)
