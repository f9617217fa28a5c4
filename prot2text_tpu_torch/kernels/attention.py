"""Attention dispatch (counterpart of prot2text_tpu/kernels/attention.py).

`dot_product_attention(q, k, v, bias, impl=...)` is the JAX entry's
bias route (no `lengths`), which the bidirectional encoders take:
  * "xla" and "auto": the plain function below, the attention the JAX
    package runs as XLA (`_xla_attention`): fp32 logits + additive bias,
    fp32 softmax, weights cast to v's dtype for ·V.  JAX keeps
    bidirectional encoder shapes on XLA under "auto" (`flash_eligible`
    is causal-only), and XLA attention is no Pallas kernel, so plain torch
    is its counterpart;
  * "flash": `flash_attention.flash_attention_bias`, K6 forward and K6b
    backward on the card.  JAX takes its Pallas kernel only for S on the
    128 grid and D in {64, 128} and falls back to chunked XLA elsewhere
    (prot2text_tpu/kernels/attention.py:226-249); the CUDA K6/K6b mask
    their ragged edge tiles themselves and take every S and D in
    {16, 32, 64, 128}.

The causal decoder's masked-run route (`lengths`) is
`flash_attention.flash_attention_masked`, called by the decoder directly;
the JAX `masked_flash_padded` padded S to the 128-row Mosaic grid around
K1 and has no counterpart.
"""

from __future__ import annotations

import torch

IMPLS = ("auto", "xla", "flash")


def dot_product_attention(q, k, v, bias, impl: str = "auto"):
    """q (B, H, Sq, D), k, v (B, Hkv, Skv, D) (Hkv = H on the plain route);
    bias: fp32 additive, broadcastable to (B, H, Sq, Skv)."""
    if impl == "flash":
        from .flash_attention import flash_attention_bias

        return flash_attention_bias(q, k, v, bias)
    if impl not in IMPLS:
        raise ValueError(f"attention impl must be one of {IMPLS}, got "
                         f"{impl!r}")
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits + bias.float()
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights.to(v.dtype), v)
