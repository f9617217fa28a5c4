"""Medusa-style learned draft heads for speculative serving (counterpart of
prot2text_tpu/models/medusa.py).

K residual-MLP heads read the target's frontier hidden state and each
predicts one future token: head k drafts the token k+1 positions past the
frontier.  The serving engine (`infer/serving.py _spec_rounds`) verifies
the K drafts in one chunk forward with per-row acceptance, so any head
weights keep greedy tokens exact; training (`train/draft.py`) only raises
acceptance.

  * Drafting is one batched product over the stacked (K, H, H) head
    kernels plus the target's own LM head, through `decoder_logits`, so
    tied, bf16 and quantized heads all work (a quantized head runs
    K10/K11a/K11b/K14 at B·K rows).  The heads' own products are plain
    matrix products, as in JAX, where no Pallas kernel computes them.
  * Zero-init heads are identity residual blocks: each drafts
    argmax(lm_head(h)), the token the frontier just emitted.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .decoder import DecoderConfig, decoder_logits


@dataclasses.dataclass(frozen=True)
class MedusaConfig:
    hidden_size: int
    num_heads: int = 4          # = draft length gamma


def init_medusa_params(cfg: MedusaConfig, generator=None,
                       dtype=torch.float32, scale: float = 0.0,
                       device="cpu") -> dict:
    """Stacked head params {"w": (K, H, H), "b": (K, H)} on `device`.
    scale=0 (the Medusa paper's init) gives zeros: every head an identity
    residual block; otherwise w = scale · N(0, 1) from `generator`."""
    K, H = cfg.num_heads, cfg.hidden_size
    if scale:
        w = scale * torch.randn((K, H, H), generator=generator, device=device,
                                dtype=torch.float32)
        w = w.to(dtype)
    else:
        w = torch.zeros((K, H, H), dtype=dtype, device=device)
    return {"w": w, "b": torch.zeros((K, H), dtype=dtype, device=device)}


def medusa_hidden(med_params, h):
    """h: (..., H) frontier hidden states -> (..., K, H), each head's draft
    of the hidden state k+1 positions ahead: h + SiLU(h·W_k + b_k), the
    heads cast to h's dtype."""
    w = med_params["w"].to(h.dtype)
    b = med_params["b"].to(h.dtype)
    proj = torch.einsum("...h,khj->...kj", h, w) + b
    return h[..., None, :] + F.silu(proj)


def medusa_drafts(dec_cfg: DecoderConfig, dec_params, med_params, h):
    """Greedy drafts from the frontier hidden state: h (B, H) -> (B, K)
    int64, draft k head k's argmax through the TARGET's LM head."""
    logits = decoder_logits(dec_cfg, dec_params,
                            medusa_hidden(med_params, h))      # (B, K, V)
    return torch.argmax(logits, dim=-1)
