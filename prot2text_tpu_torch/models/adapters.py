"""Modality adapter (counterpart of prot2text_tpu/models/adapters.py:31-113).

fc1 → GELU → fc2 → GELU → L2-normalize, inference only: the dropout
layers between them are training-time (training: ROADMAP.md §1 item 10).
The RGCN adapter is not ported yet (§1 item 13)."""

from __future__ import annotations

import dataclasses

import torch

from .transformer import gelu_erf, linear
from .weights import dense


@dataclasses.dataclass(frozen=True)
class ModalityAdapterConfig:
    input_dim: int
    intermediate_dim: int
    output_dim: int
    dropout_rate: float = 0.3


def init_modality_adapter_params(cfg: ModalityAdapterConfig, *, generator,
                                 device, dtype=torch.float32):
    kw = dict(generator=generator, device=device, dtype=dtype, bias=True)
    return {"fc1": dense(cfg.input_dim, cfg.intermediate_dim, **kw),
            "fc2": dense(cfg.intermediate_dim, cfg.output_dim, **kw)}


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    """torch F.normalize parity: x / max(||x||, eps), in fp32."""
    x32 = x.float()
    norm = x32.square().sum(dim=dim, keepdim=True).sqrt()
    return (x32 / norm.clamp(min=eps)).to(x.dtype)


def modality_adapter(cfg: ModalityAdapterConfig, params, hidden_states, *,
                     deterministic: bool = True):
    """(B, S, input_dim) → (B, S, output_dim), L2-normalized per token."""
    if not deterministic and cfg.dropout_rate > 0.0:
        raise NotImplementedError("adapter dropout is training-time; "
                                  "training is not ported yet (ROADMAP.md "
                                  "§1 item 10)")
    h = gelu_erf(linear(params["fc1"], hidden_states))
    h = gelu_erf(linear(params["fc2"], h))
    return l2_normalize(h)
