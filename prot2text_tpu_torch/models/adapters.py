"""Modality adapter (counterpart of prot2text_tpu/models/adapters.py:31-113).

fc1 → GELU → dropout → fc2 → GELU → dropout → L2-normalize; the dropouts
act in training mode only (`deterministic=False`), drawing their masks
from an explicit `torch.Generator`.  The RGCN adapter is not ported yet
(ROADMAP.md §1 item 12)."""

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


def modality_adapter_params_from_torch(sd, *, device="cpu",
                                       dtype=torch.float32,
                                       prefix: str = "") -> dict:
    """A reference ModalityAdapter state dict (the adapter-only checkpoints
    of the reference's train_contrast.py) → {"fc1", "fc2"}: kernels
    transposed to (in, out), biases, contiguous on `device` in `dtype`
    (prot2text_tpu/models/adapters.py:71).  The deprecated ln1/ln2
    LayerNorms such state dicts keep are never applied, and are
    ignored."""
    def dense(name):
        w, b = sd[prefix + name + ".weight"], sd[prefix + name + ".bias"]
        return {"kernel": w.detach().to(device=device, dtype=dtype).T
                .contiguous(),
                "bias": b.detach().to(device=device, dtype=dtype)
                .contiguous()}

    return {"fc1": dense("fc1"), "fc2": dense("fc2")}


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    """torch F.normalize parity: x / max(||x||, eps), in fp32."""
    x32 = x.float()
    norm = x32.square().sum(dim=dim, keepdim=True).sqrt()
    return (x32 / norm.clamp(min=eps)).to(x.dtype)


def _dropout(x, rate: float, generator, deterministic: bool):
    """Inverted dropout (prot2text_tpu/models/adapters.py:64): keep with
    probability 1 - rate, scale kept values by 1/(1 - rate).  The mask is
    drawn from `generator`; it cannot reproduce `jax.random`'s bits."""
    if deterministic or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def modality_adapter(cfg: ModalityAdapterConfig, params, hidden_states, *,
                     deterministic: bool = True, generator=None):
    """(B, S, input_dim) → (B, S, output_dim), L2-normalized per token.
    Training mode (`deterministic=False`) needs a `generator` on the
    activations' device for the dropout masks."""
    if not deterministic and cfg.dropout_rate > 0.0 and generator is None:
        raise ValueError("training-mode adapter dropout needs a generator")
    h = gelu_erf(linear(params["fc1"], hidden_states))
    h = _dropout(h, cfg.dropout_rate, generator, deterministic)
    h = gelu_erf(linear(params["fc2"], h))
    h = _dropout(h, cfg.dropout_rate, generator, deterministic)
    return l2_normalize(h)
