"""Parameter containers and the bridge from the JAX package's params.

A `ParamTree` is an `nn.Module` mirroring a JAX param pytree name for name:
nested dicts become submodules, array leaves become frozen `nn.Parameter`s,
so `state_dict()` keys are the JAX tree paths joined by "." (e.g.
`layers.q_proj.kernel`).  The layout is the JAX one: stacked (L, ...) layer
leaves and `kernel` stored (in, out) (prot2text_tpu/models/decoder.py:52-90,
esm2.py:84-118, adapters.py:41-54).  Model code reads `tree()` — a nested
dict of the live parameters — with the same functions the JAX package
uses on its pytrees.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class ParamTree(nn.Module):
    def __init__(self, tree: dict):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, ParamTree(leaf))
            else:
                self.register_parameter(
                    name, nn.Parameter(leaf, requires_grad=False))

    def tree(self) -> dict:
        out = {name: p for name, p in self._parameters.items()}
        for name, m in self._modules.items():
            out[name] = m.tree()
        return out


def params_from_jax(tree, *, device="cpu", dtype=None) -> ParamTree:
    """Nested dict of numpy arrays (the JAX params after
    `jax.tree_util.tree_map(np.asarray, params)`) → ParamTree on `device`.
    Float leaves are cast to `dtype` when given; integer leaves keep theirs."""
    def convert(x):
        if isinstance(x, dict):
            return {k: convert(v) for k, v in x.items()}
        a = np.asarray(x)
        if a.dtype.kind not in "fiub":       # bf16 and other ml_dtypes
            a = a.astype(np.float32)
        t = torch.from_numpy(np.array(a))      # a writable copy
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return ParamTree(convert(tree))


def normal_(shape, *, generator, device, dtype, std: float = 0.02):
    """N(0, std) drawn on `device` from `generator` (the JAX init's
    `jax.random.normal(...) * 0.02`; the bits differ, the law does not)."""
    t = torch.randn(shape, generator=generator, device=device, dtype=dtype)
    return t.mul_(std)


def dense(din, dout, *, generator, device, dtype, bias: bool):
    p = {"kernel": normal_((din, dout), generator=generator, device=device,
                           dtype=dtype)}
    if bias:
        p["bias"] = torch.zeros(dout, device=device, dtype=dtype)
    return p
