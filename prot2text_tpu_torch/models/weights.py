"""Parameter containers and the bridge to and from the JAX package's params.

A `ParamTree` is an `nn.Module` mirroring a JAX param pytree name for name:
nested dicts become submodules, array leaves become `nn.Parameter`s (frozen
unless asked otherwise), `None` leaves (the LoRA trees' untargeted
positions, prot2text_tpu/models/lora.py:98-115) stay `None`, so
`state_dict()` keys are the JAX tree paths joined by "." (e.g.
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
    def __init__(self, tree: dict, *, requires_grad: bool = False):
        super().__init__()
        self._keys = list(tree)       # tree() keeps the source's key order
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, ParamTree(leaf,
                                                requires_grad=requires_grad))
            elif leaf is None:
                self.register_parameter(name, None)
            else:
                self.register_parameter(
                    name, nn.Parameter(leaf, requires_grad=requires_grad))

    def tree(self) -> dict:
        return {name: (self._modules[name].tree() if name in self._modules
                       else self._parameters[name]) for name in self._keys}


def params_from_jax(tree, *, device="cpu", dtype=None,
                    requires_grad: bool = False) -> ParamTree:
    """Nested dict of numpy arrays (the JAX params after
    `jax.tree_util.tree_map(np.asarray, params)`; `None` leaves allowed) →
    ParamTree on `device`.  Float leaves are cast to `dtype` when given;
    integer leaves keep theirs.  `requires_grad=True` makes every leaf a
    trainable parameter (the LoRA trees and the adapter)."""
    def convert(x):
        if isinstance(x, dict):
            return {k: convert(v) for k, v in x.items()}
        if x is None:
            return None
        a = np.asarray(x)
        if a.dtype.kind not in "fiub":       # bf16 and other ml_dtypes
            a = a.astype(np.float32)
        t = torch.from_numpy(np.array(a))      # a writable copy
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return ParamTree(convert(tree), requires_grad=requires_grad)


def tree_to_numpy(tree):
    """Nested dict of tensors (a `ParamTree.tree()`, gradients, optimizer
    moments) → nested dict of numpy arrays, `None` leaves kept; bf16 leaves
    come back as float32.  The reverse of `params_from_jax`."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if tree is None:
        return None
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def tree_map(fn, tree, *rest):
    """fn over the tensor leaves of nested dicts of one structure; `None`
    leaves stay `None`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensor leaves of nested dicts, in key order, `None`s skipped."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [] if tree is None else [tree]


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
