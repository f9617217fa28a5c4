"""LoRA as separate parameter trees (counterpart of
prot2text_tpu/models/lora.py).

The reference's PEFT config: r=32, alpha=2r, targets q/k/v/o + gate/up/down
on the LLM and the fused qkv, out_proj, ffn_in and ffn_out on ESMC.  For
every targeted kernel leaf (path ending in `<target>/kernel`, shape (...,
din, dout) — stacked layers keep their leading L dim) the tree holds A:
(..., din, r) and B: (..., r, dout), B zero so the initial model equals the
base; every other leaf is `None`.  A quantized base (`models/quant.
quantize_params`) is a LoRA base too (QLoRA): the {"A","B"} dict sits under
the key the base leaf holds (`kernel_q`, `kernel_q4p`, `kernel_q4w`,
`kernel_q4`), and A's din is the unpacked contraction dim
(`quant.unpacked_in_dim`).  Training adds the side path
(`transformer.linear_lora`); `merge_lora` materializes W + (alpha/r)·A@B for
merge-and-unload into a float base.  Paths are joined with "/" as in the
JAX package, so the same regexes select the same leaves.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Sequence

import torch

from .quant import unpacked_in_dim
from .weights import tree_leaves


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 32
    alpha: int = 64           # reference: lora_alpha = 2 * r
    # regexes over tree paths (joined with '/'); the quantized kernel leaves
    # are LoRA bases too (QLoRA), as in JAX
    target_patterns: Sequence[str] = (
        r"(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj)"
        r"/kernel(_q|_q4|_q4p|_q4w)?$",
        r"(qkv|out_proj|ffn_in|ffn_out)/kernel(_q|_q4|_q4p|_q4w)?$",
    )

    @property
    def scale(self) -> float:
        return self.alpha / self.r


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _is_target(cfg: LoraConfig, path: str) -> bool:
    return any(re.search(p, path) for p in cfg.target_patterns)


# kernel-leaf keys a LoRA subtree may mirror, looked up exactly, as JAX's
# (a prefix match would take "kernel_q4" for "kernel_q4p")
_KERNEL_KEYS = ("kernel", "kernel_q", "kernel_q4p", "kernel_q4w",
                "kernel_q4")


def lora_at(sub) -> Any:
    """The {"A","B"} dict at a (possibly quantized) linear's kernel leaf of
    a LoRA subtree, or None.  `sub` mirrors the param dict, e.g.
    {"kernel_q4p": {"A", "B"}, "scale": None}."""
    if not isinstance(sub, dict):
        return None
    for k in _KERNEL_KEYS:
        v = sub.get(k)
        if v is not None:
            return v
    return None


def init_lora_params(cfg: LoraConfig, base_params: dict, *, generator,
                     dtype=torch.float32):
    """A tree with the structure of `base_params`: {"A","B"} dicts at the
    targeted kernel leaves (float or quantized), None elsewhere.  A ~
    N(0, 0.01²) of shape (..., din, r), din unpacked from a packed int4
    leaf, drawn from `generator` on the base leaf's device; B = 0 of shape
    (..., r, dout); both in `dtype` (f32)."""

    def walk(tree, path):
        out = {}
        for name, leaf in tree.items():
            p = path + (name,)
            if isinstance(leaf, dict):
                out[name] = walk(leaf, p)
                continue
            if not (name in _KERNEL_KEYS and leaf.dim() >= 2
                    and _is_target(cfg, _path_str(p))):
                out[name] = None
                continue
            *lead, _, dout = leaf.shape
            din = unpacked_in_dim(name, leaf.shape)
            A = torch.randn((*lead, din, cfg.r), generator=generator,
                            device=leaf.device, dtype=dtype).mul_(0.01)
            B = torch.zeros((*lead, cfg.r, dout), device=leaf.device,
                            dtype=dtype)
            out[name] = {"A": A, "B": B}
        return out

    return walk(base_params, ())


def merge_lora(cfg: LoraConfig, base_params: dict, lora_params: dict):
    """W_eff = W + scale · A@B at every linear the LoRA tree adapts
    (batched over any leading layer-stack dims), in the base leaf's dtype;
    other leaves pass through.  The A/B of a linear may sit under any
    kernel key (`lora_at`): a tree trained over a quantized base (QLoRA)
    merges into the float `kernel` of the same linear.  Integer (quantized)
    bases are refused, as in JAX, and so is a LoRA whose linear the base
    lacks: no LoRA is ever dropped."""

    def merge(base, lora, path):
        held = bool(tree_leaves(lora)) if isinstance(lora, dict) else False
        if not isinstance(base, dict):
            if held:
                raise ValueError(f"LoRA at {path or '/'} has no linear in "
                                 "the base (a tensor leaf there)")
            return base
        ab = lora_at(lora)
        if ab is None:
            extra = [k for k, v in (lora or {}).items()
                     if k not in base and tree_leaves(v)]
            if extra:
                raise ValueError(f"LoRA at {path or '/'} names {extra}, "
                                 "which the base lacks")
            return {k: merge(v, lora.get(k) if isinstance(lora, dict)
                             else None, f"{path}/{k}")
                    for k, v in base.items()}
        w = base.get("kernel")
        if w is None or not w.is_floating_point():
            if w is not None or any(k in base for k in _KERNEL_KEYS):
                raise ValueError(
                    "merge_lora into a quantized base is unsupported; merge "
                    "into the bf16 weights before quantize_params, or serve "
                    "with the LoRA side path unmerged")
            raise ValueError(f"LoRA at {path} has no linear in the base")
        delta = torch.matmul(ab["A"].float(), ab["B"].float())
        return {**base, "kernel": w + cfg.scale * delta.to(w.dtype)}

    return merge(base_params, lora_params, "")


def lora_param_count(lora_params: dict) -> int:
    return sum(x.numel() for x in tree_leaves(lora_params))
