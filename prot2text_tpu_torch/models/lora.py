"""LoRA as separate parameter trees (counterpart of
prot2text_tpu/models/lora.py).

The reference's PEFT config: r=32, alpha=2r, targets q/k/v/o + gate/up/down
on the LLM and the fused qkv, out_proj, ffn_in and ffn_out on ESMC.  For
every targeted kernel leaf (path ending in `<target>/kernel`, shape (...,
din, dout) — stacked layers keep their leading L dim) the tree holds A:
(..., din, r) and B: (..., r, dout), B zero so the initial model equals the
base; every other leaf is `None`.  Training adds the side path
(`transformer.linear_lora`); `merge_lora` materializes W + (alpha/r)·A@B for
merge-and-unload.  Paths are joined with "/" as in the JAX package, so the
same regexes select the same leaves.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Sequence

import torch

from .weights import tree_leaves


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 32
    alpha: int = 64           # reference: lora_alpha = 2 * r
    # regexes over tree paths (joined with '/'); the quantized kernel leaves
    # of the JAX package are matched too, and `init_lora_params` refuses
    # them until weight quantization is ported (ROADMAP.md §1 item 4)
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


def lora_at(sub) -> Any:
    """The {"A","B"} dict at a linear's kernel leaf of a LoRA subtree, or
    None.  `sub` mirrors the param dict, e.g. {"kernel": {"A", "B"}}."""
    if not isinstance(sub, dict):
        return None
    return sub.get("kernel")


def init_lora_params(cfg: LoraConfig, base_params: dict, *, generator,
                     dtype=torch.float32):
    """A tree with the structure of `base_params`: {"A","B"} dicts at the
    targeted kernel leaves, None elsewhere.  A ~ N(0, 0.01²) from
    `generator` on the base leaf's device, B = 0, both in `dtype` (f32)."""

    def walk(tree, path):
        out = {}
        for name, leaf in tree.items():
            p = path + (name,)
            if isinstance(leaf, dict):
                out[name] = walk(leaf, p)
                continue
            if not (_is_target(cfg, _path_str(p)) and leaf.dim() >= 2):
                out[name] = None
                continue
            if name != "kernel" or not leaf.is_floating_point():
                raise NotImplementedError(
                    f"LoRA over the quantized leaf {_path_str(p)} is not "
                    "ported yet (ROADMAP.md §1 item 4)")
            *lead, din, dout = leaf.shape
            A = torch.randn((*lead, din, cfg.r), generator=generator,
                            device=leaf.device, dtype=dtype).mul_(0.01)
            B = torch.zeros((*lead, cfg.r, dout), device=leaf.device,
                            dtype=dtype)
            out[name] = {"A": A, "B": B}
        return out

    return walk(base_params, ())


def merge_lora(cfg: LoraConfig, base_params: dict, lora_params: dict):
    """W_eff = W + scale · A@B at targeted leaves (batched over any leading
    layer-stack dims), in the base leaf's dtype; other leaves pass through.
    Integer (quantized) bases are refused, as in JAX."""

    def merge(base, lora):
        if isinstance(base, dict):
            return {k: merge(v, lora.get(k) if isinstance(lora, dict)
                             else None) for k, v in base.items()}
        if lora is None:
            return base
        if not base.is_floating_point():
            raise ValueError(
                "merge_lora into a quantized base is unsupported; merge "
                "into the bf16 weights before quantize_params, or serve "
                "with the LoRA side path unmerged")
        delta = torch.matmul(lora["A"].float(), lora["B"].float())
        return base + cfg.scale * delta.to(base.dtype)

    return merge(base_params, lora_params)


def lora_param_count(lora_params: dict) -> int:
    return sum(x.numel() for x in tree_leaves(lora_params))
