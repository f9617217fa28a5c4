"""Checkpoint and resume (counterpart of prot2text_tpu/core/checkpoint.py).

The same layout — `{directory}/step_{N}` under a timestamped root
(`checkpoints_%y%m%d_%H%M%S`), resume restoring the step counter — with the
port's own contents: `torch.save` of the nested dict (tensors moved to the
CPU, ints kept) as `step_{N}/checkpoint.pt`.  Conversion to and from the JAX
package's orbax checkpoints is still to come (ROADMAP.md §1 item 13).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional

import torch

FILE = "checkpoint.pt"


def timestamped_dir(base: str, prefix: str = "checkpoints") -> str:
    stamp = datetime.datetime.now().strftime("%y%m%d_%H%M%S")
    path = os.path.join(base, f"{prefix}_{stamp}")
    os.makedirs(path, exist_ok=True)
    return path


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    return tree


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Write `tree` (nested dicts of tensors, ints and None) to
    {directory}/step_{step}; returns that path."""
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, FILE + ".tmp")
    torch.save(_to_cpu(tree), tmp)
    os.replace(tmp, os.path.join(path, FILE))
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       map_location="cpu") -> Any:
    """The tree saved at `step` (the latest when None), its tensors on
    `map_location`."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(os.path.abspath(directory), f"step_{step}", FILE)
    return torch.load(path, map_location=map_location, weights_only=True)
