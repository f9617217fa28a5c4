"""Explicit device resolution: a requested GPU that is missing is an error,
never a silent switch to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """"cuda", "cuda:N" or "cpu" (or a torch.device) → torch.device.

    Raises RuntimeError when a CUDA device is requested and none is usable."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA GPU is "
                "available (torch.cuda.is_available() is False)")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(device)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} "
                         "(expected 'cpu' or 'cuda[:N]')")
    return dev
