"""Profiling (counterpart of prot2text_tpu/core/observe.py `trace`)."""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Profile the enclosed steps with `torch.profiler` (host, and the card
    where there is one) and write a Chrome trace to `logdir/trace.json`;
    no-op when logdir is None."""
    if not logdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
