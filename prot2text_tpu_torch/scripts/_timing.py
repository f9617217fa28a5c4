"""Timing, bounds and rows shared by the port's probe scripts.

Device time: one pass of a probe's calls is captured in a CUDA graph and
replayed `reps` times between two CUDA events; a call's time is the total
over the calls replayed, so the host's per-call cost (argument checks,
allocations, the ctypes call) stays out of it.  The eager time of a pass,
host cost included and synchronised, is reported beside it.  On the CPU
only that host time exists: a row then has no device time, rate or share.

L2: an H100 keeps 50 MB in L2, and a weight read from it again and again
would read faster than HBM allows.  Every probe's pass therefore rotates
through weight copies or stacked layers that together hold at least twice
that (`copies`), so each call reads its weight from HBM.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import time

import torch

from ..core.device import resolve_device

# NVIDIA's H100 SXM data sheet, dense rates
PEAK_BYTES = 3.35e12          # HBM bytes per second
PEAK_BF16 = 989e12            # bf16 tensor-core operations per second
PEAK_INT8 = 1979e12           # int8 tensor-core operations per second
L2_BYTES = 50 * 2**20
MAX_COPIES = 16


def parser(description: str, reps: int = 20) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    p.add_argument("--reps", type=int, default=reps,
                   help="CUDA-graph replays of a pass (on the CPU: eager "
                        "passes) that are timed")
    return p


def setup(args):
    """The device, and a line naming it: on a card its name and power limit
    as nvidia-smi reports them."""
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        return dev, "cpu (plain versions; host time only)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        out = f"{torch.cuda.get_device_name(dev)}, power limit not read"
    return dev, out


def copies(nbytes: int, dev) -> int:
    """Weight copies whose total exceeds twice the card's L2, at most
    `MAX_COPIES` (a weight under 6.6 MB is then read partly from L2); 1 on
    the CPU."""
    if dev.type != "cuda":
        return 1
    return max(1, min(MAX_COPIES, math.ceil(2 * L2_BYTES / nbytes)))


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16) -> dict:
    """The least time the card could take: the larger of the bytes (each
    input read once, each output written once) at the HBM rate and the
    operations at `peak`."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms > bytes_ms else "bytes",
                ops_ms=ops_ms, bytes_ms=bytes_ms)


def time_pass(run, calls: int, dev, reps: int) -> dict:
    """ms per call of `run()`, one pass of `calls` calls: device time from
    a CUDA graph of the pass (None on the CPU) and the eager host time."""
    run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_eager = 3 if dev.type == "cuda" else max(1, reps)
    for _ in range(n_eager):
        run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / (n_eager * calls)
    if dev.type != "cuda":
        return dict(ms=None, host_ms=host_ms)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * calls)
    del graph
    return dict(ms=ms, host_ms=host_ms)


def row(variant: str, kernel: str, t: dict, flops: float, nbytes: float,
        peak: float = PEAK_BF16, **extra) -> dict:
    """One variant's row: device ms per call, GB/s and TOP/s from the
    call's bytes and operations, its bound and the share of it reached."""
    ms = t["ms"]
    b = bound(flops, nbytes, peak)
    return dict(variant=variant, kernel=kernel, ms=ms, host_ms=t["host_ms"],
                bytes=nbytes, flops=flops,
                gb_s=nbytes / ms / 1e6 if ms else None,
                top_s=flops / ms / 1e9 if ms else None,
                share=b["bound_ms"] / ms if ms else None, **b, **extra)


def show(r: dict, rate: str = "gb_s") -> None:
    head = f"{r['variant']:<30} {r['kernel']:<8}"
    if r["ms"] is None:
        print(f"{head} host {r['host_ms']:9.4f} ms/call (plain version)",
              flush=True)
        return
    unit = "GB/s" if rate == "gb_s" else "TOP/s"
    print(f"{head} {r['ms']:9.4f} ms/call  {r[rate]:8.1f} {unit}  bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}) = {r['share']:6.1%}  "
          f"eager {r['host_ms']:.4f} ms/call", flush=True)


def check_close(name: str, got, want, rel: float) -> float:
    """max|got - want| / max|want|; raises above `rel`."""
    got, want = got.float(), want.float()
    top = want.abs().max().item()
    err = (got - want).abs().max().item() / max(top, 1e-30)
    if not (torch.isfinite(got).all() and err <= rel):
        raise RuntimeError(f"{name}: max|kernel - plain| / max|plain| "
                           f"{err:.3e} > {rel}")
    return err


def randint8(shape, gen, dev, lo: int = -128, hi: int = 128):
    return torch.randint(lo, hi, shape, generator=gen, device=dev,
                         dtype=torch.int8)


def layer_chain(fn, x, up, su, dn, sd, **kw):
    """One pass of the TPU probes' layer scan: for each stacked layer l, h =
    fn(fn(h, up[l], su[l]), dn[l], sd[l]), from h = x."""
    def run():
        h = x
        for layer in range(up.shape[0]):
            h = fn(fn(h, up[layer], su[layer], **kw), dn[layer], sd[layer],
                   **kw)
        return h
    return run


def chain_bytes(R: int, H: int, M: int, L: int, weight_bytes: int) -> float:
    """Bytes per call of a layer chain: its weights (both projections of
    every layer), the scales and the bf16 activations read and written,
    over its 2L calls."""
    act = 2 * (2 * R * H + 2 * R * M)            # x, y in; y, out
    return (weight_bytes + L * 4 * (H + M) + L * act) / (2 * L)
