"""K12 and K13, the slot writes of the sequence-leading (L, T, B, Hkv, D)
cache, timed through their public wrappers beside the library call that
does the same work: `copy_` of the new rows into the slot's view, once a
cache (two for K13).

At Llama-3.2-1B's lockstep cache (L 16, T 842, B 4, Hkv 8, D 64, bf16,
slot T - 128) it prints one JSON line per call (K13, K12, two `copy_`s,
one `copy_`, K13's and K12's plain versions) with:

  ms         one eager call with its host cost: the CUDA-event time around
             a single call, the median of 50;
  graph_ms   device time from a CUDA graph of 10 calls (the window also
             holds the graph's submission);
  busy_ms    the same graph replayed behind a sleep kernel, so the window
             holds the calls' own device time; busy1_ms: a graph of 1
             call (no launch before it to overlap);
  bound_ms   the new rows read once and written once at 3.35 TB/s.

At a shape where the bytes bound the write (L 16, T 64, B 256, Hkv 8,
D 64, bf16: 4 MiB of new rows a cache) it prints K13 and two `copy_`s
HBM-cold: a CUDA graph of one pass of calls, each to its own slot with its
own copy of the new rows, the copies past twice the L2
(`_timing.time_pass`), with the share of the bound reached.

It uses only what the package and its parent both have (the wrappers and
`_timing`), so run it with the tree to time first on the path:

    cd TREE && PYTHONPATH=. python3 PATH/TO/time_slab_write.py \\
        [--reps N] [--out time_slab_write.jsonl] [--tag parent]

`--device cpu` runs the plain versions at a tiny shape (host time only).
"""

from __future__ import annotations

import json
import statistics

import torch

from prot2text_tpu_torch.kernels import cache_update as cu
from prot2text_tpu_torch.scripts._timing import (
    bound, copies, parser, setup, time_pass)

LEGACY = (16, 842, 4, 8, 64)           # L, T, B, Hkv, D
BYTES_BOUND = (16, 64, 256, 8, 64)
TINY = (2, 9, 2, 2, 16)                # --device cpu


def event_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Median CUDA-event time of one eager fn() in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def graph_times(fn, calls: int, busy: bool, iters: int = 30) -> float:
    """ms per fn() from a CUDA graph of `calls` calls, the median of
    `iters` replays; with `busy` each replay is submitted behind a sleep
    kernel (~0.1 ms), so the window holds the calls' device time only."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        if busy:
            torch.cuda._sleep(200000)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    del graph
    return statistics.median(times) / calls


def operands(shape, dev, seed: int):
    """Random bf16 k and v caches of `shape` and their new rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    L, T, B, Hkv, D = shape

    def randn(*s):
        return torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)

    return (randn(L, T, B, Hkv, D), randn(L, T, B, Hkv, D),
            randn(L, B, Hkv, D), randn(L, B, Hkv, D))


def legacy_times(dev, shape=LEGACY, seed: int = 97) -> list:
    """One row per call at the legacy shape, each checked bit for bit
    against the plain version first."""
    ck, cv, nk, nv = operands(shape, dev, seed)
    idx = shape[1] - 128 if shape[1] > 128 else shape[1] - 1
    vk, vv = ck[:, idx], cv[:, idx]          # the library's views, prebuilt
    want = cu.cache_slot_write_kv_plain(ck.clone(), cv.clone(), nk, nv, idx)
    got = cu.cache_slot_write_kv(ck.clone(), cv.clone(), nk, nv, idx)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError("K13 is not bit-exact at the legacy shape")
    calls = (
        ("K13", lambda: cu.cache_slot_write_kv(ck, cv, nk, nv, idx), 2),
        ("K12", lambda: cu.cache_slot_write(ck, nk, idx), 1),
        ("copy_ x2", lambda: (vk.copy_(nk), vv.copy_(nv)), 2),
        ("copy_", lambda: vk.copy_(nk), 1),
        ("K13 plain",
         lambda: cu.cache_slot_write_kv_plain(ck, cv, nk, nv, idx), 2),
        ("K12 plain", lambda: cu.cache_slot_write_plain(ck, nk, idx), 1))
    rows = []
    for name, fn, caches in calls:
        moved = 2 * caches * nk.numel() * nk.element_size()
        row = dict(call=name, shape=shape, slot=idx, **bound(0.0, moved))
        if dev.type == "cuda":
            row.update(ms=event_ms(fn),
                       graph_ms=graph_times(fn, 10, busy=False),
                       busy_ms=graph_times(fn, 10, busy=True),
                       busy1_ms=graph_times(fn, 1, busy=True))
        else:
            row.update(time_pass(fn, 1, dev, 5))
        rows.append(row)
    return rows


def cold_times(dev, reps: int, shape=BYTES_BOUND, seed: int = 98) -> list:
    """K13 and two `copy_`s HBM-cold at the bytes-bound shape: each call of
    a pass writes its own slot from its own copy of the new rows."""
    ck, cv, nk, nv = operands(shape, dev, seed)
    L, T = shape[:2]
    per_call = 2 * (nk.numel() + nv.numel()) * nk.element_size()
    n = min(T, copies(per_call // 2, dev))
    news = [(nk, nv)] + [(nk.clone(), nv.clone()) for _ in range(n - 1)]
    views = [(ck[:, s], cv[:, s]) for s in range(n)]
    want = cu.cache_slot_write_kv_plain(ck.clone(), cv.clone(), nk, nv, 0)
    got = cu.cache_slot_write_kv(ck.clone(), cv.clone(), nk, nv, 0)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError("K13 is not bit-exact at the bytes-bound shape")
    del want, got
    passes = (
        ("K13", lambda: [cu.cache_slot_write_kv(ck, cv, a, b, s)
                         for s, (a, b) in enumerate(news)]),
        ("copy_ x2", lambda: [(vk.copy_(a), vv.copy_(b))
                              for (vk, vv), (a, b) in zip(views, news)]))
    rows = []
    for name, run in passes:
        t = time_pass(run, n, dev, reps)
        row = dict(call=name, shape=shape, calls=n, cold_ms=t["ms"],
                   host_ms=t["host_ms"], **bound(0.0, per_call))
        if t["ms"]:
            row["bound_share"] = row["bound_ms"] / t["ms"]
        rows.append(row)
    return rows


def main(argv=None) -> list:
    p = parser(__doc__, reps=20)
    p.add_argument("--out", default=None, help="append the rows here")
    p.add_argument("--tag", default="", help="label every row")
    args = p.parse_args(argv)
    dev, card = setup(args)
    cuda = dev.type == "cuda"
    rows = legacy_times(dev, LEGACY if cuda else TINY)
    rows += cold_times(dev, args.reps, BYTES_BOUND if cuda else TINY)
    for r in rows:
        r.update(tag=args.tag, card=card)
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return rows


if __name__ == "__main__":
    main()
