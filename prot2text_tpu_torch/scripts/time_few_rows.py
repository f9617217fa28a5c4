"""K10, K11a, K11b and K14 at a decode step's rows, and K15a-e at their
probes' 16 rows, timed HBM-cold through the public wrappers, so that two
trees of the package can be held against each other on one card.

For Qwen3-14B's projections (q/o, k/v, gate/up, down and the LM head), each
weight format (int4 nibble planes, int8, int4 split-half bytes, int4
bf16-pair words) and R 1, 4 and 8 it prints and writes one JSON line with:

  ms        device time per call from a CUDA graph that rotates through
            weight copies exceeding twice the L2 (`_timing.time_pass`);
  eager_ms  one eager call with its host cost: the CUDA-event time around
            a single call, the median of 20 (chip_smoke.py's `cuda_ms`);
  host_ms   the host's cost of one call: the host clock over 200 calls
            enqueued back to back with no synchronisation (their device
            time, shorter, hides behind it), per call;
  lib_ms    `torch.matmul` of x with the weight dequantized to bf16 before
            the timed region, rotating through its own copies (R 8 and, at
            gate/up, every R);
  bound_ms  the weight, its scales and x read once and y written once at
            3.35 TB/s, or the operations at 989 TFLOP/s if larger;

and the same for K15a (bc 256 and 128) at (4096, 14336), K15b, K15c and
K15d at (4096, 14336) and K15e at (5120, 17408), R 16, beside
`torch.matmul` on their dequantized weights.  Every output is held
against its plain version (2e-2 · max|plain|) before it is timed.

It uses only what both the package and its parent have (the public
wrappers and `_timing`), so run it with the tree to time first on the
path:

    cd TREE && PYTHONPATH=. python3 PATH/TO/time_few_rows.py \\
        [--reps N] [--out time_few_rows.jsonl] [--tag parent]
"""

from __future__ import annotations

import json
import statistics
import time

import torch

from prot2text_tpu_torch.kernels import probe_quant_matmul as pq
from prot2text_tpu_torch.kernels import quant_matmul as qm
from prot2text_tpu_torch.scripts._timing import (
    bound, check_close, copies, parser, setup, time_pass)

# Qwen3-14B's projections (K, N)
SHAPES = {"q/o": (5120, 5120), "k/v": (5120, 1024),
          "gate/up": (5120, 17408), "down": (17408, 5120),
          "head": (5120, 151936)}
ROWS = (1, 4, 8)
# weight format → (packer of (K, N) integers in [lo, hi), lo, hi, kernel,
# plain twin, the integers' unpacker)
FORMATS = {
    "planes": (qm.pack_int4_planes, -8, 8, qm.quant_matmul_int4_planes,
               qm.quant_matmul_int4_planes_plain, qm.unpack_int4_planes),
    "int8": (lambda q: q, -127, 128, qm.quant_matmul_int8,
             qm.quant_matmul_int8_plain, lambda w: w),
    "bytes": (qm.pack_int4, -8, 8, qm.quant_matmul_int4,
              qm.quant_matmul_int4_plain, qm.unpack_int4),
    "pairs": (qm.pack_int4_pairs, -8, 8, qm.quant_matmul_int4_pairs,
              qm.quant_matmul_int4_pairs_plain, qm.unpack_int4_pairs),
}
# probe → (kernel, plain, (K, N), the weight's packer from integers in
# [lo, hi), lo, hi, keyword arguments, the integers' unpacker)
PROBES = {
    "K15a bc256": (pq.chunk_mm, pq.chunk_mm_plain, (4096, 14336),
                   lambda q: q, -128, 128, {"bc": 256}, lambda w: w),
    "K15a bc128": (pq.chunk_mm, pq.chunk_mm_plain, (4096, 14336),
                   lambda q: q, -128, 128, {"bc": 128}, lambda w: w),
    "K15b": (pq.mm_i4f, pq.mm_i4f_plain, (4096, 14336), qm.pack_int4, -8, 8,
             {}, qm.unpack_int4),
    "K15c": (pq.mm_i4n, pq.mm_i4n_plain, (4096, 14336), pq.pack_int4_native,
             -8, 8, {}, pq.unpack_int4_native),
    "K15d": (pq.mm_i4p, pq.mm_i4p_plain, (4096, 14336), qm.pack_int4_planes,
             -8, 8, {}, qm.unpack_int4_planes),
    "K15e": (pq.mm_i4and, pq.mm_i4and_plain, (5120, 17408), qm.pack_int4,
             -8, 8, {}, qm.unpack_int4),
}


def eager_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one eager fn() with its host cost."""
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


def host_ms(fn, calls: int = 200) -> float:
    """Host milliseconds per call of `calls` calls enqueued back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / calls


def _cold(fn, w, dev, reps):
    """fn(w_i) timed over copies of w that exceed twice the L2."""
    ws = [w] + [w.clone() for _ in range(
        copies(w.numel() * w.element_size(), dev) - 1)]
    t = time_pass(lambda: [fn(wi) for wi in ws], len(ws), dev, reps)
    del ws
    return t


def main(argv=None) -> list:
    p = parser(__doc__, reps=10)
    p.add_argument("--out", default="time_few_rows.jsonl")
    p.add_argument("--tag", default="", help="a name for the tree timed")
    args = p.parse_args(argv)
    dev, card = setup(args)
    if dev.type != "cuda":
        raise SystemExit("time_few_rows times the card's kernels: "
                         "--device cuda")
    print(f"time_few_rows [{args.tag}] on {card}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(17)
    lines = []

    def emit(**line):
        line.update(tag=args.tag, card=card)
        lines.append(line)
        lib = line.get("lib_ms")
        print(f"[{args.tag}] {line['what']} R={line['R']}: "
              f"{line['ms']:.4f} ms, bound {line['bound_ms']:.4f} "
              f"({line['bound_ms'] / line['ms']:.1%}), eager "
              f"{line['eager_ms']:.4f} ms, host {line['host_ms']:.4f} ms"
              + ("" if lib is None else f", torch.matmul {lib:.4f} ms"),
              flush=True)

    for name, (K, N) in SHAPES.items():
        for fmt, (pack, lo, hi, kern, plain, unpack) in FORMATS.items():
            q = torch.randint(lo, hi, (K, N), generator=gen, device=dev,
                              dtype=torch.int8)
            w = pack(q)
            del q
            scale = torch.rand((1, N), generator=gen, device=dev) * 0.03 + 2e-3
            wd = (unpack(w).float() * scale).to(torch.bfloat16)
            for R in ROWS:
                x = torch.randn((R, K), generator=gen, device=dev).to(
                    torch.bfloat16)
                check_close(f"{fmt} {name} R={R}", kern(x, w, scale),
                            plain(x, w, scale), 2e-2)
                t = _cold(lambda wi: kern(x, wi, scale), w, dev, args.reps)
                lib = None
                if R == 8 or name == "gate/up":
                    lib = _cold(lambda wi: torch.matmul(x, wi), wd, dev,
                                args.reps)["ms"]
                bd = bound(2.0 * R * K * N, w.numel() * w.element_size()
                           + 4 * N + 2 * R * K + 2 * R * N)
                emit(what=f"{fmt} {name}", fmt=fmt, shape=name, K=K, N=N,
                     R=R, ms=t["ms"], eager_ms=eager_ms(
                         lambda: kern(x, w, scale)), host_ms=host_ms(
                         lambda: kern(x, w, scale)), lib_ms=lib,
                     bound_ms=bd["bound_ms"], bound_by=bd["bound_by"])
                del x
            del w, wd, scale
            torch.cuda.empty_cache()
    R = 16
    for kid, (kern, plain, (K, N), pack, lo, hi, kw, unpack) in (
            PROBES.items()):
        q = torch.randint(lo, hi, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        w = pack(q)
        del q
        scale = torch.rand((1, N), generator=gen, device=dev) * 0.03 + 2e-3
        x = torch.randn((R, K), generator=gen, device=dev).to(torch.bfloat16)
        check_close(kid, kern(x, w, scale, **kw), plain(x, w, scale), 2e-2)
        t = _cold(lambda wi: kern(x, wi, scale, **kw), w, dev, args.reps)
        wd = (unpack(w).float() * scale).to(torch.bfloat16)
        lib = _cold(lambda wi: torch.matmul(x, wi), wd, dev, args.reps)
        bd = bound(2.0 * R * K * N, w.numel() * w.element_size() + 4 * N
                   + 2 * R * K + 2 * R * N)
        emit(what=kid, K=K, N=N, R=R, ms=t["ms"],
             eager_ms=eager_ms(lambda: kern(x, w, scale, **kw)),
             host_ms=host_ms(lambda: kern(x, w, scale, **kw)),
             lib_ms=lib["ms"], bound_ms=bd["bound_ms"],
             bound_by=bd["bound_by"])
        del w, wd, x, scale
        torch.cuda.empty_cache()
    with open(args.out, "w") as f:
        for ln in lines:
            f.write(json.dumps(ln) + "\n")
    return lines


if __name__ == "__main__":
    main()
