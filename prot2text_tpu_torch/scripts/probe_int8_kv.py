"""int8 KV-cache probes (the port of scripts/probe_int8_kv.py): the five
operations the int8 cache kernels are built from, each run as its own
small kernel on the card at the probe's sizes (Hkv 8, T 192, D 128) and
checked over its whole output:

  p1 K15h  f32 -> int8 convert and store: int8(clip(round(4x), ±127));
  p2 K15i  int8 select: row 7 of a, the rest of b;
  p3 K15j  in-place int8 write of slot 77 (in the 32-row group 77 // 32)
           of every head of a (1, 8, 192, 128) cache, the slot read by the
           kernel from a device int32: only that row may change;
  p4 K15k  int8 -> bf16 logits, (q @ bf16(c)ᵀ) · s (rtol 1e-2, the
           probe's);
  p5 K15l  in-place f32 scale-row write of column 77: only that column may
           change.

Each line says OK or FAIL, with the device time per call (a CUDA graph of
20 calls) and its bound;
the exit code is 0 only if all five pass.  A kernel that fails to build or
launch raises.  (The TPU probe's p3 and p5 alias operand 1, `kn` or `sn`,
to their output where the cache is operand 2, so they cannot pass there;
see ROADMAP.md §3.)

    python -m prot2text_tpu_torch.scripts.probe_int8_kv [--device cuda|cpu]
        [--reps N]
"""

from __future__ import annotations

import sys

import torch

from ..kernels.probe_int8_kv import (
    f32_scale_row_rmw, f32_to_int8_store, int8_group_rmw, int8_select,
    int8_to_bf16_matmul,
)
from ._timing import parser, row, setup, show, time_pass

Hkv, T, D = 8, 192, 128
SLOT = 77
# calls per timed pass: one of these kernels takes about 2 us on the card,
# less than the replay of a one-call CUDA graph costs
CALLS = 20


def p1(dev):
    x = torch.linspace(-20, 20, T * D, dtype=torch.float32,
                       device=dev).reshape(T, D)
    want = torch.clamp(torch.round(x * 4.0), -127, 127).to(torch.int8)
    return (lambda: f32_to_int8_store(x, 4.0),
            lambda out: torch.equal(out, want), 0, 5 * T * D)


def p2(dev):
    a = torch.full((T, D), 3, dtype=torch.int8, device=dev)
    b = torch.full((T, D), -5, dtype=torch.int8, device=dev)
    want = b.clone()
    want[7] = 3
    # bytes the function must move: b, row 7 of a, the output
    return (lambda: int8_select(a, b, 7),
            lambda out: torch.equal(out, want), 0, 2 * T * D + D)


def p3(dev):
    cache = torch.full((1, Hkv, T, D), -1, dtype=torch.int8, device=dev)
    kn = torch.full((Hkv, D), 42, dtype=torch.int8, device=dev)
    slot = torch.tensor([SLOT], dtype=torch.int32, device=dev)
    want = cache.clone()
    want[0, :, SLOT] = 42
    return (lambda: int8_group_rmw(cache, kn, slot),
            lambda out: out is cache and torch.equal(out, want), 0,
            2 * Hkv * D + 4)


def p4(dev):
    q = torch.ones((8, D), dtype=torch.bfloat16, device=dev)
    c = (torch.arange(T * D, device=dev).reshape(T, D) % 7 - 3).to(
        torch.int8)
    s = torch.full((1, T), 0.5, device=dev)
    want = (torch.ones((8, D), device=dev) @ c.float().t()) * 0.5
    return (lambda: int8_to_bf16_matmul(q, c, s),
            lambda out: torch.allclose(out, want, rtol=1e-2, atol=0),
            2.0 * 8 * T * D, 2 * 8 * D + T * D + 4 * T + 4 * 8 * T)


def p5(dev):
    s = torch.full((1, Hkv, T), 0.25, device=dev)
    sn = torch.full((Hkv, 1), 9.0, device=dev)
    slot = torch.tensor([SLOT], dtype=torch.int32, device=dev)
    want = s.clone()
    want[0, :, SLOT] = 9.0
    return (lambda: f32_scale_row_rmw(s, sn, slot),
            lambda out: out is s and torch.equal(out, want), 0,
            2 * 4 * Hkv + 4)


PROBES = (("p1 f32->int8 store", "K15h", p1),
          ("p2 int8 select", "K15i", p2),
          ("p3 dynamic int8 32-group RMW", "K15j", p3),
          ("p4 int8->bf16 matmul + scale", "K15k", p4),
          ("p5 f32 scale-row RMW", "K15l", p5))


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    dev, card = setup(args)
    print(f"probe_int8_kv on {card}: Hkv={Hkv} T={T} D={D} slot={SLOT}",
          flush=True)
    rows, ok = [], True
    for name, kid, make in PROBES:
        call, passes, flops, nbytes = make(dev)
        good = bool(passes(call()))
        print(f"[probe] {name}: {'OK' if good else 'FAIL'}", flush=True)
        ok &= good
        t = time_pass(lambda: [call() for _ in range(CALLS)], CALLS, dev,
                      args.reps)
        rows.append(row(name, kid, t, flops, nbytes, ok=good))
        show(rows[-1])
    return dict(device=card, rows=rows, ok=ok)


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
