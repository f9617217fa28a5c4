"""K10/K14/K11a/K11b's two bodies over rows and grids: where the many-row
`wgmma` body (csrc/quant_matmul_rows.cuh) overtakes the few-row TMA body
(csrc/quant_matmul.cuh), which grid of the many-row body and which cluster
of the few-row body is fastest, at Qwen3-14B's projections and LM head.

For each projection (K, N), each weight format (int4 nibble planes, int8,
int4 split-half bytes, int4 bf16-pair words) and each row count it times,
device time per call from CUDA graphs that rotate through weight copies
exceeding twice the L2 (`_timing.time_pass`):

  few    the few-row body (`quant_matmul._few_rows`) and, at
         `--few_grid_rows`, at every K split over a cluster it can launch
         (`quant_matmul.few_rows_tiling(ck=...)`) and at the rule's cluster
         with `--few_stages` ring stages;
  rows   the many-row body at `quant_matmul.rows_tiling`'s grid and, for
         planes and int8 at `--grid_rows`, at every grid it can launch
         (rows a block fixed by R; columns 128/256, K split Ck; bytes and
         pairs take planes' grids, on which they are planes bit for bit);
  lib    `torch.matmul` of x with the weight dequantized to bf16 before the
         timed region, and at the install's rows also `dequantize_kernel`
         followed by `torch.matmul` (the route the many-row body replaces).

Every output is held against the plain version (2e-2 · max|plain|).  One
JSON line per timing goes to `--out`, and a summary names, per projection
and format, the rows at which the many-row body beats the few-row body,
and per (R, projection, format) the fastest grid.

    python -m prot2text_tpu_torch.scripts.sweep_quant_rows [--device cuda]
        [--reps N] [--out sweep_quant_rows.jsonl] [--grid_rows 40,64,128]
        [--few_grid_rows 8] [--few_stages 3,5,6]
"""

from __future__ import annotations

import json

import torch

from ..kernels import quant_matmul as qm
from ..models.quant import dequantize_kernel
from ._timing import bound, check_close, copies, parser, setup, time_pass

# Qwen3-14B's projections (K, N)
SHAPES = {"q/o": (5120, 5120), "k/v": (5120, 1024),
          "gate/up": (5120, 17408), "down": (17408, 5120),
          "head": (5120, 151936)}
# weight format → (leaf key, packer of (K, N) integers in [lo, hi), lo, hi,
# plain twin)
FORMATS = {
    "planes": ("kernel_q4p", qm.pack_int4_planes, -8, 8,
               qm.quant_matmul_int4_planes_plain),
    "int8": ("kernel_q", lambda q: q, -127, 128, qm.quant_matmul_int8_plain),
    "bytes": ("kernel_q4", qm.pack_int4, -8, 8, qm.quant_matmul_int4_plain),
    "pairs": ("kernel_q4w", qm.pack_int4_pairs, -8, 8,
              qm.quant_matmul_int4_pairs_plain),
}
# bits of a weight format's integers
FORMATS_BITS = {"planes": 4, "int8": 8, "bytes": 4, "pairs": 4}
CROSS_ROWS = (1, 4, 8, 16, 24, 32, 40, 64)
GRID_ROWS = (40, 64, 128)
FEW_GRID_ROWS = (8,)
FEW_STAGES = (3, 5, 6)
INSTALL_ROWS = 3072                  # 8 requests x the 384-token bucket


def grids(R: int, K: int, N: int):
    """Every grid the many-row body launches at R: (bm, bn, Ck)."""
    bm = qm.rows_tiling(R, K, N)[0]
    tiles = -(-K // qm.ROWS_TILE_K)
    for bn in qm.ROWS_BLOCK_COLS:
        if bm == 256 and bn != 128:
            continue
        for ck in qm.ROWS_CLUSTERS:
            if ck == 1 or tiles >= ck * qm.ROWS_MIN_TILES:
                yield bm, bn, ck


def main(argv=None) -> list:
    p = parser(__doc__, reps=10)
    p.add_argument("--out", default="sweep_quant_rows.jsonl")
    p.add_argument("--grid_rows", default=",".join(map(str, GRID_ROWS)),
                   help="rows at which every grid is timed")
    p.add_argument("--few_grid_rows",
                   default=",".join(map(str, FEW_GRID_ROWS)),
                   help="rows at which every cluster of the few-row body "
                        "is timed")
    p.add_argument("--few_stages", default=",".join(map(str, FEW_STAGES)),
                   help="ring stages timed at the few-row rule's cluster")
    args = p.parse_args(argv)
    dev, card = setup(args)
    if dev.type != "cuda":
        raise SystemExit("sweep_quant_rows times the card's kernels: "
                         "--device cuda")
    grid_rows = {int(r) for r in args.grid_rows.split(",") if r}
    few_grid_rows = {int(r) for r in args.few_grid_rows.split(",") if r}
    few_stages = [int(r) for r in args.few_stages.split(",") if r]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"sweep_quant_rows on {card}, {sms} SMs", flush=True)
    gen = torch.Generator(device=dev).manual_seed(11)
    lines = []
    for name, (K, N) in SHAPES.items():
        for fmt, (key, pack, lo, hi, plain) in FORMATS.items():
            q = torch.randint(lo, hi, (K, N), generator=gen, device=dev,
                              dtype=torch.int8)
            w = pack(q)
            del q
            scale = torch.rand((1, N), generator=gen, device=dev) * 0.03 + 2e-3
            ws = [w] + [w.clone() for _ in range(
                copies(w.numel() * w.element_size(), dev) - 1)]
            wd = dequantize_kernel({key: w, "scale": scale}, torch.bfloat16)
            wds = [wd] + [wd.clone() for _ in range(
                copies(wd.numel() * 2, dev) - 1)]
            rs = list(CROSS_ROWS) + sorted(grid_rows - set(CROSS_ROWS))
            if name == "gate/up":
                rs.append(INSTALL_ROWS)
            for R in rs:
                x = torch.randn((R, K), generator=gen, device=dev).to(
                    torch.bfloat16)
                want = plain(x, w, scale)
                bd = bound(2.0 * R * K * N, w.numel() * w.element_size()
                           + 4 * N + 2 * R * K + 2 * R * N)

                def emit(what, t, **extra):
                    line = dict(shape=name, K=K, N=N, R=R, fmt=fmt, what=what,
                                ms=t["ms"], host_ms=t["host_ms"],
                                bound_ms=bd["bound_ms"],
                                bound_by=bd["bound_by"], card=card, **extra)
                    lines.append(line)
                    return line

                runs = []
                if R <= max(CROSS_ROWS) or R in grid_rows:
                    check_close(f"few {name} {fmt} R={R}",
                                qm._few_rows(x, w, scale, fmt), want, 2e-2)
                    runs.append(("few", None, lambda wi: qm._few_rows(
                        x, wi, scale, fmt)))
                if R in few_grid_rows and qm.few_fit(fmt, K, N, 0):
                    bits = FORMATS_BITS[fmt]
                    rule_few = qm.few_rows_tiling(R, K, N, bits)
                    others = [qm.few_rows_tiling(R, K, N, bits, ck=ck)
                              for ck in range(1, qm.FEW_MAX_CLUSTER + 1)]
                    others += [rule_few[:2] + (st,) for st in few_stages
                               if st != rule_few[2]]
                    for few in others:
                        if few is None or few == rule_few:
                            continue

                        def fcall(wi, few=few):
                            out = torch.empty((R, N), dtype=torch.bfloat16,
                                              device=dev)
                            return qm.few_matmul(x, wi.data_ptr(),
                                                 scale.data_ptr(), out, fmt,
                                                 few)
                        check_close(f"few {name} {fmt} R={R} {few}",
                                    fcall(w), want, 2e-2)
                        runs.append(("fgrid", few, fcall))
                rule = qm.rows_tiling(R, K, N, sms)
                tilings = [rule]
                if R in grid_rows and fmt in ("planes", "int8"):
                    tilings += [g for g in grids(R, K, N) if g != rule]
                if R == INSTALL_ROWS and fmt in ("planes", "int8"):
                    # 128 rows a block beside 256
                    tilings += [g for g in ((128, 256, 1), (128, 128, 1))
                                if g != rule]
                for tiling in tilings:
                    def call(wi, tiling=tiling):
                        out = torch.empty((R, N), dtype=torch.bfloat16,
                                          device=dev)
                        return qm.rows_matmul(x, wi.data_ptr(),
                                              scale.data_ptr(), out, fmt,
                                              tiling)
                    check_close(f"rows {name} {fmt} R={R} {tiling}",
                                call(w), want, 2e-2)
                    runs.append(("rows" if tiling == rule else "grid",
                                 tiling, call))
                for what, tiling, call in runs:
                    t = time_pass(lambda: [call(wi) for wi in ws], len(ws),
                                  dev, args.reps)
                    emit(what, t, grid=tiling)
                if R in grid_rows or R == INSTALL_ROWS or R == 40:
                    t = time_pass(lambda: [torch.matmul(x, wi) for wi in wds],
                                  len(wds), dev, args.reps)
                    emit("lib", t)
                if R == INSTALL_ROWS:
                    p_ = {key: w, "scale": scale}
                    t = time_pass(lambda: torch.matmul(
                        x, dequantize_kernel(p_, torch.bfloat16)), 1, dev,
                        args.reps)
                    emit("dequantize+lib", t)
                best = {}
                for ln in lines:
                    if (ln["shape"], ln["R"], ln["fmt"]) == (name, R, fmt):
                        best[ln["what"] if ln["what"] not in
                             ("grid", "fgrid") else
                             f"{ln['what']} {tuple(ln['grid'])}"] = ln["ms"]
                top = sorted(best.items(), key=lambda kv: kv[1])[:4]
                print(f"{name} {fmt} R={R}: rule {rule}; bound "
                      f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}); "
                      + ", ".join(f"{k} {v:.4f}" for k, v in top)
                      + "; " + ", ".join(f"{k} {v:.4f}" for k, v in
                                         best.items() if k in
                                         ("few", "rows", "lib",
                                          "dequantize+lib")), flush=True)
                del x, want
            del w, ws, wd, wds, scale
            torch.cuda.empty_cache()
    for name in SHAPES:
        for fmt in FORMATS:
            won = [ln["R"] for ln in lines if ln["shape"] == name
                   and ln["fmt"] == fmt and ln["what"] == "rows"
                   and ln["R"] in CROSS_ROWS
                   and ln["ms"] < next(o["ms"] for o in lines
                                       if o["shape"] == name
                                       and o["fmt"] == fmt
                                       and o["R"] == ln["R"]
                                       and o["what"] == "few")]
            print(f"crossover {name} {fmt}: the many-row body is faster at "
                  f"R {won} of {list(CROSS_ROWS)}", flush=True)
    with open(args.out, "w") as f:
        for ln in lines:
            f.write(json.dumps(ln) + "\n")
    return lines


if __name__ == "__main__":
    main()
