"""LM-head probe (the port of scripts/bench_lmhead3.py): is the int8 head's
rate a cap of every int8 weight matmul, or of the vocab shape?  At R 16
decode rows it times, at Llama-3.1-8B's q/o (4096, 4096), gate/up (4096,
14336) and down (14336, 4096) and at the vocab shape (4096, 128256):

  K14   the port's shipped int8 matmul;
  K15a  the chunked-convert variant (the TPU probe's `chunk_mm`): the int8
        weight converted to bf16 `bc` k rows at a time, bc 32 .. 256 (128
        is K14's own chunk);
  torch.matmul on the weight dequantized to bf16 (the library yardstick).

L2: each shape's pass rotates through int8 weight copies that together
exceed twice the card's L2 (q/o: 7 copies of 16.8 MB; gate/up and down:
2; vocab: 1), and the bf16 yardstick through its own copies.

    python -m prot2text_tpu_torch.scripts.bench_lmhead3 [--device cuda|cpu]
        [--reps N]
"""

from __future__ import annotations

import torch

from ..kernels.probe_quant_matmul import CHUNK_ROWS, chunk_mm, chunk_mm_plain
from ..kernels.quant_matmul import quant_matmul_int8
from ._timing import (
    check_close, copies, parser, randint8, row, setup, show, time_pass,
)

R = 16                                 # decode rows
SHAPES = ((4096, 4096), (4096, 14336), (14336, 4096), (4096, 128256))
TAGS = {(4096, 4096): "q/o", (4096, 14336): "gateup",
        (14336, 4096): "down", (4096, 128256): "vocab"}


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    dev, card = setup(args)
    print(f"bench_lmhead3 on {card}, R={R}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for K, N in SHAPES:
        tag = TAGS.get((K, N), f"{K}x{N}")
        ws = [randint8((K, N), gen, dev) for _ in range(copies(K * N, dev))]
        scale = torch.full((1, N), 0.01, device=dev)
        x = torch.randn((R, K), generator=gen, device=dev).to(torch.bfloat16)
        want = chunk_mm_plain(x, ws[0], scale)
        flops = 2.0 * R * K * N
        io = 4 * N + 2 * R * K + 2 * R * N     # scale, x, y
        variants = [("K14 shipped", "K14", quant_matmul_int8, {})]
        variants += [(f"chunk bc={bc}", "K15a", chunk_mm, {"bc": bc})
                     for bc in CHUNK_ROWS]
        for label, kid, fn, kw in variants:
            err = check_close(f"{tag} {label}", fn(x, ws[0], scale, **kw),
                              want, 2e-2)
            t = time_pass(lambda: [fn(x, w, scale, **kw) for w in ws],
                          len(ws), dev, args.reps)
            rows.append(row(f"{tag} K={K} N={N} {label}", kid, t, flops,
                            K * N + io, err=err))
            show(rows[-1])
        del ws
        wd = [(randint8((K, N), gen, dev).float() * scale).to(torch.bfloat16)
              for _ in range(copies(2 * K * N, dev))]
        t = time_pass(lambda: [torch.matmul(x, w) for w in wd], len(wd),
                      dev, args.reps)
        rows.append(row(f"{tag} K={K} N={N} torch.matmul bf16", "library",
                        t, flops, 2 * K * N + 2 * R * K + 2 * R * N))
        show(rows[-1])
        del wd
    return dict(device=card, rows=rows)


if __name__ == "__main__":
    main()
