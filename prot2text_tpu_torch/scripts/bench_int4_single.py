"""Single-call int4 probe at the Qwen3-14B MLP shape (the port of
scripts/bench_int4_single.py): the kernel's sustained rate on one (K 5120,
N 17408) projection, 44.6 MB of split-half int4 bytes, at R 16 decode rows,
one call per stacked layer (8 layers of fresh weights, so every call reads
HBM: 357 MB of int4, 713 MB of int8, 1.43 GB of bf16 per pass):

  A  K11a, the port's shipped split-half int4 kernel;
  B  K15e, the AND unpack (the TPU probe's `mm_i4and`): lo_u = w & 0xF, hi
     = (w - lo_u) / 16 in bf16 arithmetic;
  C  K14 on int8 weights of the same shape, twice the bytes (the bandwidth
     reference);
  torch.matmul on the bf16 dequantized weights (the library yardstick).

The TPU probe also swept K15e's (bk, bn) tile; its tile has no counterpart
here.

    python -m prot2text_tpu_torch.scripts.bench_int4_single [--device
        cuda|cpu] [--reps N]
"""

from __future__ import annotations

import torch

from ..kernels.probe_quant_matmul import mm_i4and, mm_i4and_plain
from ..kernels.quant_matmul import (
    quant_matmul_int4, quant_matmul_int4_plain, quant_matmul_int8,
    quant_matmul_int8_plain, unpack_int4,
)
from ._timing import check_close, parser, randint8, row, setup, show, time_pass

# decode rows, Qwen3-14B's MLP projection (K, N), stacked layers
R, K, N, S = 16, 5120, 17408, 8


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    dev, card = setup(args)
    print(f"bench_int4_single on {card}: R={R} K={K} N={N} layers={S}",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    wp = randint8((S, K // 2, N), gen, dev)
    sc = torch.full((S, 1, N), 0.01, device=dev)
    x = torch.randn((R, K), generator=gen, device=dev).to(torch.bfloat16)
    flops = 2.0 * R * K * N
    io = 4 * N + 2 * R * K + 2 * R * N
    rows = []

    def measure(label, kid, fn, plain, w, wbytes):
        err = check_close(label, fn(x, w[0], sc[0]), plain(x, w[0], sc[0]),
                          2e-2)
        t = time_pass(lambda: [fn(x, w[i], sc[i]) for i in range(S)], S,
                      dev, args.reps)
        rows.append(row(label, kid, t, flops, wbytes + io, err=err))
        show(rows[-1])

    measure("A i32-shift (shipped)", "K11a", quant_matmul_int4,
            quant_matmul_int4_plain, wp, K * N // 2)
    measure("B and-unpack", "K15e", mm_i4and, mm_i4and_plain, wp, K * N // 2)
    wd = torch.stack([(unpack_int4(wp[i]).float() * sc[i]).to(
        torch.bfloat16) for i in range(S)])
    del wp
    w8 = randint8((S, K, N), gen, dev)
    measure("C int8 2x-bytes ref", "K14", quant_matmul_int8,
            quant_matmul_int8_plain, w8, K * N)
    del w8
    t = time_pass(lambda: [torch.matmul(x, wd[i]) for i in range(S)], S, dev,
                  args.reps)
    rows.append(row("torch.matmul bf16 dequantized", "library", t, flops,
                    2 * K * N + 2 * R * K + 2 * R * N))
    show(rows[-1])
    return dict(device=card, rows=rows)


if __name__ == "__main__":
    main()
