"""int8 tensor-core probe (the port of scripts/bench_int8_mxu.py): does an
int8 x int8 product run at the card's int8 rate (1979 TOP/s dense, twice
bf16's)?  At R 128 decode rows over L 8 stacked Llama-3.1-8B gate/up
weights (4096, 14336) int8 (470 MB a pass), it times:

  A  torch.matmul, bf16 x against the weight converted to bf16 (the
     library's answer to the TPU probe's XLA bf16 x int8 dot: PyTorch has
     no mixed-dtype product);
  B  torch._int_mm, int8 x int8 -> int32 (the library's int8 product);
  C  K15f, the port's int8 x int8 -> int32 kernel on the int8 tensor cores
     (the many-row body's s8 wgmma policy), exact (the TPU probe's
     `mm_i8i8`);
  D  K15g, bf16 x int8 -> f32 on the bf16 tensor cores, no scale (the TPU
     probe's `mm_mix`);
     K14, the port's shipped int8 weight matmul (bf16 out, unit scale).

At R 128 each call is bound by its bytes, not by the int8 rate: 58.7 MB of
weight and 7.3 MB of int32 output take 19.9 us at 3.35 TB/s, the 15.0 G
operations 7.6 us at the int8 rate.  The int8 rate sets the pace only from
about R 300 (2R operations per weight byte against the card's 590).  So
each row prints both bounds, and TOP/s against them.

    python -m prot2text_tpu_torch.scripts.bench_int8_mxu [--device
        cuda|cpu] [--reps N]
"""

from __future__ import annotations

import torch

from ..kernels.probe_quant_matmul import (
    mm_i8i8, mm_i8i8_plain, mm_mix, mm_mix_plain,
)
from ..kernels.quant_matmul import quant_matmul_int8, quant_matmul_int8_plain
from ._timing import (
    PEAK_INT8, check_close, parser, randint8, row, setup, show, time_pass,
)

# rows, Llama-3.1-8B's gate/up projection (K, N), stacked layers
R, K, N, L = 128, 4096, 14336, 8


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    dev, card = setup(args)
    print(f"bench_int8_mxu on {card}: R={R} K={K} N={N} L={L}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    w8 = randint8((L, K, N), gen, dev)
    xb = torch.randn((R, K), generator=gen, device=dev).to(torch.bfloat16)
    x8 = randint8((R, K), gen, dev)
    ones = torch.ones((1, N), device=dev)
    flops = 2.0 * R * K * N
    rows = []

    def measure(label, kid, call, out_bytes, x_bytes, w_bytes=K * N,
                peak=None, **extra):
        t = time_pass(lambda: [call(i) for i in range(L)], L, dev, args.reps)
        kw = {} if peak is None else {"peak": peak}
        rows.append(row(label, kid, t, flops, w_bytes + x_bytes + out_bytes,
                        **kw, **extra))
        show(rows[-1], rate="top_s")

    got = mm_i8i8(x8, w8[0])
    if not torch.equal(got, mm_i8i8_plain(x8, w8[0])):
        raise RuntimeError("K15f: the int8 x int8 product is not exact")
    measure("C int8 x int8 -> int32", "K15f", lambda i: mm_i8i8(x8, w8[i]),
            4 * R * N, R * K, peak=PEAK_INT8, err=0.0)
    err = check_close("K15g", mm_mix(xb, w8[0]), mm_mix_plain(xb, w8[0]),
                      1e-5)
    measure("D bf16 x int8 -> f32", "K15g", lambda i: mm_mix(xb, w8[i]),
            4 * R * N, 2 * R * K, err=err)
    err = check_close("K14", quant_matmul_int8(xb, w8[0], ones),
                      quant_matmul_int8_plain(xb, w8[0], ones), 2e-2)
    measure("K14 int8 weights (shipped)", "K14",
            lambda i: quant_matmul_int8(xb, w8[i], ones), 2 * R * N,
            2 * R * K + 4 * N, err=err)
    measure("B torch._int_mm int8 x int8", "library",
            lambda i: torch._int_mm(x8, w8[i]), 4 * R * N, R * K,
            peak=PEAK_INT8)
    wb = w8.to(torch.bfloat16)
    del w8
    measure("A torch.matmul bf16 x bf16(w)", "library",
            lambda i: torch.matmul(xb, wb[i]), 2 * R * N, 2 * R * K,
            w_bytes=2 * K * N)
    return dict(device=card, rows=rows)


if __name__ == "__main__":
    main()
