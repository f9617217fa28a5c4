"""int4 unpack probe (the port of scripts/bench_int4_unpack.py): which way
of turning packed int4 into bf16 inside the matmul keeps up with the
weight stream?  At R 16 decode rows, a chain of L 4 Llama-3.1-8B MLP
layers (up (4096, 14336), down (14336, 4096), each fed the previous
output) times:

  A  K11a, the port's shipped split-half int4 kernel (bit tricks);
  B  K15b, split-half bytes unpacked in f32 arithmetic (floor; the TPU
     probe's `mm_i4f`);
  C  K15c, a native int4 weight (the port's `pack_int4_native`; the TPU
     probe's `mm_i4n` on `jnp.int4`);
  D  K14 on the same values as int8, twice the bytes (the bandwidth
     reference);
  torch.matmul on the bf16 dequantized weights (the library yardstick).

The TPU probe also swept K15b's (bk, bn) tile; its tile has no counterpart
here (bench_int4_planes sweeps the tile of the plane format).  L2: a pass
reads every layer's weights once (int4 235 MB, int8 470 MB, bf16 940 MB).

    python -m prot2text_tpu_torch.scripts.bench_int4_unpack [--device
        cuda|cpu] [--reps N]
"""

from __future__ import annotations

import torch

from ..kernels.probe_quant_matmul import (
    mm_i4f, mm_i4n, mm_i4n_plain, pack_int4_native,
)
from ..kernels.quant_matmul import (
    pack_int4, quant_matmul_int4, quant_matmul_int4_plain, quant_matmul_int8,
    quant_matmul_int8_plain,
)
from ._timing import (
    chain_bytes, check_close, layer_chain, parser, row, setup, show,
    time_pass,
)

# decode rows, Llama-3.1-8B's hidden and MLP widths, stacked layers
R, H, M, L = 16, 4096, 14336, 4


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    dev, card = setup(args)
    print(f"bench_int4_unpack on {card}: R={R} H={H} M={M} L={L}",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    up = torch.randint(-8, 8, (L, H, M), generator=gen, device=dev,
                       dtype=torch.int8)
    dn = torch.randint(-8, 8, (L, M, H), generator=gen, device=dev,
                       dtype=torch.int8)
    su = torch.full((L, 1, M), 0.01, device=dev)
    sd = torch.full((L, 1, H), 0.01, device=dev)
    x = torch.randn((R, H), generator=gen, device=dev).to(torch.bfloat16)
    flops = 2.0 * R * H * M
    int4_bytes = L * 2 * H * M // 2
    formats = [
        ("A i32-shift (shipped)", "K11a", quant_matmul_int4,
         quant_matmul_int4_plain, pack_int4, int4_bytes),
        ("B f32-floor", "K15b", mm_i4f, quant_matmul_int4_plain, pack_int4,
         int4_bytes),
        ("C native-int4", "K15c", mm_i4n, mm_i4n_plain, pack_int4_native,
         int4_bytes),
        ("D int8 2x-bytes ref", "K14", quant_matmul_int8,
         quant_matmul_int8_plain, lambda q: q, 2 * int4_bytes),
    ]
    rows = []
    for label, kid, fn, plain, pack, wbytes in formats:
        wu, wd = pack(up), pack(dn)
        err = check_close(label, fn(x, wu[0], su[0]),
                          plain(x, wu[0], su[0]), 2e-2)
        t = time_pass(layer_chain(fn, x, wu, su, wd, sd), 2 * L, dev,
                      args.reps)
        rows.append(row(label, kid, t, flops,
                        chain_bytes(R, H, M, L, wbytes), err=err))
        show(rows[-1])
        del wu, wd
    # the yardstick: the weights dequantized to bf16 before the timed pass
    bu = (up.float() * su).to(torch.bfloat16)
    bd = (dn.float() * sd).to(torch.bfloat16)
    del up, dn

    def run():
        h = x
        for layer in range(L):
            h = torch.matmul(torch.matmul(h, bu[layer]), bd[layer])
        return h

    t = time_pass(run, 2 * L, dev, args.reps)
    rows.append(row("torch.matmul bf16 dequantized", "library", t, flops,
                    chain_bytes(R, H, M, L, 4 * int4_bytes)))
    show(rows[-1])
    return dict(device=card, rows=rows)


if __name__ == "__main__":
    main()
