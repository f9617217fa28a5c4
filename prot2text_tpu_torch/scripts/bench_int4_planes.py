"""int4 nibble-plane probe (the port of scripts/bench_int4_planes.py): the
plane format (int32 words, nibble j of word [k8, n] holding row k8 + j·K/8)
against the split-half bytes, and the plane kernel's tile.  At R 16 decode
rows, a chain of L 4 Llama-3.1-8B MLP layers (up (4096, 14336), down
(14336, 4096)) times:

  A  K11a, the port's shipped split-half int4 kernel;
     K10, the port's shipped plane kernel;
  E  K15d, K10's body over the TPU probe's (bk8, bn) sweep, read here as a
     K slice of bk8 word rows (8·bk8 k values) per block and bn / 8 output
     columns per block (128 or 256: a TPU block of 1024 columns is one
     pass of its 128-wide matrix unit per 8 sublanes; a Hopper block is 4
     or 8 warps of 32 columns), and at K10's own tiling, where it is K10
     bit for bit;
  torch.matmul on the bf16 dequantized weights (the library yardstick).

First, as the TPU probe does, the plane kernel against the shipped
split-half kernel on one projection (max|diff| < 0.1).  L2: a pass reads
every layer's weights once (int4 235 MB, bf16 940 MB).

    python -m prot2text_tpu_torch.scripts.bench_int4_planes [--device
        cuda|cpu] [--reps N]
"""

from __future__ import annotations

import torch

from ..kernels.probe_quant_matmul import mm_i4p, mm_i4p_plain
from ..kernels.quant_matmul import (
    _few_rows, pack_int4, pack_int4_planes, quant_matmul_int4,
    quant_matmul_int4_plain,
    quant_matmul_int4_planes, quant_matmul_int4_planes_plain,
)
from ._timing import (
    chain_bytes, check_close, layer_chain, parser, row, setup, show,
    time_pass,
)

# decode rows, Llama-3.1-8B's hidden and MLP widths, stacked layers
R, H, M, L = 16, 4096, 14336, 4
# the TPU probe's (bk8, bn) sweep
TILES = ((128, 1024), (256, 1024), (64, 1024), (128, 2048), (256, 2048),
         (512, 1024))


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    dev, card = setup(args)
    print(f"bench_int4_planes on {card}: R={R} H={H} M={M} L={L}",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    up = torch.randint(-8, 8, (L, H, M), generator=gen, device=dev,
                       dtype=torch.int8)
    dn = torch.randint(-8, 8, (L, M, H), generator=gen, device=dev,
                       dtype=torch.int8)
    su = torch.full((L, 1, M), 0.01, device=dev)
    sd = torch.full((L, 1, H), 0.01, device=dev)
    x = torch.randn((R, H), generator=gen, device=dev).to(torch.bfloat16)
    pu, pd = pack_int4_planes(up), pack_int4_planes(dn)
    bu, bd = pack_int4(up), pack_int4(dn)

    ref = quant_matmul_int4(x, bu[0], su[0])
    got = mm_i4p(x, pu[0], su[0])
    diff = (got.float() - ref.float()).abs().max().item()
    print(f"plane kernel max err vs shipped kernel: {diff}", flush=True)
    if not diff < 0.1:
        raise RuntimeError(f"K15d against K11a: max|diff| {diff} >= 0.1")
    if dev.type == "cuda" and not torch.equal(
            got, _few_rows(x, pu[0], su[0], "planes")):
        raise RuntimeError("K15d at K10's tiling is not K10's few-row body "
                           "bit for bit")

    flops = 2.0 * R * H * M
    nbytes = chain_bytes(R, H, M, L, L * 2 * H * M // 2)
    variants = [("A i32-shift bytes (shipped)", "K11a", quant_matmul_int4,
                 quant_matmul_int4_plain, bu, bd, {}),
                ("K10 planes (shipped)", "K10", quant_matmul_int4_planes,
                 quant_matmul_int4_planes_plain, pu, pd, {}),
                ("E i32-planes K10 tiling", "K15d", mm_i4p, mm_i4p_plain,
                 pu, pd, {})]
    variants += [(f"E i32-planes {bk8:4d}x{bn:4d}", "K15d", mm_i4p,
                  mm_i4p_plain, pu, pd,
                  {"block_cols": bn // 8, "split_k8": bk8})
                 for bk8, bn in TILES]
    rows = []
    for label, kid, fn, plain, wu, wd, kw in variants:
        err = check_close(label, fn(x, wu[0], su[0], **kw),
                          plain(x, wu[0], su[0]), 2e-2)
        t = time_pass(layer_chain(fn, x, wu, su, wd, sd, **kw), 2 * L, dev,
                      args.reps)
        rows.append(row(label, kid, t, flops, nbytes, err=err))
        show(rows[-1])
    del pu, pd, bu, bd
    fu = (up.float() * su).to(torch.bfloat16)
    fd = (dn.float() * sd).to(torch.bfloat16)
    del up, dn

    def run():
        h = x
        for layer in range(L):
            h = torch.matmul(torch.matmul(h, fu[layer]), fd[layer])
        return h

    t = time_pass(run, 2 * L, dev, args.reps)
    rows.append(row("torch.matmul bf16 dequantized", "library", t, flops,
                    chain_bytes(R, H, M, L, L * 2 * H * M * 2)))
    show(rows[-1])
    return dict(device=card, rows=rows)


if __name__ == "__main__":
    main()
