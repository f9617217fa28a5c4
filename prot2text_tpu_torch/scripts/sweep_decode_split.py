"""The cluster-split decode body (csrc/decode_attention_split.cuh) at
Qwen3-14B's int8 serving shape: where its time goes and how many of its
clusters the card holds.

bf16 K9b (G 1) and K9c run the body's int8 policy (Int8Cache) over the
shared prefix's columns and the pool's (PrefixCols), bf16 K7 (G 1) and K8
the same policy over the pool's alone (CacheCols), K9a its bf16 policy,
on B 8 rows, Hkv 8, D 128, a pool of T 1856 columns (535 valid a row at
left pads 0-250), a 256-column shared prefix (250 live; row 6 gated off),
two inactive rows on one scratch slot: `check_int8_kernels`' and
`check_serve_kernels`' operands in chip_smoke.py.  It times, device ms per
call from CUDA graphs that rotate through the layers of a pool whose slabs
exceed twice the L2 (so every call reads its slab from HBM):

  rows   K9b and K9c, then K7 and K8, at each (G, rep) of ROWS: the query
         rows G·rep set the body's n8 fragments (1, 2 or 4), G the
         chunk's own columns;
  live   K9b, K9c (G 5) and K9a with every column live, with the prefix
         only (kv_mask 0), with nothing live (both masks 0), and K7 and
         K8 with every column live and with none: the fixed cost of a
         launch beside the tiles' cost;

and reports each instantiation's resident clusters
(`decode_attention.split_resident_clusters`) against the 64 a launch at B
8, Hkv 8 asks for.  Every output is held against its plain version
(2e-2 · max|plain|).

    python -m prot2text_tpu_torch.scripts.sweep_decode_split [--device cuda]
        [--reps N]
"""

from __future__ import annotations

import torch

from ..kernels import decode_attention as da
from ..models.quant import quantize_kv
from ._timing import check_close, parser, setup, time_pass

B, HKV, D, T, PC, PS, REP = 8, 8, 128, 1856, 256, 250, 5
PADS = (0, 37, 100, 250, 5, 0, 60, 200)
VALID = 535
LAYERS = 4                         # int8 slabs of 30 MB a layer: > 2 x L2
ROWS = ((1, 5), (1, 8), (1, 16), (1, 25), (1, 32), (2, 5), (3, 5), (4, 5),
        (5, 5), (6, 5))


def operands(dev, gen):
    """The int8 pool and prefix, the bf16 pool and prefix, and the masks:
    all live, prefix only, nothing live."""
    def ints(*s):
        return torch.randint(-127, 128, s, generator=gen, device=dev,
                             dtype=torch.int8)

    def scales(*s):
        return torch.rand(s, generator=gen, device=dev) * 0.028 + 0.002

    def bf16(*s):
        return torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)

    q8 = [ints(LAYERS, B, HKV, T, D), ints(LAYERS, B, HKV, T, D),
          scales(LAYERS, B, HKV, T), scales(LAYERS, B, HKV, T)]
    p8 = [ints(LAYERS, 1, HKV, PC, D), ints(LAYERS, 1, HKV, PC, D),
          scales(LAYERS, 1, HKV, PC), scales(LAYERS, 1, HKV, PC)]
    b16 = [bf16(2, B, HKV, T, D), bf16(2, B, HKV, T, D)]
    p16 = [bf16(2, 1, HKV, PC, D), bf16(2, 1, HKV, PC, D)]
    pads = torch.tensor(PADS, device=dev)
    cols = torch.arange(T, device=dev)
    mask = ((cols >= pads[:, None]) & (cols < pads[:, None] + VALID)).to(
        torch.int32)
    pmask = (torch.arange(PC, device=dev) >= PC - PS).to(torch.int32).expand(
        B, PC).clone()
    pmask[6] = 0
    masks = {"all live": (mask, pmask),
             "prefix only": (torch.zeros_like(mask), pmask),
             "nothing live": (torch.zeros_like(mask), torch.zeros_like(pmask))}
    return q8, p8, b16, p16, masks, (pads + VALID).to(torch.int32)


def name(G: int, prefix: bool) -> str:
    """K9b/K9c with the shared prefix, K7/K8 without; G 1 the decode."""
    return ("K9b" if G == 1 else "K9c") if prefix else (
        "K7" if G == 1 else "K8")


def main(argv=None) -> list:
    p = parser(__doc__, reps=20)
    args = p.parse_args(argv)
    dev, card = setup(args)
    if dev.type != "cuda":
        raise SystemExit("sweep_decode_split times the card's kernels: "
                         "--device cuda")
    print(f"sweep_decode_split on {card}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(15)
    q8, p8, b16, p16, masks, ends = operands(dev, gen)
    lines = []

    def int8_call(G, rep, mask, pmask, prefix=True):
        """K9b/K9c (prefix) or K7/K8 at (G, rep): checked, then a pass over
        the layers to time."""
        qg = (torch.randn(B, HKV, G * rep, D, generator=gen, device=dev)
              * D ** -0.5).to(torch.bfloat16)
        kq, ks = quantize_kv(torch.randn(B, HKV, G, D, generator=gen,
                                         device=dev))
        vq, vs = quantize_kv(torch.randn(B, HKV, G, D, generator=gen,
                                         device=dev))
        slots = ends.clone()
        slots[6:] = T - 1 if G == 1 else T - 64
        if G == 1:
            args_ = [x[:, :, 0].contiguous() for x in (kq, vq, ks, vs)]
            kern, plain = (
                (da.decode_attention_stacked_write_q_prefix,
                 da.decode_attention_stacked_write_q_prefix_plain) if prefix
                else (da.decode_attention_stacked_write_q,
                      da.decode_attention_stacked_write_q_plain))
            kw = {}
        else:
            args_ = [kq, vq, ks, vs]
            kern, plain = (
                (da.decode_attention_stacked_verify_qc_prefix,
                 da.decode_attention_stacked_verify_qc_prefix_plain)
                if prefix else (da.decode_attention_stacked_verify_qc,
                                da.decode_attention_stacked_verify_qc_plain))
            kw = {"slots_max": T - 64}
        pargs = (*p8, pmask) if prefix else ()
        want = plain(qg.float(), *[t.clone() for t in q8], mask, *args_, 0,
                     slots, *pargs)
        check_close(f"{name(G, prefix)} G={G} rep={rep}",
                    kern(qg, *[t.clone() for t in q8], mask, *args_, 0,
                         slots, *pargs, **kw), want, 2e-2)
        return lambda: [kern(qg, *q8, mask, *args_, li, slots, *pargs,
                             **kw) for li in range(LAYERS)]

    def emit(what, t, **extra):
        line = dict(what=what, ms=t["ms"], host_ms=t["host_ms"], card=card,
                    **extra)
        lines.append(line)
        print(f"{what:<40} device {t['ms']:.4f} ms/call  eager "
              f"{t['host_ms']:.4f} ms/call", flush=True)

    mask, pmask = masks["all live"]
    for prefix in (True, False):
        for G, rep in ROWS:
            run = int8_call(G, rep, mask, pmask, prefix)
            emit(f"{name(G, prefix)} G {G} rep {rep} ({G * rep} rows)",
                 time_pass(run, LAYERS, dev, args.reps), G=G, rep=rep,
                 prefix=prefix)
    for label, (m, pm) in masks.items():
        for G in (1, 5):
            run = int8_call(G, REP, m, pm)
            emit(f"{name(G, True)} {label}",
                 time_pass(run, LAYERS, dev, args.reps), G=G, live=label)
            if label != "prefix only":
                run = int8_call(G, REP, m, pm, prefix=False)
                emit(f"{name(G, False)} {label}",
                     time_pass(run, LAYERS, dev, args.reps), G=G,
                     live=label, prefix=False)
        qg = (torch.randn(B, HKV, REP, D, generator=gen, device=dev)
              * D ** -0.5).to(torch.bfloat16)
        kn, vn = (torch.randn(B, HKV, D, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        slots = ends.clone()
        slots[6:] = T - 1
        emit(f"K9a bf16 {label}", time_pass(
            lambda: [da.decode_attention_stacked_write_prefix(
                qg, *b16, m, kn, vn, li, slots, *p16, pm)
                for li in range(2)], 2, dev, args.reps), live=label)
    for what, n in (
            [(f"K9b/K9c, {rows} rows", da.split_resident_clusters(
                True, rows, D)) for rows in (5, 16, 25)]
            + [(f"K7/K8, {rows} rows", da.split_resident_clusters(
                True, rows, D, prefix=False)) for rows in (5, 16, 25)]
            + [("K9a", da.split_resident_clusters(False, REP, D)),
               ("K4", da.split_resident_clusters(False, REP, D,
                                                 prefix=False))]):
        lines.append(dict(what=f"resident clusters {what}", clusters=n,
                          card=card))
        print(f"resident clusters of {what}: {n} (a launch at B {B}, Hkv "
              f"{HKV} asks for {B * HKV})", flush=True)
    return lines


if __name__ == "__main__":
    main()
