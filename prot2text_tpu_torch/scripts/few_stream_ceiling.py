"""What stops the few-row TMA body (csrc/quant_matmul.cuh) short of its
bound: the body against its own weight stream with the products taken
out, on Qwen3-14B's projections at a decode step's 8 rows.

The stream-only body is the same source compiled with
`P2T_FEW_STREAM_ONLY` (the consumers wait for each stage, read their words
and release it, with no conversion and no product), built here by nvcc
into `kernels/_build/stream_only/`.  Both run on `few_rows_tiling`'s grid;
device time per call from CUDA graphs over weight copies past the L2
(`_timing.time_pass`), beside the bound (the weight, its scales, x and y
at 3.35 TB/s).  Card only:

    python -m prot2text_tpu_torch.scripts.few_stream_ceiling [--reps N]
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from ..kernels import _build
from ..kernels import quant_matmul as qm
from ._timing import bound, copies, parser, setup, time_pass

SHAPES = {"q/o": (5120, 5120), "k/v": (5120, 1024),
          "gate/up": (5120, 17408), "down": (17408, 5120),
          "head": (5120, 151936)}
FORMATS = {"planes": qm.pack_int4_planes, "int8": lambda q: q}
SOURCES = ("quant_matmul.cu", "quant_matmul_int4.cu")


def stream_only_entry():
    """p2t_quant_matmul_few of the body compiled with P2T_FEW_STREAM_ONLY."""
    out = _build.BUILD_DIR / "stream_only"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    objs = [out / f"{src}.o" for src in SOURCES]
    jobs = [subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-DP2T_FEW_STREAM_ONLY",
         f"-I{_build.CSRC}", "-c", "-o", str(obj), str(_build.CSRC / src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(SOURCES, objs)]
    for job in jobs:
        log, _ = job.communicate()
        if job.returncode:
            raise RuntimeError(f"nvcc failed:\n{log}")
    so = out / "libstream_only.so"
    subprocess.run([nvcc, "-shared", "-o", str(so), *map(str, objs)],
                   check=True)
    fn = ctypes.CDLL(str(so)).p2t_quant_matmul_few
    fn.argtypes = _build.SIGNATURES["p2t_quant_matmul_few"]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> list:
    args = parser(__doc__, reps=10).parse_args(argv)
    dev, card = setup(args)
    if dev.type != "cuda":
        raise SystemExit("few_stream_ceiling times the card's kernels: "
                         "--device cuda")
    stream_only = stream_only_entry()
    gen = torch.Generator(device=dev).manual_seed(23)
    R, rows = 8, []
    print(f"few_stream_ceiling on {card}", flush=True)
    for name, (K, N) in SHAPES.items():
        for fmt, pack in FORMATS.items():
            w = pack(torch.randint(-8, 8, (K, N), generator=gen, device=dev,
                                   dtype=torch.int8))
            scale = torch.rand((1, N), generator=gen, device=dev) + 0.1
            x = torch.randn((R, K), generator=gen, device=dev).bfloat16()
            out = torch.empty((R, N), dtype=torch.bfloat16, device=dev)
            ws = [w] + [w.clone() for _ in range(
                copies(w.numel() * w.element_size(), dev) - 1)]
            tiling = qm.few_rows_tiling(R, K, N, qm._FORMATS[fmt][2])

            def body(wi):
                qm.few_matmul(x, wi.data_ptr(), scale.data_ptr(), out, fmt,
                              tiling)

            def stream(wi):
                _build.check(stream_only(
                    x.data_ptr(), wi.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), R, K, N, qm._FORMATS[fmt][6], tiling[1],
                    tiling[2], _build.dtype_code(x.dtype),
                    _build.stream_of(x)), "stream-only body")

            t = {k: time_pass(lambda: [f(wi) for wi in ws], len(ws), dev,
                              args.reps)["ms"]
                 for k, f in (("body", body), ("stream", stream))}
            bd = bound(2.0 * R * K * N, w.numel() * w.element_size()
                       + 4 * N + 2 * R * K + 2 * R * N)
            row = dict(shape=name, fmt=fmt, K=K, N=N, R=R, tiling=tiling,
                       body_ms=t["body"], stream_ms=t["stream"],
                       bound_ms=bd["bound_ms"], card=card)
            rows.append(row)
            print(f"{name} {fmt} R={R} {tiling}: body {t['body']:.4f} ms "
                  f"({bd['bound_ms'] / t['body']:.1%} of the bound), stream "
                  f"alone {t['stream']:.4f} ms "
                  f"({bd['bound_ms'] / t['stream']:.1%})", flush=True)
            del ws, w
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
