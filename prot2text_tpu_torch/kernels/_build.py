"""Build and load the port's CUDA kernels (one shared library, plain C ABI).

Every `csrc/*.cu` is compiled by nvcc for Hopper (`sm_90a`) — one nvcc
process per source, all started together, so the build takes the longest
file's time rather than the sum — and linked into ONE shared library,
`_build/libp2t_kernels_<hash>.so`, where the hash covers the sources, the
headers and the flags.  The build runs at first use, under an exclusive
file lock (concurrent processes wait for one build instead of racing), so a
fresh checkout needs nothing but `nvcc`: no PyTorch headers are compiled
(seconds, not minutes).  The library is loaded with ctypes;
every pointer and the CUDA stream are passed as `c_void_p`, and every entry
point returns `cudaGetLastError()` after its launch, which `check()` turns
into an exception.

Nothing here runs at import time: the CPU tests import every module of the
package, and this sandbox-independent code must not look for nvcc until a
kernel is launched on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",            # registers / shared memory / spills → log
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# C entry points → argtypes; each returns an int cudaError_t
SIGNATURES = {
    # q, k, v, kv_start, kv_len, o, lse, strides[12], B, H, Hkv, Sq, Skv, D,
    # causal, dtype, stream
    "p2t_flash_masked_fwd": [_P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, do, lse, delta, kv_start, kv_len, dq, dk, dv, strides[21],
    # B, H, Hkv, Sq, Skv, D, causal, dtype, stream
    "p2t_flash_masked_bwd": [_P] * 12 + [_I] * 8 + [_P],
    # qg, ck(layer), cv(layer), kv_mask, k_new, v_new, out, B, Hkv, rep, T,
    # D, dtype, stream
    "p2t_decode_attention": [_P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _P],
    # cache, src, n_rows, T, index, row_bytes, stream
    "p2t_cache_slot_write": [_P, _P, _L, _L, _L, _I, _P],
    # cache0, src0, cache1, src1, n_caches, L, T, index, run_bytes, stream
    "p2t_cache_slab_write": [_P, _P, _P, _P, _I, _L, _L, _L, _L, _P],
    # qg, ck(layer), cv(layer), kv_mask, k_new, v_new, slots, pk(layer),
    # pv(layer), pmask, out, B, Hkv, rep, T, Pc, D, the cache's slab and
    # column strides, the prefix's head and column strides, dtype, stream
    "p2t_decode_attention_write": [_P] * 11 + [_I] * 6 + [_L] * 4 + [_I, _P],
    # q, k, v, bias, o, lse, strides[15], B, H, Hkv, Sq, Skv, D, dtype,
    # stream
    "p2t_flash_bias_fwd": [_P] * 7 + [_I] * 7 + [_P],
    # q, k, v, bias, do, lse, delta, dq, dk, dv, strides[24], B, H, Hkv,
    # Sq, Skv, D, dtype, stream, stream_kv
    "p2t_flash_bias_bwd": [_P] * 11 + [_I] * 7 + [_P, _P],
    # do, o, delta, strides[6], B, H, S, D, stream
    "p2t_flash_bwd_delta": [_P] * 4 + [_I] * 4 + [_P],
    # qg, ck, cv, sk, sv (layer), kv_mask, kq, vq, ks, vs, slots, pk, pv,
    # psk, psv (layer), pmask, out, B, Hkv, rep, T, Pc, D, dtype, stream
    "p2t_decode_attention_write_q": [_P] * 17 + [_I] * 7 + [_P],
    # the same pointers, then B, Hkv, rep, G, T, Pc, D, dtype, stream
    "p2t_decode_attention_verify": [_P] * 17 + [_I] * 8 + [_P],
    # the split body's resident clusters: prefix (K9b/K9c) or not (K7/K8),
    # rows, D, out int; prefix (K9a) or not (K4), D, out int
    "p2t_decode_split_int8_resident": [_I, _I, _I, _P],
    "p2t_decode_split_bf16_resident": [_I, _I, _P],
    # the ragged route: x, w (layer), scale (layer), out, partial, R, K, N,
    # bits, splits, dtype, stream
    "p2t_quant_matmul": [_P] * 5 + [_I] * 6 + [_P],
    # the same, with fmt (0 split-half bytes, 1 bf16-pair words) for bits
    "p2t_quant_matmul_int4": [_P] * 5 + [_I] * 6 + [_P],
    # the few-row TMA body: x, w (layer), scale (layer), out, R, K, N, fmt
    # (0 planes, 1 pairs, 2 bytes, 3 int8), ck, stages, dtype, stream
    "p2t_quant_matmul_few": [_P] * 4 + [_I] * 7 + [_P],
    # x, xp (the int4 formats' scratch) or None, w (layer), scale (layer)
    # or None, out, R, K, N, fmt (0 int8, 1 planes, 2 bytes, 3 pairs), bm,
    # bn, ck, out dtype, stream
    "p2t_quant_matmul_rows": [_P] * 5 + [_I] * 8 + [_P],
    # x, w, scale, out, partial, R, K, N, variant, param, splits, stream
    "p2t_probe_quant_matmul": [_P] * 5 + [_I] * 6 + [_P],
    # x, w, scale, out, R, K, N, variant, param, ck, stages, stream
    "p2t_probe_quant_matmul_few": [_P] * 4 + [_I] * 7 + [_P],
    # x, w, out, R, K, N, bm, bn, ck, stream
    "p2t_int8_mma": [_P] * 3 + [_I] * 6 + [_P],
    # x, out, n, mult, stream
    "p2t_int8_quantize_store": [_P, _P, _L, _F, _P],
    # a, b, out, rows, cols, row, stream
    "p2t_int8_select_row": [_P] * 3 + [_I] * 3 + [_P],
    # cache, kn, slot, heads, T, D, stream
    "p2t_int8_group_row_write": [_P] * 3 + [_I] * 3 + [_P],
    # q, c, s, out, Q, T, D, stream
    "p2t_int8_kv_logits": [_P] * 4 + [_I] * 3 + [_P],
    # s, sn, slot, heads, T, stream
    "p2t_scale_column_write": [_P] * 3 + [_I] * 2 + [_P],
}
# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libp2t_kernels_{source_hash()}.so"


def build() -> Path:
    """Compile the library unless this exact source set is already built.
    Returns its path; the nvcc/ptxas report goes to `<lib>.log`."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if so.exists():
                return so
            cu, _ = _sources()
            nvcc = find_nvcc()
            tag = f"{so.stem}.{os.getpid()}"
            tmp = BUILD_DIR / f"{tag}.tmp.so"
            objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu]
            t0 = time.time()
            jobs = []
            for src, obj in zip(cu, objs):
                cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-c", "-o", str(obj),
                       str(src)]
                jobs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
            log, ok = [], True
            for cmd, proc in jobs:
                out, err = proc.communicate()
                log.append(f"$ {' '.join(cmd)}\n# rc {proc.returncode}\n"
                           f"{out}{err}")
                ok = ok and proc.returncode == 0
            if ok:
                cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
                res = subprocess.run(cmd, capture_output=True, text=True)
                log.append(f"$ {' '.join(cmd)}\n# rc {res.returncode}\n"
                           f"{res.stdout}{res.stderr}")
                ok = res.returncode == 0
            for obj in objs:
                obj.unlink(missing_ok=True)
            log = (f"# {len(cu)} sources in {time.time() - t0:.1f} s, "
                   f"{'ok' if ok else 'FAILED'}\n" + "\n".join(log))
            so.with_suffix(".log").write_text(log)
            if not ok:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed:\n{log}")
            os.replace(tmp, so)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.p2t_error_string.argtypes = [ctypes.c_int]
    lib.p2t_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = library().p2t_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def dtype_code(dtype) -> int:
    key = str(dtype).removeprefix("torch.")
    if key not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    return DTYPE_CODES[key]


def stream_of(t) -> int:
    """Raw cudaStream_t of the current PyTorch stream on t's device, read
    by one call into PyTorch's C extension (`torch.cuda.current_stream`
    builds a `torch.cuda.Stream` object on every call; every kernel wrapper
    calls this on every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
