"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper runs its plain version for CPU tensors and launches its kernel
(or raises) for CUDA tensors; it counts its kernel launches in a plain
integer attribute, `wrapper.launches`.  The CUDA library is built and
loaded only when a kernel is first launched (`_build.py`).
"""

from .cache_update import (
    cache_slot_write, cache_slot_write_bkt, cache_slot_write_bkt_plain,
    cache_slot_write_kv, cache_slot_write_kv_plain, cache_slot_write_plain,
)
from .decode_attention import (
    decode_attention_stacked, decode_attention_stacked_plain,
    decode_attention_stacked_write, decode_attention_stacked_write_plain,
    decode_attention_stacked_verify_qc,
    decode_attention_stacked_verify_qc_plain,
    decode_attention_stacked_verify_qc_prefix,
    decode_attention_stacked_verify_qc_prefix_plain,
    decode_attention_stacked_write_prefix,
    decode_attention_stacked_write_prefix_plain,
    decode_attention_stacked_write_q, decode_attention_stacked_write_q_plain,
    decode_attention_stacked_write_q_prefix,
    decode_attention_stacked_write_q_prefix_plain,
)
from .flash_attention import (
    flash_attention_bias, flash_attention_bias_bwd,
    flash_attention_bias_bwd_plain, flash_attention_bias_fwd,
    flash_attention_bias_plain, flash_attention_masked,
    flash_attention_masked_bwd, flash_attention_masked_bwd_plain,
    flash_attention_masked_fwd, flash_attention_masked_plain,
)
from .probe_int8_kv import (
    f32_scale_row_rmw, f32_scale_row_rmw_plain, f32_to_int8_store,
    f32_to_int8_store_plain, int8_group_rmw, int8_group_rmw_plain,
    int8_select, int8_select_plain, int8_to_bf16_matmul,
    int8_to_bf16_matmul_plain,
)
from .probe_quant_matmul import (
    chunk_mm, chunk_mm_plain, mm_i4and, mm_i4and_plain, mm_i4f, mm_i4f_plain,
    mm_i4n, mm_i4n_plain, mm_i4p, mm_i4p_plain, mm_i8i8, mm_i8i8_plain,
    mm_mix, mm_mix_plain,
)
from .quant_matmul import (
    quant_matmul_int4, quant_matmul_int4_pairs,
    quant_matmul_int4_pairs_plain, quant_matmul_int4_pairs_stacked,
    quant_matmul_int4_pairs_stacked_plain, quant_matmul_int4_plain,
    quant_matmul_int4_stacked, quant_matmul_int4_stacked_plain,
    quant_matmul_int4_planes, quant_matmul_int4_planes_plain,
    quant_matmul_int4_planes_stacked, quant_matmul_int4_planes_stacked_plain,
    quant_matmul_int8, quant_matmul_int8_plain, quant_matmul_int8_stacked,
    quant_matmul_int8_stacked_plain,
)

_PROBE_MM = "prot2text_tpu_torch/kernels/csrc/probe_quant_matmul.cu"
_PROBE_KV = "prot2text_tpu_torch/kernels/csrc/probe_int8_kv.cu"

# id → (wrapper, plain version, kernel source, TPU kernel it replaces); a
# kernel with two entry points (unstacked and stacked) lists both wrappers,
# and its launch count is their sum
KERNELS = {
    "K1": (flash_attention_masked_fwd, flash_attention_masked_plain,
           "prot2text_tpu_torch/kernels/csrc/flash_attention.cu",
           "prot2text_tpu/kernels/flash_attention.py:704"),
    "K2": (decode_attention_stacked, decode_attention_stacked_plain,
           "prot2text_tpu_torch/kernels/csrc/decode_attention.cu",
           "prot2text_tpu/kernels/decode_attention.py:66"),
    "K3": (cache_slot_write_bkt, cache_slot_write_bkt_plain,
           "prot2text_tpu_torch/kernels/csrc/cache_update.cu",
           "prot2text_tpu/kernels/cache_update.py:176"),
    "K4": (decode_attention_stacked_write,
           decode_attention_stacked_write_plain,
           "prot2text_tpu_torch/kernels/csrc/decode_attention_write.cu",
           "prot2text_tpu/kernels/decode_attention.py:182"),
    "K5": (flash_attention_masked_bwd, flash_attention_masked_bwd_plain,
           "prot2text_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
           "prot2text_tpu/kernels/flash_attention.py:582"),
    "K6": (flash_attention_bias_fwd, flash_attention_bias_plain,
           "prot2text_tpu_torch/kernels/csrc/flash_attention_bias.cu",
           "prot2text_tpu/kernels/flash_attention.py:465"),
    "K6b": (flash_attention_bias_bwd, flash_attention_bias_bwd_plain,
            "prot2text_tpu_torch/kernels/csrc/flash_attention_bias_bwd.cu",
            "prot2text_tpu/kernels/flash_attention.py:356"),
    "K9a": (decode_attention_stacked_write_prefix,
            decode_attention_stacked_write_prefix_plain,
            "prot2text_tpu_torch/kernels/csrc/decode_attention_write.cu",
            "prot2text_tpu/kernels/decode_attention.py:703"),
    "K7": (decode_attention_stacked_write_q,
           decode_attention_stacked_write_q_plain,
           "prot2text_tpu_torch/kernels/csrc/decode_attention_write_q.cu",
           "prot2text_tpu/kernels/decode_attention.py:307"),
    "K8": (decode_attention_stacked_verify_qc,
           decode_attention_stacked_verify_qc_plain,
           "prot2text_tpu_torch/kernels/csrc/decode_attention_verify.cu",
           "prot2text_tpu/kernels/decode_attention.py:525"),
    "K9b": (decode_attention_stacked_write_q_prefix,
            decode_attention_stacked_write_q_prefix_plain,
            "prot2text_tpu_torch/kernels/csrc/decode_attention_write_q.cu",
            "prot2text_tpu/kernels/decode_attention.py:843"),
    "K9c": (decode_attention_stacked_verify_qc_prefix,
            decode_attention_stacked_verify_qc_prefix_plain,
            "prot2text_tpu_torch/kernels/csrc/decode_attention_verify.cu",
            "prot2text_tpu/kernels/decode_attention.py:1041"),
    "K10": ((quant_matmul_int4_planes, quant_matmul_int4_planes_stacked),
            (quant_matmul_int4_planes_plain,
             quant_matmul_int4_planes_stacked_plain),
            "prot2text_tpu_torch/kernels/csrc/quant_matmul.cu",
            "prot2text_tpu/kernels/quant_matmul.py:346/:620"),
    "K11a": ((quant_matmul_int4, quant_matmul_int4_stacked),
             (quant_matmul_int4_plain, quant_matmul_int4_stacked_plain),
             "prot2text_tpu_torch/kernels/csrc/quant_matmul_int4.cu",
             "prot2text_tpu/kernels/quant_matmul.py:181/:256"),
    "K11b": ((quant_matmul_int4_pairs, quant_matmul_int4_pairs_stacked),
             (quant_matmul_int4_pairs_plain,
              quant_matmul_int4_pairs_stacked_plain),
             "prot2text_tpu_torch/kernels/csrc/quant_matmul_int4.cu",
             "prot2text_tpu/kernels/quant_matmul.py:495/:554"),
    "K14": ((quant_matmul_int8, quant_matmul_int8_stacked),
            (quant_matmul_int8_plain, quant_matmul_int8_stacked_plain),
            "prot2text_tpu_torch/kernels/csrc/quant_matmul.cu",
            "prot2text_tpu/kernels/quant_matmul.py:98/:683"),
    "K12": (cache_slot_write, cache_slot_write_plain,
            "prot2text_tpu_torch/kernels/csrc/cache_update.cu",
            "prot2text_tpu/kernels/cache_update.py:104"),
    "K13": (cache_slot_write_kv, cache_slot_write_kv_plain,
            "prot2text_tpu_torch/kernels/csrc/cache_update.cu",
            "prot2text_tpu/kernels/cache_update.py:67"),
    # K15: the TPU probe scripts' in-file kernels; their path is the port's
    # probes, `prot2text_tpu_torch/scripts/`
    "K15a": (chunk_mm, chunk_mm_plain, _PROBE_MM,
             "scripts/bench_lmhead3.py:65"),
    "K15b": (mm_i4f, mm_i4f_plain, _PROBE_MM,
             "scripts/bench_int4_unpack.py:96"),
    "K15c": (mm_i4n, mm_i4n_plain, _PROBE_MM,
             "scripts/bench_int4_unpack.py:138"),
    "K15d": (mm_i4p, mm_i4p_plain, _PROBE_MM,
             "scripts/bench_int4_planes.py:95"),
    "K15e": (mm_i4and, mm_i4and_plain, _PROBE_MM,
             "scripts/bench_int4_single.py:86"),
    "K15f": (mm_i8i8, mm_i8i8_plain,
             "prot2text_tpu_torch/kernels/csrc/int8_mma.cu",
             "scripts/bench_int8_mxu.py:102"),
    "K15g": (mm_mix, mm_mix_plain,
             "prot2text_tpu_torch/kernels/csrc/quant_matmul_rows.cu",
             "scripts/bench_int8_mxu.py:156"),
    "K15h": (f32_to_int8_store, f32_to_int8_store_plain, _PROBE_KV,
             "scripts/probe_int8_kv.py:38"),
    "K15i": (int8_select, int8_select_plain, _PROBE_KV,
             "scripts/probe_int8_kv.py:50"),
    "K15j": (int8_group_rmw, int8_group_rmw_plain, _PROBE_KV,
             "scripts/probe_int8_kv.py:62"),
    "K15k": (int8_to_bf16_matmul, int8_to_bf16_matmul_plain, _PROBE_KV,
             "scripts/probe_int8_kv.py:96"),
    "K15l": (f32_scale_row_rmw, f32_scale_row_rmw_plain, _PROBE_KV,
             "scripts/probe_int8_kv.py:116"),
}

# kernels that no model path of the port launches, each with why: held
# against their plain versions, but no path counts them
OFF_PATH = {
    "K2": ("no model path: the bf16 lockstep step attends and writes its "
           "slot in K4 per layer (JAX's P2T_FUSED_CACHE_WRITE route, "
           "prot2text_tpu/models/decoder.py:992-1027); JAX's default "
           "lockstep step still calls it (:1059)"),
    "K3": ("no model path: the bf16 lockstep step writes its slot in K4's "
           "epilogue per layer; JAX's default lockstep step still calls it "
           "(prot2text_tpu/models/decoder.py:1129-1131)"),
    "K12": ("no model path: the tbkd lockstep step writes its slot in K4's "
            "epilogue per layer, at the tbkd strides; JAX's tbkd step "
            "still calls it (prot2text_tpu/models/decoder.py:1139-1143)"),
    "K13": ("no path of either package; its only JAX caller is "
            "tests/test_flash_attention.py:142"),
}


def _wrappers(w) -> tuple:
    return w if isinstance(w, tuple) else (w,)


def launch_counts() -> dict:
    return {kid: sum(f.launches for f in _wrappers(w))
            for kid, (w, *_) in KERNELS.items()}


def reset_launch_counts() -> None:
    for w, *_ in KERNELS.values():
        for f in _wrappers(w):
            f.launches = 0


__all__ = [
    "KERNELS", "OFF_PATH", "cache_slot_write", "cache_slot_write_bkt",
    "cache_slot_write_bkt_plain", "cache_slot_write_kv",
    "cache_slot_write_kv_plain", "cache_slot_write_plain",
    "decode_attention_stacked", "decode_attention_stacked_plain",
    "decode_attention_stacked_write", "decode_attention_stacked_write_plain",
    "decode_attention_stacked_write_prefix",
    "decode_attention_stacked_write_prefix_plain",
    "decode_attention_stacked_verify_qc",
    "decode_attention_stacked_verify_qc_plain",
    "decode_attention_stacked_verify_qc_prefix",
    "decode_attention_stacked_verify_qc_prefix_plain",
    "decode_attention_stacked_write_q", "decode_attention_stacked_write_q_plain",
    "decode_attention_stacked_write_q_prefix",
    "decode_attention_stacked_write_q_prefix_plain", "flash_attention_bias",
    "flash_attention_bias_bwd", "flash_attention_bias_bwd_plain",
    "flash_attention_bias_fwd", "flash_attention_bias_plain",
    "flash_attention_masked", "flash_attention_masked_bwd",
    "flash_attention_masked_bwd_plain", "flash_attention_masked_fwd",
    "flash_attention_masked_plain", "chunk_mm", "chunk_mm_plain",
    "f32_scale_row_rmw", "f32_scale_row_rmw_plain", "f32_to_int8_store",
    "f32_to_int8_store_plain", "int8_group_rmw", "int8_group_rmw_plain",
    "int8_select", "int8_select_plain", "int8_to_bf16_matmul",
    "int8_to_bf16_matmul_plain", "mm_i4and", "mm_i4and_plain", "mm_i4f",
    "mm_i4f_plain", "mm_i4n", "mm_i4n_plain", "mm_i4p", "mm_i4p_plain",
    "mm_i8i8", "mm_i8i8_plain", "mm_mix", "mm_mix_plain",
    "launch_counts", "quant_matmul_int4",
    "quant_matmul_int4_pairs", "quant_matmul_int4_pairs_plain",
    "quant_matmul_int4_pairs_stacked",
    "quant_matmul_int4_pairs_stacked_plain", "quant_matmul_int4_plain",
    "quant_matmul_int4_stacked", "quant_matmul_int4_stacked_plain",
    "quant_matmul_int4_planes", "quant_matmul_int4_planes_plain",
    "quant_matmul_int4_planes_stacked",
    "quant_matmul_int4_planes_stacked_plain", "quant_matmul_int8",
    "quant_matmul_int8_plain", "quant_matmul_int8_stacked",
    "quant_matmul_int8_stacked_plain", "reset_launch_counts",
]
