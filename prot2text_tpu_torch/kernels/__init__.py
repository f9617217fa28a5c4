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
}

# kernels that no path of either package launches, each with its only JAX
# caller: held against their plain versions, but no path counts them
OFF_PATH = {"K13": "tests/test_flash_attention.py:142"}


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
    "flash_attention_masked_plain", "launch_counts", "quant_matmul_int4",
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
