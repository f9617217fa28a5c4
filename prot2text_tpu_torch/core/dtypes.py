"""CLI coercers (counterpart of prot2text_tpu/core/dtypes.py)."""

from __future__ import annotations

import argparse

import torch

_TRUE = {"yes", "true", "t", "y", "1"}
_FALSE = {"no", "false", "f", "n", "0"}

_DTYPES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "f32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "fp16": torch.float16,
}
# weight-quantized dtypes: the towers are built in bf16 and quantized
# (`models/quant.quantize_params`); only the serve CLI takes them
QUANTIZED = {"int8": 8, "int4": 4}


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).lower()
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    raise argparse.ArgumentTypeError(f"Boolean value expected, got {v!r}")


def str2dtype(v):
    """"bf16"/"fp32"/... → torch.dtype; "int8"/"int4" (weight
    quantization) are returned as the string."""
    if not isinstance(v, str):
        return v
    key = v.lower().removeprefix("torch.").removeprefix("jnp.")
    if key in QUANTIZED:
        return key
    if key not in _DTYPES:
        raise argparse.ArgumentTypeError(f"Unsupported dtype {v!r}")
    return _DTYPES[key]


def compute_dtype(model_dtype) -> torch.dtype:
    """The float dtype the towers are built and run in: `model_dtype`
    itself, or bf16 for the quantized "int8"/"int4"."""
    return torch.bfloat16 if model_dtype in QUANTIZED else model_dtype
