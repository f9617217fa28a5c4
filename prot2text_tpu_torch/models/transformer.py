"""Shared transformer primitives (counterpart of
prot2text_tpu/models/transformer.py): plain functions over nested dicts of
tensors.  Params keep the JAX layout — `kernel` is (in, out), so
`y = x @ kernel + bias`, and layer stacks keep a leading (L, ...) dim.
Norms, softmax and rope run in fp32 whatever the compute dtype.
"""

from __future__ import annotations

import math

import torch

from ..kernels.quant_matmul import (
    QUANT_KERNEL_ROWS, quant_matmul_int4, quant_matmul_int4_pairs,
    quant_matmul_int4_planes, quant_matmul_int8,
)
from .quant import dequantize_kernel


def linear(p, x):
    """y = x @ kernel (+ bias) (prot2text_tpu/models/transformer.py:35).

    Quantized leaves (`models/quant.quantize_params`): activations are
    flattened to rows first (`:69-79`).  On a bf16 x all four formats take
    their kernel at every row count: int4 nibble planes (`kernel_q4p`,
    K10), split-half bytes (`kernel_q4`, K11a), bf16-pair words
    (`kernel_q4w`, K11b) and int8 (`kernel_q`, K14), the few-row body up
    to `FEW_ROWS` rows and the many-row body above.  Each rounds x to bf16
    and applies the scale in an fp32 epilogue: JAX's Pallas kernels at
    <= 256 rows, its XLA route (`:160-176`, an integer weight in the dot,
    the scale after it) above.  Two calls take `torch.matmul` on the
    weight dequantized to x's dtype instead: an f32 x above
    `QUANT_KERNEL_ROWS` rows (JAX's XLA route keeps it unrounded), and any
    call whose x requires grad (the kernels have no backward;
    `torch.matmul` on the dequantized weight carries dX).  The
    tensor-parallel repacks (`*_tp{n}`) raise."""
    if "kernel" in p:
        y = torch.matmul(x, p["kernel"].to(x.dtype))
    else:
        y = _quant_linear(p, x)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def _quant_linear(p, x):
    found = [k for k in p if k.startswith("kernel")]
    if any("_tp" in k for k in found):
        raise NotImplementedError(
            f"tensor-parallel int4 leaves {found} are not ported yet "
            "(ROADMAP.md §1 item 14)")
    if "kernel_q4p" in p:
        kernel, w = quant_matmul_int4_planes, p["kernel_q4p"]
    elif "kernel_q4w" in p:
        kernel, w = quant_matmul_int4_pairs, p["kernel_q4w"]
    elif "kernel_q4" in p:
        kernel, w = quant_matmul_int4, p["kernel_q4"]
    else:
        kernel, w = quant_matmul_int8, p["kernel_q"]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if (torch.is_grad_enabled() and x.requires_grad) or (
            x.dtype != torch.bfloat16 and x2.shape[0] > QUANT_KERNEL_ROWS):
        y = torch.matmul(x2, dequantize_kernel(p, x.dtype))
    else:
        y = kernel(x2.contiguous(), w, p["scale"])
    return y.reshape(*lead, y.shape[-1])


def linear_lora(p, lora, x, scale: float = 1.0):
    """y = x·W (+ bias) + scale·(x·A)·B — the LoRA low-rank side path
    (prot2text_tpu/models/transformer.py:184).  `lora` is None or {"A": (din,
    r), "B": (r, dout)}, cast to x's dtype as in JAX; W+ΔW never exists."""
    y = linear(p, x)
    if lora is None:
        return y
    xa = torch.matmul(x, lora["A"].to(x.dtype))
    return y + scale * torch.matmul(xa, lora["B"].to(x.dtype))


def layer_views(layers: dict, num_layers: int):
    """Per-layer dicts of views into the stacked (L, ...) leaves (`None`
    leaves, as in LoRA trees, stay `None`)."""
    def view(sub, li):
        return {k: (view(v, li) if isinstance(v, dict)
                    else None if v is None else v[li])
                for k, v in sub.items()}

    return [view(layers, li) for li in range(num_layers)]


def layer_norm(p, x, eps: float = 1e-5):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def rms_norm(p, x, eps: float = 1e-6):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def gelu_erf(x):
    """Exact-erf GELU (HF modeling_esm gelu, torch nn.GELU default)."""
    x32 = x.float()
    y = x32 * 0.5 * (1.0 + torch.erf(x32 / math.sqrt(2.0)))
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings (GPT-NeoX half-split layout)


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions: (..., seq) int → cos/sin (..., seq, head_dim) fp32."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=positions.device) / head_dim))
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x, cos, sin):
    """x: (B, H, S, D); cos/sin: (B, S, D) or (S, D)."""
    if cos.dim() == 2:
        cos, sin = cos[None, None], sin[None, None]
    else:
        cos, sin = cos[:, None], sin[:, None]
    x32 = x.float()
    return (x32 * cos + rotate_half(x32) * sin).to(x.dtype)


# ---------------------------------------------------------------------------
# attention helpers


def repeat_kv(x, n_rep: int):
    """(B, Hkv, S, D) → (B, Hkv*n_rep, S, D) for GQA."""
    if n_rep == 1:
        return x
    b, h, s, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, s, d).reshape(b, h * n_rep, s, d)


def make_attention_bias(attention_mask, dtype=torch.float32,
                        causal: bool = False, q_positions=None,
                        kv_positions=None):
    """Additive bias (B, 1, Sq, Skv) from a (B, Skv) 0/1 key mask; causal
    also needs absolute q/kv positions (B, Sq)/(B, Skv)."""
    neg = torch.finfo(dtype).min
    ok = attention_mask[:, None, None, :].bool()
    if causal:
        ok = ok & (kv_positions[:, None, None, :]
                   <= q_positions[:, None, :, None])
    zero = torch.zeros((), dtype=dtype, device=attention_mask.device)
    return torch.where(ok, zero, torch.full_like(zero, neg))
