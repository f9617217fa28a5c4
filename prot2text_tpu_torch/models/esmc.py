"""ESM-Cambrian (ESMC) protein encoder (counterpart of
prot2text_tpu/models/esmc.py).

The architecture of EvolutionaryScale's `ESMC` as the JAX package has it:
token embedding (64-entry table), n_layers pre-LN blocks with residuals
scaled by 1/sqrt(n_layers/36) — fused qkv (no bias), q/k LayerNorm over
d_model (no bias), rotary (theta 10000) over the absolute index, the query
scaled by head_dim**-0.5 AFTER rotary, out_proj; SwiGLU FFN
(Linear(d, 2f) → silu(g1)·g2 → Linear(f, d)) — and a final LayerNorm.
Attention is bidirectional with a (B, 1, 1, S) key-padding bias, routed
by `attn_impl` as the JAX `attention(q, k, v, bias, impl=attn_impl)`
(prot2text_tpu/models/esmc.py:154): "xla" and "auto" take plain PyTorch
(fp32 logits + bias, the JAX XLA route), "flash" takes K6 forward and K6b
backward (`kernels/attention.py`).  LoRA side paths ride qkv, out_proj,
ffn_in and ffn_out; `remat=True` recomputes each block in the backward
pass (under "flash" that runs K6 a second time per block).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.attention import dot_product_attention
from .lora import lora_at
from .transformer import (
    apply_rope, layer_norm, layer_views, linear_lora, make_attention_bias,
    rope_cos_sin,
)
from .weights import normal_

# ESMC sequence tokenizer ids == ESM2 alphabet (cls=0, pad=1, eos=2, ...)
ESMC_PAD_ID = 1
ESMC_BOS_ID = 0
ESMC_EOS_ID = 2


def _swiglu_dim(expansion_ratio: float, d_model: int) -> int:
    return int(((expansion_ratio * d_model) + 255) // 256 * 256)


@dataclasses.dataclass(frozen=True)
class ESMCConfig:
    vocab_size: int = 64
    d_model: int = 1152
    n_layers: int = 36
    n_heads: int = 18
    expansion_ratio: float = 8 / 3
    rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def ffn_dim(self) -> int:
        return _swiglu_dim(self.expansion_ratio, self.d_model)

    @property
    def residue_scaling(self) -> float:
        return (self.n_layers / 36) ** 0.5

    @classmethod
    def esmc_600m(cls):
        return cls(d_model=1152, n_layers=36, n_heads=18)

    @classmethod
    def esmc_300m(cls):
        return cls(d_model=960, n_layers=30, n_heads=15)

    @classmethod
    def tiny(cls):
        return cls(d_model=64, n_layers=2, n_heads=4)


def init_esmc_params(cfg: ESMCConfig, *, generator, device,
                     dtype=torch.float32):
    """Random params with the JAX init's tree and law (N(0, 0.02) kernels and
    embedding, unit norm scales, no biases), drawn on `device`."""
    d, f, L = cfg.d_model, cfg.ffn_dim, cfg.n_layers
    kw = dict(generator=generator, device=device, dtype=dtype)

    def dense(din, dout):
        return {"kernel": normal_((L, din, dout), **kw)}

    def ln(*lead):
        return {"scale": torch.ones((*lead, d), device=device, dtype=dtype)}

    return {
        "embed": normal_((cfg.vocab_size, d), **kw),
        "layers": {
            "attn_ln": ln(L),
            "qkv": dense(d, 3 * d),
            "q_ln": ln(L),
            "k_ln": ln(L),
            "out_proj": dense(d, d),
            "ffn_ln": ln(L),
            "ffn_in": dense(d, 2 * f),
            "ffn_out": dense(f, d),
        },
        "final_ln": ln(),
    }


def _block(cfg: ESMCConfig, lp, ll, lora_scale, x, bias, cos, sin,
           attn_impl):
    B, S, _ = x.shape
    H, D = cfg.n_heads, cfg.head_dim
    scale = 1.0 / cfg.residue_scaling

    def proj(name, x_):
        lo = lora_at(ll.get(name)) if ll is not None else None
        return linear_lora(lp[name], lo, x_, lora_scale)

    xn = layer_norm(lp["attn_ln"], x, cfg.layer_norm_eps)
    q, k, v = proj("qkv", xn).chunk(3, dim=-1)
    q = layer_norm(lp["q_ln"], q, cfg.layer_norm_eps)
    k = layer_norm(lp["k_ln"], k, cfg.layer_norm_eps)
    q = q.reshape(B, S, H, D).transpose(1, 2)
    k = k.reshape(B, S, H, D).transpose(1, 2)
    v = v.reshape(B, S, H, D).transpose(1, 2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q = (q.float() * D ** -0.5).to(q.dtype)
    a = dot_product_attention(q, k, v, bias, impl=attn_impl)
    a = a.transpose(1, 2).reshape(B, S, H * D)
    x = x + proj("out_proj", a) * scale
    xn = layer_norm(lp["ffn_ln"], x, cfg.layer_norm_eps)
    g1, g2 = proj("ffn_in", xn).chunk(2, dim=-1)
    y = F.silu(g1.float()).to(g2.dtype) * g2
    return x + proj("ffn_out", y) * scale


def esmc_encode(cfg: ESMCConfig, params, input_ids, attention_mask, *,
                attn_impl: str = "auto", remat: bool = False, lora=None,
                lora_scale: float = 1.0):
    """`.embeddings`-equivalent per-token hidden states (B, S, d_model).
    input_ids (B, S) right-padded with pad id 1; attention_mask (B, S) 0/1;
    `attn_impl` "auto"/"xla" (plain) or "flash" (K6/K6b); `lora` an
    optional LoRA tree (models/lora.py layout)."""
    S = input_ids.shape[1]
    h = params["embed"][input_ids]
    bias = make_attention_bias(attention_mask, causal=False)
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    layers = layer_views(params["layers"], cfg.n_layers)
    lora_layers = (layer_views(lora["layers"], cfg.n_layers)
                   if lora is not None else [None] * cfg.n_layers)
    for lp, ll in zip(layers, lora_layers):
        if remat:
            # the block draws no random numbers: no RNG state to replay
            h = checkpoint(_block, cfg, lp, ll, lora_scale, h, bias, cos, sin,
                           attn_impl, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = _block(cfg, lp, ll, lora_scale, h, bias, cos, sin, attn_impl)
    return layer_norm(params["final_ln"], h, cfg.layer_norm_eps)


def esmc_params_from_torch(sd, num_layers: int, *, device="cpu",
                           dtype=torch.float32):
    """An `esm` package ESMC state dict (keys embed.weight,
    transformer.blocks.{i}.attn.layernorm_qkv.{0,1}, attn.{q_ln,k_ln,
    out_proj}, ffn.{0,1,3}, transformer.norm) → the JAX-layout tree:
    kernels transposed to (in, out), layers stacked.  LayerNorm biases are
    kept where the state dict has them (layernorm_qkv.0 and ffn.0 in real
    checkpoints)."""
    def t(key):
        return sd[key].detach().to(device=device, dtype=dtype)

    def dense(prefix):
        return {"kernel": t(prefix + ".weight").T}

    def ln(prefix):
        p = {"scale": t(prefix + ".weight")}
        if prefix + ".bias" in sd:
            p["bias"] = t(prefix + ".bias")
        return p

    def stack(trees):
        first = trees[0]
        if isinstance(first, dict):
            return {k: stack([x[k] for x in trees]) for k in first}
        return torch.stack(trees).contiguous()

    layers = []
    for i in range(num_layers):
        pre = f"transformer.blocks.{i}"
        layers.append({
            "attn_ln": ln(f"{pre}.attn.layernorm_qkv.0"),
            "qkv": dense(f"{pre}.attn.layernorm_qkv.1"),
            "q_ln": ln(f"{pre}.attn.q_ln"),
            "k_ln": ln(f"{pre}.attn.k_ln"),
            "out_proj": dense(f"{pre}.attn.out_proj"),
            "ffn_ln": ln(f"{pre}.ffn.0"),
            "ffn_in": dense(f"{pre}.ffn.1"),
            "ffn_out": dense(f"{pre}.ffn.3"),
        })
    return {
        "embed": t("embed.weight"),
        "layers": stack(layers),
        "final_ln": ln("transformer.norm"),
    }
