"""ESM2 protein encoder (counterpart of prot2text_tpu/models/esm2.py).

HF `EsmModel` numerics as the JAX package has them: token-dropout embedding
scaling, embeddings times the attention mask, pre-LN blocks, the query
scaled by head_dim**-0.5 BEFORE rotary, rotary over the absolute index,
final LayerNorm.  Attention goes through `kernels.attention.
dot_product_attention` with `attn_impl`, as the JAX `attention(q, k, v,
bias, impl=attn_impl)`: "auto"/"xla" plain PyTorch (fp32 logits +
key-padding bias, fp32 softmax; JAX keeps bidirectional encoders on XLA),
"flash" K6 forward and K6b backward.  `remat=True` recomputes each block
in the backward pass (the JAX `scan_layers(..., remat)`).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.attention import dot_product_attention
from .transformer import (
    apply_rope, gelu_erf, layer_norm, layer_views, linear,
    make_attention_bias, rope_cos_sin,
)
from .weights import normal_


@dataclasses.dataclass(frozen=True)
class ESM2Config:
    vocab_size: int = 33
    hidden_size: int = 320
    num_layers: int = 6
    num_heads: int = 20
    intermediate_size: int = 1280
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    mask_token_id: int = 32
    token_dropout: bool = True
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    # published checkpoint shapes
    @classmethod
    def t6_8M(cls):
        return cls(hidden_size=320, num_layers=6, num_heads=20,
                   intermediate_size=1280)

    @classmethod
    def t36_3B(cls):
        return cls(hidden_size=2560, num_layers=36, num_heads=40,
                   intermediate_size=10240)


def init_esm2_params(cfg: ESM2Config, *, generator, device,
                     dtype=torch.float32):
    h, m, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    kw = dict(generator=generator, device=device, dtype=dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def dense(din, dout):
        return {"kernel": normal_((L, din, dout), **kw),
                "bias": zeros(L, dout)}

    def ln(*lead):
        return {"scale": torch.ones((*lead, h), device=device, dtype=dtype),
                "bias": zeros(*lead, h)}

    return {
        "word_embeddings": normal_((cfg.vocab_size, h), **kw),
        "layers": {
            "attn_ln": ln(L),
            "query": dense(h, h),
            "key": dense(h, h),
            "value": dense(h, h),
            "attn_out": dense(h, h),
            "mlp_ln": ln(L),
            "intermediate": dense(h, m),
            "output": dense(m, h),
        },
        "final_ln": ln(),
    }


def _embed(cfg: ESM2Config, params, input_ids, attention_mask):
    emb = params["word_embeddings"][input_ids]
    if cfg.token_dropout:
        is_mask = input_ids == cfg.mask_token_id
        emb = torch.where(is_mask[..., None], 0.0, emb)
        mask_ratio_train = 0.15 * 0.8
        src_len = attention_mask.sum(-1).float()
        observed = is_mask.sum(-1).float() / src_len
        scale = (1.0 - mask_ratio_train) / (1.0 - observed)
        emb = (emb.float() * scale[:, None, None]).to(emb.dtype)
    return emb * attention_mask[..., None].to(emb.dtype)


def _block(cfg: ESM2Config, lp, h, bias, cos, sin, attn_impl):
    B, S, _ = h.shape
    H, D = cfg.num_heads, cfg.head_dim
    xn = layer_norm(lp["attn_ln"], h, cfg.layer_norm_eps)
    q = linear(lp["query"], xn).view(B, S, H, D).transpose(1, 2)
    k = linear(lp["key"], xn).view(B, S, H, D).transpose(1, 2)
    v = linear(lp["value"], xn).view(B, S, H, D).transpose(1, 2)
    q = (q.float() * D ** -0.5).to(q.dtype)   # ESM: scale before rotary
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    a = dot_product_attention(q, k, v, bias, impl=attn_impl)
    a = a.transpose(1, 2).reshape(B, S, H * D)
    h = h + linear(lp["attn_out"], a)
    xn = layer_norm(lp["mlp_ln"], h, cfg.layer_norm_eps)
    return h + linear(lp["output"], gelu_erf(linear(lp["intermediate"], xn)))


def esm2_encode(cfg: ESM2Config, params, input_ids=None, attention_mask=None,
                *, inputs_embeds=None, attn_impl: str = "auto",
                remat: bool = False):
    """Per-token hidden states (B, S, H)."""
    if inputs_embeds is not None:
        B, S, _ = inputs_embeds.shape
        if attention_mask is None:
            attention_mask = torch.ones((B, S), dtype=torch.int32,
                                        device=inputs_embeds.device)
        h = inputs_embeds * attention_mask[..., None].to(inputs_embeds.dtype)
    else:
        B, S = input_ids.shape
        h = _embed(cfg, params, input_ids, attention_mask)
    bias = make_attention_bias(attention_mask, causal=False)
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    for lp in layer_views(params["layers"], cfg.num_layers):
        if remat:
            # the block draws no random numbers: no RNG state to replay
            h = checkpoint(_block, cfg, lp, h, bias, cos, sin, attn_impl,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            h = _block(cfg, lp, h, bias, cos, sin, attn_impl)
    return layer_norm(params["final_ln"], h, cfg.layer_norm_eps)
