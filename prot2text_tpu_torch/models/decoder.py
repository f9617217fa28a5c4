"""Shared causal-decoder core for Llama-3.x and Qwen3 (counterpart of
prot2text_tpu/models/decoder.py).

Numerics follow the JAX package (HF LlamaForCausalLM / Qwen3ForCausalLM
parity): fp32 RMSNorm, optional per-head q/k RMSNorm (Qwen3), GQA with
half-split rotary, fp32 softmax, SwiGLU MLP, logits in fp32.

Attention runs through the port's kernels (`decoder_forward`'s
`attn_impl` "auto" or "flash"; "xla" sends every layer's attention of a
forward pass to the plain function instead, over the causal run bias, as
the JAX XLA route `_xla_attention`):
  * prefill / no-cache forward with `attn_lengths` → `kernels.
    flash_attention.flash_attention_masked`, causal with the per-row
    contiguous key run from `contiguous_lengths`: K1 forward and, when
    gradients flow (training), K5 backward.  The JAX package sends S < 1024
    or S not divisible by 128 to XLA under `attn_impl="auto"`
    (prot2text_tpu/kernels/attention.py:111-138), a v5e measurement; the
    port has no such switch;
  * forward with an explicit additive `bias` and a cache offset (the
    serving engine's prefix install: suffix rows written at [cache_index,
    cache_index + S), attention over the whole cache width) → K6,
    `flash_attention_bias`, the counterpart of the JAX
    `attention(impl="flash")` that reaches `flash_attention_tpu` on the TPU
    (prot2text_tpu/kernels/attention.py:226-236);
  * single-token decode with a host-int slot (lockstep generation) → K4
    (`kernels/decode_attention.py decode_attention_stacked_write`) per
    layer, with one (B,) slots tensor of `cache_index` a step: it reads
    the stacked (L, B, Hkv, T, D) cache, folds the current token in as an
    extra logit column and writes the token's k/v into the slot after
    every read of the slab (the slot is still 0 in `kv_mask`, so it is
    never read).  This is the JAX fused-write route
    (`P2T_FUSED_CACHE_WRITE=1`, prot2text_tpu/models/decoder.py:992-1027),
    taken at every T: the JAX default, K2 per layer then K3 for all L
    layers after the loop (`:1008-1011`), saves the TPU a carried cache,
    which an in-place update does not have, and costs a staging copy of
    each layer's k and v and two launches a step.  On the sequence-leading
    (L, T, B, Hkv, D) "tbkd" cache (`kv_cache_layout`: head dims off the
    128 grid, e.g. Llama-3.2-1B's 64) the step runs K4 too, at that
    layout's strides (`layout="tbkd"`), once a layer; JAX's tbkd step
    attends by einsum and writes the slot with K12 after the loop
    (prot2text_tpu/models/decoder.py:1063-1090, :1138-1143), because its
    Pallas decode kernels take bktd only.  The same function: K4's plain
    version on tbkd is that einsum route followed by the layer's slot
    write;
  * single-token decode with per-row slots (continuous batching) → K4,
    attention fused with each row's in-place slot write per layer; with a
    batch-broadcast shared prefix → K9a (prot2text_tpu/models/decoder.py:
    1012-1054); both on a tbkd cache too, at its strides, the prefix then
    sequence-leading (L, Pc, 1, Hkv, D), where JAX's tbkd step attends by
    einsum over the concatenated prefix and scatters the rows' slots after
    the loop (:789-812, :1110-1122);
  * on an int8 cache (`init_kv_cache(kv_bits=8)`): forward passes quantize
    each layer's k/v and attend the dequantized cache through K1/K6;
    single-token decode, per-row or lockstep, runs K7 (K9b with the
    shared prefix); the speculative chunk verify (`decoder_verify_chunk`)
    runs K8 (K9c).
Weight-quantized towers (`models/quant.quantize_params`: int4 nibble
planes, bf16-pair words or split-half bytes, or int8) multiply through
`transformer.linear`, which sends projections of few rows (the decode and
verify steps, the head) to K10/K11b/K11a/K14 on each layer's view of the
stacked buffers, read in place; a quantized LM head gives the fp32 logits
of its x-dtype output.
The layer loop is a Python loop over views of the stacked weights (no
per-layer copies).  Training adds LoRA side paths on the seven projections
(`lora=`) and per-layer recomputation (`remat=True`, the JAX
`jax.checkpoint` around each block).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.attention import IMPLS, dot_product_attention
from ..kernels.decode_attention import (
    HEAD_DIMS, MAX_CHUNK, MAX_ROWS, decode_attention_stacked_verify_qc,
    decode_attention_stacked_verify_qc_prefix, decode_attention_stacked_write,
    decode_attention_stacked_write_prefix, decode_attention_stacked_write_q,
    decode_attention_stacked_write_q_prefix, _slots,
)
from ..kernels.flash_attention import (
    flash_attention_bias, flash_attention_masked,
)
from .lora import lora_at
from .quant import quantize_kv
from .transformer import (
    apply_rope, layer_views, linear, linear_lora, repeat_kv, rms_norm,
)
from .weights import dense, normal_


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    intermediate_size: int
    head_dim: int
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    tie_word_embeddings: bool = False
    qk_norm: bool = False
    rope_scaling: Optional[str] = None  # None | "llama3"
    rope_scaling_factor: float = 8.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192


def init_decoder_params(cfg: DecoderConfig, *, generator, device,
                        dtype=torch.float32):
    """Random params with the JAX init's tree and law (N(0, 0.02) kernels and
    embeddings, unit norm scales), drawn on `device`."""
    h, m, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    kw = dict(generator=generator, device=device, dtype=dtype)

    def stacked(din, dout):
        return {"kernel": normal_((L, din, dout), **kw)}

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    params = {
        "embed_tokens": normal_((cfg.vocab_size, h), **kw),
        "layers": {
            "input_ln": {"scale": ones(L, h)},
            "q_proj": stacked(h, qd),
            "k_proj": stacked(h, kvd),
            "v_proj": stacked(h, kvd),
            "o_proj": stacked(qd, h),
            "post_attn_ln": {"scale": ones(L, h)},
            "gate_proj": stacked(h, m),
            "up_proj": stacked(h, m),
            "down_proj": stacked(m, h),
        },
        "final_ln": {"scale": ones(h)},
    }
    if cfg.qk_norm:
        params["layers"]["q_norm"] = {"scale": ones(L, cfg.head_dim)}
        params["layers"]["k_norm"] = {"scale": ones(L, cfg.head_dim)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense(h, cfg.vocab_size, bias=False, **kw)
    return params


def _rope_inv_freq_scale(cfg: DecoderConfig, inv_freq):
    """HF `_compute_llama3_parameters` smooth frequency interpolation."""
    if cfg.rope_scaling != "llama3":
        return inv_freq
    factor = cfg.rope_scaling_factor
    low = cfg.rope_low_freq_factor
    high = cfg.rope_high_freq_factor
    old_len = cfg.rope_original_max_position
    low_wavelen = old_len / low
    high_wavelen = old_len / high
    wavelen = 2 * math.pi / inv_freq
    scaled = torch.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
    smooth = (old_len / wavelen - low) / (high - low)
    smoothed = (1 - smooth) / factor * inv_freq + smooth * inv_freq
    is_medium = (wavelen >= high_wavelen) & (wavelen <= low_wavelen)
    return torch.where(is_medium, smoothed, scaled)


def decoder_rope_cos_sin(cfg: DecoderConfig, positions):
    """positions: (B, S) or (S,) int → cos/sin fp32 with optional scaling."""
    D = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, D, 2, dtype=torch.float32, device=positions.device)
        / D))
    inv_freq = _rope_inv_freq_scale(cfg, inv_freq)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def embed_tokens(params, input_ids):
    return params["embed_tokens"][input_ids]


def causal_run_bias(kv_start, kv_len, S: int):
    """(B, 1, S, S) fp32 additive bias of the causal key runs: 0 where key
    j lies in row b's run [kv_start[b], kv_start[b] + kv_len[b]) and j <=
    i, finfo(f32).min elsewhere.  For a mask with one contiguous run per
    row this is the JAX `causal_bias_from_mask` of that mask."""
    j = torch.arange(S, device=kv_start.device)
    s, n = kv_start.long()[:, None, None], kv_len.long()[:, None, None]
    ok = (j >= s) & (j < s + n) & (j[None, :] <= j[:, None])
    zero = torch.zeros((), dtype=torch.float32, device=kv_start.device)
    return torch.where(ok[:, None], zero,
                       torch.full_like(zero, torch.finfo(torch.float32).min))


def contiguous_lengths(attention_mask):
    """(B, S) 0/1 mask with one contiguous valid run per row → (kv_start,
    kv_len) int32; fully masked rows get kv_len=1 (outputs ignored)."""
    m = attention_mask.to(torch.int32)
    kv_len = m.sum(dim=1).clamp(min=1)
    kv_start = torch.argmax(m, dim=1)
    return kv_start.to(torch.int32), kv_len.to(torch.int32)


LAYOUTS = ("bktd", "tbkd")


def kv_cache_layout(cfg: DecoderConfig) -> str:
    """The dense cache's layout, as JAX picks it (prot2text_tpu/models/
    decoder.py:138-149): "bktd" (L, B, Hkv, T, D) when the head dim is a
    multiple of 128, else "tbkd" (L, T, B, Hkv, D)."""
    return "bktd" if cfg.head_dim % 128 == 0 else "tbkd"


def resolve_layout(cfg: DecoderConfig, quantized: bool, layout=None) -> str:
    """A cache's layout: `layout` when the caller names it (the serving
    pool keeps "bktd" at every head dim), else "bktd" for an int8 cache
    (JAX has none in tbkd; the port accepts one at every D) and
    `kv_cache_layout(cfg)` for a dense one."""
    if layout is None:
        return "bktd" if quantized else kv_cache_layout(cfg)
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if quantized and layout != "bktd":
        raise ValueError("an int8 cache is (L, B, Hkv, T, D): layout bktd")
    return layout


def cache_width(kv_cache, layout: str) -> int:
    """T, the cache's slot count."""
    return kv_cache["k"].shape[3 if layout == "bktd" else 1]


def _mlp(cfg, lp, x, proj=None):
    proj = proj or (lambda name, x_: linear(lp[name], x_))
    xn = rms_norm(lp["post_attn_ln"], x, cfg.rms_norm_eps)
    gate = F.silu(proj("gate_proj", xn).float())
    up = proj("up_proj", xn).float()
    return x + proj("down_proj", (gate * up).to(xn.dtype))


def _write_columns(kv_cache, li, vals, cache_index, S, layout):
    """Layer `li` of every cache tensor (k, v and, int8, their scales)
    takes `vals` at columns [cache_index, cache_index + S): a host int
    writes one slab for all rows (on tbkd the (S, B, Hkv, D) slab, the JAX
    `dynamic_update_slice`, prot2text_tpu/models/decoder.py:346-362); a
    (B,) tensor writes row b's chunk at [cache_index[b], cache_index[b] +
    S) by scatter, along T of either layout (the JAX one-hot einsum and
    select, :277-300 and :346-355, is a TPU workaround for per-row dynamic
    indices)."""
    tbkd = layout == "tbkd"
    if isinstance(cache_index, int):
        for name, x in vals.items():             # x (B, Hkv, S[, D])
            if tbkd:
                kv_cache[name][li, cache_index:cache_index + S] = \
                    x.permute(2, 0, 1, 3)
            else:
                kv_cache[name][li, :, :, cache_index:cache_index + S] = x
        return
    B = vals["k"].shape[0]
    dev = vals["k"].device
    bidx = torch.arange(B, device=dev)[:, None]
    cols = cache_index.long()[:, None] + torch.arange(S, device=dev)
    for name, x in vals.items():                 # x (B, Hkv, S[, D])
        at = (li, cols, bidx) if tbkd else (li, bidx, slice(None), cols)
        kv_cache[name][at] = x.transpose(1, 2)


def _dequant(q, scale, dtype):
    """int8 cache values → `dtype` (the JAX `(q * s).astype(x.dtype)`)."""
    return (q.float() * scale[..., None]).to(dtype)


def _block(cfg: DecoderConfig, lp, ll, lora_scale, h, cos, sin,
           attn_lengths, bias, kv_cache, cache_index, li, prefix_kv=None,
           prefix_bias=None, run_bias=None, layout="bktd"):
    """One decoder layer: attention through K1 over `attn_lengths`, or
    through K6 over the whole cache (after the shared prefix's columns,
    when given) with `bias`; with `run_bias` (attn_impl "xla"), the plain
    function over `run_bias` or `bias`."""
    B, S, _ = h.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def proj(name, x_):
        lo = lora_at(ll.get(name)) if ll is not None else None
        return linear_lora(lp[name], lo, x_, lora_scale)

    xn = rms_norm(lp["input_ln"], h, cfg.rms_norm_eps)
    q = proj("q_proj", xn).view(B, S, H, D).transpose(1, 2)
    k = proj("k_proj", xn).view(B, S, Hkv, D).transpose(1, 2)
    v = proj("v_proj", xn).view(B, S, Hkv, D).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(lp["q_norm"], q, cfg.rms_norm_eps)
        k = rms_norm(lp["k_norm"], k, cfg.rms_norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if kv_cache is not None:
        quantized = "k_scale" in kv_cache
        if quantized:
            # int8 cache: quantize per (head, token), store values and
            # scales, attend over the dequantized cache — prefill sees
            # exactly what later decode steps read
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            vals = {"k": kq.to(torch.int8), "v": vq.to(torch.int8),
                    "k_scale": ks, "v_scale": vs}
        else:
            vals = {"k": k, "v": v}
        _write_columns(kv_cache, li, vals, cache_index, S, layout)
        # K1 reads back slots [0, S); K6 the whole width, seeded columns
        # [0, cache_index) included; a tbkd cache is read through a
        # (B, Hkv, T, D) view (JAX transposes, decoder.py:363-364)
        width = S if bias is None else cache_width(kv_cache, layout)
        if layout == "tbkd":
            k = kv_cache["k"][li, :width].permute(1, 2, 0, 3)
            v = kv_cache["v"][li, :width].permute(1, 2, 0, 3)
        else:
            k = kv_cache["k"][li, :, :, :width]
            v = kv_cache["v"][li, :, :, :width]
        if quantized:
            k = _dequant(k, kv_cache["k_scale"][li, :, :, :width], h.dtype)
            v = _dequant(v, kv_cache["v_scale"][li, :, :, :width], h.dtype)
    if prefix_kv is not None:
        # the batch-broadcast shared prefix's columns go first, in ONE
        # concatenation, so the softmax is that of a physically seeded
        # prefix; a tbkd prefix layer (Pc, 1, Hkv, D) is read through a
        # (1, Hkv, Pc, D) view (JAX transposes, decoder.py:241-250)
        pk, pv = prefix_kv["k"][li], prefix_kv["v"][li]
        if layout == "tbkd":
            pk, pv = pk.permute(1, 2, 0, 3), pv.permute(1, 2, 0, 3)
        if "k_scale" in prefix_kv:
            pk = _dequant(pk, prefix_kv["k_scale"][li], k.dtype)
            pv = _dequant(pv, prefix_kv["v_scale"][li], v.dtype)
        k = torch.cat([pk.to(k.dtype).expand(B, -1, -1, -1), k], dim=2)
        v = torch.cat([pv.to(v.dtype).expand(B, -1, -1, -1), v], dim=2)
        Pc = pk.shape[2]
        bias = torch.cat([prefix_bias.float().expand(B, 1, S, Pc),
                          bias.expand(B, 1, S, bias.shape[-1])], dim=-1)
    q = (q.float() * D ** -0.5).to(q.dtype)
    if run_bias is not None:
        rep = H // Hkv
        a = dot_product_attention(q, repeat_kv(k, rep), repeat_kv(v, rep),
                                  run_bias if bias is None else bias)
    elif bias is None:
        a = flash_attention_masked(q, k, v, *attn_lengths, causal=True)
    else:
        a = flash_attention_bias(q, k, v, bias)
    a = a.transpose(1, 2).reshape(B, S, H * D)
    h = h + proj("o_proj", a)
    return _mlp(cfg, lp, h, proj)


def decoder_forward(cfg: DecoderConfig, params, *, inputs_embeds, positions,
                    attn_lengths=None, bias=None, kv_cache=None,
                    cache_index=0, layers=None, lora=None,
                    lora_scale: float = 1.0, remat: bool = False,
                    prefix_kv=None, prefix_bias=None,
                    attn_impl: str = "auto", num_layers=None,
                    final_norm: bool = True, layout=None):
    """Causal forward over a whole sequence.  Exactly one of:
      * `attn_lengths` = (kv_start, kv_len) from `contiguous_lengths`:
        attention is K1 (K5 backward), causal on sequence index; with
        `kv_cache` each layer's k/v go to slots [0, S) and attention reads
        them back (the JAX prefill's cache_index=0 slab write);
      * `bias`, fp32 additive (B, 1|H, S|1, T), with `kv_cache` ({"k","v"}
        (L, B, Hkv, T, D)): each layer writes its k/v at [cache_index,
        cache_index + S) and attention is K6 over the cache's whole width
        T, so columns seeded before the call are attended too (the serving
        prefix install, prot2text_tpu/infer/serving.py:172-185).  A (B,)
        `cache_index` writes row b's chunk at its own columns (the bf16
        speculative verify, prot2text_tpu/infer/serving.py:503-515).
        `prefix_kv` ({"k","v"[, scales]} (L, 1, Hkv, Pc, D); beside a
        tbkd cache (L, Pc, 1, Hkv, D)) with `prefix_bias` (B, 1, 1, Pc)
        prepends the batch-broadcast shared prefix's columns to every
        layer's attention operand and bias.  The serving paths that take
        it run forward only.
    `layout` names the cache's layout ("bktd" (L, B, Hkv, T, D) or "tbkd"
    (L, T, B, Hkv, D)); None takes `resolve_layout`'s: tbkd for a dense
    cache of a head dim off the 128 grid.
    An int8 `kv_cache` ({"k","v","k_scale","v_scale"}, `init_kv_cache(
    kv_bits=8)`) stores each layer's k/v quantized per (head, token) and
    attends over its dequantized copy in the activations' dtype.
    `lora`: an optional LoRA tree over `params` (models/lora.py), applied
    as side paths scaled by `lora_scale`; `remat=True` recomputes each
    layer in the backward pass (training; not with a cache).
    `attn_impl` "auto" or "flash" takes the kernels above; "xla" takes the
    plain function (k/v repeated to H heads) over `bias`, or over
    `causal_run_bias` of `attn_lengths` (the JAX XLA route over
    `causal_bias_from_mask`).  `num_layers=N` runs only the first N layers
    (of `layers` when given) and `final_norm=False` skips the final
    RMSNorm: with both, h is HF's `hidden_states[N]` (the JAX overrides
    the contrastive text tower uses).  Returns (h, kv_cache)."""
    if (attn_lengths is None) == (bias is None):
        raise ValueError("pass exactly one of attn_lengths and bias")
    if remat and kv_cache is not None:
        raise ValueError("remat recomputes layers; it takes no kv_cache")
    if attn_lengths is not None and not (isinstance(cache_index, int)
                                         and cache_index == 0):
        raise ValueError("attn_lengths attends slots [0, S): it takes "
                         "cache_index 0")
    if kv_cache is not None:
        layout = resolve_layout(cfg, "k_scale" in kv_cache, layout)
    if bias is not None:
        if kv_cache is None:
            raise ValueError("bias attends a cache's columns: pass kv_cache")
        T = cache_width(kv_cache, layout)
        if bias.shape[-1] != T:
            raise ValueError(f"bias covers {bias.shape[-1]} key columns, "
                             f"the cache {T}")
    if prefix_kv is not None and (bias is None or prefix_bias is None):
        raise ValueError("prefix_kv requires bias and prefix_bias")
    if attn_impl not in IMPLS:
        raise ValueError(f"attn_impl must be one of {IMPLS}, got "
                         f"{attn_impl!r}")
    run_bias = None
    if attn_impl == "xla":
        run_bias = (bias if attn_lengths is None else causal_run_bias(
            *attn_lengths, inputs_embeds.shape[1]))
    cos, sin = decoder_rope_cos_sin(cfg, positions)
    if layers is None:
        layers = layer_views(params["layers"], cfg.num_layers)
    layers = layers[:num_layers]
    lora_layers = (layer_views(lora["layers"], len(layers))
                   if lora is not None else [None] * len(layers))
    h = inputs_embeds
    for li, (lp, ll) in enumerate(zip(layers, lora_layers)):
        args = (cfg, lp, ll, lora_scale, h, cos, sin, attn_lengths, bias,
                kv_cache, cache_index, li, prefix_kv, prefix_bias, run_bias,
                layout)
        if remat:
            # the block draws no random numbers: no RNG state to replay
            h = checkpoint(_block, *args, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = _block(*args)
    if not final_norm:
        return h, kv_cache
    return rms_norm(params["final_ln"], h, cfg.rms_norm_eps), kv_cache


def decoder_decode_step(cfg: DecoderConfig, params, *, token_embeds,
                        kv_mask, positions, kv_cache, cache_index,
                        layers=None, prefix_kv=None, prefix_bias=None,
                        layout=None):
    """One token per row.

    token_embeds (B, 1, H); kv_mask (B, T) int32 over ALREADY-written slots
    (the slot being written must still be 0 — the current token is the
    attention's extra column); positions (B, 1) rope positions.
    `cache_index` picks the route:
      * a host int (lockstep: every row writes that slot) → K4 per layer,
        which attends and writes the token's k/v into slot `cache_index`
        of that layer in place, on a bktd or a tbkd cache (`layout`, as in
        `decoder_forward`) alike.
        The write of layer li's slot follows every read of that layer's
        slab, and the slot is 0 in `kv_mask`, so it is never read in this
        step: the cache ends as JAX's tbkd step leaves it with K12 after
        the loop;
      * a (B,) integer tensor (per-row slots, continuous batching) → K4 per
        layer, which attends and writes row b's k/v into slot
        cache_index[b] of that layer in place.
    Either kind becomes one contiguous (B,) int32 tensor on the cache's
    device once a step (an int32 tensor there passes as it is), which every
    layer's kernel takes.  Either kind runs on a tbkd cache too (`layout`),
    at its strides, where JAX's tbkd step scatters the rows' slots after
    the loop (prot2text_tpu/models/decoder.py:1110-1122).
    `prefix_kv` ({"k","v"} (L, 1, Hkv, Pc, D); beside a tbkd cache the
    sequence-leading (L, Pc, 1, Hkv, D), JAX's `_pfx_cat` layout, :805-812),
    the batch-broadcast shared prefix, with `prefix_bias` (B, 1, 1, Pc)
    fp32 additive over its columns, routes either kind of slot through K9a
    at the cache's layout; the per-row prefix mask is `prefix_bias >=
    -1e30`, as in the JAX step.
    An int8 cache ("k_scale" in kv_cache) quantizes each layer's current
    k/v per head (`models/quant.quantize_kv`) and runs K7 per layer — K9b
    with an int8 prefix (which then carries its scales) — for either kind
    of slot: the kernel attends and writes the token's int8 values and
    scales in place (prot2text_tpu/models/decoder.py:861-930).  Returns
    (h (B, 1, H), kv_cache), the cache updated in place."""
    if prefix_kv is not None and prefix_bias is None:
        raise ValueError("prefix_kv requires prefix_bias")
    quantized = "k_scale" in kv_cache
    if quantized and prefix_kv is not None and "k_scale" not in prefix_kv:
        raise ValueError("an int8 cache takes an int8 prefix (with scales)")
    B = token_embeds.shape[0]
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rep = H // Hkv
    ck_all, cv_all = kv_cache["k"], kv_cache["v"]
    L = ck_all.shape[0]
    if layers is None:
        layers = layer_views(params["layers"], L)
    layout = resolve_layout(cfg, quantized, layout)
    if prefix_kv is not None:
        pmask = (prefix_bias[:, 0, 0, :] >= -1e30).to(torch.int32)
    cos, sin = decoder_rope_cos_sin(cfg, positions)        # (B, 1, D)
    scaling = D ** -0.5
    # one (B,) int32 slots tensor a step for every layer's kernel, not one
    # conversion a layer (a contiguous int32 tensor on the cache's device
    # passes as it is)
    slots = _slots(cache_index, B, ck_all.device)
    x = token_embeds
    for li, lp in enumerate(layers):
        xn = rms_norm(lp["input_ln"], x, cfg.rms_norm_eps)
        q = linear(lp["q_proj"], xn).reshape(B, H, D)
        k = linear(lp["k_proj"], xn).reshape(B, Hkv, D)
        v = linear(lp["v_proj"], xn).reshape(B, Hkv, D)
        if cfg.qk_norm:
            q = rms_norm(lp["q_norm"], q, cfg.rms_norm_eps)
            k = rms_norm(lp["k_norm"], k, cfg.rms_norm_eps)
        q = apply_rope(q[:, :, None, :], cos, sin).reshape(B, H, D)
        k = apply_rope(k.reshape(B, Hkv, 1, D), cos, sin).reshape(B, Hkv, D)
        q = (q.float() * scaling).to(q.dtype)
        qg = q.reshape(B, Hkv, rep, D).contiguous()
        if quantized:
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            qargs = (qg, ck_all, cv_all, kv_cache["k_scale"],
                     kv_cache["v_scale"], kv_mask, kq.contiguous(),
                     vq.contiguous(), ks.contiguous(), vs.contiguous(), li,
                     slots)
            if prefix_kv is not None:
                a = decode_attention_stacked_write_q_prefix(
                    *qargs, prefix_kv["k"], prefix_kv["v"],
                    prefix_kv["k_scale"], prefix_kv["v_scale"], pmask)
            else:
                a = decode_attention_stacked_write_q(*qargs)
        else:
            k, v = k.to(qg.dtype), v.to(qg.dtype)
            if prefix_kv is not None:
                a = decode_attention_stacked_write_prefix(
                    qg, ck_all, cv_all, kv_mask, k, v, li, slots,
                    prefix_kv["k"], prefix_kv["v"], pmask, layout=layout)
            else:
                a = decode_attention_stacked_write(
                    qg, ck_all, cv_all, kv_mask, k, v, li, slots,
                    layout=layout)
        x = x + linear(lp["o_proj"], a.to(x.dtype).reshape(B, 1, H * D))
        x = _mlp(cfg, lp, x)
    h = rms_norm(params["final_ln"], x, cfg.rms_norm_eps)
    return h, kv_cache


def supports_verify_chunk_step(cfg: DecoderConfig, kv_cache, G: int) -> bool:
    """Eligibility of the fused chunk-verify path (`decoder_verify_chunk`):
    an int8 cache, a head dim the kernels take, G <= 32 chunk tokens of at
    most 256 query rows, and T a multiple of 32 with room for the TPU
    rule's 64 scratch columns (prot2text_tpu/models/decoder.py:1153-1206,
    single-device part; its mesh and VMEM checks are TPU-only)."""
    T = kv_cache["k"].shape[3]
    rep = cfg.num_heads // cfg.num_kv_heads
    return ("k_scale" in kv_cache and cfg.head_dim in HEAD_DIMS
            and 1 <= G <= MAX_CHUNK and G * rep <= MAX_ROWS
            and T % 32 == 0 and T >= 64)


def decoder_verify_chunk(cfg: DecoderConfig, params, *, token_embeds,
                         kv_mask, positions, kv_cache, cache_index,
                         layers=None, prefix_kv=None, prefix_bias=None):
    """Fused G-token chunk verify for speculative serving over an int8
    cache (prot2text_tpu/models/decoder.py:1209-1398): token_embeds
    (B, G, H); kv_mask (B, T) over already-written columns (the chunk's own
    must be 0); positions (B, G); cache_index (B,) chunk starts.  Per
    layer, the chunk's k/v are quantized and K8 (K9c with the int8
    `prefix_kv` and `prefix_bias`) attends [prefix ‖ cache ‖ causal chunk]
    for all G·rep query rows (row g·rep + r) and writes the chunk's G int8
    rows and scales in place.  Callers gate on
    `supports_verify_chunk_step`.  Returns (h (B, G, H), kv_cache)."""
    if prefix_kv is not None and prefix_bias is None:
        raise ValueError("prefix_kv requires prefix_bias")
    B, G, _ = token_embeds.shape
    if not supports_verify_chunk_step(cfg, kv_cache, G):
        raise ValueError("decoder_verify_chunk needs an int8 cache the "
                         "chunk-verify kernels take (supports_verify_chunk_"
                         "step)")
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rep = H // Hkv
    if layers is None:
        layers = layer_views(params["layers"], cfg.num_layers)
    # one (B,) int32 tensor of chunk starts a call for every layer's kernel,
    # and its largest start, read once per call for every layer's bound
    # check (one device→host read instead of one per layer)
    slots = _slots(torch.as_tensor(cache_index), B, kv_cache["k"].device)
    slots_max = int(slots.max())
    if prefix_kv is not None:
        pmask = (prefix_bias[:, 0, 0, :] >= -1e30).to(torch.int32)
        pargs = (prefix_kv["k"], prefix_kv["v"], prefix_kv["k_scale"],
                 prefix_kv["v_scale"], pmask)
    cos, sin = decoder_rope_cos_sin(cfg, positions)        # (B, G, D)
    scaling = D ** -0.5
    x = token_embeds
    for li, lp in enumerate(layers):
        xn = rms_norm(lp["input_ln"], x, cfg.rms_norm_eps)
        q = linear(lp["q_proj"], xn).reshape(B, G, H, D)
        k = linear(lp["k_proj"], xn).reshape(B, G, Hkv, D)
        v = linear(lp["v_proj"], xn).reshape(B, G, Hkv, D)
        if cfg.qk_norm:
            q = rms_norm(lp["q_norm"], q, cfg.rms_norm_eps)
            k = rms_norm(lp["k_norm"], k, cfg.rms_norm_eps)
        q = apply_rope(q.transpose(1, 2), cos, sin)        # (B, H, G, D)
        k = apply_rope(k.transpose(1, 2), cos, sin)        # (B, Hkv, G, D)
        q = (q.float() * scaling).to(q.dtype)
        # kernel row order g·rep + r: (B, H, G, D) → (B, Hkv, G·rep, D)
        qg = q.reshape(B, Hkv, rep, G, D).transpose(2, 3).reshape(
            B, Hkv, G * rep, D).contiguous()
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v.transpose(1, 2))
        qargs = (qg, kv_cache["k"], kv_cache["v"], kv_cache["k_scale"],
                 kv_cache["v_scale"], kv_mask, kq.contiguous(),
                 vq.contiguous(), ks.contiguous(), vs.contiguous(), li,
                 slots)
        if prefix_kv is not None:
            a = decode_attention_stacked_verify_qc_prefix(
                *qargs, *pargs, slots_max=slots_max)
        else:
            a = decode_attention_stacked_verify_qc(*qargs,
                                                   slots_max=slots_max)
        a = a.reshape(B, Hkv, G, rep, D).transpose(1, 2).reshape(
            B, G, H * D)
        x = x + linear(lp["o_proj"], a.to(x.dtype))
        x = _mlp(cfg, lp, x)
    h = rms_norm(params["final_ln"], x, cfg.rms_norm_eps)
    return h, kv_cache


class _MatmulF32Out(torch.autograd.Function):
    """x @ w with an fp32 result from bf16 operands on CUDA: cuBLAS's
    fp32-output GEMM (`torch.mm(..., out_dtype=torch.float32)`), so the bf16
    weight is never upcast in memory.  `mm.dtype` has no derivative in
    torch 2.11, so the backward is written out: dX = dY·Wᵀ with dY rounded
    to x's dtype.  The weight (a frozen head) gets no gradient."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(w)
        lead = x.shape[:-1]
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*lead, y.shape[-1])

    @staticmethod
    def backward(ctx, dy):
        (w,) = ctx.saved_tensors
        return torch.matmul(dy.to(w.dtype), w.t()), None


def matmul_f32_out(x, w):
    """x @ w with an fp32 result from bf16/f32 operands — the JAX
    `preferred_element_type=jnp.float32` head.  CUDA bf16: `_MatmulF32Out`
    (w must be frozen); CPU or f32: the operands are upcast."""
    if x.dtype == torch.float32 or not x.is_cuda:
        return torch.matmul(x.float(), w.float())
    if w.requires_grad:
        raise ValueError("the bf16 fp32-output head trains only its input; "
                         "its weight must be frozen")
    return _MatmulF32Out.apply(x, w.to(x.dtype))


def decoder_logits(cfg: DecoderConfig, params, hidden_states):
    if cfg.tie_word_embeddings:
        w = params["embed_tokens"].T
    elif "kernel" not in params["lm_head"]:
        # the quantized head (K10/K11/K14 at few rows): fp32 logits of an
        # output rounded to the activations' dtype, as JAX's `linear(...)
        # .astype(float32)` (prot2text_tpu/models/decoder.py:1404-1421)
        return linear(params["lm_head"], hidden_states).float()
    else:
        w = params["lm_head"]["kernel"]
    return matmul_f32_out(hidden_states, w.to(hidden_states.dtype))


def cross_entropy_loss(logits, labels, ignore_index: int = -100):
    """Shifted causal LM loss, mean over valid label positions."""
    logits = logits[:, :-1].float()
    labels = labels[:, 1:]
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, safe[..., None].long())[..., 0]
    ll = torch.where(valid, ll, 0.0)
    return -(ll.sum() / valid.sum().clamp(min=1))
