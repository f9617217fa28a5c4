"""Batched autoregressive generation with a preallocated KV cache
(counterpart of prot2text_tpu/infer/generate.py).

HF-parity details as in the JAX package: left-padded prompts, rope
positions clip(cumsum(attention_mask) - 1, 0), decode positions last_pos +
t, tokens after EOS are pad, greedy = argmax over fp32 logits, sampling
applies temperature → top-k → top-p.

The decode loop is a host-driven Python loop: one prefill (K1 inside), then
one `decoder_decode_step` per token (K4 per layer, which attends and writes
the token's k/v into the step's slot of that layer, at the tbkd strides on
the cache of a head dim off the 128 grid; K7 per layer on an int8 cache)
and one host sync per token for the all-finished check.  The slot written
at step t is still 0 in `kv_mask` while the attention runs; it is set
afterwards.  `run_generation` sends beams to `infer/beam_search.py` and
prompt lookup to `infer/speculative.py`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..models.decoder import (
    DecoderConfig, contiguous_lengths, decoder_decode_step, decoder_forward,
    decoder_logits, layer_views,
)
from .kvcache import init_kv_cache


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 256
    eos_token_id: int = 128009
    pad_token_id: int = 128002
    do_sample: bool = False
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    num_beams: int = 1
    length_penalty: float = 1.0
    early_stopping: bool = False
    prompt_lookup_tokens: int = 0
    prompt_lookup_ngram: int = 2


def resolve_generation_config(eos_token_id, pad_token_id,
                              gen_kwargs: dict) -> GenerationConfig:
    """`generation_config=GenerationConfig(...)` (flat kwargs override its
    fields) or flat kwargs merged over the model's eos/pad defaults."""
    base = gen_kwargs.pop("generation_config", None)
    if base is not None:
        return dataclasses.replace(base, **gen_kwargs) if gen_kwargs else base
    return GenerationConfig(**{"eos_token_id": eos_token_id,
                               "pad_token_id": pad_token_id, **gen_kwargs})


def filter_logits(logits, gen_cfg: GenerationConfig):
    """HF warper order — temperature, top-k, top-p.  logits: (B, V) fp32."""
    logits = logits / max(gen_cfg.temperature, 1e-6)
    if gen_cfg.top_k is not None and gen_cfg.top_k > 0:
        kth = torch.topk(logits, gen_cfg.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if gen_cfg.top_p is not None and gen_cfg.top_p < 1.0:
        # HF TopPLogitsWarper: stable ascending sort, drop the tokens whose
        # ascending cumulative mass <= 1 - top_p, always keep the top-1
        sorted_logits, sort_idx = torch.sort(logits, dim=-1, stable=True)
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        remove_sorted = cum <= (1.0 - gen_cfg.top_p)
        remove_sorted[:, -1] = False
        remove = torch.zeros_like(remove_sorted).scatter(
            -1, sort_idx, remove_sorted)
        logits = torch.where(remove, -torch.inf, logits)
    return logits


def _sample_token(logits, gen_cfg: GenerationConfig, generator):
    """(B, V) fp32 → (B,) int64."""
    if not gen_cfg.do_sample:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits, gen_cfg), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def run_generation(cfg, params, *, inputs_embeds, attention_mask, gen_cfg,
                   generator=None, cache_dtype=None, kv_bits=None,
                   stats=None, attn_impl: str = "auto", prompt_ids=None,
                   prompt_ids_mask=None):
    """Dispatch as JAX does (prot2text_tpu/infer/generate.py:116-160):
    `gen_cfg.num_beams > 1` → `beam_search.beam_search` (bf16 or f32 cache
    only), `gen_cfg.prompt_lookup_tokens > 0` → `speculative.
    prompt_lookup_generate` (greedy only; it drafts from `prompt_ids`/
    `prompt_ids_mask`, the text prompt's ids), else `generate`.  `stats`
    is passed on to whichever runs."""
    if kv_bits is not None and gen_cfg.num_beams > 1:
        raise ValueError("kv_bits quantized KV cache does not support "
                         "beam search")
    if gen_cfg.num_beams > 1:
        from .beam_search import beam_search

        return beam_search(
            cfg, params, inputs_embeds=inputs_embeds,
            attention_mask=attention_mask, gen_cfg=gen_cfg,
            attn_impl=attn_impl, cache_dtype=cache_dtype, generator=generator, stats=stats)
    if gen_cfg.prompt_lookup_tokens > 0:
        if gen_cfg.do_sample:
            raise ValueError("prompt_lookup_tokens is greedy-only "
                             "(speculative decoding)")
        from .speculative import prompt_lookup_generate

        toks, _ = prompt_lookup_generate(
            cfg, params, inputs_embeds=inputs_embeds,
            attention_mask=attention_mask, gen_cfg=gen_cfg,
            prompt_ids=prompt_ids, prompt_ids_mask=prompt_ids_mask,
            gamma=gen_cfg.prompt_lookup_tokens,
            ngram=gen_cfg.prompt_lookup_ngram, attn_impl=attn_impl,
            cache_dtype=cache_dtype, kv_bits=kv_bits, stats=stats)
        return toks
    return generate(cfg, params, inputs_embeds=inputs_embeds,
                    attention_mask=attention_mask, gen_cfg=gen_cfg,
                    generator=generator, cache_dtype=cache_dtype,
                    kv_bits=kv_bits, stats=stats, attn_impl=attn_impl)


@torch.no_grad()
def generate(cfg: DecoderConfig, params, *, inputs_embeds, attention_mask,
             gen_cfg: GenerationConfig, generator=None, cache_dtype=None,
             kv_bits=None, stats: Optional[dict] = None,
             attn_impl: str = "auto"):
    """inputs_embeds (B, P, H) left-padded prompt embeddings, attention_mask
    (B, P) → (B, max_new_tokens) int64, pad-filled after EOS.  kv_bits=8
    keeps the cache in int8 with per-(head, token) scales (its width
    rounded up to a multiple of 32, as in the JAX package): the prefill
    quantizes into it and every decode step runs K7 with the scalar slot.
    `attn_impl` routes the prefill's attention as `decoder_forward` does
    ("auto"/"flash": K1; "xla": the plain function), as JAX's prefill
    takes the caller's route; the decode step has one route per cache.

    `stats`, when given, is filled with "prefill_s" and "decode_s" (host
    seconds, each ended by a device synchronize), "steps" (decode steps
    run), "logits_finite" (every step's logits finite) and "logits" (the
    prefill and first decode-step logits).  Without it nothing syncs beyond
    the per-token stop check."""
    B, P, _ = inputs_embeds.shape
    N = gen_cfg.max_new_tokens
    T = P + N
    if kv_bits is not None:
        T = -(-T // 32) * 32
    dev = inputs_embeds.device
    if stats is not None:
        _sync(dev)
    t_start = time.perf_counter()
    dtype = cache_dtype or inputs_embeds.dtype
    if gen_cfg.do_sample and generator is None:
        raise ValueError("sampling needs a torch.Generator")

    attention_mask = attention_mask.to(torch.int32)
    positions = (torch.cumsum(attention_mask, dim=1) - 1).clamp(min=0)
    last_pos = positions[:, -1]
    layers = layer_views(params["layers"], cfg.num_layers)

    cache = init_kv_cache(cfg, B, T, device=dev, dtype=dtype, kv_bits=kv_bits)
    h, cache = decoder_forward(
        cfg, params, inputs_embeds=inputs_embeds.to(dtype),
        positions=positions, attn_lengths=contiguous_lengths(attention_mask),
        kv_cache=cache, layers=layers, attn_impl=attn_impl)
    logits = decoder_logits(cfg, params, h[:, -1:])[:, 0]
    tok = _sample_token(logits, gen_cfg, generator)
    finished = tok == gen_cfg.eos_token_id

    tokens = torch.full((B, N), gen_cfg.pad_token_id, dtype=torch.int64,
                        device=dev)
    tokens[:, 0] = tok
    kv_mask = torch.zeros((B, T), dtype=torch.int32, device=dev)
    kv_mask[:, :P] = attention_mask
    embed = params["embed_tokens"]
    # a finished row feeds its pad id back, which may lie past the
    # vocabulary (the legacy model's 128002 in a test-sized one): JAX's
    # gather clamps it, and the row's outputs are pad either way
    top_id = embed.shape[0] - 1
    if stats is not None:
        kept = [logits.clone()]
        finite = torch.isfinite(logits).all()
        _sync(dev)
        t_prefill = time.perf_counter()
    steps = 0
    for t in range(1, N):
        if bool(finished.all()):
            break
        emb = embed[tokens[:, t - 1].clamp(max=top_id)][:, None, :].to(dtype)
        h, cache = decoder_decode_step(
            cfg, params, token_embeds=emb, kv_mask=kv_mask,
            positions=(last_pos + t)[:, None], kv_cache=cache,
            cache_index=P + t - 1, layers=layers)
        kv_mask[:, P + t - 1] = 1
        logits = decoder_logits(cfg, params, h)[:, 0]
        tok = _sample_token(logits, gen_cfg, generator)
        tok = torch.where(finished, gen_cfg.pad_token_id, tok)
        tokens[:, t] = tok
        finished = finished | (tok == gen_cfg.eos_token_id)
        steps += 1
        if stats is not None:
            if len(kept) < 2:
                kept.append(logits.clone())
            finite = finite & torch.isfinite(logits).all()
    if stats is not None:
        _sync(dev)
        stats.update(prefill_s=t_prefill - t_start,
                     decode_s=time.perf_counter() - t_prefill, steps=steps,
                     logits_finite=bool(finite), logits=kept)
    return tokens


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def decode_steps_taken(tokens, eos_token_id: int) -> int:
    """Decode steps `generate` ran for these output tokens: it stops after
    the step in which the last row emitted its first EOS (or after
    max_new_tokens - 1 steps)."""
    N = tokens.shape[1]
    is_eos = tokens == eos_token_id
    first = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1),
                        torch.full_like(tokens[:, 0], N))
    return int(min(N - 1, int(first.max())))
