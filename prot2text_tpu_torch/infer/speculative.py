"""Lockstep greedy speculative decoding (counterpart of
prot2text_tpu/infer/speculative.py): a draft proposes `gamma` tokens, the
target verifies the G = gamma + 1 token chunk [last token, drafts...] in
one forward, and every row keeps the longest draft prefix equal to the
target's argmax plus the target's own next token.  The output is that of
plain greedy decoding of the target for ANY draft; a better draft only
takes fewer target forwards.  Three draft sources:
  * `speculative_generate`: a second decoder (its own prefill and cache);
  * `self_speculative_generate`: the target's first N layers with its
    final norm and head;
  * `prompt_lookup_generate`: n-gram lookup over the text prompt's ids and
    the generated tokens (`serving.ngram_drafts`), no model.

Rows advance in LOCKSTEP by the batch-minimum accepted count (finished
rows do not hold the batch back), so every cache write is one slab at a
host-int slot: the prefill is K1 (`attn_lengths`), each draft step K4 a
layer, the verify K6 over the cache's whole width (`decoder_forward` with
the chunk's bias) or, on an int8 cache that the chunk kernels take, K8
(`decoder_verify_chunk`).

JAX decides the next chunk start on the device (`lax.while_loop`).  Here
the loop runs on the host, because K4 and K6 take the slot as a host int:
each round ends with ONE device→host read of the accepted count and the
all-finished flag.  Rejected drafts leave stale k/v past the accepted
point; `kv_mask` never marks them valid and the next round's chunk
overwrites them.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..models.decoder import (
    DecoderConfig, contiguous_lengths, decoder_decode_step, decoder_forward,
    decoder_logits, decoder_verify_chunk, layer_views,
    supports_verify_chunk_step,
)
from .generate import GenerationConfig, _sync
from .kvcache import init_kv_cache
from .serving import ngram_drafts


def _chunk_bias(kv_mask, G: int, chunk_start: int):
    """(B, 1, G, T) fp32 additive bias: the already-written slots of
    `kv_mask` (B, T), and causal within the G-token chunk that occupies
    slots [chunk_start, chunk_start + G)."""
    T = kv_mask.shape[1]
    dev = kv_mask.device
    cols = torch.arange(T, device=dev)[None, :]
    rows = torch.arange(G, device=dev)[:, None]
    in_chunk = (cols >= chunk_start) & (cols <= chunk_start + rows)  # (G, T)
    ok = kv_mask.bool()[:, None, None, :] | in_chunk[None, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return torch.where(ok, zero,
                       torch.full_like(zero, torch.finfo(torch.float32).min))


class _Run:
    """What one call's rounds share: the model, the slot budget and the
    prompt's rope positions."""

    def __init__(self, cfg: DecoderConfig, params, inputs_embeds,
                 attention_mask, gen_cfg: GenerationConfig, T: int,
                 cache_dtype, attn_impl: str):
        self.cfg, self.params = cfg, params
        self.B, self.P, _ = inputs_embeds.shape
        self.T, self.attn_impl = T, attn_impl
        self.dtype = cache_dtype or inputs_embeds.dtype
        self.dev = inputs_embeds.device
        self.mask = attention_mask.to(torch.int32)
        positions = (torch.cumsum(self.mask, dim=1) - 1).clamp(min=0)
        self.positions, self.last_pos = positions, positions[:, -1]
        self.eos, self.pad = gen_cfg.eos_token_id, gen_cfg.pad_token_id
        self.layers = layer_views(params["layers"], cfg.num_layers)

    def prefill(self, cfg, params, emb, layers, kv_bits=None):
        """The prompt through K1 into a fresh cache of width T → (prefill
        logits (B, V) fp32, cache)."""
        cache = init_kv_cache(cfg, self.B, self.T, device=self.dev,
                              dtype=self.dtype, kv_bits=kv_bits)
        h, cache = decoder_forward(
            cfg, params, inputs_embeds=emb.to(self.dtype),
            positions=self.positions,
            attn_lengths=contiguous_lengths(self.mask), kv_cache=cache,
            layers=layers, attn_impl=self.attn_impl)
        return decoder_logits(cfg, params, h[:, -1:])[:, 0], cache


def _embed(params, tok, dtype):
    """Token ids → (..., H) embeddings; ids past the table (a pad id outside
    a test-sized vocabulary) take its last row, as JAX's clamping gather."""
    table = params["embed_tokens"]
    return table[tok.clamp(max=table.shape[0] - 1)].to(dtype)


def _verify_accept(run: _Run, *, tokens, cache, kv_mask, finished, prev,
                   drafts, t: int, base: int, gamma: int,
                   fused_ok: bool = False):
    """One target forward over the chunk [prev, drafts...] at slots [base,
    base + G), then the exact greedy acceptance rule with its EOS/pad
    bookkeeping (prot2text_tpu/infer/speculative.py:58-134).  Updates
    `tokens` (B, NEW + G) and `kv_mask` in place; returns (finished, a,
    done): `a` (0..gamma) the batch-minimum accepted-draft count and
    `done` whether every row has finished, both read in one transfer.

    `fused_ok` is the caller's proof that every chunk start leaves the
    int8 kernels' 64 scratch columns (T - 64 >= P + NEW)."""
    cfg, params = run.cfg, run.params
    B, G = drafts.shape[0], gamma + 1
    dev = drafts.device
    chunk = torch.cat([prev[:, None], drafts], dim=1)             # (B, G)
    emb = _embed(params, chunk, run.dtype)
    # token t - 1 sits at rope position last_pos + t
    pos = (run.last_pos + t)[:, None] + torch.arange(G, device=dev)
    if (fused_ok and "k_scale" in cache
            and supports_verify_chunk_step(cfg, cache, G)):
        h, cache = decoder_verify_chunk(
            cfg, params, token_embeds=emb, kv_mask=kv_mask, positions=pos,
            kv_cache=cache, cache_index=base, layers=run.layers)
    else:
        h, cache = decoder_forward(
            cfg, params, inputs_embeds=emb, positions=pos,
            bias=_chunk_bias(kv_mask, G, base), kv_cache=cache,
            cache_index=base, layers=run.layers, attn_impl=run.attn_impl)
    greedy = torch.argmax(decoder_logits(cfg, params, h), dim=-1)  # (B, G)

    match = (drafts == greedy[:, :gamma]).to(torch.int32)
    acc = torch.cumprod(match, dim=1).sum(dim=1)
    acc = torch.where(finished, gamma, acc)
    a = acc.min()                                                  # 0-dim
    ar = torch.arange(G, device=dev)[None, :]
    bonus = greedy.gather(1, a.expand(B)[:, None])
    out = torch.cat([drafts, greedy[:, -1:]], dim=1)
    out = torch.where(ar == a, bonus, out)
    keep = ar <= a
    eos_hit = keep & (out == run.eos)
    after_eos = (torch.cumsum(eos_hit.to(torch.int32), dim=1)
                 - eos_hit.to(torch.int32)) > 0
    emit = torch.where(~keep | finished[:, None] | after_eos, run.pad, out)
    tokens[:, t:t + G] = emit
    finished = finished | eos_hit.any(dim=1)
    slot = torch.arange(kv_mask.shape[1], device=dev)[None, :]
    kv_mask.masked_fill_((slot >= base) & (slot <= base + a), 1)
    a_host, done = torch.stack([a, finished.all().to(a.dtype)]).tolist()
    return finished, int(a_host), bool(done)


def _start(run: _Run, logits0, NEW: int, G: int, stats, t_start):
    """tokens (B, NEW + G) with the prefill's greedy token in column 0, the
    finished rows and the all-finished flag (one read)."""
    tok0 = torch.argmax(logits0, dim=-1)
    tokens = torch.full((run.B, NEW + G), run.pad, dtype=torch.int64,
                        device=run.dev)
    tokens[:, 0] = tok0
    finished = tok0 == run.eos
    if stats is not None:
        stats["logits"] = [logits0.clone()]
        _sync(run.dev)
        stats["prefill_s"] = time.perf_counter() - t_start
    return tokens, finished, bool(finished.all())


def _finish(run: _Run, stats, t_prefill, rounds: int, accepted: int):
    if stats is not None:
        _sync(run.dev)
        stats.update(decode_s=time.perf_counter() - t_prefill,
                     rounds=rounds, accepted=accepted,
                     n_target_forwards=rounds + 1)


@torch.no_grad()
def speculative_generate(target_cfg: DecoderConfig, target_params,
                         draft_cfg: DecoderConfig, draft_params, *,
                         inputs_embeds, draft_inputs_embeds, attention_mask,
                         gen_cfg: GenerationConfig, gamma: int = 4,
                         attn_impl: str = "auto", cache_dtype=None,
                         draft_num_layers: Optional[int] = None,
                         stats: Optional[dict] = None):
    """inputs_embeds (B, P, H) left-padded target prompt embeddings,
    draft_inputs_embeds (B, P, H_draft) the same prompt in the draft's
    embedding, attention_mask (B, P) → (tokens (B, max_new_tokens) int64,
    n_target_forwards: the prefill and one per verify round).  Greedy only.

    Each round the draft runs gamma + 1 decode steps (K4 a layer) from the
    last accepted token: the first consumes that token, which the draft
    has not seen, and the last writes the k/v of the last draft, which
    stays in the draft's context when every draft is accepted; then the
    target verifies.  `draft_num_layers=N` drafts with the target's own
    first N layers, its final norm and head (`self_speculative_generate`).

    `stats`, when given, gets "prefill_s" and "decode_s" (host seconds,
    each ended by a device synchronize), "rounds" (verify rounds),
    "accepted" (draft tokens accepted, summed over rounds),
    "n_target_forwards" and "logits" (the target's prefill logits)."""
    run = _Run(target_cfg, target_params, inputs_embeds, attention_mask,
               gen_cfg, inputs_embeds.shape[1] + gen_cfg.max_new_tokens
               + gamma + 1, cache_dtype, attn_impl)
    B, P, NEW, G = run.B, run.P, gen_cfg.max_new_tokens, gamma + 1
    if stats is not None:
        _sync(run.dev)
    t_start = time.perf_counter()
    logits0, tgt_cache = run.prefill(target_cfg, target_params,
                                     inputs_embeds, run.layers)
    if draft_num_layers is not None:
        # the first N layers of the target's prompt cache ARE the draft's
        # prefill (same weights, same inputs).  JAX slices them into a new
        # array; a slice here is a view, and K4 writes its slot in place,
        # so the draft steps and the verify would write one buffer: copy
        drf_layers = run.layers[:draft_num_layers]
        drf_cache = {k: v[:draft_num_layers].clone()
                     for k, v in tgt_cache.items()}
    else:
        drf_layers = layer_views(draft_params["layers"],
                                 draft_cfg.num_layers)
        _, drf_cache = run.prefill(draft_cfg, draft_params,
                                   draft_inputs_embeds, drf_layers)
    tokens, finished, done = _start(run, logits0, NEW, G, stats, t_start)
    kv_mask = torch.zeros((B, run.T), dtype=torch.int32, device=run.dev)
    kv_mask[:, :P] = run.mask
    t_prefill = time.perf_counter()
    t, rounds, accepted = 1, 0, 0
    while t < NEW and not done:
        base = P + t - 1            # slot of token t - 1, written this round
        pos_base = run.last_pos + t
        prev = d = tokens[:, t - 1]
        drafts = torch.empty((B, gamma), dtype=torch.int64, device=run.dev)
        kv_d = kv_mask.clone()
        for j in range(G):
            h, drf_cache = decoder_decode_step(
                draft_cfg, draft_params,
                token_embeds=_embed(draft_params, d, run.dtype)[:, None],
                kv_mask=kv_d, positions=(pos_base + j)[:, None],
                kv_cache=drf_cache, cache_index=base + j, layers=drf_layers)
            kv_d[:, base + j] = 1
            if j < gamma:           # the last step only writes its k/v
                d = torch.argmax(decoder_logits(draft_cfg, draft_params,
                                                h)[:, 0], dim=-1)
                drafts[:, j] = d
        finished, a, done = _verify_accept(
            run, tokens=tokens, cache=tgt_cache, kv_mask=kv_mask,
            finished=finished, prev=prev, drafts=drafts, t=t, base=base,
            gamma=gamma)
        t += 1 + a
        rounds += 1
        accepted += a
    _finish(run, stats, t_prefill, rounds, accepted)
    return tokens[:, :NEW], rounds + 1


def self_speculative_generate(cfg: DecoderConfig, params, *, inputs_embeds,
                              attention_mask, gen_cfg: GenerationConfig,
                              draft_layers: int, gamma: int = 4,
                              attn_impl: str = "auto", cache_dtype=None,
                              stats: Optional[dict] = None):
    """Self-speculative (early-exit) decoding: the draft is the target's own
    first `draft_layers` layers with its final norm and head, no second
    model (prot2text_tpu/infer/speculative.py:274-310).  Returns (tokens
    (B, max_new_tokens), n_target_forwards)."""
    if not 0 < draft_layers < cfg.num_layers:
        raise ValueError("draft_layers must be in (0, num_layers)")
    return speculative_generate(
        cfg, params, cfg, params, inputs_embeds=inputs_embeds,
        draft_inputs_embeds=inputs_embeds, attention_mask=attention_mask,
        gen_cfg=gen_cfg, gamma=gamma, attn_impl=attn_impl,
        cache_dtype=cache_dtype, draft_num_layers=draft_layers, stats=stats)


@torch.no_grad()
def prompt_lookup_generate(cfg: DecoderConfig, params, *, inputs_embeds,
                           attention_mask, gen_cfg: GenerationConfig,
                           prompt_ids=None, prompt_ids_mask=None,
                           gamma: int = 4, ngram: int = 2,
                           attn_impl: str = "auto", cache_dtype=None,
                           kv_bits=None, stats: Optional[dict] = None):
    """Prompt-lookup (n-gram) speculative decoding, HF's
    `generate(prompt_lookup_num_tokens=...)`: each round every row drafts
    `gamma` tokens by chasing its latest `ngram`-gram match in its history
    (the valid `prompt_ids`, -1 elsewhere, then the generated tokens; the
    protein span has no ids and never matches) and the target verifies
    them.  Rows with no match draft pad and advance by the bonus token.
    kv_bits=8 keeps the cache in int8, sized as JAX sizes it for the fused
    verify (T a multiple of 32 with 64 scratch columns past the last chunk
    start), so each verify is K8 where the kernels take the chunk.
    Returns (tokens (B, max_new_tokens), n_target_forwards); `stats` as in
    `speculative_generate`."""
    B, P, _ = inputs_embeds.shape
    NEW, G = gen_cfg.max_new_tokens, gamma + 1
    T = P + NEW + G
    fused_ok = False
    if kv_bits is not None:
        T = -(-(P + NEW + max(G, 64)) // 32) * 32
        fused_ok = T - 64 >= P + NEW
    run = _Run(cfg, params, inputs_embeds, attention_mask, gen_cfg, T,
               cache_dtype, attn_impl)
    if stats is not None:
        _sync(run.dev)
    t_start = time.perf_counter()
    logits0, cache = run.prefill(cfg, params, inputs_embeds, run.layers,
                                 kv_bits=kv_bits)
    tokens, finished, done = _start(run, logits0, NEW, G, stats, t_start)
    kv_mask = torch.zeros((B, T), dtype=torch.int32, device=run.dev)
    kv_mask[:, :P] = run.mask
    if prompt_ids is None:
        hist_prompt = torch.zeros((B, 0), dtype=torch.int64, device=run.dev)
    else:
        prompt_ids = prompt_ids.to(run.dev, torch.int64)
        valid = (torch.ones_like(prompt_ids) if prompt_ids_mask is None
                 else prompt_ids_mask.to(run.dev))
        hist_prompt = torch.where(valid > 0, prompt_ids, -1)
    Pp = hist_prompt.shape[1]
    gen_cols = torch.arange(NEW + G, device=run.dev)[None, :]
    t_prefill = time.perf_counter()
    t, rounds, accepted = 1, 0, 0
    while t < NEW and not done:
        base = P + t - 1
        hist = torch.cat([hist_prompt,
                          torch.where(gen_cols < t, tokens, -1)], dim=1)
        drafts = ngram_drafts(
            hist, torch.full((B,), Pp + t, dtype=torch.int64,
                             device=run.dev),
            gamma=gamma, ngram=ngram, fallback=run.pad)
        finished, a, done = _verify_accept(
            run, tokens=tokens, cache=cache, kv_mask=kv_mask,
            finished=finished, prev=tokens[:, t - 1], drafts=drafts, t=t,
            base=base, gamma=gamma, fused_ok=fused_ok)
        t += 1 + a
        rounds += 1
        accepted += a
    _finish(run, stats, t_prefill, rounds, accepted)
    return tokens[:, :NEW], rounds + 1
