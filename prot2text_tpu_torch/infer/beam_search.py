"""Beam search over a preallocated KV cache (counterpart of
prot2text_tpu/infer/beam_search.py; the reference's `--num_beams`, HF
GenerationMixin).

  * the prompt is prefilled once at batch B (K1), then the cache is
    expanded to B·K rows on its batch axis (`kvcache.batch_axis`);
  * each step is one `decoder_decode_step` at B·K rows with the host-int
    slot (K4 a layer), then the top-2K candidates split into the best K
    non-EOS ones (alive) and the EOS ones folded into the finished pool;
  * HF scoring: a finished hypothesis scores sum(logp) / len**length_penalty
    with len the tokens before its EOS; `early_stopping` stops a row once
    K hypotheses are banked, and the whole decode once every row is done;
    at the end the best alive beam (at full length) competes with the best
    finished one;
  * beam-sample (`do_sample`) warps each beam's log-probs before the beam
    scores are added and draws the candidates without replacement by
    Gumbel-top-k, its noise from the caller's `torch.Generator`.

The cache follows the alive beams by one gather of its batch axis a step,
in 8-byte words, into a second preallocated buffer that then swaps with
the first (JAX gathers into a new array every step).  Without
`early_stopping` the loop reads nothing back from the device; with it,
one flag a step.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..models.decoder import (
    DecoderConfig, contiguous_lengths, decoder_decode_step, decoder_forward,
    decoder_logits, layer_views,
)
from .generate import GenerationConfig, _sync, filter_logits
from .kvcache import batch_axis, init_kv_cache

NEG_INF = -1.0e7


def _warp_rows(logp, gen_cfg: GenerationConfig):
    """Beam-sample warping (temperature → top-k → top-p) of each beam's
    (B·K, V) log-softmax row before the beam scores are added, HF's
    placement; greedy beams as they are."""
    return filter_logits(logp, gen_cfg) if gen_cfg.do_sample else logp


def _select_candidates(cand, n: int, gen_cfg: GenerationConfig, generator):
    """Top-n of the (B, K, V) accumulated scores → ((B, n) scores, flat K·V
    ids).  Beam-sample draws the n without replacement from the softmax of
    the flat scores (Gumbel-top-k) and keeps their accumulated scores."""
    B, K, V = cand.shape
    flat = cand.reshape(B, K * V)
    if not gen_cfg.do_sample:
        return torch.topk(flat, n, dim=1)
    u = torch.rand(flat.shape, generator=generator, device=flat.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    idx = torch.topk(flat + gumbel, n, dim=1).indices
    return flat.gather(1, idx), idx


def _reorder(cache, spare, bax: int, sel):
    """Gather the rows `sel` of every cache tensor's batch axis `bax` into
    `spare`'s tensors and swap the two: → (new cache, new spare).  Each
    tensor is gathered as 8-byte words along its last axis where its bytes
    allow: `index_select` moves one element a thread, so 2-byte elements
    move at a fraction of the rate."""
    for k in cache:
        src, dst = cache[k], spare[k]
        if src.shape[-1] * src.element_size() % 8 == 0:
            src, dst = src.view(torch.int64), dst.view(torch.int64)
        torch.index_select(src, bax, sel, out=dst)
    return spare, cache


def _n_finished(finished_scores):
    return (finished_scores > NEG_INF / 2).sum(dim=1)          # (B,)


def _rows(x, sel):
    """x (B, M, ...) → the rows `sel` (B, n) picks of each batch row."""
    idx = sel.reshape(*sel.shape, *([1] * (x.dim() - 2)))
    return x.gather(1, idx.expand(*sel.shape, *x.shape[2:]))


@torch.no_grad()
def beam_search(cfg: DecoderConfig, params, *, inputs_embeds, attention_mask,
                gen_cfg: GenerationConfig, attn_impl: str = "auto",
                cache_dtype=None, generator=None,
                stats: Optional[dict] = None):
    """inputs_embeds (B, P, H) left-padded prompt embeddings, attention_mask
    (B, P) → (B, max_new_tokens) int64 best-beam tokens, pad after EOS.
    K, the length penalty and early stopping are gen_cfg's num_beams,
    length_penalty and early_stopping.  Beam-sample needs `generator`.  `stats`, when given, gets "prefill_s"
    and "decode_s" (host seconds, each ended by a device synchronize),
    "steps" (decode steps at B·K rows) and "logits" (the prefill logits)."""
    B, P, _ = inputs_embeds.shape
    K, NEW = gen_cfg.num_beams, gen_cfg.max_new_tokens
    length_penalty, early_stopping = (gen_cfg.length_penalty,
                                      gen_cfg.early_stopping)
    T = P + NEW
    dev = inputs_embeds.device
    dtype = cache_dtype or inputs_embeds.dtype
    eos, pad = gen_cfg.eos_token_id, gen_cfg.pad_token_id
    if gen_cfg.do_sample and generator is None:
        raise ValueError("beam-sample needs a torch.Generator")
    if stats is not None:
        _sync(dev)
    t_start = time.perf_counter()

    mask = attention_mask.to(torch.int32)
    positions = (torch.cumsum(mask, dim=1) - 1).clamp(min=0)
    layers = layer_views(params["layers"], cfg.num_layers)
    cache = init_kv_cache(cfg, B, T, device=dev, dtype=dtype)
    h, cache = decoder_forward(
        cfg, params, inputs_embeds=inputs_embeds.to(dtype),
        positions=positions, attn_lengths=contiguous_lengths(mask),
        kv_cache=cache, layers=layers, attn_impl=attn_impl)
    logits0 = decoder_logits(cfg, params, h[:, -1:])[:, 0]
    logp0 = _warp_rows(torch.log_softmax(logits0, dim=-1), gen_cfg)
    V = logp0.shape[-1]

    bax = batch_axis(cfg)
    cache = {k: v.repeat_interleave(K, dim=bax) for k, v in cache.items()}
    spare = {k: torch.empty_like(v) for k, v in cache.items()}
    kv_mask = torch.zeros((B * K, T), dtype=torch.int32, device=dev)
    kv_mask[:, :P] = mask.repeat_interleave(K, dim=0)
    last_pos = positions[:, -1].repeat_interleave(K)            # (B·K,)
    table = params["embed_tokens"]
    top_id = table.shape[0] - 1
    row0 = (torch.arange(B, device=dev) * K)[:, None]

    # step 0: the top-K (or K sampled) tokens of the prompt distribution
    # seed the beams; a beam whose first token is EOS finishes at once
    scores0, tok0 = _select_candidates(logp0[:, None], K, gen_cfg, generator)
    alive_tokens = torch.full((B, K, NEW), pad, dtype=torch.int64,
                              device=dev)
    alive_tokens[:, :, 0] = tok0
    fin0 = tok0 == eos
    finished_tokens = torch.where(fin0[..., None], alive_tokens, pad)
    finished_scores = torch.where(fin0, scores0, NEG_INF)
    alive_scores = torch.where(fin0, NEG_INF, scores0)
    if stats is not None:
        stats["logits"] = [logits0.clone()]
        _sync(dev)
        t_prefill = time.perf_counter()
        stats["prefill_s"] = t_prefill - t_start

    steps = 0
    for t in range(1, NEW):
        # HF BeamHypotheses.is_done with early_stopping: a row takes no
        # hypothesis once K are banked (checked before this step's)
        if early_stopping:
            done = _n_finished(finished_scores) >= K              # (B,)
            if bool(done.all()):
                break
        prev = alive_tokens[:, :, t - 1].reshape(B * K)
        emb = table[prev.clamp(max=top_id)][:, None, :].to(dtype)
        h, cache = decoder_decode_step(
            cfg, params, token_embeds=emb, kv_mask=kv_mask,
            positions=(last_pos + t)[:, None], kv_cache=cache,
            cache_index=P + t - 1, layers=layers)
        kv_mask[:, P + t - 1] = 1
        steps += 1
        logp = _warp_rows(torch.log_softmax(
            decoder_logits(cfg, params, h)[:, 0], dim=-1), gen_cfg)
        cand = alive_scores[:, :, None] + logp.reshape(B, K, V)
        top_scores, top_idx = _select_candidates(cand, 2 * K, gen_cfg,
                                                 generator)      # (B, 2K)
        top_beam = torch.div(top_idx, V, rounding_mode="floor")
        top_token = top_idx % V
        is_eos = top_token == eos

        # the candidates' sequences (B, 2K, NEW); EOS stays in the output
        cand_tokens = _rows(alive_tokens, top_beam)
        cand_tokens[:, :, t] = top_token

        # alive: the best K non-EOS candidates
        new_alive_scores, alive_sel = torch.topk(
            torch.where(is_eos, NEG_INF, top_scores), K, dim=1)
        new_alive_tokens = _rows(cand_tokens, alive_sel)
        new_alive_beam = top_beam.gather(1, alive_sel)

        # finished: EOS candidates merged into the pool, normalised by the
        # length before the EOS (t tokens) while the sum holds its logp
        hyp_len = float(max(t, 1))
        fin_cand = torch.where(is_eos, top_scores / hyp_len ** length_penalty,
                               NEG_INF)
        new_fin_scores, fin_sel = torch.topk(
            torch.cat([finished_scores, fin_cand], dim=1), K, dim=1)
        new_fin_tokens = _rows(torch.cat([finished_tokens, cand_tokens],
                                         dim=1), fin_sel)

        # the cache follows the alive beams (not after the last step)
        if t < NEW - 1:
            cache, spare = _reorder(cache, spare, bax,
                                    (row0 + new_alive_beam).reshape(-1))

        if early_stopping:        # done rows freeze
            d1, d2 = done[:, None], done[:, None, None]
            new_alive_tokens = torch.where(d2, alive_tokens, new_alive_tokens)
            new_alive_scores = torch.where(d1, alive_scores, new_alive_scores)
            new_fin_tokens = torch.where(d2, finished_tokens, new_fin_tokens)
            new_fin_scores = torch.where(d1, finished_scores, new_fin_scores)
        alive_tokens, alive_scores = new_alive_tokens, new_alive_scores
        finished_tokens, finished_scores = new_fin_tokens, new_fin_scores

    # HF finalize: the alive beams join the pool, normalised at full length,
    # only in rows that are not done.  A row with no finished hypothesis
    # takes its best alive beam, so a NEG_INF pool entry is never chosen
    alive_norm = alive_scores[:, 0] / float(NEW) ** length_penalty
    has_fin = finished_scores[:, 0] > NEG_INF / 2
    use_alive = ~has_fin | (alive_norm > finished_scores[:, 0])
    if early_stopping:
        use_alive = use_alive & (_n_finished(finished_scores) < K)
    out = torch.where(use_alive[:, None], alive_tokens[:, 0],
                      finished_tokens[:, 0])
    if stats is not None:
        _sync(dev)
        stats.update(decode_s=time.perf_counter() - t_prefill, steps=steps)
    return out
