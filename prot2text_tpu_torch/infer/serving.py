"""Continuous batching — slot-based serving loop (counterpart of
prot2text_tpu/infer/serving.py).

A fixed pool of `max_slots` cache slots; each decode round advances EVERY
active slot by `sync_every` tokens at its own length (per-row cache slots:
`decoder_decode_step` with a (B,) `cache_index`, kernel K4, or K9a over a
shared prefix; on the int8 pool, `kv_bits=8`, K7 or K9b), finished slots are
freed at once and refilled from the queue by prefilling straight into the
freed slot's cache region.  Greedy output is token-identical to per-request
`generate()` for any max_slots / sync_every, and to the JAX engine.

Prompt-lookup speculative serving (`prompt_lookup_tokens` γ > 0): each
round every slot drafts γ tokens from its own history (`ngram_drafts`), one
G = γ + 1 token chunk forward verifies all slots at per-row cache columns,
and each row advances by its own accepted length (`_spec_rounds`).  On an
int8 pool the verify is the fused `decoder_verify_chunk` (K8, or K9c over
the shared prefix); otherwise `decoder_forward` with an explicit bias over
the pool (K6).  `spec_break_even` > 0 turns on the adaptive controller that
falls back to plain rounds while too few drafts are accepted.

What carries over from the JAX engine, and what does not:
  * the same state (pool KV cache + per-slot metadata), the same
    install/decode semantics, the scratch-column rule and the T rounding
    to 16;
  * the pool, its installs and the shared prefix are (L, B, Hkv, T, D) at
    every head dim (`POOL_LAYOUT`), passed to the decoder explicitly, so
    the per-row routes K4/K7/K9 take them; JAX lays out a head dim off the
    128 grid as "tbkd" (L, T, B, Hkv, D) and serves it on XLA routes only
    (prot2text_tpu/infer/serving.py:149, :212);
  * JAX jits each piece and DONATES the state through every call so that
    slot writes stay in place; PyTorch runs eagerly, so the port updates
    the state dict's tensors in place instead (the cache through K4/K9a and
    indexed assignment, the metadata with `copy_`) — no call replaces them;
  * one host transfer per install (the first tokens) and one per decode
    round (a packed (3, sync_every, B) tensor), as in JAX; the engine's
    host timers (`install_s`, `decode_s`) end at those transfers, which
    synchronise the device, so they add no synchronisation of their own;
  * the engine counts its plain decode steps (`plain_steps`) and its
    verify rounds (`verify_rounds`) apart, beside JAX's `steps` which sums
    both, so that kernel launch counts can be asserted exactly;
  * Medusa speculative serving is not ported yet (ROADMAP.md §1 item 8).

Typical use:

    eng = ContinuousBatcher(cfg, params, max_slots=16, max_len=512)
    for rid, emb, n in requests:
        eng.submit(rid, emb, max_new_tokens=n)
    for request_id, tokens in eng.run():
        ...  # emitted as each request finishes, NOT in batch order
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Iterator, Optional

import torch

from ..models.decoder import (
    DecoderConfig, contiguous_lengths, decoder_decode_step, decoder_forward,
    decoder_logits, decoder_verify_chunk, layer_views,
    supports_verify_chunk_step,
)
from .generate import _sample_token
from .kvcache import init_kv_cache

NEG = float(torch.finfo(torch.float32).min)
POOL_LAYOUT = "bktd"
# cache width multiples: the JAX fused write kernels' 16-row bf16 and
# 32-row int8 tile groups; kept so the port's pools have the JAX engine's
# shapes
T_MULTIPLE = 16
T_MULTIPLE_INT8 = 32
# the fused chunk verify's scratch tail: inactive rows write their chunk at
# T - 64 (the TPU kernel's two-tile-group write; the port's kernels need
# only start + G <= T, but the pools keep the JAX engine's shapes)
FUSED_SCRATCH = 64
# the shared prefix is left-padded to a multiple of this (the JAX flash /
# lane-tile width), so prefix installs see the JAX engine's shapes
PREFIX_MULTIPLE = 128


@dataclasses.dataclass
class _Request:
    request_id: object
    embeds: torch.Tensor        # (W, H) prompt embeddings; real tokens are
                                # the LAST prompt_len rows
    max_new_tokens: int
    prompt_len: int = 0
    use_prefix: bool = False    # attend the engine's shared-prefix KV
                                # (embeds then hold only the SUFFIX)


def _positions(mask):
    """Rope positions of left-padded rows: clip(cumsum(mask) - 1, 0)."""
    return (torch.cumsum(mask, dim=1) - 1).clamp(min=0)


def _compute_dtype(state):
    """The activations' dtype: the pool's, except that an int8 pool
    computes in bf16 (the JAX engine's rule)."""
    dt = state["k"].dtype
    return torch.bfloat16 if dt == torch.int8 else dt


def _next_token(logits, gen_cfg, generator):
    """Greedy argmax, or the HF warper pipeline when gen_cfg samples."""
    if gen_cfg is not None and gen_cfg.do_sample:
        return _sample_token(logits, gen_cfg, generator)
    return torch.argmax(logits, dim=-1)


@torch.no_grad()
def _prefix_prefill(cfg: DecoderConfig, params, emb, mask, *,
                    prefix_cols: int, kv_bits=None, layers=None):
    """ONE-TIME prefill of the shared prompt prefix (left-padded to
    prefix_cols): returns the (L, 1, Hkv, Pc, D) KV that every install
    seeds (int8 with its scales under kv_bits=8).  Ordinary causal
    self-attention through K1 — identical math to the first prefix_len
    rows of a full-prompt prefill, so prefix-shared streams stay
    greedy-exact."""
    emb = torch.where(mask[:, :, None] > 0, emb, 0)
    cache = init_kv_cache(cfg, 1, prefix_cols, device=emb.device,
                          dtype=emb.dtype, kv_bits=kv_bits,
                          layout=POOL_LAYOUT)
    decoder_forward(cfg, params, inputs_embeds=emb, positions=_positions(mask),
                    attn_lengths=contiguous_lengths(mask), kv_cache=cache,
                    layers=layers, layout=POOL_LAYOUT)
    return cache


@torch.no_grad()
def _prefill_install_pool(cfg: DecoderConfig, state, params, emb, mask,
                          slots, plens, budgets, generator, pkv=None, *,
                          eos_token_id: int, gen_cfg=None,
                          prefix_cols: int = 0, prefix_len: int = 0,
                          dedup: bool = False, layers=None):
    """Installs n pending requests in one prefill: an (R, prompt_pad)-wide
    forward (R >= n, rows n.. are padding), then an update of the n pool
    slots `slots` (n,) — their first prompt_pad cache columns and their
    metadata; other slots keep their contents exactly.  plens/budgets (n,)
    per request.  Returns (tok0 (n,), each request's first token, and the
    (n, V) fp32 logits it was drawn from).

    With prefix_cols > 0, `pkv` ((L, 1, Hkv, Pc, D), the shared prefix's
    KV) is seeded into columns [0, Pc) of the transient R-row cache and the
    forward runs only over the private suffix (cache_index = Pc) with an
    explicit bias over [prefix ‖ suffix] — K6.  Without, it is a plain
    causal prefill — K1.  Dedup mode keeps the prefix out of the pool: only
    the suffix columns enter it, and `use_pfx` records which slots attend
    the shared prefix at decode time (prot2text_tpu/infer/serving.py:
    96-275)."""
    R, prompt_pad = mask.shape
    n = slots.shape[0]
    dev = emb.device
    # zero the padding rows so garbage there can never leak into attention
    emb = torch.where(mask[:, :, None] > 0, emb, 0)
    W = prefix_cols + prompt_pad                 # prefill cache width
    kv_bits = 8 if "k_scale" in state else None
    cache = init_kv_cache(cfg, R, W, device=dev, dtype=emb.dtype,
                          kv_bits=kv_bits, layout=POOL_LAYOUT)
    positions = _positions(mask) + prefix_len
    if prefix_cols:
        for key in cache:          # broadcast copy (values and scales)
            cache[key][:, :, :, :prefix_cols] = pkv[key]
        idx = torch.arange(prompt_pad, device=dev)
        ok = ((idx[None, :] <= idx[:, None])[None, None]
              & (mask[:, None, None, :] > 0))
        # suffix queries attend the prefix's VALID columns plus the causal
        # window; the left-pad columns [0, Pc - prefix_len) stay masked
        pvalid = torch.arange(prefix_cols, device=dev) >= (prefix_cols
                                                           - prefix_len)
        okp = pvalid.expand(R, 1, prompt_pad, prefix_cols)
        bias = torch.where(torch.cat([okp, ok], dim=-1), 0.0, NEG)
        h, cache = decoder_forward(
            cfg, params, inputs_embeds=emb, positions=positions, bias=bias,
            kv_cache=cache, cache_index=prefix_cols, layers=layers,
            layout=POOL_LAYOUT)
    else:
        h, cache = decoder_forward(
            cfg, params, inputs_embeds=emb, positions=positions,
            attn_lengths=contiguous_lengths(mask), kv_cache=cache,
            layers=layers, layout=POOL_LAYOUT)
    logits = decoder_logits(cfg, params, h[:, -1:])[:n, 0]
    tok0 = _next_token(logits, gen_cfg, generator)

    # dedup: only the suffix columns [off, W) of the transient cache enter
    # the pool (at columns [0, Wp)); the prefix stays in `pkv`
    off = prefix_cols if dedup else 0
    Wp = W - off
    for key in cache:              # k, v and (int8 pool) their scales
        state[key][:, slots, :, :Wp] = cache[key][:, :n, :, off:].to(
            state[key].dtype)
    T = state["kv_mask"].shape[1]
    pads = (prompt_pad - plens)[:, None]         # per-row left padding
    cols = torch.arange(T, device=dev)[None, :]
    # valid pool columns: the left-padded suffix window; plus (replicated
    # mode only) the prefix's real tokens at [Pc - prefix_len, Pc)
    base = 0 if dedup else prefix_cols
    row_mask = (cols < base + prompt_pad) & (cols >= base + pads)
    if prefix_cols and not dedup:
        row_mask |= (cols >= prefix_cols - prefix_len) & (cols < prefix_cols)
    finished0 = (tok0 == eos_token_id) | (budgets <= 1)
    state["kv_mask"][slots] = row_mask.to(torch.int32)
    state["pos"][slots] = prefix_len + plens - 1
    state["next_slot"][slots] = base + prompt_pad
    if "use_pfx" in state:      # dedup: which slots see the shared prefix
        state["use_pfx"][slots] = int(bool(dedup and prefix_cols))
    state["active"][slots] = ~finished0
    state["last_tok"][slots] = tok0
    state["budget"][slots] = budgets - 1
    if "hist" in state:            # speculative history: reset to [tok0]
        state["hist"][slots] = -1
        state["hist"][slots, 0] = tok0
        state["hist_len"][slots] = 1
    return tok0, logits


def _prefix_row_bias(state, pkv, prefix_len: int):
    """(B, 1, 1, Pc) fp32 additive bias over the shared-prefix columns:
    valid = the prefix's real tokens AND the row opted into the prefix
    (use_pfx — full-prompt requests sharing a dedup pool must not see
    it)."""
    Pc = pkv["k"].shape[3]
    pvalid = torch.arange(Pc, device=pkv["k"].device) >= Pc - prefix_len
    ok = (state["use_pfx"][:, None] > 0) & pvalid[None, :]
    return torch.where(ok, 0.0, NEG)[:, None, None, :]


@torch.no_grad()
def _decode_all(cfg: DecoderConfig, state, params, generator, pkv=None, *,
                eos_token_id: int, chunk: int = 1, gen_cfg=None,
                prefix_len: int = 0, layers=None):
    """`chunk` tokens for every active slot, on the device (slots that
    finish mid-chunk stop advancing, so per-request token streams are
    identical for any chunk size; refills wait until the chunk boundary).
    gen_cfg enables HF-warper sampling from `generator`; None = greedy.
    Returns packed (3, chunk, B) int64 = [tok, finished, advanced], still
    on the device."""
    B = state["pos"].shape[0]
    T = state["kv_mask"].shape[1]
    dev = state["pos"].device
    bidx = torch.arange(B, device=dev)
    # inactive rows still compute a k/v: it goes to the scratch column (the
    # last cache column, kv_mask permanently 0 there), so a finished slot's
    # cache stays intact until its refill
    scratch = T - 1
    pbias = None if pkv is None else _prefix_row_bias(state, pkv, prefix_len)
    kv = _pool(state)
    cdt = _compute_dtype(state)
    packed = torch.empty((3, chunk, B), dtype=torch.int64, device=dev)
    for c in range(chunk):
        active = state["active"]
        emb = params["embed_tokens"][state["last_tok"]][:, None, :].to(cdt)
        write_idx = torch.where(active, state["next_slot"], scratch)
        h, _ = decoder_decode_step(
            cfg, params, token_embeds=emb, kv_mask=state["kv_mask"],
            positions=(state["pos"] + 1)[:, None], kv_cache=kv,
            cache_index=write_idx, layers=layers, prefix_kv=pkv,
            prefix_bias=pbias, layout=POOL_LAYOUT)
        state["kv_mask"][bidx, write_idx] = torch.where(
            active, 1, state["kv_mask"][bidx, write_idx]).to(torch.int32)
        tok = _next_token(decoder_logits(cfg, params, h)[:, 0], gen_cfg,
                          generator)
        budget = torch.where(active, state["budget"] - 1, state["budget"])
        finished = active & ((tok == eos_token_id) | (budget <= 0))
        packed[0, c] = tok
        packed[1, c] = finished
        packed[2, c] = active
        state["budget"].copy_(budget)
        state["pos"].copy_(torch.where(active, state["pos"] + 1,
                                       state["pos"]))
        state["next_slot"].copy_(torch.where(
            active, torch.clamp(state["next_slot"] + 1, max=scratch),
            state["next_slot"]))
        state["last_tok"].copy_(torch.where(active, tok, state["last_tok"]))
        if "hist" in state:
            # keep the n-gram draft source fresh on plain rounds too, so the
            # adaptive controller re-probes over a complete history
            HW = state["hist"].shape[1]
            hpos = state["hist_len"].clamp(0, HW - 1)
            state["hist"][bidx, hpos] = torch.where(
                active, tok, state["hist"][bidx, hpos])
            state["hist_len"].add_(active.to(state["hist_len"].dtype))
        state["active"].copy_(active & ~finished)
    return packed


def _pool(state):
    """The pool's cache tensors (values and, int8, scales) as the decoder
    takes them — views of the state, updated in place."""
    return {k: state[k] for k in ("k", "v", "k_scale", "v_scale")
            if k in state}


def ngram_drafts(hist, hist_len, *, gamma: int, ngram: int,
                 fallback: int = 0):
    """Per-row prompt-lookup drafts over each row's own token history
    (prot2text_tpu/infer/serving.py:385-431).

    hist: (B, HW) integer history rows: entries beyond hist_len[b] are
    ignored, and -1 sentinels inside the valid span never match a token.
    Each row drafts `gamma` tokens by chasing the latest `ngram`-gram match
    token by token (each draft is appended to the matching history, so
    repetition periods shorter than gamma copy correctly).  Rows with no
    match draft max(fallback, 0).  Returns (B, gamma) in hist's dtype."""
    B, HW = hist.shape
    W = HW - ngram + 1
    dev = hist.device
    bidx = torch.arange(B, device=dev)
    cols = torch.arange(W, device=dev)[None, :]
    histx = torch.where(torch.arange(HW, device=dev)[None, :]
                        < hist_len[:, None], hist, -1)
    drafts = torch.zeros((B, gamma), dtype=hist.dtype, device=dev)
    for j in range(gamma):
        end = hist_len.long() + j                            # (B,)
        gram_pos = (end[:, None] - ngram + torch.arange(
            ngram, device=dev)[None, :]).clamp(0, HW - 1)
        prevgram = torch.gather(histx, 1, gram_pos)
        match = torch.ones((B, W), dtype=torch.bool, device=dev)
        for k in range(ngram):
            match &= histx[:, k:W + k] == prevgram[:, k:k + 1]
        ok = match & (cols < (end - ngram)[:, None])
        best = torch.where(ok, cols, -1).amax(dim=1)         # (B,)
        nxt = torch.gather(histx, 1, (best + ngram).clamp(0, HW - 1)[:, None]
                           )[:, 0]
        nxt = torch.where(best >= 0, nxt, fallback).clamp(min=0)
        drafts[:, j] = nxt
        histx[bidx, end.clamp(0, HW - 1)] = nxt
    return drafts


@torch.no_grad()
def _spec_rounds(cfg: DecoderConfig, state, params, pkv=None, *,
                 eos_token_id: int, gamma: int, ngram: int, rounds: int = 1,
                 use_fused: bool = False, prefix_len: int = 0, layers=None):
    """`rounds` prompt-lookup verify rounds with per-row acceptance
    (prot2text_tpu/infer/serving.py:434-575): every slot drafts `gamma`
    tokens from its own history, one G = gamma + 1 token chunk forward
    verifies all slots at per-row cache columns, and each row advances by
    its own accepted length (0..gamma drafts + the bonus token), clamped by
    its budget and its first EOS.  Rejected drafts' k/v land past the
    accepted point with kv_mask 0 and are overwritten later; inactive rows
    write into the scratch tail (T - 64 fused, T - G otherwise).  The
    state is updated in place.  Greedy only.  Returns packed
    (3, rounds, G, B) int64 = [tokens, emit flags, finished flags], still on
    the device: row b of round r emits tokens[r, :n, b], n = emit[r, :, b]
    .sum()."""
    B = state["pos"].shape[0]
    G = gamma + 1
    T = state["kv_mask"].shape[1]
    HW = state["hist"].shape[1]
    dev = state["pos"].device
    colsG = torch.arange(G, device=dev)[None, :]
    colsT = torch.arange(T, device=dev)[None, :]
    cdt = _compute_dtype(state)
    pbias = None if pkv is None else _prefix_row_bias(state, pkv, prefix_len)
    scratch = T - (FUSED_SCRATCH if use_fused else G)       # dead tail
    kv = _pool(state)
    packed = torch.empty((3, rounds, G, B), dtype=torch.int64, device=dev)
    for r in range(rounds):
        active = state["active"].clone()
        drafts = ngram_drafts(state["hist"], state["hist_len"], gamma=gamma,
                              ngram=ngram)
        chunk = torch.cat([state["last_tok"][:, None], drafts], dim=1)
        emb = params["embed_tokens"][chunk].to(cdt)          # (B, G, H)
        start = torch.where(active, state["next_slot"], scratch)
        pos = (state["pos"] + 1)[:, None] + colsG
        if use_fused:
            h, _ = decoder_verify_chunk(
                cfg, params, token_embeds=emb, kv_mask=state["kv_mask"],
                positions=pos, kv_cache=kv, cache_index=start, layers=layers,
                prefix_kv=pkv, prefix_bias=pbias)
        else:
            st = start[:, None, None, None]
            rows = torch.arange(G, device=dev)[None, None, :, None]
            cols = colsT[:, None, None, :]
            ok = ((state["kv_mask"][:, None, None, :] > 0)
                  | ((cols >= st) & (cols <= st + rows)))   # (B, 1, G, T)
            bias = torch.where(ok, 0.0, NEG)
            h, _ = decoder_forward(
                cfg, params, inputs_embeds=emb, positions=pos, bias=bias,
                kv_cache=kv, cache_index=start, layers=layers, prefix_kv=pkv,
                prefix_bias=pbias, layout=POOL_LAYOUT)
        tgt = torch.argmax(decoder_logits(cfg, params, h), dim=-1)  # (B, G)

        # per-row acceptance, then the budget and EOS clamps
        match = drafts == tgt[:, :gamma]
        a = torch.cumprod(match.long(), dim=1).sum(dim=1)
        bonus = torch.gather(tgt, 1, a[:, None])[:, 0]
        out = torch.cat([drafts, tgt[:, -1:]], dim=1)
        out = torch.where(colsG == a[:, None], bonus[:, None], out)
        n0 = torch.minimum(a + 1, state["budget"])
        iseos = (out == eos_token_id) & (colsG < n0[:, None])
        has_eos = iseos.any(dim=1)
        n = torch.where(has_eos, iseos.long().argmax(dim=1) + 1, n0)
        n = torch.where(active, n, 0)                        # (B,)
        fin = active & (has_eos | (state["budget"] - n <= 0))

        newly = (colsT >= start[:, None]) & (colsT < (start + n)[:, None])
        state["kv_mask"].masked_fill_(newly & active[:, None], 1)
        emit = colsG < n[:, None]                            # (B, G)
        hpos = (state["hist_len"][:, None] + colsG).clamp(0, HW - 1)
        hvals = torch.gather(state["hist"], 1, hpos)
        state["hist"].scatter_(1, hpos, torch.where(emit, out, hvals))
        state["hist_len"].add_(n.to(state["hist_len"].dtype))
        state["budget"].sub_(n)
        state["pos"].add_(n)
        state["next_slot"].copy_(torch.clamp(state["next_slot"] + n,
                                             max=scratch))
        last = torch.gather(out, 1, (n - 1).clamp(0, G - 1)[:, None])[:, 0]
        state["last_tok"].copy_(torch.where(n > 0, last, state["last_tok"]))
        state["active"].copy_(active & ~fin)
        packed[0, r] = out.T
        packed[1, r] = emit.T
        packed[2, r] = fin[None, :].expand(G, B)
    return packed


class ContinuousBatcher:
    """Greedy continuous-batching engine over `decoder_decode_step`.

    cfg/params: the decoder core + its params (bf16 or f32 tensors on one
        device, which the engine runs on; a weight-quantized tree from
        `models/quant.quantize_params` runs its projections through K10/K14
        and its activations in `cache_dtype`).
    max_slots: concurrent sequences (the pool width).
    max_len: cache width per slot (largest prompt_pad + longest answer).
    prompt_pad: prefill width(s).  An int gives one width; a tuple gives
        LENGTH BUCKETS — each request prefills at the smallest bucket >= its
        prompt length.
    sync_every: decode tokens per host round-trip.
    kv_bits: 8 = an int8 KV pool with per-(head, token) scales; its
        decode and verify rounds compute in bf16.
    prompt_lookup_tokens: γ > 0 turns on prompt-lookup speculative rounds
        (`prompt_lookup_ngram`-gram drafts, greedy only); spec_break_even >
        0 turns on the adaptive controller, which re-probes every
        spec_probe_every plain dispatches.
    shared_prefix_embeds: (Ps, H) embeddings of a prompt prefix shared by
        every request (the chat template's header): its KV is computed once
        and prefills cover only each request's suffix.  prefix_dedup keeps
        ONE copy of that KV, read by every slot through K9a (K9b, K9c on an
        int8 pool), instead of replicating it into each slot's cache.
    max_prefill_rows: cap on requests per prefill dispatch.
    medusa_params raises NotImplementedError (ROADMAP.md §1 item 8)."""

    def __init__(self, cfg: DecoderConfig, params, *, max_slots: int,
                 max_len: int, prompt_pad=64, eos_token_id: int = 128009,
                 cache_dtype=torch.bfloat16, sync_every: int = 1,
                 gen_cfg=None, generator=None, kv_bits=None,
                 prompt_lookup_tokens: int = 0, prompt_lookup_ngram: int = 2,
                 medusa_params=None, spec_break_even: float = 0.0,
                 spec_probe_every: int = 8, shared_prefix_embeds=None,
                 prefix_dedup: bool = False, max_prefill_rows: int = 16):
        if medusa_params is not None:
            raise NotImplementedError(
                "Medusa speculative serving is not ported yet (ROADMAP.md "
                "§1 item 8: Medusa serving with cli/train_draft.py)")
        buckets = ((prompt_pad,) if isinstance(prompt_pad, int)
                   else tuple(sorted(prompt_pad)))
        if not buckets or buckets[-1] >= max_len:
            raise ValueError("prompt_pad must leave room for new tokens")
        if kv_bits not in (None, 8):
            raise ValueError(f"kv_bits must be 8 or None, got {kv_bits}")
        self.cfg = cfg
        self.params = params
        self.layers = layer_views(params["layers"], cfg.num_layers)
        self.device = params["embed_tokens"].device
        self.max_slots = max_slots
        self.max_len = max_len
        self.prompt_buckets = buckets
        self.prompt_pad = buckets[-1]
        self.eos_token_id = eos_token_id
        # the prefills' activation dtype (decode and verify rounds on an
        # int8 pool compute in bf16, as in the JAX engine)
        self.dtype = cache_dtype
        self.sync_every = max(1, sync_every)
        # optional sampling: a GenerationConfig with do_sample=True applies
        # the HF warper pipeline per token (greedy stays the default and
        # the only mode with exact generate() token parity)
        self.gen_cfg = gen_cfg
        self.generator = (generator if generator is not None else
                          torch.Generator(device=self.device).manual_seed(0))
        self.spec_gamma = int(prompt_lookup_tokens)
        self.spec_ngram = int(prompt_lookup_ngram)
        if self.spec_gamma and gen_cfg is not None and gen_cfg.do_sample:
            raise ValueError("speculative serving is greedy-only")
        # adaptive controller (prot2text_tpu/infer/serving.py:637-646): an
        # EMA of accepted tokens per (round, active slot); below
        # spec_break_even decode falls back to plain dispatches, with one
        # speculative probe every spec_probe_every of them.  0 = always
        # speculate
        self.spec_break_even = float(spec_break_even)
        self.spec_probe_every = max(1, int(spec_probe_every))
        self._accept_ema = None
        self._plain_since_probe = 0
        self.spec_fallbacks = 0     # plain dispatches taken while γ > 0
        self.max_prefill_rows = max(1, int(max_prefill_rows))
        self.dedup = bool(prefix_dedup)
        if self.dedup and shared_prefix_embeds is None:
            raise ValueError("prefix_dedup=True requires "
                             "shared_prefix_embeds")
        self.prefix_kv = None
        self.prefix_cols = 0
        self.prefix_len = 0
        if shared_prefix_embeds is not None:
            pe = torch.as_tensor(shared_prefix_embeds).to(self.device,
                                                          self.dtype)
            Ps = int(pe.shape[0])
            if Ps <= 0:
                raise ValueError("shared_prefix_embeds must be (Ps>0, H)")
            Pc = -(-Ps // PREFIX_MULTIPLE) * PREFIX_MULTIPLE
            pemb = torch.zeros((1, Pc, pe.shape[1]), dtype=self.dtype,
                               device=self.device)
            pemb[0, Pc - Ps:] = pe
            pmask = (torch.arange(Pc, device=self.device) >= Pc - Ps).to(
                torch.int32)[None]
            self.prefix_kv = _prefix_prefill(cfg, params, pemb, pmask,
                                             prefix_cols=Pc, kv_bits=kv_bits,
                                             layers=self.layers)
            self.prefix_cols = Pc
            self.prefix_len = Ps
        # scratch columns: inactive rows' writes go past the live region —
        # the last column for plain decode, a G-wide (fused: 64-wide) tail
        # for verify rounds, which also absorbs rejected drafts — so a
        # finished slot's real columns are never overwritten; kv_mask there
        # stays 0 forever.  The width rounds up to 16 (int8: 32) as in the
        # JAX engine
        mult = T_MULTIPLE_INT8 if kv_bits is not None else T_MULTIPLE
        slack = self.spec_gamma + 1 if self.spec_gamma else 1
        if self.spec_gamma and kv_bits is not None:
            slack = max(slack, FUSED_SCRATCH)
        pcols_pool = 0 if self.dedup else self.prefix_cols
        T = -(-(pcols_pool + max_len + slack) // mult) * mult
        cache = init_kv_cache(cfg, max_slots, T, device=self.device,
                              dtype=cache_dtype, kv_bits=kv_bits,
                              layout=POOL_LAYOUT)

        def zeros(dtype=torch.int64):
            return torch.zeros((max_slots,), dtype=dtype, device=self.device)

        self.state = {
            **cache,
            "kv_mask": torch.zeros((max_slots, T), dtype=torch.int32,
                                   device=self.device),
            "pos": zeros(), "next_slot": zeros(),
            "active": zeros(torch.bool), "last_tok": zeros(),
            "budget": zeros(),
        }
        if self.dedup:
            self.state["use_pfx"] = zeros(torch.int32)
        if self.spec_gamma:
            # per-slot generated-token history, the n-gram match source
            HW = max_len - buckets[0] + self.spec_gamma + 2
            self.state["hist"] = torch.full((max_slots, HW), -1,
                                            dtype=torch.int64,
                                            device=self.device)
            self.state["hist_len"] = zeros()
        # fused verify (K8/K9c) on an eligible int8 pool with the 64-column
        # scratch tail; the bf16 pool verifies through decoder_forward (K6)
        self._spec_fused = bool(
            self.spec_gamma and T - FUSED_SCRATCH >= pcols_pool + max_len
            and supports_verify_chunk_step(cfg, self.state,
                                           self.spec_gamma + 1))
        self.queue: deque[_Request] = deque()
        self._slot_req: list[Optional[_Request]] = [None] * max_slots
        self._slot_toks: list[list[int]] = [[] for _ in range(max_slots)]
        # decoder passes: `steps` counts both kinds as the JAX engine does;
        # `plain_steps` single-token steps, `verify_rounds` chunk verifies
        self.steps = 0
        self.plain_steps = 0
        self.verify_rounds = 0
        # verify rounds' emitted tokens and active slots summed over rounds
        # (acceptance = spec_tokens / spec_slot_rounds)
        self.spec_tokens = 0
        self.spec_slot_rounds = 0
        # prefill dispatches by kind, and host seconds spent installing,
        # decoding (plain and verify) and in verify dispatches alone (each
        # ends at a device→host transfer)
        self.installs = {"prefix": 0, "full": 0}
        self.install_s = 0.0
        self.decode_s = 0.0
        self.verify_s = 0.0

    def acceptance(self) -> float:
        """Tokens emitted per verify round per active slot (0 without
        verify rounds)."""
        return self.spec_tokens / max(1, self.spec_slot_rounds)

    def _bucket_for(self, length: int) -> int:
        for b in self.prompt_buckets:
            if length <= b:
                return b
        raise ValueError(
            f"prompt length {length} > largest prompt_pad bucket "
            f"{self.prompt_buckets[-1]}")

    def submit(self, request_id, prompt_embeds, *, max_new_tokens: int = 64,
               prompt_len: Optional[int] = None,
               use_prefix: Optional[bool] = None):
        """prompt_embeds: (W, H) with the real tokens occupying the LAST
        `prompt_len` rows (left-padding convention; prompt_len defaults to
        W).  A tensor on the engine's device stays there: the install
        assembles the prefill buffer with device copies.  With a shared
        prefix, the real tokens are the SUFFIX that follows it; the caller
        owns the contract that the prompt starts with the shared prefix
        (cli/serve.py verifies token ids and routes mismatches through
        use_prefix=False, a self-contained full-prompt prefill)."""
        emb = torch.as_tensor(prompt_embeds)
        plen = int(prompt_len) if prompt_len is not None else emb.shape[0]
        if not 0 < plen <= emb.shape[0]:
            raise ValueError(f"prompt_len {plen} outside (0, {emb.shape[0]}]")
        self._bucket_for(plen)              # validate length
        if max_new_tokens > self.max_len - self.prompt_pad:
            raise ValueError("max_new_tokens exceeds the slot cache width")
        upfx = bool(self.prefix_cols) if use_prefix is None else use_prefix
        if upfx and not self.prefix_cols:
            raise ValueError("use_prefix=True on an engine without "
                             "shared_prefix_embeds")
        self.queue.append(_Request(request_id, emb, max_new_tokens, plen,
                                   upfx))

    def _fill_free_slots(self) -> Iterator[tuple]:
        """Install queued requests into ALL free slots — one prefill
        dispatch per (length bucket, prefix use) present, at most
        max_prefill_rows requests each."""
        installs = {}                       # slot -> request
        for slot in range(self.max_slots):
            if not self.queue:
                break
            if self._slot_req[slot] is None:
                installs[slot] = self.queue.popleft()
        if not installs:
            return
        by_bucket: dict = {}
        for slot, req in installs.items():
            by_bucket.setdefault(
                (self._bucket_for(req.prompt_len), req.use_prefix), {}
            )[slot] = req
        for (pad, upfx), group in sorted(by_bucket.items()):
            items = list(group.items())
            for i in range(0, len(items), self.max_prefill_rows):
                yield from self._install_group(
                    dict(items[i:i + self.max_prefill_rows]), pad, upfx)

    def _install_group(self, installs: dict, pad: int,
                       use_prefix: bool = False) -> Iterator[tuple]:
        t0 = time.perf_counter()
        reqs = list(installs.values())
        Hd = reqs[0].embeds.shape[1]
        # prefill rows = requests installed, rounded up to a power of two
        # (the JAX engine's compile buckets; kept so both run one shape)
        R = 1
        while R < len(installs):
            R *= 2
        R = min(R, self.max_slots)
        emb = torch.zeros((R, pad, Hd), dtype=self.dtype, device=self.device)
        mask = torch.zeros((R, pad), dtype=torch.int32, device=self.device)
        for i, req in enumerate(reqs):
            P = req.prompt_len
            emb[i, pad - P:] = req.embeds[req.embeds.shape[0] - P:]
            mask[i, pad - P:] = 1

        def dev(values):
            return torch.tensor(values, dtype=torch.int64, device=self.device)

        tok0, _ = _prefill_install_pool(
            self.cfg, self.state, self.params, emb, mask,
            dev(list(installs)), dev([r.prompt_len for r in reqs]),
            dev([r.max_new_tokens for r in reqs]), self.generator,
            self.prefix_kv if use_prefix else None,
            eos_token_id=self.eos_token_id, gen_cfg=self.gen_cfg,
            prefix_cols=self.prefix_cols if use_prefix else 0,
            prefix_len=self.prefix_len if use_prefix else 0,
            dedup=self.dedup, layers=self.layers)
        tok0 = tok0.tolist()                # the install's one transfer
        self.installs["prefix" if use_prefix else "full"] += 1
        self.install_s += time.perf_counter() - t0
        for (slot, req), t in zip(installs.items(), tok0):
            if t == self.eos_token_id or req.max_new_tokens <= 1:
                yield req.request_id, [t]   # finished at the first token
            else:
                self._slot_req[slot] = req
                self._slot_toks[slot] = [t]

    def _decode_round(self) -> Iterator[tuple]:
        """One decode round (sync_every tokens for every active slot, or
        the verify rounds of a speculative dispatch), yielding
        (request_id, [tokens...]) for requests that finish."""
        if self.spec_gamma and self._spec_dispatch():
            yield from self._spec_decode_round()
            return
        if self.spec_gamma:
            self.spec_fallbacks += 1
        t0 = time.perf_counter()
        packed = _decode_all(
            self.cfg, self.state, self.params, self.generator,
            self.prefix_kv if self.dedup else None,
            eos_token_id=self.eos_token_id, chunk=self.sync_every,
            gen_cfg=self.gen_cfg,
            prefix_len=self.prefix_len if self.dedup else 0,
            layers=self.layers)
        self.steps += self.sync_every
        self.plain_steps += self.sync_every
        packed = packed.cpu().numpy()       # ONE transfer per round
        self.decode_s += time.perf_counter() - t0
        tok_h, fin_h, adv_h = packed[0], packed[1], packed[2]
        for c in range(tok_h.shape[0]):
            for slot in range(self.max_slots):
                if self._slot_req[slot] is None or not adv_h[c, slot]:
                    continue
                self._slot_toks[slot].append(int(tok_h[c, slot]))
                if fin_h[c, slot]:
                    req = self._slot_req[slot]
                    toks = self._slot_toks[slot]
                    self._slot_req[slot] = None
                    self._slot_toks[slot] = []
                    yield req.request_id, toks

    def _spec_dispatch(self) -> bool:
        """Adaptive controller: speculate this dispatch?  Always with
        spec_break_even <= 0.  Otherwise while the acceptance EMA clears the
        break-even, falling back to plain dispatches below it with one
        speculative probe every spec_probe_every plain ones."""
        if self.spec_break_even <= 0:
            return True
        if (self._accept_ema is None
                or self._accept_ema >= self.spec_break_even):
            self._plain_since_probe = 0
            return True
        self._plain_since_probe += 1
        if self._plain_since_probe >= self.spec_probe_every:
            self._plain_since_probe = 0
            return True                 # probe: refresh the EMA
        return False

    def _spec_decode_round(self) -> Iterator[tuple]:
        """Prompt-lookup speculative rounds (per-row acceptance): each
        dispatch runs max(1, sync_every // G) verify rounds, each emitting
        1..G tokens per active slot."""
        G = self.spec_gamma + 1
        rounds = max(1, self.sync_every // G)
        t0 = time.perf_counter()
        packed = _spec_rounds(
            self.cfg, self.state, self.params,
            self.prefix_kv if self.dedup else None,
            eos_token_id=self.eos_token_id, gamma=self.spec_gamma,
            ngram=self.spec_ngram, rounds=rounds, use_fused=self._spec_fused,
            prefix_len=self.prefix_len if self.dedup else 0,
            layers=self.layers)
        self.steps += rounds               # one target forward per round
        self.verify_rounds += rounds
        packed = packed.cpu().numpy()      # (3, rounds, G, B), one transfer
        dt = time.perf_counter() - t0
        self.decode_s += dt
        self.verify_s += dt
        tok_h, emit_h, fin_h = packed[0], packed[1], packed[2]
        # accepted tokens per (round, active slot): an active row emits at
        # least one token per round, so a non-zero count marks activity
        per_row = emit_h.sum(axis=1)                 # (rounds, B)
        active = int((per_row > 0).sum())
        self.spec_tokens += int(per_row.sum())
        self.spec_slot_rounds += active
        if self.spec_break_even > 0 and active:
            rate = float(per_row.sum()) / active
            self._accept_ema = (rate if self._accept_ema is None
                                else 0.5 * self._accept_ema + 0.5 * rate)
        for r in range(rounds):
            for slot in range(self.max_slots):
                if self._slot_req[slot] is None:
                    continue
                for c in range(G):
                    if emit_h[r, c, slot]:
                        self._slot_toks[slot].append(int(tok_h[r, c, slot]))
                if fin_h[r, 0, slot]:
                    req = self._slot_req[slot]
                    toks = self._slot_toks[slot]
                    self._slot_req[slot] = None
                    self._slot_toks[slot] = []
                    yield req.request_id, toks

    def pump(self, until_queue_below: int = 1) -> Iterator[tuple]:
        """Backpressure for streaming submission: drive decode rounds only
        until the pending queue is shorter than `until_queue_below`, then
        return control to the caller (who can encode and submit the next
        requests), so host memory holds O(until_queue_below) undispatched
        prompts instead of the whole workload."""
        while True:
            yield from self._fill_free_slots()
            if len(self.queue) < until_queue_below:
                return
            yield from self._decode_round()

    def run(self) -> Iterator[tuple]:
        """Drives the loop until the queue and all slots drain, yielding
        (request_id, [tokens...]) as each request finishes."""
        while True:
            yield from self._fill_free_slots()
            if not any(r is not None for r in self._slot_req):
                if not self.queue:
                    return
                continue
            yield from self._decode_round()

