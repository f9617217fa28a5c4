"""The port's continuous-batching engine (infer/serving.py) against the JAX
engine on the same tiny f32 Qwen3-style decoder and the same prompts, and
against the port's own per-request `generate()`: per-request greedy
tokens identical.  Covers no prefix, a replicated and a dedup shared
prefix, a pool mixing prefix-shared and full-prompt requests, more requests
than slots, ragged prompt lengths across two buckets, ragged budgets, an
EOS stop, sync_every 1 and 4, chunked installs; the JAX side on its XLA
route (head_dim 16) and on its Pallas kernels in interpret mode (head_dim
128: K4 and K9a).  Sampled serving is checked for `filter_logits` and
token validity only: the two frameworks draw different random bits."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prot2text_tpu.infer import serving as jserv
from prot2text_tpu.models import decoder as jd
from prot2text_tpu_torch.infer import serving as tserv
from prot2text_tpu_torch.infer.generate import (
    GenerationConfig, filter_logits, generate,
)
from prot2text_tpu_torch.models import decoder as td
from prot2text_tpu_torch.models.weights import params_from_jax

HIDDEN = 64
BUCKETS = (4, 8)


def _cfgs(head_dim):
    jcfg = jd.DecoderConfig(
        vocab_size=512, hidden_size=HIDDEN, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=128, head_dim=head_dim,
        rope_theta=10000.0, qk_norm=True)
    return jcfg, td.DecoderConfig(**jcfg.__dict__)


@pytest.fixture(params=[16, 128], ids=["xla", "pallas"])
def model(request, monkeypatch):
    """(JAX cfg, port cfg, JAX params, port params).  head_dim 128 keeps the
    JAX cache in its bktd layout and runs the JAX engine's decode through
    its Pallas kernels (K4, K9a) in interpret mode."""
    if request.param == 128:
        monkeypatch.setenv("P2T_PALLAS_FORCE_INTERPRET", "1")
    jcfg, tcfg = _cfgs(request.param)
    params = jd.init_decoder_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                     params)).tree()
    return jcfg, tcfg, params, tparams


def _prompt(seed, P):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((P, HIDDEN)).astype(np.float32)


PREFIX = _prompt(99, 5)


def _serve(engine_cls, cfg, params, reqs, *, dtype, **kw):
    eng = engine_cls(cfg, params, cache_dtype=dtype, **kw)
    for rid, emb, n, *upfx in reqs:
        eng.submit(rid, emb, max_new_tokens=n,
                   use_prefix=upfx[0] if upfx else None)
    return eng, dict(eng.run())


def _both(model, reqs, **kw):
    """(port tokens, JAX tokens, port engine) for one request list."""
    jcfg, tcfg, params, tparams = model
    eng, got = _serve(tserv.ContinuousBatcher, tcfg, tparams, reqs,
                      dtype=torch.float32, **kw)
    _, want = _serve(jserv.ContinuousBatcher, jcfg, params, reqs,
                     dtype=jnp.float32, **kw)
    return got, want, eng


def _generate_ref(tcfg, tparams, emb_unpadded, max_new, eos=-1, pad=8):
    """The port's lockstep generate() on one left-padded prompt, cut at
    EOS (the engine's per-request stream)."""
    P = emb_unpadded.shape[0]
    emb = torch.zeros((1, pad, HIDDEN))
    emb[0, pad - P:] = torch.from_numpy(emb_unpadded)
    mask = torch.zeros((1, pad), dtype=torch.int32)
    mask[0, pad - P:] = 1
    row = generate(tcfg, tparams, inputs_embeds=emb, attention_mask=mask,
                   gen_cfg=GenerationConfig(max_new_tokens=max_new,
                                            eos_token_id=eos,
                                            pad_token_id=-7))[0].tolist()
    if eos in row:
        row = row[:row.index(eos) + 1]
    return [t for t in row if t != -7]


REQS = [("a", _prompt(1, 3), 4), ("b", _prompt(2, 5), 6),
        ("c", _prompt(3, 8), 3), ("d", _prompt(4, 2), 5),
        ("e", _prompt(5, 7), 6)]


@pytest.mark.parametrize("max_slots,sync_every", [(2, 1), (3, 4)])
def test_engine_matches_jax_engine_and_generate(model, max_slots,
                                                sync_every):
    """More requests than slots, prompts across two buckets, ragged
    budgets: per-request tokens equal the JAX engine's and the port's own
    generate()'s at the request's bucket."""
    got, want, eng = _both(model, REQS, max_slots=max_slots,
                           max_len=BUCKETS[-1] + 6, prompt_pad=BUCKETS,
                           eos_token_id=-1, sync_every=sync_every)
    assert got == want
    _, tcfg, _, tparams = model
    for rid, emb, n in REQS:
        pad = next(b for b in BUCKETS if emb.shape[0] <= b)
        assert got[rid] == _generate_ref(tcfg, tparams, emb, n, pad=pad), rid
        assert len(got[rid]) == n
    assert eng.installs["full"] >= 2 and eng.installs["prefix"] == 0


def test_engine_eos_stops_early_and_refills(model):
    _, tcfg, _, tparams = model
    emb = _prompt(7, 4)
    eos = _generate_ref(tcfg, tparams, emb, 6)[2]
    reqs = [("x", emb, 8), ("y", _prompt(8, 3), 4), ("z", _prompt(9, 6), 5)]
    got, want, _ = _both(model, reqs, max_slots=1, max_len=8 + 8,
                         prompt_pad=8, eos_token_id=eos, sync_every=2)
    assert got == want
    assert got["x"][-1] == eos and len(got["x"]) == 3
    for rid, e, n in reqs:
        assert got[rid] == _generate_ref(tcfg, tparams, e, n, eos=eos), rid


@pytest.mark.parametrize("dedup", [False, True], ids=["replicated", "dedup"])
def test_shared_prefix_mixed_pool_matches_jax(model, dedup):
    """Prefix-shared suffix requests and full self-contained prompts share
    one pool (3 slots, 5 requests); a full prompt equal to prefix + suffix
    gives the prefix-shared request's stream, which equals generate() on
    the whole prompt."""
    s = _prompt(11, 4)
    full = np.concatenate([PREFIX, s], axis=0)            # 9 tokens
    reqs = [("pfx", s, 6), ("full", full, 6, False),
            ("p2", _prompt(12, 2), 5), ("p3", _prompt(13, 7), 4),
            ("f2", np.concatenate([PREFIX, _prompt(14, 3)]), 3, False)]
    got, want, eng = _both(
        model, reqs, max_slots=3, max_len=PREFIX.shape[0] + 8 + 6,
        prompt_pad=(8, PREFIX.shape[0] + 8), eos_token_id=-1, sync_every=2,
        shared_prefix_embeds=PREFIX, prefix_dedup=dedup)
    assert got == want
    assert got["pfx"] == got["full"]
    _, tcfg, _, tparams = model
    assert got["pfx"] == _generate_ref(tcfg, tparams, full, 6, pad=16)
    assert eng.prefix_cols == 128 and eng.prefix_len == PREFIX.shape[0]
    T = eng.state["kv_mask"].shape[1]
    assert (T < 128) if dedup else (T >= 128)
    assert eng.installs["prefix"] >= 1 and eng.installs["full"] >= 1


def test_prefix_kv_carried_from_jax_matches(model):
    """The JAX engine's shared-prefix KV, carried into the port by the
    weight bridge (in the bktd layout), equals the port engine's own within
    1e-5 over the prefix's real columns; a port engine seeded with the JAX
    prefix serves the same tokens.  The left-pad columns [0, Pc - Ps) are
    masked forever and may differ: JAX's XLA route gives a fully masked row
    the mean of v, K1 gives it 0 (ROADMAP.md §3)."""
    jcfg, tcfg, params, tparams = model
    kw = dict(max_slots=2, max_len=8 + 6, prompt_pad=8, eos_token_id=-1,
              shared_prefix_embeds=PREFIX, prefix_dedup=True)
    jeng = jserv.ContinuousBatcher(jcfg, params, cache_dtype=jnp.float32,
                                   **kw)
    teng = tserv.ContinuousBatcher(tcfg, tparams, cache_dtype=torch.float32,
                                   **kw)
    carried = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jeng.prefix_kv)).tree()
    for n in ("k", "v"):
        if jd.kv_cache_layout(jcfg) != "bktd":   # (L, Pc, 1, Hkv, D)
            carried[n] = carried[n].permute(0, 2, 3, 1, 4).contiguous()
        real = slice(teng.prefix_cols - teng.prefix_len, None)
        torch.testing.assert_close(carried[n][:, :, :, real],
                                   teng.prefix_kv[n][:, :, :, real],
                                   atol=1e-5, rtol=0)
    teng.prefix_kv = {n: t.detach() for n, t in carried.items()}
    reqs = REQS[:3]
    for rid, emb, n in reqs:
        jeng.submit(rid, emb, max_new_tokens=n)
        teng.submit(rid, emb, max_new_tokens=n)
    assert dict(teng.run()) == dict(jeng.run())


def test_chunked_installs_match_jax(model):
    reqs = [(f"r{i}", _prompt(30 + i, 2 + (i % 6)), 3 + (i % 4))
            for i in range(6)]
    got, want, eng = _both(model, reqs, max_slots=6, max_len=8 + 6,
                           prompt_pad=8, eos_token_id=-1,
                           max_prefill_rows=2)
    assert got == want
    assert eng.installs["full"] == 3


def test_sampled_serving_filter_and_token_validity():
    """filter_logits equals the JAX warper; sampled streams are seeded
    (same generator seed → same tokens), every token lies in the top-k
    set of its step, and near-zero temperature reproduces greedy."""
    # the module: the JAX package's infer/__init__ re-exports the function
    jgen = importlib.import_module("prot2text_tpu.infer.generate")
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 40)).astype(np.float32) * 3
    for kw in (dict(temperature=0.7, top_k=5), dict(top_p=0.8),
               dict(temperature=1.3, top_k=9, top_p=0.6)):
        want = jgen.filter_logits(jnp.asarray(logits),
                                  jgen.GenerationConfig(**kw))
        got = filter_logits(torch.from_numpy(logits), GenerationConfig(**kw))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)

    jcfg, tcfg = _cfgs(16)
    tparams = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jd.init_decoder_params(jcfg, jax.random.PRNGKey(0)))
    ).tree()

    def serve(gen_cfg, seed=0):
        eng = tserv.ContinuousBatcher(
            tcfg, tparams, max_slots=2, max_len=8 + 6, prompt_pad=8,
            eos_token_id=-1, cache_dtype=torch.float32, sync_every=2,
            gen_cfg=gen_cfg, generator=torch.Generator().manual_seed(seed))
        for rid, emb, n in REQS[:3]:
            eng.submit(rid, emb, max_new_tokens=n)
        return dict(eng.run())

    greedy = serve(None)
    cold = GenerationConfig(do_sample=True, temperature=1e-6,
                            eos_token_id=-1, pad_token_id=0)
    assert serve(cold) == greedy
    hot = GenerationConfig(do_sample=True, temperature=5.0, top_k=3,
                           eos_token_id=-1, pad_token_id=0)
    s1, s2 = serve(hot, seed=1), serve(hot, seed=1)
    assert s1 == s2
    for rid, emb, n in REQS[:3]:
        toks = s1[rid]
        assert len(toks) == n and all(0 <= t < jcfg.vocab_size
                                      for t in toks)
        # each sampled token is in the top-3 of the logits that produced
        # it: replay the stream through generate's teacher-forced prefill
        P = emb.shape[0]
        seq = torch.cat([torch.from_numpy(emb),
                         tparams["embed_tokens"][torch.tensor(toks[:-1])]])
        pos = torch.arange(P + n - 1)[None]
        h, _ = td.decoder_forward(
            tcfg, tparams, inputs_embeds=seq[None], positions=pos,
            attn_lengths=td.contiguous_lengths(torch.ones(1, P + n - 1)))
        lg = td.decoder_logits(tcfg, tparams, h)[0, P - 1:]
        top = torch.topk(lg, 3, dim=-1).indices
        assert all(t in top[i].tolist() for i, t in enumerate(toks)), rid


def test_engine_refusals():
    _, tcfg = _cfgs(16)
    jcfg, _ = _cfgs(16)
    tparams = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jd.init_decoder_params(jcfg, jax.random.PRNGKey(0)))
    ).tree()
    kw = dict(max_slots=1, max_len=12, prompt_pad=8,
              cache_dtype=torch.float32)
    # the int8 pool, prompt-lookup speculation and Medusa heads are
    # ported: they build the JAX engine's state (T a multiple of 32, 64
    # scratch columns under speculation on an int8 pool; Medusa's K heads
    # set γ and keep a frontier hidden state a slot, no history)
    eng = tserv.ContinuousBatcher(tcfg, tparams, **kw, kv_bits=8)
    assert eng.state["k"].dtype == torch.int8
    assert eng.state["k_scale"].shape == eng.state["k"].shape[:4]
    assert eng.state["kv_mask"].shape[1] == 32
    eng = tserv.ContinuousBatcher(tcfg, tparams, **kw, kv_bits=8,
                                  prompt_lookup_tokens=3)
    assert eng.state["kv_mask"].shape[1] == 96 and eng._spec_fused
    eng = tserv.ContinuousBatcher(tcfg, tparams, **kw,
                                  prompt_lookup_tokens=3)
    assert eng.state["hist"].shape == (1, 12 - 8 + 3 + 2)
    assert not eng._spec_fused
    heads = {"w": torch.zeros(3, tcfg.hidden_size, tcfg.hidden_size),
             "b": torch.zeros(3, tcfg.hidden_size)}
    eng = tserv.ContinuousBatcher(tcfg, tparams, **kw, medusa_params=heads)
    assert eng.spec_gamma == 3 and "hist" not in eng.state
    assert eng.state["last_hidden"].shape == (1, tcfg.hidden_size)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tserv.ContinuousBatcher(tcfg, tparams, **kw, medusa_params=heads,
                                prompt_lookup_tokens=3)
    with pytest.raises(ValueError, match="greedy-only"):
        tserv.ContinuousBatcher(
            tcfg, tparams, **kw, prompt_lookup_tokens=3,
            gen_cfg=GenerationConfig(do_sample=True))
    with pytest.raises(ValueError, match="prefix_dedup"):
        tserv.ContinuousBatcher(tcfg, tparams, **kw, prefix_dedup=True)
    eng = tserv.ContinuousBatcher(tcfg, tparams, **kw, eos_token_id=-1)
    with pytest.raises(ValueError, match="prompt_pad"):
        eng.submit("z", _prompt(10, 9), max_new_tokens=2)
    with pytest.raises(ValueError, match="use_prefix"):
        eng.submit("z", _prompt(10, 3), max_new_tokens=2, use_prefix=True)
    with pytest.raises(ValueError, match="slot cache width"):
        eng.submit("z", _prompt(10, 3), max_new_tokens=5)
