"""The port's int8 KV pool and prompt-lookup speculative serving
(infer/serving.py) against the JAX engine and against the port's own
references:

  * the bf16-pool speculative engine in f32 equals the JAX engine (XLA
    route) per request, and the port's own plain engine, with γ 2 and 4,
    sync_every 1 and 8, ragged budgets, an EOS stop, and no, replicated
    and dedup prefixes in pools mixing prefix-shared and full prompts;
  * the adaptive controller takes the JAX engine's sequence of speculative
    and plain dispatches and counts the same fallbacks;
  * the int8 engine equals the port's `generate(kv_bits=8)` per request,
    with no, a replicated and a dedup prefix;
  * the int8 engine and the int8 speculative engine (fused verify, K8/K9c
    plain versions) equal the JAX engines (Pallas kernels in interpret
    mode) on a tiny bf16 model whose top-1 margins the test first asserts
    to be far above the bf16 error at every step (random bf16 weights near
    a tie would make any argmax comparison meaningless)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prot2text_tpu.infer import serving as jserv
from prot2text_tpu.models import decoder as jd
from prot2text_tpu_torch.infer import serving as tserv
from prot2text_tpu_torch.infer.generate import GenerationConfig, generate
from prot2text_tpu_torch.models import decoder as td
from prot2text_tpu_torch.models.weights import params_from_jax

HIDDEN = 64


def _model(head_dim, dtype=jnp.float32, successor=0.0, seed=0):
    """A tiny Qwen3-style decoder.  successor=c > 0 scales the token
    embeddings up 20-fold, so that they dominate the residual stream, and
    replaces the LM head by c times their directions, permuted: each
    token's logit for its successor leads the others by a wide margin
    (decisive greedy steps)."""
    jcfg = jd.DecoderConfig(
        vocab_size=128, hidden_size=HIDDEN, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=128, head_dim=head_dim,
        rope_theta=10000.0, qk_norm=True)
    params = jd.init_decoder_params(jcfg, jax.random.PRNGKey(seed), dtype)
    if successor:
        E = np.asarray(params["embed_tokens"]).astype(np.float32)
        succ = np.random.default_rng(seed).permutation(jcfg.vocab_size)
        W = np.zeros((HIDDEN, jcfg.vocab_size), np.float32)
        W[:, succ] = E.T * successor
        params["lm_head"]["kernel"] = jnp.asarray(W, dtype)
        params["embed_tokens"] = jnp.asarray(E * 20.0, dtype)
    tparams = params_from_jax(
        jax.tree_util.tree_map(np.asarray, params),
        dtype=torch.bfloat16 if dtype == jnp.bfloat16 else None).tree()
    return jcfg, td.DecoderConfig(**jcfg.__dict__), params, tparams


def _prompt(seed, P):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((P, HIDDEN)).astype(np.float32)


PREFIX = _prompt(99, 5)


def _serve(eng, reqs):
    for rid, emb, n, *upfx in reqs:
        eng.submit(rid, emb, max_new_tokens=n,
                   use_prefix=upfx[0] if upfx else None)
    return dict(eng.run())


@pytest.fixture(scope="module")
def f32_model():
    return _model(16)


def _reqs(prefix):
    """Ragged budgets; with a prefix, two full-prompt requests share the
    pool with the suffix ones."""
    reqs = [("a", _prompt(1, 3), 9), ("b", _prompt(2, 6), 4),
            ("c", _prompt(3, 7), 12), ("d", _prompt(4, 2), 7)]
    if prefix:
        reqs += [("f1", np.concatenate([PREFIX, _prompt(5, 3)]), 8, False),
                 ("f2", np.concatenate([PREFIX, _prompt(6, 4)]), 5, False)]
    return reqs


@pytest.mark.parametrize("gamma,sync_every", [(2, 1), (4, 8)])
@pytest.mark.parametrize("prefix", ["none", "replicated", "dedup"])
def test_bf16_pool_spec_engine_matches_jax_and_plain(f32_model, gamma,
                                                     sync_every, prefix):
    jcfg, tcfg, params, tparams = f32_model
    reqs = _reqs(prefix != "none")
    width = 16
    kw = dict(max_slots=3, max_len=width + 12, prompt_pad=(8, width),
              sync_every=sync_every)
    if prefix != "none":
        kw.update(shared_prefix_embeds=PREFIX,
                  prefix_dedup=prefix == "dedup")
    # an EOS taken from request "a"'s plain stream stops it early
    probe = tserv.ContinuousBatcher(tcfg, tparams, eos_token_id=-1,
                                    cache_dtype=torch.float32, **kw)
    eos = _serve(probe, reqs[:1])["a"][3]
    spec = tserv.ContinuousBatcher(tcfg, tparams, eos_token_id=eos,
                                   cache_dtype=torch.float32,
                                   prompt_lookup_tokens=gamma, **kw)
    got = _serve(spec, reqs)
    want = _serve(jserv.ContinuousBatcher(
        jcfg, params, eos_token_id=eos, cache_dtype=jnp.float32,
        prompt_lookup_tokens=gamma, **kw), reqs)
    plain = _serve(tserv.ContinuousBatcher(
        tcfg, tparams, eos_token_id=eos, cache_dtype=torch.float32, **kw),
        reqs)
    assert got == want
    assert got == plain
    assert got["a"][-1] == eos and len(got["a"]) <= 4
    assert not spec._spec_fused and spec.verify_rounds > 0
    assert spec.plain_steps == 0 and spec.steps == spec.verify_rounds
    assert spec.state["kv_mask"].shape == tuple(
        jserv.ContinuousBatcher(jcfg, params, eos_token_id=eos,
                                cache_dtype=jnp.float32,
                                prompt_lookup_tokens=gamma,
                                **kw).state["kv_mask"].shape)
    assert 1.0 <= spec.acceptance() <= gamma + 1


def test_controller_matches_jax(f32_model):
    """spec_break_even > 0: the same speculative/plain dispatch sequence
    and fallback count as the JAX engine, and the same tokens."""
    jcfg, tcfg, params, tparams = f32_model
    reqs = _reqs(False)
    kw = dict(max_slots=2, max_len=8 + 12, prompt_pad=8, eos_token_id=-1,
              sync_every=3, prompt_lookup_tokens=2, spec_break_even=2.2,
              spec_probe_every=2)

    def run(eng):
        seq = []
        dispatch = eng._spec_dispatch

        def logged():
            seq.append(dispatch())
            return seq[-1]

        eng._spec_dispatch = logged
        return _serve(eng, reqs), seq, eng

    got, tseq, teng = run(tserv.ContinuousBatcher(
        tcfg, tparams, cache_dtype=torch.float32, **kw))
    want, jseq, jeng = run(jserv.ContinuousBatcher(
        jcfg, params, cache_dtype=jnp.float32, **kw))
    assert got == want
    assert tseq == jseq and False in tseq and True in tseq
    assert teng.spec_fallbacks == jeng.spec_fallbacks > 0
    assert teng.steps == jeng.steps
    assert teng.plain_steps == 3 * teng.spec_fallbacks


def _generate_kv8(tcfg, tparams, emb_unpadded, n, pad):
    P = emb_unpadded.shape[0]
    emb = torch.zeros((1, pad, HIDDEN), dtype=torch.bfloat16)
    emb[0, pad - P:] = torch.from_numpy(emb_unpadded)
    mask = torch.zeros((1, pad), dtype=torch.int32)
    mask[0, pad - P:] = 1
    return generate(tcfg, tparams, inputs_embeds=emb, attention_mask=mask,
                    gen_cfg=GenerationConfig(max_new_tokens=n,
                                             eos_token_id=-1,
                                             pad_token_id=0),
                    kv_bits=8)[0].tolist()


@pytest.mark.parametrize("prefix", ["none", "replicated", "dedup"])
def test_int8_engine_matches_generate_kv8(prefix):
    """The int8 pool serves each request the tokens of the port's own
    generate(kv_bits=8) on its (full) prompt: the prefix's int8 values and
    scales are per-(head, token), so seeded, replicated or read as the
    dedup operand they equal a full-prompt prefill's."""
    _, tcfg, _, tparams = _model(128, jnp.bfloat16)
    suffixes = [_prompt(20 + i, 3 + 2 * i) for i in range(3)]
    budgets = [6, 4, 8]
    kw = dict(max_slots=2, max_len=16 + 10, prompt_pad=16, eos_token_id=-1,
              cache_dtype=torch.bfloat16, kv_bits=8)
    if prefix != "none":
        kw.update(shared_prefix_embeds=PREFIX,
                  prefix_dedup=prefix == "dedup")
    eng = tserv.ContinuousBatcher(tcfg, tparams, **kw)
    assert eng.state["k"].dtype == torch.int8
    got = _serve(eng, [(i, s, n) for i, (s, n) in
                       enumerate(zip(suffixes, budgets))])
    for i, (s, n) in enumerate(zip(suffixes, budgets)):
        full = s if prefix == "none" else np.concatenate([PREFIX, s])
        assert got[i] == _generate_kv8(tcfg, tparams, full, n,
                                       16 if prefix == "none" else 32), i


def _margins(tcfg, tparams, prompt, toks, prefix=None):
    """Top-1 minus top-2 logit at every generated position, from an fp32
    teacher-forced forward over prompt + tokens."""
    p32 = jax.tree_util.tree_map(lambda t: t.float(), tparams)
    seq = prompt if prefix is None else np.concatenate([prefix, prompt])
    x = torch.cat([torch.from_numpy(seq),
                   p32["embed_tokens"][torch.tensor(toks[:-1])]])[None]
    n = x.shape[1]
    h, _ = td.decoder_forward(
        tcfg, p32, inputs_embeds=x, positions=torch.arange(n)[None],
        attn_lengths=td.contiguous_lengths(torch.ones(1, n)))
    lg = td.decoder_logits(tcfg, p32, h)[0, len(seq) - 1:]
    top = torch.topk(lg, 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).min().item()


SUCC = 20.0
MARGIN = 2.0        # vs logits of magnitude ~30 computed in bf16 with an
                    # int8 cache: ~1% error, well under half the margin


def _token_prompt(params, seed, P):
    """A prompt of token embeddings (so the first step is decisive too)."""
    E = np.asarray(params["embed_tokens"]).astype(np.float32)
    return E[np.random.default_rng(seed).integers(0, E.shape[0], P)]


@pytest.mark.parametrize("gamma", [0, 3], ids=["plain", "spec"])
@pytest.mark.parametrize("dedup", [False, True], ids=["no_prefix", "dedup"])
def test_int8_engines_match_jax_with_margin(monkeypatch, gamma, dedup):
    monkeypatch.setenv("P2T_PALLAS_FORCE_INTERPRET", "1")
    jcfg, tcfg, params, tparams = _model(128, jnp.bfloat16, successor=SUCC,
                                         seed=5)
    reqs = [(f"r{i}", _token_prompt(params, 40 + i, 3 + 2 * i), n)
            for i, n in enumerate((10, 7, 12))]
    kw = dict(max_slots=2, max_len=16 + 12, prompt_pad=16, eos_token_id=-1,
              sync_every=4, kv_bits=8, prompt_lookup_tokens=gamma)
    if dedup:
        kw.update(shared_prefix_embeds=PREFIX, prefix_dedup=True)
    teng = tserv.ContinuousBatcher(tcfg, tparams, cache_dtype=torch.bfloat16,
                                   **kw)
    got = _serve(teng, reqs)
    for rid, emb, _ in reqs:
        m = _margins(tcfg, tparams, emb, got[rid],
                     PREFIX if dedup else None)
        assert m > MARGIN, (
            f"request {rid}: top-1 margin {m:.3f} <= {MARGIN}: too close to "
            f"a tie to compare bf16 engines of two frameworks; pick another "
            f"seed")
    jeng = jserv.ContinuousBatcher(jcfg, params, cache_dtype=jnp.bfloat16,
                                   **kw)
    want = _serve(jeng, reqs)
    assert got == want
    if gamma:
        assert teng._spec_fused and jeng._spec_fused
        assert teng.verify_rounds > 0 and teng.plain_steps == 0


def test_int8_prefix_carried_from_jax(monkeypatch):
    """The JAX engine's int8 shared-prefix tree ({"k","v","k_scale",
    "v_scale"}, prefilled in f32), carried into the port by the weight
    bridge, equals the port engine's own over the prefix's real columns
    (scales within 1e-5 relative; int8 values equal but for one-level
    flips at half-integer pre-images, at most 1% of them), and a port
    engine seeded with it serves the same tokens as with its own prefix.
    The left-pad columns are masked forever and may differ (ROADMAP.md
    §3)."""
    jcfg, tcfg, params, tparams = _model(128, jnp.float32, successor=SUCC,
                                         seed=5)
    kw = dict(max_slots=2, max_len=16 + 8, prompt_pad=16, eos_token_id=-1,
              sync_every=4, kv_bits=8, shared_prefix_embeds=PREFIX,
              prefix_dedup=True)
    jeng = jserv.ContinuousBatcher(jcfg, params, cache_dtype=jnp.float32,
                                   **kw)
    teng = tserv.ContinuousBatcher(tcfg, tparams, cache_dtype=torch.float32,
                                   **kw)
    carried = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jeng.prefix_kv)).tree()
    assert set(carried) == {"k", "v", "k_scale", "v_scale"}
    real = slice(teng.prefix_cols - teng.prefix_len, None)
    for n in ("k_scale", "v_scale"):
        torch.testing.assert_close(carried[n][..., real],
                                   teng.prefix_kv[n][..., real],
                                   atol=0, rtol=1e-5)
    for n in ("k", "v"):
        assert carried[n].dtype == torch.int8
        a = carried[n][:, :, :, real].int()
        b = teng.prefix_kv[n][:, :, :, real].int()
        assert (a - b).abs().max() <= 1
        assert (a != b).float().mean() <= 0.01
    reqs = [(f"r{i}", _token_prompt(params, 40 + i, 3 + 2 * i), n)
            for i, n in enumerate((8, 5, 7))]
    want = _serve(teng, reqs)
    seeded = tserv.ContinuousBatcher(tcfg, tparams,
                                     cache_dtype=torch.float32, **kw)
    seeded.prefix_kv = carried
    assert _serve(seeded, reqs) == want
