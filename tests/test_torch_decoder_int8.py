"""The port's decoder on an int8 KV cache and on per-row cache columns,
against the JAX decoder on the same f32 weights (carried by the bridge) and
inputs: `decoder_forward` through K1 (`attn_lengths`) and K6 (`bias`, with
the seeded-prefix offset, per-row (B,) columns and a batch-broadcast
int8 prefix), `decoder_decode_step` through K7/K9b (per-row slots, a
prefix, a scalar slot) against JAX's XLA route and its Pallas route in
interpret mode, `decoder_verify_chunk` (K8/K9c) against JAX's under forced
interpret; and `ngram_drafts` exactly against JAX's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prot2text_tpu.infer import serving as jserv
from prot2text_tpu.infer.kvcache import init_kv_cache as j_init
from prot2text_tpu.models import decoder as jd
from prot2text_tpu_torch.infer import serving as tserv
from prot2text_tpu_torch.infer.kvcache import init_kv_cache as t_init
from prot2text_tpu_torch.models import decoder as td
from prot2text_tpu_torch.models.weights import params_from_jax

ATOL = 1e-5
HIDDEN = 64
B, Pc = 3, 128


@pytest.fixture(scope="module")
def model():
    jcfg = jd.DecoderConfig(
        vocab_size=128, hidden_size=HIDDEN, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=128, head_dim=128,
        rope_theta=10000.0, qk_norm=True)
    tcfg = td.DecoderConfig(**jcfg.__dict__)
    params = jd.init_decoder_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                     params)).tree()
    return jcfg, tcfg, params, tparams


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _tt(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _assert_int8_close(got, want, pre):
    """Int8 caches identical except entries whose pre-rounding value
    (`pre`, x/scale on the port's side) lies within 1e-5 of a
    half-integer: those may differ by one level, and nothing else may."""
    got, want = got.astype(np.int32), want.astype(np.int32)
    diff = got != want
    if diff.any():
        assert np.abs(got - want)[diff].max() == 1
        frac = np.abs(np.abs(pre[diff]) % 1.0 - 0.5)
        assert frac.max() <= 1e-5, frac.max()


def _embeds(rng, S):
    return rng.standard_normal((B, S, HIDDEN)).astype(np.float32)


def _record_quant(monkeypatch):
    """Record x/scale of every quantize_kv call in the port's decoder."""
    from prot2text_tpu_torch.models import quant

    seen = []

    def rec(x, qmax=127.0):
        q, s = quant.quantize_kv(x, qmax)
        seen.append((x.float() / s[..., None]).detach().numpy())
        return q, s

    monkeypatch.setattr(td, "quantize_kv", rec)
    return seen


def test_forward_int8_attn_lengths_matches_jax(model, monkeypatch):
    """Prefill of left-padded rows into an int8 cache through K1."""
    jcfg, tcfg, params, tparams = model
    rng = np.random.default_rng(0)
    S, T = 8, 32
    emb = _embeds(rng, S)
    mask = np.ones((B, S), np.int32)
    mask[1, :3] = 0
    mask[2, :5] = 0
    pos = np.clip(np.cumsum(mask, 1) - 1, 0, None).astype(np.int32)
    causal = np.tril(np.ones((S, S), bool))[None, None] & (
        mask[:, None, None, :] > 0)
    bias = np.where(np.pad(causal, ((0, 0),) * 3 + ((0, T - S),)), 0.0,
                    np.finfo(np.float32).min).astype(np.float32)
    jh, jc = jd.decoder_forward(
        jcfg, params, inputs_embeds=jnp.asarray(emb),
        positions=jnp.asarray(pos), kv_cache=j_init(jcfg, B, T, kv_bits=8),
        cache_index=0, bias=jnp.asarray(bias),
        attn_lengths=jd.contiguous_lengths(jnp.asarray(mask)),
        attn_impl="xla")
    seen = _record_quant(monkeypatch)
    tcache = t_init(tcfg, B, T, device="cpu", kv_bits=8)
    th, _ = td.decoder_forward(
        tcfg, tparams, inputs_embeds=torch.from_numpy(emb),
        positions=torch.from_numpy(pos).long(),
        attn_lengths=td.contiguous_lengths(torch.from_numpy(mask)),
        kv_cache=tcache)
    # padded rows' outputs are never read; compare the valid positions
    valid = mask > 0
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid],
                               atol=ATOL, rtol=ATOL)
    # the cache at the valid columns (a padded query's output, and so the
    # next layer's k/v there, differs: JAX's XLA route gives a fully masked
    # row the mean of v, K1 gives it 0 — ROADMAP.md §3; those columns are
    # masked forever)
    jc = _np(jc)
    for li in range(tcfg.num_layers):
        for n, pre in (("k", seen[2 * li]), ("v", seen[2 * li + 1])):
            got = tcache[n][li, :, :, :S].numpy().transpose(0, 2, 1, 3)
            want = jc[n][li, :, :, :S].transpose(0, 2, 1, 3)
            _assert_int8_close(got[valid], want[valid],
                               pre.transpose(0, 2, 1, 3)[valid])
        for n in ("k_scale", "v_scale"):
            np.testing.assert_allclose(
                tcache[n][li, :, :, :S].numpy().transpose(0, 2, 1)[valid],
                jc[n][li, :, :, :S].transpose(0, 2, 1)[valid], rtol=1e-5)


@pytest.mark.parametrize("per_row", [False, True], ids=["slab", "per_row"])
@pytest.mark.parametrize("shared", [False, True], ids=["seeded", "prefix"])
def test_forward_int8_bias_matches_jax(model, monkeypatch, per_row, shared):
    """K6 over an int8 cache: an S-token chunk written at cache_index = Pc
    (a host int: the prefix install) or at per-row (B,) columns (the
    non-fused verify), with the prefix seeded in the cache's first Pc
    columns or read as a batch-broadcast int8 operand (dedup)."""
    jcfg, tcfg, params, tparams = model
    rng = np.random.default_rng(1 + per_row + 2 * shared)
    S = 4
    T = 96 if shared else Pc + 96
    # an int8 prefix from the JAX prefix prefill, and a random pool
    pe = rng.standard_normal((1, Pc, HIDDEN)).astype(np.float32)
    pm = (np.arange(Pc) >= Pc - 20).astype(np.int32)[None]
    pkv = _np(jserv._prefix_prefill(jcfg, params, jnp.asarray(pe),
                                    jnp.asarray(pm), prefix_cols=Pc,
                                    kv_bits=8))
    cache = _np(j_init(jcfg, B, T, kv_bits=8))
    for n in ("k", "v"):
        cache[n] = rng.integers(-127, 128, cache[n].shape).astype(np.int8)
    for n in ("k_scale", "v_scale"):
        cache[n] = rng.uniform(0.002, 0.03, cache[n].shape).astype(
            np.float32)
    off = 0 if shared else Pc
    if not shared:
        for n in cache:
            cache[n][:, :, :, :Pc] = pkv[n]
    if per_row:
        start = np.array([off + 5, off + 30, T - S], np.int32)
    else:
        start = off
    cols = np.arange(T)
    st = np.broadcast_to(start, (B,))[:, None, None, None]
    ok = (((cols >= st) & (cols <= st + np.arange(S)[None, None, :, None]))
          | ((cols < st) & (rng.random((B, 1, 1, T)) < 0.6)))
    ok[..., :Pc * (not shared)] &= (np.arange(Pc * (not shared))
                                    >= Pc - 20)
    bias = np.where(ok, 0.0, np.finfo(np.float32).min).astype(np.float32)
    pb = np.where((np.arange(Pc) >= Pc - 20)[None] & (np.arange(B) != 1)
                  [:, None], 0.0, np.finfo(np.float32).min).astype(
                      np.float32)[:, None, None, :]
    emb = _embeds(rng, S)
    pos = (np.broadcast_to(start, (B,))[:, None] + np.arange(S)).astype(
        np.int32)
    jkw = dict(prefix_kv={n: jnp.asarray(v) for n, v in pkv.items()},
               prefix_bias=jnp.asarray(pb)) if shared else {}
    jh, jc = jd.decoder_forward(
        jcfg, params, inputs_embeds=jnp.asarray(emb),
        positions=jnp.asarray(pos), bias=jnp.asarray(bias),
        kv_cache={n: jnp.asarray(v) for n, v in cache.items()},
        cache_index=jnp.asarray(start) if per_row else start,
        attn_impl="xla", **jkw)
    seen = _record_quant(monkeypatch)
    tcache = _tt(cache)
    tkw = dict(prefix_kv=_tt(pkv), prefix_bias=torch.from_numpy(pb)
               ) if shared else {}
    th, _ = td.decoder_forward(
        tcfg, tparams, inputs_embeds=torch.from_numpy(emb),
        positions=torch.from_numpy(pos).long(), bias=torch.from_numpy(bias),
        kv_cache=tcache,
        cache_index=torch.from_numpy(start) if per_row else start, **tkw)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL,
                               rtol=ATOL)
    jc = _np(jc)
    for li in range(tcfg.num_layers):
        for i, n in enumerate(("k", "v")):
            pre = np.zeros(cache[n].shape[1:], np.float32)
            for b in range(B):
                s0 = int(np.broadcast_to(start, (B,))[b])
                pre[b, :, s0:s0 + S] = seen[2 * li + i][b]
            _assert_int8_close(tcache[n][li].numpy(), jc[n][li], pre)
        for n in ("k_scale", "v_scale"):
            np.testing.assert_allclose(tcache[n][li].numpy(), jc[n][li],
                                       rtol=1e-5)


def _pool(rng, jcfg, T):
    cache = _np(j_init(jcfg, B, T, kv_bits=8))
    for n in ("k", "v"):
        cache[n] = rng.integers(-127, 128, cache[n].shape).astype(np.int8)
    for n in ("k_scale", "v_scale"):
        cache[n] = rng.uniform(0.002, 0.03, cache[n].shape).astype(
            np.float32)
    return cache


def _prefix(rng, jcfg, params):
    pe = rng.standard_normal((1, Pc, HIDDEN)).astype(np.float32)
    pm = (np.arange(Pc) >= Pc - 20).astype(np.int32)[None]
    pkv = _np(jserv._prefix_prefill(jcfg, params, jnp.asarray(pe),
                                    jnp.asarray(pm), prefix_cols=Pc,
                                    kv_bits=8))
    ok = (np.arange(Pc) >= Pc - 20)[None] & (np.arange(B) != 1)[:, None]
    pb = np.where(ok, 0.0, np.finfo(np.float32).min).astype(
        np.float32)[:, None, None, :]
    return pkv, pb


@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["per_row", "prefix", "scalar"])
def test_decode_step_int8_matches_jax(model, monkeypatch, route, kind):
    """K7/K9b through `decoder_decode_step`.  Against JAX's Pallas route in
    interpret mode: h within 1e-4 (the same rounding points; the bf16
    weights of two frameworks' exp may round apart on a tie) and the int8
    caches identical up to half-integer ties.  Against JAX's XLA route,
    which keeps the fp32 weights unrounded where the kernels round them to
    bf16 before ·V: h within 2e-3."""
    jcfg, tcfg, params, tparams = model
    if route == "pallas":
        monkeypatch.setenv("P2T_PALLAS_FORCE_INTERPRET", "1")
    rng = np.random.default_rng(7)
    T = 64
    cache = _pool(rng, jcfg, T)
    mask = (rng.random((B, T)) < 0.6).astype(np.int32)
    slots = 40 if kind == "scalar" else np.array([3, 40, T - 1], np.int32)
    mask[np.arange(B), np.broadcast_to(slots, (B,))] = 0
    emb = _embeds(rng, 1)
    pos = np.array([[17], [9], [30]], np.int32)
    jkw, tkw = {}, {}
    if kind == "prefix":
        pkv, pb = _prefix(rng, jcfg, params)
        jkw = dict(prefix_kv={n: jnp.asarray(v) for n, v in pkv.items()},
                   prefix_bias=jnp.asarray(pb))
        tkw = dict(prefix_kv=_tt(pkv), prefix_bias=torch.from_numpy(pb))
    bias_old = np.where(mask[:, None, None, :] > 0, 0.0,
                        np.finfo(np.float32).min).astype(np.float32)
    jh, jc = jd.decoder_decode_step(
        jcfg, params, token_embeds=jnp.asarray(emb),
        bias_old=jnp.asarray(bias_old), positions=jnp.asarray(pos),
        kv_cache={n: jnp.asarray(v) for n, v in cache.items()},
        cache_index=slots if kind == "scalar" else jnp.asarray(slots), **jkw)
    seen = _record_quant(monkeypatch)
    tcache = _tt(cache)
    th, _ = td.decoder_decode_step(
        tcfg, tparams, token_embeds=torch.from_numpy(emb),
        kv_mask=torch.from_numpy(mask), positions=torch.from_numpy(pos).long(),
        kv_cache=tcache,
        cache_index=slots if kind == "scalar" else torch.from_numpy(slots),
        **tkw)
    atol = 1e-4 if route == "pallas" else 2e-3
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=atol,
                               rtol=atol)
    jc = _np(jc)
    for li in range(tcfg.num_layers):
        for i, n in enumerate(("k", "v")):
            pre = np.zeros(cache[n].shape[1:], np.float32)
            for b, s in enumerate(np.broadcast_to(slots, (B,))):
                pre[b, :, s] = seen[2 * li + i][b]
            if route == "pallas" or li == 0:
                _assert_int8_close(tcache[n][li].numpy(), jc[n][li], pre)
            else:
                # the XLA route's unrounded weights move the next layer's
                # k/v by up to 2e-3: one quantization level at most
                assert np.abs(tcache[n][li].numpy().astype(np.int32)
                              - jc[n][li].astype(np.int32)).max() <= 1
        for n in ("k_scale", "v_scale"):
            np.testing.assert_allclose(
                tcache[n][li].numpy(), jc[n][li],
                rtol=1e-5 if route == "pallas" or li == 0 else 2e-3)


@pytest.mark.parametrize("prefix", [False, True])
def test_verify_chunk_matches_jax_interpret(model, monkeypatch, prefix):
    """K8/K9c through `decoder_verify_chunk` against JAX's fused route in
    interpret mode: h within 1e-4, caches identical up to half-integer
    ties, scales within 1e-5."""
    jcfg, tcfg, params, tparams = model
    monkeypatch.setenv("P2T_PALLAS_FORCE_INTERPRET", "1")
    rng = np.random.default_rng(11 + prefix)
    T, G = 96, 5
    cache = _pool(rng, jcfg, T)
    starts = np.array([3, 29, T - 64], np.int32)
    mask = (rng.random((B, T)) < 0.6).astype(np.int32)
    for b, s in enumerate(starts):
        mask[b, s:s + G] = 0
    emb = _embeds(rng, G)
    pos = (np.array([[17], [9], [30]]) + np.arange(G)).astype(np.int32)
    jkw, tkw = {}, {}
    if prefix:
        pkv, pb = _prefix(rng, jcfg, params)
        jkw = dict(prefix_kv={n: jnp.asarray(v) for n, v in pkv.items()},
                   prefix_bias=jnp.asarray(pb))
        tkw = dict(prefix_kv=_tt(pkv), prefix_bias=torch.from_numpy(pb))
    jcache = {n: jnp.asarray(v) for n, v in cache.items()}
    assert jd.supports_verify_chunk_step(jcfg, jcache, G,
                                         prefix_cols=Pc if prefix else 0)
    jh, jc = jd.decoder_verify_chunk(
        jcfg, params, token_embeds=jnp.asarray(emb),
        kv_mask01=jnp.asarray(mask), positions=jnp.asarray(pos),
        kv_cache=jcache, cache_index=jnp.asarray(starts), **jkw)
    seen = _record_quant(monkeypatch)
    tcache = _tt(cache)
    assert td.supports_verify_chunk_step(tcfg, tcache, G)
    th, _ = td.decoder_verify_chunk(
        tcfg, tparams, token_embeds=torch.from_numpy(emb),
        kv_mask=torch.from_numpy(mask), positions=torch.from_numpy(pos).long(),
        kv_cache=tcache, cache_index=torch.from_numpy(starts), **tkw)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4,
                               rtol=1e-4)
    jc = _np(jc)
    for li in range(tcfg.num_layers):
        for i, n in enumerate(("k", "v")):
            pre = np.zeros(cache[n].shape[1:], np.float32)
            for b, s in enumerate(starts):
                # the port quantizes (B, Hkv, G, D) for k and v alike
                pre[b, :, s:s + G] = seen[2 * li + i][b]
            _assert_int8_close(tcache[n][li].numpy(), jc[n][li], pre)
        for n in ("k_scale", "v_scale"):
            np.testing.assert_allclose(tcache[n][li].numpy(), jc[n][li],
                                       rtol=1e-5)


def test_ngram_drafts_match_jax():
    """Random histories with -1 sentinels inside the valid span, rows with
    no match (fallback), a row with a period shorter than gamma, ragged
    lengths."""
    rng = np.random.default_rng(3)
    Bh, HW = 6, 40
    hist = rng.integers(0, 6, (Bh, HW)).astype(np.int32)
    hist[1, 3:7] = -1                         # sentinels (prompt padding)
    hist[2] = np.arange(HW) + 100             # no repeated n-gram at all
    hist[3, :12] = np.tile([7, 8], 6)         # period 2 < gamma
    hist_len = np.array([20, 15, 18, 12, 1, 33], np.int32)
    for gamma, ngram in ((4, 2), (3, 1), (5, 3)):
        for fallback in (0, 9):
            want = jserv.ngram_drafts(jnp.asarray(hist),
                                      jnp.asarray(hist_len), gamma=gamma,
                                      ngram=ngram, fallback=fallback)
            got = tserv.ngram_drafts(torch.from_numpy(hist).long(),
                                     torch.from_numpy(hist_len).long(),
                                     gamma=gamma, ngram=ngram,
                                     fallback=fallback)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tserv.ngram_drafts(torch.from_numpy(hist).long(),
                             torch.from_numpy(hist_len).long(), gamma=4,
                             ngram=2)
    assert got[3].tolist() == [7, 8, 7, 8]
