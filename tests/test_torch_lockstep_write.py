"""The bf16 lockstep decode step's slot write (bktd cache, a host-int
`cache_index`): the port runs K4 (`decode_attention_stacked_write`) once a
layer on one (B,) slots tensor a step, which attends and writes the
token's k/v into the slot, and calls neither K2 nor K3; JAX's default
route is K2 per layer and K3 after the loop, its `P2T_FUSED_CACHE_WRITE=1`
route K4 per layer.  Held here in f32 against both JAX routes over N
steps: the last hidden states within 1e-4 and the caches within 1e-5, in
JAX's XLA route and its Pallas route in interpret mode; and K4's plain
version against K2's plain attention followed by K3's plain write, bit for
bit (the two routes' CPU functions)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import prot2text_tpu.kernels.cache_update as j_cu
import prot2text_tpu.kernels.decode_attention as j_da
from prot2text_tpu.infer.kvcache import init_kv_cache as j_init
from prot2text_tpu.models import decoder as jd
from prot2text_tpu_torch.kernels import cache_update as t_cu
from prot2text_tpu_torch.kernels import decode_attention as t_da
from prot2text_tpu_torch.models import decoder as td
from prot2text_tpu_torch.models.weights import params_from_jax

H_ATOL = 1e-4
CACHE_ATOL = 1e-5
HIDDEN, B, T, N = 64, 4, 32, 4


@pytest.fixture(scope="module")
def model():
    """head_dim 128: the bktd cache (`kv_cache_layout`); with B 4 and
    Hkv 2 JAX's Pallas route takes its in-place K3 (B·Hkv % 8 == 0)."""
    jcfg = jd.DecoderConfig(
        vocab_size=128, hidden_size=HIDDEN, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=128, head_dim=128,
        rope_theta=10000.0, qk_norm=True)
    tcfg = td.DecoderConfig(**jcfg.__dict__)
    params = jd.init_decoder_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                     params)).tree()
    return jcfg, tcfg, params, tparams


def _start(jcfg, seed):
    """A cache whose first 20 columns hold random values behind a
    left-padded mask, the slots from 20 on free, and N steps' embeddings
    and positions."""
    rng = np.random.default_rng(seed)
    cache = {n: np.asarray(v) for n, v in j_init(jcfg, B, T).items()}
    for n in cache:
        cache[n] = cache[n].copy()
        cache[n][:, :, :, :20] = rng.standard_normal(
            cache[n][:, :, :, :20].shape).astype(np.float32)
    pad = np.array([0, 3, 11, 5])
    mask = ((np.arange(T)[None] >= pad[:, None])
            & (np.arange(T)[None] < 20)).astype(np.int32)
    emb = rng.standard_normal((N, B, 1, HIDDEN)).astype(np.float32)
    pos = (20 - pad)[:, None].astype(np.int32)
    return cache, mask, emb, pos


def _count(monkeypatch, mod, name, calls, record=None):
    orig = getattr(mod, name)

    def wrapper(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        if record is not None:
            record.append(a)
        return orig(*a, **k)

    monkeypatch.setattr(mod, name, wrapper)


def _run_port(tcfg, tparams, cache, mask, emb, pos):
    tcache = {n: torch.from_numpy(v.copy()) for n, v in cache.items()}
    mask = torch.from_numpy(mask.copy())
    hs = []
    for t in range(N):
        h, tcache = td.decoder_decode_step(
            tcfg, tparams, token_embeds=torch.from_numpy(emb[t]),
            kv_mask=mask, positions=torch.from_numpy(pos + t).long(),
            kv_cache=tcache, cache_index=20 + t)
        mask[:, 20 + t] = 1
        hs.append(h.numpy())
    return hs, tcache


def _run_jax(jcfg, params, cache, mask, emb, pos):
    jcache = {n: jnp.asarray(v) for n, v in cache.items()}
    mask = mask.copy()
    hs = []
    for t in range(N):
        bias = np.where(mask[:, None, None, :] > 0, 0.0,
                        np.finfo(np.float32).min).astype(np.float32)
        h, jcache = jd.decoder_decode_step(
            jcfg, params, token_embeds=jnp.asarray(emb[t]),
            bias_old=jnp.asarray(bias), positions=jnp.asarray(pos + t),
            kv_cache=jcache, cache_index=20 + t)
        mask[:, 20 + t] = 1
        hs.append(np.asarray(h))
    return hs, {n: np.asarray(v) for n, v in jcache.items()}


def test_lockstep_step_routes_through_k4(model, monkeypatch):
    """One K4 call a layer a step, all of a step's calls on one (B,) int32
    slots tensor of the step's slot; no K2 and no K3 call, by the names
    `models/decoder.py` imports (and the kernels' modules, for any other
    path)."""
    _, tcfg, _, tparams = model
    calls, seen = {}, []
    _count(monkeypatch, td, "decode_attention_stacked_write", calls, seen)
    _count(monkeypatch, t_da, "decode_attention_stacked", calls)
    _count(monkeypatch, t_cu, "cache_slot_write_bkt", calls)
    cache, mask, emb, pos = _start(model[0], seed=0)
    _run_port(tcfg, tparams, cache, mask, emb, pos)
    L = tcfg.num_layers
    assert calls == {"decode_attention_stacked_write": L * N}, calls
    for t in range(N):
        slots = {id(a[7]) for a in seen[t * L:(t + 1) * L]}
        assert len(slots) == 1, "one slots tensor a step"
        s = seen[t * L][7]
        assert torch.is_tensor(s) and s.dtype == torch.int32
        assert s.tolist() == [20 + t] * B
    assert not hasattr(td, "decode_attention_stacked")
    assert not hasattr(td, "cache_slot_write_bkt")


@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("jax_write", ["split", "fused"])
def test_lockstep_cache_matches_jax(model, monkeypatch, route, jax_write):
    """N steps of the port's lockstep step against JAX's in f32, under
    JAX's default split write (K2 + K3) and its fused write (K4,
    `P2T_FUSED_CACHE_WRITE=1`, set for the JAX side only: the port reads
    no environment variable), in its XLA route and its Pallas route in
    interpret mode (the kernels counted): every step's h within 1e-4, the
    caches after N steps within 1e-5."""
    jcfg, tcfg, params, tparams = model
    jax.clear_caches()          # JAX reads the environment when it traces
    calls = {}
    if route == "pallas":
        monkeypatch.setenv("P2T_PALLAS_FORCE_INTERPRET", "1")
        for name in ("decode_attention_stacked",
                     "decode_attention_stacked_write"):
            _count(monkeypatch, j_da, name, calls)
        _count(monkeypatch, j_cu, "cache_slot_write_bkt", calls)
    if jax_write == "fused":
        monkeypatch.setenv("P2T_FUSED_CACHE_WRITE", "1")
    cache, mask, emb, pos = _start(jcfg, seed=1)
    jhs, jcache = _run_jax(jcfg, params, cache, mask, emb, pos)
    if route == "pallas":
        want = ({"decode_attention_stacked_write"} if jax_write == "fused"
                else {"decode_attention_stacked", "cache_slot_write_bkt"})
        assert set(calls) == want, calls
    monkeypatch.delenv("P2T_FUSED_CACHE_WRITE", raising=False)
    ths, tcache = _run_port(tcfg, tparams, cache, mask, emb, pos)
    for th, jh in zip(ths, jhs):
        np.testing.assert_allclose(th, jh, atol=H_ATOL, rtol=0)
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache[n].numpy(), jcache[n],
                                   atol=CACHE_ATOL, rtol=0)
        # the columns no step wrote are the start's, bit for bit
        assert np.array_equal(tcache[n].numpy()[:, :, :, :20],
                              cache[n][:, :, :, :20])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_plain_is_k2_plain_then_k3_plain(dtype):
    """On the CPU the two routes' functions agree bit for bit: K4's plain
    version at a scalar slot broadcast to (B,) gives K2's plain attention
    and leaves the cache K3's plain write leaves, layer by layer."""
    g = torch.Generator().manual_seed(5)
    L, Bq, Hkv, rep, Tq, D = 3, 2, 2, 4, 24, 128
    ck = torch.randn((L, Bq, Hkv, Tq, D), generator=g).to(dtype)
    cv = torch.randn((L, Bq, Hkv, Tq, D), generator=g).to(dtype)
    qg = (torch.randn((Bq, Hkv, rep, D), generator=g) * D ** -0.5).to(dtype)
    kn = torch.randn((L, Bq, Hkv, D), generator=g).to(dtype)
    vn = torch.randn((L, Bq, Hkv, D), generator=g).to(dtype)
    mask = (torch.arange(Tq)[None] < torch.tensor([[17], [12]])).to(
        torch.int32)
    slot = 17
    slots = torch.full((Bq,), slot, dtype=torch.int32)
    k4, v4 = ck.clone(), cv.clone()
    for li in range(L):
        a4 = t_da.decode_attention_stacked_write_plain(
            qg, k4, v4, mask, kn[li], vn[li], li, slots)
        a2 = t_da.decode_attention_stacked_plain(qg, ck, cv, mask, kn[li],
                                                 vn[li], li)
        assert torch.equal(a4, a2)
    t_cu.cache_slot_write_bkt_plain(ck, kn, slot)
    t_cu.cache_slot_write_bkt_plain(cv, vn, slot)
    assert torch.equal(k4, ck) and torch.equal(v4, cv)
