"""The tbkd lockstep decode step's slot write (the sequence-leading
(L, T, B, Hkv, D) cache of head dims off the 128 grid, a host-int
`cache_index`): the port runs K4 (`decode_attention_stacked_write(...,
layout="tbkd")`) once a layer on one (B,) slots tensor a step, which
attends and writes the token's k/v into the slot at the tbkd strides, and
calls neither the einsum attention as a route nor K12; JAX's tbkd step
attends by einsum and writes every layer's slot after the loop (K12 on
its Pallas route, `dynamic_update_slice` on its XLA route).  Held here in
f32 against both JAX routes over N steps: every step's h and the caches
within 1e-5.  On the CPU, K4's plain version on tbkd is the einsum
attention followed by K12's plain write, bit for bit, and it agrees with
the plain bktd K4 on the permuted cache within 1e-6 in f32 (the written
caches equal once permuted).  On the card, the tbkd K4 is bit-identical to
the bktd K4 on the permuted cache, in bf16 and in f32."""

import numpy as np
import pytest
import torch

from prot2text_tpu_torch.kernels import cache_update as t_cu
from prot2text_tpu_torch.kernels import decode_attention as t_da
from prot2text_tpu_torch.models import decoder as td

ATOL = 1e-5
HIDDEN, B, T, N = 64, 4, 32, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model():
    """head_dim 64: the tbkd cache (`kv_cache_layout`); B 4, Hkv 2, D 64
    make N = B·Hkv·D = 512, so JAX's Pallas route takes its K12."""
    import jax

    from prot2text_tpu.models import decoder as jd
    from prot2text_tpu_torch.models.weights import params_from_jax

    jcfg = jd.DecoderConfig(
        vocab_size=128, hidden_size=HIDDEN, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=128, head_dim=64,
        rope_theta=10000.0)
    tcfg = td.DecoderConfig(**jcfg.__dict__)
    assert td.kv_cache_layout(tcfg) == jd.kv_cache_layout(jcfg) == "tbkd"
    params = jd.init_decoder_params(jcfg, jax.random.PRNGKey(4))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                     params)).tree()
    return jcfg, tcfg, params, tparams


def _start(jcfg, seed):
    """A tbkd cache whose first 20 columns hold random values behind a
    left-padded mask, the slots from 20 on free, and N steps' embeddings
    and positions."""
    from prot2text_tpu.infer.kvcache import init_kv_cache as j_init

    rng = np.random.default_rng(seed)
    cache = {n: np.asarray(v).copy() for n, v in j_init(jcfg, B, T).items()}
    for n in cache:
        assert cache[n].shape[1:3] == (T, B)
        cache[n][:, :20] = rng.standard_normal(
            cache[n][:, :20].shape).astype(np.float32)
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
            record.append((a, k))
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
    import jax.numpy as jnp

    from prot2text_tpu.models import decoder as jd

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


def test_tbkd_lockstep_step_routes_through_k4(model, monkeypatch):
    """One K4 call a layer a step at layout "tbkd", all of a step's calls
    on one (B,) int32 slots tensor of the step's slot; no K12 (nor K13)
    call, and the decoder no longer holds the einsum attention or K12 as a
    route."""
    _, tcfg, _, tparams = model
    calls, seen = {}, []
    _count(monkeypatch, td, "decode_attention_stacked_write", calls, seen)
    _count(monkeypatch, t_cu, "cache_slot_write", calls)
    _count(monkeypatch, t_cu, "cache_slot_write_kv", calls)
    cache, mask, emb, pos = _start(model[0], seed=0)
    _run_port(tcfg, tparams, cache, mask, emb, pos)
    L = tcfg.num_layers
    assert calls == {"decode_attention_stacked_write": L * N}, calls
    for t in range(N):
        step = seen[t * L:(t + 1) * L]
        assert [a[6] for a, _ in step] == list(range(L))
        assert all(k == {"layout": "tbkd"} for _, k in step)
        slots = {id(a[7]) for a, _ in step}
        assert len(slots) == 1, "one slots tensor a step"
        s = step[0][0][7]
        assert torch.is_tensor(s) and s.dtype == torch.int32
        assert s.tolist() == [20 + t] * B
    assert not hasattr(td, "_tbkd_decode_attention")
    assert not hasattr(td, "cache_slot_write")


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_tbkd_lockstep_matches_jax(model, monkeypatch, route):
    """N steps of the port's tbkd lockstep step against JAX's in f32, on
    JAX's split write: `dynamic_update_slice` on its XLA route, K12 in
    interpret mode on its Pallas route (counted, twice a step; its decode
    attention stays the einsum on tbkd): every step's h and the caches
    after N steps within 1e-5, the columns no step wrote bit for bit."""
    import jax

    import prot2text_tpu.kernels.cache_update as j_cu

    jcfg, tcfg, params, tparams = model
    jax.clear_caches()          # JAX reads the environment when it traces
    calls = {}
    if route == "pallas":
        monkeypatch.setenv("P2T_PALLAS_FORCE_INTERPRET", "1")
        _count(monkeypatch, j_cu, "cache_slot_write", calls)
    cache, mask, emb, pos = _start(jcfg, seed=1)
    jhs, jcache = _run_jax(jcfg, params, cache, mask, emb, pos)
    if route == "pallas":
        assert calls == {"cache_slot_write": 2 * N}, calls
    ths, tcache = _run_port(tcfg, tparams, cache, mask, emb, pos)
    for th, jh in zip(ths, jhs):
        np.testing.assert_allclose(th, jh, atol=ATOL, rtol=0)
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache[n].numpy(), jcache[n], atol=ATOL,
                                   rtol=0)
        assert np.array_equal(tcache[n].numpy()[:, :20], cache[n][:, :20])
        assert np.array_equal(tcache[n].numpy()[:, 20 + N:],
                              cache[n][:, 20 + N:])


def _operands(dtype, seed, L=3, Bq=2, Hkv=2, rep=4, Tq=24, D=64):
    """A tbkd cache (L, T, B, Hkv, D), q, each layer's new k/v and a mask
    over the first columns, the step's slot the first free one."""
    g = torch.Generator().manual_seed(seed)
    ck = torch.randn((L, Tq, Bq, Hkv, D), generator=g).to(dtype)
    cv = torch.randn((L, Tq, Bq, Hkv, D), generator=g).to(dtype)
    qg = (torch.randn((Bq, Hkv, rep, D), generator=g) * D ** -0.5).to(dtype)
    kn = torch.randn((L, Bq, Hkv, D), generator=g).to(dtype)
    vn = torch.randn((L, Bq, Hkv, D), generator=g).to(dtype)
    mask = (torch.arange(Tq)[None] < torch.tensor([[17], [12]])).to(
        torch.int32)
    mask[1, :3] = 0
    return ck, cv, qg, kn, vn, mask, 17


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_tbkd_k4_is_einsum_attention_then_k12_plain(dtype):
    """K4's plain version on tbkd, layer by layer at the step's slot
    broadcast to (B,), gives `_tbkd_decode_attention` over the stale layer
    and leaves the cache K12's plain write leaves, bit for bit."""
    ck, cv, qg, kn, vn, mask, slot = _operands(dtype, seed=5)
    slots = torch.full((ck.shape[2],), slot, dtype=torch.int32)
    k4, v4 = ck.clone(), cv.clone()
    for li in range(ck.shape[0]):
        a4 = t_da.decode_attention_stacked_write_plain(
            qg, k4, v4, mask, kn[li], vn[li], li, slots, layout="tbkd")
        want = t_da._tbkd_decode_attention(qg, ck[li], cv[li], mask, kn[li],
                                           vn[li])
        assert torch.equal(a4, want)
    t_cu.cache_slot_write_plain(ck, kn, slot)
    t_cu.cache_slot_write_plain(cv, vn, slot)
    assert torch.equal(k4, ck) and torch.equal(v4, cv)


@pytest.mark.parametrize("wrapper", ["plain", "wrapper"])
def test_plain_tbkd_k4_matches_plain_bktd_k4_on_permuted_cache(wrapper):
    """In f32, K4 (its plain version, or the wrapper on CPU tensors) on a
    tbkd cache agrees with the plain bktd K4 on the same cache permuted to
    (L, B, Hkv, T, D) within 1e-6 at every layer, and the written caches
    are equal once permuted."""
    ck, cv, qg, kn, vn, mask, slot = _operands(torch.float32, seed=6)
    fn = (t_da.decode_attention_stacked_write_plain if wrapper == "plain"
          else t_da.decode_attention_stacked_write)
    bk, bv = (c.permute(0, 2, 3, 1, 4).contiguous() for c in (ck, cv))
    for li in range(ck.shape[0]):
        a_t = fn(qg, ck, cv, mask, kn[li], vn[li], li, slot, layout="tbkd")
        a_b = t_da.decode_attention_stacked_write_plain(
            qg, bk, bv, mask, kn[li], vn[li], li, slot)
        torch.testing.assert_close(a_t, a_b, atol=1e-6, rtol=0)
    assert torch.equal(ck.permute(0, 2, 3, 1, 4), bk)
    assert torch.equal(cv.permute(0, 2, 3, 1, 4), bv)


def test_k4_refuses_an_unknown_layout():
    ck, cv, qg, kn, vn, mask, slot = _operands(torch.float32, seed=7)
    for fn in (t_da.decode_attention_stacked_write,
               t_da.decode_attention_stacked_write_plain):
        with pytest.raises(ValueError, match="layout"):
            fn(qg, ck, cv, mask, kn[0], vn[0], 0, slot, layout="btkd")


# Llama-3.2-1B's lockstep shape (generate_legacy: protein 512 + prompt +
# 256 new tokens), and a small one
CUDA_SHAPES = [(16, 842, 4, 8, 4, 64), (2, 40, 3, 2, 2, 64),
               (2, 200, 2, 1, 5, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_tbkd_k4_is_bktd_k4_on_permuted_cache_on_cuda(cuda, dtype, shape):
    """The tbkd K4 (bf16: the split body, f32: the SIMT body) against the
    bktd K4 on the same cache permuted, at a scalar slot on layers 0 and
    L - 1: the outputs bit for bit, the written caches equal once
    permuted, the slot the only column that moved, one launch a call;
    and within 2e-2 of the plain tbkd route."""
    from prot2text_tpu_torch.kernels import launch_counts

    L, Tq, Bq, Hkv, rep, D = shape
    g = torch.Generator(device=cuda).manual_seed(31)

    def rn(*s):
        return torch.randn(*s, generator=g, device=cuda).to(dtype)

    ck, cv = rn(L, Tq, Bq, Hkv, D), rn(L, Tq, Bq, Hkv, D)
    qg = (rn(Bq, Hkv, rep, D).float() * D ** -0.5).to(dtype)
    kn, vn = rn(Bq, Hkv, D), rn(Bq, Hkv, D)
    pads = torch.arange(Bq, device=cuda) * 3
    slot = Tq - 5
    cols = torch.arange(Tq, device=cuda)
    mask = ((cols >= pads[:, None]) & (cols < slot)).to(torch.int32)
    slots = torch.full((Bq,), slot, dtype=torch.int32, device=cuda)
    bk, bv = (c.permute(0, 2, 3, 1, 4).contiguous() for c in (ck, cv))
    tk, tv = ck.clone(), cv.clone()
    for li in (0, L - 1):
        n = launch_counts()["K4"]
        a_t = t_da.decode_attention_stacked_write(
            qg, tk, tv, mask, kn, vn, li, slots, layout="tbkd")
        a_b = t_da.decode_attention_stacked_write(qg, bk, bv, mask, kn, vn,
                                                  li, slots)
        torch.cuda.synchronize()
        assert launch_counts()["K4"] == n + 2
        assert torch.equal(a_t, a_b)
        ref = t_da._tbkd_decode_attention(qg.float(), ck[li].float(),
                                          cv[li].float(), mask, kn.float(),
                                          vn.float())
        torch.testing.assert_close(a_t.float(), ref, atol=2e-2, rtol=2e-2)
    assert torch.equal(tk.permute(0, 2, 3, 1, 4), bk)
    assert torch.equal(tv.permute(0, 2, 3, 1, 4), bv)
    want_k, want_v = ck.clone(), cv.clone()
    for li in (0, L - 1):
        t_cu.cache_slot_write_plain(want_k[li:li + 1], kn[None], slot)
        t_cu.cache_slot_write_plain(want_v[li:li + 1], vn[None], slot)
    assert torch.equal(tk, want_k) and torch.equal(tv, want_v)


@pytest.mark.cuda
def test_tbkd_k4_refusals_on_cuda(cuda):
    """An int8 cache, a layout the kernel does not know and a cache whose
    shape does not match q raise before any launch."""
    L, Tq, Bq, Hkv, rep, D = 2, 40, 2, 2, 2, 64
    bf = torch.bfloat16
    ck = torch.zeros(L, Tq, Bq, Hkv, D, device=cuda, dtype=bf)
    qg = torch.zeros(Bq, Hkv, rep, D, device=cuda, dtype=bf)
    kn = torch.zeros(Bq, Hkv, D, device=cuda, dtype=bf)
    mask = torch.ones(Bq, Tq, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        t_da.decode_attention_stacked_write(
            qg, ck.to(torch.int8), ck.to(torch.int8), mask, kn, kn, 0, 3,
            layout="tbkd")
    with pytest.raises(ValueError, match="layout"):
        t_da.decode_attention_stacked_write(qg, ck, ck.clone(), mask, kn, kn,
                                            0, 3, layout="bkdt")
    with pytest.raises(ValueError, match="vs cache"):
        t_da.decode_attention_stacked_write(
            qg, ck[:, :, :1].contiguous(), ck[:, :, :1].contiguous(), mask,
            kn, kn, 0, 3, layout="tbkd")
