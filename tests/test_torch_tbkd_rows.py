"""The tbkd cache (the sequence-leading (L, T, B, Hkv, D) layout of head
dims off the 128 grid) with per-row (B,) slots and a batch-broadcast
shared prefix, as JAX computes them: its decode step scatters the rows'
slots after the layer loop (prot2text_tpu/models/decoder.py:1110-1122) and
attends a sequence-leading (L, Pc, 1, Hkv, D) prefix concatenated before
the cache (`_pfx_cat`, :789-812); its forward transposes that prefix
(:241-250) and places each row's chunk by a one-hot einsum and a select
(:277-300, :346-355).  The port's decode step runs K4 (per-row slots) or
K9a (the prefix) once a layer at the tbkd strides, `layout="tbkd"`, and
its forward scatters each row's chunk along T.  Held here in f32 against
JAX's XLA route over N steps: every step's h and the caches within 1e-5,
the columns no step wrote bit for bit; the forward's h and caches within
1e-5, the columns it moved exactly JAX's.  On the CPU the plain tbkd K9a agrees with the plain bktd
K9a on the permuted cache and prefix within 1e-6 in f32; on the card the
tbkd K9a is bit-identical to the bktd K9a there."""

import numpy as np
import pytest
import torch

from prot2text_tpu_torch.kernels import decode_attention as t_da
from prot2text_tpu_torch.models import decoder as td

ATOL = 1e-5
HIDDEN, B, T, N, PC = 64, 4, 32, 3, 6
NEG = np.finfo(np.float32).min
# per-row first free slots: distinct, one at column 0 (a row with no
# written column yet)
ROW_SLOTS = np.array([9, 0, 14, 5])
CASES = ["rows", "prefix", "rows+prefix"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model():
    """head_dim 64: the tbkd cache (`kv_cache_layout`)."""
    import jax

    from prot2text_tpu.models import decoder as jd
    from prot2text_tpu_torch.models.weights import params_from_jax

    jcfg = jd.DecoderConfig(
        vocab_size=128, hidden_size=HIDDEN, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=128, head_dim=64,
        rope_theta=10000.0)
    tcfg = td.DecoderConfig(**jcfg.__dict__)
    assert td.kv_cache_layout(tcfg) == jd.kv_cache_layout(jcfg) == "tbkd"
    params = jd.init_decoder_params(jcfg, jax.random.PRNGKey(7))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                     params)).tree()
    return jcfg, tcfg, params, tparams


def _prefix(jcfg, rng):
    """A sequence-leading prefix (L, Pc, 1, Hkv, D) and its (B, 1, 1, Pc)
    bias: row 2 sees none of it, row 3 its first four columns."""
    shape = (jcfg.num_layers, PC, 1, jcfg.num_kv_heads, jcfg.head_dim)
    prefix = {n: rng.standard_normal(shape).astype(np.float32)
              for n in ("k", "v")}
    bias = np.zeros((B, 1, 1, PC), np.float32)
    bias[2] = NEG
    bias[3, ..., 4:] = NEG
    return prefix, bias


def _start(jcfg, case, seed):
    """A tbkd cache of random values; each row's written columns and its
    first free slot (per-row: `ROW_SLOTS`, the written columns those
    before it; host int: 20, behind a left-padded mask); N steps'
    embeddings and positions; the prefix and its bias where the case has
    one."""
    from prot2text_tpu.infer.kvcache import init_kv_cache as j_init

    rng = np.random.default_rng(seed)
    cache = {n: rng.standard_normal(np.asarray(v).shape).astype(np.float32)
             for n, v in j_init(jcfg, B, T).items()}
    cols = np.arange(T)[None]
    if case.startswith("rows"):
        slots = ROW_SLOTS
        mask = (cols < slots[:, None]) & (cols >= np.array([0, 0, 2, 1])[:,
                                                                     None])
    else:
        slots = np.full(B, 20)
        mask = (cols >= np.array([0, 3, 11, 5])[:, None]) & (cols < 20)
    emb = rng.standard_normal((N, B, 1, HIDDEN)).astype(np.float32)
    pos = (slots + 2)[:, None].astype(np.int32)
    prefix, pbias = (_prefix(jcfg, rng) if "prefix" in case
                     else (None, None))
    return cache, mask.astype(np.int32), slots, emb, pos, prefix, pbias


def _index(case, slots, t, to_tensor):
    if case == "prefix":
        return int(slots[0]) + t
    return to_tensor((slots + t).astype(np.int32))


def _run_port(tcfg, tparams, case, cache, mask, slots, emb, pos, prefix,
              pbias):
    tcache = {n: torch.from_numpy(v.copy()) for n, v in cache.items()}
    mask = torch.from_numpy(mask.copy())
    kw = {}
    if prefix is not None:
        kw = dict(prefix_kv={n: torch.from_numpy(v) for n, v in
                             prefix.items()},
                  prefix_bias=torch.from_numpy(pbias))
    hs = []
    for t in range(N):
        h, tcache = td.decoder_decode_step(
            tcfg, tparams, token_embeds=torch.from_numpy(emb[t]),
            kv_mask=mask, positions=torch.from_numpy(pos + t).long(),
            kv_cache=tcache,
            cache_index=_index(case, slots, t, torch.from_numpy), **kw)
        mask[torch.arange(B), torch.from_numpy(slots + t)] = 1
        hs.append(h.numpy())
    return hs, tcache


def _run_jax(jcfg, params, case, cache, mask, slots, emb, pos, prefix,
             pbias):
    import jax.numpy as jnp

    from prot2text_tpu.models import decoder as jd

    jcache = {n: jnp.asarray(v) for n, v in cache.items()}
    mask = mask.copy()
    kw = {}
    if prefix is not None:
        kw = dict(prefix_kv={n: jnp.asarray(v) for n, v in prefix.items()},
                  prefix_bias=jnp.asarray(pbias))
    hs = []
    for t in range(N):
        bias = np.where(mask[:, None, None, :] > 0, 0.0, NEG).astype(
            np.float32)
        h, jcache = jd.decoder_decode_step(
            jcfg, params, token_embeds=jnp.asarray(emb[t]),
            bias_old=jnp.asarray(bias), positions=jnp.asarray(pos + t),
            kv_cache=jcache, cache_index=_index(case, slots, t, jnp.asarray),
            **kw)
        mask[np.arange(B), slots + t] = 1
        hs.append(np.asarray(h))
    return hs, {n: np.asarray(v) for n, v in jcache.items()}


def _count(monkeypatch, calls, seen):
    for name in ("decode_attention_stacked_write",
                 "decode_attention_stacked_write_prefix"):
        orig = getattr(td, name)

        def wrapper(*a, _f=orig, _n=name, **k):
            calls[_n] = calls.get(_n, 0) + 1
            seen.append((_n, a, k))
            return _f(*a, **k)

        monkeypatch.setattr(td, name, wrapper)


@pytest.mark.parametrize("case", CASES)
def test_tbkd_step_routes_through_k4_and_k9a(model, monkeypatch, case):
    """Per-row slots take K4, a prefix K9a, once a layer a step, each at
    layout "tbkd" on one (B,) slots tensor a step (per-row: the step's
    cache_index itself; host int: one int32 fill of it), K9a on the
    sequence-leading prefix as it was given."""
    jcfg, tcfg, _, tparams = model
    calls, seen = {}, []
    _count(monkeypatch, calls, seen)
    state = _start(jcfg, case, seed=0)
    _run_port(tcfg, tparams, case, *state)
    L = tcfg.num_layers
    name = ("decode_attention_stacked_write_prefix" if "prefix" in case
            else "decode_attention_stacked_write")
    assert calls == {name: L * N}, calls
    slots = state[2]
    for t in range(N):
        step = seen[t * L:(t + 1) * L]
        assert [a[6] for _, a, _ in step] == list(range(L))
        assert all(k == {"layout": "tbkd"} for _, _, k in step)
        assert len({id(a[7]) for _, a, _ in step}) == 1
        s = step[0][1][7]
        assert torch.is_tensor(s) and s.shape == (B,)
        assert s.tolist() == (slots + t).tolist()
        if "prefix" in case:
            assert all(a[8].shape == (L, PC, 1, tcfg.num_kv_heads,
                                      tcfg.head_dim) for _, a, _ in step)


@pytest.mark.parametrize("case", CASES)
def test_tbkd_step_matches_jax(model, case):
    """N steps of the port's tbkd step against JAX's XLA route in f32:
    every step's h and the caches after N steps within 1e-5, and every
    column no step wrote bit for bit."""
    import jax

    jcfg, tcfg, params, tparams = model
    jax.clear_caches()
    state = _start(jcfg, case, seed=1)
    jhs, jcache = _run_jax(jcfg, params, case, *state)
    ths, tcache = _run_port(tcfg, tparams, case, *state)
    for th, jh in zip(ths, jhs):
        np.testing.assert_allclose(th, jh, atol=ATOL, rtol=0)
    cache, slots = state[0], state[2]
    written = np.zeros((T, B), bool)
    for t in range(N):
        written[slots + t, np.arange(B)] = True
    for n in ("k", "v"):
        got = tcache[n].numpy()
        np.testing.assert_allclose(got, jcache[n], atol=ATOL, rtol=0)
        assert np.array_equal(got[:, ~written], cache[n][:, ~written])
        assert not np.array_equal(got[:, written], cache[n][:, written])


@pytest.mark.parametrize("impl", ["xla", "auto"])
@pytest.mark.parametrize("with_prefix", [False, True], ids=["rows",
                                                             "rows+prefix"])
def test_tbkd_forward_matches_jax(model, impl, with_prefix):
    """`decoder_forward` on a tbkd cache with per-row (B,) `cache_index`
    (a chunk of S tokens a row, one row from column 0) and, with_prefix,
    the sequence-leading prefix, against JAX's XLA route in f32: h and the
    caches within 1e-5, and the port's scatter moves exactly the columns
    JAX's one-hot einsum and select place, row b's [cache_index[b],
    cache_index[b] + S), every other byte as it was."""
    import jax
    import jax.numpy as jnp

    from prot2text_tpu.models import decoder as jd

    jcfg, tcfg, params, tparams = model
    jax.clear_caches()
    rng = np.random.default_rng(2)
    S = 3
    start = np.array([6, 0, 11, 4], np.int32)
    shape = (jcfg.num_layers, T, B, jcfg.num_kv_heads, jcfg.head_dim)
    cache = {n: rng.standard_normal(shape).astype(np.float32)
             for n in ("k", "v")}
    j = np.arange(T)[None, None, :]
    i = np.arange(S)[None, :, None]
    s0 = start[:, None, None]
    ok = (j < s0) | ((j >= s0) & (j <= s0 + i))
    bias = np.where(ok, 0.0, NEG).astype(np.float32)[:, None]  # (B,1,S,T)
    emb = rng.standard_normal((B, S, HIDDEN)).astype(np.float32)
    pos = (start[:, None] + np.arange(S)).astype(np.int32)
    prefix, pbias = _prefix(jcfg, rng) if with_prefix else (None, None)
    jkw = tkw = {}
    if with_prefix:
        jkw = dict(prefix_kv={n: jnp.asarray(v) for n, v in prefix.items()},
                   prefix_bias=jnp.asarray(pbias))
        tkw = dict(prefix_kv={n: torch.from_numpy(v) for n, v in
                              prefix.items()},
                   prefix_bias=torch.from_numpy(pbias))
    jh, jcache = jd.decoder_forward(
        jcfg, params, inputs_embeds=jnp.asarray(emb), bias=jnp.asarray(bias),
        positions=jnp.asarray(pos),
        kv_cache={n: jnp.asarray(v) for n, v in cache.items()},
        cache_index=jnp.asarray(start), attn_impl="xla", **jkw)
    tcache = {n: torch.from_numpy(v.copy()) for n, v in cache.items()}
    th, tcache = td.decoder_forward(
        tcfg, tparams, inputs_embeds=torch.from_numpy(emb),
        positions=torch.from_numpy(pos).long(), bias=torch.from_numpy(bias),
        kv_cache=tcache, cache_index=torch.from_numpy(start),
        attn_impl=impl, **tkw)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    for n in ("k", "v"):
        got, want = tcache[n].numpy(), np.asarray(jcache[n])
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        moved = (got != cache[n]).any(axis=(0, 3, 4))          # (T, B)
        assert np.array_equal(moved, (want != cache[n]).any(axis=(0, 3, 4)))
        assert np.array_equal(np.argwhere(moved.T)[:, 1],
                              (start[:, None] + np.arange(S)).reshape(-1))


def _k9a_operands(dtype, g, L=3, Bq=3, Hkv=2, rep=4, Tq=24, Pc=10, D=64):
    """A tbkd cache (L, T, B, Hkv, D), a sequence-leading prefix (L, Pc, 1,
    Hkv, D) with its per-row mask, q, each layer's new k/v and a mask over
    the first columns; per-row slots, one at column 0."""
    def rn(*s):
        return torch.randn(*s, generator=g, device=g.device).to(dtype)

    ck, cv = rn(L, Tq, Bq, Hkv, D), rn(L, Tq, Bq, Hkv, D)
    pk, pv = rn(L, Pc, 1, Hkv, D), rn(L, Pc, 1, Hkv, D)
    qg = (rn(Bq, Hkv, rep, D).float() * D ** -0.5).to(dtype)
    kn, vn = rn(L, Bq, Hkv, D), rn(L, Bq, Hkv, D)
    slots = torch.tensor([17, 0, Tq - 1, Tq // 2][:Bq], dtype=torch.int32,
                         device=g.device)
    cols = torch.arange(Tq, device=g.device)
    mask = (cols[None] < slots[:, None]).to(torch.int32)
    pmask = torch.ones((Bq, Pc), dtype=torch.int32, device=g.device)
    pmask[1, 3:] = 0
    pmask[2] = 0
    return ck, cv, pk, pv, qg, kn, vn, mask, pmask, slots


def _bktd(*tensors):
    """tbkd (L, T, B, Hkv, D) → bktd (L, B, Hkv, T, D), contiguous; the
    sequence-leading prefix (L, Pc, 1, Hkv, D) → (L, 1, Hkv, Pc, D)."""
    return [t.permute(0, 2, 3, 1, 4).contiguous() for t in tensors]


@pytest.mark.parametrize("wrapper", ["plain", "wrapper"])
def test_plain_tbkd_k9a_matches_plain_bktd_k9a_on_permuted_operands(wrapper):
    """In f32, K9a (its plain version, or the wrapper on CPU tensors) on a
    tbkd cache and prefix agrees with the plain bktd K9a on both permuted
    within 1e-6 at every layer, at per-row slots, and the written caches
    are equal once permuted."""
    g = torch.Generator().manual_seed(8)
    ck, cv, pk, pv, qg, kn, vn, mask, pmask, slots = _k9a_operands(
        torch.float32, g)
    fn = (t_da.decode_attention_stacked_write_prefix_plain
          if wrapper == "plain" else t_da.decode_attention_stacked_write_prefix)
    bk, bv, bpk, bpv = _bktd(ck, cv, pk, pv)
    for li in range(ck.shape[0]):
        a_t = fn(qg, ck, cv, mask, kn[li], vn[li], li, slots, pk, pv, pmask,
                 layout="tbkd")
        a_b = t_da.decode_attention_stacked_write_prefix_plain(
            qg, bk, bv, mask, kn[li], vn[li], li, slots, bpk, bpv, pmask)
        torch.testing.assert_close(a_t, a_b, atol=1e-6, rtol=0)
    assert torch.equal(ck.permute(0, 2, 3, 1, 4), bk)
    assert torch.equal(cv.permute(0, 2, 3, 1, 4), bv)


def test_plain_k9a_refuses_an_unknown_layout():
    g = torch.Generator().manual_seed(9)
    ck, cv, pk, pv, qg, kn, vn, mask, pmask, slots = _k9a_operands(
        torch.float32, g)
    for fn in (t_da.decode_attention_stacked_write_prefix,
               t_da.decode_attention_stacked_write_prefix_plain):
        with pytest.raises(ValueError, match="layout"):
            fn(qg, ck, cv, mask, kn[0], vn[0], 0, slots, pk, pv, pmask,
               layout="btkd")


@pytest.mark.cuda
def test_k9a_refuses_a_prefix_of_the_other_layout_on_cuda(cuda):
    """Beside a tbkd cache the prefix must be sequence-leading, beside a
    bktd one (L, 1, Hkv, Pc, D): the wrong one raises before any launch."""
    g = torch.Generator(device=cuda).manual_seed(9)
    ck, cv, pk, pv, qg, kn, vn, mask, pmask, slots = _k9a_operands(
        torch.bfloat16, g)
    bk, bv, bpk, bpv = _bktd(ck, cv, pk, pv)
    with pytest.raises(ValueError, match=r"\(L, Pc, 1, Hkv, D\)"):
        t_da.decode_attention_stacked_write_prefix(
            qg, ck, cv, mask, kn[0], vn[0], 0, slots, bpk, bpv, pmask,
            layout="tbkd")
    with pytest.raises(ValueError, match=r"\(L, 1, Hkv, Pc, D\)"):
        t_da.decode_attention_stacked_write_prefix(
            qg, bk, bv, mask, kn[0], vn[0], 0, slots, pk, pv, pmask)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(16, 842, 4, 8, 4, 64, 256),
                                   (2, 40, 3, 2, 2, 64, 10),
                                   (2, 200, 3, 1, 5, 32, 70)])
def test_tbkd_k9a_is_bktd_k9a_on_permuted_operands_on_cuda(cuda, dtype,
                                                           shape):
    """The tbkd K9a (bf16: the split body, f32: the SIMT body) against the
    bktd K9a on the same cache and prefix permuted, at per-row slots (one
    at column 0) on layers 0 and L - 1: the outputs bit for bit, the
    written caches equal once permuted, only the slots moved, one launch
    a call; within 2e-2 of the plain tbkd route."""
    from prot2text_tpu_torch.kernels import launch_counts

    L, Tq, Bq, Hkv, rep, D, Pc = shape
    g = torch.Generator(device=cuda).manual_seed(41)
    ck, cv, pk, pv, qg, kn, vn, mask, pmask, slots = _k9a_operands(
        dtype, g, L=L, Bq=Bq, Hkv=Hkv, rep=rep, Tq=Tq, Pc=Pc, D=D)
    bk, bv, bpk, bpv = _bktd(ck, cv, pk, pv)
    tk, tv = ck.clone(), cv.clone()
    for li in (0, L - 1):
        n = launch_counts()["K9a"]
        a_t = t_da.decode_attention_stacked_write_prefix(
            qg, tk, tv, mask, kn[li], vn[li], li, slots, pk, pv, pmask,
            layout="tbkd")
        a_b = t_da.decode_attention_stacked_write_prefix(
            qg, bk, bv, mask, kn[li], vn[li], li, slots, bpk, bpv, pmask)
        torch.cuda.synchronize()
        assert launch_counts()["K9a"] == n + 2
        assert torch.equal(a_t, a_b)
        ref = t_da.decode_attention_stacked_write_prefix_plain(
            qg.float(), ck.float(), cv.float(), mask, kn[li].float(),
            vn[li].float(), li, slots, pk.float(), pv.float(), pmask,
            layout="tbkd")
        torch.testing.assert_close(a_t.float(), ref, atol=2e-2, rtol=2e-2)
    assert torch.equal(tk.permute(0, 2, 3, 1, 4), bk)
    assert torch.equal(tv.permute(0, 2, 3, 1, 4), bv)
    want_k, want_v = ck.clone(), cv.clone()
    rows = torch.arange(Bq, device=cuda)
    for li in (0, L - 1):
        want_k[li, slots.long(), rows] = kn[li]
        want_v[li, slots.long(), rows] = vn[li]
    assert torch.equal(tk, want_k) and torch.equal(tv, want_v)
