"""The serving slice's modules in the port against the JAX package on the
same weights (JAX init → numpy → `params_from_jax`) and numpy inputs, f32:
`ESMCQwen.apply` (decoder inputs and logits) with its placeholder-count
check; `decoder_forward` with an explicit bias over a cache seeded with a
prefix (the serving install: K6 in the port); `decoder_decode_step` with
per-row slots, with and without the shared prefix (K4 / K9a), against the
JAX step on its XLA route and, for head_dim 128, its Pallas kernels in
interpret mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prot2text_tpu.models import adapters as ja
from prot2text_tpu.models import composed as jc
from prot2text_tpu.models import decoder as jd
from prot2text_tpu.models import esmc as jesmc
from prot2text_tpu.models import qwen3 as jq
from prot2text_tpu_torch.models import adapters as ta
from prot2text_tpu_torch.models import composed as tc
from prot2text_tpu_torch.models import decoder as td
from prot2text_tpu_torch.models import esmc as tesmc
from prot2text_tpu_torch.models import qwen3 as tq
from prot2text_tpu_torch.models.weights import params_from_jax

ATOL = 1e-5
NEG = float(np.finfo(np.float32).min)
PH = 259


def _t(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree)).tree()


def _qwen(head_dim=128, seed=0):
    jcfg = jq.Qwen3Config(vocab_size=300, hidden_size=64, num_layers=2,
                          num_heads=4, num_kv_heads=2, head_dim=head_dim,
                          intermediate_size=128, rope_theta=1e4)
    tcfg = tq.Qwen3Config(**jcfg.__dict__)
    return jcfg, tcfg, jq.init_qwen3_params(jcfg, jax.random.PRNGKey(seed))


@pytest.fixture(params=["xla", "pallas"])
def jax_route(request, monkeypatch):
    """The JAX decode step's route: XLA, or its Pallas kernels (K4, K9a) in
    interpret mode on the CPU."""
    if request.param == "pallas":
        monkeypatch.setenv("P2T_PALLAS_FORCE_INTERPRET", "1")
    return request.param


# ---------------------------------------------------------------------------
# ESMCQwen


def _esmc_qwen(seed=0):
    esm = jesmc.ESMCConfig(d_model=64, n_layers=2, n_heads=4)
    jcfg_q, tcfg_q, _ = _qwen(head_dim=16)
    adapter = (64, 48, 64)
    jcfg = jc.ESMCQwenConfig(esm, ja.ModalityAdapterConfig(*adapter),
                             jcfg_q, placeholder_id=PH)
    tcfg = tc.ESMCQwenConfig(tesmc.ESMCConfig(**esm.__dict__),
                             ta.ModalityAdapterConfig(*adapter), tcfg_q,
                             placeholder_id=PH)
    jmodel = jc.ESMCQwen(jcfg, rng=jax.random.PRNGKey(seed))
    return jcfg, tcfg, jmodel.params


def _protein_batch(B=3, S=24, seed=1):
    """Right-padded protein rows and left-padded prompts holding one
    placeholder per valid protein token."""
    rng = np.random.default_rng(seed)
    n_prot = rng.integers(4, 9, B)
    P = int(n_prot.max())
    pids = np.ones((B, P), np.int32)
    pmask = np.zeros((B, P), np.int32)
    ids = np.full((B, S), 258, np.int32)
    mask = np.zeros((B, S), np.int32)
    for b, n in enumerate(n_prot):
        pids[b, :n] = [0] + list(rng.integers(4, 24, n - 2)) + [2]
        pmask[b, :n] = 1
        text = list(rng.integers(0, 256, int(rng.integers(n + 4, S + 1) - n)))
        row = text[:3] + [PH] * n + text[3:]
        ids[b, S - len(row):] = row
        mask[b, S - len(row):] = 1
    return dict(protein_input_ids=pids, protein_attention_mask=pmask,
                input_ids=ids, attention_mask=mask)


def test_esmc_qwen_decoder_inputs_and_logits_match_jax():
    jcfg, tcfg, params = _esmc_qwen()
    batch = _protein_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    emb, mask = jc.ESMCQwen.apply(jcfg, params, return_decoder_inputs=True,
                                  **jb)
    model = tc.ESMCQwen(tcfg, _t(params))
    got, got_mask = model(return_decoder_inputs=True, **tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(emb), atol=ATOL,
                               rtol=0)
    assert np.array_equal(got_mask.numpy(), np.asarray(mask))
    want = jc.ESMCQwen.apply(jcfg, params, **jb).logits
    logits = model(**tb).logits
    valid = batch["attention_mask"].astype(bool)
    np.testing.assert_allclose(logits.numpy()[valid], np.asarray(want)[valid],
                               atol=ATOL, rtol=0)


def test_esmc_qwen_placeholder_count_error():
    _, tcfg, params = _esmc_qwen()
    batch = _protein_batch()
    ids = batch["input_ids"].copy()
    ids[0, np.flatnonzero(ids[0] == PH)[0]] = 65   # one placeholder short
    model = tc.ESMCQwen(tcfg, _t(params))
    with pytest.raises(ValueError, match="placeholder tokens"):
        model(protein_input_ids=torch.from_numpy(
                  batch["protein_input_ids"]).long(),
              protein_attention_mask=torch.from_numpy(
                  batch["protein_attention_mask"]).long(),
              input_ids=torch.from_numpy(ids).long(),
              return_decoder_inputs=True)


# ---------------------------------------------------------------------------
# decoder_forward with a bias over a seeded cache (the prefix install)


def _install_bias(R, S, Pc, prefix_len, mask):
    idx = np.arange(S)
    ok = (idx[None, :] <= idx[:, None])[None, None] & (mask[:, None, None, :]
                                                       > 0)
    okp = np.broadcast_to(np.arange(Pc) >= Pc - prefix_len, (R, 1, S, Pc))
    return np.where(np.concatenate([okp, ok], -1), 0.0, NEG).astype(
        np.float32)


@pytest.mark.parametrize("head_dim", [16, 128])
def test_decoder_forward_bias_with_cache_offset_matches_jax(head_dim):
    """Suffix rows written at [Pc, Pc + S) of a cache whose columns
    [0, Pc) hold a seeded prefix, attention over the whole width: h and
    the cache against the JAX install's call (infer/serving.py:183-185)."""
    jcfg, tcfg, params = _qwen(head_dim)
    R, S, Pc, Ps, Hkv, L = 3, 8, 16, 11, 2, 2
    rng = np.random.default_rng(2)
    x = rng.standard_normal((R, S, 64)).astype(np.float32)
    mask = np.ones((R, S), np.int32)
    mask[1, :3] = 0
    mask[2, :6] = 0
    x[mask == 0] = 0
    pos = (np.clip(np.cumsum(mask, 1) - 1, 0, None) + Ps).astype(np.int32)
    pk = rng.standard_normal((L, 1, Hkv, Pc, head_dim)).astype(np.float32)
    pv = rng.standard_normal((L, 1, Hkv, Pc, head_dim)).astype(np.float32)
    bias = _install_bias(R, S, Pc, Ps, mask)
    cache = {n: np.zeros((L, R, Hkv, Pc + S, head_dim), np.float32)
             for n in ("k", "v")}
    cache["k"][:, :, :, :Pc] = pk
    cache["v"][:, :, :, :Pc] = pv
    layout = jd.kv_cache_layout(jcfg.core())
    jcache = {n: jnp.asarray(c if layout == "bktd"
                             else c.transpose(0, 3, 1, 2, 4))
              for n, c in cache.items()}
    want_h, want_cache = jd.decoder_forward(
        jcfg.core(), params, inputs_embeds=jnp.asarray(x),
        bias=jnp.asarray(bias), positions=jnp.asarray(pos), kv_cache=jcache,
        cache_index=Pc, attn_impl="flash")
    tcache = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    # the serving pool's layout at every head dim (infer/serving.py
    # POOL_LAYOUT); JAX's D=16 cache is tbkd, compared permuted below
    got_h, _ = td.decoder_forward(
        tcfg.core(), _t(params), inputs_embeds=torch.from_numpy(x),
        positions=torch.from_numpy(pos), bias=torch.from_numpy(bias),
        kv_cache=tcache, cache_index=Pc, layout="bktd")
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=ATOL,
                               rtol=0)
    for n in ("k", "v"):
        w = np.asarray(want_cache[n])
        if layout != "bktd":
            w = w.transpose(0, 2, 3, 1, 4)
        assert np.array_equal(tcache[n].numpy()[:, :, :, :Pc],
                              cache[n][:, :, :, :Pc])  # prefix untouched
        np.testing.assert_allclose(tcache[n].numpy(), w, atol=ATOL, rtol=0)


def test_decoder_forward_needs_one_attention_kind():
    _, tcfg, params = _qwen(16)
    x = torch.zeros(1, 4, 64)
    pos = torch.arange(4)[None]
    with pytest.raises(ValueError, match="exactly one"):
        td.decoder_forward(tcfg.core(), _t(params), inputs_embeds=x,
                           positions=pos)
    with pytest.raises(ValueError, match="pass kv_cache"):
        td.decoder_forward(tcfg.core(), _t(params), inputs_embeds=x,
                           positions=pos, bias=torch.zeros(1, 1, 4, 4))
    cache = {n: torch.zeros(2, 1, 2, 6, 16) for n in ("k", "v")}
    with pytest.raises(ValueError, match="bias covers"):
        td.decoder_forward(tcfg.core(), _t(params), inputs_embeds=x,
                           positions=pos, bias=torch.zeros(1, 1, 4, 5),
                           kv_cache=cache, cache_index=2, layout="bktd")


# ---------------------------------------------------------------------------
# decoder_decode_step with per-row slots (K4) and a shared prefix (K9a)


def _decode_setup(seed=3):
    """A bktd (head_dim 128) pool of 3 rows at different fill levels, slot
    per row (the last row inactive: the scratch column T - 1)."""
    jcfg, tcfg, params = _qwen(128, seed)
    L, B, Hkv, T, D, Pc = 2, 3, 2, 32, 128, 16
    rng = np.random.default_rng(seed)
    cache = {n: rng.standard_normal((L, B, Hkv, T, D)).astype(np.float32)
             for n in ("k", "v")}
    kv_mask = np.zeros((B, T), np.int32)
    kv_mask[0, 2:9] = 1
    kv_mask[1, 5:20] = 1
    slots = np.array([9, 20, T - 1], np.int32)
    tok = rng.standard_normal((B, 1, 64)).astype(np.float32)
    pos = np.array([[12], [30], [4]], np.int32)
    pkv = {n: rng.standard_normal((L, 1, Hkv, Pc, D)).astype(np.float32)
           for n in ("k", "v")}
    use_pfx = np.array([1, 0, 1])
    pvalid = np.arange(Pc) >= Pc - 13
    pbias = np.where((use_pfx[:, None] > 0) & pvalid[None], 0.0, NEG
                     ).astype(np.float32)[:, None, None, :]
    return jcfg, tcfg, params, cache, kv_mask, slots, tok, pos, pkv, pbias


@pytest.mark.parametrize("prefix", [False, True])
def test_decode_step_per_row_slots_matches_jax(jax_route, prefix):
    (jcfg, tcfg, params, cache, kv_mask, slots, tok, pos, pkv,
     pbias) = _decode_setup()
    bias_old = np.where(kv_mask > 0, 0.0, NEG).astype(np.float32)[
        :, None, None, :]
    kw = {}
    if prefix:
        kw = dict(prefix_kv={n: jnp.asarray(a) for n, a in pkv.items()},
                  prefix_bias=jnp.asarray(pbias))
    want_h, want_cache = jd.decoder_decode_step(
        jcfg.core(), params, token_embeds=jnp.asarray(tok),
        bias_old=jnp.asarray(bias_old), positions=jnp.asarray(pos),
        kv_cache={n: jnp.asarray(c) for n, c in cache.items()},
        cache_index=jnp.asarray(slots), **kw)
    tcache = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    tkw = {}
    if prefix:
        tkw = dict(prefix_kv={n: torch.from_numpy(a) for n, a in pkv.items()},
                   prefix_bias=torch.from_numpy(pbias))
    got_h, _ = td.decoder_decode_step(
        tcfg.core(), _t(params), token_embeds=torch.from_numpy(tok),
        kv_mask=torch.from_numpy(kv_mask), positions=torch.from_numpy(pos),
        kv_cache=tcache, cache_index=torch.from_numpy(slots), **tkw)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=ATOL,
                               rtol=0)
    B = slots.shape[0]
    written = np.zeros(cache["k"].shape[:4], bool)
    written[:, np.arange(B), :, slots] = True
    for n in ("k", "v"):
        got, w = tcache[n].numpy(), np.asarray(want_cache[n])
        # every other column untouched, bit for bit; the written slots
        # hold the step's k/v, within the two frameworks' rounding
        assert np.array_equal(got[~written], cache[n][~written])
        assert np.array_equal(w[~written], cache[n][~written])
        np.testing.assert_allclose(got[written], w[written], atol=ATOL,
                                   rtol=0)


def test_decode_step_scalar_slot_keeps_lockstep_split_write():
    """A host-int slot (lockstep generation: one (B,) slots tensor a step)
    and a tensor slot both take K4, which attends and writes the slot; the
    same step gives the same h and writes the same cache either way."""
    (_, tcfg, params, cache, kv_mask, _, tok, pos, _,
     _) = _decode_setup(seed=4)
    kv_mask[:, 21] = 0
    out = []
    for slot in (21, torch.full((3,), 21)):
        tcache = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
        h, _ = td.decoder_decode_step(
            tcfg.core(), _t(params), token_embeds=torch.from_numpy(tok),
            kv_mask=torch.from_numpy(kv_mask),
            positions=torch.from_numpy(pos), kv_cache=tcache,
            cache_index=slot)
        out.append((h, tcache))
    (h0, c0), (h1, c1) = out
    torch.testing.assert_close(h0, h1, atol=ATOL, rtol=0)
    for n in ("k", "v"):
        assert torch.equal(c0[n], c1[n])


def test_decode_step_int8_cache_names_its_kernels(monkeypatch):
    """An int8 cache routes every layer's decode through K7 (per-row slots)
    or K9b (with an int8 shared prefix), never the bf16 kernels, and the
    token's int8 values and scales land in its slot."""
    from prot2text_tpu_torch.infer.kvcache import init_kv_cache

    _, tcfg, params = _qwen(16)
    calls = []
    for name in ("decode_attention_stacked_write",
                 "decode_attention_stacked_write_prefix",
                 "decode_attention_stacked_write_q",
                 "decode_attention_stacked_write_q_prefix"):
        fn = getattr(td, name)
        monkeypatch.setattr(td, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    pcache = init_kv_cache(tcfg.core(), 1, 8, device="cpu", kv_bits=8)
    for prefix in (None, pcache):
        calls.clear()
        cache = init_kv_cache(tcfg.core(), 1, 8, device="cpu", kv_bits=8)
        kw = {} if prefix is None else dict(
            prefix_kv=prefix, prefix_bias=torch.zeros(1, 1, 1, 8))
        td.decoder_decode_step(
            tcfg.core(), _t(params), token_embeds=torch.ones(1, 1, 64),
            kv_mask=torch.zeros(1, 8, dtype=torch.int32),
            positions=torch.zeros(1, 1, dtype=torch.long), kv_cache=cache,
            cache_index=torch.full((1,), 3, dtype=torch.long), **kw)
        kernel = ("decode_attention_stacked_write_q" if prefix is None
                  else "decode_attention_stacked_write_q_prefix")
        assert calls == [kernel] * 2
        assert cache["k"].dtype == torch.int8
        assert int(cache["k"][:, 0, :, 3].abs().amax()) == 127
        assert bool((cache["k_scale"][:, 0, :, 3] != 1.0).all())
