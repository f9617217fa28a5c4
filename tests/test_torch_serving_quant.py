"""Weight-quantized serving against the JAX package on the same quantized
weights (JAX's `quantize_params`, carried by the weight bridge) and inputs:

  * `decoder_decode_step` (per-row slots) and `decoder_verify_chunk` (int8
    pool, G 5) route each layer's projections through K10/K14 on the
    layer's view of the stacked buffers.  Against JAX's Pallas route in interpret mode, whose
    stacked K10 rounds x to bf16 at the same points: decode h within 1e-4
    of the largest |h| (measured 6e-6), verify h within 1e-3 (measured
    2e-4: the two frameworks' f32 activations may round to bf16, and the
    chunk's k/v to int8, one level apart at a tie, and one bf16 ulp of one
    input moves a K = 128 product by ~4e-3/sqrt(128) of its size).  Against
    JAX's XLA route, which never rounds x (int4 off the TPU, int8
    everywhere: an XLA mixed-dtype dot): h within 1e-2 of the largest |h|
    (measured 5e-4 to 8e-4: bf16-rounding the inputs of 14 projections);
  * the quantized LM head: fp32 logits of an x-dtype output, within 1e-5
    of JAX's K10/K14 in interpret mode (2^-8 for a bf16 output) and 1e-2
    of its XLA head;
  * the int4 and int8 serving engines (bf16 activations; the bf16 pool and
    the int8 pool with γ 3 speculation) serve JAX's engine's tokens, on a
    tiny decoder whose top-1 margins the test first asserts to be far
    above the bf16 error at every step: the port rounds x to bf16 at every
    projection of <= 256 rows, where JAX's CPU route does not, so tokens
    near a tie would be arbitrary."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prot2text_tpu.infer import serving as jserv
from prot2text_tpu.infer.kvcache import init_kv_cache as j_init
from prot2text_tpu.kernels import quant_matmul as jqm
from prot2text_tpu.models import decoder as jd
from prot2text_tpu.models import quant as jquant
from prot2text_tpu_torch.infer import serving as tserv
from prot2text_tpu_torch.kernels import launch_counts
from prot2text_tpu_torch.models import decoder as td
from prot2text_tpu_torch.models import transformer as tt
from prot2text_tpu_torch.models.weights import params_from_jax, tree_map

NEG = float(np.finfo(np.float32).min)
HIDDEN = 128
B = 3
TIGHT, VERIFY, LOOSE = 1e-4, 1e-3, 1e-2


def _cfg():
    # every projection's (K, N) passes JAX's plane gate, so its Pallas route
    # takes the stacked K10 for all of them
    return jd.DecoderConfig(
        vocab_size=128, hidden_size=HIDDEN, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=256, head_dim=128,
        rope_theta=10000.0, qk_norm=True)


def _quantized(params, bits, dtype=None):
    jparams = jquant.quantize_params(params, bits=bits)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              dtype=dtype).tree()
    return jparams, tparams


@pytest.fixture(scope="module")
def base():
    jcfg = _cfg()
    return jcfg, td.DecoderConfig(**jcfg.__dict__), jd.init_decoder_params(
        jcfg, jax.random.PRNGKey(1))


def _route(monkeypatch, route):
    if route == "pallas":
        monkeypatch.setenv("P2T_PALLAS_FORCE_INTERPRET", "1")


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("bits,route", [(4, "xla"), (4, "pallas"),
                                        (8, "xla")])
def test_decode_step_quant_matches_jax(base, monkeypatch, bits, route):
    jcfg, tcfg, params = base
    jparams, tparams = _quantized(params, bits)
    _route(monkeypatch, route)
    rng = np.random.default_rng(bits)
    T = 32
    cache = {n: rng.standard_normal((2, B, 2, T, 128)).astype(np.float32)
             for n in ("k", "v")}
    mask = (rng.random((B, T)) < 0.6).astype(np.int32)
    slots = np.array([9, 20, T - 1], np.int32)
    mask[np.arange(B), slots] = 0
    tok = rng.standard_normal((B, 1, HIDDEN)).astype(np.float32)
    pos = np.array([[12], [30], [4]], np.int32)
    bias_old = np.where(mask > 0, 0.0, NEG).astype(np.float32)[
        :, None, None, :]
    jh, _ = jd.decoder_decode_step(
        jcfg, jparams, token_embeds=jnp.asarray(tok),
        bias_old=jnp.asarray(bias_old), positions=jnp.asarray(pos),
        kv_cache={n: jnp.asarray(c) for n, c in cache.items()},
        cache_index=jnp.asarray(slots))
    before = launch_counts()
    th, _ = td.decoder_decode_step(
        tcfg, tparams, token_embeds=torch.from_numpy(tok),
        kv_mask=torch.from_numpy(mask), positions=torch.from_numpy(pos),
        kv_cache={n: torch.from_numpy(c.copy()) for n, c in cache.items()},
        cache_index=torch.from_numpy(slots))
    assert launch_counts() == before            # plain versions on the CPU
    assert _rel(th.numpy(), jh) <= (TIGHT if route == "pallas" else LOOSE)


def test_decode_step_routes_through_k10_on_layer_views(base, monkeypatch):
    """Every projection of every layer goes through `linear` to the K10
    wrapper with B rows and its layer's zero-copy view of the stacked
    (L, K/8, N) buffer: the layer is read in place, as the JAX stacked
    kernel reads it."""
    jcfg, tcfg, params = base
    _, tparams = _quantized(params, 4)
    stacked = {id(p["kernel_q4p"].untyped_storage()): n
               for n, p in tparams["layers"].items() if "kernel_q4p" in p}
    seen = []
    real = tt.quant_matmul_int4_planes

    def spy(x, w, s):
        L0 = tparams["layers"][stacked[id(w.untyped_storage())]]["kernel_q4p"]
        li = (w.data_ptr() - L0.data_ptr()) // (L0[0].numel()
                                                * L0.element_size())
        assert w.data_ptr() == L0[li].data_ptr() and w.shape == L0[li].shape
        seen.append((x.shape[0], li))
        return real(x, w, s)

    monkeypatch.setattr(tt, "quant_matmul_int4_planes", spy)
    T = 32
    cache = {n: torch.zeros((2, B, 2, T, 128)) for n in ("k", "v")}
    td.decoder_decode_step(
        tcfg, tparams, token_embeds=torch.ones((B, 1, HIDDEN)),
        kv_mask=torch.ones((B, T), dtype=torch.int32),
        positions=torch.zeros((B, 1), dtype=torch.long), kv_cache=cache,
        cache_index=torch.tensor([1, 2, 3]))
    assert [s[1] for s in seen] == [0] * 7 + [1] * 7
    assert {s[0] for s in seen} == {B}


def _int8_pool(rng, jcfg, T):
    cache = {k: np.asarray(v) for k, v in j_init(jcfg, B, T,
                                                 kv_bits=8).items()}
    for n in ("k", "v"):
        cache[n] = rng.integers(-127, 128, cache[n].shape).astype(np.int8)
    for n in ("k_scale", "v_scale"):
        cache[n] = rng.uniform(0.002, 0.03, cache[n].shape).astype(
            np.float32)
    return cache


@pytest.mark.parametrize("bits", [4, 8])
def test_verify_chunk_quant_matches_jax_interpret(base, monkeypatch, bits):
    """K8 plus the stacked K10/K14 over a G 5 chunk (15 rows); JAX's fused
    verify in interpret mode (its int8 projections stay XLA dots)."""
    jcfg, tcfg, params = base
    jparams, tparams = _quantized(params, bits)
    monkeypatch.setenv("P2T_PALLAS_FORCE_INTERPRET", "1")
    rng = np.random.default_rng(20 + bits)
    T, G = 96, 5
    cache = _int8_pool(rng, jcfg, T)
    starts = np.array([3, 29, T - 64], np.int32)
    mask = (rng.random((B, T)) < 0.6).astype(np.int32)
    for b, s in enumerate(starts):
        mask[b, s:s + G] = 0
    emb = rng.standard_normal((B, G, HIDDEN)).astype(np.float32)
    pos = (np.array([[17], [9], [30]]) + np.arange(G)).astype(np.int32)
    jh, _ = jd.decoder_verify_chunk(
        jcfg, jparams, token_embeds=jnp.asarray(emb),
        kv_mask01=jnp.asarray(mask), positions=jnp.asarray(pos),
        kv_cache={n: jnp.asarray(v) for n, v in cache.items()},
        cache_index=jnp.asarray(starts))
    th, _ = td.decoder_verify_chunk(
        tcfg, tparams, token_embeds=torch.from_numpy(emb),
        kv_mask=torch.from_numpy(mask), positions=torch.from_numpy(pos).long(),
        kv_cache={n: torch.from_numpy(v.copy()) for n, v in cache.items()},
        cache_index=torch.from_numpy(starts))
    assert _rel(th.numpy(), jh) <= (VERIFY if bits == 4 else LOOSE)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_head_matches_jax(base, bits, dtype):
    jcfg, tcfg, params = base
    jparams, tparams = _quantized(params, bits)
    rng = np.random.default_rng(30 + bits)
    h = rng.standard_normal((B, 2, HIDDEN)).astype(np.float32)
    th = torch.from_numpy(h).to(getattr(torch, dtype))
    got = td.decoder_logits(tcfg, tparams, th)
    assert got.dtype == torch.float32 and got.shape == (B, 2, 128)
    # the output is rounded to the activations' dtype before the fp32 cast
    assert torch.equal(got, got.to(th.dtype).float())
    lm = jparams["lm_head"]
    x = jnp.asarray(th.float().numpy()).reshape(-1, HIDDEN)
    if bits == 4:
        kern = jqm.quant_matmul_int4_planes(
            x, lm["kernel_q4p"], lm["scale"], out_dtype=jnp.float32,
            interpret=True)
    else:
        kern = jqm.quant_matmul_int8(x, lm["kernel_q"], lm["scale"],
                                     out_dtype=jnp.float32, interpret=True)
    want = np.asarray(kern).reshape(B, 2, 128)
    if dtype == "float32":
        assert _rel(got.numpy(), want) <= 1e-5
    else:          # the kernel's bf16 output
        assert _rel(got.numpy(), want) <= 2 ** -8
    xla = jd.decoder_logits(jcfg, jparams, jnp.asarray(th.float().numpy()))
    assert _rel(got.numpy(), xla) <= LOOSE


# ---------------------------------------------------------------------------
# engines


SUCC = 20.0
MARGIN = 2.0        # vs logits of magnitude ~30 computed in bf16 with int4
                    # or int8 weights: a few % error, under half the margin


def _successor_model(seed=5):
    """The tiny decoder in bf16 with decisive greedy steps: embeddings
    scaled 20-fold dominate the residual stream and the LM head is SUCC
    times their directions, permuted, so each token's successor leads."""
    jcfg = _cfg()
    params = jd.init_decoder_params(jcfg, jax.random.PRNGKey(seed),
                                    jnp.bfloat16)
    E = np.asarray(params["embed_tokens"]).astype(np.float32)
    succ = np.random.default_rng(seed).permutation(jcfg.vocab_size)
    W = np.zeros((HIDDEN, jcfg.vocab_size), np.float32)
    W[:, succ] = E.T * SUCC
    params["lm_head"]["kernel"] = jnp.asarray(W, jnp.bfloat16)
    params["embed_tokens"] = jnp.asarray(E * 20.0, jnp.bfloat16)
    return jcfg, td.DecoderConfig(**jcfg.__dict__), params


def _serve(eng, reqs):
    for rid, emb, n in reqs:
        eng.submit(rid, emb, max_new_tokens=n)
    return dict(eng.run())


def _margin(tcfg, tparams, prompt, toks):
    """Smallest top-1 minus top-2 logit over the generated positions, from
    an fp32 teacher-forced forward of the quantized weights."""
    p32 = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                   tparams)
    x = torch.cat([torch.from_numpy(prompt),
                   p32["embed_tokens"][torch.tensor(toks[:-1])]])[None]
    n = x.shape[1]
    h, _ = td.decoder_forward(
        tcfg, p32, inputs_embeds=x, positions=torch.arange(n)[None],
        attn_lengths=td.contiguous_lengths(torch.ones(1, n)))
    lg = td.decoder_logits(tcfg, p32, h)[0, len(prompt) - 1:]
    top = torch.topk(lg, 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).min().item()


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("pool", ["bf16", "kv8_spec"])
def test_quant_engines_match_jax_with_margin(monkeypatch, bits, pool):
    monkeypatch.setenv("P2T_PALLAS_FORCE_INTERPRET", "1")
    jcfg, tcfg, params = _successor_model()
    jparams, tparams = _quantized(params, bits, dtype=torch.bfloat16)
    E = np.asarray(params["embed_tokens"]).astype(np.float32)
    reqs = [(f"r{i}", E[np.random.default_rng(40 + i).integers(
        0, 128, 3 + 2 * i)], n) for i, n in enumerate((10, 7, 12))]
    kw = dict(max_slots=2, max_len=16 + 12, prompt_pad=16, eos_token_id=-1,
              sync_every=4)
    if pool == "kv8_spec":
        kw.update(kv_bits=8, prompt_lookup_tokens=3)
    teng = tserv.ContinuousBatcher(tcfg, tparams, cache_dtype=torch.bfloat16,
                                   **kw)
    got = _serve(teng, reqs)
    for rid, emb, _ in reqs:
        m = _margin(tcfg, tparams, emb, got[rid])
        assert m > MARGIN, (
            f"request {rid}: top-1 margin {m:.3f} <= {MARGIN}: too close to "
            f"a tie to compare bf16 engines of two frameworks; pick another "
            f"seed")
    jeng = jserv.ContinuousBatcher(jcfg, jparams, cache_dtype=jnp.bfloat16,
                                   **kw)
    assert got == _serve(jeng, reqs)
    assert all(len(got[rid]) == n for rid, _, n in reqs)
    if pool == "kv8_spec":
        assert teng._spec_fused and teng.verify_rounds > 0
    else:
        assert teng.plain_steps > 0 and teng.state["k"].dtype == torch.bfloat16
