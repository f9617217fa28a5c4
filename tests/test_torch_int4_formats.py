"""The int4 weight formats of kernel K11 (split-half bytes `kernel_q4`,
bf16-pair words `kernel_q4w`) through the port's model code, against the
JAX package on the same weights:

  * `quantize_params(bits=4, int4_format="bytes"|"pairs")` gives JAX's
    trees leaf for leaf on tiny ESMC and Qwen3 towers (keys, dtypes,
    shapes; scales within 1e-6 relative; integers equal except one level
    apart where the fp32 pre-image lies within 1e-5 of a half-integer), and
    the din % 8 != 0 fallback gives JAX's `kernel_q4` under every format;
  * JAX's trees in each format cross the weight bridge bit-exactly, and
    `dequantize_kernel` and `linear` on them match JAX's (`linear`: 1e-5
    of max|y| for bf16-representable x, at few rows through the K11 plain
    versions and at many through the dequantized matmul);
  * the decode step, the quantized head and lockstep `generate` on a tiny
    Qwen3 quantized in each format, against JAX's XLA route (which never
    rounds x to bf16: 1e-2 of max) and its Pallas route in interpret mode
    (1e-4 of max for the decode step, as for the planes in
    tests/test_torch_serving_quant.py: bytes measured 8e-8, pairs 6.5e-6,
    the cancellation of JAX's TPU pairs kernel, which takes 136·rowsum(x)
    off in its fp32 epilogue where the port's kernel is exact); greedy
    tokens equal JAX's on a decoder whose top-1 margins the test asserts to
    be decisive;
  * planes, bytes and pairs trees of the same float weights give the port
    identical outputs."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prot2text_tpu.kernels import quant_matmul as jqm
from prot2text_tpu.models import decoder as jd
from prot2text_tpu.models import esmc as jesmc
from prot2text_tpu.models import qwen3 as jq
from prot2text_tpu.models import quant as jquant
from prot2text_tpu.models import transformer as jt
from prot2text_tpu_torch.infer import generate as tgen
from prot2text_tpu_torch.kernels import launch_counts
from prot2text_tpu_torch.models import decoder as td
from prot2text_tpu_torch.models import quant as tquant
from prot2text_tpu_torch.models import transformer as tt
from prot2text_tpu_torch.models.weights import params_from_jax, tree_map

jgen = importlib.import_module("prot2text_tpu.infer.generate")

FORMATS = {"bytes": "kernel_q4", "pairs": "kernel_q4w"}
JAX_UNPACK = {"kernel_q4": jqm.unpack_int4, "kernel_q4w":
              jqm.unpack_int4_pairs, "kernel_q4p": jqm.unpack_int4_planes}
HIDDEN, B = 128, 3
TIGHT, LOOSE = 1e-4, 1e-2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree, dtype=None):
    return params_from_jax(_np(tree), dtype=dtype).tree()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _assert_ints_close(got, want, pre):
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    diff = got != want
    if diff.any():
        assert np.abs(got - want)[diff].max() == 1
        frac = np.abs(np.abs(np.asarray(pre)[diff]) % 1.0 - 0.5)
        assert frac.max() <= 1e-5, frac.max()


def _towers():
    return {"esmc": jesmc.init_esmc_params(
                jesmc.ESMCConfig(d_model=64, n_layers=2, n_heads=4),
                jax.random.PRNGKey(3)),
            "qwen3": jq.init_qwen3_params(jq.Qwen3Config.tiny(),
                                          jax.random.PRNGKey(4))}


@pytest.mark.parametrize("fmt", ["bytes", "pairs"])
@pytest.mark.parametrize("tower", ["esmc", "qwen3"])
def test_quantize_params_formats_match_jax(fmt, tower):
    base = _towers()[tower]
    want = _flat(_np(jquant.quantize_params(base, bits=4,
                                            int4_format=fmt)))
    got = _flat(tquant.quantize_params(_t(base), bits=4, int4_format=fmt))
    flat_base = _flat(_np(base))
    assert set(got) == set(want)
    n_quant = 0
    for path, w in want.items():
        g = got[path]
        assert g.dtype == torch.from_numpy(np.zeros(0, w.dtype)).dtype, path
        assert tuple(g.shape) == w.shape, path
        key = path.rsplit("/", 1)[-1]
        if key in JAX_UNPACK:
            n_quant += 1
            assert key == FORMATS[fmt], path
            kpath = path.rsplit("/", 1)[0]
            pre = (flat_base[kpath + "/kernel"]
                   / np.asarray(want[kpath + "/scale"]))
            _assert_ints_close(tquant.INT4_FORMATS[key][1](g).numpy(),
                               np.asarray(JAX_UNPACK[key](jnp.asarray(w))),
                               pre)
        elif key == "scale" and path.replace("/scale", "/kernel") in \
                flat_base:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)
    assert n_quant == {"esmc": 4, "qwen3": 8}[tower]


@pytest.mark.parametrize("fmt", ["planes", "pairs", "bytes"])
def test_din_off_the_word_grid_falls_back_to_bytes(fmt):
    """din % 8 != 0 with din even: JAX's split-half bytes under every
    format, stacked and single leaves."""
    rng = np.random.default_rng(7)
    tree = {"q_proj": {"kernel": (rng.standard_normal((3, 12, 16))
                                  * 0.02).astype(np.float32)},
            "lm_head": {"kernel": (rng.standard_normal((20, 24))
                                   * 0.02).astype(np.float32)}}
    want = _np(jquant.quantize_params(jax.tree_util.tree_map(
        jnp.asarray, tree), bits=4, int4_format=fmt))
    got = tquant.quantize_params(tree_map(torch.from_numpy, tree), bits=4,
                                 int4_format=fmt)
    for name in tree:
        assert set(got[name]) == set(want[name]) == {"kernel_q4", "scale"}
        np.testing.assert_array_equal(got[name]["kernel_q4"].numpy(),
                                      want[name]["kernel_q4"])


@pytest.mark.parametrize("fmt", ["bytes", "pairs"])
def test_bridge_dequantize_and_linear_match_jax(fmt):
    """JAX's tree crosses the bridge bit-exactly; the port's
    `dequantize_kernel` equals JAX's unpack + `dequantize_leaf`; `linear`
    matches JAX's at 5, 2x3 and 300 rows (a bias leaf kept and added); the
    same integers as nibble planes give the same outputs, bit for bit."""
    key = FORMATS[fmt]
    rng = np.random.default_rng(len(fmt))
    w = (rng.standard_normal((64, 48)) * 0.02).astype(np.float32)
    b = (rng.standard_normal(48) * 0.1).astype(np.float32)
    jp = jquant.quantize_params({"q_proj": {"kernel": jnp.asarray(w),
                                            "bias": jnp.asarray(b)}},
                                bits=4, int4_format=fmt)["q_proj"]
    tp = _t(jp)
    assert tp[key].dtype == {"kernel_q4": torch.int8,
                             "kernel_q4w": torch.int32}[key]
    np.testing.assert_array_equal(tp[key].numpy(), np.asarray(jp[key]))
    want = jquant.dequantize_leaf(JAX_UNPACK[key](jp[key]), jp["scale"])
    got = tquant.dequantize_kernel(tp, torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    planes = dict(tp, **{"kernel_q4p": tquant.pack_int4_planes(
        tquant.INT4_FORMATS[key][1](tp[key]))})
    del planes[key]
    for lead in ((5,), (2, 3), (300,)):
        x = torch.from_numpy(rng.standard_normal(lead + (64,)).astype(
            np.float32)).bfloat16().float()
        ref = np.asarray(jt.linear(jp, jnp.asarray(x.numpy())))
        y = tt.linear(tp, x)
        assert tuple(y.shape) == lead + (48,)
        assert _rel(y.numpy(), ref) <= 1e-5
        assert torch.equal(y, tt.linear(planes, x))


@pytest.mark.parametrize("fmt", ["bytes", "pairs"])
def test_linear_bf16_many_rows_matches_jax(fmt):
    """A bf16 x of 300 rows takes the format's kernel (its plain twin on the
    CPU): the integer weight in the fp32 product, the scale after it, as
    JAX's XLA route, which `linear` takes above 256 rows.  The two differ
    only by the order of one fp32 sum over K (JAX's split-half route sums
    the two halves apart) before the bf16 rounding of the output, so each
    output is JAX's or a bf16 neighbour: |port - JAX| <= 2^-7·|JAX| (one
    bf16 ulp) + 1e-6·max|JAX| (the fp32 reorder near zero).  The weight
    dequantized to bf16 (this route's parent) sits farther from JAX, in
    rms and in the count of outputs that differ, on the same values."""
    key = FORMATS[fmt]
    rng = np.random.default_rng(300 + len(fmt))
    w = (rng.standard_normal((256, 96)) * 0.02).astype(np.float32)
    jp = jquant.quantize_params({"q_proj": {"kernel": jnp.asarray(w)}},
                                bits=4, int4_format=fmt)["q_proj"]
    tp = _t(jp)
    x = torch.from_numpy(rng.standard_normal((300, 256)).astype(
        np.float32)).bfloat16()
    want = np.asarray(jt.linear(jp, jnp.asarray(
        x.float().numpy()).astype(jnp.bfloat16))).astype(np.float32)
    got = tt.linear(tp, x)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (300, 96)
    got = got.float().numpy()
    deq = torch.matmul(x, tquant.dequantize_kernel(tp, torch.bfloat16))
    deq = deq.float().numpy()
    top = np.abs(want).max()
    d = np.abs(got - want)
    assert (d <= 2.0 ** -7 * np.abs(want) + 1e-6 * top).all(), d.max()
    rms = lambda a: float(np.sqrt(np.mean((a - want) ** 2)))   # noqa: E731
    assert rms(got) < rms(deq), (rms(got), rms(deq))
    assert (got != want).sum() < (deq != want).sum()


# ---------------------------------------------------------------------------
# the decode step, the head and lockstep generation on a tiny Qwen3


def _cfg():
    # every projection's (K, N) passes JAX's bytes and pairs gates, so its
    # Pallas route takes the stacked K11 kernels for all of them
    return jd.DecoderConfig(
        vocab_size=128, hidden_size=HIDDEN, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=256, head_dim=128,
        rope_theta=10000.0, qk_norm=True)


@pytest.fixture(scope="module")
def base():
    jcfg = _cfg()
    return jcfg, td.DecoderConfig(**jcfg.__dict__), jd.init_decoder_params(
        jcfg, jax.random.PRNGKey(1))


def _quantized(params, fmt, dtype=None):
    jparams = jquant.quantize_params(params, bits=4, int4_format=fmt)
    return jparams, _t(jparams, dtype)


@pytest.mark.parametrize("fmt,route", [("bytes", "xla"), ("bytes", "pallas"),
                                       ("pairs", "xla"), ("pairs", "pallas")])
def test_decode_step_formats_match_jax(base, monkeypatch, fmt, route):
    jcfg, tcfg, params = base
    jparams, tparams = _quantized(params, fmt)
    if route == "pallas":
        monkeypatch.setenv("P2T_PALLAS_FORCE_INTERPRET", "1")
    rng = np.random.default_rng(len(fmt))
    T = 32
    cache = {n: rng.standard_normal((2, B, 2, T, 128)).astype(np.float32)
             for n in ("k", "v")}
    mask = (rng.random((B, T)) < 0.6).astype(np.int32)
    slots = np.array([9, 20, T - 1], np.int32)
    mask[np.arange(B), slots] = 0
    tok = rng.standard_normal((B, 1, HIDDEN)).astype(np.float32)
    pos = np.array([[12], [30], [4]], np.int32)
    bias_old = np.where(mask > 0, 0.0, np.finfo(np.float32).min).astype(
        np.float32)[:, None, None, :]
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
    assert _rel(th.numpy(), jh) <= (LOOSE if route == "xla" else TIGHT)


def test_decode_step_routes_each_format_to_its_kernel(base, monkeypatch):
    """Every projection of every layer goes through `linear` to the K11a
    (bytes) or K11b (pairs) wrapper with B rows and its layer's view of
    the stacked buffer."""
    jcfg, tcfg, params = base
    for fmt, name in (("bytes", "quant_matmul_int4"),
                      ("pairs", "quant_matmul_int4_pairs")):
        _, tparams = _quantized(params, fmt)
        key = FORMATS[fmt]
        seen = []
        real = getattr(tt, name)

        def spy(x, w, s, real=real, seen=seen):
            seen.append((x.shape[0], tuple(w.shape)))
            return real(x, w, s)

        monkeypatch.setattr(tt, name, spy)
        T = 32
        cache = {n: torch.zeros((2, B, 2, T, 128)) for n in ("k", "v")}
        td.decoder_decode_step(
            tcfg, tparams, token_embeds=torch.ones((B, 1, HIDDEN)),
            kv_mask=torch.ones((B, T), dtype=torch.int32),
            positions=torch.zeros((B, 1), dtype=torch.long), kv_cache=cache,
            cache_index=torch.tensor([1, 2, 3]))
        shapes = [tuple(p[key].shape[1:]) for n, p in sorted(
            tparams["layers"].items()) if key in p]
        assert len(seen) == 14 and {s[0] for s in seen} == {B}
        assert sorted(s[1] for s in seen) == sorted(shapes * 2)


@pytest.mark.parametrize("fmt", ["bytes", "pairs"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_head_formats_match_jax(base, fmt, dtype):
    """The fp32 logits of an x-dtype output: against JAX's kernel in
    interpret mode (bytes; JAX's unstacked pairs kernel runs on the TPU
    only, so pairs against its exact XLA route) within 1e-5 of max (2^-8
    for a bf16 output), and JAX's head, an XLA route off the TPU, within
    1e-2."""
    jcfg, tcfg, params = base
    jparams, tparams = _quantized(params, fmt)
    rng = np.random.default_rng(30 + len(fmt))
    h = rng.standard_normal((B, 2, HIDDEN)).astype(np.float32)
    th = torch.from_numpy(h).to(getattr(torch, dtype))
    got = td.decoder_logits(tcfg, tparams, th)
    assert got.dtype == torch.float32 and got.shape == (B, 2, 128)
    assert torch.equal(got, got.to(th.dtype).float())
    lm = jparams["lm_head"]
    x = jnp.asarray(th.float().numpy()).reshape(-1, HIDDEN)
    if fmt == "bytes":
        kern = jqm.quant_matmul_int4(x, lm["kernel_q4"], lm["scale"],
                                     out_dtype=jnp.float32, interpret=True)
    else:
        xb = x.astype(jnp.bfloat16).astype(jnp.float32)
        kern = jqm.quant_matmul_int4_pairs_xla(xb, lm["kernel_q4w"],
                                               lm["scale"], jnp.float32)
    want = np.asarray(kern).reshape(B, 2, 128)
    assert _rel(got.numpy(), want) <= (1e-5 if dtype == "float32"
                                       else 2 ** -8)
    xla = jd.decoder_logits(jcfg, jparams, jnp.asarray(th.float().numpy()))
    assert _rel(got.numpy(), xla) <= LOOSE


SUCC = 20.0
MARGIN = 2.0


def _successor_params(seed=5):
    """The tiny decoder in f32 with decisive greedy steps: embeddings scaled
    20-fold dominate the residual stream and the head maps each token's
    direction to its successor's logit."""
    jcfg = _cfg()
    params = jd.init_decoder_params(jcfg, jax.random.PRNGKey(seed))
    E = np.asarray(params["embed_tokens"])
    succ = np.random.default_rng(seed).permutation(jcfg.vocab_size)
    W = np.zeros((HIDDEN, jcfg.vocab_size), np.float32)
    W[:, succ] = E.T * SUCC
    params["lm_head"]["kernel"] = jnp.asarray(W)
    params["embed_tokens"] = jnp.asarray(E * 20.0)
    return jcfg, td.DecoderConfig(**jcfg.__dict__), params


def _prompts(params, P=12):
    rng = np.random.default_rng(41)
    E = np.asarray(params["embed_tokens"])
    ids = rng.integers(0, 128, (B, P))
    mask = np.ones((B, P), np.int32)
    mask[0, :4] = 0
    mask[2, :7] = 0
    return E[ids].astype(np.float32) * mask[..., None], mask


def _margin(tcfg, tparams, emb, mask, toks):
    """Smallest top-1 minus top-2 logit over the generated positions of the
    port's f32 teacher-forced forward."""
    worst = np.inf
    for b in range(emb.shape[0]):
        keep = mask[b] > 0
        x = torch.cat([torch.from_numpy(emb[b][keep]),
                       tparams["embed_tokens"][torch.from_numpy(
                           toks[b, :-1])]])[None]
        n = x.shape[1]
        h, _ = td.decoder_forward(
            tcfg, tparams, inputs_embeds=x, positions=torch.arange(n)[None],
            attn_lengths=td.contiguous_lengths(torch.ones(1, n)))
        lg = td.decoder_logits(tcfg, tparams, h)[0, int(keep.sum()) - 1:]
        top = torch.topk(lg, 2, dim=-1).values
        worst = min(worst, (top[:, 0] - top[:, 1]).min().item())
    return worst


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_lockstep_generate_formats_match_jax(monkeypatch, route):
    """`generate` on planes, bytes and pairs trees of the same float
    weights: the port's tokens and prefill/first-step logits are identical
    across the three formats, and its tokens equal JAX's `generate` in each
    format under a top-1 margin guard (JAX's XLA route never rounds x to
    bf16; its Pallas route rounds as the port does)."""
    if route == "pallas":
        monkeypatch.setenv("P2T_PALLAS_FORCE_INTERPRET", "1")
    jcfg, tcfg, params = _successor_params()
    emb, mask = _prompts(params)
    N = 8
    outs = {}
    for fmt in ("planes", "bytes", "pairs"):
        jparams, tparams = _quantized(params, fmt)
        stats = {}
        got = tgen.generate(
            tcfg, tparams, inputs_embeds=torch.from_numpy(emb),
            attention_mask=torch.from_numpy(mask),
            gen_cfg=tgen.GenerationConfig(max_new_tokens=N, eos_token_id=-1,
                                          pad_token_id=0),
            stats=stats).numpy()
        m = _margin(tcfg, tparams, emb, mask, got)
        assert m > MARGIN, f"{fmt}: top-1 margin {m:.3f} <= {MARGIN}"
        want = np.asarray(jgen.generate(
            jcfg, jparams, inputs_embeds=jnp.asarray(emb),
            attention_mask=jnp.asarray(mask),
            gen_cfg=jgen.GenerationConfig(max_new_tokens=N, eos_token_id=-1,
                                          pad_token_id=0)))
        np.testing.assert_array_equal(got, want, err_msg=fmt)
        outs[fmt] = (got, [t.numpy() for t in stats["logits"]])
    for fmt in ("bytes", "pairs"):
        np.testing.assert_array_equal(outs[fmt][0], outs["planes"][0])
        for a, b in zip(outs[fmt][1], outs["planes"][1]):
            np.testing.assert_array_equal(a, b)
