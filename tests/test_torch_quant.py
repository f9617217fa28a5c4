"""Weight quantization (`models/quant.py`) and the quantized `linear` against
the JAX package on the same weights:

  * `quantize_leaf` and `quantize_params` (int8, int4 nibble planes) give
    JAX's trees on tiny ESMC and Qwen3 towers: the same keys, dtypes and
    shapes, scales within 1e-6 relative, integer values equal except where
    the fp32 pre-image w/scale lies within 1e-5 of a half-integer (there
    the two frameworks' last bits may round one level apart, and nothing
    else may differ); a stacked leaf quantized in chunks of layers equals
    one quantized whole; the K11 formats raise;
  * JAX's quantized trees cross the weight bridge bit-exactly;
  * `linear` on quantized leaves equals JAX's `linear` within 1e-5 of the
    largest output when x is bf16-representable (the port rounds x to bf16
    at <= 256 rows, JAX's XLA route does not round), at few rows (K10/K14
    plain versions) and at many (the dequantized matmul); the quantized
    ESMC encoder against JAX's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prot2text_tpu.kernels import quant_matmul as jqm
from prot2text_tpu.models import esmc as jesmc
from prot2text_tpu.models import qwen3 as jq
from prot2text_tpu.models import quant as jquant
from prot2text_tpu.models import transformer as jt
from prot2text_tpu_torch.kernels.quant_matmul import unpack_int4_planes
from prot2text_tpu_torch.models import esmc as tesmc
from prot2text_tpu_torch.models import quant as tquant
from prot2text_tpu_torch.models import transformer as tt
from prot2text_tpu_torch.models.weights import params_from_jax, tree_map

ESMC = dict(d_model=64, n_layers=2, n_heads=4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return params_from_jax(_np(tree)).tree()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _assert_ints_close(got, want, pre):
    """Integer values equal except one level apart where the fp32 pre-image
    `pre` lies within 1e-5 of a half-integer."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    diff = got != want
    if diff.any():
        assert np.abs(got - want)[diff].max() == 1
        frac = np.abs(np.abs(np.asarray(pre)[diff]) % 1.0 - 0.5)
        assert frac.max() <= 1e-5, frac.max()


def _pre(w, scale):
    return (np.asarray(w, np.float32) / np.asarray(scale, np.float32))


def _towers(dtype=jnp.float32):
    return {"esmc": jesmc.init_esmc_params(jesmc.ESMCConfig(**ESMC),
                                           jax.random.PRNGKey(3), dtype),
            "qwen3": jq.init_qwen3_params(jq.Qwen3Config.tiny(),
                                          jax.random.PRNGKey(4), dtype)}


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_leaf_matches_jax(bits, dtype):
    rng = np.random.default_rng(bits)
    w = jnp.asarray(rng.standard_normal((3, 64, 40)) * 0.02,
                    getattr(jnp, dtype))
    jqv, js = jquant.quantize_leaf(w, bits)
    tw = torch.from_numpy(np.array(w.astype(jnp.float32))).to(
        getattr(torch, dtype))
    tqv, ts = tquant.quantize_leaf(tw, bits)
    assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == (3, 1, 40)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    _assert_ints_close(tqv.numpy(), jqv, _pre(tw.float().numpy(), js))
    assert np.abs(tqv.numpy()).max() <= 2 ** (bits - 1) - 1


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("tower", ["esmc", "qwen3"])
def test_quantize_params_matches_jax(bits, tower):
    base = _towers()[tower]
    want = _flat(_np(jquant.quantize_params(base, bits=bits)))
    got = _flat(tquant.quantize_params(_t(base), bits=bits))
    flat_base = _flat(_np(base))
    assert set(got) == set(want)
    n_quant = 0
    for path, w in want.items():
        g = got[path]
        assert g.dtype == torch.from_numpy(np.zeros(0, w.dtype)).dtype, path
        assert tuple(g.shape) == w.shape, path
        if path.endswith("/scale") and path.replace(
                "/scale", "/kernel") in flat_base:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)
        elif path.endswith(("/kernel_q", "/kernel_q4p")):
            n_quant += 1
            kpath = path.rsplit("/", 1)[0]
            pre = _pre(flat_base[kpath + "/kernel"], want[kpath + "/scale"])
            if path.endswith("q4p"):
                g = unpack_int4_planes(g)
                w = jqm.unpack_int4_planes(jnp.asarray(w))
            _assert_ints_close(g.numpy() if torch.is_tensor(g) else g, w,
                               pre)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
    # every projection of the tower, and its LM head, is quantized
    assert n_quant == {"esmc": 4, "qwen3": 8}[tower]
    key = "kernel_q4p" if bits == 4 else "kernel_q"
    assert all(not p.endswith("/kernel") or "embed" in p for p in got)
    assert any(p.endswith(key) for p in got)


def test_stacked_leaf_in_layer_chunks_equals_whole(monkeypatch):
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((5, 64, 24)) * 0.02).astype(
        np.float32))
    for bits in (4, 8):
        monkeypatch.setattr(tquant, "_LAYER_CHUNK", 5)
        whole = tquant.quantize_params({"q_proj": {"kernel": w}}, bits=bits)
        for chunk in (1, 2, 4):
            monkeypatch.setattr(tquant, "_LAYER_CHUNK", chunk)
            part = tquant.quantize_params({"q_proj": {"kernel": w}},
                                          bits=bits)
            for k in whole["q_proj"]:
                assert torch.equal(part["q_proj"][k], whole["q_proj"][k])


def test_int4_formats_of_k11_raise_and_odd_din_stays_int8():
    """The K11 formats are ported: `int4_format` "pairs" and "bytes" give
    JAX's kernel_q4w / kernel_q4 leaves (bit-identical here, where no
    pre-image lies near a half-integer), a din % 8 != 0 falls back to
    split-half bytes under every format, as in JAX, and an odd din keeps
    int4 values in int8 storage; bits other than 4 and 8 and an unknown
    format raise."""
    rng = np.random.default_rng(1)
    for din, fmt, key in ((16, "pairs", "kernel_q4w"),
                          (16, "bytes", "kernel_q4"),
                          (12, "planes", "kernel_q4"),
                          (12, "pairs", "kernel_q4"),
                          (9, "planes", "kernel_q")):
        w = (rng.standard_normal((2, din, 8)) * 0.02).astype(np.float32)
        got = tquant.quantize_params(
            {"q_proj": {"kernel": torch.from_numpy(w)}}, bits=4,
            int4_format=fmt)["q_proj"]
        want = _np(jquant.quantize_params(
            {"q_proj": {"kernel": jnp.asarray(w)}}, bits=4,
            int4_format=fmt)["q_proj"])
        assert set(got) == set(want) == {key, "scale"}, (din, fmt)
        assert got[key].dtype == torch.from_numpy(want[key]).dtype
        np.testing.assert_array_equal(got[key].numpy(), want[key])
        np.testing.assert_allclose(got["scale"].numpy(), want["scale"],
                                   rtol=1e-6)
        unpack = tquant.INT4_FORMATS.get(key, (None, lambda t: t))[1]
        assert unpack(got[key]).abs().max() <= 7
    w = torch.zeros((2, 16, 8))
    with pytest.raises(ValueError, match="bits"):
        tquant.quantize_params({"q_proj": {"kernel": w}}, bits=3)
    with pytest.raises(ValueError, match="int4_format"):
        tquant.quantize_params({"q_proj": {"kernel": w}}, bits=4,
                               int4_format="nibbles")


def test_dequantize_and_quantized_bytes_match_jax():
    base = _towers(jnp.bfloat16)["qwen3"]
    for bits in (4, 8):
        jtree = jquant.quantize_params(base, bits=bits)
        ttree = tquant.quantize_params(params_from_jax(
            _np(base), dtype=torch.bfloat16).tree(), bits=bits)
        assert tquant.quantized_bytes(ttree) == jquant.quantized_bytes(jtree)
    jtree = jquant.quantize_params(base, bits=8)
    leaf = jtree["layers"]["gate_proj"]
    want = jquant.dequantize_leaf(leaf["kernel_q"], leaf["scale"])
    got = tquant.dequantize_leaf(torch.from_numpy(np.asarray(
        leaf["kernel_q"])), torch.from_numpy(np.asarray(leaf["scale"])))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("bits", [4, 8])
def test_bridge_carries_quantized_trees_bit_exactly(bits):
    jtree = _np(jquant.quantize_params(_towers(jnp.bfloat16)["qwen3"],
                                       bits=bits))
    got = _flat(params_from_jax(jtree).tree())
    for path, w in _flat(jtree).items():
        if w.dtype.kind in "iu":
            assert got[path].dtype == {np.dtype(np.int8): torch.int8,
                                       np.dtype(np.int32): torch.int32}[
                                           w.dtype], path
            np.testing.assert_array_equal(got[path].numpy(), w)


def _xbf16(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float().numpy()


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("lead", [(5,), (2, 3), (300,), (2, 160)],
                         ids=["rows5", "rows2x3", "rows300", "rows2x160"])
def test_linear_quantized_matches_jax(bits, lead):
    """K10/K14 plain versions at <= 256 rows, the dequantized matmul above;
    a bias leaf is kept and added."""
    rng = np.random.default_rng(bits + len(lead))
    w = (rng.standard_normal((64, 48)) * 0.02).astype(np.float32)
    b = (rng.standard_normal(48) * 0.1).astype(np.float32)
    jp = jquant.quantize_params({"q_proj": {"kernel": jnp.asarray(w),
                                            "bias": jnp.asarray(b)}},
                                bits=bits)["q_proj"]
    x = _xbf16(rng, *lead, 64)
    want = np.asarray(jt.linear(jp, jnp.asarray(x)))
    got = tt.linear(_t(jp), torch.from_numpy(x))
    assert tuple(got.shape) == lead + (48,)
    top = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * top


def test_linear_dequantized_route_runs_in_x_dtype():
    """The routes that still dequantize meet the weight in x's dtype: an
    f32 x above 256 rows (every format: JAX's XLA route leaves it
    unrounded), and a call whose f32 x requires grad (every format, at any
    row count: JAX's XLA numerics under grad).  A bf16 x that requires
    grad runs its kernel (`_QuantLinear`; tests/test_torch_qlora.py)."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy((rng.standard_normal((64, 16)) * 0.02).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((300, 64)).astype(np.float32))
    for bits, fmt in ((4, "planes"), (4, "bytes"), (4, "pairs"), (8, None)):
        p = tquant.quantize_params(
            {"q_proj": {"kernel": w}}, bits=bits,
            **({"int4_format": fmt} if fmt else {}))["q_proj"]
        y = tt.linear(p, x)
        want = x @ tquant.dequantize_kernel(p, torch.float32)
        assert y.dtype == torch.float32 and torch.equal(y, want), fmt
    for bits in (4, 8):
        p = tquant.quantize_params({"q_proj": {"kernel": w}},
                                   bits=bits)["q_proj"]
        for R in (5, 300):
            xg = x[:R].clone().requires_grad_()
            y = tt.linear(p, xg)
            want = xg @ tquant.dequantize_kernel(p, torch.float32)
            assert y.dtype == torch.float32 and torch.equal(y, want), (
                bits, R)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("S", [9, 160])
def test_quantized_esmc_encode_matches_jax(bits, S):
    """The quantized ESMC encoder: at B·S = 320 rows (the dequantized
    route) within 1e-5; at 18 rows the port rounds x to bf16 in each of the
    8 projections (K10/K14 plain) where JAX's XLA route does not: within
    2e-2 of the largest output."""
    jcfg, tcfg = jesmc.ESMCConfig(**ESMC), tesmc.ESMCConfig(**ESMC)
    params = jquant.quantize_params(
        jesmc.init_esmc_params(jcfg, jax.random.PRNGKey(7)), bits=bits)
    rng = np.random.default_rng(S)
    ids = rng.integers(4, 24, (2, S)).astype(np.int32)
    ids[:, 0] = 0
    ids[1, S - 3:] = 1
    mask = (ids != 1).astype(np.int32)
    want = np.asarray(jesmc.esmc_encode(jcfg, params, ids, mask))
    got = tesmc.esmc_encode(tcfg, _t(params), torch.from_numpy(ids),
                            torch.from_numpy(mask)).numpy()
    tol = 1e-5 if 2 * S > 256 else 2e-2
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_quantized_towers_have_no_float_projection_left():
    base = _t(_towers()["qwen3"])
    q = tquant.quantize_params(base, bits=4)
    floats = [p for p, v in _flat(q).items()
              if p.endswith("/kernel")]
    assert floats == []
    assert tree_map(lambda t: t.dtype, q)["embed_tokens"] == torch.float32
