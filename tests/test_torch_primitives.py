"""The port's transformer primitives and llama3 rope against the JAX
package, on the same numpy inputs (f32, atol 1e-6)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prot2text_tpu.models import decoder as jdec
from prot2text_tpu.models import transformer as jtr
from prot2text_tpu_torch.models import decoder as tdec
from prot2text_tpu_torch.models import transformer as ttr

ATOL = 1e-6


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_linear_layer_norm_rms_norm_gelu(rng):
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    p = {"kernel": rng.standard_normal((24, 12)).astype(np.float32) * 0.1,
         "bias": rng.standard_normal(12).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    _close(ttr.linear(tp, tx), jtr.linear(jp, jnp.asarray(x)), atol=ATOL)
    ln = {"scale": rng.standard_normal(24).astype(np.float32),
          "bias": rng.standard_normal(24).astype(np.float32)}
    _close(ttr.layer_norm({k: torch.from_numpy(v) for k, v in ln.items()},
                          tx),
           jtr.layer_norm({k: jnp.asarray(v) for k, v in ln.items()},
                          jnp.asarray(x)), atol=ATOL)
    _close(ttr.rms_norm({"scale": torch.from_numpy(ln["scale"])}, tx, 1e-5),
           jtr.rms_norm({"scale": jnp.asarray(ln["scale"])}, jnp.asarray(x),
                        1e-5), atol=ATOL)
    _close(ttr.gelu_erf(tx), jtr.gelu_erf(jnp.asarray(x)))


def test_linear_refuses_quantized_leaves():
    """int8 (`kernel_q`) and int4 nibble-plane (`kernel_q4p`) leaves are
    ported (K14, K10); the other int4 formats (kernel K11) and the
    tensor-parallel repacks still raise, naming their ROADMAP item."""
    x = torch.zeros(2, 16)
    for leaf, pattern in (
            ({"kernel_q4": torch.zeros(8, 4, dtype=torch.int8)},
             r"K11.*ROADMAP\.md §2"),
            ({"kernel_q4w": torch.zeros(2, 4, dtype=torch.int32)},
             r"K11.*ROADMAP\.md §2"),
            ({"kernel_q4p_tp2": torch.zeros(2, 4, dtype=torch.int32)},
             r"ROADMAP\.md §1 item 14")):
        with pytest.raises(NotImplementedError, match=pattern):
            ttr.linear({**leaf, "scale": torch.ones(1, 4)}, x)
    y = ttr.linear({"kernel_q": torch.ones(16, 4, dtype=torch.int8),
                    "scale": torch.full((1, 4), 0.5)}, x + 1.0)
    assert torch.equal(y, torch.full((2, 4), 8.0))


@pytest.mark.parametrize("cos_rank", [2, 3])
def test_rope(rng, cos_rank):
    B, H, S, D = 2, 3, 7, 16
    x = rng.standard_normal((B, H, S, D)).astype(np.float32)
    pos = (np.arange(S)[None] + rng.integers(0, 50, (B, 1))).astype(np.int32)
    if cos_rank == 2:
        pos = pos[0]
    tc, ts = ttr.rope_cos_sin(torch.from_numpy(pos), D, 10000.0)
    jc, js = jtr.rope_cos_sin(jnp.asarray(pos), D, 10000.0)
    _close(tc, jc)
    _close(ts, js)
    _close(ttr.rotate_half(torch.from_numpy(x)),
           jtr.rotate_half(jnp.asarray(x)))
    _close(ttr.apply_rope(torch.from_numpy(x), tc, ts),
           jtr.apply_rope(jnp.asarray(x), jc, js), atol=ATOL)


def test_repeat_kv_and_attention_bias(rng):
    x = rng.standard_normal((2, 2, 5, 4)).astype(np.float32)
    _close(ttr.repeat_kv(torch.from_numpy(x), 3),
           jtr.repeat_kv(jnp.asarray(x), 3), atol=0)
    mask = np.array([[0, 1, 1, 1, 1], [1, 1, 1, 0, 0]], np.int32)
    pos = np.clip(np.cumsum(mask, 1) - 1, 0, None).astype(np.int32)
    for causal in (False, True):
        kw = dict(causal=causal)
        if causal:
            kw.update(q_positions=pos, kv_positions=pos)
        t = ttr.make_attention_bias(
            torch.from_numpy(mask), causal=causal,
            **({k: torch.from_numpy(v) for k, v in kw.items()
                if k != "causal"}))
        j = jtr.make_attention_bias(
            jnp.asarray(mask), causal=causal,
            **({k: jnp.asarray(v) for k, v in kw.items() if k != "causal"}))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("scaling,factor", [(None, 8.0), ("llama3", 8.0),
                                            ("llama3", 32.0)])
def test_llama3_rope_scaling(scaling, factor):
    kw = dict(vocab_size=8, hidden_size=512, num_layers=1, num_heads=4,
              num_kv_heads=2, intermediate_size=8, head_dim=128,
              rope_theta=500000.0, rope_scaling=scaling,
              rope_scaling_factor=factor)
    pos = np.array([[0, 1, 5, 900, 8191, 20000]], np.int32)
    tc, ts = tdec.decoder_rope_cos_sin(tdec.DecoderConfig(**kw),
                                       torch.from_numpy(pos))
    jc, js = jdec.decoder_rope_cos_sin(jdec.DecoderConfig(**kw),
                                       jnp.asarray(pos))
    _close(tc, jc)
    _close(ts, js)
    D = 128
    inv = 1.0 / (500000.0 ** (np.arange(0, D, 2, dtype=np.float32) / D))
    t_inv = tdec._rope_inv_freq_scale(tdec.DecoderConfig(**kw),
                                      torch.from_numpy(inv))
    j_inv = jdec._rope_inv_freq_scale(jdec.DecoderConfig(**kw),
                                      jnp.asarray(inv))
    np.testing.assert_allclose(t_inv.numpy(), np.asarray(j_inv), rtol=1e-6)


def test_contiguous_lengths():
    mask = np.array([[0, 0, 1, 1, 1], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0],
                     [1, 1, 0, 0, 0]], np.int32)
    ts, tl = tdec.contiguous_lengths(torch.from_numpy(mask))
    js, jl = jdec.contiguous_lengths(jnp.asarray(mask))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert ts.dtype == tl.dtype == torch.int32
