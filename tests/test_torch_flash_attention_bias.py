"""K6 forward (flash attention with an additive fp32 bias): the port's plain
version against the JAX Pallas kernel `flash_attention_tpu` in interpret
mode on repeat_kv'd inputs (f32, atol 1e-5) — the bias shapes the JAX
kernel takes, Sq != Skv with a seeded prefix, lengths off the 128 grid and
a fully masked row; the CUDA kernel against the plain version on the card;
`flash_attention_bias` is differentiable (its backward, K6b, is held to
JAX in tests/test_torch_flash_attention_bias_bwd.py)."""

import numpy as np
import pytest
import torch

from prot2text_tpu_torch.kernels.flash_attention import (
    flash_attention_bias, flash_attention_bias_bwd_plain,
    flash_attention_bias_fwd, flash_attention_bias_plain,
)

ATOL = 1e-5
NEG = float(np.finfo(np.float32).min)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(B, H, Hkv, Sq, Skv, D, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, Sq, D)) * D ** -0.5).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    return q, k, v


def _install_bias(B, Sq, Pc, prefix_len, pads):
    """The serving prefix install's bias (B, 1, Sq, Pc + Sq): the prefix's
    valid columns, then causal over the left-padded suffix."""
    idx = np.arange(Sq)
    ok = np.zeros((B, 1, Sq, Pc + Sq), bool)
    ok[:, :, :, Pc - prefix_len:Pc] = True
    for b, pad in enumerate(pads):
        ok[b, 0, :, Pc:] = (idx[None, :] <= idx[:, None]) & (idx >= pad)
    return np.where(ok, 0.0, NEG).astype(np.float32)


def _jax(q, k, v, bias):
    import jax.numpy as jnp

    from prot2text_tpu.kernels.flash_attention import flash_attention_tpu
    from prot2text_tpu.models.transformer import repeat_kv as j_repeat_kv

    rep = q.shape[1] // k.shape[1]
    return np.asarray(flash_attention_tpu(
        jnp.asarray(q), j_repeat_kv(jnp.asarray(k), rep),
        j_repeat_kv(jnp.asarray(v), rep), jnp.asarray(bias), interpret=True))


def _port(q, k, v, bias):
    return flash_attention_bias(*(torch.from_numpy(a) for a in (q, k, v,
                                                               bias))).numpy()


@pytest.mark.parametrize("bias_shape", ["b1qk", "bhqk", "b11k"])
def test_plain_matches_pallas_interpret_bias_shapes(bias_shape):
    B, H, Hkv, S, D = 2, 4, 2, 16, 64
    q, k, v = _inputs(B, H, Hkv, S, S, D)
    rng = np.random.default_rng(1)
    shape = {"b1qk": (B, 1, S, S), "bhqk": (B, H, S, S),
             "b11k": (B, 1, 1, S)}[bias_shape]
    bias = rng.standard_normal(shape).astype(np.float32)
    bias[..., :3] = NEG                   # some masked columns
    np.testing.assert_allclose(_port(q, k, v, bias), _jax(q, k, v, bias),
                               atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("rep,D", [(1, 16), (4, 64), (5, 128)])
def test_plain_matches_pallas_interpret_seeded_prefix(rep, D):
    """Sq != Skv: suffix queries over [seeded prefix ‖ suffix], left-padded
    rows, as the serving install calls it."""
    B, Hkv, Sq, Pc = 3, 2, 16, 32
    q, k, v = _inputs(B, rep * Hkv, Hkv, Sq, Pc + Sq, D, seed=2)
    bias = _install_bias(B, Sq, Pc, prefix_len=21, pads=[0, 5, 11])
    np.testing.assert_allclose(_port(q, k, v, bias), _jax(q, k, v, bias),
                               atol=ATOL, rtol=ATOL)


def test_plain_matches_pallas_interpret_off_grid():
    """Sq and Skv off every tile grid: the TPU kernel pads them (-1e30 bias
    columns); the port masks its ragged edges."""
    B, H, Hkv, Sq, Pc, D = 2, 4, 4, 13, 24, 32
    q, k, v = _inputs(B, H, Hkv, Sq, Pc + Sq, D, seed=3)
    bias = _install_bias(B, Sq, Pc, prefix_len=19, pads=[0, 6])
    np.testing.assert_allclose(_port(q, k, v, bias), _jax(q, k, v, bias),
                               atol=ATOL, rtol=ATOL)


def test_fully_masked_row_matches_pallas_interpret():
    """A row whose bias is finfo(f32).min everywhere is not special-cased:
    as in the TPU kernel, whose running max starts at -1e30, it gets zero
    weights, o = 0 and lse = -1e30."""
    B, H, Hkv, S, D = 2, 2, 1, 16, 16
    q, k, v = _inputs(B, H, Hkv, S, S, D, seed=4)
    bias = np.zeros((B, 1, S, S), np.float32)
    bias[1, 0, 5] = NEG
    want = _jax(q, k, v, bias)
    got = _port(q, k, v, bias)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    assert not np.abs(got[1, :, 5]).any()
    _, lse = flash_attention_bias_plain(
        *(torch.from_numpy(a) for a in (q, k, v, bias)))
    assert (lse[1, :, 5] == -1e30).all()


def test_gradient_raises():
    """The gradient that raised before K6b was ported now flows, and
    matches the plain version's (K6b's plain twin, 1e-6 of its largest
    |entry|); no bias gradient; without grad the output is K6's."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 4, 4, 16))
    bias = torch.zeros(1, 1, 4, 4)
    bias[..., 3] = NEG
    do = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 2, 4, 16)).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention_bias(*leaves, bias).backward(do)
    o, lse = flash_attention_bias_plain(q, k, v, bias)
    want = flash_attention_bias_bwd_plain(q, k, v, bias, o, lse, do)
    for t, w in zip(leaves, want):
        assert t.grad is not None and t.grad.shape == w.shape
        torch.testing.assert_close(t.grad, w, rtol=0,
                                   atol=1e-6 * w.abs().max().item())
    assert not bias.requires_grad and bias.grad is None
    with torch.no_grad():
        torch.testing.assert_close(flash_attention_bias(q, k, v, bias), o)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rep,D", [(5, 128), (4, 64), (1, 16)])
@pytest.mark.parametrize("bias_kind", ["install", "bhqk", "b11k"])
def test_kernel_matches_plain_on_cuda(cuda, dtype, atol, rep, D, bias_kind):
    B, Hkv, Sq, Pc = 3, 2, 77, 64
    q, k, v = _inputs(B, rep * Hkv, Hkv, Sq, Pc + Sq, D, seed=5)
    if bias_kind == "install":
        bias = _install_bias(B, Sq, Pc, prefix_len=40, pads=[0, 9, 30])
        bias[2, 0, 3] = NEG                   # a fully masked row
    else:
        shape = ((B, rep * Hkv, Sq, Pc + Sq) if bias_kind == "bhqk"
                 else (B, 1, 1, Pc + Sq))
        bias = np.random.default_rng(6).standard_normal(shape).astype(
            np.float32)
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in (q, k, v))
    bias = torch.from_numpy(bias).to(cuda)
    n = flash_attention_bias_fwd.launches
    o, lse = flash_attention_bias_fwd(q, k, v, bias)
    torch.cuda.synchronize()
    assert flash_attention_bias_fwd.launches == n + 1
    o_ref, lse_ref = flash_attention_bias_plain(q.float(), k.float(),
                                                v.float(), bias)
    torch.testing.assert_close(o.float(), o_ref, atol=atol, rtol=atol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0.0)
