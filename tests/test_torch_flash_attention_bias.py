"""K6 forward (flash attention with an additive fp32 bias): the port's plain
version against the JAX Pallas kernel `flash_attention_tpu` in interpret
mode on repeat_kv'd inputs (f32, atol 1e-5) — the bias shapes the JAX
kernel takes, Sq != Skv with a seeded prefix, lengths off the 128 grid and
a fully masked row; the CUDA kernel against the plain version on the card
(f32 the SIMT body, bf16 the tensor-core body of
csrc/flash_attention_fwd.cuh, with cases for its edges: whole masked key
tiles, the scalar bias loads at odd Skv, Sq != Skv, every head dim, GQA,
strided views, fully masked rows, misaligned views);
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


def _bshd(rng, B, S, H, D, scale, dev):
    """A (B, H, S, D) bf16 view of a (B, S, H, D) buffer, as ESMC and the
    decoder hand q/k/v over."""
    x = (rng.standard_normal((B, S, H, D)) * scale).astype(np.float32)
    return torch.from_numpy(x).to(dev, torch.bfloat16).transpose(1, 2)


# (B, rep, Hkv, Sq, Pc, D, bias kind); Skv = Pc + Sq
K6_EDGES = [
    # the install: prefix columns 0..171 masked for every row (whole key
    # tiles), the causal suffix above each q tile, a 70-column left pad
    (2, 5, 2, 200, 192, 128, "install"),
    # (B, 1, 1, Skv) at odd Skv 141: scalar bias loads, row b's base odd
    (3, 1, 2, 77, 64, 16, "b11k"),
    # (B, 1, 1, Skv) at Skv 256: one 16-byte-aligned row for every query
    (2, 5, 2, 96, 160, 64, "b11k"),
    (2, 4, 2, 50, 80, 32, "b1qk"),          # Sq != Skv, off the 16 grid
    (2, 5, 1, 64, 0, 64, "bhqk"),           # a per-head bias
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,rep,Hkv,Sq,Pc,D,kind", K6_EDGES)
def test_bf16_tensor_core_body_edges_on_cuda(cuda, B, rep, Hkv, Sq, Pc, D,
                                             kind):
    H, Skv = rep * Hkv, Pc + Sq
    rng = np.random.default_rng(Skv * 7 + D)
    q = _bshd(rng, B, Sq, H, D, D ** -0.5, cuda)
    k, v = (_bshd(rng, B, Skv, Hkv, D, 1.0, cuda) for _ in range(2))
    if kind == "install":
        bias = _install_bias(B, Sq, Pc, prefix_len=20, pads=[0, 70])
    else:
        shape = {"b11k": (B, 1, 1, Skv), "b1qk": (B, 1, Sq, Skv),
                 "bhqk": (B, H, Sq, Skv)}[kind]
        bias = rng.standard_normal(shape).astype(np.float32)
        bias[..., :3] = NEG
    if bias.shape[2] > 1:
        bias[B - 1, :, 5] = NEG                 # fully masked rows
    bias = torch.from_numpy(bias).to(cuda)
    n = flash_attention_bias_fwd.launches
    o, lse = flash_attention_bias_fwd(q, k, v, bias)
    torch.cuda.synchronize()
    assert flash_attention_bias_fwd.launches == n + 1
    o_ref, lse_ref = flash_attention_bias_plain(q.float(), k.float(),
                                                v.float(), bias)
    torch.testing.assert_close(o.float(), o_ref, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0.0)
    if bias.shape[2] > 1:
        assert (o[B - 1, :, 5] == 0).all()
        assert (lse[B - 1, :, 5] == torch.tensor(-1e30)).all()


@pytest.mark.cuda
def test_bf16_misaligned_view_raises_on_cuda(cuda):
    """A bf16 q shifted one element off a 16-byte boundary raises before
    any launch; the f32 SIMT body takes the same view."""
    B, H, S, D = 1, 2, 17, 64
    buf = torch.randn(B, H, S, D + 1, device=cuda)
    k = torch.randn(B, H, S, D, device=cuda)
    bias = torch.zeros(B, 1, 1, S, device=cuda)
    n = flash_attention_bias_fwd.launches
    with pytest.raises(ValueError, match="K6: bf16 q must be 16-byte"):
        flash_attention_bias_fwd(buf.bfloat16()[..., 1:], k.bfloat16(),
                                 k.bfloat16(), bias)
    assert flash_attention_bias_fwd.launches == n
    q = buf[..., 1:]
    o, _ = flash_attention_bias_fwd(q, k, k, bias)
    torch.testing.assert_close(o, flash_attention_bias_plain(q, k, k,
                                                             bias)[0],
                               atol=1e-4, rtol=1e-4)
