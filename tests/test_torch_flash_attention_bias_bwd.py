"""K6b (the backward of flash attention with an additive fp32 bias): the
port's plain version against `jax.vjp` of the JAX Pallas kernel
`flash_attention_tpu` in interpret mode with small blocks (f32, dQ/dK/dV
within 1e-5 of each gradient's largest |entry|) — the bias shapes the JAX
kernel takes, Sq and Skv off its block grid, Sq != Skv, grouped-query heads
(the JAX side on repeat_kv'd k/v, its group sum from the vjp of the
repeat); the autograd Function against torch autograd through the plain
forward (float64 inputs); the CUDA kernel against the plain version on the
card: the bf16 tensor-core body (K5's, with its bias policy) over the bias
kinds, rep 1/4/5, every head dim, ragged Sq != Skv, dead tiles, a row
whose bias masks every key, strided
(B, S, H, D) views, two launches bit-identical, a misaligned q raising and
a misaligned dO copied."""

import numpy as np
import pytest
import torch

from prot2text_tpu_torch.kernels import launch_counts
from prot2text_tpu_torch.kernels.flash_attention import (
    flash_attention_bias, flash_attention_bias_bwd,
    flash_attention_bias_bwd_plain, flash_attention_bias_fwd,
    flash_attention_bias_plain,
)

NEG = float(np.finfo(np.float32).min)
TOL = 1e-5          # of each gradient's largest |entry|, f32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(B, H, Hkv, Sq, Skv, D, bias_shape, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, Sq, D)) * D ** -0.5).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    do = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    bias = rng.standard_normal(bias_shape).astype(np.float32)
    bias[..., -3:] = NEG                  # masked key columns
    return q, k, v, do, bias


def _jax_grads(q, k, v, do, bias, block_q, block_k):
    import jax
    import jax.numpy as jnp

    from prot2text_tpu.kernels.flash_attention import flash_attention_tpu
    from prot2text_tpu.models.transformer import repeat_kv

    rep = q.shape[1] // k.shape[1]

    def f(q_, k_, v_):
        return flash_attention_tpu(
            q_, repeat_kv(k_, rep), repeat_kv(v_, rep), jnp.asarray(bias),
            block_q=block_q, block_k=block_k, interpret=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_grads(q, k, v, do, bias):
    q, k, v, do, bias = (torch.from_numpy(a) for a in (q, k, v, do, bias))
    o, lse = flash_attention_bias_plain(q, k, v, bias)
    return [g.numpy() for g in flash_attention_bias_bwd(
        q, k, v, bias, o, lse, do)]


def _close(got, want):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=TOL * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("bias_kind", ["b11k", "bhqk", "11qk"])
def test_plain_matches_pallas_interpret_bias_shapes(bias_kind):
    """The key-padding bias ESMC builds (B, 1, 1, S), a per-head bias and
    a batch-broadcast one, S on the 8-row block grid."""
    B, H, S, D = 2, 4, 32, 64
    shape = {"b11k": (B, 1, 1, S), "bhqk": (B, H, S, S),
             "11qk": (1, 1, S, S)}[bias_kind]
    args = _inputs(B, H, H, S, S, D, shape, seed=1)
    _close(_port_grads(*args), _jax_grads(*args, block_q=8, block_k=8))


@pytest.mark.parametrize("rep,D", [(1, 32), (2, 16)])
def test_plain_matches_pallas_interpret_ragged_sq_ne_skv(rep, D):
    """Sq = 20, Skv = 33, off the 8/16 block grid: the TPU kernel pads
    with a -1e30 bias, the port masks its ragged edges; rep 2 sums dK/dV
    over each group."""
    B, Hkv, Sq, Skv = 2, 2, 20, 33
    args = _inputs(B, rep * Hkv, Hkv, Sq, Skv, D, (B, 1, Sq, Skv), seed=2)
    _close(_port_grads(*args), _jax_grads(*args, block_q=8, block_k=16))


@pytest.mark.parametrize("rep", [1, 3])
def test_autograd_function_matches_autograd_through_plain(rep):
    """`flash_attention_bias` (K6 forward, K6b backward: the plain versions
    here) against torch autograd through the plain forward, float64
    inputs; the bias gets no gradient."""
    B, Hkv, Sq, Skv, D = 2, 2, 9, 14, 16
    q, k, v, do, bias = (torch.from_numpy(a).double() for a in _inputs(
        B, rep * Hkv, Hkv, Sq, Skv, D, (B, 1, 1, Skv), seed=3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    b = bias.clone().requires_grad_()
    flash_attention_bias(*leaves, b).backward(do)
    got = [t.grad for t in leaves]
    assert b.grad is None
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention_bias_plain(*ref, bias)[0].backward(do)
    for name, g, w in zip(("dq", "dk", "dv"), got, (t.grad for t in ref)):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=TOL * w.abs().max().item(),
                                   msg=name)


def test_plain_versions_launch_nothing():
    before = launch_counts()
    args = _inputs(1, 2, 2, 8, 8, 16, (1, 1, 1, 8))
    _port_grads(*args)
    assert launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep,D,Sq,Skv", [(1, 64, 512, 512),
                                          (1, 64, 77, 77),
                                          (2, 128, 40, 130),
                                          (1, 16, 65, 64)])
@pytest.mark.parametrize("bias_kind", ["b11k", "bhqk"])
def test_kernel_matches_plain_on_cuda(cuda, dtype, rep, D, Sq, Skv,
                                      bias_kind):
    """q/k/v/dO as ESMC hands them over (transposes of (B, S, H, D)
    buffers); dQ/dK/dV within 2e-2 (bf16) or 1e-4 (f32) of each
    gradient's largest |entry|; one launch per call."""
    B, Hkv = 2, 3
    H = rep * Hkv
    shape = (B, 1, 1, Skv) if bias_kind == "b11k" else (B, H, Sq, Skv)
    q, k, v, do, bias = _inputs(B, H, Hkv, Sq, Skv, D, shape, seed=4)

    def bshd(a):
        return torch.from_numpy(a.transpose(0, 2, 1, 3).copy()).to(
            cuda, dtype).transpose(1, 2)

    q, k, v, do = (bshd(a) for a in (q, k, v, do))
    bias = torch.from_numpy(bias).to(cuda)
    o, lse = flash_attention_bias_fwd(q, k, v, bias)
    n = flash_attention_bias_bwd.launches
    got = flash_attention_bias_bwd(q, k, v, bias, o, lse, do)
    torch.cuda.synchronize()
    assert flash_attention_bias_bwd.launches == n + 1
    want = flash_attention_bias_bwd_plain(q.float(), k.float(), v.float(),
                                          bias, o.float(), lse, do.float())
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        err, top = (g.float() - w).abs().max().item(), w.abs().max().item()
        assert err <= tol * top, (name, err, top)


def _bf16_case(dev, B, H, Hkv, Sq, Skv, D, bias, seed):
    """q/k/v/dO as (B, S, H, D) buffers seen as (B, H, S, D), the bias on
    the card, K6's o and lse; the plain gradients from the same o/lse."""
    rng = np.random.default_rng(seed)

    def bshd(h, S, scale):
        a = rng.standard_normal((B, S, h, D)).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev, torch.bfloat16).transpose(1, 2)

    q, do = bshd(H, Sq, D ** -0.5), bshd(H, Sq, D ** -0.5)
    k, v = bshd(Hkv, Skv, 1.0), bshd(Hkv, Skv, 1.0)
    bias = torch.from_numpy(bias).to(dev)
    o, lse = flash_attention_bias_fwd(q, k, v, bias)
    want = flash_attention_bias_bwd_plain(q.float(), k.float(), v.float(),
                                          bias, o.float(), lse, do.float())
    return (q, k, v, bias, o, lse, do), want


def _within(got, want, tol=2e-2):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        err = (g.float() - w).abs().max().item()
        assert err <= tol * w.abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("bias_kind", ["full", "per_head", "key_padding"])
@pytest.mark.parametrize("rep,D", [(1, 16), (4, 32), (5, 64), (1, 128),
                                   (4, 128)])
def test_bf16_tensor_core_body_matches_plain_on_cuda(cuda, bias_kind, rep,
                                                     D):
    """The bf16 body at Sq 130, Skv 77 (ragged tiles, Sq != Skv): a full
    (B, H, Sq, Skv), a per-head (1, H, Sq, Skv) and a key-padding
    (B, 1, 1, Skv) bias, each with a key tile whose bias masks it for every
    row of batch row 1 (per-head: of every batch row; a dead tile the block
    vote skips), the full and
    per-head kinds also with a query row masked at every key (its dQ is
    exactly 0, as the plain version's).  max|kernel - plain| <= 2e-2 *
    max|plain| per gradient, one launch per call."""
    B, Hkv, Sq, Skv = 2, 2, 130, 77
    H = rep * Hkv
    rng = np.random.default_rng(11)
    shape = {"full": (B, H, Sq, Skv), "per_head": (1, H, Sq, Skv),
             "key_padding": (B, 1, 1, Skv)}[bias_kind]
    bias = rng.standard_normal(shape).astype(np.float32)
    if bias_kind == "per_head":
        bias[..., 64:] = NEG              # the second key tile, every row
    else:
        bias[1, ..., 64:] = NEG           # batch row 1's second key tile
    if bias_kind != "key_padding":
        bias[0, :, 5, :] = NEG            # query row 5 sees no key
    args, want = _bf16_case(cuda, B, H, Hkv, Sq, Skv, D, bias, seed=12)
    n = flash_attention_bias_bwd.launches
    got = flash_attention_bias_bwd(*args)
    torch.cuda.synchronize()
    assert flash_attention_bias_bwd.launches == n + 1
    _within(got, want)
    if bias_kind != "key_padding":
        assert (got[0][0, :, 5] == 0).all() and (want[0][0, :, 5] == 0).all()


@pytest.mark.cuda
def test_bf16_per_head_bias_broadcast_over_batch_on_cuda(cuda):
    """A (1, H, Sq, Skv) bias read through a batch stride of 0, with a dead
    key tile for every batch row, rep 4 (a cluster of 4 dK/dV blocks)."""
    B, Hkv, rep, Sq, Skv, D = 3, 2, 4, 100, 150, 64
    H = rep * Hkv
    bias = np.random.default_rng(13).standard_normal(
        (1, H, Sq, Skv)).astype(np.float32)
    bias[..., 64:128] = NEG
    args, want = _bf16_case(cuda, B, H, Hkv, Sq, Skv, D, bias, seed=14)
    _within(flash_attention_bias_bwd(*args), want)


@pytest.mark.cuda
def test_bf16_two_launches_are_bit_identical_on_cuda(cuda):
    """No atomics: dK/dV sums its cluster's blocks in rank order, so two
    launches give the same bits (rep 5, a full bias, ragged tiles)."""
    B, Hkv, rep, Sq, Skv, D = 2, 2, 5, 333, 200, 128
    H = rep * Hkv
    bias = np.random.default_rng(16).standard_normal(
        (B, H, Sq, Skv)).astype(np.float32)
    args, want = _bf16_case(cuda, B, H, Hkv, Sq, Skv, D, bias, seed=17)
    a = flash_attention_bias_bwd(*args)
    b = flash_attention_bias_bwd(*args)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    _within(a, want)


@pytest.mark.cuda
def test_bf16_misaligned_q_raises_on_cuda(cuda):
    """A bf16 q one element off a 16-byte boundary raises before any launch
    (cp.async copies 16 bytes); the f32 SIMT body takes the same view."""
    B, H, S, D = 1, 2, 17, 64
    buf = torch.randn(B, H, S, D + 1, device=cuda)
    k = torch.randn(B, H, S, D, device=cuda)
    bias = torch.zeros(B, 1, 1, S, device=cuda)
    qb, kb = buf.bfloat16()[..., 1:], k.bfloat16()
    o, lse = flash_attention_bias_fwd(qb.contiguous(), kb, kb, bias)
    n = flash_attention_bias_bwd.launches
    with pytest.raises(ValueError, match="K6b: bf16 q must be 16-byte"):
        flash_attention_bias_bwd(qb, kb, kb, bias, o, lse, o)
    assert flash_attention_bias_bwd.launches == n
    q = buf[..., 1:]
    o, lse = flash_attention_bias_fwd(q, k, k, bias)
    got = flash_attention_bias_bwd(q, k, k, bias, o, lse, o)
    want = flash_attention_bias_bwd_plain(q, k, k, bias, o, lse, o)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4 * w.abs().max().item(),
                                   rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["offset", "row_stride"])
def test_bf16_misaligned_do_view_is_copied_on_cuda(cuda, view):
    """A dO view that cp.async cannot read goes through the wrapper's copy:
    the gradients equal those of the same values in a fresh buffer, bit for
    bit, and the plain version's within the gate."""
    B, H, Hkv, S, D = 2, 4, 2, 96, 64
    bias = np.zeros((B, 1, 1, S), np.float32)
    bias[1, ..., 80:] = NEG
    (q, k, v, bias, o, lse, _), _ = _bf16_case(cuda, B, H, Hkv, S, S, D,
                                               bias, seed=18)
    buf = torch.randn(B, S, H, D + 4, device=cuda).mul(D ** -0.5).to(
        torch.bfloat16).transpose(1, 2)
    do = buf[..., 1:D + 1] if view == "offset" else buf[..., :D]
    got = flash_attention_bias_bwd(q, k, v, bias, o, lse, do)
    fresh = flash_attention_bias_bwd(q, k, v, bias, o, lse, do.contiguous())
    torch.cuda.synchronize()
    want = flash_attention_bias_bwd_plain(q.float(), k.float(), v.float(),
                                          bias, o.float(), lse, do.float())
    for g, f in zip(got, fresh):
        assert torch.equal(g, f)
    _within(got, want)
