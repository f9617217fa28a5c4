"""K5 (masked flash-attention backward): the port's plain backward and the
differentiable `flash_attention_masked` (K1 forward, K5 backward) against
the VJP of the JAX Pallas kernel in interpret mode, f32, atol 1e-5 (K1's
forward tolerance); the CUDA kernel against the plain version on the card.
JAX repeats k/v to H heads (`repeat_kv`), so its dK/dV are summed over each
GQA group before the comparison."""

import numpy as np
import pytest
import torch

from prot2text_tpu_torch.kernels.flash_attention import (
    flash_attention_masked, flash_attention_masked_bwd,
    flash_attention_masked_bwd_plain, flash_attention_masked_fwd,
    flash_attention_masked_plain,
)

ATOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(B, H, Hkv, S, D, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, S, D)) * D ** -0.5).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    # dO ~ N(0, 1/D) keeps dP = dO·Vᵀ, and so every gradient, O(1) at each
    # D: the f32 tolerance then measures the algorithm, not the magnitude
    do = (rng.standard_normal((B, H, S, D)) * D ** -0.5).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, start, length, causal, padded=False):
    """dq, dk, dv of the JAX kernel (interpret mode), dk/dv group-summed."""
    import jax
    import jax.numpy as jnp

    from prot2text_tpu.kernels.attention import masked_flash_padded
    from prot2text_tpu.kernels.flash_attention import (
        flash_attention_masked as j_flash,
    )
    from prot2text_tpu.models.transformer import repeat_kv as j_repeat_kv

    B, H, S, D = q.shape
    Hkv = k.shape[1]
    rep = H // Hkv

    def f(q_, k_, v_):
        kr, vr = j_repeat_kv(k_, rep), j_repeat_kv(v_, rep)
        if padded:
            return masked_flash_padded(q_, kr, vr, start, length, causal,
                                       interpret=True)
        return j_flash(q_, kr, vr, jnp.asarray(start), jnp.asarray(length),
                       causal=causal, block_q=8, block_k=8, interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return tuple(np.asarray(g) for g in vjp(jnp.asarray(do)))


def _port_grads_autograd(q, k, v, do, start, length, causal):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = flash_attention_masked(qt, kt, vt, torch.from_numpy(start),
                               torch.from_numpy(length), causal=causal)
    o.backward(torch.from_numpy(do))
    return qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()


def _port_grads_plain(q, k, v, do, start, length, causal):
    t = [torch.from_numpy(a) for a in (q, k, v, do, start, length)]
    o, lse = flash_attention_masked_plain(t[0], t[1], t[2], t[4], t[5],
                                          causal)
    return tuple(g.numpy() for g in flash_attention_masked_bwd_plain(
        t[0], t[1], t[2], o, lse, t[3], t[4], t[5], causal))


# left-padded ragged rows (start > 0), a right-padded row and a fully
# masked row (kv_len 0)
STARTS = np.array([0, 5, 11, 3], np.int32)
LENS = np.array([16, 11, 5, 0], np.int32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Hkv,D", [(4, 4, 16), (8, 2, 16), (10, 2, 16),
                                     (5, 1, 64)])
def test_backward_matches_pallas_interpret(causal, H, Hkv, D):
    """rep 1, 4, 5 (Qwen3-14B's 40/8) and 5 at D=64; ragged and empty
    rows."""
    B, S = 4, 16
    q, k, v, do = _inputs(B, H, Hkv, S, D)
    want = _jax_grads(q, k, v, do, STARTS, LENS, causal)
    for got in (_port_grads_plain(q, k, v, do, STARTS, LENS, causal),
                _port_grads_autograd(q, k, v, do, STARTS, LENS, causal)):
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)
    # the fully masked row gets no gradient, and gives none to k/v
    dq = _port_grads_plain(q, k, v, do, STARTS, LENS, causal)[0]
    assert np.all(dq[3] == 0.0)


def test_backward_matches_masked_flash_padded_nontileable():
    """S = 13 is not a multiple of 128: JAX pads through
    `masked_flash_padded`; the port takes any S."""
    B, H, Hkv, S, D = 3, 10, 2, 13, 16
    q, k, v, do = _inputs(B, H, Hkv, S, D, seed=1)
    start = np.array([0, 4, 9], np.int32)
    length = np.array([13, 9, 4], np.int32)
    want = _jax_grads(q, k, v, do, start, length, True, padded=True)
    got = _port_grads_autograd(q, k, v, do, start, length, True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)


def test_cpu_backward_takes_plain_and_counts_no_launch():
    q, k, v, do = _inputs(1, 2, 1, 4, 16)
    before = flash_attention_masked_bwd.launches
    _port_grads_autograd(q, k, v, do, np.array([0], np.int32),
                         np.array([4], np.int32), True)
    assert flash_attention_masked_bwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Hkv,D", [(8, 2, 128), (10, 2, 64), (4, 4, 16)])
def test_kernel_matches_plain_on_cuda(cuda, dtype, tol, causal, H, Hkv, D):
    """Ragged starts, an empty row and S = 200 (ragged edge tiles); inputs
    rounded to `dtype`, the plain version computed in fp32 on them.
    Tolerance: max|kernel - plain| <= tol * max|plain| per gradient."""
    dev = cuda
    B, S = 4, 200
    q, k, v, do = (torch.from_numpy(a).to(dev, dtype)
                   for a in _inputs(B, H, Hkv, S, D, seed=2))
    start = torch.tensor([0, 37, 150, 0], dtype=torch.int32, device=dev)
    length = torch.tensor([200, 163, 50, 0], dtype=torch.int32, device=dev)
    o, lse = flash_attention_masked_fwd(q, k, v, start, length, causal=causal)
    got = flash_attention_masked_bwd(q, k, v, o, lse, do, start, length,
                                     causal=causal)
    torch.cuda.synchronize()
    want = flash_attention_masked_bwd_plain(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), start,
        length, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        err = (g.float() - w).abs().max().item()
        assert err <= tol * w.abs().max().item(), (name, err)
    assert got[0][3].abs().max().item() == 0.0


@pytest.mark.cuda
def test_autograd_launches_k1_and_k5_on_cuda(cuda):
    """Strided q/k/v as the decoder hands them over (views of (B, S, H, D)
    buffers): one K1 and one K5 launch, gradients equal to the plain
    backward's."""
    dev = cuda
    B, H, Hkv, S, D = 2, 10, 2, 130, 64
    rng = np.random.default_rng(3)

    def strided(h):
        a = rng.standard_normal((B, S, h, D)).astype(np.float32) * 0.3
        return torch.from_numpy(a).to(dev).transpose(1, 2).requires_grad_()

    q, k, v = strided(H), strided(Hkv), strided(Hkv)
    start = torch.tensor([0, 20], dtype=torch.int32, device=dev)
    length = torch.tensor([130, 110], dtype=torch.int32, device=dev)
    k1, k5 = flash_attention_masked_fwd.launches, \
        flash_attention_masked_bwd.launches
    o = flash_attention_masked(q, k, v, start, length, causal=True)
    o.transpose(1, 2).reshape(B, S, H * D).square().sum().backward()
    torch.cuda.synchronize()
    assert flash_attention_masked_fwd.launches == k1 + 1
    assert flash_attention_masked_bwd.launches == k5 + 1
    o_ref, lse_ref = flash_attention_masked_plain(q.detach(), k.detach(),
                                                  v.detach(), start, length,
                                                  True)
    want = flash_attention_masked_bwd_plain(
        q.detach(), k.detach(), v.detach(), o_ref, lse_ref, 2 * o_ref, start,
        length, True)
    for g, w in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
