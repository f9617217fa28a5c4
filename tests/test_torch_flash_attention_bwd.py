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


# the bf16 tensor-core body's edges: S = 70 spans a full and a ragged
# 64-row tile; row 1 starts late and stops before a padded tail, row 2 has
# no key at all, row 0 sees every key
EDGE_S = 70
EDGE_STARTS = np.array([0, 23, 9], np.int32)
EDGE_LENS = np.array([70, 30, 0], np.int32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Hkv,D", [(5, 1, 16), (8, 1, 16), (3, 3, 32)])
def test_backward_matches_pallas_interpret_at_edge_shapes(causal, H, Hkv, D):
    """rep 5, 8 and 1 over ragged tiles, a late run with a padded tail and
    an empty row (exactly zero gradients), through `masked_flash_padded`
    (JAX pads S to its 128 grid; the port takes any S)."""
    q, k, v, do = _inputs(3, H, Hkv, EDGE_S, D, seed=4)
    want = _jax_grads(q, k, v, do, EDGE_STARTS, EDGE_LENS, causal,
                      padded=True)
    for got in (_port_grads_plain(q, k, v, do, EDGE_STARTS, EDGE_LENS,
                                  causal),
                _port_grads_autograd(q, k, v, do, EDGE_STARTS, EDGE_LENS,
                                     causal)):
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)
        # the empty row: no gradient to its queries, keys or values
        for g in got:
            assert np.all(g[2] == 0.0)


def _misaligned_do(dtype, view):
    """(B, H, S, D) dO views as autograd may hand them over: a transpose of
    a (B, S, H, D) buffer (aligned), one element off a 16-byte boundary, a
    row stride of 132 elements, and a head dim that is not contiguous."""
    B, H, S, D = 2, 3, 5, 64
    buf = torch.arange(B * S * H * (D + 4), dtype=torch.float32).to(dtype)
    buf = buf.view(B, S, H, D + 4).transpose(1, 2)
    return {"aligned": torch.zeros(B, S, H, D, dtype=dtype).transpose(1, 2),
            "offset": buf[..., 1:D + 1],
            "row_stride": buf[..., :D],
            "head_dim": buf[..., :D].transpose(2, 3).contiguous()
            .transpose(2, 3)}[view]


@pytest.mark.parametrize("view", ["aligned", "offset", "row_stride",
                                  "head_dim"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grad_operand_copies_what_the_kernels_cannot_read(view, dtype):
    """K5's wrapper takes an aligned dO view as it is; it copies a bf16 view
    the tensor-core body's 16-byte cp.async cannot read, and a head dim that
    is not contiguous (the SIMT f32 body reads any other view)."""
    from prot2text_tpu_torch.kernels.flash_attention import (
        _aligned16, _grad_operand,
    )

    do = _misaligned_do(dtype, view)
    got = _grad_operand(do)
    copied = view == "head_dim" or (dtype == torch.bfloat16
                                    and view != "aligned")
    assert (got is not do) == copied
    assert torch.equal(got, do) and got.stride(-1) == 1
    if dtype == torch.bfloat16:
        assert _aligned16(got)


@pytest.mark.cuda
@pytest.mark.parametrize("rep", [1, 5, 8])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal,Sq,Skv", [(True, 200, 200),
                                           (False, 130, 75)])
def test_bf16_tensor_core_body_matches_plain_on_cuda(cuda, rep, D, causal,
                                                     Sq, Skv):
    """The bf16 body at rep 1, 5 and 8 (a cluster of that many blocks per
    key tile), Sq/Skv off the 64-row tiles, views of (B, S, H, D) buffers,
    kv_start > 0 with a padded tail, and a row with kv_len 0 whose
    gradients are exactly zero.  max|kernel - plain| <= 2e-2 * max|plain|
    per gradient."""
    B, Hkv = 3, 2
    H = Hkv * rep
    rng = np.random.default_rng(7)

    def bshd(h, S, scale):
        a = rng.standard_normal((B, S, h, D)).astype(np.float32) * scale
        return torch.from_numpy(a).to(cuda, torch.bfloat16).transpose(1, 2)

    q, do = bshd(H, Sq, D ** -0.5), bshd(H, Sq, D ** -0.5)
    k, v = bshd(Hkv, Skv, 1.0), bshd(Hkv, Skv, 1.0)
    start = torch.tensor([0, 11, 5], dtype=torch.int32, device=cuda)
    length = torch.tensor([Skv, Skv - 11 - 20, 0], dtype=torch.int32,
                          device=cuda)
    o, lse = flash_attention_masked_fwd(q, k, v, start, length,
                                        causal=causal)
    n = flash_attention_masked_bwd.launches
    got = flash_attention_masked_bwd(q, k, v, o, lse, do, start, length,
                                     causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_masked_bwd.launches == n + 1
    want = flash_attention_masked_bwd_plain(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), start,
        length, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        err = (g.float() - w).abs().max().item()
        assert err <= 2e-2 * w.abs().max().item(), (name, err)
        assert (g[2] == 0).all(), name


@pytest.mark.cuda
def test_bf16_two_launches_are_bit_identical_on_cuda(cuda):
    """No atomics: the dK/dV cluster sums its blocks in rank order, so two
    launches give the same bits (rep 5, ragged causal tiles)."""
    B, H, Hkv, S, D = 1, 10, 2, 333, 128
    rng = np.random.default_rng(8)

    def t(h, scale):
        a = rng.standard_normal((B, h, S, D)).astype(np.float32) * scale
        return torch.from_numpy(a).to(cuda, torch.bfloat16)

    q, do, k, v = t(H, D ** -0.5), t(H, D ** -0.5), t(Hkv, 1.0), t(Hkv, 1.0)
    start = torch.tensor([17], dtype=torch.int32, device=cuda)
    length = torch.tensor([S - 17 - 40], dtype=torch.int32, device=cuda)
    o, lse = flash_attention_masked_fwd(q, k, v, start, length, causal=True)
    a = flash_attention_masked_bwd(q, k, v, o, lse, do, start, length,
                                   causal=True)
    b = flash_attention_masked_bwd(q, k, v, o, lse, do, start, length,
                                   causal=True)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["offset", "row_stride"])
def test_bf16_misaligned_do_view_is_copied_on_cuda(cuda, view):
    """A dO view that cp.async cannot read goes through the wrapper's copy:
    the gradients equal those of the same values in a fresh buffer, bit for
    bit, and the plain version's within the gate."""
    B, H, Hkv, S, D = 2, 4, 2, 96, 64
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, h, S, D))
                                .astype(np.float32) * s)
               .to(cuda, torch.bfloat16)
               for h, s in ((H, D ** -0.5), (Hkv, 1.0), (Hkv, 1.0)))
    buf = torch.from_numpy(rng.standard_normal((B, S, H, D + 4))
                           .astype(np.float32) * D ** -0.5).to(
                               cuda, torch.bfloat16).transpose(1, 2)
    do = buf[..., 1:D + 1] if view == "offset" else buf[..., :D]
    start = torch.tensor([0, 7], dtype=torch.int32, device=cuda)
    length = torch.tensor([S, S - 7], dtype=torch.int32, device=cuda)
    o, lse = flash_attention_masked_fwd(q, k, v, start, length, causal=True)
    got = flash_attention_masked_bwd(q, k, v, o, lse, do, start, length,
                                     causal=True)
    fresh = flash_attention_masked_bwd(q, k, v, o, lse, do.contiguous(),
                                       start, length, causal=True)
    torch.cuda.synchronize()
    want = flash_attention_masked_bwd_plain(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), start,
        length, True)
    for g, f, w in zip(got, fresh, want):
        assert torch.equal(g, f)
        err = (g.float() - w).abs().max().item()
        assert err <= 2e-2 * w.abs().max().item()
