"""K10 (int4 nibble planes) and K14 (int8): the packers bit-identical to the
JAX package's, the tiling gates equal to its gates, and the plain versions
held against the JAX Pallas kernels in interpret mode and against their
XLA routes (f32 out: max |diff| <= 1e-5 · max |JAX|; the int values are
exact, x is rounded to bf16 on both sides, so only the order of the fp32
sums differs); the wrappers run the plain version on CPU tensors without
counting a launch; the CUDA kernel against the plain version on the card
(bf16 x: 2e-2 · max|plain|; f32 x: 1e-5 · max|plain|).

JAX is imported inside the tests that use it, so that the card-only cases
run where JAX is not installed."""

import numpy as np
import pytest
import torch

from prot2text_tpu_torch.kernels import launch_counts
from prot2text_tpu_torch.kernels import quant_matmul as qm

REL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _jax():
    import jax.numpy as jnp

    from prot2text_tpu.kernels import quant_matmul as jqm

    return jnp, jqm


def _q(rng, *shape, lo=-8, hi=7):
    return rng.integers(lo, hi + 1, shape).astype(np.int8)


def _x(rng, R, K):
    """bf16-representable f32 activations, so that every route (the XLA
    ones do not round) multiplies the same values."""
    x = rng.standard_normal((R, K)).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float().numpy()


def _scale(rng, *lead, N):
    return rng.uniform(0.002, 0.03, lead + (1, N)).astype(np.float32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= REL * top, (
        np.abs(got - want).max(), top)


@pytest.mark.parametrize("shape", [(64, 24), (3, 128, 40), (2, 5, 16, 8)])
def test_pack_unpack_bit_identical_to_jax(shape):
    jnp, jqm = _jax()
    rng = np.random.default_rng(len(shape))
    q = _q(rng, *shape)
    got = qm.pack_int4_planes(torch.from_numpy(q))
    want = np.asarray(jqm.pack_int4_planes(jnp.asarray(q)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(qm.unpack_int4_planes(got).numpy(), q)
    np.testing.assert_array_equal(
        qm.unpack_int4_planes(got).numpy(),
        np.asarray(jqm.unpack_int4_planes(jnp.asarray(want))))
    with pytest.raises(ValueError, match="K % 8"):
        qm.pack_int4_planes(torch.zeros(12, 4, dtype=torch.int8))


def test_gates_match_jax():
    _, jqm = _jax()
    for K in (8, 24, 64, 96, 128, 1152, 5120, 17408, 30):
        for N in (24, 64, 128, 384, 1024, 151936, 300):
            assert qm.supports_quant_matmul_planes(K, N) == \
                jqm.supports_quant_matmul_planes(K, N), (K, N)
            for bits in (4, 8):
                assert qm.supports_quant_matmul(K, N, bits) == \
                    jqm.supports_quant_matmul(K, N, bits), (K, N, bits)


@pytest.mark.parametrize("R", [1, 8, 40])
def test_int4_plain_matches_jax_pallas_and_xla(R):
    jnp, jqm = _jax()
    rng = np.random.default_rng(R)
    K, N = 256, 256
    assert jqm.supports_quant_matmul_planes(K, N)
    wp = jqm.pack_int4_planes(jnp.asarray(_q(rng, K, N)))
    s = _scale(rng, N=N)
    x = _x(rng, R, K)
    got = qm.quant_matmul_int4_planes_plain(
        torch.from_numpy(x), torch.from_numpy(np.array(wp)),
        torch.from_numpy(s))
    assert got.dtype == torch.float32
    pallas = jqm.quant_matmul_int4_planes(
        jnp.asarray(x), wp, jnp.asarray(s), out_dtype=jnp.float32,
        interpret=True)
    _close(got.numpy(), pallas)
    xla = jqm.quant_matmul_int4_planes_xla(jnp.asarray(x), wp,
                                           jnp.asarray(s), jnp.float32)
    _close(got.numpy(), xla)


@pytest.mark.parametrize("R", [1, 8, 40])
def test_int8_plain_matches_jax_pallas_and_xla(R):
    jnp, jqm = _jax()
    rng = np.random.default_rng(100 + R)
    K, N = 256, 128
    w = _q(rng, K, N, lo=-127, hi=127)
    s = _scale(rng, N=N)
    x = _x(rng, R, K)
    got = qm.quant_matmul_int8_plain(torch.from_numpy(x),
                                     torch.from_numpy(w), torch.from_numpy(s))
    pallas = jqm.quant_matmul_int8(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(s), out_dtype=jnp.float32,
                                   interpret=True)
    _close(got.numpy(), pallas)
    xla = jqm.quant_matmul_int8_xla(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(s), jnp.float32)
    _close(got.numpy(), xla)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("R", [1, 8, 40])
def test_stacked_plain_matches_jax_pallas(bits, R):
    """Layer `layer` of an (L, ...) buffer, as JAX's scalar-prefetch
    stacked kernels read it."""
    jnp, jqm = _jax()
    rng = np.random.default_rng(200 + 10 * bits + R)
    L, K, N = 3, 256, 128
    q = _q(rng, L, K, N, lo=-7 if bits == 4 else -127,
           hi=7 if bits == 4 else 127)
    w = jqm.pack_int4_planes(jnp.asarray(q)) if bits == 4 else jnp.asarray(q)
    s = _scale(rng, L, N=N)
    x = _x(rng, R, K)
    tw, ts = torch.from_numpy(np.array(w)), torch.from_numpy(s)
    for layer in (0, L - 1):
        if bits == 4:
            got = qm.quant_matmul_int4_planes_stacked_plain(
                torch.from_numpy(x), tw, ts, layer)
            want = jqm.quant_matmul_int4_planes_stacked(
                jnp.asarray(x), w, jnp.asarray(s), layer,
                out_dtype=jnp.float32, interpret=True)
        else:
            got = qm.quant_matmul_int8_stacked_plain(
                torch.from_numpy(x), tw, ts, layer)
            want = jqm.quant_matmul_int8_stacked(
                jnp.asarray(x), w, jnp.asarray(s), layer,
                out_dtype=jnp.float32, interpret=True)
        _close(got.numpy(), want)


def test_plain_rounds_x_to_bf16_and_keeps_its_dtype():
    """The TPU kernels round x to bf16 (`x.astype(jnp.bfloat16)`): an f32 x
    and its bf16 rounding give the same product; a bf16 x gives bf16."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    w = torch.from_numpy(_q(rng, 64, 16))
    wp = qm.pack_int4_planes(w)
    s = torch.from_numpy(_scale(rng, N=16))
    a = qm.quant_matmul_int4_planes_plain(x, wp, s)
    b = qm.quant_matmul_int4_planes_plain(x.bfloat16().float(), wp, s)
    assert torch.equal(a, b)
    assert qm.quant_matmul_int4_planes_plain(x.bfloat16(), wp, s).dtype \
        == torch.bfloat16
    want = (x.bfloat16().double() @ w.double()) * s.double()
    torch.testing.assert_close(a.double(), want, atol=1e-5, rtol=1e-5)


def test_wrappers_run_plain_on_cpu_without_counting():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(_x(rng, 3, 64))
    q = torch.from_numpy(_q(rng, 2, 64, 32))
    wp = qm.pack_int4_planes(q)
    s = torch.from_numpy(_scale(rng, 2, N=32))
    before = launch_counts()
    pairs = [
        (qm.quant_matmul_int4_planes(x, wp[1], s[1]),
         qm.quant_matmul_int4_planes_plain(x, wp[1], s[1])),
        (qm.quant_matmul_int4_planes_stacked(x, wp, s, 1),
         qm.quant_matmul_int4_planes_stacked_plain(x, wp, s, 1)),
        (qm.quant_matmul_int8(x, q[0], s[0]),
         qm.quant_matmul_int8_plain(x, q[0], s[0])),
        (qm.quant_matmul_int8_stacked(x, q, s, 0),
         qm.quant_matmul_int8_stacked_plain(x, q, s, 0)),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)
    assert launch_counts() == before


def test_splits_cover_k_without_empty_slices():
    for bits in (4, 8):
        for R in (1, 8, 40, 256):
            for K, N in ((5120, 5120), (5120, 1024), (5120, 17408),
                         (17408, 5120), (5120, 151936), (64, 24)):
                steps = qm._steps(K, bits)
                s = qm._splits(R, K, N, bits)
                per = -(-steps // s)
                assert 1 <= s <= steps and (s - 1) * per < steps


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("R,K,N", [(1, 64, 24), (8, 512, 1024),
                                   (40, 1024, 1030), (256, 256, 640),
                                   (8, 2048, 128), (3, 4096, 512)])
def test_kernel_matches_plain_on_cuda(cuda, bits, R, K, N):
    """Ragged N (not a multiple of 4 or of a block), R 1 to 256, split and
    unsplit K; the unstacked and the stacked entry point at two layers."""
    g = torch.Generator(device=cuda).manual_seed(R * K + N + bits)
    L = 2
    lo, hi = (-8, 8) if bits == 4 else (-127, 128)
    q = torch.randint(lo, hi, (L, K, N), generator=g, device=cuda,
                      dtype=torch.int8)
    w = qm.pack_int4_planes(q) if bits == 4 else q
    s = torch.rand((L, 1, N), generator=g, device=cuda) * 0.03 + 0.002
    x = torch.randn((R, K), generator=g, device=cuda)
    kern, stacked, plain = {
        4: (qm.quant_matmul_int4_planes, qm.quant_matmul_int4_planes_stacked,
            qm.quant_matmul_int4_planes_plain),
        8: (qm.quant_matmul_int8, qm.quant_matmul_int8_stacked,
            qm.quant_matmul_int8_plain)}[bits]
    for layer in (0, L - 1):
        want = plain(x, w[layer], s[layer])
        n0, n1 = kern.launches, stacked.launches
        got32 = kern(x, w[layer].contiguous(), s[layer])
        got16 = stacked(x.bfloat16(), w, s, layer)
        torch.cuda.synchronize()
        assert kern.launches == n0 + 1 and stacked.launches == n1 + 1
        assert got32.dtype == torch.float32 and got16.dtype == torch.bfloat16
        top = want.abs().max().item()
        assert (got32 - want).abs().max().item() <= 1e-5 * top
        assert (got16.float() - want).abs().max().item() <= 2e-2 * top
        again = stacked(x.bfloat16(), w, s, layer)
        assert torch.equal(again, got16), "the split sum is not repeatable"


@pytest.mark.cuda
def test_kernel_raises_on_bad_operands(cuda):
    x = torch.zeros((2, 64), device=cuda)
    w = torch.zeros((8, 16), dtype=torch.int32, device=cuda)
    s = torch.ones((1, 16), device=cuda)
    with pytest.raises(ValueError, match="K=32, the weight 64"):
        qm.quant_matmul_int4_planes(torch.zeros((2, 32), device=cuda), w, s)
    with pytest.raises(ValueError, match="weight"):
        qm.quant_matmul_int4_planes(x, w.to(torch.int8), s)
    with pytest.raises(ValueError, match="scale"):
        qm.quant_matmul_int4_planes(x, w, torch.ones((1, 8), device=cuda))
    with pytest.raises(ValueError, match="layer"):
        qm.quant_matmul_int4_planes_stacked(x, w[None], s[None], 1)
