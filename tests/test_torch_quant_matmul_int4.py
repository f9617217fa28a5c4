"""K11a (int4 split-half bytes) and K11b (int4 bf16-pair words): the
packers bit-identical to the JAX package's, the pairs tiling gate equal to
its gate, and the plain versions held against the JAX kernels on the same
integers and bf16-representable x (f32 out):

  * plain K11a against `quant_matmul_int4` and `quant_matmul_int4_stacked`
    in interpret mode and against `quant_matmul_int4_xla`, within 1e-5 of
    max|JAX| (the values are exact; only the order of the fp32 sums
    differs);
  * plain K11b against `quant_matmul_int4_pairs_xla`, which is exact,
    within 1e-5 of max, and against `quant_matmul_int4_pairs_stacked` in
    interpret mode within 1e-4 of max: the TPU kernel removes the words'
    +136 bias as 136·rowsum(x) in its fp32 epilogue, a cancellation of
    about 4e-6 of max|y| (prot2text_tpu/kernels/quant_matmul.py:410-424).
    JAX's unstacked `quant_matmul_int4_pairs` has no interpret argument and
    raises on the CPU backend, so the unstacked K11b is held to the XLA
    route only.

On the card, the CUDA kernels against the plain versions (bf16 x:
2e-2·max|plain|; f32 x: 1e-5·max|plain|), and against K10's wrapper on
the same integers: K11a and K11b read their bytes and words into K10's
fragment order in both bodies (the few-row body up to `FEW_ROWS` rows,
the many-row body above), so the three are bit-identical.

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


def _q(rng, *shape):
    return rng.integers(-8, 8, shape).astype(np.int8)


def _x(rng, R, K):
    x = rng.standard_normal((R, K)).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float().numpy()


def _scale(rng, *lead, N):
    return rng.uniform(0.002, 0.03, lead + (1, N)).astype(np.float32)


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * top, (
        np.abs(got - want).max(), top)


FORMATS = {"bytes": (qm.pack_int4, qm.unpack_int4, torch.int8, 2),
           "pairs": (qm.pack_int4_pairs, qm.unpack_int4_pairs, torch.int32,
                     8)}


@pytest.mark.parametrize("fmt", ["bytes", "pairs"])
@pytest.mark.parametrize("shape", [(64, 24), (3, 128, 40), (2, 5, 16, 8)])
def test_pack_unpack_bit_identical_to_jax(fmt, shape):
    """Single and stacked (L, K, N) leaves."""
    jnp, jqm = _jax()
    pack, unpack, dtype, per = FORMATS[fmt]
    jpack, junpack = {"bytes": (jqm.pack_int4, jqm.unpack_int4),
                      "pairs": (jqm.pack_int4_pairs,
                                jqm.unpack_int4_pairs)}[fmt]
    rng = np.random.default_rng(len(shape) + per)
    q = _q(rng, *shape)
    got = pack(torch.from_numpy(q))
    want = np.asarray(jpack(jnp.asarray(q)))
    assert got.dtype == dtype
    assert got.shape[-2] == shape[-2] // per
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(unpack(got).numpy(), q)
    np.testing.assert_array_equal(unpack(got).numpy(),
                                  np.asarray(junpack(jnp.asarray(want))))
    with pytest.raises(ValueError, match="K"):
        pack(torch.zeros((per + 1 if per > 2 else 7), 4, dtype=torch.int8))


def test_pairs_gate_matches_jax():
    _, jqm = _jax()
    for K in (8, 24, 64, 96, 128, 1152, 5120, 17408, 30):
        for N in (24, 64, 128, 384, 1024, 151936, 300):
            assert qm.supports_quant_matmul_pairs(K, N) == \
                jqm.supports_quant_matmul_pairs(K, N), (K, N)


@pytest.mark.parametrize("R", [1, 8, 40])
def test_bytes_plain_matches_jax_pallas_and_xla(R):
    jnp, jqm = _jax()
    rng = np.random.default_rng(300 + R)
    K, N = 512, 256
    assert jqm.supports_quant_matmul(K, N, bits=4)
    wp = jqm.pack_int4(jnp.asarray(_q(rng, K, N)))
    s = _scale(rng, N=N)
    x = _x(rng, R, K)
    got = qm.quant_matmul_int4_plain(
        torch.from_numpy(x), torch.from_numpy(np.array(wp)),
        torch.from_numpy(s))
    assert got.dtype == torch.float32
    pallas = jqm.quant_matmul_int4(jnp.asarray(x), wp, jnp.asarray(s),
                                   out_dtype=jnp.float32, interpret=True)
    _close(got.numpy(), pallas)
    xla = jqm.quant_matmul_int4_xla(jnp.asarray(x), wp, jnp.asarray(s),
                                    jnp.float32)
    _close(got.numpy(), xla)


@pytest.mark.parametrize("R", [1, 8, 40])
def test_pairs_plain_matches_jax_xla(R):
    """The unstacked JAX pairs kernel runs on the TPU only (no interpret
    argument; on the CPU backend it raises), so the exact XLA route holds
    the unstacked plain version."""
    jnp, jqm = _jax()
    rng = np.random.default_rng(400 + R)
    K, N = 512, 256
    assert jqm.supports_quant_matmul_pairs(K, N)
    wp = jqm.pack_int4_pairs(jnp.asarray(_q(rng, K, N)))
    s = _scale(rng, N=N)
    x = _x(rng, R, K)
    got = qm.quant_matmul_int4_pairs_plain(
        torch.from_numpy(x), torch.from_numpy(np.array(wp)),
        torch.from_numpy(s))
    xla = jqm.quant_matmul_int4_pairs_xla(jnp.asarray(x), wp,
                                          jnp.asarray(s), jnp.float32)
    _close(got.numpy(), xla)


@pytest.mark.parametrize("fmt", ["bytes", "pairs"])
@pytest.mark.parametrize("R", [1, 8, 40])
def test_stacked_plain_matches_jax_pallas(fmt, R):
    """Layer `layer` of an (L, ...) buffer as JAX's scalar-prefetch stacked
    kernels read it, in interpret mode: bytes within 1e-5 of max, pairs
    within 1e-4 (the TPU kernel's epilogue cancellation)."""
    jnp, jqm = _jax()
    rng = np.random.default_rng(500 + R + len(fmt))
    L, K, N = 3, 512, 256
    q = _q(rng, L, K, N)
    s = _scale(rng, L, N=N)
    x = _x(rng, R, K)
    if fmt == "bytes":
        w = jqm.pack_int4(jnp.asarray(q))
        plain, jk, rel = (qm.quant_matmul_int4_stacked_plain,
                          jqm.quant_matmul_int4_stacked, REL)
    else:
        w = jqm.pack_int4_pairs(jnp.asarray(q))
        plain, jk, rel = (qm.quant_matmul_int4_pairs_stacked_plain,
                          jqm.quant_matmul_int4_pairs_stacked, 1e-4)
    tw, ts = torch.from_numpy(np.array(w)), torch.from_numpy(s)
    for layer in (0, L - 1):
        got = plain(torch.from_numpy(x), tw, ts, layer)
        want = jk(jnp.asarray(x), w, jnp.asarray(s), layer,
                  out_dtype=jnp.float32, interpret=True)
        _close(got.numpy(), want, rel)


def test_wrappers_run_plain_on_cpu_without_counting():
    """On CPU tensors each wrapper is its plain version; the three int4
    formats of one integer matrix give one result, bit for bit."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(_x(rng, 3, 64))
    q = torch.from_numpy(_q(rng, 2, 64, 32))
    wb, ww = qm.pack_int4(q), qm.pack_int4_pairs(q)
    s = torch.from_numpy(_scale(rng, 2, N=32))
    before = launch_counts()
    pairs = [
        (qm.quant_matmul_int4(x, wb[1], s[1]),
         qm.quant_matmul_int4_plain(x, wb[1], s[1])),
        (qm.quant_matmul_int4_stacked(x, wb, s, 1),
         qm.quant_matmul_int4_stacked_plain(x, wb, s, 1)),
        (qm.quant_matmul_int4_pairs(x, ww[1], s[1]),
         qm.quant_matmul_int4_pairs_plain(x, ww[1], s[1])),
        (qm.quant_matmul_int4_pairs_stacked(x, ww, s, 1),
         qm.quant_matmul_int4_pairs_stacked_plain(x, ww, s, 1)),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)
    assert launch_counts() == before
    planes = qm.quant_matmul_int4_planes(x, qm.pack_int4_planes(q)[1], s[1])
    for got, _ in pairs:
        assert torch.equal(got, planes)


# ---------------------------------------------------------------------------
# on the card


def _cuda_case(cuda, fmt, R, K, N, L=2):
    g = torch.Generator(device=cuda).manual_seed(R * K + N + len(fmt))
    q = torch.randint(-8, 8, (L, K, N), generator=g, device=cuda,
                      dtype=torch.int8)
    s = torch.rand((L, 1, N), generator=g, device=cuda) * 0.03 + 0.002
    x = torch.randn((R, K), generator=g, device=cuda)
    return q, s, x


KERNELS = {
    "bytes": (qm.quant_matmul_int4, qm.quant_matmul_int4_stacked,
              qm.quant_matmul_int4_plain),
    "pairs": (qm.quant_matmul_int4_pairs, qm.quant_matmul_int4_pairs_stacked,
              qm.quant_matmul_int4_pairs_plain),
}


SHAPES = [(1, 64, 24), (4, 512, 1024), (16, 1024, 1030), (40, 2048, 640),
          (256, 256, 640), (3, 4096, 512), (5, 48, 128)]


def test_int4_formats_share_the_few_rows_route_and_grid():
    """The precondition of K11a's and K11b's bit identity with K10 at a
    decode step's rows: on every shape where the three int4 formats take
    the same route, the few-row TMA body gives them one grid (a rule of
    R, K, N and the 4-bit stage alone, `few_rows_tiling`), so they run the same MMAs in the same
    order and sum the same cluster partials; an N off 32 sends all three
    to the ragged route alike."""
    for R in (1, 4, 8):
        for K, N in ((5120, 1024), (5120, 17408), (17408, 5120),
                     (5120, 151936), (4096, 14336), (1152, 6144),
                     (1024, 1056), (2368, 1184)):
            ways = {qm.route(f, R, K, N, 0) for f in ("planes", "pairs",
                                                      "bytes")}
            assert ways == {"few"}, (R, K, N, ways)
            assert qm.few_rows_tiling(R, K, N, 4) is not None
        for N in (1028, 1040):            # N % 32 != 0: all ragged
            assert {qm.route(f, R, 1024, N, 0) for f in (
                "planes", "pairs", "bytes")} == {"ragged"}


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,R,K,N", [("bytes",) + s for s in SHAPES]
                         + [("bytes", 2, 34, 40)]
                         + [("pairs",) + s for s in SHAPES])
def test_kernel_matches_plain_on_cuda(cuda, fmt, R, K, N):
    """Ragged N (not a multiple of 4 or of a block), R 1 to 256, split and
    unsplit K, K/2 off the 16-row step (bytes: K 34 and 48); the unstacked
    and the stacked entry point at two layers."""
    pack = FORMATS[fmt][0]
    kern, stacked, plain = KERNELS[fmt]
    q, s, x = _cuda_case(cuda, fmt, R, K, N)
    w = pack(q)
    for layer in (0, 1):
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
@pytest.mark.parametrize("R,K,N", [(4, 5120, 1024), (16, 17408, 256),
                                   (40, 2048, 640), (300, 1024, 640),
                                   (1, 5120, 17408), (8, 5120, 17408),
                                   (8, 17408, 5120), (5, 1024, 1040)])
def test_kernels_against_k10_on_the_same_integers(cuda, R, K, N):
    """K11a and K11b build K10's fragments in both bodies and take K10's
    grid: bit-identical to K10's wrapper on the same integers at every R
    (the few-row TMA body at R 1-8, with K split over clusters of 2 and 7
    at Qwen3-14B's gate/up and down; the many-row body at 16, 40 and 300),
    in f32 and bf16, unstacked and stacked."""
    q, s, x = _cuda_case(cuda, "k10", R, K, N)
    for xx in (x, x.bfloat16()):
        planes = qm.quant_matmul_int4_planes_stacked(
            xx, qm.pack_int4_planes(q), s, 1)
        pairs = qm.quant_matmul_int4_pairs_stacked(
            xx, qm.pack_int4_pairs(q), s, 1)
        byts = qm.quant_matmul_int4(xx, qm.pack_int4(q[1]), s[1])
        torch.cuda.synchronize()
        assert torch.equal(pairs, planes)
        assert torch.equal(byts, planes)


@pytest.mark.cuda
def test_kernel_raises_on_bad_operands(cuda):
    x = torch.zeros((2, 64), device=cuda)
    wb = torch.zeros((32, 16), dtype=torch.int8, device=cuda)
    ww = torch.zeros((8, 16), dtype=torch.int32, device=cuda)
    s = torch.ones((1, 16), device=cuda)
    with pytest.raises(ValueError, match="K=32, the weight 64"):
        qm.quant_matmul_int4(torch.zeros((2, 32), device=cuda), wb, s)
    with pytest.raises(ValueError, match="K=32, the weight 64"):
        qm.quant_matmul_int4_pairs(torch.zeros((2, 32), device=cuda), ww, s)
    with pytest.raises(ValueError, match="weight"):
        qm.quant_matmul_int4(x, ww, s)
    with pytest.raises(ValueError, match="weight"):
        qm.quant_matmul_int4_pairs(x, wb, s)
    with pytest.raises(ValueError, match="scale"):
        qm.quant_matmul_int4_pairs(x, ww, torch.ones((1, 8), device=cuda))
    with pytest.raises(ValueError, match="layer"):
        qm.quant_matmul_int4_stacked(x, wb[None], s[None], 1)
    with pytest.raises(ValueError, match="weight on cpu"):
        qm.quant_matmul_int4_pairs(x, ww.cpu(), s)
