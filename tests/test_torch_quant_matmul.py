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


@pytest.mark.parametrize("rule", ["ragged", "few_rows_tiling"])
def test_splits_cover_k_without_empty_slices(rule):
    """The ragged route's slices of K (`_splits`) and the few-row TMA
    body's cluster (`few_rows_tiling`): every slice non-empty, together
    covering K; the cluster within the portable 8, the ring at least three
    stages of a tile."""
    for bits in (4, 8):
        for R in (1, 8, 16, 40, 256):
            for K, N in ((5120, 5120), (5120, 1024), (5120, 17408),
                         (17408, 5120), (5120, 151936), (64, 24)):
                if rule == "ragged":
                    steps = qm._steps(K, bits)
                    s = qm._splits(R, K, N, bits)
                    per = -(-steps // s)
                    assert 1 <= s <= steps and (s - 1) * per < steps
                    continue
                bn, ck, stages = qm.few_rows_tiling(R, K, N, bits)
                tiles = -(-K // qm.FEW_TILE_K[bits])
                per = -(-tiles // ck)
                assert bn == 128 and 1 <= ck <= qm.FEW_MAX_CLUSTER
                assert (ck - 1) * per < tiles <= ck * per
                assert stages >= 3
                assert stages * qm.FEW_TILE_K[bits] * bn * bits // 8 >= (
                    qm.FEW_RING_BYTES)


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


# ---------------------------------------------------------------------------
# the many-row body (csrc/quant_matmul_rows.cuh): its grid rule, its shape
# rule, and the decoder's routes


def test_rows_tiling():
    """The many-row body's grid, one rule for K10, K14 and K15g: rows a
    block follow R (64 up to 64 rows, 128 up to 128, then 256 unless 128
    pads fewer rows); at Qwen3-14B's projections it gives the grids the card
    measured fastest (a verify round's 40 rows: 128 columns, K over 4 or 8
    blocks; R 128: 256 columns but at k/v); every K rank keeps half of
    `ROWS_MIN_TILES` tiles or more, within the portable cluster of 8."""
    assert qm.rows_tiling(25, 5120, 17408)[0] == 64
    assert qm.rows_tiling(64, 5120, 17408)[0] == 64
    assert qm.rows_tiling(65, 5120, 17408)[0] == 128
    assert qm.rows_tiling(300, 5120, 17408)[0] == 128     # 384 vs 512 rows
    assert qm.rows_tiling(384, 5120, 17408)[0] == 128
    assert qm.rows_tiling(512, 5120, 17408)[0] == 256
    assert qm.rows_tiling(40, 5120, 17408, bm=128)[0] == 128
    assert qm.rows_tiling(40, 5120, 17408) == (64, 128, 4)      # gate/up
    assert qm.rows_tiling(40, 17408, 5120) == (64, 128, 8)      # down
    assert qm.rows_tiling(40, 5120, 5120) == (64, 128, 4)       # q/o
    assert qm.rows_tiling(40, 5120, 1024) == (64, 128, 8)       # k/v
    assert qm.rows_tiling(128, 5120, 17408) == (128, 256, 1)
    assert qm.rows_tiling(128, 17408, 5120) == (128, 256, 4)
    assert qm.rows_tiling(128, 5120, 1024) == (128, 128, 8)
    assert qm.rows_tiling(3072, 5120, 17408) == (256, 128, 1)   # install
    for R in (1, 25, 40, 64, 100, 128, 300, 1000, 3072):
        for K, N in ((5120, 5120), (5120, 1024), (5120, 17408),
                     (17408, 5120), (5120, 151936), (1152, 3456), (64, 24),
                     (999, 1028)):
            bm, bn, ck = qm.rows_tiling(R, K, N)
            assert bm in qm.ROWS_BLOCK_ROWS and bn in qm.ROWS_BLOCK_COLS
            assert bm != 256 or bn == 128
            assert ck in qm.ROWS_CLUSTERS
            assert ck == 1 or -(-K // qm.ROWS_TILE_K) >= (
                ck * qm.ROWS_MIN_TILES // 2)


def test_few_rows_threshold_and_shape_rule():
    """The kernels leave the few-row body above `FEW_ROWS` rows, the
    crossover the card measured over R 8-64 (the few-row body wins at 8,
    the many-row body at 16 in 7 of Qwen3-14B's 8 projection formats and
    everywhere from 24); the many-row body, whose copies are TMA boxes
    (row strides multiples of 16 bytes), takes int8 with K % 8 == 0 and N %
    16 == 0, planes and pairs with K % 64 == 0 and N % 4 == 0, bytes with K
    % 64 == 0 and N % 16 == 0, each with a 16-byte-aligned weight."""
    assert 8 <= qm.FEW_ROWS < 64
    assert qm.FEW_ROWS < qm.QUANT_KERNEL_ROWS
    assert qm.rows_fit("int8", 1000, 1040, 64)
    assert not qm.rows_fit("int8", 999, 1040, 0)           # K % 8
    assert not qm.rows_fit("int8", 1000, 1028, 0)          # N % 16
    assert not qm.rows_fit("int8", 5120, 1024, 8)          # misaligned
    for fmt in ("planes", "pairs", "bytes"):
        assert qm.rows_fit(fmt, 5120, 17408, 0)
        assert qm.rows_fit(fmt, 1024, 1040, 16)
        assert not qm.rows_fit(fmt, 5120 + 32, 1024, 0)    # K % 64
        assert not qm.rows_fit(fmt, 1000, 1024, 0)         # K % 64
        assert not qm.rows_fit(fmt, 5120, 1030, 0)         # N % 4
        assert not qm.rows_fit(fmt, 5120, 1024, 8)         # misaligned
        # N % 16: the bytes' rows are N bytes apart, the words' 4N
        assert qm.rows_fit(fmt, 1024, 1028, 16) == (fmt != "bytes")


# ---------------------------------------------------------------------------
# the few-row TMA body (csrc/quant_matmul.cuh): its grid rule, its shape
# rule and the routes


def test_few_rows_tiling():
    """The few-row TMA body's grid, one rule for K10, K11a, K11b and K14:
    K split over the largest cluster up to 8 whose ranks all hold a tile
    (the fastest on the card at every Qwen3-14B projection), a ring of 4
    stages of 8 KB (128 k of int4, 64 k of int8); every choice within a
    block's shared memory; `ck` fixes the cluster, and none fits where x's
    slice of 16 rows cannot."""
    for K, N in ((5120, 17408), (17408, 5120), (5120, 5120), (5120, 1024),
                 (5120, 151936)):
        assert qm.few_rows_tiling(8, K, N) == (128, 8, 4)
        assert qm.few_rows_tiling(8, K, N, bits=8) == (128, 8, 4)
    assert qm.few_rows_tiling(8, 1152, 3456) == (128, 5, 4)   # 9 tiles: 5 x 2
    assert qm.few_rows_tiling(8, 128, 3456) == (128, 1, 4)    # one tile
    assert qm.few_rows_tiling(1, 5120, 17408) == qm.few_rows_tiling(
        8, 5120, 17408)                        # 8 rows a block up to 8
    assert qm.few_rows_tiling(8, 5120, 17408, ck=5) == (128, 5, 4)
    assert qm.few_rows_tiling(8, 5120, 17408, ck=9) is None       # no rank
    assert qm.few_rows_tiling(16, 65536, 1024) is None            # x slice
    for R in (1, 4, 8, 9, 16, 40):
        for bits in (4, 8):
            for K, N in ((5120, 17408), (17408, 5120), (5120, 151936),
                         (1152, 3456), (14336, 4096), (2368, 1168)):
                bn, ck, stages = qm.few_rows_tiling(R, K, N, bits)
                rows = 8 if R <= 8 else 16
                tile = qm.FEW_TILE_K[bits]
                tiles = -(-K // tile)
                stage = tile * bn * bits // 8
                recv = rows * bn * 4 + ck * 16 if ck > 1 else 0
                smem = (1024 + stages * stage + recv
                        + rows * (-(-tiles // ck) * 2 * tile + 64)
                        + 16 * stages)
                assert smem <= qm.FEW_SMEM
                assert ck == min(8, tiles) or (ck * -(-tiles // (ck + 1))
                                               >= tiles)


def test_route_by_shape():
    """Which body a call takes, by its shape alone: the few-row TMA body up
    to `FEW_ROWS` rows (at any R when asked), the many-row body above, and
    the ragged route wherever TMA cannot describe the weight (a row stride
    off 16 bytes, an int4 K off the 64-value tile, an int8 K off 8, an
    unaligned base; the int4 formats here also an N off 32) or x's slice of
    16 rows cannot fit a block."""
    F = qm.FEW_ROWS
    for fmt in ("planes", "pairs", "bytes", "int8"):
        assert qm.route(fmt, 1, 5120, 17408, 0) == "few"
        assert qm.route(fmt, F, 5120, 17408, 0) == "few"
        assert qm.route(fmt, F + 1, 5120, 17408, 0) == "rows"
        assert qm.route(fmt, 300, 5120, 17408, 0, few_rows=True) == "few"
        assert qm.route(fmt, 1, 5120, 17408, 8) == "ragged"     # misaligned
        assert qm.route(fmt, 300, 5120, 17408, 8) == "ragged"
        assert qm.route(fmt, 1, 5120, 1030, 0) == "ragged"      # N % 4
        assert qm.few_fit(fmt, 32 * 1024, 1024, 0)
        assert not qm.few_fit(fmt, 64 * 1024, 1024, 0)          # x slice
    for fmt in ("planes", "pairs", "bytes"):
        assert qm.route(fmt, 1, 5120 + 32, 1024, 0) == "ragged"  # K % 64
    # N % 16 for int8 (its rows are N bytes apart); N % 32 for the int4
    # formats (planes' stage is one box of 32-word groups; all three alike)
    for fmt in ("planes", "pairs", "bytes"):
        assert qm.route(fmt, 1, 1024, 1056, 0) == "few"
        assert qm.route(fmt, 1, 1024, 1040, 0) == "ragged"
        assert qm.route(fmt, 40, 1024, 1040, 0) == "rows"  # its N % 16
    assert qm.route("int8", 1, 1024, 1040, 0) == "few"
    assert qm.route("int8", 1, 1024, 1028, 0) == "ragged"
    assert qm.route("int8", 1, 1000, 1040, 0) == "few"          # K % 8
    assert qm.route("int8", 1, 999, 1040, 0) == "ragged"


def _projections(model):
    """(K, N) of every projection the port quantizes in `model`
    (`models/quant.py DEFAULT_TARGETS`), at its published widths."""
    from prot2text_tpu_torch.models.esmc import ESMCConfig
    from prot2text_tpu_torch.models.llama import LlamaConfig
    from prot2text_tpu_torch.models.qwen3 import Qwen3Config

    if model == "ESMC-600M":
        c = ESMCConfig.esmc_600m()
        d, f = c.d_model, c.ffn_dim
        return [(d, 3 * d), (d, d), (d, 2 * f), (f, d)]
    c = (Qwen3Config.qwen3_14b() if model == "Qwen3-14B"
         else LlamaConfig.llama_3_1_8b()).core()
    H, D = c.hidden_size, c.head_dim
    return [(H, c.num_heads * D), (H, c.num_kv_heads * D),
            (c.num_heads * D, H), (H, c.intermediate_size),
            (c.intermediate_size, H), (H, c.vocab_size)]


@pytest.mark.parametrize("model", ["Qwen3-14B", "Llama-3.1-8B", "ESMC-600M"])
def test_model_projections_take_the_tma_bodies(model):
    """No projection of the port's models takes the ragged route, in any
    weight format, at a decode step's rows or above: Qwen3-14B's and
    Llama-3.1-8B's q, k/v, o, gate/up, down and LM head, ESMC-600M's qkv,
    out_proj, ffn_in and ffn_out."""
    shapes = _projections(model)
    assert len(shapes) >= 4
    for K, N in shapes:
        for fmt in ("planes", "pairs", "bytes", "int8"):
            for R in (1, 4, 8, 16, 40, 3072):
                want = "few" if R <= qm.FEW_ROWS else "rows"
                assert qm.route(fmt, R, K, N, 0) == want, (model, K, N, fmt,
                                                           R)


# weight format → the leaf's key, its packer from (K, N) integers, the
# plain twin, the unstacked and the stacked wrapper
FORMATS = {
    "planes": ("kernel_q4p", qm.pack_int4_planes,
               qm.quant_matmul_int4_planes_plain, qm.quant_matmul_int4_planes,
               qm.quant_matmul_int4_planes_stacked),
    "int8": ("kernel_q", lambda q: q, qm.quant_matmul_int8_plain,
             qm.quant_matmul_int8, qm.quant_matmul_int8_stacked),
    "bytes": ("kernel_q4", qm.pack_int4, qm.quant_matmul_int4_plain,
              qm.quant_matmul_int4, qm.quant_matmul_int4_stacked),
    "pairs": ("kernel_q4w", qm.pack_int4_pairs,
              qm.quant_matmul_int4_pairs_plain, qm.quant_matmul_int4_pairs,
              qm.quant_matmul_int4_pairs_stacked),
}


@pytest.mark.parametrize("fmt", ["planes", "int8", "bytes", "pairs"])
@pytest.mark.parametrize("R", [40, 300])
def test_linear_takes_the_kernel_at_every_row_count(fmt, R):
    """Every quantized leaf on a bf16 x goes to its kernel above 256 rows
    too (K10, K14, K11a, K11b): on the CPU the plain version, bit for bit
    (JAX's XLA order: the integer weight in the fp32 product, the scale
    after it), and no dequantized weight."""
    from prot2text_tpu_torch.models import quant as tquant
    from prot2text_tpu_torch.models import transformer as tt

    rng = np.random.default_rng(30 + len(fmt) + R)
    w = torch.from_numpy((rng.standard_normal((128, 48)) * 0.02).astype(
        np.float32))
    p = tquant.quantize_params(
        {"q_proj": {"kernel": w}}, bits=8 if fmt == "int8" else 4,
        **({} if fmt == "int8" else {"int4_format": fmt}))["q_proj"]
    key, _, plain = FORMATS[fmt][:3]
    x = torch.from_numpy(rng.standard_normal((R, 128)).astype(
        np.float32)).bfloat16()
    got = tt.linear(p, x.reshape(2, R // 2, 128))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.reshape(R, 48), plain(x, p[key], p["scale"]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tquant, "dequantize_kernel", None)
        mp.setattr(tt, "dequantize_kernel", None)
        assert torch.equal(tt.linear(p, x), got.reshape(R, 48))


@pytest.mark.parametrize("fmt", ["planes", "int8", "bytes", "pairs"])
def test_linear_under_grad_skips_the_kernels(fmt, monkeypatch):
    """A call whose x requires grad takes the dequantized weight at every
    row count and format (the kernels have no backward, so on the card dX
    would be lost): the kernel wrappers are not called, and dX equals the
    dequantized product's.  Without grad the same leaves call them, but
    for an f32 x above `QUANT_KERNEL_ROWS` rows (JAX's XLA route leaves it
    unrounded)."""
    from prot2text_tpu_torch.models import quant as tquant
    from prot2text_tpu_torch.models import transformer as tt

    calls = []
    for name in ("quant_matmul_int4_planes", "quant_matmul_int4",
                 "quant_matmul_int4_pairs", "quant_matmul_int8"):
        def spy(*a, _f=getattr(tt, name), _n=name):
            calls.append(_n)
            return _f(*a)
        monkeypatch.setattr(tt, name, spy)
    rng = np.random.default_rng(7)
    w = torch.from_numpy((rng.standard_normal((64, 16)) * 0.02).astype(
        np.float32))
    p = tquant.quantize_params(
        {"q_proj": {"kernel": w}}, bits=8 if fmt == "int8" else 4,
        **({} if fmt == "int8" else {"int4_format": fmt}))["q_proj"]
    for R, dt in ((5, torch.bfloat16), (300, torch.bfloat16),
                  (300, torch.float32)):
        x = torch.from_numpy(rng.standard_normal((R, 64)).astype(
            np.float32)).to(dt)
        xg = x.clone().requires_grad_()
        g = torch.from_numpy(rng.standard_normal((R, 16)).astype(
            np.float32)).to(dt)
        tt.linear(p, xg).backward(g)
        assert calls == [], (fmt, R)
        xd = x.clone().requires_grad_()
        (xd @ tquant.dequantize_kernel(p, dt)).backward(g)
        assert torch.equal(xg.grad, xd.grad), (fmt, R)
        with torch.no_grad():
            tt.linear(p, xg)
        tt.linear(p, x)
        kernel_rows = R <= qm.QUANT_KERNEL_ROWS or x.dtype == torch.bfloat16
        assert len(calls) == (2 if kernel_rows else 0), (fmt, R, dt, calls)
        calls.clear()


def _grids(R, K, N):
    """Every grid of the many-row body at R: the rule's rows a block, and
    256 rows too above 128 rows."""
    bms = {qm.rows_tiling(R, K, N)[0]} | ({256} if R > 128 else set())
    tiles = -(-K // qm.ROWS_TILE_K)
    for bm in sorted(bms):
        for bn in qm.ROWS_BLOCK_COLS:
            if bm == 256 and bn != 128:
                continue
            for ck in qm.ROWS_CLUSTERS:
                if ck <= tiles:
                    yield bm, bn, ck


def _rows_operands(cuda, fmt, R, K, N, seed, L=1):
    """x (R, K) bf16, the (L, ...) weight packed in `fmt`, its scales and
    the (L, K, N) integers it holds."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    lo, hi = (-127, 128) if fmt == "int8" else (-8, 8)
    q = torch.randint(lo, hi, (L, K, N), generator=g, device=cuda,
                      dtype=torch.int8)
    w = FORMATS[fmt][1](q)
    s = torch.rand((L, 1, N), generator=g, device=cuda) * 0.03 + 0.002
    x = torch.randn((R, K), generator=g, device=cuda).bfloat16()
    return x, w, s, q


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["planes", "int8", "bytes", "pairs"])
@pytest.mark.parametrize("R", [17, 40, 64, 129, 300])
def test_rows_body_matches_plain_on_cuda(cuda, fmt, R):
    """The many-row body at R rows, called directly (whatever the
    threshold), at K 2368 (37 tiles: uneven K slices over Ck 2, 4 and 8)
    and ragged N 1168 (a multiple of 16, not of a block: the last column
    block's TMA boxes run past N), at every grid (above 128 rows also at
    256 rows a block, R 300 then padding 212 rows): bf16 out within 2e-2 ·
    max|plain|, f32 out within 1e-5, two launches bit-identical; bytes and
    pairs bit-identical to the planes of the same integers at each grid."""
    K, N = 2368, 1168
    x, w, s, q = _rows_operands(cuda, fmt, R, K, N, 40 + R + len(fmt))
    w, s = w[0], s[0]
    want = FORMATS[fmt][2](x.float(), w, s)
    top = want.abs().max().item()
    wp = qm.pack_int4_planes(q[0]) if fmt in ("bytes", "pairs") else None
    for grid in _grids(R, K, N):
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
            def call(wt, f):
                return qm.rows_matmul(
                    x, wt.data_ptr(), s.data_ptr(),
                    torch.empty((R, N), dtype=dt, device=cuda), f, grid)

            out = [call(w, fmt) for _ in range(2)]
            ref = call(wp, "planes") if wp is not None else out[0]
            torch.cuda.synchronize()
            err = (out[0].float() - want).abs().max().item()
            assert err <= tol * top, (grid, dt, err, top)
            assert torch.equal(out[0], out[1]), (grid, dt)
            assert torch.equal(out[0], ref), (grid, dt, "planes")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["planes", "int8", "bytes", "pairs"])
def test_rows_body_through_the_wrappers_on_cuda(cuda, fmt):
    """The public wrappers above `FEW_ROWS` rows: f32 x (rounded to bf16,
    f32 out: 1e-5 · max|plain|) and bf16 x (2e-2), unstacked and the
    stacked entry at layer 2 of 3, each launch counted once; where the
    shape rule refuses (int8 at K 999, N 1028; bytes at N 1028; planes and
    pairs at K 1000) and at the threshold, the few-row body, bit-identical
    to `_few_rows`."""
    _, _, plain, kern, stacked = FORMATS[fmt]
    x, w, s, _ = _rows_operands(cuda, fmt, 300, 1024, 640, 300 + len(fmt),
                                L=3)
    want = plain(x.float(), w[2], s[2])
    top = want.abs().max().item()
    n0, n1 = kern.launches, stacked.launches
    got32 = kern(x.float(), w[2].contiguous(), s[2])
    got16 = stacked(x, w, s, 2)
    torch.cuda.synchronize()
    assert kern.launches == n0 + 1 and stacked.launches == n1 + 1
    assert got32.dtype == torch.float32 and got16.dtype == torch.bfloat16
    assert (got32 - want).abs().max().item() <= 1e-5 * top
    assert (got16.float() - want).abs().max().item() <= 2e-2 * top
    assert torch.equal(stacked(x, w, s, 2), got16)
    refused = {"int8": (77, 999, 1028), "bytes": (77, 1024, 1028),
               "planes": (77, 1000, 1028), "pairs": (77, 1000, 1028)}[fmt]
    for R, K, N in ((qm.FEW_ROWS, 1024, 640), refused):
        assert R <= qm.FEW_ROWS or not qm.rows_fit(fmt, K, N, 0)
        x, w, s, _ = _rows_operands(cuda, fmt, R, K, N, 5 + K, L=3)
        assert torch.equal(stacked(x, w, s, 1),
                           qm._few_rows(x, w, s, fmt, 1))
        assert torch.equal(kern(x, w[1].contiguous(), s[1]),
                           qm._few_rows(x, w[1].contiguous(), s[1], fmt))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["planes", "int8", "bytes", "pairs"])
def test_rows_body_cluster_split_on_cuda(cuda, fmt):
    """At a verify round's 40 rows of Qwen3-14B's down projection (K 17408,
    N 5120) the rule splits K over a cluster (Ck > 1): within 2e-2 ·
    max|plain|, two launches bit-identical (the ranks' partials summed in
    rank order), and within the same bound of Ck 1 at the same blocks."""
    R, K, N = 40, 17408, 5120
    grid = qm.rows_tiling(R, K, N, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert grid[2] > 1
    x, w, s, _ = _rows_operands(cuda, fmt, R, K, N, 3 + len(fmt))
    w, s = w[0], s[0]
    want = FORMATS[fmt][2](x.float(), w, s)
    top = want.abs().max().item()
    outs = [qm.rows_matmul(x, w.data_ptr(), s.data_ptr(),
                           torch.empty((R, N), dtype=torch.bfloat16,
                                       device=cuda), fmt, g)
            for g in (grid, grid, grid[:2] + (1,))]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    for o in (outs[0], outs[2]):
        assert (o.float() - want).abs().max().item() <= 2e-2 * top


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["planes", "int8", "bytes", "pairs"])
@pytest.mark.parametrize("R", [1, 3, 8, 9, 16])
def test_few_rows_body_matches_plain_on_cuda(cuda, fmt, R):
    """The few-row TMA body (`_few_rows`, whatever the threshold: R 9 and
    16 in two 8-row MMA tiles) at K 2368 (37 tiles: uneven K slices) and N
    1184 (the last 128-column block past N), on the rule's grid and at
    every cluster 1-8: f32 x within 1e-5 · max|plain|, bf16 x within 2e-2,
    two launches bit-identical, the stacked entry at layer 2 of 3 equal to
    the unstacked call on that layer's copy, and the route "few"."""
    K, N = 2368, 1184
    x, w, s, _ = _rows_operands(cuda, fmt, R, K, N, 70 + R + len(fmt), L=3)
    assert qm.route(fmt, R, K, N, w[2].data_ptr(), few_rows=True) == "few"
    want = FORMATS[fmt][2](x.float(), w[2], s[2])
    top = want.abs().max().item()
    bits = qm._FORMATS[fmt][2]
    for xx, tol in ((x.float(), 1e-5), (x, 2e-2)):
        got = qm._few_rows(xx, w, s, fmt, 2)
        assert torch.equal(got, qm._few_rows(xx, w, s, fmt, 2))
        assert torch.equal(got, qm._few_rows(xx, w[2].contiguous(), s[2],
                                             fmt))
        assert got.dtype == xx.dtype
        assert (got.float() - want).abs().max().item() <= tol * top
        for ck in range(1, qm.FEW_MAX_CLUSTER + 1):
            tiling = qm.few_rows_tiling(R, K, N, bits=bits, ck=ck)
            if tiling is None:
                continue
            outs = [qm.few_matmul(xx, w[2].data_ptr(), s[2].data_ptr(),
                                  torch.empty((R, N), dtype=xx.dtype,
                                              device=cuda), fmt, tiling)
                    for _ in range(2)]
            torch.cuda.synchronize()
            assert torch.equal(outs[0], outs[1]), (ck, xx.dtype)
            err = (outs[0].float() - want).abs().max().item()
            assert err <= tol * top, (ck, xx.dtype, err, top)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["planes", "int8", "bytes", "pairs"])
def test_few_rows_ragged_route_on_cuda(cuda, fmt):
    """Where TMA cannot describe the weight, the wrappers take the ragged
    route (csrc/quant_matmul_ragged.cuh) by the shape rule: a row stride
    off 16 bytes (N 1028 for int8, 1030 for the words), an int4 N off 32
    (N 1040 for the bytes), an int4 K off the 64-value tile (K 1000) or an
    int8 K off 8 (K 999), and
    an unaligned base (a view one element into its buffer); each within
    1e-5 (f32 x) and 2e-2 (bf16 x) of max|plain|, two launches
    bit-identical."""
    kern, plain = FORMATS[fmt][3], FORMATS[fmt][2]
    n_bad = {"int8": 1028, "bytes": 1040}.get(fmt, 1030)
    k_bad = 999 if fmt == "int8" else 1000
    cases = [(1024, n_bad, 0), (k_bad, 1024, 0), (1024, 1024, 1)]
    for K, N, offset in cases:
        x, w, s, _ = _rows_operands(cuda, fmt, 8, K, N, K + N + offset)
        w = w[0]
        if offset:
            buf = torch.empty(w.numel() + offset, dtype=w.dtype,
                              device=cuda)
            buf[offset:] = w.reshape(-1)
            w = buf[offset:].view(w.shape)
        assert qm.route(fmt, 8, K, N, w.data_ptr()) == "ragged", (K, N)
        want = plain(x.float(), w, s[0])
        top = want.abs().max().item()
        for xx, tol in ((x.float(), 1e-5), (x, 2e-2)):
            got = kern(xx, w, s[0])
            assert torch.equal(got, kern(xx, w, s[0]))
            err = (got.float() - want).abs().max().item()
            assert err <= tol * top, (K, N, offset, xx.dtype, err)
