"""K15a-K15g, the probe scripts' quantized matmuls: the plain versions held
against the JAX probe kernels in interpret mode on the same seeded numpy
inputs (K15a-e within 1e-2 of max|y|: the probes write bf16; K15f exact;
K15g within 1e-5 of max|y|), the native int4 packer against the integers,
the unpacks of K15b/K15e against `unpack_int4`, plain K15d against plain
K10 bit for bit; the wrappers run the plain version on CPU tensors without
counting a launch; the CUDA kernels against the plain versions on the card
(bf16 out 2e-2 · max|plain|, K15f exact, K15g 1e-5 · max|plain|).

The probe scripts are not imported: several run their benchmark and point
JAX's compilation cache at a shared directory when imported.  Their named
functions and imports are taken from the source with `ast` and executed
(`load_probe`)."""

import ast
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

from prot2text_tpu_torch.kernels import launch_counts
from prot2text_tpu_torch.kernels import probe_quant_matmul as pq
from prot2text_tpu_torch.kernels import quant_matmul as qm

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


def load_probe(script: str, names, **consts) -> dict:
    """The imports (but the JAX package's) and the named top-level defs of
    scripts/<script>, executed in a namespace holding `consts`."""
    tree = ast.parse((SCRIPTS / script).read_text())
    keep = [n for n in tree.body
            if isinstance(n, ast.Import) or (
                isinstance(n, ast.ImportFrom)
                and not (n.module or "").startswith("prot2text_tpu"))]
    keep += [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name in names]
    assert len(keep) > len(names)
    ns = dict(consts)
    exec(compile(ast.Module(body=keep, type_ignores=[]), script, "exec"), ns)
    return ns


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _x(rng, R, K):
    """bf16-representable f32 activations."""
    x = rng.standard_normal((R, K)).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float().numpy()


R, K, N = 8, 256, 256


def _case(kid, rng):
    """(JAX probe call in interpret mode, the port's plain call, tolerance
    relative to max|y|, None for exact)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    x = _x(rng, R, K)
    s = rng.uniform(0.002, 0.03, (1, N)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt, st = torch.from_numpy(x), torch.from_numpy(s)
    if kid == "K15a":
        q = rng.integers(-128, 128, (K, N)).astype(np.int8)
        ns = load_probe("bench_lmhead3.py", ("_chunk_kernel", "chunk_mm"))
        jax_call = partial(ns["chunk_mm"], xj, jnp.asarray(q),
                           jnp.asarray(s), bn=128, bk=128, bc=64)
        port = partial(pq.chunk_mm_plain, xt, torch.from_numpy(q), st)
    elif kid in ("K15b", "K15e"):
        wp = rng.integers(-128, 128, (K // 2, N)).astype(np.int8)
        script, names, plain = {
            "K15b": ("bench_int4_unpack.py", ("_mm_i4f_kernel", "mm_i4f"),
                     pq.mm_i4f_plain),
            "K15e": ("bench_int4_single.py",
                     ("_mm_i4and_kernel", "mm_i4and"), pq.mm_i4and_plain),
        }[kid]
        ns = load_probe(script, names)
        jax_call = partial(ns[names[1]], xj, jnp.asarray(wp), jnp.asarray(s),
                           bk=64, bn=128)
        port = partial(plain, xt, torch.from_numpy(wp), st)
    elif kid == "K15c":
        q = rng.integers(-8, 8, (K, N)).astype(np.int8)
        ns = load_probe("bench_int4_unpack.py", ("_mm_i4n_kernel", "mm_i4n"))
        jax_call = partial(ns["mm_i4n"], xj, jnp.asarray(q).astype(jnp.int4),
                           jnp.asarray(s), bk=128, bn=128)
        port = partial(pq.mm_i4n_plain, xt,
                       pq.pack_int4_native(torch.from_numpy(q)), st)
    elif kid == "K15d":
        q = rng.integers(-8, 8, (K, N)).astype(np.int8)
        ns = load_probe("bench_int4_planes.py",
                        ("pack_int4_planes", "_mm_i4p_kernel", "mm_i4p"))
        jax_call = partial(ns["mm_i4p"], xj,
                           ns["pack_int4_planes"](jnp.asarray(q)),
                           jnp.asarray(s), bk8=16, bn=128)
        port = partial(pq.mm_i4p_plain, xt,
                       qm.pack_int4_planes(torch.from_numpy(q)), st)
    elif kid == "K15f":
        w = rng.integers(-128, 128, (K, N)).astype(np.int8)
        x8 = rng.integers(-128, 128, (R, K)).astype(np.int8)
        ns = load_probe("bench_int8_mxu.py", ("_i8_kernel", "mm_i8i8"), R=R)
        jax_call = partial(ns["mm_i8i8"], jnp.asarray(x8), jnp.asarray(w),
                           bk=128, bn=128)
        port = partial(pq.mm_i8i8_plain, torch.from_numpy(x8),
                       torch.from_numpy(w))
    else:
        w = rng.integers(-128, 128, (K, N)).astype(np.int8)
        ns = load_probe("bench_int8_mxu.py", ("_mix_kernel", "mm_mix"), R=R)
        jax_call = partial(ns["mm_mix"], xj, jnp.asarray(w), bk=128, bn=128)
        port = partial(pq.mm_mix_plain, xt, torch.from_numpy(w))

    def run_jax():
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(jax_call(), np.float64)

    tol = {"K15f": None, "K15g": 1e-5}.get(kid, 1e-2)
    return run_jax, port, tol


@pytest.mark.parametrize("kid", ["K15a", "K15b", "K15c", "K15d", "K15e",
                                 "K15f", "K15g"])
def test_plain_matches_jax_probe_kernel(kid):
    run_jax, port, tol = _case(kid, np.random.default_rng(ord(kid[-1])))
    want = run_jax()
    got = port()
    assert tuple(got.shape) == want.shape
    got = got.double().numpy()
    if tol is None:
        np.testing.assert_array_equal(got, want)
    else:
        top = np.abs(want).max()
        assert np.abs(got - want).max() <= tol * top, (
            np.abs(got - want).max(), top)


@pytest.mark.parametrize("shape", [(16, 24), (3, 64, 40), (2, 2, 8, 8)])
def test_native_int4_pack_round_trip(shape):
    rng = np.random.default_rng(len(shape))
    q = rng.integers(-8, 8, shape).astype(np.int8)
    packed = pq.pack_int4_native(torch.from_numpy(q))
    assert packed.dtype == torch.int8
    assert tuple(packed.shape) == shape[:-2] + (shape[-2] // 2, shape[-1])
    p = packed.numpy().astype(np.int32)
    # byte [i, n]: row 2i in the low nibble, row 2i + 1 in the high one
    np.testing.assert_array_equal(p & 0xF, q[..., 0::2, :] & 0xF)
    np.testing.assert_array_equal((p >> 4) & 0xF, q[..., 1::2, :] & 0xF)
    np.testing.assert_array_equal(pq.unpack_int4_native(packed).numpy(), q)
    with pytest.raises(ValueError, match="even K"):
        pq.pack_int4_native(torch.zeros(3, 4, dtype=torch.int8))


def test_k15b_k15e_unpacks_equal_the_split_half_integers():
    """Every byte value: the f32-floor and AND unpacks give the integers
    `unpack_int4` gives (low nibbles, then high nibbles)."""
    wp = torch.arange(-128, 128, dtype=torch.int8).reshape(64, 4)
    want = qm.unpack_int4(wp).float()
    assert torch.equal(pq.unpack_int4_floor(wp), want)
    assert torch.equal(pq.unpack_int4_and(wp), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k15d_plain_bit_identical_to_k10_plain(dtype):
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.integers(-8, 8, (128, 96)).astype(np.int8))
    wp = qm.pack_int4_planes(q)
    s = torch.from_numpy(rng.uniform(0.002, 0.03, (1, 96)).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((5, 128)).astype(
        np.float32)).to(dtype)
    assert torch.equal(pq.mm_i4p_plain(x, wp, s),
                       qm.quant_matmul_int4_planes_plain(x, wp, s).to(
                           torch.bfloat16))


def test_k15f_plain_exact_at_the_extremes():
    x = torch.full((3, 4096), -128, dtype=torch.int8)
    w = torch.full((4096, 8), -128, dtype=torch.int8)
    y = pq.mm_i8i8_plain(x, w)
    assert y.dtype == torch.int32
    assert int(y.min()) == int(y.max()) == 128 * 128 * 4096


@pytest.mark.parametrize("K,split_k8,want", [
    (4096, 64, 8), (14336, 512, 4), (14336, 64, 8), (4096, 512, 1),
    (4096, 4096, 1), (2368, 32, 7), (4096, None, "rule")])
def test_plane_splits(K, split_k8, want):
    """K15d's split of K on the few-row TMA body, mapped onto the cluster:
    `split_k8` word rows a rank, capped at the body's cluster of 8 (K 14336
    at 64 rows would ask for 28) and at ranks that all hold a tile (K 2368:
    19 tiles, where 8 ranks of 3 would leave the last one none); None:
    K10's grid rule; a split off the 4-row step raises."""
    if want == "rule":
        want = qm.few_rows_tiling(16, K, 14336, 4)[1]
    assert pq.plane_splits(K, split_k8, 16, 14336) == want
    tiles = -(-K // qm.FEW_TILE_K[4])
    assert (want - 1) * -(-tiles // want) < tiles
    with pytest.raises(ValueError, match="split_k8"):
        pq.plane_splits(K, 6, 16, 14336)


def test_probe_routes():
    """K15a-e take the few-row TMA body where their format's shape rule
    (`quant_matmul.few_fit`) holds: every probe shape (Llama-3.1-8B's and
    Qwen3-14B's widths); int8 at N % 16 != 0 and the int4 formats at N %
    32 != 0 take the same policies on the ragged route."""
    for kid, (K, N) in (("K15a", (4096, 14336)), ("K15a", (4096, 128256)),
                        ("K15b", (14336, 4096)), ("K15c", (4096, 14336)),
                        ("K15d", (14336, 4096)), ("K15e", (5120, 17408))):
        assert qm.few_fit(pq._VARIANTS[kid][3], K, N, 0), kid
    for kid in ("K15a", "K15b", "K15c", "K15d", "K15e"):
        assert not qm.few_fit(pq._VARIANTS[kid][3], 512, 1028, 0), kid
    assert qm.few_fit(pq._VARIANTS["K15a"][3], 512, 1040, 0)
    assert not qm.few_fit(pq._VARIANTS["K15d"][3], 512, 1040, 0)


def test_mix_tiling():
    """K15g's grid: K14's many-row rule (`quant_matmul.rows_tiling`) at 128
    rows a block.  At the probe's shape 56 blocks of 256 columns, K split
    over clusters of 2 (112 of 132 SMs); a narrow N takes up to 8 K slices
    where K has the tiles; a short K splits nothing; a grid of several
    waves splits nothing; every K rank keeps at least half of
    `ROWS_MIN_TILES` tiles."""
    def tiling(R, K, N, sms=132):
        return qm.rows_tiling(R, K, N, sms, bm=pq.MIX_BLOCK_ROWS)

    assert tiling(128, 4096, 14336) == (128, 256, 2)
    assert tiling(128, 14336, 4096) == (128, 256, 8)
    assert tiling(200, 256, 128)[2] == 1
    assert tiling(1, 64, 24)[2] == 1
    assert tiling(512, 4096, 14336)[2] == 1
    assert tiling(128, 4096, 14336, sms=16)[2] == 1
    for R, K, N in ((1, 1, 4), (300, 999, 1028), (128, 64 * 33, 20000)):
        bm, bn, ck = tiling(R, K, N)
        assert bm == pq.MIX_BLOCK_ROWS and bn in qm.ROWS_BLOCK_COLS
        assert ck in qm.ROWS_CLUSTERS
        assert ck == 1 or -(-K // qm.ROWS_TILE_K) >= (
            ck * qm.ROWS_MIN_TILES // 2)


@pytest.mark.parametrize("K,N", [(999, 1028), (64, 24), (1000, 1040)])
def test_mix_operands_pad_to_the_body(K, N):
    """K15g's zero-padded copy: K to a multiple of 8 and N of 16 where the
    many-row body's shape rule fails (else the operands as given), and the
    product's first N columns unchanged (within 1e-6 · max: only the fp32
    sums' blocking may move)."""
    g = torch.Generator().manual_seed(K + N)
    x = torch.randn((5, K), generator=g).to(torch.bfloat16)
    w = torch.randint(-128, 128, (K, N), generator=g).to(torch.int8)
    xk, wk = pq._mix_operands(x, w)
    assert qm.rows_fit("int8", xk.shape[1], wk.shape[1], 0)
    assert (xk is x) == (wk is w) == qm.rows_fit("int8", K, N, w.data_ptr())
    assert xk.shape[1] - K < 8 and wk.shape[1] - N < 16
    assert not xk[:, K:].any() and not wk[K:].any() and not wk[:, N:].any()
    want = pq.mm_mix_plain(x, w)
    got = pq.mm_mix_plain(xk, wk)[:, :N]
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def test_i8_tiling():
    """K15f's grid: K14's many-row rule at 128 k values a tile
    (`pq.i8_tiling`).  At the probe's shape 128 rows and 256 columns a
    block, K over clusters of 2, as K15g (the weight streams once); rows
    follow R (64 up to 64, 256 at 200); a short K splits nothing; every K
    rank keeps at least half of `ROWS_MIN_TILES` tiles of 128."""
    assert pq.i8_tiling(128, 4096, 14336) == (128, 256, 2)
    assert pq.i8_tiling(1, 64, 32) == (64, 128, 1)
    assert pq.i8_tiling(200, 256, 128) == (256, 128, 1)
    assert pq.i8_tiling(128, 14336, 4096)[2] == 8
    for R, K, N in ((1, 16, 16), (77, 4096, 1024), (300, 1008, 1040),
                    (128, 128 * 33, 20000)):
        bm, bn, ck = pq.i8_tiling(R, K, N)
        assert bm in qm.ROWS_BLOCK_ROWS and bn in qm.ROWS_BLOCK_COLS
        assert (bm, bn) != (256, 256) and ck in qm.ROWS_CLUSTERS
        assert ck == 1 or -(-K // pq.I8_TILE_K) >= (
            ck * qm.ROWS_MIN_TILES // 2)


@pytest.mark.parametrize("N", [24, 1028, 32, 1040])
def test_i8_weight_pads_to_the_body(N):
    """K15f's weight as the body's TMA box takes it: as given where N % 16
    == 0, else zero-padded to the next multiple of 16 columns; the product
    over the padded weight holds the exact product in its first N
    columns and zeros after."""
    g = torch.Generator().manual_seed(N)
    K = 64
    x = torch.randint(-128, 128, (5, K), generator=g).to(torch.int8)
    w = torch.randint(-128, 128, (K, N), generator=g).to(torch.int8)
    wk = pq._i8_weight(w)
    assert (wk is w) == (N % 16 == 0)
    assert wk.shape == (K, -(-N // 16) * 16) and wk.dtype == torch.int8
    assert torch.equal(wk[:, :N], w) and not wk[:, N:].any()
    got = pq.mm_i8i8_plain(x, wk)
    assert torch.equal(got[:, :N], pq.mm_i8i8_plain(x, w))
    assert not got[:, N:].any()


def test_wrappers_run_plain_on_cpu_and_count_nothing():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(_x(rng, 4, 64)).bfloat16()
    q = torch.from_numpy(rng.integers(-8, 8, (64, 32)).astype(np.int8))
    s = torch.full((1, 32), 0.01)
    before = launch_counts()
    wb = qm.pack_int4(q)
    for kern, plain, w, kw in (
            (pq.chunk_mm, pq.chunk_mm_plain, q, {"bc": 64}),
            (pq.mm_i4f, pq.mm_i4f_plain, wb, {}),
            (pq.mm_i4n, pq.mm_i4n_plain, pq.pack_int4_native(q), {}),
            (pq.mm_i4p, pq.mm_i4p_plain, qm.pack_int4_planes(q),
             {"block_cols": 256, "split_k8": 4}),
            (pq.mm_i4and, pq.mm_i4and_plain, wb, {})):
        assert torch.equal(kern(x, w, s, **kw), plain(x, w, s))
    assert torch.equal(pq.mm_mix(x, q), pq.mm_mix_plain(x, q))
    assert torch.equal(pq.mm_i8i8(q[:, :4].t().contiguous(), q),
                       pq.mm_i8i8_plain(q[:, :4].t().contiguous(), q))
    assert launch_counts() == before


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version


def _cuda_operands(kid, R, K, N, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(shape, lo=-128, hi=128):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int8)

    if kid in ("K15b", "K15e"):
        w = ints((K // 2, N))
    elif kid == "K15c":
        w = pq.pack_int4_native(ints((K, N), -8, 8))
    elif kid == "K15d":
        w = qm.pack_int4_planes(ints((K, N), -8, 8))
    else:
        w = ints((K, N))
    x = (ints((R, K)) if kid == "K15f" else torch.randn(
        (R, K), generator=g, device=dev).to(torch.bfloat16))
    s = torch.rand((1, N), generator=g, device=dev) * 0.03 + 0.002
    return x, w, s


KERN = {"K15a": (pq.chunk_mm, pq.chunk_mm_plain),
        "K15b": (pq.mm_i4f, pq.mm_i4f_plain),
        "K15c": (pq.mm_i4n, pq.mm_i4n_plain),
        "K15d": (pq.mm_i4p, pq.mm_i4p_plain),
        "K15e": (pq.mm_i4and, pq.mm_i4and_plain),
        "K15f": (pq.mm_i8i8, pq.mm_i8i8_plain),
        "K15g": (pq.mm_mix, pq.mm_mix_plain)}


@pytest.mark.cuda
@pytest.mark.parametrize("kid", sorted(KERN))
@pytest.mark.parametrize("R,K,N", [(1, 64, 24), (16, 512, 1028),
                                   (40, 1024, 256), (128, 2048, 640),
                                   (200, 256, 128)])
def test_kernel_matches_plain_on_cuda(cuda, kid, R, K, N):
    """Ragged N (a multiple of 4, not of a block), R 1 to 200 (K15f/K15g:
    one or two 128-row blocks), split and unsplit K."""
    x, w, s = _cuda_operands(kid, R, K, N, cuda, R * K + N)
    kern, plain = KERN[kid]
    args = (x, w) if kid in ("K15f", "K15g") else (x, w, s)
    n0 = kern.launches
    got = kern(*args)
    torch.cuda.synchronize()
    assert kern.launches == n0 + 1
    want = plain(*args)
    if kid == "K15f":
        assert torch.equal(got, want)
        return
    top = want.float().abs().max().item()
    rel = 1e-5 if kid == "K15g" else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= rel * top
    assert torch.equal(kern(*args), got), "the split sum is not repeatable"


@pytest.mark.cuda
def test_controls_bit_identical_on_cuda(cuda):
    """K15a at bc 128 is K14's few-row body, K15b/K15e are K11a's, K15d at
    K10's tiling is K10's, bit for bit (`quant_matmul._few_rows`, whatever
    the threshold: at these 16 rows K10, K11a and K14 run the many-row
    body, the probes stay on the few-row one); K15a's other chunks and
    K15d's other tiles agree with the plain version."""
    x, q, s = _cuda_operands("K15a", 16, 4096, 2048, cuda, 1)
    assert torch.equal(pq.chunk_mm(x, q, s, bc=128),
                       qm._few_rows(x, q, s, "int8"))
    want = pq.chunk_mm_plain(x, q, s).float()
    for bc in pq.CHUNK_ROWS:
        got = pq.chunk_mm(x, q, s, bc=bc).float()
        assert (got - want).abs().max() <= 2e-2 * want.abs().max()
    _, wb, _ = _cuda_operands("K15b", 16, 4096, 2048, cuda, 2)
    ref = qm._few_rows(x, wb, s, "bytes")
    assert torch.equal(pq.mm_i4f(x, wb, s), ref)
    assert torch.equal(pq.mm_i4and(x, wb, s), ref)
    _, wp, _ = _cuda_operands("K15d", 16, 4096, 2048, cuda, 3)
    assert torch.equal(pq.mm_i4p(x, wp, s),
                       qm._few_rows(x, wp, s, "planes"))
    want = pq.mm_i4p_plain(x, wp, s).float()
    for cols in pq.PLANE_BLOCK_COLS:
        for k8 in (None, 64, 512):
            got = pq.mm_i4p(x, wp, s, block_cols=cols, split_k8=k8).float()
            assert (got - want).abs().max() <= 2e-2 * want.abs().max()


@pytest.mark.cuda
def test_kernels_raise_on_bad_operands(cuda):
    x = torch.zeros((2, 64), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((64, 16), dtype=torch.int8, device=cuda)
    s = torch.ones((1, 16), device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        pq.chunk_mm(x.float(), w, s)
    with pytest.raises(ValueError, match="bc"):
        pq.chunk_mm(x, w, s, bc=48)
    with pytest.raises(ValueError, match="multiple of 4"):
        pq.chunk_mm(x, w[:, :14].contiguous(), s[:, :14].contiguous())
    with pytest.raises(ValueError, match="K=64, the weight 128"):
        pq.mm_i4f(x, w, s)
    with pytest.raises(ValueError, match="block_cols"):
        pq.mm_i4p(x, torch.zeros((8, 16), dtype=torch.int32, device=cuda),
                  s, block_cols=512)
    with pytest.raises(TypeError, match="int8"):
        pq.mm_i8i8(x, w)


@pytest.mark.cuda
def test_k15g_probe_shape_bit_identical_on_cuda(cuda):
    """K15g at the probe's shape (R 128, K 4096, N 14336: 256 columns a
    block, K over clusters of 2) within 1e-5 · max|plain|, and two
    launches bit-identical (the cluster sums its partials in rank order)."""
    x, w, _ = _cuda_operands("K15g", 128, 4096, 14336, cuda, 21)
    got = pq.mm_mix(x, w)
    again = pq.mm_mix(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = pq.mm_mix_plain(x, w)
    top = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * top


@pytest.mark.cuda
@pytest.mark.parametrize("R,K,N", [(200, 999, 1028), (77, 4096, 1024)])
def test_k15g_every_tiling_on_cuda(cuda, R, K, N):
    """Every block width and K split of the many-row body at 128 rows a
    block, forced past the rule, within 1e-5 · max|plain|: K 999 and N 1028
    (no TMA box fits) run on the zero-padded copy, with a ragged last K
    tile and a column block past N; `mm_mix` itself takes them too."""
    x, w, _ = _cuda_operands("K15g", R, K, N, cuda, R + K + N)
    want = pq.mm_mix_plain(x, w)
    top = want.abs().max().item()
    xk, wk = pq._mix_operands(x, w)
    assert qm.rows_fit("int8", xk.shape[1], wk.shape[1], wk.data_ptr())
    for bn in qm.ROWS_BLOCK_COLS:
        for ck in qm.ROWS_CLUSTERS:
            if ck > -(-xk.shape[1] // qm.ROWS_TILE_K):
                continue
            out = torch.empty((R, wk.shape[1]), dtype=torch.float32,
                              device=cuda)
            qm.rows_matmul(xk, wk.data_ptr(), None, out, "int8",
                           (pq.MIX_BLOCK_ROWS, bn, ck))
            torch.cuda.synchronize()
            err = (out[:, :N] - want).abs().max().item()
            assert err <= 1e-5 * top, (bn, ck, err)
    err = (pq.mm_mix(x, w) - want).abs().max().item()
    assert err <= 1e-5 * top


@pytest.mark.cuda
def test_k15f_probe_shape_bit_identical_on_cuda(cuda):
    """K15f at the probe's shape (R 128, K 4096, N 14336: 256 columns a
    block, K over clusters of 2) exact, and two launches bit-identical."""
    x, w, _ = _cuda_operands("K15f", 128, 4096, 14336, cuda, 31)
    assert pq.i8_tiling(128, 4096, 14336) == (128, 256, 2)
    got = pq.mm_i8i8(x, w)
    again = pq.mm_i8i8(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, pq.mm_i8i8_plain(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("R,K,N", [(1, 4096, 1028), (77, 4096, 1024),
                                   (200, 1008, 1040), (128, 2064, 24)])
def test_k15f_every_tiling_on_cuda(cuda, R, K, N):
    """Every grid of the s8 policy forced past the rule, exact: rows 64,
    128 and 256 a block, 128 and 256 columns (not 256 at 256 rows), K over
    every cluster up to its tiles; R 1 to 200, ragged N (a multiple of 4:
    the padded weight), K off the 128-k tile (a zero-filled last tile);
    two launches of each bit-identical."""
    x, w, _ = _cuda_operands("K15f", R, K, N, cuda, R + K + N)
    want = pq.mm_i8i8_plain(x, w)
    tiles = -(-K // pq.I8_TILE_K)
    for bm in qm.ROWS_BLOCK_ROWS:
        for bn in qm.ROWS_BLOCK_COLS:
            if (bm, bn) == (256, 256):
                continue
            for ck in qm.ROWS_CLUSTERS:
                if ck > tiles:
                    continue
                got = pq.mm_i8i8(x, w, tiling=(bm, bn, ck))
                again = pq.mm_i8i8(x, w, tiling=(bm, bn, ck))
                torch.cuda.synchronize()
                assert torch.equal(got, want), (bm, bn, ck)
                assert torch.equal(again, got), (bm, bn, ck)
    assert torch.equal(pq.mm_i8i8(x, w), want)
