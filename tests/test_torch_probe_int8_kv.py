"""K15h-K15l, the int8 KV-cache probes: the plain versions of K15h, K15i and
K15k held against the JAX probe's own kernel bodies run by `pallas_call` in
interpret mode on the same seeded numpy inputs (K15h and K15i bit for bit,
K15k at the probe's rtol 1e-2, with a floor of 1e-2 · max|logit| for the
logits near zero, where only the order of the fp32 sums differs); K15j
and K15l against the probes' kernel bodies p3 and p5 with the cache
aliased, at B 1 and 4 and every kind of slot, over the whole buffer (only
the slot's row or column changes).  The JAX probes p3 and p5 cannot pass
as written: with one scalar-prefetch operand they alias operand 1 (`kn`,
`sn`) to the output, not the cache (operand 2), and JAX refuses the alias
before running; with the cache aliased they pass.  The wrappers run the
plain versions on CPU tensors without counting a launch; on the card each
kernel against its plain version (K15j at every word width), their chained
launches inside a CUDA graph, and `_build.stream_of` on a side stream.

The probe script runs nothing at import, but is loaded the way the other
probes are (`ast`), so that no test depends on a script's import-time
code."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from prot2text_tpu_torch.kernels import launch_counts
from prot2text_tpu_torch.kernels import probe_int8_kv as pk

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "probe_int8_kv.py"
Hkv, T, D = 8, 192, 128


def _probe_ns(fix_aliases: bool = False) -> dict:
    """The probe script's imports and functions, executed; fix_aliases
    aliases the cache (operand 2) instead of operand 1."""
    tree = ast.parse(SCRIPT.read_text())
    keep = [n for n in tree.body
            if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef))
            or (isinstance(n, ast.Assign) and ast.unparse(n).startswith(
                "Hkv, T, D"))]
    module = ast.Module(body=keep, type_ignores=[])
    if fix_aliases:
        for node in ast.walk(module):
            if (isinstance(node, ast.keyword)
                    and node.arg == "input_output_aliases"):
                node.value = ast.parse("{2: 0}", mode="eval").body
    ns = {}
    exec(compile(module, str(SCRIPT), "exec"), ns)
    return ns


def _kernel_body(probe: str, rows: int = T, cols: int = D):
    """The inner `kernel` of one of the probe's functions, as a function,
    with the probe's (T, D) set to (rows, cols) in its namespace."""
    tree = ast.parse(SCRIPT.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == probe)
    body = next(n for n in fn.body
                if isinstance(n, ast.FunctionDef) and n.name == "kernel")
    import jax
    import jax.numpy as jnp

    ns = {"jax": jax, "jnp": jnp, "Hkv": Hkv, "T": rows, "D": cols}
    exec(compile(ast.Module(body=[body], type_ignores=[]), str(SCRIPT),
                 "exec"), ns)
    return ns["kernel"]


def _interpret(kernel, out_shape, *args):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pl.pallas_call(kernel, out_shape=out_shape)(*args))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def test_k15h_plain_matches_jax_kernel():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    x = (rng.standard_normal((T, D)) * 12).astype(np.float32)
    x[0, :8] = [0.125, 0.375, -0.125, -0.375, 31.875, -31.875, 40.0, -40.0]
    want = _interpret(_kernel_body("p1_f32_to_int8_store"),
                      jax.ShapeDtypeStruct((T, D), jnp.int8), x)
    got = pk.f32_to_int8_store_plain(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_k15i_plain_matches_jax_kernel():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    a = rng.integers(-128, 128, (T, D)).astype(np.int8)
    b = rng.integers(-128, 128, (T, D)).astype(np.int8)
    want = _interpret(_kernel_body("p2_int8_select"),
                      jax.ShapeDtypeStruct((T, D), jnp.int8), a, b)
    got = pk.int8_select_plain(torch.from_numpy(a), torch.from_numpy(b), 7)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kid, rows, cols", [("K15h", 37, 71),
                                             ("K15i", 842, 72)])
def test_k15h_k15i_plain_match_jax_kernels_at_ragged_tiles(kid, rows, cols):
    """K15h's and K15i's plain versions against the probe's kernel bodies
    at a second tile each, off the (8, 128) grid, with the extremes K15h
    keeps (halves to even, the clip at ±127) in its first row."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(rows * cols)
    out = jax.ShapeDtypeStruct((rows, cols), jnp.int8)
    if kid == "K15h":
        x = (rng.standard_normal((rows, cols)) * 12).astype(np.float32)
        x[0, :8] = [0.125, 0.375, -0.125, -0.375, 31.875, -31.875, 40.0,
                    -40.0]
        want = _interpret(_kernel_body("p1_f32_to_int8_store", rows, cols),
                          out, x)
        got = pk.f32_to_int8_store_plain(torch.from_numpy(x))
    else:
        a = rng.integers(-128, 128, (rows, cols)).astype(np.int8)
        b = rng.integers(-128, 128, (rows, cols)).astype(np.int8)
        want = _interpret(_kernel_body("p2_int8_select", rows, cols), out,
                          a, b)
        got = pk.int8_select_plain(torch.from_numpy(a), torch.from_numpy(b),
                                   7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_k15k_plain_matches_jax_kernel():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((8, D)).astype(
        np.float32)).bfloat16()
    c = rng.integers(-128, 128, (T, D)).astype(np.int8)
    s = rng.uniform(0.01, 1.0, (1, T)).astype(np.float32)
    want = _interpret(_kernel_body("p4_int8_to_bf16_matmul"),
                      jax.ShapeDtypeStruct((8, T), jnp.float32),
                      jnp.asarray(q.float().numpy(), jnp.bfloat16), c, s)
    got = pk.int8_to_bf16_matmul_plain(q, torch.from_numpy(c),
                                       torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-2,
                               atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("probe", ["p1_f32_to_int8_store", "p2_int8_select",
                                   "p4_int8_to_bf16_matmul"])
def test_jax_probes_pass_in_interpret_mode(probe):
    from jax.experimental.pallas import tpu as pltpu

    fn = _probe_ns()[probe]
    with pltpu.force_tpu_interpret_mode():
        fn()                              # the probe asserts its own result


@pytest.mark.parametrize("probe", ["p3_dynamic_int8_group_rmw",
                                   "p5_f32_scale_row_rmw"])
def test_jax_probes_p3_p5_alias_the_wrong_operand(probe):
    """The reference fault: operand 1 is `kn`/`sn`, not the cache, so JAX
    refuses the alias; aliasing the cache (operand 2), the probe passes."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        with pytest.raises(ValueError, match="input_output_aliases"):
            _probe_ns()[probe]()
        _probe_ns(fix_aliases=True)[probe]()


def _batched_probe(probe: str, B: int):
    """The probe's kernel body (p3 or p5) under its own grid spec with a
    leading batch axis of B (grid (B,), the source's batch dim squeezed)
    and the cache aliased, operand 2: the corrected `{2: 0}`."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    if probe == "p3_dynamic_int8_group_rmw":
        src = pl.BlockSpec((None, Hkv, D), lambda b, idx: (b, 0, 0))
        buf = pl.BlockSpec((1, Hkv, 32, D),
                           lambda b, idx: (b, 0, idx[0] // 32, 0))
        shape, dtype = (B, Hkv, T, D), jnp.int8
    else:
        src = pl.BlockSpec((None, Hkv, 1), lambda b, idx: (b, 0, 0))
        buf = pl.BlockSpec((1, Hkv, T), lambda b, idx: (b, 0, 0))
        shape, dtype = (B, Hkv, T), jnp.float32
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(B,), in_specs=[src, buf],
        out_specs=buf)
    kernel = _kernel_body(probe)

    def run(slot, src_, buf_):
        with pltpu.force_tpu_interpret_mode():
            call = pl.pallas_call(
                kernel, grid_spec=grid_spec,
                out_shape=jax.ShapeDtypeStruct(shape, dtype),
                input_output_aliases={2: 0},
                compiler_params=pltpu.CompilerParams(
                    dimension_semantics=("arbitrary",)))
            return np.asarray(call(jnp.array([slot], jnp.int32), src_, buf_))
    return run


@pytest.mark.parametrize("slot", [0, 77, T - 1, T])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("probe", ["p3_dynamic_int8_group_rmw",
                                   "p5_f32_scale_row_rmw"])
def test_k15j_k15l_plain_match_jax_probes(probe, B, slot):
    """Plain K15j (p3) and K15l (p5) against the probes' kernel bodies in
    interpret mode with the cache aliased (operand 2), at B 1 and 4 and
    slots 0, 77 and T - 1: the whole buffer bit for bit, only the slot's
    row or column moved.  An out-of-range slot (T) writes nothing: p5's
    body selects no column there; p3's block index would leave the cache
    (interpret mode refuses it), so the buffer as it was is the
    reference."""
    rng = np.random.default_rng(B * 1000 + slot)
    if probe == "p3_dynamic_int8_group_rmw":
        buf = rng.integers(-128, 128, (B, Hkv, T, D)).astype(np.int8)
        src = rng.integers(-128, 128, (B, Hkv, D)).astype(np.int8)
        plain, src_t = pk.int8_group_rmw_plain, src
    else:
        buf = rng.uniform(0.01, 1.0, (B, Hkv, T)).astype(np.float32)
        src = rng.uniform(2.0, 3.0, (B, Hkv, 1)).astype(np.float32)
        plain, src_t = pk.f32_scale_row_rmw_plain, src[..., 0]
    if probe == "p3_dynamic_int8_group_rmw" and slot >= T:
        want = buf
    else:
        want = _batched_probe(probe, B)(slot, src, buf.copy())
    got = plain(torch.from_numpy(buf.copy()), torch.from_numpy(src_t),
                torch.tensor([slot], dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    moved = np.unique(np.argwhere(got.numpy() != buf)[:, 2]).tolist()
    assert moved == ([] if slot >= T else [slot])


def test_k15j_plain_writes_only_the_slot_row():
    rng = np.random.default_rng(4)
    cache = torch.from_numpy(rng.integers(-128, 128, (2, Hkv, T, D)).astype(
        np.int8))
    kn = torch.from_numpy(rng.integers(-128, 128, (2, Hkv, D)).astype(
        np.int8))
    want = cache.numpy().copy()
    want[:, :, 77] = kn.numpy()
    got = pk.int8_group_rmw_plain(cache, kn,
                                  torch.tensor([77], dtype=torch.int32))
    assert got is cache
    np.testing.assert_array_equal(got.numpy(), want)
    before = cache.clone()
    pk.int8_group_rmw_plain(cache, kn, torch.tensor([T], dtype=torch.int32))
    assert torch.equal(cache, before), "a slot past T must write nothing"


def test_k15l_plain_writes_only_the_slot_column():
    s = torch.full((1, Hkv, T), 0.25)
    sn = torch.arange(Hkv, dtype=torch.float32).reshape(Hkv, 1) + 9
    got = pk.f32_scale_row_rmw_plain(s, sn,
                                     torch.tensor([77], dtype=torch.int32))
    want = np.full((1, Hkv, T), 0.25, np.float32)
    want[0, :, 77] = np.arange(Hkv) + 9
    assert got is s
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_run_plain_on_cpu_and_count_nothing():
    before = launch_counts()
    x = torch.linspace(-20, 20, T * D).reshape(T, D)
    assert torch.equal(pk.f32_to_int8_store(x),
                       pk.f32_to_int8_store_plain(x))
    a = torch.full((T, D), 3, dtype=torch.int8)
    b = torch.full((T, D), -5, dtype=torch.int8)
    assert torch.equal(pk.int8_select(a, b), pk.int8_select_plain(a, b))
    slot = torch.tensor([77], dtype=torch.int32)
    cache = torch.full((1, Hkv, T, D), -1, dtype=torch.int8)
    pk.int8_group_rmw(cache, torch.full((Hkv, D), 42, dtype=torch.int8),
                      slot)
    assert int(cache[0, 3, 77, 5]) == 42 and int(cache[0, 3, 76, 5]) == -1
    q = torch.ones((8, D), dtype=torch.bfloat16)
    s = torch.full((1, T), 0.5)
    assert torch.equal(pk.int8_to_bf16_matmul(q, a, s),
                       pk.int8_to_bf16_matmul_plain(q, a, s))
    sr = torch.full((1, Hkv, T), 0.25)
    pk.f32_scale_row_rmw(sr, torch.full((Hkv, 1), 9.0), slot)
    assert float(sr[0, 0, 77]) == 9.0 and float(sr[0, 0, 76]) == 0.25
    assert launch_counts() == before


def test_k15j_k15l_refuse_a_device_neither_cpu_nor_cuda():
    """The wrappers run the plain version on the CPU and launch on CUDA;
    any other device raises the same message as before the fast path."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="K15j needs CUDA tensors, got meta"):
        pk.int8_group_rmw(torch.empty((1, Hkv, T, D), dtype=torch.int8,
                                      device=meta),
                          torch.empty((Hkv, D), dtype=torch.int8,
                                      device=meta),
                          torch.empty((1,), dtype=torch.int32, device=meta))
    with pytest.raises(ValueError, match="K15l needs CUDA tensors, got meta"):
        pk.f32_scale_row_rmw(torch.empty((1, Hkv, T), device=meta),
                             torch.empty((Hkv, 1), device=meta),
                             torch.empty((1,), dtype=torch.int32,
                                         device=meta))


@pytest.mark.parametrize("kid", ["K15h", "K15i"])
def test_k15h_k15i_refuse_a_device_neither_cpu_nor_cuda(kid):
    """As K15j and K15l: the plain version on the CPU, the kernel on CUDA,
    and any other device raises."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match=f"{kid} needs CUDA tensors, got "
                                         f"meta"):
        if kid == "K15h":
            pk.f32_to_int8_store(torch.empty((T, D), device=meta))
        else:
            pk.int8_select(*(torch.empty((T, D), dtype=torch.int8,
                                         device=meta) for _ in range(2)))


@pytest.mark.cuda
def test_k15j_k15l_refusals_on_cuda(cuda):
    """Every check of the two wrappers raises its own message before any
    launch: an operand off the card or not contiguous, a slot that is not
    one int32 on the card, a buffer of the wrong dtype or rank, a source
    of the wrong size."""
    n = launch_counts()
    cache = torch.zeros((2, Hkv, T, D), dtype=torch.int8, device=cuda)
    kn = torch.zeros((2, Hkv, D), dtype=torch.int8, device=cuda)
    s = torch.zeros((2, Hkv, T), device=cuda)
    sn = torch.zeros((2, Hkv), device=cuda)
    slot = torch.tensor([3], dtype=torch.int32, device=cuda)
    bad = [
        ("K15j", (cache, kn.cpu(), slot), "contiguous tensor on cuda"),
        ("K15j", (cache, kn.transpose(1, 2).contiguous().transpose(1, 2),
                  slot), "contiguous tensor on cuda"),
        ("K15j", (cache, kn, slot.long()), "slot must be one int32"),
        ("K15j", (cache, kn, slot.cpu()), "slot must be one int32"),
        ("K15j", (cache, kn, slot.repeat(2)), "slot must be one int32"),
        ("K15j", (cache.float(), kn, slot), r"\(B, Hkv, T, D\) int8"),
        ("K15j", (cache[0], kn, slot), r"\(B, Hkv, T, D\) int8"),
        ("K15j", (cache, kn[:1], slot), r"B·Hkv·D int8 values"),
        ("K15l", (s, sn.cpu(), slot), "contiguous tensor on cuda"),
        ("K15l", (s.transpose(1, 2).contiguous().transpose(1, 2), sn, slot),
         "contiguous tensor on cuda"),
        ("K15l", (s, sn, slot.long()), "slot must be one int32"),
        ("K15l", (s.double(), sn, slot), r"\(B, Hkv, T\) f32"),
        ("K15l", (s, sn[:1], slot), r"B·Hkv f32 values"),
    ]
    for kid, args, msg in bad:
        fn = pk.int8_group_rmw if kid == "K15j" else pk.f32_scale_row_rmw
        with pytest.raises(ValueError, match=msg):
            fn(*args)
    assert launch_counts() == n


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda(cuda):
    g = torch.Generator(device=cuda).manual_seed(11)

    def ints(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=cuda,
                             dtype=torch.int8)

    x = torch.randn((T, D), generator=g, device=cuda) * 12
    assert torch.equal(pk.f32_to_int8_store(x),
                       pk.f32_to_int8_store_plain(x))
    a, b = ints(T, D), ints(T, D)
    for row in (0, 7, T - 1, T):
        assert torch.equal(pk.int8_select(a, b, row),
                           pk.int8_select_plain(a, b, row))
    for slot in (0, 77, T - 1, T):
        idx = torch.tensor([slot], dtype=torch.int32, device=cuda)
        cache, kn = ints(2, Hkv, T, D), ints(2, Hkv, D)
        want = pk.int8_group_rmw_plain(cache.clone(), kn, idx)
        assert torch.equal(pk.int8_group_rmw(cache, kn, idx), want)
        s = torch.rand((2, Hkv, T), generator=g, device=cuda)
        sn = torch.rand((2, Hkv), generator=g, device=cuda)
        want = pk.f32_scale_row_rmw_plain(s.clone(), sn, idx)
        assert torch.equal(pk.f32_scale_row_rmw(s, sn, idx), want)
    q = torch.randn((8, D), generator=g, device=cuda).to(torch.bfloat16)
    s = torch.rand((1, T), generator=g, device=cuda)
    got = pk.int8_to_bf16_matmul(q, a, s)
    want = pk.int8_to_bf16_matmul_plain(q, a, s)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    with pytest.raises(ValueError, match="slot"):
        pk.int8_group_rmw(cache, kn, torch.tensor([1], device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("Q, Tc", [(8, T), (13, 200), (1, 64)])
def test_k15k_tensor_core_kernel_matches_plain_on_cuda(cuda, Q, Tc):
    """K15k on the tensor cores at the probe's shape and two ragged ones
    (query rows off the n8 fragment, c rows off the 64-row block): within
    1e-5 of max|plain|, one launch a call, two launches bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(Q * 1000 + Tc)
    q = torch.randn((Q, D), generator=g, device=cuda).to(torch.bfloat16)
    c = torch.randint(-128, 128, (Tc, D), generator=g, device=cuda,
                      dtype=torch.int8)
    s = torch.rand((1, Tc), generator=g, device=cuda)
    n = launch_counts()["K15k"]
    got = pk.int8_to_bf16_matmul(q, c, s)
    again = pk.int8_to_bf16_matmul(q, c, s)
    want = pk.int8_to_bf16_matmul_plain(q, c, s)
    assert launch_counts()["K15k"] == n + 2
    assert got.shape == (Q, Tc) and torch.equal(got, again)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
def test_k15k_refuses_unsupported_operands_on_cuda(cuda):
    """A head dim off the 16-byte grid, and q or c off a 16-byte address
    (cp.async), raise before any launch and name what is wrong."""
    q = torch.ones((8, 40), dtype=torch.bfloat16, device=cuda)
    c = torch.ones((64, 40), dtype=torch.int8, device=cuda)
    s = torch.ones((64,), device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        pk.int8_to_bf16_matmul(q, c, s)
    qb = torch.ones((8 * D + 1,), dtype=torch.bfloat16, device=cuda)
    cb = torch.ones((64 * D + 1,), dtype=torch.int8, device=cuda)
    q, c = qb[:8 * D].view(8, D), cb[:64 * D].view(64, D)
    with pytest.raises(ValueError, match="q must be 16-byte aligned"):
        pk.int8_to_bf16_matmul(qb[1:].view(8, D), c, s)
    with pytest.raises(ValueError, match="c must be 16-byte aligned"):
        pk.int8_to_bf16_matmul(q, cb[1:].view(64, D), s)
    with pytest.raises(ValueError, match="K15k"):
        pk.int8_to_bf16_matmul(q, c, s[:63])


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 64, 72])
@pytest.mark.parametrize("B", [1, 4])
def test_k15j_k15l_bit_exact_on_cuda(cuda, B, D):
    """K15j at D 128 and 64 (16-byte words) and 72 (8-byte words), and on
    a kn one byte off a word (1-byte words), and K15l, against their plain
    versions over the whole buffer at slots 0, 77, T - 1 and T (nothing
    written): bit for bit, only the slot's row or column moved, one launch
    a call."""
    g = torch.Generator(device=cuda).manual_seed(B * 100 + D)
    for slot in (0, 77, T - 1, T):
        idx = torch.tensor([slot], dtype=torch.int32, device=cuda)
        cache = torch.randint(-128, 128, (B, Hkv, T, D), generator=g,
                              device=cuda, dtype=torch.int8)
        raw = torch.randint(-128, 128, (B * Hkv * D + 1,), generator=g,
                            device=cuda, dtype=torch.int8)
        for kn in (raw[:-1].view(B, Hkv, D), raw[1:].view(B, Hkv, D)):
            before = cache.clone()
            want = pk.int8_group_rmw_plain(cache.clone(), kn, idx)
            n = launch_counts()["K15j"]
            got = pk.int8_group_rmw(cache, kn, idx)
            torch.cuda.synchronize()
            assert launch_counts()["K15j"] == n + 1
            assert got is cache and torch.equal(got, want)
            moved = (got != before).nonzero()[:, 2].unique().tolist()
            assert moved == ([] if slot >= T else [slot])
        s = torch.rand((B, Hkv, T), generator=g, device=cuda)
        sn = torch.rand((B, Hkv), generator=g, device=cuda) + 2
        before = s.clone()
        want = pk.f32_scale_row_rmw_plain(s.clone(), sn, idx)
        got = pk.f32_scale_row_rmw(s, sn, idx)
        torch.cuda.synchronize()
        assert got is s and torch.equal(got, want)
        moved = (got != before).nonzero()[:, 2].unique().tolist()
        assert moved == ([] if slot >= T else [slot])


@pytest.mark.cuda
def test_k15j_k15l_chained_launches_in_a_cuda_graph(cuda):
    """Chained launches (programmatic dependent launch) captured in one
    CUDA graph and replayed: ten K15j calls, call i copying row i (the row
    call i - 1 wrote) into row i + 1 at a slot a PyTorch kernel raised just
    before it; then ten K15l calls back to back, column i into column
    i + 1.  Every hop waits for the one before: the first row and column
    reach the eleventh, nothing past it moves."""
    hops = 10
    cache = torch.zeros((1, 1, T, D), dtype=torch.int8, device=cuda)
    first = torch.arange(D, device=cuda).to(torch.int8)
    cache[0, 0, 0] = first
    rows = [cache[0, 0, i].view(1, 1, D) for i in range(hops)]
    slots = [torch.full((1,), i, dtype=torch.int32, device=cuda)
             for i in range(hops)]
    one = torch.ones((1,), dtype=torch.int32, device=cuda)
    s = torch.zeros((1, 1, T), device=cuda)
    s[0, 0, 0] = 7.5
    cols = [s[0, 0, i:i + 1] for i in range(hops)]

    def k15j():
        for i in range(hops):
            slots[i].add_(one)              # slot i + 1, on the device
            pk.int8_group_rmw(cache, rows[i], slots[i])

    def k15l():
        for i in range(hops):
            pk.f32_scale_row_rmw(s, cols[i], slots[i])

    for fn in (k15j, k15l):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        graph.replay()
        torch.cuda.synchronize()
    for i in range(hops + 1):
        assert torch.equal(cache[0, 0, i], first)
    assert int(cache[0, 0, hops + 1:].abs().sum()) == 0
    assert torch.equal(s[0, 0, :hops + 1],
                       torch.full((hops + 1,), 7.5, device=cuda))
    assert int((s[0, 0, hops + 1:] != 0).sum()) == 0


@pytest.mark.cuda
def test_stream_of_is_the_current_stream_on_cuda(cuda):
    """`_build.stream_of` gives the raw handle of the current stream of
    the tensor's device, on the default stream and inside a
    `torch.cuda.stream` context, and a launch there runs on it."""
    from prot2text_tpu_torch.kernels import _build

    t = torch.zeros((1, Hkv, T), device=cuda)
    assert _build.stream_of(t) == torch.cuda.current_stream(cuda).cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert _build.stream_of(t) == side.cuda_stream
        assert _build.stream_of(t) != torch.cuda.default_stream(
            cuda).cuda_stream
        idx = torch.tensor([5], dtype=torch.int32, device=cuda)
        pk.f32_scale_row_rmw(t, torch.ones((1, Hkv), device=cuda), idx)
    side.synchronize()
    assert float(t[0, 3, 5]) == 1.0


def _ints(g, *shape):
    return torch.randint(-128, 128, shape, generator=g, device=g.device,
                         dtype=torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("rows, cols", [(T, D), (T, 72), (37, 71), (3, 5),
                                        (1, 1)])
def test_k15h_bit_exact_at_every_word_width_on_cuda(cuda, rows, cols,
                                                    offset):
    """K15h on x `offset` floats into its storage (16-byte words at 0 and
    4, 2-byte at 2, 1-byte at 1 and 3) at tiles whose element count is a
    multiple of 16 or leaves a tail of 1-15 elements (or has no whole
    word): bit for bit the plain version over the whole output, halves
    and the clip included, one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(rows * cols + offset)
    raw = torch.randn((rows * cols + offset,), generator=g,
                      device=cuda) * 40
    raw[offset::7] = torch.round(raw[offset::7] * 8) / 8
    x = raw[offset:].view(rows, cols)
    n = launch_counts()["K15h"]
    got = pk.f32_to_int8_store(x)
    assert launch_counts()["K15h"] == n + 1
    assert got.shape == (rows, cols) and got.dtype == torch.int8
    assert torch.equal(got, pk.f32_to_int8_store_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_k15h_keeps_its_bytes_for_inf_and_nan_on_cuda(cuda, offset):
    """±inf → ±127 and NaN → -127, as the kernel before 16-byte words gave
    (fmaxf before fminf), at 16-, 1- and 2-byte words and in the tail:
    held to those bytes, not to the plain version, whose NaN cast is
    undefined; a NaN from the product (0·inf) too."""
    inf, nan = float("inf"), float("nan")
    vals = [inf, -inf, nan, 1.0, -0.0, 126.6, -126.6, 127.5]
    raw = torch.tensor([0.0] * offset + vals * 4 + [nan, inf, -inf],
                       device=cuda)
    got = pk.f32_to_int8_store(raw[offset:])
    assert got.tolist() == [127, -127, -127, 4, 0, 127, -127, 127] * 4 + [
        -127, 127, -127]
    prod = pk.f32_to_int8_store(torch.full((16,), inf, device=cuda), 0.0)
    assert prod.tolist() == [-127] * 16


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 8])
@pytest.mark.parametrize("rows, cols", [(T, D), (842, 72), (T, 71),
                                        (5, 3)])
def test_k15i_bit_exact_at_every_word_width_on_cuda(cuda, rows, cols,
                                                    offset):
    """K15i at cols 128 and 72 (16- and 8-byte words), 71 and 3 (1-byte),
    a and b `offset` bytes into their storage (1: 1-byte words, 8: 8-byte
    ones at most), at rows -1, 0, 7, the last and past the end: bit for
    bit the plain version, one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(rows * cols + offset)
    a = _ints(g, rows * cols + offset)[offset:].view(rows, cols)
    b = _ints(g, rows * cols + offset)[offset:].view(rows, cols)
    for row in (-1, 0, 7, rows - 1, rows, 2**40):
        n = launch_counts()["K15i"]
        got = pk.int8_select(a, b, row)
        assert launch_counts()["K15i"] == n + 1
        assert torch.equal(got, pk.int8_select_plain(a, b, row)), row


@pytest.mark.cuda
def test_k15h_k15i_bit_exact_at_a_serving_layer_on_cuda(cuda):
    """One layer of a serving install's keys, (8·1024·8, 128): K15h over
    33.5 MB of f32 and K15i over 8.4 MB tiles (row inside the tile, and
    -1), bit for bit their plain versions over the whole output."""
    g = torch.Generator(device=cuda).manual_seed(65536)
    x = torch.randn((65536, 128), generator=g, device=cuda) * 40
    assert torch.equal(pk.f32_to_int8_store(x),
                       pk.f32_to_int8_store_plain(x))
    a, b = _ints(g, 65536, 128), _ints(g, 65536, 128)
    for row in (40000, -1):
        assert torch.equal(pk.int8_select(a, b, row),
                           pk.int8_select_plain(a, b, row))


@pytest.mark.cuda
def test_k15h_k15i_chained_launches_in_a_cuda_graph(cuda):
    """Ten chained calls of each inside one CUDA graph, each reading the
    previous call's output, and no output kept, so the allocator may hand
    a call memory the call before it still reads: K15h on the previous
    int8 output round-tripped through `.float()` plus 1 (mult 1: each hop
    adds one), K15i with call i taking row i of a into the previous
    output.  A read before `grid_dependency_wait`, or a store, would
    show: the results equal the hops done one by one."""
    hops = 10
    g = torch.Generator(device=cuda).manual_seed(10)
    x0 = torch.randint(-120, 100, (T, D), generator=g, device=cuda).float()
    a, b0 = _ints(g, T, D), _ints(g, T, D)
    outs = {}

    def k15h():
        y = pk.f32_to_int8_store(x0, 1.0)
        for _ in range(hops):
            y = pk.f32_to_int8_store(y.float() + 1, 1.0)
        outs["K15h"] = y

    def k15i():
        y = b0
        for i in range(hops):
            y = pk.int8_select(a, y, i)
        outs["K15i"] = y

    for fn in (k15h, k15i):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(outs["K15h"], torch.clamp(x0 + hops, -127, 127).to(
        torch.int8))
    want = b0.clone()
    want[:hops] = a[:hops]
    assert torch.equal(outs["K15i"], want)


@pytest.mark.cuda
def test_k15h_k15i_refusals_on_cuda(cuda):
    """Every check of the two wrappers raises before any launch: an
    operand off the card or not contiguous, a wrong dtype, rank or shape,
    an empty tensor."""
    n = launch_counts()
    x = torch.zeros((T, D), device=cuda)
    a = torch.zeros((T, D), dtype=torch.int8, device=cuda)
    for args, msg in (((x.t(),), "contiguous tensor on cuda"),
                      ((x.double(),), "non-empty float32"),
                      ((x[:0],), "non-empty float32")):
        with pytest.raises((ValueError, TypeError), match=msg):
            pk.f32_to_int8_store(*args)
    for args, msg in (((a, a.cpu()), "contiguous tensor on cuda"),
                      ((a, a.t()), "contiguous tensor on cuda"),
                      ((a, a.float()), r"\(rows, cols\) int8"),
                      ((a[0], a[0]), r"\(rows, cols\) int8"),
                      ((a, a[:5]), r"\(rows, cols\) int8"),
                      ((a[:0], a[:0]), r"\(rows, cols\) int8")):
        with pytest.raises(ValueError, match=msg):
            pk.int8_select(*args)
    assert launch_counts() == n
