"""K12 and K13, the in-place slot writes of the (L, T, B, Hkv, D) "tbkd"
cache: the port's plain versions against the JAX Pallas kernels in
interpret mode where their N = B·Hkv·D % 128 == 0 tiling rule holds, and
against the JAX decoder's `dynamic_update_slice` fallback where it does
not (the port's kernels take any N); K13 against two K12 writes; all
bit-exact.  The CUDA kernels bit-exact against the plain versions on the
card, with their launch counts, and lockstep generation on a D=64 decoder
launching K1 and K4 only: the tbkd step writes its slot in K4, so no model
path calls K12 (`kernels.OFF_PATH`).  JAX is imported only by the tests
that use it, so the card's tests run without it."""

import numpy as np
import pytest
import torch

from prot2text_tpu_torch.kernels import OFF_PATH, launch_counts
from prot2text_tpu_torch.kernels.cache_update import (
    cache_slot_write, cache_slot_write_kv, cache_slot_write_kv_plain,
    cache_slot_write_plain,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(L, T, B, Hkv, D, seed=0, n=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append(rng.standard_normal((L, T, B, Hkv, D)).astype(np.float32))
        out.append(rng.standard_normal((L, B, Hkv, D)).astype(np.float32))
    return out


def _jax_write(cache, new, index):
    """JAX's write of one tbkd cache: the Pallas kernel in interpret mode
    where it applies, else the decoder's fallback."""
    import jax
    import jax.numpy as jnp

    from prot2text_tpu.kernels import cache_update as jcu

    if jcu.supports_inplace(cache.shape):
        return np.asarray(jcu.cache_slot_write(
            jnp.asarray(cache), jnp.asarray(new), index, interpret=True))
    return np.asarray(jax.lax.dynamic_update_slice(
        jnp.asarray(cache), jnp.asarray(new)[:, None], (0, index, 0, 0, 0)))


# (L, T, B, Hkv, D): N = 256 and 512 (the Pallas kernel), 64 and 48 (not
# a multiple of 128: the fallback)
SHAPES = [(3, 8, 2, 2, 64), (2, 12, 2, 4, 64), (3, 8, 2, 2, 16),
          (2, 8, 3, 1, 16)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("index", [0, 5, 7])
def test_k12_plain_matches_jax(shape, index):
    cache, new = _inputs(*shape, seed=index)
    want = _jax_write(cache, new, index)
    t_cache = torch.from_numpy(cache.copy())
    before = launch_counts()
    got = cache_slot_write(t_cache, torch.from_numpy(new), index)
    assert got is t_cache                      # in place
    assert launch_counts() == before           # CPU: the plain version
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_k13_plain_matches_jax_and_two_k12(shape):
    import jax.numpy as jnp

    from prot2text_tpu.kernels import cache_update as jcu

    ck, nk, cv, nv = _inputs(*shape, seed=3, n=2)
    index = 6
    if jcu.supports_inplace(ck.shape):
        wk, wv = (np.asarray(a) for a in jcu.cache_slot_write_kv(
            jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(nk),
            jnp.asarray(nv), index, interpret=True))
    else:
        wk, wv = _jax_write(ck, nk, index), _jax_write(cv, nv, index)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    gk, gv = cache_slot_write_kv(tk, tv, torch.from_numpy(nk),
                                 torch.from_numpy(nv), index)
    assert gk is tk and gv is tv
    np.testing.assert_array_equal(gk.numpy(), wk)
    np.testing.assert_array_equal(gv.numpy(), wv)
    k12 = [cache_slot_write_plain(torch.from_numpy(c.copy()),
                                  torch.from_numpy(n), index)
           for c, n in ((ck, nk), (cv, nv))]
    assert torch.equal(gk, k12[0]) and torch.equal(gv, k12[1])


def test_k13_is_marked_off_path():
    """K13 is off-path, beside K2, K3 and K12, which the bf16 lockstep step
    (bktd) and the tbkd lockstep step replaced by K4's slot write; each
    entry names its reason and where JAX still calls it."""
    assert set(OFF_PATH) == {"K2", "K3", "K12", "K13"}
    assert "tests/test_flash_attention.py:142" in OFF_PATH["K13"]
    for kid in ("K2", "K3", "K12"):
        assert "K4" in OFF_PATH[kid]
        assert "prot2text_tpu/models/decoder.py" in OFF_PATH[kid]
    assert "tbkd" in OFF_PATH["K12"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 842, 4, 8, 64), (3, 40, 2, 2, 16),
                                   (2, 9, 3, 1, 5)])
def test_kernels_bit_exact_on_cuda(cuda, dtype, shape):
    """Llama-3.2-1B's lockstep cache (16-byte words), a small one, and an
    odd run (N·itemsize not a multiple of 16: the byte-wise variant)."""
    ck, nk, cv, nv = (torch.from_numpy(a).to(cuda, dtype)
                      for a in _inputs(*shape, seed=1, n=2))
    T = shape[1]
    for index in (0, T // 2, T - 1):
        n12, n13 = cache_slot_write.launches, cache_slot_write_kv.launches
        got = cache_slot_write(ck.clone(), nk, index)
        gk, gv = cache_slot_write_kv(ck.clone(), cv.clone(), nk, nv, index)
        torch.cuda.synchronize()
        assert cache_slot_write.launches == n12 + 1
        assert cache_slot_write_kv.launches == n13 + 1
        want_k = cache_slot_write_plain(ck.clone(), nk, index)
        want_v = cache_slot_write_plain(cv.clone(), nv, index)
        assert torch.equal(got, want_k)
        assert torch.equal(gk, want_k) and torch.equal(gv, want_v)
        pk, pv = cache_slot_write_kv_plain(ck.clone(), cv.clone(), nk, nv,
                                           index)
        assert torch.equal(pk, want_k) and torch.equal(pv, want_v)


@pytest.mark.cuda
def test_kernels_refuse_bad_operands_on_cuda(cuda):
    cache = torch.zeros(2, 8, 2, 2, 16, device=cuda)
    new = torch.zeros(2, 2, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="out of range"):
        cache_slot_write(cache, new, 8)
    with pytest.raises(ValueError, match="new"):
        cache_slot_write(cache, new[:, :1], 0)
    with pytest.raises(TypeError, match="dtype|is torch"):
        cache_slot_write(cache, new.bfloat16(), 0)
    with pytest.raises(ValueError, match="share"):
        cache_slot_write_kv(cache, cache.bfloat16(), new, new.bfloat16(), 0)
    with pytest.raises(ValueError, match="contiguous"):
        cache_slot_write_kv(cache, cache.clone(), new.transpose(1, 2), new,
                            0)
    with pytest.raises(ValueError, match="out of range"):
        cache_slot_write_kv(cache, cache.clone(), new, new, -1)
    with pytest.raises(ValueError, match="CUDA|contiguous"):
        cache_slot_write_kv(cache, cache.clone(), new, new.cpu(), 0)


def test_refusals_on_cpu_tensors():
    """The checks the CUDA path runs, on CPU tensors: a wrong shape, a
    wrong dtype, a slot outside [0, T), a CPU operand, a non-contiguous one
    (`_build.require_cuda`); the CPU wrappers run the plain version, whose
    slice assignment refuses what it cannot write."""
    from prot2text_tpu_torch.kernels import _build
    from prot2text_tpu_torch.kernels.cache_update import _tbkd_shape

    cache = torch.zeros(2, 8, 2, 3, 16)
    new = torch.zeros(2, 2, 3, 16)
    assert _tbkd_shape("K13", cache, new, 7) == (2, 8, 2 * 3 * 16 * 4)
    with pytest.raises(ValueError, match="K13: new"):
        _tbkd_shape("K13", cache, new[:, :1], 0)
    with pytest.raises(ValueError, match="K12: new"):
        _tbkd_shape("K12", cache, new.transpose(1, 2), 0)
    with pytest.raises(ValueError, match="new"):
        _tbkd_shape("K12", cache[0], new, 0)
    with pytest.raises(TypeError, match="is torch.bfloat16"):
        _tbkd_shape("K13", cache, new.bfloat16(), 0)
    for index in (8, -1):
        with pytest.raises(ValueError, match="out of range"):
            _tbkd_shape("K13", cache, new, index)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _build.require_cuda("K13", cache, cache, new, new)
    with pytest.raises(RuntimeError):
        cache_slot_write(cache.clone(), new[:, :1, :1, :3], 0)
    with pytest.raises(IndexError):
        cache_slot_write_kv(cache.clone(), cache.clone(), new, new, 8)


def _flat(n, offset, dtype, dev, gen):
    """A contiguous tensor of n elements starting `offset` bytes into a
    fresh allocation (the caching allocator's blocks are 512-byte
    aligned), filled with random bits."""
    item = torch.empty((), dtype=dtype).element_size()
    raw = torch.randint(0, 256, (n * item + offset + 16,), generator=gen,
                        dtype=torch.uint8, device=dev)
    return raw[offset:offset + n * item].view(dtype)


# (word width, what sets it): the run's bytes (the addresses at 16), or
# the addresses (offset views; the run's bytes at 16)
WIDTHS = [(w, by) for w in (16, 8, 4, 2, 1) for by in ("run", "address")]


@pytest.mark.cuda
@pytest.mark.parametrize("width,by", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16])
def test_k13_every_word_width_on_cuda(cuda, width, by, dtype):
    """K13 bit-exact against its plain version and against two K12
    launches where the widest word is `width` bytes: a run of 3·width
    bytes (B 1, Hkv 3), or a run of 48 bytes with every operand `width`
    bytes into its allocation; the first, a middle and the last slot;
    nothing else of the caches moves."""
    item = torch.empty((), dtype=dtype).element_size()
    if width < item:
        pytest.skip(f"{dtype} has no {width}-byte word")
    L, T, B, Hkv = 3, 10, 1, 3
    D = (width if by == "run" else 16) // item
    off = width if by == "address" and width < 16 else 0
    gen = torch.Generator(device=cuda).manual_seed(width)
    cshape, nshape = (L, T, B, Hkv, D), (L, B, Hkv, D)
    n_c, n_n = L * T * B * Hkv * D, L * B * Hkv * D
    ck, cv = (_flat(n_c, off, dtype, cuda, gen).view(cshape)
              for _ in range(2))
    nk, nv = (_flat(n_n, off, dtype, cuda, gen).view(nshape)
              for _ in range(2))
    if off:
        assert all(t.data_ptr() % (2 * width) == width
                   for t in (ck, cv, nk, nv))
    for index in (0, T // 2, T - 1):
        gk, gv = cache_slot_write_kv(ck.clone(), cv.clone(), nk, nv, index)
        two = (cache_slot_write(ck.clone(), nk, index),
               cache_slot_write(cv.clone(), nv, index))
        want = cache_slot_write_kv_plain(ck.clone(), cv.clone(), nk, nv,
                                         index)
        torch.cuda.synchronize()
        for got, pair, w, old in ((gk, two[0], want[0], ck),
                                  (gv, two[1], want[1], cv)):
            assert torch.equal(got.view(torch.uint8), w.view(torch.uint8))
            assert torch.equal(pair.view(torch.uint8), w.view(torch.uint8))
            moved = (got.view(torch.uint8) != old.view(torch.uint8))
            assert moved.nonzero()[:, 1].unique().tolist() in ([], [index])


@pytest.mark.cuda
def test_k13_ragged_run_on_cuda(cuda):
    """N·itemsize not a multiple of 16 bytes (bf16 B 3, Hkv 1, D 5: 30
    bytes, 2-byte words) and an f32 run of 12 bytes (4-byte words)."""
    for dtype, shape in ((torch.bfloat16, (2, 9, 3, 1, 5)),
                         (torch.float32, (4, 7, 1, 1, 3))):
        ck, nk, cv, nv = (torch.from_numpy(a).to(cuda, dtype)
                          for a in _inputs(*shape, seed=5, n=2))
        for index in (0, shape[1] - 1):
            gk, gv = cache_slot_write_kv(ck.clone(), cv.clone(), nk, nv,
                                         index)
            want = cache_slot_write_kv_plain(ck.clone(), cv.clone(), nk, nv,
                                             index)
            assert torch.equal(gk, want[0]) and torch.equal(gv, want[1])


@pytest.mark.cuda
def test_k13_chained_calls_in_one_graph_on_cuda(cuda):
    """Ten K13 calls to ten slots, each with its own new rows, captured in
    one CUDA graph (chained launches: each may start before the one before
    it ends): after a replay every slot holds its call's rows and every
    other slot is untouched; a second replay over changed new rows too."""
    L, T, B, Hkv, D = 16, 40, 4, 8, 64
    ck, cv = (torch.from_numpy(a).to(cuda, torch.bfloat16)
              for a in _inputs(L, T, B, Hkv, D, seed=6)[:1] * 2)
    ck, cv = ck.clone(), (cv + 1).clone()
    news = [(torch.randn(L, B, Hkv, D, device=cuda).bfloat16(),
             torch.randn(L, B, Hkv, D, device=cuda).bfloat16())
            for _ in range(10)]
    slots = [3 * i + 1 for i in range(10)]
    start = (ck.clone(), cv.clone())
    cache_slot_write_kv(ck, cv, *news[0], slots[0])    # warm the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for (nk, nv), s in zip(news, slots):
            cache_slot_write_kv(ck, cv, nk, nv, s)
    for rnd in range(2):
        ck.copy_(start[0])
        cv.copy_(start[1])
        if rnd:
            for nk, nv in news:
                nk.mul_(-1)
                nv.add_(1)
        graph.replay()
        torch.cuda.synchronize()
        wk, wv = start[0].clone(), start[1].clone()
        for (nk, nv), s in zip(news, slots):
            cache_slot_write_kv_plain(wk, wv, nk, nv, s)
        assert torch.equal(ck, wk) and torch.equal(cv, wv)


@pytest.mark.cuda
def test_lockstep_generate_launches_k1_and_k4_only_on_cuda(cuda):
    """A D=64 decoder (the tbkd cache): the prefill runs K1 per layer,
    every decode step K4 per layer at the tbkd strides (its slot write in
    K4's epilogue), no K12 and nothing else; the tokens equal the CPU's
    (f32)."""
    from prot2text_tpu_torch.infer.generate import GenerationConfig, generate
    from prot2text_tpu_torch.kernels import reset_launch_counts
    from prot2text_tpu_torch.models.decoder import (
        DecoderConfig, init_decoder_params, kv_cache_layout,
    )
    from prot2text_tpu_torch.models.weights import tree_map

    cfg = DecoderConfig(vocab_size=300, hidden_size=128, num_layers=2,
                        num_heads=2, num_kv_heads=1, intermediate_size=192,
                        head_dim=64, rope_theta=1e4)
    assert kv_cache_layout(cfg) == "tbkd"
    params = init_decoder_params(cfg, generator=torch.Generator()
                                 .manual_seed(0), device="cpu")
    rng = np.random.default_rng(2)
    emb = torch.from_numpy(rng.standard_normal((3, 9, 128)).astype(
        np.float32))
    mask = torch.ones(3, 9, dtype=torch.int32)
    mask[1, :4] = 0
    gcfg = GenerationConfig(max_new_tokens=5, eos_token_id=299,
                            pad_token_id=298)
    want = generate(cfg, params, inputs_embeds=emb, attention_mask=mask,
                    gen_cfg=gcfg)
    reset_launch_counts()
    stats = {}
    got = generate(cfg, tree_map(lambda t: t.to(cuda), params),
                   inputs_embeds=emb.to(cuda), attention_mask=mask.to(cuda),
                   gen_cfg=gcfg, stats=stats)
    counts = launch_counts()
    assert counts["K4"] == cfg.num_layers * stats["steps"] > 0
    assert counts["K1"] == cfg.num_layers
    assert counts["K12"] == 0
    assert sum(counts.values()) == counts["K1"] + counts["K4"]
    assert torch.equal(got.cpu(), want)


def test_time_slab_write_runs_on_cpu(capsys):
    """`scripts/time_slab_write.py` at its tiny CPU shape: the plain
    versions' host times, no device time (a CPU run has none), one JSON
    line per row."""
    from prot2text_tpu_torch.scripts import time_slab_write as tsw

    rows = tsw.main(["--device", "cpu", "--reps", "1", "--tag", "t"])
    assert [r["call"] for r in rows] == [
        "K13", "K12", "copy_ x2", "copy_", "K13 plain", "K12 plain", "K13",
        "copy_ x2"]
    for r in rows:
        assert r["host_ms"] > 0 and r["tag"] == "t"
        assert r.get("ms") is None and r.get("cold_ms") is None
        assert r["bound_by"] == "bytes" and r["bound_ms"] > 0
    assert len(capsys.readouterr().out.splitlines()) == len(rows)
