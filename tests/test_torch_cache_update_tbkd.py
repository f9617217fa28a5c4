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
