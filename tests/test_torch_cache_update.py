"""K3 (in-place cache slot write): the port's plain version against the
JAX Pallas kernel in interpret mode, exact; the CUDA kernel bit-exact
against the plain version on the card (JAX is imported only by the test
that uses it)."""

import numpy as np
import pytest
import torch

from prot2text_tpu_torch.kernels.cache_update import (
    cache_slot_write_bkt, cache_slot_write_bkt_plain,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(L, B, Hkv, T, D, seed=0):
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal((L, B, Hkv, T, D)).astype(np.float32)
    new = rng.standard_normal((L, B, Hkv, D)).astype(np.float32)
    return cache, new


@pytest.mark.parametrize("index", [0, 13, 15])
def test_plain_matches_pallas_interpret(index):
    import jax.numpy as jnp

    from prot2text_tpu.kernels.cache_update import (
        cache_slot_write_bkt as j_write,
    )

    # the TPU kernel's shape rule: D=128, T % 8 == 0, B*Hkv % 8 == 0
    cache, new = _inputs(2, 4, 2, 16, 128)
    want = np.asarray(j_write(jnp.asarray(cache), jnp.asarray(new), index,
                              interpret=True))
    t_cache = torch.from_numpy(cache.copy())
    got = cache_slot_write_bkt(t_cache, torch.from_numpy(new), index)
    assert got is t_cache                      # in place
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [128, 16, 12])
def test_kernel_bit_exact_on_cuda(cuda, dtype, D):
    cache, new = (torch.from_numpy(a).to(cuda, dtype)
                  for a in _inputs(3, 4, 2, 40, D, seed=1))
    for index in (0, 17, 39):
        got = cache_slot_write_bkt(cache.clone(), new, index)
        want = cache_slot_write_bkt_plain(cache.clone(), new, index)
        assert torch.equal(got, want)
