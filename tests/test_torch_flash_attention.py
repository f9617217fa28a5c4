"""K1 (masked flash-attention forward): the port's plain version against the
JAX Pallas kernel in interpret mode, for o AND lse (f32, atol 1e-5); the
CUDA kernel against the plain version on the card (JAX is imported only
by the tests that use it, so the cuda tests also run where JAX is absent)."""

import numpy as np
import pytest
import torch

from prot2text_tpu_torch.kernels.flash_attention import (
    flash_attention_masked, flash_attention_masked_fwd,
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
    return q, k, v


def _jax_fwd(q, k, v, start, length, causal, block):
    import jax.numpy as jnp

    from prot2text_tpu.kernels.flash_attention import _flash_masked_fwd_impl
    from prot2text_tpu.models.transformer import repeat_kv as j_repeat_kv

    rep = q.shape[1] // k.shape[1]
    o, lse = _flash_masked_fwd_impl(
        jnp.asarray(q), j_repeat_kv(jnp.asarray(k), rep),
        j_repeat_kv(jnp.asarray(v), rep), jnp.asarray(start),
        jnp.asarray(length), causal, block, block, True)
    B, H, S, _ = q.shape
    lse = np.asarray(lse).reshape(B, H, -1)[:, :, :S]
    return np.asarray(o), lse


def _port_fwd(q, k, v, start, length, causal):
    o, lse = flash_attention_masked_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(start), torch.from_numpy(length), causal=causal)
    return o.numpy(), lse.numpy()


# left-padded ragged rows (start > 0), a right-padded row and a fully
# masked row (kv_len 0)
STARTS = np.array([0, 5, 11, 3], np.int32)
LENS = np.array([16, 11, 5, 0], np.int32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
def test_plain_matches_pallas_interpret(causal, H, Hkv):
    B, S, D = 4, 16, 16
    q, k, v = _inputs(B, H, Hkv, S, D)
    o_j, lse_j = _jax_fwd(q, k, v, STARTS, LENS, causal, block=8)
    o_t, lse_t = _port_fwd(q, k, v, STARTS, LENS, causal)
    np.testing.assert_allclose(o_t, o_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse_t, lse_j, atol=ATOL, rtol=ATOL)
    # the fully masked row: o exactly 0, lse = -1e30 + log(1)
    assert np.all(o_t[3] == 0.0)
    np.testing.assert_array_equal(lse_t[3], np.float32(-1e30))


def test_plain_matches_masked_flash_padded_nontileable():
    import jax.numpy as jnp

    from prot2text_tpu.kernels.attention import (
        masked_flash_padded as j_padded,
    )
    from prot2text_tpu.models.transformer import repeat_kv as j_repeat_kv

    B, H, Hkv, S, D = 3, 2, 1, 13, 16
    q, k, v = _inputs(B, H, Hkv, S, D, seed=1)
    start = np.array([0, 4, 9], np.int32)
    length = np.array([13, 9, 4], np.int32)
    o_j = j_padded(jnp.asarray(q), j_repeat_kv(jnp.asarray(k), H // Hkv),
                   j_repeat_kv(jnp.asarray(v), H // Hkv), start, length,
                   causal=True, interpret=True)
    o_t = flash_attention_masked(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(start), torch.from_numpy(length), causal=True)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL,
                               rtol=0)


def test_cpu_tensor_takes_plain_and_counts_no_launch():
    q, k, v = _inputs(1, 2, 1, 4, 16)
    before = flash_attention_masked_fwd.launches
    flash_attention_masked_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor([0], dtype=torch.int32),
        torch.tensor([4], dtype=torch.int32), causal=True)
    assert flash_attention_masked_fwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_on_cuda(cuda, dtype, atol, causal):
    dev = cuda
    B, H, Hkv, S, D = 4, 8, 2, 200, 128
    q, k, v = (torch.from_numpy(a).to(dev, dtype)
               for a in _inputs(B, H, Hkv, S, D, seed=2))
    start = torch.tensor([0, 37, 150, 0], dtype=torch.int32, device=dev)
    length = torch.tensor([200, 163, 50, 0], dtype=torch.int32, device=dev)
    o, lse = flash_attention_masked_fwd(q, k, v, start, length, causal=causal)
    o_ref, lse_ref = flash_attention_masked_plain(
        q.float(), k.float(), v.float(), start, length, causal)
    torch.testing.assert_close(o.float(), o_ref, atol=atol, rtol=atol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
