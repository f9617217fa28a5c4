"""K2 (grouped decode attention over the stacked cache): the port's plain
version against the JAX Pallas kernel in interpret mode (f32, atol 1e-5);
the CUDA kernel against the plain version on the card (JAX is imported
only by the test that uses it)."""

import numpy as np
import pytest
import torch

from prot2text_tpu_torch.kernels.decode_attention import (
    decode_attention_stacked, decode_attention_stacked_plain,
)

ATOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(L, B, Hkv, rep, T, D, seed=0):
    rng = np.random.default_rng(seed)
    ck = rng.standard_normal((L, B, Hkv, T, D)).astype(np.float32)
    cv = rng.standard_normal((L, B, Hkv, T, D)).astype(np.float32)
    q = (rng.standard_normal((B, Hkv, rep, D)) * D ** -0.5).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    mask = rng.integers(0, 2, (B, T)).astype(np.int32)
    mask[:, 0] = 1
    mask[-1] = 0             # an empty cache row: only the new token
    return q, ck, cv, mask, kn, vn


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("layer", [0, 2])
def test_plain_matches_pallas_interpret(rep, layer):
    import jax.numpy as jnp

    from prot2text_tpu.kernels.decode_attention import (
        decode_attention_stacked as j_decode,
    )

    arrays = _inputs(3, 4, 2, rep, 16, 128)
    want = j_decode(*(jnp.asarray(a) for a in arrays), layer, interpret=True)
    got = decode_attention_stacked(*(torch.from_numpy(a) for a in arrays),
                                   layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


def _edge_inputs(rep, D, seed, T=150, L=2, B=4, Hkv=2):
    """T off the 64-column tile grid.  Row 0: valid columns 70-120, all in
    one 64-column tile; row 1: no valid cache column (o = v_new); row 2: a
    left-padded window across tiles; row 3: every column valid, the ragged
    last tile included."""
    rng = np.random.default_rng(seed)
    ck = rng.standard_normal((L, B, Hkv, T, D)).astype(np.float32)
    cv = rng.standard_normal((L, B, Hkv, T, D)).astype(np.float32)
    q = (rng.standard_normal((B, Hkv, rep, D)) * D ** -0.5).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    mask = np.zeros((B, T), np.int32)
    mask[0, 70:121] = 1
    mask[2, 5:143] = 1
    mask[3] = 1
    return q, ck, cv, mask, kn, vn


@pytest.mark.parametrize("rep,D", [(1, 16), (5, 64), (8, 128)])
def test_k2_plain_matches_pallas_interpret_at_edge_shapes(rep, D):
    import jax.numpy as jnp

    from prot2text_tpu.kernels.decode_attention import (
        decode_attention_stacked as j_decode,
    )

    arrays = _edge_inputs(rep, D, seed=7)
    want = j_decode(*(jnp.asarray(a) for a in arrays), 1, interpret=True)
    got = decode_attention_stacked(*(torch.from_numpy(a) for a in arrays), 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    # the row with no valid cache column attends to its current token alone
    vn = arrays[-1]
    np.testing.assert_allclose(got[1].numpy(), np.broadcast_to(
        vn[1][:, None, :], got[1].shape), atol=ATOL, rtol=0)


def test_cache_is_read_only():
    arrays = [torch.from_numpy(a) for a in _inputs(2, 2, 2, 2, 8, 16)]
    before = [a.clone() for a in arrays]
    decode_attention_stacked(*arrays, 1)
    for a, b in zip(arrays, before):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rep,D", [(4, 128), (1, 64), (8, 16)])
def test_kernel_matches_plain_on_cuda(cuda, dtype, atol, rep, D):
    q, ck, cv, mask, kn, vn = (torch.from_numpy(a).to(cuda) for a in
                               _inputs(3, 4, 2, rep, 600, D, seed=3))
    q, ck, cv, kn, vn = (t.to(dtype) for t in (q, ck, cv, kn, vn))
    for layer in (0, 2):
        got = decode_attention_stacked(q, ck, cv, mask, kn, vn, layer)
        want = decode_attention_stacked_plain(
            q.float(), ck.float(), cv.float(), mask, kn.float(), vn.float(),
            layer)
        torch.testing.assert_close(got.float(), want, atol=atol, rtol=atol)
