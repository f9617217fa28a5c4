"""K1 (masked flash-attention forward): the port's plain version against the
JAX Pallas kernel in interpret mode, for o AND lse (f32, atol 1e-5); the
CUDA kernel against the plain version on the card (JAX is imported only
by the tests that use it, so the cuda tests also run where JAX is absent):
f32 runs the SIMT body, bf16 the tensor-core body of
csrc/flash_attention_fwd.cuh, whose edges (ragged Sq/Skv, every head dim,
GQA, Sq != Skv, strided views, empty rows, misaligned views) have their
own cases."""

import numpy as np
import pytest
import torch

from prot2text_tpu_torch.kernels.flash_attention import (
    _check_aligned, flash_attention_masked, flash_attention_masked_fwd,
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


def _bshd(rng, B, S, H, D, scale, dev):
    """A (B, H, S, D) bf16 view of a (B, S, H, D) buffer, as the decoder
    hands q/k/v over."""
    x = (rng.standard_normal((B, S, H, D)) * scale).astype(np.float32)
    return torch.from_numpy(x).to(dev, torch.bfloat16).transpose(1, 2)


# (B, H, Hkv, Sq, Skv, D, causal): Sq/Skv off the 64 and 16 grids, every
# head dim, GQA rep 1, 4 and 5, Sq != Skv both ways; batch row 2 has no key
K1_EDGES = [(3, 4, 4, 77, 77, 16, True), (3, 8, 2, 200, 200, 32, True),
            (3, 10, 2, 13, 13, 64, False), (3, 10, 2, 96, 150, 128, False),
            (3, 4, 1, 150, 96, 128, True), (3, 40, 8, 333, 333, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal", K1_EDGES)
def test_bf16_tensor_core_body_edges_on_cuda(cuda, B, H, Hkv, Sq, Skv, D,
                                             causal):
    rng = np.random.default_rng(Sq * 131 + D)
    q = _bshd(rng, B, Sq, H, D, D ** -0.5, cuda)
    k, v = (_bshd(rng, B, Skv, Hkv, D, 1.0, cuda) for _ in range(2))
    start = torch.tensor([0, min(9, Skv - 1), 3], dtype=torch.int32,
                         device=cuda)
    length = torch.tensor([Skv, Skv - 9 - Skv // 5, 0], dtype=torch.int32,
                          device=cuda).clamp(min=0)
    n = flash_attention_masked_fwd.launches
    o, lse = flash_attention_masked_fwd(q, k, v, start, length,
                                        causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_masked_fwd.launches == n + 1
    o_ref, lse_ref = flash_attention_masked_plain(
        q.float(), k.float(), v.float(), start, length, causal)
    torch.testing.assert_close(o.float(), o_ref, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
    # the row without keys: o exactly 0, lse exactly -1e30
    assert (o[2] == 0).all()
    assert (lse[2] == torch.tensor(-1e30, dtype=torch.float32)).all()


def _misaligned(buf, view, D):
    """(B, H, S, D) views of a (B, H, S, width) buffer: shifted one element
    off a 16-byte boundary, or with a row stride of 132 elements."""
    return buf[..., 1:D + 1] if view == "offset" else buf[..., :D]


def test_alignment_check_names_the_operand():
    """The bf16 wrappers' check (run on CUDA tensors before the launch)
    takes aligned views of (B, S, H, D) buffers and names a misaligned
    operand."""
    buf = torch.zeros(2, 17, 4, 132, dtype=torch.bfloat16)
    _check_aligned("K1", q=torch.zeros(2, 17, 4, 64,
                                       dtype=torch.bfloat16).transpose(1, 2))
    for view in ("offset", "row_stride"):
        bad = _misaligned(buf.transpose(1, 2), view, 128)
        with pytest.raises(ValueError, match="K1: bf16 k must be 16-byte"):
            _check_aligned("K1", q=buf[..., :128].contiguous(), k=bad)


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["offset", "row_stride"])
def test_bf16_misaligned_view_raises_on_cuda(cuda, view):
    """A bf16 view cp.async cannot copy raises before any launch; the f32
    SIMT body takes the same view."""
    B, H, S, D = 1, 2, 17, 128
    buf = torch.randn(B, H, S, D + 4, device=cuda)
    k = torch.randn(B, H, S, D, device=cuda)
    start = torch.zeros(B, dtype=torch.int32, device=cuda)
    length = torch.full((B,), S, dtype=torch.int32, device=cuda)
    n = flash_attention_masked_fwd.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_masked_fwd(
            _misaligned(buf.bfloat16(), view, D), k.bfloat16(), k.bfloat16(),
            start, length, causal=True)
    assert flash_attention_masked_fwd.launches == n
    q = _misaligned(buf, view, D)
    o, lse = flash_attention_masked_fwd(q, k, k, start, length, causal=True)
    o_ref, lse_ref = flash_attention_masked_plain(q, k, k, start, length,
                                                  True)
    torch.testing.assert_close(o, o_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)
