"""K4 (decode attention + per-row slot write) and K9a (K4 plus a shared,
read-only prefix operand): the port's plain versions against the JAX
Pallas kernels in interpret mode (f32: attention atol 1e-5, the cache after
the write bit-exact); K9a against K4 on the same prefix physically
replicated into every row; the CUDA kernels against the plain versions on
the card (f32 1e-4, bf16 2e-2, caches bit-exact).  bf16 K2, K4 and K9a
share one column-split cluster body, so its edges on the card are held
here for all three (K2's plain-vs-JAX tests are in
test_torch_decode_attention.py)."""

import numpy as np
import pytest
import torch

from prot2text_tpu_torch.kernels.decode_attention import (
    decode_attention_stacked, decode_attention_stacked_plain,
    decode_attention_stacked_write, decode_attention_stacked_write_plain,
    decode_attention_stacked_write_prefix,
    decode_attention_stacked_write_prefix_plain,
)

ATOL = 1e-5
L, B, Hkv, T, Pc = 3, 4, 2, 32, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _slots(kind):
    return {"distinct": np.array([5, 17, 9, T - 1], np.int32),
            # every inactive serving row writes the scratch column T - 1
            "repeated": np.array([T - 1, 3, T - 1, T - 1], np.int32),
            "scalar": 12}[kind]


def _inputs(rep, D, slots, seed=0):
    rng = np.random.default_rng(seed)
    ck = rng.standard_normal((L, B, Hkv, T, D)).astype(np.float32)
    cv = rng.standard_normal((L, B, Hkv, T, D)).astype(np.float32)
    q = (rng.standard_normal((B, Hkv, rep, D)) * D ** -0.5).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    mask = rng.integers(0, 2, (B, T)).astype(np.int32)
    mask[-1] = 0                 # an empty cache row: only the new token
    mask[np.arange(B), np.broadcast_to(slots, (B,))] = 0   # slot unwritten
    pk = rng.standard_normal((L, 1, Hkv, Pc, D)).astype(np.float32)
    pv = rng.standard_normal((L, 1, Hkv, Pc, D)).astype(np.float32)
    # per-row prefix validity: full, left-padded, none (a full-prompt
    # request in a dedup pool), full
    pmask = np.ones((B, Pc), np.int32)
    pmask[1, :Pc // 2] = 0
    pmask[2] = 0
    return q, ck, cv, mask, kn, vn, pk, pv, pmask


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _slots_t(slots):
    return slots if isinstance(slots, int) else torch.from_numpy(slots)


CASES = [(1, 16), (4, 64), (5, 128)]


@pytest.mark.parametrize("rep,D", CASES)
@pytest.mark.parametrize("kind", ["distinct", "repeated", "scalar"])
def test_k4_plain_matches_pallas_interpret(rep, D, kind):
    import jax.numpy as jnp

    from prot2text_tpu.kernels.decode_attention import (
        decode_attention_stacked_write as j_write,
    )

    slots = _slots(kind)
    q, ck, cv, mask, kn, vn, *_ = _inputs(rep, D, slots)
    layer = 1
    wa, wk, wv = j_write(*(jnp.asarray(a) for a in (q, ck, cv, mask, kn,
                                                     vn)),
                         layer, jnp.asarray(slots), interpret=True)
    tq, tck, tcv, tmask, tkn, tvn = _torch(q, ck, cv, mask, kn, vn)
    got = decode_attention_stacked_write(tq, tck, tcv, tmask, tkn, tvn,
                                         layer, _slots_t(slots))
    np.testing.assert_allclose(got.numpy(), np.asarray(wa), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_array_equal(tck.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tcv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("rep,D", CASES)
@pytest.mark.parametrize("kind", ["distinct", "scalar"])
def test_k9a_plain_matches_pallas_interpret(rep, D, kind):
    import jax.numpy as jnp

    from prot2text_tpu.kernels.decode_attention import (
        decode_attention_stacked_write_prefix as j_write_p,
    )

    slots = _slots(kind)
    q, ck, cv, mask, kn, vn, pk, pv, pmask = _inputs(rep, D, slots, seed=1)
    layer = 2
    wa, wk, wv = j_write_p(
        *(jnp.asarray(a) for a in (q, ck, cv, mask, kn, vn)), layer,
        jnp.asarray(slots), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(pmask), interpret=True)
    tq, tck, tcv, tmask, tkn, tvn, tpk, tpv, tpm = _torch(
        q, ck, cv, mask, kn, vn, pk, pv, pmask)
    got = decode_attention_stacked_write_prefix(
        tq, tck, tcv, tmask, tkn, tvn, layer, _slots_t(slots), tpk, tpv, tpm)
    np.testing.assert_allclose(got.numpy(), np.asarray(wa), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_array_equal(tck.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tcv.numpy(), np.asarray(wv))


def test_k9a_equals_k4_on_replicated_prefix():
    """The prefix read as a shared operand equals the prefix physically
    seeded into every row's cache (slots shifted by Pc); a row whose pmask
    is all zero equals a prefix-free run."""
    slots = _slots("distinct")
    q, ck, cv, mask, kn, vn, pk, pv, pmask = _torch(
        *_inputs(4, 64, slots, seed=2))
    layer = 0
    ckr = torch.cat([pk.expand(L, B, -1, -1, -1), ck], dim=3)
    cvr = torch.cat([pv.expand(L, B, -1, -1, -1), cv], dim=3)
    ck0, cv0 = ck.clone(), cv.clone()
    want = decode_attention_stacked_write_plain(
        q, ckr, cvr, torch.cat([pmask, mask], dim=1), kn, vn, layer,
        torch.from_numpy(slots) + Pc)
    got = decode_attention_stacked_write_prefix_plain(
        q, ck, cv, mask, kn, vn, layer, torch.from_numpy(slots), pk, pv,
        pmask)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=ATOL)
    assert torch.equal(ck, ckr[:, :, :, Pc:]) and torch.equal(
        cv, cvr[:, :, :, Pc:])
    alone = decode_attention_stacked_write_plain(
        q, ck0, cv0, mask, kn, vn, layer, torch.from_numpy(slots))
    torch.testing.assert_close(got[2], alone[2], atol=ATOL, rtol=ATOL)


def test_masked_columns_never_leak_nan():
    """A stale or scratch column holding NaN takes no part when masked."""
    slots = _slots("repeated")
    q, ck, cv, mask, kn, vn, pk, pv, pmask = _torch(
        *_inputs(4, 16, slots, seed=3))
    for c in (ck, cv):            # (L, Hkv, B, T, D) view: mask is (B, T)
        c.permute(0, 2, 1, 3, 4)[:, :, mask == 0] = float("nan")
    pk[:, :, :, (pmask == 0).all(0)] = float("nan")
    a = decode_attention_stacked_write(q, ck, cv, mask, kn, vn, 1,
                                       torch.from_numpy(slots))
    assert torch.isfinite(a).all()
    a = decode_attention_stacked_write_prefix(
        q, ck, cv, mask, kn, vn, 1, torch.from_numpy(slots), pk, pv, pmask)
    assert torch.isfinite(a).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rep,D", [(5, 128), (4, 64), (8, 16)])
@pytest.mark.parametrize("prefix", [False, True])
def test_kernels_match_plain_on_cuda(cuda, dtype, atol, rep, D, prefix):
    slots = _slots("repeated")
    arrays = _inputs(rep, D, slots, seed=4)
    q, ck, cv, mask, kn, vn, pk, pv, pmask = (
        t.to(cuda) for t in _torch(*arrays))
    q, ck, cv, kn, vn, pk, pv = (t.to(dtype) for t in (q, ck, cv, kn, vn,
                                                        pk, pv))
    # a NaN in a masked column must not reach the kernel's output
    ck.permute(0, 2, 1, 3, 4)[:, :, mask == 0] = float("nan")
    s = torch.from_numpy(slots).to(cuda)
    for layer in (0, L - 1):
        gk, gv, wk, wv = ck.clone(), cv.clone(), ck.clone(), cv.clone()
        if prefix:
            got = decode_attention_stacked_write_prefix(
                q, gk, gv, mask, kn, vn, layer, s, pk, pv, pmask)
            want = decode_attention_stacked_write_prefix_plain(
                q.float(), wk, wv, mask, kn.float(), vn.float(), layer, s,
                pk.float(), pv.float(), pmask)
        else:
            got = decode_attention_stacked_write(q, gk, gv, mask, kn, vn,
                                                 layer, s)
            want = decode_attention_stacked_write_plain(
                q.float(), wk, wv, mask, kn.float(), vn.float(), layer, s)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want, atol=atol, rtol=atol)
        assert torch.equal(gk.nan_to_num(7.0), wk.nan_to_num(7.0))
        assert torch.equal(gv, wv)


@pytest.mark.cuda
def test_scalar_slot_and_launch_counts_on_cuda(cuda):
    q, ck, cv, mask, kn, vn, pk, pv, pmask = (
        t.to(cuda).to(torch.bfloat16) if t.is_floating_point() else
        t.to(cuda) for t in _torch(*_inputs(5, 128, 12, seed=5)))
    n4 = decode_attention_stacked_write.launches
    n9 = decode_attention_stacked_write_prefix.launches
    wk, wv = ck.clone(), cv.clone()
    decode_attention_stacked_write(q, ck, cv, mask, kn, vn, 1, 12)
    decode_attention_stacked_write_plain(q, wk, wv, mask, kn, vn, 1, 12)
    decode_attention_stacked_write_prefix(q, ck, cv, mask, kn, vn, 2, 12,
                                          pk, pv, pmask)
    decode_attention_stacked_write_prefix_plain(q, wk, wv, mask, kn, vn, 2,
                                                12, pk, pv, pmask)
    torch.cuda.synchronize()
    assert torch.equal(ck, wk) and torch.equal(cv, wv)
    assert decode_attention_stacked_write.launches == n4 + 1
    assert decode_attention_stacked_write_prefix.launches == n9 + 1


# the bf16 cluster body's edges: column tiles of 64 dealt to a cluster of 4
# blocks (tile i to block i mod 4); Pc 48 and T 80 give ragged tiles
EDGE_T, EDGE_PC = 80, 48


def _edge_inputs(rep, D, seed, T=EDGE_T, Pc=EDGE_PC, B=4):
    """Row 0: a fully masked cache span beside a valid prefix; row 1: an
    empty row (no prefix, no cache: only the current token); row 2: a
    valid cache window and a left-padded prefix; row 3: everything valid
    but the slot."""
    rng = np.random.default_rng(seed)
    ck = rng.standard_normal((L, B, Hkv, T, D)).astype(np.float32)
    cv = rng.standard_normal((L, B, Hkv, T, D)).astype(np.float32)
    q = (rng.standard_normal((B, Hkv, rep, D)) * D ** -0.5).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    pk = rng.standard_normal((L, 1, Hkv, Pc, D)).astype(np.float32)
    pv = rng.standard_normal((L, 1, Hkv, Pc, D)).astype(np.float32)
    slots = np.array([T - 1, T - 1, 37, 64], np.int32)
    mask = np.zeros((B, T), np.int32)
    mask[2, 5:37] = 1
    mask[3] = 1
    mask[np.arange(B), slots] = 0
    pmask = np.ones((B, Pc), np.int32)
    pmask[1] = 0
    pmask[2, :Pc - 20] = 0
    return q, ck, cv, mask, kn, vn, pk, pv, pmask, slots


@pytest.mark.parametrize("rep,D", CASES)
def test_k9a_plain_matches_pallas_interpret_at_edge_shapes(rep, D):
    import jax.numpy as jnp

    from prot2text_tpu.kernels.decode_attention import (
        decode_attention_stacked_write_prefix as j_write_p,
    )

    q, ck, cv, mask, kn, vn, pk, pv, pmask, slots = _edge_inputs(rep, D, 6)
    layer = 1
    wa, wk, wv = j_write_p(
        *(jnp.asarray(a) for a in (q, ck, cv, mask, kn, vn)), layer,
        jnp.asarray(slots), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(pmask), interpret=True)
    tq, tck, tcv, tmask, tkn, tvn, tpk, tpv, tpm = _torch(
        q, ck, cv, mask, kn, vn, pk, pv, pmask)
    got = decode_attention_stacked_write_prefix(
        tq, tck, tcv, tmask, tkn, tvn, layer, torch.from_numpy(slots), tpk,
        tpv, tpm)
    np.testing.assert_allclose(got.numpy(), np.asarray(wa), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_array_equal(tck.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tcv.numpy(), np.asarray(wv))
    # the empty row attends to its current token alone: o = v_new
    np.testing.assert_allclose(got[1].numpy(), np.broadcast_to(
        vn[1][:, None, :], got[1].shape), atol=ATOL, rtol=0)


@pytest.mark.parametrize("rep,D", [(1, 16), (5, 64), (8, 128)])
def test_k4_plain_matches_pallas_interpret_at_edge_shapes(rep, D):
    """K4 at the cluster body's edges without a prefix: T 80 off the tile
    grid, rows 0 and 1 with no valid cache column (o = v_new), row 2's
    valid columns in one 64-column tile, row 3 all valid; rows 0 and 1
    both write the scratch column T - 1."""
    import jax.numpy as jnp

    from prot2text_tpu.kernels.decode_attention import (
        decode_attention_stacked_write as j_write,
    )

    q, ck, cv, mask, kn, vn, _, _, _, slots = _edge_inputs(rep, D, 8)
    layer = 2
    wa, wk, wv = j_write(*(jnp.asarray(a) for a in (q, ck, cv, mask, kn,
                                                     vn)),
                         layer, jnp.asarray(slots), interpret=True)
    tq, tck, tcv, tmask, tkn, tvn = _torch(q, ck, cv, mask, kn, vn)
    got = decode_attention_stacked_write(tq, tck, tcv, tmask, tkn, tvn,
                                         layer, torch.from_numpy(slots))
    np.testing.assert_allclose(got.numpy(), np.asarray(wa), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_array_equal(tck.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tcv.numpy(), np.asarray(wv))
    for row in (0, 1):
        np.testing.assert_allclose(got[row].numpy(), np.broadcast_to(
            vn[row][:, None, :], got[row].shape), atol=ATOL, rtol=0)


def _split_case(case, D):
    """Operands for one edge of the cluster body at T 512 and Pc 128 (10
    tiles: block 0 gets tiles 0, 4, 8; block 1 tiles 1, 5, 9; blocks 2 and
    3 tiles 2, 6 and 3, 7)."""
    T, Pc, rep = 512, 128, 5
    q, ck, cv, mask, kn, vn, pk, pv, pmask, _ = _edge_inputs(
        rep, D, 10, T=T, Pc=Pc)
    rng = np.random.default_rng(11)
    mask = (rng.random((B, T)) < 0.7).astype(np.int32)
    pmask = np.ones((B, Pc), np.int32)
    slots = np.array([100, 200, 300, 400], np.int32)
    if case == "left_masked":
        # row 0 sees only cache columns 448-499 (tile 9): blocks 0, 2 and
        # 3 see nothing at all
        mask[0] = 0
        mask[0, 448:500] = 1
        pmask[0] = 0
    elif case == "pmask0":
        pmask[1] = 0
        pmask[3] = 0
    elif case == "repeated":
        slots = np.array([T - 1, 7, T - 1, T - 1], np.int32)
    # slot_live: kv_mask is 1 at every row's slot; the attention reads the
    # old value there and the write lands after it, as in the plain version
    mask[np.arange(B), slots] = int(case == "slot_live")
    return q, ck, cv, mask, kn, vn, pk, pv, pmask, slots


# (kernel, case) pairs of the split body on the card: K9a's prefix tiles
# beside the cache's; K4 and K2 without a prefix (K2 writes no slot)
SPLIT_CASES = (
    [("K9a", c) for c in ("left_masked", "pmask0", "repeated", "slot_live")]
    + [("K4", c) for c in ("left_masked", "repeated", "slot_live")]
    + [("K2", c) for c in ("left_masked", "repeated")])


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kernel,case", SPLIT_CASES)
def test_split_body_matches_plain_on_cuda(cuda, kernel, case, D):
    """bf16 K2, K4 and K9a on the column-split body against their plain
    versions: attention atol/rtol 2e-2, one launch a call, the written
    caches bit-exact (K4, K9a) or bit-unchanged (K2)."""
    q, ck, cv, mask, kn, vn, pk, pv, pmask, slots = (
        t.to(cuda) for t in _torch(*_split_case(case, D)))
    q, ck, cv, kn, vn, pk, pv = (t.to(torch.bfloat16)
                                 for t in (q, ck, cv, kn, vn, pk, pv))
    fn, plain, extra, extra_plain = {
        "K2": (decode_attention_stacked, decode_attention_stacked_plain,
               (), ()),
        "K4": (decode_attention_stacked_write,
               decode_attention_stacked_write_plain, (slots,), (slots,)),
        "K9a": (decode_attention_stacked_write_prefix,
                decode_attention_stacked_write_prefix_plain,
                (slots, pk, pv, pmask),
                (slots, pk.float(), pv.float(), pmask)),
    }[kernel]
    for layer in (0, L - 1):
        gk, gv, wk, wv = ck.clone(), cv.clone(), ck.clone(), cv.clone()
        n = fn.launches
        got = fn(q, gk, gv, mask, kn, vn, layer, *extra)
        torch.cuda.synchronize()
        assert fn.launches == n + 1
        want = plain(q.float(), wk, wv, mask, kn.float(), vn.float(), layer,
                     *extra_plain)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)
        assert torch.equal(gk, wk) and torch.equal(gv, wv)
        if kernel == "K2":
            assert torch.equal(gk, ck) and torch.equal(gv, cv)


# the split body's column limit: kMaxLocal (256) tiles a block x a cluster
# of 4 blocks (the rule) x 64 columns
SPLIT_LIMIT = 256 * 4 * 64


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K2", "K4"])
def test_split_body_limit_raises_past_it_on_cuda(cuda, kernel):
    """At the body's column limit bf16 K2/K4 run and match the plain
    version; one tile past it the wrapper raises, launching nothing and
    writing nothing: no fall-back to another body."""
    g = torch.Generator(device=cuda).manual_seed(0)
    for T in (SPLIT_LIMIT, SPLIT_LIMIT + 64):
        ck, cv = (torch.randn(1, 1, 1, T, 16, generator=g, device=cuda)
                  .to(torch.bfloat16) for _ in range(2))
        q, kn, vn = (torch.randn(*shape, generator=g, device=cuda)
                     .to(torch.bfloat16)
                     for shape in ((1, 1, 2, 16), (1, 1, 16), (1, 1, 16)))
        q = q * 0.25
        mask = (torch.rand(1, T, generator=g, device=cuda) < 0.01).to(
            torch.int32)
        slots = torch.tensor([T - 1], dtype=torch.int32, device=cuda)
        mask[0, T - 1] = 0
        ck0, cv0 = ck.clone(), cv.clone()
        if kernel == "K2":
            fn = decode_attention_stacked
            wk, wv = ck0, cv0

            def run():
                return fn(q, ck, cv, mask, kn, vn, 0)

            def plain():
                return decode_attention_stacked_plain(
                    q.float(), ck.float(), cv.float(), mask, kn.float(),
                    vn.float(), 0)
        else:
            fn = decode_attention_stacked_write
            wk, wv = ck.clone(), cv.clone()

            def run():
                return fn(q, ck, cv, mask, kn, vn, 0, slots)

            def plain():
                return decode_attention_stacked_write_plain(
                    q.float(), wk, wv, mask, kn.float(), vn.float(), 0,
                    slots)
        n = fn.launches
        if T == SPLIT_LIMIT:
            got = run()
            torch.cuda.synchronize()
            want = plain()
            torch.testing.assert_close(got.float(), want, atol=2e-2,
                                       rtol=2e-2)
            assert torch.equal(ck, wk) and torch.equal(cv, wv)
            assert fn.launches == n + 1
        else:
            with pytest.raises(RuntimeError, match="invalid argument"):
                run()
            torch.cuda.synchronize()
            assert fn.launches == n
            assert torch.equal(ck, ck0) and torch.equal(cv, cv0)
