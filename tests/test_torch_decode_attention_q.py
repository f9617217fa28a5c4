"""The int8 KV cache: `quantize_kv` and `init_kv_cache(kv_bits=8)` against
the JAX package, and K7, K9b (one token per row) and K8, K9c (a G-token
speculative chunk per row), whose plain versions are held against the JAX
Pallas kernels in interpret mode (f32 qg: attention atol 1e-5; int8 caches
and scales bit-exact after the write), also at the split body's edges (T
off the 64-column grid, a row with no cache column and its prefix gated
off, inactive rows on one scratch slot), with the prefix and without it;
K9b/K9c against K7/K8 on the same prefix physically placed in the cache;
the route rule `int8_split_route`; the CUDA kernels against the plain
versions on the card (bf16 2e-2, caches and scales bit-exact): both
bodies, and bf16 K7-K9c on the cluster-split body (K7/K8 over CacheCols,
K9b/K9c over PrefixCols) at the serving shape, every rep and G the rule
takes, its edges, K7 at the lockstep shape with a scalar slot, two
launches bit-identical, the route by the profiler's kernel names, and the
column limit."""

import re

import numpy as np
import pytest
import torch

from prot2text_tpu_torch.infer.kvcache import init_kv_cache
from prot2text_tpu_torch.kernels.decode_attention import (
    SPLIT_ROWS, decode_attention_stacked_verify_qc,
    decode_attention_stacked_verify_qc_plain,
    decode_attention_stacked_verify_qc_prefix,
    decode_attention_stacked_verify_qc_prefix_plain,
    decode_attention_stacked_write_q, decode_attention_stacked_write_q_plain,
    decode_attention_stacked_write_q_prefix,
    decode_attention_stacked_write_q_prefix_plain, int8_split_route,
)
from prot2text_tpu_torch.models.decoder import DecoderConfig
from prot2text_tpu_torch.models.quant import quantize_kv

ATOL = 1e-5
L, B, Hkv, T = 2, 4, 2, 96


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def test_quantize_kv_bit_exact_with_jax():
    """Values and scales bit-exact, with an all-zero vector (scale
    1e-8/127, values 0) and exact .5 ties (round half to even)."""
    import jax.numpy as jnp

    from prot2text_tpu.models.quant import quantize_kv as j_quantize

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 2, 5, 64)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0
    # max |x| = 127 → scale 1, so x/scale lands on exact .5 ties
    x[1, 1, 2] = np.linspace(-127, 127, 64).astype(np.float32)
    x[1, 1, 2, :6] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5]
    x[1, 1, 2, 6] = 127.0
    q, s = quantize_kv(torch.from_numpy(x))
    jq, js = j_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.float32 and s.shape == (3, 2, 5)
    np.testing.assert_array_equal(q[1, 1, 2, :6].numpy(),
                                  [0, 2, 2, -0, -2, -2])
    assert (q[0, 0, 0] == 0).all() and s[0, 0, 0] == np.float32(1e-8) / 127


def test_init_kv_cache_int8():
    cfg = DecoderConfig(vocab_size=8, hidden_size=16, num_layers=3,
                        num_heads=4, num_kv_heads=2, intermediate_size=32,
                        head_dim=64)
    c = init_kv_cache(cfg, 2, 64, device="cpu", dtype=torch.bfloat16,
                      kv_bits=8)
    assert set(c) == {"k", "v", "k_scale", "v_scale"}
    for n in ("k", "v"):
        assert c[n].dtype == torch.int8 and c[n].shape == (3, 2, 2, 64, 64)
        assert (c[n] == 0).all()
    for n in ("k_scale", "v_scale"):
        assert c[n].dtype == torch.float32 and c[n].shape == (3, 2, 2, 64)
        assert (c[n] == 1.0).all()
    with pytest.raises(ValueError, match="kv_bits"):
        init_kv_cache(cfg, 2, 64, device="cpu", kv_bits=4)


def _cache(rng, D, Pc, T=T, B=B, Hkv=Hkv):
    """An int8 pool and prefix with positive per-column scales."""
    ck = rng.integers(-127, 128, (L, B, Hkv, T, D)).astype(np.int8)
    cv = rng.integers(-127, 128, (L, B, Hkv, T, D)).astype(np.int8)
    sk = rng.uniform(0.002, 0.03, (L, B, Hkv, T)).astype(np.float32)
    sv = rng.uniform(0.002, 0.03, (L, B, Hkv, T)).astype(np.float32)
    pk = rng.integers(-127, 128, (L, 1, Hkv, Pc, D)).astype(np.int8)
    pv = rng.integers(-127, 128, (L, 1, Hkv, Pc, D)).astype(np.int8)
    psk = rng.uniform(0.002, 0.03, (L, 1, Hkv, Pc)).astype(np.float32)
    psv = rng.uniform(0.002, 0.03, (L, 1, Hkv, Pc)).astype(np.float32)
    # per-row prefix validity: full, left-padded, none (a full-prompt
    # request in a dedup pool), full
    pmask = np.ones((B, Pc), np.int32)
    pmask[1:2, :Pc // 2] = 0
    pmask[2:3] = 0
    return [ck, cv, sk, sv], [pk, pv, psk, psv, pmask]


def _new(rng, rep, D, G, B=B, Hkv=Hkv):
    """qg (B, Hkv, G·rep, D) pre-scaled f32 and the chunk's quantized
    k/v (B, Hkv, G[, D]) from `quantize_kv`.  qg holds multiples of 2^-8,
    so every q·k_int is exact in fp32 whatever the summation order: the
    two frameworks' logits agree bit for bit, and the bf16 rounding of the
    weights cannot flip on an order-of-summation difference."""
    q = np.round(rng.standard_normal((B, Hkv, G * rep, D)) * D ** -0.5
                 * 256).astype(np.float32) / 256
    kq, ks = quantize_kv(torch.from_numpy(
        rng.standard_normal((B, Hkv, G, D)).astype(np.float32)))
    vq, vs = quantize_kv(torch.from_numpy(
        rng.standard_normal((B, Hkv, G, D)).astype(np.float32)))
    return q, [kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy()]


def _mask(rng, starts, G):
    mask = rng.integers(0, 2, (B, T)).astype(np.int32)
    mask[-1] = 0                 # an empty cache row: only the new tokens
    for b, s in enumerate(np.broadcast_to(starts, (B,))):
        mask[b, s:s + G] = 0     # the written columns are still unwritten
    return mask


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(arrays):
    import jax.numpy as jnp

    return [jnp.asarray(a) for a in arrays]


def _check(got, want, caches):
    np.testing.assert_allclose(got.numpy(), np.asarray(want[0]), atol=ATOL,
                               rtol=ATOL)
    for t, w in zip(caches, want[1:]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


SLOTS = {"distinct": np.array([5, 40, 9, 63], np.int32),
         # every inactive serving row writes the scratch column
         "repeated": np.array([T - 1, 3, T - 1, T - 1], np.int32),
         "scalar": 12}


@pytest.mark.parametrize("rep,D", [(1, 64), (5, 128)])
@pytest.mark.parametrize("kind", ["distinct", "repeated", "scalar"])
def test_k7_plain_matches_pallas_interpret(rep, D, kind):
    from prot2text_tpu.kernels.decode_attention import (
        decode_attention_stacked_write_q as j_k7,
    )

    rng = np.random.default_rng([rep, D, len(kind)])
    slots = SLOTS[kind]
    cache, _ = _cache(rng, D, 32)
    q, new = _new(rng, rep, D, 1)
    new = [new[0][:, :, 0], new[1][:, :, 0], new[2][:, :, 0],
           new[3][:, :, 0]]
    mask = _mask(rng, slots, 1)
    layer = 1
    want = j_k7(*_j([q, *cache, mask, *new]), layer, np.asarray(slots),
                interpret=True)
    tc = _t(cache)
    got = decode_attention_stacked_write_q(
        torch.from_numpy(q), *tc, torch.from_numpy(mask), *_t(new), layer,
        slots if kind == "scalar" else torch.from_numpy(slots))
    _check(got, want, tc)


@pytest.mark.parametrize("rep,D,Pc", [(1, 64, 32), (5, 128, 128),
                                      (5, 64, 32)])
@pytest.mark.parametrize("kind", ["distinct", "scalar"])
def test_k9b_plain_matches_pallas_interpret(rep, D, Pc, kind):
    from prot2text_tpu.kernels.decode_attention import (
        decode_attention_stacked_write_q_prefix as j_k9b,
    )

    rng = np.random.default_rng([rep, D, Pc, len(kind)])
    slots = SLOTS[kind]
    cache, prefix = _cache(rng, D, Pc)
    q, new = _new(rng, rep, D, 1)
    new = [x[:, :, 0] for x in new]
    mask = _mask(rng, slots, 1)
    layer = 0
    want = j_k9b(*_j([q, *cache, mask, *new]), layer, np.asarray(slots),
                 *_j(prefix), interpret=True)
    tc = _t(cache)
    got = decode_attention_stacked_write_q_prefix(
        torch.from_numpy(q), *tc, torch.from_numpy(mask), *_t(new), layer,
        slots if kind == "scalar" else torch.from_numpy(slots),
        *_t(prefix))
    _check(got, want, tc)


def _placed(cache, prefix, mask):
    """The prefix physically placed in front of every row's cache."""
    ck, cv, sk, sv = cache
    pk, pv, psk, psv, pmask = prefix
    cat = [torch.cat([p.expand(L, B, *p.shape[2:]), c], dim=3)
           for p, c in ((pk, ck), (pv, cv), (psk, sk), (psv, sv))]
    return cat, torch.cat([pmask, mask], dim=1)


@pytest.mark.parametrize("G", [1, 5])
def test_prefix_variants_equal_placed_prefix(G):
    """K9b/K9c on a prefix read as a shared operand equal K7/K8 on the
    same prefix physically placed in the cache (slots shifted by Pc), and
    write the same cache columns."""
    rng = np.random.default_rng(G)
    Pc = 32
    cache, prefix = _cache(rng, 64, Pc)
    q, new = _new(rng, 5, 64, G)
    slots = np.array([5, 40, 9, 60], np.int32)
    mask = torch.from_numpy(_mask(rng, slots, G))
    tc, tp = _t(cache), _t(prefix)
    placed, pmask = _placed(tc, tp, mask)
    tq, tn = torch.from_numpy(q), _t(new)
    s = torch.from_numpy(slots)
    if G == 1:
        tn = [x[:, :, 0] for x in tn]
        got = decode_attention_stacked_write_q_prefix_plain(
            tq, *tc, mask, *tn, 1, s, *tp)
        want = decode_attention_stacked_write_q_plain(
            tq, *placed, pmask, *tn, 1, s + Pc)
    else:
        got = decode_attention_stacked_verify_qc_prefix_plain(
            tq, *tc, mask, *tn, 1, s, *tp)
        want = decode_attention_stacked_verify_qc_plain(
            tq, *placed, pmask, *tn, 1, s + Pc)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=ATOL)
    for c, p in zip(tc, placed):
        assert torch.equal(c, p[:, :, :, Pc:])


# chunk starts: distinct; one crossing a 32-column boundary (30 + G);
# inactive rows on the scratch tail T - 64 (the serving engine's rule)
VERIFY_SLOTS = np.array([5, 30, T - 64, T - 64], np.int32)


@pytest.mark.parametrize("G", [2, 5, 8])
@pytest.mark.parametrize("rep,D", [(1, 64), (5, 128)])
def test_k8_plain_matches_pallas_interpret(G, rep, D):
    from prot2text_tpu.kernels.decode_attention import (
        decode_attention_stacked_verify_qc as j_k8,
    )

    rng = np.random.default_rng(100 * G + rep)
    cache, _ = _cache(rng, D, 32)
    q, new = _new(rng, rep, D, G)
    mask = _mask(rng, VERIFY_SLOTS, G)
    layer = 1
    want = j_k8(*_j([q, *cache, mask, *new]), layer,
                np.asarray(VERIFY_SLOTS), interpret=True)
    tc = _t(cache)
    got = decode_attention_stacked_verify_qc(
        torch.from_numpy(q), *tc, torch.from_numpy(mask), *_t(new), layer,
        torch.from_numpy(VERIFY_SLOTS))
    _check(got, want, tc)


@pytest.mark.parametrize("G,Pc", [(2, 32), (5, 128), (8, 32)])
def test_k9c_plain_matches_pallas_interpret(G, Pc):
    from prot2text_tpu.kernels.decode_attention import (
        decode_attention_stacked_verify_qc_prefix as j_k9c,
    )

    rng = np.random.default_rng(7 * G + Pc)
    cache, prefix = _cache(rng, 128, Pc)
    q, new = _new(rng, 5, 128, G)
    mask = _mask(rng, VERIFY_SLOTS, G)
    layer = 0
    want = j_k9c(*_j([q, *cache, mask, *new]), layer,
                 np.asarray(VERIFY_SLOTS), *_j(prefix), interpret=True)
    tc = _t(cache)
    got = decode_attention_stacked_verify_qc_prefix(
        torch.from_numpy(q), *tc, torch.from_numpy(mask), *_t(new), layer,
        torch.from_numpy(VERIFY_SLOTS), *_t(prefix))
    _check(got, want, tc)


def test_chunk_past_the_cache_raises():
    rng = np.random.default_rng(3)
    cache, _ = _cache(rng, 64, 32)
    q, new = _new(rng, 1, 64, 4)
    with pytest.raises(ValueError, match="written columns"):
        decode_attention_stacked_verify_qc(
            torch.from_numpy(q), *_t(cache),
            torch.zeros((B, T), dtype=torch.int32), *_t(new), 0,
            torch.tensor([0, 0, 0, T - 3], dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("G,rep,D", [(1, 5, 128), (1, 8, 64), (5, 5, 128),
                                     (8, 5, 128), (3, 1, 16)])
@pytest.mark.parametrize("prefix", [False, True])
def test_kernels_match_plain_on_cuda(cuda, G, rep, D, prefix):
    """bf16 qg: attention within 2e-2 of the fp32 plain version on the same
    inputs; int8 caches and scales bit-exact after the write."""
    rng = np.random.default_rng(11 * G + D)
    cache, pfx = _cache(rng, D, 32)
    q, new = _new(rng, rep, D, G)
    slots = VERIFY_SLOTS if G > 1 else SLOTS["repeated"]
    mask = torch.from_numpy(_mask(rng, slots, G)).to(cuda)
    tn = [t.to(cuda) for t in _t(new)]
    if G == 1:
        tn = [x[:, :, 0].contiguous() for x in tn]
    tq = torch.from_numpy(q).to(cuda)
    tp = [t.to(cuda) for t in _t(pfx)]
    s = torch.from_numpy(slots).to(cuda)
    kern = {(1, False): decode_attention_stacked_write_q,
            (1, True): decode_attention_stacked_write_q_prefix,
            (0, False): decode_attention_stacked_verify_qc,
            (0, True): decode_attention_stacked_verify_qc_prefix}[
                (int(G == 1), prefix)]
    plain = {(1, False): decode_attention_stacked_write_q_plain,
             (1, True): decode_attention_stacked_write_q_prefix_plain,
             (0, False): decode_attention_stacked_verify_qc_plain,
             (0, True): decode_attention_stacked_verify_qc_prefix_plain}[
                 (int(G == 1), prefix)]
    for layer in (0, L - 1):
        gc = [t.to(cuda) for t in _t(cache)]
        wc = [t.clone() for t in gc]
        n0 = kern.launches
        got = kern(tq.bfloat16(), *gc, mask, *tn, layer, s,
                   *(tp if prefix else ()))
        torch.cuda.synchronize()
        assert kern.launches == n0 + 1
        want = plain(tq.bfloat16().float(), *wc, mask, *tn, layer, s,
                     *(tp if prefix else ()))
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)
        for a, b in zip(gc, wc):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the route rule and the split body's edges (CPU), then bf16 K9b/K9c on the
# cluster-split body (card)

@pytest.mark.parametrize("dtype,rows,prefix,split", [
    (torch.bfloat16, 5, True, True),       # K9b at the serving shape
    (torch.bfloat16, 25, True, True),      # K9c at G 5, rep 5
    (torch.bfloat16, SPLIT_ROWS, True, True),
    (torch.bfloat16, SPLIT_ROWS + 1, True, False),
    (torch.bfloat16, 40, True, False),     # K9c at G 5, rep 8
    (torch.bfloat16, 5, False, True),      # K7 at the serving shape
    (torch.float32, 5, True, False),       # f32 K9b/K9c: the SIMT body
    (torch.bfloat16, 25, False, True),     # K8 at G 5, rep 5
    (torch.bfloat16, SPLIT_ROWS, False, True),
    (torch.bfloat16, SPLIT_ROWS + 1, False, False),
    (torch.float32, 5, False, False),      # f32 K7/K8: the SIMT body
])
def test_int8_split_route(dtype, rows, prefix, split):
    assert int8_split_route(dtype, rows, prefix) is split


def test_sweep_decode_split_times_the_split_body():
    """Every (G, rep) that scripts/sweep_decode_split.py times takes the
    split body, with the prefix and without it, across 1, 2 and 4 row
    fragments."""
    from prot2text_tpu_torch.scripts import sweep_decode_split as sweep

    rows = [G * rep for G, rep in sweep.ROWS]
    assert all(int8_split_route(torch.bfloat16, r, p) for r in rows
               for p in (True, False))
    assert [sweep.name(G, p) for G in (1, 5) for p in (True, False)] == [
        "K9b", "K7", "K9c", "K8"]
    assert {-(-r // 8) for r in rows} >= {1, 2, 4}
    with pytest.raises(SystemExit, match="--device cuda"):
        sweep.main(["--device", "cpu"])


EDGE_T = 544                 # off the 64-column grid (the TPU kernels take
                             # 32-row groups); 9 cache tiles


def _edge_case(rng, rep, D, G, Pc):
    """The split body's edges at T 544: row 0 sees only cache columns
    448-499 (one tile: three of a cluster's four blocks see nothing), row
    1 no cache column and its prefix gated off (only the current columns),
    rows 2 and 3 inactive on one scratch slot (T - 1 decode, T - 64
    verify, the engine's rules)."""
    T_ = EDGE_T
    cache, prefix = _cache(rng, D, Pc, T=T_)
    q, new = _new(rng, rep, D, G)
    mask = rng.integers(0, 2, (B, T_)).astype(np.int32)
    mask[0] = 0
    mask[0, 448:500] = 1
    mask[1] = 0
    prefix[4][0] = 0
    prefix[4][1] = 0
    slots = np.array([100, 7, 0, 0], np.int32)
    slots[2:] = T_ - 1 if G == 1 else T_ - 64
    for b, s in enumerate(slots):
        mask[b, s:s + G] = 0
    return cache, prefix, q, new, mask, slots


EDGE_SHAPES = ((1, 5, 128), (1, 1, 64), (5, 5, 128), (3, 2, 64),
               (4, 4, 128))


@pytest.mark.parametrize("G,rep,D,prefix", [
    pytest.param(G, rep, D, True, id=f"{G}-{rep}-{D}")
    for G, rep, D in EDGE_SHAPES] + [
    pytest.param(G, rep, D, False, id=f"{G}-{rep}-{D}-no_prefix")
    for G, rep, D in EDGE_SHAPES])
def test_prefix_variants_plain_match_pallas_interpret_at_edges(G, rep, D,
                                                               prefix):
    """K9b (G 1) and K9c plain versions, and without the prefix K7 and K8,
    against the Pallas kernels in interpret mode at the split body's edges
    (T 544, G·rep 1-25); the row with nothing but its current columns
    gets exactly their mix."""
    from prot2text_tpu.kernels import decode_attention as jda

    rng = np.random.default_rng([G, rep, D, 9])
    Pc = 64
    cache, pfx, q, new, mask, slots = _edge_case(rng, rep, D, G, Pc)
    layer = 1
    if G == 1:
        new = [x[:, :, 0] for x in new]
    j_fn, fn = {
        (1, True): (jda.decode_attention_stacked_write_q_prefix,
                    decode_attention_stacked_write_q_prefix),
        (1, False): (jda.decode_attention_stacked_write_q,
                     decode_attention_stacked_write_q),
        (0, True): (jda.decode_attention_stacked_verify_qc_prefix,
                    decode_attention_stacked_verify_qc_prefix),
        (0, False): (jda.decode_attention_stacked_verify_qc,
                     decode_attention_stacked_verify_qc)}[(int(G == 1),
                                                           prefix)]
    pfx = pfx if prefix else []
    want = j_fn(*_j([q, *cache, mask, *new]), layer, np.asarray(slots),
                *_j(pfx), interpret=True)
    tc = _t(cache)
    got = fn(torch.from_numpy(q), *tc, torch.from_numpy(mask), *_t(new),
             layer, torch.from_numpy(slots), *_t(pfx))
    _check(got, want, tc)
    # row 1: [chunk columns] only, causal by token
    kq, vq, ks, vs = (torch.from_numpy(np.array(x)) for x in new)
    if G == 1:
        kq, vq, ks, vs = kq[:, :, None], vq[:, :, None], ks[:, :, None], \
            vs[:, :, None]
    qr = torch.from_numpy(q)[1]                          # (Hkv, G·rep, D)
    if G == 1:
        ln = torch.einsum("krd,kgd->krg", qr, kq[1] * ks[1][..., None])
    else:
        ln = torch.einsum("krd,kgd->krg", qr, kq[1]) * ks[1][:, None, :]
    vis = (torch.arange(G)[None, :] <= torch.arange(G * rep)[:, None] // rep)
    w = torch.softmax(torch.where(vis, ln, -torch.inf), dim=-1)
    only = torch.einsum("krg,kgd->krd", w * vs[1][:, None, :], vq[1])
    torch.testing.assert_close(got[1], only, atol=ATOL, rtol=ATOL)


def _to(dev, arrays):
    return [torch.from_numpy(np.array(a)).to(dev) for a in arrays]


def _run_split(cuda, G, cache, prefix, q, new, mask, slots, layer,
               with_prefix=True):
    """bf16 K9b (G 1) or K9c, or without the prefix K7 or K8, on the card
    twice, on two copies of the caches, and the plain version in f32 on
    the same values: the two launches' outputs and whole caches
    bit-identical, the kernel's caches bit-exact against the plain
    version's, the attention within 2e-2.  `slots` may be a scalar (K7's
    lockstep slot).  Returns max|kernel - plain|."""
    if G == 1:
        new = [x[:, :, 0] for x in new]
    kern, plain = {
        (1, True): (decode_attention_stacked_write_q_prefix,
                    decode_attention_stacked_write_q_prefix_plain),
        (1, False): (decode_attention_stacked_write_q,
                     decode_attention_stacked_write_q_plain),
        (0, True): (decode_attention_stacked_verify_qc_prefix,
                    decode_attention_stacked_verify_qc_prefix_plain),
        (0, False): (decode_attention_stacked_verify_qc,
                     decode_attention_stacked_verify_qc_plain)}[
                         (int(G == 1), with_prefix)]
    tq = torch.from_numpy(q).to(cuda).bfloat16()
    tn = _to(cuda, new)
    tp = _to(cuda, prefix) if with_prefix else []
    tm = torch.from_numpy(mask).to(cuda)
    ts = (int(slots) if np.ndim(slots) == 0
          else torch.from_numpy(slots).to(cuda))
    runs = []
    for _ in range(2):
        gc = _to(cuda, cache)
        n0 = kern.launches
        a = kern(tq, *gc, tm, *tn, layer, ts, *tp)
        torch.cuda.synchronize()
        assert kern.launches == n0 + 1
        runs.append((a, gc))
    (a, gc), (a2, gc2) = runs
    assert torch.equal(a, a2)
    assert all(torch.equal(x, y) for x, y in zip(gc, gc2))
    wc = _to(cuda, cache)
    want = plain(tq.float(), *wc, tm, *tn, layer, ts, *tp)
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a.float(), want, atol=2e-2, rtol=2e-2)
    assert all(torch.equal(x, y) for x, y in zip(gc, wc))
    return (a.float() - want).abs().max().item()


def _name(G, prefix):
    return {(1, True): "K9b", (1, False): "K7", (0, True): "K9c",
            (0, False): "K8"}[(int(G == 1), prefix)]


@pytest.mark.cuda
@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("G", [1, 5])
def test_int8_split_body_at_the_serving_shape_on_cuda(cuda, G, prefix):
    """Qwen3-14B's int8 serving shape (B 8, Hkv 8, rep 5, D 128, T 1856,
    535 valid cache columns a row, rows 6-7 on one scratch slot; with the
    prefix Pc 256 with 250 real columns, row 6 gated off), one launch a
    call: K7/K8 without the prefix, K9b/K9c with it."""
    rng = np.random.default_rng(15 + G)
    B_, Hkv_, rep, D, T_, Pc = 8, 8, 5, 128, 1856, 256
    cache, pfx = _cache(rng, D, Pc, T=T_, B=B_, Hkv=Hkv_)
    pfx[4][:] = (np.arange(Pc) >= Pc - 250).astype(np.int32)
    pfx[4] = np.broadcast_to(pfx[4][:1], (B_, Pc)).copy()
    pfx[4][6] = 0
    q, new = _new(rng, rep, D, G, B=B_, Hkv=Hkv_)
    pads = np.array([0, 37, 100, 250, 5, 0, 60, 200])
    cols = np.arange(T_)
    mask = ((cols >= pads[:, None]) & (cols < pads[:, None] + 535)).astype(
        np.int32)
    slots = (pads + 535).astype(np.int32)
    slots[6:] = T_ - 1 if G == 1 else T_ - 64
    err = _run_split(cuda, G, cache, pfx, q, new, mask, slots, L - 1,
                     prefix)
    print(f"{_name(G, prefix)} serving shape: max|a-plain| {err:.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("rep", [1, 2, 3, 4, 5, 6, 7, 8])
def test_int8_split_body_every_rep_and_chunk_on_cuda(cuda, rep, prefix):
    """rep 1-8 and G 1-6 wherever G·rep <= SPLIT_ROWS (1, 2 and 4 row
    fragments), D 64 and 128, at the split body's edges, with the prefix
    (K9b/K9c) and without it (K7/K8: row 0's one live tile is the folding
    block's)."""
    for G in range(1, 7):
        if G * rep > SPLIT_ROWS:
            continue
        for D in (64, 128):
            rng = np.random.default_rng([rep, G, D])
            cache, pfx, q, new, mask, slots = _edge_case(rng, rep, D, G, 64)
            err = _run_split(cuda, G, cache, pfx, q, new, mask, slots, 0,
                             prefix)
            print(f"{_name(G, prefix)} rep {rep} G {G} D {D}: "
                  f"max|a-plain| {err:.3e}")


@pytest.mark.cuda
def test_int8_split_body_lockstep_scalar_slot_on_cuda(cuda):
    """K7 at Llama-3.1-8B's lockstep shape (B 4, Hkv 8, rep 4, D 128, T
    1280: 32 clusters, one block an SM): one scalar slot broadcast to
    every row, left-padded prompts, every column before the slot valid;
    and at a short T of 128 (2 tiles: two of a cluster's blocks own none,
    the folding block among them)."""
    for B_, T_, pos, pads in ((4, 1280, 1100, (0, 17, 250, 3)),
                              (4, 128, 90, (0, 5, 60, 89))):
        rng = np.random.default_rng(T_)
        cache, pfx = _cache(rng, 128, 64, T=T_, B=B_, Hkv=8)
        q, new = _new(rng, 4, 128, 1, B=B_, Hkv=8)
        cols = np.arange(T_)
        mask = ((cols >= np.array(pads)[:, None]) & (cols < pos)).astype(
            np.int32)
        err = _run_split(cuda, 1, cache, pfx, q, new, mask, np.int32(pos),
                         L - 1, False)
        print(f"K7 lockstep B {B_} T {T_} slot {pos}: max|a-plain| "
              f"{err:.3e}")


@pytest.mark.cuda
def test_int8_route_by_kernel_name_on_cuda(cuda):
    """The profiler names the body each call ran: bf16 K7/K8 inside the
    rule the split body's CacheCols + Int8Cache instantiation, K9b/K9c its
    PrefixCols + Int8Cache one; past SPLIT_ROWS rows, and f32 q, the SIMT
    body."""
    from torch.profiler import ProfilerActivity, profile

    for G, rep, dtype, prefix in ((1, 5, torch.bfloat16, True),
                                  (5, 5, torch.bfloat16, True),
                                  (4, 8, torch.bfloat16, True),
                                  (5, 7, torch.bfloat16, True),
                                  (5, 5, torch.float32, True),
                                  (5, 5, torch.bfloat16, False),
                                  (1, 5, torch.bfloat16, False),
                                  (4, 8, torch.bfloat16, False),
                                  (5, 7, torch.bfloat16, False),
                                  (5, 5, torch.float32, False),
                                  (1, 5, torch.float32, False)):
        rng = np.random.default_rng(G * rep)
        cache, pfx, q, new, mask, slots = _edge_case(rng, rep, 64, G, 64)
        if G == 1:
            new = [x[:, :, 0] for x in new]
        kern = {(1, True): decode_attention_stacked_write_q_prefix,
                (1, False): decode_attention_stacked_write_q,
                (0, True): decode_attention_stacked_verify_qc_prefix,
                (0, False): decode_attention_stacked_verify_qc}[
                    (int(G == 1), prefix)]
        args = (torch.from_numpy(q).to(cuda).to(dtype), *_to(cuda, cache),
                torch.from_numpy(mask).to(cuda), *_to(cuda, new), 0,
                torch.from_numpy(slots).to(cuda),
                *(_to(cuda, pfx) if prefix else ()))
        kern(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            kern(*args)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        split = int8_split_route(dtype, G * rep, prefix)
        assert split == (dtype == torch.bfloat16 and G * rep <= SPLIT_ROWS)
        cols = "PrefixCols" if prefix else "CacheCols"
        want = (rf"decode_split_kernel.*{cols}.*Int8Cache" if split
                else "decode_attention_q_kernel")
        assert any(re.search(want, n) for n in names), (G, rep, dtype,
                                                         prefix, names)
        assert not any(("decode_split_kernel" in n) != split for n in names
                       if "decode" in n), names


@pytest.mark.cuda
@pytest.mark.parametrize("prefix", [False, True])
def test_int8_split_body_column_limit_on_cuda(cuda, prefix):
    """At the body's column limit (1024 tiles, 256 a block: Pc 64 + T
    65472 for K9c, T 65536 for K8) the kernel runs and matches the plain
    version; one tile past it the wrapper raises, launching nothing and
    writing nothing."""
    kern = (decode_attention_stacked_verify_qc_prefix if prefix
            else decode_attention_stacked_verify_qc)
    limit = 256 * 4 * 64
    Pc = 64 if prefix else 0
    for T_ in (limit - Pc, limit - Pc + 64):
        rng = np.random.default_rng(T_)
        Hkv_, B_, D, G, rep = 1, 1, 16, 2, 3
        cache, pfx = _cache(rng, D, 64, T=T_, B=B_, Hkv=Hkv_)
        q, new = _new(rng, rep, D, G, B=B_, Hkv=Hkv_)
        mask = (rng.random((B_, T_)) < 0.01).astype(np.int32)
        slots = np.array([T_ - 64], np.int32)
        mask[:, T_ - 64:T_ - 64 + G] = 0
        if T_ + Pc <= limit:
            _run_split(cuda, G, cache, pfx, q, new, mask, slots, 1, prefix)
            continue
        gc = _to(cuda, cache)
        n0 = kern.launches
        with pytest.raises(RuntimeError, match="invalid argument"):
            kern(torch.from_numpy(q).to(cuda).bfloat16(), *gc,
                 torch.from_numpy(mask).to(cuda), *_to(cuda, new), 1,
                 torch.from_numpy(slots).to(cuda),
                 *(_to(cuda, pfx) if prefix else ()))
        torch.cuda.synchronize()
        assert kern.launches == n0
        assert all(torch.equal(x, y) for x, y in zip(gc, _to(cuda, cache)))
