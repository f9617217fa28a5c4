"""One slots tensor a decode step.  `decoder_decode_step` and
`decoder_verify_chunk` turn `cache_index` (the serving engine's int64 (B,)
`write_idx`, a 0-dim tensor, a host int, or the verify round's int64 chunk
starts) into one contiguous (B,) int32 tensor on the cache's device once a
call, and every layer's attention wrapper (K4, K9a, K7, K9b; K8, K9c)
receives that one tensor, so no layer converts it again; an int32 tensor
already there passes as it is, with no copy.  h and the caches are
bit-identical to the step that hands the wrappers `cache_index` itself
(each wrapper then converts it), on bf16 and int8 caches, with and without
a shared prefix."""

import pytest
import torch

from prot2text_tpu_torch.infer.kvcache import init_kv_cache
from prot2text_tpu_torch.models import decoder as td

L, B, T, G, PC, HIDDEN, VALID = 3, 4, 64, 3, 32, 64, 20
CFG = td.DecoderConfig(
    vocab_size=128, hidden_size=HIDDEN, num_layers=L, num_heads=4,
    num_kv_heads=2, intermediate_size=128, head_dim=128,
    rope_theta=10000.0, qk_norm=True)
ROWS = [20, 25, 30, 21]              # distinct per-row slots / chunk starts
# (kv_bits, prefix) → the decoder's wrapper and its slots argument's place
STEP = {(None, False): ("decode_attention_stacked_write", 7),
        (None, True): ("decode_attention_stacked_write_prefix", 7),
        (8, False): ("decode_attention_stacked_write_q", 11),
        (8, True): ("decode_attention_stacked_write_q_prefix", 11)}
VERIFY = {False: ("decode_attention_stacked_verify_qc", 11),
          True: ("decode_attention_stacked_verify_qc_prefix", 11)}
INDEX = {"int64 rows": lambda: torch.tensor(ROWS),
         "int32 rows": lambda: torch.tensor(ROWS, dtype=torch.int32),
         "0-dim": lambda: torch.tensor(40),
         "host int": lambda: 40}


def _setup(kv_bits, prefix, S, seed):
    """bf16 params, a cache of random values whose first VALID columns are
    written, S tokens a row, and a prefix of PC columns (row 2 sees none
    of it) where asked."""
    g = torch.Generator().manual_seed(seed)
    params = td.init_decoder_params(CFG, generator=g, device="cpu",
                                    dtype=torch.bfloat16)
    cache = init_kv_cache(CFG, B, T, device="cpu", dtype=torch.bfloat16,
                          kv_bits=kv_bits)
    for name, t in cache.items():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g))
        else:
            t.copy_(torch.rand(t.shape, generator=g) * 0.03 + 0.002
                    if "scale" in name else torch.randn(t.shape, generator=g))
    kw = {}
    if prefix:
        Hkv, D = CFG.num_kv_heads, CFG.head_dim
        pkv = {n: torch.randn((L, 1, Hkv, PC, D), generator=g).to(
            torch.bfloat16) for n in ("k", "v")}
        if kv_bits:
            pkv = {n: torch.randint(-127, 128, (L, 1, Hkv, PC, D),
                                    generator=g, dtype=torch.int8)
                   for n in ("k", "v")}
            pkv.update({n: torch.rand((L, 1, Hkv, PC), generator=g) * 0.03
                        + 0.002 for n in ("k_scale", "v_scale")})
        bias = torch.zeros((B, 1, 1, PC))
        bias[2] = torch.finfo(torch.float32).min
        kw = dict(prefix_kv=pkv, prefix_bias=bias)
    mask = (torch.arange(T)[None] < VALID).expand(B, T).to(torch.int32)
    emb = torch.randn((B, S, HIDDEN), generator=g).to(torch.bfloat16)
    pos = (VALID + torch.arange(S))[None].expand(B, S).contiguous()
    return params, cache, mask.contiguous(), emb, pos, kw


def _run(monkeypatch, fn, wrapper, at, step_kw, convert):
    """fn(**step_kw) with the decoder's `wrapper` recording the slots
    argument of every layer; `convert` False hands the wrappers
    `cache_index` itself (each converts it), as the step did before it
    built one tensor a call."""
    seen = []
    inner = getattr(td, wrapper)

    def rec(*args, **kw):
        seen.append(args[at])
        return inner(*args, **kw)

    with monkeypatch.context() as m:
        m.setattr(td, wrapper, rec)
        if not convert:
            m.setattr(td, "_slots", lambda s, n, dev: s)
        h, cache = fn(**step_kw)
    return h, cache, seen


def _same(got, want):
    h, cache = got
    h0, cache0 = want
    assert torch.equal(h, h0)
    assert cache.keys() == cache0.keys()
    for name in cache:
        assert torch.equal(cache[name], cache0[name]), name


def _check_one_tensor(seen, index):
    assert len(seen) == L
    first = seen[0]
    assert all(s is first for s in seen), "one slots tensor for every layer"
    assert first.dtype == torch.int32 and first.shape == (B,)
    assert first.is_contiguous()
    if torch.is_tensor(index) and index.dtype == torch.int32 \
            and index.dim() == 1:
        assert first is index, "an int32 (B,) tensor passes as it is"


@pytest.mark.parametrize("index", list(INDEX))
@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("kv_bits", [None, 8])
def test_decode_step_builds_one_int32_slots_tensor(monkeypatch, kv_bits,
                                                   prefix, index):
    params, cache, mask, emb, pos, kw = _setup(kv_bits, prefix, 1, 5)
    wrapper, at = STEP[kv_bits, prefix]
    results = []
    for convert in (True, False):
        cache_index = INDEX[index]()
        step_kw = dict(cfg=CFG, params=params, token_embeds=emb,
                       kv_mask=mask, positions=pos,
                       kv_cache={n: t.clone() for n, t in cache.items()},
                       cache_index=cache_index, **kw)
        h, out, seen = _run(monkeypatch, td.decoder_decode_step, wrapper,
                            at, step_kw, convert)
        if convert:
            _check_one_tensor(seen, cache_index)
        results.append((h, out))
    _same(*results)
    moved = (results[0][1]["k"] != cache["k"]).nonzero()[:, 3].unique()
    want = [40] if index in ("0-dim", "host int") else sorted(ROWS)
    assert moved.tolist() == want


@pytest.mark.parametrize("prefix", [False, True])
def test_verify_chunk_builds_one_int32_slots_tensor(monkeypatch, prefix):
    params, cache, mask, emb, pos, kw = _setup(8, prefix, G, 6)
    wrapper, at = VERIFY[prefix]
    results = []
    for convert in (True, False):
        cache_index = torch.tensor(ROWS)
        step_kw = dict(cfg=CFG, params=params, token_embeds=emb,
                       kv_mask=mask, positions=pos,
                       kv_cache={n: t.clone() for n, t in cache.items()},
                       cache_index=cache_index, **kw)
        h, out, seen = _run(monkeypatch, td.decoder_verify_chunk, wrapper,
                            at, step_kw, convert)
        if convert:
            _check_one_tensor(seen, cache_index)
        results.append((h, out))
    _same(*results)
    moved = (results[0][1]["k"] != cache["k"]).nonzero()[:, 3].unique()
    assert moved.tolist() == sorted({r + g for r in ROWS for g in range(G)})
