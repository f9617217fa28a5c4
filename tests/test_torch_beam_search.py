"""Beam search in the port (`infer/beam_search.py`) against JAX's
(prot2text_tpu/infer/beam_search.py) on the same weights, f32 on the CPU:
K 2 and 3, an EOS that fires, length_penalty != 1 and early_stopping, at
head dims 64 (the tbkd cache, reordered on axis 2) and 128 (bktd, axis 1).
The tokens must be identical.  Beam-sample's mechanics: seeded and
reproducible, the seed matters, K distinct candidates per row, and the
temperature→0 limit is greedy beam search."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prot2text_tpu.infer.beam_search import beam_search as jbeam
from prot2text_tpu.models import decoder as jd
from prot2text_tpu_torch.infer import beam_search as tbs
from prot2text_tpu_torch.infer import generate as tgen
from prot2text_tpu_torch.models import decoder as td
from prot2text_tpu_torch.models.weights import params_from_jax, tree_to_numpy

jgen = importlib.import_module("prot2text_tpu.infer.generate")
VOCAB, PAD, N = 96, 95, 10


def _model(head_dim, seed=0):
    """A tiny decoder in both packages, drawn by the port's init (which
    builds no XLA programs)."""
    tcfg = td.DecoderConfig(
        vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=128, head_dim=head_dim,
        rope_theta=1e4)
    tree = tree_to_numpy(td.init_decoder_params(
        tcfg, generator=torch.Generator().manual_seed(seed), device="cpu"))
    return (jd.DecoderConfig(**tcfg.__dict__), tcfg,
            jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_jax(tree).tree())


def _prompt(seed=11):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((2, 6, 64)).astype(np.float32)
    mask = np.ones((2, 6), np.int64)
    mask[0, :2] = 0
    return emb, mask


def _port(tcfg, tp, emb, mask, eos, stats=None, **kw):
    """The port's beam_search; kw (num_beams, length_penalty,
    early_stopping) go into its GenerationConfig."""
    return tbs.beam_search(
        tcfg, tp, inputs_embeds=torch.from_numpy(emb),
        attention_mask=torch.from_numpy(mask), stats=stats,
        gen_cfg=tgen.GenerationConfig(max_new_tokens=N, eos_token_id=eos,
                                      pad_token_id=PAD, **kw)).numpy()


# (K, EOS id, length_penalty, early_stopping, head dim): EOS None never
# fires, "step3" is row 0's token at step 3 of the run without one; 87 at
# head dim 128 with K 2 banks two hypotheses in both rows by step 5, so
# early_stopping ends the decode there
CASES = [(2, None, 1.0, False, 64), (3, "step3", 1.0, False, 128),
         (3, "step3", 2.0, False, 64), (2, "step3", 0.5, False, 128),
         (3, "step3", 1.0, True, 64), (2, 87, 1.0, True, 128)]


@pytest.mark.parametrize("K,eos_case,lp,early,head_dim", CASES)
def test_greedy_beams_match_jax(K, eos_case, lp, early, head_dim):
    jcfg, tcfg, jp, tp = _model(head_dim)
    emb, mask = _prompt()
    kw = dict(num_beams=K, length_penalty=lp, early_stopping=early)
    eos = 9999 if eos_case is None else eos_case
    if eos_case == "step3":
        eos = int(_port(tcfg, tp, emb, mask, 9999, **kw)[0, 3])
    stats = {}
    got = _port(tcfg, tp, emb, mask, eos, stats=stats, **kw)
    want = np.asarray(jbeam(
        jcfg, jp, inputs_embeds=jnp.asarray(emb),
        attention_mask=jnp.asarray(mask),
        gen_cfg=jgen.GenerationConfig(max_new_tokens=N, eos_token_id=eos,
                                      pad_token_id=PAD), **kw))
    np.testing.assert_array_equal(got, want)
    for row in got:                     # pad after an EOS
        hit = np.flatnonzero(row == eos)
        assert not hit.size or (row[hit[0] + 1:] == PAD).all()
    assert stats["steps"] == (5 if eos_case == 87 else N - 1)


def test_beam_sample_mechanics():
    """Beam-sample draws with the caller's torch.Generator: the same seed
    gives the same tokens, another seed other tokens at temperature 5, the
    candidates of a row are K distinct ids (drawn without replacement),
    temperature 1e-4 gives greedy beam search, and no generator is a
    ValueError."""
    _, tcfg, _, tp = _model(64, seed=5)
    emb, mask = _prompt(8)
    greedy = _port(tcfg, tp, emb, mask, -1, num_beams=3)

    def sample(seed, temperature):
        return tbs.beam_search(
            tcfg, tp, inputs_embeds=torch.from_numpy(emb),
            attention_mask=torch.from_numpy(mask),
            generator=torch.Generator().manual_seed(seed),
            gen_cfg=tgen.GenerationConfig(
                max_new_tokens=N, eos_token_id=-1, pad_token_id=PAD,
                num_beams=3, do_sample=True,
                temperature=temperature)).numpy()

    s1, s2 = sample(1, 5.0), sample(2, 5.0)
    np.testing.assert_array_equal(s1, sample(1, 5.0))
    assert not np.array_equal(s1, s2)
    np.testing.assert_array_equal(sample(3, 1e-4), greedy)
    cand = torch.log_softmax(torch.randn(4, 3, VOCAB), dim=-1)
    warm = tgen.GenerationConfig(do_sample=True, temperature=5.0)
    for seed in range(5):
        _, ids = tbs._select_candidates(
            cand, 6, warm, torch.Generator().manual_seed(seed))
        assert all(len(set(r.tolist())) == 6 for r in ids)
    with pytest.raises(ValueError, match="Generator"):
        tbs.beam_search(tcfg, tp, inputs_embeds=torch.from_numpy(emb),
                        attention_mask=torch.from_numpy(mask),
                        gen_cfg=tgen.GenerationConfig(
                            max_new_tokens=3, num_beams=2, do_sample=True))
