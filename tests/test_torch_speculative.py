"""Lockstep speculative decoding in the port (`infer/speculative.py`)
against JAX's (prot2text_tpu/infer/speculative.py) on the same weights, f32
on the CPU: a second decoder as the draft (the target itself, and a random
smaller one), the target's own first layers (1 and 2 of 3), and prompt
lookup (ngram 1 and 2, with and without prompt ids, and over an int8
cache), at head dims 64 (the tbkd cache) and 128 (bktd).  The tokens and
the number of target forwards must be identical, and the tokens equal the
port's own plain greedy `generate`.  Also: JAX's ValueErrors, and prompt
lookup through `Esm2LlamaInstructForCausalLM.generate`, which passes the
text prompt's ids."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prot2text_tpu.infer import speculative as jspec
from prot2text_tpu.models import adapters as ja
from prot2text_tpu.models import composed as jc
from prot2text_tpu.models import decoder as jd
from prot2text_tpu.models import esm2 as je
from prot2text_tpu.models import llama as jl
from prot2text_tpu_torch.infer import generate as tgen
from prot2text_tpu_torch.infer import speculative as tspec
from prot2text_tpu_torch.models import adapters as ta
from prot2text_tpu_torch.models import composed as tc
from prot2text_tpu_torch.models import decoder as td
from prot2text_tpu_torch.models import esm2 as te
from prot2text_tpu_torch.models import llama as tl
from prot2text_tpu_torch.models.weights import params_from_jax, tree_to_numpy

# the module, not the `generate` function the package re-exports
jgen = importlib.import_module("prot2text_tpu.infer.generate")
VOCAB, PAD, N = 96, 95, 12


def _successor(params, c: float, seed: int):
    """Make a numpy decoder tree decisive in place: the token embeddings 20
    times larger and the head c times their directions, permuted, so each
    token's successor leads the logits by a wide margin.  Returns the
    successor of each token id."""
    E = params["embed_tokens"]
    succ = np.random.default_rng(seed).permutation(E.shape[0])
    W = np.zeros(E.shape[::-1], np.float32)
    W[:, succ] = E.T * c
    params["lm_head"]["kernel"] = W
    params["embed_tokens"] = E * 20.0
    return succ


def _both(tree):
    """A numpy tree → (JAX tree, port tree) holding the same values."""
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_jax(tree).tree())


def _model(head_dim, *, hidden=64, layers=3, heads=4, kv_heads=2, seed=0,
           successor=0.0):
    """A tiny decoder in both packages (drawn by the port's init, which
    builds no XLA programs), decisive (`_successor`) with successor=c > 0."""
    tcfg = td.DecoderConfig(
        vocab_size=VOCAB, hidden_size=hidden, num_layers=layers,
        num_heads=heads, num_kv_heads=kv_heads, intermediate_size=128,
        head_dim=head_dim, rope_theta=1e4)
    tree = tree_to_numpy(td.init_decoder_params(
        tcfg, generator=torch.Generator().manual_seed(seed), device="cpu"))
    if successor:
        _successor(tree, successor, seed)
    return (jd.DecoderConfig(**tcfg.__dict__), tcfg) + _both(tree)


def _prompt(hidden, seed=11):
    """(2, 6, hidden) prompt embeddings, row 0 left-padded by 2."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((2, 6, hidden)).astype(np.float32)
    mask = np.ones((2, 6), np.int64)
    mask[0, :2] = 0
    return emb, mask


def _plain(tcfg, tparams, emb, mask, eos, kv_bits=None):
    gen_cfg = tgen.GenerationConfig(max_new_tokens=N, eos_token_id=eos,
                                    pad_token_id=PAD)
    return tgen.generate(tcfg, tparams, inputs_embeds=torch.from_numpy(emb),
                         attention_mask=torch.from_numpy(mask),
                         gen_cfg=gen_cfg, kv_bits=kv_bits).numpy()


# (draft source, head dim): every source at both cache layouts between them
CASES = [("perfect", 64), ("smaller", 128),
         ("self1", 64), ("self2", 128), ("lookup1", 128),
         ("lookup2_ids", 64)]


@pytest.mark.parametrize("case,head_dim", CASES,
                         ids=[f"{c}-d{d}" for c, d in CASES])
def test_matches_jax_and_plain_greedy(case, head_dim):
    jcfg, tcfg, jp, tp = _model(head_dim)
    emb, mask = _prompt(64)
    # an EOS that fires: the plain greedy run's fifth token in row 0
    eos = int(_plain(tcfg, tp, emb, mask, 9999)[0, 4])
    want = _plain(tcfg, tp, emb, mask, eos)
    assert (want[0, 5:] == PAD).all()
    jkw = dict(inputs_embeds=jnp.asarray(emb),
               attention_mask=jnp.asarray(mask),
               gen_cfg=jgen.GenerationConfig(
                   max_new_tokens=N, eos_token_id=eos, pad_token_id=PAD))
    tkw = dict(inputs_embeds=torch.from_numpy(emb),
               attention_mask=torch.from_numpy(mask),
               gen_cfg=tgen.GenerationConfig(
                   max_new_tokens=N, eos_token_id=eos, pad_token_id=PAD))
    if case in ("perfect", "smaller"):
        djc, dtc, djp, dtp = (jcfg, tcfg, jp, tp) if case == "perfect" else \
            _model(head_dim, hidden=32, layers=2, heads=2, kv_heads=1,
                   seed=42)
        demb = np.random.default_rng(5).standard_normal(
            (2, 6, djc.hidden_size)).astype(np.float32)
        if case == "perfect":
            demb = emb
        got = jspec.speculative_generate(
            jcfg, jp, djc, djp, draft_inputs_embeds=jnp.asarray(demb),
            gamma=3 if case == "perfect" else 2, **jkw)
        port = tspec.speculative_generate(
            tcfg, tp, dtc, dtp, draft_inputs_embeds=torch.from_numpy(demb),
            gamma=3 if case == "perfect" else 2, **tkw)
    elif case.startswith("self"):
        n = int(case[-1])
        got = jspec.self_speculative_generate(jcfg, jp, draft_layers=n,
                                              gamma=3, **jkw)
        port = tspec.self_speculative_generate(tcfg, tp, draft_layers=n,
                                               gamma=3, **tkw)
    else:
        ngram = int(case[6])
        if case.endswith("_ids"):
            ids = np.random.default_rng(3).integers(0, VOCAB, (2, 8))
            ids[1, 2:6] = want[1, :4]         # a history that matches
            ids_mask = np.ones((2, 8), np.int64)
            ids_mask[0, :2] = 0
            jkw.update(prompt_ids=jnp.asarray(ids),
                       prompt_ids_mask=jnp.asarray(ids_mask))
            tkw.update(prompt_ids=torch.from_numpy(ids),
                       prompt_ids_mask=torch.from_numpy(ids_mask))
        got = jspec.prompt_lookup_generate(jcfg, jp, gamma=3, ngram=ngram,
                                           **jkw)
        port = tspec.prompt_lookup_generate(tcfg, tp, gamma=3, ngram=ngram,
                                            **tkw)
    np.testing.assert_array_equal(port[0].numpy(), np.asarray(got[0]))
    assert port[1] == int(got[1])
    np.testing.assert_array_equal(port[0].numpy(), want)


def _margin(tcfg, tparams, emb, mask, toks):
    """Top-1 minus top-2 logit at every generated position of every row,
    from an f32 teacher-forced forward of its valid prompt and tokens."""
    margins = []
    for b in range(emb.shape[0]):
        prompt = torch.from_numpy(emb[b][mask[b] == 1])
        x = torch.cat([prompt, tparams["embed_tokens"][
            torch.from_numpy(toks[b, :-1])]])
        n = x.shape[0]
        h, _ = td.decoder_forward(
            tcfg, tparams, inputs_embeds=x[None],
            positions=torch.arange(n)[None],
            attn_lengths=td.contiguous_lengths(torch.ones(1, n)))
        lg = td.decoder_logits(tcfg, tparams, h)[0, prompt.shape[0] - 1:]
        top = torch.topk(lg, 2, dim=-1).values
        margins.append((top[:, 0] - top[:, 1]).min().item())
    return min(margins)


def test_int8_prompt_lookup_matches_jax(monkeypatch):
    """kv_bits=8 at head dim 128: the port's verify is the fused chunk
    verify (K8's plain version, every round), JAX's on the CPU its XLA
    forward over the int8 cache.  Both quantize per (head, token), so the
    tokens agree wherever the top-1 margin is wide: the successor model's,
    asserted first.  The prompt ids hold the successor chain, so drafts are
    accepted.  Tokens and target forwards equal JAX's, and the tokens the
    port's plain int8 greedy `generate`."""
    jcfg, tcfg, jp, tp = _model(128, successor=20.0, seed=5)
    E = tp["embed_tokens"].numpy()
    emb = E[np.random.default_rng(7).integers(0, VOCAB, (2, 6))]
    mask = np.ones((2, 6), np.int64)
    mask[0, :2] = 0
    want = _plain(tcfg, tp, emb, mask, -1, kv_bits=8)
    margin = _margin(tcfg, tp, emb, mask, want)
    assert margin > 2.0, f"top-1 margin {margin}: pick another seed"
    calls = []
    real = tspec.decoder_verify_chunk
    monkeypatch.setattr(tspec, "decoder_verify_chunk",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = jspec.prompt_lookup_generate(
        jcfg, jp, inputs_embeds=jnp.asarray(emb),
        attention_mask=jnp.asarray(mask), prompt_ids=jnp.asarray(want),
        kv_bits=8, gamma=3, ngram=2,
        gen_cfg=jgen.GenerationConfig(max_new_tokens=N, eos_token_id=-1,
                                      pad_token_id=PAD))
    stats = {}
    port = tspec.prompt_lookup_generate(
        tcfg, tp, inputs_embeds=torch.from_numpy(emb),
        attention_mask=torch.from_numpy(mask),
        prompt_ids=torch.from_numpy(want), kv_bits=8, gamma=3, ngram=2,
        stats=stats, gen_cfg=tgen.GenerationConfig(
            max_new_tokens=N, eos_token_id=-1, pad_token_id=PAD))
    np.testing.assert_array_equal(port[0].numpy(), np.asarray(got[0]))
    assert port[1] == int(got[1]) == stats["n_target_forwards"]
    np.testing.assert_array_equal(port[0].numpy(), want)
    assert len(calls) == stats["rounds"] > 0
    assert stats["accepted"] > 0


def _refusal(pkg, case):
    if case == "draft_layers":
        mod, cfg = (jspec, jd) if pkg == "jax" else (tspec, td)
        dcfg = cfg.DecoderConfig(vocab_size=VOCAB, hidden_size=64,
                                 num_layers=2, num_heads=4, num_kv_heads=2,
                                 intermediate_size=128, head_dim=16)
        return lambda: mod.self_speculative_generate(
            dcfg, {}, inputs_embeds=None, attention_mask=None, gen_cfg=None,
            draft_layers=2)
    g = (jgen if pkg == "jax" else tgen).GenerationConfig(
        max_new_tokens=4, **({"num_beams": 2} if case == "beams_kv8" else
                             {"do_sample": True, "prompt_lookup_tokens": 2}))
    run = (jgen if pkg == "jax" else tgen).run_generation
    return lambda: run(None, {}, inputs_embeds=None, attention_mask=None,
                       gen_cfg=g, kv_bits=8 if case == "beams_kv8" else None)


@pytest.mark.parametrize("case", ["draft_layers", "beams_kv8",
                                  "sample_lookup"])
def test_value_errors_match_jax(case):
    messages = []
    for pkg in ("jax", "port"):
        with pytest.raises(ValueError) as e:
            _refusal(pkg, case)()
        messages.append(str(e.value))
    assert messages[0] == messages[1]


PH, EOS = 259, 257      # ByteTextTokenizer's placeholder and eos ids


def test_instruct_generate_passes_prompt_ids():
    """Prompt lookup through `Esm2LlamaInstructForCausalLM.generate` on a
    decisive decoder (`_successor`) whose prompt text holds the successor
    chain it will generate: the tokens equal JAX's class's and the port's
    plain greedy ones, and the target forwards are those of
    `prompt_lookup_generate` drafting from the text ids, fewer than from
    the generated tokens alone."""
    llama = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=264),
                                placeholder_id=PH, eos_token_id=EOS,
                                pad_token_id=258)
    esm = je.ESM2Config(hidden_size=32, num_layers=2, num_heads=4,
                        intermediate_size=64)
    adapter = (32, 48, llama.hidden_size)
    jcfg = jc.Esm2LlamaInstructConfig(esm, ja.ModalityAdapterConfig(*adapter),
                                      llama, PH)
    tcfg = tc.Esm2LlamaInstructConfig(
        te.ESM2Config(**esm.__dict__), ta.ModalityAdapterConfig(*adapter),
        tl.LlamaConfig(**llama.__dict__), PH)
    tree = tree_to_numpy(tc.init_instruct_params(
        tcfg, generator=torch.Generator().manual_seed(2), device="cpu"))
    succ = _successor(tree["llama_decoder"], 20.0, seed=4)
    jtree, ttree = _both(tree)
    jm = jc.Esm2LlamaInstructForCausalLM(jcfg, jtree, attn_impl="auto")
    tm = tc.Esm2LlamaInstructForCausalLM(tcfg, ttree)
    ids = np.full((2, 20), 258, np.int64)
    mask = np.zeros((2, 20), np.int64)
    def chain(start):
        c = [start]
        for _ in range(7):
            c.append(int(succ[c[-1]]))
        return c

    # two chains of text ids (no special id) for the two rows
    starts = [x for x in range(256) if not {PH, EOS, 258} & set(chain(x))]
    for b, (start, n) in enumerate(((starts[0], 5), (starts[-1], 3))):
        row = chain(start) + [PH] * n + chain(start)[:3]
        ids[b, 20 - len(row):], mask[b, 20 - len(row):] = row, 1
    pids = np.ones((2, 5), np.int64)
    pmask = np.zeros((2, 5), np.int64)
    pids[0], pmask[0] = [0, 5, 6, 7, 2], 1
    pids[1, :3], pmask[1, :3] = [0, 9, 2], 1
    batch = dict(inputs=ids, attention_mask=mask, protein_input_ids=pids,
                 protein_attention_mask=pmask)
    kw = dict(max_new_tokens=N, prompt_lookup_tokens=3)
    want = np.asarray(jm.generate(**{k: jnp.asarray(v)
                                     for k, v in batch.items()}, **kw))
    stats = {}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = tm.generate(**tb, stats=stats, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, tm.generate(**tb, max_new_tokens=N))
    emb, m = tm.apply(tcfg, tm.params(), input_ids=tb["inputs"],
                      attention_mask=tb["attention_mask"],
                      protein_input_ids=tb["protein_input_ids"],
                      protein_attention_mask=tb["protein_attention_mask"],
                      return_decoder_inputs=True)
    n_fwd = {}
    for with_ids in (True, False):
        ids_kw = (dict(prompt_ids=tb["inputs"],
                       prompt_ids_mask=tb["attention_mask"])
                  if with_ids else {})
        _, n_fwd[with_ids] = tspec.prompt_lookup_generate(
            tcfg.llama_config.core(), tm.params()["llama_decoder"],
            inputs_embeds=emb, attention_mask=m, gamma=3, ngram=2,
            gen_cfg=tgen.GenerationConfig(max_new_tokens=N, eos_token_id=EOS,
                                          pad_token_id=258), **ids_kw)
    assert stats["n_target_forwards"] == n_fwd[True] < n_fwd[False]
