"""`ESMCQwen.encode_protein_sequences` and `ESMCQwen.generate` in the port
against the JAX class on the same weights (JAX init → numpy →
`params_from_jax`) and the same batch, f32 on the CPU:

  * the encoder's embeddings of raw protein strings within 1e-5, masks
    equal, at `attn_impl` auto, xla and flash;
  * lockstep generation from raw strings and from pre-tokenized proteins:
    greedy tokens identical, the prefill's and the first decode step's
    logits within 1e-5 of JAX's (a teacher-forced JAX forward over the
    prompt, and over the prompt and the first token), at `attn_impl` auto,
    xla and flash, on head dim 16 (tbkd lockstep cache) and 128 (bktd);
  * `kv_bits=8` (the int8 cache, bktd at head dim 128) with JAX's tokens;
  * generation without proteins raises; prompt lookup gives the plain
    greedy tokens and refuses sampling with JAX's "greedy-only"
    ValueError."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prot2text_tpu.models import adapters as ja
from prot2text_tpu.models import composed as jc
from prot2text_tpu.models import decoder as jd
from prot2text_tpu.models import esmc as jesmc
from prot2text_tpu.models import qwen3 as jq
from prot2text_tpu_torch.infer import generate as tgen
from prot2text_tpu_torch.models import adapters as ta
from prot2text_tpu_torch.models import composed as tc
from prot2text_tpu_torch.models import esmc as tesmc
from prot2text_tpu_torch.models import qwen3 as tq
from prot2text_tpu_torch.models.weights import params_from_jax

jgen = importlib.import_module("prot2text_tpu.infer.generate")
ATOL = 1e-5
PH, EOS, PAD = 259, 257, 258
SEQS = ["MKTAYIAKQR", "GSHMLEDPVAGLK", "MVLSEGEW"]


def _t(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree)).tree()


def _models(head_dim, impl, seed=0):
    esm = jesmc.ESMCConfig(d_model=64, n_layers=2, n_heads=4)
    qwen = jq.Qwen3Config(vocab_size=300, hidden_size=64, num_layers=2,
                          num_heads=4, num_kv_heads=2, head_dim=head_dim,
                          intermediate_size=128, rope_theta=1e4,
                          eos_token_id=EOS, pad_token_id=PAD)
    adapter = (64, 48, 64)
    jcfg = jc.ESMCQwenConfig(esm, ja.ModalityAdapterConfig(*adapter), qwen,
                             placeholder_id=PH)
    tcfg = tc.ESMCQwenConfig(tesmc.ESMCConfig(**esm.__dict__),
                             ta.ModalityAdapterConfig(*adapter),
                             tq.Qwen3Config(**qwen.__dict__),
                             placeholder_id=PH)
    jm = jc.ESMCQwen(jcfg, rng=jax.random.PRNGKey(seed), attn_impl=impl)
    tm = tc.ESMCQwen(tcfg, _t(jm.params), attn_impl=impl)
    return jm, tm


def _prompts(seed=1, S=32):
    """Left-padded prompts holding len(seq) + 2 placeholders (the ESMC
    tokens with cls and eos) between random text tokens."""
    rng = np.random.default_rng(seed)
    ids = np.full((len(SEQS), S), PAD, np.int64)
    mask = np.zeros((len(SEQS), S), np.int64)
    for b, s in enumerate(SEQS):
        text = list(rng.integers(0, 256, int(rng.integers(3, 10))))
        row = text[:2] + [PH] * (len(s) + 2) + text[2:]
        ids[b, S - len(row):] = row
        mask[b, S - len(row):] = 1
    return ids, mask


@pytest.mark.parametrize("impl", ["auto", "xla", "flash"])
def test_encode_protein_sequences_matches_jax(impl):
    jm, tm = _models(16, impl)
    jemb, jmask = jm.encode_protein_sequences(SEQS, pad_to=16)
    temb, tmask = tm.encode_protein_sequences(SEQS, pad_to=16)
    assert tuple(temb.shape) == (3, 16, 64)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), atol=ATOL,
                               rtol=0)


def _jax_logits(jm, emb, mask):
    """The last position's logits of a teacher-forced JAX forward (XLA)."""
    core = jm.config.llm_config.core()
    pos = jnp.clip(jnp.cumsum(mask, axis=1) - 1, 0, None).astype(jnp.int32)
    h, _ = jd.decoder_forward(
        core, jm.params["llm_decoder"], inputs_embeds=emb,
        bias=jd.causal_bias_from_mask(mask), positions=pos, attn_impl="xla",
        attn_lengths=jd.contiguous_lengths(mask))
    return np.asarray(jd.decoder_logits(core, jm.params["llm_decoder"],
                                        h[:, -1:])[:, 0])


@pytest.mark.parametrize("head_dim", [16, 128])
@pytest.mark.parametrize("impl", ["auto", "xla", "flash"])
def test_generate_matches_jax(head_dim, impl):
    jm, tm = _models(head_dim, impl, seed=head_dim)
    ids, mask = _prompts(seed=head_dim)
    N = 6
    want = np.asarray(jm.generate(jnp.asarray(ids), jnp.asarray(mask),
                                  protein_sequences=SEQS, max_new_tokens=N))
    stats = {}
    got = tm.generate(torch.from_numpy(ids), torch.from_numpy(mask),
                      protein_sequences=SEQS, max_new_tokens=N, stats=stats)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["steps"] == tgen.decode_steps_taken(got, EOS) > 0
    # the prefill and the first decode step against teacher-forced forwards
    emb, m = jm.forward(protein_sequences=SEQS, input_ids=jnp.asarray(ids),
                        attention_mask=jnp.asarray(mask),
                        return_decoder_inputs=True)
    np.testing.assert_allclose(stats["logits"][0].numpy(),
                               _jax_logits(jm, emb, m), atol=ATOL, rtol=0)
    tok0 = jm.params["llm_decoder"]["embed_tokens"][jnp.asarray(want[:, :1])]
    emb1 = jnp.concatenate([emb, tok0.astype(emb.dtype)], axis=1)
    m1 = jnp.concatenate([m, jnp.ones_like(m[:, :1])], axis=1)
    np.testing.assert_allclose(stats["logits"][1].numpy(),
                               _jax_logits(jm, emb1, m1), atol=ATOL, rtol=0)


def test_generate_from_token_ids_and_kv8_match_jax():
    """Pre-tokenized proteins give the raw strings' tokens; the int8 cache
    (head dim 128, bktd) gives JAX's `generate(kv_bits=8)` tokens."""
    jm, tm = _models(128, "auto", seed=7)
    ids, mask = _prompts(seed=7)
    pids, pmask = tm.protein_tokenizer.batch_encode(SEQS)
    kw = dict(max_new_tokens=6)
    by_ids = tm.generate(torch.from_numpy(ids), torch.from_numpy(mask),
                         protein_input_ids=torch.from_numpy(pids).long(),
                         protein_attention_mask=torch.from_numpy(
                             pmask).long(), **kw)
    by_seq = tm.generate(torch.from_numpy(ids), torch.from_numpy(mask),
                         protein_sequences=SEQS, **kw)
    assert torch.equal(by_ids, by_seq)
    want8 = np.asarray(jm.generate(jnp.asarray(ids), jnp.asarray(mask),
                                   protein_sequences=SEQS, kv_bits=8, **kw))
    got8 = tm.generate(torch.from_numpy(ids), torch.from_numpy(mask),
                       protein_sequences=SEQS, kv_bits=8, **kw)
    np.testing.assert_array_equal(got8.numpy(), want8)


def test_generate_refusals():
    _, tm = _models(16, "auto")
    ids, mask = _prompts()
    with pytest.raises(ValueError, match="protein_sequences"):
        tm.generate(torch.from_numpy(ids), torch.from_numpy(mask))
    # prompt lookup is ported (tests/test_torch_speculative.py): it gives
    # the plain greedy tokens, and refuses sampling as JAX does
    kw = dict(protein_sequences=SEQS, max_new_tokens=3)
    assert torch.equal(
        tm.generate(torch.from_numpy(ids), torch.from_numpy(mask),
                    prompt_lookup_tokens=2, **kw),
        tm.generate(torch.from_numpy(ids), torch.from_numpy(mask), **kw))
    with pytest.raises(ValueError, match="greedy-only"):
        tm.generate(torch.from_numpy(ids), torch.from_numpy(mask),
                    prompt_lookup_tokens=2, do_sample=True,
                    generator=torch.Generator().manual_seed(0), **kw)
    bad = ids.copy()
    bad[0, np.flatnonzero(bad[0] == PH)[0]] = 65
    with pytest.raises(ValueError, match="placeholder tokens"):
        tm.generate(torch.from_numpy(bad), torch.from_numpy(mask),
                    protein_sequences=SEQS, max_new_tokens=3)
