"""The slice as a whole: `Esm2LlamaInstructForCausalLM.generate` in the
port against the JAX class on the same weights and the same batch (f32 on
the CPU).  Greedy tokens must be identical and the prefill logits within
1e-4, both where JAX takes its XLA paths (head_dim 16) and where it runs
its Pallas kernels in interpret mode (head_dim 128): K1, then K2/K3 (its
default decode route) or K4 (its fused-write route, the port's)."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prot2text_tpu.models import adapters as ja
from prot2text_tpu.models import composed as jc
from prot2text_tpu.models import decoder as jd
from prot2text_tpu.models import esm2 as je
from prot2text_tpu.models import llama as jl
from prot2text_tpu_torch.infer import generate as tgen
from prot2text_tpu_torch.models import adapters as ta
from prot2text_tpu_torch.models import composed as tc
from prot2text_tpu_torch.models import esm2 as te
from prot2text_tpu_torch.models import llama as tl
from prot2text_tpu_torch.models.weights import params_from_jax

# the module, not the `generate` function the package re-exports
jgen = importlib.import_module("prot2text_tpu.infer.generate")
PH, EOS, PAD = 259, 257, 258      # ByteTextTokenizer special ids
LOGIT_ATOL = 1e-4


def _configs(llama: jl.LlamaConfig):
    llama = dataclasses.replace(llama, placeholder_id=PH, eos_token_id=EOS,
                                pad_token_id=PAD)
    esm = je.ESM2Config(hidden_size=32, num_layers=2, num_heads=4,
                        intermediate_size=64)
    adapter = (32, 48, llama.hidden_size)
    jcfg = jc.Esm2LlamaInstructConfig(esm, ja.ModalityAdapterConfig(*adapter),
                                      llama, PH)
    tcfg = tc.Esm2LlamaInstructConfig(
        te.ESM2Config(**esm.__dict__), ta.ModalityAdapterConfig(*adapter),
        tl.LlamaConfig(**llama.__dict__), PH)
    return jcfg, tcfg


def _batch(B, P, seed):
    """Left-padded prompts whose placeholder runs match right-padded
    protein token rows (n placeholders = n valid ESM tokens)."""
    rng = np.random.default_rng(seed)
    n_prot = rng.integers(4, 9, B)
    Pp = int(n_prot.max())
    pids = np.ones((B, Pp), np.int32)
    pmask = np.zeros((B, Pp), np.int32)
    ids = np.full((B, P), PAD, np.int32)
    mask = np.zeros((B, P), np.int32)
    for b, n in enumerate(n_prot):
        pids[b, :n] = [0] + list(rng.integers(4, 24, n - 2)) + [2]
        pmask[b, :n] = 1
        text = list(rng.integers(0, 256, int(rng.integers(n + 4, P + 1) - n)))
        row = text[:3] + [PH] * n + text[3:]
        ids[b, P - len(row):] = row
        mask[b, P - len(row):] = 1
    return dict(inputs=ids, attention_mask=mask, protein_input_ids=pids,
                protein_attention_mask=pmask)


def _jax_prefill_logits(jcfg, params, batch):
    core = jcfg.llama_config.core()

    def run(p, ids, mask, pids, pmask):
        emb, m = jc.Esm2LlamaInstructForCausalLM.apply(
            jcfg, p, input_ids=ids, attention_mask=mask,
            protein_input_ids=pids, protein_attention_mask=pmask,
            return_decoder_inputs=True, attn_impl="xla")
        pos = jnp.clip(jnp.cumsum(m, axis=1) - 1, 0, None).astype(jnp.int32)
        h, _ = jd.decoder_forward(
            core, p["llama_decoder"], inputs_embeds=emb,
            bias=jd.causal_bias_from_mask(m), positions=pos,
            attn_impl="xla", attn_lengths=jd.contiguous_lengths(m))
        return jd.decoder_logits(core, p["llama_decoder"], h[:, -1:])[:, 0]

    return np.asarray(jax.jit(run)(params, *batch.values()))


def _run_both(jcfg, tcfg, batch, N, seed):
    jm = jc.Esm2LlamaInstructForCausalLM(jcfg, rng=jax.random.PRNGKey(seed),
                                         attn_impl="auto")
    tm = tc.Esm2LlamaInstructForCausalLM(
        tcfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params)))
    want = np.asarray(jm.generate(**{k: jnp.asarray(v)
                                     for k, v in batch.items()},
                                  max_new_tokens=N))
    stats = {}
    got = tm.generate(**{k: torch.from_numpy(v) for k, v in batch.items()},
                      max_new_tokens=N, stats=stats)
    return jm, want, got.numpy(), stats


def test_greedy_matches_jax_xla_path():
    """LlamaConfig.tiny (head_dim 16): JAX runs chunked XLA attention in
    the prefill and its einsum decode step; the port runs its kernels'
    plain versions."""
    jcfg, tcfg = _configs(jl.LlamaConfig.tiny(vocab_size=264))
    batch = _batch(B=3, P=20, seed=0)
    jm, want, got, stats = _run_both(jcfg, tcfg, batch, N=6, seed=0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(stats["logits"][0].numpy(),
                               _jax_prefill_logits(jcfg, jm.params, batch),
                               atol=LOGIT_ATOL, rtol=0)
    assert stats["steps"] == tgen.decode_steps_taken(torch.from_numpy(got),
                                                     EOS)


def _greedy_pallas_interpret(monkeypatch, fused: bool):
    """head_dim 128, B*Hkv = 8, T % 16 == 0: with the Pallas gates forced
    open (interpret mode) the JAX reference runs K1 in the prefill and, in
    every decode step, K2 + K3 (its default) or K4 (`fused`:
    `P2T_FUSED_CACHE_WRITE=1`, set for the JAX side only), counted below;
    the port (K4 a layer, whatever the environment) must produce its exact
    greedy tokens.  JAX reads the environment when it traces, so its
    traces are cleared first."""
    jax.clear_caches()
    monkeypatch.setenv("P2T_PALLAS_FORCE_INTERPRET", "1")
    monkeypatch.setenv("P2T_PAD_FLASH", "1")
    if fused:
        monkeypatch.setenv("P2T_FUSED_CACHE_WRITE", "1")
    import prot2text_tpu.kernels.attention as j_attn
    import prot2text_tpu.kernels.cache_update as j_cu
    import prot2text_tpu.kernels.decode_attention as j_da

    calls = {}

    def count(mod, name):
        orig = getattr(mod, name)

        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return orig(*a, **k)

        monkeypatch.setattr(mod, name, wrapper)

    count(j_attn, "masked_flash_padded")
    count(j_da, "decode_attention_stacked")
    count(j_da, "decode_attention_stacked_write")
    count(j_cu, "cache_slot_write_bkt")
    llama = jl.LlamaConfig(vocab_size=264, hidden_size=512, num_layers=2,
                           num_heads=4, num_kv_heads=2, intermediate_size=256,
                           rope_theta=10000.0, tie_word_embeddings=False,
                           rope_scaling="llama3", rope_scaling_factor=8.0)
    jcfg, tcfg = _configs(llama)
    batch = _batch(B=4, P=24, seed=1)
    jm, want, got, stats = _run_both(jcfg, tcfg, batch, N=8, seed=1)
    decode = ({"decode_attention_stacked_write"} if fused else
              {"decode_attention_stacked", "cache_slot_write_bkt"})
    assert set(calls) == {"masked_flash_padded"} | decode, calls
    np.testing.assert_array_equal(got, want)
    monkeypatch.delenv("P2T_PALLAS_FORCE_INTERPRET")
    monkeypatch.delenv("P2T_FUSED_CACHE_WRITE", raising=False)
    np.testing.assert_allclose(stats["logits"][0].numpy(),
                               _jax_prefill_logits(jcfg, jm.params, batch),
                               atol=LOGIT_ATOL, rtol=0)


def test_greedy_matches_jax_pallas_interpret_path(monkeypatch):
    """Against JAX's default split write (K2 per layer, K3 a step)."""
    _greedy_pallas_interpret(monkeypatch, fused=False)


def test_greedy_matches_jax_pallas_interpret_fused_write_path(monkeypatch):
    """Against JAX's fused write (K4 per layer), the port's own route."""
    _greedy_pallas_interpret(monkeypatch, fused=True)


@pytest.mark.parametrize("kw", [
    dict(temperature=0.7),
    dict(top_k=5),
    dict(top_p=0.9),
    dict(temperature=1.3, top_k=7, top_p=0.8),
])
def test_filter_logits_matches_jax(kw):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 50)).astype(np.float32)
    logits[1, 10:14] = logits[1, 3]                  # ties at the boundary
    want = np.asarray(jgen.filter_logits(jnp.asarray(logits),
                                         jgen.GenerationConfig(**kw)))
    got = tgen.filter_logits(torch.from_numpy(logits),
                             tgen.GenerationConfig(**kw)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=0)


def test_resolve_generation_config_matches_jax():
    for kw in ({}, {"max_new_tokens": 7, "eos_token_id": 3},
               {"generation_config": None}):
        j = jgen.resolve_generation_config(1, 2, dict(kw))
        t = tgen.resolve_generation_config(1, 2, dict(kw))
        assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_sampling_is_seeded_and_unported_modes_raise():
    _, tcfg = _configs(jl.LlamaConfig.tiny(vocab_size=264))
    tm = tc.Esm2LlamaInstructForCausalLM(
        tcfg, generator=torch.Generator().manual_seed(3))
    batch = {k: torch.from_numpy(v) for k, v in _batch(2, 20, 3).items()}

    def sample(seed):
        return tm.generate(**batch, max_new_tokens=5, do_sample=True,
                           top_k=20, generator=torch.Generator().manual_seed(
                               seed))

    a, b = sample(0), sample(0)
    assert torch.equal(a, b) and int(a.max()) < 264
    with pytest.raises(NotImplementedError, match="beam"):
        tm.generate(**batch, max_new_tokens=3, num_beams=2)
    with pytest.raises(NotImplementedError, match="prompt-lookup"):
        tm.generate(**batch, max_new_tokens=3, prompt_lookup_tokens=2)
    # the int8 KV cache is ported: it decodes (K7's plain version here)
    t8 = tm.generate(**batch, max_new_tokens=3, kv_bits=8)
    assert t8.shape == (2, 3) and int(t8.max()) < 264
    bad = dict(batch, protein_attention_mask=torch.ones_like(
        batch["protein_attention_mask"]))
    with pytest.raises(ValueError, match="placeholder"):
        tm.generate(**bad, max_new_tokens=3)
