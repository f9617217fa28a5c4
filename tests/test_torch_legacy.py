"""The legacy concat-fusion arc in the port against the JAX package on the
same weights (JAX init → numpy → `params_from_jax`) and numpy batches in
the derived collator's layout (left-padded proteins of mixed lengths,
[bos, prompt, bos], right-padded descriptions), f32 on the CPU:
`concat_fusion`; `Esm2LlamaForCausalLM.apply` logits and loss at every
`attn_impl` (JAX's CPU route: XLA over `causal_bias_from_mask` of the
whole mask, which the port's key runs of that mask reproduce — JAX's
text-mask runs are its reference fault, read only by its TPU flash
route); `generate`, prompt included; the D=64 "tbkd" lockstep path
(prefill cache, 3 decode steps' caches without a permute, logits,
tokens; its K12 launches on the card are held in
tests/test_torch_cache_update_tbkd.py); the legacy train step's loss and
gradients at grad_accum 1 and 2 (StepLR AdamW against optax:
tests/test_torch_training_modules.py test_adamw_matches_optax_three_steps)."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prot2text_tpu.infer import kvcache as jkv
from prot2text_tpu.models import composed as jc
from prot2text_tpu.models import decoder as jd
from prot2text_tpu.models import esm2 as je
from prot2text_tpu.models import fusion as jf
from prot2text_tpu.models import llama as jl
from prot2text_tpu.train import legacy as jlegacy
from prot2text_tpu.train import optim as jopt
from prot2text_tpu_torch.infer import generate as tgen
from prot2text_tpu_torch.infer import kvcache as tkv
from prot2text_tpu_torch.models import composed as tc
from prot2text_tpu_torch.models import decoder as td
from prot2text_tpu_torch.models import esm2 as te
from prot2text_tpu_torch.models import fusion as tf
from prot2text_tpu_torch.models import llama as tl
from prot2text_tpu_torch.models.weights import (
    params_from_jax, tree_leaves, tree_to_numpy,
)
from prot2text_tpu_torch.train import legacy as tlegacy
from prot2text_tpu_torch.train import optim as topt

# the module, not the `generate` function the package re-exports
jgen = importlib.import_module("prot2text_tpu.infer.generate")
ATOL = 1e-5
BOS, EOS = 256, 257
ESM = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=96)
# head dim 64 (the tbkd cache, as Llama-3.2-1B's), 2 query heads per kv head
LLAMA = dict(vocab_size=300, hidden_size=128, num_layers=2, num_heads=2,
             num_kv_heads=1, intermediate_size=192, rope_theta=1e4,
             tie_word_embeddings=False, rope_scaling=None)


def _configs(decoder_hidden_size=128):
    """Without the adapter the encoder's width is the decoder's."""
    esm = (ESM if decoder_hidden_size else
           dict(ESM, hidden_size=LLAMA["hidden_size"], num_heads=8))
    jcfg = jc.Esm2LlamaConfig(je.ESM2Config(**esm), jl.LlamaConfig(**LLAMA),
                              decoder_hidden_size, BOS, EOS)
    tcfg = tc.Esm2LlamaConfig(te.ESM2Config(**esm), tl.LlamaConfig(**LLAMA),
                              decoder_hidden_size, BOS, EOS)
    return jcfg, tcfg


def _models(seed=0, decoder_hidden_size=128):
    jcfg, tcfg = _configs(decoder_hidden_size)
    jm = jc.Esm2LlamaForCausalLM(jcfg, rng=jax.random.PRNGKey(seed))
    tm = tc.Esm2LlamaForCausalLM(tcfg, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params)))
    return jm, tm


def _batch(B=3, Pp=12, desc=10, seed=0, train=True):
    """The derived collator's layout: proteins of mixed lengths LEFT-padded
    with 1, prompt [bos, 5 tokens, bos], descriptions right-padded; labels
    -100 over the prompt and the padding."""
    rng = np.random.default_rng(seed)
    pids = np.ones((B, Pp), np.int32)
    pmask = np.zeros((B, Pp), np.int32)
    prompt = np.r_[BOS, rng.integers(3, 250, 5), BOS]
    ids, mask, labels = [], [], []
    for b in range(B):
        n = int(rng.integers(3, Pp - 1))
        pids[b, Pp - n - 2:] = np.r_[0, rng.integers(4, 24, n), 2]
        pmask[b, Pp - n - 2:] = 1
        d = int(rng.integers(2, desc + 1))
        dids = np.zeros(desc, np.int32)
        dids[:d] = rng.integers(3, 250, d)
        ids.append(np.r_[prompt, dids])
        mask.append(np.r_[np.ones_like(prompt), np.arange(desc) < d])
        labels.append(np.r_[np.full_like(prompt, -100),
                            np.where(np.arange(desc) < d, dids, -100)])
    out = dict(input_ids=np.stack(ids).astype(np.int32),
               attention_mask=np.stack(mask).astype(np.int32),
               labels=np.stack(labels).astype(np.int32),
               protein_input_ids=pids, protein_attention_mask=pmask)
    if not train:
        out = {"input_ids": np.tile(prompt, (B, 1)).astype(np.int32),
               "attention_mask": np.ones((B, len(prompt)), np.int32),
               "protein_input_ids": pids, "protein_attention_mask": pmask}
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jax_apply(jm, batch, **static):
    """JAX `Esm2LlamaForCausalLM.apply` on its CPU route, jitted: XLA
    compiles it once instead of every eager primitive (one process takes
    some 240 XLA:CPU compiles, tests/conftest.py)."""
    def run(p, b):
        out = jc.Esm2LlamaForCausalLM.apply(jm.config, p, **b,
                                            attn_impl="xla", **static)
        return out if static else (out.logits, out.loss)

    return jax.jit(run)(jm.params, _j(batch))


def _t(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def test_concat_fusion_matches_jax():
    rng = np.random.default_rng(1)
    enc = rng.standard_normal((2, 5, 8)).astype(np.float32)
    emask = np.array([[0, 0, 1, 1, 1], [0, 1, 1, 1, 1]], np.int32)
    txt = rng.standard_normal((2, 4, 8)).astype(np.float32)
    tmask = np.array([[1, 1, 1, 0], [1, 1, 1, 1]], np.int32)
    labels = rng.integers(0, 9, (2, 4)).astype(np.int32)
    for lab in (None, labels):
        want = jf.concat_fusion(jnp.asarray(enc), jnp.asarray(emask),
                                jnp.asarray(txt), jnp.asarray(tmask),
                                None if lab is None else jnp.asarray(lab))
        got = tf.concat_fusion(torch.from_numpy(enc), torch.from_numpy(emask),
                               torch.from_numpy(txt), torch.from_numpy(tmask),
                               None if lab is None else torch.from_numpy(lab))
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_configs_and_init_tree_match_jax():
    assert te.ESM2Config.t6_8M() == te.ESM2Config(
        **je.ESM2Config.t6_8M().__dict__)
    assert tl.LlamaConfig.llama_3_2_1b() == tl.LlamaConfig(
        **jl.LlamaConfig.llama_3_2_1b().__dict__)
    assert tl.LlamaConfig.llama_3_2_1b().head_dim == 64
    jm, _ = _models()
    got = tc.init_esm2llama_params(_configs()[1], generator=torch.Generator(),
                                   device="cpu")

    def shapes(tree):
        return sorted((jax.tree_util.keystr(path), np.shape(x)) for path, x
                      in jax.tree_util.tree_flatten_with_path(tree)[0])

    assert shapes(tree_to_numpy(got)) == shapes(jm.params)
    nothing = tc.init_esm2llama_params(_configs(None)[1],
                                       generator=torch.Generator(),
                                       device="cpu")
    assert "encoder_adapter" not in nothing


@pytest.mark.parametrize("attn_impl", ["auto", "xla", "flash"])
@pytest.mark.parametrize("adapter", [128, None])
def test_apply_logits_and_loss_match_jax(attn_impl, adapter):
    """Mixed protein lengths, so [enc ‖ text] starts at a different column
    in every row.  Logits at the valid positions within 1e-5, loss within
    1e-5 (padding query rows have no valid key: JAX averages masked keys
    there, the port's K1 gives 0, and no label reads them)."""
    jm, tm = _models(seed=1, decoder_hidden_size=adapter)
    batch = _batch(seed=2)
    want_logits, want_loss = _jax_apply(jm, batch)
    got = tc.Esm2LlamaForCausalLM.apply(tm.config, tm.params(), **_t(batch),
                                        attn_impl=attn_impl)
    valid = np.concatenate([batch["protein_attention_mask"],
                            batch["attention_mask"]], axis=1).astype(bool)
    np.testing.assert_allclose(got.logits.detach().numpy()[valid],
                               np.asarray(want_logits)[valid], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(got.loss), float(want_loss), atol=ATOL,
                               rtol=0)
    enc, emask = tm(protein_input_ids=_t(batch)["protein_input_ids"],
                    protein_attention_mask=_t(batch)[
                        "protein_attention_mask"],
                    return_encoder_output=True)
    jenc, _ = _jax_apply(jm, {k: v for k, v in batch.items()
                              if k.startswith("protein")},
                         return_encoder_output=True)
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), atol=ATOL,
                               rtol=0)
    assert torch.equal(emask, _t(batch)["protein_attention_mask"])


@pytest.mark.parametrize("default_prompt", [False, True])
def test_generate_matches_jax_prompt_included(default_prompt):
    jm, tm = _models(seed=2)
    batch = _batch(seed=3, train=False)
    if default_prompt:        # one bos per row
        batch = {k: v for k, v in batch.items() if k.startswith("protein")}
    want = np.asarray(jm.generate(**{("inputs" if k == "input_ids" else k): v
                                     for k, v in _j(batch).items()},
                                  max_new_tokens=6))
    stats = {}
    got = tm.generate(**{("inputs" if k == "input_ids" else k): v
                         for k, v in _t(batch).items()},
                      max_new_tokens=6, stats=stats)
    np.testing.assert_array_equal(got.numpy(), want)
    P = 1 if default_prompt else batch["input_ids"].shape[1]
    assert got.shape == (3, P + 6)
    if default_prompt:
        assert (got[:, 0] == BOS).all()
    else:
        np.testing.assert_array_equal(got[:, :P].numpy(), batch["input_ids"])
    assert stats["logits_finite"]


def test_model_surface():
    jm, tm = _models()
    with pytest.raises(NotImplementedError, match="contact"):
        tm.predict_contacts()
    for kw in ({"esm_checkpoint_dir": "e"}, {"llama_checkpoint_dir": "l"}):
        with pytest.raises(NotImplementedError, match="§1 item 6"):
            tc.Esm2LlamaForCausalLM.from_pretrained(tm.config, **kw)
    assert tm.parts == ["esm_encoder", "llama_decoder", "encoder_adapter"]
    assert {n for n, _ in tm.named_parameters()} == {
        ".".join(str(k.key) for k in path) for path, _ in
        jax.tree_util.tree_flatten_with_path(jm.params)[0]}


def test_from_pretrained_reads_a_combined_checkpoint(tmp_path):
    from prot2text_tpu_torch.core.checkpoint import save_checkpoint

    _, tm = _models(seed=4)
    save_checkpoint(str(tmp_path), 3, {"model": tm.params(), "step": 3})
    back = tc.Esm2LlamaForCausalLM.from_pretrained(
        tm.config, combined_checkpoint_dir=str(tmp_path),
        dtype=torch.bfloat16)
    for a, b in zip(tree_leaves(tm.params()), tree_leaves(back.params())):
        assert b.dtype == torch.bfloat16 and torch.equal(a.bfloat16(), b)
    rand = tc.Esm2LlamaForCausalLM.from_pretrained(
        tm.config, generator=torch.Generator().manual_seed(0))
    assert all(t.dtype == torch.float32 for t in tree_leaves(rand.params()))


# ---------------------------------------------------------------------------
# the D=64 tbkd lockstep path


def test_kv_cache_layout_matches_jax():
    for D in (16, 64, 96, 128, 256):
        cfg = jd.DecoderConfig(vocab_size=8, hidden_size=2 * D,
                               num_layers=1, num_heads=2, num_kv_heads=1,
                               intermediate_size=8, head_dim=D)
        tcfg = td.DecoderConfig(**cfg.__dict__)
        assert td.kv_cache_layout(tcfg) == jd.kv_cache_layout(cfg)
        want = jkv.init_kv_cache(cfg, 3, 5)["k"].shape
        assert tkv.init_kv_cache(tcfg, 3, 5, device="cpu")["k"].shape == want
        # int8 stays (L, B, Hkv, T, D) at every D; the pool layout is named
        assert tkv.init_kv_cache(tcfg, 3, 5, device="cpu",
                                 kv_bits=8)["k"].shape == (1, 3, 1, 5, D)
        assert tkv.init_kv_cache(tcfg, 3, 5, device="cpu",
                                 layout="bktd")["k"].shape == (1, 3, 1, 5, D)
    with pytest.raises(ValueError, match="int8"):
        tkv.init_kv_cache(tcfg, 3, 5, device="cpu", kv_bits=8,
                          layout="tbkd")


def test_tbkd_cache_refuses_per_row_slots():
    """Per-row (B,) slots on the legacy model's tbkd cache, which the port
    once refused: JAX's decode step and forward take them on tbkd
    (prot2text_tpu/models/decoder.py:1110-1122, :346-355), and so does the
    port now.  The decode step and the forward at per-row slots (one row
    at column 0 in the step) compute what they compute on the same cache
    permuted to bktd: h and the caches, once permuted, within 1e-5, and
    each row's slots the only columns that moved.  (Against JAX itself:
    tests/test_torch_tbkd_rows.py.  The name is kept from when this test
    held the refusal, so its history stays one test's.)"""
    _, tm = _models()
    core = tm.config.llama_config.core()
    params = tm.params()["llama_decoder"]
    cache = tkv.init_kv_cache(core, 2, 8, device="cpu")
    assert cache["k"].shape == (2, 8, 2, 1, 64)
    g = torch.Generator().manual_seed(3)
    for n in cache:
        cache[n].normal_(generator=g)
    old = {n: v.clone() for n, v in cache.items()}
    bk = {n: v.permute(0, 2, 3, 1, 4).contiguous() for n, v in cache.items()}
    emb = torch.randn(2, 1, 128, generator=g)
    slots = torch.tensor([0, 2])
    mask = (torch.arange(8)[None] < slots[:, None]).to(torch.int32)
    step = dict(token_embeds=emb, kv_mask=mask,
                positions=slots[:, None].long(), cache_index=slots)
    h_t, _ = td.decoder_decode_step(core, params, kv_cache=cache, **step)
    h_b, _ = td.decoder_decode_step(core, params, kv_cache=bk,
                                    layout="bktd", **step)
    torch.testing.assert_close(h_t, h_b, atol=1e-5, rtol=0)
    starts = torch.tensor([3, 5])
    fwd = dict(inputs_embeds=emb, positions=starts[:, None].long(),
               bias=torch.zeros(2, 1, 1, 8), cache_index=starts)
    h_t, _ = td.decoder_forward(core, params, kv_cache=cache, **fwd)
    h_b, _ = td.decoder_forward(core, params, kv_cache=bk, layout="bktd",
                                **fwd)
    torch.testing.assert_close(h_t, h_b, atol=1e-5, rtol=0)
    for n in cache:
        torch.testing.assert_close(cache[n].permute(0, 2, 3, 1, 4), bk[n],
                                   atol=1e-5, rtol=0)
        moved = (cache[n] != old[n]).any(dim=(0, 3, 4))        # (T, B)
        assert moved.nonzero().tolist() == [[0, 0], [2, 1], [3, 0], [5, 1]]


def _lockstep_inputs(seed):
    jm, tm = _models(seed=seed)
    batch = _batch(seed=seed, train=False)
    emb, mask = tm.apply(tm.config, tm.params(), **_t(batch),
                         return_encoder_output=True)
    txt = td.embed_tokens(tm.params()["llama_decoder"],
                          _t(batch)["input_ids"])
    emb, mask, _ = tf.concat_fusion(emb, mask, txt,
                                    _t(batch)["attention_mask"])
    return jm, tm, emb.detach().numpy(), mask.numpy().astype(np.int32)


def test_tbkd_lockstep_matches_jax_generate():
    """Llama at D = 64, the tbkd cache in both packages: JAX `generate` and
    the port's greedy tokens identical; then the same loop step by step —
    the prefill cache and the cache after each of 3 decode steps equal to
    JAX's without a permute (atol 1e-5, both computed in f32), each step's
    logits within 1e-5."""
    jm, tm, emb, mask = _lockstep_inputs(seed=5)
    core_j, core_t = jm.config.llama_config.core(), \
        tm.config.llama_config.core()
    assert td.kv_cache_layout(core_t) == jd.kv_cache_layout(core_j) == "tbkd"
    jp, tp = jm.params["llama_decoder"], tm.params()["llama_decoder"]
    N = 4
    gcfg = jgen.GenerationConfig(max_new_tokens=N, eos_token_id=EOS,
                                 pad_token_id=299)
    want = np.asarray(jgen.generate(core_j, jp,
                                    inputs_embeds=jnp.asarray(emb),
                                    attention_mask=jnp.asarray(mask),
                                    gen_cfg=gcfg))
    stats = {}
    got = tgen.generate(core_t, tp, inputs_embeds=torch.from_numpy(emb),
                        attention_mask=torch.from_numpy(mask),
                        gen_cfg=tgen.GenerationConfig(**gcfg.__dict__),
                        stats=stats)
    np.testing.assert_array_equal(got.numpy(), want)

    B, P = mask.shape
    T = P + N
    pos = np.clip(np.cumsum(mask, 1) - 1, 0, None).astype(np.int32)
    prefill = jax.jit(lambda p, e, m, q: jd.decoder_forward(
        core_j, p, inputs_embeds=e, bias=jgen._prefill_bias(m, T),
        positions=q, kv_cache=jkv.init_kv_cache(core_j, B, T),
        cache_index=0, attn_lengths=jd.contiguous_lengths(m)))
    step = jax.jit(lambda p, e, b, q, c, i: jd.decoder_decode_step(
        core_j, p, token_embeds=e, bias_old=b, positions=q, kv_cache=c,
        cache_index=i))
    head = jax.jit(lambda p, h: jd.decoder_logits(core_j, p, h))
    jh, jcache = prefill(jp, jnp.asarray(emb), jnp.asarray(mask),
                         jnp.asarray(pos))
    tcache = tkv.init_kv_cache(core_t, B, T, device="cpu")
    th, tcache = td.decoder_forward(
        core_t, tp, inputs_embeds=torch.from_numpy(emb),
        positions=torch.from_numpy(pos).long(),
        attn_lengths=td.contiguous_lengths(torch.from_numpy(mask)),
        kv_cache=tcache)

    kv_mask = np.zeros((B, T), np.int32)
    kv_mask[:, :P] = mask

    def same_cache(step):
        """Every written column equal; a left-pad column, which no query
        attends, holds each package's own value from layer 2 on (its query
        row sees no valid key: JAX averages, K1 gives 0)."""
        live = kv_mask.T > 0                               # (T, B)
        for n in ("k", "v"):
            w, g = np.asarray(jcache[n]), tcache[n].numpy()
            assert g.shape == w.shape == (2, T, B, 1, 64), step
            np.testing.assert_allclose(g[:, live], w[:, live], atol=ATOL,
                                       rtol=0, err_msg=step)
            np.testing.assert_array_equal(g[:, live.sum(1) == 0], 0.0)
            np.testing.assert_array_equal(w[:, live.sum(1) == 0], 0.0)

    same_cache("prefill")
    jl_ = np.asarray(head(jp, jh[:, -1:]))[:, 0]
    tl_ = td.decoder_logits(core_t, tp, th[:, -1:])[:, 0]
    np.testing.assert_allclose(tl_.numpy(), jl_, atol=ATOL, rtol=0)
    np.testing.assert_allclose(stats["logits"][0].numpy(), jl_, atol=ATOL,
                               rtol=0)
    last = pos[:, -1]
    for t in range(1, N):
        tok = want[:, t - 1]
        e = np.asarray(jp["embed_tokens"])[tok][:, None]
        bias_old = np.where(kv_mask > 0, 0.0, np.finfo(np.float32).min
                            ).astype(np.float32)[:, None, None, :]
        jh, jcache = step(jp, jnp.asarray(e), jnp.asarray(bias_old),
                          jnp.asarray((last + t)[:, None]), jcache,
                          jnp.asarray(P + t - 1, jnp.int32))
        th, tcache = td.decoder_decode_step(
            core_t, tp, token_embeds=torch.from_numpy(e),
            kv_mask=torch.from_numpy(kv_mask),
            positions=torch.from_numpy((last + t)[:, None]).long(),
            kv_cache=tcache, cache_index=P + t - 1)
        kv_mask[:, P + t - 1] = 1
        same_cache(f"decode step {t}")
        # the step wrote its slot: the column is live in every row
        assert np.abs(tcache["k"].numpy()[:, P + t - 1]).min() > 0
        np.testing.assert_allclose(
            td.decoder_logits(core_t, tp, th)[:, 0].numpy(),
            np.asarray(head(jp, jh))[:, 0], atol=ATOL,
            rtol=0)


# ---------------------------------------------------------------------------
# training


@pytest.mark.parametrize("accum", [1, 2])
def test_legacy_train_step_matches_jax(accum):
    """One step of `make_legacy_train_step` (remat on, as the CLIs run it):
    the loss within 1e-4 and every parameter's gradient within 1e-3 of its
    leaf's largest entry, against `jax.value_and_grad` of JAX's loss
    averaged over the micro-batches as the JAX step does; both steps then
    advance the step counter and move every parameter group."""
    jm, tm = _models(seed=7)
    B = 2
    batch = _batch(B=B * accum, seed=8)
    jtx = jopt.step_lr(1e-3, 0.5, 4, grad_clip=1.0)
    ttx = topt.step_lr(1e-3, 0.5, 4, grad_clip=1.0)

    def split(b, lib):
        if accum == 1:
            return b
        return {k: lib.stack(lib.split(v, accum)) if lib is np else
                v.reshape(accum, B, -1) for k, v in b.items()}

    def jloss(p, mb):
        return jc.Esm2LlamaForCausalLM.apply(
            jm.config, p, input_ids=mb["input_ids"],
            attention_mask=mb["attention_mask"], labels=mb["labels"],
            protein_input_ids=mb["protein_input_ids"],
            protein_attention_mask=mb["protein_attention_mask"],
            attn_impl="xla", remat=True).loss

    micro = ([batch] if accum == 1 else
             [{k: v[i * B:(i + 1) * B] for k, v in batch.items()}
              for i in range(accum)])
    want_loss, want_g = 0.0, None
    grad_fn = jax.jit(jax.value_and_grad(jloss))
    for mb in micro:
        l, g = grad_fn(jm.params, _j(mb))
        want_loss += float(l) / accum
        g = jax.tree_util.tree_map(lambda x: np.asarray(x) / accum, g)
        want_g = g if want_g is None else jax.tree_util.tree_map(
            np.add, want_g, g)
    jstate = jopt.TrainState.create(jm.params, jtx)
    jstep = jax.jit(jlegacy.make_legacy_train_step(
        config=jm.config, tx=jtx, grad_accum=accum))
    jstate, jl_ = jstep(jstate, _j(split(batch, np)))
    np.testing.assert_allclose(float(jl_), want_loss, atol=1e-6, rtol=0)

    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                             requires_grad=True).tree()
    before = {name: [p.detach().clone() for p in tree_leaves(params[name])]
              for name in params}
    tstate = topt.TrainState.create(params, ttx)
    tstep = tlegacy.make_legacy_train_step(config=tm.config, tx=ttx,
                                           grad_accum=accum)
    tstate, loss = tstep(tstate, split(_t(batch), torch))
    np.testing.assert_allclose(float(loss), want_loss, atol=1e-4, rtol=0)
    leaves = jax.tree_util.tree_leaves(want_g)
    assert len(leaves) == len(tree_leaves(params))
    for p, w in zip(tree_leaves(params), leaves):
        g = p.grad.numpy() / accum
        np.testing.assert_allclose(g, w, atol=1e-3 * np.abs(w).max(), rtol=0)
    assert tstate.step == int(jstate.step) == 1
    for name in ("esm_encoder", "encoder_adapter", "llama_decoder"):
        assert all(not torch.equal(a, p.detach()) for a, p in zip(
            before[name], tree_leaves(params[name]))), name
