"""Medusa draft heads in the port (`models/medusa.py`, `train/draft.py`, the
serving engine's Medusa branch, `cli/train_draft.py`, `serve
--medusa_path`) against the JAX package on the same weights, f32 on the
CPU:

  * `medusa_hidden` and `medusa_drafts` within 1e-5 of JAX (untied and tied
    heads); zero-init heads draft the frontier token;
  * `medusa_loss` and its head gradients against `jax.value_and_grad`
    (loss 1e-5, gradients rtol 1e-4) for token batches and for embedding
    batches with -100 labels, and one AdamW step against JAX's
    `make_medusa_train_step`;
  * engines with nonzero heads: the tokens and the target forwards of the
    JAX engine, and the plain engine's tokens, on the f32 pool (a refill,
    an EOS stop) and on the int8 pool with the dedup prefix (K9c's plain
    version against JAX's Pallas kernel in interpret mode, under a top-1
    margin guard); the
    controller's plain fallbacks keep the frontier fresh; Medusa with
    prompt lookup and with sampling raises JAX's ValueError;
  * `cli/train_draft.py` → npz → `cli/serve.py --medusa_path` end to end,
    the served predictions those of plain serving."""

import importlib
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prot2text_tpu.infer import serving as jserv
from prot2text_tpu.models import decoder as jd
from prot2text_tpu.models import medusa as jm
from prot2text_tpu.train import draft as jdraft
from prot2text_tpu.train import optim as joptim
from prot2text_tpu_torch.cli import serve as serve_cli
from prot2text_tpu_torch.cli import train_draft as draft_cli
from prot2text_tpu_torch.infer import serving as tserv
from prot2text_tpu_torch.infer.generate import GenerationConfig
from prot2text_tpu_torch.models import decoder as td
from prot2text_tpu_torch.models import medusa as tm
from prot2text_tpu_torch.models import quant as tquant
from prot2text_tpu_torch.models import transformer as tt
from prot2text_tpu_torch.models.weights import params_from_jax, tree_to_numpy
from prot2text_tpu_torch.train import draft as tdraft
from prot2text_tpu_torch.train.optim import TrainState, adamw_constant

# the module, not the `generate` function the package re-exports
jgen = importlib.import_module("prot2text_tpu.infer.generate")
VOCAB, HIDDEN, K = 96, 64, 3


def _both(tree):
    """A numpy tree → (JAX tree, port tree) holding the same values."""
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_jax(tree).tree())


def _model(tie=False, seed=0, successor=0.0, head_dim=16):
    """A tiny decoder in both packages, drawn by the port's init.
    successor=c > 0 makes it decisive: the embeddings 20 times larger and
    the head c times their directions, permuted, so each token's
    successor leads the logits by a wide margin."""
    tcfg = td.DecoderConfig(
        vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=128, head_dim=head_dim,
        rope_theta=1e4, tie_word_embeddings=tie)
    tree = tree_to_numpy(td.init_decoder_params(
        tcfg, generator=torch.Generator().manual_seed(seed), device="cpu"))
    if tie:
        tree.pop("lm_head", None)
    if successor:
        E = tree["embed_tokens"]
        succ = np.random.default_rng(seed).permutation(VOCAB)
        W = np.zeros((HIDDEN, VOCAB), np.float32)
        W[:, succ] = E.T * successor
        tree["lm_head"]["kernel"] = W
        tree["embed_tokens"] = E * 20.0
    return (jd.DecoderConfig(**tcfg.__dict__), tcfg) + _both(tree)


def _heads(scale, seed=1, k=K):
    """Nonzero random heads as numpy {"w", "b"}."""
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal((k, HIDDEN, HIDDEN))
                  ).astype(np.float32),
            "b": (scale * rng.standard_normal((k, HIDDEN))
                  ).astype(np.float32)}


@pytest.fixture(scope="module")
def f32_model():
    return _model()


@pytest.mark.parametrize("head", ["untied", "tied", "int8"])
def test_hidden_and_drafts_match_jax(monkeypatch, head):
    """Untied and tied heads within 1e-5 of JAX, drafts equal.  An int8
    head (the port's `quantize_params`, its tree carried to JAX) takes
    K14's wrapper at the B·K rows of the drafts; it rounds x to bf16,
    JAX's XLA route does not, so its logits sit within 1e-2 of max|logit|
    of JAX's."""
    jcfg, tcfg, jp, tp = _model(tie=head == "tied")
    if head == "int8":
        tp = tquant.quantize_params(tp, bits=8)
        jp = jax.tree_util.tree_map(jnp.asarray, tree_to_numpy(tp))
        rows = []
        real = tt.quant_matmul_int8
        monkeypatch.setattr(tt, "quant_matmul_int8", lambda x, *a: (
            rows.append(x.shape[0]) or real(x, *a)))
    heads = _heads(0.3)
    h = np.random.default_rng(2).standard_normal((5, HIDDEN)).astype(
        np.float32)
    jh, th = jnp.asarray(h), torch.from_numpy(h)
    jmed, tmed = _both(heads)
    got = tm.medusa_hidden(tmed, th)
    want = np.asarray(jm.medusa_hidden(jmed, jh))
    assert got.shape == (5, K, HIDDEN)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    logits = td.decoder_logits(tcfg, tp, got)
    jlogits = np.asarray(jd.decoder_logits(jcfg, jp, jnp.asarray(want)))
    drafts = tm.medusa_drafts(tcfg, tp, tmed, th)
    assert torch.equal(drafts, torch.argmax(logits, dim=-1))
    if head == "int8":
        assert rows == [5 * K, 5 * K]
        err = np.abs(logits.numpy() - jlogits).max()
        assert err <= 1e-2 * np.abs(jlogits).max()
        return
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        drafts.numpy(), np.asarray(jm.medusa_drafts(jcfg, jp, jmed, jh)))


def test_zero_heads_draft_the_frontier_token(f32_model):
    _, tcfg, _, tp = f32_model
    med = tm.init_medusa_params(tm.MedusaConfig(HIDDEN, K))
    assert not med["w"].any() and not med["b"].any()
    h = torch.randn(5, HIDDEN, generator=torch.Generator().manual_seed(2))
    base = torch.argmax(td.decoder_logits(tcfg, tp, h), dim=-1)
    assert torch.equal(tm.medusa_drafts(tcfg, tp, med, h),
                       base[:, None].expand(5, K))
    g = torch.Generator().manual_seed(0)
    rand = tm.init_medusa_params(tm.MedusaConfig(HIDDEN, K), g, scale=0.1)
    assert rand["w"].std() > 0.05 and not rand["b"].any()


def _batch(form):
    """(numpy batch, its torch twin) at B 3, S 12: token ids right-padded,
    or embeddings left-padded with labels -100 on the prompt span (one
    contiguous run a row, as the collators build them)."""
    rng = np.random.default_rng(4)
    B, S = 3, 12
    lens = (12, 9, 5)
    mask = np.zeros((B, S), np.int32)
    if form == "ids":
        ids = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
        for i, n in enumerate(lens):
            mask[i, :n] = 1
            ids[i, n:] = 0
        batch = {"input_ids": ids, "attention_mask": mask}
    else:
        emb = rng.standard_normal((B, S, HIDDEN)).astype(np.float32)
        labels = np.full((B, S), -100, np.int32)
        for i, n in enumerate(lens):
            mask[i, S - n:] = 1
            labels[i, S - n + 3:] = rng.integers(0, VOCAB, n - 3)
        batch = {"inputs_embeds": emb, "attention_mask": mask,
                 "labels": labels}
    return batch, {k: torch.from_numpy(v).long() if v.dtype == np.int32
                   else torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("form", ["ids", "embeds"])
def test_loss_grads_and_step_match_jax(f32_model, form):
    """The loss and the heads' gradients against `jax.value_and_grad`;
    on the token batch also one AdamW step of each package's train
    step."""
    jcfg, tcfg, jp, tp = f32_model
    heads = _heads(0.05)
    batch, tbatch = _batch(form)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmed = jax.tree_util.tree_map(jnp.asarray, heads)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda m: jdraft.medusa_loss(jcfg, jp, m, jbatch)))(jmed)
    tmed = params_from_jax(heads, requires_grad=True).tree()
    got = tdraft.medusa_loss(tcfg, tp, tmed, tbatch)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), atol=1e-5, rtol=0)
    for k in ("w", "b"):
        g, w = tmed[k].grad.numpy(), np.asarray(grads[k])
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    assert all(not t.requires_grad for t in jax.tree_util.tree_leaves(tp))
    if form != "ids":
        return
    lr = 1e-3
    jtx = joptim.adamw_constant(lr)
    jstate, jloss = jdraft.make_medusa_train_step(jcfg, jtx)(
        joptim.TrainState.create(jmed, jtx), jp, jbatch)
    tx = adamw_constant(lr)
    state = TrainState.create(
        {k: torch.from_numpy(v.copy()) for k, v in heads.items()}, tx)
    state, tloss = tdraft.make_medusa_train_step(tcfg, tx)(state, tp, tbatch)
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=1e-5, rtol=0)
    assert state.step == 1
    for k in ("w", "b"):
        new = state.params[k].detach().numpy()
        np.testing.assert_allclose(new, np.asarray(jstate.params[k]),
                                   atol=1e-6, rtol=0)
        assert np.abs(new - heads[k]).max() > 0.5 * lr


def _prompt(seed, P):
    return np.random.default_rng(seed).standard_normal((P, HIDDEN)).astype(
        np.float32)


PREFIX = _prompt(99, 5)


def _serve(eng, reqs):
    for rid, emb, n, *upfx in reqs:
        eng.submit(rid, emb, max_new_tokens=n,
                   use_prefix=upfx[0] if upfx else None)
    return dict(eng.run())


def _reqs():
    """Ragged budgets, four requests for three slots (a refill)."""
    return [("a", _prompt(1, 3), 14), ("b", _prompt(2, 6), 6),
            ("c", _prompt(3, 7), 16), ("d", _prompt(5, 8), 10)]


def _engines(jcfg, tcfg, jp, tp, med, dtype=torch.float32, **kw):
    """(port engine, JAX engine) with the same arguments; `med` numpy
    heads or None."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    teng = tserv.ContinuousBatcher(
        tcfg, tp, cache_dtype=dtype, medusa_params=None if med is None else
        params_from_jax(med, dtype=dtype).tree(), **kw)
    jeng = jserv.ContinuousBatcher(
        jcfg, jp, cache_dtype=jdt, medusa_params=None if med is None else
        jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), med), **kw)
    return teng, jeng


F32_KW = dict(max_slots=3, max_len=16 + 16, prompt_pad=16, sync_every=4)


def test_f32_engine_matches_jax_and_plain(f32_model):
    """Near-identity heads (so drafts get accepted where the stream
    repeats) on the f32 pool: tokens and verify rounds equal JAX's, tokens
    equal plain serving's, an EOS stop; then the controller, whose plain
    fallbacks keep the frontier hidden state fresh, with the same
    tokens."""
    jcfg, tcfg, jp, tp = f32_model
    reqs = _reqs()
    plain = _serve(tserv.ContinuousBatcher(
        tcfg, tp, cache_dtype=torch.float32, eos_token_id=-1, **F32_KW),
        reqs)
    eos = plain["a"][4]
    want = _serve(tserv.ContinuousBatcher(
        tcfg, tp, cache_dtype=torch.float32, eos_token_id=eos, **F32_KW),
        reqs)
    med = _heads(0.02, seed=3)
    teng, jeng = _engines(jcfg, tcfg, jp, tp, med, eos_token_id=eos,
                          **F32_KW)
    got = _serve(teng, reqs)
    assert got == want and got == _serve(jeng, reqs)
    assert got["a"] == plain["a"][:plain["a"].index(eos) + 1]
    assert teng.spec_gamma == K and "hist" not in teng.state
    assert teng.state["last_hidden"].shape == (3, HIDDEN)
    assert teng.plain_steps == 0 and teng.steps == jeng.steps
    assert teng.acceptance() > 1.0, "no draft accepted: pick other heads"

    ctl = tserv.ContinuousBatcher(
        tcfg, tp, cache_dtype=torch.float32, eos_token_id=eos,
        medusa_params=params_from_jax(med).tree(), spec_break_even=10.0,
        spec_probe_every=2, **F32_KW)
    assert _serve(ctl, reqs) == want
    assert ctl.spec_fallbacks > 0 and ctl.verify_rounds > 0
    assert ctl.plain_steps == ctl.spec_fallbacks * F32_KW["sync_every"]


MARGIN = 2.0        # vs logits of magnitude ~30 computed in bf16 with an
                    # int8 cache: ~1% error, well under half the margin


def _margins(tcfg, tparams, seq, toks):
    """Top-1 minus top-2 logit at every generated position, from an f32
    teacher-forced forward over the prompt and the tokens."""
    p32 = jax.tree_util.tree_map(lambda t: t.float(), tparams)
    x = torch.cat([torch.from_numpy(seq),
                   p32["embed_tokens"][torch.tensor(toks[:-1])]])[None]
    n = x.shape[1]
    h, _ = td.decoder_forward(
        tcfg, p32, inputs_embeds=x, positions=torch.arange(n)[None],
        attn_lengths=td.contiguous_lengths(torch.ones(1, n)))
    lg = td.decoder_logits(tcfg, p32, h)[0, len(seq) - 1:]
    top = torch.topk(lg, 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).min().item()


def test_int8_prefix_engine_matches_jax_with_margin(monkeypatch):
    """The int8 pool with the dedup prefix (K9c's plain version every
    round; JAX's Pallas K9c in interpret mode) on a decisive bf16 model
    with nonzero heads: every request's top-1 margin first, then tokens
    equal to JAX's and to the port's plain int8 engine."""
    monkeypatch.setenv("P2T_PALLAS_FORCE_INTERPRET", "1")
    jcfg, tcfg, jp, _ = _model(seed=5, successor=20.0, head_dim=128)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(
            jnp.float32)), jp)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), jp)
    tp = params_from_jax(tree, dtype=torch.bfloat16).tree()
    E = tree["embed_tokens"]
    rng = np.random.default_rng(40)
    reqs = [(f"r{i}", E[rng.integers(0, VOCAB, 3 + 2 * i)], n)
            for i, n in enumerate((10, 7, 12))]
    kw = dict(max_slots=3, max_len=16 + 12, prompt_pad=16, eos_token_id=-1,
              sync_every=4, kv_bits=8, shared_prefix_embeds=PREFIX,
              prefix_dedup=True)
    teng, jeng = _engines(jcfg, tcfg, jp, tp, _heads(0.05, seed=6),
                          dtype=torch.bfloat16, **kw)
    got = _serve(teng, reqs)
    for rid, emb, _ in reqs:
        m = _margins(tcfg, tp, np.concatenate([PREFIX, emb]), got[rid])
        assert m > MARGIN, (f"request {rid}: top-1 margin {m:.3f} <= "
                            f"{MARGIN}; pick another seed")
    assert teng._spec_fused and jeng._spec_fused
    assert teng.state["k"].dtype == torch.int8
    assert teng.verify_rounds > 0 and teng.plain_steps == 0
    assert got == _serve(jeng, reqs)
    plain = tserv.ContinuousBatcher(tcfg, tp, cache_dtype=torch.bfloat16,
                                    **kw)
    assert got == _serve(plain, reqs)


@pytest.mark.parametrize("case,match", [
    ("prompt_lookup", "mutually exclusive"), ("sampling", "greedy-only")])
def test_refusals_match_jax(f32_model, case, match):
    """Medusa beside prompt lookup, or with a sampling gen_cfg: JAX's
    ValueError, word for word."""
    jcfg, tcfg, jp, tp = f32_model
    med = _heads(0.1)
    kw = dict(max_slots=2, max_len=8 + 6, prompt_pad=8, eos_token_id=-1)
    if case == "prompt_lookup":
        tkw = jkw = dict(kw, prompt_lookup_tokens=2)
    else:
        tkw = dict(kw, gen_cfg=GenerationConfig(do_sample=True))
        jkw = dict(kw, gen_cfg=jgen.GenerationConfig(do_sample=True))
    with pytest.raises(ValueError, match=match) as t:
        tserv.ContinuousBatcher(tcfg, tp, cache_dtype=torch.float32,
                                medusa_params=params_from_jax(med).tree(),
                                **tkw)
    with pytest.raises(ValueError, match=match) as j:
        jserv.ContinuousBatcher(
            jcfg, jp, cache_dtype=jnp.float32,
            medusa_params=jax.tree_util.tree_map(jnp.asarray, med), **jkw)
    assert str(t.value) == str(j.value)


CSV_ROWS = """AlphaFoldDB,Full Name,taxon,sequence,function
P00001,Cytochrome c,Homo sapiens,MGDVEKGKKIFIMKCSQCHTVEK,Electron carrier protein.
P00002,Lysozyme C,Gallus gallus,KVFGRCELAAAMKRHGLDNYRGY,Hydrolyzes peptidoglycan.
P00003,Myoglobin,Physeter catodon,MVLSEGEWQLVLHVWAKVEADVAGHGQDILIRLF,Oxygen storage.
P00004,Ubiquitin,Homo sapiens,MQIFVKTLTGKTITLEVEPSDTI,Protein degradation signal.
P00005,Insulin,Homo sapiens,MALWMRLLPLLALLALWGPDPAAAFVNQHLCGSHLVEAL,Hormone.
"""


def test_train_draft_then_serve_medusa_path(tmp_path, capsys):
    """train_draft on the CPU writes float32 {"w", "b"} equal to the heads
    it returns; serve --medusa_path loads them (fp32 as they are; bf16
    under int4, never an integer) and serves the plain predictions."""
    csv = tmp_path / "t.csv"
    csv.write_text(CSV_ROWS)
    npz = str(tmp_path / "heads.npz")
    common = ["--device", "cpu", "--debug_tiny_model", "true",
              "--model_dtype", "fp32"]
    heads = draft_cli.main(["--train_csv", str(csv), *common,
                            "--batch_size", "2", "--max_sequence_length",
                            "24", "--num_heads", "3", "--output_path", npz])
    out = capsys.readouterr().out
    assert "medusa loss" in out and "saved 3 heads" in out
    z = np.load(npz)
    assert sorted(z.files) == ["b", "w"] and z["w"].dtype == np.float32
    for k in ("w", "b"):
        assert np.array_equal(z[k], heads[k].detach().numpy())
    assert np.abs(z["w"]).max() > 0
    loaded = serve_cli.load_medusa_heads(npz, torch.float32, "cpu")
    assert all(torch.equal(loaded[k], heads[k].detach()) for k in loaded)
    assert all(t.dtype == torch.bfloat16 for t in
               serve_cli.load_medusa_heads(npz, "int4", "cpu").values())

    serve = ["--test_csv", str(csv), *common, "--max_new_tokens", "8",
             "--prompt_pad", "128,256,512"]
    got = serve_cli.main(serve + ["--medusa_path", npz, "--output_dir",
                                  str(tmp_path / "medusa")])
    assert "verify rounds accepting" in capsys.readouterr().out
    want = serve_cli.main(serve + ["--output_dir", str(tmp_path / "plain")])
    assert got == want and len(got) == 5
    with open(tmp_path / "medusa" / "generation_serve_0.json") as f:
        assert json.load(f) == got
