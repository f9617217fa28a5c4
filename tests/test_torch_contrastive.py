"""Stage-1 contrastive training against prot2text_tpu/train/contrastive.py:
tiny ESMC + tiny Qwen3, the JAX params through the weight bridge, adapter
dropout 0 on both sides (the dropout bits of `jax.random` cannot be
reproduced), f32.  Compared: the readouts and InfoNCE losses (1e-6), ESMC
at attn_impl "xla" and "flash" (1e-5 of max|h|), `text_hidden_at_layer`
(1e-5 of max|h|), `contrastive_loss` and its adapter gradients (loss 1e-5,
gradients rtol 1e-4 of each leaf's max), the per-epoch schedule (1e-7 of
base lr: JAX evaluates it in float32), and 3 AdamW steps of
`make_contrastive_train_step` with grad_accum 2 (params 1e-5 = 1e-3·lr, as
tests/test_torch_sft.py), then one more step of both from the JAX state
carried over (adapter and optimizer moments in JAX's layout)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prot2text_tpu.models import adapters as ja
from prot2text_tpu.models import esmc as jesmc
from prot2text_tpu.models import qwen3 as jq
from prot2text_tpu.train import contrastive as jc
from prot2text_tpu.train import optim as jopt
from prot2text_tpu_torch.kernels import flash_attention as tfa
from prot2text_tpu_torch.models import adapters as ta
from prot2text_tpu_torch.models import esmc as tesmc
from prot2text_tpu_torch.models import qwen3 as tq
from prot2text_tpu_torch.models.weights import (
    params_from_jax, tree_leaves, tree_to_numpy,
)
from prot2text_tpu_torch.train import contrastive as tc
from prot2text_tpu_torch.train import optim as topt

ESMC = dict(d_model=64, n_layers=2, n_heads=4)
QWEN = dict(vocab_size=300, hidden_size=64, num_layers=3, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=96)
ADAPTER = (64, 48, 64)
B, P, SD, ACCUM = 4, 16, 24, 2
CCFG = dict(temperature=0.05, num_segments=2, output_llm_layer=2)
OPT = dict(warmup_frac=0.34, grad_clip=0.05)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(rng):
    """ACCUM x B records: right-padded proteins and descriptions."""
    out = {k: [] for k in tc.BATCH_KEYS}
    for _ in range(ACCUM * B):
        n = int(rng.integers(4, P - 2))
        prot = np.ones(P, np.int32)
        prot[:n + 2] = np.r_[0, rng.integers(4, 24, n), 2]
        d = int(rng.integers(5, SD))
        desc = np.zeros(SD, np.int32)
        desc[:d] = rng.integers(3, 290, d)
        dmask = (np.arange(SD) < d).astype(np.int32)
        for k, v in zip(tc.BATCH_KEYS, (prot, (prot != 1).astype(np.int32),
                                        desc, dmask)):
            out[k].append(v)
    return {k: np.stack(v).reshape(ACCUM, B, -1) for k, v in out.items()}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    jcfgs = (jesmc.ESMCConfig(**ESMC),
             ja.ModalityAdapterConfig(*ADAPTER, dropout_rate=0.0),
             jq.Qwen3Config(**QWEN).core())
    tcfgs = (tesmc.ESMCConfig(**ESMC),
             ta.ModalityAdapterConfig(*ADAPTER, dropout_rate=0.0),
             tq.Qwen3Config(**QWEN).core())
    frozen = {"esm_encoder": _np(jesmc.init_esmc_params(jcfgs[0], keys[0])),
              "llm_decoder": _np(jq.init_qwen3_params(jq.Qwen3Config(**QWEN),
                                                      keys[1]))}
    adapter = _np(ja.init_modality_adapter_params(jcfgs[1], keys[2]))
    return dict(jcfgs=jcfgs, tcfgs=tcfgs, frozen=frozen, adapter=adapter,
                batch=_batch(rng))


def _kw(cfgs, mod):
    esm_config, adapter_config, decoder_core = cfgs
    return dict(esm_config=esm_config, adapter_config=adapter_config,
                decoder_core=decoder_core, cfg=mod.ContrastiveConfig(**CCFG))


def _tfrozen(s):
    return {k: params_from_jax(v).tree() for k, v in s["frozen"].items()}


def _tbatch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long()
            for k, v in batch.items()}


def _micro(s, i=0):
    return {k: v[i] for k, v in s["batch"].items()}


def _rel(got, want, tol, msg=""):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=msg)


@pytest.mark.parametrize("readout", ["last", "mean", "std", "mix"])
def test_readout_embeddings_match_jax(readout):
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((3, 7, 5)).astype(np.float32)
    mask = (np.arange(7)[None] < np.array([[7], [3], [1]])).astype(np.int32)
    want = np.asarray(jax.jit(lambda e, m: jc.readout_embeddings(
        e, m, readout))(emb, mask))
    got = tc.readout_embeddings(torch.from_numpy(emb),
                                torch.from_numpy(mask), readout).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_infonce_losses_match_jax():
    rng = np.random.default_rng(2)
    x1, x2 = (rng.standard_normal((6, 8)).astype(np.float32)
              for _ in range(2))
    labels = np.array([3, 4, 5])

    @jax.jit
    def ref(a, b):
        z1, z2 = jc._l2(a), jc._l2(b)
        return (z1, z2, jc.batch_infonce_loss(z1, z2),
                jc.segmented_infonce_loss(z1[3:], z2, labels, 0.07))

    z1, z2, batch_loss, seg_loss = map(np.array, ref(x1, x2))
    t1, t2 = tc._l2(torch.from_numpy(x1)), tc._l2(torch.from_numpy(x2))
    np.testing.assert_allclose(t1.numpy(), z1, atol=1e-6)
    np.testing.assert_allclose(tc.batch_infonce_loss(t1, t2).item(),
                               batch_loss, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        tc.segmented_infonce_loss(t1[3:], t2, torch.from_numpy(labels),
                                  0.07).item(),
        seg_loss, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_esmc_encode_attn_impl_matches_jax(setup, impl, monkeypatch):
    """ESMC under "flash" takes K6 (its plain version here: the spy counts
    one call per layer) and agrees with JAX's "flash" route, which at S =
    16 is chunked XLA; "xla" takes the plain function, no K6."""
    s = setup
    calls = []
    fwd = tfa.flash_attention_bias_fwd
    monkeypatch.setattr(tfa, "flash_attention_bias_fwd",
                        lambda *a: calls.append(1) or fwd(*a))
    mb = _micro(s)
    ids, mask = mb["protein_input_ids"], mb["protein_attention_mask"]
    want = np.asarray(jax.jit(lambda p, i, m: jesmc.esmc_encode(
        s["jcfgs"][0], p, i, m, attn_impl=impl))(
            s["frozen"]["esm_encoder"], ids, mask))
    got = tesmc.esmc_encode(
        s["tcfgs"][0], _tfrozen(s)["esm_encoder"], torch.from_numpy(ids),
        torch.from_numpy(mask), attn_impl=impl).numpy()
    _rel(got, want, 1e-5)
    assert len(calls) == (ESMC["n_layers"] if impl == "flash" else 0)


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_text_hidden_at_layer_matches_jax(setup, impl):
    """HF hidden_states[2] of a 3-layer decoder (the first 2 layers, no
    final norm) over right-padded descriptions."""
    s = setup
    mb = _micro(s)
    ids, mask = (mb["description_input_ids"],
                 mb["description_attention_mask"])
    want = np.asarray(jax.jit(lambda p, i, m: jc.text_hidden_at_layer(
        s["jcfgs"][2], p, i, m, 2, impl))(
            s["frozen"]["llm_decoder"], ids, mask))
    got = tc.text_hidden_at_layer(
        s["tcfgs"][2], _tfrozen(s)["llm_decoder"], torch.from_numpy(ids),
        torch.from_numpy(mask), 2, impl).numpy()
    valid = mask.astype(bool)
    _rel(got[valid], want[valid], 1e-5)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_contrastive_loss_and_grads_match_jax(setup, impl):
    s = setup
    mb = _micro(s)
    loss_fn = lambda ad: jc.contrastive_loss(
        ad, s["frozen"], mb, deterministic=True, attn_impl=impl,
        **_kw(s["jcfgs"], jc))
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        s["adapter"])
    adapter = params_from_jax(s["adapter"], requires_grad=True).tree()
    loss = tc.contrastive_loss(adapter, _tfrozen(s), _tbatch(mb),
                               deterministic=True, attn_impl=impl,
                               **_kw(s["tcfgs"], tc))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5,
                               rtol=0)
    got = jax.tree_util.tree_leaves(tree_to_numpy(
        jax.tree_util.tree_map(lambda p: p.grad, adapter)))
    want = jax.tree_util.tree_leaves_with_path(_np(want_grads))
    assert len(got) == len(want) == 4
    for g, (path, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_per_epoch_schedule_matches_jax():
    kw = dict(total_steps=12, warmup_frac=0.06, steps_per_period=5)
    want = jopt.cosine_warmup_schedule(2e-4, **kw)
    got = topt.cosine_warmup_schedule(2e-4, **kw)
    for t in range(70):
        np.testing.assert_allclose(got(t), float(want(t)), rtol=0,
                                   atol=1e-7 * 2e-4, err_msg=str(t))


def _adam_moments(opt_state):
    """The (count, mu, nu) of optax's ScaleByAdamState inside a chain."""
    if hasattr(opt_state, "mu"):
        return opt_state
    for sub in opt_state:
        found = _adam_moments(sub) if isinstance(sub, tuple) else None
        if found is not None:
            return found
    return None


def test_three_accumulated_adamw_steps_match_jax(setup):
    s = setup
    jtx = jopt.adamw_cosine_warmup(1e-2, total_steps=4, **OPT)
    jstep = jax.jit(jc.make_contrastive_train_step(
        tx=jtx, attn_impl="flash", grad_accum=ACCUM,
        **_kw(s["jcfgs"], jc)))
    jstate = jopt.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, s["adapter"]), jtx)
    ttx = topt.adamw_cosine_warmup(1e-2, total_steps=4, **OPT)
    tstep = tc.make_contrastive_train_step(
        tx=ttx, attn_impl="flash", grad_accum=ACCUM, **_kw(s["tcfgs"], tc))
    tstate = topt.TrainState.create(
        params_from_jax(s["adapter"], requires_grad=True).tree(), ttx)
    frozen, batch = _tfrozen(s), _tbatch(s["batch"])
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        jstate, jloss = jstep(jstate, s["frozen"], s["batch"],
                              jax.random.PRNGKey(i))
        tstate, tloss = tstep(tstate, frozen, batch, gen)
        np.testing.assert_allclose(tloss.item(), float(jloss), atol=1e-5,
                                   rtol=0)
    assert tstate.step == int(jstate.step) == 3
    got = jax.tree_util.tree_leaves(tree_to_numpy(tstate.params))
    want = jax.tree_util.tree_leaves_with_path(_np(jstate.params))
    moved = 0
    for g, (path, w), w0 in zip(got, want,
                                jax.tree_util.tree_leaves(s["adapter"])):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
        moved += int(np.abs(w - w0).max() > 1e-4)
    assert moved == len(want)

    # both packages resume from the JAX state: adapter, moments and count
    # carried over in JAX's layout
    adam = _adam_moments(jstate.opt_state)
    carried = topt.TrainState(
        params=params_from_jax(_np(jstate.params),
                               requires_grad=True).tree(),
        opt_state={"count": int(adam.count),
                   "mu": params_from_jax(_np(adam.mu)).tree(),
                   "nu": params_from_jax(_np(adam.nu)).tree()},
        step=int(jstate.step))
    for a, b in zip(jax.tree_util.tree_leaves(tree_to_numpy(
            tstate.opt_state["nu"])), jax.tree_util.tree_leaves(
            _np(adam.nu))):
        _rel(a, b, 1e-4)
    jstate, jloss = jstep(jstate, s["frozen"], s["batch"],
                          jax.random.PRNGKey(3))
    carried, tloss = tstep(carried, frozen, batch, gen)
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=1e-5,
                               rtol=0)
    for g, w in zip(tree_leaves(carried.params),
                    jax.tree_util.tree_leaves(_np(jstate.params))):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-5, rtol=0)
