"""The SFT slice as a whole against prot2text_tpu/train/sft.py: tiny ESMC +
tiny Qwen3 (head_dim 64, S = 256, so the JAX side can take its Pallas
route), the JAX params through the weight bridge, LoRA B non-zero, adapter
dropout 0 on both sides (the dropout bits of `jax.random` cannot be
reproduced).  Compared: `sft_loss` (f32, atol 1e-5), the LoRA and adapter
gradients (rtol 1e-4 of each leaf's largest entry), and the trainable params
after 3 clipped AdamW steps with grad_accum = 2 (atol 1e-5 = 1e-3·lr: Adam
divides each entry's gradient by its own RMS, so an entry whose gradient is
near zero turns its larger relative disagreement into a step of size up to
lr).  The JAX side runs its XLA attention and, under
P2T_PALLAS_FORCE_INTERPRET=1, its Pallas flash kernels (forward and the
backward the port's K5 replaces) in interpret mode; the port takes its
"auto" route, K1/K5, whose CPU tensors run the plain versions.  Then both
packages at attn_impl "xla" and "flash" (the port's ESMC through K6/K6b's
plain versions)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prot2text_tpu.models import adapters as ja
from prot2text_tpu.models import esmc as jesmc
from prot2text_tpu.models import lora as jlora
from prot2text_tpu.models import qwen3 as jq
from prot2text_tpu.train import optim as jopt
from prot2text_tpu.train import sft as jsft
from prot2text_tpu_torch.models import adapters as ta
from prot2text_tpu_torch.models import esmc as tesmc
from prot2text_tpu_torch.models import lora as tlora
from prot2text_tpu_torch.models import qwen3 as tq
from prot2text_tpu_torch.models.weights import (
    params_from_jax, tree_leaves, tree_to_numpy,
)
from prot2text_tpu_torch.train import optim as topt
from prot2text_tpu_torch.train import sft as tsft

PH = 299                       # placeholder id in the tiny vocab
ESMC = dict(d_model=64, n_layers=2, n_heads=4)
QWEN = dict(vocab_size=300, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=64, intermediate_size=96)
ADAPTER = (64, 48, 64)
S, P, B, ACCUM = 256, 16, 2, 2
OPT = dict(total_steps=10, warmup_frac=0.1, weight_decay=0.01,
           grad_clip=0.05)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(rng):
    """ACCUM x B records: left-padded prompt with one placeholder per valid
    protein token, a description with labels, right padding."""
    keys = ("protein_input_ids", "protein_attention_mask", "input_ids",
            "attention_mask", "labels")
    out = {k: [] for k in keys}
    for _ in range(ACCUM * B):
        n = int(rng.integers(6, P - 2))
        prot = np.ones(P, np.int32)
        prot[:n + 2] = np.r_[0, rng.integers(4, 24, n), 2]
        pad_l = int(rng.integers(0, 40))
        desc = int(rng.integers(20, 60))
        prompt = np.r_[rng.integers(3, 250, 7), np.full(n + 2, PH),
                       rng.integers(3, 250, 5)]
        ids = np.zeros(S, np.int32)
        mask = np.zeros(S, np.int32)
        labels = np.full(S, -100, np.int32)
        end = pad_l + len(prompt)
        ids[pad_l:end] = prompt
        ids[end:end + desc] = rng.integers(3, 250, desc)
        mask[pad_l:end + desc] = 1
        labels[end:end + desc] = ids[end:end + desc]
        for k, v in zip(keys, (prot, (prot != 1).astype(np.int32), ids, mask,
                               labels)):
            out[k].append(v)
    return {k: np.stack(v).reshape(ACCUM, B, -1) for k, v in out.items()}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    jcfgs = (jesmc.ESMCConfig(**ESMC),
             ja.ModalityAdapterConfig(*ADAPTER, dropout_rate=0.0),
             jq.Qwen3Config(**QWEN).core())
    tcfgs = (tesmc.ESMCConfig(**ESMC),
             ta.ModalityAdapterConfig(*ADAPTER, dropout_rate=0.0),
             tq.Qwen3Config(**QWEN).core())
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    esm = jesmc.init_esmc_params(jcfgs[0], keys[0])
    llm = jq.init_qwen3_params(jq.Qwen3Config(**QWEN), keys[1])
    adapter = ja.init_modality_adapter_params(jcfgs[1], keys[2])
    lcfg = jlora.LoraConfig(r=4, alpha=8)

    def nonzero_b(tree):
        def fill(x):
            if isinstance(x, dict) and "B" in x:
                return {"A": np.asarray(x["A"]), "B": (rng.standard_normal(
                    x["B"].shape) * 0.05).astype(np.float32)}
            if isinstance(x, dict):
                return {k: fill(v) for k, v in x.items()}
            return x
        return fill(_np(tree))

    trainable = {
        "lora_esm": nonzero_b(jlora.init_lora_params(lcfg, esm, keys[3])),
        "lora_llm": nonzero_b(jlora.init_lora_params(lcfg, llm, keys[4])),
        "adapter": _np(adapter),
    }
    frozen = {"esm_encoder": _np(esm), "llm_decoder": _np(llm),
              "adapter": _np(adapter)}
    return dict(jcfgs=jcfgs, tcfgs=tcfgs, trainable=trainable,
                frozen=frozen, batch=_batch(rng), lcfg=lcfg)


def _jax_kw(s):
    esm_config, adapter_config, decoder_core = s["jcfgs"]
    return dict(esm_config=esm_config, adapter_config=adapter_config,
                decoder_core=decoder_core,
                cfg=jsft.SFTConfig(lora=s["lcfg"], placeholder_id=PH))


def _port_kw(s):
    esm_config, adapter_config, decoder_core = s["tcfgs"]
    return dict(esm_config=esm_config, adapter_config=adapter_config,
                decoder_core=decoder_core,
                cfg=tsft.SFTConfig(lora=tlora.LoraConfig(r=4, alpha=8),
                                   placeholder_id=PH))


def _port_trees(s):
    trainable = {k: params_from_jax(v, requires_grad=True).tree()
                 for k, v in s["trainable"].items()}
    frozen = {k: params_from_jax(v).tree() for k, v in s["frozen"].items()}
    return trainable, frozen


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.fixture(params=["xla", "flash"])
def jax_route(request, monkeypatch):
    """attn_impl for the JAX side; "flash" runs the Pallas kernels in
    interpret mode on the CPU."""
    if request.param == "flash":
        monkeypatch.setenv("P2T_PALLAS_FORCE_INTERPRET", "1")
    return request.param


def test_loss_and_grads_match_jax(setup, jax_route):
    _check_loss_and_grads(setup, jax_route, "auto")


@pytest.mark.parametrize("route", ["xla", "flash"])
def test_loss_and_grads_match_jax_at_attn_impl(setup, route, monkeypatch):
    """Both packages at the same --attn_impl: "xla" is the plain function
    in both towers against JAX's XLA attention; "flash" is K6/K6b (plain
    versions) in ESMC and K1/K5 in the decoder against JAX's "flash" route
    (its decoder's Pallas kernels in interpret mode; its ESMC at S = 16,
    off the 128 grid, on chunked XLA)."""
    if route == "flash":
        monkeypatch.setenv("P2T_PALLAS_FORCE_INTERPRET", "1")
    _check_loss_and_grads(setup, route, route)


def _check_loss_and_grads(s, jax_route, port_route):
    mb = {k: v[0] for k, v in s["batch"].items()}
    loss_fn = lambda tr: jsft.sft_loss(tr, s["frozen"], mb, deterministic=True,
                                       attn_impl=jax_route, **_jax_kw(s))
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        s["trainable"])
    trainable, frozen = _port_trees(s)
    loss = tsft.sft_loss(trainable, frozen, _tbatch(mb), deterministic=True,
                         attn_impl=port_route, **_port_kw(s))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5,
                               rtol=0)
    grads = tree_to_numpy(jax.tree_util.tree_map(
        lambda p: p.grad, trainable))
    want = jax.tree_util.tree_leaves_with_path(_np(want_grads))
    got = jax.tree_util.tree_leaves(grads)
    assert len(got) == len(want) > 20
    for g, (path, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_three_accumulated_adamw_steps_match_jax(setup, jax_route):
    s = setup
    jtx = jopt.adamw_cosine_warmup(1e-2, **OPT)
    jstep = jax.jit(jsft.make_sft_train_step(
        tx=jtx, attn_impl=jax_route, grad_accum=ACCUM, **_jax_kw(s)))
    jstate = jopt.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, s["trainable"]), jtx)
    trainable, frozen = _port_trees(s)
    ttx = topt.adamw_cosine_warmup(1e-2, **OPT)
    tstep = tsft.make_sft_train_step(tx=ttx, grad_accum=ACCUM, **_port_kw(s))
    tstate = topt.TrainState.create(trainable, ttx)
    batch, tbatch = s["batch"], _tbatch(s["batch"])
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        jstate, jloss = jstep(jstate, s["frozen"], batch,
                              jax.random.PRNGKey(i))
        tstate, tloss = tstep(tstate, frozen, tbatch, gen)
        np.testing.assert_allclose(tloss.item(), float(jloss), atol=1e-5,
                                   rtol=0)
    assert tstate.step == int(jstate.step) == 3
    got = tree_to_numpy(tstate.params)
    want = jax.tree_util.tree_leaves_with_path(_np(jstate.params))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(_np(jstate.params))
    moved = 0
    for g, (path, w), w0 in zip(jax.tree_util.tree_leaves(got), want,
                                jax.tree_util.tree_leaves(s["trainable"])):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
        moved += int(np.abs(w - w0).max() > 1e-4)
    assert moved == len(want)       # every leaf trained (lr > 0 after step 1)
    for p in tree_leaves(tstate.params):
        assert p.requires_grad and p.is_leaf
