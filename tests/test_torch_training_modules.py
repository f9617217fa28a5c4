"""The port's training modules against the JAX package on the same weights
(JAX init → numpy → `params_from_jax`) and the same numpy inputs, f32:
the weight bridge with `None` leaves and its reverse, `linear_lora`, the
LoRA trees and their merge, adapter dropout, the ESMC encoder (with and
without LoRA), Qwen3's qk-norm in `decoder_forward` and
`decoder_decode_step`, AdamW with the cosine-warmup schedule and global-norm
clipping against optax, checkpoints and the loss logger."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prot2text_tpu.models import adapters as ja
from prot2text_tpu.models import decoder as jd
from prot2text_tpu.models import esmc as jesmc
from prot2text_tpu.models import lora as jlora
from prot2text_tpu.models import qwen3 as jq
from prot2text_tpu.models import transformer as jt
from prot2text_tpu.train import optim as jopt
from prot2text_tpu_torch.cli.common import LossLogger
from prot2text_tpu_torch.core import checkpoint as tckpt
from prot2text_tpu_torch.models import adapters as ta
from prot2text_tpu_torch.models import decoder as td
from prot2text_tpu_torch.models import esmc as tesmc
from prot2text_tpu_torch.models import lora as tlora
from prot2text_tpu_torch.models import qwen3 as tq
from prot2text_tpu_torch.models import transformer as tt
from prot2text_tpu_torch.models.weights import (
    params_from_jax, tree_leaves, tree_to_numpy,
)
from prot2text_tpu_torch.train import optim as topt

ATOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree, requires_grad=False):
    return params_from_jax(_np(tree), requires_grad=requires_grad).tree()


def _nonzero_b(lora_tree, seed):
    """LoRA trees with B drawn N(0, 0.05) instead of 0, so the side path
    (and the gradient of A) is not trivially zero."""
    rng = np.random.default_rng(seed)

    def fill(x):
        if isinstance(x, dict) and "B" in x:
            return {"A": np.asarray(x["A"]),
                    "B": (rng.standard_normal(x["B"].shape) * 0.05)
                    .astype(np.float32)}
        if isinstance(x, dict):
            return {k: fill(v) for k, v in x.items()}
        return x

    return fill(lora_tree)


def test_bridge_carries_none_leaves_trainable_subtrees_and_back():
    lcfg = jlora.LoraConfig(r=4, alpha=8)
    base = jq.init_qwen3_params(jq.Qwen3Config.tiny(), jax.random.PRNGKey(0))
    lora = _np(jlora.init_lora_params(lcfg, base, jax.random.PRNGKey(1)))
    tree = params_from_jax(lora, requires_grad=True)
    t = tree.tree()
    assert t["embed_tokens"] is None and t["final_ln"]["scale"] is None
    a = t["layers"]["q_proj"]["kernel"]["A"]
    assert a.requires_grad and a.is_leaf
    assert all(p.requires_grad for p in tree.parameters())
    frozen = params_from_jax(_np(base))
    assert not any(p.requires_grad for p in frozen.parameters())
    back = tree_to_numpy(t)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(lora)
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(lora)):
        np.testing.assert_array_equal(x, y)


def test_linear_lora():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    p = {"kernel": rng.standard_normal((8, 5)).astype(np.float32),
         "bias": rng.standard_normal(5).astype(np.float32)}
    lo = {"A": rng.standard_normal((8, 2)).astype(np.float32),
          "B": rng.standard_normal((2, 5)).astype(np.float32)}
    want = jt.linear_lora(p, lo, jnp.asarray(x), 2.0)
    got = tt.linear_lora(_t(p), _t(lo), torch.from_numpy(x), 2.0)
    # outputs are O(10): a few f32 ulps
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(
        tt.linear_lora(_t(p), None, torch.from_numpy(x)).numpy(),
        np.asarray(jt.linear(p, jnp.asarray(x))), atol=1e-6, rtol=1e-6)


def test_init_lora_params_structure_merge_and_count():
    lcfg = jlora.LoraConfig(r=4, alpha=8)
    tcfg = tlora.LoraConfig(r=4, alpha=8)
    for jbase in (jq.init_qwen3_params(jq.Qwen3Config.tiny(),
                                       jax.random.PRNGKey(2)),
                  jesmc.init_esmc_params(jesmc.ESMCConfig.tiny(),
                                         jax.random.PRNGKey(3))):
        jl = _np(jlora.init_lora_params(lcfg, jbase, jax.random.PRNGKey(4)))
        tbase = _t(jbase)
        gen = torch.Generator().manual_seed(0)
        tl = tlora.init_lora_params(tcfg, tbase, generator=gen)
        got = tree_to_numpy(tl)
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(jl)
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(jl)):
            assert g.shape == w.shape and g.dtype == np.float32
        for path, leaf in jax.tree_util.tree_flatten_with_path(got)[0]:
            if path[-1].key == "B":
                assert np.all(leaf == 0.0)
            else:      # A ~ N(0, 0.01²)
                assert 0.005 < leaf.std() < 0.02
        assert tlora.lora_param_count(tl) == jlora.lora_param_count(jl)
        # merge on the same (non-zero) A/B
        jl = _nonzero_b(jl, 5)
        want = jlora.merge_lora(lcfg, jbase, jl)
        merged = tlora.merge_lora(tcfg, tbase, _t(jl))
        for g, w in zip(jax.tree_util.tree_leaves(tree_to_numpy(merged)),
                        jax.tree_util.tree_leaves(_np(want))):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="quantized"):
        tlora.merge_lora(tcfg, {"q_proj": {"kernel": torch.zeros(
            2, 2, dtype=torch.int8)}}, {"q_proj": {"kernel": {
                "A": torch.zeros(2, 1), "B": torch.zeros(1, 2)}}})


def test_adapter_dropout():
    cfg = ta.ModalityAdapterConfig(16, 32, 8, dropout_rate=0.3)
    params = _t(ja.init_modality_adapter_params(
        ja.ModalityAdapterConfig(16, 32, 8), jax.random.PRNGKey(6)))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 50, 16)).astype(np.float32))
    det = ta.modality_adapter(cfg, params, x)
    gen = torch.Generator().manual_seed(0)
    a = ta.modality_adapter(cfg, params, x, deterministic=False,
                            generator=gen)
    b = ta.modality_adapter(cfg, params, x, deterministic=False,
                            generator=gen)
    assert not torch.equal(a, b) and not torch.equal(a, det)
    # the mask law: keep 1 - rate, kept values scaled by 1 / (1 - rate)
    h = torch.ones(200_000)
    y = ta._dropout(h, 0.3, torch.Generator().manual_seed(1), False)
    assert abs((y != 0).float().mean().item() - 0.7) < 0.005
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.7))
    with pytest.raises(ValueError, match="generator"):
        ta.modality_adapter(cfg, params, x, deterministic=False)
    # rate 0 in training mode is the deterministic adapter, as in JAX
    cfg0 = ta.ModalityAdapterConfig(16, 32, 8, dropout_rate=0.0)
    assert torch.equal(ta.modality_adapter(cfg0, params, x,
                                           deterministic=False), det)


ESMC = dict(d_model=64, n_layers=2, n_heads=4)


@pytest.mark.parametrize("with_lora", [False, True])
@pytest.mark.parametrize("remat", [False, True])
def test_esmc_encode(with_lora, remat):
    jcfg, tcfg = jesmc.ESMCConfig(**ESMC), tesmc.ESMCConfig(**ESMC)
    params = jesmc.init_esmc_params(jcfg, jax.random.PRNGKey(7))
    ids = np.array([[0, 5, 6, 7, 8, 9, 2, 1, 1],
                    [0, 4, 9, 10, 11, 12, 13, 14, 2]], np.int32)
    mask = (ids != 1).astype(np.int32)
    lora = None
    if with_lora:
        lora = _nonzero_b(_np(jlora.init_lora_params(
            jlora.LoraConfig(r=4, alpha=8), params,
            jax.random.PRNGKey(8))), 9)
    want = jesmc.esmc_encode(jcfg, params, ids, mask, lora=lora,
                             lora_scale=2.0)
    got = tesmc.esmc_encode(tcfg, _t(params), torch.from_numpy(ids),
                            torch.from_numpy(mask), remat=remat,
                            lora=None if lora is None else _t(lora),
                            lora_scale=2.0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


def test_esmc_params_from_torch_matches_jax_converter():
    cfg = jesmc.ESMCConfig(**ESMC)
    d, f = cfg.d_model, cfg.ffn_dim
    g = torch.Generator().manual_seed(0)
    sd = {"embed.weight": torch.randn(64, d, generator=g),
          "transformer.norm.weight": torch.randn(d, generator=g)}
    for i in range(cfg.n_layers):
        pre = f"transformer.blocks.{i}"
        for name, shape in (("attn.layernorm_qkv.0.weight", (d,)),
                            ("attn.layernorm_qkv.0.bias", (d,)),
                            ("attn.layernorm_qkv.1.weight", (3 * d, d)),
                            ("attn.q_ln.weight", (d,)),
                            ("attn.k_ln.weight", (d,)),
                            ("attn.out_proj.weight", (d, d)),
                            ("ffn.0.weight", (d,)), ("ffn.0.bias", (d,)),
                            ("ffn.1.weight", (2 * f, d)),
                            ("ffn.3.weight", (d, f))):
            sd[f"{pre}.{name}"] = torch.randn(shape, generator=g)
    want = _np(jesmc.esmc_params_from_torch(sd, cfg.n_layers))
    got = tree_to_numpy(tesmc.esmc_params_from_torch(sd, cfg.n_layers))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for x, y in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(x, y)


QWEN = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=96)


def _qwen_params():
    jcfg, tcfg = jq.Qwen3Config(**QWEN), tq.Qwen3Config(**QWEN)
    params = jq.init_qwen3_params(jcfg, jax.random.PRNGKey(10))
    # non-unit qk-norm scales, so a missing norm cannot pass
    rng = np.random.default_rng(11)
    params = _np(params)
    for n in ("q_norm", "k_norm"):
        params["layers"][n]["scale"] = (1 + 0.5 * rng.standard_normal(
            params["layers"][n]["scale"].shape)).astype(np.float32)
    return jcfg, tcfg, params


def test_qwen3_init_tree_matches_jax():
    jcfg, tcfg, params = _qwen_params()
    t = tq.init_qwen3_params(tcfg, generator=torch.Generator(),
                             device="cpu")
    got = tree_to_numpy(t)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(params)
    for x, y in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(params)):
        assert x.shape == y.shape


@pytest.mark.parametrize("with_lora", [False, True])
def test_qwen3_decoder_forward_with_qk_norm(with_lora):
    jcfg, tcfg, params = _qwen_params()
    B, S = 2, 12
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, :3] = 0                                 # left-padded row
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    lora = None
    if with_lora:
        lora = _nonzero_b(_np(jlora.init_lora_params(
            jlora.LoraConfig(r=4, alpha=8), params,
            jax.random.PRNGKey(13))), 14)
    want, _ = jd.decoder_forward(
        jcfg.core(), params, inputs_embeds=jnp.asarray(x),
        bias=jd.causal_bias_from_mask(jnp.asarray(mask)),
        positions=jnp.asarray(pos), lora=lora, lora_scale=2.0)
    got, _ = td.decoder_forward(
        tcfg.core(), _t(params), inputs_embeds=torch.from_numpy(x),
        positions=torch.from_numpy(pos),
        attn_lengths=td.contiguous_lengths(torch.from_numpy(mask)),
        lora=None if lora is None else _t(lora), lora_scale=2.0)
    valid = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               atol=ATOL, rtol=0)


def test_qwen3_decode_step_with_qk_norm():
    """One decode step over a cache holding S prefilled slots: the port's
    lockstep step against the JAX XLA decode step.  At D = 16 both keep
    the (L, T, B, Hkv, D) "tbkd" cache, so the port's plain attention and
    K12 (plain on the CPU) are held against JAX's directly: the hidden
    states, and the prefilled and stepped caches without a permute."""
    jcfg, tcfg, params = _qwen_params()
    B, S, T, D = 2, 6, 8, 16
    rng = np.random.default_rng(15)
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    tok = rng.standard_normal((B, 1, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    # D = 16: the JAX package keeps this cache (L, T, B, Hkv, D) ("tbkd")
    assert jd.kv_cache_layout(jcfg.core()) == "tbkd"
    jcache = {"k": jnp.zeros((2, T, B, 2, D)), "v": jnp.zeros((2, T, B, 2, D))}
    mask = np.ones((B, S), np.int32)
    slots = np.arange(T)
    ok = (slots[None, :] <= np.arange(S)[:, None]) & (slots[None, :] < S)
    bias = np.where(ok, 0.0, np.finfo(np.float32).min).astype(np.float32)
    _, jcache = jd.decoder_forward(
        jcfg.core(), params, inputs_embeds=jnp.asarray(x),
        bias=jnp.asarray(np.broadcast_to(bias, (B, 1, S, T))),
        positions=jnp.asarray(pos), kv_cache=jcache, cache_index=0)
    kv_mask = np.zeros((B, T), np.int32)
    kv_mask[:, :S] = 1
    bias_old = np.where(kv_mask > 0, 0.0, np.finfo(np.float32).min).astype(
        np.float32)[:, None, None, :]
    prefilled = {n: np.asarray(c) for n, c in jcache.items()}
    want, jcache = jd.decoder_decode_step(
        jcfg.core(), params, token_embeds=jnp.asarray(tok),
        bias_old=jnp.asarray(bias_old),
        positions=jnp.full((B, 1), S, jnp.int32), kv_cache=jcache,
        cache_index=S)
    tp = _t(params)
    assert td.kv_cache_layout(tcfg.core()) == "tbkd"
    tcache = {"k": torch.zeros(2, T, B, 2, D), "v": torch.zeros(2, T, B, 2, D)}
    td.decoder_forward(
        tcfg.core(), tp, inputs_embeds=torch.from_numpy(x),
        positions=torch.from_numpy(pos),
        attn_lengths=td.contiguous_lengths(torch.from_numpy(mask)),
        kv_cache=tcache)
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache[n].numpy(), prefilled[n],
                                   atol=ATOL, rtol=0)
    got, _ = td.decoder_decode_step(
        tcfg.core(), tp, token_embeds=torch.from_numpy(tok),
        kv_mask=torch.from_numpy(kv_mask),
        positions=torch.full((B, 1), S), kv_cache=tcache, cache_index=S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jcache[n]),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("schedule", ["cosine_warmup", "constant",
                                      "step_lr", "step_lr_unclipped"])
def test_adamw_matches_optax_three_steps(schedule):
    """Three steps of AdamW, clipped unless named otherwise, including the
    warmup's lr(0) = 0 first step, and the legacy trainer's StepLR at
    optax's own eps (1e-8) and weight decay (1e-4), two steps an epoch and
    gamma 0.5, so step 3 runs at half the rate: params equal optax's (f32,
    atol 1e-7 on O(1) params)."""
    rng = np.random.default_rng(16)
    params = {"a": {"A": rng.standard_normal((3, 4)).astype(np.float32),
                    "B": None},
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{"a": {"A": rng.standard_normal((3, 4)).astype(np.float32),
                    "B": None},
              "b": rng.standard_normal(5).astype(np.float32) * s}
             for s in (0.1, 10.0, 1.0)]     # the clip triggers on some
    if schedule == "cosine_warmup":
        jtx = jopt.adamw_cosine_warmup(0.1, total_steps=20, warmup_frac=0.1,
                                       weight_decay=0.01, grad_clip=1.0)
        ttx = topt.adamw_cosine_warmup(0.1, total_steps=20, warmup_frac=0.1,
                                       weight_decay=0.01, grad_clip=1.0)
        assert ttx.lr(0) == 0.0
    elif schedule.startswith("step_lr"):
        clip = None if schedule.endswith("unclipped") else 1.0
        jtx = jopt.step_lr(0.1, 0.5, 2, grad_clip=clip)
        ttx = topt.step_lr(0.1, 0.5, 2, grad_clip=clip)
        assert (ttx.eps, ttx.weight_decay) == (1e-8, 1e-4)
        sched = jopt.step_lr_schedule(0.1, 0.5, 2)
        assert [ttx.lr(t) for t in range(5)] == [float(sched(t))
                                                 for t in range(5)]
    else:
        jtx = jopt.adamw_constant(0.1, weight_decay=0.01, grad_clip=1.0)
        ttx = topt.adamw_constant(0.1, weight_decay=0.01, grad_clip=1.0)
    jstate = jopt.TrainState.create(jax.tree_util.tree_map(
        jnp.asarray, params), jtx)
    tstate = topt.TrainState.create(_t(params, requires_grad=True), ttx)
    for g in grads:
        jstate = jopt.apply_updates(jstate, jax.tree_util.tree_map(
            jnp.asarray, g), jtx)
        tstate = topt.apply_updates(tstate, _t(g), ttx)
        for x, y in zip(tree_leaves(tstate.params),
                        jax.tree_util.tree_leaves(jstate.params)):
            np.testing.assert_allclose(x.detach().numpy(), np.asarray(y),
                                       atol=1e-7, rtol=0)
    assert tstate.step == int(jstate.step) == 3
    assert tstate.opt_state["count"] == 3


def test_checkpoint_round_trip(tmp_path):
    tree = {"lora": {"x": {"A": torch.randn(2, 3), "B": None}},
            "opt_state": {"count": 4, "mu": {"y": torch.ones(2)}},
            "step": 4}
    d = tckpt.timestamped_dir(str(tmp_path))
    tckpt.save_checkpoint(d, 2, tree)
    tckpt.save_checkpoint(d, 4, tree)
    assert tckpt.latest_step(d) == 4
    got = tckpt.restore_checkpoint(d)
    assert got["step"] == 4 and got["opt_state"]["count"] == 4
    assert got["lora"]["x"]["B"] is None
    assert torch.equal(got["lora"]["x"]["A"], tree["lora"]["x"]["A"])
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "empty"))


def test_loss_logger_syncs_every_log_every_and_warns(capsys):
    log = LossLogger(log_every=2)
    log.append(torch.tensor(1.0))
    assert log._pending and not log._host          # no sync yet
    log.append(torch.tensor(float("nan")))
    assert not log._pending and len(log._host) == 2
    log.append(torch.tensor(3.0))
    mean, n = log.finish()
    assert n == 3 and np.isnan(mean)
    assert "impossible loss nan" in capsys.readouterr().err


def test_head_f32_matmul_gradient_on_cpu():
    """The head's fp32-output GEMM is differentiable in the hidden states:
    CPU operands take the upcast path."""
    from prot2text_tpu_torch.models.decoder import matmul_f32_out

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 8, generator=g).bfloat16().requires_grad_()
    w = torch.randn(8, 5, generator=g).bfloat16()
    dy = torch.randn(2, 3, 5, generator=g)
    y = matmul_f32_out(x, w)
    assert y.dtype == torch.float32
    y.backward(dy)
    torch.testing.assert_close(x.grad.float(), (dy @ w.float().T).bfloat16()
                               .float())


@pytest.mark.cuda
def test_head_bf16_f32_out_gradient_on_cuda():
    """`torch.mm(..., out_dtype=torch.float32)` has no derivative in the
    card's PyTorch (2.11): the head's autograd function supplies dX = dY·Wᵀ
    in bf16.  The reference is the f32 cotangent times the f32 weight, as the
    JAX VJP writes it; the port rounds dY to bf16 (the TPU's default matmul
    precision does the same) and returns a bf16 dX.  Budget for those two
    roundings: rtol 2e-2 (dX's own bf16 rounding is 2^-9 relative) and atol
    3.2e-4 (dY's rounding, at most 2^-9 relative per term, sums over K = 1000
    terms of size 1e-3 to about 3.5e-5 rms).  A trainable head weight is
    refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from prot2text_tpu_torch.models.decoder import matmul_f32_out

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(2, 64, 256, generator=g, device="cuda").bfloat16()
    w = torch.randn(256, 1000, generator=g, device="cuda").bfloat16()
    dy = torch.randn(2, 64, 1000, generator=g, device="cuda") * 1e-3
    x.requires_grad_()
    y = matmul_f32_out(x, w)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, x.detach().float() @ w.float(),
                               rtol=1e-3, atol=1e-3)
    y.backward(dy)
    assert x.grad.dtype == torch.bfloat16
    torch.testing.assert_close(x.grad.float(), dy @ w.float().T,
                               rtol=2e-2, atol=2e-2 * 1e-3 * 16)
    with pytest.raises(ValueError, match="frozen"):
        matmul_f32_out(x, w.requires_grad_())
