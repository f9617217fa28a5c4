"""QLoRA: LoRA over weight-quantized towers, against the JAX package.

A tiny ESMC (d_model 36: its qkv, out_proj and ffn_in have a contraction
dim off the 8 grid, so planes and pairs fall back to split-half bytes) and a
tiny Qwen3 (intermediate 91: an odd din, so down_proj keeps int4 values in
int8 storage; an untied LM head, quantized too), random f32 towers
quantized in each format (int8, int4 planes / bytes / pairs; the port's
`quantize_params`, whose trees are JAX's, tests/test_torch_quant.py) and
handed to both packages as numpy trees, as are r 4 LoRA trees (B non-zero)
and the adapter (dropout 0).  JAX's own calls are few and jitted (the XLA
CPU compile count per process has a wall).  Each property is one test
parametrised over the four formats:

  (a) the port's LoRA tree has JAX's paths and A/B shapes (A's din
      unpacked), and `unpacked_in_dim` inverts `_int4_key`'s packing;
  (b) `sft_loss` and the LoRA and adapter gradients against JAX's
      `jax.value_and_grad` in f32 (loss atol 1e-5, gradients rtol 1e-4 of
      each leaf's largest entry), at ESMC rows <= 256 and decoder rows
      > 256;
  (c) under grad a bf16 x's quantized `linear` (and the whole bf16
      `sft_loss`) equals the call without grad bit for bit, and the remat
      recompute runs each projection's kernel twice, the head's once;
  (d) `_QuantLinear`'s dX against `jax.vjp` of JAX's `linear` at bf16
      (within 1e-2 of max|dX|: the port rounds dY·s to bf16, ROADMAP §3);
  (e) `saved_tensors_hooks` see no floating tensor of the projection's
      (K, N) size: only the packed leaf itself and its scale;
  (f) `merge_lora` merges A/B kept at a quantized key into a float
      `kernel` as at `kernel`, and raises on a LoRA the base cannot take;
  (g) a QLoRA checkpoint of the train CLI served through
      `--load_sft_checkpoint_dir` gives the merged model's logits.
"""

import os

import hf_dirs
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prot2text_tpu.models import adapters as ja
from prot2text_tpu.models import esmc as jesmc
from prot2text_tpu.models import lora as jlora
from prot2text_tpu.models import qwen3 as jq
from prot2text_tpu.models import transformer as jt
from prot2text_tpu.train import sft as jsft
from prot2text_tpu_torch.models import adapters as ta
from prot2text_tpu_torch.models import esmc as tesmc
from prot2text_tpu_torch.models import lora as tlora
from prot2text_tpu_torch.models import quant as tquant
from prot2text_tpu_torch.models import qwen3 as tq
from prot2text_tpu_torch.models import transformer as tt
from prot2text_tpu_torch.models.weights import (
    params_from_jax, tree_leaves, tree_map, tree_to_numpy,
)
from prot2text_tpu_torch.train import sft as tsft

PH = 299
ESMC = dict(d_model=36, n_layers=2, n_heads=2)
QWEN = dict(vocab_size=300, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=91,
            tie_word_embeddings=False)
ADAPTER = (36, 48, 64)
S, P, B = 160, 16, 2               # decoder rows 320 > 256, ESMC rows 32
FORMATS = {"int8": (8, "planes"), "planes": (4, "planes"),
           "bytes": (4, "bytes"), "pairs": (4, "pairs")}
KERNELS = ("quant_matmul_int4_planes", "quant_matmul_int4",
           "quant_matmul_int4_pairs", "quant_matmul_int8")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(rng):
    """B records: a left-padded prompt with one placeholder per valid
    protein token, a description with labels, right padding."""
    keys = ("protein_input_ids", "protein_attention_mask", "input_ids",
            "attention_mask", "labels")
    out = {k: [] for k in keys}
    for _ in range(B):
        n = int(rng.integers(6, P - 2))
        prot = np.ones(P, np.int32)
        prot[:n + 2] = np.r_[0, rng.integers(4, 24, n), 2]
        pad_l = int(rng.integers(0, 30))
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
    return {k: np.stack(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def base():
    """The port's random f32 towers and adapter as numpy trees (either
    package takes them), and a batch."""
    g = torch.Generator().manual_seed(0)
    kw = dict(generator=g, device="cpu")
    return dict(
        esm=tree_to_numpy(tesmc.init_esmc_params(tesmc.ESMCConfig(**ESMC),
                                                 **kw)),
        llm=tree_to_numpy(tq.init_qwen3_params(tq.Qwen3Config(**QWEN), **kw)),
        adapter=tree_to_numpy(ta.init_modality_adapter_params(
            ta.ModalityAdapterConfig(*ADAPTER, dropout_rate=0.0), **kw)),
        batch=_batch(np.random.default_rng(0)))


_CACHE = {}


def _quantized(base, fmt):
    """The towers quantized in `fmt` by the port's `quantize_params` (the
    same keys as JAX's; numpy leaves, so both packages run on the same
    integers), once per format."""
    if ("towers", fmt) not in _CACHE:
        bits, int4_format = FORMATS[fmt]
        _CACHE["towers", fmt] = {
            name: tree_to_numpy(tquant.quantize_params(
                params_from_jax(base[k]).tree(), bits=bits,
                int4_format=int4_format))
            for name, k in (("esm_encoder", "esm"), ("llm_decoder", "llm"))}
    return _CACHE["towers", fmt]


def _lora(base, fmt):
    """r 4 LoRA trees over `_quantized(base, fmt)` (numpy), B non-zero,
    once per format."""
    if ("lora", fmt) not in _CACHE:
        rng = np.random.default_rng(1)
        g = torch.Generator().manual_seed(1)
        cfg = tlora.LoraConfig(r=4, alpha=8)
        trees = {}
        for name, tower in (("lora_esm", "esm_encoder"),
                            ("lora_llm", "llm_decoder")):
            tree = tlora.init_lora_params(cfg, params_from_jax(
                _quantized(base, fmt)[tower]).tree(), generator=g)
            for b in _b_leaves(tree):
                b.copy_(torch.from_numpy((rng.standard_normal(b.shape)
                                          * 0.05).astype(np.float32)))
            trees[name] = tree_to_numpy(tree)
        _CACHE["lora", fmt] = trees
    return _CACHE["lora", fmt]


def _b_leaves(tree):
    if isinstance(tree, dict):
        if "B" in tree:
            return [tree["B"]]
        return [b for v in tree.values() for b in _b_leaves(v)]
    return []


def _paths(tree, prefix=""):
    """{path: shape} of a tree's array leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}/"))
        elif v is not None:
            out[prefix + k] = tuple(v.shape)
    return out


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_lora_tree_over_quantized_towers_matches_jax(base, fmt):
    """(a) The port's `init_lora_params` over a quantized base: JAX's
    paths and shapes, A's din unpacked (bytes rows · 2, planes/pairs
    words · 8), every kernel key present that the base holds."""
    towers = _quantized(base, fmt)
    lcfg = jlora.LoraConfig(r=4, alpha=8)
    tcfg = tlora.LoraConfig(r=4, alpha=8)
    keys = set()
    for name, jtree in towers.items():
        want = _paths(jax.eval_shape(lambda t: jlora.init_lora_params(
            lcfg, t, jax.random.PRNGKey(2)), jtree))
        port_base = params_from_jax(jtree).tree()
        got_tree = tlora.init_lora_params(
            tcfg, port_base, generator=torch.Generator().manual_seed(2))
        assert _paths(got_tree) == want, name
        keys |= {p.split("/")[-2] for p in want}
        for path, shape in want.items():
            if path.endswith("/B"):
                continue
            key = path.split("/")[-2]
            node = port_base
            for part in path.split("/")[:-2]:
                node = node[part]
            assert shape[-2] == tquant.unpacked_in_dim(
                key, node[key].shape), path
    if fmt == "int8":
        assert keys == {"kernel_q"}
    else:
        # ESMC's din 36 falls back to bytes, Qwen3's odd 91 to int8 storage
        assert keys == {"kernel_q", "kernel_q4",
                        {"planes": "kernel_q4p", "bytes": "kernel_q4",
                         "pairs": "kernel_q4w"}[fmt]}
    for din in (8, 36, 90, 91, 1152, 5120, 17408):
        bits, int4_format = FORMATS[fmt]
        key = (tquant._int4_key(din, int4_format) if bits == 4
               else "kernel_q")
        rows = din // (tquant.INT4_FORMATS[key][2]
                       if key in tquant.INT4_FORMATS else 1)
        assert tquant.unpacked_in_dim(key, (3, rows, 5)) == din, (din, key)


def _jax_kw(lcfg):
    return dict(esm_config=jesmc.ESMCConfig(**ESMC),
                adapter_config=ja.ModalityAdapterConfig(*ADAPTER,
                                                        dropout_rate=0.0),
                decoder_core=jq.Qwen3Config(**QWEN).core(),
                cfg=jsft.SFTConfig(lora=lcfg, placeholder_id=PH))


def _port_kw(r=4, alpha=8):
    return dict(esm_config=tesmc.ESMCConfig(**ESMC),
                adapter_config=ta.ModalityAdapterConfig(*ADAPTER,
                                                        dropout_rate=0.0),
                decoder_core=tq.Qwen3Config(**QWEN).core(),
                cfg=tsft.SFTConfig(lora=tlora.LoraConfig(r=r, alpha=alpha),
                                   placeholder_id=PH))


def _port(base, towers, lora, dtype=None):
    trainable = {k: params_from_jax(v, requires_grad=True).tree()
                 for k, v in {**lora, "adapter": base["adapter"]}.items()}
    frozen = {k: params_from_jax(_np(v), dtype=dtype).tree()
              for k, v in towers.items()}
    frozen["adapter"] = params_from_jax(base["adapter"]).tree()
    return trainable, frozen


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_qlora_loss_and_grads_match_jax(base, fmt):
    """(b) f32: every quantized projection that trains takes the f32
    dequantized product (JAX's XLA numerics), the head and the ESMC
    layer-0 qkv too (their LoRA side paths train)."""
    towers = _quantized(base, fmt)
    lcfg = jlora.LoraConfig(r=4, alpha=8)
    lora = _lora(base, fmt)
    jtrain = {**lora, "adapter": base["adapter"]}
    jfrozen = {**_np(towers), "adapter": base["adapter"]}
    loss_fn = lambda tr: jsft.sft_loss(tr, jfrozen, base["batch"],
                                       deterministic=True, attn_impl="xla",
                                       **_jax_kw(lcfg))
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jtrain)
    trainable, frozen = _port(base, towers, lora)
    loss = tsft.sft_loss(trainable, frozen, _tbatch(base["batch"]),
                         deterministic=True, **_port_kw())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5,
                               rtol=0)
    got = jax.tree_util.tree_leaves(tree_to_numpy(tree_map(
        lambda p: p.grad, trainable)))
    want = jax.tree_util.tree_leaves_with_path(_np(want_grads))
    assert len(got) == len(want) == 2 * (7 + 4) + 4    # stacked A, B
    for g, (path, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_bf16_forward_under_grad_equals_no_grad(base, fmt, monkeypatch):
    """(c) A bf16 x under grad runs the same kernel call as without grad:
    `linear` bit-identical at 5 and 300 rows, and so is the whole bf16
    `sft_loss`.  Its backward recomputes each remat'ed layer, so each
    projection's kernel runs twice a step and the head's once."""
    towers = _quantized(base, fmt)
    p = params_from_jax(_np(towers["llm_decoder"])).tree()["layers"]
    leaf = {k: v[0] for k, v in p["gate_proj"].items()}
    rng = np.random.default_rng(3)
    for R in (5, 300):
        x = torch.from_numpy(rng.standard_normal((R, 64)).astype(
            np.float32)).bfloat16()
        with torch.no_grad():
            want = tt.linear(leaf, x)
        got = tt.linear(leaf, x.clone().requires_grad_())
        assert got.requires_grad and torch.equal(got, want), R
    calls = []
    for name in KERNELS:
        def spy(*a, _f=getattr(tt, name)):
            calls.append(1)
            return _f(*a)
        monkeypatch.setattr(tt, name, spy)
    trainable, frozen = _port(base, towers, _lora(base, fmt),
                              dtype=torch.bfloat16)
    batch = _tbatch(base["batch"])
    with torch.no_grad():
        want = tsft.sft_loss(trainable, frozen, batch, deterministic=True,
                             **_port_kw())
    calls.clear()
    loss = tsft.sft_loss(trainable, frozen, batch, deterministic=True,
                         **_port_kw())
    assert torch.equal(loss, want)
    forward = len(calls)
    loss.backward()
    projections = 7 * QWEN["num_layers"] + 4 * ESMC["n_layers"]
    assert forward == projections + 1
    assert len(calls) == 2 * projections + 1
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in tree_leaves(trainable))


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_quant_linear_dx_matches_jax_vjp(base, fmt):
    """(d) dX of a bf16 x through `_QuantLinear` against `jax.vjp` of JAX's
    quantized `linear` (its XLA route: dY·s in fp32 times the integer
    weight): within 1e-2 of max|dX| at 5 and 300 rows."""
    towers = _quantized(base, fmt)
    jleaf = {k: v[0] for k, v in
             towers["llm_decoder"]["layers"]["up_proj"].items()}
    leaf = params_from_jax(jleaf).tree()
    rng = np.random.default_rng(4)
    for R in (5, 300):
        x = rng.standard_normal((R, 64)).astype(np.float32)
        dy = rng.standard_normal((R, 91)).astype(np.float32)
        xj, dyj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)
        want = np.asarray(jax.jit(lambda a, d: jax.vjp(
            lambda a_: jt.linear(jleaf, a_), a)[1](d)[0])(xj, dyj).astype(
                jnp.float32))
        xt = torch.from_numpy(x).bfloat16().requires_grad_()
        tt.linear(leaf, xt).backward(torch.from_numpy(dy).bfloat16())
        got = xt.grad.float().numpy()
        assert xt.grad.dtype == torch.bfloat16
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-2, (R, err)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_quant_linear_saves_no_dequantized_weight(base, fmt):
    """(e) What autograd keeps for the backward of a bf16 LoRA'd quantized
    projection: no floating tensor of the weight's (K, N) = (64, 91) size;
    every integer tensor is the frozen leaf itself (same storage)."""
    towers = _quantized(base, fmt)
    p = params_from_jax(_np(towers["llm_decoder"])).tree()["layers"]
    leaf = {k: v[1] for k, v in p["up_proj"].items()}
    key = next(k for k in leaf if k.startswith("kernel"))
    lora = {"A": torch.randn(64, 4, requires_grad=True),
            "B": torch.randn(4, 91, requires_grad=True)}
    saved = []

    def pack(t):
        saved.append(t)
        return t

    x = torch.randn(5, 64).bfloat16().requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = tt.linear_lora(leaf, lora, x, 2.0)
    y.float().sum().backward()
    assert saved and x.grad is not None
    for t in saved:
        if t.is_floating_point():
            assert t.numel() != 64 * 91, tuple(t.shape)
        else:
            assert t.data_ptr() == leaf[key].data_ptr(), tuple(t.shape)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_merge_lora_takes_a_qlora_tree(base, fmt):
    """(f) A LoRA tree trained over the quantized base merges into the
    float base exactly as the same A/B kept at `kernel`; the quantized
    base itself is refused, and so is a LoRA whose linear the base lacks."""
    towers = _quantized(base, fmt)
    cfg = tlora.LoraConfig(r=4, alpha=8)
    lora = params_from_jax(_lora(base, fmt)["lora_llm"]).tree()
    floats = params_from_jax(_np(base["llm"])).tree()

    def at_kernel(node):
        if not isinstance(node, dict):
            return node
        ab = tlora.lora_at(node)
        if ab is not None:
            return {**{k: None for k in node if k not in tlora._KERNEL_KEYS},
                    "kernel": ab}
        return {k: at_kernel(v) for k, v in node.items()}

    got = tlora.merge_lora(cfg, floats, lora)
    want = tlora.merge_lora(cfg, floats, at_kernel(lora))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(want)))
    assert not torch.equal(got["layers"]["q_proj"]["kernel"],
                           floats["layers"]["q_proj"]["kernel"])
    with pytest.raises(ValueError, match="quantized base"):
        tlora.merge_lora(cfg, params_from_jax(_np(towers["llm_decoder"]))
                         .tree(), lora)
    ab = tlora.lora_at(lora["layers"]["q_proj"])
    for bad in ({"layers": {"no_proj": {"kernel": ab}}},
                {"embed_tokens": ab},
                {"final_ln": {"kernel_q4p": ab}}):
        with pytest.raises(ValueError, match="base"):
            tlora.merge_lora(cfg, floats, bad)


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_qlora_checkpoint_serves_merged(fmt, tmp_path):
    """(g) `train_instruct --model_dtype int8/int4` writes LoRA trees at
    the quantized keys; `serve --load_sft_checkpoint_dir` (bf16) merges
    them into the bf16 towers: its decoder's logits equal the merged
    model's and differ from the base's."""
    from prot2text_tpu_torch.cli import serve as scli
    from prot2text_tpu_torch.cli.train_instruct import main as train_main
    from prot2text_tpu_torch.core.checkpoint import restore_checkpoint
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer

    csv = tmp_path / "train.csv"
    csv.write_text(
        "AlphaFoldDB,Full Name,taxon,sequence,function\n"
        "P1,Cytochrome c,Homo sapiens,MGDVEKGKKIFIMKCSQ,Electron carrier.\n"
        "P2,Lysozyme C,Gallus gallus,KVFGRCELAAAMKRHGL,Hydrolyzes walls.\n")
    ckpt = tmp_path / "ck"
    train_main(["--train_csv", str(csv), "--device", "cpu",
                "--debug_tiny_model", "true", "--model_dtype", fmt,
                "--gradient_accumulation_steps", "1", "--num_epochs", "1",
                "--learning_rate", "1e-2", "--checkpoint_dir", str(ckpt)])
    (run,) = os.listdir(ckpt)
    sft = restore_checkpoint(str(ckpt / run))
    key = "kernel_q4p" if fmt == "int4" else "kernel_q"
    assert set(sft["lora_llm"]["layers"]["q_proj"]) == {key, "scale"}
    assert sft["lora_llm"]["layers"]["q_proj"][key]["B"].abs().max() > 0
    tok, cpu = ByteTextTokenizer(), torch.device("cpu")
    flags = ["--test_csv", str(csv), "--device", "cpu",
             "--debug_tiny_model", "true", "--model_dtype", "bf16"]
    cfg, served = scli.build_server(scli.build_parser().parse_args(
        flags + ["--load_sft_checkpoint_dir", str(ckpt / run)]), tok, cpu)
    _, plain = scli.build_server(scli.build_parser().parse_args(flags),
                                 tok, cpu)
    merged = tlora.merge_lora(tlora.LoraConfig(r=32, alpha=64),
                              plain["llm_decoder"], sft["lora_llm"])
    core = cfg.llm_config.core()
    got = hf_dirs.decoder_logits_of(core, served["llm_decoder"])
    assert torch.equal(got, hf_dirs.decoder_logits_of(core, merged))
    assert not torch.equal(got, hf_dirs.decoder_logits_of(
        core, plain["llm_decoder"]))
