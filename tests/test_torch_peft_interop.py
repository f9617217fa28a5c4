"""PEFT adapter directories (`models/peft_interop.py`) against the JAX
package's converters and the `peft` library, on a tiny HF Qwen3:

  * a directory `peft` wrote: the port's reader gives JAX's reader's tree
    bit for bit, and its merge equals `PeftModel.merge_and_unload`;
  * a directory the port wrote (its own safetensors writer): JAX's reader
    gives the port's A/B back, and `PeftModel.from_pretrained` merges to
    the port's `merge_lora`;
  * a QLoRA tree (A/B at the quantized keys) saves every layer and reads
    back bit-identical against the quantized base, where the reference's
    writer saves no tensor and its reader raises (ROADMAP.md §3).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from prot2text_tpu.models import hf_import as jhf
from prot2text_tpu.models import lora as jlora
from prot2text_tpu.models import peft_interop as jpeft
from prot2text_tpu_torch.models import hf_import as thf
from prot2text_tpu_torch.models import lora as tlora
from prot2text_tpu_torch.models import peft_interop as tpeft
from prot2text_tpu_torch.models import quant as tquant
from prot2text_tpu_torch.models.weights import tree_leaves, tree_to_numpy

L = 2
TARGETS = ["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
           "down_proj"]


def _hf_model(seed):
    from transformers import Qwen3Config, Qwen3ForCausalLM

    torch.manual_seed(seed)
    return Qwen3ForCausalLM(Qwen3Config(
        vocab_size=64, hidden_size=32, intermediate_size=64,
        num_hidden_layers=L, num_attention_heads=4, num_key_value_heads=2,
        head_dim=8, rope_theta=10000.0, rms_norm_eps=1e-6,
        tie_word_embeddings=False, attention_dropout=0.0))


def _port_tree(model):
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return thf.qwen3_params_from_hf(sd, L, tie_word_embeddings=False)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same(got, want, path=""):
    """A port tree (tensors) against a JAX tree (arrays): the same keys and
    None leaves, arrays equal bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif want is None:
        assert got is None, path
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=path)


@pytest.fixture(scope="module")
def peft_dir(tmp_path_factory):
    from peft import LoraConfig as PeftLoraConfig, get_peft_model

    pm = get_peft_model(_hf_model(5), PeftLoraConfig(
        r=4, lora_alpha=8, lora_dropout=0.0, target_modules=TARGETS))
    with torch.no_grad():
        for n, p in pm.named_parameters():
            if "lora_B" in n:
                p.add_(torch.randn_like(p) * 0.05)
    d = str(tmp_path_factory.mktemp("peft"))
    pm.save_pretrained(d)
    return d


def test_reader_matches_jax_on_a_peft_directory(peft_dir):
    from peft import PeftModel

    fresh = _hf_model(11)
    base = _port_tree(fresh)
    jbase = jhf.qwen3_params_from_hf(
        {k: v.detach().clone() for k, v in fresh.state_dict().items()}, L)
    tree, cfg = tpeft.lora_params_from_peft_dir(peft_dir, base)
    jtree, jcfg = jpeft.lora_params_from_peft_dir(peft_dir, jbase)
    assert (cfg.r, cfg.alpha) == (jcfg.r, jcfg.alpha) == (4, 8)
    _assert_same(tree, _np(jtree))
    merged = PeftModel.from_pretrained(fresh, peft_dir).merge_and_unload()
    want = _port_tree(merged)
    got = tlora.merge_lora(cfg, base, tree)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a, b, atol=2e-6, rtol=2e-6)


def test_saved_directory_loads_in_jax_and_peft(tmp_path):
    from peft import PeftModel

    model = _hf_model(7)
    base = _port_tree(model)
    cfg = tlora.LoraConfig(r=3, alpha=6)
    g = torch.Generator().manual_seed(1)
    tree = tlora.init_lora_params(cfg, base, generator=g)
    for t in tree_leaves(tree):
        t.add_(torch.randn(t.shape, generator=g) * 0.03)
    d = tpeft.save_peft_dir(str(tmp_path / "out"), tree, cfg, "tiny-qwen3")
    with open(os.path.join(d, "adapter_config.json")) as f:
        acfg = json.load(f)
    assert acfg["target_modules"] == sorted(TARGETS)
    assert (acfg["r"], acfg["lora_alpha"]) == (3, 6)
    jbase = jhf.qwen3_params_from_hf(
        {k: v.detach().clone() for k, v in model.state_dict().items()}, L)
    jtree, jcfg = jpeft.lora_params_from_peft_dir(d, jbase)
    assert (jcfg.r, jcfg.alpha) == (3, 6)
    _assert_same(tree, _np(jtree))
    merged = PeftModel.from_pretrained(model, d).merge_and_unload()
    want = _port_tree(merged)
    got = tlora.merge_lora(cfg, base, tree)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a, b, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("fmt", ["int8", "planes", "bytes", "pairs"])
def test_qlora_tree_saves_every_layer(fmt, tmp_path):
    """A LoRA tree over the quantized decoder (QLoRA): every layer's A/B of
    the 7 projections is saved, and the reader against the quantized base
    gives the tree back bit for bit, under the same keys.  JAX's writer
    reads only `kernel` and saves no tensor of such a tree; JAX's reader
    takes L from `q_proj/kernel` and raises on the quantized base."""
    base = _port_tree(_hf_model(3))
    qbase = tquant.quantize_params(
        base, bits=8 if fmt == "int8" else 4,
        **({} if fmt == "int8" else {"int4_format": fmt}))
    cfg = tlora.LoraConfig(r=4, alpha=8)
    g = torch.Generator().manual_seed(2)
    tree = tlora.init_lora_params(cfg, qbase, generator=g)
    for t in tree_leaves(tree):
        t.add_(torch.randn(t.shape, generator=g) * 0.03)
    d = tpeft.save_peft_dir(str(tmp_path / "q"), tree, cfg)
    saved = thf.read_safetensors(os.path.join(d, "adapter_model.safetensors"))
    assert len(saved) == 2 * L * len(TARGETS)
    back, back_cfg = tpeft.lora_params_from_peft_dir(d, qbase)
    assert (back_cfg.r, back_cfg.alpha) == (4, 8)

    def same(a, b):
        if isinstance(a, dict):
            assert isinstance(b, dict) and set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        else:
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b)

    same(back, tree)
    jd = str(tmp_path / "jax")
    jpeft.save_peft_dir(jd, tree_to_numpy(tree), jlora.LoraConfig(r=4,
                                                                   alpha=8))
    assert thf.read_safetensors(os.path.join(
        jd, "adapter_model.safetensors")) == {}
    with pytest.raises(KeyError):
        jpeft.lora_params_from_peft_dir(d, tree_to_numpy(qbase))
