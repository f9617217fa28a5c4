"""The port's convert_checkpoint CLI against the JAX CLI on the same
sources, on the CPU: tiny HF directories (an ESM2 and a Qwen3 written by
`tests/hf_dirs.py` from random trees, a tied Llama), an esm-package ESMC
state dict and a reference adapter `.pt` (prefixed, with its deprecated
ln1/ln2).  JAX's orbax tree restored and the port's `step_0/checkpoint.pt`
restored agree key for key within 1e-6 in f32 (JAX's own CLI test is
marked slow; these stay small).  Also: the default bf16, a bf16
directory, layer counts read through the "esm." prefix, the refusals, and
the key that keeps the output from feeding `generate_instruct
--load_checkpoint_dir` in both packages."""

import os

import hf_dirs
import jax
import numpy as np
import pytest
import torch

from prot2text_tpu_torch.cli import convert_checkpoint as cli
from prot2text_tpu_torch.core.checkpoint import restore_checkpoint
from prot2text_tpu_torch.models.decoder import DecoderConfig
from prot2text_tpu_torch.models.decoder import init_decoder_params
from prot2text_tpu_torch.models.esm2 import ESM2Config, init_esm2_params
from prot2text_tpu_torch.models.esmc import ESMCConfig, init_esmc_params
from prot2text_tpu_torch.models.qwen3 import Qwen3Config, init_qwen3_params
from prot2text_tpu_torch.models.weights import tree_to_numpy

L = 2


def esmc_state_dict(tree: dict) -> dict:
    """An esm-package ESMC state dict from the port's ESMC tree (the keys
    `esmc_params_from_torch` reads; weights (out, in))."""
    sd = {"embed.weight": tree["embed"],
          "transformer.norm.weight": tree["final_ln"]["scale"]}
    names = {"attn_ln": "attn.layernorm_qkv.0", "qkv": "attn.layernorm_qkv.1",
             "q_ln": "attn.q_ln", "k_ln": "attn.k_ln",
             "out_proj": "attn.out_proj", "ffn_ln": "ffn.0",
             "ffn_in": "ffn.1", "ffn_out": "ffn.3"}
    for mod, hf in names.items():
        for leaf, t in tree["layers"][mod].items():
            for i in range(L):
                key = f"transformer.blocks.{i}.{hf}."
                if leaf == "kernel":
                    sd[key + "weight"] = t[i].T
                else:
                    sd[key + ("weight" if leaf == "scale" else leaf)] = t[i]
    return sd


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """{flag: path} of every source kind, each random from its own seed."""
    root = tmp_path_factory.mktemp("sources")
    gen = torch.Generator().manual_seed(0)
    kw = dict(generator=gen, device="cpu")

    def jitter(tree):              # norms and biases away from 1 and 0
        for t in jax.tree_util.tree_leaves(tree):
            t.add_(torch.randn(t.shape, generator=gen) * 0.1)
        return tree

    esm = jitter(init_esm2_params(ESM2Config(
        hidden_size=32, num_layers=L, num_heads=4, intermediate_size=64),
        **kw))
    qwen = jitter(init_qwen3_params(Qwen3Config.tiny(vocab_size=96), **kw))
    llama = init_decoder_params(DecoderConfig(
        vocab_size=96, hidden_size=32, num_layers=L, num_heads=4,
        num_kv_heads=2, intermediate_size=64, head_dim=8,
        tie_word_embeddings=True), **kw)
    esmc = jitter(init_esmc_params(ESMCConfig(d_model=32, n_layers=L,
                                              n_heads=4), **kw))
    esmc["layers"]["attn_ln"]["bias"] = torch.randn(L, 32, generator=gen)
    out = {
        "--esm2_dir": hf_dirs.write({
            "esm." + k: v for k, v in
            hf_dirs.esm2_state_dict(esm, L).items()}, root / "esm2"),
        "--decoder_dir": hf_dirs.write(hf_dirs.decoder_state_dict(qwen, L),
                                       root / "qwen3"),
        "llama": hf_dirs.write(hf_dirs.decoder_state_dict(llama, L),
                               root / "llama"),
        "--esmc_path": str(root / "esmc.pt"),
        "--adapter_path": str(root / "adapter.pt"),
    }
    torch.save(esmc_state_dict(esmc), out["--esmc_path"])
    torch.save({"model_state_dict": {
        "adapter.fc1.weight": torch.randn(12, 8, generator=gen),
        "adapter.fc1.bias": torch.randn(12, generator=gen),
        "adapter.fc2.weight": torch.randn(32, 12, generator=gen),
        "adapter.fc2.bias": torch.randn(32, generator=gen),
        "adapter.ln1.weight": torch.ones(12),
        "adapter.ln1.bias": torch.zeros(12)}}, out["--adapter_path"])
    return out


def _flat(tree) -> dict:
    if any(torch.is_tensor(x) for x in jax.tree_util.tree_leaves(tree)):
        tree = tree_to_numpy(tree)
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


# the sources of one run: ESM2 + Qwen3 + adapter; ESMC + a tied Llama
RUNS = {
    "esm2+qwen3+adapter": lambda s: [
        "--esm2_dir", s["--esm2_dir"], "--esm2_num_layers", str(L),
        "--decoder_dir", s["--decoder_dir"], "--qwen3", "true",
        "--adapter_path", s["--adapter_path"]],
    "esmc+tied_llama": lambda s: [
        "--esmc_path", s["--esmc_path"], "--esmc_num_layers", str(L),
        "--decoder_dir", s["llama"], "--tie_word_embeddings", "true"],
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_convert_matches_jax(sources, tmp_path, run, capsys):
    from prot2text_tpu.cli.convert_checkpoint import main as jax_main
    from prot2text_tpu.core.checkpoint import (
        restore_checkpoint as jax_restore,
    )

    flags = RUNS[run](sources) + ["--dtype", "fp32"]
    jax_main(["--output_dir", str(tmp_path / "jax")] + flags)
    path = cli.main(["--output_dir", str(tmp_path / "torch"),
                     "--device", "cpu"] + flags)
    assert path == os.path.join(str(tmp_path / "torch"), "step_0")
    assert os.path.isfile(os.path.join(path, "checkpoint.pt"))
    want = jax_restore(str(tmp_path / "jax"), step=0)
    got = restore_checkpoint(str(tmp_path / "torch"), step=0)
    assert sorted(got) == sorted(want)
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_allclose(g[k], w[k], atol=1e-6, rtol=0,
                                   err_msg=k)
    for t in jax.tree_util.tree_leaves(got):
        assert t.dtype == torch.float32 and t.is_contiguous()
    out = capsys.readouterr().out
    assert f"{L} layers" in out and "→" in out


def test_convert_defaults_to_bf16_and_reads_bf16_dirs(sources, tmp_path):
    """The default --dtype is bf16; a bf16 directory (which numpy alone
    cannot read) converts to the same tree as its f32 source cast to
    bf16."""
    from prot2text_tpu_torch.models.hf_import import (
        load_state_dict_dir, qwen3_params_from_hf,
    )

    f32 = load_state_dict_dir(sources["--decoder_dir"])
    bf16_dir = hf_dirs.write(f32, tmp_path / "bf16", dtype=torch.bfloat16)
    cli.main(["--output_dir", str(tmp_path / "out"), "--device", "cpu",
              "--decoder_dir", bf16_dir, "--qwen3", "true"])
    got = restore_checkpoint(str(tmp_path / "out"))["llm_decoder"]
    want = qwen3_params_from_hf(f32, L, dtype=torch.bfloat16)
    hf_dirs.assert_tree_equal(got, want)


def test_convert_output_does_not_feed_generate_instruct(sources, tmp_path):
    """Both CLIs write the decoder under "llm_decoder" (JAX:
    prot2text_tpu/cli/convert_checkpoint.py:77), while the instruct model
    reads "llama_decoder" (prot2text_tpu/models/composed.py:113): the
    output is no `generate_instruct --load_checkpoint_dir` checkpoint as
    it is.  The port keeps JAX's keys; its generate_instruct names the
    missing part."""
    from prot2text_tpu_torch.cli import generate_instruct as gi

    out = str(tmp_path / "conv")
    cli.main(["--output_dir", out, "--device", "cpu", "--esm2_dir",
              sources["--esm2_dir"], "--decoder_dir", sources["llama"],
              "--tie_word_embeddings", "true", "--adapter_path",
              sources["--adapter_path"]])
    assert set(restore_checkpoint(out)) == {"esm_encoder", "llm_decoder",
                                            "adapter"}
    args = gi.build_parser().parse_args([
        "--data_root", "unused", "--test_csv", "unused.csv", "--device",
        "cpu", "--debug_tiny_model", "true", "--model_dtype", "fp32",
        "--load_checkpoint_dir", out])
    with pytest.raises(ValueError, match="llama_decoder"):
        gi.build_model(args, gi.text_tokenizer(args), torch.device("cpu"))


def test_layer_counts_read_through_prefixes(sources, tmp_path):
    """Without --esm2_num_layers the port counts the layers of an
    "esm."-prefixed EsmForMaskedLM-style state dict; the JAX CLI counts
    only unprefixed "encoder.layer." keys and raises on it."""
    from prot2text_tpu.cli.convert_checkpoint import main as jax_main

    with pytest.raises(ValueError):
        jax_main(["--output_dir", str(tmp_path / "jax"), "--esm2_dir",
                  sources["--esm2_dir"]])
    cli.main(["--output_dir", str(tmp_path / "a"), "--device", "cpu",
              "--esm2_dir", sources["--esm2_dir"]])
    cli.main(["--output_dir", str(tmp_path / "b"), "--device", "cpu",
              "--esm2_dir", sources["--esm2_dir"], "--esm2_num_layers",
              str(L)])
    hf_dirs.assert_tree_equal(restore_checkpoint(str(tmp_path / "a")),
                              restore_checkpoint(str(tmp_path / "b")))


def test_convert_refusals(tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["--output_dir", str(tmp_path / "o"), "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["--output_dir", str(tmp_path / "o"), "--device", "cpu",
                  "--dtype", "int8", "--decoder_dir", "unused"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            cli.main(["--output_dir", str(tmp_path / "o"), "--decoder_dir",
                      "unused"])
