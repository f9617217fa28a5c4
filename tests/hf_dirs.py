"""HF-format checkpoint directories written from the port's parameter trees,
for the tests of the port's weight loader and the CLI flags that read it.
No real weights are in the repository, and the package has no exporter
(neither has JAX): these write what `transformers` would save, under its
names, with linear weights (out, in), as safetensors.  Loaded back by
`prot2text_tpu_torch.models.hf_import`, a directory gives the tree it was
written from, bit for bit.  The test modules import it as `hf_dirs`
(pytest puts this directory on the path)."""

from __future__ import annotations

import os

import torch


def _layers(tree: dict, L: int, names: dict, pre: str) -> dict:
    """{HF name: tensor} of the stacked layer leaves: names maps the tree's
    sub-module to its HF name under `pre.{i}.`; kernels go back to (out,
    in)."""
    out = {}
    for mod, hf in names.items():
        for leaf, t in tree[mod].items():
            suffix = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
            for i in range(L):
                x = t[i].T if leaf == "kernel" else t[i]
                out[f"{pre}.{i}.{hf}.{suffix}"] = x
    return out


def esm2_state_dict(tree: dict, L: int) -> dict:
    """An `EsmModel` state dict (no prefix) from the port's ESM2 tree."""
    sd = {"embeddings.word_embeddings.weight": tree["word_embeddings"]}
    sd.update(_layers(tree["layers"], L, {
        "attn_ln": "attention.LayerNorm", "query": "attention.self.query",
        "key": "attention.self.key", "value": "attention.self.value",
        "attn_out": "attention.output.dense", "mlp_ln": "LayerNorm",
        "intermediate": "intermediate.dense", "output": "output.dense",
    }, "encoder.layer"))
    for leaf, t in tree["final_ln"].items():
        sd[f"encoder.emb_layer_norm_after."
           f"{'weight' if leaf == 'scale' else leaf}"] = t
    return sd


def decoder_state_dict(tree: dict, L: int) -> dict:
    """A `LlamaForCausalLM` / `Qwen3ForCausalLM` state dict ("model."
    keys, `lm_head.weight` where the tree has a head) from the port's
    decoder tree."""
    names = {"input_ln": "input_layernorm", "q_proj": "self_attn.q_proj",
             "k_proj": "self_attn.k_proj", "v_proj": "self_attn.v_proj",
             "o_proj": "self_attn.o_proj",
             "post_attn_ln": "post_attention_layernorm",
             "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
             "down_proj": "mlp.down_proj", "q_norm": "self_attn.q_norm",
             "k_norm": "self_attn.k_norm"}
    names = {k: v for k, v in names.items() if k in tree["layers"]}
    sd = {"model.embed_tokens.weight": tree["embed_tokens"],
          "model.norm.weight": tree["final_ln"]["scale"]}
    sd.update(_layers(tree["layers"], L, names, "model.layers"))
    if "lm_head" in tree:
        sd["lm_head.weight"] = tree["lm_head"]["kernel"].T
    return sd


def write(sd: dict, path, dtype=None) -> str:
    """`sd` as `model.safetensors` in the directory `path` (made), each
    tensor contiguous on the CPU, cast to `dtype` when given."""
    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    save_file({k: (v if dtype is None else v.to(dtype)).detach().cpu()
               .contiguous() for k, v in sd.items()},
              os.path.join(path, "model.safetensors"),
              metadata={"format": "pt"})
    return str(path)


def assert_tree_equal(got, want, path: str = "") -> None:
    """Nested dicts of tensors: the same keys, leaves equal in dtype, shape
    and value."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}.{k}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert torch.equal(got.detach().cpu(), want.detach().cpu()), path


def qwen3_cli_dir(path, seed: int = 11):
    """A tiny HF Qwen3 directory at the CLIs' `--debug_tiny_model`
    dimensions (`cli/common.py build_models`), random from `seed`, in f32;
    returns (the directory, the tree it holds)."""
    from types import SimpleNamespace

    from prot2text_tpu_torch.cli.common import build_models
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer

    args = SimpleNamespace(debug_tiny_model=True, model_dtype=torch.float32,
                           random_seed=seed, esm_checkpoint_path=None,
                           llm_checkpoint_dir=None)
    _, cfg, _, towers, _ = build_models(args, ByteTextTokenizer(),
                                        torch.device("cpu"))
    tree = towers["llm_decoder"]
    return write(decoder_state_dict(tree, cfg.num_layers), path), tree


def peft_cli_dir(path, seed: int = 5):
    """A PEFT adapter directory over the CLIs' `--debug_tiny_model` Qwen3
    (every q/k/v/o/gate/up/down projection, r 4, B non-zero, random from
    `seed`), written by the port's `save_peft_dir`; returns (the
    directory, the LoRA tree, its LoraConfig)."""
    from types import SimpleNamespace

    from prot2text_tpu_torch.cli.common import build_models
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer
    from prot2text_tpu_torch.models.lora import LoraConfig, init_lora_params
    from prot2text_tpu_torch.models.peft_interop import save_peft_dir

    args = SimpleNamespace(debug_tiny_model=True, model_dtype=torch.float32,
                           random_seed=seed, esm_checkpoint_path=None,
                           llm_checkpoint_dir=None)
    _, _, _, towers, _ = build_models(args, ByteTextTokenizer(),
                                      torch.device("cpu"))
    cfg = LoraConfig(r=4, alpha=8)
    g = torch.Generator().manual_seed(seed)
    tree = init_lora_params(cfg, towers["llm_decoder"], generator=g)
    for sub in tree["layers"].values():
        if sub.get("kernel") is not None:
            sub["kernel"]["B"].normal_(0.0, 0.05, generator=g)
    return save_peft_dir(str(path), tree, cfg), tree, cfg


def decoder_logits_of(cfg, params, seed: int = 0, S: int = 12):
    """The fp32 logits of a decoder tree on S random tokens (no cache)."""
    from prot2text_tpu_torch.models.decoder import (
        contiguous_lengths, decoder_forward, decoder_logits,
    )

    ids = torch.randint(3, 250, (1, S),
                        generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        h, _ = decoder_forward(
            cfg, params, inputs_embeds=params["embed_tokens"][ids],
            positions=torch.arange(S)[None],
            attn_lengths=contiguous_lengths(torch.ones_like(ids)))
        return decoder_logits(cfg, params, h)
