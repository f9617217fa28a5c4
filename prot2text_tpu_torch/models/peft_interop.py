"""PEFT adapter-directory interop (counterpart of
prot2text_tpu/models/peft_interop.py).

The reference saves stage-2 checkpoints as PEFT `save_pretrained` adapter
directories and reloads them with `PeftModel.from_pretrained`.  These
converters carry a decoder's LoRA tree (`models/lora.py`) to and from such a
directory:

  * `lora_params_from_peft_dir(dir, base_params)` → the LoRA tree over
    `base_params` (per-layer A/B stacked on a leading layer dim) and its
    LoraConfig(r, alpha);
  * `save_peft_dir(dir, lora_params, cfg)` → adapter_model.safetensors +
    adapter_config.json that PEFT loads back.

PEFT's key layout:
  base_model.model.model.layers.{i}.self_attn.{q,k,v,o}_proj.lora_A.weight
  (r, din), base_model.model.model.layers.{i}.mlp.{gate,up,down}_proj.
  lora_B.weight (dout, r).  Ours: A = lora_A.T (din, r), B = lora_B.T
  (r, dout).

Both resolve a linear's kernel key through `lora_at` / the base node's own
key, so a tree trained over a quantized base (QLoRA) saves every layer's
A/B, and a quantized base gives the layer count and the key the A/B sit
under.  The safetensors file is read and written by `models/hf_import.py`:
no `safetensors` package is needed.
"""

from __future__ import annotations

import json
import os
import re
from typing import Tuple

import torch

from .hf_import import read_safetensors, write_safetensors
from .lora import _KERNEL_KEYS, LoraConfig, lora_at
from .quant import unpacked_in_dim

_PEFT_NAME = {
    "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
    "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
    "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
    "down_proj": "mlp.down_proj",
}
_KEY = re.compile(
    r"layers\.(\d+)\.((?:self_attn|mlp)\.\w+_proj)\.lora_(A|B)\.weight$")
ADAPTER_FILE = "adapter_model.safetensors"
CONFIG_FILE = "adapter_config.json"


def _kernel_key(node: dict) -> str:
    """The kernel key a base linear node holds (float or quantized)."""
    key = next((k for k in _KERNEL_KEYS if k in node), None)
    if key is None:
        raise ValueError(f"no kernel leaf among {sorted(node)}")
    return key


def lora_params_from_peft_dir(path: str, base_params: dict,
                              dtype=torch.float32) -> Tuple[dict, LoraConfig]:
    """A PEFT LoRA adapter directory targeting a Llama/Qwen3 decoder → the
    LoRA tree over `base_params` (None at every leaf the adapter does not
    adapt; each A/B under the key the base linear holds, on its device, in
    `dtype`) and its LoraConfig.  A projection the adapter names must have
    all of the base's layers, and shapes matching the base's (din
    unpacked from a packed int4 leaf)."""
    with open(os.path.join(path, CONFIG_FILE)) as f:
        acfg = json.load(f)
    cfg = LoraConfig(r=acfg["r"], alpha=acfg["lora_alpha"])
    grouped: dict = {}
    for k, v in read_safetensors(os.path.join(path, ADAPTER_FILE)).items():
        m = _KEY.search(k)
        if m:
            grouped.setdefault((int(m.group(1)), m.group(2)), {})[
                m.group(3)] = v
    layers = base_params["layers"]
    L = layers["q_proj"][_kernel_key(layers["q_proj"])].shape[0]

    def build(name, node):
        key = _kernel_key(node)
        peft_name = _PEFT_NAME[name]
        out = {k: None for k in node}
        if (0, peft_name) not in grouped:
            return out
        w = node[key]
        din, dout = unpacked_in_dim(key, w.shape), w.shape[-1]
        A, B = [], []
        for i in range(L):
            ab = grouped.get((i, peft_name), {})
            if set(ab) != {"A", "B"}:
                raise ValueError(f"{path}: layer {i} of {peft_name} lacks "
                                 f"lora_A or lora_B")
            a, b = ab["A"].T, ab["B"].T
            if a.shape != (din, cfg.r) or b.shape != (cfg.r, dout):
                raise ValueError(
                    f"{path}: {peft_name} layer {i} has A {tuple(a.shape)} "
                    f"and B {tuple(b.shape)}; the base wants ({din}, "
                    f"{cfg.r}) and ({cfg.r}, {dout})")
            A.append(a)
            B.append(b)
        out[key] = {k: torch.stack(v).to(device=w.device, dtype=dtype)
                    for k, v in (("A", A), ("B", B))}
        return out

    def walk(node, prefix):
        if not isinstance(node, dict):
            return None
        return {k: (build(k, v) if prefix == "layers" and k in _PEFT_NAME
                    else walk(v, f"{prefix}/{k}" if prefix else k))
                for k, v in node.items()}

    return walk(base_params, ""), cfg


def save_peft_dir(path: str, lora_params: dict, cfg: LoraConfig,
                  base_model_name: str = "") -> str:
    """A decoder's LoRA tree as a PEFT adapter directory: every layer's A/B
    of every adapted projection (at whichever kernel key, `lora_at`) as f32
    lora_A (r, din) / lora_B (dout, r), and adapter_config.json."""
    os.makedirs(path, exist_ok=True)
    tensors, targets = {}, []
    layers = lora_params["layers"]
    for name, peft_name in _PEFT_NAME.items():
        ab = lora_at(layers.get(name))
        if ab is None:
            continue
        targets.append(name)
        A, B = ab["A"].detach(), ab["B"].detach()
        for i in range(A.shape[0]):
            pre = f"base_model.model.model.layers.{i}.{peft_name}"
            tensors[f"{pre}.lora_A.weight"] = A[i].T.float()
            tensors[f"{pre}.lora_B.weight"] = B[i].T.float()
    write_safetensors(os.path.join(path, ADAPTER_FILE), tensors)
    with open(os.path.join(path, CONFIG_FILE), "w") as f:
        json.dump({
            "peft_type": "LORA",
            "r": cfg.r,
            "lora_alpha": cfg.alpha,
            "lora_dropout": 0.0,
            "target_modules": sorted(targets),
            "bias": "none",
            "base_model_name_or_path": base_model_name,
            "task_type": "CAUSAL_LM",
        }, f, indent=2)
    return path
