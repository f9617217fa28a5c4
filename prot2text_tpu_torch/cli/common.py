"""Shared CLI plumbing (counterpart of prot2text_tpu/cli/common.py and
`build_models` of prot2text_tpu/cli/train_contrast.py:75-128): the common
flags, the loss logger, the text tokenizer, the last batch's padding, the
ESMC + Qwen3 towers and the legacy arc's configuration."""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..data.chat import ByteTextTokenizer

from ..core.dtypes import QUANTIZED, compute_dtype, str2dtype
from ..models.adapters import (
    ModalityAdapterConfig, init_modality_adapter_params,
)
from ..models.composed import Esm2LlamaConfig
from ..models.esm2 import ESM2Config
from ..models.esmc import ESMCConfig, esmc_params_from_torch, init_esmc_params
from ..models.llama import LlamaConfig
from ..models.quant import quantize_params
from ..models.qwen3 import Qwen3Config, init_qwen3_params


def add_common_args(p: argparse.ArgumentParser):
    p.add_argument("--model_dtype", type=str2dtype, default="bf16")
    p.add_argument("--random_seed", type=int, default=42)
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    # "auto": plain encoder attention, K1/K5 in the decoder; "flash": K6/K6b
    # in the encoder too; "xla": the plain function everywhere (the serving
    # engine's decoder keeps its own routes)
    p.add_argument("--attn_impl", type=str, default="auto",
                   choices=["auto", "xla", "flash", "ring"])
    p.add_argument("--checkpoint_dir", type=str, default="./checkpoints")
    p.add_argument("--load_model_checkpoint_path", type=str, default=None)
    p.add_argument("--save_every_epochs", type=int, default=1)
    p.add_argument("--log_every", type=int, default=10,
                   help="steps between loss host-syncs")
    return p


def refuse(todo) -> None:
    """NotImplementedError for the first (bad, what, ROADMAP item) that
    holds: the flag values the port does not have yet."""
    for bad, what, item in todo:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP.md {item})")


def common_unported(args, quantized: bool = False) -> list:
    """The common flags' unported values, for `refuse`.  `quantized=True`
    (serve, train_contrast, generate_instruct_light: frozen towers run
    forward only) accepts --model_dtype int8/int4."""
    return [
        (max(args.fsdp, args.tp, args.sp) > 1, "--fsdp/--tp/--sp > 1",
         "§1 item 14"),
        (args.attn_impl == "ring", "--attn_impl ring", "§1 item 14"),
        (isinstance(args.model_dtype, str) and not quantized,
         f"--model_dtype {args.model_dtype} (LoRA over quantized towers: "
         f"QLoRA)", "§1 item 4"),
    ]


class LossLogger:
    """Per-step losses WITHOUT per-step host syncs: device scalars are
    collected and copied to the host as ONE stacked tensor every
    `log_every` steps.  Each flush warns on non-finite losses and, with
    `positive_required` (the contrastive trainer), on losses <= 0."""

    def __init__(self, log_every: int = 10, positive_required: bool = False):
        self.log_every = max(1, int(log_every))
        self.positive_required = positive_required
        self._pending: list = []
        self._host: list = []

    def append(self, device_loss):
        self._pending.append(device_loss)
        if len(self._pending) >= self.log_every:
            self._flush()

    def _flush(self):
        if not self._pending:
            return
        vals = torch.stack(self._pending).float().cpu().numpy()  # one copy
        self._pending.clear()
        bad = ~np.isfinite(vals)
        if self.positive_required:
            bad |= vals <= 0
        for v in vals[bad]:
            print(f"WARNING: impossible loss {float(v)}", file=sys.stderr)
        self._host.extend(float(v) for v in vals)

    def finish(self) -> tuple:
        """Flush the tail; returns (mean, count) for the epoch print."""
        self._flush()
        n = len(self._host)
        mean = float(np.mean(self._host)) if n else float("nan")
        self._host.clear()
        return mean, n


def text_tokenizer(args):
    """HF tokenizer from a local path, else the offline byte tokenizer."""
    path = getattr(args, "tokenizer_path", None)
    if path:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(path)
        if tok.pad_token_id is None:
            tok.pad_token = "<|reserved_special_token_0|>"
        return tok
    return ByteTextTokenizer()


def pad_rows(arrays: dict, batch_size: int) -> dict:
    """Repeat the last row up to batch_size: one shape for the last batch."""
    out = {}
    for k, a in arrays.items():
        n = batch_size - a.shape[0]
        out[k] = np.concatenate([a, np.repeat(a[-1:], n, axis=0)]) if n else a
    return out


def legacy_config(args, tok) -> Esm2LlamaConfig:
    """The legacy CLIs' model (prot2text_tpu/cli/generate_legacy.py:80-96,
    train_legacy.py:88-101): ESM2-8M → dense + LayerNorm to
    `--decoder_hidden_size` → Llama-3.2-1B, or with `--debug_tiny_model`
    a 2-layer ESM2 and `LlamaConfig.tiny` over the tokenizer's vocabulary;
    bos and eos from the tokenizer."""
    if args.debug_tiny_model:
        esm_cfg = ESM2Config(hidden_size=32, num_layers=2, num_heads=4,
                             intermediate_size=64)
        llama_cfg = LlamaConfig.tiny(
            vocab_size=getattr(tok, "vocab_size", 512))
        dec_hidden = llama_cfg.hidden_size
    else:
        esm_cfg = ESM2Config.t6_8M()
        llama_cfg = LlamaConfig.llama_3_2_1b()
        dec_hidden = args.decoder_hidden_size
    return Esm2LlamaConfig(
        esm_config=esm_cfg, llama_config=llama_cfg,
        decoder_hidden_size=dec_hidden,
        bos_token_id=getattr(tok, "bos_token_id", 128000),
        eos_token_id=getattr(tok, "eos_token_id", 128001))


def build_models(args, tok, device):
    """(esm_cfg, llm_cfg, adapter_cfg, {"esm_encoder", "llm_decoder"},
    adapter): ESMC + Qwen3 towers in `--model_dtype` (random N(0, 0.02)
    from `--random_seed`, or ESMC from `--esm_checkpoint_path`) and an f32
    modality adapter, all on `device`.  For --model_dtype int8/int4 the
    towers are built in bf16 and the caller quantizes them with
    `quantize_towers` (the serve CLI after merging a LoRA, train_contrast
    at once); `args` is left as it is."""
    if args.debug_tiny_model:
        esm_cfg = ESMCConfig.tiny()
        llm_cfg = Qwen3Config(
            vocab_size=getattr(tok, "vocab_size", 512), hidden_size=64,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            intermediate_size=128)
        adapter_cfg = ModalityAdapterConfig(esm_cfg.d_model, 64,
                                            llm_cfg.hidden_size)
    else:
        esm_cfg = (ESMCConfig.esmc_600m() if "600" in args.esm_model
                   else ESMCConfig.esmc_300m())
        llm_cfg = Qwen3Config.qwen3_14b()
        adapter_cfg = ModalityAdapterConfig(esm_cfg.d_model, 2048,
                                            llm_cfg.hidden_size)
    dtype = compute_dtype(args.model_dtype)
    gen = torch.Generator(device=device).manual_seed(args.random_seed)
    kw = dict(generator=gen, device=device)
    if args.esm_checkpoint_path:
        sd = torch.load(args.esm_checkpoint_path, map_location="cpu",
                        weights_only=True)
        esm_params = esmc_params_from_torch(sd, esm_cfg.n_layers,
                                            device=device, dtype=dtype)
    else:
        esm_params = init_esmc_params(esm_cfg, dtype=dtype, **kw)
    llm_params = init_qwen3_params(llm_cfg, dtype=dtype, **kw)
    adapter = init_modality_adapter_params(adapter_cfg, **kw)  # f32
    return (esm_cfg, llm_cfg, adapter_cfg,
            {"esm_encoder": esm_params, "llm_decoder": llm_params}, adapter)


def quantize_towers(towers: dict, model_dtype) -> dict:
    """{"esm_encoder", "llm_decoder"} built in bf16 → both quantized per
    output channel (`models/quant.quantize_params`) for --model_dtype
    int8/int4; the towers as they are for a float dtype."""
    bits = QUANTIZED.get(model_dtype)
    if not bits:
        return towers
    return {name: quantize_params(t, bits=bits) for name, t in towers.items()}
