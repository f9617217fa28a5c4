"""Convert reference/HF torch checkpoints into the port's checkpoint format
(counterpart of prot2text_tpu/cli/convert_checkpoint.py).

  * --esm2_dir       HF EsmModel dir (safetensors/bin) → esm_encoder tree
  * --esmc_path      esm-package ESMC state-dict .pt → esm_encoder tree
  * --decoder_dir    HF Llama/Qwen3 dir → llm_decoder tree (--qwen3 for
                     the q/k norms)
  * --adapter_path   reference adapter-only .pt → adapter tree (f32)

Every component goes into one tree under the JAX CLI's keys, written as
{output_dir}/step_0/checkpoint.pt by `core/checkpoint.save_checkpoint`,
which `core/checkpoint.restore_checkpoint` reads back.  The same flags as
the JAX CLI, plus --device (default "cuda", where the conversion's casts
and transposes run; a missing GPU raises, never a silent CPU run): the
tensors are read from disk, written leaf by leaf onto the device
(`models/hf_import.py`) and saved from there.  Layer counts not given are
read from the state dict's keys, with or without the "esm."/"model."
prefix.  bf16 safetensors need no `safetensors` package.

    python -m prot2text_tpu_torch.cli.convert_checkpoint \\
        --output_dir ckpt --decoder_dir Qwen3-14B --qwen3 true --device cuda
"""

from __future__ import annotations

import argparse

import torch

from ..core.checkpoint import save_checkpoint
from ..core.device import resolve_device
from ..core.dtypes import str2bool, str2dtype


def build_parser():
    p = argparse.ArgumentParser("convert_checkpoint")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--dtype", type=str2dtype, default="bf16")
    p.add_argument("--esm2_dir", type=str, default=None)
    p.add_argument("--esm2_num_layers", type=int, default=None)
    p.add_argument("--esmc_path", type=str, default=None)
    p.add_argument("--esmc_num_layers", type=int, default=36)
    p.add_argument("--decoder_dir", type=str, default=None)
    p.add_argument("--decoder_num_layers", type=int, default=None)
    p.add_argument("--qwen3", type=str2bool, default=False)
    p.add_argument("--tie_word_embeddings", type=str2bool, default=False)
    p.add_argument("--adapter_path", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda[:N]' or 'cpu'; a missing GPU raises")
    return p


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    if not isinstance(args.dtype, torch.dtype):
        raise SystemExit(f"--dtype {args.dtype}: the converter writes float "
                         f"weights (quantize with models/quant.py)")
    device = resolve_device(args.device)
    tree = {}

    if args.esm2_dir:
        from ..models.hf_import import (
            esm2_params_from_hf, load_state_dict_dir, num_layers_in,
        )

        sd = load_state_dict_dir(args.esm2_dir)
        n = args.esm2_num_layers
        if n is None:
            n = num_layers_in(sd, ("esm.", "esm_encoder."), "encoder.layer.")
        tree["esm_encoder"] = esm2_params_from_hf(sd, n, device=device,
                                                  dtype=args.dtype)
        del sd
        print(f"esm2: {n} layers")

    if args.esmc_path:
        from ..models.esmc import esmc_params_from_torch

        sd = torch.load(args.esmc_path, map_location="cpu",
                        weights_only=True)
        tree["esm_encoder"] = esmc_params_from_torch(
            sd, args.esmc_num_layers, device=device, dtype=args.dtype)
        del sd
        print(f"esmc: {args.esmc_num_layers} layers")

    if args.decoder_dir:
        from ..models.hf_import import (
            decoder_params_from_hf, load_state_dict_dir, num_layers_in,
        )

        sd = load_state_dict_dir(args.decoder_dir)
        n = args.decoder_num_layers
        if n is None:
            n = num_layers_in(sd, ("model.",), "layers.")
        tree["llm_decoder"] = decoder_params_from_hf(
            sd, n, device=device, dtype=args.dtype, qk_norm=args.qwen3,
            tie_word_embeddings=args.tie_word_embeddings)
        del sd
        print(f"decoder: {n} layers (qwen3={args.qwen3})")

    if args.adapter_path:
        from ..models.adapters import modality_adapter_params_from_torch

        sd = torch.load(args.adapter_path, map_location="cpu",
                        weights_only=True)
        if "model_state_dict" in sd:
            sd = sd["model_state_dict"]
        prefix = "adapter." if any(k.startswith("adapter.") for k in sd) \
            else ""
        tree["adapter"] = modality_adapter_params_from_torch(
            sd, device=device, prefix=prefix)
        print("adapter: fc1/fc2 converted")

    if not tree:
        raise SystemExit("nothing to convert — pass at least one source flag")
    path = save_checkpoint(args.output_dir, 0, tree)
    print(f"→ {path}")
    return path


if __name__ == "__main__":
    main()
