"""Train Medusa draft heads for speculative serving (counterpart of
prot2text_tpu/cli/train_draft.py; `models/medusa.py`, `train/draft.py`).

Distills K residual-MLP heads against the FROZEN target decoder on the
dataset's description text — the text the serving engine decodes — and
saves the npz that `cli/serve.py --medusa_path` loads ({"w" (K, H, H),
"b" (K, H)} in float32, the file the JAX serve CLI reads too).  The decoder
forward runs without gradients (K1 a layer, no K5), so the trainable state
is only the head stack, f32, under a constant-rate AdamW.

Same flags as the JAX CLI, plus --device (default "cuda"; a missing GPU is
an error, never a silent CPU run).  The towers come from `cli/common.py
build_models` (Qwen3 from --llm_checkpoint_dir when given), the decoder
quantized for --model_dtype int8/int4 as the JAX CLI's `build_models`
does.  --fsdp/--tp/--sp > 1 and --attn_impl ring raise NotImplementedError
naming ROADMAP.md §1 item 14.

    python -m prot2text_tpu_torch.cli.train_draft --train_csv train.csv \\
        --llm_checkpoint_dir qwen3 --num_heads 4 --output_path medusa.npz
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtypes import str2bool
from ..data.dataset import Prot2TextLightDataset
from ..data.sampler import DataLoader, ShardedSampler
from ..models.medusa import MedusaConfig, init_medusa_params
from ..train.draft import make_medusa_train_step
from ..train.optim import TrainState, adamw_constant
from .common import (
    LossLogger, add_common_args, build_models, common_unported,
    quantize_towers, refuse, text_tokenizer,
)


def build_parser():
    p = argparse.ArgumentParser("train_draft")
    add_common_args(p)
    p.add_argument("--train_csv", type=str, required=True)
    p.add_argument("--esm_model", type=str, default="esmc_600m")
    p.add_argument("--llm_model", type=str, default="Qwen/Qwen3-14B")
    p.add_argument("--llm_checkpoint_dir", type=str, default=None)
    p.add_argument("--esm_checkpoint_path", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_sequence_length", type=int, default=256)
    p.add_argument("--num_epochs", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--output_path", type=str, default="medusa.npz")
    p.add_argument("--debug_tiny_model", type=str2bool, default=False)
    p.add_argument("--debug_trim_train_split", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda[:N]' or 'cpu'; a missing GPU raises")
    return p


class DescriptionCollator:
    """Rows → {"input_ids", "attention_mask"} (B, S) int32: each record's
    description ("function") tokens, cut to S and right-padded with the
    tokenizer's pad id (prot2text_tpu/cli/train_draft.py:70-80)."""

    def __init__(self, tok, max_sequence_length: int):
        self.tok = tok
        self.S = max_sequence_length
        self.pad_id = getattr(tok, "pad_token_id", 0) or 0

    def __call__(self, rows) -> dict:
        ids = np.full((len(rows), self.S), self.pad_id, np.int32)
        mask = np.zeros((len(rows), self.S), np.int32)
        for i, row in enumerate(rows):
            t = self.tok.encode(str(row["function"]))[:self.S]
            ids[i, :len(t)] = t
            mask[i, :len(t)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.int64, device=device)
            for k, v in batch.items()}


def save_heads(path: str, params: dict) -> None:
    """The heads as the float32 npz both packages' serve CLIs read."""
    np.savez(path, **{k: params[k].detach().float().cpu().numpy()
                      for k in ("w", "b")})


def build_draft_training(args, tok, device, models=None):
    """(frozen decoder core config, its params, the heads' TrainState, the
    step function) as `main` builds them from its flags: the towers from
    `build_models` (or `models`, its result, when the caller already holds
    it), the decoder quantized for --model_dtype int8/int4, zero-init f32
    heads, AdamW at --learning_rate."""
    _, llm_cfg, _, towers, _ = (models if models is not None else
                                build_models(args, tok, device))
    decoder = quantize_towers({"llm_decoder": towers["llm_decoder"]},
                              args.model_dtype)["llm_decoder"]
    core = llm_cfg.core()
    tx = adamw_constant(args.learning_rate)
    heads = init_medusa_params(MedusaConfig(core.hidden_size, args.num_heads),
                               dtype=torch.float32, device=device)
    return core, decoder, TrainState.create(heads, tx), \
        make_medusa_train_step(core, tx)


def main(argv=None):
    """Trains the heads and saves them; returns their params."""
    args = build_parser().parse_args(argv)
    refuse(common_unported(args))
    device = resolve_device(args.device)
    tok = text_tokenizer(args)

    dataset = Prot2TextLightDataset(args.train_csv)
    if args.debug_trim_train_split:
        dataset.df = dataset.df.iloc[:args.debug_trim_train_split]
    loader = DataLoader(
        dataset=dataset,
        collate_fn=DescriptionCollator(tok, args.max_sequence_length),
        batch_size=args.batch_size,
        sampler=ShardedSampler(len(dataset), shuffle=True,
                               seed=args.random_seed),
        drop_last=True)

    core, decoder, state, step = build_draft_training(args, tok, device)
    logger = LossLogger(args.log_every)
    for epoch in range(args.num_epochs):
        loader.set_epoch(epoch)
        for batch in loader:
            state, loss = step(state, decoder, to_device(batch, device))
            logger.append(loss)
        mean, n = logger.finish()
        print(f"epoch {epoch}: medusa loss {mean:.4f} over {n} steps")

    save_heads(args.output_path, state.params)
    print(f"saved {args.num_heads} heads -> {args.output_path}")
    return state.params


if __name__ == "__main__":
    main()
