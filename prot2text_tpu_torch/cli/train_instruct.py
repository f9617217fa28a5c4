"""Stage-2 LoRA instruction-SFT CLI (counterpart of
prot2text_tpu/cli/train_instruct.py, reference scripts/train_instruct.py).

Trains LoRA adapters over frozen ESMC + Qwen3 towers plus the full modality
adapter with the port's SFT step (`train/sft.py`).  Same flags and loop as
the JAX CLI, plus --device (default "cuda"; a missing GPU is an error, never
a silent CPU run).  --attn_impl routes attention as the JAX package does
(`train/sft.py`): "auto" (the default) sends every causal decoder
attention, at every sequence length, to K1 forward and K5 backward (the
JAX package's S >= 1024 switch to its Pallas kernel is a TPU measurement
and has no counterpart here) and keeps ESMC's bidirectional attention
plain; "flash" also sends ESMC's attention to K6 forward and K6b backward;
"xla" sends every attention to the plain function.  Values the port does
not have yet raise NotImplementedError naming their ROADMAP item:
--fsdp/--tp/--sp > 1 and --attn_impl ring (item 14), --model_dtype
int8/int4 (item 4, QLoRA), --llm_checkpoint_dir (item 6, HF loader).
Checkpoints are the port's own `torch.save` format (`core/checkpoint.py`).

    python -m prot2text_tpu_torch.cli.train_instruct \\
        --train_csv train.csv --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Callable

import numpy as np
import torch

from ..data.collate import Buckets, LightCollator
from ..data.dataset import Prot2TextLightDataset
from ..data.sampler import DataLoader, ShardedSampler, prefetch

from ..core.checkpoint import (
    restore_checkpoint, save_checkpoint, timestamped_dir,
)
from ..core.device import resolve_device
from ..core.dtypes import str2bool
from ..core.observe import trace
from ..models.lora import LoraConfig, init_lora_params
from ..models.weights import tree_leaves, tree_map
from ..train.optim import AdamW, TrainState, adamw_cosine_warmup
from ..train.sft import SFTConfig, make_sft_eval_step, make_sft_train_step
from .common import (
    LossLogger, add_common_args, build_models, common_unported, refuse,
    text_tokenizer,
)

# the CLI's collation buckets (prot2text_tpu/cli/train_instruct.py:81-83)
BUCKETS = dict(protein=[128, 256, 512, 1024], prompt=[256, 512, 1024, 2048],
               description=[128, 256, 512])
BATCH_KEYS = ("protein_input_ids", "protein_attention_mask", "input_ids",
              "attention_mask", "labels")


def build_parser():
    p = argparse.ArgumentParser("train_instruct")
    add_common_args(p)
    p.add_argument("--train_csv", type=str, required=True)
    p.add_argument("--eval_csv", type=str, default=None)
    p.add_argument("--esm_model", type=str, default="esmc_600m")
    p.add_argument("--llm_model", type=str, default="Qwen/Qwen3-14B")
    p.add_argument("--llm_checkpoint_dir", type=str, default=None)
    p.add_argument("--esm_checkpoint_path", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--load_adapter_checkpoint_dir", type=str, default=None,
                   help="stage-1 adapter checkpoint dir (the port's format)")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=0,
                   help="loader worker processes")
    p.add_argument("--gradient_accumulation_steps", type=int, default=32)
    p.add_argument("--num_epochs", type=int, default=24)
    p.add_argument("--learning_rate", type=float, default=2e-4)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--gradient_clipping", type=float, default=None)
    p.add_argument("--lora_rank", type=int, default=32)
    p.add_argument("--fix_modality_adapter", type=str2bool, default=False)
    p.add_argument("--name_dropout", type=float, default=0.8)
    p.add_argument("--taxonomy_dropout", type=float, default=0.8)
    p.add_argument("--resume_checkpoint_dir", type=str, default=None,
                   help="resume LoRA+adapter+optimizer+step")
    p.add_argument("--debug_trim_train_split", type=int, default=None)
    p.add_argument("--debug_tiny_model", type=str2bool, default=False)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the run here")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda[:N]' or 'cpu'; a missing GPU raises")
    return p


def refuse_unported(args) -> None:
    refuse([
        (args.llm_checkpoint_dir is not None,
         "--llm_checkpoint_dir (HF weight loader)", "§1 item 6"),
        *common_unported(args),
    ])


def to_device(batch: dict, device, grad_accum: int) -> dict:
    """Host batch → int64 tensors on `device`, stacked (grad_accum,
    micro_bsz, ...) when accumulating."""
    out = {}
    for k in BATCH_KEYS:
        a = np.asarray(batch[k])
        if grad_accum > 1:
            a = np.stack(np.split(a, grad_accum))
        out[k] = torch.as_tensor(a, dtype=torch.int64, device=device)
    return out


@dataclasses.dataclass
class Training:
    """What `main` trains with: the frozen towers (+ the frozen adapter),
    the train state, the optimizer, the step function and its model
    keyword arguments."""

    frozen: dict
    state: TrainState
    tx: AdamW
    step_fn: Callable
    step_kw: dict


def build_training(args, tok, device, *, total_steps: int,
                   models=None) -> Training:
    """Towers, LoRA trees, adapter, optimizer and SFT step as `main` builds
    them from its flags (also the entry point of the chip smoke test).
    `models` is `build_models(args, tok, device)`'s result when the caller
    already holds it (the same args and seed build the same towers)."""
    esm_cfg, llm_cfg, adapter_cfg, frozen_models, adapter = (
        models if models is not None else build_models(args, tok, device))
    if args.load_adapter_checkpoint_dir:
        adapter = restore_checkpoint(args.load_adapter_checkpoint_dir,
                                     map_location=device)["adapter"]
    lora_cfg = LoraConfig(r=args.lora_rank, alpha=2 * args.lora_rank)
    step_kw = dict(
        esm_config=esm_cfg, adapter_config=adapter_cfg,
        decoder_core=llm_cfg.core(),
        cfg=SFTConfig(lora=lora_cfg,
                      placeholder_id=getattr(tok, "placeholder_id", 151669),
                      fix_modality_adapter=args.fix_modality_adapter),
        attn_impl=args.attn_impl)
    frozen = {**frozen_models, "adapter": adapter}
    tx = adamw_cosine_warmup(
        args.learning_rate, total_steps=total_steps, warmup_frac=0.06,
        weight_decay=args.weight_decay, grad_clip=args.gradient_clipping)
    if args.resume_checkpoint_dir:
        restored = restore_checkpoint(args.resume_checkpoint_dir,
                                      map_location=device)
        state = TrainState(
            params={k: restored[k] for k in
                    ("lora_esm", "lora_llm", "adapter")},
            opt_state=restored["opt_state"], step=int(restored["step"]))
        print(f"resumed from step {state.step}")
    else:
        lora_gen = torch.Generator(device=device).manual_seed(
            args.random_seed + 1)
        state = TrainState.create({
            "lora_esm": init_lora_params(lora_cfg, frozen["esm_encoder"],
                                         generator=lora_gen),
            "lora_llm": init_lora_params(lora_cfg, frozen["llm_decoder"],
                                         generator=lora_gen),
            # its own copy: the frozen adapter (fix_modality_adapter) must
            # not move with the optimizer's in-place updates
            "adapter": tree_map(torch.clone, adapter),
        }, tx)
    for t in tree_leaves(state.params):
        t.requires_grad_(True)
    step_fn = make_sft_train_step(
        tx=tx, grad_accum=args.gradient_accumulation_steps, **step_kw)
    return Training(frozen=frozen, state=state, tx=tx, step_fn=step_fn,
                    step_kw=step_kw)


def main(argv=None):
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    device = resolve_device(args.device)
    tok = text_tokenizer(args)
    accum = args.gradient_accumulation_steps

    dataset = Prot2TextLightDataset(args.train_csv)
    if args.debug_trim_train_split:
        dataset.df = dataset.df.iloc[:args.debug_trim_train_split]
    placeholder_token = getattr(tok, "placeholder_token",
                                "<|reserved_special_token_1|>")
    collater = LightCollator(
        tokenizer=tok, mode="train", placeholder_token=placeholder_token,
        name_dropout=args.name_dropout,
        taxonomy_dropout=args.taxonomy_dropout, buckets=Buckets(**BUCKETS))
    loader = DataLoader(
        dataset=dataset, collate_fn=collater,
        batch_size=args.batch_size * accum, num_workers=args.num_workers,
        sampler=ShardedSampler(len(dataset), seed=args.random_seed))

    steps_per_epoch = max(len(loader), 1)
    run = build_training(args, tok, device,
                         total_steps=args.num_epochs * steps_per_epoch)
    state, frozen, step_fn = run.state, run.frozen, run.step_fn

    eval_loader = None
    if args.eval_csv:
        eval_ds = Prot2TextLightDataset(args.eval_csv)
        eval_loader = DataLoader(
            dataset=eval_ds,
            collate_fn=LightCollator(
                tokenizer=tok, mode="train",
                placeholder_token=placeholder_token, name_dropout=0.0,
                taxonomy_dropout=0.0, buckets=collater.buckets),
            batch_size=args.batch_size, num_workers=args.num_workers,
            sampler=ShardedSampler(len(eval_ds), shuffle=False))
        eval_fn = make_sft_eval_step(**run.step_kw)

    ckpt_dir = timestamped_dir(args.checkpoint_dir)
    dropout_gen = torch.Generator(device=device).manual_seed(args.random_seed)
    with trace(args.profile_dir):
        for epoch in range(1, args.num_epochs + 1):
            loader.set_epoch(epoch)
            t0 = time.time()
            log = LossLogger(args.log_every)
            for batch in prefetch(iter(loader)):
                state, loss = step_fn(state, frozen,
                                      to_device(batch, device, accum),
                                      dropout_gen)
                log.append(loss)   # device scalar; no per-step sync
            mean_loss, n_steps = log.finish()
            print(f"epoch {epoch}: train_loss={mean_loss:.4f} "
                  f"({time.time() - t0:.1f}s, {n_steps} steps)")
            if np.isnan(mean_loss):
                print("NaN loss — aborting", file=sys.stderr)
                break
            if eval_loader is not None:
                elog = LossLogger(args.log_every)
                for b in eval_loader:
                    elog.append(eval_fn(state.params, frozen,
                                        to_device(b, device, 1)))
                print(f"epoch {epoch}: eval_loss={elog.finish()[0]:.4f}")
            if (epoch == 1 or epoch == args.num_epochs
                    or epoch % args.save_every_epochs == 0):
                save_checkpoint(ckpt_dir, state.step, {
                    **state.params, "opt_state": state.opt_state,
                    "step": state.step})
    print(f"checkpoints → {ckpt_dir}")
    return state


if __name__ == "__main__":
    main()
