"""Stage-1 contrastive training CLI (counterpart of
prot2text_tpu/cli/train_contrast.py, reference scripts/train_contrast.py).

Trains the modality adapter to align frozen ESMC protein embeddings with a
frozen Qwen3's layer-`--output_llm_layer` text embeddings under segmented
InfoNCE (`train/contrastive.py`).  Same flags and loop as the JAX CLI, plus
--device (default "cuda"; a missing GPU is an error, never a silent CPU
run).  The learning rate follows a cosine with 6% warmup over
--num_epochs, stepped once per epoch as the reference's scheduler is.
--model_dtype int8/int4 builds both towers in bf16 and quantizes them per
output channel (`models/quant.quantize_params`); they run forward only.
--attn_impl routes attention as `train/contrastive.py` says ("flash": K6
in ESMC; the text tower takes K1 under "auto" and "flash").  Values the
port does not have yet raise NotImplementedError naming their ROADMAP
item: --fsdp/--tp/--sp > 1 and --attn_impl ring (item 14).
--llm_checkpoint_dir loads the Qwen3 text tower from an HF directory
(`models/hf_import.py`).  Checkpoints {"adapter", "opt_state", "step"}
are the port's own `torch.save` format (`core/checkpoint.py`).

    python -m prot2text_tpu_torch.cli.train_contrast \\
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
from ..models.weights import tree_leaves, tree_map
from ..train.contrastive import (
    BATCH_KEYS, ContrastiveConfig, make_contrastive_eval_step,
    make_contrastive_train_step,
)
from ..train.optim import TrainState, adamw_cosine_warmup
from .common import (
    LossLogger, add_common_args, build_models, common_unported,
    quantize_towers, refuse, text_tokenizer,
)

# the CLI's collation buckets (prot2text_tpu/cli/train_contrast.py:145-147)
BUCKETS = dict(protein=[128, 256, 512, 1024], prompt=[256, 512, 1024, 2048],
               description=[128, 256, 512])


def build_parser():
    p = argparse.ArgumentParser("train_contrast")
    add_common_args(p)
    p.add_argument("--train_csv", type=str, required=True)
    p.add_argument("--eval_csv", type=str, default=None)
    p.add_argument("--esm_model", type=str, default="esmc_600m")
    p.add_argument("--llm_model", type=str, default="Qwen/Qwen3-14B")
    p.add_argument("--llm_checkpoint_dir", type=str, default=None)
    p.add_argument("--esm_checkpoint_path", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_workers", type=int, default=0,
                   help="loader worker processes")
    p.add_argument("--gradient_accumulation_steps", type=int, default=8)
    p.add_argument("--num_epochs", type=int, default=12)
    p.add_argument("--learning_rate", type=float, default=2e-4)
    p.add_argument("--gradient_clipping", type=float, default=None)
    p.add_argument("--contrastive_num_segments", type=int, default=2)
    p.add_argument("--output_llm_layer", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.05)
    p.add_argument("--name_dropout", type=float, default=0.8)
    p.add_argument("--taxonomy_dropout", type=float, default=0.8)
    p.add_argument("--resume_checkpoint_dir", type=str, default=None,
                   help="resume adapter+optimizer+step from a checkpoint dir")
    p.add_argument("--debug_trim_train_split", type=int, default=None)
    p.add_argument("--debug_trim_eval_split", type=int, default=None)
    p.add_argument("--debug_tiny_model", type=str2bool, default=False)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the run here")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda[:N]' or 'cpu'; a missing GPU raises")
    return p


def refuse_unported(args) -> None:
    refuse([
        *common_unported(args),
    ])


def to_device(batch: dict, device, grad_accum: int) -> dict:
    """Host batch → int64 tensors on `device` (BATCH_KEYS), stacked
    (grad_accum, micro_bsz, ...) when accumulating."""
    out = {}
    for k in BATCH_KEYS:
        a = np.asarray(batch[k])
        if grad_accum > 1:
            a = np.stack(np.split(a, grad_accum))
        out[k] = torch.as_tensor(a, dtype=torch.int64, device=device)
    return out


@dataclasses.dataclass
class Contrast:
    """What `main` trains with: the frozen towers, the train state (the
    adapter), the step function and its model keyword arguments."""

    frozen: dict
    state: TrainState
    step_fn: Callable
    step_kw: dict


def build_contrast(args, tok, device, *, steps_per_epoch: int,
                   models=None) -> Contrast:
    """Towers, adapter, per-epoch schedule and contrastive step as `main`
    builds them from its flags (also the entry point of the chip smoke
    test).  `models` is `build_models(args, tok, device)`'s result when the
    caller already holds it (the same args and seed build the same
    towers); the towers are then quantized for --model_dtype int8/int4."""
    esm_cfg, llm_cfg, adapter_cfg, towers, adapter = (
        models if models is not None else build_models(args, tok, device))
    frozen = quantize_towers(towers, args.model_dtype)
    step_kw = dict(
        esm_config=esm_cfg, adapter_config=adapter_cfg,
        decoder_core=llm_cfg.core(),
        cfg=ContrastiveConfig(
            temperature=args.temperature,
            num_segments=args.contrastive_num_segments,
            output_llm_layer=min(args.output_llm_layer,
                                 llm_cfg.num_layers)),
        attn_impl=args.attn_impl)
    # reference parity: the scheduler steps once per epoch over a
    # num_epochs-long cosine
    tx = adamw_cosine_warmup(
        args.learning_rate, total_steps=args.num_epochs, warmup_frac=0.06,
        grad_clip=args.gradient_clipping, steps_per_period=steps_per_epoch)
    if args.resume_checkpoint_dir:
        restored = restore_checkpoint(args.resume_checkpoint_dir,
                                      map_location=device)
        state = TrainState(params=restored["adapter"],
                           opt_state=restored["opt_state"],
                           step=int(restored["step"]))
        print(f"resumed from step {state.step}")
    else:
        # its own copy: a caller's `models` adapter is not trained in place
        state = TrainState.create(tree_map(torch.clone, adapter), tx)
    for t in tree_leaves(state.params):
        t.requires_grad_(True)
    step_fn = make_contrastive_train_step(
        tx=tx, grad_accum=args.gradient_accumulation_steps, **step_kw)
    return Contrast(frozen=frozen, state=state, step_fn=step_fn,
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
    run = build_contrast(args, tok, device,
                         steps_per_epoch=max(len(loader), 1))
    state, frozen = run.state, run.frozen

    eval_loader = None
    if args.eval_csv:
        eval_ds = Prot2TextLightDataset(args.eval_csv)
        if args.debug_trim_eval_split:
            eval_ds.df = eval_ds.df.iloc[:args.debug_trim_eval_split]
        eval_loader = DataLoader(
            dataset=eval_ds,
            collate_fn=LightCollator(
                tokenizer=tok, mode="train",
                placeholder_token=placeholder_token, name_dropout=0.0,
                taxonomy_dropout=0.0, buckets=collater.buckets),
            batch_size=args.batch_size, num_workers=args.num_workers,
            sampler=ShardedSampler(len(eval_ds), shuffle=False))
        eval_fn = make_contrastive_eval_step(**run.step_kw)

    ckpt_dir = timestamped_dir(args.checkpoint_dir)
    dropout_gen = torch.Generator(device=device).manual_seed(args.random_seed)
    with trace(args.profile_dir):
        for epoch in range(1, args.num_epochs + 1):
            loader.set_epoch(epoch)
            t0 = time.time()
            log = LossLogger(args.log_every, positive_required=True)
            for batch in prefetch(iter(loader)):
                state, loss = run.step_fn(state, frozen,
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
                    "adapter": state.params, "opt_state": state.opt_state,
                    "step": state.step})
    print(f"checkpoints → {ckpt_dir}")
    return state


if __name__ == "__main__":
    main()
