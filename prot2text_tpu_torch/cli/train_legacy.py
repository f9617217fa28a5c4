"""Legacy full-finetune SFT CLI (counterpart of prot2text_tpu/cli/
train_legacy.py, reference scripts/train_legacy.py).

Trains every parameter of `Esm2LlamaForCausalLM` (ESM2-8M + adapter +
Llama-3.2-1B, concat fusion) on the preprocessed instruct dataset through
the derived collator, with AdamW at optax's defaults + StepLR(gamma) per
epoch (`train/optim.py step_lr`) and the port's legacy step
(`train/legacy.py`).  Parameters are f32, as the JAX CLI builds them,
except the towers read from HF directories by --esm_checkpoint_dir and
--llama_checkpoint_dir (`models/hf_import.py`), which take --model_dtype,
as there (`prot2text_tpu/cli/train_legacy.py:104-117`).  --attn_impl
routes attention as in the other training CLIs ("auto": plain ESM2
attention, K1/K5 in the decoder; "flash" also K6/K6b in ESM2; "xla" the
plain function).  Same flags and loop as
the JAX CLI, plus --device (default "cuda"; a missing GPU is an error,
never a silent CPU run); --eval_csv is accepted and unused, as there.
Checkpoints are the port's `torch.save` format (`core/checkpoint.py`):
{"model", "opt_state", "step"}, which `--resume_checkpoint_dir` restores
and `generate_legacy --load_checkpoint_dir` reads.

    python -m prot2text_tpu_torch.cli.train_legacy \\
        --data_root ROOT --train_csv train.csv --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Callable

import numpy as np
import torch

from ..core.checkpoint import (
    restore_checkpoint, save_checkpoint, timestamped_dir,
)
from ..core.device import resolve_device
from ..core.dtypes import str2bool
from ..core.observe import trace
from ..data.collate import Buckets, DerivedCollator
from ..data.sampler import DataLoader, ShardedSampler, prefetch
from ..models.composed import (
    Esm2LlamaConfig, hf_towers, init_esm2llama_params,
)
from ..models.weights import tree_leaves
from ..train.legacy import make_legacy_train_step
from ..train.optim import AdamW, TrainState, step_lr
from .common import (
    NO_INTEGER_DTYPE, LossLogger, add_common_args, common_unported,
    legacy_config, refuse, refuse_integer_dtype, text_tokenizer,
)
from .train_instruct import to_device

# the CLI's collation buckets (prot2text_tpu/cli/train_legacy.py:72-74)
BUCKETS = dict(protein=[128, 256, 512, 1024], description=[128, 256, 512])


def build_parser():
    p = argparse.ArgumentParser("train_legacy")
    add_common_args(p)
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--train_csv", type=str, required=True)
    p.add_argument("--eval_csv", type=str, default=None,
                   help="accepted and unused, as in the JAX CLI")
    p.add_argument("--esm_checkpoint_dir", type=str, default=None)
    p.add_argument("--llama_checkpoint_dir", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--decoder_hidden_size", type=int, default=2048)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_workers", type=int, default=0)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--num_epochs", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=2e-4)
    p.add_argument("--scheduler_gamma", type=float, default=0.1)
    p.add_argument("--gradient_clipping", type=float, default=None)
    p.add_argument("--original_eos_token_id", type=int, default=128009)
    p.add_argument("--resume_checkpoint_dir", type=str, default=None,
                   help="resume model+optimizer+step (reference"
                        " --load_general_checkpoint_path)")
    p.add_argument("--debug_trim_train_split", type=int, default=None)
    p.add_argument("--debug_tiny_model", type=str2bool, default=False)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the run here")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda[:N]' or 'cpu'; a missing GPU raises")
    return p


def refuse_unported(args) -> None:
    refuse(common_unported(args))
    refuse_integer_dtype(args, NO_INTEGER_DTYPE["legacy"])
    accum = args.gradient_accumulation_steps
    if accum < 1 or args.batch_size % accum:
        raise ValueError(f"--batch_size {args.batch_size} must split into "
                         f"--gradient_accumulation_steps {accum} micro-"
                         f"batches")


@dataclasses.dataclass
class Training:
    """What `main` trains with: the model's configuration, the train
    state, the optimizer and the step function."""

    config: Esm2LlamaConfig
    state: TrainState
    tx: AdamW
    step_fn: Callable


def build_training(args, tok, device, *, steps_per_epoch: int) -> Training:
    """Configuration, f32 parameters (random from --random_seed, the towers
    of --esm_checkpoint_dir/--llama_checkpoint_dir in --model_dtype in
    their place; or the --resume_checkpoint_dir state), StepLR AdamW and
    the legacy step as `main` builds them (also the entry point of the chip
    smoke test)."""
    config = legacy_config(args, tok)
    tx = step_lr(args.learning_rate, args.scheduler_gamma, steps_per_epoch,
                 grad_clip=args.gradient_clipping)
    if args.resume_checkpoint_dir:
        restored = restore_checkpoint(args.resume_checkpoint_dir,
                                      map_location=device)
        state = TrainState(params=restored["model"],
                           opt_state=restored["opt_state"],
                           step=int(restored["step"]))
        print(f"resumed from step {state.step}")
    else:
        gen = torch.Generator(device=device).manual_seed(args.random_seed)
        params = init_esm2llama_params(config, generator=gen, device=device,
                                       dtype=torch.float32)
        params.update(hf_towers(
            config.esm_config, config.llama_config,
            esm_checkpoint_dir=args.esm_checkpoint_dir,
            llama_checkpoint_dir=args.llama_checkpoint_dir, device=device,
            dtype=args.model_dtype))
        state = TrainState.create(params, tx)
    for t in tree_leaves(state.params):
        t.requires_grad_(True)
    step_fn = make_legacy_train_step(
        config=config, tx=tx, attn_impl=args.attn_impl,
        grad_accum=args.gradient_accumulation_steps)
    return Training(config=config, state=state, tx=tx, step_fn=step_fn)


def main(argv=None):
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    device = resolve_device(args.device)
    tok = text_tokenizer(args)
    accum = args.gradient_accumulation_steps

    from ..data.dataset import Prot2TextInstructDataset

    dataset = Prot2TextInstructDataset(
        root_dir=args.data_root, csv_path=args.train_csv,
        description_tokenizer=tok, skip_download=True, skip_reload=True,
        ignore_graph_features=True)
    if args.debug_trim_train_split:
        dataset.usable_uids = dataset.usable_uids[
            :args.debug_trim_train_split]
    collater = DerivedCollator(
        tokenizer=tok, original_eos_token_id=args.original_eos_token_id,
        mode="train", buckets=Buckets(**BUCKETS))
    loader = DataLoader(
        dataset=dataset, collate_fn=collater, batch_size=args.batch_size,
        num_workers=args.num_workers,
        sampler=ShardedSampler(len(dataset), seed=args.random_seed))

    run = build_training(args, tok, device,
                         steps_per_epoch=max(len(loader), 1))
    state = run.state
    ckpt_dir = timestamped_dir(args.checkpoint_dir)
    with trace(args.profile_dir):
        for epoch in range(1, args.num_epochs + 1):
            loader.set_epoch(epoch)
            t0 = time.time()
            log = LossLogger(args.log_every)
            for batch in prefetch(iter(loader)):
                state, loss = run.step_fn(state,
                                          to_device(batch, device, accum))
                log.append(loss)   # device scalar; no per-step sync
            mean_loss, n_steps = log.finish()
            print(f"epoch {epoch}: train_loss={mean_loss:.4f} "
                  f"({time.time() - t0:.1f}s, {n_steps} steps)")
            if np.isnan(mean_loss):
                print("NaN loss — aborting", file=sys.stderr)
                break
            if (epoch == 1 or epoch == args.num_epochs
                    or epoch % args.save_every_epochs == 0):
                save_checkpoint(ckpt_dir, state.step, {
                    "model": state.params, "opt_state": state.opt_state,
                    "step": state.step})
    print(f"checkpoints → {ckpt_dir}")
    return state


if __name__ == "__main__":
    main()
