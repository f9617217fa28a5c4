"""Batched generation CLI for the legacy concat-fusion model (counterpart
of prot2text_tpu/cli/generate_legacy.py, reference
scripts/generate_legacy.py).

Decodes with the port's `Esm2LlamaForCausalLM` (ESM2-8M + adapter +
Llama-3.2-1B, whose head dim 64 puts the lockstep cache in the tbkd layout:
plain decode attention, K12 slot writes; K1 in the prefill) over the
derived collator's inference batches and writes one JSON file per process,
{name: {"true", "pred"}}, whose predictions include the prompt as the
model's output does.  Same flags, plus --device (default "cuda"; a missing
GPU is an error, never a silent CPU run).  Unlike the JAX CLI,
--model_dtype is applied to the weights (bf16 by default), as in
`generate_instruct`.  --load_checkpoint_dir reads the port's checkpoints
(`cli/train_legacy.py`'s timestamped directory of `step_N/checkpoint.pt`).
Values this port does not have yet raise NotImplementedError naming the
ROADMAP item.

    python -m prot2text_tpu_torch.cli.generate_legacy \\
        --data_root ROOT --test_csv test.csv --device cuda
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..core.device import resolve_device
from ..core.dtypes import str2bool
from ..data.collate import Buckets, DerivedCollator
from ..data.sampler import DataLoader, ShardedSampler
from ..models.composed import Esm2LlamaForCausalLM
from .common import (
    add_common_args, common_unported, legacy_config, pad_rows, refuse,
    text_tokenizer,
)

# the CLI's collation buckets (prot2text_tpu/cli/generate_legacy.py:72-74)
BUCKETS = dict(protein=[128, 256, 512, 1024])
BATCH_KEYS = ("input_ids", "attention_mask", "protein_input_ids",
              "protein_attention_mask")


def build_parser():
    p = argparse.ArgumentParser("generate_legacy")
    add_common_args(p)
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--test_csv", type=str, required=True)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--load_checkpoint_dir", type=str, default=None)
    p.add_argument("--decoder_hidden_size", type=int, default=2048)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_workers", type=int, default=0)
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--do_sample", type=str2bool, default=False)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--original_eos_token_id", type=int, default=128009)
    p.add_argument("--output_dir", type=str, default="./generation_results")
    p.add_argument("--output_identifier", type=str, default="legacy")
    p.add_argument("--debug_trim_generate_split", type=int, default=None)
    p.add_argument("--debug_tiny_model", type=str2bool, default=False)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda[:N]' or 'cpu'; a missing GPU raises")
    return p


def build_model(args, tok, device) -> Esm2LlamaForCausalLM:
    """The CLI's model: random weights from --random_seed, or the
    --load_checkpoint_dir checkpoint's, in --model_dtype on `device`."""
    return Esm2LlamaForCausalLM.from_pretrained(
        legacy_config(args, tok),
        combined_checkpoint_dir=args.load_checkpoint_dir,
        dtype=args.model_dtype, device=device,
        generator=torch.Generator(device=device).manual_seed(
            args.random_seed),
        attn_impl=args.attn_impl)


def main(argv=None):
    args = build_parser().parse_args(argv)
    refuse(common_unported(args))
    device = resolve_device(args.device)
    tok = text_tokenizer(args)
    dist = torch.distributed.is_available() and \
        torch.distributed.is_initialized()
    rank = torch.distributed.get_rank() if dist else 0
    world = torch.distributed.get_world_size() if dist else 1

    from ..data.dataset import Prot2TextInstructDataset

    dataset = Prot2TextInstructDataset(
        root_dir=args.data_root, csv_path=args.test_csv,
        description_tokenizer=tok, skip_download=True, skip_reload=True,
        ignore_graph_features=True,
        max_description_length=None)  # untrimmed labels (generate_legacy:144)
    if args.debug_trim_generate_split:
        dataset.usable_uids = dataset.usable_uids[
            :args.debug_trim_generate_split]
    collater = DerivedCollator(
        tokenizer=tok, original_eos_token_id=args.original_eos_token_id,
        mode="inference", buckets=Buckets(**BUCKETS))
    loader = DataLoader(
        dataset=dataset, collate_fn=collater, batch_size=args.batch_size,
        num_workers=args.num_workers,
        sampler=ShardedSampler(len(dataset), num_shards=world,
                               shard_index=rank, shuffle=False),
        drop_last=False)

    model = build_model(args, tok, device)
    sample_gen = None
    if args.do_sample:
        sample_gen = torch.Generator(device=device).manual_seed(
            args.random_seed + 1)
    pad_id = model.config.llama_config.pad_token_id

    results = {}
    t0 = time.time()
    for batch in loader:
        names = batch["name"]
        arrays = pad_rows({k: batch[k] for k in BATCH_KEYS}, args.batch_size)
        t = {k: torch.as_tensor(a, dtype=torch.int64, device=device)
             for k, a in arrays.items()}
        toks = model.generate(
            inputs=t["input_ids"], attention_mask=t["attention_mask"],
            protein_input_ids=t["protein_input_ids"],
            protein_attention_mask=t["protein_attention_mask"],
            generator=sample_gen, max_new_tokens=args.max_new_tokens,
            do_sample=args.do_sample, temperature=args.temperature,
            top_k=args.top_k, top_p=args.top_p).cpu().numpy()
        for i, name in enumerate(names):
            pred = tok.decode([x for x in toks[i].tolist() if x != pad_id],
                              skip_special_tokens=True)
            true = tok.decode(
                [x for x in batch["description_input_ids"][i].tolist()
                 if x != pad_id], skip_special_tokens=True)
            results[name] = {"true": true, "pred": pred}
    dt = time.time() - t0

    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(
        args.output_dir, f"generation_{args.output_identifier}_{rank}.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    n = len(results)
    print(f"{n} proteins in {dt:.1f}s on {device} "
          f"({n / max(dt, 1e-9) * 3600:.0f} descriptions/hour) → {out_path}")
    return results


if __name__ == "__main__":
    main()
