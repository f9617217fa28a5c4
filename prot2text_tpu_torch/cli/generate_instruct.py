"""Batched generation CLI over the preprocessed instruct dataset
(counterpart of prot2text_tpu/cli/generate_instruct.py, reference
scripts/generate_instruct.py).

Decodes with the port's Esm2LlamaInstructForCausalLM and writes one JSON
file per process, {name: {"true", "pred"}}, as the JAX CLI does.  Same flags,
plus --device (default "cuda"; a missing GPU is an error, never a silent
CPU run).  Unlike the JAX CLI, --model_dtype is applied to the weights
(bf16 by default).  --attn_impl routes the encoder and the prefill as the
JAX CLI does: "auto" and "flash" take K1 in the prefill, "xla" the plain
function; "flash" also sends ESM2's attention through K6.
--num_beams > 1 decodes by beam search (`infer/beam_search.py`) and
--prompt_lookup_tokens by prompt-lookup speculative decoding
(`infer/speculative.py`), over the int8 cache too under --kv_bits 8.
--load_checkpoint_dir restores the port's `step_N/checkpoint.pt`;
--esm_checkpoint_dir/--llama_checkpoint_dir load HF directories
(`models/hf_import.py`) over it or over the random weights.  Values this
port does not have yet raise NotImplementedError naming the ROADMAP item.

    python -m prot2text_tpu_torch.cli.generate_instruct \\
        --data_root ROOT --test_csv test.csv --device cuda
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..data.collate import Buckets, InstructCollator
from ..data.sampler import DataLoader, ShardedSampler

from ..core.checkpoint import restore_checkpoint
from ..core.device import resolve_device
from ..core.dtypes import str2bool
from ..models.adapters import ModalityAdapterConfig
from ..models.composed import (
    Esm2LlamaInstructConfig, Esm2LlamaInstructForCausalLM, hf_towers,
    init_instruct_params,
)
from ..models.esm2 import ESM2Config
from ..models.llama import LlamaConfig
from ..models.weights import tree_map
from .common import (
    NO_INTEGER_DTYPE, add_common_args, common_unported, pad_rows, refuse,
    refuse_integer_dtype, text_tokenizer,
)


def build_parser():
    p = argparse.ArgumentParser("generate_instruct")
    add_common_args(p)
    # generate_instruct flags
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--test_csv", type=str, required=True)
    p.add_argument("--esm_checkpoint_dir", type=str, default=None)
    p.add_argument("--llama_checkpoint_dir", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--load_checkpoint_dir", type=str, default=None)
    p.add_argument("--use_graph", type=str2bool, default=False)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_workers", type=int, default=0)
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--length_penalty", type=float, default=1.0)
    p.add_argument("--early_stopping", type=str2bool, default=False)
    p.add_argument("--do_sample", type=str2bool, default=False)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--prompt_lookup_tokens", type=int, default=0)
    p.add_argument("--prompt_lookup_ngram", type=int, default=2)
    p.add_argument("--kv_bits", type=int, default=None,
                   help="8 = int8 KV cache (decode through kernel K7)")
    p.add_argument("--edge_budget", type=int, default=16384)
    p.add_argument("--output_dir", type=str, default="./generation_results")
    p.add_argument("--output_identifier", type=str, default="instruct")
    p.add_argument("--debug_trim_generate_split", type=int, default=None)
    p.add_argument("--debug_tiny_model", type=str2bool, default=False)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda[:N]' or 'cpu'; a missing GPU raises")
    return p


def refuse_unported(args) -> None:
    """NotImplementedError for every flag value the port lacks."""
    refuse([
        (args.use_graph, "--use_graph (RGCN arc)", "§1 item 12"),
        *common_unported(args),
    ])
    refuse_integer_dtype(args, NO_INTEGER_DTYPE["generate_instruct"])


def build_model(args, tok, device) -> Esm2LlamaInstructForCausalLM:
    if args.debug_tiny_model:
        esm_cfg = ESM2Config(hidden_size=32, num_layers=2, num_heads=4,
                             intermediate_size=64)
        llama_cfg = LlamaConfig.tiny(vocab_size=getattr(tok, "vocab_size",
                                                        512))
    else:
        esm_cfg = ESM2Config.t36_3B()
        llama_cfg = LlamaConfig.llama_3_1_8b()
    placeholder_id = getattr(tok, "placeholder_id", 128003)
    llama_cfg = type(llama_cfg)(**{
        **llama_cfg.__dict__,
        "placeholder_id": placeholder_id,
        "eos_token_id": getattr(tok, "eos_token_id", 128009),
        "pad_token_id": getattr(tok, "pad_token_id", 128002),
    })
    cfg = Esm2LlamaInstructConfig(
        esm_config=esm_cfg,
        adapter_config=ModalityAdapterConfig(esm_cfg.hidden_size, 2048,
                                             llama_cfg.hidden_size),
        llama_config=llama_cfg, placeholder_id=placeholder_id)
    return Esm2LlamaInstructForCausalLM(
        cfg, instruct_params(args, cfg, device), attn_impl=args.attn_impl)


def instruct_params(args, cfg: Esm2LlamaInstructConfig, device) -> dict:
    """The model's tree in --model_dtype on `device`: the port's
    `step_N/checkpoint.pt` under --load_checkpoint_dir (its "model" tree if
    it has one, else the tree itself, as the JAX CLI reads it), else
    random weights from --random_seed; then the towers of
    --esm_checkpoint_dir/--llama_checkpoint_dir in their place (the JAX
    CLI declares both flags and reads neither)."""
    dtype = args.model_dtype
    if args.load_checkpoint_dir:
        restored = restore_checkpoint(args.load_checkpoint_dir,
                                      map_location=device)
        params = tree_map(lambda t: t.to(dtype) if t.is_floating_point()
                          else t, restored.get("model", restored))
        missing = [p for p in Esm2LlamaInstructForCausalLM.PARTS
                   if p not in params]
        if missing:
            raise ValueError(f"{args.load_checkpoint_dir} holds "
                             f"{sorted(params)}, not {missing}")
    else:
        gen = torch.Generator(device=device).manual_seed(args.random_seed)
        params = init_instruct_params(cfg, generator=gen, device=device,
                                      dtype=dtype)
    params.update(hf_towers(
        cfg.esm_config, cfg.llama_config,
        esm_checkpoint_dir=args.esm_checkpoint_dir,
        llama_checkpoint_dir=args.llama_checkpoint_dir, device=device,
        dtype=dtype))
    return params


def main(argv=None):
    args = build_parser().parse_args(argv)
    refuse_unported(args)
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
        ignore_graph_features=True)
    if args.debug_trim_generate_split:
        dataset.usable_uids = dataset.usable_uids[
            :args.debug_trim_generate_split]
    collater = InstructCollator(
        text_pad_token_id=getattr(tok, "pad_token_id", 128002),
        mode="inference",
        buckets=Buckets(protein=[128, 256, 512, 1024],
                        prompt=[256, 512, 1024, 2048],
                        description=[128, 256, 512]))
    loader = DataLoader(
        dataset=dataset, collate_fn=lambda b: (collater(b), b),
        batch_size=args.batch_size, num_workers=args.num_workers,
        sampler=ShardedSampler(len(dataset), num_shards=world,
                               shard_index=rank, shuffle=False),
        drop_last=False)

    model = build_model(args, tok, device)
    sample_gen = None
    if args.do_sample:
        sample_gen = torch.Generator(device=device).manual_seed(
            args.random_seed + 1)
    gen_kwargs = dict(max_new_tokens=args.max_new_tokens,
                      do_sample=args.do_sample, temperature=args.temperature,
                      top_k=args.top_k, top_p=args.top_p,
                      num_beams=args.num_beams,
                      length_penalty=args.length_penalty,
                      early_stopping=args.early_stopping,
                      prompt_lookup_tokens=args.prompt_lookup_tokens,
                      prompt_lookup_ngram=args.prompt_lookup_ngram,
                      kv_bits=args.kv_bits)
    pad_id = model.config.llama_config.pad_token_id

    results = {}
    t0 = time.time()
    akeys = ("input_ids", "attention_mask", "protein_input_ids",
             "protein_attention_mask")
    for batch, _records in loader:
        names = batch["name"]
        arrays = pad_rows({k: batch[k] for k in akeys}, args.batch_size)
        t = {k: torch.as_tensor(a, dtype=torch.int64, device=device)
             for k, a in arrays.items()}
        toks = model.generate(
            t["input_ids"], attention_mask=t["attention_mask"],
            protein_input_ids=t["protein_input_ids"],
            protein_attention_mask=t["protein_attention_mask"],
            generator=sample_gen, **gen_kwargs)
        toks = toks.cpu().numpy()
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
