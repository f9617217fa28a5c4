"""Batched lockstep generation over the CSV-backed light dataset
(counterpart of prot2text_tpu/cli/generate_instruct_light.py, reference
scripts/generate_instruct_light.py).

ESMC + adapter + Qwen3 (`models/composed.py ESMCQwen`) encode each batch
of CSV rows (collated by the serve CLI's `LightCollator`, JAX's buckets)
into prompt embeddings, which `ESMCQwen.generate` decodes in lockstep: one
prefill (K1, or the plain function under --attn_impl xla) into a
preallocated cache, then one decode step per token (K4 per layer on
Qwen3-14B's head dim 128).  The final partial batch is padded by repeating its last
row, as JAX pads it, and only the real rows are written: one JSON file
{name: {"true", "pred"}} and a descriptions/hour line.

The model is built as `cli/serve.py build_server` builds it: the towers in
bf16 (or --model_dtype fp32), then a PEFT adapter directory's LoRA
(--load_peft_adapter_dir) merged into the decoder and the LoRA of a
`cli/train_instruct.py` checkpoint (--load_sft_checkpoint_dir, a QLoRA one
too) into both towers, its adapter in place of the random one, then, for
--model_dtype int8/int4, both towers quantized (int4: nibble planes, K10;
int8: K14).  The JAX CLI quantizes
first and then fails in `merge_lora` (ROADMAP.md §3).  The other int4
formats (bf16-pair words, K11b; split-half bytes, K11a) are reached through
the API, as in JAX: `models.quant.quantize_params(..., int4_format=)` on
the towers `build_model` gives at --model_dtype bf16, then
`generate_batches`.

Same flags as the JAX CLI, plus --device (default "cuda"; a missing GPU is
an error, never a silent CPU run).  --llm_checkpoint_dir loads Qwen3 from
an HF directory (`models/hf_import.py`).  Every decoding flag runs:
--num_beams > 1 (`infer/beam_search.py`), --prompt_lookup_tokens, and
--speculative_gamma with a self-draft (--self_speculative_layers) or a
draft model (--draft_checkpoint_dir, Qwen3-0.6B; under --debug_tiny_model
a random copy of the target), all lockstep (`infer/speculative.py`).
Values the port does not have yet raise NotImplementedError naming their
ROADMAP item.

    python -m prot2text_tpu_torch.cli.generate_instruct_light \\
        --test_csv test.csv --device cuda --model_dtype int4
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Iterable

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtypes import QUANTIZED, compute_dtype, str2bool
from ..data.dataset import Prot2TextLightDataset
from ..data.sampler import DataLoader, ShardedSampler
from ..infer.generate import GenerationConfig
from ..infer.speculative import (
    self_speculative_generate, speculative_generate,
)
from ..models.composed import ESMCQwen
from ..models.quant import quantized_bytes
from .common import (
    add_common_args, common_unported, pad_rows, refuse, text_tokenizer,
)
from .serve import build_server, make_collator


def build_parser():
    p = argparse.ArgumentParser("generate_instruct_light")
    add_common_args(p)
    p.add_argument("--test_csv", type=str, required=True)
    p.add_argument("--esm_model", type=str, default="esmc_600m")
    p.add_argument("--llm_model", type=str, default="Qwen/Qwen3-14B")
    p.add_argument("--llm_checkpoint_dir", type=str, default=None)
    p.add_argument("--esm_checkpoint_path", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--load_sft_checkpoint_dir", type=str, default=None)
    p.add_argument("--load_peft_adapter_dir", type=str, default=None)
    p.add_argument("--lora_rank", type=int, default=32)
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
    p.add_argument("--max_sequence_length", type=int, default=512)
    p.add_argument("--speculative_gamma", type=int, default=0)
    p.add_argument("--draft_checkpoint_dir", type=str, default=None)
    p.add_argument("--self_speculative_layers", type=int, default=0)
    p.add_argument("--prompt_lookup_tokens", type=int, default=0)
    p.add_argument("--prompt_lookup_ngram", type=int, default=2)
    p.add_argument("--output_dir", type=str, default="./generation_results")
    p.add_argument("--output_identifier", type=str, default="light")
    p.add_argument("--debug_trim_generate_split", type=int, default=None)
    p.add_argument("--debug_tiny_model", type=str2bool, default=False)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda[:N]' or 'cpu'; a missing GPU raises")
    return p


def refuse_unported(args) -> None:
    """NotImplementedError for every flag value the port lacks."""
    refuse(common_unported(args))


def check_decoding_flags(args) -> None:
    """JAX's SystemExit for decoding flags that do not go together
    (prot2text_tpu/cli/generate_instruct_light.py:156-178)."""
    if args.prompt_lookup_tokens > 0 and args.speculative_gamma > 0:
        raise SystemExit("--prompt_lookup_tokens and --speculative_gamma "
                         "are mutually exclusive draft sources")
    if ((args.prompt_lookup_tokens > 0 or args.speculative_gamma > 0)
            and (args.do_sample or args.num_beams > 1)):
        raise SystemExit("speculative decoding is greedy-only")
    if (args.speculative_gamma > 0 and args.self_speculative_layers <= 0
            and not args.debug_tiny_model and not args.draft_checkpoint_dir):
        raise SystemExit("--speculative_gamma needs --draft_checkpoint_dir")


def build_draft(args, model: ESMCQwen, device):
    """The draft of --speculative_gamma: None without it; "self" with
    --self_speculative_layers (the target's first N layers); else (Qwen3
    config, tree) in the towers' float dtype: under --debug_tiny_model a
    random copy of the target's config from --random_seed + 1, otherwise
    Qwen3-0.6B from the HF directory --draft_checkpoint_dir."""
    if args.speculative_gamma <= 0:
        return None
    if args.self_speculative_layers > 0:
        return "self"
    from ..models.qwen3 import Qwen3Config, init_qwen3_params

    dtype = compute_dtype(args.model_dtype)
    if args.debug_tiny_model:
        llm_cfg = model.config.llm_config
        draft_cfg = type(llm_cfg)(**llm_cfg.__dict__)
        gen = torch.Generator(device=device).manual_seed(args.random_seed + 1)
        return draft_cfg, init_qwen3_params(draft_cfg, generator=gen,
                                            device=device, dtype=dtype)
    from ..models.hf_import import load_state_dict_dir, qwen3_params_from_hf

    draft_cfg = Qwen3Config.qwen3_0_6b()
    return draft_cfg, qwen3_params_from_hf(
        load_state_dict_dir(args.draft_checkpoint_dir), draft_cfg.num_layers,
        device=device, dtype=dtype,
        tie_word_embeddings=draft_cfg.tie_word_embeddings)


def build_model(args, tok, device) -> ESMCQwen:
    """ESMCQwen on `device` as `main` builds it from its flags (`cli/
    serve.py build_server`: bf16 towers, the SFT LoRA merged, then
    quantized for --model_dtype int8/int4), routed by --attn_impl."""
    cfg, params = build_server(args, tok, device)
    return ESMCQwen(cfg, params, attn_impl=args.attn_impl)


AKEYS = ("input_ids", "attention_mask", "protein_input_ids",
         "protein_attention_mask")


def generate_batches(args, tok, model: ESMCQwen, batches: Iterable[dict],
                     device, draft=None, stats: list = None) -> dict:
    """The CLI's batch loop: each collated batch, its last partial one
    padded to --batch_size, decoded → {name: {"true", "pred"}} for the real
    rows.  JAX's four branches (prot2text_tpu/cli/generate_instruct_light.
    py:217-253): prompt lookup, plain decoding and beams through
    `model.generate`; with a `draft` (`build_draft`'s, which `main` builds
    once before the loop, as JAX does), `self_speculative_generate` or
    `speculative_generate` (the draft's prompt: the raw `input_ids` in its
    own embedding) on the decoder inputs of `model.forward`.  With
    `stats`, one stats dict per batch is appended to it, its "tokens" the
    batch's (B, max_new_tokens) output."""
    cfg = model.config.llm_config
    eos_id = getattr(tok, "eos_token_id", cfg.eos_token_id)
    pad_id = getattr(tok, "pad_token_id", cfg.pad_token_id)
    gen_cfg = GenerationConfig(
        max_new_tokens=args.max_new_tokens, eos_token_id=eos_id,
        pad_token_id=pad_id, do_sample=args.do_sample,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        num_beams=args.num_beams, length_penalty=args.length_penalty,
        early_stopping=args.early_stopping,
        prompt_lookup_tokens=args.prompt_lookup_tokens,
        prompt_lookup_ngram=args.prompt_lookup_ngram)
    generator = None
    if args.do_sample:
        generator = torch.Generator(device=device).manual_seed(
            args.random_seed + 1)
    results = {}
    for batch in batches:
        names = batch["name"]
        arrays = pad_rows({k: np.asarray(batch[k]) for k in AKEYS},
                          args.batch_size)
        t = {k: torch.as_tensor(a, dtype=torch.int64, device=device)
             for k, a in arrays.items()}
        st = {} if stats is not None else None
        if draft is None:
            toks = model.generate(
                t["input_ids"], attention_mask=t["attention_mask"],
                protein_input_ids=t["protein_input_ids"],
                protein_attention_mask=t["protein_attention_mask"],
                generator=generator, generation_config=gen_cfg, stats=st)
        else:
            embeds, attn = model.forward(
                protein_input_ids=t["protein_input_ids"],
                protein_attention_mask=t["protein_attention_mask"],
                input_ids=t["input_ids"], attention_mask=t["attention_mask"],
                return_decoder_inputs=True)
            kw = dict(inputs_embeds=embeds, attention_mask=attn,
                      gen_cfg=gen_cfg, gamma=args.speculative_gamma,
                      attn_impl=args.attn_impl, stats=st)
            if draft == "self":
                toks, _ = self_speculative_generate(
                    cfg.core(), model.llm_decoder.tree(),
                    draft_layers=args.self_speculative_layers, **kw)
            else:
                draft_cfg, draft_params = draft
                toks, _ = speculative_generate(
                    cfg.core(), model.llm_decoder.tree(), draft_cfg.core(),
                    draft_params, draft_inputs_embeds=draft_params[
                        "embed_tokens"][t["input_ids"]], **kw)
        if stats is not None:
            st["tokens"] = toks
            stats.append(st)
        toks = toks.cpu().numpy()
        for i, name in enumerate(names):
            pred = tok.decode([x for x in toks[i].tolist() if x != pad_id],
                              skip_special_tokens=True)
            true = tok.decode(
                [x for x in np.asarray(
                    batch["description_input_ids"][i]).tolist()
                 if x != pad_id], skip_special_tokens=True)
            results[name] = {"true": true, "pred": pred}
    return results


def main(argv=None):
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    check_decoding_flags(args)
    device = resolve_device(args.device)
    tok = text_tokenizer(args)
    dataset = Prot2TextLightDataset(args.test_csv)
    if args.debug_trim_generate_split:
        dataset.df = dataset.df.iloc[:args.debug_trim_generate_split]
    loader = DataLoader(
        dataset=dataset, collate_fn=make_collator(args, tok),
        batch_size=args.batch_size, num_workers=args.num_workers,
        sampler=ShardedSampler(len(dataset), shuffle=False),
        drop_last=False)
    model = build_model(args, tok, device)
    if args.model_dtype in QUANTIZED:
        params = model.params()
        print(f"[generate_instruct_light] --model_dtype {args.model_dtype}: "
              f"towers {quantized_bytes(params['esm_encoder'])} + "
              f"{quantized_bytes(params['llm_decoder'])} bytes (ESMC + "
              f"decoder)")
    draft = build_draft(args, model, device)
    t0 = time.time()
    results = generate_batches(args, tok, model, loader, device, draft=draft)
    dt = time.time() - t0

    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir,
                            f"generation_{args.output_identifier}_0.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    n = len(results)
    print(f"{n} proteins in {dt:.1f}s on {device} "
          f"({n / max(dt, 1e-9) * 3600:.0f} descriptions/hour) → {out_path}")
    return results


if __name__ == "__main__":
    main()
