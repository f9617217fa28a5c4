"""Continuous-batching serving CLI over the CSV-backed light dataset
(counterpart of prot2text_tpu/cli/serve.py).

ESMC + adapter + Qwen3 (`models/composed.py ESMCQwen`) encode each loader
batch into prompt embeddings, which decode through
`infer.serving.ContinuousBatcher`: a fixed pool of cache slots where every
request advances at its own length and finished slots refill at once.
Greedy by default (token-identical to generate()); --do_sample enables the
HF warper pipeline (temperature/top-k/top-p) per token.  With
--shared_prefix (the default) the longest common token prefix of the first
batch's prompts — the chat template's header — is prefilled once and every
request verified against it prefills only its suffix (kernel K6); with
--prefix_dedup (the default) the pool holds no copy of that prefix and
decode reads its one copy (K9a); otherwise decode is K4.  --kv_bits 8 keeps
the pool in int8 (decode K9b with the deduplicated prefix, K7 without);
--prompt_lookup_tokens γ verifies γ n-gram drafts per slot per round (K9c
or K8 on the int8 pool, K6 on the bf16 one), and --spec_break_even turns
on the controller that falls back to plain rounds.

--model_dtype int8 or int4 quantizes both frozen towers' projections per
output channel (`models/quant.quantize_params`: int8, or int4 nibble
planes) after building them in bf16; the activations, the adapter and the
KV pool stay in bf16, and the decoder's projections at few rows run K14
(int8) or K10 (int4), the prefills' dequantized weights `torch.matmul`.

Same flags as the JAX CLI, plus --device (default "cuda"; a missing GPU is
an error, never a silent CPU run).  --load_sft_checkpoint_dir restores a
checkpoint of the port's `cli/train_instruct.py` (a QLoRA one too) and
merges its LoRA into the towers, and --load_peft_adapter_dir a PEFT
adapter directory's into the decoder (`models/peft_interop.py`), the
towers built in --model_dtype (bf16 for int8/int4) first and quantized
after (the JAX CLI merges after its quantize step and fails; ROADMAP.md
§3).  --attn_impl routes the ESMC encoder as the JAX CLI
does (K6 forward under "flash", plain under "auto" and "xla"); the
engine's decoder keeps its own routes, as JAX serving fixes them.
--llm_checkpoint_dir loads Qwen3 from an HF directory (`models/
hf_import.py`) before the LoRA merge and the quantization.  Values
the port does not have yet raise NotImplementedError naming their ROADMAP
item.  Output: one JSON file
{name: {"true", "pred"}} and a descriptions/hour line.

    python -m prot2text_tpu_torch.cli.serve --test_csv test.csv --device cuda
    python -m prot2text_tpu_torch.cli.serve --test_csv test.csv \
        --model_dtype int4 --kv_bits 8
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Iterable

import numpy as np
import torch

from ..data.collate import Buckets, LightCollator
from ..data.dataset import Prot2TextLightDataset
from ..data.sampler import DataLoader, ShardedSampler

from ..core.checkpoint import restore_checkpoint
from ..core.device import resolve_device
from ..core.dtypes import QUANTIZED, compute_dtype, str2bool
from ..infer.generate import GenerationConfig
from ..infer.serving import ContinuousBatcher
from ..models.composed import ESMCQwen, ESMCQwenConfig
from ..models.lora import LoraConfig, merge_lora
from ..models.peft_interop import lora_params_from_peft_dir
from ..models.quant import quantized_bytes
from .common import (
    add_common_args, build_models, common_unported, quantize_towers, refuse,
    text_tokenizer,
)

# the CLI's collation buckets (prot2text_tpu/cli/serve.py:133-134)
BUCKETS = dict(protein=[128, 256, 512, 1024], prompt=[256, 512, 1024, 2048])
# a shared prefix shorter than this does not pay for its own prefill
MIN_SHARED_PREFIX = 16


def build_parser():
    p = argparse.ArgumentParser("serve")
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
    p.add_argument("--max_slots", type=int, default=8,
                   help="concurrent sequences in the serving pool")
    p.add_argument("--sync_every", type=int, default=8,
                   help="decode tokens per host round-trip")
    p.add_argument("--prompt_pad", type=str,
                   default="384,512,768,1024,1280,1408,1664",
                   help="static prefill width, or comma-separated LENGTH "
                        "BUCKETS: each request prefills at the smallest "
                        "bucket that fits; longer prompts are skipped with "
                        "a warning")
    p.add_argument("--num_workers", type=int, default=0,
                   help="loader worker processes")
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--do_sample", type=str2bool, default=False)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--max_sequence_length", type=int, default=512)
    p.add_argument("--prompt_lookup_tokens", type=int, default=0,
                   help="speculative serving: n-gram drafts per slot, "
                        "verified per row (greedy only; 0 = off)")
    p.add_argument("--prompt_lookup_ngram", type=int, default=2)
    p.add_argument("--medusa_path", type=str, default=None,
                   help="Medusa draft heads (not ported yet)")
    p.add_argument("--spec_break_even", type=float, default=0.0,
                   help="adaptive speculation: fall back to plain decode "
                        "while accepted tokens per verify round and active "
                        "slot stay below this (0 = always speculate)")
    p.add_argument("--spec_probe_every", type=int, default=8,
                   help="while falling back, re-probe speculation every N "
                        "plain dispatches")
    p.add_argument("--kv_bits", type=int, default=None,
                   help="8 = int8 KV cache pool (half the cache bytes per "
                        "slot)")
    p.add_argument("--shared_prefix", type=str2bool, default=True,
                   help="prefix-shared KV: discover the common chat-template "
                        "token prefix from the first batch, compute its KV "
                        "once, and prefill only each request's private "
                        "suffix (requests are verified token by token; "
                        "mismatches fall back to full-prompt prefill)")
    p.add_argument("--prefix_dedup", type=str2bool, default=True,
                   help="store the shared prefix KV once instead of in every "
                        "slot; only applies with --shared_prefix")
    p.add_argument("--output_dir", type=str, default="./generation_results")
    p.add_argument("--output_identifier", type=str, default="serve")
    p.add_argument("--debug_trim_generate_split", type=int, default=None)
    p.add_argument("--debug_tiny_model", type=str2bool, default=False)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda[:N]' or 'cpu'; a missing GPU raises")
    return p


def refuse_unported(args) -> None:
    """NotImplementedError for every flag value the port lacks."""
    refuse([
        (args.medusa_path is not None,
         "--medusa_path (Medusa speculative serving)",
         "§1 item 8, Medusa serving with cli/train_draft.py"),
        *common_unported(args),
    ])


def build_server(args, tok, device):
    """(ESMCQwenConfig, params {"esm_encoder", "adapter", "llm_decoder"}) as
    `main` builds them from its flags: the towers in --model_dtype (bf16
    for int8/int4) through `cli/common.py build_models`, then a PEFT
    adapter directory's LoRA (--load_peft_adapter_dir, `models/
    peft_interop.py`) merged into the decoder, then the SFT checkpoint's
    LoRA merged into both towers (a QLoRA checkpoint's A/B, kept at the
    quantized keys, merge into the same linears) and its adapter in place
    of the random one, then, for int8/int4, both towers quantized."""
    esm_cfg, llm_cfg, adapter_cfg, frozen, adapter = build_models(
        args, tok, device)
    if args.load_peft_adapter_dir:
        lora_tree, lcfg = lora_params_from_peft_dir(
            args.load_peft_adapter_dir, frozen["llm_decoder"])
        frozen["llm_decoder"] = merge_lora(lcfg, frozen["llm_decoder"],
                                           lora_tree)
    if args.load_sft_checkpoint_dir:
        sft = restore_checkpoint(args.load_sft_checkpoint_dir,
                                 map_location=device)
        lora_cfg = LoraConfig(r=args.lora_rank, alpha=2 * args.lora_rank)
        frozen["esm_encoder"] = merge_lora(
            lora_cfg, frozen["esm_encoder"], sft["lora_esm"])
        frozen["llm_decoder"] = merge_lora(
            lora_cfg, frozen["llm_decoder"], sft["lora_llm"])
        adapter = sft["adapter"]
    frozen = quantize_towers(frozen, args.model_dtype)
    placeholder_id = getattr(tok, "placeholder_id", 151669)
    cfg = ESMCQwenConfig(esm_config=esm_cfg, adapter_config=adapter_cfg,
                         llm_config=llm_cfg, placeholder_id=placeholder_id)
    return cfg, {"esm_encoder": frozen["esm_encoder"], "adapter": adapter,
                 "llm_decoder": frozen["llm_decoder"]}


def make_collator(args, tok) -> LightCollator:
    return LightCollator(
        tokenizer=tok, mode="inference",
        placeholder_token=getattr(tok, "placeholder_token",
                                  "<|reserved_special_token_1|>"),
        name_dropout=0.0, taxonomy_dropout=0.0,
        max_sequence_length=args.max_sequence_length,
        buckets=Buckets(**BUCKETS))


def shared_prefix_ids(batch, placeholder_id: int):
    """The longest common token prefix of a batch's prompts, cut at the
    first placeholder (protein rows are per request), or None when there
    are fewer than two prompts or it is shorter than MIN_SHARED_PREFIX."""
    ids = np.asarray(batch["input_ids"])
    am = np.asarray(batch["attention_mask"])
    rows = [ids[i][am[i] > 0] for i in range(ids.shape[0])]
    if len(rows) < 2:
        return None
    L = min(len(r) for r in rows) - 1
    eq = np.ones(max(L, 0), bool)
    for r in rows[1:]:
        eq &= r[:L] == rows[0][:L]
    ncom = int(np.argmin(eq)) if not eq.all() else L
    ph = np.flatnonzero(rows[0][:ncom] == placeholder_id)
    if ph.size:
        ncom = int(ph[0])
    return rows[0][:ncom].copy() if ncom >= MIN_SHARED_PREFIX else None


@torch.no_grad()
def encode_batch(cfg: ESMCQwenConfig, params, batch, device,
                 attn_impl: str = "auto"):
    """A collated batch → (prompt embeddings (B, P, H) on `device`, its
    attention mask as a host array): ESMC (its attention routed by
    `attn_impl`: K6 under "flash", plain under "auto"/"xla"), adapter and
    placeholder merge.  The embeddings stay on the device (the engine's
    device submit); only the small mask comes to the host, for the prompt
    lengths."""
    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=device)

    embeds, attn = ESMCQwen.apply(
        cfg, params, protein_input_ids=tensor(batch["protein_input_ids"]),
        protein_attention_mask=tensor(batch["protein_attention_mask"]),
        input_ids=tensor(batch["input_ids"]),
        attention_mask=tensor(batch["attention_mask"]),
        return_decoder_inputs=True, attn_impl=attn_impl)
    return embeds, attn.cpu().numpy()


@dataclasses.dataclass
class ServeRun:
    results: dict            # name -> {"true", "pred"}
    n_tokens: dict           # name -> tokens generated (EOS included)
    engine: ContinuousBatcher
    seconds: float           # host wall time of the whole loop
    prefix_len: int          # shared prefix tokens (0: none)


def serve(args, tok, cfg: ESMCQwenConfig, params, batches: Iterable[dict],
          device) -> ServeRun:
    """The CLI's serving loop over collated `batches`: encode each batch,
    discover the shared prefix from the first one, then interleave submit
    with `pump` backpressure and drain with `run`.  Ends with the last
    request's tokens on the host."""
    llm_cfg = cfg.llm_config
    eos_id = getattr(tok, "eos_token_id", llm_cfg.eos_token_id)
    pad_id = getattr(tok, "pad_token_id", llm_cfg.pad_token_id)
    gen_cfg = None
    if args.do_sample:
        gen_cfg = GenerationConfig(
            do_sample=True, temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, eos_token_id=eos_id, pad_token_id=pad_id)
    buckets = tuple(int(b) for b in str(args.prompt_pad).split(","))

    def encode(batch):
        return encode_batch(cfg, params, batch, device, args.attn_impl)

    trues, results, n_tokens = {}, {}, {}
    t0 = time.time()
    batch_it = iter(batches)
    first = next(batch_it, None)
    # prefix-shared KV: the first batch's common prompt prefix is the chat
    # template's header; its embeddings are SLICED from the encoder output
    # (what a full prefill would see) and its KV is computed once inside
    # the engine.  Every request is verified against its ids; mismatches
    # prefill their full prompt (use_prefix=False)
    shared_ids = first_enc = prefix_embeds = None
    if first is not None:
        first_enc = encode(first)
        if args.shared_prefix:
            shared_ids = shared_prefix_ids(first, cfg.placeholder_id)
            if shared_ids is not None:
                print(f"[serve] shared prompt prefix: {len(shared_ids)} "
                      "tokens")
    if shared_ids is not None:
        embeds0, attn0 = first_enc
        s0 = embeds0.shape[1] - int(attn0[0].sum())  # row 0's left padding
        prefix_embeds = embeds0[0, s0:s0 + len(shared_ids)]

    eng = ContinuousBatcher(
        llm_cfg.core(), params["llm_decoder"], max_slots=args.max_slots,
        max_len=max(buckets) + args.max_new_tokens,
        prompt_pad=buckets if len(buckets) > 1 else buckets[0],
        eos_token_id=eos_id, cache_dtype=compute_dtype(args.model_dtype),
        sync_every=args.sync_every, gen_cfg=gen_cfg,
        generator=torch.Generator(device=device).manual_seed(
            args.random_seed),
        kv_bits=args.kv_bits,
        prompt_lookup_tokens=args.prompt_lookup_tokens,
        prompt_lookup_ngram=args.prompt_lookup_ngram,
        spec_break_even=args.spec_break_even,
        spec_probe_every=args.spec_probe_every,
        shared_prefix_embeds=prefix_embeds,
        prefix_dedup=args.prefix_dedup and prefix_embeds is not None)

    def finish(name, toks):
        n_tokens[name] = len(toks)
        pred = tok.decode([t for t in toks if t not in (pad_id, eos_id)],
                          skip_special_tokens=True)
        results[name] = {"true": trues.pop(name), "pred": pred}

    def submit_batch(batch, enc):
        embeds, attn = enc
        plens = attn.sum(axis=1).astype(int)
        ids = np.asarray(batch["input_ids"])
        for i, name in enumerate(batch["name"]):
            plen = int(plens[i])
            upfx = False
            if shared_ids is not None and plen > len(shared_ids):
                row = ids[i][np.asarray(batch["attention_mask"][i]) > 0]
                upfx = bool(np.array_equal(row[:len(shared_ids)],
                                           shared_ids))
            eff = plen - len(shared_ids) if upfx else plen
            if eff > max(buckets):
                print(f"[serve] skipping {name}: prompt {eff} > "
                      f"--prompt_pad {max(buckets)}")
                continue
            trues[name] = tok.decode(
                [t for t in np.asarray(
                    batch["description_input_ids"][i]).tolist()
                 if t != pad_id], skip_special_tokens=True)
            eng.submit(name, embeds[i], prompt_len=eff,
                       max_new_tokens=args.max_new_tokens, use_prefix=upfx)

    # submission interleaves with draining (pump backpressure): at most
    # about two batches of prompt embeddings wait at any time
    if first is not None:
        submit_batch(first, first_enc)
        for name, toks in eng.pump(until_queue_below=args.max_slots):
            finish(name, toks)
    for batch in batch_it:
        submit_batch(batch, encode(batch))
        for name, toks in eng.pump(until_queue_below=args.max_slots):
            finish(name, toks)
    for name, toks in eng.run():
        finish(name, toks)
    return ServeRun(results=results, n_tokens=n_tokens, engine=eng,
                    seconds=time.time() - t0,
                    prefix_len=0 if shared_ids is None else len(shared_ids))


def main(argv=None):
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    device = resolve_device(args.device)
    tok = text_tokenizer(args)
    dataset = Prot2TextLightDataset(args.test_csv)
    if args.debug_trim_generate_split:
        dataset.df = dataset.df.iloc[:args.debug_trim_generate_split]
    loader = DataLoader(
        dataset=dataset, collate_fn=make_collator(args, tok),
        batch_size=args.max_slots, num_workers=args.num_workers,
        sampler=ShardedSampler(len(dataset), shuffle=False),
        drop_last=False)
    cfg, params = build_server(args, tok, device)
    if args.model_dtype in QUANTIZED:
        print(f"[serve] --model_dtype {args.model_dtype}: towers "
              f"{quantized_bytes(params['esm_encoder'])} + "
              f"{quantized_bytes(params['llm_decoder'])} bytes (ESMC + "
              f"decoder)")
    run = serve(args, tok, cfg, params, loader, device)

    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir,
                            f"generation_{args.output_identifier}_0.json")
    with open(out_path, "w") as f:
        json.dump(run.results, f, indent=2)
    n = len(run.results)
    eng = run.engine
    spec = ""
    if eng.verify_rounds:
        spec = (f", {eng.verify_rounds} verify rounds accepting "
                f"{eng.acceptance():.2f} tokens per round per active slot")
    print(f"{n} proteins in {run.seconds:.1f}s "
          f"({n / run.seconds * 3600:.0f} descriptions/hour, continuous "
          f"batching, {eng.plain_steps} decode steps{spec}) → {out_path}")
    return run.results


if __name__ == "__main__":
    main()
