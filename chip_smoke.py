#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py              # one card, no arguments

Phases (any failure raises and the script exits non-zero):
  1. setup: versions, the card's name and power limit, the CUDA kernels'
     build from `prot2text_tpu_torch/kernels/csrc` (timed);
  2. kernels: each hand-written kernel (K1 flash prefill, K2 decode
     attention, K3 cache slot write) against its plain PyTorch version on
     the same bf16 inputs computed in fp32, at the slice's own shapes, with
     median CUDA-event times of both;
  3. slice: ESM2-3B → adapter → Llama-3.1-8B (full width and depth, bf16,
     random weights from a seeded CUDA generator) generates 256 tokens for
     4 proteins through `Esm2LlamaInstructForCausalLM.generate`; the launch
     counters must show every kernel on that path;
  4. plumbing: a tiny f32 model on `cuda` (kernels) against the same model
     on `cpu` (plain versions): prefill and first decode-step logits.

The line before the last is a JSON object with one entry per kernel; the
last line is the device contract `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, msg: str) -> None:
    """A failed check raises (also under `python -O`, unlike assert)."""
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain at the slice's shapes


def check_kernels(torch, dev, card):
    from prot2text_tpu_torch.kernels.cache_update import (
        cache_slot_write_bkt, cache_slot_write_bkt_plain,
    )
    from prot2text_tpu_torch.kernels.decode_attention import (
        decode_attention_stacked, decode_attention_stacked_plain,
    )
    from prot2text_tpu_torch.kernels.flash_attention import (
        flash_attention_masked_fwd, flash_attention_masked_plain,
    )

    g = torch.Generator(device=dev).manual_seed(1234)
    bf16 = torch.bfloat16
    rows = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf16)

    # K1: Llama-3.1-8B prefill shape, left-padded causal, ragged starts,
    # one fully masked row
    B, H, Hkv, S, D = 4, 32, 8, 1024, 128
    q = randn(B, H, S, D, scale=D ** -0.5)
    k, v = randn(B, Hkv, S, D), randn(B, Hkv, S, D)
    kv_start = torch.tensor([0, 37, 301, 0], dtype=torch.int32, device=dev)
    kv_len = torch.tensor([S, S - 37, S - 301, 0], dtype=torch.int32,
                          device=dev)
    o, lse = flash_attention_masked_fwd(q, k, v, kv_start, kv_len,
                                        causal=True)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_attention_masked_plain(
        q.float(), k.float(), v.float(), kv_start, kv_len, causal=True)
    err_o = (o.float() - o_ref).abs().max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    torch.testing.assert_close(o.float(), o_ref, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0.0)
    empty_lse = torch.tensor(-1e30, dtype=torch.float32).item()
    require(o[3].abs().max().item() == 0.0, "empty row must give o = 0")
    require(lse[3].max().item() == empty_lse, "empty row must give lse -1e30")
    ms = cuda_ms(torch, lambda: flash_attention_masked_fwd(
        q, k, v, kv_start, kv_len, causal=True))
    plain_ms = cuda_ms(torch, lambda: flash_attention_masked_plain(
        q, k, v, kv_start, kv_len, causal=True))
    log(f"K1 flash prefill B={B} H={H} Hkv={Hkv} S={S} D={D} bf16: "
        f"max|o-plain|={err_o:.3e} (atol/rtol 2e-2) "
        f"max|lse-plain|={err_lse:.3e} (atol 1e-3); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms [{card}]")
    rows["K1"] = dict(max_abs_err=err_o, lse_max_abs_err=err_lse, ms=ms,
                      plain_ms=plain_ms)

    # K2: decode attention over the 8B cache at T = 1024 + 256
    L, B, Hkv, rep, T, D = 32, 4, 8, 4, 1280, 128
    ck, cv = randn(L, B, Hkv, T, D), randn(L, B, Hkv, T, D)
    qg = randn(B, Hkv, rep, D, scale=D ** -0.5)
    kn, vn = randn(B, Hkv, D), randn(B, Hkv, D)
    pos = torch.arange(T, device=dev)
    pad = torch.tensor([0, 37, 301, 5], device=dev)[:, None]
    kv_mask = ((pos >= pad) & (pos < 1024 + 100)).to(torch.int32)
    errs = []
    for li in (0, 7, L - 1):
        a = decode_attention_stacked(qg, ck, cv, kv_mask, kn, vn, li)
        torch.cuda.synchronize()
        a_ref = decode_attention_stacked_plain(
            qg.float(), ck.float(), cv.float(), kv_mask, kn.float(),
            vn.float(), li)
        torch.testing.assert_close(a.float(), a_ref, atol=2e-2, rtol=2e-2)
        errs.append((a.float() - a_ref).abs().max().item())
    ms = cuda_ms(torch, lambda: decode_attention_stacked(
        qg, ck, cv, kv_mask, kn, vn, 7), iters=50)
    plain_ms = cuda_ms(torch, lambda: decode_attention_stacked_plain(
        qg, ck, cv, kv_mask, kn, vn, 7), iters=50)
    log(f"K2 decode attention L={L} B={B} Hkv={Hkv} rep={rep} T={T} D={D} "
        f"bf16: max|a-plain|={max(errs):.3e} (atol/rtol 2e-2); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms per layer [{card}]")
    rows["K2"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)

    # K3: slot write into the same cache, bit-exact
    new = randn(L, B, Hkv, D)
    got = cache_slot_write_bkt(ck.clone(), new, 1100)
    want = cache_slot_write_bkt_plain(ck.clone(), new, 1100)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "K3 is not bit-exact")
    ms = cuda_ms(torch, lambda: cache_slot_write_bkt(ck, new, 1100),
                 iters=50)
    plain_ms = cuda_ms(torch, lambda: cache_slot_write_bkt_plain(
        ck, new, 1100), iters=50)
    log(f"K3 cache slot write L={L} B={B} Hkv={Hkv} T={T} D={D} bf16: "
        f"bit-exact; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]")
    rows["K3"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms)
    return rows


# ---------------------------------------------------------------------------
# phase 3: the full-width slice through the entry point a user calls

AMINO = "ACDEFGHIKLMNPQRSTVWY"
# the CLI's collation buckets (prot2text_tpu/cli/generate_instruct.py:88-93)
BUCKETS = dict(protein=[128, 256, 512, 1024], prompt=[256, 512, 1024, 2048],
               description=[128, 256, 512])


def make_batch(torch, dev, tok, n: int, lengths, seed: int):
    """n instruct records built with numpy through the shared data code
    (chat template, byte tokenizer, ESM2 alphabet), collated as the CLI
    does → dict of int64 tensors on `dev`."""
    import numpy as np

    from prot2text_tpu.data.chat import (
        SYSTEM_MESSAGE, llama3_chat_prompt, protein_user_message,
    )
    from prot2text_tpu.data.collate import Buckets, InstructCollator
    from prot2text_tpu.data.tokenization import esm2_tokenizer

    rng = np.random.default_rng(seed)
    ptok = esm2_tokenizer()
    records = []
    for i in range(n):
        seq = "".join(rng.choice(list(AMINO), int(rng.integers(*lengths))))
        user = protein_user_message(f"Protein {i}", "Homo sapiens",
                                    len(seq) + 2, tok.placeholder_token)
        records.append({
            "name": f"P{i:05d}",
            "sequence_input_ids": np.asarray(ptok.encode(seq), np.int32),
            "prompt_input_ids": np.asarray(tok.encode(
                llama3_chat_prompt(SYSTEM_MESSAGE, user)), np.int32),
            "description_input_ids": np.asarray(
                tok.encode("Unknown function.") + [tok.eos_token_id],
                np.int32),
        })
    batch = InstructCollator(text_pad_token_id=tok.pad_token_id,
                             mode="inference", buckets=Buckets(**BUCKETS))(
                                 records)
    keys = ("input_ids", "attention_mask", "protein_input_ids",
            "protein_attention_mask")
    return {k: torch.as_tensor(batch[k], dtype=torch.int64, device=dev)
            for k in keys}


def build_model(torch, dev, tok, esm_cfg, llama_cfg, dtype, seed: int):
    from prot2text_tpu_torch.models import (
        Esm2LlamaInstructConfig, Esm2LlamaInstructForCausalLM,
        ModalityAdapterConfig,
    )

    llama_cfg = type(llama_cfg)(**{
        **llama_cfg.__dict__, "placeholder_id": tok.placeholder_id,
        "eos_token_id": tok.eos_token_id, "pad_token_id": tok.pad_token_id})
    cfg = Esm2LlamaInstructConfig(
        esm_config=esm_cfg,
        adapter_config=ModalityAdapterConfig(esm_cfg.hidden_size, 2048,
                                             llama_cfg.hidden_size),
        llama_config=llama_cfg, placeholder_id=tok.placeholder_id)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Esm2LlamaInstructForCausalLM(cfg, device=dev, dtype=dtype,
                                        generator=gen)


def generate(torch, model, batch, max_new_tokens: int):
    stats = {}
    if batch["input_ids"].is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = model.generate(
        batch["input_ids"], attention_mask=batch["attention_mask"],
        protein_input_ids=batch["protein_input_ids"],
        protein_attention_mask=batch["protein_attention_mask"],
        max_new_tokens=max_new_tokens, stats=stats)
    stats["total_s"] = time.perf_counter() - t0
    return toks, stats


def run_slice(torch, dev, card):
    from prot2text_tpu.data.chat import ByteTextTokenizer
    from prot2text_tpu_torch.infer.generate import decode_steps_taken
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts
    from prot2text_tpu_torch.models import ESM2Config, LlamaConfig

    B, N = 4, 256
    tok = ByteTextTokenizer()
    t0 = time.perf_counter()
    model = build_model(torch, dev, tok, ESM2Config.t36_3B(),
                        LlamaConfig.llama_3_1_8b(), torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"slice model ESM2-3B + adapter + Llama-3.1-8B bf16: "
        f"{n_params / 1e9:.3f} B params, random init on {dev} in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = make_batch(torch, dev, tok, B, (200, 251), seed=0)
    P = batch["input_ids"].shape[1]
    log(f"batch: B={B} protein width {batch['protein_input_ids'].shape[1]}"
        f" prompt width {P} (valid {batch['attention_mask'].sum(1).tolist()})")

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    toks, st = generate(torch, model, batch, N)
    counts = launch_counts()
    steps = decode_steps_taken(toks, tok.eos_token_id)
    log(f"launches in the slice run: {counts}; decode steps {st['steps']}")
    require(tuple(toks.shape) == (B, N), f"tokens {tuple(toks.shape)}")
    require(st["logits_finite"], "non-finite logits")
    require(steps == st["steps"],
            f"tokens imply {steps} decode steps, generate ran {st['steps']}")
    L = model.config.llama_config.num_layers
    want = {"K1": L, "K2": L * steps, "K3": 2 * steps}
    require(counts == want, f"launch counts {counts} != expected {want}")
    require(steps > 0, "no decode step ran")
    peak = torch.cuda.max_memory_allocated() / 2**30

    # second, timed run (the first one paid cuBLAS/allocator warm-up)
    toks2, st2 = generate(torch, model, batch, N)
    require(torch.equal(toks2, toks), "greedy run is not repeatable")
    for name, s in (("first", st), ("second", st2)):
        encode_s = s["total_s"] - s["prefill_s"] - s["decode_s"]
        log(f"slice {name} run [{card}]: encode+adapter "
            f"{encode_s * 1e3:.2f} ms, prefill {s['prefill_s'] * 1e3:.2f} ms "
            f"(B={B}, P={P}), decode {s['decode_s'] / s['steps'] * 1e3:.3f} "
            f"ms/step over {s['steps']} steps = "
            f"{B * s['steps'] / s['decode_s']:.1f} tokens/s, total "
            f"{s['total_s']:.3f} s = {B / s['total_s'] * 3600:.0f} "
            f"descriptions/hour")
    log(f"slice peak device memory {peak:.2f} GiB [{card}]")
    log(f"first tokens row 0: {toks[0, :12].tolist()}")
    return counts


# ---------------------------------------------------------------------------
# phase 4: the same tiny f32 model on cuda (kernels) and cpu (plain)


def run_plumbing(torch, dev):
    from prot2text_tpu.data.chat import ByteTextTokenizer
    from prot2text_tpu_torch.models import ESM2Config, LlamaConfig

    tok = ByteTextTokenizer()
    esm_cfg = ESM2Config(hidden_size=64, num_layers=2, num_heads=4,
                         intermediate_size=128)
    llama_cfg = LlamaConfig(vocab_size=tok.vocab_size, hidden_size=256,
                            num_layers=2, num_heads=4, num_kv_heads=2,
                            intermediate_size=512, rope_theta=1e4,
                            tie_word_embeddings=False, rope_scaling=None)
    cpu = torch.device("cpu")
    model = build_model(torch, cpu, tok, esm_cfg, llama_cfg, torch.float32,
                        seed=1)
    batch = make_batch(torch, cpu, tok, 2, (20, 60), seed=1)
    _, st_cpu = generate(torch, model, batch, 2)
    model.to(dev)
    _, st_gpu = generate(torch, model, {k: v.to(dev) for k, v in
                                        batch.items()}, 2)
    for i, name in enumerate(("prefill", "first decode step")):
        a, b = st_gpu["logits"][i].cpu(), st_cpu["logits"][i]
        err = (a - b).abs().max().item()
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0.0)
        log(f"plumbing f32 cuda vs cpu, {name} logits: max abs diff "
            f"{err:.3e} (atol 1e-4)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from prot2text_tpu_torch.core.device import resolve_device
    from prot2text_tpu_torch.kernels import KERNELS, _build

    dev = resolve_device("cuda")
    card = card_line()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    so = _build.build()
    _build.library()
    log(f"kernels built in {time.time() - t0:.1f} s → {so.name}")
    report = so.with_suffix(".log")
    if report.exists():       # ptxas: registers / smem / spills per kernel
        fn = None
        for line in report.read_text().splitlines():
            m = re.search(r"entry function '.*?(\w+_kernel\w*)'", line)
            if m:
                fn = m.group(1)
            elif fn and "Used" in line:
                log(f"  {fn}: {line.split(':', 1)[1].strip()}")

    rows = check_kernels(torch, dev, card)
    for kid, n in run_slice(torch, dev, card).items():
        rows[kid]["launches"] = n
    run_plumbing(torch, dev)

    out = []
    for kid, (_, _, src, tpu) in KERNELS.items():
        r = rows[kid]
        out.append({"name": kid, "route": "cuda", "source": src,
                    "replaces": tpu, "launches": r["launches"],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"]})
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
