#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py              # one card, no arguments

Phases (any failure raises and the script exits non-zero):
  1. setup: versions, the card's name and power limit, the CUDA kernels'
     build from `prot2text_tpu_torch/kernels/csrc` (timed);
  2. kernels: each hand-written kernel (K1 flash prefill, K2 decode
     attention and K3 cache slot write (no model path launches them since
     the bf16 lockstep step writes its slot in K4, so these checks stand
     in; K4 is also held at their shape, beside K2), K12/K13 the same
     write on
     Llama-3.2-1B's tbkd cache (K13 k and v in one launch, also against
     two K12 launches; no path calls K12 or K13 since the tbkd lockstep
     step writes its slot in K4, so these checks stand in; K4 is also
     held there at the tbkd strides: bit-identical to the bktd K4 on the
     permuted cache, its slot write bit-exact, timed beside the bktd
     launch and the plain tbkd route; so are K4 at per-row slots and
     K9a with a sequence-leading Pc 256 prefix there, as the tbkd decode
     step runs them, bit-identical to the bktd launches on the permuted
     cache and prefix), K4 decode attention + per-row
     slot write, K5 flash backward (two launches bit-identical), K6 bias
     flash prefill, also at
     ESMC-600M's training shapes (timed there too), K6b its backward at
     ESMC-600M's SFT shapes (two launches bit-identical), K9a K4 over a
     shared prefix; on the int8
     cache K7 decode + slot write, K9b K7 over an int8 prefix, K8 chunk
     verify + chunk write, K9c K8 over an int8 prefix (all four on the
     split body's int8 policy, K7/K8 over its CacheCols columns and
     K9b/K9c over PrefixCols, each route gated by the profiler's kernel
     names; each two launches bit-identical, timed eagerly and from CUDA
     graphs; K7/K8's eager times gated at half their SIMT body's, 0.2456
     and 0.2647 ms on an H100 80GB HBM3 at 700 W), K7 also at
     Llama-3.1-8B's lockstep shape with one scalar slot;
     K10 int4 and K14 int8 weight matmuls at Qwen3-14B's projections,
     K11a/K11b the int4 split-half-byte and bf16-pair-word matmuls at its
     gate/up (up to an install's 3072 rows), down and head, also bit for
     bit against K10's wrapper; K15a-K15g the probe scripts' quantized
     matmuls at their Llama-3.1-8B and Qwen3-14B shapes, K15a at bc 128
     against K14, K15b/K15e against K11a and K15d at K10's tiling against
     K10 bit for bit (their few-row body), K15f exact on the many-row
     body's s8 policy (by the profiler's kernel name); K15h-K15l the
     int8-KV probe operations, bit-exact (K15k on the tensor cores within
     1e-5 of max, also at two ragged shapes, its kernel by the profiler's
     name), at the probe's sizes; K15j and K15l also at the legacy
     cache's (4, 8, 842) at D 64 and 72, and timed from CUDA graphs of
     one call beside ten)
     against its plain PyTorch version on the same bf16 inputs computed in
     fp32, at the paths' own shapes, with median CUDA-event times of both,
     the bound (the larger of the bytes at the HBM rate and the operations
     at the bf16 peak) and, where one PyTorch call computes the same
     function, that call's time on operands built outside the timed region
     (the port never calls it); K1, K2, K4, K5, K6, K6b and K9a also
     print their device time and SDPA's from CUDA graphs (SDPA backward's
     from torch.profiler: no graph holds torch.autograd.grad), their
     useful TFLOP/s and TB/s and share of the bound on that time, and
     their ratio to SDPA, eager and on the device (K3, K12, K13 and
     K15h-l print their device time and their library call's), and their
     eager times
     are gated at a half (K2, K4, K9a, K6b) or a third (K5) of their SIMT
     bodies' times (0.3109, 0.2460, 0.3607, 0.5602 and 3.9088 ms on an
     H100 80GB HBM3 at 700 W); K15g's device time per call comes from
     CUDA graphs beside torch.matmul's on a bf16 copy of the weight;
  3. generation: ESM2-3B → adapter → Llama-3.1-8B (full width and depth,
     bf16, random weights from a seeded CUDA generator) generates 256
     tokens for 4 proteins through `Esm2LlamaInstructForCausalLM.generate`;
     the launch counters must show every kernel on that path (K1 in the
     prefill, K4 a layer a decode step, no K2 or K3); then 16 tokens under
     torch.profiler: the decode window's device time by kernel family (K1,
     K4), its device events a step and its idle share;
  3b. legacy generation: ESM2-8M → dense + LayerNorm → Llama-3.2-1B (full
     width and depth, bf16, random weights) built by
     `cli/generate_legacy.py build_model` generates 256 tokens for 4
     proteins of 380-500 residues through `Esm2LlamaForCausalLM.generate`
     on the D=64 tbkd cache: exact K1 (prefill) and K4 (16 per decode
     step, at the tbkd strides; no K12) counts, the prompt leading the
     output; then 8 tokens under torch.profiler: the decode window's
     device time by kernel family, its device events and busy time a step
     and its idle share;
  3c. ESMC + Qwen3 lockstep generation: ESMC-600M → adapter → Qwen3-14B
     (full width and depth, random weights) through
     `cli/generate_instruct_light.py`: its `build_model` once in bf16,
     the towers quantized to int4 planes, split-half bytes and bf16-pair
     words in turn, 4 x 64 tokens each through the CLI's batch loop
     (exact K10, K11a, K11b counts; planes' first decoder layer and
     logits against its plain twins, bytes' and pairs' logits and tokens
     bit-identical to planes'), then its `main` at `--model_dtype int4`
     over a 6-record CSV at batch 4;
  3d. lockstep speculative decoding and beam search, 4 x 64 tokens each:
     (a)-(c) on phase 3's model right after it (held through 3b and 3c,
     its 22 GiB beside 3c's bf16 Qwen3-14B build would near the card's 80
     GB): `generate(prompt_lookup_tokens=4)` (exact K1 = 32, K6 = 32 a
     verify round), the same with `kv_bits=8` (K8 = 32 a round, 20 query
     rows), `num_beams=4` (K1 = 32, K4 = 32 a step at 16 rows; the cache
     reorder's device time from a profiled window, and alone in 8-byte
     words beside the element gather); (d)-(e) after 3c on its int4
     planes towers through the light CLI's `generate_batches` at
     `--speculative_gamma 4`: `--self_speculative_layers 10` (K4 = 10 a
     draft step, K6 = 40 a round, K10 counted at the few-row and many-row
     bodies) and `--draft_checkpoint_dir` of a random Qwen3-0.6B written as
     bf16 safetensors (loaded back bit-identical; K1 = 40 + 28, K4 = 28 a
     draft step, K6 = 40 a round); every run's first tokens equal the
     plain run's (one K1 prefill), its tokens are vocabulary ids with pad
     after EOS, at most one target forward a token; acceptance, ms a
     round or a beam step and descriptions/hour are printed;
  4. training: stage-2 LoRA SFT of ESMC-600M + adapter + Qwen3-14B (full
     width and depth, bf16 towers, f32 LoRA r=32 and adapter) built and
     stepped as `cli/train_instruct.py` does: 2 AdamW steps of 4
     accumulated B=1 micro-batches at S >= 1024; exact K1/K5 launch
     counts, frozen towers untouched, LoRA B moved; then one micro-step
     under `torch.profiler` for the device-time breakdown; then
     `--attn_impl flash` on the same towers: one micro-batch's loss and
     LoRA-ESM gradients against "auto" (and ESMC's alone against an f32
     copy of the tower), 2 steps with exact K1/K5/K6/K6b counts;
  4e. stage-1 contrastive training through `cli/train_contrast.py`'s
     `build_contrast` on phase 4's towers at the CLI's defaults (batch 8
     x accumulation 8, 2 segments, text tower layer 16) and `--attn_impl
     flash`: 2 steps with exact K1/K6 counts, the adapter moved, the
     towers untouched, one profiled step;
  4q. QLoRA: phase 4's bf16 towers quantized to int4 nibble planes and
     freed, then `cli/train_instruct.py build_training` at `--model_dtype
     int4` and the CLI's defaults (r 32, f32 LoRA and adapter): one
     micro-batch's loss and LoRA gradients through K10 against the plain
     twins on the card, layer 0's up_proj alone (K10 under grad against
     its plain twin, dX against the fp32 product), 2 AdamW steps of 4
     B=1 micro-batches at S >= 1024 with exact K1/K5/K10 counts, every
     packed leaf byte-identical, LoRA B moved at a kernel_q4p leaf of each
     tower, the peak under phase 4's bf16 peak by at least half the
     towers' byte difference, the trained LoRA-LLM through
     `save_peft_dir` and `lora_params_from_peft_dir` bit-identical, one
     profiled micro-step (K10's share, the `_QuantLinear` backwards'
     dequantize and dX products);
  4f. legacy full fine-tuning through `cli/train_legacy.py build_training`
     at its defaults (f32, every parameter trained, StepLR, B 4, S =
     protein 512 + prompt + description 128): 2 steps with exact K1/K5
     counts, every parameter group moved;
  4b. serving: ESMC-600M + adapter + Qwen3-14B (full width and depth,
     bf16, random weights) built by `cli/serve.py build_server` serve 16
     records through the CLI's own loop (`cli/serve.py serve`: shared
     prefix with dedup, 8 slots, sync_every 8, 128 new tokens where the
     CLI defaults to 256); exact K1/K6/K9a launch counts from the engine's
     own counters; then a short run with the shared prefix off (K4) and a
     short profiled one;
  4c. int8-KV and speculative serving through the same model and loop: (a)
     `--kv_bits 8 --prompt_lookup_tokens 4` with the deduplicated prefix,
     16 x 128 (K9c per verify round); (b) `--kv_bits 8`, the same 16
     requests (K9b per decode step, beside 4b's bf16 pool); (c) `--kv_bits
     8 --shared_prefix false --prompt_lookup_tokens 4 --spec_break_even 100
     --spec_probe_every 2`, 8 x 32 (K8 per verify round and K7 per plain
     step of the controller's fallback); (d) `--prompt_lookup_tokens 4` on
     the bf16 pool, 8 x 32 (K6 per verify round); exact launch counts;
     then three short profiled int8 runs, plain and speculative with the
     prefix and the controller's without it (K7 and K8);
  4m. Medusa draft heads on the same model: (a) 2 AdamW steps of
     `train/draft.py` over `cli/train_draft.py`'s description collate at
     the CLI's defaults (K 4, batch 8, S 256, lr 1e-3) on the frozen bf16
     Qwen3-14B (exact K1 = 40 a step, no K5; every decoder leaf
     bit-unchanged, the heads moved; s/step, TFLOP/s, peak), the heads
     saved by the CLI's writer; (b) `cli/serve.py serve --medusa_path`
     with them, 8 x 32, on the bf16 pool (K6 a verify round) and the int8
     pool (K9c), both with the dedup prefix: exact counts, no plain step,
     acceptance >= 1, every first token that of a plain install,
     vocabulary ids; (c) `cli/train_draft.py main` under
     `--debug_tiny_model`, its npz read back bit-identical by the serve
     CLI's loader; (d) `cli/benchmark.py main` on phase 3c's light JSON
     and (b)'s bf16 one with neither `sacrebleu` nor `rouge_score`
     imported, the references against themselves 1.0, BERTScore on random
     embeddings against its formula;
  4d. weight-quantized serving (the bf16 model freed first): the towers
     built by `build_server` with `--model_dtype int4` (bf16, then int4
     nibble planes) serve (e) `--kv_bits 8`, 16 x 128 (K10 per projection
     and head at every row count, the installs' prefills and ESMC included,
     K9b) and (g) `--kv_bits 8 --prompt_lookup_tokens 4`, 8 x 32 (K10 at
     40 rows, K9c), then a short profiled run; `--model_dtype int8`
     serves (f) the 16 requests of (e) on the bf16 pool (K14, K9a); exact
     K10/K14 counts from the engine's counters (`quant_launches`), each
     build's and run's peak;
  5. plumbing: tiny f32 models on `cuda` (kernels) against the same models
     on `cpu` (plain versions): prefill and first decode-step logits at
     head dims 64 (the tbkd cache) and 128 (the bktd cache), K4's f32
     body at either layout's strides, one
     SFT step's loss and LoRA gradients at `--attn_impl` auto and flash
     (K6/K6b), one QLoRA SFT step over int8 and int4 planes / bytes /
     pairs towers in f32 (the dequantized f32 products) and in bf16 (K14,
     K10, K11a, K11b forward under grad, exact counts), one contrastive
     step's loss and adapter gradients (K1, K6),
     a serving engine's install logits
     and tokens (K1, K4, K6, K9a), a speculative bf16-pool engine's tokens,
     Medusa engines with random heads on the f32 pool (K6) and on a
     decisive decoder's int8 pool (K8; plain K7): tokens identical on both
     devices and equal to plain greedy,
     an int8 engine's decode-step and verify-round logits (K7, K8), and
     int4 (planes, bytes, pairs) and int8 weight engines' decode-step and
     verify-round logits and tokens (K10, K11a, K11b, K14), a legacy
     model's generation (K1, K4 on tbkd) and one
     legacy train step (K1, K5); phase 3d's strategies on tiny f32
     decoders at head dims 64 and 128 (prompt lookup on the f32 and the
     int8 cache, the self-draft, a draft model, beams with and without
     early_stopping): tokens identical on both devices, speculative ones
     equal to plain greedy (K1, K4, K6, K7, K8).
  6. probes: the six scripts of `prot2text_tpu_torch/scripts/` through
     their `main()` at their own shapes (R 16 or 128 rows; Llama-3.1-8B's
     q/o, gate/up, down and vocab; Qwen3-14B's MLP), replays cut to 5:
     every variant agrees with its plain version, no row reads above 105%
     of its bound (bound / device time <= 1.05: the weights rotate past
     the L2), the int8-KV probes all pass, and every K15 kernel launches.

The line before the last is a JSON object with one entry per kernel; the
last line is the device contract `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
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


def graph_ms(torch, fn, calls: int = 10) -> float:
    """Median device time of one fn() in milliseconds, from a CUDA graph of
    `calls` back-to-back calls: the host's per-call launch cost (Python
    checks, allocations, the ctypes call), which exceeds a microsecond-scale
    kernel, is left out of the window."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(torch, graph.replay) / calls


def busy_graph_ms(torch, fn, calls: int = 10, iters: int = 30) -> float:
    """Device time of one fn() in milliseconds from a CUDA graph of
    `calls` calls replayed behind a sleep kernel (~0.1 ms): the replay is
    submitted while the device is busy, so the window holds the calls'
    own device time.  `graph_ms`'s window also holds the graph's
    submission, which buries a microsecond kernel even spread over 10
    calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200000)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times) / calls


def cold_ms(torch, fn, w, dev, reps: int = 10) -> float:
    """Device time of one fn(w_i) in milliseconds, HBM-cold: a CUDA graph
    of one pass over copies of w that together exceed twice the card's L2
    (`scripts/_timing.py` `copies`, `time_pass`), as a decode step reads a
    different layer's weight on every call."""
    from prot2text_tpu_torch.scripts import _timing as tm

    ws = [w] + [w.clone() for _ in range(tm.copies(nbytes(w), dev) - 1)]
    t = tm.time_pass(lambda: [fn(wi) for wi in ws], len(ws), dev, reps)
    del ws
    return t["ms"]


# the card's peaks for the bound column (NVIDIA's H100 SXM data sheet, dense)
PEAK_FLOPS = 989e12          # bf16 tensor-core operations per second
PEAK_BYTES = 3.35e12         # HBM bytes per second


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations at
    the bf16 peak and the bytes (each input read once, each output written
    once) at the HBM rate, and which of the two it is."""
    t_ops, t_mem = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_mem),
                bound_by="operations" if t_ops > t_mem else "bytes",
                flops=flops, bytes=nbytes)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def profiled_ms(torch, fn, calls: int = 10) -> float | None:
    """Device time of one fn() in milliseconds from `torch.profiler`: the
    sum of the CUDA kernel events of `calls` calls over `calls`.  For a
    call a CUDA graph cannot hold (a backward through torch.autograd.grad).
    A profiler session that records no device kernel (seen once on the
    card, in a process that had profiled before) is run again; after three
    such sessions the time is not measured: None, and the log says so."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / calls
    log("the profiler recorded no device kernels in three sessions: this "
        "device time is not measured")
    return None


PROFILED_SOURCE = ("torch.profiler kernel times (no CUDA graph holds "
                   "torch.autograd.grad)")
UNPROFILED_SOURCE = ("not measured: the profiler recorded no device kernel "
                     "in three sessions")


def ms_text(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def speed(torch, fn, lib_fn, ms: float, lib_ms: float, bd: dict,
          lib_dev_ms: float | None = None) -> dict:
    """What a kernel call achieved beside its library call: both calls'
    device times from CUDA graphs (the eager times `ms` and `lib_ms` also
    hold the host's launch path; `lib_dev_ms`, where given, stands for a
    library call no graph holds), the useful operations and bytes per
    second and the share of the bound on the device time (the bound's
    count: this data's unmasked pairs or valid columns), and the kernel's
    time over the library call's, eager and on the device.  Without
    `lib_fn`, a `lib_dev_ms` of None is a library time not measured: its
    ratio is None too."""
    dev_ms = graph_ms(torch, fn)
    if lib_dev_ms is None and lib_fn is not None:
        lib_dev_ms = graph_ms(torch, lib_fn)
    return dict(device_ms=dev_ms, library_device_ms=lib_dev_ms,
                useful_tflops=bd["flops"] / dev_ms / 1e9,
                useful_tbps=bd["bytes"] / dev_ms / 1e9,
                bound_share=bd["bound_ms"] / dev_ms, x_library=ms / lib_ms,
                x_library_device=(None if lib_dev_ms is None
                                  else dev_ms / lib_dev_ms))


def speed_text(sp: dict) -> str:
    ratio = sp["x_library_device"]
    return (f"device {sp['device_ms']:.4f} ms (SDPA "
            f"{ms_text(sp['library_device_ms'])}), "
            f"{sp['useful_tflops']:.1f} useful TFLOP/s, "
            f"{sp['useful_tbps']:.2f} TB/s, "
            f"{sp['bound_share']:.1%} of the bound, "
            f"{sp['x_library']:.2f}x SDPA eager, "
            + ("not measured" if ratio is None else f"{ratio:.2f}x")
            + " on the device")


def causal_run_pairs(torch, kv_start, kv_len, S: int) -> int:
    """(query, key) pairs a causal masked-run attention computes: query i
    of row b sees keys j in [kv_start[b], kv_start[b] + kv_len[b]), j <= i."""
    i = torch.arange(S, device=kv_start.device)[None, :]
    s, n = kv_start[:, None].long(), kv_len[:, None].long()
    return int((torch.minimum(i, s + n - 1) - s + 1).clamp(min=0).sum())


def decode_bound(torch, mask, pmask, Hkv, rows, D, itemsize, scale_bytes,
                 fixed_bytes):
    """A decode-attention call's bound: each valid cache column of a row
    (k and v, D elements of `itemsize` bytes, plus `scale_bytes` of scales
    per head) read once; the prefix's columns valid for any row read once
    (the operand is shared); 4·D operations per (query row, valid column)
    per kv head; `fixed_bytes` for q, the output, the new tokens, masks
    and the slot writes."""
    col = Hkv * (2 * D * itemsize + scale_bytes)
    cols = int(mask.sum())
    pcols = 0 if pmask is None else int((pmask > 0).any(dim=0).sum())
    pvalid = 0 if pmask is None else int(pmask.sum())
    flops = 4.0 * D * rows * Hkv * (cols + pvalid)
    return bound(flops, (cols + pcols) * col + fixed_bytes)


def expect(**nonzero) -> dict:
    """Every registered kernel's expected launch count: 0 unless given."""
    from prot2text_tpu_torch.kernels import KERNELS

    return {k: nonzero.get(k, 0) for k in KERNELS}


def sdpa_call(torch, q, k, v, mask):
    """The library yardstick: one `F.scaled_dot_product_attention` call
    (q pre-scaled, grouped-query heads) on operands built beforehand."""
    import torch.nn.functional as F

    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=1.0, enable_gqa=True)


def decode_library_call(torch, qg, ck, cv, kv_mask, kn, vn, li, pk=None,
                        pv=None, pmask=None):
    """SDPA over a pre-built [prefix ‖ cache ‖ current] operand: what one
    library call computes of K2/K4/K9a (their slot writes aside)."""
    B, Hkv, rep, D = qg.shape
    k = torch.cat([ck[li], kn[:, :, None]], dim=2)
    v = torch.cat([cv[li], vn[:, :, None]], dim=2)
    m = torch.cat([kv_mask > 0, torch.ones((B, 1), dtype=torch.bool,
                                           device=qg.device)], dim=1)
    if pk is not None:
        k = torch.cat([pk[li].expand(B, -1, -1, -1), k], dim=2)
        v = torch.cat([pv[li].expand(B, -1, -1, -1), v], dim=2)
        m = torch.cat([pmask > 0, m], dim=1)
    return sdpa_call(torch, qg.reshape(B, Hkv * rep, 1, D), k, v,
                     m[:, None, None, :])


def run_mask(torch, kv_start, kv_len, S: int):
    """(B, 1, S, S) boolean mask of K1's causal key runs, for SDPA."""
    i = torch.arange(S, device=kv_start.device)
    s, n = kv_start[:, None, None].long(), kv_len[:, None, None].long()
    j = i[None, None, :]
    return ((j >= s) & (j < s + n) & (j <= i[None, :, None]))[:, None]


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
        flash_attention_masked_bwd, flash_attention_masked_bwd_plain,
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
    def k1():
        return flash_attention_masked_fwd(q, k, v, kv_start, kv_len,
                                          causal=True)

    ms = cuda_ms(torch, k1)
    plain_ms = cuda_ms(torch, lambda: flash_attention_masked_plain(
        q, k, v, kv_start, kv_len, causal=True))
    lib = sdpa_call(torch, q, k, v, run_mask(torch, kv_start, kv_len, S))
    lib_ms = cuda_ms(torch, lib)
    bd = bound(4.0 * D * H * causal_run_pairs(torch, kv_start, kv_len, S),
               nbytes(q, k, v, o, lse, kv_start, kv_len))
    sp = speed(torch, k1, lib, ms, lib_ms, bd)
    log(f"K1 flash prefill B={B} H={H} Hkv={Hkv} S={S} D={D} bf16: "
        f"max|o-plain|={err_o:.3e} (atol/rtol 2e-2) "
        f"max|lse-plain|={err_lse:.3e} (atol 1e-3); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, SDPA (boolean run mask) {lib_ms:.4f} ms, "
        f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}); "
        f"{speed_text(sp)} [{card}]")
    rows["K1"] = dict(max_abs_err=err_o, lse_max_abs_err=err_lse, ms=ms,
                      plain_ms=plain_ms, library_ms=lib_ms, **bd, **sp)

    # K2: decode attention over the 8B cache at T = 1024 + 256
    L, B, Hkv, rep, T, D = 32, 4, 8, 4, 1280, 128
    ck, cv = randn(L, B, Hkv, T, D), randn(L, B, Hkv, T, D)
    qg = randn(B, Hkv, rep, D, scale=D ** -0.5)
    kn, vn = randn(B, Hkv, D), randn(B, Hkv, D)
    pos = torch.arange(T, device=dev)
    pad = torch.tensor([0, 37, 301, 5], device=dev)[:, None]
    kv_mask = ((pos >= pad) & (pos < 1024 + 100)).to(torch.int32)
    ck0, cv0 = ck.clone(), cv.clone()
    errs, top = [], 0.0
    for li in (0, 7, L - 1):
        n = decode_attention_stacked.launches
        a = decode_attention_stacked(qg, ck, cv, kv_mask, kn, vn, li)
        torch.cuda.synchronize()
        require(decode_attention_stacked.launches == n + 1,
                "K2: one launch per call")
        a_ref = decode_attention_stacked_plain(
            qg.float(), ck.float(), cv.float(), kv_mask, kn.float(),
            vn.float(), li)
        torch.testing.assert_close(a.float(), a_ref, atol=2e-2, rtol=2e-2)
        errs.append((a.float() - a_ref).abs().max().item())
        top = max(top, a_ref.abs().max().item())
    require(torch.equal(ck, ck0) and torch.equal(cv, cv0),
            "K2 changed the cache")
    del ck0, cv0

    def k2():
        return decode_attention_stacked(qg, ck, cv, kv_mask, kn, vn, 7)

    ms = cuda_ms(torch, k2, iters=50)
    plain_ms = cuda_ms(torch, lambda: decode_attention_stacked_plain(
        qg, ck, cv, kv_mask, kn, vn, 7), iters=50)
    lib = decode_library_call(torch, qg, ck, cv, kv_mask, kn, vn, 7)
    lib_ms = cuda_ms(torch, lib, iters=50)
    bd = decode_bound(torch, kv_mask, None, Hkv, rep, D, 2, 0,
                      2 * nbytes(qg) + nbytes(kn, vn, kv_mask))
    sp = speed(torch, k2, lib, ms, lib_ms, bd)
    log(f"K2 decode attention L={L} B={B} Hkv={Hkv} rep={rep} T={T} D={D} "
        f"bf16: max|a-plain|={max(errs):.3e} (atol/rtol 2e-2; "
        f"{max(errs) / top:.2e} of max|plain|) at layers 0, 7, {L - 1}, "
        f"one launch a call, the cache bit-unchanged; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound "
        f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}) per layer; "
        f"{speed_text(sp)} [{card}]")
    require(ms <= 0.155, f"K2 eager {ms:.4f} ms > 0.155 (half the SIMT "
            f"body's)")
    # no model path launches K2 (kernels.OFF_PATH): this check stands in
    rows["K2"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                      library_ms=lib_ms, checked=True, **bd, **sp)
    rows["K4 lockstep"] = check_k4_lockstep(
        torch, dev, card, qg, ck, cv, kv_mask, kn, vn, sp["device_ms"])

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
    idx = torch.tensor([1100], device=dev)
    new5 = new[:, :, :, None, :]

    def lib():
        return ck.index_copy_(3, idx, new5)

    lib_ms = cuda_ms(torch, lib, iters=50)
    # the device alone (CUDA graphs): the eager times hold the host's path
    dev_ms = graph_ms(torch, lambda: cache_slot_write_bkt(ck, new, 1100))
    lib_dev_ms = graph_ms(torch, lib)
    bd = bound(0.0, 2 * nbytes(new))        # read the new rows, write them
    log(f"K3 cache slot write L={L} B={B} Hkv={Hkv} T={T} D={D} bf16: "
        f"bit-exact; kernel {ms:.4f} ms (device {dev_ms:.4f} ms from CUDA "
        f"graphs), plain {plain_ms:.4f} ms, index_copy_ {lib_ms:.4f} ms "
        f"(device {lib_dev_ms:.4f} ms), bound {bd['bound_ms']:.4f} ms "
        f"({bd['bound_by']}) [{card}]")
    rows["K3"] = dict(max_abs_err=0.0, ms=ms, device_ms=dev_ms,
                      plain_ms=plain_ms, library_ms=lib_ms,
                      library_device_ms=lib_dev_ms, checked=True, **bd)

    # K1 again, then K5, at the Qwen3-14B training shape (rep 5, causal,
    # kv_start > 0 and a padded tail) for S = 1152, the S the training
    # buckets give, and S = 1280; q/k/v/dO laid out as the decoder hands
    # them over (views of (B, S, H, D) buffers); then a D=64 case (rep 3).
    # K1: o atol/rtol 2e-2, lse atol 1e-3 as above.  K5 per gradient:
    # max|kernel - plain| <= 2e-2 * max|plain|
    errs = []
    for B, H, Hkv, S, D, start, tail in ((1, 40, 8, 1152, 128, 37, 50),
                                         (1, 40, 8, 1280, 128, 37, 50),
                                         (2, 18, 6, 512, 64, 11, 20)):
        def bshd(h, scale=1.0):
            return randn(B, S, h, D, scale=scale).transpose(1, 2)

        q, k, v = bshd(H, D ** -0.5), bshd(Hkv), bshd(Hkv)
        do = bshd(H, D ** -0.5)
        kv_start = torch.full((B,), start, dtype=torch.int32, device=dev)
        kv_len = torch.full((B,), S - start - tail, dtype=torch.int32,
                            device=dev)
        o, lse = flash_attention_masked_fwd(q, k, v, kv_start, kv_len,
                                            causal=True)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_attention_masked_plain(
            q.float(), k.float(), v.float(), kv_start, kv_len, causal=True)
        e_o = (o.float() - o_ref).abs().max().item()
        e_lse = (lse - lse_ref).abs().max().item()
        torch.testing.assert_close(o.float(), o_ref, atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0.0)
        rows["K1"]["max_abs_err"] = max(rows["K1"]["max_abs_err"], e_o)
        rows["K1"]["lse_max_abs_err"] = max(rows["K1"]["lse_max_abs_err"],
                                            e_lse)
        log(f"K1 flash forward B={B} H={H} Hkv={Hkv} S={S} D={D} causal "
            f"bf16 (training layout): max|o-plain|={e_o:.3e} (atol/rtol "
            f"2e-2) max|lse-plain|={e_lse:.3e} (atol 1e-3)")
        del o_ref, lse_ref
        def k5():
            return flash_attention_masked_bwd(q, k, v, o, lse, do, kv_start,
                                              kv_len, causal=True)

        got = k5()
        again = k5()
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"K5 at S={S} D={D}: two launches differ")
        del again
        want = flash_attention_masked_bwd_plain(
            q.float(), k.float(), v.float(), o.float(), lse, do.float(),
            kv_start, kv_len, causal=True)
        parts = []
        for name, gr, w in zip(("dq", "dk", "dv"), got, want):
            err, top = (gr.float() - w).abs().max().item(), w.abs().max().item()
            require(err <= 2e-2 * top, f"K5 {name} at D={D}: max|err| {err} "
                    f"> 2e-2 * max|plain| {top}")
            errs.append(err)
            parts.append(f"{name} {err:.3e} (max|plain| {top:.3e})")
        log(f"K5 flash backward B={B} H={H} Hkv={Hkv} S={S} D={D} causal "
            f"bf16: two launches bit-identical; max|kernel-plain| " +
            ", ".join(parts))
        if S == 1280:
            ms = cuda_ms(torch, k5)
            plain_ms = cuda_ms(torch, lambda: flash_attention_masked_bwd_plain(
                q, k, v, o, lse, do, kv_start, kv_len, causal=True))
            # the library's backward of the same SDPA call (its forward,
            # which keeps the graph, runs outside the timed region); no
            # CUDA graph holds torch.autograd.grad, so its device time is
            # the profiler's sum of its kernels, K5's beside it
            qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
            out = torch.nn.functional.scaled_dot_product_attention(
                qr, kr, vr, attn_mask=run_mask(torch, kv_start, kv_len, S),
                scale=1.0, enable_gqa=True)

            def lib():
                return torch.autograd.grad(out, (qr, kr, vr), do,
                                           retain_graph=True)

            lib_ms = cuda_ms(torch, lib)
            lib_dev = profiled_ms(torch, lib)
            k5_prof = profiled_ms(torch, k5)
            del qr, kr, vr, out
            # recomputed q·kᵀ, dO·vᵀ, Pᵀ·dO, dS·k and dSᵀ·q: 10·D per pair
            bd = bound(10.0 * D * H * causal_run_pairs(torch, kv_start,
                                                       kv_len, S),
                       nbytes(q, k, v, o, lse, do, *got))
            sp = speed(torch, k5, None, ms, lib_ms, bd, lib_dev_ms=lib_dev)
            sp["device_ms_profiler"] = k5_prof
            sp["library_device_source"] = (
                PROFILED_SOURCE if lib_dev is not None else UNPROFILED_SOURCE)
            log(f"K5 at B={B} H={H} S={S} D={D}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, SDPA backward {lib_ms:.4f} ms, bound "
                f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}); "
                f"{speed_text(sp)} (SDPA's device time and K5's "
                f"{ms_text(k5_prof)} from the profiler) [{card}]")
            require(ms <= 1.30, f"K5 eager {ms:.4f} ms > 1.30 (a third of "
                    f"the SIMT body's)")
        del q, k, v, do, o, lse, got, want
    rows["K5"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                      library_ms=lib_ms, **bd, **sp)
    return rows


def check_k4_lockstep(torch, dev, card, qg, ck, cv, kv_mask, kn, vn,
                      k2_device_ms):
    """K4 as the bf16 lockstep step runs it, at K2's generation shape
    (Llama-3.1-8B, B 4, Hkv 8, rep 4, T 1280): one scalar slot broadcast
    to every row (the first column kv_mask leaves 0, so the body never
    reads what it writes), at layers 0, 7 and L - 1: the attention within
    2e-2 of the plain version and beside K2's on the same inputs (bit for
    bit or not, logged), the written cache bit-exact against K3's write of
    those layers; the launch in one wave (the card's resident clusters of
    the instantiation against B·Hkv); its device time per layer beside
    K2's."""
    from prot2text_tpu_torch.kernels.decode_attention import (
        decode_attention_stacked, decode_attention_stacked_plain,
        decode_attention_stacked_write, split_resident_clusters,
    )

    L, B, Hkv, T, D = ck.shape
    rep = qg.shape[2]
    # the step's slot: the column after the last one any row holds
    slot = int(torch.nonzero(kv_mask.sum(dim=0))[-1]) + 1
    require(slot < T, "K4 at the lockstep shape: no free column")
    slots = torch.full((B,), slot, dtype=torch.int32, device=dev)
    ck4, cv4 = ck.clone(), cv.clone()
    want_k, want_v = ck.clone(), cv.clone()
    errs, same = [], True
    for li in (0, 7, L - 1):
        a4 = decode_attention_stacked_write(qg, ck4, cv4, kv_mask, kn, vn,
                                            li, slots)
        a2 = decode_attention_stacked(qg, ck, cv, kv_mask, kn, vn, li)
        torch.cuda.synchronize()
        ref = decode_attention_stacked_plain(
            qg.float(), ck.float(), cv.float(), kv_mask, kn.float(),
            vn.float(), li)
        torch.testing.assert_close(a4.float(), ref, atol=2e-2, rtol=2e-2)
        errs.append((a4.float() - ref).abs().max().item())
        same = same and torch.equal(a4, a2)
        want_k[li, :, :, slot] = kn
        want_v[li, :, :, slot] = vn
    require(torch.equal(ck4, want_k) and torch.equal(cv4, want_v),
            "K4 at the lockstep shape: the written cache is not K3's write")
    resident = split_resident_clusters(False, rep, D, prefix=False)
    require(B * Hkv <= resident, f"K4 at the lockstep shape: {B * Hkv} "
            f"clusters, {resident} resident: a second wave")

    def k4():
        return decode_attention_stacked_write(qg, ck4, cv4, kv_mask, kn, vn,
                                              7, slots)

    ms = cuda_ms(torch, k4, iters=50)
    dev_ms = graph_ms(torch, k4)
    bd = decode_bound(torch, kv_mask, None, Hkv, rep, D, 2, 0,
                      2 * nbytes(qg) + nbytes(kn, vn, kv_mask, slots)
                      + nbytes(kn, vn))
    log(f"K4 at the lockstep shape L={L} B={B} Hkv={Hkv} rep={rep} T={T} "
        f"D={D} bf16, slot {slot} for every row: max|a-plain|="
        f"{max(errs):.3e} (atol/rtol 2e-2) at layers 0, 7, {L - 1}, "
        f"{'bit-identical to' if same else 'not bit-identical to'} K2's "
        f"attention, the written cache = K3's write bit for bit; "
        f"{B * Hkv} clusters of {resident} resident (one wave); kernel "
        f"{ms:.4f} ms, device {dev_ms:.4f} ms per layer from CUDA graphs "
        f"(K2 {k2_device_ms:.4f} ms: {dev_ms / k2_device_ms:.3f}x), bound "
        f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}) = "
        f"{bd['bound_ms'] / dev_ms:.1%} [{card}]")
    return dict(ms=ms, device_ms=dev_ms, k2_device_ms=k2_device_ms,
                x_k2_device=dev_ms / k2_device_ms, max_abs_err=max(errs),
                bit_identical_to_k2=same, resident_clusters=resident,
                clusters=B * Hkv, **bd)


# the legacy arc's shapes: protein bucket 512, 256 new tokens
LEGACY_PROTEIN, LEGACY_NEW = 512, 256


def legacy_prompt_len() -> int:
    """The derived collator's fixed prompt, [bos, sentence, bos]."""
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer
    from prot2text_tpu_torch.data.collate import DerivedCollator

    return len(DerivedCollator(tokenizer=ByteTextTokenizer(),
                               original_eos_token_id=128009).prompt_input_ids)


def check_tbkd_kernels(torch, dev, card):
    """K12 and K13 against their plain versions, bit for bit, on
    Llama-3.2-1B's lockstep cache (bf16 (16, T, 4, 8, 64), T = protein 512
    + prompt + 256 new tokens), at the first, a decode and the last slot;
    K13 also against two K12 launches; then at every word width
    (`check_slab_widths`) and ten chained K13 calls in one CUDA graph
    (`check_slab_chain`).  Times (`scripts/time_slab_write.py`): eager CUDA
    events, CUDA graphs of 10 calls, and behind a busy device graphs of 10
    and of 1 call, beside `copy_` into the slot's view (one a cache), and
    K13 HBM-cold where the bytes bound it, (16, 64, 256, 8, 64).  No model
    path launches either (`kernels.OFF_PATH`): these checks stand in.
    Then K4 at the tbkd strides on that cache (`check_k4_tbkd`), the launch
    that took K12's work."""
    from prot2text_tpu_torch.kernels.cache_update import (
        cache_slot_write, cache_slot_write_kv, cache_slot_write_kv_plain,
        cache_slot_write_plain,
    )
    from prot2text_tpu_torch.scripts import time_slab_write as tsw

    g = torch.Generator(device=dev).manual_seed(4321)
    L, B, Hkv, D = 16, 4, 8, 64
    T = LEGACY_PROTEIN + legacy_prompt_len() + LEGACY_NEW

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    ck, cv = randn(L, T, B, Hkv, D), randn(L, T, B, Hkv, D)
    nk, nv = randn(L, B, Hkv, D), randn(L, B, Hkv, D)
    idx = T - LEGACY_NEW // 2
    for index in (0, idx, T - 1):
        got = cache_slot_write(ck.clone(), nk, index)
        gk, gv = cache_slot_write_kv(ck.clone(), cv.clone(), nk, nv, index)
        two = (cache_slot_write(ck.clone(), nk, index),
               cache_slot_write(cv.clone(), nv, index))
        torch.cuda.synchronize()
        want = cache_slot_write_kv_plain(ck.clone(), cv.clone(), nk, nv,
                                         index)
        require(torch.equal(got, want[0]) and torch.equal(
            cache_slot_write_plain(ck.clone(), nk, index), want[0]),
            f"K12 is not bit-exact at slot {index}")
        require(torch.equal(gk, want[0]) and torch.equal(gv, want[1]),
                f"K13 is not bit-exact against its plain version at slot "
                f"{index}")
        require(torch.equal(gk, two[0]) and torch.equal(gv, two[1]),
                f"K13 differs from two K12 launches at slot {index}")
    del ck, cv, nk, nv, got, gk, gv, two, want
    check_slab_widths(torch, dev)
    check_slab_chain(torch, dev)
    times = {r["call"]: r for r in tsw.legacy_times(dev, (L, T, B, Hkv, D))}
    rows = {}
    for kid, lib, plain in (("K12", "copy_", "K12 plain"),
                            ("K13", "copy_ x2", "K13 plain")):
        k, lb, pl = times[kid], times[lib], times[plain]
        log(f"{kid} tbkd slot write L={L} T={T} B={B} Hkv={Hkv} D={D} "
            f"bf16{' (k and v)' if kid == 'K13' else ''}: bit-exact; kernel "
            f"{k['ms']:.4f} ms eager, device {k['graph_ms']:.4f} ms from "
            f"CUDA graphs, behind a busy device {k['busy_ms']:.4f} ms of 10, "
            f"{k['busy1_ms']:.4f} ms of 1; plain {pl['ms']:.4f} ms; {lib} "
            f"{lb['ms']:.4f} ms eager, {lb['graph_ms']:.4f} ms, "
            f"{lb['busy_ms']:.4f} / {lb['busy1_ms']:.4f} ms; bound "
            f"{k['bound_ms']:.5f} ms ({k['bound_by']}) [{card}]")
        rows[kid] = dict(
            max_abs_err=0.0, ms=k["ms"], device_ms=k["graph_ms"],
            plain_ms=pl["ms"], library_ms=lb["ms"],
            library_device_ms=lb["graph_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], checked=True, **dict(zip(BUSY_KEYS, (
                k["busy_ms"], k["busy1_ms"], lb["busy_ms"],
                lb["busy1_ms"]))))
    k13, two = times["K13"], times["copy_ x2"]
    log(f"K13 goals [{card}]: busy 10-call {k13['busy_ms']:.4f} ms <= "
        f"0.0020 and below two copy_s' {two['busy_ms']:.4f}: "
        + ("met" if k13["busy_ms"] <= 0.002 and k13["busy_ms"] < two[
            "busy_ms"] else "missed")
        + f"; eager {k13['ms']:.4f} ms vs two copy_s' {two['ms']:.4f}: "
        + ("at or below" if k13["ms"] <= two["ms"] else "above"))
    cold = {r["call"]: r for r in tsw.cold_times(dev, reps=10)}
    kc, lc = cold["K13"], cold["copy_ x2"]
    log(f"K13 at the bytes-bound shape {kc['shape']} bf16, HBM-cold over "
        f"{kc['calls']} slots and copies of the new rows: {kc['cold_ms']:.4f}"
        f" ms ({kc['bound_share']:.1%} of the {kc['bound_ms']:.4f} ms bytes "
        f"bound; goal >= 50% and no slower than two copy_s: "
        + ("met" if kc["bound_share"] >= 0.5 and kc["cold_ms"] <= lc[
            "cold_ms"] else "missed")
        + f"), two copy_s {lc['cold_ms']:.4f} ms ({lc['bound_share']:.1%}) "
        f"[{card}]")
    rows["K13"]["other_shapes"] = [dict(
        shape=kc["shape"], cold_ms=kc["cold_ms"],
        library_cold_ms=lc["cold_ms"], bound_ms=kc["bound_ms"],
        bound_share=kc["bound_share"],
        library_bound_share=lc["bound_share"])]
    rows["K4 tbkd"] = check_k4_tbkd(torch, dev, card, g, L, T, B, Hkv, D)
    rows.update(check_tbkd_rows(torch, dev, card, g, L, T, B, Hkv, D))
    return rows


def check_slab_widths(torch, dev):
    """K13 bit-exact against its plain version and two K12 launches where
    the widest word is W = 16, 8, 4, 2 or 1 bytes: set by the run (uint8
    caches, B 1, Hkv 3, D W: a run of 3·W bytes) or by the addresses
    (every operand W bytes into its allocation, a 48-byte run), at the
    first and last slot; a ragged bf16 run of 30 bytes too."""
    from prot2text_tpu_torch.kernels.cache_update import (
        cache_slot_write, cache_slot_write_kv, cache_slot_write_kv_plain,
    )

    g = torch.Generator(device=dev).manual_seed(4323)

    def flat(n, off, dtype):
        item = torch.empty((), dtype=dtype).element_size()
        raw = torch.randint(0, 256, (n * item + off + 16,), generator=g,
                            dtype=torch.uint8, device=dev)
        return raw[off:off + n * item].view(dtype)

    cases = [(w, by, torch.uint8, 1) for w in (16, 8, 4, 2, 1)
             for by in ("run", "address")]
    cases.append((2, "ragged", torch.bfloat16, 2))
    for w, by, dtype, item in cases:
        L, T, B, Hkv = 3, 10, (5 if by == "ragged" else 1), 3
        D = {"run": w, "address": 16, "ragged": 2}[by] // item
        off = w if by == "address" and w < 16 else 0
        ck, cv = (flat(L * T * B * Hkv * D, off, dtype).view(L, T, B, Hkv, D)
                  for _ in range(2))
        nk, nv = (flat(L * B * Hkv * D, off, dtype).view(L, B, Hkv, D)
                  for _ in range(2))
        for index in (0, T - 1):
            gk, gv = cache_slot_write_kv(ck.clone(), cv.clone(), nk, nv,
                                         index)
            two = (cache_slot_write(ck.clone(), nk, index),
                   cache_slot_write(cv.clone(), nv, index))
            want = cache_slot_write_kv_plain(ck.clone(), cv.clone(), nk, nv,
                                             index)
            require(all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                        for a, b in ((gk, want[0]), (gv, want[1]),
                                     (two[0], want[0]), (two[1], want[1]))),
                    f"K13/K12 not bit-exact at {w}-byte words set by the "
                    f"{by}, slot {index}")
    log(f"K13/K12 bit-exact at every word width (16, 8, 4, 2, 1 bytes, set "
        f"by the run and by the addresses) and on a ragged 30-byte run")


def check_slab_chain(torch, dev):
    """Ten K13 calls to ten slots, each with its own new rows, captured in
    one CUDA graph (chained launches): every slot holds its call's rows
    after a replay, and after a second replay over changed rows."""
    from prot2text_tpu_torch.kernels.cache_update import (
        cache_slot_write_kv, cache_slot_write_kv_plain,
    )

    g = torch.Generator(device=dev).manual_seed(4324)
    L, T, B, Hkv, D = 16, 40, 4, 8, 64

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    ck, cv = randn(L, T, B, Hkv, D), randn(L, T, B, Hkv, D)
    start = (ck.clone(), cv.clone())
    news = [(randn(L, B, Hkv, D), randn(L, B, Hkv, D)) for _ in range(10)]
    slots = [3 * i + 1 for i in range(10)]
    cache_slot_write_kv(ck, cv, *news[0], slots[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for (nk, nv), s in zip(news, slots):
            cache_slot_write_kv(ck, cv, nk, nv, s)
    for rnd in range(2):
        ck.copy_(start[0])
        cv.copy_(start[1])
        if rnd:
            for nk, nv in news:
                nk.neg_()
                nv.add_(1)
        graph.replay()
        torch.cuda.synchronize()
        wk, wv = start[0].clone(), start[1].clone()
        for (nk, nv), s in zip(news, slots):
            cache_slot_write_kv_plain(wk, wv, nk, nv, s)
        require(torch.equal(ck, wk) and torch.equal(cv, wv),
                f"ten chained K13 calls in one CUDA graph: a slot is wrong "
                f"(replay {rnd})")
    del graph
    log("K13: ten chained calls to ten slots in one CUDA graph, every slot "
        "bit-exact over two replays")


def check_k4_tbkd(torch, dev, card, g, L, T, B, Hkv, D, rep=4):
    """K4 as the tbkd lockstep step runs it, at Llama-3.2-1B's generation
    shape (L 16, T 842, B 4, Hkv 8, rep 4, D 64, bf16), one scalar slot
    broadcast to every row (a mid-decode column kv_mask leaves 0), at
    layers 0, 7 and L - 1: its output bit-identical to the bktd K4 on the
    same cache permuted to (L, B, Hkv, T, D), and within 2e-2 of the plain
    tbkd route (`_tbkd_decode_attention`) on the same bf16 operands; its
    written slot bit-exact against `cache_slot_write_plain` of those
    layers, every other cache byte unchanged, the bktd launch's written
    cache the same once permuted; the launch in one wave; its device time
    per layer from CUDA graphs beside the bktd launch's and the plain
    route's (one layer's attention and slot write)."""
    from prot2text_tpu_torch.kernels.cache_update import (
        cache_slot_write_plain,
    )
    from prot2text_tpu_torch.kernels.decode_attention import (
        decode_attention_stacked_write, decode_attention_stacked_write_plain,
        split_resident_clusters,
    )

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    ck, cv = randn(L, T, B, Hkv, D), randn(L, T, B, Hkv, D)
    qg = (randn(B, Hkv, rep, D).float() * D ** -0.5).to(torch.bfloat16)
    kn, vn = randn(B, Hkv, D), randn(B, Hkv, D)
    slot = T - LEGACY_NEW // 2
    pads = torch.tensor([0, 37, 100, 5], device=dev)[:B]
    cols = torch.arange(T, device=dev)
    kv_mask = ((cols >= pads[:, None]) & (cols < slot)).to(torch.int32)
    slots = torch.full((B,), slot, dtype=torch.int32, device=dev)
    tk, tv = ck.clone(), cv.clone()
    bk, bv = (c.permute(0, 2, 3, 1, 4).contiguous() for c in (ck, cv))
    pk_, pv_ = ck.clone(), cv.clone()       # the plain route's caches
    errs, layers = [], (0, 7, L - 1)
    for li in layers:
        a_t = decode_attention_stacked_write(qg, tk, tv, kv_mask, kn, vn, li,
                                             slots, layout="tbkd")
        a_b = decode_attention_stacked_write(qg, bk, bv, kv_mask, kn, vn, li,
                                             slots)
        ref = decode_attention_stacked_write_plain(
            qg, pk_, pv_, kv_mask, kn, vn, li, slots, layout="tbkd")
        torch.cuda.synchronize()
        require(torch.equal(a_t, a_b), f"the tbkd K4 at layer {li} is not "
                f"bit-identical to the bktd K4 on the permuted cache")
        torch.testing.assert_close(a_t.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
        errs.append((a_t.float() - ref.float()).abs().max().item())
    want_k, want_v = ck.clone(), cv.clone()
    for li in layers:
        cache_slot_write_plain(want_k[li:li + 1], kn[None], slot)
        cache_slot_write_plain(want_v[li:li + 1], vn[None], slot)
    at = list(layers)
    require(torch.equal(tk[at, slot], want_k[at, slot])
            and torch.equal(tv[at, slot], want_v[at, slot]),
            "the tbkd K4's written slot is not cache_slot_write_plain's")
    require(torch.equal(tk, want_k) and torch.equal(tv, want_v),
            "the tbkd K4 changed a cache byte outside its slot")
    require(torch.equal(bk, tk.permute(0, 2, 3, 1, 4))
            and torch.equal(bv, tv.permute(0, 2, 3, 1, 4)),
            "the bktd K4's written cache differs from the tbkd one permuted")
    require(torch.equal(pk_, tk) and torch.equal(pv_, tv),
            "the plain tbkd route's written cache differs from the kernel's")
    resident = split_resident_clusters(False, rep, D, prefix=False)
    require(B * Hkv <= resident, f"the tbkd K4: {B * Hkv} clusters, "
            f"{resident} resident: a second wave")

    def k4_t():
        return decode_attention_stacked_write(qg, tk, tv, kv_mask, kn, vn, 7,
                                              slots, layout="tbkd")

    def k4_b():
        return decode_attention_stacked_write(qg, bk, bv, kv_mask, kn, vn, 7,
                                              slots)

    def plain():
        return decode_attention_stacked_write_plain(
            qg, pk_, pv_, kv_mask, kn, vn, 7, slots, layout="tbkd")

    ms = cuda_ms(torch, k4_t, iters=50)
    plain_ms = cuda_ms(torch, plain, iters=20)
    dev_ms, b_dev_ms = graph_ms(torch, k4_t), graph_ms(torch, k4_b)
    plain_dev_ms = graph_ms(torch, plain)
    bd = decode_bound(torch, kv_mask, None, Hkv, rep, D, 2, 0,
                      2 * nbytes(qg) + nbytes(kn, vn, kv_mask, slots)
                      + nbytes(kn, vn))
    log(f"K4 tbkd at the legacy lockstep shape L={L} T={T} B={B} Hkv={Hkv} "
        f"rep={rep} D={D} bf16, slot {slot} for every row: bit-identical to "
        f"the bktd K4 on the permuted cache at layers {layers}, max|a - plain "
        f"tbkd route|={max(errs):.3e} (atol/rtol 2e-2), the written slot = "
        f"cache_slot_write_plain bit for bit, no other byte moved; "
        f"{B * Hkv} clusters of {resident} resident (one wave); kernel "
        f"{ms:.4f} ms, device {dev_ms:.4f} ms per layer from CUDA graphs "
        f"(bktd K4 {b_dev_ms:.4f} ms: {dev_ms / b_dev_ms:.3f}x; plain tbkd "
        f"route {plain_dev_ms:.4f} ms, eager {plain_ms:.4f} ms), bound "
        f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}) = "
        f"{bd['bound_ms'] / dev_ms:.1%} [{card}]")
    return dict(ms=ms, device_ms=dev_ms, bktd_device_ms=b_dev_ms,
                x_bktd_device=dev_ms / b_dev_ms, plain_ms=plain_ms,
                plain_device_ms=plain_dev_ms, max_abs_err=max(errs),
                resident_clusters=resident, clusters=B * Hkv, **bd)


TBKD_PREFIX = 256           # the tbkd K9a's prefix columns (serving's Pc)


def check_tbkd_rows(torch, dev, card, g, L, T, B, Hkv, D, rep=4,
                    Pc=TBKD_PREFIX):
    """K4 with per-row (B,) slots and K9a with the sequence-leading prefix
    (L, Pc, 1, Hkv, D) on the tbkd cache at Llama-3.2-1B's generation shape
    (L 16, T 842, B 4, Hkv 8, rep 4, D 64, bf16; Pc 256), as the tbkd
    decode step runs them (no CLI does: the serving pool is bktd): slots
    distinct per row, one row with no written column, the prefix gated per
    row.  At layers 0, 7 and L - 1 each output is bit-identical to the
    bktd launch on the cache (and prefix) permuted to (L, B, Hkv, T, D)
    ((L, 1, Hkv, Pc, D)) and within 2e-2 of the plain tbkd route; the
    written slots are bit-exact, every other cache byte unchanged, the
    bktd launch's written cache the same once permuted.  Device time per
    layer from CUDA graphs beside the bktd launch's and the plain route's,
    with the bound."""
    from prot2text_tpu_torch.kernels.decode_attention import (
        decode_attention_stacked_write, decode_attention_stacked_write_plain,
        decode_attention_stacked_write_prefix,
        decode_attention_stacked_write_prefix_plain,
    )

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    def bktd(t):
        return t.permute(0, 2, 3, 1, 4).contiguous()

    ck, cv = randn(L, T, B, Hkv, D), randn(L, T, B, Hkv, D)
    pk, pv = randn(L, Pc, 1, Hkv, D), randn(L, Pc, 1, Hkv, D)
    bpk, bpv = bktd(pk), bktd(pv)
    qg = (randn(B, Hkv, rep, D).float() * D ** -0.5).to(torch.bfloat16)
    kn, vn = randn(B, Hkv, D), randn(B, Hkv, D)
    pads = torch.tensor([0, 37, 100, 5], device=dev)[:B]
    slots = torch.tensor([T - 142, 37, T - 41, T - 1], dtype=torch.int32,
                         device=dev)[:B]           # row 1: nothing written
    cols = torch.arange(T, device=dev)
    kv_mask = ((cols >= pads[:, None]) & (cols < slots[:, None])).to(
        torch.int32)
    pmask = torch.ones((B, Pc), dtype=torch.int32, device=dev)
    pmask[2, :100] = 0
    pmask[3] = 0
    rows_ = torch.arange(B, device=dev)
    out = {}
    for kid, wrapper, plain, pre in (
            ("K4 tbkd rows", decode_attention_stacked_write,
             decode_attention_stacked_write_plain, ()),
            ("K9a tbkd", decode_attention_stacked_write_prefix,
             decode_attention_stacked_write_prefix_plain, (pk, pv, pmask))):
        bpre = (bpk, bpv, pmask) if pre else ()
        tk, tv = ck.clone(), cv.clone()
        bk, bv = bktd(ck), bktd(cv)
        rk, rv = ck.clone(), cv.clone()       # the plain route's caches
        errs, layers = [], (0, 7, L - 1)
        for li in layers:
            n = wrapper.launches
            a_t = wrapper(qg, tk, tv, kv_mask, kn, vn, li, slots, *pre,
                          layout="tbkd")
            a_b = wrapper(qg, bk, bv, kv_mask, kn, vn, li, slots, *bpre)
            ref = plain(qg, rk, rv, kv_mask, kn, vn, li, slots, *pre,
                        layout="tbkd")
            torch.cuda.synchronize()
            require(wrapper.launches == n + 2, f"{kid}: one launch a call")
            require(torch.equal(a_t, a_b), f"{kid} at layer {li} is not "
                    f"bit-identical to the bktd launch on the permuted "
                    f"cache{' and prefix' if pre else ''}")
            torch.testing.assert_close(a_t.float(), ref.float(), atol=2e-2,
                                       rtol=2e-2)
            errs.append((a_t.float() - ref.float()).abs().max().item())
        want_k, want_v = ck.clone(), cv.clone()
        for li in layers:
            want_k[li, slots.long(), rows_] = kn
            want_v[li, slots.long(), rows_] = vn
        require(torch.equal(tk, want_k) and torch.equal(tv, want_v),
                f"{kid}: the written slots are not bit-exact, or another "
                f"cache byte moved")
        require(torch.equal(bk, tk.permute(0, 2, 3, 1, 4))
                and torch.equal(bv, tv.permute(0, 2, 3, 1, 4)),
                f"{kid}: the bktd launch's written cache differs from the "
                f"tbkd one permuted")
        require(torch.equal(rk, tk) and torch.equal(rv, tv),
                f"{kid}: the plain tbkd route's written cache differs")
        del want_k, want_v

        def k_t():
            return wrapper(qg, tk, tv, kv_mask, kn, vn, 7, slots, *pre,
                           layout="tbkd")

        def k_b():
            return wrapper(qg, bk, bv, kv_mask, kn, vn, 7, slots, *bpre)

        def route():
            return plain(qg, rk, rv, kv_mask, kn, vn, 7, slots, *pre,
                         layout="tbkd")

        ms = cuda_ms(torch, k_t, iters=50)
        plain_ms = cuda_ms(torch, route, iters=20)
        dev_ms, b_dev_ms = graph_ms(torch, k_t), graph_ms(torch, k_b)
        plain_dev_ms = graph_ms(torch, route)
        bd = decode_bound(torch, kv_mask, pmask if pre else None, Hkv, rep,
                          D, 2, 0, 2 * nbytes(qg) + 2 * nbytes(kn, vn)
                          + nbytes(kv_mask, slots)
                          + (nbytes(pmask) if pre else 0))
        what = f", prefix Pc={Pc} (L, Pc, 1, Hkv, D)" if pre else ""
        log(f"{kid} at the legacy shape L={L} T={T} B={B} Hkv={Hkv} "
            f"rep={rep} D={D} bf16{what}, per-row slots {slots.tolist()}: "
            f"bit-identical to the bktd launch on the permuted operands at "
            f"layers {layers}, "
            f"max|a - plain tbkd route|={max(errs):.3e} (atol/rtol 2e-2), "
            f"the slots bit-exact, no other byte moved; kernel {ms:.4f} ms, "
            f"device {dev_ms:.4f} ms per layer from CUDA graphs (bktd "
            f"{b_dev_ms:.4f} ms: {dev_ms / b_dev_ms:.3f}x; plain tbkd route "
            f"{plain_dev_ms:.4f} ms, eager {plain_ms:.4f} ms), bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}) = "
            f"{bd['bound_ms'] / dev_ms:.1%} [{card}]")
        out[kid] = dict(ms=ms, device_ms=dev_ms, bktd_device_ms=b_dev_ms,
                        x_bktd_device=dev_ms / b_dev_ms, plain_ms=plain_ms,
                        plain_device_ms=plain_dev_ms, max_abs_err=max(errs),
                        **bd)
        del tk, tv, bk, bv, rk, rv
    return out


def check_serve_kernels(torch, dev, card):
    """K4, K9a and K6 against their plain versions at the serving shapes
    of Qwen3-14B (B 8, Hkv 8, rep 5, D 128; the pool's T for the CLI's
    default 256 new tokens; the byte tokenizer's 250-token shared prefix
    padded to Pc 256, and Pc 128), bf16: attention atol/rtol 2e-2, written
    caches bit-exact.  K4 and K9a are timed on int32 slots, the one tensor
    the decode step builds a step, with the eager time on the serving
    engine's int64 `write_idx` (converted by the wrapper a call) beside;
    K4's eager gate reads the int32 call."""
    from prot2text_tpu_torch.kernels.decode_attention import (
        decode_attention_stacked_write, decode_attention_stacked_write_plain,
        decode_attention_stacked_write_prefix,
        decode_attention_stacked_write_prefix_plain,
    )
    from prot2text_tpu_torch.kernels.flash_attention import (
        flash_attention_bias_fwd, flash_attention_bias_plain,
    )

    g = torch.Generator(device=dev).manual_seed(4321)
    bf16 = torch.bfloat16
    rows = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf16)

    L, B, Hkv, rep, T, D = 40, 8, 8, 5, 1936, 128
    ck, cv = randn(L, B, Hkv, T, D), randn(L, B, Hkv, T, D)
    qg = randn(B, Hkv, rep, D, scale=D ** -0.5)
    kn, vn = randn(B, Hkv, D), randn(B, Hkv, D)
    # left-padded 512-wide suffix windows plus decoded columns; rows 6 and
    # 7 are inactive and both write the scratch column T - 1
    pads = torch.tensor([0, 37, 100, 250, 5, 0, 60, 200], device=dev)
    ends = torch.tensor([612, 540, 700, 513, 640, 800, 530, 600],
                        device=dev)
    cols = torch.arange(T, device=dev)
    kv_mask = ((cols >= pads[:, None]) & (cols < ends[:, None])).to(
        torch.int32)
    # the decode step's one int32 tensor a step; the serving engine's
    # write_idx is int64, which each wrapper converted a layer before
    slots64 = ends.clone()
    slots64[6:] = T - 1
    kv_mask[torch.arange(B, device=dev), slots64] = 0
    slots = slots64.to(torch.int32)

    def k4(ck_, cv_, li, slots_=slots):
        return decode_attention_stacked_write(qg, ck_, cv_, kv_mask, kn, vn,
                                              li, slots_)

    def k4_plain(ck_, cv_, li):
        return decode_attention_stacked_write_plain(
            qg.float(), ck_, cv_, kv_mask, kn.float(), vn.float(), li, slots)

    def check_write(name, kern, plain, plain_bf16, wrapper):
        """The worst max|kernel - plain|, that over max|plain|, the
        kernel's eager time on int32 slots (the decode step's) and on the
        int64 ones (converted by the wrapper), and the plain version's."""
        errs, top = [], 0.0
        for li in (0, 23, L - 1):
            gk, gv = ck.clone(), cv.clone()
            n = wrapper.launches
            a = kern(gk, gv, li)
            torch.cuda.synchronize()
            require(wrapper.launches == n + 1, f"{name}: one launch a call")
            wk, wv = ck.clone(), cv.clone()
            want = plain(wk, wv, li)
            torch.testing.assert_close(a.float(), want, atol=2e-2, rtol=2e-2)
            require(torch.equal(gk, wk) and torch.equal(gv, wv),
                    f"{name}: the written cache is not bit-exact")
            errs.append((a.float() - want).abs().max().item())
            top = max(top, want.abs().max().item())
            del gk, gv, wk, wv
        ms = cuda_ms(torch, lambda: kern(ck, cv, 23), iters=50)
        ms64 = cuda_ms(torch, lambda: kern(ck, cv, 23, slots64), iters=50)
        plain_ms = cuda_ms(torch, lambda: plain_bf16(ck, cv, 23), iters=20)
        return max(errs), max(errs) / top, ms, ms64, plain_ms

    err, rel, ms, ms64, plain_ms = check_write(
        "K4", k4, k4_plain,
        lambda ck_, cv_, li: decode_attention_stacked_write_plain(
            qg, ck_, cv_, kv_mask, kn, vn, li, slots),
        decode_attention_stacked_write)
    # q, the output, the new k/v (read, then written at the slots), mask
    fixed = 2 * nbytes(qg) + 2 * nbytes(kn, vn) + nbytes(kv_mask, slots)
    lib = decode_library_call(torch, qg, ck, cv, kv_mask, kn, vn, 23)
    lib_ms = cuda_ms(torch, lib)
    bd = decode_bound(torch, kv_mask, None, Hkv, rep, D, 2, 0, fixed)
    sp = speed(torch, lambda: k4(ck, cv, 23), lib, ms, lib_ms, bd)
    log(f"K4 decode attention + slot write L={L} B={B} Hkv={Hkv} rep={rep} "
        f"T={T} D={D} bf16 (slots distinct, two rows on the scratch "
        f"column): max|a-plain|={err:.3e} (atol/rtol 2e-2; {rel:.2e} of "
        f"max|plain|), caches bit-exact, one launch a call; kernel "
        f"{ms:.4f} ms on int32 slots (int64, converted by the wrapper: "
        f"{ms64:.4f} ms), plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
        f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}) per layer; "
        f"{speed_text(sp)} [{card}]")
    require(ms <= 0.123, f"K4 eager {ms:.4f} ms > 0.123 (half the SIMT "
            f"body's)")
    rows["K4"] = dict(max_abs_err=err, ms=ms, ms_int64_slots=ms64,
                      plain_ms=plain_ms, library_ms=lib_ms, **bd, **sp)

    for Pc in (128, 256):
        pk, pv = randn(L, 1, Hkv, Pc, D), randn(L, 1, Hkv, Pc, D)
        pmask = (torch.arange(Pc, device=dev) >= Pc - min(Pc, 250)).to(
            torch.int32).expand(B, Pc).clone()
        pmask[6] = 0                      # a full-prompt row in the pool

        def k9(ck_, cv_, li, slots_=slots):
            return decode_attention_stacked_write_prefix(
                qg, ck_, cv_, kv_mask, kn, vn, li, slots_, pk, pv, pmask)

        def k9_plain(ck_, cv_, li):
            return decode_attention_stacked_write_prefix_plain(
                qg.float(), ck_, cv_, kv_mask, kn.float(), vn.float(), li,
                slots, pk.float(), pv.float(), pmask)

        err, rel, ms, ms64, plain_ms = check_write(
            "K9a", k9, k9_plain,
            lambda ck_, cv_, li: decode_attention_stacked_write_prefix_plain(
                qg, ck_, cv_, kv_mask, kn, vn, li, slots, pk, pv, pmask),
            decode_attention_stacked_write_prefix)
        lib = decode_library_call(torch, qg, ck, cv, kv_mask, kn, vn, 23,
                                  pk, pv, pmask)
        lib_ms = cuda_ms(torch, lib)
        bd = decode_bound(torch, kv_mask, pmask, Hkv, rep, D, 2, 0,
                          fixed + nbytes(pmask))
        sp = speed(torch, lambda: k9(ck, cv, 23), lib, ms, lib_ms, bd)
        log(f"K9a decode attention + slot write + shared prefix Pc={Pc} "
            f"(row 6 gated off) L={L} B={B} T={T} bf16: "
            f"max|a-plain|={err:.3e} (atol/rtol 2e-2; {rel:.2e} of "
            f"max|plain|), caches bit-exact, one launch a call; "
            f"kernel {ms:.4f} ms on int32 slots (int64: {ms64:.4f} ms), "
            f"plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}) per layer; "
            f"{speed_text(sp)} [{card}]")
        require(ms <= 0.18, f"K9a eager {ms:.4f} ms > 0.18 (half the SIMT "
                f"body's)")
        # the row keeps the worst error and the serving shape's times
        worst = max(err, rows.get("K9a", {}).get("max_abs_err", 0.0))
        rows["K9a"] = dict(max_abs_err=worst, ms=ms, ms_int64_slots=ms64,
                           plain_ms=plain_ms, library_ms=lib_ms, **bd, **sp)
    del ck, cv

    # K6: the prefix install's attention, R 8 rows, Sq 512 suffix columns
    # after the Pc 256 seeded prefix, left-padded rows
    R, H, Hkv, Sq, Pc, Ps = 8, 40, 8, 512, 256, 250
    q = randn(R, Sq, H, D, scale=D ** -0.5).transpose(1, 2)
    k, v = randn(R, Hkv, Pc + Sq, D), randn(R, Hkv, Pc + Sq, D)
    idx = torch.arange(Sq, device=dev)
    pads = torch.tensor([0, 37, 100, 250, 5, 0, 60, 200], device=dev)
    ok = ((idx[None, :] <= idx[:, None])[None, None]
          & (idx >= pads[:, None])[:, None, None, :])
    okp = (torch.arange(Pc, device=dev) >= Pc - Ps).expand(R, 1, Sq, Pc)
    bias = torch.where(torch.cat([okp, ok], dim=-1), 0.0,
                       torch.finfo(torch.float32).min)
    o, lse = flash_attention_bias_fwd(q, k, v, bias)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_attention_bias_plain(q.float(), k.float(),
                                                v.float(), bias)
    err = (o.float() - o_ref).abs().max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    torch.testing.assert_close(o.float(), o_ref, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0.0)
    # rows whose bias is finfo(f32).min everywhere (a whole q tile of row 7,
    # one row of row 3): o = 0 and lse = -1e30 exactly, as the plain
    # version and the TPU kernel give
    dead = bias.clone()
    dead[7, :, :64] = torch.finfo(torch.float32).min
    dead[3, :, 100] = torch.finfo(torch.float32).min
    o_d, lse_d = flash_attention_bias_fwd(q, k, v, dead)
    torch.cuda.synchronize()
    empty_lse = torch.tensor(-1e30, dtype=torch.float32).item()
    require(o_d[7, :, :64].abs().max().item() == 0.0
            and o_d[3, :, 100].abs().max().item() == 0.0,
            "K6: fully masked rows must give o = 0")
    require(bool((lse_d[7, :, :64] == empty_lse).all())
            and bool((lse_d[3, :, 100] == empty_lse).all()),
            "K6: fully masked rows must give lse = -1e30")
    del dead, o_d, lse_d

    def k6():
        return flash_attention_bias_fwd(q, k, v, bias)

    ms = cuda_ms(torch, k6)
    plain_ms = cuda_ms(torch, lambda: flash_attention_bias_plain(q, k, v,
                                                                 bias))
    # SDPA takes a float mask in the query's dtype: cast before timing
    lib = sdpa_call(torch, q, k, v, bias.to(q.dtype))
    lib_ms = cuda_ms(torch, lib)
    pairs = int((bias > -1e30).sum()) * H            # unmasked (q, k) pairs
    bd = bound(4.0 * D * pairs, nbytes(q, k, v, bias, o, lse))
    sp = speed(torch, k6, lib, ms, lib_ms, bd)
    log(f"K6 bias flash prefill R={R} H={H} Hkv={Hkv} Sq={Sq} Skv={Pc + Sq} "
        f"D={D} bf16, bias (R,1,Sq,Skv), left-padded rows (fully masked "
        f"rows: o = 0, lse = -1e30 exactly): "
        f"max|o-plain|={err:.3e} (atol/rtol 2e-2) max|lse-plain|="
        f"{err_lse:.3e} (atol 1e-3); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, SDPA (additive bias) {lib_ms:.4f} ms, bound "
        f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}) per layer; "
        f"{speed_text(sp)} [{card}]")
    rows["K6"] = dict(max_abs_err=err, lse_max_abs_err=err_lse, ms=ms,
                      plain_ms=plain_ms, library_ms=lib_ms, **bd, **sp)
    return rows


def check_bias_bwd_kernel(torch, dev, card):
    """K6 forward and K6b against their plain versions at ESMC-600M's
    training shapes, bf16, q/k/v/dO laid out as ESMC hands them over
    (transposes of (B, S, H, D) buffers), H 18, D 64, a (B, 1, 1, S)
    key-padding bias of ragged valid runs.  K6's o and lse at B 1 with S
    512 (the width of phase 4's proteins) and S 1024 (the largest protein
    bucket), and at the contrastive batch B 8, S 512 with a run per row,
    at the gates of the serving check (o atol/rtol 2e-2, lse atol 1e-3),
    each timed beside SDPA on the same operands.  K6b from K6's o and lse
    at the two B 1 shapes: two launches bit-identical, per gradient
    max|kernel - plain| <= 2e-2 * max|plain|, timed at both: eager, device
    time from CUDA graphs, SDPA backward's device time from the profiler;
    the row holds S 512, its `other_shapes` S 1024.  Returns the K6b row, K6's worst
    max|o - plain| here and K6's timings at these shapes."""
    from prot2text_tpu_torch.kernels.flash_attention import (
        flash_attention_bias_bwd, flash_attention_bias_bwd_plain,
        flash_attention_bias_fwd, flash_attention_bias_plain,
    )

    g = torch.Generator(device=dev).manual_seed(6161)
    bf16 = torch.bfloat16
    H, D = 18, 64
    errs, row, fwd_errs, fwd_times = [], None, [], []

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf16)

    def bshd(B, S, scale=1.0):
        return randn(B, S, H, D, scale=scale).transpose(1, 2)

    def key_padding(S, valid):
        keep = torch.arange(S, device=dev) < valid[:, None]
        return torch.where(keep, 0.0, torch.finfo(torch.float32).min).view(
            len(valid), 1, 1, S)

    def check_fwd(q, k, v, bias, what):
        o, lse = flash_attention_bias_fwd(q, k, v, bias)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_attention_bias_plain(q.float(), k.float(),
                                                    v.float(), bias)
        err = (o.float() - o_ref).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        torch.testing.assert_close(o.float(), o_ref, atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0.0)
        fwd_errs.append(err)
        def k6():
            return flash_attention_bias_fwd(q, k, v, bias)

        ms = cuda_ms(torch, k6)
        lib = sdpa_call(torch, q, k, v, bias.to(bf16))
        lib_ms = cuda_ms(torch, lib)
        # unmasked pairs: valid keys of each batch row x Sq query rows x H
        pairs = int((bias > -1e30).sum()) * q.shape[2] * H
        bd = bound(4.0 * D * pairs, nbytes(q, k, v, bias, o, lse))
        sp = speed(torch, k6, lib, ms, lib_ms, bd)
        fwd_times.append(dict(shape=what, ms=ms, library_ms=lib_ms,
                              bound_ms=bd["bound_ms"],
                              bound_by=bd["bound_by"], **sp))
        log(f"K6 bias flash forward {what} H={H} D={D} bf16, key-padding "
            f"bias (B,1,1,S): max|o-plain|={err:.3e} (atol/rtol 2e-2) "
            f"max|lse-plain|={err_lse:.3e} (atol 1e-3); kernel {ms:.4f} ms, "
            f"SDPA (additive bias) {lib_ms:.4f} ms, bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}); {speed_text(sp)} "
            f"[{card}]")
        return o, lse

    # the contrastive batch: 8 rows of ragged protein lengths in bucket 512
    valid = torch.tensor([443, 380, 451, 512, 397, 129, 65, 1], device=dev)
    q, k, v = bshd(8, 512, D ** -0.5), bshd(8, 512), bshd(8, 512)
    check_fwd(q, k, v, key_padding(512, valid),
              f"B=8 S=512 (valid keys {valid.tolist()})")
    del q, k, v

    for S, n_valid in ((1024, 1024 - 187), (512, 443)):
        B = 1
        q, k, v = bshd(B, S, D ** -0.5), bshd(B, S), bshd(B, S)
        do = bshd(B, S, D ** -0.5)
        bias = key_padding(S, torch.tensor([n_valid], device=dev))
        o, lse = check_fwd(q, k, v, bias,
                           f"B={B} S={S} ({n_valid} valid keys)")

        def k6b():
            return flash_attention_bias_bwd(q, k, v, bias, o, lse, do)

        got, again = k6b(), k6b()
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"K6b at S={S}: two launches differ")
        want = flash_attention_bias_bwd_plain(
            q.float(), k.float(), v.float(), bias, o.float(), lse, do.float())
        parts = []
        for name, gr, w in zip(("dq", "dk", "dv"), got, want):
            err, top = (gr.float() - w).abs().max().item(), w.abs().max().item()
            require(err <= 2e-2 * top, f"K6b {name} at S={S}: max|err| {err} "
                    f"> 2e-2 * max|plain| {top}")
            errs.append(err)
            parts.append(f"{name} {err:.3e} ({err / top:.2e} of max|plain|)")
        ms = cuda_ms(torch, k6b)
        # the library's backward of the same SDPA call (float mask in the
        # query's dtype; its forward, which keeps the graph, runs outside
        # the timed region); no CUDA graph holds torch.autograd.grad, so its
        # device time is the profiler's sum of its kernels, K6b's beside it
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qr, kr, vr, attn_mask=bias.to(bf16), scale=1.0)

        def lib():
            return torch.autograd.grad(out, (qr, kr, vr), do,
                                       retain_graph=True)

        lib_ms = cuda_ms(torch, lib)
        lib_dev = profiled_ms(torch, lib)
        k6b_prof = profiled_ms(torch, k6b)
        del qr, kr, vr, out
        # recomputed q·kᵀ, dO·vᵀ, Pᵀ·dO, dS·k and dSᵀ·q: 10·D per (query,
        # key) pair; this data needs the unmasked pairs only
        full = 10.0 * D * B * H * S * S
        bd = bound(10.0 * D * B * H * S * n_valid,
                   nbytes(q, k, v, o, lse, do, bias, *got))
        sp = speed(torch, k6b, None, ms, lib_ms, bd, lib_dev_ms=lib_dev)
        sp["device_ms_profiler"] = k6b_prof
        sp["library_device_source"] = (
            PROFILED_SOURCE if lib_dev is not None else UNPROFILED_SOURCE)
        msg = (f"K6b bias flash backward B={B} H={H} S={S} D={D} bf16, "
               f"key-padding bias (1,1,1,S) over {n_valid} valid keys: two "
               f"launches bit-identical; max|kernel-plain| " +
               ", ".join(parts) + f"; kernel {ms:.4f} ms, SDPA backward "
               f"{lib_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms "
               f"({bd['bound_by']}; all S² pairs "
               f"{full / PEAK_FLOPS * 1e3:.4f} ms); {speed_text(sp)} (SDPA's "
               f"device time and K6b's {ms_text(k6b_prof)} from the "
               f"profiler)")
        shape = dict(shape=f"B={B} H={H} S={S} D={D}", ms=ms,
                     library_ms=lib_ms, bound_ms=bd["bound_ms"],
                     bound_by=bd["bound_by"], **sp)
        if S == 512:
            plain_ms = cuda_ms(torch, lambda: flash_attention_bias_bwd_plain(
                q, k, v, bias, o, lse, do))
            msg += f", plain {plain_ms:.4f} ms"
            require(ms <= 0.2801, f"K6b eager {ms:.4f} ms > 0.2801 (a half "
                    f"of the SIMT body's)")
            row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bd,
                       **sp)
        else:
            other = shape
        log(msg + f" [{card}]")
        del q, k, v, do, o, lse, got, again, want
    row["other_shapes"] = [other]
    return ({"K6b": dict(max_abs_err=max(errs), **row)}, max(fwd_errs),
            fwd_times)


# bf16 K7/K8's eager times on the SIMT body they left (an H100 80GB HBM3
# at 700 W, PERF.md §6): the split body must take at most half
INT8_SIMT_EAGER_MS = {"K7": 0.2456, "K8": 0.2647}
# the kernel-name pattern of each int8 kernel's split route
INT8_SPLIT_NAMES = {"K7": r"decode_split_kernel.*CacheCols.*Int8Cache",
                    "K8": r"decode_split_kernel.*CacheCols.*Int8Cache",
                    "K9b": r"decode_split_kernel.*PrefixCols.*Int8Cache",
                    "K9c": r"decode_split_kernel.*PrefixCols.*Int8Cache"}


def device_kernel_names(torch, fn) -> list | None:
    """The device kernels one fn() launches, by name, from `torch.profiler`
    (a session that records none is run again, up to three; then None)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    return None


def int8_case(torch, dev, g, B, Hkv, rep, G, D):
    """bf16 qg (B, Hkv, G·rep, D) pre-scaled and the current tokens'
    quantized k/v from `quantize_kv` ((B, Hkv, D) and (B, Hkv) for G 1)."""
    from prot2text_tpu_torch.models.quant import quantize_kv

    qg = (torch.randn(B, Hkv, G * rep, D, generator=g, device=dev)
          * D ** -0.5).to(torch.bfloat16)
    kq, ks = quantize_kv(torch.randn(B, Hkv, G, D, generator=g, device=dev))
    vq, vs = quantize_kv(torch.randn(B, Hkv, G, D, generator=g, device=dev))
    new = [kq, vq, ks, vs]
    if G == 1:
        new = [x[:, :, 0].contiguous() for x in new]
    return qg, new


def check_int8_case(torch, name, kern, plain, qg, cache, kv_mask, new,
                    slots, pargs, layers) -> float:
    """kern against plain on the same values (plain in fp32) at each of
    `layers`: two launches bit-identical, the attention within atol/rtol
    2e-2, the written int8 caches and scales bit-exact.  Returns the
    largest |kernel - plain|."""
    errs = []
    for li in layers:
        gcache = [t.clone() for t in cache]
        a = kern(qg, *gcache, kv_mask, *new, li, slots, *pargs)
        again = [t.clone() for t in cache]
        a2 = kern(qg, *again, kv_mask, *new, li, slots, *pargs)
        torch.cuda.synchronize()
        require(torch.equal(a, a2) and all(
            torch.equal(x, y) for x, y in zip(gcache, again)),
            f"{name}: two launches differ")
        del again, a2
        wcache = [t.clone() for t in cache]
        want = plain(qg.float(), *wcache, kv_mask, *new, li, slots, *pargs)
        require(bool(torch.isfinite(a).all()), f"{name}: non-finite")
        torch.testing.assert_close(a.float(), want, atol=2e-2, rtol=2e-2)
        require(all(torch.equal(x, y) for x, y in zip(gcache, wcache)),
                f"{name}: the written int8 cache or scales differ")
        errs.append((a.float() - want).abs().max().item())
        del gcache, wcache
    return max(errs)


def check_int8_kernels(torch, dev, card, gates: bool = True):
    """K7, K9b, K8 and K9c against their plain versions at the int8
    serving shapes of Qwen3-14B: B 8, Hkv 8, rep 5, D 128, T 1856 (the
    int8 pool under speculation with 128 new tokens), 535 valid columns per
    row, distinct slots and two inactive rows on one scratch slot (T - 1
    for decode, T - 64 for verify, the engine's rules), Pc 256 with 250
    real tokens and row 6 gated off, G 5 (γ 4); then K7 at Llama-3.1-8B's
    lockstep shape (`generate_instruct.py --kv_bits 8`: L 32, B 4, Hkv 8,
    rep 4, T 1280, left-padded rows, one scalar slot for every row).  bf16
    qg against the plain version on the same values in fp32: attention
    atol/rtol 2e-2; the int8 caches and scales bit-exact after the write;
    two launches bit-identical.  Times: eager CUDA events and the device
    time from CUDA graphs (`graph_ms`) beside the bound and the plain
    version.  With `gates`, each call's route (the profiler's kernel names
    against `INT8_SPLIT_NAMES`) and K7/K8's eager times against
    `INT8_SIMT_EAGER_MS` must hold; without, the same checks and times
    with the routes only printed (another tree's package, for an A/B)."""
    from prot2text_tpu_torch.kernels import decode_attention as da

    g = torch.Generator(device=dev).manual_seed(8765)
    L, B, Hkv, rep, T, D, Pc, Ps = 40, 8, 8, 5, 1856, 128, 256, 250
    rows = {}

    def ints(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def scales(*shape):
        return torch.rand(shape, generator=g, device=dev) * 0.028 + 0.002

    cache = [ints(L, B, Hkv, T, D), ints(L, B, Hkv, T, D),
             scales(L, B, Hkv, T), scales(L, B, Hkv, T)]
    prefix = [ints(L, 1, Hkv, Pc, D), ints(L, 1, Hkv, Pc, D),
              scales(L, 1, Hkv, Pc), scales(L, 1, Hkv, Pc)]
    pmask = (torch.arange(Pc, device=dev) >= Pc - Ps).to(
        torch.int32).expand(B, Pc).clone()
    pmask[6] = 0                          # a full-prompt row in the pool
    pads = torch.tensor([0, 37, 100, 250, 5, 0, 60, 200], device=dev)
    ends = pads + 535
    cols = torch.arange(T, device=dev)
    kv_mask = ((cols >= pads[:, None]) & (cols < ends[:, None])).to(
        torch.int32)
    cases = (("K7", da.decode_attention_stacked_write_q,
              da.decode_attention_stacked_write_q_plain, 1, False),
             ("K9b", da.decode_attention_stacked_write_q_prefix,
              da.decode_attention_stacked_write_q_prefix_plain, 1, True),
             ("K8", da.decode_attention_stacked_verify_qc,
              da.decode_attention_stacked_verify_qc_plain, 5, False),
             ("K9c", da.decode_attention_stacked_verify_qc_prefix,
              da.decode_attention_stacked_verify_qc_prefix_plain, 5, True))

    def route_of(name, fn, dtype, nrows, with_prefix):
        """The body the call ran, by the profiler's kernel names: "split",
        "SIMT" or, where the profiler recorded nothing, the rule's answer
        (`int8_split_route`, which the C entry points apply too)."""
        names = device_kernel_names(torch, fn)
        rule = da.int8_split_route(dtype, nrows, with_prefix)
        if names is None:
            log(f"{name}: the profiler recorded no device kernel in three "
                f"sessions; the route is the rule's, not measured")
            route = "split" if rule else "SIMT"
        elif any(re.search(INT8_SPLIT_NAMES[name], n) for n in names):
            route = "split"
        elif any("decode_attention_q_kernel" in n for n in names):
            route = "SIMT"
        else:
            route = f"unknown {names}"
        if gates:
            require(route == "split" and rule,
                    f"{name}: bf16 at {nrows} query rows must run the "
                    f"split body's {INT8_SPLIT_NAMES[name]}, ran {route}")
        return route

    for name, kern, plain, G, with_prefix in cases:
        slots = ends.to(torch.int32)
        slots[6:] = T - 1 if G == 1 else T - 64
        qg, new = int8_case(torch, dev, g, B, Hkv, rep, G, D)
        pargs = (*prefix, pmask) if with_prefix else ()
        err = check_int8_case(torch, name, kern, plain, qg, cache, kv_mask,
                              new, slots, pargs, (0, 23, L - 1))
        # K8/K9c given the largest chunk start: no device→host read, so a
        # CUDA graph can hold the call
        kw = {} if G == 1 else {"slots_max": int(slots.max())}

        def fn():
            return kern(qg, *cache, kv_mask, *new, 23, slots, *pargs, **kw)

        # the eager time first: no profiler session just before it
        ms = cuda_ms(torch, fn, iters=50, warmup=10)
        dev_ms = graph_ms(torch, fn)
        plain_ms = cuda_ms(torch, lambda: plain(qg, *cache, kv_mask, *new,
                                                23, slots, *pargs), iters=20)
        route = route_of(name, fn, qg.dtype, G * rep, with_prefix)
        # q, the output, the new tokens' values and scales (read, then
        # written into the cache as int8 + two fp32 scales), the masks
        fixed = (2 * nbytes(qg) + nbytes(*new, kv_mask, slots)
                 + B * Hkv * G * (2 * D + 8)
                 + (nbytes(pmask) if with_prefix else 0))
        bd = decode_bound(torch, kv_mask, pmask if with_prefix else None,
                          Hkv, G * rep, D, 1, 8, fixed)
        log(f"{name} int8 {'verify G=5' if G > 1 else 'decode'}"
            f"{' + prefix Pc=256 (row 6 gated off)' if with_prefix else ''}"
            f" L={L} B={B} Hkv={Hkv} rep={rep} T={T} D={D}, 535 valid "
            f"columns per row, rows 6-7 on one scratch slot, the {route} "
            f"body: max|a-plain|={err:.3e} (atol/rtol 2e-2), int8 "
            f"caches and scales bit-exact, two launches bit-identical; "
            f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms from CUDA graphs, "
            f"{bd['bound_ms'] / dev_ms:.1%} of the bound), plain "
            f"{plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms "
            f"({bd['bound_by']}) per layer; no library call [{card}]")
        if gates and name in INT8_SIMT_EAGER_MS:
            simt = INT8_SIMT_EAGER_MS[name]
            require(ms <= simt / 2, f"{name} eager {ms:.4f} ms > "
                    f"{simt / 2:.4f} (half the SIMT body's {simt})")
        rows[name] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                          bound_share=bd["bound_ms"] / dev_ms,
                          plain_ms=plain_ms, library_ms=None, **bd)
    del cache, prefix
    lock = check_int8_lockstep(torch, dev, card, g, route_of)
    rows["K7"]["other_shapes"] = lock
    rows["K7"]["max_abs_err"] = max(
        rows["K7"]["max_abs_err"], *(r["max_abs_err"] for r in lock.values()))
    return rows


def check_int8_lockstep(torch, dev, card, g, route_of) -> dict:
    """K7 at Llama-3.1-8B's lockstep int8 shape: L 32, B 4, Hkv 8, rep 4,
    T 1280, D 128 (32 clusters of 4, one block an SM), rows left-padded by
    0-250 columns, every column before the step's one scalar slot 1100
    valid, the slot broadcast to every row by the wrapper (checked with
    the host int; timed on the broadcast (B,) slots, so that the times
    hold the kernel and not the broadcast's fill)."""
    from prot2text_tpu_torch.kernels import decode_attention as da

    L, B, Hkv, rep, T, D, pos = 32, 4, 8, 4, 1280, 128, 1100
    cache = [torch.randint(-127, 128, (L, B, Hkv, T, D), generator=g,
                           device=dev, dtype=torch.int8) for _ in range(2)]
    cache += [torch.rand((L, B, Hkv, T), generator=g, device=dev) * 0.028
              + 0.002 for _ in range(2)]
    pads = torch.tensor([0, 17, 250, 3], device=dev)
    cols = torch.arange(T, device=dev)
    kv_mask = ((cols >= pads[:, None]) & (cols < pos)).to(torch.int32)
    qg, new = int8_case(torch, dev, g, B, Hkv, rep, 1, D)
    kern = da.decode_attention_stacked_write_q
    plain = da.decode_attention_stacked_write_q_plain
    err = check_int8_case(torch, "K7 lockstep", kern, plain, qg, cache,
                          kv_mask, new, pos, (), (0, 17, L - 1))

    slots = torch.full((B,), pos, dtype=torch.int32, device=dev)

    def fn():
        return kern(qg, *cache, kv_mask, *new, 17, slots)

    ms = cuda_ms(torch, fn, iters=50, warmup=10)
    dev_ms = graph_ms(torch, fn)
    plain_ms = cuda_ms(torch, lambda: plain(qg, *cache, kv_mask, *new, 17,
                                            slots), iters=20)
    route = route_of("K7", fn, qg.dtype, rep, False)
    fixed = (2 * nbytes(qg) + nbytes(*new, kv_mask, slots)
             + B * Hkv * (2 * D + 8))
    bd = decode_bound(torch, kv_mask, None, Hkv, rep, D, 1, 8, fixed)
    log(f"K7 int8 decode, lockstep L={L} B={B} Hkv={Hkv} rep={rep} T={T} "
        f"D={D}, slot {pos} for every row, 850-1100 valid columns a row, "
        f"the {route} body: max|a-plain|={err:.3e} (atol/rtol 2e-2), int8 "
        f"caches and scales bit-exact, two launches bit-identical; kernel "
        f"{ms:.4f} ms (device {dev_ms:.4f} ms from CUDA graphs, "
        f"{bd['bound_ms'] / dev_ms:.1%} of the bound), plain "
        f"{plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms "
        f"({bd['bound_by']}) per layer; no library call [{card}]")
    return {"lockstep B4 Hkv8 rep4 T1280 D128": dict(
        max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=bd["bound_ms"], bound_share=bd["bound_ms"] / dev_ms,
        route=route)}


# Qwen3-14B's projections (K, N) and the rows the serving path gives them:
# 8 (a decode step at B 8), 40 (a γ-4 verify round), 128; gate/up also at
# 1 and 4 (smaller batches) and an install's 3072 (8 requests x the 384
# bucket); the head at 1, 4, 8 and 40
QUANT_SHAPES = (("q/o", 5120, 5120, (8, 40, 128)),
                ("k/v", 5120, 1024, (8, 40, 128)),
                ("gate/up", 5120, 17408, (1, 4, 8, 40, 128, 3072)),
                ("down", 17408, 5120, (8, 40, 128)),
                ("head", 5120, 151936, (1, 4, 8, 40)))


def check_quant_kernels(torch, dev, card):
    """K10 (int4 nibble planes) and K14 (int8) against their plain versions
    at Qwen3-14B's projection shapes, bf16 x against the fp32 plain version
    on the same values: max|kernel - plain| <= 2e-2 · max|plain| (the int
    values are exact in bf16; only the output's bf16 rounding and the order
    of the fp32 sums differ); above `FEW_ROWS` rows (the many-row body) two
    launches bit-identical; the stacked entry point at layer 2 of a 3-layer
    buffer.  Beside each: the plain version, `torch.matmul` of x with the
    weight dequantized to bf16 before the timed region (the library
    column; the port never calls it) and `dequantize_kernel` followed by
    `torch.matmul` (the route the port took above 256 rows before the
    many-row body).  Every shape's two launches are bit-identical.  Times
    are device time per call from CUDA graphs: at up to `FEW_ROWS` rows
    (the few-row TMA body) HBM-cold, the kernel and the library call each
    over weight copies past the L2 (`cold_ms`), as a decode step finds
    them; above, over one weight (`graph_ms`).  At these sizes an eager
    call's host cost exceeds the kernel's, and one eager call's time is
    printed beside it.  The row keeps the gate/up shape's times at R 8, the
    step's largest projection, with R 1, 4, 40, 128 and 3072 beside them
    (`at_rows`), the head's few-row times (`head_rows`), and the largest
    absolute error of any shape."""
    from prot2text_tpu_torch.kernels import quant_matmul as qm
    from prot2text_tpu_torch.models.quant import dequantize_kernel

    g = torch.Generator(device=dev).manual_seed(2468)
    rows = {}
    for kid, bits, kern, stacked, plain in (
            ("K10", 4, qm.quant_matmul_int4_planes,
             qm.quant_matmul_int4_planes_stacked,
             qm.quant_matmul_int4_planes_plain),
            ("K14", 8, qm.quant_matmul_int8, qm.quant_matmul_int8_stacked,
             qm.quant_matmul_int8_plain)):
        lo, hi = (-8, 8) if bits == 4 else (-127, 128)
        key = "kernel_q4p" if bits == 4 else "kernel_q"
        worst, at_rows, head_rows = 0.0, [], []
        for name, K, N, Rs in QUANT_SHAPES:
            q = torch.randint(lo, hi, (K, N), generator=g, device=dev,
                              dtype=torch.int8)
            w = qm.pack_int4_planes(q) if bits == 4 else q
            del q
            scale = torch.rand((1, N), generator=g, device=dev) * 0.03 + 2e-3
            leaf = {key: w, "scale": scale}
            wd = dequantize_kernel(leaf, torch.bfloat16)
            for R in Rs:
                x = torch.randn((R, K), generator=g, device=dev).to(
                    torch.bfloat16)
                y = kern(x, w, scale)
                torch.cuda.synchronize()
                want = plain(x.float(), w, scale)
                err = (y.float() - want).abs().max().item()
                top = want.abs().max().item()
                require(bool(torch.isfinite(y).all()) and err <= 2e-2 * top,
                        f"{kid} {name} R={R}: max|err| {err} > 2e-2 * "
                        f"max|plain| {top}")
                body = "few-row" if R <= qm.FEW_ROWS else "many-row"
                require(torch.equal(kern(x, w, scale), y),
                        f"{kid} {name} R={R}: two launches differ")
                worst = max(worst, err)
                if body == "few-row":
                    ms = cold_ms(torch, lambda wi: kern(x, wi, scale), w, dev)
                    lib_ms = cold_ms(torch, lambda wi: torch.matmul(x, wi),
                                     wd, dev)
                else:
                    ms = graph_ms(torch, lambda: kern(x, w, scale))
                    lib_ms = graph_ms(torch, lambda: torch.matmul(x, wd))
                plain_ms = graph_ms(torch, lambda: plain(x, w, scale),
                                    calls=2)
                deq_ms = graph_ms(torch, lambda: torch.matmul(
                    x, dequantize_kernel(leaf, torch.bfloat16)), calls=2)
                host_ms = cuda_ms(torch, lambda: kern(x, w, scale), iters=20)
                # W, its scales and x read once, y written once
                bd = bound(2.0 * R * K * N,
                           nbytes(w, scale, x) + R * N * x.element_size())
                log(f"{kid} {'int4 planes' if bits == 4 else 'int8'} {name} "
                    f"R={R} K={K} N={N} bf16 x, {body} body: "
                    f"max|y-plain|/max|plain| {err / top:.3e} (2e-2); two "
                    f"launches bit-identical; device time per call (CUDA "
                    f"graph{', HBM-cold' if body == 'few-row' else ''}): "
                    f"kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, torch.matmul on the bf16 dequantized "
                    f"weight {lib_ms:.4f} ms, dequantize + torch.matmul "
                    f"{deq_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms "
                    f"({bd['bound_by']}) = {bd['bound_ms'] / ms:.1%}; one "
                    f"eager call with its host cost {host_ms:.4f} ms "
                    f"[{card}]")
                t = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         eager_ms=host_ms, **bd)
                if name == "gate/up":
                    if R == 8:
                        rows[kid] = t
                    else:
                        at_rows.append(dict(R=R, K=K, N=N, body=body,
                                            dequantize_library_ms=deq_ms,
                                            **t))
                elif name == "head" and body == "few-row":
                    head_rows.append(dict(R=R, K=K, N=N, body=body, **t))
                del x, y, want
            del w, scale, wd, leaf
        # the stacked entry point reads layer 2 of an (L, ...) buffer in place
        K, N = 5120, 5120
        q = torch.randint(lo, hi, (3, K, N), generator=g, device=dev,
                          dtype=torch.int8)
        w = qm.pack_int4_planes(q) if bits == 4 else q
        scale = torch.rand((3, 1, N), generator=g, device=dev) * 0.03 + 2e-3
        for R in (8, 40):
            x = torch.randn((R, K), generator=g, device=dev).to(
                torch.bfloat16)
            y = stacked(x, w, scale, 2)
            torch.cuda.synchronize()
            want = plain(x.float(), w[2], scale[2])
            err = (y.float() - want).abs().max().item()
            top = want.abs().max().item()
            require(err <= 2e-2 * top, f"{kid} stacked layer 2 R={R}: "
                    f"max|err| {err} > 2e-2 * max|plain| {top}")
            worst = max(worst, err)
            log(f"{kid} stacked entry, layer 2 of (3, {w.shape[1]}, {N}), "
                f"R={R}: max|y-plain|/max|plain| {err / top:.3e} (2e-2)")
        rows[kid]["max_abs_err"] = worst
        rows[kid]["at_rows"] = at_rows
        rows[kid]["head_rows"] = head_rows
        rows[kid]["sources"] = [
            "prot2text_tpu_torch/kernels/csrc/quant_matmul.cu",
            "prot2text_tpu_torch/kernels/csrc/quant_matmul_rows.cu"]
        del q, w, scale, x, y, want
        gc.collect()
        torch.cuda.empty_cache()
    return rows


# Qwen3-14B's largest projections and its head (K, N), at the rows of the
# lockstep decode at B 4, a batch of 16 and a verify round of 40; gate/up
# also at 128 and at an install's (a prefill's) 3072
K11_SHAPES = (("gate/up", 5120, 17408, (1, 4, 8, 16, 40, 128, 3072)),
              ("down", 17408, 5120, (4, 8, 16, 40)),
              ("head", 5120, 151936, (4, 8, 16, 40)))


def check_k11_kernels(torch, dev, card):
    """K11a (int4 split-half bytes) and K11b (int4 bf16-pair words) against
    their plain versions at `K11_SHAPES`, bf16 x against the fp32 plain
    version on the same values: max|kernel - plain| <= 2e-2 · max|plain|,
    as for K10/K14; two launches bit-identical.  Each against K10's wrapper
    on the same integers at every R: both bodies read the bytes and words
    into K10's fragment order and take K10's grid, so each must be
    bit-identical to it.  The stacked entry point at layer 2 of a 3-layer
    gate/up buffer at R 4, 16 and 40.  Times are device time per call from
    CUDA graphs, at up to `FEW_ROWS` rows HBM-cold (`cold_ms`: the kernel
    and the library call over weight copies past the L2), above over one
    weight (`graph_ms`), with one eager call's time beside them; the
    library column is one `torch.matmul` of x with the weight dequantized
    to bf16 before the timed region (the port never calls it), and at R
    3072 also `dequantize_kernel` followed by `torch.matmul` (the route
    these rows took before the many-row body).  The row keeps the gate/up
    shape's times at R 4, the lockstep step's largest projection, with R
    1, 8, 40, 128 and 3072 beside them (`at_rows`), the head's few-row
    times (`head_rows`), and the largest absolute error of any shape."""
    from prot2text_tpu_torch.kernels import quant_matmul as qm
    from prot2text_tpu_torch.models.quant import dequantize_kernel

    g = torch.Generator(device=dev).manual_seed(1357)
    rows = {}
    for kid, fmt, key, pack, kern, stacked, plain in (
            ("K11a", "bytes", "kernel_q4", qm.pack_int4,
             qm.quant_matmul_int4, qm.quant_matmul_int4_stacked,
             qm.quant_matmul_int4_plain),
            ("K11b", "pairs", "kernel_q4w", qm.pack_int4_pairs,
             qm.quant_matmul_int4_pairs, qm.quant_matmul_int4_pairs_stacked,
             qm.quant_matmul_int4_pairs_plain)):
        worst, at_rows, head_rows = 0.0, [], []
        for name, K, N, Rs in K11_SHAPES:
            q = torch.randint(-8, 8, (K, N), generator=g, device=dev,
                              dtype=torch.int8)
            w, wp = pack(q), qm.pack_int4_planes(q)
            del q
            scale = torch.rand((1, N), generator=g, device=dev) * 0.03 + 2e-3
            leaf = {key: w, "scale": scale}
            wd = dequantize_kernel(leaf, torch.bfloat16)
            for R in Rs:
                x = torch.randn((R, K), generator=g, device=dev).to(
                    torch.bfloat16)
                y = kern(x, w, scale)
                y10 = qm.quant_matmul_int4_planes(x, wp, scale)
                torch.cuda.synchronize()
                want = plain(x.float(), w, scale)
                err = (y.float() - want).abs().max().item()
                top = want.abs().max().item()
                require(bool(torch.isfinite(y).all()) and err <= 2e-2 * top,
                        f"{kid} {name} R={R}: max|err| {err} > 2e-2 * "
                        f"max|plain| {top}")
                worst = max(worst, err)
                d10 = (y.float() - y10.float()).abs().max().item()
                require(torch.equal(y, y10), f"{kid} {name} R={R}: not "
                        f"bit-identical to K10's wrapper (max|diff| {d10})")
                body = "few-row" if R <= qm.FEW_ROWS else "many-row"
                require(torch.equal(kern(x, w, scale), y),
                        f"{kid} {name} R={R}: two launches differ")
                if body == "few-row":
                    ms = cold_ms(torch, lambda wi: kern(x, wi, scale), w, dev)
                    lib_ms = cold_ms(torch, lambda wi: torch.matmul(x, wi),
                                     wd, dev)
                else:
                    ms = graph_ms(torch, lambda: kern(x, w, scale))
                    lib_ms = graph_ms(torch, lambda: torch.matmul(x, wd))
                plain_ms = graph_ms(torch, lambda: plain(x, w, scale),
                                    calls=2)
                deq = ""
                if R == 3072:
                    deq_ms = graph_ms(torch, lambda: torch.matmul(
                        x, dequantize_kernel(leaf, torch.bfloat16)), calls=2)
                    deq = f", dequantize + torch.matmul {deq_ms:.4f} ms"
                host_ms = cuda_ms(torch, lambda: kern(x, w, scale), iters=20)
                # W, its scales and x read once, y written once
                bd = bound(2.0 * R * K * N,
                           nbytes(w, scale, x) + R * N * x.element_size())
                log(f"{kid} int4 {fmt} {name} R={R} K={K} N={N} bf16 x, "
                    f"{body} body: max|y-plain|/max|plain| {err / top:.3e} "
                    f"(2e-2); bit-identical to K10's wrapper on the same "
                    f"integers, two launches bit-identical; device time per "
                    f"call (CUDA graph"
                    f"{', HBM-cold' if body == 'few-row' else ''}): kernel "
                    f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul on "
                    f"the bf16 dequantized weight {lib_ms:.4f} ms "
                    f"(x{ms / lib_ms:.2f}){deq}, bound "
                    f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}) = "
                    f"{bd['bound_ms'] / ms:.1%}; one eager call with its host "
                    f"cost {host_ms:.4f} ms [{card}]")
                t = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         eager_ms=host_ms, **bd)
                if name == "gate/up":
                    if R == 4:
                        rows[kid] = t
                    elif R != 16:
                        if R == 3072:
                            t["dequantize_library_ms"] = deq_ms
                        at_rows.append(dict(R=R, K=K, N=N, body=body, **t))
                elif name == "head" and body == "few-row":
                    head_rows.append(dict(R=R, K=K, N=N, body=body, **t))
                del x, y, y10, want
            del w, wp, scale, wd, leaf
        # the stacked entry point reads layer 2 of an (L, ...) buffer in place
        K, N = 5120, 17408
        q = torch.randint(-8, 8, (3, K, N), generator=g, device=dev,
                          dtype=torch.int8)
        w = pack(q)
        del q
        scale = torch.rand((3, 1, N), generator=g, device=dev) * 0.03 + 2e-3
        for R in (4, 16, 40):
            x = torch.randn((R, K), generator=g, device=dev).to(torch.bfloat16)
            y = stacked(x, w, scale, 2)
            torch.cuda.synchronize()
            want = plain(x.float(), w[2], scale[2])
            err = (y.float() - want).abs().max().item()
            top = want.abs().max().item()
            require(err <= 2e-2 * top, f"{kid} stacked layer 2 R={R}: "
                    f"max|err| {err} > 2e-2 * max|plain| {top}")
            worst = max(worst, err)
            log(f"{kid} stacked entry, layer 2 of 3 (K={K}, N={N}), R={R}: "
                f"max|y-plain|/max|plain| {err / top:.3e} (2e-2)")
        rows[kid]["max_abs_err"] = worst
        rows[kid]["at_rows"] = at_rows
        rows[kid]["head_rows"] = head_rows
        rows[kid]["sources"] = [
            "prot2text_tpu_torch/kernels/csrc/quant_matmul_int4.cu",
            "prot2text_tpu_torch/kernels/csrc/quant_matmul_rows_int4.cu"]
        del w, scale, x, y, want
        gc.collect()
        torch.cuda.empty_cache()
    return rows


# K15a-g at their probes' shapes: (kernel id, the probe's (K, N) shapes,
# rows, the shape the row keeps the times of)
# K15f's kernel: the many-row body's integer policy
K15F_NAME = r"mm_rows_kernel.*S8W"
PROBE_MM_SHAPES = (
    ("K15a", ((4096, 4096), (4096, 14336), (14336, 4096), (4096, 128256)),
     16, (4096, 14336)),
    ("K15b", ((4096, 14336), (14336, 4096)), 16, (4096, 14336)),
    ("K15c", ((4096, 14336), (14336, 4096)), 16, (4096, 14336)),
    ("K15d", ((4096, 14336), (14336, 4096)), 16, (4096, 14336)),
    ("K15e", ((5120, 17408),), 16, (5120, 17408)),
    ("K15f", ((4096, 14336),), 128, (4096, 14336)),
    ("K15g", ((4096, 14336),), 128, (4096, 14336)),
)


def probe_operands(torch, dev, g, kid, K, N, R):
    """x, the packed weight, the scale (None for K15f/K15g) and the integer
    weight (K, N) it holds, for one K15a-g call."""
    from prot2text_tpu_torch.kernels import probe_quant_matmul as pq
    from prot2text_tpu_torch.kernels import quant_matmul as qm

    def ints(shape, lo=-128, hi=128):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int8)

    if kid in ("K15b", "K15e"):            # split-half bytes: any byte
        w = ints((K // 2, N))
        deq = qm.unpack_int4(w)
    elif kid in ("K15c", "K15d"):
        deq = ints((K, N), -8, 8)
        w = (pq.pack_int4_native if kid == "K15c"
             else qm.pack_int4_planes)(deq)
    else:
        w = deq = ints((K, N))
    x = (ints((R, K)) if kid == "K15f" else torch.randn(
        (R, K), generator=g, device=dev).to(torch.bfloat16))
    scale = (None if kid in ("K15f", "K15g") else
             torch.rand((1, N), generator=g, device=dev) * 0.03 + 2e-3)
    return x, w, scale, deq


def k15f_kernel_names(torch, dev, gates: bool = True) -> None:
    """The kernels one K15f call at the probe's shape launches, by the
    profiler's names: the many-row body's s8 policy (`K15F_NAME`).  `main`
    runs it first in phase 2: in a whole run the profiler recorded nothing
    for this call in three sessions each at the head and in the body of
    `check_probe_kernels` (H100 80GB HBM3, 700 W), while in a fresh
    process it saw the kernel every time.  Where it records nothing, the
    body is the entry's only one (`p2t_int8_mma` runs `rows::run<S8W>`),
    logged as not measured.  `gates=False` prints the names of another
    tree's K15f."""
    from prot2text_tpu_torch.kernels import probe_quant_matmul as pq

    g = torch.Generator(device=dev).manual_seed(8643)
    x, w, _, _ = probe_operands(torch, dev, g, "K15f", 4096, 14336, 128)
    names = device_kernel_names(torch, lambda: pq.mm_i8i8(x, w))
    if names is None:
        log("K15f: the profiler recorded no device kernel in three "
            "sessions; its body is p2t_int8_mma's only one, not measured")
        return
    body = [n for n in names if re.search(K15F_NAME, n)]
    log(f"K15f R=128 K=4096 N=14336 kernels: "
        f"{sorted(set(n[:90] for n in names))}")
    require(bool(body) or not gates,
            f"K15f: no {K15F_NAME!r} kernel among {names}")


K15K_NAME = r"kv_logits_mma_kernel"


def k15k_kernel_names(torch, dev, gates: bool = True) -> None:
    """The kernels one K15k call at the probe's shape (Q 8, T 192, D 128)
    launches, by the profiler's names: the tensor-core body
    (`K15K_NAME`).  `main` runs it first in phase 2, beside K15f's, where
    the profiler records a fresh process's kernels; where it records
    nothing, the body is `p2t_int8_kv_logits`'s only one, logged as not
    measured.  `gates=False` prints the names of another tree's K15k."""
    from prot2text_tpu_torch.kernels import probe_int8_kv as pk

    g = torch.Generator(device=dev).manual_seed(8644)
    q = torch.randn((8, 128), generator=g, device=dev).to(torch.bfloat16)
    c = torch.randint(-128, 128, (192, 128), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand((1, 192), generator=g, device=dev)
    names = device_kernel_names(torch, lambda: pk.int8_to_bf16_matmul(q, c,
                                                                      s))
    if names is None:
        log("K15k: the profiler recorded no device kernel in three "
            "sessions; its body is p2t_int8_kv_logits's only one, not "
            "measured")
        return
    log(f"K15k Q=8 T=192 D=128 kernels: {sorted(set(n[:90] for n in names))}")
    require(any(re.search(K15K_NAME, n) for n in names) or not gates,
            f"K15k: no {K15K_NAME!r} kernel among {names}")


def check_probe_kernels(torch, dev, card, kids=None):
    """K15a-K15g (`kids`: those alone) against their plain versions at
    their probes' shapes (`PROBE_MM_SHAPES`): bf16 outputs within 2e-2 ·
    max|plain| (K15a-e), K15f's int32 product exact and two launches
    bit-identical (its kernel's name: `k15f_kernel_names`), K15g's f32
    within 1e-5 · max|plain|.  Each
    variant's control: K15a at bc 128 is K14 bit for bit (its other chunks
    within 2e-2); K15b and K15e (K11a's bytes, two other unpacks) are K11a
    bit for bit; K15d at K10's tiling is K10 bit for bit (256 columns and K
    slices within 2e-2).  The K10/K11a/K14 references are their few-row
    body (`quant_matmul._few_rows`), whose fragments K15a, K15b, K15d and
    K15e share (at the probes' 16 rows the wrappers run the many-row
    body).  Times
    at the row's shape: device time per call from a CUDA graph that rotates
    through weight copies exceeding twice
    the card's L2 (`scripts/_timing.py`), eager time beside it; the plain
    version from CUDA graphs; the library yardstick, never called by the
    port: `torch.matmul` on the weight dequantized to bf16 (K15f:
    `torch._int_mm`), rotating through its own copies.  Bounds: bytes at
    3.35 TB/s or operations at the bf16 rate (K15f: the int8 rate)."""
    from prot2text_tpu_torch.kernels import probe_quant_matmul as pq
    from prot2text_tpu_torch.kernels import quant_matmul as qm
    from prot2text_tpu_torch.scripts import _timing as tm

    fns = {"K15a": (pq.chunk_mm, pq.chunk_mm_plain),
           "K15b": (pq.mm_i4f, pq.mm_i4f_plain),
           "K15c": (pq.mm_i4n, pq.mm_i4n_plain),
           "K15d": (pq.mm_i4p, pq.mm_i4p_plain),
           "K15e": (pq.mm_i4and, pq.mm_i4and_plain),
           "K15f": (pq.mm_i8i8, pq.mm_i8i8_plain),
           "K15g": (pq.mm_mix, pq.mm_mix_plain)}
    g = torch.Generator(device=dev).manual_seed(8642)
    rows = {}
    for kid, shapes, R, timed in PROBE_MM_SHAPES:
        if kids is not None and kid not in kids:
            continue
        kern, plain = fns[kid]
        worst = 0.0
        for K, N in shapes:
            x, w, scale, deq = probe_operands(torch, dev, g, kid, K, N, R)
            args = (x, w) if scale is None else (x, w, scale)
            y = kern(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            top = want.float().abs().max().item()
            if kid == "K15f":
                require(torch.equal(y, want), f"K15f K={K} N={N}: the int8 "
                        f"product is not exact")
                err = 0.0
            else:
                err = (y.float() - want.float()).abs().max().item()
                rel = 1e-5 if kid == "K15g" else 2e-2
                require(bool(torch.isfinite(y).all()) and err <= rel * top,
                        f"{kid} K={K} N={N} R={R}: max|err| {err} > {rel} "
                        f"* max|plain| {top}")
            worst = max(worst, err)

            def near(got, what):
                d = (got.float() - want.float()).abs().max().item()
                require(d <= 2e-2 * top, f"{kid} {what} K={K} N={N}: "
                        f"max|err| {d} > 2e-2 * max|plain| {top}")

            ctrl = ""
            if kid == "K15a":
                require(torch.equal(pq.chunk_mm(x, w, scale, bc=128),
                                    qm._few_rows(x, w, scale, "int8")),
                        f"K15a bc 128 is not K14's few-row body bit for bit "
                        f"(K={K} N={N})")
                for bc in (32, 64):
                    near(pq.chunk_mm(x, w, scale, bc=bc), f"bc {bc}")
                ctrl = ("; bc 128 = K14's few-row body bit for bit, bc 32 and "
                        "64 within 2e-2")
            elif kid in ("K15b", "K15e"):
                require(torch.equal(y, qm._few_rows(x, w, scale, "bytes")),
                        f"{kid} is not K11a's few-row body bit for bit (K={K} "
                        f"N={N})")
                ctrl = "; = K11a's few-row body bit for bit"
            elif kid == "K15f":
                require(torch.equal(y, kern(*args)),
                        f"K15f K={K} N={N}: two launches differ")
                sms = torch.cuda.get_device_properties(
                    dev).multi_processor_count
                ctrl = (f"; two launches bit-identical; (rows, columns, "
                        f"cluster) a block {pq.i8_tiling(R, K, N, sms)}")
            elif kid == "K15g":
                require(torch.equal(y, kern(*args)),
                        f"K15g K={K} N={N}: two launches differ")
                bm, bn, cl = qm.rows_tiling(
                    R, K, N, torch.cuda.get_device_properties(
                        dev).multi_processor_count, bm=pq.MIX_BLOCK_ROWS)
                ctrl = (f"; two launches bit-identical; many-row body, {bm} "
                        f"rows x {bn} columns a block, K over a cluster of "
                        f"{cl}")
            elif kid == "K15d":
                require(torch.equal(y, qm._few_rows(x, w, scale, "planes")),
                        f"K15d is not K10's few-row body bit for bit (K={K} "
                        f"N={N})")
                for kw in ({"block_cols": 256}, {"split_k8": 64},
                           {"block_cols": 256, "split_k8": 512}):
                    near(pq.mm_i4p(x, w, scale, **kw), str(kw))
                ctrl = ("; K10's tiling = K10's few-row body bit for bit, "
                        "256 columns and K slices within 2e-2")
            log(f"{kid} R={R} K={K} N={N}: max|y-plain|/max|plain| "
                f"{err / max(top, 1e-30):.3e}{ctrl}")
            if (K, N) == timed:
                ws = [w] + [w.clone() for _ in range(
                    tm.copies(nbytes(w), dev) - 1)]
                t = tm.time_pass(lambda: [kern(x, wi, *args[2:])
                                          for wi in ws], len(ws), dev, 10)
                plain_ms = graph_ms(torch, lambda: plain(*args), calls=2)
                if kid == "K15f":
                    lib, name = ws, "torch._int_mm"
                    lt = tm.time_pass(lambda: [torch._int_mm(x, wi)
                                               for wi in lib], len(lib),
                                      dev, 10)
                else:
                    wd = deq.float()
                    if scale is not None:
                        wd = wd * scale
                    wd = wd.to(torch.bfloat16)
                    lib, name = [wd] + [wd.clone() for _ in range(
                        tm.copies(nbytes(wd), dev) - 1)], "torch.matmul"
                    lt = tm.time_pass(lambda: [torch.matmul(x, wi)
                                               for wi in lib], len(lib),
                                      dev, 10)
                io = nbytes(x, y) + (0 if scale is None else nbytes(scale))
                bd = tm.bound(2.0 * R * K * N, nbytes(w) + io,
                              tm.PEAK_INT8 if kid == "K15f" else
                              tm.PEAK_BF16)
                log(f"{kid} R={R} K={K} N={N}: device time per call (CUDA "
                    f"graph over {len(ws)} weight copies) {t['ms']:.4f} ms, "
                    f"eager {t['host_ms']:.4f} ms; plain {plain_ms:.4f} ms; "
                    f"{name} {lt['ms']:.4f} ms; bound {bd['bound_ms']:.4f} "
                    f"ms ({bd['bound_by']}; bytes {bd['bytes_ms']:.4f}, "
                    f"operations {bd['ops_ms']:.4f}) = "
                    f"{bd['bound_ms'] / t['ms']:.1%} [{card}]")
                rows[kid] = dict(ms=t["ms"], plain_ms=plain_ms,
                                 library_ms=lt["ms"], **bd)
                del ws, lib
            del x, w, scale, deq, y, want, args
            gc.collect()
            torch.cuda.empty_cache()
        rows[kid]["max_abs_err"] = worst
    return rows


# K15k's ragged shapes beside the probe's (Q 8, T 192)
K15K_SHAPES = ((13, 200), (1, 64))


PROBE_KV_SHAPES = ((4, 8, 842, 64), (4, 8, 842, 72))
# K15j's and K15l's device times behind a busy device: the kernel's from
# graphs of 10 and of 1 call, then the library call's
BUSY_KEYS = ("device_busy_ms", "device_busy1_ms", "library_device_busy_ms",
             "library_device_busy1_ms")


def check_slot_writes(torch, dev, card, g, B, Hkv, T, D):
    """K15j on an int8 (B, Hkv, T, D) cache and K15l on an f32 (B, Hkv, T)
    scale row at slot T - 242 (D 64 takes 16-byte words, D 72 8-byte
    ones): bit-exact against the plain version over the whole buffer, only
    the slot's row or column moved; eager and device times (CUDA graphs of
    10 calls, and behind a busy device of 10 and of 1) beside
    `index_copy_`'s, the plain version's and the bound."""
    from prot2text_tpu_torch.kernels import probe_int8_kv as pk

    slot = T - 242
    idx = torch.tensor([slot], dtype=torch.int32, device=dev)
    idx64 = idx.long()
    cache = torch.randint(-128, 128, (B, Hkv, T, D), generator=g, device=dev,
                          dtype=torch.int8)
    kn = torch.randint(-128, 128, (B, Hkv, D), generator=g, device=dev,
                       dtype=torch.int8)
    srow = torch.rand((B, Hkv, T), generator=g, device=dev)
    sn = torch.rand((B, Hkv), generator=g, device=dev) + 1
    kn4, sn3 = kn.reshape(B, Hkv, 1, D), sn.reshape(B, Hkv, 1)
    out = {}
    for kid, buf, fn, plain, lib, src in (
            ("K15j", cache, lambda: pk.int8_group_rmw(cache, kn, idx),
             lambda: pk.int8_group_rmw_plain(cache, kn, idx),
             lambda: cache.index_copy_(2, idx64, kn4), kn),
            ("K15l", srow, lambda: pk.f32_scale_row_rmw(srow, sn, idx),
             lambda: pk.f32_scale_row_rmw_plain(srow, sn, idx),
             lambda: srow.index_copy_(2, idx64, sn3), sn)):
        before = buf.clone()
        y = fn().clone()
        torch.cuda.synchronize()
        buf.copy_(before)
        want = plain().clone()
        buf.copy_(before)
        require(torch.equal(y, want), f"{kid} at {tuple(buf.shape)} is not "
                f"bit-exact")
        moved_at = (y != before).nonzero()[:, 2].unique().tolist()
        require(moved_at == [slot], f"{kid} at {tuple(buf.shape)} changed "
                f"slots {moved_at}, not only {slot}")
        ms = cuda_ms(torch, fn, iters=50)
        plain_ms = cuda_ms(torch, plain, iters=50)
        lib_ms = cuda_ms(torch, lib, iters=50)
        dev_ms, lib_dev_ms = graph_ms(torch, fn), graph_ms(torch, lib)
        busy = [busy_graph_ms(torch, f, calls=n) for f in (fn, lib)
                for n in (10, 1)]
        bd = bound(0.0, 2 * nbytes(src) + 4)
        log(f"{kid} slot write {tuple(buf.shape)} slot {slot}: bit-exact, "
            f"only the slot moved; kernel {ms:.4f} ms (device {dev_ms:.4f} "
            f"ms from CUDA graphs; behind a busy device {busy[0]:.4f} ms of "
            f"10, {busy[1]:.4f} ms of 1), plain {plain_ms:.4f} ms, "
            f"index_copy_ {lib_ms:.4f} ms (device {lib_dev_ms:.4f} ms; "
            f"{busy[2]:.4f} / {busy[3]:.4f} ms), bound "
            f"{bd['bound_ms']:.7f} ms ({bd['bound_by']}) [{card}]")
        out[kid] = dict(shape=tuple(buf.shape), ms=ms, device_ms=dev_ms,
                        plain_ms=plain_ms, library_ms=lib_ms,
                        library_device_ms=lib_dev_ms, **dict(zip(BUSY_KEYS,
                                                                busy)), **bd)
    return out


def stream_of_us(torch, dev, calls: int = 20000) -> tuple:
    """Host µs a call of `_build.stream_of` (the raw current stream) and of
    `torch.cuda.current_stream(dev).cuda_stream` (a `Stream` object built
    a call), timed in one process; every kernel wrapper reads the stream
    on every launch."""
    from prot2text_tpu_torch.kernels import _build

    t = torch.empty(1, device=dev)
    out = []
    for fn in (lambda: _build.stream_of(t),
               lambda: torch.cuda.current_stream(t.device).cuda_stream):
        fn()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    require(_build.stream_of(t) == torch.cuda.current_stream(dev).cuda_stream,
            "stream_of is not the current stream")
    return tuple(out)


# K15h/K15i where the bytes bound them: one layer of a serving install's
# keys, 8 requests x 1024 columns x 8 kv heads of D 128
STORE_SELECT_ROWS, STORE_SELECT_COLS = 8 * 1024 * 8, 128


def check_store_select(torch, dev, card, g) -> dict:
    """K15h and K15i at (65536, 128), one layer of a serving install's
    keys: K15h over 33.5 MB of f32 in and 8.4 MB out, K15i over 8.4 MB
    each of a, b and out (row 40000 inside the tile); bit-exact against
    the plain version over the whole output; device times from CUDA
    graphs (`graph_ms`: L2-warm, the operands fit the card's 50 MB L2 in
    part or whole) and HBM-cold (`cold_ms`: a pass over copies past twice
    the L2) beside the plain version's and, for K15i, `torch.where`'s,
    and the share of the bytes bound on both.  Then ragged tiles: K15h at
    (37, 71) with x 4 bytes into its storage (1-byte words, a tail), K15i
    at (842, 72) (8-byte words) with row 841 and -1: bit-exact, eager and
    device times.  Returns each kernel's rows for `other_shapes`."""
    from prot2text_tpu_torch.kernels import probe_int8_kv as pk

    R, C, row = STORE_SELECT_ROWS, STORE_SELECT_COLS, 40000
    x = torch.randn((R, C), generator=g, device=dev) * 40
    ab = torch.randint(-128, 128, (2, R, C), generator=g, device=dev,
                       dtype=torch.int8)
    pick = (torch.arange(R, device=dev) == row)[:, None]
    cases = (  # id, kernel, plain, library (each of the operand), operand,
               # the bytes the function must move
        ("K15h", pk.f32_to_int8_store, pk.f32_to_int8_store_plain, None, x,
         nbytes(x) + x.numel()),
        ("K15i", lambda w: pk.int8_select(w[0], w[1], row),
         lambda w: pk.int8_select_plain(w[0], w[1], row),
         lambda w: torch.where(pick, w[0], w[1]), ab,
         2 * nbytes(ab[1]) + C))
    out = {}
    for kid, fn, plain, lib, w, moved in cases:
        y = fn(w)
        torch.cuda.synchronize()
        require(torch.equal(y, plain(w)), f"{kid} at ({R}, {C}) is not "
                f"bit-exact")
        del y
        ms = cuda_ms(torch, lambda: fn(w), iters=50)
        warm = [None if f is None else graph_ms(torch, lambda f=f: f(w))
                for f in (fn, plain, lib)]
        cold = [None if f is None else cold_ms(torch, f, w, dev)
                for f in (fn, plain, lib)]
        bd = bound(0.0, moved)
        log(f"{kid} int8-KV probe op at ({R}, {C}) (a serving layer's keys"
            f"{f', row {row}' if kid == 'K15i' else ''}): bit-exact; kernel "
            f"{ms:.4f} ms eager, device {warm[0]:.4f} ms L2-warm "
            f"({bd['bound_ms'] / warm[0]:.1%} of the bound), "
            f"{cold[0]:.4f} ms HBM-cold ({bd['bound_ms'] / cold[0]:.1%}); "
            f"plain {warm[1]:.4f} / {cold[1]:.4f} ms; "
            + ("" if lib is None else
               f"torch.where {warm[2]:.4f} / {cold[2]:.4f} ms; ")
            + f"bound {bd['bound_ms']:.5f} ms ({bd['bound_by']}) [{card}]")
        out[kid] = [dict(shape=(R, C), ms=ms, device_ms=warm[0],
                         cold_ms=cold[0], plain_device_ms=warm[1],
                         plain_cold_ms=cold[1], library_device_ms=warm[2],
                         library_cold_ms=cold[2],
                         bound_share=bd["bound_ms"] / warm[0],
                         cold_bound_share=bd["bound_ms"] / cold[0], **bd)]
    del x, ab
    # ragged: x 4 bytes into its storage, cols off the 16-byte grid
    raw = torch.randn((37 * 71 + 1,), generator=g, device=dev) * 40
    xr = raw[1:].view(37, 71)
    a, b = torch.randint(-128, 128, (2, 842, 72), generator=g, device=dev,
                         dtype=torch.int8)
    for kid, shape, what, fn, plain, moved in (
            ("K15h", (37, 71), "x 4 bytes into its storage",
             lambda: pk.f32_to_int8_store(xr),
             lambda: pk.f32_to_int8_store_plain(xr),
             nbytes(xr) + xr.numel()),
            ("K15i", (842, 72), "row 841",
             lambda: pk.int8_select(a, b, 841),
             lambda: pk.int8_select_plain(a, b, 841), 2 * nbytes(b) + 72),
            ("K15i", (842, 72), "row -1",
             lambda: pk.int8_select(a, b, -1),
             lambda: pk.int8_select_plain(a, b, -1), 2 * nbytes(b))):
        require(torch.equal(fn(), plain()), f"{kid} at {shape}, {what}, is "
                f"not bit-exact")
        ms = cuda_ms(torch, fn, iters=50)
        dev_ms = graph_ms(torch, fn)
        bd = bound(0.0, moved)
        log(f"{kid} int8-KV probe op at {shape}, {what}: bit-exact; kernel "
            f"{ms:.4f} ms (device {dev_ms:.4f} ms from CUDA graphs), bound "
            f"{bd['bound_ms']:.6f} ms ({bd['bound_by']}) [{card}]")
        out[kid].append(dict(shape=shape, case=what, ms=ms,
                             device_ms=dev_ms, **bd))
    return out


def check_probe_kv_kernels(torch, dev, card):
    """K15h-K15l against their plain versions on random inputs at the int8
    KV probe's sizes (Hkv 8, T 192, D 128, slot 77): K15h, K15i, K15j and
    K15l bit for bit over the whole output (K15j and K15l write in place,
    and only the slot's row or column may change), K15k within 1e-5 ·
    max|plain|, also at two ragged shapes (`K15K_SHAPES`: query rows off
    the n8 fragment, c rows off the 64-row block).  Times: eager CUDA
    events (these kernels are launch-bound) with the device time from CUDA
    graphs beside them, the plain versions', and the library yardstick
    where one PyTorch call computes the function (`torch.where` for K15i,
    `index_copy_` for K15j and K15l); K15k's share of its bound on the
    device time, at every shape.  K15h, K15i, K15j and K15l (chained
    launches) also from graphs replayed behind a busy device
    (`busy_graph_ms`) of 10 calls and of one call, which no launch before
    overlaps, beside `torch.where`'s and `index_copy_`'s; K15j and K15l at
    the legacy cache's (B, Hkv, T) = (4, 8, 842), D 64 and 72
    (`PROBE_KV_SHAPES`: K15j's 16- and 8-byte words), the same checks and
    times; K15h and K15i where the bytes bound them and at ragged tiles
    (`check_store_select`)."""
    from prot2text_tpu_torch.kernels import probe_int8_kv as pk

    g = torch.Generator(device=dev).manual_seed(9753)
    Hkv, T, D, slot = 8, 192, 128, 77

    def ints(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    x = torch.randn((T, D), generator=g, device=dev) * 12
    a, b, kn = ints(T, D), ints(T, D), ints(Hkv, D)
    cache = ints(1, Hkv, T, D)
    q = torch.randn((8, D), generator=g, device=dev).to(torch.bfloat16)
    s = torch.rand((1, T), generator=g, device=dev)
    srow = torch.rand((1, Hkv, T), generator=g, device=dev)
    sn = torch.rand((Hkv, 1), generator=g, device=dev)
    idx = torch.tensor([slot], dtype=torch.int32, device=dev)
    idx64 = idx.long()
    first = (torch.arange(T, device=dev) == 7)[:, None]
    kn4, sn3 = kn.reshape(1, Hkv, 1, D), sn.reshape(1, Hkv, 1)
    cases = (  # id, kernel, plain, library, bytes moved, operations
        ("K15h", lambda: pk.f32_to_int8_store(x),
         lambda: pk.f32_to_int8_store_plain(x), None,
         nbytes(x) + x.numel(), 0.0),
        ("K15i", lambda: pk.int8_select(a, b, 7),
         lambda: pk.int8_select_plain(a, b, 7),
         lambda: torch.where(first, a, b), 2 * nbytes(b) + D, 0.0),
        ("K15j", lambda: pk.int8_group_rmw(cache, kn, idx),
         lambda: pk.int8_group_rmw_plain(cache, kn, idx),
         lambda: cache.index_copy_(2, idx64, kn4), 2 * nbytes(kn) + 4, 0.0),
        ("K15k", lambda: pk.int8_to_bf16_matmul(q, a, s),
         lambda: pk.int8_to_bf16_matmul_plain(q, a, s), None,
         nbytes(q, a, s) + 4 * 8 * T, 2.0 * 8 * T * D),
        ("K15l", lambda: pk.f32_scale_row_rmw(srow, sn, idx),
         lambda: pk.f32_scale_row_rmw_plain(srow, sn, idx),
         lambda: srow.index_copy_(2, idx64, sn3), 2 * nbytes(sn) + 4, 0.0),
    )
    rows = {}
    for kid, fn, plain, lib, moved, flops in cases:
        before = (cache.clone(), srow.clone())
        y = fn().clone()
        torch.cuda.synchronize()
        cache.copy_(before[0])
        srow.copy_(before[1])
        want = plain().clone()
        err = 0.0
        if kid == "K15k":
            err = (y - want).abs().max().item()
            top = want.abs().max().item()
            require(err <= 1e-5 * top, f"K15k: max|err| {err} > 1e-5 * "
                    f"max|plain| {top}")
        else:
            require(torch.equal(y, want), f"{kid} is not bit-exact")
        if kid in ("K15j", "K15l"):
            old = before[0] if kid == "K15j" else before[1]
            moved_at = (y != old).nonzero()[:, 2].unique().tolist()
            require(moved_at == [slot], f"{kid} changed slots {moved_at}, "
                    f"not only {slot}")
        ms = cuda_ms(torch, fn, iters=50)
        plain_ms = cuda_ms(torch, plain, iters=50)
        lib_ms = None if lib is None else cuda_ms(torch, lib, iters=50)
        dev_ms = graph_ms(torch, fn)
        lib_dev_ms = None if lib is None else graph_ms(torch, lib)
        bd = bound(flops, moved)
        what = (f"max|err| {err:.3e} (1e-5 of max), "
                f"{bd['bound_ms'] / dev_ms:.1%} of the bound on the device"
                if kid == "K15k" else "bit-exact")
        lib_txt = ("none" if lib_ms is None else
                   f"{lib_ms:.4f} ms (device {lib_dev_ms:.4f} ms)")
        one = ""
        if kid != "K15k":
            busy = [None if f is None else busy_graph_ms(torch, f, calls=n)
                    for f in (fn, lib) for n in (10, 1)]
            one = (f"; behind a busy device, graphs of 10 and of 1 call: "
                   f"kernel {busy[0]:.4f} / {busy[1]:.4f} ms, library "
                   + ("none" if lib is None else
                      f"{busy[2]:.4f} / {busy[3]:.4f} ms"))
        log(f"{kid} int8-KV probe op Hkv={Hkv} T={T} D={D}: {what}; kernel "
            f"{ms:.4f} ms (device {dev_ms:.4f} ms from CUDA graphs), plain "
            f"{plain_ms:.4f} ms, library {lib_txt}, bound "
            f"{bd['bound_ms']:.6f} ms ({bd['bound_by']}){one} [{card}]")
        rows[kid] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         library_device_ms=lib_dev_ms, **bd)
        if one:
            rows[kid].update(zip(BUSY_KEYS, busy), other_shapes=[])
    us = stream_of_us(torch, dev)
    log(f"_build.stream_of {us[0]:.3f} us a call, "
        f"torch.cuda.current_stream().cuda_stream {us[1]:.3f} us [{card}]")
    for kid, more in check_store_select(torch, dev, card, g).items():
        rows[kid]["other_shapes"] += more
    for B, H, Tw, Dw in PROBE_KV_SHAPES:
        for kid, row in check_slot_writes(torch, dev, card, g, B, H, Tw,
                                          Dw).items():
            rows[kid]["other_shapes"].append(row)
    rows["K15k"]["other_shapes"] = []
    for Q, Tk in K15K_SHAPES:
        qk = torch.randn((Q, D), generator=g, device=dev).to(torch.bfloat16)
        ck = ints(Tk, D)
        sk = torch.rand((1, Tk), generator=g, device=dev)
        y = pk.int8_to_bf16_matmul(qk, ck, sk)
        want = pk.int8_to_bf16_matmul_plain(qk, ck, sk)
        err = (y - want).abs().max().item()
        top = want.abs().max().item()
        require(y.shape == (Q, Tk) and err <= 1e-5 * top,
                f"K15k at Q={Q} T={Tk}: max|err| {err} > 1e-5 * max|plain| "
                f"{top}")
        ms = cuda_ms(torch, lambda: pk.int8_to_bf16_matmul(qk, ck, sk),
                     iters=50)
        dev_ms = graph_ms(torch, lambda: pk.int8_to_bf16_matmul(qk, ck, sk))
        bd = bound(2.0 * Q * Tk * D, nbytes(qk, ck, sk) + 4 * Q * Tk)
        log(f"K15k int8-KV probe op Q={Q} T={Tk} D={D}: max|err| {err:.3e} "
            f"(1e-5 of max); kernel {ms:.4f} ms (device {dev_ms:.4f} ms "
            f"from CUDA graphs), bound {bd['bound_ms']:.6f} ms "
            f"({bd['bound_by']}) = {bd['bound_ms'] / dev_ms:.1%} [{card}]")
        rows["K15k"]["max_abs_err"] = max(rows["K15k"]["max_abs_err"], err)
        rows["K15k"]["other_shapes"].append(dict(
            Q=Q, T=Tk, max_abs_err=err, ms=ms, device_ms=dev_ms, **bd))
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

    from prot2text_tpu_torch.data.chat import (
        SYSTEM_MESSAGE, llama3_chat_prompt, protein_user_message,
    )
    from prot2text_tpu_torch.data.collate import Buckets, InstructCollator
    from prot2text_tpu_torch.data.tokenization import esm2_tokenizer

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


def generate(torch, model, batch, max_new_tokens: int, **gen_kwargs):
    stats = {}
    if batch["input_ids"].is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = model.generate(
        batch["input_ids"], attention_mask=batch["attention_mask"],
        protein_input_ids=batch["protein_input_ids"],
        protein_attention_mask=batch["protein_attention_mask"],
        max_new_tokens=max_new_tokens, stats=stats, **gen_kwargs)
    stats["total_s"] = time.perf_counter() - t0
    return toks, stats


def run_slice(torch, dev, card, check: bool = True, keep=None):
    """Phase 3 (the module's docstring); `check=False` logs the launch
    counts without requiring them: how the verify skill's A/B recipe times
    another tree's package.  A `keep` dict gets the model and its batch,
    for phase 3d."""
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer
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
    want = expect(K1=L, K4=L * steps)
    require(counts == want or not check,
            f"launch counts {counts} != expected {want}")
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
    # a short run under the profiler: the decode window after the
    # prefill's last K1 launch, K4's share of it, its device events a step
    # and the idle share
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, st3 = generate(torch, model, batch, 16)
    log(f"slice, {st3['steps']} decode steps at "
        f"{st3['decode_s'] / st3['steps'] * 1e3:.3f} ms/step, decode "
        + kernel_breakdown(torch, prof, st3["decode_s"], GEN_FAMILIES,
                           after=K1_FWD, steps=st3["steps"]) + f" [{card}]")
    if keep is not None:
        keep.update(model=model, batch=batch)
    return counts


# ---------------------------------------------------------------------------
# phase 3b: the legacy arc's generation at full width


def legacy_records(n: int, lengths, seed: int):
    """n preprocessed instruct records (the dataset's fields) built with
    numpy: random residues of `lengths` through the ESM2 alphabet, short
    descriptions ending in the instruct eot the derived collator rewrites."""
    import numpy as np

    from prot2text_tpu_torch.data.chat import ByteTextTokenizer
    from prot2text_tpu_torch.data.tokenization import esm2_tokenizer

    rng = np.random.default_rng(seed)
    tok, ptok = ByteTextTokenizer(), esm2_tokenizer()
    return [{"name": f"P{i:05d}",
             "sequence_input_ids": np.asarray(ptok.encode("".join(
                 rng.choice(list(AMINO), int(rng.integers(*lengths))))),
                 np.int32),
             "description_input_ids": np.asarray(
                 tok.encode(FUNCTIONS[i % len(FUNCTIONS)]) + [128009],
                 np.int32)} for i in range(n)]


def legacy_batch(torch, dev, records, mode: str, buckets: dict):
    """`records` through the CLIs' `DerivedCollator` → int64 tensors."""
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer
    from prot2text_tpu_torch.data.collate import Buckets, DerivedCollator

    batch = DerivedCollator(tokenizer=ByteTextTokenizer(),
                            original_eos_token_id=128009, mode=mode,
                            buckets=Buckets(**buckets))(records)
    keys = ("input_ids", "attention_mask", "protein_input_ids",
            "protein_attention_mask") + (("labels",) if mode == "train"
                                         else ())
    return {k: torch.as_tensor(batch[k], dtype=torch.int64, device=dev)
            for k in keys}


# kernel-name patterns of the profiled breakdowns: K1's and K6's bf16
# forwards are the one tensor-core body's instances by mask policy
# (flash_fwd_kernel<D, policy>), their f32 forwards the SIMT kernels; K5's
# and K6b's bf16 backwards likewise (flash_masked_bwd_*_mma_kernel<D,
# policy>: RunMask, BiasMask)
K1_FWD = r"flash_masked_fwd|flash_fwd_kernel.*RunMask"
K6_FWD = r"flash_bias_fwd|flash_fwd_kernel.*BiasMask"
K5_BWD = r"flash_masked_bwd_(dq|dkv)_kernel|flash_masked_bwd.*RunMask"
K6B_BWD = r"flash_bias_bwd|flash_masked_bwd.*BiasMask"
GEN_FAMILIES = (("K1", K1_FWD),
                ("K4", r"decode_split_kernel.*SlotWrite|"
                       r"decode_attention_write_kernel"))
# the legacy tbkd step: K4 at the tbkd strides (the same kernels), and
# K12's, which no path of the port launches any more (a parent tree's)
LEGACY_FAMILIES = GEN_FAMILIES + (("K12", "slab_write"),)
LEGACY_PROFILED_NEW = 8  # the profiled run's new tokens: 7 decode steps


def write_safetensors(torch, directory: str, tensors: dict) -> str:
    """`tensors` as `model.safetensors` in `directory` (made), by the
    port's writer (`models/hf_import.write_safetensors`): the card's
    machine has no `safetensors` package."""
    from prot2text_tpu_torch.models.hf_import import (
        write_safetensors as write,
    )

    os.makedirs(directory, exist_ok=True)
    write(os.path.join(directory, "model.safetensors"), tensors)
    return directory


def hf_layers(tree: dict, L: int, names: dict, pre: str) -> dict:
    """{HF name: tensor} of stacked layer leaves, kernels back to (out,
    in): `names` maps the tree's sub-module to its HF name under
    `pre.{i}.`."""
    out = {}
    for mod, hf in names.items():
        for leaf, t in tree[mod].items():
            suffix = "weight" if leaf in ("kernel", "scale") else leaf
            for i in range(L):
                out[f"{pre}.{i}.{hf}.{suffix}"] = (
                    t[i].T if leaf == "kernel" else t[i])
    return out


def hf_esm2_tensors(tree: dict, L: int) -> dict:
    """The port's ESM2 tree under `EsmModel`'s names."""
    sd = {"embeddings.word_embeddings.weight": tree["word_embeddings"]}
    sd.update(hf_layers(tree["layers"], L, {
        "attn_ln": "attention.LayerNorm", "query": "attention.self.query",
        "key": "attention.self.key", "value": "attention.self.value",
        "attn_out": "attention.output.dense", "mlp_ln": "LayerNorm",
        "intermediate": "intermediate.dense", "output": "output.dense",
    }, "encoder.layer"))
    sd["encoder.emb_layer_norm_after.weight"] = tree["final_ln"]["scale"]
    sd["encoder.emb_layer_norm_after.bias"] = tree["final_ln"]["bias"]
    return sd


def hf_llama_tensors(tree: dict, L: int) -> dict:
    """The port's Llama or Qwen3 tree under `LlamaForCausalLM`'s or
    `Qwen3ForCausalLM`'s names (a tied model has no `lm_head.weight`)."""
    sd = {"model.embed_tokens.weight": tree["embed_tokens"],
          "model.norm.weight": tree["final_ln"]["scale"]}
    names = {
        "input_ln": "input_layernorm", "q_proj": "self_attn.q_proj",
        "k_proj": "self_attn.k_proj", "v_proj": "self_attn.v_proj",
        "o_proj": "self_attn.o_proj",
        "post_attn_ln": "post_attention_layernorm",
        "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
        "down_proj": "mlp.down_proj", "q_norm": "self_attn.q_norm",
        "k_norm": "self_attn.k_norm"}
    sd.update(hf_layers(tree["layers"], L, {
        k: v for k, v in names.items() if k in tree["layers"]},
        "model.layers"))
    if "lm_head" in tree:
        sd["lm_head.weight"] = tree["lm_head"]["kernel"].T
    return sd


def same_tree(torch, a, b) -> bool:
    """Nested dicts of tensors (or None leaves) with the same keys, dtypes,
    shapes and bits."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and sorted(a) == sorted(b)
                and all(same_tree(torch, a[k], b[k]) for k in a))
    if a is None or b is None:
        return a is None and b is None
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a, b))


def legacy_from_hf(torch, dev, card, args, model):
    """Phase 3b's model through the HF weight loader: its randomly built
    ESM2-8M and Llama-3.2-1B towers written as bf16 safetensors under HF's
    names (weights (out, in); `write_safetensors`) into a temporary
    directory, the model rebuilt by `Esm2LlamaForCausalLM.from_pretrained(
    esm_checkpoint_dir=..., llama_checkpoint_dir=...)` on the card (its
    adapter drawn from the CLI's seed, as the built model's), every leaf
    required bit-identical; the write and load seconds and the load's
    peak device memory logged.  Then `cli/convert_checkpoint.py --esm2_dir
    ... --device cuda` on the ESM2 directory, its restored tree required
    bit-identical to the tower.  Returns the loaded model."""
    import tempfile

    from prot2text_tpu_torch.cli import convert_checkpoint
    from prot2text_tpu_torch.core.checkpoint import restore_checkpoint
    from prot2text_tpu_torch.models.composed import Esm2LlamaForCausalLM

    cfg, params = model.config, model.params()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        esm_dir = write_safetensors(
            torch, os.path.join(tmp, "esm2"), hf_esm2_tensors(
                params["esm_encoder"], cfg.esm_config.num_layers))
        llama_dir = write_safetensors(
            torch, os.path.join(tmp, "llama"), hf_llama_tensors(
                params["llama_decoder"], cfg.llama_config.num_layers))
        write_s = time.perf_counter() - t0
        gb = sum(os.path.getsize(os.path.join(d, "model.safetensors"))
                 for d in (esm_dir, llama_dir)) / 1e9
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loaded = Esm2LlamaForCausalLM.from_pretrained(
            cfg, esm_checkpoint_dir=esm_dir, llama_checkpoint_dir=llama_dir,
            dtype=args.model_dtype, device=dev,
            generator=torch.Generator(device=dev).manual_seed(
                args.random_seed), attn_impl=args.attn_impl)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        require(same_tree(torch, loaded.params(), params),
                "the model loaded from bf16 HF safetensors is not "
                "bit-identical to the model it was written from")
        t0 = time.perf_counter()
        out = os.path.join(tmp, "converted")
        convert_checkpoint.main(["--output_dir", out, "--esm2_dir", esm_dir,
                                 "--device", str(dev)])
        conv = restore_checkpoint(out, map_location=dev)
        conv_s = time.perf_counter() - t0
        require(sorted(conv) == ["esm_encoder"] and same_tree(
            torch, conv["esm_encoder"], params["esm_encoder"]),
            "convert_checkpoint --esm2_dir is not bit-identical to the "
            "ESM2 tower")
    log(f"legacy model through the HF loader [{card}]: ESM2-8M + "
        f"Llama-3.2-1B written as bf16 safetensors ({gb:.3f} GB) in "
        f"{write_s:.2f} s, loaded by from_pretrained in {load_s:.2f} s "
        f"(peak device memory {peak:.2f} GiB above the "
        f"{base / 2**30:.2f} GiB held), every leaf bit-identical; "
        f"convert_checkpoint --esm2_dir on {dev} and restore in "
        f"{conv_s:.2f} s, bit-identical")
    return loaded


def run_legacy_generation(torch, dev, card, check: bool = True):
    """Phase 3b: ESM2-8M → dense 320→2048 + LayerNorm → Llama-3.2-1B (all
    16 layers, bf16, random weights from a seeded CUDA generator), built
    by `cli/generate_legacy.py build_model` at the CLI's defaults, then
    written as bf16 HF safetensors and read back through the weight
    loader (`legacy_from_hf`; the rest of the phase runs on the loaded
    model); 4
    proteins of 380-500 residues collated as the CLI does; 256 greedy new
    tokens through `Esm2LlamaForCausalLM.generate`.  Head dim 64: the
    lockstep cache is tbkd, so exact counts K1 = 16 (prefill), K4 = 16 per
    decode step (at the tbkd strides, the slot written in its epilogue),
    K12 = 0, nothing else; the output includes the prompt.  Then one short
    profiled run: the decode window after the prefill's last K1 by kernel
    family, its device events and device busy time a step and its idle
    share.  `check=False` logs the launch counts without requiring them
    and skips the loader (a parent tree's package may have none): how the
    verify skill's A/B recipe runs another tree's package."""
    from prot2text_tpu_torch.cli import generate_legacy as gcli
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer
    from prot2text_tpu_torch.infer.generate import decode_steps_taken
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts
    from prot2text_tpu_torch.models.decoder import kv_cache_layout

    B = 4
    tok = ByteTextTokenizer()
    args = gcli.build_parser().parse_args([
        "--data_root", "unused", "--test_csv", "unused", "--device", "cuda",
        "--random_seed", "0"])
    t0 = time.perf_counter()
    model = gcli.build_model(args, tok, dev)
    torch.cuda.synchronize()
    core = model.config.llama_config.core()
    require(kv_cache_layout(core) == "tbkd", "Llama-3.2-1B's cache not tbkd")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"legacy model ESM2-8M + adapter + Llama-3.2-1B bf16: "
        f"{n_params / 1e9:.3f} B params, random init on {dev} in "
        f"{time.perf_counter() - t0:.1f} s")
    if check:
        model = legacy_from_hf(torch, dev, card, args, model)
    batch = legacy_batch(torch, dev, legacy_records(B, (380, 501), seed=21),
                         "inference", gcli.BUCKETS)
    P = batch["input_ids"].shape[1]
    require(batch["protein_input_ids"].shape[1] == LEGACY_PROTEIN,
            "protein bucket")
    log(f"legacy batch: B={B} protein width {LEGACY_PROTEIN} (valid "
        f"{batch['protein_attention_mask'].sum(1).tolist()}), prompt {P}")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    toks, st = generate(torch, model, batch, LEGACY_NEW)
    counts = launch_counts()
    steps = decode_steps_taken(toks[:, P:], tok.eos_token_id)
    log(f"launches in the legacy generation run: {counts}; decode steps "
        f"{st['steps']}")
    require(tuple(toks.shape) == (B, P + LEGACY_NEW),
            f"tokens {tuple(toks.shape)}")
    require(torch.equal(toks[:, :P], batch["input_ids"]),
            "the output does not start with the prompt")
    require(st["logits_finite"], "non-finite logits")
    require(steps == st["steps"] > 0,
            f"tokens imply {steps} decode steps, generate ran {st['steps']}")
    want = expect(K1=core.num_layers, K4=core.num_layers * steps)
    require(counts == want or not check,
            f"launch counts {counts} != expected {want}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    toks2, st2 = generate(torch, model, batch, LEGACY_NEW)
    require(torch.equal(toks2, toks), "greedy run is not repeatable")
    for name, s in (("first", st), ("second", st2)):
        encode_s = s["total_s"] - s["prefill_s"] - s["decode_s"]
        log(f"legacy generation {name} run [{card}]: encode+adapter "
            f"{encode_s * 1e3:.2f} ms, prefill {s['prefill_s'] * 1e3:.2f} ms "
            f"(B={B}, S={LEGACY_PROTEIN + P}), decode "
            f"{s['decode_s'] / s['steps'] * 1e3:.3f} ms/step over "
            f"{s['steps']} steps = {B * s['steps'] / s['decode_s']:.1f} "
            f"tokens/s, total {s['total_s']:.3f} s = "
            f"{B / s['total_s'] * 3600:.0f} descriptions/hour")
    log(f"legacy generation peak device memory {peak:.2f} GiB [{card}]")
    # a short run under the profiler (its trace costs the host about half a
    # millisecond per device event to read back): the decode window after
    # the prefill's last K1
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, st3 = generate(torch, model, batch, LEGACY_PROFILED_NEW)
    log(f"legacy generation, {st3['steps']} decode steps at "
        f"{st3['decode_s'] / st3['steps'] * 1e3:.3f} ms/step, decode "
        + kernel_breakdown(torch, prof, st3["decode_s"], LEGACY_FAMILIES,
                           after=K1_FWD, steps=st3["steps"]) + f" [{card}]")
    return counts


# ---------------------------------------------------------------------------
# phase 3c: ESMC + Qwen3 lockstep generation at full width through the
# light CLI

LIGHT_NEW = 64           # new tokens; the CLI defaults to 256
LIGHT_FORMATS = (("planes", "K10"), ("bytes", "K11a"), ("pairs", "K11b"))


def light_launches(cfg, batches, steps: int) -> int:
    """int4-matmul launches of the light CLI's generation over `batches`:
    7 projections per layer and the head per decode step, and per batch
    its prefill's 7 per layer (B × bucket rows), one head and ESMC's 4
    projections per layer: a bf16 x takes the format's kernel at every row
    count, in each of the three int4 formats."""
    L = cfg.llm_config.num_layers
    esm = 4 * cfg.esm_config.n_layers
    return len(batches) * (7 * L + 1 + esm) + steps * (7 * L + 1)


def planes_witnesses(torch, lcli, args, tok, model, batch, dev) -> dict:
    """The planes towers' prefill and first-step logits (2 new tokens, no
    launch counted) on routes beside the one the model takes: "planes
    plain", every K10 call through its plain twin on the card (the same
    route: x rounded to bf16, the integer weight, the scale in an fp32
    epilogue); "planes reordered", the plain twin with its fp32 sums over
    K in two halves (only the order of the sums moves: how far that alone
    carries the logits of 40 random layers)."""
    import argparse

    from prot2text_tpu_torch.kernels import quant_matmul as qm
    from prot2text_tpu_torch.models import transformer

    def reordered(x, w, s):
        q = qm.unpack_int4_planes(w).float()
        xb = x.to(torch.bfloat16).float()
        h = q.shape[0] // 2
        y = torch.matmul(xb[:, :h], q[:h]) + torch.matmul(xb[:, h:], q[h:])
        return (y * s.reshape(-1).float()).to(x.dtype)

    short = argparse.Namespace(**dict(vars(args), max_new_tokens=2))
    real = transformer.quant_matmul_int4_planes
    out = {}
    for name, fn in (("planes plain", qm.quant_matmul_int4_planes_plain),
                     ("planes reordered", reordered)):
        stats = []
        transformer.quant_matmul_int4_planes = fn
        try:
            lcli.generate_batches(short, tok, model, [batch], dev,
                                  stats=stats)
        finally:
            transformer.quant_matmul_int4_planes = real
        out[name] = [t.float().cpu() for t in stats[0]["logits"]]
    return out


# the hidden states after the first layer of each planes tower, on the
# kernels against the plain twins: the per-call gate (a fault of K10 in one
# layer shows here at full size, where 40 layers of random weights carry a
# reorder of fp32 sums to several % of the logits)
LIGHT_LAYER_LIMIT = 2e-2


def planes_first_layers(torch, model, batch, dev, card) -> None:
    """The planes towers' hidden states after ESMC's and Qwen3's layer 0,
    K10 (the model's route) against its plain twin on the card (every
    other operation the same): max|diff| <= `LIGHT_LAYER_LIMIT` ·
    max|h|."""
    import numpy as np

    from prot2text_tpu_torch.kernels import quant_matmul as qm
    from prot2text_tpu_torch.models import esmc, transformer
    from prot2text_tpu_torch.models.composed import ESMCQwen
    from prot2text_tpu_torch.models.decoder import (
        contiguous_lengths, decoder_forward,
    )
    from prot2text_tpu_torch.models.transformer import layer_views

    cfg, params, impl = model.config, model.params(), model.attn_impl
    t = {k: torch.as_tensor(np.asarray(batch[k]), dtype=torch.int64,
                            device=dev)
         for k in ("input_ids", "attention_mask", "protein_input_ids",
                   "protein_attention_mask")}
    ecfg, ep = cfg.esm_config, params["esm_encoder"]
    with torch.no_grad():
        embeds, mask = ESMCQwen.apply(
            cfg, params, protein_input_ids=t["protein_input_ids"],
            protein_attention_mask=t["protein_attention_mask"],
            input_ids=t["input_ids"], attention_mask=t["attention_mask"],
            return_decoder_inputs=True, attn_impl=impl)
    core = cfg.llm_config.core()
    B, S = t["input_ids"].shape
    P = t["protein_input_ids"].shape[1]
    cos, sin = esmc.rope_cos_sin(
        torch.arange(P, dtype=torch.int32, device=dev), ecfg.head_dim,
        ecfg.rope_theta)
    h0 = ep["embed"][t["protein_input_ids"]]
    bias = esmc.make_attention_bias(t["protein_attention_mask"],
                                    causal=False)
    lp = layer_views(ep["layers"], ecfg.n_layers)[0]

    def layers():
        with torch.no_grad():
            e = esmc._block(ecfg, lp, None, 1.0, h0, bias, cos, sin, impl)
            d, _ = decoder_forward(
                core, params["llm_decoder"], inputs_embeds=embeds,
                positions=torch.arange(S, device=dev).expand(B, S),
                attn_lengths=contiguous_lengths(mask), attn_impl=impl,
                num_layers=1, final_norm=False)
        return e.float(), d.float()

    got = layers()
    real = transformer.quant_matmul_int4_planes
    transformer.quant_matmul_int4_planes = qm.quant_matmul_int4_planes_plain
    try:
        want = layers()
    finally:
        transformer.quant_matmul_int4_planes = real
    for name, a, b, rows in (("ESMC", got[0], want[0], B * P),
                             ("Qwen3", got[1], want[1], B * S)):
        d = (a - b).abs().max().item()
        top = b.abs().max().item()
        require(bool(torch.isfinite(a).all()) and d <= LIGHT_LAYER_LIMIT * top,
                f"light planes {name} layer 0: max|diff| {d} > "
                f"{LIGHT_LAYER_LIMIT} x max|h| {top} of the plain twins")
        log(f"light planes {name} layer 0 hidden states ({rows} rows), K10 "
            f"against its plain twin: max|diff| {d:.3e} = {d / top:.3e} of "
            f"max|h| ({LIGHT_LAYER_LIMIT}) [{card}]")


# each run's logits against (reference, limit · its largest |logit| or None:
# reported, whether a row's first token must agree); the "planes ..." runs
# are `planes_witnesses`.  Planes against its plain twin: the limit is set
# from the card's readings (PERF.md §6: 4.5% in the prefill on an H100; the
# twin with its sums reordered is the yardstick of what rounding alone does
# over 40 random layers), the per-call gate held by `planes_first_layers`;
# bytes and pairs run K10's fragments on K10's grids, so bit for bit (limit
# 0: every row's first token agrees)
LIGHT_PLAIN_LIMIT = 0.15
LIGHT_AGAINST = {
    "planes reordered": (("planes plain", None, False),),
    "planes": (("planes plain", LIGHT_PLAIN_LIMIT, False),),
    "bytes": (("planes", 0.0, True),),
    "pairs": (("planes", 0.0, True), ("bytes", 0.0, True))}


def light_compare(refs: dict, fmt: str, logits: list) -> None:
    """`fmt`'s prefill and first-step logits against its `LIGHT_AGAINST`
    references: the first step on the rows whose first (greedy) token
    agrees (on random weights a prefill's top-2 logits may lie within any
    rounding apart; where the limit is 0, every row must agree)."""
    for against, limit, need_same in LIGHT_AGAINST[fmt]:
        ref = refs[against]
        same = logits[0].argmax(-1) == ref[0].argmax(-1)
        require(bool(same.all() if limit == 0 else same.any())
                or not need_same, f"light {fmt}: first tokens "
                f"{logits[0].argmax(-1).tolist()} against the {against} "
                f"run's {ref[0].argmax(-1).tolist()}")
        for i, name in enumerate(("prefill", "first step")):
            rows_ = slice(None) if i == 0 else same
            if i and not bool(same.any()):
                log(f"light {fmt} first step against {against}: no row "
                    f"with the same first token")
                continue
            d = (logits[i][rows_] - ref[i][rows_]).abs().max().item()
            top = ref[i][rows_].abs().max().item()
            require(limit is None or d <= limit * top, f"light {fmt} {name} "
                    f"logits: max|diff| {d} > {limit} x max|logit| {top} of "
                    f"{against}")
            log(f"light {fmt} {name} logits against {against}"
                f"{'' if i == 0 else f' ({int(same.sum())} of 4 rows with the same first token)'}: "
                f"{'bit-identical' if d == 0 else f'max|diff| {d:.3e} = {d / top:.3e} of max|logit|'}"
                f"{' (reported)' if limit is None else f' ({limit})'}")


LIGHT_FAMILIES = (("K1", K1_FWD),
                  ("K4", r"decode_split_kernel.*SlotWrite|"
                         r"decode_attention_write_kernel"),
                  ("K10 few-row", "few_rows_kernel"),
                  ("K10 many-row", "mm_rows_kernel|planes_x_kernel"))


def light_profile(torch, lcli, args, tok, model, batch, dev, card) -> None:
    """16 tokens of phase 3c's generation under torch.profiler: the decode
    window after the prefill's last K1 by kernel family, its device events
    a step and its idle share."""
    import copy

    a16 = copy.copy(args)
    a16.max_new_tokens = 16
    stats = []
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        lcli.generate_batches(a16, tok, model, [batch], dev, stats=stats)
        torch.cuda.synchronize()
    (st,) = stats
    log(f"light planes, {st['steps']} decode steps at "
        f"{st['decode_s'] / st['steps'] * 1e3:.3f} ms/step, decode "
        + kernel_breakdown(torch, prof, st["decode_s"], LIGHT_FAMILIES,
                           after=K1_FWD, steps=st["steps"]) + f" [{card}]")


def run_light_generation(torch, dev, card, check: bool = True, keep=None):
    """Phase 3c: ESMC-600M + adapter + Qwen3-14B (full width and depth,
    random weights from `--random_seed 0`) through
    `cli/generate_instruct_light.py`, `LIGHT_NEW` greedy tokens: (1) the
    CLI's `build_model` once at `--model_dtype bf16`, then its
    towers quantized by `quantize_params(int4_format=)` in planes, bytes
    and pairs in turn, each tree freed before the next, each run through
    the CLI's batch loop on 4 records: exact K1/K4 and K10/K11a/K11b
    counts (each format's kernel at every row count), finite logits, the
    prefill's and first step's logits (the first step on the rows whose
    first token agrees) against `LIGHT_AGAINST`'s references: planes
    within `LIGHT_PLAIN_LIMIT` of its plain twin on the card, beside the
    distance that reordering the twin's sums alone gives, and its first
    layers within `LIGHT_LAYER_LIMIT` of the twins
    (`planes_first_layers`); bytes and pairs (K10's fragments and grids)
    bit-identical to planes, with the same tokens; encode+adapter ms,
    prefill ms, decode ms/step, descriptions/hour, peak memory and the
    towers' bytes; planes' decode window profiled (`light_profile`); (2)
    the CLI's
    `main` at `--model_dtype int4` (nibble planes) over a CSV of those 4
    and 2 more records at `--batch_size 4` (the last batch padded): the
    JSON checked, exact K1/K4/K10 counts (its decode steps from K4's L
    launches per step).  `check=False` runs (1)'s generations and their
    times alone (no counts, references or (2)): how the verify skill's A/B
    recipe times another tree's package.  A `keep` dict gets the planes
    model, its batch, the CLI's argv and the planes run's first tokens, for
    phase 3d."""
    import csv
    import os
    import tempfile

    from prot2text_tpu_torch.cli import generate_instruct_light as lcli
    from prot2text_tpu_torch.cli.serve import make_collator
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts
    from prot2text_tpu_torch.models.composed import ESMCQwen
    from prot2text_tpu_torch.models.quant import (
        quantize_params, quantized_bytes,
    )

    tok = ByteTextTokenizer()
    records = train_records(6, (200, 451), seed=31)
    argv = ["--test_csv", "unused", "--device", "cuda", "--random_seed", "0",
            "--batch_size", "4", "--max_new_tokens", str(LIGHT_NEW),
            "--model_dtype", "int4"]
    args = lcli.build_parser().parse_args(argv)
    lcli.refuse_unported(args)
    collate = make_collator(args, tok)
    batch = collate(records[:4])
    log(f"light batch: B=4 protein width {batch['protein_input_ids'].shape[1]}"
        f" prompt width {batch['input_ids'].shape[1]} (valid "
        f"{batch['attention_mask'].sum(1).tolist()})")

    # (1) one bf16 build, three int4 formats
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bf16 = lcli.build_model(lcli.build_parser().parse_args(
        argv + ["--model_dtype", "bf16"]), tok, dev)
    torch.cuda.synchronize()
    cfg, towers = bf16.config, bf16.params()
    del bf16
    L = cfg.llm_config.num_layers
    log(f"light model ESMC-600M + adapter + Qwen3-14B bf16 towers built by "
        f"the CLI's build_model in {time.perf_counter() - t0:.1f} s, "
        f"{(quantized_bytes(towers['esm_encoder']) + quantized_bytes(towers['llm_decoder'])) / 2**30:.3f}"
        f" GiB, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"[{card}]")
    paths, refs, texts = {}, {}, {}
    for fmt, kid in LIGHT_FORMATS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = dict(towers, **{
            t: quantize_params(towers[t], bits=4, int4_format=fmt)
            for t in ("esm_encoder", "llm_decoder")})
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        nbytes_q = (quantized_bytes(params["esm_encoder"])
                    + quantized_bytes(params["llm_decoder"]))
        model = ESMCQwen(cfg, params, attn_impl=args.attn_impl)
        torch.cuda.reset_peak_memory_stats()
        stats = []
        reset_launch_counts()
        t0 = time.perf_counter()
        results = lcli.generate_batches(args, tok, model, [batch], dev,
                                        stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        (st,) = stats
        steps = st["steps"]
        require(len(results) == 4 and steps > 0, f"{fmt}: {len(results)} "
                f"results, {steps} decode steps")
        require(st["logits_finite"], f"{fmt}: non-finite logits")
        want = expect(K1=L, K4=L * steps,
                      **{kid: light_launches(cfg, [batch], steps)})
        require(counts == want or not check, f"light {fmt}: launch counts "
                f"{counts} != expected {want}")
        logits = [t.float().cpu() for t in st["logits"]]
        if check and fmt == "planes":
            planes_first_layers(torch, model, batch, dev, card)
            refs.update(planes_witnesses(torch, lcli, args, tok, model,
                                         batch, dev))
            light_compare(refs, "planes reordered", refs["planes reordered"])
        if check:
            light_compare(refs, fmt, logits)
            require(fmt == "planes" or results == texts["planes"],
                    f"light {fmt}: the generated texts differ from planes'")
            if fmt != "planes":
                log(f"light {fmt}: {steps} decode steps, every row's text "
                    f"identical to planes'")
        refs[fmt], texts[fmt] = logits, results
        encode_s = wall - st["prefill_s"] - st["decode_s"]
        log(f"light {fmt} ({kid}) [{card}]: towers {nbytes_q} bytes "
            f"({nbytes_q / 2**30:.3f} GiB) quantized in {quant_s:.1f} s; "
            f"encode+adapter {encode_s * 1e3:.2f} ms, prefill "
            f"{st['prefill_s'] * 1e3:.2f} ms (B=4, P="
            f"{batch['input_ids'].shape[1]}), decode "
            f"{st['decode_s'] / steps * 1e3:.3f} ms/step over {steps} steps "
            f"= {4 * steps / st['decode_s']:.1f} tokens/s, total {wall:.3f} s"
            f" = {4 / wall * 3600:.0f} descriptions/hour; peak device memory"
            f" {peak:.2f} GiB")
        log(f"light {fmt} launches: {counts}")
        paths[f"light_{fmt}"] = counts
        if fmt == "planes":
            light_profile(torch, lcli, args, tok, model, batch, dev, card)
            if keep is not None:
                keep.update(model=model, batch=batch, argv=list(argv),
                            first=logits[0].argmax(-1))
        del params, model, results, stats, st
        gc.collect()
        torch.cuda.empty_cache()
    del towers
    gc.collect()
    torch.cuda.empty_cache()
    if not check:
        return paths

    # (2) the CLI's main over a CSV of 6 records
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = os.path.join(tmp, "light.csv")
        with open(csv_path, "w", newline="") as f:
            wr = csv.DictWriter(f, fieldnames=list(records[0]))
            wr.writeheader()
            wr.writerows(records)
        argv[argv.index("--test_csv") + 1] = csv_path
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        results = lcli.main(argv + ["--output_dir", tmp])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        with open(os.path.join(tmp, "generation_light_0.json")) as f:
            saved = json.load(f)
    require(saved == results and sorted(saved) == sorted(
        r["AlphaFoldDB"] for r in records), f"JSON names {sorted(saved)}")
    LIGHT_RESULTS["light"] = saved
    require(all(set(v) == {"true", "pred"} and isinstance(v["pred"], str)
                for v in saved.values()), "JSON entries")
    steps = counts["K4"] // L
    batches = [batch, collate(records[4:])]
    want = expect(K1=2 * L, K4=L * steps,
                  K10=light_launches(cfg, batches, steps))
    require(steps > 0 and counts == want,
            f"light main: launch counts {counts} != expected {want}")
    log(f"light main --model_dtype int4 [{card}]: 6 records in 2 batches of "
        f"4 (the last padded), {steps} decode steps, {wall:.3f} s with the "
        f"build, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {counts}")
    paths["light_main_int4"] = counts
    return paths


# ---------------------------------------------------------------------------
# phase 3d: lockstep speculative decoding and beam search at full width

DECODE_NEW = 64          # new tokens of each phase 3d run
DECODE_GAMMA = 4         # drafts a verify round
SELF_DRAFT_LAYERS = 10   # Qwen3-14B's first layers that draft in (d)
BEAM_FAMILIES = (("K1", K1_FWD),
                 ("K4", r"decode_split_kernel.*SlotWrite|"
                        r"decode_attention_write_kernel"),
                 ("reorder", r"indexSelect|index_select"))


def decoding_gates(torch, label, toks, st, first, vocab, eos, pad):
    """Phase 3d's checks of one run: (B, DECODE_NEW) tokens, each a
    vocabulary id or pad, only pad after a row's first EOS; the prefill's
    greedy token bit-identical to the plain run's `first` (the same K1
    prefill), and so the output's first token where it is greedy
    (speculative runs); at most one target forward a token."""
    B = first.shape[0]
    require(tuple(toks.shape) == (B, DECODE_NEW), f"{label}: tokens "
            f"{tuple(toks.shape)}")
    t = toks.cpu()
    require(bool(((t >= 0) & (t < vocab) | (t == pad)).all()),
            f"{label}: a token outside the vocabulary")
    after = (torch.cumsum((t == eos).int(), dim=1) - (t == eos).int()) > 0
    require(bool((t[after] == pad).all()), f"{label}: a token after EOS")
    lead = st["logits"][0].argmax(-1).cpu()
    require(torch.equal(lead, first.cpu()), f"{label}: the prefill's greedy "
            f"tokens {lead.tolist()} differ from the plain run's "
            f"{first.tolist()}")
    if "rounds" in st:
        require(torch.equal(t[:, 0], first.cpu()), f"{label}: first tokens")
        require(st["n_target_forwards"] == st["rounds"] + 1 <= DECODE_NEW,
                f"{label}: {st['n_target_forwards']} target forwards for "
                f"{DECODE_NEW} tokens")


def decoding_line(label, st, B: int, total_s: float, card) -> str:
    """A run's readings: per verify round (acceptance: tokens a round) or
    per beam step, prefill, descriptions/hour."""
    if "rounds" in st:
        r = st["rounds"]
        per = (f"{r} verify rounds, {(r + st['accepted']) / r:.3f} tokens a "
               f"round ({st['accepted']} drafts accepted), "
               f"{st['decode_s'] / r * 1e3:.3f} ms a round")
    else:
        per = (f"{st['steps']} beam steps, {st['decode_s'] / st['steps'] * 1e3:.3f}"
               f" ms a step")
    return (f"{label} [{card}]: prefill {st['prefill_s'] * 1e3:.2f} ms, "
            f"{per}, total {total_s:.3f} s = {B / total_s * 3600:.0f} "
            f"descriptions/hour")


def beam_reorder_window(torch, model, batch, card) -> None:
    """4 new tokens of 4 beams under torch.profiler: the decode window after
    the prefill's last K1 by kernel family, and the cache reorder's
    (`index_select` into the spare buffer) device time a step and share of
    the busy time; then the reorder of one cache tensor of (c)'s shape
    alone, in 8-byte words (`beam_search._reorder`) beside the element
    gather, CUDA-event ms against the bound of its bytes read and
    written."""
    from prot2text_tpu_torch.infer import beam_search as bs

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, st = generate(torch, model, batch, 4, num_beams=4)
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in events_of(prof) if e.device_type == cuda]
    t0 = max((e.end for e in evs if re.search(K1_FWD, e.name)), default=None)
    if t0 is None:
        log(f"beams (c) reorder: not measured (no device events) [{card}]")
    else:
        evs = [e for e in evs if e.start >= t0]
        busy = sum(e.us for e in evs) / 1e3
        reorder = sum(e.us for e in evs
                      if re.search(BEAM_FAMILIES[-1][1], e.name)) / 1e3
        n = st["steps"]
        log(f"beams (c) reorder, {n} steps profiled: "
            f"{reorder / max(n - 1, 1):.3f} ms a step (the last step has "
            f"none), {reorder / max(busy, 1e-9):.1%} of the device busy "
            f"time, " + kernel_breakdown(torch, prof, st["decode_s"],
                                         BEAM_FAMILIES, after=K1_FWD,
                                         steps=n) + f" [{card}]")
    lc = model.config.llama_config
    rows = 4 * batch["input_ids"].shape[0]
    shape = (lc.num_layers, rows, lc.num_kv_heads,
             batch["input_ids"].shape[1] + DECODE_NEW, lc.head_dim)
    src = torch.randn(shape, device=batch["input_ids"].device,
                      dtype=torch.bfloat16)
    dst = torch.empty_like(src)
    sel = torch.randint(0, rows, (rows,), device=src.device)
    words = cuda_ms(torch, lambda: bs._reorder({"k": src}, {"k": dst}, 1,
                                               sel))
    elems = cuda_ms(torch, lambda: torch.index_select(src, 1, sel, out=dst))
    bd = 2 * nbytes(src) / PEAK_BYTES * 1e3
    log(f"beams (c) reorder of one cache tensor {tuple(shape)} bf16 "
        f"({nbytes(src)} bytes): 8-byte words {words:.4f} ms, elements "
        f"{elems:.4f} ms, bound {bd:.4f} ms (read + write at 3.35 TB/s) "
        f"[{card}]")
    del src, dst


def run_decoding(torch, dev, card, model, batch):
    """Phase 3d (a)-(c) on phase 3's ESM2-3B + Llama-3.1-8B bf16 model and
    batch, `DECODE_NEW` tokens each through `model.generate`: (a)
    `prompt_lookup_tokens=DECODE_GAMMA` (exact K1 = L, K6 = L a verify
    round, no K4), (b) the same over the int8 cache (`kv_bits=8`: K8 = L a
    round, 20 query rows on the split body), (c) `num_beams=4` (K1 = L, K4
    = L a step at 16 rows), each against `decoding_gates` (the plain run's
    first tokens from a one-token `generate`, at kv_bits 8 for (b)); then
    (c)'s reorder in a profiled window (`beam_reorder_window`)."""
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts

    lc = model.config.llama_config
    L, B = lc.num_layers, batch["input_ids"].shape[0]
    runs = (("(a) prompt lookup", dict(prompt_lookup_tokens=DECODE_GAMMA),
             None),
            ("(b) prompt lookup int8", dict(prompt_lookup_tokens=DECODE_GAMMA,
                                            kv_bits=8), 8),
            ("(c) beams", dict(num_beams=4), None))
    paths = {}
    for label, kw, kv_bits in runs:
        first = generate(torch, model, batch, 1, kv_bits=kv_bits)[0][:, 0]
        reset_launch_counts()
        toks, st = generate(torch, model, batch, DECODE_NEW, **kw)
        counts = launch_counts()
        decoding_gates(torch, f"decoding {label}", toks, st, first,
                       lc.vocab_size, lc.eos_token_id, lc.pad_token_id)
        if "rounds" in st:
            per = "K8" if kv_bits else "K6"
            want = expect(K1=L, **{per: L * st["rounds"]})
        else:
            want = expect(K1=L, K4=L * st["steps"])
        require(counts == want, f"decoding {label}: launch counts {counts} "
                f"!= expected {want}")
        log(decoding_line(f"decoding {label}, B={B}", st, B, st["total_s"],
                          card) + f"; launches {dict((k, v) for k, v in counts.items() if v)}")
        paths[f"decode_{label[1]}"] = counts
    beam_reorder_window(torch, model, batch, card)
    return paths


def random_qwen3_draft_dir(torch, dev, directory: str, card) -> dict:
    """A random Qwen3-0.6B (seed 1) written as bf16 safetensors under HF's
    names; returns its tree."""
    from prot2text_tpu_torch.models.qwen3 import Qwen3Config, init_qwen3_params

    cfg = Qwen3Config.qwen3_0_6b()
    tree = init_qwen3_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(1), device=dev, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    sd = hf_llama_tensors(tree, cfg.num_layers)
    write_safetensors(torch, directory, {k: v.contiguous().cpu()
                                         for k, v in sd.items()})
    nb = sum(v.numel() * v.element_size() for v in sd.values())
    log(f"draft Qwen3-0.6B: {nb} bytes of bf16 safetensors written in "
        f"{time.perf_counter() - t0:.2f} s [{card}]")
    return tree


def run_light_decoding(torch, dev, card, held, routes):
    """Phase 3d (d)-(e) on phase 3c's int4-planes ESMC-600M + Qwen3-14B
    towers and batch through the light CLI's `generate_batches`,
    `DECODE_NEW` tokens: (d) `--speculative_gamma DECODE_GAMMA
    --self_speculative_layers SELF_DRAFT_LAYERS` (K4 = N a draft step, K6
    = L a verify round, K10 at the few-row body for the draft steps' 4
    rows and the prefill's head, at the many-row body for the prefill and
    ESMC and the verify's 20 rows, counted from `quant_matmul.route`'s
    answers); (e) `--speculative_gamma DECODE_GAMMA --draft_checkpoint_dir
    DIR`, DIR a random Qwen3-0.6B as bf16 safetensors
    (`random_qwen3_draft_dir`) loaded back through the flag by the CLI's
    `build_draft` before the timed window, bit-identical (K1 = L + 28, K4 = 28 a draft step, K6 = L a round, K10 the target's
    projections only); each against `decoding_gates` with the planes run's
    first tokens."""
    import tempfile

    from prot2text_tpu_torch.cli import generate_instruct_light as lcli
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts

    model, batch, argv, first = (held[k] for k in ("model", "batch", "argv",
                                                    "first"))
    tok = ByteTextTokenizer()
    cfg = model.config
    qc = cfg.llm_config
    L, N, G = qc.num_layers, SELF_DRAFT_LAYERS, DECODE_GAMMA + 1
    esm_rows = light_launches(cfg, [batch], 0) - 7 * L - 1
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        draft_tree = None
        for label, extra in (
                ("(d) self-draft", ["--self_speculative_layers", str(N)]),
                ("(e) draft model", ["--draft_checkpoint_dir", tmp])):
            if label.startswith("(e)"):
                draft_tree = random_qwen3_draft_dir(torch, dev, tmp, card)
            args = lcli.build_parser().parse_args(
                argv + ["--max_new_tokens", str(DECODE_NEW),
                        "--speculative_gamma", str(DECODE_GAMMA)] + extra)
            # the CLI's `main` builds the draft once before its batch loop;
            # the timed window holds the decoding only
            t0 = time.perf_counter()
            draft = lcli.build_draft(args, model, dev)
            if draft_tree is not None:
                dcfg, loaded = draft
                torch.cuda.synchronize()
                require(same_tree(torch, loaded, draft_tree),
                        "the draft loaded through --draft_checkpoint_dir "
                        "differs from the tree written")
                log(f"draft Qwen3-0.6B loaded through the flag in "
                    f"{time.perf_counter() - t0:.2f} s, bit-identical")
                del loaded
            stats = []
            before = dict(routes)
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lcli.generate_batches(args, tok, model, [batch], dev,
                                  draft=draft, stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            del draft
            counts = launch_counts()
            (st,) = stats
            r = st["rounds"]
            decoding_gates(torch, f"decoding {label}", st["tokens"], st,
                           first, qc.vocab_size, tok.eos_token_id,
                           tok.pad_token_id)
            k10 = light_launches(cfg, [batch], 0) + r * (7 * L + 1)
            if draft_tree is None:
                few = 1 + r * (G * 7 * N + DECODE_GAMMA)
                k10 += r * (G * 7 * N + DECODE_GAMMA)
                want = expect(K1=L, K4=N * G * r, K6=L * r, K10=k10)
            else:
                few = 1
                DL = dcfg.num_layers
                want = expect(K1=L + DL, K4=DL * G * r, K6=L * r, K10=k10)
            require(counts == want, f"decoding {label}: launch counts "
                    f"{counts} != expected {want}")
            seen = {k: routes.get(k, 0) - before.get(k, 0) for k in routes}
            many = esm_rows + 7 * L + r * (7 * L + 1)
            require(seen.get("few", 0) == few and seen.get("rows", 0) == many
                    and sum(seen.values()) == k10, f"decoding {label}: K10 "
                    f"bodies {seen}, expected few {few}, rows {many}")
            log(decoding_line(f"decoding {label}, B=4", st, 4, wall, card)
                + f"; K10 by body {seen}; launches "
                f"{dict((k, v) for k, v in counts.items() if v)}")
            paths[f"decode_{label[1]}"] = counts
    return paths


# ---------------------------------------------------------------------------
# phase 4: stage-2 SFT at full width through the CLI's own setup

FUNCTIONS = ("Binds ATP and transfers its gamma-phosphate to serine.",
             "Component of the large ribosomal subunit.",
             "Transports potassium ions across the inner membrane.",
             "Unknown function.")


def train_records(n: int, lengths, seed: int):
    """n CSV-style rows (the `Prot2TextLightDataset` record) built with
    numpy: random residues of `lengths` and short descriptions."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"AlphaFoldDB": f"P{i:05d}", "Full Name": f"Protein {i}",
             "taxon": "Homo sapiens",
             "sequence": "".join(rng.choice(list(AMINO),
                                            int(rng.integers(*lengths)))),
             "function": FUNCTIONS[i % len(FUNCTIONS)]} for i in range(n)]


TRAIN_FAMILIES = (("K1", K1_FWD), ("K5", K5_BWD), ("K6", K6_FWD),
                  ("K6b", K6B_BWD))
# the profiled serving runs are bf16: K4, K9a, K7/K8 and K9b/K9c run the
# split body, told apart by its column and element policies (K7/K8 over
# CacheCols, K9b/K9c over PrefixCols); the SIMT int8 body (f32 q, or past
# 32 query rows) keeps a family of its own; K10/K14 are both of their
# bodies (the few-row quant_mma/quant_matmul_reduce kernels, the many-row
# mm_rows kernel and planes' x copy)
# the ragged route's kernels (csrc/quant_matmul_ragged.cuh; before the
# few-row TMA body, every few-row call's)
RAGGED_QUANT = "quant_mma_kernel|quant_matmul_reduce_kernel"
SERVE_FAMILIES = (("K1", K1_FWD), ("K6", K6_FWD),
                  ("K7/K8", r"decode_split_kernel.*CacheCols.*Int8Cache"),
                  ("int8 SIMT", "decode_attention_q_kernel"),
                  ("K9b/K9c", r"decode_split_kernel.*PrefixCols.*Int8Cache"),
                  ("K4", r"decode_split_kernel.*CacheCols.*SlotWrite"),
                  ("K9a", r"decode_split_kernel.*PrefixCols.*Bf16Cache"),
                  ("K10/K14 few-row", "few_rows_kernel"),
                  ("K10/K14 ragged", RAGGED_QUANT),
                  ("K10/K14 many-row", "mm_rows_kernel|planes_x_kernel"))


class Event:
    """One profiled event: name, device type, start and end in µs."""

    __slots__ = ("name", "device_type", "start", "end")

    def __init__(self, e):
        self.name, self.device_type = e.name(), e.device_type()
        self.start, self.end = e.start_ns() / 1e3, e.end_ns() / 1e3

    @property
    def us(self) -> float:
        return self.end - self.start


def events_of(prof) -> list:
    """A profiled window's events, read from the profiler's kineto results
    as they are.  `prof.events()` first builds the tree of function events,
    ~70 µs an event: half a minute for a serving window's ~500,000."""
    return [Event(e) for e in prof.profiler.kineto_results.events()
            if not e.is_hidden_event()]


def kernel_breakdown(torch, prof, wall_s: float,
                     families=TRAIN_FAMILIES, after: str | None = None,
                     steps: int | None = None) -> str:
    """Device time of a profiled window by kernel family (the port's kernels
    by a name pattern each, cuBLAS GEMMs, the rest), from the CUDA kernel
    events of `torch.profiler`, and the host's CUDA API calls (launches,
    synchronisations, copies) that pace it.  With `after`, the window
    starts where the last device event matching that pattern ends (`wall_s`
    is then that window's wall time); with `steps`, the window's device
    events are also given per step."""
    fam = {label: 0.0 for label, _ in families}
    fam.update(GEMM=0.0, rest=0.0)
    by_name, api = {}, {}
    n_kernels = 0
    events = events_of(prof)
    if after is not None:
        t0 = max((e.end for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and re.search(after, e.name)), default=None)
        require(t0 is not None, f"no device event matches {after!r}")
        events = [e for e in events if e.start >= t0]
    for e in events:
        us = e.us
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.name.startswith(("cuda", "cu")) and not e.name.startswith(
                    "cudnn"):
                n, t = api.get(e.name, (0, 0.0))
                api[e.name] = (n + 1, t + us)
            continue
        n_kernels += 1
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        label = next((lb for lb, key in families if re.search(key, e.name)),
                     None)
        if label is None:
            label = ("GEMM" if re.search(r"gemm|xmma|nvjet|cutlass|cublas",
                                         e.name, re.I) else "rest")
        fam[label] += us
    busy = sum(fam.values()) / 1e6
    if busy == 0:
        return "profiled window: the profiler recorded no device kernels"
    lines = [f"profiled window: wall {wall_s * 1e3:.1f} ms, device busy "
             f"{busy * 1e3:.1f} ms, idle share {1 - busy / wall_s:.3f}, "
             f"{n_kernels} device events"
             + ("" if steps is None else
                f" ({n_kernels / steps:.1f} a step over {steps}, device "
                f"busy {busy * 1e3 / steps:.3f} ms a step)")
             + "; " +
             ", ".join(f"{k} {v / 1e3:.1f} ms ({v / 1e6 / busy:.1%})"
                       for k, v in fam.items())]
    lines.append("  host CUDA API: " + ", ".join(
        f"{name} {n}x {t / 1e3:.1f} ms" for name, (n, t) in
        sorted(api.items(), key=lambda kv: -kv[1][1])[:6]))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        lines.append(f"  {us / 1e3:9.2f} ms  {name[:110]}")
    return "\n".join(lines)


def run_training(torch, dev, card):
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer
    from prot2text_tpu_torch.data.collate import Buckets, LightCollator
    from prot2text_tpu_torch.cli.common import build_models
    from prot2text_tpu_torch.cli.train_instruct import (
        BUCKETS as TRAIN_BUCKETS, build_parser, build_training, to_device,
    )
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts
    from prot2text_tpu_torch.models.lora import lora_param_count
    from prot2text_tpu_torch.models.weights import tree_leaves
    from prot2text_tpu_torch.train.sft import make_sft_train_step

    accum, steps = 4, 2
    tok = ByteTextTokenizer()
    args = build_parser().parse_args([
        "--train_csv", "unused", "--device", "cuda", "--random_seed", "0",
        "--gradient_accumulation_steps", str(accum), "--learning_rate",
        "2e-4", "--weight_decay", "0.01"])
    t0 = time.perf_counter()
    models = build_models(args, tok, dev)
    run = build_training(args, tok, dev, total_steps=steps, models=models)
    torch.cuda.synchronize()
    towers = {k: run.frozen[k] for k in ("esm_encoder", "llm_decoder")}
    frozen = tree_leaves(towers)
    n_frozen = sum(t.numel() for t in frozen)
    params = run.state.params
    log(f"train model ESMC-600M + adapter + Qwen3-14B: frozen bf16 "
        f"{n_frozen / 1e9:.3f} B params, LoRA f32 "
        f"{lora_param_count(params['lora_esm']) / 1e6:.1f} M (ESMC) + "
        f"{lora_param_count(params['lora_llm']) / 1e6:.1f} M (Qwen3), adapter "
        f"f32 {lora_param_count(params['adapter']) / 1e6:.1f} M; built on "
        f"{dev} in {time.perf_counter() - t0:.1f} s")
    # the towers must come out untouched: no in-place op (version counters)
    # and bit-equal strided samples of every leaf
    stamp = [(t._version, t.view(-1)[::max(1, t.numel() // 2**20)].clone())
             for t in frozen]

    collater = LightCollator(
        tokenizer=tok, mode="train", placeholder_token=tok.placeholder_token,
        buckets=Buckets(**TRAIN_BUCKETS))
    # steps + 1 profiled batches for "auto", as many again for "flash"
    records = train_records(2 * accum * (steps + 1), (380, 451), seed=0)
    batches = [to_device(collater(records[i * accum:(i + 1) * accum]), dev,
                         accum) for i in range(2 * (steps + 1))]
    S = batches[0]["input_ids"].shape[-1]
    require(S >= 1024, f"training sequence {S} < 1024")
    log(f"batches: {accum} x B=1 micro-batches of S={S} (protein width "
        f"{batches[0]['protein_input_ids'].shape[-1]}), valid tokens per "
        f"step {[int(b['attention_mask'].sum()) for b in batches[:steps]]}")

    gen = torch.Generator(device=dev).manual_seed(0)
    state = run.state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, loss = run.step_fn(state, run.frozen, batches[i], gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = launch_counts()
    L = run.step_kw["decoder_core"].num_layers
    micro = steps * accum
    want = expect(K1=2 * L * micro, K5=L * micro)
    log(f"launches in the training run: {counts} (K1 = forward + "
        f"recomputation per layer and micro-step, K5 = one per layer and "
        f"micro-step)")
    require(counts == want, f"launch counts {counts} != expected {want}")
    require(all(map(lambda x: x == x and abs(x) < float("inf"), losses)),
            f"non-finite loss {losses}")
    require(state.step == steps, f"step counter {state.step}")
    for t, (version, sample) in zip(frozen, stamp):
        require(t._version == version and torch.equal(
            t.view(-1)[::max(1, t.numel() // 2**20)], sample),
            "a frozen tower weight changed")
    bs = [x for name in ("lora_esm", "lora_llm")
          for x in _lora_b(params[name])]
    require(all(b.abs().max().item() > 0 for b in bs),
            "a LoRA B is still zero after a step with lr > 0")
    PEAKS["train"] = torch.cuda.max_memory_allocated()
    peak = PEAKS["train"] / 2**30
    positions = accum * S
    for i, (dt, loss) in enumerate(zip(times, losses)):
        valid = int(batches[i]["attention_mask"].sum())
        log(f"train step {i + 1} [{card}]: loss {loss:.4f}, {dt:.3f} s = "
            f"{positions / dt:.1f} positions/s ({valid / dt:.1f} valid "
            f"tokens/s)")
    log(f"train peak device memory {peak:.2f} GiB [{card}]; LoRA B moved "
        f"in all {len(bs)} targets; frozen towers bit-identical")

    # one micro-step under the profiler: its trace costs the host about
    # half a millisecond per device event to read back
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof_fn = make_sft_train_step(tx=run.tx, **run.step_kw)
    mb = {k: v[0] for k, v in batches[steps].items()}
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, loss = prof_fn(state, run.frozen, mb, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log("one micro-step " + kernel_breakdown(torch, prof, wall)
        + f" [{card}]")
    del prof
    run.state = state
    counts_flash = run_training_flash(torch, run, batches[steps + 1:], gen,
                                      accum, stamp, card)
    return {"train": counts, "train_flash": counts_flash}, models, stamp


def run_training_flash(torch, run, batches, gen, accum, stamp, card):
    """Phase 4, --attn_impl flash on the towers phase 4 built: ESMC's
    attention through K6 and K6b, the decoder's through K1 and K5.  First
    one micro-batch's loss and LoRA-ESM gradients at "flash" against
    "auto" from one state (both compute the same function; bf16 towers,
    so they agree to the bf16 rounding of the attention outputs), then
    len(batches) - 1 steps with exact launch counts.  (Its profiled
    micro-step went for phase 4q's time: it read as "auto"'s within 4%,
    K6 and K6b under 1% of the device time.)"""
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts
    from prot2text_tpu_torch.models.esmc import esmc_encode
    from prot2text_tpu_torch.models.weights import tree_leaves, tree_map
    from prot2text_tpu_torch.train.sft import make_sft_train_step, sft_loss

    step_kw = {**run.step_kw, "attn_impl": "flash"}
    params = run.state.params
    mb = {k: v[0] for k, v in batches[0].items()}
    kw = {k: v for k, v in run.step_kw.items() if k != "attn_impl"}
    lora_esm = tree_leaves(params["lora_esm"])

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    # the whole model: the same loss; the LoRA-ESM gradients agree to the
    # bf16 noise of 76 bf16 layers (a gross-error gate)
    res = {}
    for impl in ("auto", "flash"):
        loss = sft_loss(params, run.frozen, mb, deterministic=True,
                        attn_impl=impl, **kw)
        grads = torch.autograd.grad(loss, lora_esm)
        res[impl] = (loss.item(), torch.cat([g.flatten() for g in grads]))
    (l_a, g_a), (l_f, g_f) = res["auto"], res["flash"]
    r_model = rel(g_f, g_a)
    log(f"train --attn_impl flash vs auto, one micro-batch from one state "
        f"(bf16 towers): loss {l_f:.6f} vs {l_a:.6f} (|diff| "
        f"{abs(l_f - l_a):.3e}, gate 1e-2 * |loss|), LoRA-ESM gradient "
        f"||g_flash - g_auto|| / ||g_auto|| = {r_model:.3e} (gross-error "
        f"gate 0.25) over {g_a.numel()} entries [{card}]")
    require(abs(l_f - l_a) <= 1e-2 * abs(l_a),
            f"flash loss {l_f} vs auto {l_a}")
    require(r_model <= 0.25, f"flash LoRA-ESM gradient rel. diff {r_model}")
    del res, g_a, g_f, grads, loss

    # ESMC alone, the vector-Jacobian product of one fixed cotangent into
    # the LoRA-ESM leaves: both bf16 routes against the plain route on an
    # f32 copy of the tower; flash (fp32 P in K6b) must be no farther
    # from it than auto (bf16 autograd products) is, within 1.5x + 2e-3
    cfg_e, scale = run.step_kw["esm_config"], run.step_kw["cfg"].lora.scale
    esm16 = run.frozen["esm_encoder"]
    esm32 = tree_map(lambda t: t.float(), esm16)
    ids, am = mb["protein_input_ids"], mb["protein_attention_mask"]
    dh = torch.randn((*ids.shape, cfg_e.d_model), device=ids.device,
                     generator=torch.Generator(device=ids.device)
                     .manual_seed(3))
    vjp = {}
    for name, tower, impl, dt in (("f32", esm32, "xla", torch.float32),
                                  ("auto", esm16, "auto", torch.bfloat16),
                                  ("flash", esm16, "flash", torch.bfloat16)):
        h = esmc_encode(cfg_e, tower, ids, am, attn_impl=impl,
                        lora=params["lora_esm"], lora_scale=scale)
        grads = torch.autograd.grad(h, lora_esm, dh.to(dt))
        vjp[name] = torch.cat([g.float().flatten() for g in grads])
    del esm32, h, grads
    r_a, r_f = rel(vjp["auto"], vjp["f32"]), rel(vjp["flash"], vjp["f32"])
    log(f"ESMC-600M alone, LoRA-ESM vector-Jacobian product of one bf16 "
        f"tower route against the plain route on an f32 copy: flash "
        f"(K6/K6b) {r_f:.3e}, auto (plain, bf16 autograd) {r_a:.3e} "
        f"relative L2 (gate: flash <= 1.5 * auto + 2e-3) [{card}]")
    require(r_f <= 1.5 * r_a + 2e-3,
            f"flash VJP rel. err {r_f} > 1.5 * auto's {r_a} + 2e-3")
    del vjp

    step_fn = make_sft_train_step(tx=run.tx, grad_accum=accum, **step_kw)
    state, steps = run.state, len(batches) - 1
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, loss = step_fn(state, run.frozen, batches[i], gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = launch_counts()
    L = run.step_kw["decoder_core"].num_layers
    L_esm = run.step_kw["esm_config"].n_layers
    micro = steps * accum
    want = expect(K1=2 * L * micro, K5=L * micro, K6=2 * L_esm * micro,
                  K6b=L_esm * micro)
    log(f"launches in the flash training run: {counts} (K1 and K6 = "
        f"forward + recomputation per layer and micro-step, K5 and K6b = "
        f"one per layer and micro-step)")
    require(counts == want, f"launch counts {counts} != expected {want}")
    require(all(map(lambda x: x == x and abs(x) < float("inf"), losses)),
            f"non-finite loss {losses}")
    frozen = tree_leaves({k: run.frozen[k] for k in ("esm_encoder",
                                                     "llm_decoder")})
    for t, (version, sample) in zip(frozen, stamp):
        require(t._version == version and torch.equal(
            t.view(-1)[::max(1, t.numel() // 2**20)], sample),
            "a frozen tower weight changed")
    peak = torch.cuda.max_memory_allocated() / 2**30
    S = batches[0]["input_ids"].shape[-1]
    for i, (dt, loss) in enumerate(zip(times, losses)):
        log(f"train --attn_impl flash step {i + 1} [{card}]: loss "
            f"{loss:.4f}, {dt:.3f} s = {accum * S / dt:.1f} positions/s")
    log(f"train --attn_impl flash peak device memory {peak:.2f} GiB "
        f"[{card}]; frozen towers bit-identical")
    run.state = state
    return counts


CONTRAST_FAMILIES = (("K1", K1_FWD), ("K6", K6_FWD))


def run_contrast(torch, dev, card, models, stamp):
    """Phase 4e: stage-1 contrastive training of the adapter at full width
    through `cli/train_contrast.py`'s own setup (`build_contrast`: its
    adapter init, per-epoch cosine schedule and step) at the CLI's
    defaults (batch 8 x accumulation 8, 2 segments, output_llm_layer 16)
    and --attn_impl flash, on the bf16 towers phase 4 built
    (`build_models` draws from one seeded generator in a fixed order, so
    the same args would build the same towers).  The records make one
    batch per epoch, so the schedule's epoch-1 learning rate (0, warmup)
    gives way to the peak at step 2.  2 steps with exact launch counts
    (K1 per text-tower layer and micro-step, K6 per ESMC layer and
    micro-step, no backward kernel: the towers run without a gradient),
    the adapter moved, the towers bit-identical, then one profiled
    step."""
    from prot2text_tpu_torch.cli import train_contrast as tcli
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer
    from prot2text_tpu_torch.data.collate import Buckets, LightCollator
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts
    from prot2text_tpu_torch.models.weights import tree_leaves

    tok = ByteTextTokenizer()
    args = tcli.build_parser().parse_args([
        "--train_csv", "unused", "--device", "cuda", "--random_seed", "0",
        "--attn_impl", "flash"])
    accum, bsz, steps = (args.gradient_accumulation_steps, args.batch_size,
                         2)
    t0 = time.perf_counter()
    crun = tcli.build_contrast(args, tok, dev, steps_per_epoch=1,
                               models=models)
    collater = LightCollator(
        tokenizer=tok, mode="train", placeholder_token=tok.placeholder_token,
        buckets=Buckets(**tcli.BUCKETS))
    n = accum * bsz
    records = train_records(n * (steps + 1), (380, 451), seed=11)
    batches = [tcli.to_device(collater(records[i * n:(i + 1) * n]), dev,
                              accum) for i in range(steps + 1)]
    torch.cuda.synchronize()
    cfg = crun.step_kw["cfg"]
    log(f"contrast setup (build_contrast on phase 4's towers, {n} records "
        f"per step) in {time.perf_counter() - t0:.1f} s: {accum} x B={bsz} "
        f"micro-batches, protein width "
        f"{batches[0]['protein_input_ids'].shape[-1]}, description width "
        f"{batches[0]['description_input_ids'].shape[-1]}, text tower "
        f"layers {cfg.output_llm_layer}, {cfg.num_segments} segments")
    before = [t.detach().clone() for t in tree_leaves(crun.state.params)]
    frozen = tree_leaves({k: crun.frozen[k] for k in ("esm_encoder",
                                                      "llm_decoder")})
    gen = torch.Generator(device=dev).manual_seed(0)
    state = crun.state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, loss = crun.step_fn(state, crun.frozen, batches[i], gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = launch_counts()
    L_esm = crun.step_kw["esm_config"].n_layers
    micro = steps * accum
    want = expect(K1=cfg.output_llm_layer * micro, K6=L_esm * micro)
    log(f"launches in the contrastive run: {counts} (K1 = one per text "
        f"tower layer and micro-step, K6 = one per ESMC layer and "
        f"micro-step)")
    require(counts == want, f"launch counts {counts} != expected {want}")
    require(all(map(lambda x: x == x and 0 < x < float("inf"), losses)),
            f"contrastive loss not finite and positive: {losses}")
    require(state.step == steps, f"step counter {state.step}")
    moved = max((a.detach() - b).abs().max().item()
                for a, b in zip(tree_leaves(state.params), before))
    require(moved > 0, "the adapter did not move")
    for t, (version, sample) in zip(frozen, stamp):
        require(t._version == version and torch.equal(
            t.view(-1)[::max(1, t.numel() // 2**20)], sample),
            "a frozen tower weight changed")
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, (dt, loss) in enumerate(zip(times, losses)):
        log(f"contrast step {i + 1} [{card}]: loss {loss:.4f}, {dt:.3f} s "
            f"= {n / dt:.1f} sequences/s")
    log(f"contrast peak device memory {peak:.2f} GiB [{card}]; adapter "
        f"moved (max |delta| {moved:.3e}), frozen towers bit-identical")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, loss = crun.step_fn(state, crun.frozen, batches[steps], gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log("contrast " + kernel_breakdown(torch, prof, wall, CONTRAST_FAMILIES)
        + f" [{card}]")
    return counts


# ---------------------------------------------------------------------------
# phase 4q: QLoRA at full width: LoRA over int4 towers through K10


# the bf16 peak of phase 4's "auto" steps, which phase 4q's must undercut
PEAKS = {}
# the quantized matmuls' kernels (both bodies; the training rows take the
# many-row one)
K10_KERNELS = "few_rows_kernel|mm_rows_kernel|planes_x_kernel"
QLORA_FAMILIES = (("K1", K1_FWD), ("K5", K5_BWD), ("K10", K10_KERNELS))
# one micro-batch through the kernels against the plain twins on the card:
# both sum exact products in fp32 (in other orders) and round to bf16, so
# they agree to the bf16 noise of 76 random layers, which phase 4's flash
# against auto reads at the same size (gross-error gates, as there)
QLORA_LOSS_GATE = 1e-2           # |loss diff| / |loss|
QLORA_GRAD_GATE = 0.25           # ||g_kernel - g_plain|| / ||g_plain||
# one projection alone carries the precision: K10's output against its
# plain twin (phase 2's gate) and `_QuantLinear`'s dX against the fp32
# product of the scaled dY and the integer weight (the bf16 rounding of
# dY·s and of dX; ROADMAP §3)
QLORA_Y_GATE = 2e-2              # max|y_K10 - y_plain| / max|y_plain|
QLORA_DX_GATE = 1e-2             # max|dX - dX_f32| / max|dX_f32|


def qlora_backward_split(prof) -> tuple:
    """(count, device ms, the product's device ms) of every
    `_QuantLinear` backward in a profiled window: the dequantize of the
    integer weight and the scaled dY, then the dX product (aten::matmul)."""
    n, total, product = 0, 0.0, 0.0
    for e in prof.events():
        if e.name != "_QuantLinearBackward":
            continue
        n += 1
        total += e.device_time_total
        product += sum(c.device_time_total for c in e.cpu_children
                       if c.name == "aten::matmul")
    return n, total / 1e3, product / 1e3


@contextlib.contextmanager
def plain_quant_kernels():
    """`models/transformer.py`'s quantized matmuls on their plain twins (on
    the card too) inside the block, the kernels after it."""
    from prot2text_tpu_torch.kernels import quant_matmul as qm
    from prot2text_tpu_torch.models import transformer as tt

    names = ("quant_matmul_int4_planes", "quant_matmul_int4",
             "quant_matmul_int4_pairs", "quant_matmul_int8")
    kept = {n: getattr(tt, n) for n in names}
    try:
        for n in names:
            setattr(tt, n, getattr(qm, n + "_plain"))
        yield
    finally:
        for n, f in kept.items():
            setattr(tt, n, f)


def qlora_projection(torch, dev, card, decoder, rows: int) -> None:
    """Layer 0's up_proj of the int4 decoder alone on `rows` bf16 rows that
    require grad: K10's output (through `_QuantLinear`) against its plain
    twin's, and dX against the fp32 product of dY·s and the integer
    weight; the plain route's dX is the same backward, bit for bit."""
    from prot2text_tpu_torch.models.quant import unpack_kernel
    from prot2text_tpu_torch.models.transformer import linear

    leaf = {k: v[0] for k, v in decoder["layers"]["up_proj"].items()}
    K, N = leaf["kernel_q4p"].shape[0] * 8, leaf["kernel_q4p"].shape[1]
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((rows, K), generator=g, device=dev).bfloat16()
    dy = torch.randn((rows, N), generator=g, device=dev).bfloat16()
    out = {}
    for label in ("kernels", "plain"):
        with (plain_quant_kernels() if label == "plain"
              else contextlib.nullcontext()):
            xg = x.clone().requires_grad_()
            y = linear(leaf, xg)
            y.backward(dy)
        out[label] = (y.detach().float(), xg.grad)
    (y_k, dx_k), (y_p, dx_p) = out["kernels"], out["plain"]
    ref = (dy.float() * leaf["scale"].reshape(-1)) @ unpack_kernel(
        leaf).float().T
    y_err = ((y_k - y_p).abs().max() / y_p.abs().max()).item()
    dx_err = ((dx_k.float() - ref).abs().max() / ref.abs().max()).item()
    log(f"qlora up_proj alone (R {rows} K {K} N {N} int4 planes, x requires "
        f"grad): K10 against its plain twin {y_err:.3e} of max|y| (gate "
        f"{QLORA_Y_GATE}); dX against fp32 (dY·s)·Qᵀ {dx_err:.3e} of max|dX| "
        f"(gate {QLORA_DX_GATE}); the plain route's dX bit-identical "
        f"[{card}]")
    require(y_err <= QLORA_Y_GATE, f"qlora K10 under grad vs plain {y_err}")
    require(dx_err <= QLORA_DX_GATE, f"qlora dX vs fp32 {dx_err}")
    require(torch.equal(dx_k, dx_p), "qlora dX differs between the routes")


def run_qlora(torch, dev, card, holder):
    """Phase 4q: `train_instruct --model_dtype int4` at the CLI's defaults
    (r 32, f32 LoRA and adapter) through its `build_training`, on phase
    4's bf16 towers (`holder`, a one-item list, gives them up: the bf16
    trees are freed once quantized to int4 nibble planes).  One
    micro-batch's loss and LoRA gradients through K10 against the same
    with every quantized linear on its plain twin; 2 AdamW steps of 4
    accumulated B=1 micro-batches at S >= 1024 with exact K1/K5/K10
    counts (remat: every layer's projections twice a micro-step, the head
    once); every frozen leaf byte-identical, LoRA B moved at a kernel_q4p
    leaf of each tower; the peak against phase 4's bf16 peak; the trained
    LoRA-LLM through `save_peft_dir` and back; one profiled micro-step.
    `qlora_projection` holds one projection's forward and dX."""
    import tempfile

    from prot2text_tpu_torch.cli.train_instruct import (
        BUCKETS as TRAIN_BUCKETS, build_parser, build_training, to_device,
    )
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer
    from prot2text_tpu_torch.data.collate import Buckets, LightCollator
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts
    from prot2text_tpu_torch.models.lora import lora_at
    from prot2text_tpu_torch.models.peft_interop import (
        lora_params_from_peft_dir, save_peft_dir,
    )
    from prot2text_tpu_torch.models.quant import quantized_bytes
    from prot2text_tpu_torch.models.weights import tree_leaves
    from prot2text_tpu_torch.train.sft import make_sft_train_step, sft_loss

    accum, steps = 4, 2
    tok = ByteTextTokenizer()
    args = build_parser().parse_args([
        "--train_csv", "unused", "--device", "cuda", "--random_seed", "0",
        "--model_dtype", "int4", "--gradient_accumulation_steps",
        str(accum), "--learning_rate", "2e-4", "--weight_decay", "0.01"])
    models = holder.pop()
    bf16_bytes = sum(quantized_bytes(t) for t in models[3].values())
    t0 = time.perf_counter()
    run = build_training(args, tok, dev, total_steps=steps, models=models)
    del models
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    towers = {k: run.frozen[k] for k in ("esm_encoder", "llm_decoder")}
    q_bytes = {k: quantized_bytes(t) for k, t in towers.items()}
    log(f"qlora build (int4 planes from phase 4's bf16 towers, LoRA r "
        f"{args.lora_rank} over the packed leaves) in {build_s:.1f} s: "
        f"towers ESMC {q_bytes['esm_encoder']} + Qwen3 "
        f"{q_bytes['llm_decoder']} bytes = {sum(q_bytes.values()) / 1e9:.3f} "
        f"GB against {bf16_bytes / 1e9:.3f} GB in bf16")
    frozen = tree_leaves(towers)
    host = [t.cpu() for t in frozen]              # every byte, on the host
    versions = [t._version for t in frozen]

    collater = LightCollator(
        tokenizer=tok, mode="train", placeholder_token=tok.placeholder_token,
        buckets=Buckets(**TRAIN_BUCKETS))
    records = train_records(accum * (steps + 1), (380, 451), seed=7)
    batches = [to_device(collater(records[i * accum:(i + 1) * accum]), dev,
                         accum) for i in range(steps + 1)]
    S = batches[0]["input_ids"].shape[-1]
    require(S >= 1024, f"qlora sequence {S} < 1024")

    # one micro-batch through the kernels and through their plain twins
    params = run.state.params
    kw = {k: v for k, v in run.step_kw.items() if k != "attn_impl"}
    mb = {k: v[0] for k, v in batches[0].items()}
    lora = tree_leaves({k: params[k] for k in ("lora_esm", "lora_llm")})
    res = {}
    for label in ("kernels", "plain"):
        with (plain_quant_kernels() if label == "plain"
              else contextlib.nullcontext()):
            loss = sft_loss(params, run.frozen, mb, deterministic=True, **kw)
            grads = torch.autograd.grad(loss, lora)
        res[label] = (loss.item(), torch.cat([g.flatten() for g in grads]))
        del loss, grads
    (l_k, g_k), (l_p, g_p) = res["kernels"], res["plain"]
    r_grad = ((g_k - g_p).norm() / g_p.norm()).item()
    log(f"qlora one micro-batch, K10 against its plain twin on the card: "
        f"loss {l_k:.6f} vs {l_p:.6f} (|diff| {abs(l_k - l_p):.3e}, gate "
        f"{QLORA_LOSS_GATE} * |loss|), LoRA gradients ||g_K10 - g_plain|| / "
        f"||g_plain|| = {r_grad:.3e} (gate {QLORA_GRAD_GATE}) over "
        f"{g_p.numel()} entries [{card}]")
    require(abs(l_k - l_p) <= QLORA_LOSS_GATE * abs(l_p),
            f"qlora loss through K10 {l_k} vs plain {l_p}")
    require(r_grad <= QLORA_GRAD_GATE,
            f"qlora LoRA gradient rel. diff {r_grad}")
    del res, g_k, g_p
    qlora_projection(torch, dev, card, run.frozen["llm_decoder"], S)
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(0)
    state = run.state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, loss = run.step_fn(state, run.frozen, batches[i], gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    L = run.step_kw["decoder_core"].num_layers
    L_esm = run.step_kw["esm_config"].n_layers
    micro = steps * accum
    want = expect(K1=2 * L * micro, K5=L * micro,
                  K10=(2 * (7 * L + 4 * L_esm) + 1) * micro)
    log(f"launches in the qlora run: {counts} (K1 = forward + "
        f"recomputation per layer and micro-step, K5 = one per layer and "
        f"micro-step, K10 = every projection of both towers twice, the "
        f"head once, per micro-step)")
    require(counts == want, f"launch counts {counts} != expected {want}")
    require(all(map(lambda x: x == x and abs(x) < float("inf"), losses)),
            f"non-finite loss {losses}")
    require(state.step == steps, f"step counter {state.step}")
    require(all(t._version == v and torch.equal(t.cpu(), h)
                for t, v, h in zip(frozen, versions, host)),
            "a frozen (packed) tower leaf changed")
    del host
    params = state.params
    for name, proj in (("lora_esm", "qkv"), ("lora_llm", "q_proj")):
        node = params[name]["layers"][proj]
        require(node.get("kernel_q4p") is not None
                and node["kernel_q4p"]["B"].abs().max().item() > 0,
                f"{name}/{proj}: LoRA B did not move at kernel_q4p")
    bs = _lora_b({k: params[k] for k in ("lora_esm", "lora_llm")})
    require(all(b.abs().max().item() > 0 for b in bs),
            "a LoRA B is still zero after a step with lr > 0")
    for i, (dt, loss) in enumerate(zip(times, losses)):
        log(f"qlora step {i + 1} [{card}]: loss {loss:.4f}, {dt:.3f} s = "
            f"{accum * S / dt:.1f} positions/s")
    bf16_peak = PEAKS["train"]
    limit = bf16_peak - (bf16_bytes - sum(q_bytes.values())) / 2
    log(f"qlora peak device memory {peak / 2**30:.2f} GiB against phase "
        f"4's bf16 {bf16_peak / 2**30:.2f} GiB (limit: bf16 peak - half the "
        f"towers' bf16 - int4 bytes = {limit / 2**30:.2f} GiB) [{card}]; "
        f"every packed leaf byte-identical; LoRA B moved in all {len(bs)} "
        f"targets, kernel_q4p in both towers")
    require(peak <= limit, f"qlora peak {peak} > {limit}")

    # the trained LoRA-LLM as a PEFT adapter directory and back
    lcfg = run.step_kw["cfg"].lora
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        save_peft_dir(d, params["lora_llm"], lcfg)
        t_save = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for f in os.listdir(d))
        t0 = time.perf_counter()
        back, back_cfg = lora_params_from_peft_dir(d, run.frozen[
            "llm_decoder"])
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    require((back_cfg.r, back_cfg.alpha) == (lcfg.r, lcfg.alpha)
            and same_tree(torch, back, params["lora_llm"]),
            "the PEFT round trip of the QLoRA LoRA-LLM is not bit-identical")
    n_ab = sum(lora_at(v) is not None
               for v in params["lora_llm"]["layers"].values())
    log(f"qlora LoRA-LLM ({n_ab} projections x {L} layers) through "
        f"save_peft_dir: {nbytes} bytes written in {t_save:.2f} s, read back "
        f"against the int4 base in {t_load:.2f} s, bit-identical")
    del back

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof_fn = make_sft_train_step(tx=run.tx, **run.step_kw)
    mb = {k: v[0] for k, v in batches[steps].items()}
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, loss = prof_fn(state, run.frozen, mb, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n, bwd_ms, mm_ms = qlora_backward_split(prof)
    log("qlora one micro-step " + kernel_breakdown(
        torch, prof, wall, QLORA_FAMILIES) + f"\n  the {n} _QuantLinear "
        f"backwards: {bwd_ms:.1f} ms of device time, the dX products "
        f"{mm_ms:.1f} ms, the integer weights' dequantize and dY·s "
        f"{bwd_ms - mm_ms:.1f} ms [{card}]")
    del prof
    return counts


# ---------------------------------------------------------------------------
# phase 4f: the legacy arc's full fine-tuning at full width


def run_legacy_training(torch, dev, card):
    """Phase 4f: `cli/train_legacy.py build_training` at the CLI's
    defaults (f32 ESM2-8M + adapter + Llama-3.2-1B, all parameters
    trained, AdamW at optax's defaults with StepLR, B = 4, accumulation 1,
    remat), on the derived collator's batches of S = protein 512 + prompt
    + description 128: 2 steps with exact counts (K1 = forward +
    recomputation per decoder layer, K5 one per layer; ESM2-8M's
    attention is plain under "auto"), every parameter group moved, the
    loss finite."""
    from prot2text_tpu_torch.cli import train_legacy as tcli
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts
    from prot2text_tpu_torch.models.weights import tree_leaves

    steps = 2
    tok = ByteTextTokenizer()
    args = tcli.build_parser().parse_args([
        "--data_root", "unused", "--train_csv", "unused", "--device", "cuda",
        "--random_seed", "0"])
    t0 = time.perf_counter()
    run = tcli.build_training(args, tok, dev, steps_per_epoch=steps)
    torch.cuda.synchronize()
    params = run.state.params
    n = sum(t.numel() for t in tree_leaves(params))
    log(f"legacy train model f32 {n / 1e9:.3f} B params (all trained), "
        f"built on {dev} in {time.perf_counter() - t0:.1f} s")
    B = args.batch_size
    batches = [legacy_batch(torch, dev, legacy_records(B, (380, 501),
                                                       seed=31 + i),
                            "train", tcli.BUCKETS) for i in range(steps)]
    S = (batches[0]["protein_input_ids"].shape[1]
         + batches[0]["input_ids"].shape[1])
    require(S == LEGACY_PROTEIN + legacy_prompt_len() + 128,
            f"legacy training sequence {S}")
    valid = [int(b["attention_mask"].sum() + b["protein_attention_mask"].sum())
             for b in batches]
    log(f"legacy train batches: B={B}, S={S}, valid tokens per step {valid}")

    def sample(t):
        return t.detach().view(-1)[::max(1, t.numel() // 2**16)].clone()

    before = {k: [sample(t) for t in tree_leaves(v)]
              for k, v in params.items()}
    state = run.state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, loss = run.step_fn(state, batches[i])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = launch_counts()
    L = run.config.llama_config.num_layers
    want = expect(K1=2 * L * steps, K5=L * steps)
    log(f"launches in the legacy training run: {counts} (K1 = forward + "
        f"recomputation per layer and step, K5 = one per layer and step)")
    require(counts == want, f"launch counts {counts} != expected {want}")
    require(all(map(lambda x: x == x and abs(x) < float("inf"), losses)),
            f"non-finite loss {losses}")
    require(state.step == steps, f"step counter {state.step}")
    for k, v in params.items():
        require(any(not torch.equal(a, sample(t)) for a, t in
                    zip(before[k], tree_leaves(v))), f"{k} did not move")
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, (dt, loss) in enumerate(zip(times, losses)):
        log(f"legacy train step {i + 1} [{card}]: loss {loss:.4f}, "
            f"{dt:.3f} s = {B * S / dt:.1f} positions/s, lr "
            f"{run.tx.lr(i):.3e}")
    log(f"legacy train peak device memory {peak:.2f} GiB [{card}]; every "
        f"parameter group ({', '.join(params)}) moved")
    return counts


def _lora_b(tree):
    if isinstance(tree, dict):
        if "B" in tree:
            return [tree["B"]]
        return [b for v in tree.values() for b in _lora_b(v)]
    return []


# ---------------------------------------------------------------------------
# phase 4b: continuous-batching serving at full width through the CLI's loop


def serve_args(*extra):
    from prot2text_tpu_torch.cli.serve import build_parser

    return build_parser().parse_args([
        "--test_csv", "unused", "--device", "cuda", "--random_seed", "0",
        "--max_new_tokens", "128", *extra])


def serve_batches(args, tok, n: int, seed: int):
    """n CSV-style records of 200-450 residues collated by the CLI's own
    collator, `max_slots` per batch, as its DataLoader batches them."""
    from prot2text_tpu_torch.cli.serve import make_collator

    collate = make_collator(args, tok)
    records = train_records(n, (200, 451), seed=seed)
    return [collate(records[i:i + args.max_slots])
            for i in range(0, n, args.max_slots)]


def serve_once(torch, args, tok, cfg, params, batches, dev, label, card):
    """One run of the CLI's serving loop with every launch count at 0 just
    before it; returns (ServeRun, launch counts)."""
    from prot2text_tpu_torch.cli.serve import serve
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    run = serve(args, tok, cfg, params, batches, dev)
    counts = launch_counts()
    eng = run.engine
    n = len(run.results)
    installs = sum(eng.installs.values())
    encode_s = run.seconds - eng.install_s - eng.decode_s
    parts = []
    if eng.plain_steps:
        parts.append(f"{(eng.decode_s - eng.verify_s) / eng.plain_steps * 1e3:.3f}"
                     f" ms/step over {eng.plain_steps} plain steps")
    if eng.verify_rounds:
        parts.append(f"{eng.verify_s / eng.verify_rounds * 1e3:.3f} ms/round "
                     f"over {eng.verify_rounds} verify rounds accepting "
                     f"{eng.acceptance():.3f} tokens per round per active "
                     f"slot ({eng.spec_fallbacks} plain fallbacks)")
    log(f"serve {label} [{card}]: {n} requests in {run.seconds:.3f} s = "
        f"{n / run.seconds * 3600:.0f} descriptions/hour; decode "
        f"{'; '.join(parts)} at B={args.max_slots} ("
        f"{sum(map(len, run.tokens.values())) / eng.decode_s:.1f} "
        f"tokens/s); "
        f"prefill {eng.install_s / installs * 1e3:.2f} ms per install over "
        f"{installs} installs {eng.installs}; encode + prefix prefill + "
        f"host {encode_s * 1e3:.1f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"serve {label} launches: {counts}; shared prefix "
        f"{run.prefix_len} tokens (Pc {eng.prefix_cols}); pool T "
        f"{eng.state['kv_mask'].shape[1]}")
    require(n == sum(len(b["name"]) for b in batches),
            f"served {n} of the submitted requests")
    counts_by_name = {k: len(t) for k, t in run.tokens.items()}
    require(all(1 <= c <= args.max_new_tokens
                for c in counts_by_name.values()),
            f"token counts out of range: {counts_by_name}")
    require(not bool(eng.state["active"].any()), "a slot is still active")
    return run, counts


def run_serve(torch, dev, card):
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer
    from prot2text_tpu_torch.cli.serve import build_server, refuse_unported
    from prot2text_tpu_torch.models.weights import tree_leaves

    tok = ByteTextTokenizer()
    args = serve_args()
    refuse_unported(args)
    t0 = time.perf_counter()
    cfg, params = build_server(args, tok, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    L = cfg.llm_config.num_layers
    log(f"serve model ESMC-600M + adapter + Qwen3-14B bf16: "
        f"{n_params / 1e9:.3f} B params, random init on {dev} in "
        f"{time.perf_counter() - t0:.1f} s")

    batches = serve_batches(args, tok, 16, seed=5)
    run, counts = serve_once(torch, args, tok, cfg, params, batches, dev,
                             "shared prefix + dedup, 16 x 128 tokens", card)
    eng = run.engine
    require(run.prefix_len >= 16, f"shared prefix {run.prefix_len} < 16")
    want = expect(K1=L * (1 + eng.installs["full"]),
                  K6=L * eng.installs["prefix"], K9a=L * eng.steps)
    require(counts == want, f"launch counts {counts} != expected {want}")
    require(eng.installs["prefix"] > 0, "no prefix install ran")
    paths = {"serve": counts}
    del run, eng                 # free the pool before the next run's peak
    gc.collect()
    paths["serve_no_prefix"] = serve_no_prefix(torch, tok, cfg, params, dev,
                                               card)

    # one short default-path run under torch.profiler: where the time goes
    args_p = serve_args("--max_new_tokens", "12")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    batches_p = serve_batches(args_p, tok, 8, 7)
    with torch.profiler.profile(activities=acts) as prof:
        run_p, _ = serve_once(torch, args_p, tok, cfg, params, batches_p,
                              dev, "profiled, 8 x 12 tokens", card)
    log(kernel_breakdown(torch, prof, run_p.seconds, SERVE_FAMILIES)
        + f" [{card}]")
    del run_p, prof
    gc.collect()
    paths.update(run_serve_int8(torch, dev, card, tok, cfg, params, batches))
    paths.update(run_medusa(torch, dev, card, tok, cfg, params))
    return paths


def serve_no_prefix(torch, tok, cfg, params, dev, card):
    """The serving loop with the shared prefix off: full-prompt installs
    (K1) and per-row decode through K4, 8 x 32 tokens."""
    args = serve_args("--shared_prefix", "false", "--max_new_tokens", "32")
    run, counts = serve_once(
        torch, args, tok, cfg, params, serve_batches(args, tok, 8, 6), dev,
        "no shared prefix, 8 x 32 tokens", card)
    eng = run.engine
    want = expect(K1=cfg.llm_config.num_layers * eng.installs["full"],
                  K4=cfg.llm_config.num_layers * eng.steps)
    require(counts == want, f"launch counts {counts} != expected {want}")
    del run, eng
    gc.collect()
    return counts


def run_serve_int8(torch, dev, card, tok, cfg, params, batches):
    """Phase 4c: the int8 pool and prompt-lookup speculation through the
    CLI's loop on the model phase 4b built, with exact launch counts from
    the engine's own counters (`plain_steps`, `verify_rounds`,
    `installs`)."""
    L = cfg.llm_config.num_layers
    paths = {}

    def once(label, path, flags, batches_, want_fn):
        args = serve_args(*flags)
        run, counts = serve_once(torch, args, tok, cfg, params, batches_, dev,
                                 label, card)
        eng = run.engine
        want = want_fn(eng)
        require(counts == want, f"{path}: launch counts {counts} != "
                f"expected {want}")
        paths[path] = counts
        stats = (eng.plain_steps, eng.verify_rounds, eng.spec_fallbacks,
                 eng.state["k"].dtype)
        del run, eng
        gc.collect()
        return stats

    def prefix_installs(eng, **more):
        return expect(K1=L * (1 + eng.installs["full"]),
                      K6=L * eng.installs["prefix"], **more)

    # (a) the int8 pool with the deduplicated prefix and γ 4: fused verify
    plain, rounds, _, dt = once(
        "int8 + prompt lookup 4, shared prefix + dedup, 16 x 128 tokens",
        "serve_kv8_spec", ("--kv_bits", "8", "--prompt_lookup_tokens", "4"),
        batches, lambda e: prefix_installs(e, K9c=L * e.verify_rounds))
    require(dt == torch.int8 and plain == 0 and rounds > 0,
            f"run a: pool {dt}, {plain} plain steps, {rounds} rounds")
    # (b) the int8 pool, plain decode, on the requests 4b served in bf16
    plain, rounds, _, _ = once(
        "int8, shared prefix + dedup, 16 x 128 tokens", "serve_kv8",
        ("--kv_bits", "8"), batches,
        lambda e: prefix_installs(e, K9b=L * e.plain_steps))
    require(plain > 0 and rounds == 0, f"run b: {plain} steps, {rounds}")
    # (c) no prefix; the controller falls back to plain steps and probes
    args_c = serve_args("--max_new_tokens", "32")
    plain, rounds, fallbacks, _ = once(
        "int8 + prompt lookup 4, no prefix, controller (break-even 100, "
        "probe every 2), 8 x 32 tokens", "serve_kv8_spec_controller",
        ("--kv_bits", "8", "--shared_prefix", "false",
         "--prompt_lookup_tokens", "4", "--spec_break_even", "100",
         "--spec_probe_every", "2", "--max_new_tokens", "32"),
        serve_batches(args_c, tok, 8, 6),
        lambda e: expect(K1=L * e.installs["full"], K7=L * e.plain_steps,
                         K8=L * e.verify_rounds))
    require(plain > 0 and rounds > 0 and fallbacks > 0,
            f"run c: {plain} plain steps, {rounds} rounds, {fallbacks} "
            f"fallbacks")
    # (d) speculation on the bf16 pool: the verify is K6 over the pool
    plain, rounds, _, dt = once(
        "bf16 + prompt lookup 4, shared prefix + dedup, 8 x 32 tokens",
        "serve_spec_bf16", ("--prompt_lookup_tokens", "4",
                            "--max_new_tokens", "32"),
        serve_batches(args_c, tok, 8, 7),
        lambda e: expect(K1=L * (1 + e.installs["full"]),
                         K6=L * (e.installs["prefix"] + e.verify_rounds),
                         K9a=L * e.plain_steps))
    require(dt == torch.bfloat16 and rounds > 0,
            f"run d: pool {dt}, {rounds} rounds")

    # three short profiled runs of the int8 pool, plain decode and
    # speculative with the prefix, and (c)'s controller without it: where
    # a step's and a round's device time goes
    for label, flags in INT8_WINDOWS:
        serve_int8_window(torch, tok, cfg, params, dev, card, label, flags)
    return paths


# the profiled int8-pool serving windows, 8 x 12 tokens each: (label,
# flags); the last is run (c)'s no-prefix controller (K7 and K8)
INT8_WINDOWS = (
    ("int8", ()),
    ("int8 + prompt lookup 4", ("--prompt_lookup_tokens", "4")),
    ("int8 + prompt lookup 4, no prefix, controller",
     ("--shared_prefix", "false", "--prompt_lookup_tokens", "4",
      "--spec_break_even", "100", "--spec_probe_every", "2")))


def serve_int8_window(torch, tok, cfg, params, dev, card, label, flags):
    """One short int8-pool serving run (8 x 12 tokens) under
    torch.profiler on the model phase 4b built: its device time by kernel
    family (`SERVE_FAMILIES`) and idle share, logged and returned."""
    args_p = serve_args("--kv_bits", "8", "--max_new_tokens", "12", *flags)
    batches_p = serve_batches(args_p, tok, 8, 7)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run_p, _ = serve_once(torch, args_p, tok, cfg, params, batches_p,
                              dev, f"profiled {label}, 8 x 12 tokens", card)
    text = kernel_breakdown(torch, prof, run_p.seconds, SERVE_FAMILIES)
    log(text + f" [{card}]")
    del run_p, prof
    gc.collect()
    return text


def serve_int8_windows(torch, dev, card, windows=INT8_WINDOWS[-1:]):
    """`serve_int8_window` over `windows` (by default the no-prefix
    controller's, K7 and K8) on a fresh bf16 server (the CLI's defaults):
    for an A/B of two trees' packages (run this file's function with the
    other tree first on `sys.path`).  Returns the breakdowns."""
    from prot2text_tpu_torch.cli.serve import build_server
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer

    tok = ByteTextTokenizer()
    cfg, params = build_server(serve_args(), tok, dev)
    out = [serve_int8_window(torch, tok, cfg, params, dev, card, label,
                             flags) for label, flags in windows]
    del cfg, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4m: Medusa draft heads at full width on phase 4b's model: two draft
# steps at `cli/train_draft.py`'s defaults, serving with the saved heads on
# the bf16 and the int8 pool, the CLI's main on a tiny model, scoring

MEDUSA_RECORDS = 16          # two steps at the CLI's batch of 8
MEDUSA_NEW = 32              # new tokens a request in (b)
# phase 3c's light `main` results, scored in phase 4m (d)
LIGHT_RESULTS = {}


def leaf_bits(torch, t) -> tuple:
    """A contiguous tensor's version counter and the sum of its bit
    patterns read as integers: an in-place op, or a changed bit, shows.
    Summed 2^26 elements at a time (an int64 sum of a whole Qwen3-14B leaf
    would hold a copy 4 times its size)."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    flat = t.reshape(-1).view(ints[t.element_size()])
    return t._version, sum(int(c.sum(dtype=torch.int64))
                           for c in flat.split(1 << 26))


def run_medusa(torch, dev, card, tok, cfg, params):
    """Phase 4m on the bf16 model phase 4b built: (a) `medusa_train`, (b)
    `medusa_serve`, (c) `medusa_cli`, (d) `score_results`.  Returns the
    launch counts by path."""
    import tempfile

    t0 = time.perf_counter()
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "medusa.npz")
        paths["medusa_train"] = medusa_train(torch, dev, card, tok, cfg,
                                             params, npz)
        served, results = medusa_serve(torch, dev, card, tok, cfg, params,
                                       npz)
        paths.update(served)
        paths["train_draft_main"] = medusa_cli(torch, dev, card, tmp)
        score_results(card, tmp, results)
    log(f"phase 4m took {time.perf_counter() - t0:.1f} s")
    return paths


def medusa_train(torch, dev, card, tok, cfg, params, npz):
    """(a) Two AdamW steps of `train/draft.py`'s step over `cli/
    train_draft.py`'s description collate at the CLI's defaults (K 4,
    batch 8, S 256, lr 1e-3) on the frozen bf16 Qwen3-14B: exact K1 = L a
    step and no K5 (the frozen forward runs without gradients), every
    decoder leaf bit-unchanged, both head leaves moved; s/step and the
    peak; the heads saved by the CLI's writer to `npz`."""
    from prot2text_tpu_torch.cli.train_draft import (
        DescriptionCollator, build_draft_training, build_parser, save_heads,
        to_device,
    )
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts
    from prot2text_tpu_torch.models.weights import tree_leaves

    args = build_parser().parse_args(["--train_csv", "unused", "--device",
                                      "cuda", "--random_seed", "0"])
    models = (cfg.esm_config, cfg.llm_config, cfg.adapter_config,
              {"esm_encoder": params["esm_encoder"],
               "llm_decoder": params["llm_decoder"]}, params["adapter"])
    core, decoder, state, step = build_draft_training(args, tok, dev,
                                                      models=models)
    require(decoder is params["llm_decoder"],
            "the bf16 draft trainer must train over phase 4b's decoder")
    frozen = tree_leaves(decoder)
    stamp = [leaf_bits(torch, t) for t in frozen]
    n_dec = sum(t.numel() for t in frozen)
    collate = DescriptionCollator(tok, args.max_sequence_length)
    records = train_records(MEDUSA_RECORDS, (200, 451), seed=11)
    B = args.batch_size
    batches = [to_device(collate(records[i:i + B]), dev)
               for i in range(0, MEDUSA_RECORDS, B)]
    S, L = batches[0]["input_ids"].shape[1], core.num_layers
    K, H, V = args.num_heads, core.hidden_size, core.vocab_size
    # the frozen forward's 2·params a position, and each head's logits
    # forward and their input gradient (2·H·V each a position)
    flops = B * S * (2 * n_dec + K * 4 * H * V)
    log(f"medusa draft setup [{card}]: K {K} heads over the frozen bf16 "
        f"Qwen3-14B ({n_dec / 1e9:.3f} B params), batch {B} x S {S}, lr "
        f"{args.learning_rate}; {len(batches)} steps, valid tokens "
        f"{[int(b['attention_mask'].sum()) for b in batches]}; "
        f"{flops / 1e12:.1f} TFLOP a step")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, losses = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, loss = step(state, decoder, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = launch_counts()
    want = expect(K1=L * len(batches))
    require(counts == want, f"medusa draft steps: launch counts {counts} != "
            f"expected {want}")
    require(all(x == x and 0 < x < float("inf") for x in losses),
            f"medusa losses {losses}")
    require(state.step == len(batches), f"step counter {state.step}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(all(leaf_bits(torch, t) == s for t, s in zip(frozen, stamp)),
            "a frozen decoder weight changed in the draft steps")
    moved = {k: state.params[k].abs().max().item() for k in ("w", "b")}
    require(all(v > 0 for v in moved.values()),
            f"a head leaf did not move from zero: {moved}")
    for i, (dt, loss) in enumerate(zip(times, losses)):
        log(f"medusa draft step {i + 1} [{card}]: loss {loss:.4f}, "
            f"{dt:.3f} s = {B * S / dt:.0f} positions/s, "
            f"{flops / dt / 1e12:.1f} TFLOP/s")
    log(f"medusa draft steps [{card}]: peak device memory {peak:.2f} GiB; "
        f"launches {counts}; decoder bit-unchanged ({len(frozen)} leaves); "
        f"heads moved (max |w| {moved['w']:.3e}, |b| {moved['b']:.3e})")
    save_heads(npz, state.params)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def medusa_serve(torch, dev, card, tok, cfg, params, npz):
    """(b) `cli/serve.py serve --medusa_path` with (a)'s heads, 8 x 32, on
    the bf16 pool (verify K6) and on the int8 pool (K9c), both with the
    dedup prefix: exact counts from the engine's counters, no plain step,
    at most one target forward a token (a verify round emits at least one
    token a slot), acceptance >= 1, every request's first token that of a
    plain run's install (the same flags at --max_new_tokens 1), vocabulary
    ids.  Returns (launch counts by path, the bf16 run's results)."""
    from prot2text_tpu_torch.cli.serve import serve
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts

    L, V = cfg.llm_config.num_layers, cfg.llm_config.vocab_size
    paths, results = {}, None
    for label, path, flags in (("bf16", "serve_medusa", ()),
                               ("int8", "serve_medusa_kv8",
                                ("--kv_bits", "8"))):
        args = serve_args("--max_new_tokens", str(MEDUSA_NEW),
                          "--medusa_path", npz, *flags)
        batches = serve_batches(args, tok, 8, 8)
        reset_launch_counts()
        first = serve(serve_args("--max_new_tokens", "1", *flags), tok, cfg,
                      params, batches, dev)
        paths[path + "_first"] = launch_counts()
        fi = first.engine.installs
        require(paths[path + "_first"] == expect(
            K1=L * (1 + fi["full"]), K6=L * fi["prefix"]),
            f"{path}: the installs-only run launched "
            f"{paths[path + '_first']}")
        run, counts = serve_once(
            torch, args, tok, cfg, params, batches, dev,
            f"Medusa K 4 ({label} pool, shared prefix + dedup), 8 x "
            f"{MEDUSA_NEW} tokens", card)
        eng = run.engine
        rounds, pfx = L * eng.verify_rounds, L * eng.installs["prefix"]
        verify = ({"K6": pfx + rounds} if label == "bf16" else
                  {"K6": pfx, "K9c": rounds})
        want = expect(K1=L * (1 + eng.installs["full"]), **verify)
        require(counts == want, f"{path}: launch counts {counts} != "
                f"expected {want}")
        require(eng.spec_gamma == 4 and eng.plain_steps == 0
                and eng.verify_rounds > 0 and eng.installs["prefix"] > 0,
                f"{path}: gamma {eng.spec_gamma}, {eng.plain_steps} plain "
                f"steps, {eng.verify_rounds} rounds, {eng.installs}")
        require(eng.spec_slot_rounds <= eng.spec_tokens
                and eng.acceptance() >= 1.0,
                f"{path}: {eng.spec_slot_rounds} slot-rounds for "
                f"{eng.spec_tokens} tokens")
        firsts = {k: t[0] for k, t in first.tokens.items()}
        require(sorted(firsts) == sorted(run.tokens) and all(
            run.tokens[k][0] == firsts[k] for k in firsts),
            f"{path}: first tokens differ from the plain installs'")
        require(all(0 <= t < V for ts in run.tokens.values() for t in ts),
                f"{path}: a token outside the vocabulary")
        round_ms = eng.verify_s / eng.verify_rounds * 1e3
        log(f"serve {path} [{card}]: {round_ms:.3f} ms a verify round, "
            f"acceptance {eng.acceptance():.3f}, "
            f"{len(run.results) / run.seconds * 3600:.0f} descriptions/hour;"
            f" first tokens of all {len(firsts)} requests the plain "
            f"installs'")
        paths[path] = counts
        if results is None:
            results = run.results
        del run, eng, first
        gc.collect()
    return paths, results


def medusa_cli(torch, dev, card, tmp):
    """(c) `cli/train_draft.py main` on the card under --debug_tiny_model
    (bf16, K 3, batch 2 over 6 records: 3 steps, K1 = 2 a step): the npz
    it writes reads back through the serve CLI's loader bit-identical to
    the heads it returns, in f32 and in bf16."""
    import csv

    from prot2text_tpu_torch.cli import train_draft
    from prot2text_tpu_torch.cli.serve import load_medusa_heads
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts

    records = train_records(6, (20, 41), seed=12)
    csv_path = os.path.join(tmp, "draft.csv")
    with open(csv_path, "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=list(records[0]))
        wr.writeheader()
        wr.writerows(records)
    npz = os.path.join(tmp, "tiny_medusa.npz")
    reset_launch_counts()
    t0 = time.perf_counter()
    heads = train_draft.main([
        "--train_csv", csv_path, "--debug_tiny_model", "true",
        "--batch_size", "2", "--max_sequence_length", "64", "--num_heads",
        "3", "--output_path", npz])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    require(counts == expect(K1=2 * 3),
            f"train_draft main: launch counts {counts}")
    for dtype in (torch.float32, torch.bfloat16):
        loaded = load_medusa_heads(npz, dtype, dev)
        require(all(loaded[k].dtype == dtype and torch.equal(
            loaded[k], heads[k].detach().to(dtype)) for k in ("w", "b")),
            f"the heads npz read back in {dtype} differs")
    log(f"train_draft main --debug_tiny_model [{card}]: 3 steps in "
        f"{wall:.3f} s with the build, launches {counts}; npz read back "
        f"bit-identical in f32 and bf16")
    return counts


def score_results(card, tmp, served):
    """(d) `cli/benchmark.py main` on phase 3c's light JSON and on (b)'s
    bf16 serving JSON with neither `sacrebleu` nor `rouge_score` imported;
    the references scored against themselves (exact match and every ROUGE
    1.0, BLEU-2 and BLEU-4 1.0 over the references of at least four
    tokens); `bert_score_from_embeddings` on seeded random embeddings
    against a direct evaluation of its formula."""
    import io

    import numpy as np

    from prot2text_tpu_torch.cli import benchmark
    from prot2text_tpu_torch.eval_metrics.metrics import (
        _tokenize_13a, bert_score_from_embeddings, compute_bleu,
        compute_metrics,
    )

    require("light" in LIGHT_RESULTS, "phase 3c's light results are missing")
    d = os.path.join(tmp, "scores")
    os.makedirs(d)
    sets = {"light": LIGHT_RESULTS["light"], "serve_medusa": served}
    for name, res in sets.items():
        with open(os.path.join(d, f"generation_{name}_0.json"), "w") as f:
            json.dump(res, f)
    t0 = time.perf_counter()
    scores = {}
    for name in sets:
        with contextlib.redirect_stdout(io.StringIO()):
            scores[name] = benchmark.main(["--results_dir", d, "--identifier",
                                           name])
    wall = time.perf_counter() - t0
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("sacrebleu", "rouge_score"))
    require(not loaded, f"scoring imported {loaded}")
    for name, m in scores.items():
        vals = [m["exact_match"], m["bleu2"]["bleu"], m["bleu4"]["bleu"],
                *m["rouge"].values()]
        require(all(0.0 <= v <= 1.0 for v in vals), f"{name} scores {m}")
    refs = [r["true"] for res in sets.values() for r in res.values()]
    same = compute_metrics(refs, refs)
    long = [r for r in refs if len(_tokenize_13a(r)) >= 4]
    require(same["exact_match"] == 1.0
            and all(v == 1.0 for v in same["rouge"].values())
            and long and all(compute_bleu(long, long, n)["bleu"] == 1.0
                             for n in (2, 4)),
            f"references against themselves: {same}")
    rng = np.random.default_rng(26)
    pe = [rng.standard_normal((n, 32)) for n in (5, 3, 7)]
    re_ = [rng.standard_normal((n, 32)) for n in (4, 6, 2)]
    wp = [rng.random(len(x)) for x in pe]
    wr = [rng.random(len(x)) for x in re_]
    got = bert_score_from_embeddings(pe, re_, wp, wr)
    ps, rs = [], []
    for a, b, u, v in zip(pe, re_, wp, wr):
        cos = [[float(x @ y) / float(np.linalg.norm(x) * np.linalg.norm(y))
                for y in b] for x in a]
        ps.append(sum(w * max(row) for w, row in zip(u, cos)) / sum(u))
        rs.append(sum(w * max(col) for w, col in zip(v, zip(*cos))) / sum(v))
    fs = [2 * p * r / (p + r) for p, r in zip(ps, rs)]
    want = {"precision": sum(ps) / 3, "recall": sum(rs) / 3,
            "f1": sum(fs) / 3}
    require(all(abs(got[k] - want[k]) <= 1e-12 for k in want),
            f"BERTScore {got} != the direct formula's {want}")
    log(f"scoring [{card}]: light (phase 3c main) bleu4 "
        f"{scores['light']['bleu4']['bleu']:.4f}, rougeL "
        f"{scores['light']['rouge']['rougeL']:.4f}; serve_medusa bleu4 "
        f"{scores['serve_medusa']['bleu4']['bleu']:.4f}, rougeL "
        f"{scores['serve_medusa']['rouge']['rougeL']:.4f}; {wall:.3f} s, "
        f"no sacrebleu or rouge_score imported; {len(refs)} references "
        f"against themselves 1.0 (BLEU over the {len(long)} of >= 4 "
        f"tokens); BERTScore on random embeddings = the direct formula")


def quant_launches(eng, cfg, batches) -> int:
    """K10 (int4) or K14 (int8) launches of one serving run, from the
    engine's counters: bf16 towers send every projection of a quantized
    leaf to the kernel at every row count (`models/transformer.py linear`),
    so 7 stacked projections per layer and 1 head per decoder dispatch (a
    plain step at B rows, a verify round at B·G rows) and per install (its
    prefill of R × a bucket rows, the head on its last position), the 7·L
    projections of the shared prefix's prefill, and the protein encoder's
    4 projections per layer for every batch."""
    L = cfg.llm_config.num_layers
    dispatches = eng.plain_steps + eng.verify_rounds
    n = (dispatches + sum(eng.installs.values())) * (7 * L + 1)
    if eng.prefix_cols > 0:
        n += 7 * L
    return n + len(batches) * 4 * cfg.esm_config.n_layers


def run_serve_quant(torch, dev, card):
    """Phase 4d: weight-quantized serving, ESMC-600M + adapter + Qwen3-14B
    with both towers quantized by `build_server` (bf16 → int4 nibble planes
    or int8), through the CLI's loop, with exact launch counts: (e) int4 +
    int8 pool, the CLI's defaults, 16 × 128 (K10, K9b); (g) int4 + int8
    pool + γ 4, 8 × 32 (K10 at 40 rows, K9c); a short profiled int4 run;
    then (f) int8 weights on the bf16 pool, the 16 requests of (e) (K14,
    K9a).  Each model's build peak and each run's serving peak are read
    after a reset."""
    from prot2text_tpu_torch.cli.serve import build_server, refuse_unported
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer
    from prot2text_tpu_torch.models.quant import quantized_bytes
    from prot2text_tpu_torch.models.weights import tree_leaves

    tok = ByteTextTokenizer()
    batches = serve_batches(serve_args(), tok, 16, seed=5)
    args_s = serve_args("--max_new_tokens", "32")
    paths = {}
    for dtype in ("int4", "int8"):
        args = serve_args("--model_dtype", dtype)
        refuse_unported(args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cfg, params = build_server(args, tok, dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        L = cfg.llm_config.num_layers
        require(params["llm_decoder"]["embed_tokens"].dtype == torch.bfloat16
                and params["esm_encoder"]["embed"].dtype == torch.bfloat16,
                "the launch formula assumes bf16 towers (an f32 x above "
                "256 rows takes the dequantized weight)")
        n_params = sum(t.numel() for t in tree_leaves(params))
        log(f"serve model ESMC-600M + adapter + Qwen3-14B --model_dtype "
            f"{dtype}: {n_params / 1e9:.3f} B stored values; towers "
            f"{quantized_bytes(params['esm_encoder']) / 2**30:.3f} GiB "
            f"(ESMC) + {quantized_bytes(params['llm_decoder']) / 2**30:.3f} "
            f"GiB (Qwen3), adapter "
            f"{quantized_bytes(params['adapter']) / 2**30:.3f} GiB; built "
            f"(bf16, then quantized) in {build_s:.1f} s, build peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        kid = "K10" if dtype == "int4" else "K14"

        def once(label, path, flags, batches_, want_fn):
            args_ = serve_args("--model_dtype", dtype, *flags)
            run, counts = serve_once(torch, args_, tok, cfg, params,
                                     batches_, dev, label, card)
            eng = run.engine
            want = want_fn(eng)
            want[kid] = quant_launches(eng, cfg, batches_)
            require(counts == want, f"{path}: launch counts {counts} != "
                    f"expected {want}")
            paths[path] = counts
            stats = (eng.plain_steps, eng.verify_rounds)
            del run, eng
            gc.collect()
            return stats

        if dtype == "int4":
            plain, rounds = once(
                "int4 weights + int8 pool, shared prefix + dedup, 16 x 128 "
                "tokens", "serve_int4_kv8", ("--kv_bits", "8"), batches,
                lambda e: expect(K1=L * (1 + e.installs["full"]),
                                 K6=L * e.installs["prefix"],
                                 K9b=L * e.plain_steps))
            require(plain > 0 and rounds == 0, f"run e: {plain} steps")
            plain, rounds = once(
                "int4 weights + int8 pool + prompt lookup 4, 8 x 32 tokens",
                "serve_int4_kv8_spec", ("--kv_bits", "8",
                                        "--prompt_lookup_tokens", "4",
                                        "--max_new_tokens", "32"),
                serve_batches(args_s, tok, 8, 6),
                lambda e: expect(K1=L * (1 + e.installs["full"]),
                                 K6=L * e.installs["prefix"],
                                 K9c=L * e.verify_rounds))
            require(plain == 0 and rounds > 0, f"run g: {rounds} rounds")
            _, ragged = serve_quant_profile(torch, tok, cfg, params, dev,
                                            card)
            require(not ragged, f"the ragged route ran on the int4 serving "
                    f"path: {ragged}")
        else:
            plain, rounds = once(
                "int8 weights, bf16 pool, shared prefix + dedup, 16 x 128 "
                "tokens", "serve_int8_weights", (), batches,
                lambda e: expect(K1=L * (1 + e.installs["full"]),
                                 K6=L * e.installs["prefix"],
                                 K9a=L * e.plain_steps))
            require(plain > 0 and rounds == 0, f"run f: {plain} steps")
        del cfg, params
        gc.collect()
        torch.cuda.empty_cache()
    return paths


def serve_quant_profile(torch, tok, cfg, params, dev, card):
    """A short profiled run of int4 towers on the int8 pool (8 x 12 tokens)
    through the CLI's loop: the window's device time by kernel family, the
    quantized matmuls by body (`SERVE_FAMILIES`).  Returns the breakdown
    and the names of the ragged route's kernels that ran (none should: no
    model projection takes it)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    args_p = serve_args("--model_dtype", "int4", "--kv_bits", "8",
                        "--max_new_tokens", "12")
    batches_p = serve_batches(args_p, tok, 8, 7)
    with torch.profiler.profile(activities=acts) as prof:
        run_p, _ = serve_once(torch, args_p, tok, cfg, params, batches_p,
                              dev, "profiled int4 + int8 pool, 8 x 12", card)
    text = kernel_breakdown(torch, prof, run_p.seconds, SERVE_FAMILIES)
    log(text + f" [{card}]")
    ragged = sorted({e.name for e in events_of(prof)
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and re.search(RAGGED_QUANT, e.name)})
    del run_p, prof
    return text, ragged


def serve_quant_window(torch, dev, card):
    """`serve_quant_profile` on a fresh int4 server (the CLI's defaults,
    int4 towers): the profiled window alone, for an A/B of two trees'
    packages (run this file's function with the other tree first on
    `sys.path`).  Returns the breakdown and the ragged route's kernels
    seen."""
    from prot2text_tpu_torch.cli.serve import build_server
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer

    tok = ByteTextTokenizer()
    cfg, params = build_server(serve_args("--model_dtype", "int4"), tok, dev)
    out = serve_quant_profile(torch, tok, cfg, params, dev, card)
    del cfg, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_serve_plumbing(torch, dev):
    """A tiny f32 serving engine on cuda (K1, K4, K6, K9a) and on cpu (plain
    versions) from the same weights: the shared prefix's KV and one prefix
    install's logits within 1e-4; every request's greedy tokens identical,
    with the shared prefix (dedup, a pool mixing prefix and full-prompt
    requests) and without it."""
    from prot2text_tpu_torch.infer import serving
    from prot2text_tpu_torch.models.qwen3 import Qwen3Config, init_qwen3_params
    from prot2text_tpu_torch.models.weights import tree_map

    import numpy as np

    qwen = Qwen3Config(vocab_size=300, hidden_size=128, num_layers=2,
                       num_heads=10, num_kv_heads=2, head_dim=64,
                       intermediate_size=256)
    cfg = qwen.core()
    params = init_qwen3_params(
        qwen, generator=torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(8)
    prefix = rng.standard_normal((21, 128)).astype(np.float32)
    reqs = [(f"r{i}", rng.standard_normal((int(n), 128)).astype(np.float32),
             int(m)) for i, (n, m) in enumerate(((5, 9), (17, 6), (30, 12),
                                                 (3, 7), (11, 8)))]

    def engine(d, prefix_embeds, **kw):
        return serving.ContinuousBatcher(
            cfg, tree_map(lambda t: t.to(d), params), max_slots=3,
            max_len=64 + 12, prompt_pad=(32, 64), eos_token_id=-1,
            cache_dtype=torch.float32, sync_every=4,
            shared_prefix_embeds=prefix_embeds,
            prefix_dedup=prefix_embeds is not None, **kw)

    def serve_all(d, **kw):
        """Every request's greedy tokens, with the shared prefix (dedup,
        one full-prompt request in the pool) and without it."""
        out = {}
        for pfx in (prefix, None):
            eng = engine(d, pfx, **kw)
            for i, (rid, e, m) in enumerate(reqs):
                full = pfx is not None and i == 2     # a full-prompt row
                eng.submit(rid, np.concatenate([pfx, e]) if full else e,
                           max_new_tokens=m,
                           use_prefix=False if full else None)
            out[pfx is not None] = dict(eng.run())
        return out

    logits, pkv, toks = [], [], []
    for d in (torch.device("cpu"), dev):
        eng = engine(d, prefix)
        pkv.append({k: v.cpu() for k, v in eng.prefix_kv.items()})
        emb = torch.zeros((2, 32, 128), device=d)
        mask = torch.zeros((2, 32), dtype=torch.int32, device=d)
        for i, (_, e, _) in enumerate(reqs[:2]):
            emb[i, 32 - len(e):] = torch.from_numpy(e).to(d)
            mask[i, 32 - len(e):] = 1
        idx = torch.tensor([0, 1], device=d)
        _, lg = serving._prefill_install_pool(
            cfg, eng.state, eng.params, emb, mask, idx,
            torch.tensor([len(reqs[0][1]), len(reqs[1][1])], device=d),
            torch.tensor([9, 6], device=d), eng.generator, eng.prefix_kv,
            eos_token_id=-1, prefix_cols=eng.prefix_cols,
            prefix_len=eng.prefix_len, dedup=True, layers=eng.layers)
        logits.append(lg.cpu())
        toks.append(serve_all(d))
    for k in ("k", "v"):
        torch.testing.assert_close(pkv[1][k], pkv[0][k], atol=1e-4, rtol=0)
    err = (logits[1] - logits[0]).abs().max().item()
    torch.testing.assert_close(logits[1], logits[0], atol=1e-4, rtol=0.0)
    require(toks[1] == toks[0], f"serving tokens cuda {toks[1]} != cpu "
            f"{toks[0]}")
    log(f"plumbing f32 serving cuda vs cpu: prefix install logits max abs "
        f"diff {err:.3e} (atol 1e-4), prefix KV within 1e-4, greedy tokens "
        f"of {len(reqs)} requests identical with and without the shared "
        f"prefix")

    # prompt-lookup speculation on the (f32) bf16-kind pool: the verify
    # rounds go through K6 on the card; tokens identical across devices
    # and to plain serving (speculation is an exact shortcut in f32)
    spec = [serve_all(d, prompt_lookup_tokens=3)
            for d in (torch.device("cpu"), dev)]
    require(spec[1] == spec[0], f"speculative serving tokens cuda "
            f"{spec[1]} != cpu {spec[0]}")
    require(spec[0] == toks[0], "speculative serving changed the greedy "
            "tokens")
    log(f"plumbing f32 speculative serving (γ 3) cuda vs cpu: greedy tokens "
        f"of {len(reqs)} requests identical, and equal to plain serving")

    # the int8 pool computes in bf16: one decode step's (K7 on the card)
    # and one verify round's (K8) logits over the same installed state.
    # Tolerance 5e-2 of the largest logit: bf16 keeps 8 significant bits
    # (2^-8 relative per rounding) and the devices round ~a dozen bf16
    # products per layer at other points; an int8 value may also sit one
    # level apart where its fp32 pre-image lies at a half-integer.  Token
    # equality is not asserted: bf16 argmax near a tie is arbitrary
    got = []
    for d in (torch.device("cpu"), dev):
        eng = engine(d, None, kv_bits=8, prompt_lookup_tokens=3)
        require(eng._spec_fused, "the int8 plumbing engine must verify "
                "through the fused chunk kernel")
        for rid, e, m in reqs[:3]:
            eng.submit(rid, e, max_new_tokens=m)
        list(eng._fill_free_slots())
        got.append([t.float().cpu() for t in int8_round_logits(torch, eng)]
                   + [eng.state["last_tok"].cpu()])
    require(torch.equal(got[1][2], got[0][2]), "int8 installs drew other "
            "first tokens on cuda and cpu")
    for i, name in enumerate(("decode step", "verify round")):
        a, b = got[1][i], got[0][i]
        err, top = (a - b).abs().max().item(), b.abs().max().item()
        require(bool(torch.isfinite(a).all()) and err <= 5e-2 * top,
                f"int8 {name} logits cuda vs cpu: max|diff| {err} > 5e-2 "
                f"x max|logit| {top}")
        log(f"plumbing int8 pool {name} logits cuda vs cpu: max abs diff "
            f"{err:.3e} (<= 5e-2 x max|logit| {top:.3e})")


def run_medusa_plumbing(torch, dev):
    """A tiny decoder with nonzero random Medusa heads (K 3) serving on
    `dev` (kernels) and on the CPU (plain versions): on the f32 pool (K1
    installs, K6 verify rounds; the plain engine K4) and on the int8 pool
    (K8 verify rounds; the plain engine K7), every request's tokens
    identical on both devices and equal to the plain engine's greedy
    tokens on each.  The int8 pool computes in bf16, so it serves a
    decisive decoder (the embeddings 20 times larger, the head mapping
    each token to a successor) over prompts of token embeddings."""
    import numpy as np

    from prot2text_tpu_torch.infer.serving import ContinuousBatcher
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts
    from prot2text_tpu_torch.models.decoder import (
        DecoderConfig, init_decoder_params,
    )
    from prot2text_tpu_torch.models.medusa import (
        MedusaConfig, init_medusa_params,
    )
    from prot2text_tpu_torch.models.weights import tree_map

    cpu, V, H = torch.device("cpu"), 300, 128
    cfg = DecoderConfig(vocab_size=V, hidden_size=H, num_layers=2,
                        num_heads=4, num_kv_heads=2, head_dim=64,
                        intermediate_size=256, rope_theta=1e4)
    g = torch.Generator().manual_seed(26)
    rand = init_decoder_params(cfg, generator=g, device=cpu)
    E = rand["embed_tokens"]
    head = torch.zeros((H, V))
    head[:, torch.randperm(V, generator=g)] = E.T * 20.0
    succ = dict(rand, embed_tokens=E * 20.0, lm_head={"kernel": head})
    heads = init_medusa_params(MedusaConfig(H, 3), g, scale=0.05)
    heads["b"] = 0.05 * torch.randn(3, H, generator=g)
    rng = np.random.default_rng(26)
    lens = ((5, 12), (17, 9), (30, 14), (3, 10), (11, 8))
    for label, params, kw in (("f32", rand, {}), ("int8", succ,
                                                  {"kv_bits": 8})):
        reqs = [(f"r{i}", (succ["embed_tokens"][rng.integers(0, V, n)]
                           .numpy() if kw else rng.standard_normal(
                               (n, H)).astype(np.float32)), m)
                for i, (n, m) in enumerate(lens)]
        toks = []
        for d in (cpu, dev):
            def serve(**more):
                eng = ContinuousBatcher(
                    cfg, tree_map(lambda t: t.to(d), params), max_slots=3,
                    max_len=32 + 16, prompt_pad=32, eos_token_id=-1,
                    cache_dtype=torch.float32, sync_every=4, **kw, **more)
                for rid, e, m in reqs:
                    eng.submit(rid, e, max_new_tokens=m)
                return dict(eng.run()), eng

            reset_launch_counts()
            got, eng = serve(medusa_params=tree_map(lambda t: t.to(d),
                                                    heads))
            counts = {k: v for k, v in launch_counts().items() if v}
            plain, _ = serve()
            require(got == plain, f"medusa plumbing {label} on {d}: tokens "
                    f"differ from plain greedy")
            require(eng.verify_rounds > 0 and eng.plain_steps == 0
                    and eng._spec_fused == bool(kw),
                    f"medusa plumbing {label}: {eng.verify_rounds} rounds, "
                    f"{eng.plain_steps} plain steps, fused "
                    f"{eng._spec_fused}")
            toks.append(got)
        require(toks[1] == toks[0], f"medusa plumbing {label}: cuda tokens "
                f"{toks[1]} != cpu {toks[0]}")
        log(f"medusa plumbing {label} pool cuda vs cpu: tokens of "
            f"{len(reqs)} requests identical and equal to plain greedy; "
            f"acceptance {eng.acceptance():.3f} on {d}; Medusa launches "
            f"{counts}")


def int8_round_logits(torch, eng):
    """One decode step's and one verify round's logits over copies of an
    int8 engine's pool, computed as `_decode_all` and `_spec_rounds` do
    (bf16 activations; the verify is the fused chunk kernel's path)."""
    from prot2text_tpu_torch.infer.serving import (
        FUSED_SCRATCH, POOL_LAYOUT, ngram_drafts,
    )
    from prot2text_tpu_torch.models.decoder import (
        decoder_decode_step, decoder_logits, decoder_verify_chunk,
    )

    st, cfg, p = eng.state, eng.cfg, eng.params
    T = st["kv_mask"].shape[1]

    def pool():
        return {k: st[k].clone() for k in ("k", "v", "k_scale", "v_scale")}

    emb = p["embed_tokens"][st["last_tok"]][:, None].to(torch.bfloat16)
    h, _ = decoder_decode_step(
        cfg, p, token_embeds=emb, kv_mask=st["kv_mask"],
        positions=(st["pos"] + 1)[:, None], kv_cache=pool(),
        cache_index=torch.where(st["active"], st["next_slot"], T - 1),
        layers=eng.layers, layout=POOL_LAYOUT)
    step = decoder_logits(cfg, p, h)[:, 0]
    drafts = ngram_drafts(st["hist"], st["hist_len"], gamma=eng.spec_gamma,
                          ngram=eng.spec_ngram)
    chunk = torch.cat([st["last_tok"][:, None], drafts], dim=1)
    pos = (st["pos"] + 1)[:, None] + torch.arange(chunk.shape[1],
                                                  device=chunk.device)
    h, _ = decoder_verify_chunk(
        cfg, p, token_embeds=p["embed_tokens"][chunk].to(torch.bfloat16),
        kv_mask=st["kv_mask"], positions=pos, kv_cache=pool(),
        cache_index=torch.where(st["active"], st["next_slot"],
                                T - FUSED_SCRATCH), layers=eng.layers)
    return step, decoder_logits(cfg, p, h)


def run_serve_quant_plumbing(torch, dev):
    """Tiny f32 serving engines (γ 3 on the f32 pool) with int4 weights in
    each format (nibble planes, split-half bytes, bf16-pair words) and int8
    weights on cuda (K10/K11a/K11b/K14, K4, K6, K1) and on cpu (plain
    versions) from the same quantized weights.  On the random decoder, whose residual stream the
    projections carry (embeddings of std 0.02), one decode step's and one
    verify round's last hidden states and logits agree within 5e-3 of their
    largest |value|: both devices round x to bf16 at each projection, so an
    fp32 activation that the two compute 1e-7 apart on a bf16 rounding tie
    enters one projection one bf16 ulp (2^-8 relative) apart, which moves a
    K = 128 product by ~2^-8/sqrt(128) of its size, while one wrong scale
    column moves its outputs by their own size.  Then the successor model of
    tests/test_torch_serving_quant.py (embeddings scaled 20-fold, the head
    maps each token to its successor: decisive greedy steps) serves every
    request's greedy tokens identically on both devices, plain and
    speculative."""
    from prot2text_tpu_torch.infer import serving
    from prot2text_tpu_torch.models.qwen3 import Qwen3Config, init_qwen3_params
    from prot2text_tpu_torch.models.quant import quantize_params
    from prot2text_tpu_torch.models.weights import tree_map

    import numpy as np

    qwen = Qwen3Config(vocab_size=300, hidden_size=128, num_layers=2,
                       num_heads=10, num_kv_heads=2, head_dim=64,
                       intermediate_size=256)
    cfg = qwen.core()
    g = torch.Generator().manual_seed(4)
    rand = init_qwen3_params(qwen, generator=g, device="cpu")
    succ = dict(rand)
    E = rand["embed_tokens"]
    head = torch.zeros((128, 300))
    head[:, torch.randperm(300, generator=g)] = E.T * 20.0
    succ["lm_head"] = {"kernel": head}
    succ["embed_tokens"] = E * 20.0

    def requests(params):
        rng = np.random.default_rng(9)
        return [(f"r{i}", params["embed_tokens"][torch.from_numpy(
            rng.integers(0, 300, int(n)))].numpy(), int(m))
            for i, (n, m) in enumerate(((5, 9), (17, 6), (30, 12), (3, 7)))]

    for label, kw in (("int4", dict(bits=4)),
                      ("int4 bytes", dict(bits=4, int4_format="bytes")),
                      ("int4 pairs", dict(bits=4, int4_format="pairs")),
                      ("int8", dict(bits=8))):
        params = {name: quantize_params(p, **kw)
                  for name, p in (("rand", rand), ("succ", succ))}
        rounds, toks = [], []
        for d in (torch.device("cpu"), dev):
            def engine(name, gamma):
                return serving.ContinuousBatcher(
                    cfg, tree_map(lambda t: t.to(d), params[name]),
                    max_slots=3, max_len=64 + 12, prompt_pad=(32, 64),
                    eos_token_id=-1, cache_dtype=torch.float32, sync_every=4,
                    prompt_lookup_tokens=gamma)

            eng = engine("rand", 3)
            for rid, e, m in requests(rand)[:3]:
                eng.submit(rid, e, max_new_tokens=m)
            list(eng._fill_free_slots())
            rounds.append([t.cpu() for t in f32_round_logits(torch, eng)])
            out = []
            for gamma in (0, 3):
                eng = engine("succ", gamma)
                for rid, e, m in requests(succ):
                    eng.submit(rid, e, max_new_tokens=m)
                out.append(dict(eng.run()))
            toks.append(out)
        for i, name in enumerate(("decode step hidden", "decode step logits",
                                  "verify round hidden",
                                  "verify round logits")):
            a, b = rounds[1][i], rounds[0][i]
            err, top = (a - b).abs().max().item(), b.abs().max().item()
            require(bool(torch.isfinite(a).all()) and err <= 5e-3 * top,
                    f"{label} {name} cuda vs cpu: max|diff| {err} "
                    f"> 5e-3 x max|value| {top}")
            log(f"plumbing f32 {label} weights {name} cuda vs cpu: max abs "
                f"diff {err:.3e} = {err / top:.3e} of max|value| {top:.3e} "
                f"(<= 5e-3)")
        require(toks[1] == toks[0], f"{label} serving tokens cuda "
                f"{toks[1]} != cpu {toks[0]}")
        require(toks[0][0] == toks[0][1], f"{label}: speculation changed "
                "the greedy tokens")
        log(f"plumbing f32 {label} weights serving cuda vs cpu: greedy "
            f"tokens of 4 requests identical, plain and γ 3")


def f32_round_logits(torch, eng):
    """One decode step's and one verify round's last hidden states and
    logits, (h, logits, h, logits), over copies of an f32 engine's pool,
    computed as `_decode_all` and `_spec_rounds` do on a float pool (the
    verify: `decoder_forward` with a bias over the pool)."""
    from prot2text_tpu_torch.infer.serving import (
        NEG, POOL_LAYOUT, ngram_drafts,
    )
    from prot2text_tpu_torch.models.decoder import (
        decoder_decode_step, decoder_forward, decoder_logits,
    )

    st, cfg, p = eng.state, eng.cfg, eng.params
    T = st["kv_mask"].shape[1]

    def pool():
        return {k: st[k].clone() for k in ("k", "v")}

    emb = p["embed_tokens"][st["last_tok"]][:, None]
    h, _ = decoder_decode_step(
        cfg, p, token_embeds=emb, kv_mask=st["kv_mask"],
        positions=(st["pos"] + 1)[:, None], kv_cache=pool(),
        cache_index=torch.where(st["active"], st["next_slot"], T - 1),
        layers=eng.layers, layout=POOL_LAYOUT)
    h_step, step = h[:, 0], decoder_logits(cfg, p, h)[:, 0]
    drafts = ngram_drafts(st["hist"], st["hist_len"], gamma=eng.spec_gamma,
                          ngram=eng.spec_ngram)
    chunk = torch.cat([st["last_tok"][:, None], drafts], dim=1)
    G = chunk.shape[1]
    cols = torch.arange(T, device=chunk.device)
    start = torch.where(st["active"], st["next_slot"], T - G)
    pos = (st["pos"] + 1)[:, None] + torch.arange(G, device=chunk.device)
    st_ = start[:, None, None, None]
    rows = torch.arange(G, device=chunk.device)[None, None, :, None]
    ok = ((st["kv_mask"][:, None, None, :] > 0)
          | ((cols >= st_) & (cols <= st_ + rows)))
    h, _ = decoder_forward(
        cfg, p, inputs_embeds=p["embed_tokens"][chunk], positions=pos,
        bias=torch.where(ok, 0.0, NEG), kv_cache=pool(), cache_index=start,
        layers=eng.layers, layout=POOL_LAYOUT)
    return h_step, step, h, decoder_logits(cfg, p, h)


# ---------------------------------------------------------------------------
# phase 5: the same tiny f32 models on cuda (kernels) and cpu (plain)


def run_plumbing(torch, dev):
    """Tiny f32 generation on `dev` against the CPU: prefill and first
    decode-step logits within 1e-4, at head dim 64 (the tbkd cache) and 128
    (the bktd cache), K4's f32 body a layer at either layout's strides, its
    launches counted."""
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts
    from prot2text_tpu_torch.models import ESM2Config, LlamaConfig

    tok = ByteTextTokenizer()
    esm_cfg = ESM2Config(hidden_size=64, num_layers=2, num_heads=4,
                         intermediate_size=128)
    cpu = torch.device("cpu")
    for hidden, layout in ((256, "tbkd"), (512, "bktd")):
        llama_cfg = LlamaConfig(vocab_size=tok.vocab_size, hidden_size=hidden,
                                num_layers=2, num_heads=4, num_kv_heads=2,
                                intermediate_size=512, rope_theta=1e4,
                                tie_word_embeddings=False, rope_scaling=None)
        model = build_model(torch, cpu, tok, esm_cfg, llama_cfg,
                            torch.float32, seed=1)
        batch = make_batch(torch, cpu, tok, 2, (20, 60), seed=1)
        _, st_cpu = generate(torch, model, batch, 2)
        model.to(dev)
        reset_launch_counts()
        _, st_gpu = generate(torch, model, {k: v.to(dev) for k, v in
                                            batch.items()}, 2)
        k4 = launch_counts()["K4"]
        want = (2 * st_gpu["steps"] if dev.type == "cuda"
                else 0)                            # plain versions count 0
        require(k4 == want, f"plumbing D {hidden // 4}: K4 launched {k4} "
                f"times, expected {want}")
        for i, name in enumerate(("prefill", "first decode step")):
            a, b = st_gpu["logits"][i].cpu(), st_cpu["logits"][i]
            err = (a - b).abs().max().item()
            torch.testing.assert_close(a, b, atol=1e-4, rtol=0.0)
            log(f"plumbing f32 cuda vs cpu, D {hidden // 4} ({layout}, K4 "
                f"{k4}x), {name} logits: max abs diff {err:.3e} (atol 1e-4)")


def run_decoding_plumbing(torch, dev):
    """Phase 3d's strategies on tiny f32 decoders on `dev` (kernels) against
    the same on the CPU (plain versions), at head dims 64 (the tbkd cache)
    and 128 (bktd), 12 tokens: prompt lookup (γ 3, the prompt ids those of
    plain greedy, so drafts are accepted) on the f32 and the int8 cache,
    the self-draft (1 of 2 layers) and a one-layer draft model, beams (K 3)
    with and without early_stopping (an EOS that fires).  Every run's
    tokens are identical on the two devices, and each speculative run's
    those of plain greedy generation on its device (over the int8 cache,
    of plain int8 generation).  The int8 runs take a decisive decoder (the
    embeddings 20 times larger, the head mapping each token to a
    successor): int8 rounding may land one level apart on the two devices,
    which would flip a near-tied argmax."""
    from prot2text_tpu_torch.infer.beam_search import beam_search
    from prot2text_tpu_torch.infer.generate import GenerationConfig
    from prot2text_tpu_torch.infer.generate import generate as plain
    from prot2text_tpu_torch.infer.speculative import (
        prompt_lookup_generate, self_speculative_generate,
        speculative_generate,
    )
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts
    from prot2text_tpu_torch.models.decoder import (
        DecoderConfig, init_decoder_params,
    )
    from prot2text_tpu_torch.models.weights import tree_map

    cpu, V, H = torch.device("cpu"), 300, 128
    for D in (64, 128):
        cfg = DecoderConfig(vocab_size=V, hidden_size=H, num_layers=2,
                            num_heads=4, num_kv_heads=2, head_dim=D,
                            intermediate_size=256, rope_theta=1e4)
        dcfg = DecoderConfig(vocab_size=V, hidden_size=64, num_layers=1,
                             num_heads=2, num_kv_heads=1, head_dim=D,
                             intermediate_size=128, rope_theta=1e4)
        g = torch.Generator().manual_seed(D)
        rand = init_decoder_params(cfg, generator=g, device=cpu)
        draft = init_decoder_params(dcfg, generator=g, device=cpu)
        E = rand["embed_tokens"]
        head = torch.zeros((H, V))
        head[:, torch.randperm(V, generator=g)] = E.T * 20.0
        succ = dict(rand, embed_tokens=E * 20.0, lm_head={"kernel": head})
        emb = torch.randn(2, 7, H, generator=g)
        demb = torch.randn(2, 7, 64, generator=g)
        semb = succ["embed_tokens"][torch.randint(0, V, (2, 7), generator=g)]
        mask = torch.ones(2, 7, dtype=torch.int64)
        mask[0, :3] = 0
        gen_cfg = GenerationConfig(max_new_tokens=12, eos_token_id=-1,
                                   pad_token_id=0)

        def runs(device, eos):
            to = (lambda t: tree_map(lambda x: x.to(device), t))
            p, sp, dp = to(rand), to(succ), to(draft)
            kw = dict(inputs_embeds=emb.to(device),
                      attention_mask=mask.to(device), gen_cfg=gen_cfg)
            skw = dict(kw, inputs_embeds=semb.to(device))
            out = {"plain": plain(cfg, p, **kw)}
            out["lookup"] = prompt_lookup_generate(
                cfg, p, prompt_ids=out["plain"], gamma=3, **kw)[0]
            out["self-draft"] = self_speculative_generate(
                cfg, p, draft_layers=1, gamma=3, **kw)[0]
            out["draft model"] = speculative_generate(
                cfg, p, dcfg, dp, draft_inputs_embeds=demb.to(device),
                gamma=3, **kw)[0]
            out["plain int8"] = plain(cfg, sp, kv_bits=8, **skw)
            out["lookup int8"] = prompt_lookup_generate(
                cfg, sp, prompt_ids=out["plain int8"], kv_bits=8, gamma=3,
                **skw)[0]
            for name, early in (("beams", False), ("beams early", True)):
                out[name] = beam_search(cfg, p, **dict(
                    kw, gen_cfg=GenerationConfig(
                        max_new_tokens=12, eos_token_id=eos, pad_token_id=0,
                        num_beams=3, early_stopping=early)))
            return {k: v.cpu() for k, v in out.items()}

        eos = int(plain(cfg, rand, inputs_embeds=emb, attention_mask=mask,
                        gen_cfg=gen_cfg)[0, 3])
        want = runs(cpu, eos)
        reset_launch_counts()
        got = runs(dev, eos)
        counts = {k: v for k, v in launch_counts().items() if v}
        for name in want:
            require(torch.equal(got[name], want[name]), f"decoding plumbing "
                    f"D {D} {name}: cuda tokens {got[name].tolist()} != cpu "
                    f"{want[name].tolist()}")
        for name, ref in (("lookup", "plain"), ("self-draft", "plain"),
                          ("draft model", "plain"),
                          ("lookup int8", "plain int8")):
            require(torch.equal(got[name], got[ref]), f"decoding plumbing D "
                    f"{D}: {name} tokens differ from {ref}'s")
        log(f"decoding plumbing f32 cuda vs cpu, D {D}: tokens identical "
            f"({', '.join(want)}), speculative = plain greedy; launches "
            f"{counts}")


def run_train_plumbing(torch, dev):
    """One SFT step of tiny f32 ESMC + Qwen3 (head_dim 64: K1/K5 at D=64 on
    the card) on cuda and on cpu from the same weights and batch: loss atol
    1e-4, LoRA/adapter gradients rtol 1e-3 of each leaf's largest entry.
    Adapter dropout 0: the two devices' generators give different masks."""
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer
    from prot2text_tpu_torch.data.collate import Buckets, LightCollator
    from prot2text_tpu_torch.cli.train_instruct import BUCKETS as TB
    from prot2text_tpu_torch.cli.train_instruct import to_device
    from prot2text_tpu_torch.models.adapters import (
        ModalityAdapterConfig, init_modality_adapter_params,
    )
    from prot2text_tpu_torch.models.esmc import ESMCConfig, init_esmc_params
    from prot2text_tpu_torch.models.lora import LoraConfig, init_lora_params
    from prot2text_tpu_torch.models.qwen3 import Qwen3Config, init_qwen3_params
    from prot2text_tpu_torch.models.weights import tree_leaves, tree_map
    from prot2text_tpu_torch.train.optim import TrainState, adamw_constant
    from prot2text_tpu_torch.train.sft import SFTConfig, make_sft_train_step

    tok = ByteTextTokenizer()
    esm_cfg = ESMCConfig.tiny()
    qwen = Qwen3Config(vocab_size=tok.vocab_size, hidden_size=128,
                       num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                       intermediate_size=256)
    ad_cfg = ModalityAdapterConfig(esm_cfg.d_model, 64, qwen.hidden_size,
                                   dropout_rate=0.0)
    lora = LoraConfig(r=8, alpha=16)
    g = torch.Generator().manual_seed(2)
    kw = dict(generator=g, device="cpu")
    frozen = {"esm_encoder": init_esmc_params(esm_cfg, **kw),
              "llm_decoder": init_qwen3_params(qwen, **kw)}
    trainable = {"lora_esm": init_lora_params(lora, frozen["esm_encoder"],
                                              generator=g),
                 "lora_llm": init_lora_params(lora, frozen["llm_decoder"],
                                              generator=g),
                 "adapter": init_modality_adapter_params(ad_cfg, **kw)}
    for b in _lora_b(trainable):          # non-zero B: A gets a gradient
        b.normal_(0.0, 0.05, generator=g)
    collate = LightCollator(tokenizer=tok, mode="train",
                            placeholder_token=tok.placeholder_token,
                            buckets=Buckets(**TB))
    host = collate(train_records(2, (30, 60), seed=3))
    step_kw = dict(esm_config=esm_cfg, adapter_config=ad_cfg,
                   decoder_core=qwen.core(),
                   cfg=SFTConfig(lora=lora, placeholder_id=tok.placeholder_id))
    for impl in ("auto", "flash"):
        out = []
        for d in (torch.device("cpu"), dev):
            params = tree_map(lambda t: t.to(d, copy=True).requires_grad_(),
                              trainable)
            fz = tree_map(lambda t: t.to(d), frozen)
            step = make_sft_train_step(tx=adamw_constant(1e-3),
                                       attn_impl=impl, **step_kw)
            _, loss = step(TrainState.create(params, adamw_constant(1e-3)),
                           fz, to_device(host, d, 1),
                           torch.Generator(device=d).manual_seed(0))
            out.append((loss.item(), [p.grad.cpu() for p in
                                      tree_leaves(params)]))
        _cuda_cpu_gate(f"SFT step --attn_impl {impl}", out)
    run_qlora_plumbing(torch, dev, frozen, trainable["adapter"], step_kw,
                       host)


# phase 5's bf16 QLoRA step, cuda against cpu: both sides run every
# product in bf16 (kernels and cuBLAS against the plain twins and the
# CPU's GEMMs), so they agree to bf16 rounding
QLORA_PLUMBING_LOSS = 1e-2       # |loss diff| / |loss|
QLORA_PLUMBING_GRAD = 5e-2       # each leaf's ||g_cuda - g_cpu|| / ||g_cpu||


def run_qlora_plumbing(torch, dev, frozen, adapter, step_kw, host):
    """One QLoRA SFT step of run_train_plumbing's tiny f32 ESMC + Qwen3,
    both towers quantized in each format (int8: K14; int4 planes, bytes,
    pairs: K10, K11a, K11b), on cuda and on cpu from the same weights, LoRA
    trees and batch.  f32 towers: every trained product takes the f32
    dequantized weight, no quantized kernel launches, and the SFT gates
    hold (loss atol 1e-4, gradients rtol 1e-3).  bf16 towers: the kernels
    forward and `_QuantLinear`'s backward, exact launch counts (every
    projection twice under remat, the head once), loss and gradients
    within bf16 gates."""
    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts
    from prot2text_tpu_torch.cli.train_instruct import to_device
    from prot2text_tpu_torch.models.lora import init_lora_params
    from prot2text_tpu_torch.models.quant import quantize_params
    from prot2text_tpu_torch.models.weights import tree_leaves, tree_map
    from prot2text_tpu_torch.train.optim import TrainState, adamw_constant
    from prot2text_tpu_torch.train.sft import make_sft_train_step

    cpu = torch.device("cpu")
    lora = step_kw["cfg"].lora
    L = step_kw["decoder_core"].num_layers
    L_esm = step_kw["esm_config"].n_layers
    launches = 2 * (7 * L + 4 * L_esm) + 1
    for fmt, bits, kid in (("int8", 8, "K14"), ("planes", 4, "K10"),
                           ("bytes", 4, "K11a"), ("pairs", 4, "K11b")):
        for dt in (torch.float32, torch.bfloat16):
            qfrozen = {k: quantize_params(tree_map(lambda t: t.to(dt), v),
                                          bits=bits, int4_format=fmt
                                          if bits == 4 else "planes")
                       for k, v in frozen.items()}
            g = torch.Generator().manual_seed(4)
            trainable = {"lora_esm": init_lora_params(
                             lora, qfrozen["esm_encoder"], generator=g),
                         "lora_llm": init_lora_params(
                             lora, qfrozen["llm_decoder"], generator=g),
                         "adapter": adapter}
            for b in _lora_b(trainable):
                b.normal_(0.0, 0.05, generator=g)
            out, n = [], 0
            for d in (cpu, dev):
                params = tree_map(
                    lambda t: t.to(d, copy=True).requires_grad_(), trainable)
                fz = tree_map(lambda t: t.to(d), qfrozen)
                step = make_sft_train_step(tx=adamw_constant(1e-3), **step_kw)
                reset_launch_counts()
                _, loss = step(TrainState.create(params, adamw_constant(1e-3)),
                               fz, to_device(host, d, 1),
                               torch.Generator(device=d).manual_seed(0))
                n = launch_counts()[kid]
                out.append((loss.item(), [p.grad.float().cpu() for p in
                                          tree_leaves(params)]))
            label = f"QLoRA SFT step, {fmt} towers in {str(dt)[6:]}"
            want = (launches if dev.type == "cuda" and dt == torch.bfloat16
                    else 0)
            require(n == want, f"{label}: {kid} launched {n} times, "
                    f"expected {want}")
            if dt == torch.float32:
                _cuda_cpu_gate(label, out)
                continue
            (l_cpu, g_cpu), (l_gpu, g_gpu) = out
            worst = max(((a - b).norm() / b.norm()).item()
                        for a, b in zip(g_gpu, g_cpu))
            log(f"plumbing {label} cuda vs cpu ({kid} {n}x): loss "
                f"{l_gpu:.6f} vs {l_cpu:.6f} (gate {QLORA_PLUMBING_LOSS} * "
                f"|loss|), worst of {len(g_cpu)} gradient leaves "
                f"||g_cuda - g_cpu|| / ||g_cpu|| = {worst:.3e} (gate "
                f"{QLORA_PLUMBING_GRAD})")
            require(abs(l_gpu - l_cpu) <= QLORA_PLUMBING_LOSS * abs(l_cpu),
                    f"{label}: loss cuda {l_gpu} vs cpu {l_cpu}")
            require(worst <= QLORA_PLUMBING_GRAD,
                    f"{label}: gradient rel. diff {worst}")


def _cuda_cpu_gate(label, out):
    """[(loss, grads) on cpu, (loss, grads) on cuda]: loss atol 1e-4,
    every gradient entry within 1e-3 of |grad| + 1e-3 of its leaf's max."""
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out
    require(abs(l_cpu - l_gpu) <= 1e-4,
            f"{label} loss cuda {l_gpu} vs cpu {l_cpu} (atol 1e-4)")
    worst = 0.0
    for a, b in zip(g_gpu, g_cpu):
        err = ((a - b).abs() / (b.abs() + b.abs().max() * 1e-3)).max().item()
        worst = max(worst, err)
    require(worst <= 1e-3,
            f"{label} grads cuda vs cpu: rel err {worst} > 1e-3")
    log(f"plumbing f32 {label} cuda vs cpu: loss {l_gpu:.6f} vs "
        f"{l_cpu:.6f} (atol 1e-4), {len(g_cpu)} gradients within rtol "
        f"{worst:.2e} (1e-3 of |grad| + 1e-3 of the leaf's max)")


def run_contrast_plumbing(torch, dev):
    """One contrastive step of tiny f32 ESMC + Qwen3 (head_dim 64: K1 at
    D=64; ESMC's D=16 through K6 under --attn_impl flash) on cuda and on
    cpu from the same weights and batch, at the SFT step's gates (loss
    atol 1e-4, adapter gradients rtol 1e-3).  Adapter dropout 0."""
    from prot2text_tpu_torch.cli import train_contrast as tcli
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer
    from prot2text_tpu_torch.data.collate import Buckets, LightCollator
    from prot2text_tpu_torch.models.adapters import (
        ModalityAdapterConfig, init_modality_adapter_params,
    )
    from prot2text_tpu_torch.models.esmc import ESMCConfig, init_esmc_params
    from prot2text_tpu_torch.models.qwen3 import Qwen3Config, init_qwen3_params
    from prot2text_tpu_torch.models.weights import tree_leaves, tree_map
    from prot2text_tpu_torch.train.contrastive import (
        ContrastiveConfig, make_contrastive_train_step,
    )
    from prot2text_tpu_torch.train.optim import TrainState, adamw_constant

    tok = ByteTextTokenizer()
    esm_cfg = ESMCConfig.tiny()
    qwen = Qwen3Config(vocab_size=tok.vocab_size, hidden_size=128,
                       num_layers=3, num_heads=4, num_kv_heads=2, head_dim=64,
                       intermediate_size=256)
    ad_cfg = ModalityAdapterConfig(esm_cfg.d_model, 64, qwen.hidden_size,
                                   dropout_rate=0.0)
    g = torch.Generator().manual_seed(4)
    kw = dict(generator=g, device="cpu")
    frozen = {"esm_encoder": init_esmc_params(esm_cfg, **kw),
              "llm_decoder": init_qwen3_params(qwen, **kw)}
    adapter = init_modality_adapter_params(ad_cfg, **kw)
    collate = LightCollator(tokenizer=tok, mode="train",
                            placeholder_token=tok.placeholder_token,
                            buckets=Buckets(**tcli.BUCKETS))
    host = collate(train_records(4, (30, 60), seed=5))
    step_kw = dict(esm_config=esm_cfg, adapter_config=ad_cfg,
                   decoder_core=qwen.core(),
                   cfg=ContrastiveConfig(output_llm_layer=2))
    out = []
    for d in (torch.device("cpu"), dev):
        params = tree_map(lambda t: t.to(d, copy=True).requires_grad_(),
                          adapter)
        fz = tree_map(lambda t: t.to(d), frozen)
        step = make_contrastive_train_step(tx=adamw_constant(1e-3),
                                           attn_impl="flash", **step_kw)
        _, loss = step(TrainState.create(params, adamw_constant(1e-3)), fz,
                       tcli.to_device(host, d, 1),
                       torch.Generator(device=d).manual_seed(0))
        out.append((loss.item(), [p.grad.cpu() for p in
                                  tree_leaves(params)]))
    _cuda_cpu_gate("contrastive step --attn_impl flash", out)


def run_legacy_plumbing(torch, dev):
    """A tiny f32 legacy model (ESM2 D 16, Llama D 64: the tbkd cache, K1
    and K4's f32 body at the tbkd strides on the card) on cuda against the
    same one on cpu: greedy
    generation's tokens identical and its prefill and first decode-step
    logits within 1e-4; one legacy train step's loss and gradients at the
    SFT step's gates (`_cuda_cpu_gate`)."""
    from prot2text_tpu_torch.cli.train_legacy import BUCKETS as TB
    from prot2text_tpu_torch.data.chat import ByteTextTokenizer
    from prot2text_tpu_torch.models import ESM2Config, LlamaConfig
    from prot2text_tpu_torch.models.composed import (
        Esm2LlamaConfig, Esm2LlamaForCausalLM, init_esm2llama_params,
    )
    from prot2text_tpu_torch.models.weights import tree_leaves, tree_map
    from prot2text_tpu_torch.train.legacy import make_legacy_train_step
    from prot2text_tpu_torch.train.optim import TrainState, step_lr

    tok = ByteTextTokenizer()
    cfg = Esm2LlamaConfig(
        ESM2Config(hidden_size=64, num_layers=2, num_heads=4,
                   intermediate_size=128),
        LlamaConfig(vocab_size=tok.vocab_size, hidden_size=256, num_layers=2,
                    num_heads=4, num_kv_heads=2, intermediate_size=512,
                    rope_theta=1e4, tie_word_embeddings=False,
                    rope_scaling=None),
        decoder_hidden_size=256, bos_token_id=tok.bos_token_id,
        eos_token_id=tok.eos_token_id)
    cpu = torch.device("cpu")
    params = init_esm2llama_params(cfg, generator=torch.Generator()
                                   .manual_seed(3), device=cpu)
    records = legacy_records(2, (20, 60), seed=41)
    out = []
    for d in (cpu, dev):
        model = Esm2LlamaForCausalLM(cfg, tree_map(lambda t: t.to(d),
                                                   params))
        batch = legacy_batch(torch, d, records, "inference",
                             dict(protein=[64]))
        out.append(generate(torch, model, batch, 3))
    (t_cpu, st_cpu), (t_gpu, st_gpu) = out
    require(torch.equal(t_gpu.cpu(), t_cpu),
            "legacy generation tokens differ between cuda and cpu")
    for i, name in enumerate(("prefill", "first decode step")):
        a, b = st_gpu["logits"][i].cpu(), st_cpu["logits"][i]
        err = (a - b).abs().max().item()
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0.0)
        log(f"plumbing f32 legacy generation cuda vs cpu, {name} logits: "
            f"max abs diff {err:.3e} (atol 1e-4); tokens identical")
    out = []
    for d in (cpu, dev):
        p = tree_map(lambda t: t.to(d, copy=True).requires_grad_(), params)
        tx = step_lr(1e-3, 0.1, 1)
        step = make_legacy_train_step(config=cfg, tx=tx)
        _, loss = step(TrainState.create(p, tx), legacy_batch(
            torch, d, records, "train", dict(TB, protein=[64])))
        out.append((loss.item(), [t.grad.cpu() for t in tree_leaves(p)]))
    _cuda_cpu_gate("legacy train step", out)


# ---------------------------------------------------------------------------
# phase 6: the port's probe scripts, the path of K15a-K15l

PROBES = ("bench_lmhead3", "bench_int4_unpack", "bench_int4_planes",
          "bench_int4_single", "bench_int8_mxu", "probe_int8_kv")
PROBE_REPS = 5       # CUDA-graph replays per variant (the scripts: 20)


def run_probes(torch, dev, card):
    """Phase 6: each of `prot2text_tpu_torch/scripts/` six probes through its
    `main()` on the card at its own shapes (only its replays cut), as
    `python -m prot2text_tpu_torch.scripts.<name>` runs it.  No row may
    read above 105% of its bound (bound / device time <= 1.05: a faster
    reading would be a weight read from L2, not HBM), every variant agrees
    with its plain version inside the script, and probe_int8_kv's five
    probes pass.
    Returns the launch counts of the whole run: every K15 kernel must be
    among them, beside K10, K11a and K14."""
    import importlib

    from prot2text_tpu_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    for name in PROBES:
        t0 = time.perf_counter()
        mod = importlib.import_module(f"prot2text_tpu_torch.scripts.{name}")
        out = mod.main(["--device", str(dev), "--reps", str(PROBE_REPS)])
        for r in out["rows"]:
            require(r["ms"] is not None and r["bound_ms"] <= 1.05 * r["ms"],
                    f"{name} {r['variant']}: {r['ms']} ms per call beats its "
                    f"bound {r['bound_ms']} ms by more than 5%")
        if name == "probe_int8_kv":
            require(out["ok"], "probe_int8_kv: a probe failed")
        best = max(out["rows"], key=lambda r: r["share"])
        log(f"probe {name}: {len(out['rows'])} rows in "
            f"{time.perf_counter() - t0:.1f} s, highest share of its bound "
            f"{best['share']:.1%} ({best['variant']}, {best['kernel']}) "
            f"[{card}]")
        del out
        gc.collect()
        torch.cuda.empty_cache()
    counts = launch_counts()
    missing = [k for k in counts if k.startswith("K15") and counts[k] == 0]
    require(not missing, f"the probes launched no {missing}")
    require(counts["K10"] > 0 and counts["K11a"] > 0 and counts["K14"] > 0,
            f"the probes' shipped baselines did not run: {counts}")
    log(f"launches in the probes' run: "
        f"{ {k: v for k, v in counts.items() if v} }")
    return counts


# the extra keys of the rows in the kernels line: K1's, K2's, K4's, K5's,
# K6's, K6b's and K9a's speed; the device times of the int8 attentions, the
# slot writes (K3, K12, K13), the int8-KV probes and their library calls
SPEED_KEYS = ("device_ms", "library_device_ms", "useful_tflops",
              "useful_tbps", "bound_share", "x_library", "x_library_device",
              "device_ms_profiler", "library_device_source", "other_shapes",
              "sources", "at_rows", "lockstep", "tbkd", "tbkd_rows") \
    + BUSY_KEYS


def count_routes(qm):
    """Tally the bodies `quant_matmul.route` picks (few, rows, ragged) while
    the model paths run: its wrapper in the module, which `_launch` calls.
    Returns the tally and the function that puts the rule back."""
    tally, rule = {}, qm.route

    def counted(*args, **kw):
        way = rule(*args, **kw)
        tally[way] = tally.get(way, 0) + 1
        return way

    qm.route = counted
    return tally, lambda: setattr(qm, "route", rule)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from prot2text_tpu_torch.core.device import resolve_device
    from prot2text_tpu_torch.kernels import KERNELS, OFF_PATH, _build

    t_start = time.time()
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

    k15f_kernel_names(torch, dev)
    k15k_kernel_names(torch, dev)
    rows = check_kernels(torch, dev, card)
    rows.update(check_tbkd_kernels(torch, dev, card))
    rows.update(check_serve_kernels(torch, dev, card))
    rows["K4"]["lockstep"] = rows.pop("K4 lockstep")
    rows["K4"]["tbkd"] = rows.pop("K4 tbkd")
    rows["K4"]["tbkd_rows"] = rows.pop("K4 tbkd rows")
    rows["K9a"]["tbkd"] = rows.pop("K9a tbkd")
    bwd_rows, k6_err, k6_esmc = check_bias_bwd_kernel(torch, dev, card)
    rows.update(bwd_rows)
    # the K6 row keeps the worst error over its serving and training shapes
    # and its times at the training shapes beside the serving shape's
    rows["K6"]["max_abs_err"] = max(rows["K6"]["max_abs_err"], k6_err)
    rows["K6"]["other_shapes"] = k6_esmc
    gc.collect()
    torch.cuda.empty_cache()
    rows.update(check_int8_kernels(torch, dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    rows.update(check_quant_kernels(torch, dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    rows.update(check_k11_kernels(torch, dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    rows.update(check_probe_kernels(torch, dev, card))
    rows.update(check_probe_kv_kernels(torch, dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3 at {time.time() - t_start:.1f} s")
    held = {}
    paths = {"generate": run_slice(torch, dev, card, keep=held)}
    # phase 3d's runs (a)-(c) on phase 3's model here: held through phases
    # 3b and 3c, its 22 GiB beside 3c's bf16 Qwen3-14B build would bring
    # the peak near the card's 80 GB
    log(f"phase 3d (a)-(c) at {time.time() - t_start:.1f} s")
    paths.update(run_decoding(torch, dev, card, **held))
    held.clear()
    gc.collect()                 # free the generation model before training
    torch.cuda.empty_cache()
    log(f"phase 3b at {time.time() - t_start:.1f} s")
    paths["legacy_generate"] = run_legacy_generation(torch, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3c at {time.time() - t_start:.1f} s")
    from prot2text_tpu_torch.kernels import quant_matmul as qm
    routes, restore_route = count_routes(qm)
    paths.update(run_light_generation(torch, dev, card, keep=held))
    log(f"phase 3d (d)-(e) at {time.time() - t_start:.1f} s")
    paths.update(run_light_decoding(torch, dev, card, held, routes))
    held.clear()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 4 at {time.time() - t_start:.1f} s")
    train_paths, models, stamp = run_training(torch, dev, card)
    paths.update(train_paths)
    paths["contrast"] = run_contrast(torch, dev, card, models, stamp)
    del stamp
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 4q at {time.time() - t_start:.1f} s")
    holder = [models]            # run_qlora frees the bf16 towers
    del models
    paths["qlora"] = run_qlora(torch, dev, card, holder)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 4f at {time.time() - t_start:.1f} s")
    paths["legacy_train"] = run_legacy_training(torch, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 4b at {time.time() - t_start:.1f} s")
    paths.update(run_serve(torch, dev, card))
    gc.collect()                 # free the bf16 serving model first
    torch.cuda.empty_cache()
    log(f"phase 4d at {time.time() - t_start:.1f} s")
    paths.update(run_serve_quant(torch, dev, card))
    restore_route()
    log(f"quantized matmuls of phases 3c-4d by body: {routes}")
    require(routes.get("few", 0) > 0 and routes.get("ragged", 0) == 0,
            f"a model projection took the ragged route, or none the "
            f"few-row body: {routes}")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 5 at {time.time() - t_start:.1f} s")
    run_plumbing(torch, dev)
    run_decoding_plumbing(torch, dev)
    run_train_plumbing(torch, dev)
    run_contrast_plumbing(torch, dev)
    run_serve_plumbing(torch, dev)
    run_medusa_plumbing(torch, dev)
    run_serve_quant_plumbing(torch, dev)
    run_legacy_plumbing(torch, dev)
    log(f"phase 6 at {time.time() - t_start:.1f} s")
    paths["probes"] = run_probes(torch, dev, card)

    out = []
    for kid, (_, _, src, tpu) in KERNELS.items():
        r = rows[kid]
        by_path = {p: c.get(kid, 0) for p, c in paths.items()}
        entry = {}
        if kid in OFF_PATH:
            # no model path launches it: phase 2's checks against its plain
            # version stand in
            require(r.get("checked") and sum(by_path.values()) == 0,
                    f"{kid} is off-path: phase 2 must check it and no path "
                    f"may launch it")
            entry["off_path"] = OFF_PATH[kid]
        else:
            require(sum(by_path.values()) > 0,
                    f"{kid} was launched no time on any path")
        if kid.startswith("K15"):
            require(by_path["probes"] > 0, f"{kid}: no launch in phase 6")
        out.append({"name": kid, "route": "cuda", "source": src,
                    "replaces": tpu, "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"], **entry,
                    **{key: r[key] for key in SPEED_KEYS if key in r}})
    log(f"all phases passed in {time.time() - t_start:.1f} s")
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
