"""Stage-2 instruction SFT with LoRA (counterpart of
prot2text_tpu/train/sft.py).

Teacher-forcing LM loss on chat-template batches (labels -100 outside the
description); trainable = LoRA trees over the ESMC and Qwen3 stacks plus the
full modality adapter (unless `fix_modality_adapter`); frozen = the base
towers, whose weights never get a gradient.  The LoRA trees ride the stacks
as low-rank side paths: W+ΔW is never materialized.  With gradient
accumulation the micro-batches run one after another, each backward adding
into the parameters' `.grad`; the step's loss is the mean over the
micro-batches and the gradients are averaged, as the JAX step's scan does.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.adapters import ModalityAdapterConfig, modality_adapter
from ..models.decoder import (
    DecoderConfig, contiguous_lengths, cross_entropy_loss, decoder_forward,
    decoder_logits,
)
from ..models.esmc import ESMCConfig, esmc_encode
from ..models.fusion import placeholder_merge
from ..models.lora import LoraConfig
from ..models.weights import tree_leaves, tree_map
from .optim import AdamW, TrainState, apply_updates


@dataclasses.dataclass(frozen=True)
class SFTConfig:
    lora: LoraConfig = LoraConfig()
    placeholder_id: int = 151669
    fix_modality_adapter: bool = False  # --fix_modality_adapter
    remat: bool = True


def sft_loss(trainable: dict, frozen: dict, batch: dict, *,
             esm_config: ESMCConfig, adapter_config: ModalityAdapterConfig,
             decoder_core: DecoderConfig, cfg: SFTConfig,
             deterministic: bool = False, generator=None,
             attn_impl: str = "auto"):
    """trainable {"lora_llm", "lora_esm", "adapter"}; frozen {"esm_encoder",
    "llm_decoder", "adapter"?}; batch of (B, ...) int tensors.  Training
    mode (`deterministic=False`) draws the adapter's dropout masks from
    `generator`.  `attn_impl` routes both towers' attention as in JAX:
    "auto" — plain ESMC attention, K1/K5 in the decoder; "flash" — K6/K6b
    in ESMC, K1/K5 in the decoder; "xla" — the plain function in both."""
    adapter_params = (frozen["adapter"] if cfg.fix_modality_adapter
                      else trainable["adapter"])
    scale = cfg.lora.scale
    enc = esmc_encode(esm_config, frozen["esm_encoder"],
                      batch["protein_input_ids"],
                      batch["protein_attention_mask"], attn_impl=attn_impl,
                      remat=cfg.remat, lora=trainable["lora_esm"],
                      lora_scale=scale)
    adapted = modality_adapter(adapter_config, adapter_params, enc,
                               deterministic=deterministic,
                               generator=generator)
    llm_params = frozen["llm_decoder"]
    input_ids = batch["input_ids"]
    inputs_embeds = placeholder_merge(
        llm_params["embed_tokens"][input_ids], input_ids, adapted,
        batch["protein_attention_mask"], cfg.placeholder_id)
    B, S = input_ids.shape
    positions = torch.arange(S, device=input_ids.device).expand(B, S)
    h, _ = decoder_forward(
        decoder_core, llm_params, inputs_embeds=inputs_embeds,
        positions=positions,
        attn_lengths=contiguous_lengths(batch["attention_mask"]),
        lora=trainable["lora_llm"], lora_scale=scale, remat=cfg.remat,
        attn_impl=attn_impl)
    logits = decoder_logits(decoder_core, llm_params, h)
    return cross_entropy_loss(logits, batch["labels"])


def make_sft_train_step(*, esm_config: ESMCConfig,
                        adapter_config: ModalityAdapterConfig,
                        decoder_core: DecoderConfig, cfg: SFTConfig,
                        tx: AdamW, grad_accum: int = 1,
                        attn_impl: str = "auto"):
    """Returns `step(state, frozen, batch, generator) -> (state, loss)`.
    With grad_accum > 1 every batch leaf is stacked (grad_accum, micro_bsz,
    ...).  The dropout generator advances through the micro-batches, so
    each draws its own masks.  `loss` is a device scalar: no host sync."""

    def step(state: TrainState, frozen, batch, generator):
        params = state.params
        for p in tree_leaves(params):
            p.grad = None
        micro = ([batch] if grad_accum == 1 else
                 [{k: v[i] for k, v in batch.items()}
                  for i in range(grad_accum)])
        total = None
        for mb in micro:
            loss = sft_loss(params, frozen, mb, esm_config=esm_config,
                            adapter_config=adapter_config,
                            decoder_core=decoder_core, cfg=cfg,
                            deterministic=False, generator=generator,
                            attn_impl=attn_impl)
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        # a trainable leaf the loss does not reach (the adapter under
        # fix_modality_adapter) has a zero gradient, as under jax.grad
        grads = tree_map(lambda p: (torch.zeros_like(p) if p.grad is None
                                    else p.grad / grad_accum), params)
        return apply_updates(state, grads, tx), total / grad_accum

    return step


def make_sft_eval_step(*, esm_config: ESMCConfig,
                       adapter_config: ModalityAdapterConfig,
                       decoder_core: DecoderConfig, cfg: SFTConfig,
                       attn_impl: str = "auto"):
    """Deterministic loss-only step (reference eval_epoch)."""

    @torch.no_grad()
    def step(trainable, frozen, batch):
        return sft_loss(trainable, frozen, batch, esm_config=esm_config,
                        adapter_config=adapter_config,
                        decoder_core=decoder_core, cfg=cfg,
                        deterministic=True, attn_impl=attn_impl)

    return step
