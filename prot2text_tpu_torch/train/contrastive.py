"""Stage-1 contrastive alignment (counterpart of
prot2text_tpu/train/contrastive.py).

  * protein embedding: frozen ESMC encode → trainable modality adapter →
    "mix" readout = concat(mean, std) pooling → L2-norm;
  * text embedding: the FROZEN decoder truncated at layer
    `output_llm_layer` (HF `hidden_states[layer]`, pre-final-norm; only the
    first `layer` layers run) → "mix" readout → L2-norm;
  * segmented InfoNCE (τ = 0.05): segment × batch similarity with integer
    labels; segments bound the similarity matrix.
Both towers run under `torch.no_grad()`, the JAX `stop_gradient`: only the
adapter trains, so the towers keep no activations for a backward.  The text
tower runs forward only with flash forced under "auto", as in JAX (K1 on
the card); ESMC runs under the caller's `attn_impl` (K6 forward under
"flash", plain otherwise).  With gradient accumulation the micro-batches
run one after another, each backward adding into the adapter's `.grad`;
the step's loss is the mean over the micro-batches and the gradients are
averaged, as the JAX step's scan does.  The negatives are those of the
micro-batch (global-batch negatives across cards: ROADMAP.md §1 item 14).
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.adapters import ModalityAdapterConfig, modality_adapter
from ..models.decoder import (
    DecoderConfig, contiguous_lengths, decoder_forward,
)
from ..models.esmc import ESMCConfig, esmc_encode
from ..models.weights import tree_leaves, tree_map
from .optim import AdamW, TrainState, apply_updates

BATCH_KEYS = ("protein_input_ids", "protein_attention_mask",
              "description_input_ids", "description_attention_mask")


@dataclasses.dataclass(frozen=True)
class ContrastiveConfig:
    temperature: float = 0.05
    num_segments: int = 2
    output_llm_layer: int = 16
    readout: str = "mix"
    # reference quirk kept by the JAX package: the adapter outputs are
    # pooled with an all-ones mask (pads included); False pools valid
    # tokens only
    mask_aware_protein_readout: bool = False


def readout_embeddings(embeddings, attention_mask, readout_fn: str = "mix"):
    """(B, S, H) + (B, S) → (B, H), or (B, 2H) for "mix", in fp32."""
    mask = attention_mask.float()
    if readout_fn == "last":
        idx = (mask.sum(dim=1).long() - 1) % embeddings.shape[1]
        return embeddings[torch.arange(embeddings.shape[0]), idx]
    x = embeddings.float()
    count = mask.sum(dim=1, keepdim=True).clamp(min=1.0)
    mean = (x * mask[..., None]).sum(dim=1) / count
    if readout_fn == "mean":
        return mean
    var = ((x - mean[:, None, :]).square() * mask[..., None]).sum(dim=1) \
        / count
    std = var.sqrt()
    if readout_fn == "std":
        return std
    if readout_fn == "mix":
        return torch.cat([mean, std], dim=1)
    raise ValueError(readout_fn)


def _l2(x, eps: float = 1e-12):
    return x / x.square().sum(dim=-1, keepdim=True).sqrt().clamp(min=eps)


def batch_infonce_loss(z1, z2, temperature: float = 0.05):
    """In-batch InfoNCE, positives on the diagonal."""
    logits = (z1 @ z2.T) / temperature
    return -torch.log_softmax(logits, dim=1).diagonal().mean()


def segmented_infonce_loss(seg_z1, batch_z2, labels,
                           temperature: float = 0.05):
    """(segment × batch) similarity with integer labels."""
    logp = torch.log_softmax((seg_z1 @ batch_z2.T) / temperature, dim=1)
    return -logp.gather(1, labels[:, None])[:, 0].mean()


def text_hidden_at_layer(core: DecoderConfig, decoder_params, input_ids,
                         attention_mask, layer: int, attn_impl: str = "auto"):
    """HF `hidden_states[layer]` (pre-final-norm), running only the first
    `layer` layers of `decoder_forward`.  Forward only: "auto" is forced to
    "flash", as in JAX (both take K1 in the port's decoder)."""
    B, S = input_ids.shape
    positions = torch.arange(S, device=input_ids.device).expand(B, S)
    h, _ = decoder_forward(
        core, decoder_params, inputs_embeds=decoder_params["embed_tokens"][
            input_ids], positions=positions,
        attn_lengths=contiguous_lengths(attention_mask),
        attn_impl="flash" if attn_impl == "auto" else attn_impl,
        num_layers=layer, final_norm=False)
    return h


def contrastive_loss(adapter_params, frozen: dict, batch: dict, *,
                     esm_config: ESMCConfig,
                     adapter_config: ModalityAdapterConfig,
                     decoder_core: DecoderConfig, cfg: ContrastiveConfig,
                     deterministic: bool = True, generator=None,
                     attn_impl: str = "auto"):
    """Segmented InfoNCE over the batch, differentiable in the adapter's
    params only.  frozen {"esm_encoder", "llm_decoder"}; batch of (B, ...)
    int tensors (BATCH_KEYS).  Training mode (`deterministic=False`) draws
    the adapter's dropout masks from `generator`."""
    with torch.no_grad():
        text_h = text_hidden_at_layer(
            decoder_core, frozen["llm_decoder"],
            batch["description_input_ids"],
            batch["description_attention_mask"], cfg.output_llm_layer,
            attn_impl)
        text_z = _l2(readout_embeddings(
            text_h, batch["description_attention_mask"], cfg.readout))
        enc = esmc_encode(esm_config, frozen["esm_encoder"],
                          batch["protein_input_ids"],
                          batch["protein_attention_mask"],
                          attn_impl=attn_impl)
    adapted = modality_adapter(adapter_config, adapter_params, enc,
                               deterministic=deterministic,
                               generator=generator)
    prot_mask = batch["protein_attention_mask"]
    if not cfg.mask_aware_protein_readout:
        prot_mask = torch.ones_like(prot_mask)
    prot_z = _l2(readout_embeddings(adapted, prot_mask, cfg.readout))

    n_seg = cfg.num_segments
    seg = prot_z.shape[0] // n_seg
    loss = 0.0
    for s in range(n_seg):
        labels = s * seg + torch.arange(seg, device=prot_z.device)
        loss = loss + segmented_infonce_loss(
            prot_z[s * seg:(s + 1) * seg], text_z, labels, cfg.temperature)
    return loss / n_seg


def make_contrastive_train_step(*, esm_config: ESMCConfig,
                                adapter_config: ModalityAdapterConfig,
                                decoder_core: DecoderConfig,
                                cfg: ContrastiveConfig, tx: AdamW,
                                attn_impl: str = "auto", grad_accum: int = 1,
                                deterministic: bool = False):
    """Returns `step(state, frozen, batch, generator) -> (state, loss)`;
    `state.params` is the adapter tree.  With grad_accum > 1 every batch
    leaf is stacked (grad_accum, micro_bsz, ...).  The dropout generator
    advances through the micro-batches.  `loss` is a device scalar."""

    def step(state: TrainState, frozen, batch, generator):
        params = state.params
        for p in tree_leaves(params):
            p.grad = None
        micro = ([batch] if grad_accum == 1 else
                 [{k: v[i] for k, v in batch.items()}
                  for i in range(grad_accum)])
        total = None
        for mb in micro:
            loss = contrastive_loss(
                params, frozen, mb, esm_config=esm_config,
                adapter_config=adapter_config, decoder_core=decoder_core,
                cfg=cfg, deterministic=deterministic, generator=generator,
                attn_impl=attn_impl)
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        grads = tree_map(lambda p: p.grad / grad_accum, params)
        return apply_updates(state, grads, tx), total / grad_accum

    return step


def make_contrastive_eval_step(*, esm_config: ESMCConfig,
                               adapter_config: ModalityAdapterConfig,
                               decoder_core: DecoderConfig,
                               cfg: ContrastiveConfig,
                               attn_impl: str = "auto"):
    """Deterministic loss-only step (reference eval_epoch)."""

    @torch.no_grad()
    def step(adapter_params, frozen, batch):
        return contrastive_loss(
            adapter_params, frozen, batch, esm_config=esm_config,
            adapter_config=adapter_config, decoder_core=decoder_core,
            cfg=cfg, deterministic=True, attn_impl=attn_impl)

    return step
