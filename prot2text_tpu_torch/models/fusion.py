"""Modality fusion (counterpart of prot2text_tpu/models/fusion.py):
  * `placeholder_merge` (:21-65): the n-th placeholder of row b receives
    the n-th valid encoder token of row b, by cumsum ordinals and gathers
    (no data-dependent shapes);
  * `concat_fusion` (:68-86): the legacy arc's [encoder ‖ text] along the
    sequence."""

from __future__ import annotations

import torch


def placeholder_merge(inputs_embeds, input_ids, encoder_hidden,
                      encoder_attention_mask, placeholder_id: int):
    ph = input_ids == placeholder_id                           # (B, S)
    ph_ord = (torch.cumsum(ph.to(torch.int64), dim=1) - 1).clamp(min=0)
    emask = encoder_attention_mask.bool()                      # (B, P)
    P = encoder_hidden.shape[1]
    enc_ord = torch.cumsum(emask.to(torch.int64), dim=1) - 1
    key = torch.where(emask, enc_ord,
                      P + torch.arange(P, device=emask.device)[None, :])
    order = torch.argsort(key, dim=1, stable=True)   # valid tokens first
    compacted = torch.take_along_dim(encoder_hidden, order[..., None], dim=1)
    gather_idx = ph_ord.clamp(0, P - 1)
    merged = torch.take_along_dim(compacted, gather_idx[..., None], dim=1)
    return torch.where(ph[..., None], merged.to(inputs_embeds.dtype),
                       inputs_embeds)


def count_check(input_ids, placeholder_id, encoder_attention_mask):
    """Per-row placeholder count == valid protein-token count."""
    n_ph = (input_ids == placeholder_id).sum(dim=1)
    n_enc = encoder_attention_mask.sum(dim=1)
    return n_ph == n_enc


def concat_fusion(encoder_embeds, encoder_attention_mask, text_embeds,
                  text_attention_mask, labels=None, ignore_index: int = -100):
    """[enc ‖ text] along the sequence in the text's dtype, the masks
    concatenated, labels prefixed with `ignore_index` over the encoder's
    columns → (embeds, mask, labels or None)."""
    embeds = torch.cat([encoder_embeds.to(text_embeds.dtype), text_embeds],
                       dim=1)
    mask = torch.cat([encoder_attention_mask, text_attention_mask], dim=1)
    if labels is None:
        return embeds, mask, None
    pad = torch.full(encoder_embeds.shape[:2], ignore_index,
                     dtype=labels.dtype, device=labels.device)
    return embeds, mask, torch.cat([pad, labels], dim=1)
