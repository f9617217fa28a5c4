"""Training step of the Medusa draft heads (counterpart of
prot2text_tpu/train/draft.py; the heads: `models/medusa.py`).

Distillation against the frozen target decoder: one forward of the target
over a token batch, then head k learns to predict the token at t+2+k from
the target's hidden state at position t, cross-entropy through the target's
own frozen LM head.  Only the (K, H, H) + (K, H) head stack gets gradients.

  * The frozen forward runs under `torch.no_grad()` (JAX's
    `stop_gradient`): attention is K1 a layer, no K5 runs and no decoder
    activation is kept.
  * One head at a time, with fp32 log-softmax: a head's (B, S, V) fp32
    logits are already the standard trainer's peak activation.  The train
    step also runs each head's backward before the next head's forward, so
    only one head's logits live at a time; the loss and the summed
    gradients are those of the whole mean.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.decoder import (
    DecoderConfig, contiguous_lengths, decoder_forward, decoder_logits,
    embed_tokens,
)
from .optim import AdamW, TrainState, apply_updates


def _frozen_hidden(core_cfg: DecoderConfig, dec_params, batch):
    """(h (B, S, H) of the frozen target, labels (B, S), mask (B, S)):
    batch holds attention_mask and either input_ids or inputs_embeds with
    labels (-100 where a position has no token)."""
    mask = batch["attention_mask"].long()
    if "inputs_embeds" in batch:
        emb, labels = batch["inputs_embeds"], batch["labels"]
    else:
        labels = batch["input_ids"]
        emb = embed_tokens(dec_params, labels)
    pos = (torch.cumsum(mask, dim=1) - 1).clamp(min=0)
    with torch.no_grad():
        h, _ = decoder_forward(core_cfg, dec_params, inputs_embeds=emb,
                               positions=pos,
                               attn_lengths=contiguous_lengths(mask))
    return h, labels, mask


def _head_targets(labels, mask, k: int):
    """Head k's labels (labels[t+2+k]) and where they count: the target
    position lies inside the sequence and on a real token, the source
    position too, and the label is not -100."""
    S = labels.shape[1]
    tgt = torch.arange(S, device=labels.device) + 2 + k
    valid = tgt < S
    tgt = tgt.clamp(max=S - 1)
    lbl = labels[:, tgt]
    ok = (mask[:, tgt] > 0) & valid[None] & (mask > 0) & (lbl >= 0)
    return lbl, ok


def _head_ll(core_cfg, dec_params, med_params, h, lbl, ok, k: int):
    """Head k's summed log-likelihood of its labels where `ok`."""
    w_k = med_params["w"][k].to(h.dtype)
    b_k = med_params["b"][k].to(h.dtype)
    hk = h + F.silu(h @ w_k + b_k)
    logp = torch.log_softmax(decoder_logits(core_cfg, dec_params, hk),
                             dim=-1)
    ll = torch.gather(logp, -1, lbl.clamp(min=0)[..., None])[..., 0]
    return torch.where(ok, ll, 0.0).sum()


def _terms(core_cfg, dec_params, med_params, batch):
    """The loss's per-head terms -ll_k / count in head order; each is built
    when asked for, after the one frozen forward."""
    h, labels, mask = _frozen_hidden(core_cfg, dec_params, batch)
    K = med_params["w"].shape[0]
    targets = [_head_targets(labels, mask, k) for k in range(K)]
    count = sum(ok.sum() for _, ok in targets).clamp(min=1)
    for k, (lbl, ok) in enumerate(targets):
        yield -_head_ll(core_cfg, dec_params, med_params, h, lbl, ok,
                        k) / count


def medusa_loss(core_cfg: DecoderConfig, dec_params, med_params, batch):
    """Mean cross-entropy of every head over every position with a valid
    target (prot2text_tpu/train/draft.py:28-79).

    batch: attention_mask (B, S) 0/1 plus either input_ids (B, S) (text
    distillation) or inputs_embeds (B, S, H) with labels (B, S), -100 at
    positions without a token (the composed protein→text case).  The
    hidden state at t predicts the next token through the LM head; head k
    (0-based) predicts the token at t+2+k, matching the serving chunk
    [last_tok, d_1..d_K] where d_{k+1} is checked against the target's
    argmax k+1 tokens past the frontier token."""
    return sum(_terms(core_cfg, dec_params, med_params, batch))


def make_medusa_train_step(core_cfg: DecoderConfig, tx: AdamW):
    """Returns step(state, dec_params, batch) -> (state, loss); state holds
    the head params (`train/optim.TrainState`), updated in place.  Each
    head's term is backpropagated before the next head's forward; `loss`
    is a device scalar (no host sync)."""

    def step(state: TrainState, dec_params, batch):
        params = state.params
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
        loss = None
        for term in _terms(core_cfg, dec_params, params, batch):
            term.backward()
            loss = term.detach() if loss is None else loss + term.detach()
        return apply_updates(state, {k: p.grad for k, p in params.items()},
                             tx), loss

    return step
