"""Legacy full-finetune SFT step (counterpart of prot2text_tpu/train/
legacy.py): teacher forcing through the concat-fusion
`Esm2LlamaForCausalLM` on the derived collator's batches, training ALL
parameters (encoder, adapter and decoder) with AdamW + StepLR
(`train/optim.py step_lr`).

With gradient accumulation the micro-batches run one after another, each
backward adding into the parameters' `.grad`; the step's loss is the mean
over the micro-batches and the gradients are divided by their count, as
the JAX step's scan sums and then divides.
"""

from __future__ import annotations

import torch

from ..models.composed import Esm2LlamaConfig, Esm2LlamaForCausalLM
from ..models.weights import tree_leaves, tree_map
from .optim import AdamW, TrainState, apply_updates


def make_legacy_train_step(*, config: Esm2LlamaConfig, tx: AdamW,
                           attn_impl: str = "auto", remat: bool = True,
                           grad_accum: int = 1):
    """Returns `step(state, batch) -> (state, loss)` over `state.params`
    (every leaf trainable).  With grad_accum > 1 every batch leaf is
    stacked (grad_accum, micro_bsz, ...).  `remat` recomputes each encoder
    and decoder layer in the backward pass (the JAX `jax.checkpoint`).
    `loss` is a device scalar: no host sync."""

    def step(state: TrainState, batch):
        params = state.params
        for p in tree_leaves(params):
            p.grad = None
        micro = ([batch] if grad_accum == 1 else
                 [{k: v[i] for k, v in batch.items()}
                  for i in range(grad_accum)])
        total = None
        for mb in micro:
            loss = Esm2LlamaForCausalLM.apply(
                config, params, attn_impl=attn_impl, remat=remat,
                **mb).loss
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        grads = tree_map(lambda p: (torch.zeros_like(p) if p.grad is None
                                    else p.grad / grad_accum), params)
        return apply_updates(state, grads, tx), total / grad_accum

    return step
