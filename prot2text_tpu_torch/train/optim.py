"""AdamW, its schedules and the train-state update (counterpart of
prot2text_tpu/train/optim.py).

`AdamW` is optax's `chain(clip_by_global_norm(c), adamw(schedule, eps, wd))`
written out, step for step:
  * global-norm clipping scales by max_norm / norm only when norm >=
    max_norm (`t / norm * max_norm`, no epsilon — not
    `torch.nn.utils.clip_grad_norm_`);
  * mu = b1·mu + (1-b1)·g, nu = b2·nu + (1-b2)·g², bias-corrected with the
    incremented count; update = mu_hat / (sqrt(nu_hat) + eps), eps outside
    the square root;
  * decoupled weight decay on every trainable leaf: update += wd·param;
  * param += -lr(count)·update, the schedule evaluated at the count BEFORE
    the increment, so a warmup schedule's first update uses lr(0) = 0.
Unlike optax's pure functions, parameters and moments are updated in place
(no second copy of the trainable tree).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..models.weights import tree_leaves, tree_map


def cosine_warmup_schedule(base_lr: float, total_steps: int,
                           warmup_frac: float = 0.06,
                           steps_per_period: int = 1
                           ) -> Callable[[int], float]:
    """lr(t): linear warmup to base_lr over warmup_frac·total, then cosine
    decay to 0, evaluated at t // steps_per_period: the contrastive
    trainer's per-epoch stepping over a num_epochs-long cosine; the
    instruct trainer steps per optimizer step (1)."""
    warmup = max(int(total_steps * warmup_frac), 1)

    def sched(step: int) -> float:
        step = step // steps_per_period
        if step < warmup:
            return base_lr * step / warmup
        progress = (step - warmup) / max(total_steps - warmup, 1)
        progress = min(max(progress, 0.0), 1.0)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * progress))

    return sched


def step_lr_schedule(base_lr: float, gamma: float, steps_per_epoch: int
                     ) -> Callable[[int], float]:
    """StepLR(step_size=1 epoch, gamma): base_lr·gamma^(step //
    steps_per_epoch), in float32 as the JAX schedule computes it
    (prot2text_tpu/train/optim.py:55-62; reference train_legacy.py:325)."""

    def sched(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return float(np.float32(base_lr)
                     * np.float32(gamma) ** np.float32(epoch))

    return sched


B1, B2 = 0.9, 0.999           # optax.adamw's defaults, used by every trainer
# optax.adamw's own eps and weight decay, which `step_lr` keeps (the other
# trainers pass eps 1e-6 and their own decay)
OPTAX_EPS, OPTAX_WEIGHT_DECAY = 1e-8, 1e-4


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Union[float, Callable[[int], float]]
    weight_decay: float = 0.0
    eps: float = 1e-6
    grad_clip: Optional[float] = None

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params) -> dict:
        zeros = lambda p: torch.zeros_like(p, memory_format=torch.
                                           contiguous_format)
        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(self, grads, opt_state: dict, params) -> None:
        """One optimizer step, in place on `params` and `opt_state`."""
        gs = tree_leaves(grads)
        if self.grad_clip is not None:
            norm = torch.sqrt(sum(g.float().square().sum() for g in gs))
            keep = norm < self.grad_clip
            gs = [torch.where(keep, g, g / norm * self.grad_clip) for g in gs]
        count = opt_state["count"]
        lr = self.lr(count)
        t = count + 1
        # optax's bias corrections are float32 arithmetic: 1 - 0.999f**t
        # differs from the float64 value by 1.3e-5 relative at t = 1
        bc1, bc2 = (float(np.float32(1) - np.float32(b) ** np.float32(t))
                    for b in (B1, B2))
        for p, g, m, v in zip(tree_leaves(params), gs,
                              tree_leaves(opt_state["mu"]),
                              tree_leaves(opt_state["nu"])):
            m.mul_(B1).add_(g, alpha=1.0 - B1)
            v.mul_(B2).add_(g.square(), alpha=1.0 - B2)
            u = (m / bc1) / ((v / bc2).sqrt() + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(u * -lr)
        opt_state["count"] = t


def adamw_cosine_warmup(base_lr: float, total_steps: int,
                        warmup_frac: float = 0.06,
                        weight_decay: float = 0.0,
                        eps: float = 1e-6,
                        grad_clip: Optional[float] = None,
                        steps_per_period: int = 1) -> AdamW:
    sched = cosine_warmup_schedule(base_lr, total_steps, warmup_frac,
                                   steps_per_period)
    return AdamW(sched, weight_decay=weight_decay, eps=eps,
                 grad_clip=grad_clip)


def adamw_constant(lr: float, weight_decay: float = 0.0, eps: float = 1e-6,
                   grad_clip: Optional[float] = None) -> AdamW:
    return AdamW(lr, weight_decay=weight_decay, eps=eps, grad_clip=grad_clip)


def step_lr(base_lr: float, gamma: float, steps_per_epoch: int,
            grad_clip: Optional[float] = None) -> AdamW:
    """The legacy trainer's optimizer: `optax.adamw(step_lr_schedule(...))`
    at optax's defaults (eps 1e-8, weight decay 1e-4), global-norm clipping
    chained before it when `grad_clip` is given (prot2text_tpu/train/
    optim.py:87-93)."""
    return AdamW(step_lr_schedule(base_lr, gamma, steps_per_epoch),
                 weight_decay=OPTAX_WEIGHT_DECAY, eps=OPTAX_EPS,
                 grad_clip=grad_clip)


@dataclasses.dataclass
class TrainState:
    """Trainable params (nested dict of leaf tensors with requires_grad),
    optimizer state, step counter."""

    params: dict
    opt_state: dict
    step: int

    @classmethod
    def create(cls, params, tx: AdamW):
        return cls(params=params, opt_state=tx.init(params), step=0)


def apply_updates(state: TrainState, grads, tx: AdamW) -> TrainState:
    tx.update(grads, state.opt_state, state.params)
    return TrainState(params=state.params, opt_state=state.opt_state,
                      step=state.step + 1)
