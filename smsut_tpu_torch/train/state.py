# -*- coding: utf-8 -*-
"""Train state and the reference-matching SGD.

Port of ``make_sgd`` and ``TrainState`` of ``smsut_tpu/train/state.py``:
SGD(momentum 0.9, weight_decay 1e-3) with coupled L2 under the
per-iteration poly LR, as optax's chain
``add_decayed_weights -> trace(momentum) -> scale_by_learning_rate`` runs
it:
  d = g + wd * p;  t = d + momentum * t (t starts at 0, so the first trace
  is d);  p = p - lr * t,  lr = poly(max(step - 1, 0)).
No dampening, no Nesterov.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from smsut_tpu_torch.config import Config
from smsut_tpu_torch.ops.schedules import poly_lr_schedule

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SGD:
    """The optimizer's settings; ``lr`` maps the step count to the LR."""
    lr: Callable[[int], float]
    weight_decay: float
    momentum: float = 0.9

    def init(self, params: Params) -> Params:
        return {k: torch.zeros_like(v) for k, v in params.items()}


def make_sgd(cfg: Config, momentum: float = 0.9) -> SGD:
    return SGD(poly_lr_schedule(cfg.lr, cfg.total_iters), cfg.weight_decay,
               momentum)


@dataclasses.dataclass
class TrainState:
    """Step count, float32 parameters and momentum traces."""
    step: int
    params: Params
    opt_state: Params
    tx: SGD

    @classmethod
    def create(cls, params: Params, tx: SGD) -> "TrainState":
        return cls(step=0, params=params, opt_state=tx.init(params), tx=tx)

    @torch.no_grad()
    def apply_gradients(self, grads: Params) -> "TrainState":
        """One SGD update.  It updates the parameter and trace tensors in
        place (the JAX step donates its state buffers the same way), so the
        state passed in is consumed; the returned state holds them.  The
        multi-tensor ops make a few launches for all parameters instead of
        several per parameter."""
        tx = self.tx
        keys = list(self.params)
        ps = [self.params[k] for k in keys]
        ts = [self.opt_state[k] for k in keys]
        d = torch._foreach_add([grads[k] for k in keys], ps,
                               alpha=tx.weight_decay)
        torch._foreach_mul_(ts, tx.momentum)
        torch._foreach_add_(ts, d)
        torch._foreach_add_(ps, ts, alpha=-tx.lr(self.step))
        return dataclasses.replace(self, step=self.step + 1)
