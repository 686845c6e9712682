# -*- coding: utf-8 -*-
"""Train states and the reference-matching optimizers.

Port of ``make_sgd``, ``make_adam``, ``TrainState`` and ``GANTrainState``
of ``smsut_tpu/train/state.py``, as optax's chains run them, both under
the per-iteration poly LR:

- SGD (momentum 0.9, weight_decay 1e-3), ``add_decayed_weights ->
  trace(momentum) -> scale_by_learning_rate``:
  d = g + wd * p;  t = d + momentum * t (t starts at 0, so the first trace
  is d);  p = p - lr * t,  lr = poly(max(step - 1, 0)).
  No dampening, no Nesterov.
- Adam (b1 0.9, b2 0.999, eps 1e-8), ``add_decayed_weights ->
  scale_by_adam -> scale_by_learning_rate``: the coupled L2 is added
  before the moments,
  d = g + wd * p;  mu = b1 mu + (1 - b1) d;  nu = b2 nu + (1 - b2) d^2;
  p = p - lr * (mu / (1 - b1^k)) / (sqrt(nu / (1 - b2^k)) + eps),
  k the updates made including this one, lr = poly at the optimizer's own
  count of earlier updates.

Every update runs as a few multi-tensor (``_foreach``) ops for all
parameters, in place: the parameter and optimizer tensors passed in are
consumed (the JAX step donates its state buffers the same way).
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

    @torch.no_grad()
    def update_(self, params: Params, traces: Params, grads: Params,
                count: int) -> None:
        """One update of ``params`` and ``traces`` in place, at the LR of
        ``count`` earlier updates."""
        keys = list(params)
        ps = [params[k] for k in keys]
        ts = [traces[k] for k in keys]
        d = torch._foreach_add([grads[k] for k in keys], ps,
                               alpha=self.weight_decay)
        torch._foreach_mul_(ts, self.momentum)
        torch._foreach_add_(ts, d)
        torch._foreach_add_(ps, ts, alpha=-self.lr(count))


def make_sgd(cfg: Config, momentum: float = 0.9) -> SGD:
    return SGD(poly_lr_schedule(cfg.lr, cfg.total_iters), cfg.weight_decay,
               momentum)


@dataclasses.dataclass
class AdamState:
    """Adam's count of updates made and its first and second moments."""
    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class Adam:
    """The optimizer's settings; ``lr`` maps the update count to the LR."""
    lr: Callable[[int], float]
    weight_decay: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Params) -> AdamState:
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
        return AdamState(0, zeros(), zeros())

    @torch.no_grad()
    def update_(self, params: Params, state: AdamState,
                grads: Params) -> AdamState:
        """One update of ``params`` and the moments in place."""
        keys = list(params)
        ps = [params[k] for k in keys]
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        d = torch._foreach_add([grads[k] for k in keys], ps,
                               alpha=self.weight_decay)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, d, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, d, d, value=1.0 - self.b2)
        k = state.count + 1
        den = torch._foreach_div(nu, 1.0 - self.b2 ** k)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, 1.0 - self.b1 ** k)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(ps, upd, alpha=-self.lr(state.count))
        return AdamState(k, state.mu, state.nu)


def make_adam(cfg: Config, b1: float = 0.9, b2: float = 0.999) -> Adam:
    return Adam(poly_lr_schedule(cfg.lr, cfg.total_iters), cfg.weight_decay,
                b1, b2)


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

    def apply_gradients(self, grads: Params) -> "TrainState":
        """One SGD update, in place; the state passed in is consumed."""
        self.tx.update_(self.params, self.opt_state, grads, self.step)
        return dataclasses.replace(self, step=self.step + 1)


@dataclasses.dataclass
class GANTrainState:
    """Generator (SGD) + discriminator (Adam).  One ``step`` counter
    counts the iterations; the train step advances it after both updates,
    so it is also the generator's count of earlier updates (the LR of its
    SGD), as the reference's shared ``self.iter`` drives both poly
    schedules."""
    step: int
    g_params: Params
    g_opt_state: Params
    d_params: Params
    d_opt_state: AdamState
    g_tx: SGD
    d_tx: Adam

    @classmethod
    def create(cls, g_params: Params, d_params: Params, cfg: Config,
               beta1: float = 0.9, beta2: float = 0.999) -> "GANTrainState":
        g_tx, d_tx = make_sgd(cfg), make_adam(cfg, beta1, beta2)
        return cls(step=0, g_params=g_params, g_opt_state=g_tx.init(g_params),
                   d_params=d_params, d_opt_state=d_tx.init(d_params),
                   g_tx=g_tx, d_tx=d_tx)

    def apply_d_gradients(self, grads: Params) -> "GANTrainState":
        """One Adam update of D, in place."""
        return dataclasses.replace(self, d_opt_state=self.d_tx.update_(
            self.d_params, self.d_opt_state, grads))

    def apply_g_gradients(self, grads: Params) -> "GANTrainState":
        """One SGD update of G, in place."""
        self.g_tx.update_(self.g_params, self.g_opt_state, grads, self.step)
        return self
