# -*- coding: utf-8 -*-
"""Train states and the reference-matching optimizers.

Port of ``make_sgd``, ``make_adam``, ``TrainState`` and ``GANTrainState``
of ``smsut_tpu/train/state.py``, as optax's chains run them, both under
the per-iteration poly LR (and :func:`make_constant_sgd`, the chain of
CoraNet's stage A, ``optax.scale(-lr)``: no poly, no lag):

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

Both optimizers take one call, ``tx.update_(params, opt_state, grads,
count)`` with ``count`` the caller's device count of earlier updates, so a
``TrainState`` runs either (M3L's is Adam): SGD reads its LR at ``count``;
Adam keeps its own count in its state (``AdamState.count``, as optax's
``scale_by_adam`` does) and reads its LR and bias corrections there.

Every update runs as a few multi-tensor (``_foreach``) ops for all
parameters, in place: the parameter and optimizer tensors passed in are
consumed (the JAX step donates its state buffers the same way).

The step counts live on the device, as 0-d int64 tensors (``count``), and
every update reads its LR and Adam's bias corrections from float64 host
tables (:func:`poly_lr_table`, :func:`bias_corrections`) copied to the
device, indexed there by the count.  No value of an update is a host number
that changes from step to step, so a CUDA graph of the step
(``train/graphs.py``) replays it right.  The host's ``step`` is a mirror of
``count``: the caller advances it, and nothing reads the count back.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from smsut_tpu_torch.config import Config
from smsut_tpu_torch.ops.schedules import poly_lr_table

Params = Dict[str, torch.Tensor]

# rows of Adam's bias-correction tables: past 2^15 updates 1 - 0.999^k
# rounds to 1 in float32, so the last row stands for every later count
ADAM_ROWS = 1 << 15


def bias_corrections(b: float, rows: int) -> np.ndarray:
    """float64 [rows]: row k is 1 - b^k, as the host computed it."""
    return np.array([1.0 - b ** k for k in range(rows)], np.float64)


def zero_count(params: Params) -> torch.Tensor:
    """A 0-d int64 step counter at 0 on the parameters' device."""
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int64, device=dev)


class _Tables:
    """Host float64 tables, copied once to each (device, dtype) asked for,
    and read at a device count (clamped to the last row) without a host
    wait."""

    def __init__(self, **tables: np.ndarray):
        self.host = tables
        self._dev: Dict[tuple, torch.Tensor] = {}

    def at(self, name: str, count: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
        key = (name, count.device, dtype)
        t = self._dev.get(key)
        if t is None:
            t = self._dev[key] = torch.from_numpy(self.host[name]).to(
                count.device, dtype)
        i = torch.clamp(count, max=t.shape[0] - 1).reshape(1)
        return t.index_select(0, i).reshape(())


class SGD:
    """The optimizer's settings; ``lr_table`` row k is the LR at count k."""

    def __init__(self, lr_table: np.ndarray, weight_decay: float,
                 momentum: float = 0.9):
        self.tables = _Tables(lr=lr_table)
        self.weight_decay = weight_decay
        self.momentum = momentum

    def init(self, params: Params) -> Params:
        return {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def update_(self, params: Params, traces: Params, grads: Params,
                count: torch.Tensor) -> None:
        """One update of ``params`` and ``traces`` in place, at the LR of
        ``count`` (a device tensor) earlier updates."""
        keys = list(params)
        ps = [params[k] for k in keys]
        ts = [traces[k] for k in keys]
        d = torch._foreach_add([grads[k] for k in keys], ps,
                               alpha=self.weight_decay)
        torch._foreach_mul_(ts, self.momentum)
        torch._foreach_add_(ts, d)
        lr = self.tables.at("lr", count, ps[0].dtype)
        torch._foreach_sub_(ps, torch._foreach_mul(ts, lr))


def make_sgd(cfg: Config, momentum: float = 0.9,
             total_iters: Optional[int] = None) -> SGD:
    """SGD under the poly LR over ``total_iters`` (``cfg.total_iters``
    unless given)."""
    return SGD(poly_lr_table(cfg.lr, total_iters or cfg.total_iters),
               cfg.weight_decay, momentum)


def make_constant_sgd(cfg: Config, momentum: float = 0.9) -> SGD:
    """SGD at ``cfg.lr`` for every count: a one-row table."""
    return SGD(np.array([cfg.lr], np.float64), cfg.weight_decay, momentum)


@dataclasses.dataclass
class AdamState:
    """Adam's count of updates made (a 0-d int64 device tensor) and its
    first and second moments."""
    count: torch.Tensor
    mu: Params
    nu: Params


class Adam:
    """The optimizer's settings; ``lr_table`` row k is the LR at count k."""

    def __init__(self, lr_table: np.ndarray, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        rows = max(len(lr_table), ADAM_ROWS)
        self.tables = _Tables(lr=lr_table, c1=bias_corrections(b1, rows),
                              c2=bias_corrections(b2, rows))
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Params) -> AdamState:
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
        return AdamState(zero_count(params), zeros(), zeros())

    @torch.no_grad()
    def update_(self, params: Params, state: AdamState, grads: Params,
                count: Optional[torch.Tensor] = None) -> AdamState:
        """One update of ``params``, the moments and the count in place, at
        the LR and bias corrections of ``state.count``; returns ``state``.
        ``count``, the caller's step count, is taken for the optimizers'
        shared call and not read."""
        keys = list(params)
        ps = [params[k] for k in keys]
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        dt = ps[0].dtype
        d = torch._foreach_add([grads[k] for k in keys], ps,
                               alpha=self.weight_decay)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, d, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, d, d, value=1.0 - self.b2)
        k = state.count + 1
        den = torch._foreach_div(nu, self.tables.at("c2", k, dt))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, self.tables.at("c1", k, dt))
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, self.tables.at("lr", state.count, dt))
        torch._foreach_sub_(ps, upd)
        state.count.add_(1)
        return state


def make_adam(cfg: Config, b1: float = 0.9, b2: float = 0.999) -> Adam:
    return Adam(poly_lr_table(cfg.lr, cfg.total_iters), cfg.weight_decay,
                b1, b2)


@dataclasses.dataclass
class TrainState:
    """Step count (host mirror), float32 parameters, the optimizer's state
    (SGD's momentum traces, or Adam's ``AdamState``) and the device step
    count; Mean Teacher, CoraNet and M3L add the teacher's EMA parameters
    (``ema_params``), cross-pseudo supervision a second network
    (``params2``, ``opt_state2``) under the same optimizer and count."""
    step: int
    params: Params
    opt_state: Union[Params, AdamState]
    tx: Union[SGD, Adam]
    count: torch.Tensor
    ema_params: Optional[Params] = None
    params2: Optional[Params] = None
    opt_state2: Optional[Union[Params, AdamState]] = None

    @classmethod
    def create(cls, params: Params, tx: Union[SGD, Adam],
               ema_params: Optional[Params] = None,
               params2: Optional[Params] = None) -> "TrainState":
        return cls(step=0, params=params, opt_state=tx.init(params), tx=tx,
                   count=zero_count(params), ema_params=ema_params,
                   params2=params2,
                   opt_state2=None if params2 is None else tx.init(params2))

    def update(self, grads: Params, grads2: Optional[Params] = None) -> None:
        """One optimizer update at the device count, in place (of both
        networks with ``grads2``), and the device count advanced once; the
        host ``step`` is left to the caller."""
        self.tx.update_(self.params, self.opt_state, grads, self.count)
        if grads2 is not None:
            self.tx.update_(self.params2, self.opt_state2, grads2,
                            self.count)
        self.count.add_(1)

    @torch.no_grad()
    def ema_update_(self, alpha: torch.Tensor) -> None:
        """``ema = ema * alpha + params * (1 - alpha)`` in place, ``alpha``
        a 0-d device tensor."""
        keys = list(self.ema_params)
        ema = [self.ema_params[k] for k in keys]
        torch._foreach_mul_(ema, alpha)
        torch._foreach_add_(ema, torch._foreach_mul(
            [self.params[k] for k in keys], 1.0 - alpha))

    def apply_gradients(self, grads: Params) -> "TrainState":
        """:meth:`update` and the host ``step`` advanced; returns self."""
        self.update(grads)
        self.step += 1
        return self


@dataclasses.dataclass
class GANTrainState:
    """Generator (SGD) + discriminator (Adam).  One step counter counts the
    iterations (``count`` on the device, ``step`` its host mirror); the
    train step advances it after both updates, so it is also the
    generator's count of earlier updates (the LR of its SGD), as the
    reference's shared ``self.iter`` drives both poly schedules."""
    step: int
    g_params: Params
    g_opt_state: Params
    d_params: Params
    d_opt_state: AdamState
    g_tx: SGD
    d_tx: Adam
    count: torch.Tensor

    @classmethod
    def create(cls, g_params: Params, d_params: Params, cfg: Config,
               beta1: float = 0.9, beta2: float = 0.999) -> "GANTrainState":
        g_tx, d_tx = make_sgd(cfg), make_adam(cfg, beta1, beta2)
        return cls(step=0, g_params=g_params, g_opt_state=g_tx.init(g_params),
                   d_params=d_params, d_opt_state=d_tx.init(d_params),
                   g_tx=g_tx, d_tx=d_tx, count=zero_count(g_params))

    def apply_d_gradients(self, grads: Params) -> "GANTrainState":
        """One Adam update of D, in place."""
        self.d_tx.update_(self.d_params, self.d_opt_state, grads, self.count)
        return self

    def apply_g_gradients(self, grads: Params) -> "GANTrainState":
        """One SGD update of G, in place, at the device count's LR."""
        self.g_tx.update_(self.g_params, self.g_opt_state, grads, self.count)
        return self
