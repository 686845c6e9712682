# -*- coding: utf-8 -*-
"""CUDA graphs of the port's device work: the counterpart of the JAX
package's ``jax.jit`` programs, one graph per input shape as ``jit``
compiles one program per shape.

:class:`Replay` wraps ``fn(inputs) -> outputs``, dicts of tensors, where
``fn`` does its work on the card without waiting on it and without a host
value that changes between calls (the train states keep their step counts
and learning rates on the device, train/state.py).  On the card, per input
signature (names, shapes, dtypes, and whether ``ops.plain()`` is on):

1. the first call runs ``fn`` eagerly on the capture stream, on the
   signature's fixed input buffers: a real call (a training iteration of
   the run), which also builds what the kernels set up once -- the norm
   tickets of that stream (``ops/instnorm.py`` ``tickets``), the norm
   plans and the shared-memory opt-ins -- so that capture finds them;
2. the second call copies its inputs into the buffers, captures ``fn``
   into a graph (capture computes nothing, so the counters of the
   kernels' launches are put back where they were) and replays it;
3. every later call copies its inputs into the buffers, replays the graph
   on the current stream and adds the launches the capture counted
   (``ops.add_counts``).

The outputs a replay returns are the graph's own buffers: the next replay
overwrites them.  A failed capture raises.  Off the card, and with
``capture=False``, a call is ``fn`` on the inputs moved to the device.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from smsut_tpu_torch import ops

Tensors = Dict[str, torch.Tensor]

_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The one side stream of ``device`` that every graph is warmed and
    captured on: its norm tickets exist once the first warm-up ran."""
    i = device.index if device.index is not None else \
        torch.cuda.current_device()
    s = _STREAMS.get(i)
    if s is None:
        s = _STREAMS[i] = torch.cuda.Stream(device=i)
    return s


class _Entry:
    def __init__(self, static: Tensors):
        self.static = static
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.out: Optional[Tensors] = None
        self.counts: List[int] = []


class Replay:
    """``fn`` replayed as a CUDA graph per input signature on a CUDA
    ``device`` when ``capture``; called directly otherwise."""

    def __init__(self, fn: Callable[[Tensors], Tensors],
                 device: torch.device, capture: bool = True):
        self.fn = fn
        self.device = torch.device(device)
        self.captures = bool(capture) and self.device.type == "cuda"
        self._entries: Dict[tuple, _Entry] = {}

    @property
    def graphs(self) -> int:
        """The graphs captured so far."""
        return sum(e.graph is not None for e in self._entries.values())

    def __call__(self, inputs: Tensors) -> Tensors:
        if not self.captures:
            return self.fn({k: v.to(self.device, non_blocking=True)
                            for k, v in inputs.items()})
        key = (ops.plain_active(),) + tuple(
            (k, tuple(v.shape), v.dtype) for k, v in sorted(inputs.items()))
        e = self._entries.get(key)
        if e is None:
            e = self._entries[key] = _Entry({
                k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                for k, v in inputs.items()})
            self._load(e, inputs)
            return self._on_side(lambda: self.fn(e.static))
        self._load(e, inputs)
        if e.graph is None:
            self._capture(e)
        e.graph.replay()
        ops.add_counts(e.counts)
        return e.out

    @staticmethod
    def _load(e: _Entry, inputs: Tensors) -> None:
        for k, v in inputs.items():
            e.static[k].copy_(v, non_blocking=True)

    def _on_side(self, f):
        cur = torch.cuda.current_stream(self.device)
        side = capture_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = f()
        cur.wait_stream(side)
        return out

    def _capture(self, e: _Entry) -> None:
        side = capture_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        graph = torch.cuda.CUDAGraph()
        before = ops.counts()
        # the loaders' producer threads pin host memory while this thread
        # captures: "thread_local" keeps their calls out of this capture's
        # checks (in "global" mode a cudaHostAlloc there would end it)
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            out = self.fn(e.static)
        e.counts = [a - b for a, b in zip(ops.counts(), before)]
        ops.add_counts([-d for d in e.counts])
        e.graph, e.out = graph, out
