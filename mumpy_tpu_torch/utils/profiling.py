"""Cost counting, device traces and step timing, counterpart of
``mumpy_tpu/utils/profiling.py``.

* :func:`cost_analysis` counts a callable's floating-point operations with
  ``torch.utils.flop_counter.FlopCounterMode`` (matrix products,
  convolutions, attention: the operations it has formulas for).
* :func:`model_flops` counts a model's forward on its plain path: the
  counter sees only aten operations, not the hand-written kernels the
  kernel path launches through ctypes, and the plain path computes the
  same function.
* :func:`trace` records a ``torch.profiler`` trace (with CUDA activity when
  a card is present) and writes it as a Chrome trace (Perfetto,
  ``chrome://tracing``).
* :class:`StepTimer` times steps, dropping the first ``warmup``: by CUDA
  events on the card, by the host clock after a synchronisation elsewhere.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["cost_analysis", "model_flops", "trace", "StepTimer"]


def cost_analysis(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """``{"flops": n}``: the floating-point operations of ``fn(*args,
    **kwargs)``, counted as it runs once (a multiply-add is two).  Unlike
    XLA's cost analysis there is no bytes figure: the counter sees the
    operations, not the memory traffic."""
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}


def model_flops(model: torch.nn.Module, *inputs, **kwargs) -> float:
    """Forward flops of ``model`` in eval mode on ``inputs`` (the serving
    forward, as the JAX package counts its deterministic apply), counted on
    its plain path: ``use_kernels`` off at every kernel site for the time of
    the count, the kernels' operands built (``prepare_for_inference``); the
    plain versions compute the functions the kernels compute.  The model's
    mode and kernel path are restored after."""
    from ..models.swin import KernelSite
    from .serving import prepare_for_inference

    sites = [m for m in model.modules() if isinstance(m, KernelSite)]
    before = [m.use_kernels for m in sites]
    training = model.training
    try:
        for m in sites:
            m.use_kernels = False
        prepare_for_inference(model)
        return cost_analysis(model, *inputs, **kwargs)["flops"]
    finally:
        for m, use in zip(sites, before):
            m.use_kernels = use
        model.train(training)


@contextlib.contextmanager
def trace(logdir: str):
    """Record the enclosed block under ``torch.profiler`` (CPU activity, and
    CUDA activity when a card is present) and write it to
    ``logdir/trace.json``, a Chrome trace.  Yields the profiler
    (``key_averages()`` for a table).  Usage::

        with trace("/tmp/profile"):
            step(...)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Per-step seconds, the first ``warmup`` steps dropped: ``start()``,
    then ``stop(result)``.  Where a card is present each step is timed by two
    CUDA events on the current stream (``stop`` waits for the second);
    elsewhere by the host clock.  ``result`` is accepted for the JAX package's signature (its
    ``block_until_ready``); the device is synchronised either way."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times = []
        self._n = 0
        self._cuda = torch.cuda.is_available()
        self._t0 = None

    def start(self):
        if self._cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self, result: Any = None) -> float:
        if self._cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = self._t0.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")
