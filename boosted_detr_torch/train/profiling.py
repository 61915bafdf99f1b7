"""Profiling and observability: a trace context, a step-time and
images-per-second meter, operation counts and a scoped NaN check.

Counterpart of boosted_detr_tpu/train/profiling.py, over PyTorch's tools:
``trace`` writes a ``torch.profiler`` trace (TensorBoard's profile plugin
or chrome://tracing read it) where JAX's writes ``jax.profiler``'s;
``StepMeter`` synchronises the card at each tick, so that a step's time is
the card's and not its enqueue's; ``compiled_cost`` counts floating-point
operations with ``torch.utils.flop_counter.FlopCounterMode``, where JAX
reads XLA's cost analysis; ``debug_nans`` raises at the first operation
whose output holds a NaN, as ``jax_debug_nans`` does.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace of the block, CPU and (where there is a
    card) CUDA activity, written into ``logdir`` as a TensorBoard trace
    file when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(logdir)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=handler):
        yield


class StepMeter:
    """Images/sec and step-time meter that skips ``warmup`` intervals. Each
    ``tick`` waits for the card (``torch.cuda.synchronize``) before it
    reads the clock, unless ``device`` is the CPU; ``device`` is ``cuda``
    unless the caller passes another."""

    def __init__(self, batch_size: int, warmup: int = 2, device=None):
        from boosted_detr_torch.models.detr import _resolve_device

        self.batch_size = batch_size
        self.warmup = warmup
        self.device = _resolve_device(device)
        self._times = []
        self._last = None

    def tick(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    @property
    def step_time(self) -> float:
        steady = self._times[self.warmup:]
        return sum(steady) / len(steady) if steady else float("nan")

    @property
    def images_per_sec(self) -> float:
        st = self.step_time
        return self.batch_size / st if st == st and st > 0 else float("nan")

    def summary(self) -> Dict[str, float]:
        return {"step_time_ms": self.step_time * 1e3,
                "images_per_sec": self.images_per_sec,
                "steps_measured": len(self._times)}


def compiled_cost(fn: Callable, *args) -> Dict[str, float]:
    """The floating-point operations of one call ``fn(*args)``, counted by
    ``FlopCounterMode`` from the shapes of the matrix products,
    convolutions and attentions it dispatches (a multiply-add counts 2),
    the backward's included where ``fn`` runs one. Returns ``{"flops":
    ...}``. JAX's ``bytes_accessed`` is left out: PyTorch has no count of
    the bytes a call moves, and no number is made up for it here. The call
    runs (PyTorch compiles nothing ahead), so its side effects happen."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops())}


class _NaNCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and torch.isnan(t).any().item()):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped NaN check, as ``jax_debug_nans``: inside the block every
    operation's floating-point outputs are read, and the first that holds
    a NaN raises ``FloatingPointError`` naming the operation (an infinity
    passes, as it does in JAX). Each check reads a value back from the
    card, so the block runs far slower than without it."""
    if not enable:
        yield
        return
    with _NaNCheck():
        yield
