"""Profiling and tracing utilities, port of
``flamingo_mini_tpu/utils/profiling.py`` on PyTorch's own tools.

* ``trace(logdir)``: a ``torch.profiler`` trace of everything inside the
  block (host activity, and the card's kernels when a card is present),
  written under ``logdir`` as a Chrome trace (``*.pt.trace.json``, which
  TensorBoard's profiler plugin and ``chrome://tracing`` read);
* ``annotate(name)``: a named span in that trace
  (``torch.profiler.record_function``), so phases such as encode, prefill
  and decode show up by name;
* ``PhaseTimer``: host wall-clock time per phase, each phase fenced on the
  card (the counterpart of ``block_until_ready``), so asynchronous launches
  are counted where they run;
* ``debug_nans(enable)``: the first operation that yields a NaN raises
  ``FloatingPointError`` naming it, as ``jax_debug_nans`` does.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..ops import cuda_build


@contextlib.contextmanager
def trace(logdir: str, host_tracer_level: int = 2):
    """Profile the block; on exit write ``<host>.<time>.pt.trace.json``
    under ``logdir``. CPU activity is recorded at ``host_tracer_level`` 1
    and above (shapes too at 3, as JAX's verbose host tracer), the card's
    kernels whenever CUDA is available. Yields the
    ``torch.profiler.profile``."""
    activities = []
    if host_tracer_level > 0:
        activities.append(torch.profiler.ProfilerActivity.CPU)
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities, record_shapes=host_tracer_level >= 3,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof


def annotate(name: str):
    """Named span in traces: ``with annotate('prefill'): ...``"""
    return torch.profiler.record_function(name)


def _fence(value) -> None:
    """Wait until the card has computed every CUDA tensor in ``value`` (a
    tensor, or lists, tuples and dicts of them), each on its own device."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _fence(v)
    elif isinstance(value, dict):
        for v in value.values():
            _fence(v)


class PhaseTimer:
    """Host-side per-phase wall-clock accounting.

    >>> timer = PhaseTimer()
    >>> with timer.phase("vision_encode"):
    ...     feats = timer.fence(encode(...))   # waited for when the phase closes
    >>> timer.summary()
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._last_result = None

    @contextlib.contextmanager
    def phase(self, name: str, result=None):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            if self._last_result is not None:
                _fence(self._last_result)
                self._last_result = None
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def fence(self, value):
        """Mark a value to be waited for when the phase closes."""
        self._last_result = value
        return value

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }


# aten ops whose output is uninitialised memory, not a computed value
_UNINITIALISED = ("empty", "new_empty", "empty_like", "empty_strided",
                  "new_empty_strided", "resize_")


def _nan_in(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_floating_point() and bool(torch.isnan(out).any())
    if isinstance(out, (list, tuple)):
        return any(_nan_in(o) for o in out)
    return False


class _NanCheck(TorchDispatchMode):
    """Every aten op's floating outputs checked for NaN as it returns."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.__name__.split(".")[0] not in _UNINITIALISED and _nan_in(out):
            raise FloatingPointError(f"debug_nans: {func} produced NaN")
        return out


_nan_mode: Optional[_NanCheck] = None


def debug_nans(enable: bool = True) -> None:
    """Global NaN checking. While it is on, the first operation that yields
    a NaN raises ``FloatingPointError`` naming it: every aten op of the
    calling thread and of autograd's backward (a dispatch mode, and
    ``torch.autograd.set_detect_anomaly``), and every hand-written kernel's
    outputs, which the dispatcher never sees
    (``ops.cuda_build.check``). ``debug_nans(False)`` removes both;
    off, nothing is checked and nothing is paid."""
    global _nan_mode
    if enable and _nan_mode is None:
        _nan_mode = _NanCheck()
        _nan_mode.__enter__()
        torch.autograd.set_detect_anomaly(True)
    elif not enable and _nan_mode is not None:
        _nan_mode.__exit__(None, None, None)
        _nan_mode = None
        torch.autograd.set_detect_anomaly(False)
    cuda_build.nan_checks = enable
