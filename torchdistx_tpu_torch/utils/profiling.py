"""Profiling hooks over ``torch.profiler``, and deprecated host-timer shims
(the port's own copy of ``torchdistx_tpu/utils/profiling.py``).

``trace`` records the enclosed region's CPU and CUDA activity with
``torch.profiler`` and writes a Chrome trace (Perfetto / chrome://tracing)
into ``logdir``; ``annotate`` adds a named region to that timeline.
Host-side wall timing lives in :mod:`torchdistx_tpu_torch.observe`:
``observe.span`` lands in the exported trace, and ``observe.StepMeter``
is the training-loop successor of ``StepTimer``.  ``Timer`` and
``StepTimer`` survive as deprecation shims with their original
semantics.

Usage::

    from torchdistx_tpu_torch.utils import annotate, trace

    with trace("/tmp/prof"):
        with annotate("tdx.step"):
            state, loss = train_step(state, batch)
    # /tmp/prof/trace-<pid>-<n>.json names the step's kernels
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
import warnings
from typing import Any, Iterator, Optional

import torch

from .. import observe

__all__ = ["StepTimer", "Timer", "annotate", "trace", "last_trace_path"]

_trace_no = itertools.count()
_last_trace: Optional[str] = None


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region (CPU, and CUDA where a device exists)
    and write its Chrome trace to ``logdir/trace-<pid>-<n>.json``
    (:func:`last_trace_path` gives the file).  The device is synchronized
    before the profile stops, so the region's kernels are in it."""
    global _last_trace
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace-{os.getpid()}-{next(_trace_no)}.json")
    prof = torch.profiler.profile(activities=_activities())
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(path)
        _last_trace = path


def last_trace_path() -> Optional[str]:
    """The file the last :func:`trace` region wrote, or None."""
    return _last_trace


def annotate(name: str):
    """A named region on the profiler's timeline (``record_function``)."""
    return torch.profiler.record_function(name)


class Timer:
    """DEPRECATED shim: use ``observe.span(name)`` (the measurement then
    lands in the exported trace too).

    >>> with Timer() as t:
    ...     out = step(state, batch)
    ...     t.block_on(out)
    >>> t.elapsed
    """

    def __init__(self):
        warnings.warn(
            "torchdistx_tpu_torch.utils.profiling.Timer is deprecated; use "
            "torchdistx_tpu_torch.observe.span(...) instead.",
            DeprecationWarning,
            stacklevel=2,
        )
        self.elapsed: Optional[float] = None
        self._blocked: Any = None
        self._span = None

    def __enter__(self) -> "Timer":
        self._span = observe.span("utils.Timer", category="compat")
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def block_on(self, value: Any) -> Any:
        self._blocked = value
        return value

    def __exit__(self, *exc) -> None:
        if self._blocked is not None:
            devices = {t.device for t in _tensors(self._blocked)
                       if t.device.type == "cuda"}
            for d in devices:
                torch.cuda.synchronize(d)
            self._blocked = None  # don't pin device tensors past the scope
        self.elapsed = time.perf_counter() - self._t0
        span, self._span = self._span, None
        span.__exit__(None, None, None)


def _tensors(value: Any):
    from torch.utils._pytree import tree_leaves

    return [x for x in tree_leaves(value) if isinstance(x, torch.Tensor)]


class StepTimer(observe.StepMeter):
    """DEPRECATED shim: use :class:`torchdistx_tpu_torch.observe.StepMeter`
    (the same ``start``/``stop``/``steps``/``total``/``mean`` surface,
    plus per-step spans and tokens-per-second / MFU gauges)."""

    def __init__(self):
        warnings.warn(
            "torchdistx_tpu_torch.utils.profiling.StepTimer is deprecated; "
            "use torchdistx_tpu_torch.observe.StepMeter instead.",
            DeprecationWarning,
            stacklevel=2,
        )
        super().__init__(name="utils.StepTimer")
