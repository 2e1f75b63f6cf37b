"""Per-step training telemetry: :class:`StepMeter` (the port's own copy
of ``torchdistx_tpu/observe/step.py``) and the peak table MFU divides by.

Each step becomes a ``train.step`` span (blocking on the step's CUDA work,
so asynchronous launches cannot hide device time) and feeds derived
throughput gauges: ``tdx.train.tokens_per_s`` and — when FLOPs and a
peak are known — ``tdx.train.mfu`` or ``tdx.train.mfu_est``.
``parallel.train.make_train_step`` wires one of these around the step
when telemetry is enabled.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import torch

# Dense peak TFLOP/s of one card by compute dtype, by CUDA device-name
# substring (NVIDIA's H100 SXM data sheet, at the 700 W power limit; f32
# on the CUDA cores, no TF32).  Unknown names (and the CPU) have no peak:
# MFU is omitted rather than guessed.  The one home of these figures.
PEAK_TFLOPS = (
    ("H100 80GB HBM3", {torch.bfloat16: 989.0, torch.float32: 67.0}),
    ("H100 SXM", {torch.bfloat16: 989.0, torch.float32: 67.0}),
)
# The same H100 figures in FLOP/s (chip_smoke's bounds and MFU).
H100_PEAK_FLOPS = {dt: t * 1e12 for dt, t in PEAK_TFLOPS[0][1].items()}


def peak_tflops_for(device_name: str,
                    dtype: torch.dtype = torch.bfloat16) -> Optional[float]:
    """Peak dense TFLOP/s of ``dtype`` on the card ``device_name``
    (``torch.cuda.get_device_name``), or None when the card is unknown
    (callers must omit MFU, not guess)."""
    for sub, peaks in PEAK_TFLOPS:
        if sub.lower() in device_name.lower():
            return peaks.get(dtype)
    return None


class StepMeter:
    """Running throughput stats for a training loop, with per-step spans.

    * each ``start``/``stop`` pair records a span (default ``train.step``)
      when telemetry is enabled;
    * ``tokens_per_step`` derives a ``tdx.train.tokens_per_s`` gauge;
    * ``flops_per_step`` (+ ``peak_tflops``) derive ``tdx.train.tflops``
      and an MFU gauge whose NAME declares its provenance:
      ``tdx.train.mfu`` when ``flops_source="counted"`` (the FLOPs
      ``torch.utils.flop_counter`` counted on the step, via
      :mod:`.costmodel`), or ``tdx.train.mfu_est`` for the 6·N·D estimate
      (the default, so an uninstrumented caller can never mislabel a
      guess as measured).

    Works with telemetry disabled too — it then times the steps and
    records nothing.
    """

    def __init__(self, *, name: str = "train.step",
                 tokens_per_step: Optional[int] = None,
                 flops_per_step: Optional[float] = None,
                 peak_tflops: Optional[float] = None,
                 flops_source: str = "estimate"):
        self.name = name
        self.tokens_per_step = tokens_per_step
        self.flops_per_step = flops_per_step
        self.peak_tflops = peak_tflops
        self.flops_source = flops_source
        self.steps = 0
        self.total = 0.0
        self._t0: Optional[float] = None
        self._span = None
        self._gauges: dict = {}  # name → handle, looked up once

    def start(self) -> None:
        from . import enabled, tracer

        if enabled():
            self._span = tracer().span(self.name, "train", {"step": self.steps})
            self._span.__enter__()
        self._t0 = time.perf_counter()

    def stop(self, result: Any = None) -> float:
        """Close the step; ``result`` (if given) is blocked on first so
        the duration covers the device work, not just the launches."""
        if result is not None:
            from .spans import block_until_ready

            block_until_ready(result)
        dt = time.perf_counter() - self._t0
        self.steps += 1
        self.total += dt
        if self._span is not None:
            span, self._span = self._span, None
            derived = self._derived(dt)
            span.set(**derived)
            span.__exit__(None, None, None)
            self._set_gauges(dt, derived)
        return dt

    def _derived(self, dt: float) -> dict:
        out = {}
        if self.tokens_per_step:
            out["tokens_per_s"] = round(self.tokens_per_step / dt, 1)
        if self.flops_per_step:
            tflops = self.flops_per_step / dt / 1e12
            # 6 decimals: a toy CPU step is micro-TFLOP/s and must not
            # round to a 0.0 that reads as "no measurement".
            out["tflops"] = round(tflops, 6)
            if self.peak_tflops:
                key = "mfu" if self.flops_source == "counted" else "mfu_est"
                out[key] = round(tflops / self.peak_tflops, 4)
        return out

    def _set_gauges(self, dt: float, derived: dict) -> None:
        self._gauge("tdx.train.step_ms").set(dt * 1e3)
        for key, value in derived.items():
            self._gauge(f"tdx.train.{key}").set(value)
        if "mfu" not in derived and "tdx.train.mfu" in self._gauges:
            # Provenance downgraded mid-run (a shape past the counting
            # cache falls back to the estimate): the last counted value
            # must not linger as if live — poison it to NaN instead.
            self._gauges.pop("tdx.train.mfu").set(float("nan"))

    def _gauge(self, name: str):
        g = self._gauges.get(name)
        if g is None:
            from . import gauge

            g = self._gauges[name] = gauge(name)
        return g

    @property
    def mean(self) -> float:
        return self.total / max(1, self.steps)
