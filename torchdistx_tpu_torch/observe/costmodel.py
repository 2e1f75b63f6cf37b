"""Device accounting for the training step (the port's counterpart of
``torchdistx_tpu/observe/costmodel.py``): the FLOPs a step runs, counted
by ``torch.utils.flop_counter``, the device-memory high-water mark, and
MFU.

The JAX package reads FLOPs from XLA's ``cost_analysis()`` of the
compiled step.  PyTorch runs eagerly, so :func:`program_costs` runs one
step under ``FlopCounterMode`` instead: every matrix product, and the
flash kernels through the FLOP formulas ``ops.flash_attention``
registers for its custom ops (the key/query pairs each kernel visits,
model FLOPs).  A DTensor operand counts its local shard — the work this
rank did — so the whole mesh's work is the count times the ranks.

:func:`link_bandwidth_gbps` measures the host→device copy rate of this
process's device, so the materializer's rate can be reported as a share
of what the link moves (``tdx.cuda.link_utilization``).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

__all__ = [
    "link_bandwidth_gbps",
    "link_probe_size_mb",
    "mfu",
    "note_program_memory",
    "program_costs",
    "reset_link_probe",
]


def _local_shapes(formula):
    """``formula`` (a ``flop_registry`` entry) on the local tensors of its
    DTensor operands."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_map

    def local(x):
        return x.to_local() if isinstance(x, DTensor) else x

    def wrapped(*args, out_val=None, **kwargs):
        args, kwargs, out_val = tree_map(local, (args, kwargs, out_val))
        return formula(*args, out_val=out_val, **kwargs)

    wrapped._get_raw = True
    return wrapped


def program_costs(step: Callable, *args, **kwargs) -> Tuple[object, Dict[str, float]]:
    """Run ``step(*args, **kwargs)`` once under ``FlopCounterMode`` and
    return ``(its result, costs)``: ``flops`` (this rank's), and on a CUDA
    device ``peak_bytes`` (``torch.cuda.max_memory_allocated`` after the
    step)."""
    from torch.utils.flop_counter import FlopCounterMode, flop_registry

    mapping = {k: _local_shapes(f) for k, f in flop_registry.items()}
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        out = step(*args, **kwargs)
    costs = {"flops": float(counter.get_total_flops())}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        costs["peak_bytes"] = float(torch.cuda.max_memory_allocated())
    return out, costs


# -- device-memory high-water --------------------------------------------------

_hbm_lock = threading.Lock()
_hbm_high_water = 0.0


def note_program_memory(costs: Optional[Dict[str, float]]) -> None:
    """Fold one step's ``peak_bytes`` into the process-wide
    ``tdx.cuda.hbm_high_water_bytes`` gauge (monotone max — the largest
    device footprint seen, the number an operator sizes a trainer by)."""
    global _hbm_high_water
    if not costs or not costs.get("peak_bytes"):
        return
    peak = costs["peak_bytes"]
    with _hbm_lock:
        if peak <= _hbm_high_water:
            return
        _hbm_high_water = peak
    from . import enabled, gauge

    if enabled():
        gauge("tdx.cuda.hbm_high_water_bytes").set(peak)


def reset() -> None:
    """Forget the high-water mark (tests)."""
    global _hbm_high_water
    with _hbm_lock:
        _hbm_high_water = 0.0


# -- link-bandwidth probe ----------------------------------------------------
#
# The materializer's GB/s needs a denominator: what THIS host→device link
# moves.  The probe copies pageable host buffers of a few SIZES to the
# device a few times each and keeps the best rate (max, not min: any
# interference only lowers a sample; the size sweep keeps a too-small
# buffer, whose fixed launch cost dominates, from under-measuring a fast
# link).  Measured once per process and cached: the link does not change
# under us, and the sweep takes well under a second.

_link_lock = threading.Lock()
_link_gbps: Optional[float] = None
_link_probe_mb: Optional[int] = None
_LINK_PROBE_SWEEP_MB = (8, 32, 128)
_LINK_PROBE_REPEATS = 3


def _probe_sizes_mb(probe_mb: Optional[int]) -> tuple:
    """The probe sizes to sweep: an explicit argument pins one size;
    ``TDX_LINK_PROBE_MB`` accepts one size or a comma list; default is
    the 8/32/128 MB sweep."""
    if probe_mb:
        return (int(probe_mb),)
    env = os.environ.get("TDX_LINK_PROBE_MB", "")
    if env:
        return tuple(int(p) for p in env.split(",") if p.strip())
    return _LINK_PROBE_SWEEP_MB


def _probe_device() -> torch.device:
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def link_bandwidth_gbps(probe_mb: Optional[int] = None, *,
                        cached_only: bool = False) -> Optional[float]:
    """Measured host→device copy rate (GB/s) of this process's device
    (the current CUDA device; the CPU where there is none, a host copy),
    cached per process; None when the probe failed.  Sweeps the
    ``TDX_LINK_PROBE_MB`` sizes (default 8,32,128 MB) and keeps the best
    size's best rate; the size is exported as a ``probe_mb`` label on
    the gauge ``tdx.cuda.link_bandwidth_gbps`` and by
    :func:`link_probe_size_mb`.

    ``cached_only`` returns the cached value or None WITHOUT probing:
    for callers inside a timed region or an open span, where the probe's
    copies would skew the very numbers it puts in context."""
    global _link_gbps, _link_probe_mb
    with _link_lock:
        if _link_gbps is not None:
            return _link_gbps if _link_gbps > 0 else None
        if cached_only:
            return None
        try:
            dev = _probe_device()
            best, best_mb = 0.0, None
            for mb in _probe_sizes_mb(probe_mb):
                n_bytes = mb * (1 << 20)
                # A deliberately UNALIGNED pageable view: an aligned or
                # pinned buffer can take a faster path than the
                # materializer's host data does (or none at all: a CPU
                # "copy" of an aliasable buffer), which would put a
                # fantasy denominator under the utilization.
                buf = torch.empty(n_bytes + 64, dtype=torch.uint8)
                host = buf[1:n_bytes + 1]
                for _ in range(_LINK_PROBE_REPEATS):
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    arr = host.to(dev, copy=True)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    dt = time.perf_counter() - t0
                    if dt > 0 and n_bytes / dt / 1e9 > best:
                        best, best_mb = n_bytes / dt / 1e9, mb
                    del arr
                del host, buf
            _link_gbps = best if best > 0 else -1.0
            _link_probe_mb = best_mb
        except Exception:  # noqa: BLE001 — no usable device
            _link_gbps = -1.0
        if _link_gbps > 0:
            from . import enabled, gauge

            if enabled():
                gauge("tdx.cuda.link_bandwidth_gbps").set(round(_link_gbps, 3))
                gauge("tdx.cuda.link_bandwidth_gbps",
                      probe_mb=_link_probe_mb).set(round(_link_gbps, 3))
            return _link_gbps
        return None


def link_probe_size_mb() -> Optional[int]:
    """The buffer size (MB) that won the link-probe sweep, or None when
    the probe has not run (or failed)."""
    with _link_lock:
        return _link_probe_mb


def reset_link_probe() -> None:
    """Forget the cached probe and the high-water mark (tests, as the
    JAX package's does)."""
    global _link_gbps, _link_probe_mb
    with _link_lock:
        _link_gbps = None
        _link_probe_mb = None
    reset()


def mfu(flops: float, seconds: float, peak_tflops: Optional[float]
        ) -> Optional[float]:
    """Achieved / peak for counted FLOPs over a measured wall time; None
    when either side is unusable (callers omit MFU rather than guess —
    the same contract as :func:`~.step.peak_tflops_for`)."""
    if not flops or not seconds or seconds <= 0 or not peak_tflops:
        return None
    return flops / seconds / 1e12 / peak_tflops
