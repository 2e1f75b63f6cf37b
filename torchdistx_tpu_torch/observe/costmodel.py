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
``link_bandwidth_gbps`` is not ported yet.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

import torch

__all__ = ["mfu", "note_program_memory", "program_costs"]


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


def mfu(flops: float, seconds: float, peak_tflops: Optional[float]
        ) -> Optional[float]:
    """Achieved / peak for counted FLOPs over a measured wall time; None
    when either side is unusable (callers omit MFU rather than guess —
    the same contract as :func:`~.step.peak_tflops_for`)."""
    if not flops or not seconds or seconds <= 0 or not peak_tflops:
        return None
    return flops / seconds / 1e12 / peak_tflops
