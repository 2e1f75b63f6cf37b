"""Keyed, counter-based random draws: the CUDA kernel's wrapper and its
plain PyTorch version.

The materializer (:mod:`..cuda_bridge.materialize`) draws every
``uniform_`` / ``normal_`` of a recording through :func:`keyed_fill_`:
Philox4x32-10 keyed by the op's 64-bit key, its counter the element's
global flat index in the entry's full contiguous shape divided by 4 (the
element takes lane ``index % 4`` of its block).  Every element is a pure
function of (key, index), so a rank can draw its shard alone — a box
``region`` of the full shape, given by per-dim ``start`` and the output's
shape — and the shard equals its slice of the whole draw bit for bit.
This is the counterpart of the partitionable threefry XLA generates for
the JAX bridge; it replaces no Pallas kernel.

What is drawn (all in f32, rounded once into f32, bf16 or f16):

* ``uniform``: ``u = (lane >> 8) * 2**-24`` in [0, 1), then
  ``lo + (hi - lo) * u`` with ``hi - lo`` rounded to f32 first;
* ``normal``: Box–Muller over the lane pairs (0, 1) and (2, 3) of the
  element's block, ``u1 = ((x0 >> 8) + 1) * 2**-24`` in (0, 1],
  ``u2 = (x1 >> 8) * 2**-24``, ``r = sqrt(-2 log u1)``,
  ``t = f32(2 pi) * u2``; the even lane takes ``r cos t``, the odd one
  ``r sin t``; then ``mean + std * z``.

:func:`keyed_fill_` launches the hand-written kernel
(``csrc/keyed_rng.cu``) on a CUDA tensor, or raises; on a CPU tensor it
runs :func:`keyed_draw_reference`, because the tensor lies on the CPU.
The plain version is the same Philox in int64 tensor ops: a uint32 ×
uint32 product overflows int64, so each multiplier is split into 16-bit
halves.  Its uniform draws equal the kernel's bitwise, on the CPU as on
the card.  For ``normal`` the kernel takes ``logf``, ``sinf`` and
``cosf`` in f32: the plain version does the same on a CUDA tensor
(within 2 ulp of the kernel), and on the CPU evaluates those three in
f64 and rounds each to f32 — torch's CPU loops run most elements through
SIMD code and a tensor's tail through scalar libm, whose last bits
differ, and an element's value must not depend on where it sits in the
tensor it is drawn into.

The kernel's launch comes from :func:`launch_plan`, a plain function of
the region: its merged dims, the number of runs (rows of the last merged
dim, each contiguous in the full tensor), the Philox blocks given to
each run (one thread each), and whether 32-bit index arithmetic covers
it (a full tensor below 2**34 elements, so every block index is below
2**32, and fewer than 2**31 local elements).

``launches`` counts the kernel's launches (one per call on a CUDA
tensor).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

__all__ = ["DTYPES", "LaunchPlan", "keyed_draw_reference", "keyed_fill_",
           "launch_plan", "launches", "merge_region", "philox4x32", "SOURCE"]

SOURCE = "keyed_rng.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
KINDS = {"uniform": 0, "normal": 1}
_MAX_DIMS = 8  # kMaxDims in csrc/keyed_rng.cu
# The 32-bit path: block indices below 2**32, and local indices and slot
# numbers (at most 7/4 of the elements) below kNarrowSlots.
_NARROW_FULL = 1 << 34
_NARROW_LOCAL = 1 << 31

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_TWO_POW_M24 = 2.0 ** -24
_TWO_PI_F32 = float(np.float32(2 * math.pi))
# Elements per chunk of the plain version (its int64 temporaries are
# ~10x the chunk): small on the CPU, large on the card, where each of its
# ~400 tensor ops a chunk is a launch.
_CHUNK = {"cpu": 1 << 20, "cuda": 1 << 24}

launches = 0


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` 32-bit words of ``m * x`` for a 32-bit constant ``m``
    and int64 ``x`` in [0, 2**32), without overflowing int64: ``m`` is
    split into 16-bit halves, each partial product below 2**48."""
    p_lo = x * (m & 0xFFFF)
    p_hi = x * (m >> 16)
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32(block: torch.Tensor, key: int) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 of the counters ``(block mod 2**32, block >> 32, 0,
    0)`` (int64 ``block``) under the 64-bit ``key`` (its low word first):
    the four output words as int64 tensors in [0, 2**32)."""
    k0, k1 = key & _MASK32, (key >> 32) & _MASK32
    c0 = block & _MASK32
    c1 = block >> 32
    c2 = torch.zeros_like(block)
    c3 = torch.zeros_like(block)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def merge_region(full_shape: Sequence[int], start: Sequence[int],
                 shape: Sequence[int]) -> Tuple[Tuple[int, ...],
                                                Tuple[int, ...], int]:
    """``(lengths, full_strides, base)`` of a box region of a contiguous
    tensor of ``full_shape``: dims merged wherever the inner dims are
    whole (their region spans the full extent), the last stride 1, and
    ``base`` the global index of the region's first element."""
    full_shape, start, shape = list(full_shape), list(start), list(shape)
    if not (len(full_shape) == len(start) == len(shape)):
        raise ValueError(f"region {start} + {shape} does not match the full "
                         f"shape {full_shape}")
    for f, s, n in zip(full_shape, start, shape):
        if s < 0 or n < 0 or s + n > f:
            raise ValueError(f"region {start} + {shape} is outside the full "
                             f"shape {full_shape}")
    stride, acc = [], 1
    for f in reversed(full_shape):
        stride.append(acc)
        acc *= f
    stride.reverse()
    base = sum(s * st for s, st in zip(start, stride))
    lens, strides = [], []
    for d in range(len(shape)):
        if lens and d > 0 and shape[d] == full_shape[d]:
            lens[-1] *= shape[d]
            strides[-1] = stride[d]
        else:
            lens.append(shape[d])
            strides.append(stride[d])
    if not lens:  # a 0-d tensor: one element
        lens, strides = [1], [1]
    return tuple(lens), tuple(strides), base


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """What one kernel launch needs for a region (:func:`launch_plan`).

    A *slot* is one thread's Philox block: run ``r`` owns slots
    ``r * slots_per_run`` to ``(r + 1) * slots_per_run - 1``, the blocks
    from the one holding the run's first element on; a slot past the
    run's last block writes nothing, and a block's lanes outside the run
    are masked."""

    lens: Tuple[int, ...]     # merged dims (merge_region)
    strides: Tuple[int, ...]  # the full tensor's stride per merged dim
    base: int                 # global index of the region's first element
    n: int                    # elements in the region
    runs: int                 # rows of the last merged dim
    run_len: int              # elements in each run
    head: int                 # the lane each run starts at, -1 if they differ
    slots_per_run: int
    slots: int                # runs * slots_per_run
    narrow: bool              # 32-bit index arithmetic


def launch_plan(full_shape: Sequence[int], start: Sequence[int],
                shape: Sequence[int]) -> LaunchPlan:
    """The kernel's launch for the region at ``start`` of ``full_shape``
    with ``shape``.  Every run starts at the same lane when each merged
    dim that varies (length > 1) strides by a multiple of 4, and then
    takes ``ceil((head + run_len) / 4)`` blocks; otherwise each run is
    given the most any start lane needs, ``(run_len + 6) // 4``."""
    lens, strides, base = merge_region(full_shape, start, shape)
    n = math.prod(int(x) for x in shape)
    runs = math.prod(lens[:-1])
    run_len = lens[-1]
    same = all(st % 4 == 0 for ln, st in zip(lens[:-1], strides[:-1])
               if ln > 1)
    head = base % 4 if same else -1
    per_run = (head + run_len + 3) // 4 if same else (run_len + 6) // 4
    narrow = (math.prod(int(x) for x in full_shape) < _NARROW_FULL
              and n < _NARROW_LOCAL)
    return LaunchPlan(lens, strides, base, n, runs, run_len, head, per_run,
                      runs * per_run, narrow)


def _run_starts(lens, strides, base, device) -> torch.Tensor:
    """The global index of the first element of every run (the last merged
    dim), in row-major order of the region."""
    starts = torch.full((1,), base, dtype=torch.int64, device=device)
    for n, st in zip(lens[:-1], strides[:-1]):
        offs = torch.arange(n, dtype=torch.int64, device=device) * st
        starts = (starts[:, None] + offs[None, :]).reshape(-1)
    return starts


def _lane_values(c, kind: str, a: float, b: float,
                 exact: bool) -> torch.Tensor:
    """[..., 4] f32 values of the four lanes of each block."""
    if kind == "uniform":
        u = (torch.stack(c, dim=-1) >> 8).to(torch.float32) * _TWO_POW_M24
        return u.mul_(b).add_(a)
    dev = c[0].device
    two_pi = torch.tensor(_TWO_PI_F32, dtype=torch.float32, device=dev)
    outs = []
    for x0, x1 in ((c[0], c[1]), (c[2], c[3])):
        u1 = ((x0 >> 8) + 1).to(torch.float32) * _TWO_POW_M24
        u2 = (x1 >> 8).to(torch.float32) * _TWO_POW_M24
        lg = torch.log(u1.double()).float() if exact else torch.log(u1)
        rad = torch.sqrt(lg * -2.0)
        t = u2 * two_pi
        if exact:
            cos, sin = torch.cos(t.double()).float(), torch.sin(t.double()).float()
        else:
            cos, sin = torch.cos(t), torch.sin(t)
        outs += [rad * cos, rad * sin]
    z = torch.stack(outs, dim=-1)
    return z.mul_(b).add_(a)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _params(kind: str, a: float, b: float) -> Tuple[float, float]:
    """The kernel's two f32 operands: ``(lo, hi - lo)`` for uniform (the
    span rounded to f32 from f32 bounds), ``(mean, std)`` for normal."""
    if kind == "uniform":
        lo, hi = np.float32(a), np.float32(b)
        return float(lo), float(np.float32(hi - lo))
    return _f32(a), _f32(b)


def keyed_draw_reference(shape: Sequence[int], dtype: torch.dtype, kind: str,
                         a: float, b: float, key: int,
                         full_shape: Optional[Sequence[int]] = None,
                         start: Optional[Sequence[int]] = None,
                         device=None) -> torch.Tensor:
    """The plain version: a new tensor of ``shape`` holding the draws of
    the region at ``start`` of ``full_shape`` (the whole of ``shape`` by
    default) on ``device``.  ``kind`` is ``uniform`` (``a``, ``b`` = low,
    high) or ``normal`` (mean, std)."""
    shape = tuple(int(s) for s in shape)
    full_shape = shape if full_shape is None else tuple(full_shape)
    start = (0,) * len(shape) if start is None else tuple(start)
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {tuple(KINDS)}, not {kind!r}")
    device = torch.device("cpu" if device is None else device)
    lens, strides, base = merge_region(full_shape, start, shape)
    pa, pb = _params(kind, a, b)
    exact = device.type == "cpu"
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    if n == 0:
        return out.to(dtype).reshape(shape)
    L = lens[-1]
    starts = _run_starts(lens, strides, base, device)
    # Sub-runs of at most _CHUNK elements, so each piece's temporaries stay
    # bounded: (run start + offset, piece length).
    chunk = _CHUNK.get(device.type, _CHUNK["cpu"])
    piece = min(L, chunk)
    per = max(1, chunk // piece)
    pos = 0
    for off in range(0, L, piece):
        m = min(piece, L - off)
        nb = (m + 3) // 4 + 1
        lane_idx = torch.arange(nb * 4, device=device)
        for r0 in range(0, starts.numel(), per):
            s = starts[r0:r0 + per] + off
            blocks = (s >> 2)[:, None] + torch.arange(nb, device=device)[None]
            vals = _lane_values(philox4x32(blocks, key), kind, pa, pb, exact)
            vals = vals.reshape(len(s), nb * 4)
            take = (s & 3)[:, None] + lane_idx[None, :m]
            got = torch.gather(vals, 1, take)
            # Row-major order of the region: piece `off` of every run.
            rows = torch.arange(r0, r0 + len(s), device=device)
            idx = (rows[:, None] * L + off
                   + torch.arange(m, device=device)[None, :])
            out[idx.reshape(-1)] = got.reshape(-1)
            pos += got.numel()
    assert pos == n
    return out.to(dtype).reshape(shape)


_kernel_fn = None


def _kernel():
    global _kernel_fn
    if _kernel_fn is None:
        lib = _build.load(SOURCE)
        fn = lib.tdx_keyed_rng
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_uint,
                       ctypes.c_uint, ctypes.c_float, ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.tdx_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tdx_cuda_error_string.restype = ctypes.c_char_p
        _kernel_fn = fn
    return _kernel_fn


def build_kernel() -> None:
    """Build (or fetch) and load the kernel library now, instead of at
    its first launch."""
    _kernel()


def keyed_fill_(out: torch.Tensor, kind: str, a: float, b: float, key: int,
                full_shape: Optional[Sequence[int]] = None,
                start: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Fill ``out`` in place with the draws of ``kind`` (``uniform`` with
    low ``a`` and high ``b``, ``normal`` with mean ``a`` and std ``b``)
    under the 64-bit ``key`` for the region of ``full_shape`` (default:
    ``out``'s shape) that starts at ``start`` and has ``out``'s shape.

    A CUDA tensor launches the kernel on the current stream (one count
    in ``launches``) or raises; a CPU tensor takes
    :func:`keyed_draw_reference`.  A non-contiguous ``out`` is drawn
    into a contiguous buffer and copied in."""
    global launches
    if out.dtype not in DTYPES:
        raise TypeError(f"keyed draws fill {tuple(DTYPES)}, not {out.dtype}")
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {tuple(KINDS)}, not {kind!r}")
    shape = tuple(out.shape)
    full_shape = shape if full_shape is None else tuple(int(s) for s in full_shape)
    start = (0,) * len(shape) if start is None else tuple(int(s) for s in start)
    if out.device.type == "cpu":
        out.copy_(keyed_draw_reference(shape, out.dtype, kind, a, b, key,
                                       full_shape, start, device="cpu"))
        return out
    if out.device.type != "cuda":
        raise ValueError(f"keyed draws run on cuda or cpu, not {out.device}")
    plan = launch_plan(full_shape, start, shape)
    if len(plan.lens) > _MAX_DIMS:
        raise ValueError(f"a region of {len(plan.lens)} merged dims; the "
                         f"kernel takes at most {_MAX_DIMS}")
    target = out if out.is_contiguous() else torch.empty(
        shape, dtype=out.dtype, device=out.device)
    if plan.n:
        fn = _kernel()
        pa, pb = _params(kind, a, b)
        arr = ctypes.c_longlong * len(plan.lens)
        with torch.cuda.device(out.device):
            stream = torch.cuda.current_stream(out.device).cuda_stream
            err = fn(target.data_ptr(), DTYPES[out.dtype], KINDS[kind],
                     int(not plan.narrow), len(plan.lens), arr(*plan.lens),
                     arr(*plan.strides), plan.base, plan.slots_per_run,
                     plan.slots, key & _MASK32, (key >> 32) & _MASK32, pa,
                     pb, stream)
        if err != 0:
            msg = _build.load(SOURCE).tdx_cuda_error_string(err)
            raise RuntimeError(f"keyed_rng launch failed: CUDA error {err} "
                               f"({msg.decode()})")
        launches += 1
    if target is not out:
        out.copy_(target)
    return out
