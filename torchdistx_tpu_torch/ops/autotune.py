"""Flash-attention launch-shape tuner (the port's counterpart of
``torchdistx_tpu/ops/autotune.py``).

A block here is a launch shape of the bf16 forward and dq kernels: W
warps of 16 query rows a CTA over 64-key tiles, ``(block_q, block_k) =
(16·W, 64)``; :func:`~.flash_attention.built_blocks` lists the ones the
library builds.  The tuner times each candidate on the live device with
the JAX package's chain scheme (N data-dependent steps, two values of N
differenced, so launch latency cancels), picks the fastest, and
remembers the winner per (device name, shape, dtype, causality,
workload) in a small JSON file under ``config.cache_dir`` so a repeated
call measures nothing.

Usage::

    from torchdistx_tpu_torch.ops import make_flash_attention, tune_flash_blocks
    bq, bk = tune_flash_blocks(batch=2, seq_len=2048, heads=32, kv_heads=8,
                               head_dim=128, workload="bwd")
    attn = make_flash_attention(block_q=bq, block_k=bk)

Unlike the JAX tuner, candidates are not clamped to the sequence: a
launch shape is a CTA's row count, not a tile the sequence must fill.
On CPU tensors (``device="cpu"``) the plain version runs whatever the
block, so the tuner's search and cache work there (tests) but its
numbers mean nothing.

:data:`last_timings` holds the last measured call's seconds per
candidate (``inf`` for one the card refused), :data:`measurements` the
number of candidates measured since the last :func:`reset_counts`.
"""

from __future__ import annotations

import importlib
import json
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import torch

from .flash_attention import BlockConfigError, built_blocks

__all__ = ["BlockConfigError", "DEFAULT_CANDIDATES", "tune_flash_blocks"]

# Every shape the library builds at some head dim (built_blocks filters
# them by the call's head dim and dtype).
DEFAULT_CANDIDATES: Tuple[Tuple[int, int], ...] = ((64, 64), (128, 64))

last_timings: Dict[Tuple[int, int], float] = {}
measurements = 0


def reset_counts() -> None:
    global measurements
    measurements = 0
    last_timings.clear()


def _cache_path() -> str:
    from .. import config

    base = config.get().cache_dir or os.path.join(
        os.path.expanduser("~"), ".cache", "torchdistx_tpu_torch")
    return os.path.join(base, "flash_blocks.json")


def _cache_key(device_name: str, shape, dtype, causal: bool,
               workload: str) -> str:
    return (f"{device_name}|{'x'.join(map(str, shape))}|"
            f"{str(dtype).removeprefix('torch.')}|causal={causal}|"
            f"workload={workload}")


def _read_cache(key: str):
    try:
        with open(_cache_path()) as f:
            entry = json.load(f).get(key)
        return tuple(entry) if entry else None
    except (OSError, ValueError):
        return None


def _write_cache(key: str, blocks: Tuple[int, int]) -> None:
    path = _cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
        data[key] = list(blocks)
        # Atomic replace: concurrent tuners can lose each other's
        # read-modify-write, but no reader ever sees a torn file.
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)
    except OSError:
        pass  # tuning still returns the measured answer


_REFUSAL_TEXT = ("too many resources requested for launch",
                 "invalid configuration argument")


def _refusal_trigger(e: BaseException) -> Optional[str]:
    """The text that classified ``e`` as the card refusing a launch
    shape (a per-shape failure a tuner steps past), or None.  An out of
    memory error is not one: no launch shape fixes it."""
    s = str(e)
    for m in _REFUSAL_TEXT:
        if m in s:
            return m
    return None


def _sync(tensors) -> None:
    devices = {t.device for t in tensors if t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


def _chain(fn, carry, n: int):
    """``n`` data-dependent steps of ``fn`` from ``carry``, finished on
    the device."""
    for _ in range(n):
        carry = tuple(fn(*carry))
    _sync(carry)
    return carry


def _measure(fn, q, k, v, *, extra=(), n_lo=2, n_hi=10, repeats=2) -> float:
    """Per-step seconds by the JAX tuner's chain scheme: ``fn(*carry) ->
    carry`` threads ``(q, k, v, *extra)`` through N steps (a ``bwd``
    workload feeds all three gradients back, as a training step does),
    and the time of ``n_lo`` steps is taken from that of ``n_hi``.  The
    pair is repeated and the smallest positive difference wins; all
    non-positive differences are noise and measure as ``inf``.  A launch
    the card refuses raises :class:`BlockConfigError`; any other error
    propagates."""
    global measurements
    measurements += 1
    carry = (q, k, v, *extra)
    try:
        _chain(fn, carry, n_lo)  # warm: builds the library, first launches
        _chain(fn, carry, n_hi)
        deltas = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            _chain(fn, carry, n_lo)
            t_lo = time.perf_counter() - t0
            t0 = time.perf_counter()
            _chain(fn, carry, n_hi)
            t_hi = time.perf_counter() - t0
            deltas.append((t_hi - t_lo) / (n_hi - n_lo))
    except BlockConfigError:
        raise
    except Exception as e:
        if _refusal_trigger(e) is not None:
            raise BlockConfigError(str(e)) from e
        raise
    pos = [d for d in deltas if d > 0]
    return min(pos) if pos else float("inf")


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def tune_flash_blocks(
    *,
    batch: int = 4,
    seq_len: int = 2048,
    heads: int = 16,
    head_dim: int = 64,
    kv_heads: Optional[int] = None,
    causal: bool = True,
    dtype=torch.bfloat16,
    candidates: Optional[Sequence[Tuple[int, int]]] = None,
    use_cache: bool = True,
    workload: str = "fwd",
    device="cuda",
) -> Tuple[int, int]:
    """Measure ``candidates`` (by default the launch shapes the library
    builds at ``head_dim`` and ``dtype``) on ``device`` and return the
    fastest ``(block_q, block_k)``, cached per (device name, shape,
    dtype, causality, workload).

    ``workload`` selects what each candidate times, as in the JAX tuner:
    ``"fwd"`` the forward kernel; ``"bwd"`` the forward and the gradients
    of q, k and v (the dq and dk/dv kernels); ``"bias"`` the forward with
    an f32 [H, S, S] bias.  A cached winner is served only when it is one
    of the requested candidates.  A candidate the card refuses loses; if
    every candidate is refused, the last refusal is raised.  If every
    candidate measured as noise, the smallest is returned and nothing is
    cached."""
    from .._device import resolve_device

    # The module (the package re-exports its function under its name).
    fa = importlib.import_module(".flash_attention", __package__)

    if workload not in ("fwd", "bwd", "bias"):
        raise ValueError(f"unknown workload {workload!r}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    kv = kv_heads or heads
    shape = (batch, seq_len, heads, kv, head_dim)
    key = _cache_key(_device_name(dev), shape, dtype, causal, workload)
    if candidates is None:
        candidates = [c for c in DEFAULT_CANDIDATES
                      if c in built_blocks(dtype, head_dim)]
    cands = tuple(dict.fromkeys(tuple(c) for c in candidates))
    if use_cache:
        cached = _read_cache(key)
        if cached is not None and (not cands or cached in cands):
            return cached
    if not cands:
        raise ValueError("no candidate fits: the candidate list is empty")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def normal(*size, dt=dtype):
        return torch.randn(*size, generator=gen, device=dev, dtype=dt)

    q = normal(batch, seq_len, heads, head_dim)
    k = normal(batch, seq_len, kv, head_dim)
    v = normal(batch, seq_len, kv, head_dim)
    bias = (normal(heads, seq_len, seq_len, dt=torch.float32)
            if workload == "bias" else None)

    timings: Dict[Tuple[int, int], float] = {}
    best, best_t = None, float("inf")
    measured = []  # candidates the card ran
    refused, last_refusal = 0, None
    for bq, bk in cands:

        def fn(q, k, v, *rest, bq=bq, bk=bk):
            # Looked up at call time, so a patched flash_attention is seen.
            attn = fa.flash_attention
            if workload == "bwd":
                qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
                out = attn(qq, kk, vv, causal=causal, block_q=bq, block_k=bk)
                dq, dk, dv = torch.autograd.grad(out.float().sum(),
                                                 (qq, kk, vv))
                return ((q + 1e-6 * dq).to(q.dtype),
                        (k + 1e-6 * dk).to(k.dtype),
                        (v + 1e-6 * dv).to(v.dtype))
            out = attn(q, k, v, causal=causal, bias=rest[0] if rest else None,
                       block_q=bq, block_k=bk)
            return (out.to(q.dtype), k, v, *rest)

        try:
            t = _measure(fn, q, k, v, extra=() if bias is None else (bias,))
        except BlockConfigError as e:
            refused += 1
            last_refusal = e
            timings[(bq, bk)] = float("inf")
            continue
        timings[(bq, bk)] = t
        measured.append((bq, bk))
        if t < best_t:
            best, best_t = (bq, bk), t
    last_timings.clear()
    last_timings.update(timings)
    if refused == len(cands):
        raise last_refusal
    if best is None:
        # Every candidate the card ran measured as noise: the smallest,
        # never a refused one, and uncached (the next call re-measures).
        return min(measured, key=lambda c: c[0] * c[1])
    if use_cache:
        _write_cache(key, best)
    return best
