"""Materialize a deferred-init recording into (sharded) device memory,
with keyed RNG (counterpart of ``torchdistx_tpu/jax_bridge/materialize.py``'s
public API and its self-healing engine).

The JAX bridge compiles the recording into XLA programs.  Here the
recording is already torch ops, so it is replayed on the local device,
in recorded (``op_nr``) order, with four differences from the eager
:func:`..deferred_init.materialize_module`:

* **Keyed, counter-based RNG.**  Every ``uniform_`` / ``normal_`` draws
  through the hand-written Philox kernel (:mod:`..ops.keyed_rng`), keyed
  by a fixed mix (splitmix64) of ``seed`` and the op's session-relative
  ``key_nr`` (:func:`op_seed`, the counterpart of the JAX bridge's
  ``fold_in(PRNGKey(seed), key_nr)``), its counter the element's global
  index in the entry's full shape.  Values are a function of the seed and
  the recording: not of the global generator, of the mesh, of what else
  was recorded, or of the order of materialization; the uniform bits are
  the same on the CPU (the kernel's plain version) as on the card.  Other
  random ops (``randint``, ``randperm``, ``bernoulli``, ...) and f64
  draws take a ``torch.Generator`` of their own, seeded by the same key,
  over the full entry (ROADMAP C4).
* **Shard-local replay.**  An entry whose call stack is *elementwise
  closed* — one factory (``empty`` / ``zeros`` / ``ones`` / ``full``) of
  the entry's full shape, then keyed fills, in-place unary or scalar ops
  (``erfinv_``, ``mul_``, ``add_``, ``clamp_``, ``fill_``, ``zero_``,
  ...), whole-storage aliases (``detach``) and dtype casts — is replayed
  on this rank's local shape only, the kernel given the shard's region:
  a rank allocates and draws its shard and nothing more.  Every other
  entry replays whole (through the kernel too) and keeps its slice.
  Either way a shard equals its slice of ``mesh=None`` bit for bit.
* **Sharded results.**  The rank keeps its planned local shard, as a
  ``DTensor`` on a ``DeviceMesh`` (a plain tensor with ``mesh=None``, or
  for one coordinate of a :class:`..parallel.mesh.VirtualMesh`).
* **The recording is not consumed.**  Values live in a run-local table,
  each freed after its last consumer; the module stays fake and can be
  materialized again, under another mesh.  Values that were read while
  recording (early replay) are copied from their nodes.

``param_dtype`` casts floating ``nn.Parameter`` entries after their
recorded-precision init; buffers keep their recorded dtype.  Tied
weights are one entry.  Under a :class:`..parallel.sharding.StageShardingPlan`
a pipeline stage materializes only the block layers it owns (and the
entries every stage holds).

**The engine** (``TDX_MATERIALIZE_PIPELINE``, docs in :mod:`..config`).
``auto`` splits the entries into the JAX function's structural groups
(:mod:`.groups`); ``off`` makes them one group.  Each group runs three
stages, each at its chaos site (the 1-based group number): ``lower``
(the group's replay plan) and ``compile`` (the kernel library's lookup),
both under the ``TDX_COMPILE_DEADLINE_S`` watchdog (:func:`_bounded_stage`
abandons a stage past it and raises :class:`CompileHangError`), and
``execute`` (the replay, which cannot be abandoned: a CUDA replay still
running would race its own retry, ROADMAP C17).  Each stage runs the
retry ladder (:func:`_run_ladder`, ``TDX_MATERIALIZE_RETRIES``, backoff)
over the retryable errors.  When groups exhaust their retries, the last
rung replays the whole recording once more (chaos group 1); only then
does :class:`MaterializationError` escape, with a flight dump.  With
``TDX_MATERIALIZE_RETRIES=0`` nothing is retried, the last rung
included.  ``corrupt`` at the three sites damages the kernel-library
cache (``TDX_CACHE_DIR``), which the CRC check quarantines at the next
load.

**Resume** (``TDX_MATERIALIZE_RESUME_DIR``).  Each rank commits every
completed group's local values under ``<dir>/<coordinate>/`` in the JAX
layout (``MATERIALIZE_PROGRESS.json``, ``version: 1``; per group a
fingerprint-named directory of ``out_NNNN.bin`` payloads with CRC32s,
the manifest written after the payload), in the init dtype
(:mod:`.transport`).  The commit (a device→host copy into pinned memory,
then the write) runs on a writer thread while the next group replays,
up to ``TDX_MATERIALIZE_OVERLAP_DEPTH`` groups in flight.  A rerun loads
each group whose fingerprint and CRCs match (one staging buffer and one
host→device copy per group) and recomputes on any mismatch; a completed
run sweeps the directory.  A SIGTERM (on the main thread) commits what is
done and raises :class:`MaterializationError` with ``drained=True``.

With telemetry on, each call is one ``materialize`` span carrying the
entries by path (``local_entries``, ``full_entries``), the groups, the
resumed groups, the commit ``overlap``, the bytes kept on this rank and
their rate (``bytes``, ``gbps``, after a device synchronize), the counter
``tdx.cuda.bytes_materialized``, the gauge ``tdx.cuda.materialize_gbps``,
and, when the host→device link probe
(:func:`..observe.costmodel.link_bandwidth_gbps`) has already run,
``link_utilization``.  :func:`last_run_stats` holds the same figures.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import itertools
import json
import os
import shutil
import signal
import threading
import time
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import torch

from .. import _graph, chaos, config, observe
from .._device import resolve_device
from .._graph import CONTEXT_KEY, ReplayTarget, flat_outputs
from ..fake import get_fake_context, is_fake, is_param_like
from ..ops import _build, keyed_rng
from ..parallel.mesh import VirtualMesh
from ..parallel.sharding import (
    PartitionSpec,
    ShardingPlan,
    StageShardingPlan,
    mesh_shape,
    placements_for,
    shard_region,
    spec_str,
)
from ..utils.logging import get_logger
from . import transport
from .groups import (
    _raw_bytes,
    collect_nodes,
    group_fingerprint,
    split_init_groups,
)

__all__ = [
    "CompileHangError",
    "MaterializationError",
    "bind_values",
    "last_run_stats",
    "materialize_module_cuda",
    "materialize_params_cuda",
    "materialize_tensor_cuda",
    "named_fake_tensors",
]

_MASK64 = (1 << 64) - 1

#: Whether elementwise-closed entries replay on their local shape (the
#: default); False replays every entry whole, the path the shard-local
#: one is held against.
shard_local = True


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def op_seed(seed: int, key_nr: int) -> int:
    """The 64-bit key of the random op numbered ``key_nr`` in its
    recording session, under ``seed``."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ key_nr)


class MaterializationError(RuntimeError):
    """Materialization failed (or was drained by SIGTERM) after the whole
    ladder: per-stage retries, then the whole recording replayed once.

    ``completed_groups`` / ``failed_groups`` are 0-based group indices
    (the chaos sites number them from 1).  ``resumable`` is True when a
    progress manifest was left under ``TDX_MATERIALIZE_RESUME_DIR``;
    ``drained`` marks a SIGTERM drain (the last rung is not attempted:
    the process is being preempted)."""

    def __init__(self, msg, *, completed_groups=(), failed_groups=(),
                 resumable=False, drained=False):
        super().__init__(msg)
        self.completed_groups = sorted(completed_groups)
        self.failed_groups = sorted(failed_groups)
        self.resumable = resumable
        self.drained = drained


class CompileHangError(RuntimeError):
    """A group's ``lower`` or ``compile`` stage exceeded the
    ``TDX_COMPILE_DEADLINE_S`` deadline; its worker thread was abandoned.
    Always retryable."""


def _retryable_errors() -> tuple:
    """Exception types a caller may retry in this process (the serving
    engine requeues its lanes on them): the chaos ``raise`` / ``flap``
    error and ``torch.cuda.OutOfMemoryError``, which the caching
    allocator raises before any kernel runs and which leaves the CUDA
    context valid.

    A sticky CUDA error (an illegal address or a device-side assert,
    ``torch.AcceleratorError`` or a ``RuntimeError`` naming ``CUDA
    error``) is NOT here: it poisons the context, every later call
    (graph replays included) fails the same way, so a retry can only
    loop.  It propagates with its original message; recovering from it
    takes a new process (ROADMAP C5).  The JAX package retries every
    ``XlaRuntimeError``; the port cannot."""
    from ..chaos import InjectedRuntimeError

    return (InjectedRuntimeError, torch.cuda.OutOfMemoryError)


def _ladder_errors() -> tuple:
    """What the materializer's ladder retries: the above and the
    watchdog's :class:`CompileHangError`."""
    return _retryable_errors() + (CompileHangError,)


@functools.lru_cache(maxsize=None)
def _generator_overload(func):
    """``func``, or the overload of its packet that takes the same
    arguments plus ``generator`` (``aten.randn.default`` →
    ``aten.randn.generator``)."""
    names = [a.name for a in func._schema.arguments]
    if "generator" in names:
        return func
    pkt = func.overloadpacket
    for ov in pkt.overloads():
        cand = getattr(pkt, ov)
        cand_names = [a.name for a in cand._schema.arguments]
        if "generator" in cand_names and sorted(
                n for n in cand_names if n != "generator") == sorted(names):
            return cand
    raise NotImplementedError(
        f"`{func}` draws random numbers and has no overload that takes a "
        f"generator, so it cannot be materialized with a keyed RNG")


# -- keyed fills and elementwise-closed chains --------------------------------

# In-place draws the kernel serves: schema name -> (kind, its two
# parameters' names).
_KEYED = {"aten::uniform_": ("uniform", "from", "to"),
          "aten::normal_": ("normal", "mean", "std")}
_FACTORIES = {"aten::empty", "aten::zeros", "aten::ones", "aten::full"}
_ALIASES = {"aten::detach", "aten::alias"}
_ELEMENTWISE = {"aten::erfinv_", "aten::mul_", "aten::add_", "aten::sub_",
                "aten::div_", "aten::clamp_", "aten::clamp_min_",
                "aten::clamp_max_", "aten::fill_", "aten::zero_",
                "aten::neg_"}
_CASTS = {"aten::_to_copy"}
_CAST_KWARGS = {"dtype", "device", "layout", "pin_memory", "non_blocking"}


def _schema_name(func) -> Optional[str]:
    schema = getattr(func, "_schema", None)
    return None if schema is None else schema.name


def _bound(func, args, kwargs) -> dict:
    """The call's arguments by schema name, defaults filled in."""
    out = {}
    for i, a in enumerate(func._schema.arguments):
        if i < len(args):
            out[a.name] = args[i]
        elif a.name in kwargs:
            out[a.name] = kwargs[a.name]
        elif a.has_default_value():
            out[a.name] = a.default_value
    return out


def _keyed_draw(node) -> Optional[Tuple[str, str, str]]:
    """``(kind, a_name, b_name)`` when ``node`` is a draw the kernel
    serves (the default overload, no generator given)."""
    func = node.op.func
    spec = _KEYED.get(_schema_name(func))
    if spec is None or func._overloadname not in ("", "default"):
        return None
    if node.op.kwargs.get("generator") is not None:
        return None
    return spec


def _is_scalar_arg(obj) -> bool:
    return obj is None or isinstance(obj, (bool, int, float))


def _local_chain(fake: torch.Tensor) -> Optional[List[_graph.OpNode]]:
    """The entry's call stack when it is elementwise closed (see the
    module docstring): a factory of the entry's full shape, then a linear
    chain of keyed draws, scalar in-place ops, whole aliases and casts,
    every draw in a dtype the kernel fills.  None otherwise."""
    ctx = get_fake_context(fake, CONTEXT_KEY)
    if ctx is None or ctx.output_index != 0:
        return None
    stack = ctx.node.build_call_stack()
    # The entry is the output of its context node, then every in-place op
    # the stack applies to that storage after it: the chain's last value,
    # unless a cast (a new storage) follows the context node.
    pos = next((i for i, n in enumerate(stack) if n is ctx.node), None)
    if pos is None or any(_schema_name(n.op.func) in _CASTS
                          for n in stack[pos + 1:]):
        return None
    first = stack[0]
    if (_schema_name(first.op.func) not in _FACTORIES or first.dependencies
            or not first.op.args
            or list(first.op.args[0]) != list(fake.shape)):
        return None
    dtype = first.op.kwargs.get("dtype") or first.op.tls.default_dtype
    for prev, n in zip(stack, stack[1:]):
        if n.materialized or n.argument_versions or len(n.dependencies) != 1:
            return None
        dep, idx = n.dependencies[0]
        if dep is not prev or idx != 0:
            return None
        name = _schema_name(n.op.func)
        rest = list(n.op.args[1:]) + [v for k, v in n.op.kwargs.items()
                                      if k != "dtype"]
        if _keyed_draw(n) is not None:
            if dtype not in keyed_rng.DTYPES:
                return None
        elif name in _CASTS:
            if set(n.op.kwargs) - _CAST_KWARGS or n.op.args[1:]:
                return None
            dtype = n.op.kwargs.get("dtype") or dtype
        elif name not in _ALIASES and name not in _ELEMENTWISE:
            return None
        if not all(_is_scalar_arg(v) or isinstance(v, (torch.device,
                                                        torch.dtype,
                                                        torch.layout))
                   for v in rest):
            return None
    if first.materialized or first.argument_versions or dtype != fake.dtype:
        return None
    return stack


class _LocalTarget(ReplayTarget):
    """Replays every recorded device onto the one local device."""

    def rewrite_device(self, d: torch.device) -> torch.device:
        return self.device


def _keyed_fill(node, args, kwargs, seed: int, full_shape=None, start=None):
    """Run the draw ``node`` through the kernel on its resolved ``self``."""
    kind, a_name, b_name = _keyed_draw(node)
    b = _bound(node.op.func, args, kwargs)
    return keyed_rng.keyed_fill_(b["self"], kind, float(b[a_name]),
                                 float(b[b_name]), op_seed(seed, node.key_nr),
                                 full_shape, start)


def _replay_chain(stack, target: _LocalTarget, seed: int, full_shape,
                  region) -> torch.Tensor:
    """Replay an elementwise-closed chain on the region's shape only."""
    start = tuple(s for s, _ in region)
    local_shape = [n for _, n in region]
    value = None
    for n in stack:
        op = n.op
        if value is None:
            args = (local_shape,) + tuple(op.args[1:])
            value = flat_outputs(op.replay(target, args, dict(op.kwargs)))[0]
            continue
        args = _graph._resolve(op.args, n.dependencies, lambda _n, _i: value)
        kwargs = _graph._resolve(op.kwargs, n.dependencies,
                                 lambda _n, _i: value)
        if _keyed_draw(n) is not None:
            value = _keyed_fill(n, args, kwargs, seed, full_shape, start)
        else:
            value = flat_outputs(op.replay(target, args, kwargs))[0]
    return value


def _plan_full(fakes: Dict[str, torch.Tensor]) -> dict:
    """The replay plan of entries replayed whole: the union of their call
    stacks in ``op_nr`` order, when each entry is done, when each value
    is freed."""
    entries = {}
    nodes: Dict[int, _graph.OpNode] = {}
    done_at: Dict[int, list] = {}
    last_use: Dict[int, int] = {}
    for name, fake in fakes.items():
        ctx = get_fake_context(fake, CONTEXT_KEY)
        if ctx is None:
            raise ValueError(
                f"`{name}` was not recorded under deferred_init (or was "
                f"already materialized in place) and cannot be materialized")
        entries[name] = (ctx.node, ctx.output_index)
        stack = ctx.node.build_call_stack()
        for n in stack:
            nodes[id(n)] = n
        done = max(n.op_nr for n in stack)
        done_at.setdefault(done, []).append(name)
        last_use[id(ctx.node)] = max(last_use.get(id(ctx.node), -1), done)
    order = sorted(nodes.values(), key=lambda n: n.op_nr)
    for n in order:
        last_use[id(n)] = max(last_use.get(id(n), -1), n.op_nr)
        if not n.materialized:
            for dep, _ in n.dependencies:
                last_use[id(dep)] = max(last_use.get(id(dep), -1), n.op_nr)
    free_at: Dict[int, list] = {}
    for nid, k in last_use.items():
        free_at.setdefault(k, []).append(nid)
    return {"entries": entries, "order": order, "done_at": done_at,
            "free_at": free_at}


def _replay_full(plan: dict, device: torch.device, seed: int,
                 finish) -> Dict[str, torch.Tensor]:
    """Replay a :func:`_plan_full` plan on ``device`` without touching the
    recording; ``finish(name, full)`` turns each entry's value into what
    is kept, as soon as the last op that writes it has run."""
    entries, done_at, free_at = plan["entries"], plan["done_at"], plan["free_at"]
    target = _LocalTarget(device)
    values: Dict[int, list] = {}

    def lookup(node: _graph.OpNode, idx: int):
        vals = values.get(id(node))
        if vals is None:
            if not node.materialized:
                raise RuntimeError(
                    f"`{node.op.name}` (op #{node.op_nr}) was needed before "
                    f"it was replayed")
            # Read while recording: copy, so this run's in-place ops
            # leave the node's value as it was.
            vals = values[id(node)] = [
                o.detach().to(device, copy=True) if isinstance(o, torch.Tensor)
                else o for o in node.outputs]
        return vals[idx]

    out: Dict[str, torch.Tensor] = {}
    for n in plan["order"]:
        if not n.materialized:
            _graph._verify_external_args(n)
            op = n.op
            args = _graph._resolve(op.args, n.dependencies, lookup)
            kwargs = _graph._resolve(op.kwargs, n.dependencies, lookup)
            if (_keyed_draw(n) is not None and isinstance(args[0], torch.Tensor)
                    and args[0].dtype in keyed_rng.DTYPES):
                values[id(n)] = [_keyed_fill(n, args, kwargs, seed)]
            else:
                if _graph._is_rng_op(op.func):
                    gen = torch.Generator(device=device)
                    gen.manual_seed(op_seed(seed, n.key_nr))
                    op = dataclasses.replace(
                        op, func=_generator_overload(op.func),
                        kwargs={**op.kwargs, "generator": gen})
                    kwargs = {**kwargs, "generator": gen}
                values[id(n)] = flat_outputs(op.replay(target, args, kwargs))
        for name in done_at.get(n.op_nr, ()):
            node, idx = entries[name]
            out[name] = finish(name, lookup(node, idx).detach())
        for nid in free_at.get(n.op_nr, ()):
            values.pop(nid, None)
    return out


def named_fake_tensors(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """All fake parameters and buffers of ``module`` by qualified name,
    deduplicated by identity (tied weights appear once, under their first
    name)."""
    out: Dict[str, torch.Tensor] = {}
    seen = set()
    for name, t in itertools.chain(
            module.named_parameters(remove_duplicate=False),
            module.named_buffers(remove_duplicate=False)):
        if t is None or not is_fake(t) or id(t) in seen:
            continue
        seen.add(id(t))
        out[name] = t
    return out


def _is_compact(t: torch.Tensor) -> bool:
    """Whether ``t`` is the whole of its storage, in order."""
    return (t.is_contiguous() and t.storage_offset() == 0
            and t.untyped_storage().nbytes() == t.numel() * t.element_size())


def _place(mesh, device: Optional[torch.device]) -> torch.device:
    """The device a run replays on: the mesh's for a ``DeviceMesh``, else
    ``device`` (the GPU unless the caller asks for the CPU)."""
    if mesh is None or isinstance(mesh, VirtualMesh):
        return resolve_device("cuda" if device is None else device)
    kind = mesh.device_type
    if device is not None and torch.device(device).type != kind:
        raise ValueError(f"device {device!r} differs from the mesh's "
                         f"device type {kind!r}")
    if kind == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(kind)


# -- the retry ladder and the watchdog ----------------------------------------

_RETRY_BACKOFF_BASE_S = 0.05
_RETRY_BACKOFF_MAX_S = 2.0


def _retry_backoff(attempt: int) -> None:
    time.sleep(min(_RETRY_BACKOFF_MAX_S,
                   _RETRY_BACKOFF_BASE_S * (2 ** (attempt - 1))))


def _run_ladder(attempt_fn, *, retries: int, retryable: tuple, describe: str):
    """Call ``attempt_fn(attempt)`` until it returns, retrying only
    ``retryable`` errors up to ``retries`` times with exponential backoff
    (each retry counted in ``tdx.cuda.materialize_retries``).  The final
    error re-raises unchanged."""
    attempt = 0
    while True:
        try:
            return attempt_fn(attempt)
        except Exception as e:  # noqa: BLE001 — classified just below
            if not isinstance(e, retryable):
                raise
            attempt += 1
            if attempt > retries:
                raise
            observe.counter("tdx.cuda.materialize_retries").inc()
            get_logger().warning("materialize: %s failed (%s: %s); retry %d/%d",
                                 describe, type(e).__name__, str(e)[:120],
                                 attempt, retries)
            _retry_backoff(attempt)


def _bounded_stage(stage: str, fn, *, deadline: Optional[float], group: int):
    """Run one stage, under the watchdog when ``deadline`` is set: the
    stage runs on a daemon thread that is abandoned on timeout (a Python
    thread cannot be killed) and :class:`CompileHangError` is raised.  An
    injected ``hang`` / ``slow`` on the abandoned thread wakes on its
    cancel event."""
    if not deadline or deadline <= 0:
        return fn()
    box: Dict[str, object] = {}
    cancel = threading.Event()
    cfg = config.get()

    def _target():
        chaos.set_cancel_event(cancel)
        try:
            with config.bind(cfg):
                box["result"] = fn()
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            box["error"] = e

    t = threading.Thread(target=_target, daemon=True,
                         name=f"tdx-mat-{stage}-{group}")
    t.start()
    t.join(deadline)
    if t.is_alive():
        cancel.set()
        observe.counter("tdx.cuda.compile_watchdog_kills").inc()
        observe.instant("cuda.compile_watchdog_kill", category="cuda",
                        stage=stage, group=group, deadline_s=deadline)
        observe.flight_dump("compile_watchdog_kill", stage=stage, group=group,
                            deadline_s=deadline)
        raise CompileHangError(
            f"the {stage} stage of group {group} exceeded the {deadline}s "
            f"watchdog deadline (TDX_COMPILE_DEADLINE_S); its thread was "
            f"abandoned and the stage will be retried")
    if "error" in box:
        raise box["error"]
    return box["result"]


# -- resume ---------------------------------------------------------------------

_RESUME_MANIFEST = "MATERIALIZE_PROGRESS.json"
_DTYPE_NAMES = {str(d).removeprefix("torch."): d for d in (
    torch.float64, torch.float32, torch.bfloat16, torch.float16, torch.int64,
    torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool,
    torch.complex64, torch.complex128)}


def _coordinate_dir(rdir: str, mesh, coord) -> str:
    """This rank's progress directory: named by its mesh coordinate."""
    if mesh is None:
        tag = "whole"
    else:
        tag = "-".join(f"{a}{i}" for a, i in zip(mesh_shape(mesh), coord))
    return os.path.join(rdir, tag)


def _load_manifest(cdir: str) -> Dict[str, dict]:
    try:
        with open(os.path.join(cdir, _RESUME_MANIFEST)) as f:
            m = json.load(f)
        if m.get("version") == 1 and isinstance(m.get("groups"), dict):
            return m["groups"]
    except (OSError, ValueError):
        pass
    return {}


def _write_manifest(cdir: str, groups: Dict[str, dict]) -> None:
    path = os.path.join(cdir, _RESUME_MANIFEST)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"version": 1, "groups": groups, "pid": os.getpid(),
                   "time": time.time()}, f)
    os.replace(tmp, path)


def _clear_resume_state(cdir: str) -> None:
    """Sweep a completed run's progress: every fingerprint-named payload
    directory (listed or orphaned), the manifest, and the directory."""
    try:
        names = os.listdir(cdir)
    except OSError:
        return
    for name in names:
        p = os.path.join(cdir, name)
        if (len(name) == 40 and all(c in "0123456789abcdef" for c in name)
                and os.path.isdir(p)):
            shutil.rmtree(p, ignore_errors=True)
    for name in (_RESUME_MANIFEST, _RESUME_MANIFEST + ".tmp"):
        try:
            os.remove(os.path.join(cdir, name))
        except OSError:
            pass
    try:
        os.rmdir(cdir)
    except OSError:
        pass


class _Writer:
    """The commit thread: each group's values are copied to pinned host
    memory (enqueued on the caller's stream); the thread writes the
    payloads and the manifest entry once the copy has landed.  At most
    ``depth`` commits are in flight."""

    def __init__(self, cdir: str, manifest: Dict[str, dict], depth: int,
                 tracker: transport.OverlapTracker):
        self.cdir, self.manifest, self.depth = cdir, manifest, max(1, depth)
        self.tracker = tracker
        self.pool = ThreadPoolExecutor(1, thread_name_prefix="tdx-mat-commit")
        self.inflight: deque = deque()

    def _write(self, gi: int, fp: str, indices, host, event) -> None:
        try:
            if event is not None:
                event.synchronize()
            gdir = os.path.join(self.cdir, fp)
            os.makedirs(gdir, exist_ok=True)
            outs = []
            for j, t in enumerate(host):
                data = _raw_bytes(t)
                rel = f"out_{j:04d}.bin"
                with open(os.path.join(gdir, rel), "wb") as f:
                    f.write(data)
                outs.append({"file": rel, "shape": list(t.shape),
                             "dtype": str(t.dtype).removeprefix("torch."),
                             "crc32": zlib.crc32(data)})
            self.manifest[fp] = {"indices": list(indices), "outputs": outs}
            _write_manifest(self.cdir, self.manifest)
        except Exception as e:  # noqa: BLE001 — a lost entry, not a lost run
            get_logger().warning(
                "materialize: progress commit of group %d failed (%s: %s); "
                "resume will recompute it", gi + 1, type(e).__name__, e)

    def submit(self, gi: int, fp: str, indices, values) -> None:
        """Queue group ``gi``'s commit, first waiting for the oldest when
        ``depth`` commits are in flight."""
        while len(self.inflight) >= self.depth:
            self._wait_oldest()
        t0 = time.perf_counter()
        host, event = [], None
        for v in values:
            if v.device.type == "cuda":
                h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                host.append(h.copy_(v, non_blocking=True))
                event = event or torch.cuda.Event()
            else:
                host.append(v.detach().clone())
        if event is not None:
            event.record()
        self.inflight.append((self.pool.submit(
            self._write, gi, fp, indices, host, event), t0))

    def _wait_oldest(self) -> None:
        fut, t0 = self.inflight.popleft()
        t = time.perf_counter()
        fut.result()
        now = time.perf_counter()
        self.tracker.note(now - t0, now - t)

    def drain(self) -> None:
        """Wait for every queued commit and stop the thread."""
        while self.inflight:
            self._wait_oldest()
        self.pool.shutdown(wait=True)


def _try_resume(cdir: str, fp: str, rec: dict, indices,
                device) -> Optional[list]:
    """A committed group's values on ``device`` in their stored dtypes,
    or None (recompute) on any mismatch: other indices, a missing file,
    a CRC failure."""
    if rec.get("indices") != list(indices):
        return None
    outs = rec.get("outputs") or ()
    if len(outs) != len(indices):
        return None
    payloads = []
    try:
        for o in outs:
            with open(os.path.join(cdir, fp, o["file"]), "rb") as f:
                data = f.read()
            dtype = _DTYPE_NAMES[o["dtype"]]
            numel = 1
            for size in o["shape"]:
                numel *= int(size)
            if (zlib.crc32(data) != o["crc32"]
                    or len(data) != numel * dtype.itemsize):
                return None
            payloads.append((data, o["shape"], dtype))
    except Exception:  # noqa: BLE001 — any load failure: recompute
        return None
    return transport.batched_load(payloads, device)


# -- the entry points -------------------------------------------------------------


def materialize_params_cuda(
    fakes: Dict[str, torch.Tensor],
    *,
    mesh=None,
    plan: Optional[ShardingPlan] = None,
    seed: int = 0,
    param_dtype: Optional[torch.dtype] = None,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Materialize a dict of fake tensors, each as this rank's planned
    shard.

    ``mesh``: ``None`` (full tensors), a ``DeviceMesh`` (``DTensor``s
    holding this rank's shard, placed by ``plan`` — replicated where it
    has no rule) or a :class:`..parallel.mesh.VirtualMesh` (the plain
    local shards of its coordinate).  With a
    :class:`..parallel.sharding.StageShardingPlan` the result holds only
    the entries of this rank's pipeline stage and those every stage
    holds; a stage-owned entry is this rank's shard of the base plan's
    spec over the mesh's other axes, as a DTensor on the mesh of those
    axes (the stage's own; a plain tensor where the mesh has no other
    axis), as no DTensor over the whole mesh describes a tensor that
    only one stage holds.  Draws are keyed by ``seed`` and each op's
    ``key_nr`` and counted by global element index, so gathered shards
    equal the unsharded values bit for bit on any mesh of the same
    device type.

    ``param_dtype`` casts floating ``nn.Parameter`` entries (a loaded
    recording's parameters too); buffers (float or otherwise) keep their
    recorded dtype.  ``device`` defaults to the GPU (``"cpu"`` must be
    asked for); with a ``DeviceMesh`` it is the mesh's.  Raises
    :class:`MaterializationError` when the engine's ladder is spent."""
    cast = {n for n, f in fakes.items() if is_param_like(f)}
    return _materialize(fakes, cast, mesh, plan, seed, param_dtype, device)


_stats_lock = threading.Lock()
_last_run_stats: Dict = {}


def last_run_stats() -> Dict:
    """The figures of this process's most recent materialization:
    ``entries``, ``local_entries`` (replayed on their shard's shape),
    ``full_entries``, ``n_groups``, ``resumed`` groups, ``retries``,
    ``fallback`` (whether the last rung ran), ``overlap`` (commit time
    hidden behind replay, over the wall) and ``wall_s``."""
    with _stats_lock:
        return dict(_last_run_stats)


def _materialize(fakes, cast, mesh, plan, seed, param_dtype, device):
    """The shared body of the entry points: ``cast`` names the entries
    ``param_dtype`` applies to."""
    t0 = time.perf_counter()
    with observe.span("materialize", category="cuda",
                      entries=len(fakes)) as sp:
        engine = _Engine(fakes, cast, mesh, plan, seed, param_dtype, device)
        try:
            values = engine.run()
        except MaterializationError as e:
            if not e.drained:
                observe.flight_dump(
                    "materialization_error", error=str(e)[:400],
                    failed_groups=list(e.failed_groups),
                    completed_groups=list(e.completed_groups),
                    resumable=e.resumable)
            raise
        stats = engine.stats()
        with _stats_lock:
            _last_run_stats.clear()
            _last_run_stats.update(stats)
        sp.set(**{k: v for k, v in stats.items() if k != "entries"})
        if observe.enabled():
            _account(values, t0, sp)
    return values


def _account(values: Dict[str, torch.Tensor], t0: float, sp) -> None:
    """The materialize span's bytes and rate, and the link utilization
    where the link probe has run."""
    from torch.distributed.tensor import DTensor

    local = [v.to_local() if isinstance(v, DTensor) else v
             for v in values.values()]
    devices = {t.device for t in local if t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)
    n_bytes = sum(t.numel() * t.element_size() for t in local)
    gbps = n_bytes / (time.perf_counter() - t0) / 1e9
    sp.set(bytes=n_bytes, gbps=gbps)
    observe.counter("tdx.cuda.bytes_materialized").inc(n_bytes)
    observe.gauge("tdx.cuda.materialize_gbps").set(gbps)
    lbw = observe.costmodel.link_bandwidth_gbps(cached_only=True)
    if lbw:
        util = gbps / lbw
        sp.set(link_bandwidth_gbps=round(lbw, 3), link_utilization=util)
        observe.gauge("tdx.cuda.link_utilization").set(util)


# The program-count rule of the JAX engine (materialize.py:1215, 1231):
# a function of the recording alone, never of the host.
_PIPELINE_MIN_NODES = 32


def _pipeline_max_programs(n_nodes: int) -> int:
    return min(32, max(8, n_nodes // 48))


def _plan_groups(fake_list) -> Optional[List[List[int]]]:
    """The group split of ``fake_list``, or None for one group (a small
    recording, or a single bin)."""
    nodes = collect_nodes(fake_list)
    if len(nodes) < _PIPELINE_MIN_NODES:
        return None
    bins = split_init_groups(fake_list,
                             max_programs=_pipeline_max_programs(len(nodes)),
                             nodes=nodes)
    return bins if len(bins) >= 2 else None


class _Engine:
    """One materialization: the groups, their ladders, the last rung,
    resume and the drain."""

    def __init__(self, fakes, cast, mesh, plan, seed, param_dtype, device):
        cfg = config.get()
        self.cfg = cfg
        mode = cfg.materialize_pipeline
        if mode not in ("off", "auto"):
            raise ValueError(f"TDX_MATERIALIZE_PIPELINE={mode!r}: expected "
                             f"'off' or 'auto'")
        self.dev = _place(mesh, device)
        self.mesh, self.seed, self.param_dtype = mesh, seed, param_dtype
        specs, owned = {}, set()
        if mesh is not None:
            plan = plan or ShardingPlan()
            if isinstance(plan, StageShardingPlan):
                fakes, owned = _stage_entries(fakes, plan, mesh)
            specs = {n: plan.spec_for(n, tuple(f.shape), mesh)
                     for n, f in fakes.items()}
        self.fakes, self.specs, self.owned = fakes, specs, owned
        self.names = list(fakes)
        self.coord = _coordinate(mesh)
        self.cast = cast if param_dtype is not None else set()
        self.wrap = _wrapper(mesh, self.coord, specs,
                             {n: tuple(f.shape) for n, f in fakes.items()},
                             owned,
                             plan.axis if isinstance(plan, StageShardingPlan)
                             else None)
        self.finals = {n: self._final_dtype(n) for n in self.names}
        self.storage = dict(zip(self.names, transport.plan_transport(
            [self.finals[n] for n in self.names],
            [n in cast for n in self.names],
            transport.resolve_init_dtype(cfg.materialize_init_dtype))))
        self.mode = mode
        self.retries = max(0, cfg.materialize_retries)
        self.deadline = cfg.compile_deadline_s or None
        self.fault_plan = chaos.active_plan()
        self.chaos_path = str(_build.cache_dir())
        self.counts = {"local": 0, "full": 0}
        self.n_groups = 1
        self.resumed: set = set()
        self.retried = 0
        self.fallback = False
        self.tracker = transport.OverlapTracker()
        self.wall = 0.0

    def _final_dtype(self, name: str) -> torch.dtype:
        d = self.fakes[name].dtype
        if name in self.cast and d.is_floating_point:
            return self.param_dtype
        return d

    def stats(self) -> dict:
        return {"entries": len(self.names),
                "local_entries": self.counts["local"],
                "full_entries": self.counts["full"],
                "n_groups": self.n_groups, "resumed": len(self.resumed),
                "retries": self.retried, "fallback": self.fallback,
                "overlap": self.tracker.overlap(self.wall),
                "wall_s": self.wall}

    # -- one group ------------------------------------------------------------

    def _region(self, name: str):
        shape = tuple(self.fakes[name].shape)
        if self.mesh is None:
            return tuple((0, s) for s in shape)
        return shard_region(shape, self.specs[name], mesh_shape(self.mesh),
                            self.coord)

    def _lower(self, idxs: List[int]) -> dict:
        """The group's replay plan: its elementwise-closed chains and the
        plan of the entries replayed whole."""
        chains, whole = {}, {}
        for i in idxs:
            name = self.names[i]
            chain = _local_chain(self.fakes[name]) if shard_local else None
            if chain is not None:
                chains[name] = chain
            else:
                whole[name] = self.fakes[name]
        return {"chains": chains, "full": _plan_full(whole) if whole else None}

    def _compile(self) -> None:
        """The kernel library's lookup (built, fetched or loaded)."""
        if self.dev.type == "cuda":
            keyed_rng.build_kernel()

    def _finish(self, name: str, value: torch.Tensor,
                whole: bool) -> torch.Tensor:
        """This rank's local value of ``name``: its slice of a whole value,
        cast where asked, through the init dtype where the transport plan
        stores it, in its own compact storage."""
        if whole and self.mesh is not None:
            region = self._region(name)
            for dim, (s, n) in enumerate(region):
                if n != value.shape[dim]:
                    value = value.narrow(dim, s, n)
        final = self.finals[name]
        if value.dtype != final:
            value = value.to(final)
        store = self.storage.get(name)
        if store is not None:
            value = value.to(store).to(final)
        if not _is_compact(value):
            value = value.clone(memory_format=torch.contiguous_format)
        return value

    def _execute(self, plan: dict) -> Dict[str, torch.Tensor]:
        target = _LocalTarget(self.dev)
        out: Dict[str, torch.Tensor] = {}
        with _graph.gc_paused():
            for name, chain in plan["chains"].items():
                region = self._region(name)
                value = _replay_chain(chain, target, self.seed,
                                      tuple(self.fakes[name].shape), region)
                out[name] = self._finish(name, value.detach(), whole=False)
            if plan["full"] is not None:
                out.update(_replay_full(
                    plan["full"], self.dev, self.seed,
                    lambda n, v: self._finish(n, v, whole=True)))
        return out

    def _run_group(self, gno: int, idxs: List[int]) -> Dict[str, torch.Tensor]:
        """The three stages of one group, each on its ladder."""
        retryable = _ladder_errors()

        def plan_attempt(a):
            if a:
                self.retried += 1

            def lower():
                chaos.maybe_inject("lower", gno, path=self.chaos_path,
                                   plan=self.fault_plan)
                return self._lower(idxs)

            def compile_():
                chaos.maybe_inject("compile", gno, path=self.chaos_path,
                                   plan=self.fault_plan)
                self._compile()

            plan = _bounded_stage("lower", lower, deadline=self.deadline,
                                  group=gno)
            _bounded_stage("compile", compile_, deadline=self.deadline,
                           group=gno)
            return plan

        plan = _run_ladder(plan_attempt, retries=self.retries,
                           retryable=retryable, describe=f"group {gno} plan")

        def execute_attempt(a):
            if a:
                self.retried += 1
            chaos.maybe_inject("execute", gno, path=self.chaos_path,
                               plan=self.fault_plan)
            return self._execute(plan)

        with observe.span("materialize.group", category="cuda", group=gno,
                          entries=len(idxs)):
            values = _run_ladder(execute_attempt, retries=self.retries,
                                 retryable=retryable,
                                 describe=f"group {gno} replay")
        self.counts["local"] += len(plan["chains"])
        self.counts["full"] += len(idxs) - len(plan["chains"])
        return values

    # -- resume -----------------------------------------------------------

    def _group_fp(self, idxs: List[int]) -> Optional[str]:
        try:
            h = hashlib.sha1(group_fingerprint(
                [self.fakes[self.names[i]] for i in idxs]).encode())
        except Exception:  # noqa: BLE001 — an unstable chain: never resumed
            return None
        for i in idxs:
            n = self.names[i]
            spec = spec_str(self.specs[n]) if self.mesh is not None else None
            h.update(repr((i, n, self.seed, str(self.finals[n]), spec,
                           self._region(n), str(self.storage.get(n)),
                           shard_local)).encode())
        return h.hexdigest()

    def _stored(self, name: str, v: torch.Tensor) -> torch.Tensor:
        store = self.storage.get(name)
        return v if store is None else v.to(store)

    # -- the run ---------------------------------------------------------------

    def run(self) -> Dict[str, torch.Tensor]:
        t_wall = time.perf_counter()
        fake_list = [self.fakes[n] for n in self.names]
        bins = None
        if self.mode == "auto" and fake_list:
            bins = _plan_groups(fake_list)
        if bins is None:
            bins = [list(range(len(self.names)))]
        self.n_groups = len(bins)
        rdir = self.cfg.materialize_resume_dir
        cdir = _coordinate_dir(rdir, self.mesh, self.coord) if rdir else None
        manifest: Dict[str, dict] = {}
        fps: List[Optional[str]] = [None] * len(bins)
        local: Dict[str, torch.Tensor] = {}
        completed: set = set()
        failed: Dict[int, BaseException] = {}
        if cdir:
            os.makedirs(cdir, exist_ok=True)
            manifest = _load_manifest(cdir)
            for gi, idxs in enumerate(bins):
                fps[gi] = self._group_fp(idxs)
                rec = manifest.get(fps[gi]) if fps[gi] else None
                if rec is None:
                    continue
                loaded = _try_resume(cdir, fps[gi], rec, idxs, self.dev)
                if loaded is None:
                    manifest.pop(fps[gi], None)  # stale or damaged: recompute
                    continue
                for i, v in zip(idxs, loaded):
                    n = self.names[i]
                    local[n] = v.to(self.finals[n])
                self.resumed.add(gi)
                completed.add(gi)
            if self.resumed:
                observe.counter("tdx.cuda.groups_resumed").inc(len(self.resumed))
        writer = (_Writer(cdir, manifest, self.cfg.materialize_overlap_depth,
                          self.tracker) if cdir else None)
        drain = {"requested": False}
        prev_handler, handler = None, False
        if cdir and threading.current_thread() is threading.main_thread():
            def _on_sigterm(signum, frame):  # noqa: ARG001 — signal signature
                drain["requested"] = True

            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
            handler = True
        try:
            for gi, idxs in enumerate(bins):
                if drain["requested"]:
                    break
                if gi in completed:
                    continue
                try:
                    values = self._run_group(gi + 1, idxs)
                except Exception as e:  # noqa: BLE001 — classified below
                    if not isinstance(e, _ladder_errors()):
                        raise
                    failed[gi] = e
                    get_logger().error(
                        "materialize: group %d exhausted its retry ladder "
                        "(%s: %s)", gi + 1, type(e).__name__, str(e)[:160])
                    continue
                local.update(values)
                completed.add(gi)
                if writer is not None and fps[gi]:
                    names = [self.names[i] for i in idxs]
                    writer.submit(gi, fps[gi], idxs,
                                  [self._stored(n, values[n]) for n in names])
            if writer is not None:
                writer.drain()
            if drain["requested"] and len(completed) < len(bins):
                observe.flight_dump("sigterm_drain",
                                    completed_groups=sorted(completed),
                                    n_groups=len(bins), resumable=bool(cdir))
                raise MaterializationError(
                    f"materialization drained on SIGTERM with "
                    f"{len(completed)}/{len(bins)} groups committed",
                    completed_groups=completed,
                    failed_groups=set(range(len(bins))) - completed,
                    resumable=bool(cdir), drained=True)
        finally:
            if writer is not None:
                writer.drain()
            if handler:
                signal.signal(signal.SIGTERM, prev_handler)
                if drain["requested"] and len(completed) == len(bins):
                    # The notice came after the last group: the run is
                    # whole, but the preemption must not be swallowed.
                    os.kill(os.getpid(), signal.SIGTERM)
        if failed:
            local = self._last_rung(bins, completed, failed, cdir, manifest)
        if cdir:
            _clear_resume_state(cdir)
        self.wall = time.perf_counter() - t_wall
        return {n: self.wrap(n, local[n]) for n in self.names}

    def _last_rung(self, bins, completed, failed, cdir, manifest):
        """Every group that failed is spent: replay the whole recording
        once more as one group (chaos group 1), or raise."""
        msg = (f"{len(failed)} of {len(bins)} groups failed after "
               f"{self.retries} retries: " + "; ".join(
                   f"group {gi + 1}: {type(e).__name__}: {str(e)[:80]}"
                   for gi, e in sorted(failed.items())))
        err = MaterializationError(msg, completed_groups=completed,
                                   failed_groups=set(failed),
                                   resumable=bool(cdir and manifest))
        if self.retries == 0:
            raise err
        observe.counter("tdx.cuda.materialize_fallbacks").inc()
        get_logger().error("materialize: %s; replaying the whole recording",
                           msg)
        self.fallback = True
        self.counts = {"local": 0, "full": 0}
        try:
            return self._run_group(1, list(range(len(self.names))))
        except Exception as e:  # noqa: BLE001 — classified below
            if not isinstance(e, _ladder_errors()):
                raise
            raise err from e


def _coordinate(mesh):
    """This rank's (or this virtual coordinate's) mesh coordinate."""
    if mesh is None:
        return None
    if isinstance(mesh, VirtualMesh):
        return mesh.coordinate
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return tuple(coord)


def _stage_entries(fakes, plan: StageShardingPlan, mesh):
    """``(entries, owned)``: the entries this rank's pipeline stage
    materializes — those it owns and those every stage holds — and the
    names of the owned ones."""
    shape = mesh_shape(mesh)
    if plan.axis not in shape:
        raise ValueError(f"the plan gives layers to stages over "
                         f"{plan.axis!r}; mesh axes are {tuple(shape)}")
    if isinstance(mesh, VirtualMesh):
        stage = mesh.coordinate[list(shape).index(plan.axis)]
    else:
        stage = mesh.get_local_rank(plan.axis)
    kept, owned = {}, set()
    for name, fake in fakes.items():
        owner = plan.stage_of(name, mesh)
        if owner is None or owner == stage:
            kept[name] = fake
        if owner == stage:
            owned.add(name)
    return kept, owned


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, n = [], 1
    for size in reversed(shape):
        stride.append(n)
        n *= size
    return tuple(reversed(stride))


def _wrapper(mesh, coord, specs, full_shapes, owned=frozenset(),
             stage_axis: Optional[str] = None):
    """``(name, local) -> kept value``: on a ``DeviceMesh`` the local
    shard wrapped as a DTensor of the full shape (an entry a pipeline
    stage owns, ``owned``, on the mesh of the axes other than
    ``stage_axis``, plain where there is none); the local tensor
    itself otherwise."""
    if coord is None or isinstance(mesh, VirtualMesh):
        return lambda name, local: local
    shape = mesh_shape(mesh)
    stage_mesh = None
    if owned:
        rest = tuple(a for a in shape if a != stage_axis)
        if rest:
            stage_mesh = mesh[rest if len(rest) > 1 else rest[0]]

    def wrap(name: str, local: torch.Tensor):
        from torch.distributed.tensor import DTensor

        on, placements = mesh, placements_for(specs[name], mesh)
        if name in owned:
            if stage_mesh is None:
                return local
            on = stage_mesh
            placements = tuple(pl for a, pl in zip(shape, placements)
                               if a != stage_axis)
        full = full_shapes[name]
        return DTensor.from_local(local, on, placements, run_check=False,
                                  shape=torch.Size(full),
                                  stride=_contiguous_stride(full))

    return wrap


def materialize_tensor_cuda(
    tensor: torch.Tensor,
    *,
    mesh=None,
    spec: Optional[PartitionSpec] = None,
    seed: int = 0,
    param_dtype: Optional[torch.dtype] = None,
    device=None,
) -> torch.Tensor:
    """Materialize one fake tensor, as this rank's shard under ``spec``
    (replicated by default).  ``param_dtype`` casts the result when it is
    floating — the tensor is named explicitly here, so no
    parameter-vs-buffer distinction applies (unlike the module entry
    points, which never cast buffers)."""
    if not is_fake(tensor):
        raise ValueError("`tensor` is not fake; nothing to materialize.")
    plan = ShardingPlan(default=spec or PartitionSpec())
    return _materialize({"tensor": tensor}, {"tensor"}, mesh, plan, seed,
                        param_dtype, device)["tensor"]


def materialize_module_cuda(
    module: torch.nn.Module,
    *,
    mesh=None,
    plan: Optional[ShardingPlan] = None,
    seed: int = 0,
    param_dtype: Optional[torch.dtype] = None,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Materialize every fake parameter and buffer of a deferred-init
    module into (sharded) device memory, returning a flat state dict
    (tied weights listed once, under their first name).

    The module stays fake (no storage anywhere); the values live on the
    device, each rank holding its planned shard.  See
    :func:`materialize_params_cuda` for ``mesh``, ``plan``, ``seed``,
    ``param_dtype`` and ``device``."""
    fakes = named_fake_tensors(module)
    if not fakes:
        return {}
    return materialize_params_cuda(fakes, mesh=mesh, plan=plan, seed=seed,
                                   param_dtype=param_dtype, device=device)


def bind_values(module: torch.nn.Module, values: Dict[str, torch.Tensor], *,
                strict: bool = True) -> None:
    """Swap each fake parameter and buffer of ``module`` for its value in
    ``values`` (as :func:`materialize_module_cuda` returns them, keyed by
    :func:`named_fake_tensors`' names); tied entries share one
    ``nn.Parameter``.  ``strict=False`` leaves the entries ``values``
    lacks fake (a pipeline stage's values hold only its own layers).

    Values are bound as they come: on a ``DeviceMesh`` each parameter is
    an ``nn.Parameter`` around its DTensor, this rank's shard and no more
    (nothing is gathered), which ``parallel.make_train_step(mesh=)``
    takes over into its tensor-parallel and FSDP2 layout."""
    fakes = named_fake_tensors(module)
    missing = [n for n in fakes if n not in values]
    if missing and strict:
        raise KeyError(f"no value for {missing[:4]} ({len(missing)} entries)")
    by_id = {id(t): values[n] for n, t in fakes.items() if n in values}
    made: dict = {}
    for mod in module.modules():
        for d, is_param in ((mod._parameters, True), (mod._buffers, False)):
            for k, t in d.items():
                if t is None or id(t) not in by_id:
                    continue
                if id(t) not in made:
                    v = by_id[id(t)]
                    made[id(t)] = torch.nn.Parameter(
                        v, requires_grad=t.requires_grad) if is_param else v
                d[k] = made[id(t)]
