"""Materialize a deferred-init recording into (sharded) device memory,
with keyed RNG (counterpart of ``torchdistx_tpu/jax_bridge/materialize.py``'s
public API).

The JAX bridge compiles the recording into one XLA program.  Here the
recording is already torch ops, so it is replayed entry by entry on the
local device, in recorded (``op_nr``) order, with three differences from
the eager :func:`..deferred_init.materialize_module`:

* **Keyed RNG.**  Every random op draws from its own ``torch.Generator``
  on the target device, seeded by a fixed mix (splitmix64) of ``seed``
  and the op's session-relative ``key_nr`` — the counterpart of the JAX
  bridge's ``fold_in(PRNGKey(seed), key_nr)``.  Values are a function of
  the seed and the recording: not of the global generator, of the mesh,
  of what else was recorded, or of the order of materialization.  They
  are not the eager route's values, and torch's generators differ by
  device type (mt19937 on the CPU, Philox on CUDA), so one recording
  gives other values on the CPU than on the card.
* **Sharded results.**  Each entry's full tensor exists only briefly, on
  the device; the rank keeps its planned local shard, as a ``DTensor``
  on a ``DeviceMesh`` (a plain tensor with ``mesh=None``, or for one
  coordinate of a :class:`..parallel.mesh.VirtualMesh`).
* **The recording is not consumed.**  Values live in a run-local table,
  each freed after its last consumer; the module stays fake and can be
  materialized again, under another mesh.  Values that were read while
  recording (early replay) are copied from their nodes.

``param_dtype`` casts floating ``nn.Parameter`` entries after their
recorded-precision init; buffers keep their recorded dtype.  Tied
weights are one entry.

Under a :class:`..parallel.sharding.StageShardingPlan` a pipeline stage
materializes only the block layers it owns (and the entries every stage
holds): the other stages' layers are never drawn or allocated on it.

With telemetry on, each call is one ``materialize`` span carrying the
bytes kept on this rank and their rate (``bytes``, ``gbps``, after a
device synchronize), the counter ``tdx.cuda.bytes_materialized``, the
gauge ``tdx.cuda.materialize_gbps``, and, when the host→device link
probe (:func:`..observe.costmodel.link_bandwidth_gbps`) has already run,
``link_utilization`` = gbps over the link's rate (read cached-only:
nothing is probed inside the timed window).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import time
from typing import Dict, Optional, Tuple

import torch

from .. import _graph, observe
from .._device import resolve_device
from .._graph import CONTEXT_KEY, ReplayTarget, flat_outputs
from ..fake import get_fake_context, is_fake, is_param_like
from ..parallel.mesh import VirtualMesh
from ..parallel.sharding import (
    PartitionSpec,
    ShardingPlan,
    StageShardingPlan,
    local_shard,
    mesh_shape,
    placements_for,
)

__all__ = [
    "bind_values",
    "materialize_module_cuda",
    "materialize_params_cuda",
    "materialize_tensor_cuda",
    "named_fake_tensors",
]

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def op_seed(seed: int, key_nr: int) -> int:
    """The 64-bit seed of the generator of the random op numbered
    ``key_nr`` in its recording session, under ``seed``."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ key_nr)


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


class _LocalTarget(ReplayTarget):
    """Replays every recorded device onto the one local device."""

    def rewrite_device(self, d: torch.device) -> torch.device:
        return self.device


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


def _replay(fakes: Dict[str, torch.Tensor], device: torch.device, seed: int,
            finish) -> Dict[str, torch.Tensor]:
    """Replay the union of the entries' call stacks in ``op_nr`` order on
    ``device`` without touching the recording; ``finish(name, full)``
    turns each entry's value into what is kept, as soon as the last op
    that writes it has run."""
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
    with _graph.gc_paused():
        for n in order:
            if not n.materialized:
                _graph._verify_external_args(n)
                op = n.op
                if _graph._is_rng_op(op.func):
                    gen = torch.Generator(device=device)
                    gen.manual_seed(op_seed(seed, n.key_nr))
                    op = dataclasses.replace(
                        op, func=_generator_overload(op.func),
                        kwargs={**op.kwargs, "generator": gen})
                args = _graph._resolve(op.args, n.dependencies, lookup)
                kwargs = _graph._resolve(op.kwargs, n.dependencies, lookup)
                values[id(n)] = flat_outputs(op.replay(target, args, kwargs))
            for name in done_at.get(n.op_nr, ()):
                node, idx = entries[name]
                out[name] = finish(name, lookup(node, idx).detach())
            for nid in free_at.get(n.op_nr, ()):
                values.pop(nid, None)
    return {name: out[name] for name in fakes}


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
    only one stage holds.  RNG uses per-op generators keyed by
    ``seed`` and the op's ``key_nr``, so gathered shards equal the
    unsharded values bit for bit on any mesh of the same device type.

    ``param_dtype`` casts floating ``nn.Parameter`` entries (a loaded
    recording's parameters too); buffers (float or otherwise) keep their
    recorded dtype.  ``device`` defaults to the GPU (``"cpu"`` must be
    asked for); with a ``DeviceMesh`` it is the mesh's."""
    cast = {n for n, f in fakes.items() if is_param_like(f)}
    return _materialize(fakes, cast, mesh, plan, seed, param_dtype, device)


def _materialize(fakes, cast, mesh, plan, seed, param_dtype, device):
    """The shared body of the entry points: ``cast`` names the entries
    ``param_dtype`` applies to."""
    t0 = time.perf_counter()
    with observe.span("materialize", category="cuda",
                      entries=len(fakes)) as sp:
        values = _materialize_values(fakes, cast, mesh, plan, seed,
                                     param_dtype, device)
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


def _materialize_values(fakes, cast, mesh, plan, seed, param_dtype, device):
    dev = _place(mesh, device)
    specs, owned = {}, set()
    if mesh is not None:
        plan = plan or ShardingPlan()
        if isinstance(plan, StageShardingPlan):
            fakes, owned = _stage_entries(fakes, plan, mesh)
        specs = {n: plan.spec_for(n, tuple(f.shape), mesh)
                 for n, f in fakes.items()}
    finish = _finisher(mesh, specs, cast if param_dtype is not None else (),
                       param_dtype, owned,
                       plan.axis if isinstance(plan, StageShardingPlan)
                       else None)
    return _replay(fakes, dev, seed, finish)


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


def _finisher(mesh, specs, cast, param_dtype, owned=frozenset(),
              stage_axis: Optional[str] = None):
    """``(name, full) -> kept value``: this rank's (or this virtual
    coordinate's) local shard, cast where asked, in its own compact
    storage — the full tensor is freed when the run drops it — and on a
    ``DeviceMesh`` wrapped as a DTensor of the full shape; an entry a
    pipeline stage owns (``owned``) on the mesh of the axes other than
    ``stage_axis`` (plain where there is none)."""
    coord = None
    if isinstance(mesh, VirtualMesh):
        coord = mesh.coordinate
    elif mesh is not None:
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
    shape = mesh_shape(mesh) if mesh is not None else None
    stage_mesh = None
    if owned and coord is not None and not isinstance(mesh, VirtualMesh):
        rest = tuple(a for a in shape if a != stage_axis)
        if rest:
            stage_mesh = mesh[rest if len(rest) > 1 else rest[0]]

    def finish(name: str, full: torch.Tensor) -> torch.Tensor:
        local = full if mesh is None else local_shard(
            full, specs[name], shape, coord)
        if name in cast and local.is_floating_point():
            local = local.to(param_dtype)
        if not _is_compact(local):
            local = local.clone(memory_format=torch.contiguous_format)
        if coord is None or isinstance(mesh, VirtualMesh):
            return local
        from torch.distributed.tensor import DTensor

        on, placements = mesh, placements_for(specs[name], mesh)
        if name in owned:
            if stage_mesh is None:
                return local
            on = stage_mesh
            placements = tuple(pl for a, pl in zip(shape, placements)
                               if a != stage_axis)
        return DTensor.from_local(
            local, on, placements, run_check=False,
            shape=full.shape, stride=_contiguous_stride(full.shape))

    return finish


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
