"""Tensor parallelism and FSDP2 over a mesh, laid out as the keyed values
already are.

The JAX package lets GSPMD follow the shardings its parameters were
materialized with.  Here the keyed values (``cuda_bridge``) arrive as
DTensors placed by a sharding plan (:func:`..sharding.placements_for`),
and :func:`shard_module` rebuilds the module around them:

1. each bound parameter's placements say which tensor dim each mesh axis
   shards; the parameter is swapped for a ``meta`` tensor of its global
   shape (ties kept);
2. :func:`tp_styles` maps those layouts to
   ``torch.distributed.tensor.parallel`` styles — a linear whose weight
   has ``tp`` on dim 0 is column-parallel, on dim 1 row-parallel; an
   embedding with the vocab on ``tp`` is row-parallel (vocab-parallel) —
   and ``parallelize_module`` applies them over ``mesh["tp"]``;
3. ``fully_shard`` runs per block and at the root over ``mesh["fsdp"]``
   (``mesh["dp", "fsdp"]``, FSDP2's HSDP, when ``dp > 1``), each
   parameter sharded on the dim it has ``fsdp`` on; the parameters that
   no data axis shards (the plans' norms and most biases) are left out of
   FSDP2 and their gradients averaged over the data ranks by
   :func:`reduce_replicated_grads`;
4. each parameter's new layout is checked against the value's and the
   value's local tensor is handed to it through
   ``load_state_dict(assign=True)`` — FSDP2 adopts that storage as its
   shard, so nothing is copied, gathered or allocated twice.

A layout that no style or FSDP2 placement gives raises with the
parameter's name and its spec; nothing falls back to replication.

Expert weights (a ``MoEMLP``'s ``w_gate``/``w_up``/``w_down``, ``[E, d,
ff]``/``[E, ff, d]``) are split over ``ep`` (the expert dim) and ``tp``
(the ``ff`` dim) by hand, not by DTensor: the parameter is this rank's
``[E/ep, d, ff/tp]`` block as a plain tensor, FSDP2 shards that block
over the data axes like any other parameter, and the module runs with
an :class:`ExpertParallel`: the routing is global over the data shards
of the batch and the sequence chunks of ``sp`` (capacity and slots from
every row's counts, all-gathered over ``sp`` in chunk order, then over
the data axes; the load-balancing mean from the router's probabilities
gathered over ``sp`` and an autograd all-reduce over the data axes), the
expert region is entered with an identity whose backward all-reduces
over ``ep`` and ``tp``, and left with an all-reduce of the partial
output whose backward is the identity (Megatron's pair of conjugate
operators).  Every rank of an ``ep``/``tp`` group sees the same tokens,
as the batch is sharded over the data axes and ``sp`` only (checked).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .sharding import PartitionSpec, mesh_shape, spec_str

DATA_AXES = ("dp", "fsdp")
# Axes a MoEMLP splits its experts over by hand, and the dim of each
# expert weight they shard.
_EXPERT_DIMS = {"w_gate": {"ep": 0, "tp": 2}, "w_up": {"ep": 0, "tp": 2},
                "w_down": {"ep": 0, "tp": 1}}
# Attention and MLP projections that pair up: the inputs column-parallel,
# the output row-parallel, the heads or the hidden units local in between.
_PAIRS = {"Attention": (("wq", "wk", "wv"), "wo"),
          "CrossAttention": (("wq", "wk", "wv"), "wo"),
          "MLP": (("w_gate", "w_up"), "w_down")}

AxisDims = Dict[str, int]  # mesh axis -> the tensor dim it shards


def axis_dims(placements: Sequence, axes: Sequence[str]) -> AxisDims:
    """``{axis: tensor dim}`` of DTensor ``placements`` over mesh ``axes``
    (the axes that replicate are absent)."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    return {a: p.dim for a, p in zip(axes, placements)
            if isinstance(p, (Shard, _StridedShard))}


def _spec(dims: AxisDims, ndim: int) -> str:
    """``dims`` as a PartitionSpec string (axes in mesh order), for
    messages."""
    per_dim = [tuple(a for a, d in dims.items() if d == i) for i in range(ndim)]
    return spec_str(PartitionSpec(*(None if not a else a[0] if len(a) == 1
                                    else a for a in per_dim)))


def tp_styles(module: nn.Module, dims: Dict[str, AxisDims]) -> dict:
    """``{module name: ParallelStyle}`` for ``parallelize_module``, from
    each parameter's ``{axis: tensor dim}`` (``dims`` by qualified name).
    Raises ``ValueError`` naming the parameter and its spec where no
    style gives that layout — for example ``wq`` sharded while ``wk`` is
    replicated (a head count ``tp`` does not divide)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

    params = dict(module.named_parameters())

    def tp_dim(name: str) -> Optional[int]:
        return dims.get(name, {}).get("tp")

    def fail(name: str, why: str):
        raise ValueError(f"tensor parallelism: `{name}` has spec "
                         f"{_spec(dims.get(name, {}), params[name].ndim)}: "
                         f"{why}")

    def check_bias(prefix: str, lin: nn.Module, want: Optional[int]):
        if getattr(lin, "bias", None) is not None \
                and tp_dim(prefix + "bias") != want:
            fail(prefix + "bias", "the bias must be sharded as its weight's "
                 "output dim (column-parallel) or replicated (row-parallel)")

    styles: dict = {}
    paired = set()
    mods = dict(module.named_modules())
    for mod_name, mod in mods.items():
        pair = _PAIRS.get(type(mod).__name__)
        if pair is None:
            continue
        ins, out = pair
        prefix = f"{mod_name}." if mod_name else ""
        members = [n for n in ins if isinstance(getattr(mod, n, None), nn.Linear)]
        members.append(out)
        paired.update(prefix + n for n in members)
        sharded = [n for n in members if tp_dim(f"{prefix}{n}.weight") is not None]
        for n in members:
            want = (1 if n == out else 0) if sharded else None
            if tp_dim(f"{prefix}{n}.weight") != want:
                fail(f"{prefix}{n}.weight",
                     f"{sharded[0]} of {mod_name or 'the module'} is "
                     f"tensor-parallel, so this weight must have tp on dim "
                     f"{want} ({'row' if n == out else 'column'}-parallel)")
            check_bias(f"{prefix}{n}.", getattr(mod, n),
                       0 if sharded and n != out else None)
            if sharded:
                styles[prefix + n] = (RowwiseParallel() if n == out
                                      else ColwiseParallel())
    for mod_name, mod in mods.items():
        if mod_name in paired or not isinstance(mod, (nn.Linear, nn.Embedding)):
            continue
        prefix = f"{mod_name}." if mod_name else ""
        dim = tp_dim(prefix + "weight")
        if isinstance(mod, nn.Linear):
            check_bias(prefix, mod, 0 if dim == 0 else None)
        if dim is None:
            continue
        if isinstance(mod, nn.Embedding):
            # [vocab, d]: the vocab over tp is the vocab-parallel lookup.
            styles[mod_name] = (RowwiseParallel(input_layouts=Replicate())
                                if dim == 0 else
                                ColwiseParallel(output_layouts=Replicate()))
        else:
            # A lone linear (the head): its output or input is whole.
            styles[mod_name] = (ColwiseParallel(output_layouts=Replicate())
                                if dim == 0 else
                                RowwiseParallel(input_layouts=Replicate()))
    styled = {f"{m}.{n}" if m else n for m in styles
              for n, _ in mods[m].named_parameters(recurse=False)}
    for name in params:
        if tp_dim(name) is not None and name not in styled:
            fail(name, "no tensor-parallel style shards this parameter")
    return styles


def layout_of(t: torch.Tensor, mesh) -> tuple:
    """``t``'s placements over ``mesh``'s dims, by axis name: a DTensor on
    a sub-mesh is replicated over the axes it lacks, a plain tensor over
    all of them."""
    from torch.distributed.tensor import DTensor, Replicate

    names = list(mesh_shape(mesh))
    out = [Replicate()] * len(names)
    if isinstance(t, DTensor):
        for a, p in zip(t.device_mesh.mesh_dim_names, t.placements):
            out[names.index(a)] = p
    return tuple(out)


def data_axes(mesh, batch_axes: Sequence[str] = DATA_AXES) -> Tuple[str, ...]:
    """The axes of ``batch_axes`` on ``mesh``, in mesh order."""
    bad = [a for a in batch_axes if a not in DATA_AXES]
    if bad:
        raise ValueError(f"batch_axes {tuple(batch_axes)}: only {DATA_AXES} "
                         f"carry the batch in the port")
    return tuple(a for a in mesh.mesh_dim_names if a in batch_axes)


class _EnterRegion(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``groups``
    (each rank of the expert region holds a part of it)."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.clone()

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        for group in ctx.groups:
            dist.all_reduce(grad, group=group)
        return grad, None


class _LeaveRegion(torch.autograd.Function):
    """The sum over ``groups`` forward (each rank holds a partial output);
    identity backward."""

    @staticmethod
    def forward(ctx, t, groups):
        t = t.contiguous().clone()
        for group in groups:
            dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherSeq(torch.autograd.Function):
    """The ``[B, s, ...]`` chunks of the ``sp`` ranks, joined on dim 1 in
    chunk order; the backward keeps this rank's chunk of the gradient.
    Every rank then computes the same function of the whole sequence,
    and the step sums the gradients over ``sp``, which adds the chunks'
    parts once each."""

    @staticmethod
    def forward(ctx, t, group, index):
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        ctx.index, ctx.n = index, t.shape[1]
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(1, ctx.index * ctx.n, ctx.n), None, None


@dataclass
class ExpertParallel:
    """A ``MoEMLP``'s place on a mesh: ``data_groups`` (major first, the
    data axes of size > 1) and ``data_index`` place this rank's rows among
    the ``n_data`` shards of the batch; ``seq_group`` (None without an
    ``sp`` axis of size > 1), ``seq_index`` and ``n_seq`` its chunk of
    each row; ``groups`` are the ``ep`` and ``tp`` groups that split the
    experts, ``expert_offset`` and ``n_local`` this rank's experts."""

    data_groups: list
    data_index: int
    n_data: int
    groups: list
    expert_offset: int
    n_local: int
    seq_group: Optional[object] = None
    seq_index: int = 0
    n_seq: int = 1

    def route_counts(self, rows: torch.Tensor):
        """``(before, total)`` from this rank's (token, choice) pairs per
        row and expert ``[B_local, E]``: for each of its rows, the pairs
        that come before its chunk in the token-major order of the whole
        batch (every earlier row of every data shard, and the row's
        earlier chunks), and the pairs of the whole batch per expert."""
        within = 0
        if self.seq_group is not None:
            parts = [torch.empty_like(rows) for _ in range(self.n_seq)]
            dist.all_gather(parts, rows.contiguous(), group=self.seq_group)
            chunks = torch.stack(parts)  # [n_seq, B_local, E], chunk order
            within = chunks[:self.seq_index].sum(0)
            rows = chunks.sum(0)
        every = rows
        for group in reversed(self.data_groups):
            parts = [torch.empty_like(every)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, every, group=group)
            every = torch.cat(parts)
        lo, n = self.data_index * rows.shape[0], rows.shape[0]
        before = (every.cumsum(0) - every)[lo:lo + n]
        return before + within, every.sum(0)

    def gather_seq(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (``[B_local, s, ...]``, this rank's chunk) for the whole
        sequence, differentiable (see :class:`_GatherSeq`)."""
        if self.seq_group is None:
            return t
        return _GatherSeq.apply(t, self.seq_group, self.seq_index)

    def sum_data(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the data shards, differentiable (its backward sums
        the gradient too)."""
        from torch.distributed.nn.functional import all_reduce

        for group in self.data_groups:
            t = all_reduce(t, group=group)
        return t

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        return _EnterRegion.apply(t, self.groups) if self.groups else t

    def leave(self, t: torch.Tensor) -> torch.Tensor:
        return _LeaveRegion.apply(t, self.groups) if self.groups else t


def data_index(mesh, axes: Sequence[str]) -> int:
    """This rank's place among the data shards of the batch over
    ``axes`` (the first one major), as ``make_train_step``'s
    ``shard_batch`` cuts the rows."""
    shape = mesh_shape(mesh)
    where = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    idx = 0
    for a in axes:
        idx = idx * shape[a] + where[a]
    return idx


def _experts(module: nn.Module, skip=frozenset()) -> Dict[str, nn.Module]:
    """The ``MoEMLP`` modules by qualified name, but those in ``skip``
    (ids of modules left as they are)."""
    from ..models.layers import MoEMLP

    return {n: m for n, m in module.named_modules()
            if isinstance(m, MoEMLP) and id(m) not in skip}


def _manual_dims(module: nn.Module, dims: Dict[str, AxisDims],
                 skip=frozenset()) -> Dict[str, AxisDims]:
    """``{expert weight: {axis: dim}}`` of the ``ep``/``tp`` splits done by
    hand.  Raises where the plan puts ep on another dim than the expert
    dim or tp on another than ``ff``, splits the three weights of one
    MoE layer over different axes, or shards any other parameter over
    ``ep``."""
    ndim = {n: p.ndim for n, p in module.named_parameters()}
    manual: Dict[str, AxisDims] = {}
    for prefix in _experts(module, skip):
        for w, want in _EXPERT_DIMS.items():
            name = f"{prefix}.{w}" if prefix else w
            d = dims[name]
            split = {a: i for a, i in d.items() if a in want}
            bad = [a for a, i in split.items() if want[a] != i]
            if bad:
                raise ValueError(
                    f"expert parallelism: `{name}` has spec "
                    f"{_spec(d, ndim[name])}: ep must shard dim 0 and tp dim "
                    f"{want['tp']}")
            manual[name] = split
    for name, d in dims.items():
        if "ep" in d and name not in manual:
            raise ValueError(f"`{name}` has spec {_spec(d, ndim[name])}: "
                             f"only expert weights shard over ep")
    for prefix in _experts(module, skip):
        splits = {tuple(sorted(manual[f"{prefix}.{w}" if prefix else w]))
                  for w in _EXPERT_DIMS}
        if len(splits) != 1:
            raise ValueError(f"`{prefix}`: w_gate, w_up and w_down must be "
                             f"split over the same axes, not {splits}")
    return manual


def _check_same_tokens(mesh, groups, axes: Sequence[str]) -> None:
    """Every rank of each expert group (``ep``, ``tp``) must hold this
    rank's tokens: the same coordinate on the data axes and on ``sp``.
    Raises, naming the rank and the axes, where one does not."""
    names = mesh.mesh_dim_names
    mine = dict(zip(names, mesh.get_coordinate()))
    for group in groups:
        for r in dist.get_process_group_ranks(group):
            at = (mesh.mesh == r).nonzero()
            coord = dict(zip(names, at[0].tolist())) if len(at) else {}
            bad = [a for a in axes if coord.get(a) != mine[a]]
            if bad:
                raise ValueError(
                    f"expert parallelism: rank {r} of an expert group of "
                    f"this rank holds other tokens (its {bad} coordinates "
                    f"differ); each ep/tp group must lie within one data "
                    f"shard and one sp chunk")


def _set_expert_parallel(module: nn.Module, mesh, manual, batch_axes,
                         skip=frozenset()) -> None:
    """Give each ``MoEMLP`` its :class:`ExpertParallel` on ``mesh``."""
    shape = mesh_shape(mesh)
    where = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    baxes = data_axes(mesh, batch_axes)
    idx = data_index(mesh, baxes)
    data_groups = [mesh.get_group(a) for a in baxes if shape[a] > 1]
    n_seq = shape.get("sp", 1)
    token_axes = baxes + (("sp",) if "sp" in shape else ())
    for prefix, mod in _experts(module, skip).items():
        split = manual[f"{prefix}.w_gate" if prefix else "w_gate"]
        E = mod.cfg.moe.n_experts
        n_ep = shape["ep"] if "ep" in split else 1
        groups = [mesh.get_group(a) for a in ("ep", "tp")
                  if a in split and shape[a] > 1]
        _check_same_tokens(mesh, groups, token_axes)
        mod.parallel = ExpertParallel(
            data_groups=data_groups, data_index=idx,
            n_data=math.prod(shape[a] for a in baxes), groups=groups,
            expert_offset=(where["ep"] if "ep" in split else 0) * (E // n_ep),
            n_local=E // n_ep,
            seq_group=mesh.get_group("sp") if n_seq > 1 else None,
            seq_index=where.get("sp", 0), n_seq=n_seq)


def _blocks(module: nn.Module) -> List[nn.Module]:
    """The transformer blocks FSDP2 wraps one by one."""
    from ..models.layers import Block

    return [m for m in module.modules() if isinstance(m, Block)]


@dataclass
class ShardedModule:
    """What :func:`shard_module` did: each parameter's ``{axis: tensor
    dim}`` by name, the parameters left replicated over the data axes
    (``replicated``), the groups their gradients are summed over, the
    number of data ranks and, by name, the number of blocks an expert
    weight is split into by hand (``split``: over ep and tp)."""

    dims: Dict[str, AxisDims]
    replicated: List[nn.Parameter]
    groups: list
    n_data: int
    split: Dict[str, int]


def shard_module(module: nn.Module, mesh,
                 batch_axes: Sequence[str] = DATA_AXES, *,
                 skip: Iterable[nn.Module] = (),
                 pipelined: bool = False) -> ShardedModule:
    """Lay ``module``'s bound keyed values (DTensors on ``mesh``) out for
    training: tensor parallelism over ``mesh["tp"]``, FSDP2 over the
    data axes and the experts split by hand over ``ep`` and ``tp``,
    adopting each value's local tensor as the parameter's shard (see the
    module docstring); ``batch_axes`` are the axes the batch is sharded
    over, which the MoE routing gathers over.  In place.

    A pipeline stage lays out its own part on the mesh of its other axes:
    ``skip`` holds the submodules it leaves as they are (the other
    stages' blocks, still fake), and with ``pipelined`` the module's own
    forward never runs (the stage calls its blocks, the embed and the
    head one by one), so FSDP2 makes each block, and each module outside
    the blocks that holds a data-sharded parameter, a unit of its own
    (``Embed.attend`` counts as a forward), not resharded after its
    forwards: the walker reshards and reduces each at its chunk's last
    backward."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.parallel import parallelize_module

    names = tuple(mesh.mesh_dim_names)
    shape = mesh_shape(mesh)
    skip_mods = {id(m) for s in skip for m in s.modules()}
    skipped = {id(p) for s in skip for p in s.parameters()}
    # 1. The bound values, one per tensor (ties share the first name).
    first: Dict[int, str] = {}
    canon: Dict[str, str] = {}
    values: Dict[str, DTensor] = {}
    dims: Dict[str, AxisDims] = {}
    for name, p in module.named_parameters(remove_duplicate=False):
        if id(p) in skipped:
            continue
        canon[name] = first.setdefault(id(p), name)
        if not isinstance(p, DTensor) or p.device_mesh != mesh:
            raise ValueError(
                f"`{name}` is not a DTensor on {mesh}: bind the values "
                f"materialize_module_cuda(mesh=mesh, plan=...) gives")
        values.setdefault(canon[name], p)
        dims[name] = axis_dims(p.placements, names)
    for name, b in module.named_buffers():
        if isinstance(b, DTensor):
            raise NotImplementedError(f"buffer `{name}` is a DTensor: sharded "
                                      f"buffers are not carried yet")
    manual = _manual_dims(module, dims, skip_mods)
    # 2. Meta parameters of the global shapes (an expert weight's: its
    # ep/tp block), ties kept.
    meta: Dict[int, nn.Parameter] = {}
    for mod_name, mod in module.named_modules():
        if id(mod) in skip_mods:
            continue
        for k, p in mod._parameters.items():
            if p is None:
                continue
            if id(p) not in meta:
                size = list(p.shape)
                for a, d in manual.get(f"{mod_name}.{k}" if mod_name else k,
                                       {}).items():
                    size[d] //= shape[a]
                meta[id(p)] = nn.Parameter(
                    torch.empty(size, dtype=p.dtype, device="meta"),
                    requires_grad=p.requires_grad)
            mod._parameters[k] = meta[id(p)]
    # 3. Tensor parallelism, then FSDP2 over the data axes, each
    # parameter on the dim it has fsdp on; the rest ignored by FSDP2.
    if "tp" in names:
        styles = tp_styles(module, {n: d for n, d in dims.items()
                                    if n not in manual})
        if styles:
            parallelize_module(module, mesh["tp"], styles)
    replicated_names = {n for n, d in dims.items()
                        if not any(a in d for a in DATA_AXES)}
    if "fsdp" in names:
        name_of = {id(p): n for n, p in module.named_parameters()}
        ignored = {p for n, p in module.named_parameters()
                   if n in replicated_names}

        def placement(p: nn.Parameter):
            name = name_of[id(p)]
            if "fsdp" not in dims[name]:
                raise ValueError(
                    f"FSDP2: `{name}` has spec {_spec(dims[name], p.ndim)}: "
                    f"sharded over dp but not fsdp")
            return Shard(dims[name]["fsdp"])

        fsdp_mesh = (mesh["dp", "fsdp"] if shape.get("dp", 1) > 1
                     else mesh["fsdp"])
        kw = dict(mesh=fsdp_mesh, shard_placement_fn=placement,
                  ignored_params=ignored)
        if pipelined:
            # Each unit is a root of its own, gathered at its first
            # forward of a step and kept whole over the microbatches
            # until its chunk's last backward (the pipeline walker says
            # which): one all-gather and one reduce-scatter a step.
            kw["reshard_after_forward"] = False
        blocks = _blocks(module)
        for blk in blocks:
            if id(blk) in skip_mods:
                continue
            if hasattr(blk, "moe"):
                # the router and the experts, plain tensors, in a group of
                # their own, apart from the block's tensor-parallel ones
                fully_shard(blk.moe, **kw)
            fully_shard(blk, **kw)
        if pipelined:
            from torch.distributed.fsdp import register_fsdp_forward_method

            in_blocks = {id(p) for b in blocks for p in b.parameters()}
            for mod in module.modules():
                held = [p for p in mod.parameters(recurse=False)
                        if id(p) not in in_blocks and p not in ignored]
                if not held:
                    continue
                if mod is module:
                    raise NotImplementedError(
                        f"FSDP2 over a pipeline stage: {type(module).__name__}"
                        f" holds data-sharded parameters itself, and its "
                        f"forward never runs on a stage")
                fully_shard(mod, **kw)
                if hasattr(mod, "attend"):  # a tied head
                    register_fsdp_forward_method(mod, "attend")
        else:
            fully_shard(module, **kw)
    # 4. The new layouts against the values'; the local tensors adopted.
    state: Dict[str, nn.Parameter] = {}
    made: Dict[str, nn.Parameter] = {}
    replicated: List[nn.Parameter] = []
    for name, p in module.named_parameters(remove_duplicate=False):
        if id(p) in skipped:
            continue
        key = canon[name]
        if key in made:
            state[name] = made[key]
            continue
        value = values[key]
        got = layout_of(p, mesh)
        want = tuple(Replicate() if a in manual.get(key, {}) else pl
                     for a, pl in zip(names, value.placements))
        if got != want:
            raise ValueError(
                f"`{name}` has spec {_spec(dims[name], p.ndim)}, placed "
                f"{tuple(value.placements)}; tensor parallelism and FSDP2 "
                f"give {got}")
        local = value.to_local()
        if isinstance(p, DTensor):
            local = DTensor.from_local(local, p.device_mesh, p.placements,
                                       run_check=False, shape=p.shape,
                                       stride=p.stride())
        new = made[key] = nn.Parameter(local, requires_grad=p.requires_grad)
        state[name] = new
        if key in replicated_names:
            replicated.append(new)
    module.load_state_dict(state, strict=False, assign=True)
    _set_expert_parallel(module, mesh, manual, batch_axes, skip_mods)
    dp = [a for a in DATA_AXES if a in names]
    groups = [mesh.get_group(a) for a in dp if shape[a] > 1]
    split = {n: math.prod(shape[a] for a in d) for n, d in manual.items()}
    return ShardedModule(dims, replicated, groups,
                         math.prod(shape[a] for a in dp), split)


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def reduce_replicated_grads(sharded: ShardedModule) -> None:
    """Average the gradients of the parameters FSDP2 does not hold over
    the data ranks, as FSDP2's reduce-scatter averages its own: one
    all-reduce of their flattened local gradients per data axis and
    dtype."""
    grads = [_local(p.grad) for p in sharded.replicated if p.grad is not None]
    if not sharded.groups or not grads:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in same])
        for group in sharded.groups:
            dist.all_reduce(flat, group=group)
        flat /= sharded.n_data
        offset = 0
        for g in same:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def sum_grads(params: Iterable[nn.Parameter], group) -> None:
    """Sum every parameter's local gradient over ``group`` in place (the
    ranks of a sequence-parallel axis each hold a part of it)."""
    from .collectives import all_reduce_

    for p in params:
        if p.grad is not None:
            all_reduce_(_local(p.grad), group)


def global_grad_norm(params: Iterable[nn.Parameter], mesh,
                     split: Optional[Sequence[int]] = None,
                     holders: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The L2 norm of every gradient, each counted once however it is
    sharded or replicated: each rank sums the squares of its local
    shards (in f32, with no f32 copy of a gradient), divided by the
    number of ranks holding the same shard, and one all-reduce over the
    mesh adds them up.  ``split`` gives, per parameter, the blocks it is
    split into by hand besides its DTensor placements (an expert weight's
    ep x tp; 1 otherwise); ``holders`` the ranks that hold it (the whole
    mesh by default; a pipeline stage's layers only its stage's ranks)."""
    from torch.distributed.tensor import DTensor, Replicate

    if mesh.size() != dist.get_world_size():
        raise ValueError(f"{mesh} spans {mesh.size()} of "
                         f"{dist.get_world_size()} ranks; the port's meshes "
                         f"span the whole group")
    total = None
    params = list(params)
    for p, n_split, n_hold in zip(params, split or [1] * len(params),
                                  holders or [mesh.size()] * len(params)):
        g = p.grad
        if g is None:
            continue
        copies = n_hold // n_split
        if isinstance(g, DTensor):
            for i, pl in enumerate(g.placements):
                if not isinstance(pl, Replicate):
                    copies //= g.device_mesh.size(i)
        sq = torch.linalg.vector_norm(_local(g), dtype=torch.float32
                                      ).square() / copies
        total = sq if total is None else total + sq
    if total is None:
        raise ValueError("no gradients")
    dist.all_reduce(total)
    return total.sqrt()
