"""Named-axis collectives over a ``DeviceMesh`` (counterpart of
``torchdistx_tpu/parallel/collectives.py``).

The JAX package names a mesh axis inside ``shard_map`` and lets XLA
emit the collective.  Here each function takes the mesh and the axis
name and runs the ``torch.distributed`` collective over that axis's
``ProcessGroup``, so ring attention, Ulysses and the train step speak
one vocabulary.  An axis of size 1 is the identity: nothing is sent.

``all_gather``, ``all_to_all`` and the ring shifts are differentiable
(their backward runs the conjugate collective: a reduce-scatter, the
inverse all-to-all, the opposite shift); ``psum``, ``reduce_scatter``
and ``stage_exchange`` (a pipeline tick's transfers, whose schedule
walks the backward itself) are not.

On a gloo group, device tensors go through host buffers for the
operations gloo does not take on CUDA tensors (:data:`GLOO_CUDA`
lists the ones it takes; several ranks on one card share no NCCL
communicator, so they talk over gloo).  An NCCL group always gets the
device tensors themselves.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

# The collectives gloo runs on CUDA tensors directly (each checked for
# its result on an H100 with torch 2.11).  Its send and receive read a
# device pointer as host memory and fail, so the ring shifts ("p2p") are
# staged through host memory.
GLOO_CUDA = frozenset({"all_reduce", "all_gather", "all_to_all",
                       "reduce_scatter"})


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def _staged(op: str, group, t: torch.Tensor) -> bool:
    """Whether ``op`` on ``t`` over ``group`` goes through the host."""
    return (t.is_cuda and op not in GLOO_CUDA
            and dist.get_backend(group) == "gloo")


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum contiguous ``t`` over ``group`` in place; returns ``t``."""
    if _staged("all_reduce", group, t):
        buf = t.cpu()
        dist.all_reduce(buf, group=group)
        return t.copy_(buf)
    dist.all_reduce(t, group=group)
    return t


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (a new tensor; not differentiable)."""
    out = x.contiguous().clone()
    if axis_size(mesh, axis) == 1:
        return out
    return all_reduce_(out, axis_group(mesh, axis))


def _gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    src = x.cpu() if _staged("all_gather", group, x) else x
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src.contiguous(), group=group)
    return torch.cat(parts, dim).to(x.device)


def _scatter_sum(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The sum over the group of ``x``, this rank's chunk along ``dim``."""
    src = x.cpu() if _staged("reduce_scatter", group, x) else x
    src = src.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).to(x.device)


def reduce_scatter(x: torch.Tensor, mesh, axis: str, *, dim: int = 0
                   ) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, tiled along ``dim``: this rank keeps
    its chunk (not differentiable)."""
    n = axis_size(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {axis} ({n})")
    if n == 1:
        return x.clone()
    return _scatter_sum(x, axis_group(mesh, axis), n, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, grad):
        return _scatter_sum(grad, ctx.group, ctx.n, ctx.dim), None, None, None


def all_gather(x: torch.Tensor, mesh, axis: str, *, dim: int = 0
               ) -> torch.Tensor:
    """Every rank's ``x`` over ``axis``, concatenated along ``dim`` in rank
    order (tiled).  Its backward sums the gradient over the axis and
    keeps this rank's chunk."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    return _AllGather.apply(x, axis_group(mesh, axis), n, dim)


def _a2a(x: torch.Tensor, group, n: int, split_dim: int,
         concat_dim: int) -> torch.Tensor:
    """Chunk ``j`` of ``x`` along ``split_dim`` goes to rank ``j``; the
    chunks received are concatenated along ``concat_dim`` in rank order."""
    src = x.cpu() if _staged("all_to_all", group, x) else x
    chunks = src.movedim(split_dim, 0)
    chunks = chunks.reshape(n, chunks.shape[0] // n, *chunks.shape[1:])
    chunks = chunks.contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=group)
    # out[j] is rank j's chunk for this rank: [n, c, ...] with split_dim
    # first; put each back in place, then concatenate along concat_dim.
    parts = [p.movedim(0, split_dim) for p in out.unbind(0)]
    return torch.cat(parts, concat_dim).to(x.device)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_dim, concat_dim):
        ctx.args = (group, n, concat_dim, split_dim)
        return _a2a(x, group, n, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return _a2a(grad, *ctx.args), None, None, None, None


def all_to_all(x: torch.Tensor, mesh, axis: str, *, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)``: ``x`` split into n chunks along
    ``split_dim``, chunk ``j`` sent to rank ``j``, the received chunks
    concatenated along ``concat_dim`` in rank order."""
    n = axis_size(mesh, axis)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split over {axis} ({n})")
    if n == 1:
        return x
    return _AllToAll.apply(x, axis_group(mesh, axis), n, split_dim,
                           concat_dim)


def _peer(group, n: int, idx: int, shift: int) -> int:
    """The global rank ``shift`` places along the ring from ``idx``."""
    return dist.get_global_rank(group, (idx + shift) % n)


def _shift(tensors: Sequence[torch.Tensor], group, n: int, idx: int,
           shift: int, wrap: bool) -> List[torch.Tensor]:
    """Send each tensor ``shift`` (+1 or -1) places along the ring and
    receive the ones sent to this rank; without ``wrap`` the edge rank
    sends nothing and the other edge receives zeros."""
    send = wrap or 0 <= idx + shift < n
    recv = wrap or 0 <= idx - shift < n
    staged = any(_staged("p2p", group, t) for t in tensors)
    ops, bufs = [], []
    for tag, t in enumerate(tensors):
        src = t.cpu() if staged else t.contiguous()
        buf = torch.empty_like(src)
        if send:
            ops.append(dist.P2POp(dist.isend, src,
                                  _peer(group, n, idx, shift), group, tag))
        if recv:
            ops.append(dist.P2POp(dist.irecv, buf,
                                  _peer(group, n, idx, -shift), group, tag))
        bufs.append(buf)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if not recv:
        return [torch.zeros_like(t) for t in tensors]
    return [b.to(t.device) for b, t in zip(bufs, tensors)]


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, n, idx, shift, wrap, *tensors):
        ctx.args = (group, n, idx, -shift, wrap)
        return tuple(_shift(tensors, group, n, idx, shift, wrap))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) * 5 + tuple(_shift(grads, *ctx.args))


def _shifted(tensors, mesh, axis: str, shift: int, wrap: bool):
    n = axis_size(mesh, axis)
    tensors = tuple(tensors)
    if n == 1:
        return tensors if wrap else tuple(torch.zeros_like(t)
                                          for t in tensors)
    return _Shift.apply(axis_group(mesh, axis), n, axis_index(mesh, axis),
                        shift, wrap, *tensors)


def ppermute_next(tensors: Sequence[torch.Tensor], mesh, axis: str):
    """Rotate each tensor one step forward along the ring (rank i -> i+1,
    the last to the first), all in one batch of sends and receives."""
    return _shifted(tensors, mesh, axis, 1, True)


def ppermute_prev(tensors: Sequence[torch.Tensor], mesh, axis: str):
    """Rotate each tensor one step backward along the ring (i -> i-1)."""
    return _shifted(tensors, mesh, axis, -1, True)


def send_next(tensors: Sequence[torch.Tensor], mesh, axis: str):
    """Shift to the next rank without wraparound: rank 0 receives zeros."""
    return _shifted(tensors, mesh, axis, 1, False)


def send_prev(tensors: Sequence[torch.Tensor], mesh, axis: str):
    """Shift to the previous rank without wraparound: the last rank
    receives zeros."""
    return _shifted(tensors, mesh, axis, -1, False)


def stage_exchange(mesh, axis: str, *, to_next=None, to_prev=None,
                   from_prev=None, from_next=None, wrap: bool = False):
    """One pipeline tick's point-to-point transfers along ``axis``: the
    ring shifts' sends and receives (:func:`send_next`,
    :func:`send_prev`), each made only where a schedule has one.

    ``to_next`` goes to the rank after this one, ``to_prev`` to the one
    before.  ``from_prev`` / ``from_next`` give the shape, dtype and
    device of what arrives from those ranks (their values are not read),
    or None where nothing does.  Each rank must be given exactly the
    transfers its neighbours make, so both read them from one schedule
    table; a send with no matching receive leaves both ranks waiting.
    ``wrap`` joins the last rank to the first (the interleaved
    schedule's ring); a one-rank ring sends to itself.  Returns
    ``(got_prev, got_next)``, None where nothing was received.

    On a mesh of several axes ``axis``'s group is this rank's ring: the
    ranks that share its coordinates on the other axes, so each
    coordinate's stages exchange on a group of their own.

    Transfers towards the next rank carry tag 0 and towards the previous
    tag 1, and each rank posts them in that order, so two ranks that are
    each other's next and previous (a ring of two) match them by tag on
    gloo.  NCCL, which ignores tags, would have to match them by that
    order; no run has sent them between NCCL ranks yet (one card holds
    one NCCL rank, and a one-rank ring sends nothing)."""
    n, idx = axis_size(mesh, axis), axis_index(mesh, axis)
    with_next = to_next is not None or from_next is not None
    with_prev = to_prev is not None or from_prev is not None
    if not wrap and (with_next and idx == n - 1 or with_prev and idx == 0):
        raise ValueError(f"stage_exchange: rank {idx} of {n} has no "
                         f"neighbour there on an unwrapped {axis!r}")
    if n == 1:  # a ring of one: what leaves arrives back
        return (None if from_prev is None else to_next,
                None if from_next is None else to_prev)
    group = axis_group(mesh, axis)
    tensors = [t for t in (to_next, to_prev, from_prev, from_next)
               if t is not None]
    staged = any(_staged("p2p", group, t) for t in tensors)
    ops = []

    def send(t, shift, tag):
        src = t.detach().cpu() if staged else t.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, src, _peer(group, n, idx, shift),
                              group, tag))

    def recv(like, shift, tag):
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if staged else like.device)
        ops.append(dist.P2POp(dist.irecv, buf, _peer(group, n, idx, shift),
                              group, tag))
        return buf

    if to_next is not None:
        send(to_next, 1, 0)
    got_prev = None if from_prev is None else recv(from_prev, -1, 0)
    if to_prev is not None:
        send(to_prev, -1, 1)
    got_next = None if from_next is None else recv(from_next, 1, 1)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return (None if got_prev is None else got_prev.to(from_prev.device),
            None if got_next is None else got_next.to(from_next.device))
