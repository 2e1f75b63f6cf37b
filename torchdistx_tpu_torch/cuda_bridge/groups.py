"""The recording split into groups of entries (the port's own copy of
``torchdistx_tpu/jax_bridge/compile.py``'s ``collect_nodes``,
``_components``, ``_node_sig``, ``group_fingerprint`` and
``split_init_groups``).

The JAX bridge compiles one program per group so that compiles overlap
execution; the port replays each group eagerly, and the groups are the
unit of its retry ladder and of resume (:mod:`.materialize`).  The bins
are the JAX function's bins for the same module: components of the
recorded graph (storage-aliased constants kept together), grouped by
structural fingerprint, greedily cost-balanced into at most
``max_programs`` bins.  They depend only on the recording and
``max_programs``, never on the host.

:func:`collect_nodes` walks each entry's call stack through
``OpNode.build_call_stack``, which runs in the native graph engine
(:mod:`.._native`) wherever it is loaded.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .._graph import CONTEXT_KEY, OpNode, _Dep
from ..fake import get_fake_context

__all__ = ["collect_nodes", "group_fingerprint", "split_init_groups"]


def _op_name(node: OpNode) -> str:
    func = node.op.func
    try:
        return (f"{func.namespace}.{func._schema.name.split('::')[-1]}."
                f"{func._overloadname or 'default'}")
    except AttributeError:
        return node.op.name


def _storage_key(t: torch.Tensor):
    s = t.untyped_storage()
    return (s.data_ptr(), s.nbytes())


def _raw_bytes(t: torch.Tensor) -> bytes:
    """A host tensor's bytes in row-major order (bf16 through int16:
    numpy has no bf16)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _tensor_digest(t: torch.Tensor) -> Tuple:
    return ("tensor", tuple(t.shape), str(t.dtype).removeprefix("torch."),
            hashlib.sha1(_raw_bytes(t)).hexdigest())


def collect_nodes(fakes: Sequence[torch.Tensor]) -> List[OpNode]:
    """Union of the fakes' call stacks in chronological order."""
    nodes: List[OpNode] = []
    seen: set = set()
    for f in fakes:
        ctx = get_fake_context(f, CONTEXT_KEY)
        if ctx is None:
            raise ValueError(
                "a tensor passed to the materializer has no deferred-init "
                "recording (it is either real or already materialized)")
        for n in ctx.node.build_call_stack():
            if id(n) not in seen:
                seen.add(id(n))
                nodes.append(n)
    nodes.sort(key=lambda n: n.op_nr)
    return nodes


def _components(nodes: Sequence[OpNode]) -> List[List[OpNode]]:
    """Dependency-connected components, each in chronological order,
    ordered by first op; components touching one early-materialized
    storage stay together (a recorded in-place write in one is visible to
    readers in the other)."""
    parent = {id(n): id(n) for n in nodes}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    storage_anchor: Dict[Any, int] = {}

    def union_storage(nid: int, out) -> None:
        if not isinstance(out, torch.Tensor) or out.untyped_storage().nbytes() == 0:
            return
        a = storage_anchor.setdefault(_storage_key(out), nid)
        union(nid, a)

    for n in nodes:
        if n.materialized and n.outputs is not None:
            for out in n.outputs:
                union_storage(id(n), out)
        for d, idx in n.dependencies:
            if id(d) in parent:
                union(id(n), id(d))
            elif d.materialized and d.outputs is not None and idx < len(d.outputs):
                union_storage(id(n), d.outputs[idx])
    comps: Dict[int, List[OpNode]] = {}
    for n in nodes:
        comps.setdefault(find(id(n)), []).append(n)
    return list(comps.values())


def _value_sig(obj, deps, local_index):
    if isinstance(obj, _Dep):
        node, idx = deps[obj.index]
        li = local_index.get(id(node))
        if li is None:
            # A dependency outside the component (read while recording):
            # its value is the instance's own, so the signature is unique.
            return ("extdep", id(node), idx)
        return ("dep", li, idx)
    if isinstance(obj, torch.Tensor):
        return _tensor_digest(obj)
    if isinstance(obj, (list, tuple)):
        kind = "list" if isinstance(obj, list) else "tuple"
        return (kind, tuple(_value_sig(x, deps, local_index) for x in obj))
    if isinstance(obj, dict):
        return ("dict", tuple(sorted(
            (k, _value_sig(v, deps, local_index)) for k, v in obj.items())))
    if isinstance(obj, torch.Size):
        return ("size", tuple(obj))
    if isinstance(obj, (torch.device, torch.dtype, torch.layout,
                        torch.memory_format)):
        return ("torch", str(obj))
    return ("py", type(obj).__name__, repr(obj))


def _node_sig(node: OpNode, local_index: Dict[int, int]):
    if node.materialized:
        return ("terminal", id(node))
    return (
        _op_name(node),
        _value_sig(node.op.args, node.dependencies, local_index),
        _value_sig(node.op.kwargs, node.dependencies, local_index),
        str(node.op.tls.default_dtype),
    )


def _fp_value_sig(obj, deps, local_index):
    """Like :func:`_value_sig`, stable across processes: a dependency on
    a value read while recording is signed by its content."""
    if isinstance(obj, _Dep):
        node, idx = deps[obj.index]
        li = local_index.get(id(node))
        if li is not None:
            return ("dep", li, idx)
        if node.materialized and node.outputs is not None and idx < len(node.outputs):
            out = node.outputs[idx]
            if isinstance(out, torch.Tensor):
                return ("extconst",) + _tensor_digest(out)
            return ("extconst", "py", repr(out))
        raise ValueError(f"group fingerprint: unstable external dependency "
                         f"on {node.op.name!r}")
    if isinstance(obj, torch.Tensor):
        return _tensor_digest(obj)
    if isinstance(obj, (list, tuple)):
        kind = "list" if isinstance(obj, list) else "tuple"
        return (kind, tuple(_fp_value_sig(x, deps, local_index) for x in obj))
    if isinstance(obj, dict):
        return ("dict", tuple(sorted(
            (k, _fp_value_sig(v, deps, local_index)) for k, v in obj.items())))
    return _value_sig(obj, deps, local_index)


def group_fingerprint(fakes: Sequence[torch.Tensor]) -> str:
    """Content fingerprint of the recorded computation of ``fakes``: op
    names, argument values, RNG ``key_nr``s, values read while recording,
    and the requested outputs.  Stable across processes: resume keys its
    manifest on it, so a rerun skips only a group whose recorded
    computation equals the committed one."""
    nodes = collect_nodes(fakes)
    local_index = {id(n): j for j, n in enumerate(nodes)}
    h = hashlib.sha1(b"tdx-group-fp-v1")
    for n in nodes:
        if n.materialized and n.outputs is not None:
            sig: Tuple = ("terminal", tuple(
                _tensor_digest(o) if isinstance(o, torch.Tensor)
                else ("py", repr(o)) for o in n.outputs))
        else:
            tls = n.op.tls
            sig = (
                _op_name(n),
                _fp_value_sig(n.op.args, n.dependencies, local_index),
                _fp_value_sig(n.op.kwargs, n.dependencies, local_index),
                str(tls.default_dtype) if tls is not None else None,
            )
        h.update(repr((n.key_nr, sig)).encode())
    for f in fakes:
        ctx = get_fake_context(f, CONTEXT_KEY)
        h.update(repr((local_index.get(id(ctx.node), -1), ctx.output_index,
                       tuple(f.shape), str(f.dtype))).encode())
    return h.hexdigest()


def split_init_groups(fakes: Sequence[torch.Tensor], max_programs: int = 8,
                      *, nodes: Optional[List[OpNode]] = None
                      ) -> List[List[int]]:
    """Partition the indices of ``fakes`` into at most ``max_programs``
    bins of structurally related components.

    Components are grouped by structural fingerprint (everything but the
    RNG ``key_nr``), then the fingerprint groups are greedily
    cost-balanced into bins, largest first: a group costs 16 per node of
    its representative and 1 per repeated instance.  Deterministic for a
    recording and ``max_programs``.  ``nodes`` may pass a precollected
    :func:`collect_nodes` result."""
    if nodes is None:
        nodes = collect_nodes(fakes)
    comps = _components(nodes)
    node2comp: Dict[int, int] = {}
    for ci, comp in enumerate(comps):
        for n in comp:
            node2comp[id(n)] = ci

    sig2group: Dict[Any, int] = {}
    comp2group: Dict[int, int] = {}
    group_cost: List[int] = []
    for ci, comp in enumerate(comps):
        local_index = {id(n): j for j, n in enumerate(comp)}
        sig = tuple(_node_sig(n, local_index) for n in comp)
        gi = sig2group.get(sig)
        if gi is None:
            gi = sig2group[sig] = len(group_cost)
            group_cost.append(16 * len(comp))
        else:
            group_cost[gi] += 1
        comp2group[ci] = gi

    group_slots: Dict[int, List[int]] = {}
    for i, f in enumerate(fakes):
        ctx = get_fake_context(f, CONTEXT_KEY)
        gi = comp2group[node2comp[id(ctx.node)]]
        group_slots.setdefault(gi, []).append(i)

    order = sorted(group_slots, key=lambda g: (-group_cost[g], g))
    n_bins = max(1, min(len(order), max_programs))
    bins: List[List[int]] = [[] for _ in range(n_bins)]
    bin_cost = [0] * n_bins
    for g in order:
        j = bin_cost.index(min(bin_cost))
        bins[j].extend(group_slots[g])
        bin_cost[j] += group_cost[g]
    out = [sorted(b) for b in bins if b]
    out.sort(key=lambda b: b[0])
    return out
