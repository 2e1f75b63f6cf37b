"""The recorded-operation graph and materialization engine.

The port's own copy of ``torchdistx_tpu/_graph.py`` (its telemetry
calls are not carried over).  The graph *topology* is mirrored into the
native engine (``csrc/tdx_graph.cc``, loaded by :mod:`._native`) when
its library is loaded, and the call-stack walk is delegated there; the
Python walks below stay the reference (``TDX_NATIVE=0``).  The data
model mirrors the reference torchdistx's deferred-init core
(``deferred_init.cc``) one-to-one:

* :class:`Op` — one recorded ATen call: the op, a preserved (compound-
  deep-copied) argument stack, and the captured grad-mode state;
* :class:`OpNode` — a node in the replay DAG: chronological ``op_nr``,
  output meta-storage keys for alias/in-place detection, dependencies on
  producing nodes, weak dependent back-edges, and version counters of
  external (real) tensor arguments;
* :class:`DeferredInitContext` — the per-fake-tensor context stored in the
  fake-context registry, updated in place as the fake is re-produced by
  in-place ops; aliasing outputs are retained via the base's ``views``
  list so recordings survive the death of view fakes;
* :func:`materialize` — the replay engine: last-in-place walk, call-stack
  collection (dependencies + in-place dependents + clobbered readers),
  chronological replay with external-version verification.

Replay runs through a :class:`ReplayTarget`, which rewrites the devices
the fakes claimed (``cuda``, ``meta``) to the device the caller asked
for — by default the GPU.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import torch

from . import _native
from .fake import (
    FakeTensor,
    _iter_tensors,
    get_fake_context,
    is_fake,
    set_fake_context,
    del_fake_context,
)

import itertools

CONTEXT_KEY = "deferred_init"

_op_counter = itertools.count()


# GC pause refcount: recording and replay allocate thousands of cyclic
# node/op/trace objects that survive their region, so Python's
# generational collector rescans them repeatedly for nothing (~40% of a
# 70B record's wall time, measured).  gc.disable() is process-GLOBAL
# while regions are per-thread, so concurrent/nested regions share one
# counter — collection resumes when the LAST region exits, and only if
# this module was the one that disabled it.
_gc_pause_lock = threading.Lock()
_gc_pause_depth = 0
_gc_disabled_by_us = False


@contextlib.contextmanager
def gc_paused():
    """Pause cyclic GC for an allocation-heavy region (recording, eager
    replay, bridge interpretation); exception-safe, re-entrant, and
    thread-shared.  Allocation-triggered collections resume at exit and
    reap the region's actual garbage then."""
    global _gc_pause_depth, _gc_disabled_by_us
    with _gc_pause_lock:
        _gc_pause_depth += 1
        # Checked on EVERY entry, not just the 0->1 transition: if the
        # outermost region found GC already off (flag stays False) and
        # other code re-enabled it mid-region, a nested entry re-arms
        # the pause instead of silently degrading.
        if gc.isenabled():
            gc.disable()
            _gc_disabled_by_us = True
    try:
        yield
    finally:
        with _gc_pause_lock:
            _gc_pause_depth -= 1
            if _gc_pause_depth == 0 and _gc_disabled_by_us:
                _gc_disabled_by_us = False
                gc.enable()


def _next_op_nr() -> int:
    # Monotone op number: replay order is chronological recording order.
    # The reference's counter is thread-local (deferred_init.cc:379, 668),
    # which leaves cross-thread recordings unordered; a process-global
    # counter is a strict superset (still monotone within a thread) and
    # makes interleaved recordings replay correctly.
    return next(_op_counter)


# Session-relative numbering for RNG-key derivation.  The global op_nr
# is only an *ordering*; its raw value depends on everything recorded
# before (other threads, earlier models), so the keyed materializer
# (cuda_bridge) must not fold it into RNG keys.  Each top-level
# deferred-init session numbers its ops 0..n on a thread-local counter:
# the same model recorded under the same seed yields the same parameters
# no matter what else this process recorded.
_session_tls = threading.local()


class _SessionToken:
    """Identity tag for one recording session, carrying the session's
    RNG-bearing node list.  Nodes hold their token strongly and the token
    holds the rng list strongly, so a session's dead draws stay reachable
    exactly as long as any of its nodes (i.e. any of its fakes) lives —
    materializing model A after model B was recorded still replays A's
    own dead draws (and never B's)."""

    __slots__ = ("rng_nodes",)

    def __init__(self) -> None:
        self.rng_nodes: List["OpNode"] = []


def begin_recording_session() -> None:
    _session_tls.counter = itertools.count()
    _session_tls.token = _SessionToken()
    # The thread-local list IS the token's list (one object): recording
    # appends via the TLS alias, consumers reach it via node tokens.  It
    # outlives the region: value reads after it (b.item() on a returned
    # fake) must still replay pending draws in recorded order; the next
    # session starts a fresh list.
    _session_tls.rng_nodes = _session_tls.token.rng_nodes


def end_recording_session() -> None:
    _session_tls.counter = None
    # rng_nodes is deliberately KEPT: value reads after the region
    # (b.item() on a returned fake) must still replay pending draws in
    # recorded order.  The list resets at the next session start.


def _next_key_nr(op_nr: int) -> int:
    counter = getattr(_session_tls, "counter", None)
    return next(counter) if counter is not None else op_nr


# Ops that consume the torch global generator at replay.  Tracked per
# session so control-flow-forced early materialization can replay every
# pending draw in chronological order first — keeping the generator
# stream aligned with eager execution (see flush_pending_rng).
_RNG_OP_NAMES = {
    "aten::uniform_", "aten::normal_", "aten::normal", "aten::bernoulli",
    "aten::bernoulli_", "aten::rand", "aten::randn", "aten::randint",
    "aten::randint_", "aten::random_", "aten::randperm",
    "aten::exponential_", "aten::cauchy_", "aten::log_normal_",
    "aten::geometric_", "aten::multinomial", "aten::poisson",
    "aten::rrelu_with_noise", "aten::rand_like", "aten::randn_like",
    "aten::randint_like",
}


def _is_rng_op(func) -> bool:
    schema = getattr(func, "_schema", None)
    return schema is not None and schema.name in _RNG_OP_NAMES


def flush_pending_rng(target: Optional["ReplayTarget"] = None) -> None:
    """Replay every not-yet-materialized RNG-consuming node of the current
    recording session, in global chronological order.

    Called before any control-flow-forced early materialization
    (terminal ops, ``bool(fake)``).  Rationale: recording consumes no RNG,
    so at any point during recording, *eager* execution would have drawn
    every random op recorded so far, in recorded order.  Early-replaying
    only the needed chain draws those ops out of order (totals match,
    positions do not — observed as HF ViT's trunc_normal_ rejection
    sampling desyncing later weights); replaying all pending draws first
    keeps the generator stream bit-aligned with eager.
    """
    pending = [
        n for n in getattr(_session_tls, "rng_nodes", [])
        if not n.materialized
    ]
    if not pending:
        return
    target = target or ReplayTarget()
    todo: List[OpNode] = []
    seen: Set[int] = set()
    for n in pending:
        for m in n.build_call_stack():
            if id(m) not in seen:
                seen.add(id(m))
                todo.append(m)
    for m in sorted(todo, key=lambda n: n.op_nr):
        replay_node(m, target)
    # Cleared only after every replay succeeded: a partial failure (e.g.
    # the modified-external-arg check) that constructor code catches must
    # keep the unmaterialized remainder tracked for the next flush.
    # Clear IN PLACE: the list is aliased by the session token
    # (materialize_many reaches dead draws through it), so rebinding the
    # TLS name would silently fork the two views.
    del _session_tls.rng_nodes[:]


class _Dep:
    """Placeholder for a fake argument in a preserved stack.

    The reference nulls out fake tensor args after recording their
    dependency to break reference cycles (deferred_init.cc:476); we replace
    them with an index into the node's dependency list.
    """

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def __repr__(self):
        return f"_Dep({self.index})"


def _copy_preserved(obj, fake_to_dep):
    """copyStack equivalent (deferred_init.cc:65-96): deep-copy compound
    containers, keep leaves by reference, substitute fakes with deps."""
    if isinstance(obj, torch.Tensor):
        if is_fake(obj):
            return fake_to_dep(obj)
        return obj
    if isinstance(obj, (list, tuple)):
        copied = [_copy_preserved(x, fake_to_dep) for x in obj]
        return copied if isinstance(obj, list) else tuple(copied)
    if isinstance(obj, dict):
        return {k: _copy_preserved(v, fake_to_dep) for k, v in obj.items()}
    _validate_leaf(obj)
    return obj


_ALLOWED_LEAVES = (
    type(None), bool, int, float, complex, str,
    torch.device, torch.dtype, torch.layout, torch.memory_format,
    torch.Generator, torch.Size,
)


def _validate_leaf(obj) -> None:
    # validateStack whitelist (deferred_init.cc:230-256): immutable IValue
    # types only, so replay state is reproducible.
    if not isinstance(obj, _ALLOWED_LEAVES):
        raise RuntimeError(
            f"Argument of type `{type(obj).__name__}` cannot be recorded for "
            f"deferred initialization; only immutable argument types are "
            f"supported."
        )


def _storage_key(meta: torch.Tensor) -> int:
    return meta.untyped_storage()._cdata


class ThreadLocalState:
    """Replay-relevant thread-local state, captured per recorded op and
    restored around its replay — the counterpart of the reference's
    ``at::ThreadLocalState`` capture in ``Op``'s constructor and its
    ``ThreadLocalStateGuard`` during materialization
    (deferred_init.cc:207, 263).

    Captures grad mode, per-device autocast (enabled + dtype for every
    autocast-capable backend the build knows), the autocast cache flag,
    and the default dtype (factory ops recorded without an explicit
    ``dtype=`` resolve it at replay time).
    """

    __slots__ = ("grad_enabled", "autocast", "autocast_cache_enabled",
                 "default_dtype")

    _DEVICES = ("cpu", "cuda")
    # Device-typed autocast introspection landed in torch 2.4; on older
    # torch the capture degrades to grad mode + default dtype only.
    _HAS_DEVICE_AUTOCAST = hasattr(torch, "get_autocast_dtype")

    def __init__(self, grad_enabled: bool, autocast: tuple,
                 autocast_cache_enabled: bool, default_dtype: torch.dtype):
        self.grad_enabled = grad_enabled
        # ((device_type, enabled, dtype), ...)
        self.autocast = autocast
        self.autocast_cache_enabled = autocast_cache_enabled
        self.default_dtype = default_dtype

    @classmethod
    def capture(cls) -> "ThreadLocalState":
        if cls._HAS_DEVICE_AUTOCAST:
            autocast = tuple(
                (d, torch.is_autocast_enabled(d), torch.get_autocast_dtype(d))
                for d in cls._DEVICES
            )
            cache = torch.is_autocast_cache_enabled()
        else:  # torch < 2.4
            autocast, cache = (), True
        return cls(
            grad_enabled=torch.is_grad_enabled(),
            autocast=autocast,
            autocast_cache_enabled=cache,
            default_dtype=torch.get_default_dtype(),
        )

    def restore(self):
        """Context manager restoring the captured state on this thread.

        Hot path (`materialize_module` replays thousands of ops): contexts
        are entered only for state that actually differs from ambient."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.set_grad_enabled(self.grad_enabled))
        prev_default = torch.get_default_dtype()
        if prev_default != self.default_dtype:
            torch.set_default_dtype(self.default_dtype)
            stack.callback(torch.set_default_dtype, prev_default)
        for device_type, enabled, dtype in self.autocast:
            if torch.is_autocast_enabled(device_type) != enabled or (
                enabled and torch.get_autocast_dtype(device_type) != dtype
            ):
                stack.enter_context(
                    torch.autocast(
                        device_type, dtype=dtype, enabled=enabled,
                        cache_enabled=self.autocast_cache_enabled,
                    )
                )
        return stack

    def __eq__(self, other):
        return isinstance(other, ThreadLocalState) and all(
            getattr(self, s) == getattr(other, s) for s in self.__slots__
        )


@dataclass
class Op:
    """One recorded call (deferred_init.cc:163-297)."""

    func: Any  # OpOverload or callable with torch-like signature
    args: tuple
    kwargs: dict
    tls: ThreadLocalState
    name: str

    def replay(self, target: "ReplayTarget", resolved_args, resolved_kwargs):
        with self.tls.restore():
            return target.run(self, resolved_args, resolved_kwargs)


class OpNode:
    """A node of the replay DAG (deferred_init.cc:309-705).

    The graph *topology* (op_nr order, storage alias keys, dep/dependent
    edges) is mirrored into the native engine when its library is
    loaded, and :meth:`build_call_stack` delegates there; the Python
    walks remain the reference (``TDX_NATIVE=0``)."""

    __slots__ = (
        "op", "op_nr", "key_nr", "storages", "dependencies", "dependents",
        "argument_versions", "outputs", "materialized", "loaded",
        "session_token", "out_geom", "_ng", "_nid", "__weakref__",
    )

    def __init__(self, op: Op, *, key_nr: Optional[int] = None):
        self.op = op
        self.op_nr = _next_op_nr()
        # The op's number within its recording session: the keyed
        # materializer derives the op's RNG key from it (see
        # _next_key_nr); outside a session it falls back to op_nr.  An
        # explicit key_nr (serialize.load_recording rebuilding saved
        # nodes) must NOT consume the session counter, or loading a
        # recording mid-session would shift the RNG keys of every op
        # recorded after it.
        self.key_nr = _next_key_nr(self.op_nr) if key_nr is None else key_nr
        # True for nodes rebuilt by serialize.load_recording: their
        # storage alias keys are file-local, so the graph cannot be
        # *extended* with new ops (record_op refuses); replay is
        # unaffected.
        self.loaded = False
        # Which recording session this node belongs to (None outside a
        # session): materialize_many's include_session_rng uses it to
        # replay only the *requested model's* dead RNG draws, never a
        # newer session's.
        self.session_token = getattr(_session_tls, "token", None)
        # Meta storages of fake outputs: the alias/in-place detection key
        # (deferred_init.cc:384, 413-425).
        self.storages: Set[int] = set()
        # (producer node, output index among tensor outputs) per fake input
        # (OpOutputDescriptor, deferred_init.cc:102-118).
        self.dependencies: List[Tuple["OpNode", int]] = []
        # Back-edges; weak so the graph has no cycles (the reference uses
        # raw pointers erased in the dtor, deferred_init.cc:394, 409-411).
        self.dependents: "weakref.WeakSet[OpNode]" = weakref.WeakSet()
        # (tensor, version at record time) for external real tensor args
        # (deferred_init.cc:391, 477-486).
        self.argument_versions: List[Tuple[torch.Tensor, int]] = []
        self.outputs: Optional[List[Any]] = None
        self.materialized = False
        # Physical meta geometry per tensor-output index, (size, stride,
        # storage_offset, storage_numel), kept only where it is not
        # C-contiguous from offset 0 over the whole storage: the saved
        # recording carries it for the JAX package's bridge, whose
        # storage-relative ops need it (see geom_is_c_contig_spanning).
        self.out_geom: Dict[int, Tuple] = {}
        if _native.available():
            self._ng = _native.NativeGraph.current()
            self._nid = self._ng.node_create()
            self._ng.py_nodes[self._nid] = weakref.ref(self)
        else:
            self._ng = None
            self._nid = 0

    def __del__(self):
        # Mirror the reference's OpNode destructor: erase back-edges in
        # the native graph (deferred_init.cc:409-411).
        if self._ng is not None:
            try:
                self._ng.py_nodes.pop(self._nid, None)
                self._ng.node_destroy(self._nid)
            except Exception:
                pass

    def _native_sync_edges(self) -> None:
        """Push dependencies and storages to the native mirror (once,
        after record_op fills them in).

        A dependency recorded on another thread lives in another native
        graph; neither graph then has the whole topology, so BOTH are
        poisoned (their walks run in Python, on the process-global op_nr
        order, which stays correct)."""
        if self._ng is None:
            # A Python-only node (recorded under config.override(
            # native=False)) extending graphs that DO have native
            # mirrors: those mirrors no longer see the whole topology.
            for dep, _ in self.dependencies:
                if dep._ng is not None:
                    dep._ng.poisoned = True
            return
        foreign = [dep for dep, _ in self.dependencies if dep._ng is not self._ng]
        if foreign:
            self._ng.poisoned = True
            for dep in foreign:
                if dep._ng is not None:
                    dep._ng.poisoned = True
            return
        for dep, idx in self.dependencies:
            self._ng.add_dep(self._nid, dep._nid, idx)
        for key in self.storages:
            self._ng.add_storage(self._nid, key)

    # -- graph walks -----------------------------------------------------

    def last_in_place_node(self) -> "OpNode":
        """Latest node mutating this node's storages.

        Walks BOTH dependent and dependency edges, traversing through
        storage-aliasing nodes. The reference walks dependents only
        (getLastInPlaceOpNode, deferred_init.cc:537-575), which misses
        in-place ops recorded against a view's *base* fake — the mutation
        node depends on the base's producer, not on the view node — and
        replays the stale pre-mutation value. The bidirectional walk
        reaches every alias-relative, restoring eager semantics (found by
        the replay fuzzer, tests/test_fuzz_replay.py).  Delegated to the
        native engine as :meth:`build_call_stack` is."""
        if self._ng is not None and not self._ng.poisoned:
            found = self._ng.nodes_of([self._ng.last_in_place(self._nid)])
            if found is not None:
                return found[0]
        last = self
        seen = {id(self)}
        stack: List[OpNode] = [self]
        while stack:
            n = stack.pop()
            for m in list(n.dependents) + [d for d, _ in n.dependencies]:
                if id(m) in seen:
                    continue
                seen.add(id(m))
                if not (m.storages & self.storages):
                    continue
                if m.op_nr > last.op_nr:
                    last = m
                stack.append(m)
        return last

    def build_call_stack(self) -> List["OpNode"]:
        """buildCallStack + collectCallStack (deferred_init.cc:526-618).

        Includes: the dependency closure of the last in-place node; every
        in-place dependent mutating our storages up to that node; and
        *readers* — non-aliasing dependents of any included node whose
        input storage is clobbered by a later included in-place op (they
        must replay before the mutation or they can never replay
        correctly).

        Delegates to the native engine when its library is loaded and
        this node's graph is whole; the Python code below is the
        reference.
        """
        if self._ng is not None and not self._ng.poisoned:
            stack = self._ng.nodes_of(self._ng.build_call_stack(self._nid))
            if stack is not None:
                return stack
        _native.walks["python"] += 1
        last = self.last_in_place_node()
        included: Dict[int, OpNode] = {}

        def visit(n: "OpNode") -> None:
            if id(n) in included:
                return
            included[id(n)] = n
            for dep, _ in n.dependencies:
                if not dep.materialized:
                    visit(dep)

        visit(self)
        if last is not self:
            visit(last)

        # Fixpoint closure: for every included node, pull in (a) dependents
        # that alias its storages (in-place mutations and views — the view
        # chain w → select → add_ must replay even though the final node
        # does not depend on it), up to the last in-place node; (b) readers
        # of a storage that a later included in-place op clobbers (they can
        # never replay correctly afterwards).  Readers are found through
        # EVERY included alias of the clobbered storage, not only the
        # mutator's direct dependency — a reader through a view (e.g. a
        # `.data` detach) of the mutated base is equally clobbered (found
        # by the replay fuzzer, tests/test_fuzz_replay.py data-ops suite).
        changed = True
        while changed:
            changed = False
            nodes_now = list(included.values())
            # The alias FRONTIER: included nodes plus their transitive
            # alias closure, in BOTH directions.  Materialized nodes are
            # never replayed, but their cached outputs still carry the
            # aliasing relation — dependencies reach the storage's base,
            # and materialized aliasing DEPENDENTS reach the rest of the
            # alias web hanging off it (e.g. a data-read→add_→zero_ chain
            # on the base), whose own non-aliasing readers (clone/
            # deepcopy) are clobbered by an included mutator of the
            # shared storage just the same.
            frontier = list(nodes_now)
            fseen = {id(f) for f in frontier}
            fi = 0
            while fi < len(frontier):
                f = frontier[fi]
                for dep, _ in f.dependencies:
                    if id(dep) not in fseen:
                        fseen.add(id(dep))
                        frontier.append(dep)
                for d in f.dependents:
                    if (
                        id(d) not in fseen
                        and d.materialized
                        and d.storages & f.storages
                    ):
                        fseen.add(id(d))
                        frontier.append(d)
                fi += 1
            for f in frontier:
                # (a) aliasing dependents of any frontier node replay too
                # (mutations and views of the same storages), up to the
                # last in-place node.
                for d in list(f.dependents):
                    if id(d) in included or d.materialized:
                        continue
                    if d.op_nr <= last.op_nr and d.storages & f.storages:
                        visit(d)
                        changed = True
            # Storage index over the frontier so the reader scan touches
            # only genuinely aliasing (n, v) pairs, not the full product.
            carriers_by_storage: Dict[int, List[OpNode]] = {}
            for v in frontier:
                for sk in v.storages:
                    carriers_by_storage.setdefault(sk, []).append(v)
            for n in nodes_now:
                # (b) n mutates a storage an earlier frontier node v
                # aliases; v's non-aliasing dependents that read before
                # the mutation are clobbered by it (replaying onto a
                # materialized v mutates its cached output) and must
                # replay first.
                seen_v: Set[int] = set()
                for sk in n.storages:
                    for v in carriers_by_storage.get(sk, ()):
                        if v is n or id(v) in seen_v or v.op_nr >= n.op_nr:
                            continue
                        seen_v.add(id(v))
                        for reader in list(v.dependents):
                            if (
                                id(reader) not in included
                                and reader.op_nr < n.op_nr
                                and not reader.materialized
                                and not (reader.storages & v.storages)
                            ):
                                visit(reader)
                                changed = True
        return sorted(included.values(), key=lambda n: n.op_nr)

    def detach_dependencies(self) -> None:
        """Free replay-only memory as materialization proceeds (the
        reference drops its dependency refs outright,
        deferred_init.cc:518-521).  The TOPOLOGY stays: later walks still
        traverse materialized nodes — a mutation recorded after this node
        materialized must find readers of its cached output through these
        edges (replay fuzzer).  The heavy payloads go: the preserved
        argument stack (which may pin big external real tensors) and the
        version list; a materialized node never replays again."""
        self.argument_versions = []
        self.op.args = ()
        self.op.kwargs = {}


class DeferredInitContext:
    """Per-fake context stored under the deferred-init key
    (deferred_init.cc:120-161)."""

    __slots__ = ("node", "output_index", "views")

    def __init__(self, node: OpNode, output_index: int):
        self.node = node
        self.output_index = output_index
        # Contexts of aliasing outputs, retained so view recordings survive
        # the view fake's death (deferred_init.cc:139-160, 427-458).
        self.views: List["DeferredInitContext"] = []

    def update(self, node: OpNode, output_index: int) -> None:
        self.node = node
        self.output_index = output_index


# ---------------------------------------------------------------------------
# Recording (recordOp, deferred_init.cc:670-693, 400-492)
# ---------------------------------------------------------------------------


def record_op(func, args, kwargs, out, *, name: Optional[str] = None) -> None:
    """Record one executed op whose inputs or outputs involve fake tensors."""
    dependencies: List[Tuple[OpNode, int]] = []
    seen_fakes: Dict[int, int] = {}
    # Meta-storage key -> context of the input fake owning that storage,
    # used for the view keep-alive below.  Populated during the same
    # traversal that assigns dependency slots so duplicate fake arguments
    # cannot misalign it.
    input_storage_ctx: Dict[int, DeferredInitContext] = {}

    def fake_to_dep(fake: FakeTensor) -> _Dep:
        if id(fake) in seen_fakes:
            return _Dep(seen_fakes[id(fake)])
        ctx = get_fake_context(fake, CONTEXT_KEY)
        if ctx is None:
            raise RuntimeError(
                "A tensor that was constructed in a fake-mode context "
                "outside of deferred-init cannot be used inside a "
                "deferred-init context (see the reference's identical "
                "constraint, deferred_init.cc:821-832)."
            )
        if ctx.node.loaded:
            raise RuntimeError(
                "A fake tensor from a loaded recording cannot be used in "
                "new deferred-init ops: its alias-tracking keys are "
                "file-local, so extensions would replay incorrectly. "
                "Record additional ops before save_recording instead."
            )
        idx = len(dependencies)
        seen_fakes[id(fake)] = idx
        dependencies.append((ctx.node, ctx.output_index))
        input_storage_ctx.setdefault(_storage_key(fake._meta), ctx)
        return _Dep(idx)

    preserved_args = _copy_preserved(tuple(args), fake_to_dep)
    preserved_kwargs = _copy_preserved(dict(kwargs), fake_to_dep)

    op = Op(
        func=func,
        args=preserved_args,
        kwargs=preserved_kwargs,
        tls=ThreadLocalState.capture(),
        name=name or str(func),
    )
    node = OpNode(op)
    node.dependencies = dependencies
    for dep, _ in dependencies:
        dep.dependents.add(node)

    if _is_rng_op(func):
        rng_list = getattr(_session_tls, "rng_nodes", None)
        if rng_list is not None:
            # Strong refs: a draw whose fake died before the flush still
            # consumed an eager stream position and must replay on time.
            # Bounded by the session; cleared on flush / next session.
            rng_list.append(node)

    # Version counters of external (real) tensor args
    # (deferred_init.cc:391, 477-486).
    for t in _iter_tensors((args, kwargs)):
        if not is_fake(t):
            # Inference tensors have no version counter; rejected at
            # materialize time (deferred_init.cc:636-663).
            version = None if t.is_inference() else t._version
            node.argument_versions.append((t, version))

    # Outputs: assign contexts; tensor outputs are indexed by position among
    # tensor outputs (Op::getOutput, deferred_init.cc:270-297).
    tensor_idx = 0
    for t in _iter_tensors(out):
        if is_fake(t):
            m = t._meta
            if not _c_contig_spanning(m):
                node.out_geom[tensor_idx] = (
                    tuple(m.shape), tuple(m.stride()), m.storage_offset(),
                    m.untyped_storage().nbytes() // m.element_size(),
                )
            skey = _storage_key(m)
            node.storages.add(skey)
            existing = get_fake_context(t, CONTEXT_KEY)
            if existing is not None:
                existing.update(node, tensor_idx)
                ctx = existing
            else:
                ctx = DeferredInitContext(node, tensor_idx)
                set_fake_context(t, CONTEXT_KEY, ctx)
            # View keep-alive: output aliases an input's storage → retain
            # the output's context on the base input's context
            # (deferred_init.cc:427-458).
            base_ctx = input_storage_ctx.get(skey)
            if base_ctx is not None and base_ctx is not ctx and ctx not in base_ctx.views:
                base_ctx.views.append(ctx)
        tensor_idx += 1

    node._native_sync_edges()


def geom_is_c_contig_spanning(size, stride, offset, storage_numel) -> bool:
    """C-contiguous from offset 0 AND spanning the whole storage: the
    layout where logical value order equals storage order (the JAX
    package's predicate of the same name, which decides when a saved
    ``geom`` entry is needed)."""
    if offset != 0:
        return False
    expect = 1
    for s, st in zip(reversed(tuple(size)), reversed(tuple(stride))):
        if s != 1 and st != expect:
            return False
        expect *= s
    return expect == storage_numel


def _c_contig_spanning(m: torch.Tensor) -> bool:
    return geom_is_c_contig_spanning(
        m.shape, m.stride(), m.storage_offset(),
        m.untyped_storage().nbytes() // m.element_size(),
    )



# ---------------------------------------------------------------------------
# Synthetic ops — recorded calls that are not ATen OpOverloads.
# ---------------------------------------------------------------------------


def _set_data_replay(base: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    # Replays `base.data = value` on real tensors (reference replay
    # closure for "VariableHooks::set_data", deferred_init.cc:949-971).
    # Rebind a FRESH alias, not `base` itself: `base` is the producer
    # node's cached output, and mutating it would clobber the value for
    # earlier readers that have not replayed yet.  The returned tensor aliases `value`'s storage, so later
    # mutations through either side stay shared.
    out = base.detach()
    out.data = value
    return out


# Stable names of the synthetic ops, for serialize.py.
SYNTHETIC_OPS: Dict[str, Any] = {"tdx::set_data": _set_data_replay}


def _record_set_data(fake: FakeTensor, new: torch.Tensor) -> None:
    """Record `fake.data = new` into the replay graph.

    Called by fake._set_data AFTER the meta swap, so the node's storage
    key is the new (shared) storage and later ops alias correctly.  Fakes
    with no deferred-init context (plain fake_mode) record nothing — the
    reference likewise only proxies set_data while deferred-init is
    enabled (deferred_init.cc:1073-1096).
    """
    has_ctx = get_fake_context(fake, CONTEXT_KEY) is not None or (
        is_fake(new) and get_fake_context(new, CONTEXT_KEY) is not None
    )
    if not has_ctx:
        return
    record_op(_set_data_replay, (fake, new), {}, fake, name="tdx::set_data")
    # Alias keep-alive, mirrored: after `p.data = w`, later mutations of
    # the shared storage recorded *through w* live on nodes held only by
    # w's context — which dies with w. Retain w's context on p's (the
    # same lifetime protocol as record_op's view keep-alive,
    # deferred_init.cc:427-458, in the opposite direction).
    p_ctx = get_fake_context(fake, CONTEXT_KEY)
    w_ctx = get_fake_context(new, CONTEXT_KEY) if is_fake(new) else None
    if w_ctx is not None and w_ctx is not p_ctx and w_ctx not in p_ctx.views:
        p_ctx.views.append(w_ctx)


from . import fake as _fake_module  # noqa: E402  (install the hook)

_fake_module._set_data_recorder = _record_set_data


# ---------------------------------------------------------------------------
# Replay (OpNode::materialize + detail::materialize,
# deferred_init.cc:502-663, 707-732)
# ---------------------------------------------------------------------------


class ReplayTarget:
    """Where replayed ops execute: eagerly, with torch, on ``device``.

    Fakes claim ``cuda`` (or ``cpu``) at record time; replay rewrites a
    claimed ``cuda`` or ``meta`` device to ``device`` (default: the GPU),
    so one recording can be materialized straight into device memory or,
    when the caller asks for it, onto the CPU.  A claimed ``cpu`` stays.
    """

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    def rewrite_device(self, d: torch.device) -> torch.device:
        if d.type in ("cuda", "meta"):
            return self.device
        return d

    def run(self, op: Op, args, kwargs):
        args = self._rewrite(args)
        kwargs = self._rewrite(kwargs)
        return op.func(*args, **kwargs)

    def _rewrite(self, obj):
        if isinstance(obj, torch.device):
            return self.rewrite_device(obj)
        if isinstance(obj, (list, tuple)):
            r = [self._rewrite(x) for x in obj]
            return r if isinstance(obj, list) else tuple(r)
        if isinstance(obj, dict):
            return {k: self._rewrite(v) for k, v in obj.items()}
        return obj


def _resolve(obj, deps: List[Tuple[OpNode, int]], lookup=None):
    """``obj`` with each :class:`_Dep` replaced by its producer's output:
    ``lookup(node, idx)``, by default the node's cached output."""
    if isinstance(obj, _Dep):
        node, idx = deps[obj.index]
        return (lookup or node_output)(node, idx)
    if isinstance(obj, (list, tuple)):
        r = [_resolve(x, deps, lookup) for x in obj]
        return r if isinstance(obj, list) else tuple(r)
    if isinstance(obj, dict):
        return {k: _resolve(v, deps, lookup) for k, v in obj.items()}
    return obj


def node_output(node: OpNode, idx: int):
    assert node.materialized and node.outputs is not None
    return node.outputs[idx]


def _verify_external_args(node: OpNode) -> None:
    # materializeArguments' external checks (deferred_init.cc:636-663).
    for t, version in node.argument_versions:
        if version is None or t.is_inference():
            raise RuntimeError(
                f"The tensor argument of `{node.op.name}` is an inference "
                f"tensor and cannot be used for deferred initialization."
            )
        if t._version != version:
            raise RuntimeError(
                f"A tensor argument of `{node.op.name}` was modified in "
                f"place after it was recorded; the recording can no longer "
                f"be replayed deterministically (the reference's identical "
                f"constraint, deferred_init.cc:643-651)."
            )


def replay_node(node: OpNode, target: ReplayTarget) -> None:
    if node.materialized:
        return
    _verify_external_args(node)
    args = _resolve(node.op.args, node.dependencies)
    kwargs = _resolve(node.op.kwargs, node.dependencies)
    out = node.op.replay(target, args, kwargs)
    node.outputs = flat_outputs(out)
    node.materialized = True
    if node._ng is not None:
        node._ng.set_materialized(node._nid, True)
    node.detach_dependencies()


def flat_outputs(out) -> List[Any]:
    """A replayed op's outputs, flattened to the tensor-position indexing
    of record time (non-tensor outputs as they are when it has no
    tensor output)."""
    flat: List[Any] = []
    _flatten_tensors(out, flat)
    if flat:
        return flat
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _flatten_tensors(o, flat: List[Any]) -> None:
    # A module-level function, not a self-recursive closure: the closure
    # would be a reference cycle holding ``flat`` (and the tensors in it)
    # until the cyclic collector runs, which gc_paused holds off.
    if isinstance(o, torch.Tensor):
        flat.append(o)
    elif isinstance(o, (list, tuple)):
        for x in o:
            _flatten_tensors(x, flat)


def materialize_graph(node: OpNode, target: ReplayTarget) -> None:
    """Replay everything `node` needs, in chronological order."""
    for n in node.build_call_stack():
        replay_node(n, target)


def materialize_many(
    fakes: Sequence[FakeTensor],
    target: Optional[ReplayTarget] = None,
    *,
    include_session_rng: bool = False,
) -> None:
    """Replay the union of the call stacks of ``fakes`` in global
    chronological (``op_nr``) order.

    This is how :func:`materialize_module` replays a whole module: random
    ops then consume the torch RNG in exactly the order the eager
    constructor would have, giving bitwise parity with eager init under a
    fixed seed — a property the reference's strictly per-tensor replay
    cannot provide (its RNG draws happen in materialization order,
    deferred_init.cc:636-663).

    ``include_session_rng=True`` additionally replays the recording
    session's *dead* RNG draws — ops whose outputs no surviving fake
    reaches, e.g. a parameter that was initialized and then replaced by
    weight tying (``self.head.weight = self.emb.weight``).  Eager
    execution consumed those draws, so skipping them would shift the
    generator stream for every draw recorded after (found by the random
    module-tree fuzzer).  Whole-module materialization wants this;
    per-shard paths (FSDP ``param_init_fn``) deliberately do not — the
    whole point there is replaying only the shard's slice of work.
    """
    target = target or ReplayTarget()
    nodes: List[OpNode] = []
    seen: Set[int] = set()

    def add_stack(root: OpNode) -> None:
        for n in root.build_call_stack():
            if id(n) not in seen:
                seen.add(id(n))
                nodes.append(n)

    tokens: Dict[int, _SessionToken] = {}
    for f in fakes:
        ctx = get_fake_context(f, CONTEXT_KEY)
        if ctx is None:
            continue
        tok = ctx.node.session_token
        if tok is not None:
            tokens[id(tok)] = tok
        add_stack(ctx.node)
    if include_session_rng:
        # Dead draws are tracked on each session's token, reached through
        # the requested fakes' own nodes — so this replays exactly the
        # requested models' sessions' pending draws: never a newer
        # session's (would consume + cache them out of order), and still
        # correct for an older model after other models were recorded.
        for tok in tokens.values():
            for n in tok.rng_nodes:
                if not n.materialized:
                    add_stack(n)
    for n in sorted(nodes, key=lambda n: n.op_nr):
        replay_node(n, target)


def materialize(
    fake: FakeTensor,
    target: Optional[ReplayTarget] = None,
    *,
    retain_context: bool = False,
) -> torch.Tensor:
    """detail::materialize equivalent (deferred_init.cc:707-732)."""
    ctx = get_fake_context(fake, CONTEXT_KEY)
    if ctx is None:
        if getattr(fake, "_tdx_materialized", False):
            raise ValueError("The tensor has already been materialized.")
        raise ValueError(
            "The tensor was constructed outside of a deferred-init context "
            "and cannot be materialized."
        )
    target = target or ReplayTarget()
    materialize_graph(ctx.node, target)
    real = node_output(ctx.node, ctx.output_index)
    # requires_grad_() is untrackable; re-apply on leaves post-replay
    # (deferred_init.cc:720-724).
    if isinstance(real, torch.Tensor) and fake.requires_grad and real.is_leaf:
        real = real.detach()
        real.requires_grad_(True)
    if not retain_context:
        del_fake_context(fake, CONTEXT_KEY)
        fake._tdx_materialized = True
    return real
