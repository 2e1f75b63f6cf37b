"""Deferred module initialization.

The port's own copy of ``torchdistx_tpu/deferred_init.py`` (the JAX
package's torch frontend), call-compatible with the reference
torchdistx's ``deferred_init.py``:

* :func:`deferred_init` — construct a module with fake tensors while
  recording every operation;
* :func:`materialize_tensor` — replay the recording for one tensor, a
  no-op passthrough for non-fake tensors;
* :func:`materialize_module` — depth-first in-place materialization of a
  whole module with ``buffers_only`` / ``check_fn`` partial-init hooks.
  Here it replays straight onto ``device`` (the GPU unless the caller
  asks for the CPU), so parameters are created in device memory and
  never pass through the host.

The interception point is a ``TorchDispatchMode`` layered on the fake
handler, which sees every op before it executes.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Iterator, Optional

import torch
from torch.nn import Module, Parameter
from torch.utils._python_dispatch import TorchDispatchMode

from . import _graph
from ._device import resolve_device
from ._graph import ReplayTarget, record_op
from .fake import ModeToggle, _fake_handler, _iter_tensors, _tree_map, is_fake, is_param_like

__all__ = [
    "deferred_init",
    "materialize_tensor",
    "materialize_module",
    "enable_deferred_init",
    "no_deferred_init",
    "ReplayTarget",
]

_tls = threading.local()

# Terminal ops force early materialization of their fake arguments so
# value-dependent control flow in module constructors works
# (deferred_init.cc:792-797, 834-848; the reference keys on "aten::item",
# which at Python dispatch level appears as _local_scalar_dense).
_TERMINAL_OPS = {
    "aten::item",
    "aten::_local_scalar_dense",
    "aten::equal",
    "aten::is_nonzero",
}


def _is_terminal(func) -> bool:
    try:
        return func._schema.name in _TERMINAL_OPS or str(func) in _TERMINAL_OPS
    except AttributeError:
        return False


class DeferredInitMode(TorchDispatchMode):
    """Counterpart of DeferredInitHandler (deferred_init.cc:735-906).

    For every op: preserve the argument stack, redispatch through the fake
    handler (which routes to the meta backend), and record the op into the
    replay graph if any argument or output was fake.
    """

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}

        if getattr(_tls, "suspended", False):
            # no_deferred_init() guard: behave as if the mode were not
            # installed — run the op for real (the mode is popped during
            # its own dispatch, so this does not recurse).  Ops on fake
            # args still route through the subclass fake dispatch, just
            # unrecorded — the reference's key-exclusion semantics.
            # A real RNG draw here consumes the global generator NOW, so
            # pending recorded draws must replay first to keep the stream
            # aligned with eager execution order.
            if _graph._is_rng_op(func):
                _graph.flush_pending_rng()
            return func(*args, **kwargs)

        if _is_terminal(func) and any(is_fake(t) for t in _iter_tensors((args, kwargs))):
            # Early replay: materialize fake args (retaining their context
            # so later ops can still extend the recording) and run for
            # real.  All pending RNG draws replay first, in recorded
            # order, so the generator stream stays aligned with eager
            # (_graph.flush_pending_rng).
            _graph.flush_pending_rng()

            def mat(t):
                if is_fake(t):
                    return _graph.materialize(t, retain_context=True)
                return t

            rargs = _tree_map(mat, args)
            rkwargs = _tree_map(mat, kwargs)
            return func(*rargs, **rkwargs)

        out = _fake_handler(func, args, kwargs)

        involved_fake = any(is_fake(t) for t in _iter_tensors((args, kwargs))) or any(
            is_fake(t) for t in _iter_tensors(out)
        )
        if involved_fake:
            record_op(func, args, kwargs, out)
        return out


# Top-level enable starts a fresh recording session, which tracks its own
# RNG draws and numbers its ops for RNG keys (see
# _graph.begin_recording_session).
_deferred_toggle = ModeToggle(
    DeferredInitMode,
    "Deferred-init mode",
    on_first_enable=_graph.begin_recording_session,
    on_last_disable=_graph.end_recording_session,
)


def enable_deferred_init(enabled: bool) -> None:
    """Re-entrant toggle (enableDeferredInit, deferred_init.cc:1140-1160)."""
    _deferred_toggle.set(enabled)


@contextlib.contextmanager
def no_deferred_init() -> Iterator[None]:
    """Run the body with deferred-init recording suspended — the public
    counterpart of the reference's ``NoDeferredInit`` guard
    (deferred_init.h:35-43, used for self-exclusion at deferred_init.cc:774).

    Inside the guard, factory calls allocate *real* tensors (useful for
    lookup tables or constants a module constructor genuinely needs at
    build time).  Ops on existing fake arguments still produce fakes —
    the per-tensor fake dispatch stays active, as with the reference's
    key-exclusion — they are just not recorded.  The recording session
    (and its RNG key numbering) resumes untouched when the guard exits.

    Implemented as a thread-local suspension flag the mode checks, NOT by
    popping dispatch modes: torch's mode stack pops strictly LIFO with no
    identity check, so stack surgery would corrupt any unrelated
    TorchDispatchMode active above the deferred mode.
    """
    prev = getattr(_tls, "suspended", False)
    _tls.suspended = True
    try:
        yield
    finally:
        _tls.suspended = prev


@contextlib.contextmanager
def _deferred(enabled: bool = True) -> Iterator[None]:
    if not enabled:
        yield
        return
    # The with-block ordering keeps the GC restore exception-safe: even
    # an enable_deferred_init failure unwinds through gc_paused.
    with _graph.gc_paused():
        enable_deferred_init(True)
        try:
            yield
        finally:
            enable_deferred_init(False)


def deferred_init(module_fn: Callable[..., Any], *args: Any, **kwargs: Any):
    """Defer the initialization of a :class:`Module` (or any tensor-
    producing callable).

    The callable runs with fake tensors: no storage is allocated, every
    operation is recorded into a replay graph, and the result can later be
    materialized tensor-by-tensor (:func:`materialize_tensor`) or module-by-
    module (:func:`materialize_module`).

    Reference: deferred_init.py:17-36.
    """
    with _deferred():
        try:
            return module_fn(*args, **kwargs)
        except RuntimeError as e:
            if _raised_constructing_uninitialized_param(e):
                raise RuntimeError(
                    "deferred_init cannot fake lazy modules (LazyLinear, "
                    "LazyConv*, ...): their UninitializedParameter wraps a "
                    "placeholder tensor via Tensor._make_subclass, and the "
                    "real parameters only exist after the first forward "
                    "pass. Construct lazy modules eagerly outside "
                    "deferred_init (run a dummy forward to bind their "
                    "shapes first)."
                ) from e
            raise


def _raised_constructing_uninitialized_param(e: BaseException) -> bool:
    """Whether the exception was raised inside UninitializedParameter /
    UninitializedBuffer construction (checked via the traceback frames —
    following ``__cause__``/``__context__`` chains, since wrapping layers
    re-raise — not error-text matching, so unrelated _make_subclass
    failures keep their own message)."""
    from torch.nn.parameter import UninitializedTensorMixin

    seen = set()
    exc: Optional[BaseException] = e
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        tb = exc.__traceback__
        while tb is not None:
            cls = tb.tb_frame.f_locals.get("cls")
            if isinstance(cls, type) and issubclass(cls, UninitializedTensorMixin):
                return True
            tb = tb.tb_next
        exc = exc.__cause__ or exc.__context__
    return False


def materialize_tensor(
    tensor: torch.Tensor,
    *,
    target: Optional[ReplayTarget] = None,
    retain_context: bool = False,
) -> torch.Tensor:
    """Materialize ``tensor``; a no-op passthrough for non-fake tensors
    (reference deferred_init.py:39-46, deferred_init.cc:1162-1168)."""
    if not is_fake(tensor):
        return tensor
    real = _graph.materialize(tensor, target, retain_context=retain_context)
    # Preserve the Python class: Parameter in, Parameter out (the
    # reference's pybind layer rebuilds the original Python type,
    # _C/deferred_init.cc:31-86).
    if is_param_like(tensor):
        real = Parameter(real, requires_grad=tensor.requires_grad)
    return real


def materialize_module(
    module: Module,
    *,
    buffers_only: bool = False,
    check_fn: Optional[Callable[[Module], bool]] = None,
    target: Optional[ReplayTarget] = None,
    device="cuda",
    replay_dead_rng: Optional[bool] = None,
    _memo: Optional[dict] = None,
) -> Module:
    """Materialize ``module`` and its descendants in place, on ``device``.

    Replay rewrites the devices the fakes claimed to ``device``: the GPU
    by default; ``device="cpu"`` must be asked for.  A custom ``target``
    replaces the default :class:`ReplayTarget` (and ``device`` with it).

    ``check_fn`` gates entire submodules (the partial/sharded-init hook
    FSDP-style wrappers use); ``buffers_only`` skips parameters.  Mirrors
    reference deferred_init.py:49-87, including the depth-first recursion
    order and the in-place replacement inside ``_parameters`` /
    ``_buffers``.  Improvement over the reference: a fake shared between
    several modules (weight tying, e.g. GPT-2's ``lm_head``/``wte``)
    materializes once, to a single shared real tensor — the reference
    raises "already materialized" on the second occurrence.

    ``replay_dead_rng`` controls whether the sessions' *dead* RNG draws
    (inits overwritten by weight tying) replay too, keeping the
    generator stream bitwise-eager (see ``_graph.materialize_many``).
    Default: on for ungated whole-module calls, off for gated/partial
    ones; per-shard callers that materialize submodule-by-submodule
    (e.g. FSDP ``param_init_fn``) must pass ``False`` — each call would
    otherwise replay the whole session's dead draws out of order.
    """
    if _memo is None:
        # Outermost call: pre-replay the union call stack in global
        # chronological order so RNG consumption matches eager
        # construction bitwise (_graph.materialize_many), then recurse
        # with the shared memo — all under one GC pause (replay allocates
        # like recording does; see _graph.gc_paused).
        if target is None:
            target = ReplayTarget(resolve_device(device))
        with _graph.gc_paused():
            fakes = []

            def collect(mod):
                if check_fn is not None and not check_fn(mod):
                    return
                for child in mod.children():
                    collect(child)
                if not buffers_only:
                    fakes.extend(
                        t for t in mod._parameters.values()
                        if t is not None and is_fake(t)
                    )
                fakes.extend(
                    t for t in mod._buffers.values()
                    if t is not None and is_fake(t)
                )

            collect(module)
            if replay_dead_rng is None:
                replay_dead_rng = check_fn is None and not buffers_only
            _graph.materialize_many(
                fakes, target, include_session_rng=replay_dead_rng
            )
            return materialize_module(
                module, buffers_only=buffers_only, check_fn=check_fn,
                target=target, replay_dead_rng=replay_dead_rng, _memo={},
            )
    if check_fn is not None and not check_fn(module):
        return module

    for child in module.children():
        materialize_module(
            child, buffers_only=buffers_only, check_fn=check_fn, target=target,
            _memo=_memo,
        )

    def swap(d):
        for key in list(d.keys()):
            t = d[key]
            if t is None or not is_fake(t):
                continue
            if id(t) in _memo:
                d[key] = _memo[id(t)]
                continue
            try:
                real = materialize_tensor(t, target=target)
            except ValueError as e:
                raise ValueError(f"`{key}` cannot be materialized: {e}") from e
            _memo[id(t)] = real
            d[key] = real

    if not buffers_only:
        swap(module._parameters)
    swap(module._buffers)
    return module
