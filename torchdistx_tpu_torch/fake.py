"""Fake tensors: tensors that claim a device but hold no storage.

The port's own copy of ``torchdistx_tpu/fake.py`` (the JAX package's
torch frontend), kept in this package so the port imports nothing of the
JAX package.  The one deliberate difference: the JAX package renames
torch's ``privateuse1`` backend to ``tpu`` so its fakes can claim TPU
devices; this copy does not (a second rename would clash with the JAX
package's when both are imported in one process).  Its fakes claim
``cuda`` or ``cpu``, and claim ``cuda`` with no CUDA runtime, as the JAX
package's claim ``tpu`` with no TPU: a login host with no GPU (a
CPU-only torch, or a CUDA build that sees no device) records a model
for the card.  Torch's argument parser initializes a device type's
runtime before any dispatch mode sees a factory call that names it;
while fake mode or deferred init is on and no CUDA device exists, the
CUDA runtime's lazy init is a no-op (see :func:`_claims_begin`).

The design, as in the reference torchdistx (``fake.cc``):

* a fake tensor holds a **meta** tensor used for dispatch but *claims* a
  real device;
* every op on a fake tensor is redirected to the **meta backend** for
  shape/dtype inference with no allocation;
* factory calls under ``fake_mode()`` produce fakes even with no tensor
  arguments;
* in-place ops on the held meta tensor are routed back to the owning fake
  via a meta→fake back-pointer, so the *same* fake is refreshed rather
  than a new one allocated;
* each fake carries a per-key opaque **context map**, which the
  deferred-init layer uses to hang its graph node off every fake tensor.

Interposition is a ``torch.Tensor._make_wrapper_subclass`` wrapper
(``FakeTensor``) plus a ``TorchDispatchMode`` (``FakeMode``).
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "FakeTensor",
    "fake_mode",
    "is_fake",
    "meta_tensor",
    "set_fake_context",
    "get_fake_context",
    "has_fake_context",
    "del_fake_context",
]

_tls = threading.local()

def _attr_name_of_meta_owner() -> str:
    return "_tdx_fake_owner"


class FakeTensor(torch.Tensor):
    """A tensor that claims a real device but allocates no storage.

    Counterpart of ``FakeTensorImpl`` (fake.cc:120-347): ``_meta`` is the
    held meta tensor actually used for dispatch, the wrapper reports the
    claimed ``device`` and has no accessible storage.
    """

    _meta: torch.Tensor
    _fake_device: torch.device
    _fake_contexts: dict

    @staticmethod
    def __new__(cls, meta: torch.Tensor, device: torch.device, requires_grad: bool = False):
        assert meta.device.type == "meta", "FakeTensor must wrap a meta tensor"
        r = torch.Tensor._make_wrapper_subclass(  # type: ignore[attr-defined]
            cls,
            meta.size(),
            strides=meta.stride(),
            storage_offset=meta.storage_offset(),
            dtype=meta.dtype,
            layout=meta.layout,
            device=device,
            requires_grad=requires_grad,
        )
        return r

    def __init__(self, meta=None, device=None, requires_grad: bool = False):
        super().__init__()
        if hasattr(self, "_meta"):
            # Re-init of a complete fake, REGARDLESS of the args: the
            # legacy ctor ``torch.Tensor(n)`` (HF wav2vec2's
            # masked_spec_embed does this) builds its storage through a
            # dispatched ``empty`` that already returned a fully-formed
            # fake out of ``Tensor.__new__`` — Python's type protocol
            # then re-invokes ``__init__(fake, <ctor args>)``.  Ignore
            # it; overwriting state here would drop the recorded
            # context.  (The reference handles the same entry by
            # detecting internal_new_from_data, deferred_init.cc:776-785.)
            return
        if not (isinstance(meta, torch.Tensor) and meta.device.type == "meta"):
            raise TypeError(
                "FakeTensor(meta, device): `meta` must be a meta tensor"
            )
        self._meta = meta
        self._fake_device = torch.device(device)
        self._fake_contexts = {}
        # Meta -> fake back-pointer (fake.cc:330-339 ``setMeta``).  Weakref
        # so a dead fake does not keep itself alive through its meta.
        setattr(meta, _attr_name_of_meta_owner(), weakref.ref(self))

    # -- introspection ---------------------------------------------------

    def __repr__(self) -> str:  # fake.py:15-40 repr patch equivalent
        with no_fake_dispatch():
            return (
                f"tensor(..., size={tuple(self.shape)}, dtype={self.dtype}, "
                f"device='{self._fake_device}', fake=True)"
            )

    def _early_value(self, what: str) -> torch.Tensor:
        """Value-dependent reads on a *recorded* fake materialize it early
        (the terminal-op protocol, deferred_init.cc:792-797) — torch's own
        init helpers branch on tensor predicates (`if not mask.any()` in
        nn.init.trunc_normal_).  A bare fake-mode fake still raises.

        Replay must run on real tensors, so the recording/fake modes are
        popped (inside __torch_dispatch__ that happens automatically;
        these are plain-Python entry points), and pending RNG draws
        replay first in recorded order (flush_pending_rng)."""
        from . import _graph

        if get_fake_context(self, _graph.CONTEXT_KEY) is None:
            raise RuntimeError(
                f"{what} of a fake tensor cannot be read: fake tensors "
                f"have no storage. Materialize it first."
            )
        with torch.utils._python_dispatch._disable_current_modes():
            _graph.flush_pending_rng()
            return _graph.materialize(self, retain_context=True)

    def __bool__(self):
        return bool(self._early_value("The truth value"))

    def item(self):
        return self._early_value("The value").item()

    def tolist(self):
        # The reference documents tolist()/numpy() as unsupported failure
        # patterns (docs/src/deferred_init.rst:204-207); the early-replay
        # hatch covers them here.  Snapshot semantics: the result holds
        # the value at call time (eager `numpy()` would alias storage).
        return self._early_value("The value").tolist()

    def numpy(self, *, force: bool = False):
        return self._early_value("The value").numpy(force=force).copy()

    def __float__(self):
        return float(self._early_value("The value"))

    def __int__(self):
        return int(self._early_value("The value"))

    def __deepcopy__(self, memo):
        # copy.deepcopy of a fake (nn.Transformer deepcopies its layer
        # stack at construction) must NOT walk __dict__: the deferred-init
        # context chain reaches the whole replay graph and the ctypes
        # native-engine handle.  Eager deepcopy semantics are a recorded
        # detach+clone — a new fake computing the same value, sharing the
        # recording.
        if id(self) in memo:
            return memo[id(self)]
        from . import _graph

        src_ctx = get_fake_context(self, _graph.CONTEXT_KEY)
        # Eager torch deepcopy copies the underlying STORAGE once per
        # memo, so views inside the copied structure keep sharing it.
        # Mirror that with recorded ops: clone a full-extent alias of the
        # storage (once, memoized by storage), then re-view.
        meta = self._meta
        skey = ("tdx_fake_storage", meta.untyped_storage()._cdata, self.dtype)
        full_copy = memo.get(skey)
        if full_copy is None:
            n = meta.untyped_storage().nbytes() // meta.element_size()
            full_copy = self.detach().as_strided((n,), (1,), 0).clone()
            memo[skey] = full_copy
        # Geometry from the META, not the wrapper: after `p.data = w` the
        # wrapper's construction-time storage_offset is stale (the meta
        # swapped to w's storage, where the view starts at w's offset).
        out = full_copy.as_strided(
            tuple(meta.shape), tuple(meta.stride()), meta.storage_offset()
        )
        if src_ctx is not None and get_fake_context(out, _graph.CONTEXT_KEY) is None:
            # Outside the recording region the clone cannot be recorded —
            # fail HERE with the real cause instead of handing back a copy
            # that only breaks later at materialize time.
            raise RuntimeError(
                "Cannot deepcopy a recorded fake tensor outside its "
                "deferred-init region: the copy would be unmaterializable. "
                "Materialize the module first, or deepcopy inside the "
                "region (under deferred_init / enable_deferred_init)."
            )
        if self.requires_grad:
            out.requires_grad_(True)
        if is_param_like(self):
            out = torch.nn.Parameter(out, requires_grad=self.requires_grad)
        memo[id(self)] = out
        return out

    # -- dispatch --------------------------------------------------------

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        # Ops on fake tensors outside fake_mode() still flow through the
        # fake handler: in the reference the Fake dispatch key lives in the
        # tensor's key set, not only in TLS (fake.cc:186-205).
        return _fake_handler(func, args, kwargs or {})

    # -- .data interception ----------------------------------------------
    # ``Tensor.data`` reads/writes bypass the dispatcher (they are C-level
    # variable_data/set_data calls), which is why the reference swaps in a
    # recording VariableHooks proxy (deferred_init.cc:908-1135).  A wrapper
    # subclass has a cheaper route: a Python property shadows the C getset
    # for fake tensors only, rerouting reads through a normal recorded
    # detach and writes through :func:`_set_data`.

    @property
    def data(self):
        return self.detach()

    @data.setter
    def data(self, new):
        _set_data(self, new)


def is_fake(tensor: torch.Tensor) -> bool:
    """``True`` if ``tensor`` is fake (reference fake.py:53-55, fake.cc:621-627)."""
    return isinstance(tensor, FakeTensor)


def is_param_like(tensor: torch.Tensor) -> bool:
    """Parameter-ness of a (possibly fake) tensor: a real ``nn.Parameter``
    or a fake carrying the ``_is_param`` mark (set when ``nn.Parameter``
    construction is intercepted, and by serialize's manifest).  The single
    predicate shared by deepcopy, materialization, and deserialization."""
    return isinstance(tensor, torch.nn.Parameter) or bool(
        getattr(tensor, "_is_param", False)
    )


# Installed by _graph at import time: records `fake.data = x` as a
# synthetic replay op when the fake participates in a deferred-init
# recording (reference records "VariableHooks::set_data",
# deferred_init.cc:930-971).  The swap itself happens here either way.
_set_data_recorder: Optional[Any] = None


def _effective_strides(t: torch.Tensor) -> tuple:
    """Strides restricted to dims of size > 1 — the layout-relevant ones
    (size-1 dims carry arbitrary strides; torch's own contiguity checks
    skip them)."""
    return tuple(s for s, n in zip(t.stride(), t.shape) if n > 1)


_C_TENSOR_BASE = getattr(torch._C, "TensorBase", None) or torch._C._TensorBase


def _swap_wrapper_impl(fake: FakeTensor, meta: torch.Tensor) -> None:
    """Point ``fake`` (the SAME Python object) at a fresh storageless impl
    carrying ``meta``'s current geometry/dtype.

    The reference refreshes its C++ impl in place (shallowCopyFromMeta,
    fake.cc:207-230); a ``_make_wrapper_subclass`` wrapper's metadata is
    frozen at construction, but torch's C-level ``set_data`` — the same
    entry ``.data =`` uses on real tensors — swaps the variable's impl
    under the unchanged Python object: ``__dict__`` (the fake-context
    registry, ``_is_param``), autograd identity, and every outstanding
    reference stay intact while shape/strides/dtype update.
    """
    shell = FakeTensor(meta, fake._fake_device)
    _C_TENSOR_BASE.data.__set__(fake, shell)
    # shell.__init__ claimed the meta's back-pointer; re-point it at the
    # surviving wrapper (the shell dies here).
    fake._meta = meta
    setattr(meta, _attr_name_of_meta_owner(), weakref.ref(fake))


def _set_data(fake: FakeTensor, new: torch.Tensor) -> None:
    """``fake.data = new``: rebind the fake's meta to (a storage-sharing
    view of) ``new``'s metadata, preserving the wrapper object.

    torch's set_data allows ANY metadata change (reference records it
    with a hand-written replay closure, deferred_init.cc:930-971); a
    shape/dtype/layout-changing assignment swaps the wrapper's impl via
    :func:`_swap_wrapper_impl` so the same Python object reports the new
    metadata, exactly like eager ``.data =``.
    """
    if is_fake(new):
        new_meta = new._meta.detach()  # shares storage: p.data = w aliases w
    else:
        # empty_like contiguizes non-dense inputs, which would misreport
        # a genuinely layout-differing assignment as geometry-preserving;
        # preserve the real tensor's strides exactly.
        new_meta = torch.empty_strided(
            new.shape, new.stride(), dtype=new.dtype, device="meta"
        )
    if (
        new_meta.shape != fake._meta.shape
        or new_meta.dtype != fake._meta.dtype
        or _effective_strides(new_meta) != _effective_strides(fake._meta)
    ):
        # Metadata-changing assignment: swap the impl (the wrapper's
        # construction-time geometry would otherwise go stale and
        # composite-op decompositions would consult wrong contiguity).
        _swap_wrapper_impl(fake, new_meta)
    else:
        fake._meta = new_meta
        setattr(new_meta, _attr_name_of_meta_owner(), weakref.ref(fake))
    if _set_data_recorder is not None:
        _set_data_recorder(fake, new)


def meta_tensor(tensor: torch.Tensor) -> torch.Tensor:
    """The meta tensor backing a fake (reference ``getFakeMetaStorage``, fake.h:47)."""
    if not is_fake(tensor):
        raise ValueError("`tensor` is not fake.")
    return tensor._meta


# ---------------------------------------------------------------------------
# Per-fake opaque context registry (fake.cc:175, 655-688).
# ---------------------------------------------------------------------------


def set_fake_context(tensor: torch.Tensor, key: str, value: Any) -> None:
    if not is_fake(tensor):
        raise ValueError("`tensor` is not fake.")
    tensor._fake_contexts[key] = value


def get_fake_context(tensor: torch.Tensor, key: str) -> Optional[Any]:
    if not is_fake(tensor):
        raise ValueError("`tensor` is not fake.")
    return tensor._fake_contexts.get(key)


def has_fake_context(tensor: torch.Tensor, key: str) -> bool:
    return is_fake(tensor) and key in tensor._fake_contexts


def del_fake_context(tensor: torch.Tensor, key: str) -> None:
    if is_fake(tensor):
        tensor._fake_contexts.pop(key, None)


# ---------------------------------------------------------------------------
# The fake handler — counterpart of FakeHandler (fake.cc:349-612).
# ---------------------------------------------------------------------------

def _skip_level() -> int:
    return getattr(_tls, "skip_dispatch", 0)


@contextlib.contextmanager
def no_fake_dispatch() -> Iterator[None]:
    """Run ops on the underlying meta tensors without fake interposition.

    Counterpart of the handler's ``ExcludeDispatchKeyGuard`` self-exclusion
    (fake.cc:407) — thread-local, like the reference's TLS guard.
    """
    _tls.skip_dispatch = _skip_level() + 1
    try:
        yield
    finally:
        _tls.skip_dispatch = _skip_level() - 1


def _tree_map(fn, obj):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        mapped = [_tree_map(fn, x) for x in obj]
        return type(obj)(mapped) if not isinstance(obj, tuple) else tuple(mapped)
    if isinstance(obj, dict):
        return {k: _tree_map(fn, v) for k, v in obj.items()}
    return obj


def _iter_tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _iter_tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _iter_tensors(x)


def _infer_fake_device(args, kwargs) -> Optional[torch.device]:
    """Common claimed device of fake args; errors on mixed fake devices.

    Counterpart of the handler's device inference (fake.cc:402-456): CPU
    scalar tensors are ignored, mixed devices among fakes are an error.
    """
    device: Optional[torch.device] = None
    for t in _iter_tensors((args, kwargs)):
        if is_fake(t):
            d = t._fake_device
            if device is None:
                device = d
            elif device != d:
                raise RuntimeError(
                    f"Expected all fake tensors to be on the same device, "
                    f"but found at least two devices, {device} and {d}!"
                )
    return device


def _explicit_device(func, args, kwargs) -> Optional[torch.device]:
    """Locate a ``device=`` argument.

    The reference uses a schema heuristic (BackendSelect kernel or a
    TensorOptions-shaped parameter run, fake.cc:458-502); with Python
    schemas available we can simply look the argument up by name.
    """
    dev = kwargs.get("device")
    if dev is not None:
        return torch.device(dev)
    try:
        schema_args = func._schema.arguments
    except AttributeError:
        return None
    for i, a in enumerate(schema_args):
        if a.name == "device" and i < len(args) and args[i] is not None:
            return torch.device(args[i])
    return None


def _wrap_output(out, device: torch.device):
    """Wrap a meta output as fake; refresh existing fakes for in-place ops.

    Counterpart of ``convertMetaOutputsToFakeTensors`` (fake.cc:573-596): if
    the meta output already belongs to a fake (via the back-pointer), that
    fake's metadata is refreshed in place and the same fake is returned.
    """
    if not isinstance(out, torch.Tensor):
        return out
    if is_fake(out):  # already wrapped (e.g. returned arg)
        return out
    if out.device.type != "meta":
        return out
    owner_ref = getattr(out, _attr_name_of_meta_owner(), None)
    if owner_ref is not None:
        owner = owner_ref()
        if owner is not None:
            # In-place op mutated the held meta: a geometry-preserving
            # mutation is a no-op refresh; a geometry-CHANGING one raises
            # (after rolling the meta back) — wrapper metadata is frozen
            # at construction, see _refresh_fake.
            return _refresh_fake(owner, out)
    return FakeTensor(out, device)


def _refresh_fake(owner: FakeTensor, meta: torch.Tensor) -> FakeTensor:
    """shallowCopyFromMeta equivalent (fake.cc:207-230).

    An in-place op mutated the held meta.  Geometry-preserving mutations
    (the overwhelmingly common init case) are a no-op refresh; a
    geometry-CHANGING one (``resize_``/``t_``/``squeeze_``-style)
    re-wraps — the wrapper's impl is swapped so the SAME Python object
    (and every other live reference to it) reports the meta's new
    geometry, matching the reference's in-place impl refresh
    (fake.cc:581-596).  The ``.data`` path shares the swap.
    """
    # Wrapper geometry (frozen at construction) vs the meta's current;
    # size-1-dim strides are layout-irrelevant noise (_effective_strides).
    if owner.shape == meta.shape and _effective_strides(owner) == _effective_strides(meta):
        return owner
    _swap_wrapper_impl(owner, meta)
    return owner


def _fake_handler(func, args, kwargs, *, force_fake: bool = False):
    """The catch-all fake handler (FakeHandler::run, fake.cc:406-424).

    Steps mirror the reference: infer device, locate ``device=`` arg, swap
    fakes for their metas, decide ``shouldFakeOp``, redispatch to the meta
    backend, wrap meta outputs as fakes.
    """
    if _skip_level():
        with no_fake_dispatch():
            return func(*args, **kwargs)

    fake_device = _infer_fake_device(args, kwargs)
    explicit = _explicit_device(func, args, kwargs)
    has_tensor_args = any(True for _ in _iter_tensors((args, kwargs)))

    # shouldFakeOp (fake.cc:538-540): a fake arg, a device arg, or a pure
    # factory (no tensor args) makes the op fake.
    should_fake = force_fake or fake_device is not None or explicit is not None or not has_tensor_args
    if not should_fake:
        with no_fake_dispatch():
            return func(*args, **kwargs)

    # Output device: explicit device arg > first fake arg device > cpu
    # (fake.cc:504-520).
    out_device = explicit or fake_device or torch.device("cpu")
    if out_device.type == "meta":
        # Asking for meta explicitly: no faking needed, run as-is.
        with no_fake_dispatch():
            return func(*_tree_map(lambda t: t._meta if is_fake(t) else t, args),
                        **_tree_map(lambda t: t._meta if is_fake(t) else t, kwargs))

    # Swap fake args for their meta tensors (fake.cc:522-536).  Real tensor
    # args are converted to meta *for shape inference only* — the recording
    # layer keeps the original real tensor in the preserved stack, so its
    # value is used at replay (the reference redispatches with the real
    # tensor in place, relying on meta kernels tolerating mixed devices;
    # converting is the portable equivalent).
    def _to_meta(t: torch.Tensor) -> torch.Tensor:
        if is_fake(t):
            return t._meta
        if t.device.type == "meta":
            return t
        return t.to("meta")

    margs = _tree_map(_to_meta, args)
    mkwargs = _tree_map(_to_meta, kwargs)

    # Rewrite the device argument to meta (fake.cc:542-550).
    if explicit is not None:
        if "device" in mkwargs and mkwargs["device"] is not None:
            mkwargs = dict(mkwargs)
            mkwargs["device"] = torch.device("meta")
        else:
            try:
                schema_args = func._schema.arguments
            except AttributeError:
                schema_args = []
            margs = list(margs)
            for i, a in enumerate(schema_args):
                if a.name == "device" and i < len(margs) and margs[i] is not None:
                    margs[i] = torch.device("meta")
            margs = tuple(margs)
    elif not has_tensor_args:
        mkwargs = dict(mkwargs)
        mkwargs["device"] = torch.device("meta")

    # Redispatch to the meta backend (fake.cc:552-565).  Missing meta
    # kernels surface as the same actionable error class as the reference.
    try:
        with no_fake_dispatch():
            out = func(*margs, **mkwargs)
    except NotImplementedError as e:
        raise NotImplementedError(
            f"`{func}` has no meta kernel; the fake handler cannot infer "
            f"its output metadata. See the reference's guidance on meta "
            f"kernel coverage (docs/src/deferred_init.rst:176-207)."
        ) from e

    return _tree_map(lambda t: _wrap_output(t, out_device), out)


class FakeMode(TorchDispatchMode):
    """Dispatch-mode counterpart of the TLS-included Fake key (fake.cc:629-645)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return _fake_handler(func, args, kwargs or {})


# -- claiming cuda with no CUDA device ------------------------------------

_real_cuda_lazy_init = None


def _cuda_lazy_init_or_claim():
    """Stands in for ``torch.cuda._lazy_init`` once a claim region ran on
    a host with no CUDA device: inside a region on this thread it does
    nothing (a factory call that names ``cuda`` makes a fake there, which
    needs no runtime), elsewhere it is the real init."""
    if getattr(_tls, "claim_depth", 0) > 0 and not torch.cuda.is_available():
        return None
    return _real_cuda_lazy_init()


def _claims_begin() -> None:
    """Enter a claim region (fake mode or deferred init) on this thread.

    Only where no CUDA device exists is the lazy init replaced: torch
    remembers a successful init per device type, so a stand-in must
    never run where the real init has to happen.  On such a host, once
    a recording named ``cuda``, a later real CUDA call outside a region
    fails in dispatch instead of in the init (it fails either way)."""
    global _real_cuda_lazy_init
    _tls.claim_depth = getattr(_tls, "claim_depth", 0) + 1
    if _real_cuda_lazy_init is None and not torch.cuda.is_available():
        _real_cuda_lazy_init = torch.cuda._lazy_init
        torch.cuda._lazy_init = _cuda_lazy_init_or_claim


def _claims_end() -> None:
    _tls.claim_depth -= 1


class ModeToggle:
    """Re-entrant thread-local enable/disable of a dispatch mode.

    Shared by fake mode (``enableFakeMode``, fake.cc:635-645) and deferred
    init (``enableDeferredInit``, deferred_init.cc:1140-1160).
    """

    def __init__(self, mode_cls, name: str, on_first_enable=None, on_last_disable=None):
        self._mode_cls = mode_cls
        self._name = name
        self._on_first_enable = on_first_enable
        self._on_last_disable = on_last_disable
        self._tls = threading.local()

    def _stack(self):
        if not hasattr(self._tls, "stack"):
            self._tls.stack = []
        return self._tls.stack

    def set(self, enabled: bool) -> None:
        stack = self._stack()
        if enabled:
            if not stack and self._on_first_enable is not None:
                self._on_first_enable()
            mode = self._mode_cls()
            stack.append(mode)
            mode.__enter__()
            _claims_begin()
        else:
            if not stack:
                raise RuntimeError(f"{self._name} is not enabled.")
            stack.pop().__exit__(None, None, None)
            _claims_end()
            if not stack and self._on_last_disable is not None:
                self._on_last_disable()


_fake_toggle = ModeToggle(FakeMode, "Fake mode")


def enable_fake_mode(enabled: bool) -> None:
    """Re-entrant enable/disable, mirroring ``enableFakeMode`` (fake.cc:635-645)."""
    _fake_toggle.set(enabled)


@contextlib.contextmanager
def fake_mode() -> Iterator[None]:
    """Context manager in which all tensors are fake (reference fake.py:43-50).

    Example::

        with fake_mode():
            t = torch.ones(10, device="cuda")   # no storage allocated
    """
    enable_fake_mode(True)
    try:
        yield
    finally:
        enable_fake_mode(False)
