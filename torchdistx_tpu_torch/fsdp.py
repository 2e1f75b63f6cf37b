"""FSDP integration: sharded initialization the way the reference
torchdistx is used (counterpart of ``torchdistx_tpu/fsdp.py``).

torch's FSDP ships native torchdistX support —
``torch.distributed.fsdp._init_utils`` detects fake parameters via
``torchdistx.fake.is_fake`` and materializes units through
``torchdistx.deferred_init.materialize_module(…, check_fn=…)``.  This
module makes that machinery work against the port:

* :func:`install_torchdistx_shim` — register the port under the
  ``torchdistx`` module name (``torchdistx.fake`` /
  ``torchdistx.deferred_init``), the drop-in switch for every consumer of
  the reference, torch FSDP included.  Call it **before** importing
  ``torch.distributed.fsdp`` (FSDP snapshots availability at import).
* :func:`param_init_fn` / :func:`make_param_init_fn` — the explicit
  ``FSDP(…, param_init_fn=…)`` route; FSDP calls it once per module to
  materialize, shared/tied fakes materialize once.

The JAX package's ``make_xla_param_init_fn`` (torch-xla devices) has no
counterpart here.  For keyed materialization straight into sharded
device memory see :func:`.cuda_bridge.materialize_module_cuda`.
"""

from __future__ import annotations

import importlib
import importlib.machinery
import importlib.util
import sys
import types
from typing import Callable, Optional

import torch

from . import fake as _fake_mod
from ._graph import ReplayTarget
from .deferred_init import materialize_module

# The module, not the function the package re-exports under its name.
_deferred_init_mod = importlib.import_module(".deferred_init", __package__)

__all__ = [
    "install_torchdistx_shim",
    "param_init_fn",
    "make_param_init_fn",
]


def install_torchdistx_shim(*, force: bool = False) -> None:
    """Expose the port as importable ``torchdistx``.

    After this, ``from torchdistx import deferred_init, fake`` resolves to
    the port's call-compatible modules — which is exactly the import
    torch FSDP's deferred-init support performs.  No-op if a real
    ``torchdistx`` is already importable (unless ``force``).
    """
    if not force:
        try:
            if importlib.util.find_spec("torchdistx") is not None:
                return  # a real torchdistx is importable; don't shadow it
        except (ImportError, ValueError):
            pass
    shim = types.ModuleType("torchdistx")
    shim.__doc__ = "torchdistx compatibility shim provided by torchdistx_tpu_torch."
    # A real spec: import machinery (importlib.util.find_spec, used e.g. by
    # transformers' lazy imports) rejects modules whose __spec__ is None.
    shim.__spec__ = importlib.machinery.ModuleSpec("torchdistx", loader=None)
    shim.__path__ = []  # mark as package so find_spec of submodules works
    shim.fake = _fake_mod
    shim.deferred_init = _deferred_init_mod
    sys.modules["torchdistx"] = shim
    sys.modules["torchdistx.fake"] = _fake_mod
    sys.modules["torchdistx.deferred_init"] = _deferred_init_mod


def make_param_init_fn(
    *,
    check_fn: Optional[Callable[[torch.nn.Module], bool]] = None,
    target: Optional[ReplayTarget] = None,
) -> Callable[[torch.nn.Module], None]:
    """Build a ``param_init_fn`` for ``FSDP(…, param_init_fn=…)``.

    FSDP invokes it per module-to-materialize; fakes already swapped by an
    earlier call are skipped, so nested wrapping cannot double-replay.
    ``target`` retargets replay (e.g. ``ReplayTarget("cpu")``; the GPU by
    default); ``check_fn`` gates submodules exactly like
    :func:`.deferred_init.materialize_module`.
    """

    def _init(module: torch.nn.Module) -> None:
        # Per-shard path: FSDP calls this submodule-by-submodule, so
        # session-wide dead-RNG replay (whole-module parity machinery)
        # must stay off — each unit replays only its slice of work.
        materialize_module(
            module, check_fn=check_fn, target=target, replay_dead_rng=False
        )

    return _init


# The common case, usable directly as FSDP(…, param_init_fn=param_init_fn).
param_init_fn = make_param_init_fn()
