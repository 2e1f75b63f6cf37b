"""Deterministic fault injection (the port's own copy of
``torchdistx_tpu/chaos``).

Every failure mode the serving engine and the elastic loop claim to
survive can be *injected on demand* and proven survived, in CI, on the
CPU, deterministically.
Fault plans are keyed by site and step; see :mod:`.plan` for the grammar.

Activation, in precedence order:

1. programmatic: ``chaos.install(chaos.parse_plan("serve@4=raise"))``
   (or pass the text straight to :func:`install`);
2. config: ``TDX_FAULT_PLAN`` / ``config.override(fault_plan=...)``,
   parsed lazily and cached per plan text.

Injection points call :func:`maybe_inject`, a cheap no-op when no plan
is active: one lock, one attribute read and one config read per site.

===========  ==========================================================
``raise``    :class:`InjectedRuntimeError` mid-step: the device failure
             the serving engine survives by requeueing its lanes
``hang``     a step that does not return for ``arg`` seconds (default
             3600; :func:`set_cancel_event` cuts it)
``corrupt``  post-commit checkpoint damage (truncate or bit-flip) at
             ``save``/``restore`` and of the incoming checkpoint at
             ``rollover``; the in-flight chunk at ``reshard``; the
             registry's entries at ``registry``, the installed kernel
             libraries at ``cache``; at the compile sites
             ``NotImplementedError`` naming its ROADMAP item
``slow``     extra seconds at the site
``preempt``  SIGTERM to self: the announced preemption notice; at the
             ``fleet`` site :class:`ReplicaPreempted`, which kills only
             the replica thread (:func:`execute_replica_fault`)
``flap``     an INTERMITTENT, RECURRING ``raise`` on a duty-cycle
             fraction of its matches (never spent)
===========  ==========================================================
"""

from __future__ import annotations

import threading
from typing import List, Optional, Union

from .inject import (
    InjectedRuntimeError,
    ReplicaPreempted,
    corrupt_cache_dir,
    corrupt_checkpoint,
    corrupt_registry_dir,
    execute,
    execute_replica_fault,
    set_cancel_event,
)
from .plan import KINDS, SITES, Fault, FaultPlan, parse_plan

__all__ = [
    "Fault",
    "FaultPlan",
    "InjectedRuntimeError",
    "KINDS",
    "ReplicaPreempted",
    "SITES",
    "active_plan",
    "clear",
    "corrupt_cache_dir",
    "corrupt_checkpoint",
    "corrupt_registry_dir",
    "execute",
    "execute_replica_fault",
    "install",
    "maybe_inject",
    "parse_plan",
    "set_cancel_event",
]

_lock = threading.Lock()
_installed: Optional[FaultPlan] = None
_env_cache: "tuple[str, FaultPlan] | None" = None  # (plan text, parsed)


def install(plan: Union[FaultPlan, str, None]) -> Optional[FaultPlan]:
    """Set the process-wide fault plan (text is parsed).  ``None`` clears.
    Returns the installed plan."""
    global _installed
    with _lock:
        _installed = parse_plan(plan) if isinstance(plan, str) else plan
        return _installed


def clear() -> None:
    """Remove the installed plan and drop the config-parse cache."""
    global _installed, _env_cache
    with _lock:
        _installed = None
        _env_cache = None


def active_plan() -> Optional[FaultPlan]:
    """The plan injections consult: the installed one, else a cached
    parse of the effective config's ``fault_plan`` text."""
    global _env_cache
    with _lock:
        if _installed is not None:
            return _installed
    from .. import config

    text = config.get().fault_plan
    if not text:
        return None
    with _lock:
        if _env_cache is None or _env_cache[0] != text:
            _env_cache = (text, parse_plan(text))
        return _env_cache[1]


def maybe_inject(
    site: str,
    step: int,
    *,
    path: Optional[str] = None,
    plan: Optional[FaultPlan] = None,
) -> List[Fault]:
    """Fire any faults due at ``(site, step)``; no-op without a plan.

    Returns the faults that fired (a ``raise`` fault propagates instead
    of returning).  ``plan`` pins an explicit plan."""
    if plan is None:
        plan = active_plan()
    if plan is None:
        return []
    fired = plan.take(site, step)
    for fault in fired:
        execute(fault, path=path)
    return fired
