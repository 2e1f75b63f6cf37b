"""Fault-plan grammar and bookkeeping (the port's own copy of
``torchdistx_tpu/chaos/plan.py``: one plan text means the same faults to
both packages).

A fault plan is a deterministic schedule of failures keyed by *site*
(where the fault fires) and *step* (the 1-based step, program-group or
replica number the site counts).  Determinism is the point: every
failure the recovery code claims to survive can be replayed exactly, in
CI, on the CPU.

Text grammar (``TDX_FAULT_PLAN`` / :func:`parse_plan`)::

    plan  := entry (';' entry)*
    entry := site '@' step '=' kind [':' arg] ['x' count]
    site  := 'step' | 'save' | 'restore' | 'lower' | 'compile' | 'execute'
           | 'cache' | 'registry' | 'serve' | 'fleet' | 'reshard'
           | 'rollover'
    kind  := 'raise' | 'hang' | 'corrupt' | 'slow' | 'preempt' | 'flap'

Every site name of the JAX package parses here, so a plan written for
either package means the same entries to both.  The port fires:

* ``serve`` at the top of every serving-engine step (1-based step
  number): ``serve@3=raise`` requeues every active request (recompute
  preemption); ``serve@3=raise:chunk`` is deferred to the next
  prefill-chunk boundary, ``serve@3=raise:verify`` to the next
  speculative verify tick; ``flap`` / ``slow`` / ``hang`` as below;
* ``lower``, ``cache`` and ``compile`` (group 1) at each lazy build of a
  serving program, before its CUDA graph capture opens;
* ``cache`` before each kernel library's local lookup (group =
  ``ops._build.group(source)``) and ``registry`` at each publish to and
  fetch from the artifact registry;
* ``lower``, ``compile`` and ``execute`` before each stage of each group
  of the keyed materializer (:mod:`..cuda_bridge.materialize`; group =
  the 1-based group number, the whole recording's last rung group 1).

Each entry fires ``count`` times (default 1) and is then spent.  The one
exception is ``flap``: an INTERMITTENT, RECURRING fault.  Its arg is a
duty cycle in ``(0, 1]`` (default 0.5): each time its ``(site, step)``
matches, the entry counts the match and fires on the deterministic
Bresenham pattern that realizes exactly that fraction of matches
(``flap:1.0`` fires every match, ``flap:0.25`` every 4th); it is never
spent, ignores ``xN``, and keeps ``pending()`` non-empty until the plan
is cleared.  ``hang``/``slow`` args are seconds; ``corrupt`` args are
``truncate`` (default) or ``flip``.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field
from typing import List, Optional

SITES = ("step", "save", "restore", "lower", "compile", "execute", "cache",
         "registry", "serve", "fleet", "reshard", "rollover")
KINDS = ("raise", "hang", "corrupt", "slow", "preempt", "flap")
_FLAP_DEFAULT_DUTY = 0.5

_ENTRY_RE = re.compile(
    r"^(?P<site>[a-z_]+)@(?P<step>\d+)=(?P<kind>[a-z_]+)"
    r"(?::(?P<arg>[^x;]*?))?(?:\s*x(?P<count>\d+))?$"
)


@dataclass
class Fault:
    """One scheduled failure.  ``remaining`` counts down as it fires."""

    site: str
    step: int
    kind: str
    arg: Optional[str] = None
    count: int = 1
    remaining: int = field(default=-1)  # initialized from count
    hits: int = field(default=0)        # flap: (site, step) matches seen

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} (one of {SITES})")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (one of {KINDS})")
        if self.count < 1:
            raise ValueError(f"fault count must be >= 1, got {self.count}")
        if self.kind == "flap":
            duty = self.duty_cycle()
            if not (0.0 < duty <= 1.0):
                raise ValueError(
                    f"flap duty cycle must be in (0, 1], got {duty}"
                )
        if self.remaining < 0:
            self.remaining = self.count

    def duty_cycle(self) -> float:
        """The flap entry's firing fraction (its parsed arg)."""
        return float(self.arg) if self.arg else _FLAP_DEFAULT_DUTY

    def spec(self) -> str:
        arg = f":{self.arg}" if self.arg else ""
        cnt = f" x{self.count}" if self.count != 1 else ""
        return f"{self.site}@{self.step}={self.kind}{arg}{cnt}"


class FaultPlan:
    """A set of :class:`Fault` entries with thread-safe match-and-consume.

    :meth:`take` returns the faults due at ``(site, step)`` and decrements
    their budgets atomically, so concurrent callers (the watchdog worker
    thread vs the main loop) cannot double-fire an entry.
    """

    def __init__(self, faults: Optional[List[Fault]] = None):
        self.faults: List[Fault] = list(faults or [])
        self.fired: List[str] = []  # spec strings, in firing order
        self._lock = threading.Lock()

    def add(self, fault: Fault) -> "FaultPlan":
        with self._lock:
            self.faults.append(fault)
        return self

    def take(self, site: str, step: int) -> List[Fault]:
        """Faults due now; their ``remaining`` budgets are consumed.
        ``flap`` entries are never consumed: each match increments their
        ``hits`` and they fire on the deterministic Bresenham pattern of
        their duty cycle — the recurring-intermittent-fault model."""
        out: List[Fault] = []
        with self._lock:
            for f in self.faults:
                if f.site != site or f.step != step:
                    continue
                if f.kind == "flap":
                    f.hits += 1
                    duty = f.duty_cycle()
                    if int(f.hits * duty) > int((f.hits - 1) * duty):
                        self.fired.append(f.spec())
                        out.append(f)
                elif f.remaining > 0:
                    f.remaining -= 1
                    self.fired.append(f.spec())
                    out.append(f)
        return out

    def pending(self) -> List[Fault]:
        with self._lock:
            return [f for f in self.faults
                    if f.remaining > 0 or f.kind == "flap"]

    def __bool__(self) -> bool:  # "is there anything left to inject?"
        return bool(self.pending())

    def __repr__(self) -> str:
        return f"FaultPlan({'; '.join(f.spec() for f in self.faults)})"


def parse_plan(text: str) -> FaultPlan:
    """Parse the ``TDX_FAULT_PLAN`` grammar into a :class:`FaultPlan`."""
    faults: List[Fault] = []
    for raw in text.split(";"):
        entry = raw.strip()
        if not entry:
            continue
        m = _ENTRY_RE.match(entry)
        if not m:
            raise ValueError(
                f"bad fault-plan entry {entry!r}; expected "
                f"'site@step=kind[:arg][xN]' (see torchdistx_tpu_torch.chaos)"
            )
        arg = (m.group("arg") or "").strip() or None
        faults.append(
            Fault(
                site=m.group("site"),
                step=int(m.group("step")),
                kind=m.group("kind"),
                arg=arg,
                count=int(m.group("count") or 1),
            )
        )
    return FaultPlan(faults)
