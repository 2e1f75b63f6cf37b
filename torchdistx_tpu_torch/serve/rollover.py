"""Blue-green weight rollover with a bitwise canary gate (the port's
counterpart of ``torchdistx_tpu/serve/rollover.py``).

The :class:`RolloverController` rolls a live :class:`~.fleet.ServeFleet`
from the weights it is serving onto a committed checkpoint, without the
fleet ever dropping below its replica floor and without any in-flight
request migrating across weight versions mid-decode.  It is a
tick-driven state machine (:meth:`ServeFleet.tick` calls :meth:`step`
once per control step, after reaps and before dispatch) walking four
stages:

``fetch``
    Verify the checkpoint (manifest digests + commit marker), stamp its
    version (:func:`~..utils.checkpoint.checkpoint_version`), and load it
    into the serving layout: through :func:`~..reshard.restore_resharded`
    where the manifest's topology differs from the live parameters',
    else a plain :func:`~..utils.checkpoint.restore_checkpoint` onto the
    serving device.
``canary``
    Spin up one GREEN replica on the new weights (``canary=True``: the
    dispatcher never routes real traffic at it) and hold it behind the
    **bitwise canary gate**: the GREEN replica must reproduce
    :func:`~.engine.oracle_generate` under the NEW weights on a probe
    set, token for token, with final logits within ``logits_atol``.
``shift``
    Flip traffic: the fleet's ``active_version`` becomes the new stamp,
    the spawn defaults follow (floor backfills and autoscale-ups come up
    on the new weights), and the canary joins rotation.  In-flight
    requests stay PINNED to the version they first streamed under.
``drain``
    Retire BLUE one replica at a time through the fleet's drain path.
    Before each drain the controller checks the floor: if draining would
    take the serving count below ``min_replicas`` it first spawns a
    GREEN replacement and waits for it to serve.

Failure containment (degrade-never-corrupt): a canary mismatch, a GREEN
fault, an injected ``rollover``-site chaos fault, or a stage timeout
ABORTS the roll: the GREEN replica is torn down, its KV pool freed, the
probe bookkeeping dropped, and (for fetch/canary-stage failures) the
checkpoint is quarantined (:func:`~..utils.checkpoint
.quarantine_checkpoint`).  BLUE is never touched.  A post-shift abort
(drain timeout) keeps the shifted version and stops retiring BLUEs.

Chaos: the ``rollover`` site is keyed by stage number (fetch=1,
canary=2, shift=3, drain=4).  ``corrupt`` damages the INCOMING
checkpoint (caught at the fetch stage by verification); ``preempt``
kills only the GREEN canary replica (never the process); ``raise`` /
``hang`` fire at the stage boundary and surface as an abort / a stalled
roll.

The checkpoint restore and the canary's oracle run on the controller
thread under the fleet's ``device_lock``, as every piece of the fleet's
device work does (:mod:`.fleet`).

Telemetry: ``tdx.fleet.rollover_{started,completed,aborts,
canary_mismatch,blue_drains,resharded}`` counters, the
``rollover.fetch`` span, and ``fleet.rollover_*`` trace instants.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import chaos, observe
from ..reshard import needs_reshard, restore_resharded
from ..utils.checkpoint import (
    checkpoint_version,
    quarantine_checkpoint,
    restore_checkpoint,
    verify_checkpoint,
)
from ..utils.logging import get_logger
from .engine import Request, oracle_generate
from .fleet import _TERMINAL_STATES, params_model

__all__ = [
    "ROLL_STAGES",
    "STAGE_NO",
    "RollError",
    "RolloverConfig",
    "RolloverController",
]

ROLL_STAGES = ("fetch", "canary", "shift", "drain")

# The chaos ``rollover`` site key per stage (plan grammar:
# ``rollover@2=preempt`` kills the GREEN canary).
STAGE_NO = {s: i + 1 for i, s in enumerate(ROLL_STAGES)}

# Probe rids live in the fleet's normal result plumbing while the
# canary runs; the prefix keeps them unmistakably internal.
_PROBE_PREFIX = "~rollover/probe-"


class RollError(RuntimeError):
    """A roll-stage failure: canary mismatch, GREEN death, checkpoint
    verification failure, or stage timeout.  Always contained — the
    controller aborts, BLUE keeps serving."""


@dataclass(frozen=True)
class RolloverConfig:
    """Knobs for one roll.  The probe set is deliberately tiny — the
    gate's power is bitwise exactness, not coverage; three prompts of
    different lengths exercise distinct prefill buckets."""

    probe_prompts: Tuple[Tuple[int, ...], ...] = (
        (1, 2, 3),
        (2, 7, 1, 8, 2),
        (5, 4, 3, 2, 1, 6, 7),
    )
    probe_new_tokens: int = 6
    logits_atol: float = 1e-4          # final-logits tolerance (tokens exact)
    canary_timeout_s: float = 120.0    # GREEN bring-up + probe round-trip
    drain_timeout_s: float = 300.0     # full BLUE retirement

    def __post_init__(self):
        if not self.probe_prompts:
            raise ValueError("probe_prompts must not be empty")
        if self.probe_new_tokens < 1:
            raise ValueError("probe_new_tokens must be >= 1")


class RolloverController:
    """One blue-green roll; constructed via
    :meth:`~.fleet.ServeFleet.start_rollover` and driven by the fleet
    tick.  Read ``stage`` / ``outcome`` / ``digest()`` to observe it;
    ``outcome`` is ``None`` while in flight, then ``"completed"`` or
    ``"aborted"`` (with ``error`` and ``quarantined`` set)."""

    def __init__(self, fleet, checkpoint_path, *,
                 cfg: Optional[RolloverConfig] = None):
        self.fleet = fleet
        self.path = Path(checkpoint_path)
        self.rc = cfg or RolloverConfig()
        self.stage = "idle"
        self.outcome: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.version: Optional[str] = None   # new stamp (set at fetch)
        self.old_version: Optional[str] = None
        self.quarantined = False
        self.failed_stage: Optional[str] = None
        self.new_params = None
        self.green = None                    # the canary ReplicaHandle
        self._probe_rids: List[str] = []
        self._probes_sent = False
        self._stage_t0 = time.monotonic()
        self._stage_s: Dict[str, float] = {}
        self._log = get_logger()

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        if not self.fleet.handles:
            raise RuntimeError("start the fleet before rolling it")
        self.old_version = self.fleet.active_version
        self.fleet.rollover = self
        observe.counter("tdx.fleet.rollover_started").inc()
        observe.instant("fleet.rollover_start", category="serve",
                        path=str(self.path))
        self._enter("fetch")

    def step(self) -> None:
        """One roll step, called from the controller tick.  Stage
        failures are CONTAINED here: any exception aborts the roll and
        is recorded on the controller, never propagated into the tick
        — BLUE's traffic must not notice."""
        if self.stage not in ROLL_STAGES:
            return
        try:
            getattr(self, f"_step_{self.stage}")()
        except Exception as e:  # noqa: BLE001 — containment boundary
            self._abort(e)

    def digest(self) -> dict:
        """JSON-ready roll summary: versions, stage, outcome, error, the
        seconds of each stage."""
        return {
            "path": str(self.path),
            "from_version": self.old_version,
            "to_version": self.version,
            "stage": self.stage,
            "failed_stage": self.failed_stage,
            "outcome": self.outcome,
            "error": str(self.error) if self.error is not None else None,
            "quarantined": self.quarantined,
            "probes": len(self.rc.probe_prompts),
            "stages_s": {k: round(v, 4) for k, v in self._stage_s.items()},
        }

    # -- stage machinery --------------------------------------------------

    def _enter(self, stage: str) -> None:
        now = time.monotonic()
        if self.stage in ROLL_STAGES:
            self._stage_s[self.stage] = now - self._stage_t0
        self.stage = stage
        self._stage_t0 = now
        observe.instant("fleet.rollover_stage", category="serve",
                        stage=stage)

    def _elapsed(self) -> float:
        return time.monotonic() - self._stage_t0

    def _fault(self, stage: str) -> None:
        """The ``rollover`` chaos site, keyed by stage number.
        ``preempt`` is special-cased onto the GREEN replica (a roll
        preemption models losing the canary host, never the serving
        process); everything else goes through the standard injector —
        whose ``corrupt`` fallthrough damages the incoming checkpoint
        directory."""
        plan = chaos.active_plan()
        if plan is None:
            return
        for fault in plan.take("rollover", STAGE_NO[stage]):
            if fault.kind == "preempt":
                observe.counter("tdx.chaos.injected", kind="preempt").inc()
                observe.instant("chaos.injected", category="chaos",
                                spec=fault.spec(), site="rollover")
                g = self.green
                if g is not None and g in self.fleet.handles:
                    g.error = chaos.ReplicaPreempted(
                        f"chaos: injected GREEN preemption ({fault.spec()})")
                    g.set_state("preempted")
                    g.stop_evt.set()
                    g.work_evt.set()
                continue
            chaos.execute(fault, path=str(self.path))

    # -- stages -----------------------------------------------------------

    def _step_fetch(self) -> None:
        fleet = self.fleet
        # Faults fire BEFORE verification so a fetch-stage corrupt is
        # caught by the gate's verify arm, not deserialized.
        self._fault("fetch")
        with observe.span("rollover.fetch", category="serve",
                          path=str(self.path)):
            ok, reason = verify_checkpoint(self.path)
            if not ok:
                raise RollError(
                    f"checkpoint {self.path} failed verification: {reason}")
            self.version = checkpoint_version(self.path)
            target = fleet.params
            if target is None:
                raise RollError("fleet has no serving params to roll from")
            with fleet.device_lock:
                if needs_reshard(self.path, target):
                    # Trained on another topology than the serving
                    # layout: stream-reshard straight into it.
                    observe.counter("tdx.fleet.rollover_resharded").inc()
                    self.new_params = restore_resharded(
                        self.path, target, chaos_plan=chaos.active_plan())
                else:
                    self.new_params = restore_checkpoint(
                        self.path, target=target)
        self._enter("canary")

    def _step_canary(self) -> None:
        fleet, rc = self.fleet, self.rc
        if self._elapsed() > rc.canary_timeout_s:
            raise RollError(
                f"canary timed out after {rc.canary_timeout_s}s "
                f"(green={'up' if self.green is not None else 'unspawned'}, "
                f"probes_sent={self._probes_sent})")
        g = self.green
        if g is None:
            if len(fleet.handles) >= fleet.fc.max_replicas:
                return  # wait for headroom (a reap frees the slot)
            self.green = fleet.scale_up(
                params=self.new_params, version=self.version, canary=True)
            observe.instant("fleet.rollover_green", category="serve",
                            replica=self.green.idx, version=self.version)
            return
        if g not in fleet.handles or g.state in _TERMINAL_STATES:
            # Checked BEFORE probe results so a preempted/killed GREEN
            # aborts as a green fault, not a canary mismatch.
            raise RollError(
                f"GREEN replica r{g.idx} died during canary "
                f"(state={g.state}): {g.error}")
        if g.state != "serving":
            return  # still launching
        if not self._probes_sent:
            self._fault("canary")
            if g.state != "serving" or g not in fleet.handles:
                return  # the fault killed GREEN; abort on the next pass
            for i, prompt in enumerate(rc.probe_prompts):
                rid = f"{_PROBE_PREFIX}{i}"
                req = Request(rid, list(prompt),
                              max_new_tokens=rc.probe_new_tokens)
                # Probes bypass the admission queue — they must land on
                # the canary, which dispatch never routes to — but ride
                # the normal completion plumbing (_reap_completions).
                fleet._pending.add(rid)
                fleet._requests[rid] = req
                self._probe_rids.append(rid)
                g.give(req)
            self._probes_sent = True
            return
        unresolved = [rid for rid in self._probe_rids
                      if rid not in fleet.results
                      and rid not in fleet.rejected]
        if unresolved:
            return  # still decoding; judged when all are terminal
        self._judge_canary()
        self._enter("shift")

    def _judge_canary(self) -> None:
        """The bitwise gate: every probe must match the NEW oracle,
        tokens exactly and final logits within ``logits_atol``."""
        fleet, rc = self.fleet, self.rc
        try:
            for i, prompt in enumerate(rc.probe_prompts):
                rid = self._probe_rids[i]
                got = fleet.results.get(rid)
                if got is None:
                    rej = fleet.rejected.get(rid)
                    raise RollError(
                        f"canary probe {rid} did not complete"
                        + (f" (rejected: {rej.reason})" if rej else ""))
                with fleet.device_lock:
                    want, want_logits = oracle_generate(
                        params_model(fleet.family, fleet.cfg,
                                     self.new_params),
                        list(prompt), rc.probe_new_tokens)
                got_logits = fleet.final_logits.get(rid)
                if (list(got) != list(want) or got_logits is None
                        or not np.allclose(got_logits, want_logits,
                                           atol=rc.logits_atol)):
                    observe.counter(
                        "tdx.fleet.rollover_canary_mismatch").inc()
                    raise RollError(
                        f"canary MISMATCH on {rid}: GREEN produced "
                        f"{list(got)} vs oracle {list(want)} under "
                        f"{self.version} (logits atol={rc.logits_atol})")
        finally:
            self._cleanup_probes()
        observe.instant("fleet.rollover_canary_ok", category="serve",
                        replica=self.green.idx,
                        probes=len(rc.probe_prompts))

    def _step_shift(self) -> None:
        fleet = self.fleet
        self._fault("shift")
        g = self.green
        if g is None or g not in fleet.handles or g.state != "serving":
            raise RollError("GREEN replica lost at shift")
        # From here every new spawn — floor backfill, autoscale-up,
        # half-open probe replacement — comes up on the new weights.
        fleet.version_params[self.version] = self.new_params
        fleet._spawn_params = self.new_params
        fleet._spawn_version = self.version
        fleet.active_version = self.version
        g.canary = False  # GREEN joins rotation this very tick
        observe.instant("fleet.rollover_shift", category="serve",
                        version=self.version, replica=g.idx)
        self._enter("drain")

    def _step_drain(self) -> None:
        fleet = self.fleet
        if self._elapsed() > self.rc.drain_timeout_s:
            raise RollError(
                f"drain timed out after {self.rc.drain_timeout_s}s")
        self._fault("drain")
        blues = [h for h in fleet.handles
                 if h.weight_version != self.version]
        if not blues:
            self._finish()
            return
        if any(h.state == "draining" for h in blues):
            return  # one at a time: capacity never steps down by two
        serving_blues = [h for h in blues if h.state == "serving"]
        if not serving_blues:
            return  # launching/dead blues resolve via normal reaping
        serving = sum(1 for h in fleet.handles if h.state == "serving")
        if serving - 1 < fleet.fc.min_replicas:
            # Make-before-break: a GREEN replacement must serve before
            # the next BLUE drains, so the floor never dips.
            if any(h.state == "launching" for h in fleet.handles):
                return  # replacement on its way
            if len(fleet.handles) < fleet.fc.max_replicas:
                fleet.scale_up()  # spawn defaults are GREEN post-shift
                return
            # min == max: no headroom for make-before-break — drain
            # anyway and let the autoscaler floor backfill (GREEN, by
            # the spawn defaults) as soon as the drained BLUE reaps.
        victim = least_outstanding_blue(serving_blues)
        victim.set_state("draining")
        victim.drain_evt.set()
        victim.work_evt.set()
        observe.counter("tdx.fleet.rollover_blue_drains").inc()
        observe.instant("fleet.rollover_drain", category="serve",
                        replica=victim.idx,
                        version=victim.weight_version)

    # -- terminal -----------------------------------------------------------

    def _finish(self) -> None:
        self._enter("done")
        self.outcome = "completed"
        self.fleet.rollover = None
        observe.counter("tdx.fleet.rollover_completed").inc()
        observe.instant(
            "fleet.rollover_done", category="serve",
            version=self.version,
            **{f"{k}_s": round(v, 4) for k, v in self._stage_s.items()})
        self._log.info("rollover: fleet now on %s (%s)", self.version,
                       ", ".join(f"{k}={v:.3f}s"
                                 for k, v in self._stage_s.items()))

    def _abort(self, err: BaseException) -> None:
        failed_stage = self.stage
        self.failed_stage = failed_stage
        self.error = err
        self._enter("aborted")
        self.outcome = "aborted"
        observe.counter("tdx.fleet.rollover_aborts").inc()
        observe.instant("fleet.rollover_abort", category="serve",
                        stage=failed_stage, error=str(err))
        self._log.warning("rollover: ABORTED at %s: %s (BLUE keeps "
                          "serving)", failed_stage, err)
        g = self.green
        if failed_stage in ("fetch", "canary"):
            # Pre-shift: GREEN never took real traffic: tear it down
            # (its stop path requeues lanes and frees the KV pool) and
            # drop the probe bookkeeping.
            if g is not None and g in self.fleet.handles:
                g.error = g.error or err
                self.fleet._remove(g)
            self._cleanup_probes()
            # Containment: the new weights are bad (verify/canary
            # failure) or unprovable (GREEN death) — quarantine the
            # checkpoint so nothing restores or re-rolls it until an
            # operator looks (same rename contract as run_elastic).
            if self.path.exists():
                try:
                    quarantine_checkpoint(self.path)
                    self.quarantined = True
                except OSError as qerr:  # containment must not raise
                    self._log.warning(
                        "rollover: could not quarantine %s: %s",
                        self.path, qerr)
        # Post-shift aborts (drain timeout) keep the shifted version:
        # the canary already proved those weights; the roll just stops
        # retiring BLUEs.
        self.fleet.rollover = None

    def _cleanup_probes(self) -> None:
        """Drop every trace of the probe rids from the fleet's result
        plumbing — probes are gate internals, never client results."""
        fleet = self.fleet
        for rid in self._probe_rids:
            fleet._pending.discard(rid)
            fleet._requests.pop(rid, None)
            fleet.results.pop(rid, None)
            fleet.final_logits.pop(rid, None)
            fleet.rejected.pop(rid, None)
            fleet.served_version.pop(rid, None)
            fleet._rid_version.pop(rid, None)
            with fleet._stream_lock:
                fleet.partial.pop(rid, None)
                fleet._first_replica.pop(rid, None)
                fleet._stream_pos.pop(rid, None)
        self._probe_rids = []


def least_outstanding_blue(handles):
    """The drain-victim policy: the serving BLUE with the least
    outstanding work (fewest in-flight tokens to finish on the old
    weights), ties broken by launch order."""
    return min(handles, key=lambda h: (h.outstanding(), h.idx))
