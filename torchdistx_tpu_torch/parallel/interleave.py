"""Interleaved (virtual-stage) 1F1B schedule generation (the port's own
copy of ``torchdistx_tpu/parallel/interleave.py``; pure numpy, so the
tables are the reference's array for array).

Megatron-style interleaving: with ``v`` virtual stages ("model chunks")
per device, the ``K = v * pp`` chunks are dealt round-robin — global
chunk ``k`` lives on device ``k % pp`` — so the pipeline fill/drain
bubble costs ``~(pp - 1)`` *chunk*-sized stalls instead of ``(pp - 1)``
*device*-sized ones: a ``v``-fold bubble reduction, paid for with
``v``× more activation traffic between the stages.

The schedule is simulated once and emitted as static per-``(device,
tick)`` tables, which the executor
(:func:`~torchdistx_tpu_torch.parallel.pipeline.pipeline_train_interleaved`)
walks tick by tick: which chunk and microbatch each device runs forward
and backward, the inbox slot each arrival lands in and each op reads,
and the stash slot that keeps a forward's state until its backward.
Correctness (dependency order, device capacity, slot liveness) is
testable without running a model (tests/test_torch_interleave.py).

Schedule model
--------------

Events ``F(k, i)`` / ``B(k, i)`` for chunk ``k`` in [0, K), microbatch
``i`` in [0, m).  One tick = one chunk-forward plus (possibly) one
chunk-backward per device — the same per-tick budget as the flat 1F1B
loop.  Constraints:

* ``t(F(k, i)) >= t(F(k-1, i)) + 1``  (the activation takes one transfer);
* ``t(B(k, i)) >= t(B(k+1, i)) + 1``  (the cotangent takes one transfer);
* ``t(B(K-1, i)) == t(F(K-1, i))``    (the last chunk seeds its own
  backward from the tick's forward output, like the flat schedule);
* ``t(B(k, i)) > t(F(k, i))`` for ``k < K-1`` (the stash must exist);
* per device per tick: at most one F and at most one B.

The greedy dispatcher prefers the highest-chunk ready F (which
reproduces Megatron's group-of-``pp`` depth-first fill) and the
lowest-(mb, chunk-from-end) ready B (drain oldest work first).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


@dataclass(frozen=True)
class Segment:
    """A contiguous run of ticks sharing one statically-known work
    archetype — the UNION of per-device activity over the run (the
    reference's SPMD program is identical on every device, so a tick
    where any device does backward work runs the backward body on all
    of them).

    The archetype says which halves of a tick the run can hold:
    ``fwd-only`` ticks no backward, ``bwd-only`` ticks no forward, and
    only ``fwd+bwd-seed`` ticks a head-loss seed.  The port's tick
    walkers look only for those halves in a run."""

    t0: int
    t1: int
    has_f: bool       # any device runs a chunk forward in [t0, t1)
    has_b: bool       # any device runs a chunk backward
    has_seed: bool    # any backward self-seeds (head+loss vjp)
    has_f_arr: bool   # any activation arrival lands
    has_b_arr: bool   # any cotangent arrival lands

    @property
    def ticks(self) -> int:
        return self.t1 - self.t0

    @property
    def archetype(self) -> str:
        if self.has_f and self.has_b:
            return "fwd+bwd-seed" if self.has_seed else "fwd+bwd-mid"
        if self.has_f:
            return "fwd-only"
        if self.has_b:
            return "bwd-only"
        return "idle"  # pragma: no cover - schedules never emit idle runs

    @property
    def role(self) -> str:
        """Observability name: fwd-only runs are the pipeline fill
        ("warmup"), mixed runs the steady state, bwd-only the drain
        ("cooldown")."""
        return {"fwd-only": "warmup", "fwd+bwd-seed": "steady",
                "fwd+bwd-mid": "steady", "bwd-only": "cooldown",
                "idle": "idle"}[self.archetype]


# Analytic per-tick cost units (in chunk-forward equivalents) of the
# reference's static model.  A recompute backward (the reference's fused
# executors re-run the chunk interior under jax.vjp) costs a forward
# more than a stored-residual backward (GPipe's).  The port keeps each
# in-flight microbatch's autograd graph instead of recomputing, so its
# 1F1B backward costs BWD_STORED_UNIT; the model is kept as the
# reference's, for the tables' tests.
FWD_UNIT = 1.0
BWD_STORED_UNIT = 2.0
BWD_RECOMPUTE_UNIT = 3.0


@dataclass
class InterleavedSchedule:
    """Static tables for the executor; all arrays are int32 with
    shape ``[pp, T]`` and -1 meaning "no-op / discard" unless noted."""

    pp: int
    v: int
    m: int
    T: int
    # forward op at (d, t): local chunk j (global chunk = j*pp + d), mb
    f_loc: np.ndarray
    f_mb: np.ndarray
    # where F reads its input: inbox slot, or -1 = feed from the batch
    # (only ever -1 for global chunk 0 on device 0)
    f_rd: np.ndarray
    # stash slot F writes its input to (for the later recompute-backward)
    stash_w: np.ndarray
    # backward op at (d, t)
    b_loc: np.ndarray
    b_mb: np.ndarray
    # where B reads its upstream cotangent: inbox slot, or -1 = self-seed
    # (only on the last device, last local chunk)
    b_rd: np.ndarray
    stash_r: np.ndarray
    # inbox slot to store THIS tick's arrival into (-1: discard)
    f_arr: np.ndarray
    b_arr: np.ndarray
    # buffer sizes (max live slots, per device -> max over devices)
    n_f_slots: int
    n_b_slots: int
    n_stash_slots: int
    # schedule quality: fraction of (device, tick, F/B-slot) capacity idle
    bubble_fraction: float = 0.0
    # per-device peak count of simultaneously-live input stashes
    peak_stash: int = 0

    def tables(self):
        """The dict of arrays the executor closes over."""
        return {
            "f_loc": self.f_loc, "f_mb": self.f_mb, "f_rd": self.f_rd,
            "stash_w": self.stash_w, "b_loc": self.b_loc,
            "b_mb": self.b_mb, "b_rd": self.b_rd, "stash_r": self.stash_r,
            "f_arr": self.f_arr, "b_arr": self.b_arr,
        }

    def segments(self) -> List[Segment]:
        """Partition ``[0, T)`` into maximal contiguous runs whose
        (any-forward, any-backward) union archetype is constant, with
        per-run arrival/seed flags read off the tables.  The phase-
        specialized executor runs each run with only its archetype's
        halves.  Every realizable schedule collapses to the classic
        warmup → steady → cooldown shape (asserted over the pp×v×m
        sweep by the tests), but the merge is generic so a future
        dispatcher change degrades to more segments, not wrong ones."""
        any_f = (self.f_loc >= 0).any(axis=0)
        any_b = (self.b_loc >= 0).any(axis=0)
        segs: List[Segment] = []
        t0 = 0
        for t in range(1, self.T + 1):
            if t == self.T or (any_f[t], any_b[t]) != (any_f[t0], any_b[t0]):
                sl = slice(t0, t)
                segs.append(Segment(
                    t0=t0, t1=t,
                    has_f=bool(any_f[t0]), has_b=bool(any_b[t0]),
                    has_seed=bool(
                        ((self.b_loc[:, sl] >= 0)
                         & (self.b_rd[:, sl] < 0)).any()
                    ),
                    has_f_arr=bool((self.f_arr[:, sl] >= 0).any()),
                    has_b_arr=bool((self.b_arr[:, sl] >= 0).any()),
                ))
                t0 = t
        return segs

    def analytic_step_units(self) -> float:
        """Predicted cost of one step under the phase-specialized
        executor, in chunk-forward units: each tick of a run pays only
        its archetype's work (every device, active or masked, as the
        reference's SPMD program runs it)."""
        return sum(
            s.ticks * (s.has_f * FWD_UNIT + s.has_b * BWD_RECOMPUTE_UNIT)
            for s in self.segments()
        )

    def uniform_step_units(self) -> float:
        """Predicted cost of the uniform-tick executor: all ``T`` ticks
        pay forward + recompute-backward regardless of activity."""
        return self.T * (FWD_UNIT + BWD_RECOMPUTE_UNIT)


class _SlotPool:
    """First-free slot allocator with interval liveness accounting."""

    def __init__(self):
        self.free: List[int] = []
        self.n = 0
        self.live = 0
        self.peak = 0

    def alloc(self) -> int:
        self.live += 1
        self.peak = max(self.peak, self.live)
        if self.free:
            return self.free.pop()
        s = self.n
        self.n += 1
        return s

    def release(self, s: int) -> None:
        self.live -= 1
        self.free.append(s)


def interleaved_schedule(pp: int, v: int, m: int) -> InterleavedSchedule:
    """Simulate the interleaved 1F1B schedule; see the module docstring.

    ``m`` (microbatches) need not be a multiple of ``pp``; ragged counts
    just schedule less densely.  ``v == 1`` reproduces a flat 1F1B
    ordering (useful for differential testing against the closed-form
    flat schedule).
    """
    if pp < 1 or v < 1 or m < 1:
        raise ValueError(f"interleaved_schedule({pp=}, {v=}, {m=})")
    K = pp * v

    # Event state: tick each F/B ran at (-1 = not yet).
    tF = -np.ones((K, m), dtype=np.int64)
    tB = -np.ones((K, m), dtype=np.int64)

    # Per-(device, tick) op logs, grown as we go.
    ops_f: List[List[Tuple[int, int, int]]] = [[] for _ in range(pp)]
    ops_b: List[List[Tuple[int, int, int]]] = [[] for _ in range(pp)]

    # Per-device op ORDER (Megatron interleaved order): microbatches run
    # in groups of ``pp`` per chunk — round r covers mbs [r*pp, (r+1)*pp)
    # through chunks 0..v-1 forward (v-1..0 backward), so the next group
    # can start filling a chunk while the previous drains deeper ones.
    # Tick assignment below is list scheduling: each device walks its
    # sequences IN ORDER, stalling a slot while dependencies are unmet.
    def mb_rounds():
        return [
            list(range(r * pp, min((r + 1) * pp, m)))
            for r in range((m + pp - 1) // pp)
        ]

    fwd_seq: List[Tuple[int, int]] = []  # (local chunk, mb), same for all d
    bwd_seq: List[Tuple[int, int]] = []
    for mbs in mb_rounds():
        for c in range(v):
            fwd_seq.extend((c, i) for i in mbs)
        for c in reversed(range(v)):
            bwd_seq.extend((c, i) for i in mbs)

    # Megatron warmup depth: later ranks start their backwards sooner.
    warm = [
        min(2 * (pp - d - 1) + (v - 1) * pp, v * m) for d in range(pp)
    ]
    pf = [0] * pp  # per-device cursor into fwd_seq
    pb = [0] * pp

    done_b = 0
    t = 0
    # Safety bound: the schedule must finish within the serial bound.
    t_max = 2 * K * m + 2 * K + 8
    while done_b < K * m and t <= t_max:
        for d in range(pp):
            seeded = False
            # ---- F slot: next forward in order, if its input is ready --
            if pf[d] < len(fwd_seq):
                c, i = fwd_seq[pf[d]]
                k = c * pp + d
                if k == 0 or 0 <= tF[k - 1, i] < t:
                    tF[k, i] = t
                    ops_f[d].append((t, k, i))
                    pf[d] += 1
                    if k == K - 1:
                        # seed: backward runs THIS tick on this device
                        tB[k, i] = t
                        ops_b[d].append((t, k, i))
                        done_b += 1
                        seeded = True
                        # the (v-1, i) entry in bwd_seq is satisfied
            # ---- B slot: next backward in order (past warmup) ----------
            if seeded:
                continue
            if pb[d] >= len(bwd_seq):
                continue
            if pf[d] < warm[d] and pf[d] < len(fwd_seq):
                continue  # still warming up
            # skip bwd_seq entries already satisfied by seeds
            while pb[d] < len(bwd_seq):
                c, i = bwd_seq[pb[d]]
                if tB[c * pp + d, i] >= 0:
                    pb[d] += 1
                else:
                    break
            if pb[d] >= len(bwd_seq):
                continue
            c, i = bwd_seq[pb[d]]
            k = c * pp + d
            if k == K - 1:
                continue  # last chunk's backward only happens as a seed
            if 0 <= tB[k + 1, i] < t and 0 <= tF[k, i] < t:
                tB[k, i] = t
                ops_b[d].append((t, k, i))
                pb[d] += 1
                done_b += 1
        t += 1
    if done_b < K * m:  # pragma: no cover - scheduler invariant
        raise RuntimeError(
            f"interleaved_schedule({pp}, {v}, {m}) did not converge"
        )
    T = t

    shape = (pp, T)
    f_loc = -np.ones(shape, np.int32); f_mb = -np.ones(shape, np.int32)
    f_rd = -np.ones(shape, np.int32); stash_w = -np.ones(shape, np.int32)
    b_loc = -np.ones(shape, np.int32); b_mb = -np.ones(shape, np.int32)
    b_rd = -np.ones(shape, np.int32); stash_r = -np.ones(shape, np.int32)
    f_arr = -np.ones(shape, np.int32); b_arr = -np.ones(shape, np.int32)

    for d in range(pp):
        for (tt, k, i) in ops_f[d]:
            f_loc[d, tt] = k // pp
            f_mb[d, tt] = i
        for (tt, k, i) in ops_b[d]:
            b_loc[d, tt] = k // pp
            b_mb[d, tt] = i

    # ---- slot assignment ------------------------------------------------
    # Activation inbox: edge F(k, i) -> F(k+1, i); value arrives on the
    # consumer at tick tF[k, i] + 1, read at tF[k+1, i].
    fpool = [_SlotPool() for _ in range(pp)]
    events: Dict[Tuple[int, int], List[Tuple[str, int, int, int]]] = {}
    for k in range(K - 1):
        dc = (k + 1) % pp
        for i in range(m):
            ta, tc = int(tF[k, i]) + 1, int(tF[k + 1, i])
            events.setdefault((dc, ta), []).append(("fa", k, i, tc))
    bpool = [_SlotPool() for _ in range(pp)]
    for k in range(K - 1):
        dc = k % pp
        for i in range(m):
            ta, tc = int(tB[k + 1, i]) + 1, int(tB[k, i])
            events.setdefault((dc, ta), []).append(("ba", k, i, tc))

    # Replay arrivals in tick order so alloc/release interleave correctly.
    release_at: Dict[Tuple[int, int, str], List[int]] = {}
    for tt in range(T + 1):
        for d in range(pp):
            for s in release_at.pop((d, tt, "f"), []):
                fpool[d].release(s)
            for s in release_at.pop((d, tt, "b"), []):
                bpool[d].release(s)
            for (kind, k, i, tc) in events.get((d, tt), []):
                if kind == "fa":
                    s = fpool[d].alloc()
                    f_arr[d, tt] = s
                    f_rd[d, int(tF[k + 1, i])] = s
                    # freed the tick AFTER the read executes
                    release_at.setdefault((d, tc + 1, "f"), []).append(s)
                else:
                    s = bpool[d].alloc()
                    b_arr[d, tt] = s
                    b_rd[d, int(tB[k, i])] = s
                    release_at.setdefault((d, tc + 1, "b"), []).append(s)

    # Input stash: F(k, i) writes, B(k, i) reads (same device); the seed
    # (k == K-1) consumes its own tick's input directly — still stash it
    # for uniformity of the executor's gather (read slot == write slot).
    spool = [_SlotPool() for _ in range(pp)]
    s_release: Dict[Tuple[int, int], List[int]] = {}
    for tt in range(T + 1):
        for d in range(pp):
            for s in s_release.pop((d, tt), []):
                spool[d].release(s)
            if tt < T and f_loc[d, tt] >= 0:
                k = f_loc[d, tt] * pp + d
                i = f_mb[d, tt]
                s = spool[d].alloc()
                stash_w[d, tt] = s
                stash_r[d, int(tB[k, i])] = s
                s_release.setdefault((d, int(tB[k, i]) + 1), []).append(s)

    # A tick's arrival slot must never equal a slot being READ this tick
    # by construction (release happens after the read tick); the pools
    # guarantee it, and the tests assert it.

    busy = int((f_loc >= 0).sum() + (b_loc >= 0).sum())
    n_f = max((p.n for p in fpool), default=0) or 1
    n_b = max((p.n for p in bpool), default=0) or 1
    n_s = max((p.n for p in spool), default=0) or 1
    # Build-time guards (cheap numpy): every ACTIVE read/write index
    # lands strictly in-bounds of its buffer (the tests prove the same
    # over the pp×v×m sweep).
    for name, tab, n_slots, active in [
        ("f_rd", f_rd, n_f, f_loc >= 0), ("f_arr", f_arr, n_f, f_arr >= 0),
        ("b_rd", b_rd, n_b, b_loc >= 0), ("b_arr", b_arr, n_b, b_arr >= 0),
        ("stash_w", stash_w, n_s, f_loc >= 0),
        ("stash_r", stash_r, n_s, b_loc >= 0),
    ]:
        # f_rd/b_rd stay -1 for batch feeds / self-seeds — those are
        # active ops whose table value is legitimately negative.
        vals = tab[active]
        if name in ("f_rd", "b_rd"):
            vals = vals[vals >= 0]
        assert vals.size == 0 or (0 <= vals.min() and vals.max() < n_slots), (
            f"interleaved_schedule({pp}, {v}, {m}): {name} has an active "
            f"index outside [0, {n_slots})"
        )
    sched = InterleavedSchedule(
        pp=pp, v=v, m=m, T=T,
        f_loc=f_loc, f_mb=f_mb, f_rd=f_rd, stash_w=stash_w,
        b_loc=b_loc, b_mb=b_mb, b_rd=b_rd, stash_r=stash_r,
        f_arr=f_arr, b_arr=b_arr,
        n_f_slots=n_f, n_b_slots=n_b, n_stash_slots=n_s,
        bubble_fraction=round(1.0 - busy / (2.0 * pp * T), 4),
        peak_stash=max(p.peak for p in spool),
    )
    return sched


def flat_1f1b_ticks(pp: int, m: int) -> int:
    """Closed-form tick count of the flat (non-interleaved) schedule —
    ``2*(pp-1) + m`` — in DEVICE-sized stage units.  For a like-for-like
    bubble comparison against :func:`interleaved_schedule` (whose ticks
    are ``1/v`` the work), scale by ``v``."""
    return 2 * (pp - 1) + m


def flat_1f1b_segments(pp: int, m: int) -> List[Segment]:
    """Closed-form segments of the flat 1F1B schedule: ``pp-1`` warmup
    ticks where only forwards run (the first backward is the last
    stage's tick-``pp-1`` self-seed), ``m`` steady ticks (every one of
    which seeds — the last stage backs up one microbatch per tick), and
    ``pp-1`` drain ticks with forwards exhausted.  Arrival flags are
    meaningless for the flat executor (it has single-slot ring buffers,
    not inboxes) and are stamped to mirror the work flags."""
    n1 = pp - 1
    segs = [
        Segment(0, n1, True, False, False, n1 > 1, False),
        Segment(n1, n1 + m, True, True, True, True, True),
        Segment(n1 + m, 2 * n1 + m, False, True, False, False, n1 > 1),
    ]
    return [s for s in segs if s.ticks > 0]


def analytic_step_units_flat(pp: int, v: int, m: int) -> float:
    """Phase-specialized flat-1F1B step cost in chunk-forward units
    (one flat tick runs the whole ``v``-chunk device stack)."""
    return v * sum(
        s.ticks * (s.has_f * FWD_UNIT + s.has_b * BWD_RECOMPUTE_UNIT)
        for s in flat_1f1b_segments(pp, m)
    )


def analytic_step_units_gpipe(pp: int, v: int, m: int) -> float:
    """GPipe step cost in chunk-forward units: ``m + pp - 1`` forward
    ticks of the full device stack, then the same count of
    stored-residual backward ticks (no recompute — GPipe
    keeps every microbatch's layer activations, its memory price)."""
    return (m + pp - 1) * v * (FWD_UNIT + BWD_STORED_UNIT)
