"""The port's pipeline schedule tables (``torchdistx_tpu_torch.parallel
.interleave``) held against the JAX package's, and the schedule's
invariants.

The tables are pure numpy on both sides, so they must be equal array for
array: ``interleaved_schedule`` (every table, the slot counts, the bubble
fraction, the peak stash, the segments), ``flat_1f1b_ticks``,
``flat_1f1b_segments`` and the analytic units, over a (pp, v, m) grid
with ragged microbatch counts and v = 1.  Then the invariants of
``tests/test_interleave.py`` on the port's tables, which its executor
walks tick by tick: every op exactly once and in dependency order, a
symbolic replay of the arrivals, inboxes and stash through the tables,
no slot reused while its value is unread, and segments that tile the
ticks as warmup, steady and cooldown.  No model runs here.
"""

import numpy as np
import pytest
import torch

from torchdistx_tpu.parallel import interleave as ref
from torchdistx_tpu_torch.parallel import interleave as port

torch.set_num_threads(2)

GRID = sorted({(1, 1, 1), (1, 2, 3), (2, 1, 4), (2, 2, 4), (2, 2, 5),
               (3, 2, 5), (4, 3, 7)}
              | {(pp, v, m) for pp in (2, 4, 8) for v in (1, 2, 4)
                 for m in (pp, 2 * pp + 1)})
TABLES = ("f_loc", "f_mb", "f_rd", "stash_w", "b_loc", "b_mb", "b_rd",
          "stash_r", "f_arr", "b_arr")
SCALARS = ("pp", "v", "m", "T", "n_f_slots", "n_b_slots", "n_stash_slots",
           "bubble_fraction", "peak_stash")


def _segments(segs):
    return [(g.t0, g.t1, g.has_f, g.has_b, g.has_seed, g.has_f_arr,
             g.has_b_arr, g.archetype, g.role) for g in segs]


@pytest.mark.parametrize("pp,v,m", GRID)
def test_tables_equal_the_reference(pp, v, m):
    got, want = port.interleaved_schedule(pp, v, m), \
        ref.interleaved_schedule(pp, v, m)
    for name in TABLES:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert set(got.tables()) == set(want.tables())
    for name in SCALARS:
        assert getattr(got, name) == getattr(want, name), name
    assert _segments(got.segments()) == _segments(want.segments())
    assert got.analytic_step_units() == want.analytic_step_units()
    assert got.uniform_step_units() == want.uniform_step_units()
    assert port.flat_1f1b_ticks(pp, m) == ref.flat_1f1b_ticks(pp, m)
    assert _segments(port.flat_1f1b_segments(pp, m)) == \
        _segments(ref.flat_1f1b_segments(pp, m))
    for fn in ("analytic_step_units_flat", "analytic_step_units_gpipe"):
        assert getattr(port, fn)(pp, v, m) == getattr(ref, fn)(pp, v, m)


def _replay_pool(arr, rd, n_slots, T, what):
    """A slot an arrival takes at tick ``t`` stays taken until the tick
    after its read; taking it earlier would overwrite an unread value."""
    occupied = {}
    for t in range(T):
        for s in [s for s, free in occupied.items() if free <= t]:
            del occupied[s]
        s = int(arr[t])
        if s < 0:
            continue
        assert s not in occupied, f"{what}: slot {s} reused at tick {t}"
        reads = np.flatnonzero(rd[t:] == s)
        assert reads.size, f"{what}: arrival at tick {t} never read"
        occupied[s] = t + int(reads[0]) + 1
        assert len(occupied) <= n_slots, what


@pytest.mark.parametrize("pp,v,m", GRID)
def test_schedule_invariants(pp, v, m):
    """Exactly once and in dependency order; the symbolic replay of the
    executor's arrivals, inboxes and stash; no slot reused while unread;
    warmup → steady → cooldown segments tiling [0, T)."""
    s = port.interleaved_schedule(pp, v, m)
    K = pp * v
    tF = -np.ones((K, m), np.int64)
    tB = -np.ones((K, m), np.int64)
    for d in range(pp):
        for t in range(s.T):
            if s.f_loc[d, t] >= 0:
                k, i = s.f_loc[d, t] * pp + d, s.f_mb[d, t]
                assert tF[k, i] < 0, "double forward"
                tF[k, i] = t
            if s.b_loc[d, t] >= 0:
                k, i = s.b_loc[d, t] * pp + d, s.b_mb[d, t]
                assert tB[k, i] < 0, "double backward"
                tB[k, i] = t
    assert (tF >= 0).all() and (tB >= 0).all(), "missing ops"
    for k in range(K):
        for i in range(m):
            if k > 0:
                assert tF[k, i] > tF[k - 1, i]
            if k < K - 1:
                assert tB[k, i] > tB[k + 1, i] and tB[k, i] > tF[k, i]
            else:
                assert tB[k, i] == tF[k, i], "seed not same-tick"

    # The executor's data flow, with symbols for values.
    buf, dbuf = [None] * pp, [None] * pp
    inbox_f = [dict() for _ in range(pp)]
    inbox_b = [dict() for _ in range(pp)]
    stash = [dict() for _ in range(pp)]
    for t in range(s.T):
        for d in range(pp):
            if s.f_arr[d, t] >= 0:
                assert buf[(d - 1) % pp] is not None, "arrival, no send"
                inbox_f[d][int(s.f_arr[d, t])] = buf[(d - 1) % pp]
            if s.b_arr[d, t] >= 0:
                assert dbuf[(d + 1) % pp] is not None
                inbox_b[d][int(s.b_arr[d, t])] = dbuf[(d + 1) % pp]
        new_buf, new_dbuf = [None] * pp, [None] * pp
        for d in range(pp):
            if s.f_loc[d, t] >= 0:
                k, i = int(s.f_loc[d, t]) * pp + d, int(s.f_mb[d, t])
                if s.f_rd[d, t] < 0:
                    assert k == 0, "batch feed off chunk 0"
                else:
                    assert inbox_f[d][int(s.f_rd[d, t])] == ("F", k - 1, i)
                stash[d][int(s.stash_w[d, t])] = (k, i)
                new_buf[d] = ("F", k, i)
            if s.b_loc[d, t] >= 0:
                k, i = int(s.b_loc[d, t]) * pp + d, int(s.b_mb[d, t])
                if s.b_rd[d, t] < 0:
                    assert k == K - 1, "self-seed off the last chunk"
                else:
                    assert inbox_b[d][int(s.b_rd[d, t])] == ("B", k + 1, i)
                assert stash[d][int(s.stash_r[d, t])] == (k, i)
                new_dbuf[d] = ("B", k, i)
        buf, dbuf = new_buf, new_dbuf

    for d in range(pp):
        _replay_pool(s.f_arr[d], s.f_rd[d], s.n_f_slots, s.T, f"f d{d}")
        _replay_pool(s.b_arr[d], s.b_rd[d], s.n_b_slots, s.T, f"b d{d}")
        _replay_pool(s.stash_w[d], s.stash_r[d], s.n_stash_slots, s.T,
                     f"stash d{d}")

    segs = s.segments()
    assert segs[0].t0 == 0 and segs[-1].t1 == s.T
    assert all(a.t1 == b.t0 for a, b in zip(segs, segs[1:]))
    if pp > 1:
        assert [g.role for g in segs] == ["warmup", "steady", "cooldown"]
        assert segs[1].has_seed
    flat = port.flat_1f1b_segments(pp, m)
    assert sum(g.ticks for g in flat) == port.flat_1f1b_ticks(pp, m)
