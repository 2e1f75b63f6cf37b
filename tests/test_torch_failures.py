"""The port's elastic loop (``utils/failures.py::run_elastic``) held against
the JAX package's, behaviour for behaviour.

Each case feeds the same toy step (``w * 1.5 + batch`` on 16 float32
values and a step count: exact float32 arithmetic, so both frameworks
compute the same bits), the same batches and the same chaos plan text
through the JAX ``run_elastic`` and the port's, each in a fresh
checkpoint directory.  Both must return the same ``(state, steps,
restarts)`` — the state bitwise — or raise the same way, leave the same
``step_N`` / ``step_N.corrupt`` directories and ``CLEAN_EXIT.json``, and
move the ``tdx.elastic.*`` counters by the same amounts.  The cases: a
raise at a step, a flapping entry, a save damaged after it committed
(found at the next restore, quarantined, an older step restored), a
restore that raises, a hang cut by the step watchdog, async saves under
``max_to_keep`` with a preemption drain, budget exhaustion, an exception
``retry_on`` does not list, and a streaming input rewound past its
replay window (``ReplayWindowExceeded``).

The two packages' injected errors differ in type by design (the JAX
``raise`` is an ``XlaRuntimeError``, the port's an
``InjectedRuntimeError``; ``_retryable_errors`` never retries a sticky
CUDA error), so a raise through both is compared as "the package's
chaos error".
"""

import json

import numpy as np
import pytest
import torch

from torchdistx_tpu_torch import chaos, observe
from torchdistx_tpu_torch.observe import health
from torchdistx_tpu_torch.utils.failures import (
    ReplayWindowExceeded,
    device_health,
    run_elastic,
)

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)

COUNTERS = ("restarts", "watchdog_kills", "drains", "drain_failures",
            "unhealthy_restarts")
N_BATCHES = 8


class _Boom(ValueError):
    """A real bug: no ``retry_on`` lists it."""


# case: (plan text, run_elastic options, step kind, streaming batches)
CASES = {
    "raise": ("step@3=raise", {}, "plain", False),
    "flap": ("step@4=raise;step@3=flap:0.5", {"max_restarts": 4}, "plain",
             False),
    "save-corrupt": ("save@4=corrupt:truncate;step@5=raise", {}, "plain",
                     False),
    "restore-raise": ("restore@2=raise;step@3=raise", {}, "plain", False),
    "hang": ("step@3=hang:30", {"step_deadline": 0.5}, "plain", False),
    "async-keep-drain": ("step@5=raise;step@7=preempt",
                         {"async_checkpoints": True, "max_to_keep": 2},
                         "plain", False),
    "budget": ("step@2=raise x5", {"max_restarts": 2}, "plain", False),
    "unlisted": ("", {}, "boom", False),
    "replay-window": ("save@4=corrupt:flip;step@5=raise", {}, "plain", True),
}


def _counts(obs):
    return {n: obs.counters().counter(f"tdx.elastic.{n}").value
            for n in COUNTERS}


def _run(side, text, kw, kind, streaming, tmp):
    """One run of ``side``'s loop: (outcome, directory listing, clean
    exit step, counter deltas)."""
    if side == "jax":
        import jax.numpy as jnp

        from torchdistx_tpu import chaos as pkg_chaos, observe as obs
        from torchdistx_tpu.utils.failures import run_elastic as run

        state = {"w": jnp.arange(16, dtype=jnp.float32), "n": jnp.float32(0)}
        batches = [jnp.float32(i) for i in range(1, N_BATCHES + 1)]
        mul = jnp.float32(1.5)
    else:
        pkg_chaos, obs, run = chaos, observe, run_elastic
        state = {"w": torch.arange(16, dtype=torch.float32),
                 "n": torch.tensor(0.0)}
        batches = [torch.tensor(float(i)) for i in range(1, N_BATCHES + 1)]
        mul = 1.5
    calls = {"n": 0}

    def step(s, b):
        calls["n"] += 1
        if kind == "boom" and calls["n"] == 3:
            raise _Boom("a real bug, not a device failure")
        return {"w": s["w"] * mul + b, "n": s["n"] + 1}, {}

    before = _counts(obs)
    pkg_chaos.install(text or None)
    try:
        out, steps, restarts = run(
            step, state, iter(batches) if streaming else batches,
            checkpoint_dir=str(tmp), checkpoint_every=2,
            probe_on_restart=False, **kw)
        outcome = (np.asarray(out["w"]).tobytes().hex(), float(out["n"]),
                   steps, restarts)
    except Exception as e:  # noqa: BLE001 — compared across the packages
        chaotic = isinstance(e, RuntimeError) and "chaos: injected" in str(e)
        outcome = ("raised", "chaos" if chaotic else type(e).__name__)
    finally:
        pkg_chaos.clear()
    clean = tmp / "CLEAN_EXIT.json"
    after = _counts(obs)
    return (outcome, sorted(p.name for p in tmp.iterdir()
                            if p.name != "CLEAN_EXIT.json"),
            json.loads(clean.read_text())["step"] if clean.exists() else None,
            {n: after[n] - before[n] for n in COUNTERS})


@pytest.mark.parametrize("case", list(CASES))
def test_run_elastic_matches_jax(case, tmp_path):
    text, kw, kind, streaming = CASES[case]
    got = {}
    for side in ("jax", "torch"):
        (tmp_path / side).mkdir()
        got[side] = _run(side, text, kw, kind, streaming, tmp_path / side)
    assert got["torch"] == got["jax"]
    outcome, dirs, clean, counts = got["torch"]
    if case == "budget":
        assert outcome == ("raised", "chaos") and counts["restarts"] == 3
    elif case == "unlisted":
        assert outcome == ("raised", "_Boom") and counts["restarts"] == 0
    elif case == "replay-window":
        assert outcome == ("raised", ReplayWindowExceeded.__name__)
        assert "step_4.corrupt" in dirs
    else:
        w = np.arange(16, dtype=np.float32)
        stop = 7 if case == "async-keep-drain" else N_BATCHES
        for b in range(1, stop + 1):
            w = w * np.float32(1.5) + np.float32(b)
        assert outcome[0] == w.tobytes().hex() and outcome[2] == stop
    if case == "save-corrupt":
        assert "step_4.corrupt" in dirs and counts["restarts"] == 1
    if case == "hang":
        assert counts["watchdog_kills"] == 1
    if case == "async-keep-drain":
        assert clean == 7 and dirs == ["step_6", "step_7"]
        assert counts["drains"] == 1
        alive, detail = health.liveness()
        assert alive and "elastic" in detail["heartbeats"]
    assert device_health()["healthy"]


def test_live_abandoned_step_raises_without_restoring(tmp_path, monkeypatch):
    """ROADMAP C9, the contract: a hang that ignores the watchdog's cancel
    (a wedged step, not an injected fault) still runs past the grace
    period, so the loop raises naming ``resume=True`` and restores
    nothing: no checkpoint is read, and the live module keeps the
    weights of the last step that returned."""
    import threading

    from torch import nn

    from torchdistx_tpu_torch.utils import checkpoint, failures

    monkeypatch.setattr(failures, "_ABANDONED_GRACE_S", 0.2)
    reads = []
    monkeypatch.setattr(checkpoint, "restore_checkpoint",
                        lambda *a, **k: reads.append(a))
    model = nn.Linear(4, 4)
    params = list(model.parameters())
    first = [p.detach().clone() for p in params]
    state = {"model": model, "params": params,
             "opt": torch.optim.SGD(params, lr=0.1), "step": 0}
    release, calls = threading.Event(), {"n": 0}

    def step(s, b):
        calls["n"] += 1
        if calls["n"] == 3:
            release.wait(30)  # wedged: it never looks at the cancel
        with torch.no_grad():
            for p in s["params"]:
                p.add_(b)
        s["step"] += 1
        return s, {}

    batches = [torch.tensor(float(i)) for i in range(1, N_BATCHES + 1)]
    try:
        with pytest.raises(RuntimeError, match=r"resume=True"):
            run_elastic(step, state, batches, checkpoint_dir=str(tmp_path),
                        checkpoint_every=1, step_deadline=0.5,
                        probe_on_restart=False)
        after = [p.detach().clone() for p in params]
        steps_done = state["step"]
    finally:
        release.set()
    assert reads == [] and calls["n"] == 3 and steps_done == 2
    for got, p0 in zip(after, first):
        assert torch.equal(got, p0 + 1.0 + 2.0)
