"""The port's ``chaos`` package held against the JAX package's.

* one plan text parses to the same ``Fault`` entries in both packages
  (site, step, kind, arg, count, budget, spec), and a bad text fails in
  both;
* ``FaultPlan.take`` fires on the same calls in both over 64 matches of
  one ``(site, step)``: spent entries once per count, ``flap`` entries on
  their duty cycle's Bresenham pattern;
* the executors: ``raise`` and ``flap`` raise the port's
  ``InjectedRuntimeError``, count ``tdx.chaos.injected{kind}`` and dump
  the flight recorder (a bundle both packages' ``validate`` accept)
  before raising; ``slow`` sleeps; a ``hang`` is cut by
  ``set_cancel_event``; ``corrupt`` flips the byte the JAX executor flips
  in a checkpoint's largest payload file at ``save`` / ``restore``, in
  every registry entry's payload at ``registry`` and in every installed
  kernel library (the JAX cache's entries) at ``cache``, touches no file
  at ``reshard`` (the engine damages its chunk) and raises
  ``NotImplementedError`` naming the ROADMAP item that ports its target
  at the compile sites;
* activation: an installed plan before the config's ``fault_plan``, the
  config's parse cached per text, ``maybe_inject`` a no-op without one.
"""

import json
import threading
import time

import pytest

from torchdistx_tpu import chaos as jax_chaos
from torchdistx_tpu.observe import flightrec as jax_flightrec
from torchdistx_tpu_torch import chaos, config, observe
from torchdistx_tpu_torch.observe import flightrec

PLANS = [
    "serve@2=raise;serve@4=slow:0.01",
    "serve@3=raise:chunk;serve@5=raise:verify",
    "compile@1=raise x2;lower@1=slow:0.5",
    "fleet@2=flap:0.3;fleet@1=flap",
    "step@4=hang:3600; save@2=corrupt:flip ;restore@1=corrupt",
    "rollover@2=preempt;reshard@3=corrupt:truncate;registry@1=raise x3",
    "cache@1=corrupt;execute@2=slow",
]


def _entries(plan):
    return [(f.site, f.step, f.kind, f.arg, f.count, f.remaining, f.spec())
            for f in plan.faults]


@pytest.mark.parametrize("text", PLANS)
def test_plan_texts_parse_alike(text):
    ours, theirs = chaos.parse_plan(text), jax_chaos.parse_plan(text)
    assert _entries(ours) == _entries(theirs)
    assert repr(ours) == repr(theirs)
    assert chaos.SITES == jax_chaos.SITES and chaos.KINDS == jax_chaos.KINDS


@pytest.mark.parametrize("text", [
    "serve@2", "nowhere@1=raise", "serve@1=explode", "serve@1=raise x0",
    "fleet@1=flap:1.5", "serve@x=raise",
])
def test_bad_plan_texts_fail_alike(text):
    with pytest.raises(ValueError):
        jax_chaos.parse_plan(text)
    with pytest.raises(ValueError):
        chaos.parse_plan(text)


@pytest.mark.parametrize("text", [
    "fleet@2=flap:0.5", "fleet@2=flap:0.3", "fleet@2=flap:0.25",
    "fleet@2=flap", "fleet@2=flap:1.0", "fleet@2=raise x3",
    "fleet@2=raise;fleet@2=flap:0.75",
])
def test_take_fires_on_the_same_calls(text):
    ours, theirs = chaos.parse_plan(text), jax_chaos.parse_plan(text)
    fired = []
    for plan in (ours, theirs):
        fired.append([[f.spec() for f in plan.take("fleet", 2)]
                      for _ in range(64)])
        assert plan.take("fleet", 1) == [] and plan.take("serve", 2) == []
    assert fired[0] == fired[1]
    assert ours.fired == theirs.fired
    assert [f.spec() for f in ours.pending()] == \
        [f.spec() for f in theirs.pending()]
    assert bool(ours) == bool(theirs)


def test_flap_duty_cycle_fires_its_fraction():
    plan = chaos.parse_plan("serve@1=flap:0.25")
    hits = [bool(plan.take("serve", 1)) for _ in range(64)]
    assert sum(hits) == 16 and hits[3] and not any(hits[:3])
    assert plan.pending()  # a flap entry is never spent


@pytest.fixture
def telemetry(tmp_path):
    observe.enable(True)
    observe.reset()
    try:
        with config.override(flight_dir=str(tmp_path)):
            yield tmp_path
    finally:
        observe.enable(None)
        observe.reset()


@pytest.mark.parametrize("text", ["serve@1=raise", "serve@1=flap:1.0"])
def test_raise_and_flap_raise_the_injected_error(telemetry, text):
    fault = chaos.parse_plan(text).faults[0]
    before = observe.counter("tdx.chaos.injected", kind=fault.kind).value
    with pytest.raises(chaos.InjectedRuntimeError, match="chaos: injected"):
        chaos.execute(fault)
    assert observe.counter("tdx.chaos.injected",
                           kind=fault.kind).value == before + 1
    assert issubclass(chaos.ReplicaPreempted, chaos.InjectedRuntimeError)
    (bundle,) = sorted(telemetry.glob("flight-*-chaos_injected.json"))
    doc = json.loads(bundle.read_text())
    assert doc["context"]["spec"] == fault.spec()
    assert flightrec.validate(doc) == [] and jax_flightrec.validate(doc) == []
    assert doc["env"]["torch"] and "jax" not in doc["env"]
    assert any(e.get("name") == "chaos.injected" for e in doc["events"])


def test_slow_sleeps_and_cancel_event_cuts_a_hang():
    t = time.perf_counter()
    chaos.execute(chaos.parse_plan("serve@1=slow:0.05").faults[0])
    assert time.perf_counter() - t >= 0.05
    ev, took = threading.Event(), []

    def worker():
        chaos.set_cancel_event(ev)
        t0 = time.perf_counter()
        chaos.execute(chaos.parse_plan("serve@1=hang:30").faults[0])
        took.append(time.perf_counter() - t0)

    th = threading.Thread(target=worker)
    th.start()
    time.sleep(0.1)
    ev.set()
    th.join(timeout=5)
    assert not th.is_alive() and took and took[0] < 5


def _checkpoint(path):
    """A committed checkpoint of the port's and the JAX package's shape:
    two payload files, the larger the damage's victim."""
    path.mkdir()
    (path / "big.bin").write_bytes(bytes(range(256)) * 8)
    (path / "small.bin").write_bytes(b"x" * 16)
    return path


def _registry(path):
    """A registry tree: two complete entries and an in-flight publish."""
    for key in ("k1", "k2"):
        (path / key).mkdir(parents=True)
        (path / key / "meta.json").write_text("{}")
        (path / key / "lib.so").write_bytes(bytes(range(256)) * (3 + len(key)))
        (path / key / "lib.log").write_bytes(b"ptxas info" * 4)
    (path / ".tmp-pub-k3").mkdir()
    (path / ".tmp-pub-k3" / "lib.so").write_bytes(b"half" * 8)
    return path


@pytest.mark.parametrize("site,item", [
    ("save", "A12"), ("restore", "A12"), ("reshard", "A12"),
    ("cache", "A8"), ("registry", "A8"), ("compile", "A13"),
])
def test_corrupt_names_the_unported_target(site, item, tmp_path):
    """``corrupt`` damages what the port has: at ``save`` / ``restore``
    the checkpoint's largest payload file, byte for byte as the JAX
    executor damages it (flip), at ``reshard`` nothing on disk (the
    engine flips its in-flight chunk); at ``registry`` every complete
    entry's payload and at ``cache`` every installed kernel library, the
    bytes the JAX executor leaves in its registry and its compile
    cache's entries; elsewhere it names the ROADMAP item that ports its
    target."""
    fault = chaos.parse_plan(f"{site}@1=corrupt:flip").faults[0]
    jax_fault = jax_chaos.parse_plan(f"{site}@1=corrupt:flip").faults[0]
    if item == "A13":
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            chaos.execute(fault)
        return
    if site == "registry":
        ours, theirs = _registry(tmp_path / "a"), _registry(tmp_path / "b")
        chaos.execute(fault, path=str(ours))
        jax_chaos.execute(jax_fault, path=str(theirs))
        files = sorted(p.relative_to(theirs) for p in theirs.rglob("*")
                       if p.is_file())
        assert sorted(p.relative_to(ours) for p in ours.rglob("*")
                      if p.is_file()) == files
        for rel in files:
            assert (ours / rel).read_bytes() == (theirs / rel).read_bytes()
        assert (ours / ".tmp-pub-k3" / "lib.so").read_bytes() == b"half" * 8
        assert (ours / "k1" / "lib.so").read_bytes() != bytes(range(256)) * 5
        with pytest.raises(ValueError, match="target path"):
            chaos.execute(fault)
        return
    if site == "cache":
        (tmp_path / "a").mkdir()
        (tmp_path / "b").mkdir()
        payloads = {"flash": bytes(range(256)) * 7, "paged": b"\x01" * 300}
        loaded = {}
        for name, data in payloads.items():
            (tmp_path / "a" / f"{name}.so").write_bytes(data)
            (tmp_path / "b" / f"{name}-cache").write_bytes(data)
            loaded[name] = open(tmp_path / "a" / f"{name}.so", "rb")
        (tmp_path / "a" / "flash.log").write_bytes(b"log")
        chaos.execute(fault, path=str(tmp_path / "a"))
        jax_chaos.execute(jax_fault, path=str(tmp_path / "b"))
        for name, data in payloads.items():
            got = (tmp_path / "a" / f"{name}.so").read_bytes()
            assert got == (tmp_path / "b" / f"{name}-cache").read_bytes()
            assert sum(a != b for a, b in zip(got, data)) == 1
            # A new file took the name: what a process opened (or
            # mapped) before the damage still reads the old bytes.
            assert loaded.pop(name).read() == data
        assert (tmp_path / "a" / "flash.log").read_bytes() == b"log"
        return
    ours, theirs = _checkpoint(tmp_path / "a"), _checkpoint(tmp_path / "b")
    before = (ours / "big.bin").read_bytes()
    chaos.execute(fault, path=str(ours))
    jax_chaos.execute(jax_fault, path=str(theirs))
    for name in ("big.bin", "small.bin"):
        assert (ours / name).read_bytes() == (theirs / name).read_bytes()
    after = (ours / "big.bin").read_bytes()
    if site == "reshard":
        assert after == before
    else:
        assert sum(a != b for a, b in zip(after, before)) == 1
        with pytest.raises(ValueError, match="target path"):
            chaos.execute(fault)


def test_activation_order_and_the_config_cache():
    chaos.clear()
    try:
        assert chaos.active_plan() is None
        assert chaos.maybe_inject("serve", 1) == []
        with config.override(fault_plan="serve@1=slow:0.001"):
            plan = chaos.active_plan()
            assert plan is chaos.active_plan()  # parsed once per text
            assert [f.spec() for f in chaos.maybe_inject("serve", 1)] == \
                ["serve@1=slow:0.001"]
            installed = chaos.install("serve@2=raise")
            assert chaos.active_plan() is installed
            with pytest.raises(chaos.InjectedRuntimeError):
                chaos.maybe_inject("serve", 2)
            chaos.install(None)
            assert chaos.active_plan() is plan
        pinned = chaos.parse_plan("serve@3=slow:0.001")
        assert chaos.maybe_inject("serve", 3, plan=pinned)
    finally:
        chaos.clear()
