"""The port's telemetry (``torchdistx_tpu_torch.observe`` and
``config``) held against the JAX package's:

* one call sequence — spans nested within a thread and across threads,
  an instant, labelled counters, a gauge, a histogram, then ``flush`` to
  a trace directory and a ``.prom`` path — gives the same Chrome-trace
  events in both (names, categories, phases and args; timestamps,
  durations, self-times, pids, tids and the trace id masked; events
  sorted, since threads interleave) and the same Prometheus text;
* ``StepMeter`` on a fixed clock derives the same tokens/s, TFLOP/s and
  MFU (the port's ``flops_source="counted"`` is the JAX ``"xla"``: a
  measured count);
* ``make_train_step`` with telemetry on, on the CPU: one ``train.step``
  span per step with ``tokens_per_s``, no MFU (the CPU has no peak); with
  a peak patched in, ``tdx.train.mfu`` from the counted FLOPs, which equal
  the hand count exactly — 6 per matmul weight per token plus the plain
  attention's full square, 12·L·B·H·S²·D, or with the flash attention
  function 12·D per visible (query, key) pair, causal and packed.
"""

import json
import re
import threading

import numpy as np
import pytest
import torch

import torchdistx_tpu.observe as jax_observe
import torchdistx_tpu.observe.step as jax_step
from torchdistx_tpu_torch import deferred_init, materialize_module
from torchdistx_tpu_torch import observe
from torchdistx_tpu_torch.models import TINY, make_llama
from torchdistx_tpu_torch.models.layers import Linear
from torchdistx_tpu_torch.observe import step as port_step
from torchdistx_tpu_torch.ops import make_flash_attention
from torchdistx_tpu_torch.ops.flash_attention import visible_pairs
from torchdistx_tpu_torch.parallel import make_train_step
from torchdistx_tpu_torch.parallel.train import train_step_flops

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)

MASKED = ("ts", "dur", "pid", "tid")


@pytest.fixture
def both():
    for obs in (jax_observe, observe):
        obs.reset()
        obs.enable(True)
    yield
    for obs in (jax_observe, observe):
        obs.reset()
        obs.enable(None)


def _drive(obs, tmp) -> dict:
    with obs.span("outer", category="train", step=1) as sp:
        with obs.span("inner", category="train", size=3):
            obs.instant("mark", category="tdx", k="v")
        sp.set(extra=2)

    def work(i):
        with obs.span("thread.work", category="tdx", i=i):
            with obs.span("thread.inner"):
                pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    obs.counter("tdx.test.count", kind="a").inc(3)
    obs.counter("tdx.test.count", kind="b").inc()
    obs.gauge("tdx.test.gauge").set(1.5)
    hist = obs.histogram("tdx.test.hist", buckets=(0.1, 1.0))
    hist.observe(0.05)
    hist.observe(2.0, n=3)
    return obs.flush(trace_dir=str(tmp / "trace"),
                     metrics_path=str(tmp / "metrics.prom"))


def _events(path) -> list:
    out = []
    for e in json.load(open(path))["traceEvents"]:
        e = {k: v for k, v in e.items() if k not in MASKED}
        args = dict(e.get("args", {}))
        args.pop("self_us", None)
        if e["name"] == "process_name":
            args["name"] = re.sub(r"pid=\d+", "pid=", args["name"])
        if e["name"] == "process_labels":
            args["labels"] = "trace="
        e["args"] = args
        out.append(json.dumps(e, sort_keys=True))
    return sorted(out)


def test_trace_and_prometheus_match_jax(both, tmp_path):
    got = _drive(observe, tmp_path / "port")
    want = _drive(jax_observe, tmp_path / "jax")
    assert set(got) == set(want) == {"trace", "metrics"}
    port_events = _events(got["trace"])
    assert port_events == _events(want["trace"])
    assert sum('"name": "thread.work"' in e for e in port_events) == 3
    prom = open(got["metrics"]).read()
    assert prom == open(want["metrics"]).read()
    assert 'tdx_test_count{kind="a"} 3' in prom


class _Clock:
    def __init__(self, ticks):
        self.ticks = list(ticks)

    def perf_counter(self):
        return self.ticks.pop(0)


def test_step_meter_matches_jax(both, monkeypatch):
    derived = []
    for mod, obs, source in ((jax_step, jax_observe, "xla"),
                             (port_step, observe, "counted")):
        monkeypatch.setattr(mod, "time", _Clock([10.0, 10.25, 11.0, 11.5]))
        meter = mod.StepMeter(tokens_per_step=4096, flops_per_step=3e13,
                              peak_tflops=989.0, flops_source=source)
        for _ in range(2):
            meter.start()
            meter.stop()
        gauges = {r["name"]: r["value"] for r in obs.counters().snapshot()}
        derived.append((meter.steps, meter.total, gauges))
    assert derived[0] == derived[1]
    gauges = derived[1][2]
    assert gauges["tdx.train.tokens_per_s"] == 8192.0
    assert gauges["tdx.train.mfu"] == round(3e13 / 0.5 / 1e12 / 989.0, 4)


def _train_spans(attn_fn, segment_ids, monkeypatch, peak):
    if peak:
        # A microflop peak: the toy CPU step's MFU must not round to 0.
        monkeypatch.setattr(observe, "peak_tflops_for", lambda *a: 1e-6)
    cfg = TINY
    kw = {} if attn_fn is None else {"attn_fn": attn_fn}
    model = deferred_init(make_llama, cfg, device="cpu", **kw)
    torch.manual_seed(0)
    materialize_module(model, device="cpu")
    init_state, train_step, shard_batch = make_train_step(model, cfg,
                                                          device="cpu")
    state = init_state(model)
    tokens = shard_batch(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 16)))
    seg = None if segment_ids is None else torch.as_tensor(segment_ids)
    for _ in range(2):
        state, _ = train_step(state, tokens, seg)
    spans = [e for e in observe.tracer().drain()
             if e["ph"] == "X" and e["name"] == "train.step"]
    gauges = {r["name"]: r["value"] for r in observe.counters().snapshot()}
    return model, cfg, spans, gauges


def test_instrumented_step_on_cpu_has_no_mfu(both, monkeypatch):
    _, _, spans, gauges = _train_spans(None, None, monkeypatch, peak=False)
    assert [s["args"]["step"] for s in spans] == [0, 1]
    assert all(s["args"]["tokens_per_s"] > 0 for s in spans)
    assert "flops_counted" in spans[0]["args"]
    assert not any("mfu" in s["args"] for s in spans)
    assert gauges["tdx.train.tokens_per_s"] > 0
    assert "tdx.train.mfu" not in gauges and "tdx.train.mfu_est" not in gauges


SEGMENTS = np.array([[0] * 6 + [1] * 7 + [-1] * 3, [0] * 16])


@pytest.mark.parametrize("attn,segments", [
    ("plain", False), ("flash", False), ("flash", True)])
def test_counted_flops_equal_the_hand_count(both, monkeypatch, attn, segments):
    attn_fn = make_flash_attention() if attn == "flash" else None
    seg = SEGMENTS if segments else None
    model, cfg, spans, gauges = _train_spans(attn_fn, seg, monkeypatch,
                                             peak=True)
    B, S, D = 2, 16, cfg.head_size
    n = sum(m.weight.numel() for m in model.modules() if isinstance(m, Linear))
    if attn == "plain":  # QKᵀ and PV over the full square, fwd + bwd
        attn_flops = 12 * cfg.n_layers * B * cfg.n_heads * S * S * D
    else:  # 12·D per visible pair: causal, and within a segment
        if seg is None:
            rows = [S * (S + 1) // 2] * B
        else:  # row 0: documents of 6 and 7 and a padded tail of 3
            rows = [6 * 7 // 2 + 7 * 8 // 2 + 3 * 4 // 2, S * (S + 1) // 2]
        pairs = cfg.n_heads * sum(rows)
        q = torch.empty(B * cfg.n_heads, S, D)
        k = torch.empty(B * cfg.kv_heads, S, D)
        s_ids = None if seg is None else torch.as_tensor(seg)
        assert visible_pairs(q, k, True, s_ids, s_ids) == pairs
        attn_flops = 12 * cfg.n_layers * D * pairs
    assert spans[0]["args"]["flops_counted"] == 6 * n * B * S + attn_flops
    if attn == "flash" and not segments:
        assert spans[0]["args"]["flops_counted"] == pytest.approx(
            train_step_flops(model, cfg, B, S), rel=1 / S)
    assert "mfu" in spans[1]["args"] and gauges["tdx.train.mfu"] > 0
