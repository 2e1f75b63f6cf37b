"""The port's profiling hooks (``utils/profiling.py`` over ``torch.profiler``)
and host→device link probe (``observe/costmodel.link_bandwidth_gbps``) on
the CPU path, as ``tests/test_costmodel.py``'s link-probe and
materialize-accounting cases run the JAX package's: the probe measures
and caches, the materializer's span carries bytes, GB/s and (with the
probe cached) the link utilization, and a trace names its annotation."""

import json
import warnings

import pytest
import torch

from torchdistx_tpu_torch import observe
from torchdistx_tpu_torch.cuda_bridge.materialize import materialize_params_cuda
from torchdistx_tpu_torch.deferred_init import deferred_init
from torchdistx_tpu_torch.observe import costmodel
from torchdistx_tpu_torch.utils import StepTimer, Timer, annotate, profiling, trace

torch.set_num_threads(2)


@pytest.fixture
def telemetry():
    observe.reset()
    costmodel.reset_link_probe()
    observe.enable(True)
    yield
    observe.enable(None)
    observe.reset()
    costmodel.reset_link_probe()


def _snap():
    return {(r["name"], tuple(sorted((r.get("labels") or {}).items()))):
            r.get("value") for r in observe.counters().snapshot()}


def test_link_probe_measures_caches_and_resets(telemetry, monkeypatch):
    assert costmodel.link_bandwidth_gbps(cached_only=True) is None
    bw = costmodel.link_bandwidth_gbps(probe_mb=4)
    assert bw is not None and bw > 0
    assert costmodel.link_probe_size_mb() == 4
    assert costmodel.link_bandwidth_gbps() == bw  # cached
    assert costmodel.link_bandwidth_gbps(cached_only=True) == bw
    snap = _snap()
    assert snap[("tdx.cuda.link_bandwidth_gbps", ())] == round(bw, 3)
    assert snap[("tdx.cuda.link_bandwidth_gbps", (("probe_mb", "4"),))] > 0
    costmodel.note_program_memory({"peak_bytes": 100.0})
    costmodel.reset_link_probe()  # forgets the probe and the high-water
    assert costmodel.link_probe_size_mb() is None
    assert costmodel.link_bandwidth_gbps(cached_only=True) is None
    # The sweep comes from TDX_LINK_PROBE_MB (one size or a list).
    monkeypatch.setenv("TDX_LINK_PROBE_MB", "1,2")
    assert costmodel._probe_sizes_mb(None) == (1, 2)
    assert costmodel._probe_sizes_mb(8) == (8,)
    assert costmodel.link_bandwidth_gbps() > 0
    assert costmodel.link_probe_size_mb() in (1, 2)


def test_materialize_span_bytes_rate_and_utilization(telemetry):
    # Nothing probed inside the materializer: without a cached probe the
    # span has no utilization.
    m = deferred_init(torch.nn.Linear, 16, 8)
    materialize_params_cuda({"weight": m.weight, "bias": m.bias},
                            device="cpu")
    assert costmodel.link_bandwidth_gbps(cached_only=True) is None
    (first,) = [e for e in observe.tracer().events
                if e["ph"] == "X" and e["name"] == "materialize"]
    assert first["args"]["bytes"] == (16 * 8 + 8) * 4
    assert first["args"]["gbps"] > 0
    assert "link_utilization" not in first["args"]
    # With the probe warmed first, utilization = gbps / link.
    lbw = costmodel.link_bandwidth_gbps(probe_mb=4)
    materialize_params_cuda({"weight": m.weight, "bias": m.bias},
                            device="cpu", param_dtype=torch.bfloat16)
    second = [e for e in observe.tracer().events
              if e["ph"] == "X" and e["name"] == "materialize"][-1]
    assert second["args"]["bytes"] == (16 * 8 + 8) * 2
    assert second["args"]["link_utilization"] == pytest.approx(
        second["args"]["gbps"] / lbw)
    snap = _snap()
    assert snap[("tdx.cuda.bytes_materialized", ())] == (16 * 8 + 8) * 6
    assert snap[("tdx.cuda.materialize_gbps", ())] > 0
    assert snap[("tdx.cuda.link_utilization", ())] > 0


def test_trace_names_its_annotation_and_ops(tmp_path):
    with trace(str(tmp_path)):
        with annotate("tdx.step"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    path = profiling.last_trace_path()
    assert path and path.startswith(str(tmp_path))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "tdx.step" in names
    assert any(n and "mm" in n for n in names)


def test_deprecated_timer_shims(telemetry):
    with pytest.warns(DeprecationWarning, match="observe.span"):
        t = Timer()
    with t:
        t.block_on(torch.ones(3) * 2)
    assert t.elapsed is not None and t.elapsed >= 0
    assert any(e["name"] == "utils.Timer" for e in observe.tracer().events)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(DeprecationWarning, match="StepMeter"):
            StepTimer()
    with pytest.warns(DeprecationWarning):
        st = StepTimer()
    st.start()
    st.stop()
    assert st.steps == 1
