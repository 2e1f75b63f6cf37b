"""The serving engine's error contract on the CPU (ROADMAP C5): a
non-retryable error (``ValueError``, ``torch.AcceleratorError``, a
``RuntimeError`` naming a CUDA error) propagates out of ``step`` with
its message and requeues nothing; ``torch.cuda.OutOfMemoryError``
requeues like the chaos error; ``spin_up_replica(device="cpu")`` walks
its health component through ``spin_up`` -> ``warming`` -> ``serving``
(the device still defaults to ``"cuda"``).

Kept apart from ``test_torch_serve_chaos.py`` so that neither file holds
more than 9 tests: pytest-xdist's ``--dist loadfile`` starts the files
with the most tests first, and the JAX package's longest files hold few
(``test_rollover.py`` 9), so a slow port file of more than 9 would start
before them and delay them.
"""

import inspect

import pytest
import torch

from test_torch_jax_oracle import SHAPES
from torchdistx_tpu_torch import observe
from torchdistx_tpu_torch.cuda_bridge.materialize import _retryable_errors
from torchdistx_tpu_torch.models import TransformerConfig
from torchdistx_tpu_torch.observe import health
from torchdistx_tpu_torch.serve import (
    Request,
    ServeConfig,
    ServeEngine,
    make_model,
    spin_up_replica,
)
from test_torch_serve_chaos import FAMILY, SERVE

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def small_model():
    tcfg = TransformerConfig(dtype=torch.float32, **SHAPES[FAMILY])
    torch.manual_seed(0)
    return tcfg, make_model(FAMILY, tcfg, device="cpu").eval()


def _one_lane_engine(small_model):
    tcfg, model = small_model
    eng = ServeEngine(FAMILY, tcfg, model, serve_cfg=ServeConfig(**SERVE),
                      device="cpu")
    eng.submit(Request("e", [5, 9, 2], max_new_tokens=4))
    eng.step()
    assert len(eng.active) == 1
    return eng


@pytest.mark.parametrize("error", [
    ValueError("not a device fault"),
    torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: device-side assert triggered"),
])
def test_non_retryable_errors_propagate_without_requeue(small_model, error):
    eng = _one_lane_engine(small_model)

    def boom():
        raise error

    eng._decode_step = boom
    with pytest.raises(type(error), match=str(error)):
        eng.step()
    assert len(eng.active) == 1 and eng.preemptions == 0
    assert not isinstance(error, _retryable_errors())


def test_out_of_memory_requeues_like_the_chaos_error(small_model):
    eng = _one_lane_engine(small_model)
    decode = eng._decode_step

    def oom_once():
        eng._decode_step = decode
        raise torch.cuda.OutOfMemoryError("CUDA out of memory.")

    eng._decode_step = oom_once
    eng.step()
    assert not eng.active and eng.preemptions == 1
    assert eng.kv.pages_in_use == 0
    assert eng.run()["e"]


def test_spin_up_walks_the_health_states():
    assert inspect.signature(spin_up_replica).parameters[
        "device"].default == "cuda"
    observe.enable(True)
    observe.reset()
    try:
        eng = spin_up_replica("tiny", device="cpu", serve_cfg=ServeConfig(
            max_batch=2, page_size=8, n_pages=16, max_pages_per_seq=3,
            prefill_buckets=(8,)), health_component="chaos-test",
            slo_name="chaos-slo")
        walked = [e["args"]["state"] for e in observe.tracer().events
                  if e.get("name") == "chaos-test.state"]
        assert walked == ["spin_up", "warming", "serving"]
        assert health.snapshot()["states"]["chaos-test"]["state"] == "serving"
        assert health.readiness()[0] or "chaos-test" not in \
            health.readiness()[1].get("not_ready", {})
        assert eng.slo.name == "chaos-slo"
    finally:
        observe.enable(None)
        health.clear_state("chaos-test")
