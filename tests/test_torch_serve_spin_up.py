"""Replica bring-up through deferred init on the CPU, and the features the
port once refused (prefix cache, speculation, prompts past the largest
bucket) now serving.

Kept apart from ``test_torch_serve.py`` so that neither file holds more
than 9 tests: pytest-xdist's ``--dist loadfile`` starts the files with
the most tests first, and the JAX package's longest files hold few
(``test_rollover.py`` 9), so a slow port file of more than 9 would start
before them and delay them.
"""

import numpy as np
import pytest
import torch

from torchdistx_tpu_torch.serve import (
    Request,
    ServeConfig,
    oracle_generate,
    spin_up_replica,
)
from test_torch_serve import SERVE, Pair

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["llama", "gpt2"])
def pair(request):
    return Pair(request.param)


def test_unported_features_raise(pair):
    """What the port once refused now serves: ``prefix_cache=True`` and
    ``spec_decode=True`` construct an engine, and a prompt longer than
    the largest bucket prefills in chunks, equal to the JAX oracle."""
    for knobs in (dict(prefix_cache=True), dict(spec_decode=True)):
        eng = pair.engine(**knobs, **SERVE)
        for name, value in knobs.items():
            assert getattr(eng.scfg, name) is value
    eng = pair.engine(**SERVE)
    req = Request("long", [(5 * i + 1) % 128 for i in range(17)],
                  max_new_tokens=2)
    out = eng.run([req])
    assert eng.prefill_chunks == 2  # 16 + 1 tokens through chunk-16/-8
    pair.check_against_jax_oracle(eng, [req], out)


def test_spin_up_replica_on_cpu_serves():
    """Bring-up through deferred init onto the CPU (asked for), then
    serving equal to the port's oracle; without CUDA the default device
    raises instead of falling back."""
    eng = spin_up_replica("tiny", device="cpu", seed=3,
                          serve_cfg=ServeConfig(**SERVE))
    assert all(p.device.type == "cpu" for p in eng.model.parameters())
    reqs = [Request("t0", [4, 8, 15, 16], max_new_tokens=5),
            Request("t1", [23, 42], max_new_tokens=4)]
    out = eng.run(reqs)
    for r in reqs:
        want, logits = oracle_generate(eng.model, r.tokens, r.max_new_tokens)
        assert out[r.rid] == want
        np.testing.assert_allclose(eng.final_logits[r.rid], logits, atol=1e-4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            spin_up_replica("tiny")
