"""Speculation through page-exhaustion preemption against the JAX
reference, and the engine's lifecycle: cancel, deadlines, drain,
``install_params``, ``release_kv``.

Kept apart from ``test_torch_serve_features.py`` so that neither file
holds more than 9 tests: pytest-xdist's ``--dist loadfile`` starts the
files with the most tests first, and the JAX package's longest files
hold few (``test_rollover.py`` 9), so a slow port file of more than 9
would start before them and delay them.
"""

import time

import pytest

from torchdistx_tpu_torch.serve import Request, oracle_generate
from test_torch_serve_features import FEAT, PREAMBLE, TIGHT, Pair


@pytest.fixture(scope="module", params=["llama", "gpt2"])
def pair(request):
    return Pair(request.param)


def test_spec_through_preemption_matches_jax_oracle(pair):
    eng = pair.engine(**TIGHT)
    reqs = [Request("pp0", [7] * 6, max_new_tokens=8),
            Request("pp1", [7, 7, 7, 9, 9, 9], max_new_tokens=8)]
    out = eng.run(reqs)
    assert eng.preemptions > 0 and eng.spec_drafted > 0
    pair.check(eng, reqs, out)
    eng.drain()
    assert eng.kv.pages_in_use == 0


def test_cancel_frees_pages_and_spares_the_survivor(pair):
    eng = pair.engine(**FEAT)
    keep = Request("keep", [5, 9, 2], max_new_tokens=6)
    drop = Request("drop", [17, 3, 3, 8, 1], max_new_tokens=6)
    eng.submit(keep)
    eng.submit(drop)
    eng.step()
    eng.step()
    held = eng.kv.pages_in_use
    toks = eng.cancel("drop")
    assert toks and eng.cancelled["drop"] == toks
    assert eng.kv.pages_in_use < held
    assert eng.cancel("nobody") is None
    out = eng.run()
    assert "drop" not in out
    pair.check(eng, [keep], out)


def test_past_deadline_expires_and_calls_on_cancel(pair):
    told = []
    eng = pair.engine(**FEAT)
    eng.on_cancel = lambda rid, toks, active: told.append((rid, active))
    late = Request("late", [4, 8, 15], max_new_tokens=6, deadline_s=0.0)
    eng.submit(late)
    time.sleep(0.01)
    out = eng.run()
    assert "late" not in out and told == [("late", False)]
    assert eng.kv.pages_in_use == 0


def test_install_params_in_place_and_release_kv(pair):
    eng = pair.engine(**FEAT)
    r = Request("w0", PREAMBLE + [1, 2], max_new_tokens=3)
    eng.submit(r)
    eng.step()
    with pytest.raises(RuntimeError, match="active"):
        eng.install_params(pair.model.state_dict())
    eng.run()
    assert len(eng.prefix) == 1
    ptrs = [p.data_ptr() for p in pair.model.parameters()]
    new = {k: v * 1.5 for k, v in pair.model.state_dict().items()}
    old = {k: v.clone() for k, v in pair.model.state_dict().items()}
    try:
        eng.install_params(new, version="x1.5")
        assert len(eng.prefix) == 0 and eng.weight_version == "x1.5"
        assert [p.data_ptr() for p in pair.model.parameters()] == ptrs
        r2 = Request("w1", PREAMBLE + [1, 2], max_new_tokens=3)
        out = eng.run([r2])
        want, _ = oracle_generate(pair.model, r2.tokens, 3)
        assert out["w1"] == want
    finally:
        pair.model.load_state_dict(old)
    eng.drain()
    eng.release_kv()
    assert eng.k_pages is None and eng.kv.pages_in_use == 0
    assert eng.results["w0"]
    with pytest.raises(RuntimeError, match="release_kv"):
        eng.run([Request("w2", [1, 2, 3], max_new_tokens=2)])
