"""The port's flash launch-shape tuner (``torchdistx_tpu_torch.ops.autotune``)
against the JAX package's: the cases of ``tests/test_autotune.py`` with an
injected ``_measure`` (the same timing table picks the same winner in both
packages), the cache contract through the real config layer, the refusal
classification, and the launch-shape validation of ``flash_attention``.
``_measure`` against the real kernels is in ``test_torch_autotune_card.py``
(a card test in a file that imports no JAX)."""

import importlib
import json
import os

import pytest
import torch

import torchdistx_tpu.config as jax_config
import torchdistx_tpu_torch.config as port_config
from torchdistx_tpu.ops import autotune as jax_autotune
from torchdistx_tpu_torch.ops import autotune
from torchdistx_tpu_torch.ops import flash_attention as port_flash_fn
from torchdistx_tpu_torch.ops.autotune import BlockConfigError, tune_flash_blocks
from torchdistx_tpu_torch.ops.flash_attention import built_blocks, launch_warps

torch.set_num_threads(2)
fa_mod = importlib.import_module("torchdistx_tpu_torch.ops.flash_attention")
SMALL = dict(batch=1, seq_len=64, heads=2, head_dim=16)


@pytest.fixture
def cache_dir(tmp_path):
    # Through the REAL _cache_path and config layer of both packages.
    with port_config.override(cache_dir=str(tmp_path / "port")), \
            jax_config.override(cache_dir=str(tmp_path / "jax")):
        yield tmp_path


def _table(table):
    """A ``_measure`` that reads each candidate's time from ``table``
    (keyed by the candidate its ``fn`` closes over); a value that is an
    exception class is raised."""
    def measure(fn, *a, **k):
        t = table[(fn.__kwdefaults__["bq"], fn.__kwdefaults__["bk"])]
        if isinstance(t, type) and issubclass(t, Exception):
            raise t("refused")
        return t

    return measure


TABLES = {
    "second_wins": {(16, 16): 2e-3, (32, 16): 1e-3, (64, 16): 3e-3},
    "first_wins": {(16, 16): 1e-4, (32, 16): 1e-3, (64, 16): 1e-3},
    "noise_loses": {(16, 16): float("inf"), (32, 16): 5e-3, (64, 16): 4e-3},
}


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("workload", ["fwd", "bwd"])
def test_same_table_same_winner(table, workload, cache_dir, monkeypatch):
    cands = tuple(TABLES[table])
    got = {}
    for name, mod, kw in (("jax", jax_autotune, {}),
                          ("port", autotune, {"device": "cpu"})):
        monkeypatch.setattr(mod, "_measure", _table(TABLES[table]))
        got[name] = mod.tune_flash_blocks(**SMALL, candidates=cands,
                                          workload=workload,
                                          use_cache=False, **kw)
    assert got["port"] == got["jax"]


def test_returns_candidate_and_caches(cache_dir, monkeypatch):
    cands = ((16, 16), (32, 16))
    monkeypatch.setattr(autotune, "_measure",
                        _table({(16, 16): 2.0, (32, 16): 1.0}))
    blocks = tune_flash_blocks(**SMALL, candidates=cands, device="cpu")
    assert blocks == (32, 16)
    path = autotune._cache_path()
    assert os.path.dirname(path) == str(cache_dir / "port")
    key = next(iter(json.load(open(path))))
    assert key.startswith("cpu|") and "bfloat16" in key
    assert "workload=fwd" in key
    # The second call hits the cache: measuring again would be a bug.
    monkeypatch.setattr(
        autotune, "_measure",
        lambda *a, **k: pytest.fail("re-measured despite a valid cache hit"))
    assert tune_flash_blocks(**SMALL, candidates=cands, device="cpu") == blocks
    # Another workload is another key.
    monkeypatch.setattr(autotune, "_measure",
                        _table({(16, 16): 1.0, (32, 16): 2.0}))
    assert tune_flash_blocks(**SMALL, candidates=cands, device="cpu",
                             workload="bwd") == (16, 16)


def test_cached_winner_outside_candidates_remeasures(cache_dir, monkeypatch):
    monkeypatch.setattr(autotune, "_measure",
                        _table({(16, 16): 1.0, (32, 32): 1.0}))
    tune_flash_blocks(**SMALL, candidates=((32, 32),), device="cpu")
    assert tune_flash_blocks(**SMALL, candidates=((16, 16),),
                             device="cpu") == (16, 16)


def test_edge_lists_raise_or_pick_as_the_jax_tuner(cache_dir, monkeypatch):
    for mod, kw in ((jax_autotune, {}), (autotune, {"device": "cpu"})):
        with pytest.raises(ValueError, match="candidate list is empty"):
            mod.tune_flash_blocks(**SMALL, candidates=(), use_cache=False,
                                  **kw)
        # Everything measured as noise: the smallest, not cached.
        monkeypatch.setattr(mod, "_measure", lambda *a, **k: float("inf"))
        blocks = mod.tune_flash_blocks(
            **{**SMALL, "seq_len": 64},
            candidates=((64, 64), (16, 16), (64, 16)), use_cache=True, **kw)
        assert blocks == (16, 16)
        assert not os.path.exists(mod._cache_path())
        # Every candidate refused: systemic, raised.
        monkeypatch.setattr(mod, "_measure",
                            _table({(64, 64): mod.BlockConfigError,
                                    (16, 16): mod.BlockConfigError}))
        with pytest.raises(mod.BlockConfigError):
            mod.tune_flash_blocks(**{**SMALL, "seq_len": 64},
                                  candidates=((64, 64), (16, 16)),
                                  use_cache=False, **kw)
    # Unlike the JAX tuner, no clamp to the sequence: a launch shape is a
    # CTA's row count, not a tile the sequence must fill.
    monkeypatch.setattr(autotune, "_measure",
                        _table({(64, 64): 2.0, (128, 64): 1.0}))
    assert tune_flash_blocks(**{**SMALL, "seq_len": 8},
                             candidates=((64, 64), (128, 64)),
                             use_cache=False, device="cpu") == (128, 64)


def test_refused_candidate_loses_to_one_that_runs(cache_dir, monkeypatch):
    """The real ``_measure`` on the CPU's plain version, with a
    flash_attention that refuses block_q = 32 as the card would."""
    real = fa_mod.flash_attention

    def gated(q, k, v, *a, block_q=None, block_k=None, **kw):
        if block_q == 32:
            raise BlockConfigError("too many resources requested for launch")
        return real(q, k, v, *a, **kw)

    monkeypatch.setattr(fa_mod, "flash_attention", gated)
    autotune.reset_counts()
    for workload in ("fwd", "bwd", "bias"):
        assert tune_flash_blocks(**SMALL, candidates=((32, 16), (16, 16)),
                                 use_cache=False, device="cpu",
                                 workload=workload) == (16, 16)
        assert autotune.last_timings[(32, 16)] == float("inf")
        assert 0 < autotune.last_timings[(16, 16)] < float("inf")
    assert autotune.measurements == 6


class _Boom:
    def __init__(self, exc):
        self.exc = exc

    def __call__(self, *carry):
        raise self.exc


def test_measure_classifies_failures(monkeypatch):
    q = k = v = torch.zeros(1, 8, 1, 16)
    # The card refusing the launch shape: a per-shape failure.
    for text in ("CUDA error 701 (too many resources requested for launch)",
                 "CUDA error 9 (invalid configuration argument)"):
        with pytest.raises(BlockConfigError):
            autotune._measure(_Boom(RuntimeError(text)), q, k, v)
    assert autotune._refusal_trigger(RuntimeError(
        "too many resources requested for launch")) == \
        "too many resources requested for launch"
    assert autotune._refusal_trigger(RuntimeError("connection reset")) is None
    # Anything else propagates: a broken program, or out of memory (no
    # launch shape fixes it).
    with pytest.raises(ValueError, match="head_dim"):
        autotune._measure(_Boom(ValueError("head_dim 48")), q, k, v)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        autotune._measure(_Boom(torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 12.00 GiB")), q, k, v)
    # A refusal first seen in the TIMED loop is still per-shape; anything
    # else there propagates.
    for exc, expect in ((RuntimeError("too many resources requested for "
                                      "launch"), BlockConfigError),
                        (RuntimeError("illegal memory access"), RuntimeError)):
        calls = {"n": 0}

        def scripted(fn, carry, n, exc=exc):
            calls["n"] += 1
            if calls["n"] > 2:  # both warm-ups succeed
                raise exc
            return carry

        monkeypatch.setattr(autotune, "_chain", scripted)
        with pytest.raises(expect):
            autotune._measure(lambda *c: c, q, k, v)
        assert calls["n"] == 3


def test_launch_shapes_are_validated():
    assert built_blocks(torch.bfloat16, 128) == ((64, 64), (128, 64))
    assert built_blocks(torch.bfloat16, 64) == ((64, 64),)
    assert built_blocks(torch.float32, 128) == ()
    for bq, bk in ((None, None), (1024, 1024), (None, 64), (1024, None)):
        assert launch_warps(bq, bk, torch.bfloat16, 128) == 0
    assert launch_warps(128, 64, torch.bfloat16, 128) == 8
    assert launch_warps(64, None, torch.bfloat16, 16) == 4
    for bq, bk, dt, d in ((128, 64, torch.bfloat16, 64),
                          (32, 64, torch.bfloat16, 128),
                          (64, 128, torch.bfloat16, 128),
                          (64, 64, torch.float32, 128)):
        with pytest.raises(BlockConfigError, match="built blocks"):
            launch_warps(bq, bk, dt, d)
    # On CPU operands a block means nothing and is not checked.
    q = torch.randn(1, 20, 2, 16)
    assert torch.equal(port_flash_fn(q, q, q, block_q=16, block_k=16),
                       port_flash_fn(q, q, q))
