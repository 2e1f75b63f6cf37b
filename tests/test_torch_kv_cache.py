"""The port's page allocator held against the JAX package's, behaviorally:
one random operation sequence (made from a seed) goes into both
``PagedKVCache`` classes, and after every operation both must return the
same result — or raise the same error — and hold identical free lists,
page tables and refcounts."""

import random

import numpy as np
import pytest
import torch

from torchdistx_tpu.serve.kv_cache import KVCacheConfig as JaxKVConfig
from torchdistx_tpu.serve.kv_cache import PagedKVCache as JaxCache
from torchdistx_tpu_torch.serve.kv_cache import (
    KVCacheConfig,
    OutOfPages,
    PagedKVCache,
    init_pools,
)

# Six xdist workers share the machine's cores: keep torch's intra-op
# pool small so they do not oversubscribe it.
torch.set_num_threads(2)

SHAPE = dict(n_layers=2, kv_heads=2, head_dim=8, page_size=4, n_pages=12)
MAX_PAGES = 8


def _state(cache):
    return (
        list(cache._free),
        {sid: (list(s.pages), s.length) for sid, s in cache._seqs.items()},
        dict(cache._ref),
    )


def _apply(cache, op):
    name, args = op
    try:
        out = getattr(cache, name)(*args)
    except Exception as e:  # noqa: BLE001 — the error IS the result compared
        return ("raised", type(e).__name__)
    if isinstance(out, np.ndarray):
        return ("rows", out.tolist())
    return ("ok", out)


def _next_op(rng, cache, next_id):
    """One random operation on the sequences ``cache`` holds now (both
    caches hold the same ones while the test passes)."""
    live = sorted(cache._seqs)
    kind = rng.choice(["alloc", "alloc", "extend", "extend", "free",
                       "table_rows", "table_rows", "rollback",
                       "alloc_shared", "cow_page"])
    if kind == "alloc" or not live:
        return ("alloc", (next_id, rng.randint(0, 30)))
    sid = rng.choice(live)
    if kind == "extend":
        return ("extend", (sid, cache.length(sid) + rng.randint(0, 12)))
    if kind == "free":
        return ("free", (sid,))
    if kind == "table_rows":
        return ("table_rows", (rng.sample(live, min(3, len(live))), MAX_PAGES))
    if kind == "rollback":
        return ("rollback", (sid, rng.randint(0, cache.length(sid))))
    if kind == "alloc_shared":
        # Share the donor's leading page (the prefix-cache admission path).
        return ("alloc_shared", (next_id, cache.page_ids(sid)[:1],
                                 rng.randint(0, 30)))
    return ("cow_page", (sid, rng.randint(0, max(0, len(cache.page_ids(sid)) - 1))))


@pytest.mark.parametrize("seed", range(6))
def test_random_op_sequence_matches_jax(seed):
    ours, theirs = PagedKVCache(KVCacheConfig(**SHAPE)), JaxCache(
        JaxKVConfig(**SHAPE))
    rng = random.Random(seed)
    saw = set()
    next_id = 1
    for i in range(300):
        op = _next_op(rng, ours, next_id)
        if op[0].startswith("alloc"):
            next_id += 1
        got = _apply(ours, op)
        want = _apply(theirs, op)
        # Exception classes are distinct objects in the two packages:
        # compare by name (OutOfPages, ValueError, ...).
        assert got == want, (i, op, got, want)
        assert _state(ours) == _state(theirs), (i, op)
        saw.add(got[1] if got[0] == "raised" else op[0])
    assert {"OutOfPages", "table_rows", "free", "extend"} <= saw, saw


def test_out_of_pages_changes_nothing():
    cache = PagedKVCache(KVCacheConfig(**SHAPE))
    cache.alloc(1, 40)  # 10 of 11 usable pages
    before = _state(cache)
    with pytest.raises(OutOfPages):
        cache.alloc(2, 8)
    with pytest.raises(OutOfPages):
        cache.extend(1, 48)
    assert _state(cache) == before


def test_init_pools_shape_and_device():
    cfg = KVCacheConfig(**SHAPE)
    k, v = init_pools(cfg, torch.bfloat16, "cpu")
    assert k.shape == v.shape == (2, 12, 4, 2, 8)
    assert k.dtype == torch.bfloat16 and not k.any()
    assert k.data_ptr() != v.data_ptr()
