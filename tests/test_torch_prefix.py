"""The port's prefix cache and n-gram drafter held against the JAX
package's host classes, operation by operation.

``PrefixCache`` over the port's ``PagedKVCache`` and the JAX
``PrefixCache`` over the JAX one take the same random sequence of
match / match_len / insert / evict / alloc / alloc_shared / extend /
cow / rollback / free / clear; after every operation the return values
(or the exception raised), every refcount, the free list, the page
count, the cached pages and the token streams must be equal.
``NgramDrafter`` takes the same random streams through observe / draft /
warm_from_prefix at a capacity small enough to fill.
"""

import random

import pytest

from torchdistx_tpu.serve import KVCacheConfig as JaxKVCacheConfig
from torchdistx_tpu.serve import NgramDrafter as JaxNgramDrafter
from torchdistx_tpu.serve import PagedKVCache as JaxPagedKVCache
from torchdistx_tpu.serve import PrefixCache as JaxPrefixCache
from torchdistx_tpu_torch.serve import (
    KVCacheConfig,
    NgramDrafter,
    PagedKVCache,
    PrefixCache,
)


class Twin:
    """The same object on both sides: every call goes to both and
    returns both outcomes, a value or the exception's type name."""

    def __init__(self, port, ref):
        self.port, self.ref = port, ref

    def __call__(self, method, *args, **kw):
        out = []
        for obj in (self.port, self.ref):
            try:
                out.append(getattr(obj, method)(*args, **kw))
            except Exception as e:  # noqa: BLE001 — compared, not hidden
                out.append(("raised", type(e).__name__))
        assert out[0] == out[1], (method, args, out)
        return out[0]


def _state(kv, tree):
    return (dict(kv._ref), list(kv._free), tree.page_count(),
            sorted(tree.pages()), sorted(tree.token_streams()),
            {sid: (kv.page_ids(sid), kv.length(sid)) for sid in kv._seqs},
            tree.lookups, tree.hits)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_prefix_cache_equals_jax_under_random_operations(seed):
    rng = random.Random(seed)
    page, n_pages = rng.choice([(2, 12), (4, 10), (4, 16)])
    kv = Twin(PagedKVCache(KVCacheConfig(n_layers=1, kv_heads=1, head_dim=4,
                                         page_size=page, n_pages=n_pages)),
              JaxPagedKVCache(JaxKVCacheConfig(n_layers=1, kv_heads=1,
                                               head_dim=4, page_size=page,
                                               n_pages=n_pages)))
    tree = Twin(PrefixCache(kv.port), JaxPrefixCache(kv.ref))
    prompts = {}  # sid -> tokens
    next_sid = 1
    # A small alphabet so prompts share prefixes and the tree branches.
    tokens = lambda n: [rng.randrange(3) for _ in range(n)]  # noqa: E731
    for _ in range(500):
        op = rng.random()
        live = sorted(prompts)
        if op < 0.25:  # admission: match, evict under pressure, alloc
            toks = tokens(rng.randrange(1, 4 * page))
            tree("match_len", toks)
            shared = tree("match", toks)
            need = kv.port.cfg.pages_for(len(toks)) - len(shared)
            while need > kv.port.free_pages and tree(
                    "evict", exclude=set(shared)):
                pass
            sid, next_sid = next_sid, next_sid + 1
            if shared:
                kv("alloc_shared", sid, shared, len(toks))
            else:
                kv("alloc", sid, len(toks))
            if kv.port.has(sid):
                prompts[sid] = toks
        elif op < 0.4 and live:  # a finished prefill publishes its pages
            sid = rng.choice(live)
            toks = prompts[sid]
            nfull = len(toks) // page
            tree("insert", toks[:nfull * page], kv.port.page_ids(sid)[:nfull])
        elif op < 0.5 and live:  # decode growth
            sid = rng.choice(live)
            kv("extend", sid, kv.port.length(sid) + rng.randrange(1, 5))
        elif op < 0.6 and live:  # copy-on-write before a write
            sid = rng.choice(live)
            if kv.port.page_ids(sid):
                kv("cow_page", sid,
                   rng.randrange(len(kv.port.page_ids(sid))))
        elif op < 0.7 and live:  # speculative rollback
            sid = rng.choice(live)
            kv("rollback", sid, rng.randrange(kv.port.length(sid) + 1))
        elif op < 0.82 and live:  # retirement / preemption
            sid = rng.choice(live)
            kv("free", sid)
            del prompts[sid]
        elif op < 0.95:
            tree("evict")
        else:
            tree("clear")
        assert _state(kv.port, tree.port) == _state(kv.ref, tree.ref)
        assert kv.port.shared_pages == kv.ref.shared_pages
        assert tree.port.hit_rate() == tree.ref.hit_rate()
    for sid in sorted(prompts):
        kv("free", sid)
    tree("clear")
    assert kv.port.pages_in_use == kv.ref.pages_in_use == 0


@pytest.mark.parametrize("order,cap", [(1, 6), (2, 12), (3, 1 << 16)])
def test_ngram_drafter_equals_jax_on_random_streams(order, cap):
    rng = random.Random(order * 31 + cap)
    d = Twin(NgramDrafter(order=order, max_entries=cap),
             JaxNgramDrafter(order=order, max_entries=cap))
    for _ in range(300):
        stream = [rng.randrange(5) for _ in range(rng.randrange(0, 12))]
        if rng.random() < 0.5:
            d("observe", stream)
        else:
            d("draft", stream, rng.randrange(0, 6))
        assert d.port._next == d.ref._next
        assert (d.port.observed, d.port.proposed) == (d.ref.observed,
                                                      d.ref.proposed)
        assert len(d.port) == len(d.ref) <= cap
    # Warm-up off a radix tree: the same streams, the same table.
    kv = Twin(PagedKVCache(KVCacheConfig(n_layers=1, kv_heads=1, head_dim=4,
                                         page_size=2, n_pages=32)),
              JaxPagedKVCache(JaxKVCacheConfig(n_layers=1, kv_heads=1,
                                               head_dim=4, page_size=2,
                                               n_pages=32)))
    tree = Twin(PrefixCache(kv.port), JaxPrefixCache(kv.ref))
    for sid in range(1, 5):
        toks = [rng.randrange(4) for _ in range(8)]
        kv("alloc", sid, len(toks))
        tree("insert", toks, kv.port.page_ids(sid))
    warm = Twin(NgramDrafter(order=order, max_entries=cap),
                JaxNgramDrafter(order=order, max_entries=cap))
    assert warm.port.warm_from_prefix(tree.port) == \
        warm.ref.warm_from_prefix(tree.ref)
    assert warm.port._next == warm.ref._next
