"""Copy-on-write prefix sharing: a radix tree over page-aligned token
blocks mapping cached prompt prefixes to live KV pages (the port's own
copy of ``torchdistx_tpu/serve/prefix.py``; host-only Python, the same
code).

Shared prompt prefixes (system prompts, few-shot preambles) dominate
serving traffic: without sharing, a thousand requests with one system
prompt pay its prefill a thousand times.  The paged pool's page-table
indirection (:mod:`.kv_cache`) makes the fix structural: K/V for a token
block lives in a page, a page id can appear in ANY sequence's table, and
the serving programs already gather through the table, so reusing a
cached prefix is host-side bookkeeping: no recompute, no program change.

This module is that bookkeeping.  A :class:`PrefixCache` is a radix
tree whose edges are ``page_size``-token blocks and whose nodes each
hold ONE pool page: the K/V of that block, prefilled once by whichever
sequence inserted it.  The cache owns one refcount reference per node
(:meth:`PagedKVCache.retain`), so cached pages survive their inserting
sequence's retirement; a sequence admitted through
:meth:`PagedKVCache.alloc_shared` adds its own reference per mapped
page.  The copy-on-write contract lives in the allocator
(:meth:`PagedKVCache.cow_page`): a grower about to write into a shared
page swaps in a private copy first, so a cached page's contents are
immutable while anyone else can read them.

Only FULL pages enter the tree (a partial tail page is still writable
by its owning sequence, so it can never be shared), which keeps every
match page-aligned by construction.  Eviction is LRU over leaf nodes,
driven by the engine under pool pressure: dropping a leaf releases one
page reference, never touches live sequences, and is always preferred
over preempting a running lane.

:meth:`match_len` is the router-affinity probe: a fleet controller may
call it across threads against a serving replica's live tree, so it
mutates nothing and treats any concurrent-mutation artifact as "no
match".

:class:`NgramDrafter` is the speculative-decoding proposer that rides
on top: a bounded host-side n-gram table fed by the same token streams
the tree caches (admitted prompts, each lane's own emitted tokens, and
:meth:`PrefixCache.token_streams` warmup straight off the radix tree),
proposing the k tokens most recently seen to follow the lane's current
tail.  No second model, no weights; drafts are free guesses the batched
``verify-<k>`` program checks, so a wrong draft costs a verify slot and
never a wrong token.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .kv_cache import PagedKVCache

__all__ = ["NgramDrafter", "PrefixCache"]


@dataclass
class _Node:
    """One cached token block: ``key`` is its ``page_size``-token edge,
    ``page`` the pool page holding its K/V."""

    key: Tuple[int, ...]
    page: int
    parent: Optional["_Node"]  # None for first-block nodes
    children: Dict[Tuple[int, ...], "_Node"] = field(default_factory=dict)
    last_used: int = 0


class PrefixCache:
    """Radix tree over page-aligned token prefixes; see the module
    docstring.  All mutation happens on the engine's serving thread;
    only :meth:`match_len` is read across threads."""

    def __init__(self, kv: PagedKVCache):
        self.kv = kv
        self.page_size = kv.cfg.page_size
        self._children: Dict[Tuple[int, ...], _Node] = {}
        self._tick = 0
        self._count = 0
        # Lookup/hit tallies for the live hit-rate gauge
        # (``tdx.serve.prefix_hit_rate``): one lookup per admission-path
        # :meth:`match`, a hit when any prefix page matched.
        self.lookups = 0
        self.hits = 0

    # -- queries ------------------------------------------------------------

    def __len__(self) -> int:
        return self._count

    def page_count(self) -> int:
        return self._count

    def pages(self) -> List[int]:
        """Every page the tree holds a reference on."""
        out: List[int] = []
        stack = list(self._children.values())
        while stack:
            n = stack.pop()
            out.append(n.page)
            stack.extend(n.children.values())
        return out

    def _blocks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        ps = self.page_size
        return [tuple(tokens[i:i + ps])
                for i in range(0, (len(tokens) // ps) * ps, ps)]

    def token_streams(self) -> List[List[int]]:
        """Every cached root→leaf prefix as one token stream (edge keys
        concatenated in order) — the drafter-warmup view: a fresh
        :class:`NgramDrafter` can absorb the preambles this tree already
        proved hot without re-reading any request."""
        out: List[List[int]] = []

        def walk(node: _Node, acc: List[int]) -> None:
            acc = acc + list(node.key)
            if node.children:
                for child in node.children.values():
                    walk(child, acc)
            else:
                out.append(acc)

        for n in self._children.values():
            walk(n, [])
        return out

    def match(self, tokens: Sequence[int]) -> List[int]:
        """The pages of the longest cached page-aligned prefix of
        ``tokens``, in order (possibly empty); touches the matched path
        for LRU."""
        self._tick += 1
        pages: List[int] = []
        children = self._children
        for key in self._blocks(tokens):
            node = children.get(key)
            if node is None:
                break
            node.last_used = self._tick
            pages.append(node.page)
            children = node.children
        self.lookups += 1
        if pages:
            self.hits += 1
        return pages

    def hit_rate(self) -> float:
        """Fraction of admission-path lookups that matched at least one
        cached block (0.0 before any lookup)."""
        return self.hits / self.lookups if self.lookups else 0.0

    def match_len(self, tokens: Sequence[int]) -> int:
        """Matched-prefix length in TOKENS, mutation-free and safe to
        call from another thread against a live tree (a concurrent
        mutation can cost accuracy, never a crash): a router's affinity
        signal."""
        n = 0
        try:
            children = self._children
            for key in self._blocks(tokens):
                node = children.get(key)
                if node is None:
                    break
                n += self.page_size
                children = node.children
        except RuntimeError:  # dict resized mid-iteration on a hot tree
            return n
        return n

    # -- mutations ----------------------------------------------------------

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Cache a fully-prefilled prompt prefix: ``pages[i]`` holds the
        K/V of the ``i``-th full block of ``tokens``.  Blocks already
        cached keep their existing page (the inserter mapped that very
        page via :meth:`match` + ``alloc_shared``); each NEW node
        retains its page.  Returns how many new blocks were cached."""
        self._tick += 1
        blocks = self._blocks(tokens)
        if len(pages) < len(blocks):
            raise ValueError(
                f"{len(blocks)} full blocks need {len(blocks)} pages, "
                f"got {len(pages)}"
            )
        added = 0
        parent: Optional[_Node] = None
        children = self._children
        for key, page in zip(blocks, pages):
            node = children.get(key)
            if node is None:
                self.kv.retain([page])
                node = _Node(key=key, page=page, parent=parent)
                children[key] = node
                self._count += 1
                added += 1
            node.last_used = self._tick
            parent = node
            children = node.children
        return added

    def evict(self, exclude: Optional[Set[int]] = None) -> bool:
        """Drop the least-recently-used LEAF (releasing its page
        reference); ``exclude`` protects pages a caller is mid-way
        through mapping.  Returns whether anything was evicted — the
        engine loops this under pool pressure before it will preempt a
        lane."""
        victim: Optional[_Node] = None
        stack = list(self._children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif exclude is not None and n.page in exclude:
                continue
            elif victim is None or n.last_used < victim.last_used:
                victim = n
        if victim is None:
            return False
        siblings = (victim.parent.children if victim.parent is not None
                    else self._children)
        del siblings[victim.key]
        self._count -= 1
        self.kv.release([victim.page])
        return True

    def clear(self) -> int:
        """Release every cached page (drain / release_kv); returns how
        many references were dropped."""
        pages = self.pages()
        if pages:
            self.kv.release(pages)
        self._children = {}
        self._count = 0
        return len(pages)


class NgramDrafter:
    """Self-drafting n-gram proposer for speculative decoding.

    A bounded map from each ``order``-token tail to the token most
    recently observed to follow it, fed by :meth:`observe` on admitted
    prompts and emitted tokens (last writer wins — recency is the whole
    model).  :meth:`draft` walks the map up to ``k`` steps from a lane's
    current tail and stops at the first unknown tail, so drafts are
    always a contiguous guess at the sequential greedy chain.  Greedy
    accept in the engine makes draft quality a pure throughput knob:
    every proposed token is checked by the batched verify program, so
    the drafter can be arbitrarily wrong without costing a token of
    output.
    """

    def __init__(self, order: int = 2, max_entries: int = 1 << 16):
        if order < 1:
            raise ValueError(f"order must be >= 1, got {order}")
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.order = order
        self.max_entries = max_entries
        self._next: Dict[Tuple[int, ...], int] = {}
        self.observed = 0   # (gram -> next) pairs absorbed
        self.proposed = 0   # draft tokens handed out

    def __len__(self) -> int:
        return len(self._next)

    def observe(self, tokens: Sequence[int]) -> int:
        """Absorb every ``(order-gram -> next token)`` pair in
        ``tokens``.  At capacity, known grams keep updating (recency)
        and new grams are dropped — bounded memory beats completeness
        for a proposer whose misses are free."""
        o = self.order
        seen = 0
        nxt = self._next
        toks = list(tokens)
        for i in range(len(toks) - o):
            key = tuple(toks[i:i + o])
            if len(nxt) >= self.max_entries and key not in nxt:
                continue
            nxt[key] = toks[i + o]
            seen += 1
        self.observed += seen
        return seen

    def warm_from_prefix(self, prefix: PrefixCache) -> int:
        """Seed the map from every prompt stream the radix tree holds —
        replica warmup for the preambles that dominate traffic."""
        return sum(self.observe(s) for s in prefix.token_streams())

    def draft(self, context: Sequence[int], k: int) -> List[int]:
        """Up to ``k`` proposed continuation tokens of ``context``
        (possibly empty: an unknown tail proposes nothing, and the
        engine's verify tick degenerates to plain decode)."""
        o = self.order
        if k <= 0 or len(context) < o:
            return []
        tail = list(context[-o:])
        out: List[int] = []
        for _ in range(k):
            nxt = self._next.get(tuple(tail))
            if nxt is None:
                break
            out.append(nxt)
            tail = tail[1:] + [nxt]
        self.proposed += len(out)
        return out
