"""Paged KV-cache: fixed-size pages in a preallocated device pool
(counterpart of ``torchdistx_tpu/serve/kv_cache.py``; the host logic is
the same code, refcounts included, without its telemetry gauges).

Instead of one contiguous [B, max_seq, KV, D] cache per sequence, K/V
live in a pool of fixed-size **pages** ([n_pages, page_size, kv_heads,
head_dim] per layer, allocated once at replica bring-up), and each
sequence owns an ordered list of page ids — its **page table**.
Admission costs ``ceil(len / page_size)`` pages, growth one page at a
time, and retirement returns pages to the free list immediately.

Split of responsibilities:

* **host side (this class)** — the free list, per-sequence page tables,
  alloc/extend/free.  Pure Python bookkeeping.
* **device side** — the pools themselves are torch tensors owned by the
  engine (:func:`init_pools`) and updated in place by the serving
  programs (:mod:`.programs`).

Page 0 is reserved as the **null page**: batch-padding slots and
prompt-padding positions route their writes there, so padded lanes never
touch a live sequence's memory.  The null page is never handed out and
never read (idle lanes carry ``length == 0``).

Pages carry host-side **refcounts** (one per page table that maps the
page, one per prefix-cache holder), so a page returns to the free list
only when its last reference drops; :meth:`PagedKVCache.cow_page` is the
copy-on-write step for shared pages (the prefix cache of
:mod:`.prefix` shares them).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

import torch

__all__ = ["KVCacheConfig", "OutOfPages", "PagedKVCache"]


class OutOfPages(RuntimeError):
    """The pool cannot satisfy an alloc/extend; the engine responds by
    deferring admission or preempting a sequence, never by failing the
    request."""


@dataclass(frozen=True)
class KVCacheConfig:
    """Shape of the device pool (one K and one V pool, all layers)."""

    n_layers: int
    kv_heads: int
    head_dim: int
    page_size: int = 16
    n_pages: int = 64  # includes the reserved null page 0

    @property
    def usable_pages(self) -> int:
        return self.n_pages - 1

    @property
    def tokens_capacity(self) -> int:
        """Token slots available to live sequences (null page excluded)."""
        return self.usable_pages * self.page_size

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` of context."""
        return max(0, -(-n_tokens // self.page_size))

    def pool_shape(self) -> Tuple[int, int, int, int, int]:
        """[L, P, page, KV, D] — the per-pool (K or V) array shape."""
        return (self.n_layers, self.n_pages, self.page_size,
                self.kv_heads, self.head_dim)


@dataclass
class _Seq:
    pages: List[int] = field(default_factory=list)
    length: int = 0  # tokens currently stored


class PagedKVCache:
    """Host-side page allocator: free list + per-sequence page tables.

    The device pools are NOT stored here (the engine owns them and its
    programs update them in place); :func:`init_pools` builds them.
    """

    def __init__(self, cfg: KVCacheConfig):
        if cfg.n_pages < 2:
            raise ValueError(
                f"n_pages must be >= 2 (page 0 is the reserved null "
                f"page), got {cfg.n_pages}"
            )
        if cfg.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {cfg.page_size}")
        self.cfg = cfg
        # LIFO free list: recently-freed pages are reused first (their
        # pool slices are most likely still warm in device caches).
        self._free: List[int] = list(range(cfg.n_pages - 1, 0, -1))
        self._seqs: Dict[int, _Seq] = {}
        # Per-page refcounts: one reference per live page table mapping
        # the page, plus one per prefix-cache node holding it.  A page
        # returns to the free list only at refcount zero.
        self._ref: Dict[int, int] = {}

    # -- queries ------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.cfg.usable_pages - len(self._free)

    @property
    def shared_pages(self) -> int:
        """Pages with more than one reference (prefix-shared right
        now) — the live copy-on-write exposure."""
        return sum(1 for v in self._ref.values() if v > 1)

    def length(self, seq_id: int) -> int:
        return self._seqs[seq_id].length

    def page_ids(self, seq_id: int) -> List[int]:
        return list(self._seqs[seq_id].pages)

    def has(self, seq_id: int) -> bool:
        return seq_id in self._seqs

    def ref(self, page: int) -> int:
        """The page's current refcount (0 for free/unknown pages)."""
        return self._ref.get(page, 0)

    def occupancy(self) -> float:
        """Used token slots / allocated slots in live pages (1.0 = no
        internal fragmentation; 0.0 when nothing is allocated)."""
        alloc = sum(len(s.pages) for s in self._seqs.values())
        if not alloc:
            return 0.0
        used = sum(s.length for s in self._seqs.values())
        return used / (alloc * self.cfg.page_size)

    def fragmentation(self) -> float:
        """Wasted fraction of allocated slots (``1 - occupancy`` over
        live pages): the tail-page waste bound the paged layout trades
        for zero external fragmentation."""
        return 0.0 if not self._seqs else 1.0 - self.occupancy()

    def can_fit(self, n_tokens: int) -> bool:
        return self.cfg.pages_for(n_tokens) <= len(self._free)

    # -- mutations ----------------------------------------------------------

    def alloc(self, seq_id: int, n_tokens: int) -> List[int]:
        """Allocate pages for a new sequence holding ``n_tokens``;
        returns its page ids.  Raises :class:`OutOfPages` (allocating
        nothing) when the free list cannot cover it."""
        if seq_id in self._seqs:
            raise ValueError(f"sequence {seq_id} already allocated")
        need = self.cfg.pages_for(n_tokens)
        if need > len(self._free):
            raise OutOfPages(
                f"need {need} pages for {n_tokens} tokens, "
                f"{len(self._free)} free"
            )
        pages = [self._free.pop() for _ in range(need)]
        for p in pages:
            self._ref[p] = 1
        self._seqs[seq_id] = _Seq(pages=pages, length=n_tokens)
        return list(pages)

    def alloc_shared(self, seq_id: int, shared_pages: Sequence[int],
                     n_tokens: int) -> List[int]:
        """Allocate a sequence whose LEADING pages are another prompt's
        already-written prefix: the shared pages' refcounts rise (their
        contents are never rewritten without :meth:`cow_page`), fresh
        pages cover only the suffix.  Returns the full page table.
        Raises :class:`OutOfPages` changing nothing when the free list
        cannot cover the suffix."""
        if seq_id in self._seqs:
            raise ValueError(f"sequence {seq_id} already allocated")
        shared = list(shared_pages)
        need = self.cfg.pages_for(n_tokens) - len(shared)
        if need < 0:
            raise ValueError(
                f"{len(shared)} shared pages exceed the "
                f"{self.cfg.pages_for(n_tokens)} pages {n_tokens} tokens "
                f"need"
            )
        for p in shared:
            if self._ref.get(p, 0) < 1:
                raise ValueError(f"shared page {p} is not allocated")
        if need > len(self._free):
            raise OutOfPages(
                f"need {need} fresh pages for {n_tokens} tokens "
                f"({len(shared)} shared), {len(self._free)} free"
            )
        for p in shared:
            self._ref[p] += 1
        fresh = [self._free.pop() for _ in range(need)]
        for p in fresh:
            self._ref[p] = 1
        self._seqs[seq_id] = _Seq(pages=shared + fresh, length=n_tokens)
        return shared + fresh

    def retain(self, pages: Iterable[int]) -> None:
        """Add one reference to each page (the prefix cache holding a
        prompt's pages past the sequence's lifetime)."""
        for p in pages:
            if self._ref.get(p, 0) < 1:
                raise ValueError(f"cannot retain free page {p}")
            self._ref[p] += 1

    def release(self, pages: Iterable[int]) -> int:
        """Drop one reference from each page, returning those that hit
        zero to the free list; returns how many pages were freed."""
        freed = []
        for p in pages:
            n = self._ref.get(p, 0)
            if n < 1:
                raise ValueError(f"cannot release free page {p}")
            if n == 1:
                del self._ref[p]
                freed.append(p)
            else:
                self._ref[p] = n - 1
        if freed:
            self._free.extend(reversed(freed))
        return len(freed)

    def cow_page(self, seq_id: int,
                 page_index: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write: the sequence is about to WRITE into the page at
        ``page_index`` of its table.  Exclusively-owned pages need
        nothing (returns ``None``); a shared page is swapped for a fresh
        one — the caller must device-copy src → dst before writing —
        and the caller's reference moves to the copy.  Returns
        ``(src, dst)`` page ids, or raises :class:`OutOfPages` (changing
        nothing) when no fresh page is free."""
        seq = self._seqs[seq_id]
        src = seq.pages[page_index]
        if self._ref[src] == 1:
            return None
        if not self._free:
            raise OutOfPages(
                f"sequence {seq_id} needs a copy-on-write page, 0 free"
            )
        dst = self._free.pop()
        self._ref[src] -= 1
        self._ref[dst] = 1
        seq.pages[page_index] = dst
        return src, dst

    def extend(self, seq_id: int, new_length: int) -> List[int]:
        """Grow ``seq_id`` to hold ``new_length`` tokens, allocating at
        most the pages the growth needs; returns the pages ADDED.  On
        :class:`OutOfPages` nothing changes — the engine preempts a
        victim and retries."""
        seq = self._seqs[seq_id]
        if new_length < seq.length:
            raise ValueError(
                f"extend cannot shrink: {seq.length} -> {new_length}"
            )
        need = self.cfg.pages_for(new_length) - len(seq.pages)
        if need > len(self._free):
            raise OutOfPages(
                f"sequence {seq_id} needs {need} more pages, "
                f"{len(self._free)} free"
            )
        added = [self._free.pop() for _ in range(max(0, need))]
        for p in added:
            self._ref[p] = 1
        seq.pages.extend(added)
        seq.length = new_length
        return added

    def rollback(self, seq_id: int, new_length: int) -> int:
        """Token-level rollback (speculative decoding): shrink ``seq_id``
        to ``new_length`` tokens, dropping THIS sequence's reference to
        every trailing page the shorter length no longer needs.  Dropped
        pages return to the free list at refcount zero; a trailing page
        some other reader still holds (COW sharing) merely loses this
        table's reference — the reader's contents are untouched.  The
        partial tail page is truncated by bookkeeping alone: positions
        past ``new_length`` are never attended (attention masks on
        length) and are overwritten before they are ever valid again, so
        after rollback the cache state is exactly what plain decode
        would have produced.  Returns how many pages left this table.
        The inverse edge of :meth:`extend`, which deliberately refuses
        to shrink."""
        seq = self._seqs[seq_id]
        if not (0 <= new_length <= seq.length):
            raise ValueError(
                f"rollback target {new_length} outside [0, {seq.length}]"
            )
        keep = self.cfg.pages_for(new_length)
        dropped = seq.pages[keep:]
        del seq.pages[keep:]
        seq.length = new_length
        if dropped:
            self.release(dropped)
        return len(dropped)

    def free(self, seq_id: int) -> int:
        """Retire a sequence, dropping one reference from each of its
        pages; pages whose refcount hits zero return to the free list
        (shared prefix pages survive for their other readers).  Returns
        how many pages were actually freed.  Unknown ids are a no-op
        (retire paths race with preemption paths by design)."""
        seq = self._seqs.pop(seq_id, None)
        if seq is None:
            return 0
        freed = []
        for p in seq.pages:
            if self._ref[p] == 1:
                del self._ref[p]
                freed.append(p)
            else:
                self._ref[p] -= 1
        self._free.extend(reversed(freed))
        return len(freed)

    def reset(self) -> None:
        """Free every sequence and every outstanding reference (replica
        drain): one free-list rebuild, not N :meth:`free` calls."""
        self._seqs.clear()
        self._ref.clear()
        self._free = list(range(self.cfg.n_pages - 1, 0, -1))

    # -- batch views --------------------------------------------------------

    def table_row(self, seq_id: int, max_pages: int) -> List[int]:
        """The sequence's page table padded with the null page to a
        fixed-width row (the decode program's [B, max_pages] operand)."""
        pages = self._seqs[seq_id].pages
        if len(pages) > max_pages:
            raise ValueError(
                f"sequence {seq_id} holds {len(pages)} pages > "
                f"max_pages={max_pages}"
            )
        return pages + [0] * (max_pages - len(pages))

    def table_rows(self, seq_ids: Sequence[int],
                   max_pages: int) -> np.ndarray:
        """The batched decode operand: one null-padded page-table row
        per sequence, built in a single pass ([len(seq_ids), max_pages]
        int32) instead of a per-lane Python loop on the decode tick."""
        rows = np.zeros((len(seq_ids), max_pages), np.int32)
        for i, sid in enumerate(seq_ids):
            pages = self._seqs[sid].pages
            if len(pages) > max_pages:
                raise ValueError(
                    f"sequence {sid} holds {len(pages)} pages > "
                    f"max_pages={max_pages}"
                )
            rows[i, :len(pages)] = pages
        return rows


def init_pools(cfg: KVCacheConfig, dtype: torch.dtype,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The zeroed device pools (k_pages, v_pages), [L, P, page, KV, D]."""
    shape = cfg.pool_shape()
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
