"""Paged KV-cache storage: refcounted page pool + radix prefix cache.

Counterpart of ``repro.serve.pages`` for the single-card paged path.  The
host-side bookkeeping (:class:`PrefixCache`, :class:`PagePool`'s free list,
refcounts, LRU eviction and the trash page at index ``num_pages``) is the
reference's, line for line, so identical request streams produce identical
page tables in both packages.

The device ops differ in one way: the reference's are pure (storage in,
storage out, with buffer donation making the update in place), while these
write into the storage tensors **in place** and return nothing.  The pool
holds the only copy of the storage; callers pass views of it.
:func:`write_slot` is the dense per-slot path's one store op, in place on
the engine's per-slot state in the same way.
"""

from __future__ import annotations

__all__ = ["N_TRASH", "PagePool", "PagedLeafSpec", "PrefixCache",
           "copy_pages", "gather_pages", "scatter_chunk", "scatter_token",
           "scatter_window", "write_slot"]

import dataclasses
import heapq
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.models.module import tree_map


@dataclasses.dataclass(frozen=True)
class PagedLeafSpec:
    """One decode-cache leaf, described around its token axis.

    A dense cache leaf ``(L, B, S, H, D)`` becomes
    ``prefix=(L,), suffix=(H, D)`` — batch and sequence axes are replaced
    by the pool's ``(num_pages, page_size)`` pair.
    """
    prefix: tuple
    suffix: tuple
    dtype: Any                  # torch.dtype

    def storage_shape(self, num_pages: int, page_size: int) -> tuple:
        """prefix + (num_pages, page_size) + suffix — the pool array shape."""
        return tuple(self.prefix) + (num_pages, page_size) + tuple(self.suffix)


# extra never-allocated page absorbing dead-slot decode writes; storage is
# always materialized with ``num_pages + N_TRASH`` pages
N_TRASH = 1


class _PrefixNode:
    """One cached page: a page-sized token chunk hanging off its parent."""
    __slots__ = ("key", "page", "parent", "children", "last_use")

    def __init__(self, key: bytes, page: int, parent):
        self.key = key                  # the ps int32 tokens, as bytes
        self.page = page
        self.parent = parent
        self.children: dict[bytes, _PrefixNode] = {}
        self.last_use = 0


class PrefixCache:
    """Radix index over cached pages: token-chunk content -> page id.

    Each node is one FULL page whose K/V content is final; a path from the
    root spells out a token prefix at page granularity.  :meth:`match`
    additionally shares a *partial* last page when a cached child covers
    the request's whole remaining prompt.  The cache is an index only —
    refcounts and the free list live on the :class:`PagePool`.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._root = _PrefixNode(b"", -1, None)
        self._by_page: dict[int, _PrefixNode] = {}
        self._clock = 0

    def __contains__(self, page: int) -> bool:
        return page in self._by_page

    def __len__(self) -> int:
        return len(self._by_page)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _walk(self, toks: np.ndarray, depth: int) -> Optional[_PrefixNode]:
        """The node spelling ``toks[:depth * page_size]`` (root for 0)."""
        ps, cur = self.page_size, self._root
        for i in range(depth):
            cur = cur.children.get(toks[i * ps:(i + 1) * ps].tobytes())
            if cur is None:
                return None
        return cur

    def match(self, toks: np.ndarray) -> tuple[list[int], int]:
        """Longest cached prefix of ``toks``: (page ids, tokens covered).

        Walks full-page chunks, then tries one partial step: a child whose
        content begins with the ENTIRE remaining prompt extends the match
        to ``len(toks)``.  Matched nodes get their LRU stamp bumped.
        """
        toks = np.ascontiguousarray(toks, np.int32)
        total, ps = len(toks), self.page_size
        cur, pages, k = self._root, [], 0
        while (k + 1) * ps <= total:
            child = cur.children.get(toks[k * ps:(k + 1) * ps].tobytes())
            if child is None:
                break
            child.last_use = self._tick()
            pages.append(child.page)
            cur, k = child, k + 1
        rem = total - k * ps
        if rem > 0:
            pre = toks[k * ps:].tobytes()
            cands = [c for c in cur.children.values()
                     if c.key.startswith(pre)]
            if cands:
                best = max(cands, key=lambda c: c.last_use)
                best.last_use = self._tick()
                pages.append(best.page)
                return pages, total
        return pages, k * ps

    def insert(self, toks: np.ndarray, depth: int, page: int) -> bool:
        """Register ``page`` as chunk ``depth`` of sequence ``toks``.  First
        registration wins; returns True iff ``page`` was registered."""
        toks = np.ascontiguousarray(toks, np.int32)
        ps = self.page_size
        if (depth + 1) * ps > len(toks) or page in self._by_page:
            return False
        cur = self._walk(toks, depth)
        if cur is None:
            return False
        key = toks[depth * ps:(depth + 1) * ps].tobytes()
        node = cur.children.get(key)
        if node is not None:
            node.last_use = self._tick()
            return False
        node = _PrefixNode(key, int(page), cur)
        node.last_use = self._tick()
        cur.children[key] = node
        self._by_page[int(page)] = node
        return True

    def touch(self, page: int) -> None:
        """Refresh a cached page's LRU timestamp (prefix re-match)."""
        node = self._by_page.get(page)
        if node is not None:
            node.last_use = self._tick()

    def forget(self, page: int) -> list[int]:
        """Unregister ``page`` AND its whole subtree.  Returns every
        unregistered page id, ``page`` first."""
        node = self._by_page.get(page)
        if node is None:
            return []
        del node.parent.children[node.key]
        dropped, stack = [], [node]
        while stack:
            nd = stack.pop()
            dropped.append(nd.page)
            del self._by_page[nd.page]
            stack.extend(nd.children.values())
        return dropped

    def evict_leaves(self, n: int, evictable: Callable[[int], bool]
                     ) -> list[int]:
        """Drop up to ``n`` LRU *leaf* nodes whose page passes
        ``evictable``; leaf-first keeps every surviving chain matchable."""
        heap = [(nd.last_use, nd.page) for nd in self._by_page.values()
                if not nd.children]
        heapq.heapify(heap)
        dropped: list[int] = []
        while heap and len(dropped) < n:
            stamp, page = heapq.heappop(heap)
            nd = self._by_page.get(page)
            if nd is None or nd.children or not evictable(page):
                continue
            if nd.last_use != stamp:        # touched since seeding: re-queue
                heapq.heappush(heap, (nd.last_use, page))
                continue
            parent = nd.parent
            del parent.children[nd.key]
            del self._by_page[page]
            dropped.append(page)
            if parent is not self._root and not parent.children:
                heapq.heappush(heap, (parent.last_use, parent.page))
        return dropped


class PagePool:
    """Refcounted fixed-size KV pages with a FIFO free list, on one device.

    One extra *trash* page (index ``num_pages``) is always allocated so
    batched decode can keep dead slots in the step: their token writes land
    in the trash page instead of corrupting a live one.  With
    ``prefix_cache=True``, pages whose refcount drops to zero while
    registered are *parked* in the :class:`PrefixCache` (evictable LRU).
    ``pages_free + pages_cached + pages_in_use == num_pages`` always.
    """

    def __init__(self, leaf_specs, *, num_pages: int, page_size: int,
                 device, prefix_cache: bool = False):
        if num_pages < 1 or page_size < 1:
            raise ValueError(f"num_pages={num_pages} and page_size="
                             f"{page_size} must both be >= 1")
        self.leaf_specs = leaf_specs
        self.num_pages = num_pages
        self.page_size = page_size
        self.device = torch.device(device)
        self.trash_page = num_pages            # valid index, never allocated
        self.storage = self._fresh_storage()
        self._free: deque[int] = deque(range(num_pages))
        self._free_set: set[int] = set(self._free)
        self._ref = np.zeros(num_pages, np.int64)
        self.prefix = PrefixCache(page_size) if prefix_cache else None
        self._n_cached = 0
        self.evictions = 0
        self._high_water = 0

    def _fresh_storage(self):
        return tree_map(
            lambda s: torch.zeros(
                s.storage_shape(self.num_pages + N_TRASH, self.page_size),
                dtype=s.dtype, device=self.device),
            self.leaf_specs)

    def reset_storage(self) -> None:
        """Rebuild zeroed storage with the original shapes.  The KV
        *contents* are gone — callers must evict every resident request
        first; the prefix cache is flushed for the same reason."""
        self.storage = None            # let the old buffers go first
        self.storage = self._fresh_storage()
        self.flush_cache()

    def flush_cache(self) -> None:
        """Drop every prefix-cache entry.  Parked (unreferenced) pages
        return to the free list; held pages just lose their registration."""
        if self.prefix is None:
            return
        cached = list(self.prefix._by_page)
        self.prefix = PrefixCache(self.page_size)
        for p in cached:
            if self._ref[p] == 0:
                self._free_push(p)
        self._n_cached = 0

    # -- host-side accounting -------------------------------------------------

    @property
    def pages_free(self) -> int:
        """Pages on the free list (unreferenced, unregistered)."""
        return len(self._free)

    @property
    def pages_cached(self) -> int:
        """Registered pages no request holds (LRU eviction candidates)."""
        return self._n_cached

    @property
    def pages_in_use(self) -> int:
        """Pages referenced by at least one slot (free + cached excluded)."""
        return self.num_pages - len(self._free) - self._n_cached

    @property
    def high_water(self) -> int:
        """Max pages simultaneously referenced since construction."""
        return self._high_water

    def ref(self, page: int) -> int:
        """Current refcount of one page."""
        return int(self._ref[page])

    def _free_push(self, page: int) -> None:
        self._free.append(int(page))
        self._free_set.add(int(page))

    def _note_usage(self) -> None:
        self._high_water = max(self._high_water, self.pages_in_use)

    def alloc(self, n: int) -> Optional[list[int]]:
        """Pop ``n`` exclusive pages (refcount 1), or None if exhausted
        (all-or-nothing).  When the free list runs short, LRU unreferenced
        cached pages are evicted to cover the shortfall."""
        if n < 0:
            return None
        if len(self._free) < n and self.prefix is not None:
            dropped = self.prefix.evict_leaves(
                n - len(self._free), lambda p: self._ref[p] == 0)
            for p in dropped:
                self._n_cached -= 1
                self._free_push(p)
            self.evictions += len(dropped)
        if len(self._free) < n:
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._free_set.discard(p)
            self._ref[p] = 1
        self._note_usage()
        return pages

    def incref(self, pages) -> None:
        """Take a reference on already-registered pages (a prefix match)."""
        for p in pages:
            p = int(p)
            if not 0 <= p < self.num_pages:
                raise ValueError(f"incref of invalid page id {p}")
            if self._ref[p] == 0:
                if self.prefix is None or p not in self.prefix:
                    raise ValueError(
                        f"incref of page {p} that is neither held nor cached")
                self._n_cached -= 1
            self._ref[p] += 1
        self._note_usage()

    def decref(self, pages) -> None:
        """Drop one reference per page; at zero a registered page parks in
        the prefix cache, any other returns to the free list.  Decref below
        zero raises."""
        for p in pages:
            p = int(p)
            if not 0 <= p < self.num_pages:
                raise ValueError(f"decref of invalid page id {p}")
            if self._ref[p] <= 0:
                raise ValueError(
                    f"decref of page {p} below zero (double release)")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                if self.prefix is not None and p in self.prefix:
                    self._n_cached += 1
                    self.prefix.touch(p)
                else:
                    self._free_push(p)

    def unregister(self, page: int) -> None:
        """Drop ``page`` (and any cached descendants) from the prefix index
        — the write-in-place path when its single holder is about to mutate
        it.  Unreferenced descendants return to the free list."""
        if self.prefix is None:
            return
        for q in self.prefix.forget(page):
            if self._ref[q] == 0:
                self._n_cached -= 1
                self._free_push(q)


# ---------------------------------------------------------------------------
# Device ops: in-place writes into the pool's storage tensors
# ---------------------------------------------------------------------------

def _check_write_dtype(storage, vals, op: str):
    """Scatter writes must arrive already in the pool's storage dtype: an
    implicit cast would turn a precision mismatch into wrong cached numbers
    with no error, so a mismatch raises."""
    if vals.dtype != storage.dtype:
        raise TypeError(
            f"{op}: value dtype {vals.dtype} != storage dtype "
            f"{storage.dtype}; convert explicitly before the scatter — "
            "implicit lossy casts are not performed")


def scatter_chunk(storage, pages, chunk, *, page_size: int) -> None:
    """Write a page-aligned token chunk into its pages, in place.

    storage: (N, page_size, suffix...) — one layer's leaf;  pages: (n,) int
    page ids;  chunk: (n * page_size, suffix...) — in the storage dtype.
    """
    _check_write_dtype(storage, chunk, "scatter_chunk")
    n = pages.shape[0]
    storage[pages.long()] = chunk.reshape((n, page_size) + chunk.shape[1:])


def scatter_token(storage, pages, offs, vals) -> None:
    """Write one token per slot at (page, offset), in place — the decode
    write.  pages, offs: (B,) ints; vals: (B, suffix...)."""
    _check_write_dtype(storage, vals, "scatter_token")
    storage[pages.long(), offs.long()] = vals


def scatter_window(storage, pages, offs, vals) -> None:
    """Write a per-slot window of tokens at (page, offset) pairs, in place —
    the speculative-verify write (C candidate positions a slot in one
    scatter; pad and dead positions point at the trash page).
    pages, offs: (B, C) ints; vals: (B, C, suffix...)."""
    B, C = pages.shape
    scatter_token(storage, pages.reshape(-1), offs.reshape(-1),
                  vals.reshape((B * C,) + vals.shape[2:]))


def gather_pages(storage, tables):
    """Gather each slot's pages into a contiguous copy.

    storage: (N, page_size, suffix...);  tables: (B, P) ints
    -> (B, P * page_size, suffix...)
    """
    B, P = tables.shape
    g = storage[tables.long()]
    return g.reshape((B, P * storage.shape[1]) + g.shape[3:])


def copy_pages(storage, leaf_specs, src, dst) -> None:
    """Copy whole pages ``src[i] -> dst[i]`` in every leaf, in place — the
    copy-on-write op.  Every source is read (into a new tensor) before any
    destination is written, so disjoint copies from one shared source are
    safe in one call.  A leaf's page axis follows its spec's prefix axes
    (the layer axis)."""
    src, dst = src.long(), dst.long()
    for name, st in storage.items():
        pfx = (slice(None),) * len(leaf_specs[name].prefix)
        vals = st[pfx + (src,)]              # advanced indexing: a copy
        st[pfx + (dst,)] = vals


# ---------------------------------------------------------------------------
# Dense per-slot state store (the degenerate "one page per slot" layout)
# ---------------------------------------------------------------------------

def write_slot(state, slot_state, slot: int) -> None:
    """Write a (B = 1) prefill state into slot ``slot`` of the batched
    state, in place.

    Every leaf has batch on axis 1.  A KV-cache leaf whose sequence axis
    (axis 2) is shorter than the slot's gets the prefill's rows and zeros
    after them, as the reference's zero-pad gives (the validity length
    masks the tail either way); a leaf of the same shape as the slot's
    (a recurrent state such as rwkv6's wkv and shift buffers) is copied
    whole.  Values are cast to the state's dtype, as in the reference.
    """
    for name, dst in state.items():
        src = slot_state[name][:, 0]
        if dst.ndim >= 3 and src.shape[1] < dst.shape[2]:
            n = src.shape[1]
            dst[:, slot, :n] = src
            dst[:, slot, n:] = 0
        else:
            dst[:, slot] = src
