"""Host-side page allocator and prefix index for the paged KV cache (port
of ``repro/serving/paging.py``; pure Python and numpy, no device work).

The device side (``nn/attention.KVCache`` in its paged layout) is a page
pool indexed by per-row tables; everything stateful lives here, on the
host, where the engine runs its admission loop:

* ``PagePool`` — a free list and per-page refcounts.  A page is owned by
  every slot whose table maps it plus, for published prompt pages, the
  prefix index; it returns to the free list when the last reference drops.
* ``PrefixIndex`` — a radix trie over page-sized token-id chunks: a node
  per full prompt page, holding the page id that caches that chunk's K/V.
  Admissions walk it for the longest already-cached prefix and map those
  pages read-only (refcounted) instead of prefilling them again.

Lifecycle (``serving/engine.py``):

1. admission: ``match()`` the prompt -> shared pages; incref them for the
   slot; allocate fresh pages for the rest of ``len(prompt) + max_new``;
   if the pool is short, ``reclaim()`` LRU index entries first, and if
   still short the request stays queued (back-pressure).
2. prefill completion: ``insert()`` publishes the row's full prompt pages
   so later admissions can share them.  Publishing only once the K/V are
   written keeps a racing admission from attending to unwritten pages: it
   misses and prefills for itself.
3. eviction: decref every page the slot held.  No device work.

Invariants: no page is on the free list with a nonzero refcount, no page
is mapped by two live slots unless ``match()`` handed it out (shared), and
alloc/decref conserve pages exactly (no leak, no double free).
"""
from __future__ import annotations

from collections import deque
from typing import Iterable, Optional

import numpy as np


class PagePool:
    """Free list and refcounts over ``num_pages`` fixed-size pages."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._ref = np.zeros((self.num_pages,), np.int64)
        self._free: deque[int] = deque(range(self.num_pages))

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def alloc(self, n: int) -> Optional[list[int]]:
        """Take ``n`` pages off the free list at refcount 1, or None if the
        pool cannot cover them all (all or nothing)."""
        if n < 0:
            raise ValueError("n must be >= 0")
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def incref(self, pages: Iterable[int]) -> None:
        for p in pages:
            if self._ref[p] <= 0:
                raise RuntimeError(f"incref of free page {p}")
            self._ref[p] += 1

    def decref(self, pages: Iterable[int]) -> list[int]:
        """Drop one reference per page; returns the pages that reached zero
        and went back on the free list."""
        freed = []
        for p in pages:
            if self._ref[p] <= 0:
                raise RuntimeError(f"double free of page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed


class _Node:
    __slots__ = ("parent", "key", "children", "page", "stamp")

    def __init__(self, parent: Optional["_Node"], key):
        self.parent = parent
        self.key = key
        self.children: dict = {}
        self.page: Optional[int] = None
        self.stamp = 0


class PrefixIndex:
    """Radix trie over page-sized token-id chunks -> cached page ids.

    Each indexed node holds one index-owned reference on its page, so a
    published page outlives the slot that prefilled it until ``reclaim()``
    evicts the entry (LRU, childless leaves first: an interior entry is
    never dropped before its descendants, which keeps every held page
    reachable from the root and reclaimable)."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self._root = _Node(None, None)
        self._clock = 0
        self.n_entries = 0

    def _chunks(self, tokens):
        p = self.pool.page_size
        for i in range(0, (len(tokens) // p) * p, p):
            yield tuple(int(t) for t in tokens[i:i + p])

    def match(self, tokens) -> list[int]:
        """Longest indexed full-page prefix of ``tokens`` -> page ids (the
        caller increfs them; a bare match holds no reference)."""
        self._clock += 1
        node, pages = self._root, []
        for key in self._chunks(tokens):
            node = node.children.get(key)
            if node is None or node.page is None:
                break
            node.stamp = self._clock
            pages.append(node.page)
        return pages

    def insert(self, tokens, pages: list[int]) -> int:
        """Publish a completed prompt's full pages: ``pages[i]`` holds the
        K/V of chunk i.  Newly indexed pages gain an index-owned reference;
        chunks already indexed (possibly under another page id, from a
        racing admission) are left alone.  Returns the entries added."""
        self._clock += 1
        node, added = self._root, 0
        for key, pid in zip(self._chunks(tokens), pages):
            child = node.children.get(key)
            if child is None:
                child = _Node(node, key)
                node.children[key] = child
            if child.page is None:
                child.page = pid
                self.pool.incref([pid])
                self.n_entries += 1
                added += 1
            child.stamp = self._clock
            node = child
        return added

    def reclaim(self, pages_needed: int) -> int:
        """Evict LRU leaf entries until the pool has ``pages_needed`` free
        pages (or nothing is left to evict).  Dropping the index's reference
        frees a page only if no live slot still maps it.  Returns the
        entries evicted."""
        evicted = 0
        while self.pool.pages_free < pages_needed:
            best = None
            stack = [self._root]
            while stack:
                n = stack.pop()
                for c in n.children.values():
                    if c.children:
                        stack.append(c)
                    elif c.page is not None and (best is None
                                                 or c.stamp < best.stamp):
                        best = c
            if best is None:
                break
            self.pool.decref([best.page])
            best.page = None
            self.n_entries -= 1
            evicted += 1
            node = best
            while (node is not self._root and not node.children
                   and node.page is None):
                parent = node.parent
                del parent.children[node.key]
                node = parent
        return evicted
