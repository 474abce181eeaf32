"""Global prefix cache: copy-on-write shared KV pages behind a radix index
(port of ``paddle_tpu/serving/prefix_cache.py``, copied whole: host code,
numpy only).

Most production prompts share a prefix (system prompts, few-shot headers,
multi-turn history), yet plain admission prefills every prompt into
freshly allocated pages.  Because the ragged fused step already reads
arbitrary pool pages through per-slot page tables (docs/serving.md
"Ragged fused step"), a cached prefix needs ZERO kernel changes: it is
just page-table entries pointing at pages another request filled.

**Radix index.**  A node is one FULL page of ``page_size`` token ids,
keyed by content + parent: each node's children are a dict keyed on the
child's raw token-id chunk bytes, so the path root -> node spells out a
token prefix page by page and lookup is a longest-prefix walk.  Every
node owns exactly one pool page (moved into the allocator's ``shared``
ledger at registration) whose KV holds those positions.

**COW ownership rule.**  A slot only ever WRITES pages it exclusively
owns.  Shared nodes are created only from *completed, immutable* full
pages — at harvest time, once ``pos`` has advanced past the page's last
position, the engine registers it here and the slot's remaining writes
land at positions ``>= pos``, i.e. strictly later pages.  The boundary
partial page is always private.  Decoding past a shared prefix is
therefore copy-on-write by construction: new tokens go to the slot's own
tail pages while shared pages are only read.

**Hits.**  ``acquire(prompt)`` walks the prompt's full-page chunks,
takes a reader reference on every matched page, and returns the pages to
splice into the new slot's table.  The match is capped so at least one
prompt token always prefills (the last prompt position must produce the
first logits).  Admission then reserves pages ONLY for the uncached tail
and the engine starts the prefill run at the first uncached token — the
positions are per-slot traced vectors, so no retrace.

**Eviction.**  LRU over refcount-0 nodes, leaf-first (references are
taken path-wise from the root, so a refcount-0 node's whole subtree is
refcount-0 and evicting leaves first keeps the tree consistent).  The
evictor is installed as the allocator's ``reclaimer``: under pool
pressure, cache-held pages are reclaimed BEFORE admission backpressures,
and never while referenced (``BlockAllocator.reclaim`` refuses
refcount > 0).

**Disaggregation.**  The index is per replica and transport-agnostic:
under prefill/decode disaggregation (serving/disagg.py) prefill replicas
keep their own caches — prefix-locality routing sends sibling prompts to
the replica that already holds their prefix — and a hand-off copies a
request's matched SHARED pages into private destination pages (the
reader reference pins them for the copy's duration; the source drops it
at release).  The decode side re-registers completed pages into its own
index at harvest, so transferred siblings dedup storage there too.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .paged_cache import BlockAllocator

__all__ = ["PrefixCache"]


class _PrefixNode:
    """One full page of cached KV: ``key`` is the raw bytes of the
    page's ``page_size`` token ids (the child key in ``parent.children``),
    ``page`` the pool page holding their KV."""

    __slots__ = ("parent", "key", "page", "children", "lru")

    def __init__(self, parent, key: bytes, page: int):
        self.parent = parent
        self.key = key
        self.page = page
        self.children: dict = {}
        self.lru = 0


def _chunk_key(tokens) -> bytes:
    return np.ascontiguousarray(np.asarray(tokens, np.int64)).tobytes()


class PrefixCache:
    """Radix index over completed KV pages, backed by ``allocator``'s
    shared-page ledger.  Host-side only — the device never sees it; all
    sharing happens through page-table entries."""

    def __init__(self, allocator: BlockAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = int(page_size)
        self._root = _PrefixNode(None, b"", -1)
        self._all: set = set()           # every live node (root excluded)
        self._clock = 0                  # monotonic LRU stamp
        self.stats = {"hits": 0, "partial_hits": 0, "misses": 0,
                      "evictions": 0, "cached_tokens": 0,
                      "inserted": 0, "deduped": 0}
        # eviction-before-backpressure: the allocator consults this when
        # the free list cannot cover a reservation
        allocator.reclaimer = self.evict

    # -- introspection -------------------------------------------------------
    @property
    def nodes(self) -> int:
        return len(self._all)

    @property
    def pages(self) -> int:
        """Pool pages the cache holds (== allocator.shared_pages when this
        is the only sharer)."""
        return len(self._all)

    def _cacheable_chunks(self, n_tokens: int) -> int:
        """Full-page chunks of an ``n_tokens`` prompt eligible for
        matching: capped below the last token so at least one position
        always prefills (its logits seed generation)."""
        return max(int(n_tokens) - 1, 0) // self.page_size

    # -- lookup --------------------------------------------------------------
    def match_len(self, prompt) -> int:
        """Longest cached prefix of ``prompt`` in tokens — read-only (no
        references taken).  The placement layer's locality signal."""
        prompt = np.asarray(prompt)
        ps, node, n = self.page_size, self._root, 0
        for i in range(self._cacheable_chunks(prompt.size)):
            child = node.children.get(_chunk_key(prompt[i * ps:(i + 1) * ps]))
            if child is None:
                break
            node, n = child, n + ps
        return n

    def acquire(self, prompt) -> Tuple[List[_PrefixNode], List[int], int]:
        """Longest cached prefix of ``prompt`` with a reader reference
        taken on every matched page.  Returns ``(nodes, pages,
        n_cached_tokens)`` — the caller splices ``pages`` into the slot's
        table, seats the slot at position ``n_cached_tokens``, and must
        ``release(nodes)`` at retirement (or immediately, if admission
        backpressures)."""
        prompt = np.asarray(prompt)
        ps, node = self.page_size, self._root
        nodes: List[_PrefixNode] = []
        for i in range(self._cacheable_chunks(prompt.size)):
            child = node.children.get(_chunk_key(prompt[i * ps:(i + 1) * ps]))
            if child is None:
                break
            nodes.append(child)
            node = child
        self._clock += 1
        for nd in nodes:
            self.allocator.ref(nd.page)
            nd.lru = self._clock
        return nodes, [nd.page for nd in nodes], len(nodes) * ps

    def release(self, nodes: Sequence[_PrefixNode]):
        """Drop the reader references ``acquire``/``extend`` took.  Pages
        stay cache-held (evictable) at refcount 0 — they return to the
        free list only through LRU eviction or ``flush``."""
        for nd in nodes:
            self.allocator.unref(nd.page)

    # -- registration --------------------------------------------------------
    def extend(self, parent: Optional[_PrefixNode], chunk,
               page: int) -> Tuple[_PrefixNode, bool]:
        """Register one completed full page under ``parent`` (None for the
        root).  ``chunk`` is the page's ``page_size`` token ids, ``page``
        the slot's exclusively-owned pool page holding their KV.

        New chunk: the page moves into the allocator's shared ledger
        (refcount 1 = the registering slot) and ``(node, True)`` is
        returned.  Duplicate chunk (another slot registered identical
        content first): the EXISTING node gains a reference and ``(node,
        False)`` is returned — the caller adopts the existing shared page
        and frees its private duplicate, so identical prefixes dedup to
        one physical copy."""
        node = self._root if parent is None else parent
        key = _chunk_key(chunk)
        if len(key) != 8 * self.page_size:
            raise ValueError(
                f"extend: chunk has {len(key) // 8} tokens, want a full "
                f"page of {self.page_size} (partial pages stay private)")
        self._clock += 1
        child = node.children.get(key)
        if child is not None:
            self.allocator.ref(child.page)
            child.lru = self._clock
            self.stats["deduped"] += 1
            return child, False
        self.allocator.share(page)
        child = _PrefixNode(node, key, page)
        child.lru = self._clock
        node.children[key] = child
        self._all.add(child)
        self.stats["inserted"] += 1
        return child, True

    # -- eviction ------------------------------------------------------------
    def evict(self, n: int) -> int:
        """Reclaim up to ``n`` pages from refcount-0 nodes, LRU-first and
        leaf-first.  Installed as the allocator's ``reclaimer`` so pool
        pressure drains the cache before admission backpressures.
        Returns the number of pages actually reclaimed."""
        import heapq

        rc = self.allocator.refcount
        heap = [(nd.lru, nd.page, nd) for nd in self._all
                if not nd.children and rc(nd.page) == 0]
        heapq.heapify(heap)
        freed = 0
        while heap and freed < n:
            _, _, nd = heapq.heappop(heap)
            self.allocator.reclaim(nd.page)
            parent = nd.parent
            del parent.children[nd.key]
            self._all.discard(nd)
            freed += 1
            if (parent is not self._root and not parent.children
                    and rc(parent.page) == 0):
                heapq.heappush(heap, (parent.lru, parent.page, parent))
        self.stats["evictions"] += freed
        return freed

    def flush(self):
        """Drop the whole index and return every page to the free list —
        the rebuild path (docs/serving.md "Failure model"): a fresh pool's
        content is zeroed, so cached KV is invalid.  All references must
        already be released (every seated slot was failed and retired
        before ``_rebuild`` runs); a live reference here is a bug."""
        for nd in self._all:
            rc = self.allocator.refcount(nd.page)
            if rc:
                raise RuntimeError(
                    f"flush: page {nd.page} still has {rc} reader(s) — "
                    "flush must only run after every slot retired")
        for nd in self._all:
            self.allocator.reclaim(nd.page)
        self.stats["evictions"] += len(self._all)
        self._all.clear()
        self._root.children.clear()
