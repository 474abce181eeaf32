"""Paged KV cache: a global pool of fixed-size KV pages + free-list
allocator (port of ``paddle_tpu/serving/paged_cache.py``).

ONE pool of ``[num_pages, H, page_size, D]`` pages per layer (one tensor
a layer for the layered GPT, stacked as ``[L, num_pages, H, page_size,
D]`` for the stacked one) on the model's device is shared by every decode
slot; a slot's context is named by its *page table* (an int32 row of pool
page ids), so memory scales with live tokens.

Page 0 is the **null page**: never handed out by the allocator, it absorbs
the writes of inactive slots and prefill padding (their page-table entries
all point at it) so the fused step needs no branching -- garbage lands in a
page no read ever resolves to validly.

The fused step writes the pool IN PLACE (``index_put_``): PyTorch tensors
are mutable, so the pool needs no donation to be updated without a copy.

``dtype="int8"`` is the quantized pool: int8 pages plus ``k_scale`` /
``v_scale`` fp32 absmax scales, one per (page, head), in the pages'
layout.  A scale row is addressed by the page id it describes, so it
needs no allocator of its own: it travels with its page through every
ledger transition.

A pool made for a replica mesh of ``mp > 1`` shards (``mesh=``, or
:meth:`PagedKVCache.shard`) holds no tensors of its own: ``shards[i]`` is
a whole pool of ``H/mp`` heads on ``mesh[i]`` (the reference's per-head
sharding over ``mp``), ``nbytes`` their sum.  A page id names the same
page in every shard.  :meth:`PagedKVCache.gather_pages` and
:meth:`PagedKVCache.scatter_pages` move pages between two pools of one
geometry, per pool tensor and per shard, scales included (the
disaggregated hand-off).

A pool made for a model placed on a training mesh (``placement=``)
holds layer ``l``'s pages cut by heads on the devices that hold layer
``l``'s shards: one stacked pool a shard for each group of layers (a
pipeline stage of the stacked GPT, one layer of the layered GPT), an int8
pool's ``[P, H/mp]`` scales on the same cut, read through
:meth:`PagedKVCache.layer_shards`.  The page ids and their ledger are
the same for every group.

``BlockAllocator`` is host bookkeeping, copied whole from the JAX package
with its 4-term ledger (free + used + spec + shared == capacity).
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional, Sequence, Tuple

import torch

from ..core import canonical_device, dtype_name, resolve_device, \
    to_torch_dtype
from ..models.generation import _KVBuffers

__all__ = ["NULL_PAGE", "PagedKVCache", "BlockAllocator",
           "pages_for_tokens"]

# pool page 0: reserved sink for inactive-slot / padding writes
NULL_PAGE = 0


def pages_for_tokens(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` positions: ``ceil(tokens /
    page_size)``.

    THE page-math helper -- admission sizing and every later ledger route
    through this one function so a rounding change can never diverge the
    ledgers (the all-or-nothing reservation discipline only keeps
    accounting exact while everyone agrees on the ceiling)."""
    tokens = int(tokens)
    page_size = int(page_size)
    if tokens < 0:
        raise ValueError(f"pages_for_tokens(tokens={tokens})")
    if page_size < 1:
        raise ValueError(f"pages_for_tokens(page_size={page_size})")
    return -(-tokens // page_size)


class PagedKVCache(_KVBuffers):
    """Global KV page pool on ``device``, zero-initialised.  ``paged`` is
    the marker the model dispatches on.

    ``stacked=False`` (the reference's default; the layered GPT's): per-
    layer ``k[i]``/``v[i]`` of ``[num_pages, H, page_size, D]``, read
    through :meth:`layer` and :meth:`layer_scales`.  ``stacked=True`` (the
    stacked GPT's): one pair of ``[L, num_pages, H, page_size, D]``
    tensors read whole.  An int8 pool (``quantized``) also holds
    ``k_scale``/``v_scale``, fp32 zeros (the quantizer's fresh-page
    sentinel) of ``[num_pages, H]`` a layer, or ``[L, num_pages, H]``
    stacked; a float pool holds None there."""

    paged = True
    # nbytes counts the scales, and release drops them, with the pages
    _FIELDS = ("k", "v", "k_scale", "v_scale")

    def __init__(self, num_layers: int, num_pages: int, num_heads: int,
                 page_size: int, head_dim: int, dtype="bfloat16",
                 stacked: bool = False, *, device=None, mesh=None,
                 placement=None):
        if num_pages < 2:
            raise ValueError(
                f"num_pages={num_pages}: the pool needs the null page plus "
                "at least one allocatable page")
        self.num_layers = num_layers
        self.num_pages = num_pages
        self.num_heads = num_heads
        self.page_size = page_size
        self.head_dim = head_dim
        self.dtype = dtype_name(dtype)
        self.stacked = bool(stacked)
        self.quantized = self.dtype == "int8"
        self.shards: Optional[List["PagedKVCache"]] = None
        self.mesh_shards = 1
        self.k = self.v = self.k_scale = self.v_scale = None
        if placement is not None:
            if mesh is not None:
                raise ValueError("a pool placed over a training mesh takes "
                                 "no serving mesh")
            self._place(placement, num_heads, lambda n, hs, d: PagedKVCache(
                n, num_pages, hs, page_size, head_dim, dtype, True,
                device=d))
            return
        if mesh is not None and len(mesh) > 1:
            mp = len(mesh)
            if num_heads % mp:
                raise ValueError(f"num_heads={num_heads} is not divisible "
                                 f"by mp={mp}")
            mesh = [canonical_device(d) for d in mesh]
            self.device = mesh[0]
            self.shards = [PagedKVCache(num_layers, num_pages,
                                        num_heads // mp, page_size, head_dim,
                                        dtype, stacked, device=d)
                           for d in mesh]
            self.mesh_shards = mp
            return
        if mesh is not None:
            device = mesh[0]
        self.device = resolve_device(device)

        def alloc(shape, td):
            if stacked:
                return torch.zeros((num_layers,) + shape, dtype=td,
                                   device=self.device)
            return [torch.zeros(shape, dtype=td, device=self.device)
                    for _ in range(num_layers)]

        td = to_torch_dtype(dtype, storage=True)
        shape = (num_pages, num_heads, page_size, head_dim)
        self.k, self.v = alloc(shape, td), alloc(shape, td)
        if self.quantized:
            ss = (num_pages, num_heads)
            self.k_scale = alloc(ss, torch.float32)
            self.v_scale = alloc(ss, torch.float32)

    def shard(self, mesh: Sequence[torch.device]) -> "PagedKVCache":
        """Split this pool per head over ``mesh`` in place: shard ``i`` is
        a contiguous pool of heads ``i*H/mp .. (i+1)*H/mp`` on ``mesh[i]``
        (the pages' content and scales kept); one device moves the pool
        there whole."""
        if self.shards is not None or self.groups is not None:
            raise ValueError("the pool is sharded already")
        mp = len(mesh)
        # the head axis of every pool tensor: [L, P, H, ...] stacked,
        # [P, H, ...] a layer (pages and scales alike)
        hax = 2 if self.stacked else 1
        if mp == 1:
            d = resolve_device(mesh[0])
            for f in self._FIELDS:
                t = getattr(self, f)
                if isinstance(t, list):
                    setattr(self, f, [x.to(d) for x in t])
                elif t is not None:
                    setattr(self, f, t.to(d))
            self.device = d
            return self
        if self.num_heads % mp:
            raise ValueError(f"num_heads={self.num_heads} is not divisible "
                             f"by mp={mp}")
        hs = self.num_heads // mp
        shards = []
        for i, d in enumerate(mesh):
            c = PagedKVCache.__new__(PagedKVCache)
            c.__dict__.update({k: v for k, v in self.__dict__.items()
                               if k not in self._FIELDS})
            c.num_heads, c.device = hs, canonical_device(d)
            for f in self._FIELDS:
                t = getattr(self, f)

                def cut(x):
                    return x.narrow(hax, i * hs, hs).contiguous().to(d)

                if isinstance(t, list):
                    setattr(c, f, [cut(x) for x in t])
                else:
                    setattr(c, f, None if t is None else cut(t))
            shards.append(c)
        for f in self._FIELDS:
            setattr(self, f, None)
        self.shards, self.mesh_shards = shards, mp
        self.device = shards[0].device
        return self

    def _tensors(self):
        if self.shards is not None:
            return [t for s in self.shards for t in s._tensors()]
        return super()._tensors()

    def release(self):
        if self.shards is not None:
            for s in self.shards:
                s.release()
        super().release()

    def layer(self, i: int):
        """(k, v) pool tensors of layer ``i`` (the per-layer layout
        only)."""
        self._check_whole("layer()")
        if self.stacked:
            raise ValueError("layer() is for the per-layer pool layout; "
                             "the stacked pool is read whole")
        return self.k[i], self.v[i]

    def layer_scales(self, i: int):
        """(k_scale, v_scale) of layer ``i``, ``(None, None)`` for a float
        pool (the per-layer layout only)."""
        self._check_whole("layer_scales()")
        if self.stacked:
            raise ValueError("layer_scales() is for the per-layer pool "
                             "layout; the stacked pool is read whole")
        if not self.quantized:
            return None, None
        return self.k_scale[i], self.v_scale[i]

    def _check_whole(self, what: str):
        if self.groups is not None:
            raise ValueError(f"{what}: the pool is placed over a training "
                             "mesh; read layer_shards(i)")
        if self.shards is not None:
            raise ValueError(f"{what}: the pool is sharded over "
                             f"{self.mesh_shards} devices; read "
                             "cache.shards[i]")

    # -- page moves (the disaggregated hand-off) ---------------------------
    def pool_tensors(self) -> List[Tuple[torch.Tensor, int]]:
        """Every tensor a page lives in, with its page axis: K and V (a
        layer each, or the stacked pair), then an int8 pool's scales, shard
        after shard.  Two pools of one geometry list them in the same
        order."""
        if self.shards is not None:
            return [p for s in self.shards for p in s.pool_tensors()]
        if self.groups is not None:
            return [p for _, subs in self.groups for s in subs
                    for p in s.pool_tensors()]
        ax = 1 if self.stacked else 0
        out = []
        for f in self._FIELDS:
            t = getattr(self, f)
            if isinstance(t, list):
                out.extend((x, ax) for x in t)
            elif t is not None:
                out.append((t, ax))
        return out

    def gather_pages(self, pages: Sequence[int]) -> List[torch.Tensor]:
        """The content of ``pages`` (their K/V and scales), one block per
        :meth:`pool_tensors` entry, on that tensor's device."""
        out = []
        idx = {}
        for t, ax in self.pool_tensors():
            if t.device not in idx:
                idx[t.device] = torch.as_tensor(list(pages),
                                                dtype=torch.long,
                                                device=t.device)
            out.append(t.index_select(ax, idx[t.device]))
        return out

    def scatter_pages(self, pages: Sequence[int],
                      blocks: Sequence[torch.Tensor]):
        """Write ``blocks`` (from :meth:`gather_pages` of a pool of the same
        geometry, on any devices) into ``pages`` of this pool, in place."""
        tensors = self.pool_tensors()
        if len(blocks) != len(tensors):
            raise ValueError(f"{len(blocks)} blocks for {len(tensors)} pool "
                             "tensors: the pools' geometries differ")
        idx = {}
        for (t, ax), b in zip(tensors, blocks):
            if t.device not in idx:
                idx[t.device] = torch.as_tensor(list(pages),
                                                dtype=torch.long,
                                                device=t.device)
            t.index_copy_(ax, idx[t.device], b.to(t.device))


class BlockAllocator:
    """Free-list allocator over pool pages ``1..num_pages-1`` (page 0 is
    the null page and is never handed out).

    ``alloc`` is all-or-nothing: a request that cannot be fully served
    leaves the free list untouched and returns None — the caller
    backpressures (keeps the request queued) instead of corrupting live
    slots with partial reservations."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (null page + 1)")
        self.num_pages = num_pages
        self._free: deque = deque(range(1, num_pages))
        self._allocated: set = set()
        self._spec: set = set()
        # shared (prefix-cache) pages: page id -> reader refcount.  A page
        # at refcount 0 is cache-held: not free (its KV is live and
        # indexed) but reclaimable under pool pressure via ``reclaimer``.
        self._shared: dict = {}
        # pool-pressure escape hatch: fn(deficit) -> pages reclaimed.  The
        # prefix cache installs its LRU evictor here so cache-held pages
        # are reclaimed BEFORE admission backpressures (never while
        # referenced — ``reclaim`` refuses refcount > 0).
        self.reclaimer = None
        # test-only fault injection: fn("alloc", ctx) may set
        # ctx["force_none"] to simulate pool exhaustion (serving/faults.py;
        # same discipline as checkpoint/manager.py's _fault_hook)
        self._fault_hook = None

    @property
    def capacity(self) -> int:
        """Allocatable pages (the null page is not counted)."""
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self._allocated)

    @property
    def spec_pages(self) -> int:
        """Pages held under a speculative reservation: taken from the free
        list but not yet committed — a rejected speculation rolls them
        straight back (docs/serving.md "Speculative decoding")."""
        return len(self._spec)

    @property
    def shared_pages(self) -> int:
        """Pages owned by the prefix cache (any refcount, including the
        evictable refcount-0 ones).  Every page is in exactly one of
        {free, allocated, speculative, shared}:
        ``free + used + spec + shared == capacity`` at all times."""
        return len(self._shared)

    def _reclaim_for(self, n: int):
        """Ask the installed reclaimer to evict cache-held pages when the
        free list cannot cover ``n`` — eviction before backpressure."""
        if n > len(self._free) and self.reclaimer is not None:
            self.reclaimer(n - len(self._free))

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages, or None (state unchanged) when fewer than n are free."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if self._fault_hook is not None:
            ctx = {"force_none": False, "n": n}
            self._fault_hook("alloc", ctx)
            if ctx["force_none"]:
                return None          # injected exhaustion: state unchanged
        self._reclaim_for(n)
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        self._allocated.update(pages)
        return pages

    def free(self, pages: List[int]):
        """Return pages to the pool.  Double-free and foreign ids raise —
        silent acceptance would eventually hand one page to two slots."""
        for p in pages:
            if p not in self._allocated:
                raise ValueError(
                    f"free({p}): page is not currently allocated "
                    "(double free or foreign id)")
            self._allocated.discard(p)
            self._free.append(p)

    # -- speculative reservations ------------------------------------------
    # The propose/verify loop (serving/speculative.py) writes K/V for
    # tokens the target model may REJECT.  Pages backing only-speculative
    # positions are reserved through this API instead of ``alloc`` so the
    # accounting invariant stays exact through partial acceptance, faults,
    # and retirement: every page is in exactly one of {free, allocated,
    # speculative, shared}, and free + used + spec + shared == capacity at
    # all times.

    def reserve_spec(self, n: int) -> Optional[List[int]]:
        """Reserve ``n`` pages speculatively (all-or-nothing, like
        ``alloc``).  None when fewer than ``n`` are free — the caller
        degrades (proposes fewer tokens) instead of corrupting state.

        The disaggregated hand-off (serving/disagg.py) reuses this exact
        ledger as its DESTINATION-side transfer reservation: pages sit in
        ``spec`` while the copy is in flight, ``commit_spec`` lands them
        atomically at harvest, ``rollback_spec`` returns them on a
        mid-transfer fault — so free+used+spec+shared==capacity is exact
        on both pools at every step boundary, transfers in flight
        included."""
        if n < 0:
            raise ValueError(f"reserve_spec({n})")
        if self._fault_hook is not None:
            ctx = {"force_none": False, "n": n, "spec": True}
            self._fault_hook("alloc", ctx)
            if ctx["force_none"]:
                return None
        self._reclaim_for(n)
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        self._spec.update(pages)
        return pages

    def commit_spec(self, pages: List[int]):
        """Promote speculatively reserved pages to regular allocations
        (their positions were ACCEPTED — from here they free through the
        normal ``free`` path at retirement).  Non-speculative ids raise."""
        for p in pages:
            if p not in self._spec:
                raise ValueError(
                    f"commit_spec({p}): page holds no speculative "
                    "reservation (double commit or foreign id)")
            self._spec.discard(p)
            self._allocated.add(p)

    def rollback_spec(self, pages: List[int]):
        """Return speculatively reserved pages to the free list (their
        positions were REJECTED, or the step they backed failed).
        Non-speculative ids raise — exactly like ``free``."""
        for p in pages:
            if p not in self._spec:
                raise ValueError(
                    f"rollback_spec({p}): page holds no speculative "
                    "reservation (double rollback or foreign id)")
            self._spec.discard(p)
            self._free.append(p)

    # -- shared (prefix-cache) pages ----------------------------------------
    # The prefix cache (serving/prefix_cache.py) indexes COMPLETED,
    # immutable full pages so later admissions splice them into their page
    # tables instead of re-prefilling.  Such pages move out of the
    # ``allocated`` ledger into ``shared`` with a reader refcount: the
    # registering slot keeps one reference, every admission that splices
    # the page takes another, retirement drops it.  Refcount 0 leaves the
    # page CACHE-HELD (evictable LRU), not free — ``reclaim`` is the only
    # path back to the free list and it refuses referenced pages, so a
    # page one slot still reads can never be handed to another.

    def share(self, page: int):
        """Move an allocated page into the shared ledger with refcount 1
        (the registering slot's own reference).  Non-allocated ids raise —
        only a page some slot exclusively owned (and therefore finished
        writing) can become shared."""
        if page not in self._allocated:
            raise ValueError(
                f"share({page}): page is not currently allocated "
                "(already shared, free, or foreign id)")
        self._allocated.discard(page)
        self._shared[page] = 1

    def ref(self, page: int):
        """Take a reader reference on a shared page (a cache hit splices
        it into another slot's page table)."""
        if page not in self._shared:
            raise ValueError(f"ref({page}): page is not shared")
        self._shared[page] += 1

    def unref(self, page: int):
        """Drop a reader reference (slot retirement).  The page stays
        shared at refcount 0 — cache-held and evictable.  Over-release
        raises, exactly like a double ``free``."""
        rc = self._shared.get(page)
        if rc is None:
            raise ValueError(f"unref({page}): page is not shared")
        if rc <= 0:
            raise ValueError(
                f"unref({page}): refcount already 0 (over-release)")
        self._shared[page] = rc - 1

    def refcount(self, page: int) -> Optional[int]:
        """Current reader refcount of a shared page (None if not shared)."""
        return self._shared.get(page)

    def reclaim(self, page: int):
        """Return a refcount-0 shared page to the free list (prefix-cache
        eviction).  Referenced pages raise — eviction must never race a
        live reader."""
        rc = self._shared.get(page)
        if rc is None:
            raise ValueError(f"reclaim({page}): page is not shared")
        if rc != 0:
            raise ValueError(
                f"reclaim({page}): page still has {rc} reader(s)")
        del self._shared[page]
        self._free.append(page)
