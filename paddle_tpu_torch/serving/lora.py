"""Paged per-request LoRA adapters for multi-tenant serving (port of
``paddle_tpu/serving/lora.py``).

One fused step serves MANY fine-tuned tenants: every registered adapter's
low-rank factors live in paged device SLABS -- per target matrix ``m``
with base weight ``W_m`` of ``[in, out]``, an A-slab and a B-slab of
``num_adapter_pages`` pages of ``[in, r]`` and ``[r, out]`` factors a
layer -- and each step token carries the int32 adapter-PAGE id of its
request.  The slab layout matches the model class (``stacked``): the
layered GPT's ``[P, L, in, r]`` / ``[P, L, r, out]``, page axis first
(the reference's default, ``stacked=False``; :meth:`LoRAAdapterPool.
layer_slabs` slices a layer), or the stacked GPT's ``[L, P, in, r]`` /
``[L, P, r, out]`` (``stacked=True``; read layer by layer beside its
stacked weights).  The engine refuses a pool whose layout is not its
model's.
Inside the step every projection computes

    x @ W_m  +  scaling * (x @ A_m[page]) @ B_m[page]

through ``ops/lora.py``; registration writes an adapter's factors into a
free page of the slabs IN PLACE, eviction frees the page, and the step
never changes as tenants come and go.

Allocator discipline is the KV pool's: the slabs are fronted by a
:class:`~paddle_tpu_torch.serving.paged_cache.BlockAllocator` (page 0 =
the NULL adapter, all-zero factors), registration allocates
all-or-nothing, and a tenant SEATED in a decode slot pins its page by a
refcount: evicting it raises the typed :class:`AdapterInUse`.

Target matrices: ``qkv``, ``out_proj``, ``fc1``, ``fc2``; the per-layer
slab order is ``(qkv_A, qkv_B, proj_A, proj_B, fc1_A, fc1_B, fc2_A,
fc2_B)``.  Slab bytes = 2 * r * (4h + 3h + f + f + h + h) * L * pages *
itemsize.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import dtype_name, resolve_device, to_torch_dtype
from .engine import ServingError
from .paged_cache import BlockAllocator

__all__ = ["LoRAAdapterPool", "AdapterError", "AdapterInUse",
           "UnknownAdapter", "random_adapter"]

# the per-layer slab order both GPT classes consume (A then B per matrix)
TARGETS = ("qkv", "out_proj", "fc1", "fc2")
NULL_ADAPTER = 0
# the weight of each target matrix: the stacked GPT's [L, in, out] slab,
# and the layered GPT's [in, out] weight of layer {i}
_STACKED_WEIGHTS = {"qkv": "decoder.qkv_w", "out_proj": "decoder.proj_w",
                    "fc1": "decoder.fc1_w", "fc2": "decoder.fc2_w"}
_LAYERED_WEIGHTS = {"qkv": "gpt.layer_{}.attn.qkv_proj.weight",
                    "out_proj": "gpt.layer_{}.attn.out_proj.weight",
                    "fc1": "gpt.layer_{}.mlp.fc1.weight",
                    "fc2": "gpt.layer_{}.mlp.fc2.weight"}


class AdapterError(ServingError):
    """Base of the typed LoRA adapter faults."""


class AdapterInUse(AdapterError):
    """Eviction refused: the adapter is pinned by seated request(s).
    Evicting under a live tenant would hand its page to the next
    registration and silently decode with the WRONG adapter."""


class UnknownAdapter(AdapterError):
    """The request names an adapter the pool has never seen (or one that
    was evicted before the request seated)."""


def _matrix_dims(cfg) -> Dict[str, Tuple[int, int]]:
    h, f = cfg.hidden_size, cfg.ffn_size
    return {"qkv": (h, 3 * h), "out_proj": (h, h),
            "fc1": (h, f), "fc2": (f, h)}


def random_adapter(cfg, rank: int, rng: np.random.RandomState,
                   scale: float = 0.02) -> Dict[str, list]:
    """A random adapter weight set for tests and smoke runs: per target
    matrix, a list of ``num_layers`` ``(A [in, r], B [r, out])`` float32
    pairs (the reference's draws, in its order).  B is NOT zero so the
    delta is visibly nonzero."""
    dims = _matrix_dims(cfg)
    return {
        m: [(rng.randn(din, rank).astype(np.float32) * scale,
             rng.randn(rank, dout).astype(np.float32) * scale)
            for _ in range(cfg.num_layers)]
        for m, (din, dout) in dims.items()
    }


class LoRAAdapterPool:
    """Paged adapter slab pool for one model configuration, on ``device``
    (``None``: the card; ``"cpu"`` asks for the CPU).

    ``num_adapter_pages`` counts REGISTRABLE adapters (the null page is
    extra); ``rank`` is fixed per pool; ``alpha`` defaults to ``rank``
    (scaling = alpha / rank = 1.0); ``dtype`` is the slabs' (the adapter
    precision).  ``stacked`` selects the slab layout of the model class
    served: False (the default) for ``GPTForPretraining``, True for
    ``GPTStackedForPretraining``."""

    def __init__(self, cfg, *, num_adapter_pages: int = 8, rank: int = 4,
                 alpha: Optional[float] = None, dtype: str = "float32",
                 stacked: bool = False, device=None):
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        if num_adapter_pages < 1:
            raise ValueError("num_adapter_pages must be >= 1")
        self.cfg = cfg
        self.rank = int(rank)
        self.alpha = float(alpha if alpha is not None else rank)
        self.scaling = self.alpha / self.rank
        self.dtype = dtype_name(dtype)
        self.stacked = bool(stacked)
        self.device = resolve_device(device)
        self.num_pages = int(num_adapter_pages) + 1      # + null page
        self.allocator = BlockAllocator(self.num_pages)
        self._lock = threading.Lock()
        # name -> [page, refcount]
        self._adapters: Dict[str, List[int]] = {}
        td = to_torch_dtype(self.dtype)
        L, P, r = cfg.num_layers, self.num_pages, self.rank
        self._slabs: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        lead = (L, P) if stacked else (P, L)
        for m, (din, dout) in _matrix_dims(cfg).items():
            self._slabs[m] = (
                torch.zeros(lead + (din, r), dtype=td, device=self.device),
                torch.zeros(lead + (r, dout), dtype=td, device=self.device))

    # -- slab views (models/gpt.py contract) -------------------------------
    def layer_slabs(self, i: int):
        """Layer ``i``'s 8-tuple of ``[P, dim, r]`` / ``[P, r, dim]`` slab
        views (the layered layout; strided, page axis first, so a row's
        gather stays one ``index_select``)."""
        if self.stacked:
            raise ValueError("layer_slabs() is for the layered layout; "
                             "stacked models read stacked_slabs()")
        out = []
        for m in TARGETS:
            out.extend(t[:, i] for t in self._slabs[m])
        return tuple(out)

    def stacked_slabs(self):
        """8-tuple of stacked ``[L, P, dim, r]`` / ``[L, P, r, dim]`` slab
        tensors, read layer by layer beside the stacked parameters."""
        if not self.stacked:
            raise ValueError("stacked_slabs() is for the stacked layout")
        out = []
        for m in TARGETS:
            out.extend(self._slabs[m])
        return tuple(out)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for pair in self._slabs.values() for t in pair)

    # -- registration / eviction -------------------------------------------
    def register(self, name: str, weights: Dict[str, list]) -> int:
        """Write an adapter's factors into a free page and return the page
        id.  ``weights``: per target matrix, ``num_layers`` ``(A, B)``
        pairs (:func:`random_adapter`'s shape).  All-or-nothing: a full
        pool raises the typed :class:`AdapterError`; a malformed weight set
        raises it too and leaks no page."""
        with self._lock:
            if name in self._adapters:
                raise AdapterError(f"adapter {name!r} is already registered")
            missing = [m for m in TARGETS if m not in weights]
            if missing:
                raise AdapterError(
                    f"adapter {name!r}: missing target matrices {missing}")
            pages = self.allocator.alloc(1)
            if pages is None:
                raise AdapterError(
                    f"adapter pool full ({self.allocator.capacity} pages): "
                    f"evict an adapter before registering {name!r}")
            page = pages[0]
            try:
                self._write_page(page, weights)
            except Exception:
                self.allocator.free([page])
                raise
            self._adapters[name] = [page, 0]
            return page

    def _write_page(self, page: int, weights: Dict[str, list]):
        L, r = self.cfg.num_layers, self.rank
        dims = _matrix_dims(self.cfg)
        staged = {}
        for m in TARGETS:          # validate every matrix before any write
            pairs = weights[m]
            if len(pairs) != L:
                raise AdapterError(
                    f"target {m!r}: expected {L} layer pairs, got "
                    f"{len(pairs)}")
            din, dout = dims[m]
            a_np = np.stack([np.asarray(a, np.float32) for a, _ in pairs])
            b_np = np.stack([np.asarray(b, np.float32) for _, b in pairs])
            if a_np.shape != (L, din, r) or b_np.shape != (L, r, dout):
                raise AdapterError(
                    f"target {m!r}: A/B shapes {a_np.shape}/{b_np.shape} "
                    f"!= expected {(L, din, r)}/{(L, r, dout)} "
                    f"(rank {r} pool)")
            staged[m] = (a_np, b_np)
        with torch.no_grad():
            for m, (a_np, b_np) in staged.items():
                at, bt = self._slabs[m]
                if self.stacked:
                    at, bt = at[:, page], bt[:, page]
                else:
                    at, bt = at[page], bt[page]
                at.copy_(torch.from_numpy(a_np))
                bt.copy_(torch.from_numpy(b_np))

    def evict(self, name: str):
        """Free the adapter's page.  Typed :class:`AdapterInUse` while any
        seated request pins it; the page's stale factors are unreachable
        once freed and are overwritten by the next registration."""
        with self._lock:
            ent = self._adapters.get(name)
            if ent is None:
                raise UnknownAdapter(f"adapter {name!r} is not registered")
            page, refs = ent
            if refs > 0:
                raise AdapterInUse(
                    f"adapter {name!r} (page {page}) is pinned by {refs} "
                    "seated request(s); drain or cancel them first")
            del self._adapters[name]
            self.allocator.free([page])

    # -- seating refcounts (engine integration) ----------------------------
    def acquire(self, name: str) -> int:
        """Pin ``name`` for one seated request -> its page id.  Typed
        :class:`UnknownAdapter` when the name is unknown (e.g. evicted
        while the request was queued)."""
        with self._lock:
            ent = self._adapters.get(name)
            if ent is None:
                raise UnknownAdapter(
                    f"adapter {name!r} is not registered (evicted while "
                    "the request was queued?)")
            ent[1] += 1
            return ent[0]

    def release(self, name: str):
        with self._lock:
            ent = self._adapters.get(name)
            if ent is not None:
                ent[1] = max(ent[1] - 1, 0)

    def refcount(self, name: str) -> int:
        with self._lock:
            ent = self._adapters.get(name)
            return 0 if ent is None else ent[1]

    def adapters(self) -> Dict[str, int]:
        """name -> page id snapshot."""
        with self._lock:
            return {k: v[0] for k, v in self._adapters.items()}

    def merged_state_dict(self, model, name: str) -> Dict[str, torch.Tensor]:
        """Offline reference: ``model``'s parameters with this adapter's
        delta MERGED into the dense weights (``W + scaling * A @ B``, in
        fp32, cast back to W's dtype) -- the oracle of the parity checks.
        Load it into a fresh model of the same config with
        ``load_state_dict``."""
        with self._lock:
            ent = self._adapters.get(name)
            if ent is None:
                raise UnknownAdapter(f"adapter {name!r} is not registered")
            page = ent[0]
        sd = {k: p.detach().clone() for k, p in model.named_parameters()}
        with torch.no_grad():
            for m in TARGETS:
                at, bt = self._slabs[m]
                a, b = ((at[:, page], bt[:, page]) if self.stacked
                        else (at[page], bt[page]))
                delta = torch.einsum("lir,lro->lio", a.float(),
                                     b.float()) * self.scaling
                keys = ([_STACKED_WEIGHTS[m]] if self.stacked else
                        [_LAYERED_WEIGHTS[m].format(i)
                         for i in range(self.cfg.num_layers)])
                for key, d in zip(keys, [delta] if self.stacked
                                  else delta.unbind(0)):
                    w = sd[key]
                    sd[key] = (w.float() + d.to(w.device)).to(w.dtype)
        return sd
