"""Autoregressive decode over a contiguous KV cache: ``generate()`` (port
of ``paddle_tpu/models/generation.py``).

- The KV cache is preallocated on the model's device (``[L, B, H,
  max_seq, D]`` for the stacked GPT, one ``[B, H, max_seq, D]`` pair a
  layer for the layered one) and written in place, position by
  position; the position of a decode step is a device int tensor, never
  a host int, so the loop makes no host sync until it returns (without
  ``eos_token_id``).
- The whole-prompt prefill runs the flash forward kernel
  (``ops/kernels/flash_attention.py``) at any prompt length; every later
  token runs the decode-attention kernel
  (``ops/kernels/decode_attention.py``) over ``pos + 1`` positions.
- Sampling (greedy / temperature / top-k / top-p) is plain torch on the
  ``[B, V]`` logits; its Gumbel noise comes from an explicit
  ``torch.Generator``.

Caches are kept per (batch, max_seq, cache dtype) on the model,
LRU-bounded at ``_MAX_ENGINES``, each behind its own lock; a later
``generate()`` of the same shape reuses the cache's memory.  The JAX
package's ``trace_counts``/``compiled_programs`` count traces of its
compiled prefill and decode programs; PyTorch runs the steps eagerly,
so there is nothing to count and they are not ported.

Model contract: a model mixes in :class:`GenerationMixin` and implements
``new_kv_cache(batch_size, max_seq, dtype)`` plus
``_cached_lm_logits(input_ids, kv_cache, cache_index) -> [B, S, V]``
(which must write the step's K/V into the cache in place).
"""
from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

from ..core import dtype_name, resolve_device, to_torch_dtype

__all__ = [
    "KVCache",
    "GenerationMixin",
    "filter_logits",
    "sample_tokens",
    "generate",
]


class _KVBuffers:
    """Size accounting and release shared by :class:`KVCache` and the
    serving pool (``serving.paged_cache.PagedKVCache``), so the two cannot
    drift: ``_FIELDS`` names the attributes that hold device tensors, each
    a tensor (the stacked layout), a list of them (one a layer) or None."""

    _FIELDS = ("k", "v")
    # a cache placed over a training mesh (:meth:`_place`): ``(layers,
    # shard caches)`` a group; None for a cache of its own tensors
    groups = None

    def _tensors(self) -> List[torch.Tensor]:
        if self.groups is not None:
            return [t for _, subs in self.groups for s in subs
                    for t in s._tensors()]
        out = []
        for t in (getattr(self, f) for f in self._FIELDS):
            if isinstance(t, list):
                out.extend(t)
            elif t is not None:
                out.append(t)
        return out

    def _place(self, placement, num_heads: int, make):
        """Hold the cache as the groups of ``placement`` -- ``(layers,
        devices)`` pairs: the layers each group holds and the devices of
        their tensor-parallel shards -- each shard a cache of ``make(n
        layers, heads, device)`` in the stacked layout, cut by heads
        (``num_heads / len(devices)`` a shard).  Layer ``l``'s tensors on
        each shard are read through :meth:`layer_shards`."""
        groups, where = [], {}
        for layers, devs in placement:
            devs = tuple(devs)
            if num_heads % len(devs):
                raise ValueError(f"num_heads={num_heads} is not divisible "
                                 f"by mp={len(devs)}")
            hs = num_heads // len(devs)
            for j, layer in enumerate(layers):
                where[int(layer)] = (len(groups), j)
            groups.append((tuple(int(x) for x in layers),
                           [make(len(layers), hs, d) for d in devs]))
        self.groups, self._where = groups, where
        self.device = groups[0][1][0].device

    def layer_shards(self, i: int) -> list:
        """Layer ``i``'s tensors of a placed cache, one tuple a
        tensor-parallel shard in shard order: each field of the cache
        (``(k, v)``; a page pool's ``(k, v, k_scale, v_scale)``, None for
        a float pool's scales) as the layer's view."""
        g, j = self._where[i]
        return [tuple(None if t is None else t[j]
                      for t in (getattr(s, f) for f in self._FIELDS))
                for s in self.groups[g][1]]

    @property
    def nbytes(self) -> int:
        """Device bytes of every tensor the cache holds."""
        return sum(t.numel() * t.element_size() for t in self._tensors())

    def release(self):
        """Drop the cache's tensors now; their memory goes back to
        PyTorch's allocator for the next allocation.  The cache is unusable
        afterwards."""
        for _, subs in self.groups or ():
            for sub in subs:
                sub.release()
        for f in self._FIELDS:
            setattr(self, f, None)


class KVCache(_KVBuffers):
    """Preallocated KV cache on ``device``, zero-initialised.

    ``stacked=False`` (the reference's default; the layered GPT's): per-
    layer tensor pairs, ``k[i]``/``v[i]`` of ``[B, H, max_seq, D]``, read
    through :meth:`layer`.  ``stacked=True`` (the stacked GPT's): one pair
    of ``[L, B, H, max_seq, D]`` tensors read whole, layer ``l``'s cache
    the view ``k[l]``.

    ``placement`` (a model placed on a training mesh): ``(layers,
    devices)`` groups (:meth:`_KVBuffers._place`): each group's layers
    cut by heads over its shard devices, one stacked cache a shard, read
    through :meth:`layer_shards`; ``k``/``v`` are then None.

    Stale content past the current length is never read by the kernels
    (every read is length-bounded), so a cache is reused across
    ``generate()`` calls without re-zeroing."""

    paged = False

    def __init__(self, num_layers: int, batch_size: int, num_heads: int,
                 max_seq: int, head_dim: int, dtype="bfloat16",
                 stacked: bool = False, *, device=None, placement=None):
        self.num_layers = num_layers
        self.batch_size = batch_size
        self.num_heads = num_heads
        self.max_seq = max_seq
        self.head_dim = head_dim
        self.dtype = dtype_name(dtype)
        self.stacked = bool(stacked)
        if placement is not None:
            self.k = self.v = None
            self._place(placement, num_heads, lambda n, hs, d: KVCache(
                n, batch_size, hs, max_seq, head_dim, dtype, True,
                device=d))
            return
        self.device = resolve_device(device)
        td = to_torch_dtype(dtype)
        shape = (batch_size, num_heads, max_seq, head_dim)
        self.k, self.v = (
            torch.zeros((num_layers,) + shape, dtype=td, device=self.device)
            if stacked else [torch.zeros(shape, dtype=td, device=self.device)
                             for _ in range(num_layers)]
            for _ in range(2))

    def layer(self, i: int):
        """(k, v) of layer ``i`` (the per-layer layout only)."""
        if self.groups is not None:
            raise ValueError("layer(): the cache is placed over a mesh; "
                             "read layer_shards(i)")
        if self.stacked:
            raise ValueError("layer() is for the per-layer cache layout; "
                             "the stacked cache is read whole")
        return self.k[i], self.v[i]



# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

_NEG = -1e30


def filter_logits(logits: torch.Tensor, top_k: int = 0,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """Top-k / nucleus (top-p) logit filtering over ``[B, V]``.

    Filtered positions get -1e30 so the downstream softmax renormalizes
    over the kept set.  Top-p keeps the smallest prefix of the
    probability-sorted vocab whose mass reaches ``top_p`` (always at least
    the argmax token)."""
    vocab = logits.shape[-1]
    neg = torch.full_like(logits, _NEG)
    if top_k and 0 < top_k < vocab:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]     # [B, 1]
        logits = torch.where(logits < kth, neg, logits)
    if top_p is not None:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        # mass strictly above each rank; rank kept iff that mass < top_p
        prev_mass = torch.cumsum(probs, dim=-1) - probs
        keep = prev_mass < top_p
        thresh = torch.where(keep, sorted_l, torch.full_like(sorted_l, -_NEG)
                             ).min(dim=-1, keepdim=True).values
        logits = torch.where(logits < thresh, neg, logits)
    return logits


def sample_tokens(logits: torch.Tensor, *, do_sample: bool,
                  temperature: Optional[float] = None, top_k: int = 0,
                  top_p: Optional[float] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Next-token selection over ``[B, V]`` logits -> int64 ``[B]``.

    Greedy is a pure argmax; sampling applies temperature, then top-k /
    top-p filtering, and draws by the Gumbel-argmax trick with uniform
    noise from ``generator`` (required when ``do_sample``).  A uniform 0
    gives a Gumbel of -inf, never +inf, so a filtered token is never
    drawn."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError("sampling needs an explicit torch.Generator")
    if temperature is not None:
        logits = logits / temperature
    logits = filter_logits(logits, top_k=top_k, top_p=top_p).float()
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


# ---------------------------------------------------------------------------
# the decode engine: one cache per request shape
# ---------------------------------------------------------------------------

class _DecodeEngine:
    """One KV cache bound to a model, cached on the model per (batch,
    max_seq, cache dtype): repeated ``generate()`` calls of that shape
    reuse its memory."""

    def __init__(self, cache: KVCache):
        self.cache = cache
        # one generate() at a time per engine: the steps mutate the SHARED
        # cache, so concurrent callers of one request shape serialize per
        # engine; distinct engines run concurrently.  `released` flips
        # under the lock when eviction drops the cache; a caller that
        # raced the eviction (engine looked up, lock not yet taken) sees
        # it and fetches a fresh engine.
        self.lock = threading.RLock()
        self.released = False

    def release(self):
        """Drop the engine's cache.  Taking ``self.lock`` first means an
        in-flight generate() on this engine finishes before the tensors
        go; ``released`` tells a caller that looked the engine up just
        before to retry with a fresh one."""
        with self.lock:
            self.cache.release()
            self.released = True


# each cached engine pins a full KV cache on the card; bound how many
# distinct (batch, max_seq, dtype) combinations stay resident
_MAX_ENGINES = 4


def _engine_for(model, batch: int, max_seq: int,
                cache_dtype: str) -> _DecodeEngine:
    # dict.setdefault is atomic, so concurrent first calls agree on one
    # lock and one registry
    lock = model.__dict__.setdefault("_decode_engines_lock",
                                     threading.Lock())
    with lock:
        engines = model.__dict__.setdefault("_decode_engines", {})
        key = (batch, max_seq, dtype_name(cache_dtype))
        eng = engines.pop(key, None)
        if eng is not None and eng.released:
            eng = None        # cache already dropped: build a fresh one
        if eng is None:
            while len(engines) >= _MAX_ENGINES:
                # LRU: dict order is move-to-back-on-use
                engines.pop(next(iter(engines))).release()
            eng = _DecodeEngine(model.new_kv_cache(batch, max_seq,
                                                   dtype=cache_dtype))
        engines[key] = eng  # (re)insert at the back = most recently used
        return eng


def _as_ids(model, input_ids) -> torch.Tensor:
    """``input_ids`` (numpy, a list or a tensor on any device) as an int64
    ``[B, S0]`` tensor on the model's device."""
    ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(
        input_ids, torch.Tensor) else input_ids)
    if ids.dim() != 2 or ids.dtype.is_floating_point:
        raise ValueError(f"input_ids must be integer [B, S0]; got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    return ids.to(device=model.device, dtype=torch.int64)


def generate(model, input_ids, max_new_tokens: int = 32, *,
             do_sample: bool = False, temperature: float = 1.0,
             top_k: int = 0, top_p: Optional[float] = None,
             eos_token_id: Optional[int] = None,
             max_seq_len: Optional[int] = None,
             cache_dtype: str = "bfloat16", return_logits: bool = False,
             generator: Optional[torch.Generator] = None):
    """Autoregressive generation from ``input_ids`` ``[B, S0]`` (numpy or a
    tensor on any device; moved to the model's device).

    Returns ``[B, S0 + max_new_tokens]`` int64 token ids on the model's
    device (prompt included), or ``(ids, logits)`` with ``logits``
    ``[B, max_new_tokens, V]`` fp32 (the pre-sampling logits of each
    generated position) when ``return_logits=True``.

    Sampling draws from ``generator`` (a ``torch.Generator`` on the
    model's device); without one, a fresh generator seeded from the
    operating system is made for the call, so only an explicit generator
    makes sampling reproducible.

    Without ``eos_token_id`` the loop makes no host sync until it
    returns.  With it, each step copies the tokens back to decide an
    early stop; rows keep their first ``eos_token_id`` and are padded with
    it afterwards.  Under ``return_logits`` positions at or after a row's
    first eos carry the distribution conditioned on the raw sampled
    continuation (the id padding is applied afterwards), and the
    all-rows-done early stop is off so every logits row is real."""
    ids = _as_ids(model, input_ids)
    b, s0 = int(ids.shape[0]), int(ids.shape[1])
    cfg = model.config
    max_seq = int(max_seq_len or cfg.max_position_embeddings)
    if max_seq > cfg.max_position_embeddings:
        raise ValueError(
            f"max_seq_len={max_seq} exceeds max_position_embeddings="
            f"{cfg.max_position_embeddings}")
    if s0 + max_new_tokens > max_seq:
        raise ValueError(
            f"prompt ({s0}) + max_new_tokens ({max_new_tokens}) exceeds the "
            f"cache length {max_seq}; raise max_seq_len (<= "
            f"max_position_embeddings) or shorten the request")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if do_sample and not float(temperature) > 0.0:
        raise ValueError("temperature must be > 0 when do_sample=True")
    if do_sample and generator is None:
        generator = torch.Generator(device=model.device)
        generator.seed()

    def pick(logits):
        return sample_tokens(
            logits, do_sample=do_sample,
            temperature=float(temperature) if do_sample else None,
            top_k=int(top_k or 0),
            top_p=top_p if do_sample and top_p is not None else None,
            generator=generator)

    # eng.lock: the steps mutate the engine's shared cache, so a second
    # thread on the same request shape serializes here instead of
    # interleaving decode steps through one cache.  The retry loop closes
    # the lookup->lock window: an engine evicted in between flips
    # `released` under its lock, and we fetch a fresh one.
    while True:
        eng = _engine_for(model, b, max_seq, cache_dtype)
        with eng.lock:
            if eng.released:
                continue
            was_training = model.training
            model.eval()
            try:
                with torch.no_grad():
                    toks, logit_steps = _decode_loop(
                        model, eng.cache, ids, max_new_tokens, pick,
                        eos_token_id, return_logits)
            finally:
                model.train(was_training)
            break

    gen = torch.stack(toks, dim=1)                              # [B, N]
    if eos_token_id is not None:
        # freeze every row at its first eos: positions after it become eos
        hit = torch.cumsum((gen == eos_token_id).long(), dim=1) > 0
        after = torch.zeros_like(hit)
        after[:, 1:] = hit[:, :-1]
        gen = torch.where(after, torch.full_like(gen, eos_token_id), gen)
    out = torch.cat([ids, gen], dim=1)
    if return_logits:
        return out, torch.stack(logit_steps, dim=1)             # [B, N, V]
    return out


def _decode_loop(model, cache, ids, max_new_tokens, pick, eos_token_id,
                 return_logits):
    """The prefill at position 0 (a Python 0: the whole-prompt path), then
    ``max_new_tokens - 1`` decode steps with the position a device int32
    tensor.  Returns (tokens per step, fp32 logits per step)."""
    last = model._cached_lm_logits(ids, cache, 0)[:, -1, :].float()
    tok = pick(last)
    toks: List[torch.Tensor] = [tok]
    logit_steps: List[torch.Tensor] = [last] if return_logits else []
    pos = torch.full((), ids.shape[1], dtype=torch.int32, device=ids.device)
    done = None
    if eos_token_id is not None:
        done = (tok == eos_token_id).cpu().numpy()
    for _ in range(max_new_tokens - 1):
        if done is not None and bool(done.all()) and not return_logits:
            # every row finished: pad the remaining steps instead of
            # decoding.  (With return_logits the loop keeps decoding so
            # every returned row is a real model distribution.)
            toks.append(torch.full_like(tok, eos_token_id))
            continue
        last = model._cached_lm_logits(tok[:, None], cache, pos)[:, -1, :]
        last = last.float()
        tok = pick(last)
        pos = pos + 1
        toks.append(tok)
        if return_logits:
            logit_steps.append(last)
        if done is not None:
            done = done | (tok == eos_token_id).cpu().numpy()
    return toks, logit_steps


class GenerationMixin:
    """Adds ``generate()`` to a causal LM exposing the cache contract
    (``new_kv_cache`` + ``_cached_lm_logits``).

    Caches are kept per request shape, LRU-bounded at ``_MAX_ENGINES``;
    call :meth:`clear_decode_cache` to drop them all now (e.g. before
    resuming training on a memory-tight card)."""

    def generate(self, input_ids, max_new_tokens: int = 32, **kwargs):
        return generate(self, input_ids, max_new_tokens, **kwargs)

    def clear_decode_cache(self):
        """Drop every cached engine and its KV cache."""
        lock = self.__dict__.get("_decode_engines_lock")
        if lock is None:
            engines = self.__dict__.pop("_decode_engines", None)
        else:
            with lock:
                engines = self.__dict__.pop("_decode_engines", None)
        for eng in (engines or {}).values():
            eng.release()
