"""Paged decode attention: ONE query per (slot, head) over that slot's
pages of the global KV pool, the C == 1 paged step without a ragged plan.

Port of ``paddle_tpu/ops/pallas_kernels/paged_attention.py``.  Parts:

- ``gather_pages``, each slot's pages as one contiguous context (the
  chunked-prefill path and the plain versions use it), dequantized page
  by page for an int8 pool;
- the plain PyTorch version, ``paged_attention_plain``, the counterpart
  of ``_xla_paged_reference``: gather, fp32 scores, the ``NEG_INF``
  length mask, an fp32 softmax, probabilities cast to the q dtype before
  PV; a length-0 slot returns zeros;
- the Hopper kernel (``csrc/decode_attention.cu``: the decode kernel's
  split-and-merge design with the paged addressing) behind the public
  wrapper ``paged_attention``, which keeps the JAX signature.  Each
  (slot, head) row's keys are split over CTAs of ``keys_per_split`` keys;
  each CTA reads its slot's length from device memory, then the table
  entries of the pages its live keys touch, and only those pages.  Each
  writes a partial (m, l, acc) to a workspace and the last one of a row
  merges them in split order;
- ``split_merge_plain``, the same split-and-merge arithmetic over the
  pool in plain PyTorch (per-slot lengths, partials over key ranges that
  may straddle pages, merged in order), used only by the tests and
  ``chip_smoke.py`` to hold the kernel's design against the reference.

An int8 pool comes with ``k_scale``/``v_scale``, one fp32 scale per
(page, head): q joins the fp32 dequantization, the kernel dequantizes each
key and value as it reads it with its page's scale, and the output is
fp32.

The wrapper takes the plain version only for tensors on the CPU.  Any
other tensor launches the kernel (counted in ``paged_attention.launches``)
or raises ``ValueError``; nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ._build import KernelError
from . import decode_attention as _decode
from .decode_attention import (
    KERNEL_DTYPES, NEG_INF, scale_pointers, check_rows, check_scales,
    device_lengths, q_dtype, merge_partials, query_kernel_info,
    range_partial, workspace, workspace_shapes,
)

__all__ = [
    "paged_attention",
    "paged_attention_plain",
    "split_merge_plain",
    "gather_pages",
    "kernel_unsupported_reason",
    "kernel_info",
    "keys_per_split",
    "num_splits",
]


def gather_pages(pool: torch.Tensor, page_tables: torch.Tensor,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each row's paged context as a contiguous view: pool
    ``[P, H, page_size, D]``, page_tables ``[S, max_pages]`` ->
    ``[S, H, max_pages * page_size, D]``.  Position p of row s lives at
    ``pool[page_tables[s, p // page_size], :, p % page_size]``.  With
    ``scale`` ([P, H] fp32, an int8 pool) each gathered page is
    dequantized by its (page, head) scale and the result is fp32."""
    tbl = page_tables.long()
    g = pool[tbl]                                # [S, MP, H, ps, D]
    if scale is not None:
        g = g.float() * scale[tbl][..., None, None]
    s, mp, h, ps, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(s, h, mp * ps, d)


def paged_attention_plain(q, k_pool, v_pool, page_tables, lengths,
                          scale: float, k_scale=None, v_scale=None
                          ) -> torch.Tensor:
    """Gather plus masked single-query attention: q ``[S, H, D]`` over the
    first ``lengths[s]`` positions of each slot's pages, returning
    ``[S, H, D]`` in the q dtype; length-0 slots return zeros.  An int8
    pool's pages are dequantized as they are gathered (q is then fp32, so
    P is not rounded)."""
    k = gather_pages(k_pool, page_tables, k_scale)
    v = gather_pages(v_pool, page_tables, v_scale)
    s = torch.einsum("shd,shkd->shk", q.float(), k.float()) * scale
    lengths = lengths.to(torch.int64)
    valid = torch.arange(k.shape[2], device=k.device)[None, :] \
        < lengths[:, None]
    s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(lengths[:, None, None] > 0, p, torch.zeros_like(p))
    p = p.to(q.dtype).float()
    return torch.einsum("shk,shkd->shd", p, v.float()).to(q.dtype)


def split_merge_plain(q, k_pool, v_pool, page_tables, lengths,
                      scale: float, keys: int, k_scale=None, v_scale=None
                      ) -> torch.Tensor:
    """The paged launch's arithmetic in plain PyTorch: for each slot, its
    first ``lengths[s]`` positions (clamped to the table's capacity) cut
    into ranges of ``keys``, each range's keys read from their own pages
    (a range may straddle pages); each range's partial by
    ``range_partial``, then the ranges merged in order by
    ``merge_partials``.  Positions at or past a slot's
    length, and the table entries of pages holding only such positions,
    are never read, so a non-finite value there, or an entry naming no
    pool page, does not reach the output; a length-0 slot gives zeros.
    q ``[S, H, D]``, pools ``[P, H, page_size, D]``, page_tables ``[S,
    max_pages]``, lengths ``[S]`` -> ``[S, H, D]`` in the q dtype; an
    int8 pool with its ``[P, H]`` scales, dequantized as it is read (q
    fp32, P unrounded)."""
    slots, h, d = q.shape
    page = k_pool.shape[2]
    capacity = page_tables.shape[1] * page
    out = torch.zeros((slots, h, d), dtype=q.dtype, device=q.device)
    for s in range(slots):
        n = max(0, min(int(lengths[s]), capacity))
        parts = []
        for c0 in range(0, n, keys):
            pos = torch.arange(c0, min(c0 + keys, n), device=q.device)
            pages = page_tables[s, pos // page].long()
            k = k_pool[pages, :, pos % page].float()          # [nk, H, D]
            v = v_pool[pages, :, pos % page].float()
            if k_scale is not None:
                k = k * k_scale[pages][..., None]
                v = v * v_scale[pages][..., None]
            parts.append(range_partial(q[s], k.transpose(0, 1),
                                       v.transpose(0, 1), scale))
        if parts:
            out[s] = merge_partials(parts).to(q.dtype)
    return out


# the kernel's head dims: the decode kernel's
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 192, 256)


def kernel_unsupported_reason(head_dim: int, dtype: torch.dtype
                              ) -> Optional[str]:
    """``None`` when the paged kernel takes pools of this head_dim and
    dtype, else why not."""
    if dtype not in KERNEL_DTYPES:
        return _decode.kernel_unsupported_reason(head_dim, dtype)
    if head_dim not in KERNEL_HEAD_DIMS:
        return (f"head_dim={head_dim} (the paged kernel takes "
                f"{KERNEL_HEAD_DIMS}; other head dims are ROADMAP.md "
                "queue 2)")
    return None


def keys_per_split(head_dim: int, dtype: torch.dtype) -> int:
    """Keys one CTA of the paged launch takes (the kernel's ``Split::KS``,
    the decode launch's rule).  Raises ``ValueError`` for what the kernel
    does not take."""
    reason = kernel_unsupported_reason(head_dim, dtype)
    if reason is not None:
        raise ValueError(f"paged_attention kernel: {reason}")
    return _decode.keys_per_split(head_dim, dtype)


def num_splits(max_pages: int, page_size: int, head_dim: int,
               dtype: torch.dtype) -> int:
    """CTAs per (slot, head) row of the launch: the decode launch's count
    over the table's ``max_pages * page_size`` positions, sized on the
    host (the lengths stay on the device).  Raises ``ValueError`` for what
    the kernel does not take, an empty table, or more splits than a grid
    dimension holds (65535)."""
    keys_per_split(head_dim, dtype)
    if max_pages < 1 or page_size < 1:
        raise ValueError(f"paged_attention kernel: max_pages={max_pages}, "
                         f"page_size={page_size}")
    return _decode.num_splits(max_pages * page_size, head_dim, dtype)


def kernel_info(dtype: torch.dtype, head_dim: int, device: int = 0) -> dict:
    """What a paged launch at this pool dtype and head_dim runs on CUDA
    device ``device``: shared memory per CTA (bytes), registers per
    thread, CTAs resident per SM, threads per CTA, local memory per
    thread (bytes, the spills) and keys per split."""
    return query_kernel_info("decode_attention",
                             "paged_attention_kernel_info",
                             "decode_attention_error_string",
                             KERNEL_DTYPES[dtype], head_dim, device)


_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        lib = _build.library("decode_attention")
        fn = lib.paged_attention_forward
        i32, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = [i32, i32, i32, ptr, i64, i64, ptr, ptr, ptr, ptr, ptr,
                       ptr, ptr, i32, i32, i32, i32, ctypes.c_float, i32, i32,
                       ptr, ptr, ptr]
        fn.restype = i32
        lib.decode_attention_error_string.argtypes = [i32]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.decode_attention_error_string)
    return _fn


def _launch(q, k_pool, v_pool, page_tables, lengths, scale: float,
            k_scale=None, v_scale=None) -> torch.Tensor:
    """Check everything the kernel assumes, then launch it on the current
    stream."""
    dev = k_pool.device
    _, h, page_size, d = k_pool.shape
    keys = keys_per_split(d, k_pool.dtype)
    for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
        check_rows(name, pool, 4, dev, k_pool.dtype)
        if not pool.is_contiguous() or pool.shape != k_pool.shape:
            raise ValueError(f"{name} must be a contiguous "
                             f"{tuple(k_pool.shape)} pool")
    if page_tables.dim() != 2 or page_tables.device != dev \
            or page_tables.dtype.is_floating_point:
        raise ValueError(f"page_tables must be an integer [S, max_pages] "
                         f"tensor on {dev}; got {page_tables.dtype} "
                         f"{tuple(page_tables.shape)} on "
                         f"{page_tables.device}")
    slots, max_pages = page_tables.shape
    qd = q_dtype(k_pool.dtype)
    if q.shape != (slots, h, d) or q.dtype != qd \
            or q.device != dev or q.stride(2) != 1:
        raise ValueError(f"q is {q.dtype} {tuple(q.shape)} {q.stride()} on "
                         f"{q.device}; expected {qd} ({slots}, "
                         f"{h}, {d}) with contiguous rows on {dev}")
    ks, vs = scale_pointers(k_scale, v_scale)
    splits = num_splits(max_pages, page_size, d, k_pool.dtype)
    shapes = workspace_shapes(slots * h, splits, d)
    tables = page_tables.to(torch.int32).contiguous()
    lens = device_lengths(lengths, slots, dev)
    out = torch.empty((slots, h, d), dtype=q.dtype, device=dev)
    fn, err_str = _kernel_fn()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = workspace(dev, stream, shapes)
    err = fn(dev.index, KERNEL_DTYPES[k_pool.dtype], d, q.data_ptr(),
             q.stride(0), q.stride(1), k_pool.data_ptr(), v_pool.data_ptr(),
             ks, vs, tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
             slots, h, page_size, max_pages, float(scale), keys, splits,
             ws["partials"].data_ptr(), ws["tickets"].data_ptr(), stream)
    if err != 0:
        raise KernelError("paged_attention kernel launch failed: "
                        f"{err_str(err).decode()} (cudaError {err})")
    paged_attention.launches += 1
    return out


def paged_attention(q, k_pool, v_pool, page_tables, lengths, *,
                    sm_scale: Optional[float] = None, k_scale=None,
                    v_scale=None) -> torch.Tensor:
    """Single-query attention over a paged KV block pool.

    q:           [S, H, D] -- the ONE new query per (slot, head); rows may
                 be strided (a view into the fused QKV output)
    k_pool:      [P, H, page_size, D] -- the global page pool
    v_pool:      [P, H, page_size, D]
    page_tables: [S, max_pages] int32 -- per-slot page ids, table order;
                 every entry of a page below the slot's length must name a
                 pool page (the kernel reads no entry past it)
    lengths:     [S] int32 -- valid positions per slot (0 = inactive slot,
                 defined to return zeros)
    k_scale/v_scale: [P, H] fp32 per-(page, head) scales of an int8 pool
                 (given with an int8 pool, and only then)
    returns      [S, H, D] in the pool dtype (q is cast to it first); fp32
                 for an int8 pool

    CPU tensors run the plain version; any other tensor launches the
    Hopper kernel or raises."""
    p, h, _, d = k_pool.shape
    scale = float(sm_scale if sm_scale is not None else 1.0 / (d ** 0.5))
    check_scales(k_pool, k_scale, v_scale, (p, h))
    q = q.to(q_dtype(k_pool.dtype))
    if k_pool.device.type == "cpu" and q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, page_tables, lengths,
                                     scale, k_scale, v_scale)
    return _launch(q, k_pool, v_pool, page_tables, lengths, scale, k_scale,
                   v_scale)


# kernel launches made through the wrapper (plain-version calls on the
# CPU never count); callers reset it to 0 before a run they measure
paged_attention.launches = 0
