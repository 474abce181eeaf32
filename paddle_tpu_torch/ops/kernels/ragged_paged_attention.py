"""Ragged paged attention: ONE launch per layer for a fused mixed
prefill/decode serving step over the paged KV pool.

Port of ``paddle_tpu/ops/pallas_kernels/ragged_paged_attention.py``.
Every query token of the step -- decode tokens and prefill-chunk tokens
alike -- is one row of a flat ``[T, H, D]`` buffer; the host packs rows
into token blocks (one slot per block, consecutive positions) and builds a
work list of (token block, pool page, page slot) items.  Three parts:

- the host plan builder, ``build_ragged_plan`` and ``RAGGED_PLAN_FIELDS``,
  copied verbatim from the JAX package (numpy);
- the plain PyTorch version, ``ragged_paged_attention_plain``: each token
  gathers its slot's pages (``paged_attention.gather_pages``) and runs
  masked single-query attention with an fp32 softmax, as
  ``paged_attention._xla_paged_reference`` does;
- the Hopper kernel (``csrc/ragged_paged_attention.cu``) behind the public
  wrapper ``ragged_paged_attention``, which keeps the JAX signature.  It
  runs one CTA per (split, head), a split being ``keys_per_split`` keys of
  one work item's page (bf16 on the tensor cores); each CTA writes a
  partial (m, l, O) to a workspace and the last one of a (block, head)
  merges the block's splits in work-list order;
- ``split_merge_plain``, the same split-and-merge arithmetic in plain
  PyTorch (partials over each block's page splits, merged in order), used
  only by the tests and ``chip_smoke.py`` to hold the kernel's design
  against the reference on the CPU.

An int8 pool comes with ``k_scale``/``v_scale``, one fp32 scale per
(page, head): q joins the fp32 dequantization, the kernel dequantizes each
staged page chunk as it reads it, and the output is fp32.

The wrapper takes the plain version only for tensors on the CPU.  A CUDA
tensor launches the kernel or raises; nothing falls back.  Forward only:
serving never differentiates through the pool.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from ._build import KernelError
from .decode_attention import (
    SPLIT_KV_BYTES, check_scales, merge_partials, q_dtype, query_kernel_info,
    scale_pointers, workspace,
)
from .paged_attention import gather_pages

__all__ = [
    "ragged_paged_attention",
    "ragged_paged_attention_plain",
    "split_merge_plain",
    "build_ragged_plan",
    "kernel_unsupported_reason",
    "kernel_info",
    "keys_per_split",
    "splits_per_page",
    "workspace_shapes",
    "RAGGED_PLAN_FIELDS",
    "TOKEN_BLOCK",
    "NEG_INF",
]

NEG_INF = -1e30
# the port's token block: rows per block of the plan, and the kernel's
# compile-time row count
TOKEN_BLOCK = 16
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 192, 256)
# the pool dtype's code in the C interface: q and the output share a
# float pool's dtype; an int8 pool takes fp32 q and gives fp32
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# the ordered field names of a ragged plan -- the host builder emits them,
# the serving engine ships them (as int32 tensors) into the fused step,
# and the kernel consumes them positionally
RAGGED_PLAN_FIELDS = (
    "blk_tok",      # [NB, QB]  flat token index feeding each block row
    "tok_blk",      # [T]       inverse map: token -> its block
    "tok_row",      # [T]       inverse map: token -> its row in the block
    "blk_base",     # [NB]      absolute position of each block's row 0
    "blk_rows",     # [NB]      valid rows per block (0 = padding block)
    "wl_blk",       # [WL]      work item -> token block
    "wl_page",      # [WL]      work item -> POOL page id (pre-translated)
    "wl_pageslot",  # [WL]      work item -> page-slot (for position math)
    "n_items",      # [1]       real work items (tail entries are clamped)
)


# ---------------------------------------------------------------------------
# host-side plan construction (numpy; built from the scheduler mirrors)
# ---------------------------------------------------------------------------

def build_ragged_plan(runs: Sequence[Tuple[int, int, np.ndarray]], *,
                      token_block: int, page_size: int,
                      t_max: int, nb_max: int, wl_max: int
                      ) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """Flatten one fused step's work into the kernel's plan arrays.

    ``runs``: one entry per contiguous token run -- a decode slot (count 1)
    or a prefill chunk (count up to the step's token budget) -- as
    ``(base_pos, count, table_row)`` where ``table_row`` is the slot's
    int32 page-table row.  Token flat order is run-major: run r's tokens
    occupy flat indices ``[start_r, start_r + count_r)`` in submission
    order (``stats["run_starts"]`` reports the starts).

    Every array is padded to its fixed maximum (``t_max``/``nb_max``/
    ``wl_max``); the work-list tail REPEATS the last real entry, and the
    kernel visits only the first ``n_items`` entries.  Padding block-gather
    rows point at the block's first token (a valid index; the row is
    masked and never written).

    Returns ``(plan_arrays, stats)``: the arrays keyed by
    :data:`RAGGED_PLAN_FIELDS`, and stats with ``n_tokens``/``n_blocks``/
    ``n_items``/``run_starts`` plus the grid-occupancy numerators the
    serving metrics report."""
    qb = int(token_block)
    blk_tok = np.zeros((nb_max, qb), np.int32)
    tok_blk = np.zeros((t_max,), np.int32)
    tok_row = np.zeros((t_max,), np.int32)
    blk_base = np.zeros((nb_max,), np.int32)
    blk_rows = np.zeros((nb_max,), np.int32)
    items: List[Tuple[int, int, int]] = []     # (block, pool page, page-slot)
    t = 0
    b = 0
    run_starts: List[int] = []
    for base, count, table in runs:
        base, count = int(base), int(count)
        if count < 1:
            raise ValueError(f"run with count={count}; every run must "
                             "carry at least one token")
        run_starts.append(t)
        if t + count > t_max:
            raise ValueError(f"plan overflow: {t + count} tokens > "
                             f"t_max={t_max}")
        off = 0
        while off < count:
            rows = min(qb, count - off)
            if b >= nb_max:
                raise ValueError(f"plan overflow: block {b} >= "
                                 f"nb_max={nb_max}")
            blk_tok[b, :rows] = np.arange(t + off, t + off + rows, dtype=np.int32)
            blk_tok[b, rows:] = t + off
            blk_base[b] = base + off
            blk_rows[b] = rows
            tok_blk[t + off:t + off + rows] = b
            tok_row[t + off:t + off + rows] = np.arange(rows, dtype=np.int32)
            last_pos = base + off + rows - 1
            n_pages = last_pos // page_size + 1
            for ps_i in range(n_pages):
                items.append((b, int(table[ps_i]), ps_i))
            off += rows
            b += 1
        t += count
    n_items = len(items)
    if n_items > wl_max:
        raise ValueError(f"plan overflow: {n_items} work items > "
                         f"wl_max={wl_max}")
    if n_items == 0:
        raise ValueError("empty plan: the fused step must not be "
                         "dispatched with no runs")
    wl_blk = np.full((wl_max,), items[-1][0], np.int32)
    wl_page = np.full((wl_max,), items[-1][1], np.int32)
    wl_ps = np.full((wl_max,), items[-1][2], np.int32)
    for w, (bi, pg, psi) in enumerate(items):
        wl_blk[w] = bi
        wl_page[w] = pg
        wl_ps[w] = psi
    plan = {
        "blk_tok": blk_tok, "tok_blk": tok_blk, "tok_row": tok_row,
        "blk_base": blk_base, "blk_rows": blk_rows,
        "wl_blk": wl_blk, "wl_page": wl_page, "wl_pageslot": wl_ps,
        "n_items": np.array([n_items], np.int32),
    }
    stats = {
        "n_tokens": t, "n_blocks": b, "n_items": n_items,
        "run_starts": run_starts,
        # grid occupancy: the fraction of the fixed launch doing real work
        # (items) and of the block rows carrying real queries (rows)
        "wl_capacity": wl_max,
        "row_capacity": b * qb,
    }
    return plan, stats


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------

def ragged_paged_attention_plain(q, k_pool, v_pool, token_tables, lengths,
                                 scale: float, k_scale=None, v_scale=None
                                 ) -> torch.Tensor:
    """Per-token gather plus masked single-query attention: each flat
    token attends over its own ``lengths[t]`` positions of its table row.
    fp32 scores and softmax with the finite ``NEG_INF``; the probabilities
    are cast to the q dtype before the PV product; length-0 tokens
    return zeros.  ``q`` is already in the pool dtype (fp32 for an int8
    pool, whose pages are dequantized as they are gathered); the result
    is too."""
    k = gather_pages(k_pool, token_tables, k_scale)
    v = gather_pages(v_pool, token_tables, v_scale)
    s = torch.einsum("shd,shkd->shk", q.float(), k.float()) * scale
    lengths = lengths.to(torch.int64)
    pos = torch.arange(k.shape[2], device=k.device)
    valid = pos[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(lengths[:, None, None] > 0, p, torch.zeros_like(p))
    p = p.to(q.dtype).float()
    return torch.einsum("shk,shkd->shd", p, v.float()).to(q.dtype)


def split_merge_plain(q, k_pool, v_pool, plan, scale: float, keys: int,
                      k_scale=None, v_scale=None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, from the plan alone: for
    each block and each of its items (in work-list order, the first
    ``n_items``), the page cut into splits of ``keys`` keys, only those up
    to the block's last position ``max_pos`` read; each split's partial
    (m, l, O) over its visible keys -- fp32 scores, the causal mask before
    the max, ``p = exp(s - m)`` against the split's own max (0 where
    masked), ``l`` the sum of the unrounded p, O the sum of p rounded to
    the q dtype times V -- then the block's splits merged in order,
    ``O = sum_s e^(m_s - m) O_s / sum_s e^(m_s - m) l_s``, and each valid
    row written to its flat token; padding tokens are zeros.  ``plan`` as
    the kernel takes it (int32 tensors of ``RAGGED_PLAN_FIELDS``); an int8
    pool with its ``[P, H]`` scales is dequantized as it is read (q fp32,
    P unrounded).  Returns ``[T, H, D]`` in the q dtype."""
    p = dict(zip(RAGGED_PLAN_FIELDS, (a.tolist() for a in plan)))
    t, h, d = q.shape
    page_size = k_pool.shape[2]
    out = torch.zeros((t, h, d), dtype=torch.float32, device=q.device)
    n = min(p["n_items"][0], len(p["wl_blk"]))
    items: Dict[int, list] = {}
    for w in range(n):
        items.setdefault(p["wl_blk"][w], []).append(w)
    for blk, ws in items.items():
        rows, base = p["blk_rows"][blk], p["blk_base"][blk]
        if rows <= 0:
            continue
        max_pos = base + rows - 1
        toks = p["blk_tok"][blk][:rows]
        qb = q[toks].float()                                # [rows, H, D]
        row_pos = torch.arange(base, base + rows, device=q.device)
        parts = []
        for w in ws:
            page, ps = p["wl_page"][w], p["wl_pageslot"][w]
            for k0 in range(0, page_size, keys):
                pos0 = ps * page_size + k0
                if pos0 > max_pos:
                    break
                nk = min(keys, page_size - k0, max_pos - pos0 + 1)
                k = k_pool[page, :, k0:k0 + nk].float()     # [H, nk, D]
                v = v_pool[page, :, k0:k0 + nk].float()
                if k_scale is not None:
                    k = k * k_scale[page][:, None, None]
                    v = v * v_scale[page][:, None, None]
                s = torch.einsum("rhd,hkd->hrk", qb, k) * scale
                vis = (pos0 + torch.arange(nk, device=q.device))[None, :] \
                    <= row_pos[:, None]                     # [rows, nk]
                s = torch.where(vis[None], s, torch.full_like(s, NEG_INF))
                m = s.amax(dim=-1)                          # [H, rows]
                pr = torch.where(vis[None], torch.exp(s - m[..., None]),
                                 torch.zeros_like(s))
                o = torch.einsum("hrk,hkd->hrd", pr.to(q.dtype).float(), v)
                parts.append((m, pr.sum(dim=-1), o))
        out[toks] = merge_partials(parts).transpose(0, 1)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# the Hopper kernel
# ---------------------------------------------------------------------------

def kernel_unsupported_reason(page_size: int, head_dim: int,
                              token_block: int, dtype: torch.dtype
                              ) -> Optional[str]:
    """``None`` when the kernel takes this layout, else why not."""
    if dtype not in KERNEL_DTYPES:
        return (f"pool dtype {dtype} (the kernel takes float32, bfloat16 "
                "and int8)")
    if head_dim not in KERNEL_HEAD_DIMS:
        return f"head_dim={head_dim} (the kernel takes {KERNEL_HEAD_DIMS})"
    if page_size % 16 or not 16 <= page_size <= 128:
        return (f"page_size={page_size} (the kernel takes a multiple of 16 "
                "up to 128)")
    if token_block != TOKEN_BLOCK:
        return (f"token_block={token_block} (the kernel takes "
                f"{TOKEN_BLOCK})")
    return None


def keys_per_split(head_dim: int, dtype: torch.dtype) -> int:
    """Keys one CTA takes (the kernel's ``Geometry::KS``): the largest of
    128 (bf16 only: the FMA path's 16-row blocks are bound by
    instructions), 64 and 32 whose K and V fit ``SPLIT_KV_BYTES``, else 16.
    Raises ``ValueError`` for a head_dim or dtype the kernel does not
    take."""
    reason = kernel_unsupported_reason(16, head_dim, TOKEN_BLOCK, dtype)
    if reason is not None:
        raise ValueError(f"ragged_paged_attention kernel: {reason}")
    raw = SPLIT_KV_BYTES // (2 * head_dim * torch.empty(
        (), dtype=dtype).element_size())
    sizes = (128, 64, 32) if dtype == torch.bfloat16 else (64, 32)
    return next((k for k in sizes if raw >= k), 16)


def splits_per_page(page_size: int, head_dim: int, dtype: torch.dtype
                    ) -> int:
    """CTAs per work item and head: ``ceil(page_size / keys_per_split)``.
    Raises ``ValueError`` for a layout the kernel does not take."""
    reason = kernel_unsupported_reason(page_size, head_dim, TOKEN_BLOCK,
                                       dtype)
    if reason is not None:
        raise ValueError(f"ragged_paged_attention kernel: {reason}")
    return -(-page_size // keys_per_split(head_dim, dtype))


def workspace_shapes(wl_max: int, nb_max: int, heads: int, page_size: int,
                     head_dim: int, dtype: torch.dtype) -> Dict[str, tuple]:
    """The kernel's workspace for a plan of ``wl_max`` items and
    ``nb_max`` blocks: fp32 partials, ``O`` [wl_max * splits_per_page,
    heads, 16, head_dim] then ``(m, l)`` [..., 16, 2], as one flat buffer,
    and one int32 ticket per (block, head).  Raises ``ValueError`` for
    what the kernel does not take."""
    spp = splits_per_page(page_size, head_dim, dtype)
    if wl_max < 1 or nb_max < 1 or not 1 <= heads <= 65535 \
            or wl_max * spp + 1 > 65535:
        raise ValueError(f"ragged_paged_attention kernel: wl_max={wl_max}, "
                         f"nb_max={nb_max}, heads={heads} (the grid takes "
                         "nb_max >= 1, 1 to 65535 heads, and 1 to 65534 "
                         f"splits: wl_max x {spp} splits a page)")
    return {"partials": (wl_max * spp * heads * TOKEN_BLOCK
                         * (head_dim + 2),),
            "tickets": (nb_max * heads,)}


def kernel_info(dtype: torch.dtype, head_dim: int, device: int = 0) -> dict:
    """What a launch of the kernel at this pool dtype and head_dim runs on
    CUDA device ``device``: its shared memory per CTA (bytes), registers
    per thread, CTAs resident per SM, threads per CTA, local memory per
    thread (bytes) and keys per split."""
    return query_kernel_info("ragged_paged_attention", "rpa_kernel_info",
                             "rpa_error_string", KERNEL_DTYPES[dtype],
                             head_dim, device)


_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        lib = _build.library("ragged_paged_attention")
        fn = lib.rpa_forward
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i32, i32] + [ptr] * 15 + [ctypes.c_longlong] + [
            i32] * 7 + [ctypes.c_float, i32, i32, ptr, ptr, ptr]
        fn.restype = i32
        lib.rpa_error_string.argtypes = [i32]
        lib.rpa_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.rpa_error_string)
    return _fn


def _check_plan(plan, dev: torch.device):
    """Raise unless ``plan`` is nine int32 arrays of consistent shapes,
    contiguous, on ``dev``."""
    if len(plan) != len(RAGGED_PLAN_FIELDS):
        raise ValueError(f"plan has {len(plan)} arrays, expected "
                         f"{len(RAGGED_PLAN_FIELDS)} ({RAGGED_PLAN_FIELDS})")
    nb, qb = plan[0].shape
    t = plan[1].shape[0]
    wl = plan[5].shape[0]
    want = {"blk_tok": (nb, qb), "tok_blk": (t,), "tok_row": (t,),
            "blk_base": (nb,), "blk_rows": (nb,), "wl_blk": (wl,),
            "wl_page": (wl,), "wl_pageslot": (wl,), "n_items": (1,)}
    for name, a in zip(RAGGED_PLAN_FIELDS, plan):
        if a.dtype != torch.int32 or tuple(a.shape) != want[name]:
            raise ValueError(f"plan field {name}: {a.dtype} "
                             f"{tuple(a.shape)}, expected int32 "
                             f"{want[name]}")
        if a.device != dev or not a.is_contiguous():
            raise ValueError(f"plan field {name} must be contiguous on "
                             f"{dev}; got {a.device}")


def _launch(q, k_pool, v_pool, plan, scale: float, k_scale=None,
            v_scale=None) -> torch.Tensor:
    """Check everything the kernel assumes, then launch it on the current
    stream.  Raises on anything it does not take."""
    dev = k_pool.device
    t, h, d = q.shape
    p_, hp, page_size, dp = k_pool.shape
    nb, qb = plan[0].shape
    wl = plan[5].shape[0]
    reason = kernel_unsupported_reason(page_size, d, qb, k_pool.dtype)
    if reason is not None:
        raise ValueError(f"ragged_paged_attention kernel: {reason}")
    if (hp, dp) != (h, d) or v_pool.shape != k_pool.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k_pool "
                         f"{tuple(k_pool.shape)}, v_pool "
                         f"{tuple(v_pool.shape)}")
    if q.dtype != q_dtype(k_pool.dtype) or v_pool.dtype != k_pool.dtype:
        raise ValueError("k_pool and v_pool must share a dtype, and q must "
                         "be in it (fp32 for an int8 pool)")
    if q.device != dev or v_pool.device != dev:
        raise ValueError(f"q, k_pool and v_pool must be on {dev}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("the kernel takes contiguous pools only")
    # q may be a view into the fused QKV output: heads and elements
    # contiguous, tokens any stride apart
    if q.stride(2) != 1 or q.stride(1) != d or q.stride(0) < h * d:
        raise ValueError(f"q strides {q.stride()}: the kernel takes "
                         f"(row stride >= {h * d}, {d}, 1)")
    _check_plan(plan, dev)
    if plan[1].shape[0] != t:
        raise ValueError(f"the plan is for {plan[1].shape[0]} tokens; q "
                         f"has {t}")
    ks, vs = scale_pointers(k_scale, v_scale)
    keys = keys_per_split(d, k_pool.dtype)
    spp = splits_per_page(page_size, d, k_pool.dtype)
    shapes = workspace_shapes(wl, nb, h, page_size, d, k_pool.dtype)
    out = torch.empty((t, h, d), dtype=q.dtype, device=dev)
    fn, err_str = _kernel_fn()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = workspace(dev, stream, shapes)
    err = fn(dev.index, KERNEL_DTYPES[k_pool.dtype], q.data_ptr(),
             k_pool.data_ptr(), v_pool.data_ptr(), ks, vs, out.data_ptr(),
             *(a.data_ptr() for a in plan), q.stride(0), t, h, d, page_size,
             qb, nb, wl, float(scale), keys, spp, ws["partials"].data_ptr(),
             ws["tickets"].data_ptr(), stream)
    if err != 0:
        raise KernelError("ragged_paged_attention kernel launch failed: "
                        f"{err_str(err).decode()} (cudaError {err})")
    ragged_paged_attention.launches += 1
    return out


def ragged_paged_attention(q, k_pool, v_pool, token_tables, lengths, plan,
                           *, sm_scale=None, k_scale=None, v_scale=None
                           ) -> torch.Tensor:
    """Token-granular attention over the paged KV pool for one fused
    mixed prefill/decode step.

    q:            [T, H, D] -- every query token of the step, flat
    k_pool:       [P, H, page_size, D] -- the global page pool
    v_pool:       [P, H, page_size, D]
    token_tables: [T, max_pages] int32 -- each token's slot page-table row
                  (read by the plain version; the kernel reads pool pages
                  straight from the pre-translated work list)
    lengths:      [T] int32 -- valid context per token (position + 1)
    plan:         the :data:`RAGGED_PLAN_FIELDS` arrays of
                  :func:`build_ragged_plan`, as int32 tensors
    k_scale/v_scale: [P, H] fp32 per-(page, head) scales of an int8 pool
                  (given with an int8 pool, and only then)
    returns       [T, H, D] in the pool dtype; fp32 for an int8 pool

    CPU tensors run the plain version; CUDA tensors launch the Hopper
    kernel (and count it in ``ragged_paged_attention.launches``) or
    raise.  On the kernel path the rows of padding tokens are zeros."""
    p, h, _, d = k_pool.shape
    scale = float(sm_scale if sm_scale is not None else 1.0 / (d ** 0.5))
    check_scales(k_pool, k_scale, v_scale, (p, h))
    q = q.to(q_dtype(k_pool.dtype))
    if k_pool.device.type == "cpu" and q.device.type == "cpu":
        return ragged_paged_attention_plain(q, k_pool, v_pool, token_tables,
                                            lengths, scale, k_scale, v_scale)
    return _launch(q, k_pool, v_pool, plan, scale, k_scale, v_scale)


# kernel launches made through the wrapper (plain-version calls on the
# CPU never count); callers reset it to 0 before a run they measure
ragged_paged_attention.launches = 0
