"""Decode attention: ONE query per (batch, head) over a contiguous KV cache,
the decode step of ``generate()``.

Port of ``paddle_tpu/ops/pallas_kernels/decode_attention.py``.  Two parts:

- the plain PyTorch version, ``decode_attention_plain``, the counterpart
  of ``_xla_decode_reference``: fp32 scores times ``scale``, the finite
  ``NEG_INF`` length mask over every cache position, an fp32 softmax, and
  the probabilities cast to the q dtype before the PV product (fp32 sum);
- the Hopper kernel (``csrc/decode_attention.cu``) behind the public
  wrapper ``decode_attention``, which keeps the JAX signature.  The kernel
  reads only the first ``length`` positions, and reads ``length`` itself
  from device memory, so a decode step needs no host sync.  It splits each
  (batch, head) row's keys over CTAs of ``keys_per_split`` keys each
  (flash-decoding); each CTA writes a partial (m, l, acc) to a workspace
  and the last one of a row merges them in split order;
- ``split_merge_plain``, the same split-and-merge arithmetic in plain
  PyTorch (partials over key ranges, merged in order), used only by the
  tests and ``chip_smoke.py`` to hold the kernel's design against the
  reference on the CPU.

An int8 cache comes with ``k_scale``/``v_scale``, one fp32 scale per
(batch, head): q joins the fp32 dequantization, the kernel dequantizes
each key and value as it reads it (``float(int8) * scale``) and the
output is fp32.  No model path of the JAX package passes scales here (its
``generate()`` refuses a quantized model); the int8 variant is the kernel
API, held against its plain version on the card.

The wrapper takes the plain version only for tensors on the CPU.  Any
other tensor launches the kernel (counted in
``decode_attention.launches``) or raises ``ValueError`` naming what the
kernel does not take; nothing falls back.  Forward only: decode never
differentiates through the cache.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Union

import torch

from . import _build

__all__ = [
    "decode_attention",
    "decode_attention_plain",
    "split_merge_plain",
    "range_partial",
    "merge_partials",
    "kernel_unsupported_reason",
    "kernel_info",
    "keys_per_split",
    "num_splits",
    "workspace_shapes",
    "check_scales",
    "NEG_INF",
]

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 192, 256)
# the bytes of K and V that one CTA of the split kernel stages at most
SPLIT_KV_BYTES = 32768
# the cache dtype's code in the C interface: q and the output share a
# float cache's dtype; an int8 cache takes fp32 q and gives fp32
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def decode_attention_plain(q, k_cache, v_cache, length, scale: float,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """Masked single-query attention: q ``[B, H, D]`` over the first
    ``length`` positions of ``[B, H, max_seq, D]`` caches, returning
    ``[B, H, D]`` in the q dtype.  ``length`` is an int or a 0-d tensor.
    Every cache position is read; masked ones weigh 0 (so a non-finite
    value past ``length`` reaches the output, as in the reference).  An
    int8 cache is dequantized whole first with its ``[B, H]`` scales (q
    is then fp32, so P is not rounded)."""
    if k_scale is not None:
        k_cache = k_cache.float() * k_scale[:, :, None, None]
        v_cache = v_cache.float() * v_scale[:, :, None, None]
    s = torch.einsum("bhd,bhsd->bhs", q.float(), k_cache.float()) * scale
    valid = torch.arange(k_cache.shape[2], device=k_cache.device) < length
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhs,bhsd->bhd", p.float(),
                        v_cache.float()).to(q.dtype)


def split_merge_plain(q, k_cache, v_cache, length: int, scale: float,
                      keys: int, k_scale=None, v_scale=None) -> torch.Tensor:
    """The split kernel's arithmetic in plain PyTorch: the first ``length``
    positions cut into ranges of ``keys``; each range's partial (m, l,
    acc) -- fp32 scores, ``p = exp(s - m)`` against the range's own max,
    ``l`` the sum of the unrounded p, ``acc`` the sum of p rounded to the
    q dtype times V -- then the ranges merged in order, ``O = sum_s
    e^(m_s - m) acc_s / sum_s e^(m_s - m) l_s`` with the ``l == 0``
    guard.  Positions at or past ``length`` are never read, so a
    non-finite value there does not reach the output; ``length`` 0 gives
    zeros.  ``length`` is an int here (the kernel reads it on the device).
    q ``[B, H, D]``, caches ``[B, H, max_seq, D]`` -> ``[B, H, D]`` in the
    q dtype; an int8 cache with its ``[B, H]`` scales, dequantized as it
    is read (q fp32, P unrounded)."""
    b, h, _, d = k_cache.shape
    n = max(0, min(int(length), k_cache.shape[2]))
    parts = []
    for c0 in range(0, n, keys):
        k = k_cache[:, :, c0:min(c0 + keys, n)].float()
        v = v_cache[:, :, c0:min(c0 + keys, n)].float()
        if k_scale is not None:
            k = k * k_scale[:, :, None, None]
            v = v * v_scale[:, :, None, None]
        parts.append(range_partial(q, k, v, scale))
    if not parts:
        return torch.zeros((b, h, d), dtype=q.dtype, device=q.device)
    return merge_partials(parts).to(q.dtype)


def range_partial(q, k, v, scale: float):
    """One key range's partial (m, l, acc), as a CTA of the split kernel
    forms it: q ``[..., D]`` over fp32 (dequantized) k, v ``[..., n, D]``;
    fp32 scores, ``p = exp(s - m)`` against the range's own max, ``l`` the
    sum of the unrounded p, ``acc`` the sum of p rounded to the q dtype
    times V."""
    s = torch.einsum("...d,...kd->...k", q.float(), k) * scale
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("...k,...kd->...d", p.to(q.dtype).float(), v)
    return m, p.sum(dim=-1), acc


def merge_partials(parts):
    """``[(m, l, acc), ...]`` partials of key ranges, in range order ->
    ``sum e^(m_s - m) acc_s / sum e^(m_s - m) l_s`` (fp32, the ``l == 0``
    guard), summed in that order.  ``m`` and ``l`` are ``[...]``, ``acc``
    ``[..., D]``."""
    m = parts[0][0]
    for mi, _, _ in parts[1:]:
        m = torch.maximum(m, mi)
    o = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for mi, li, ai in parts:
        w = torch.exp(mi - m)
        den = den + w * li
        o = o + w[..., None] * ai
    return o / torch.where(den == 0, torch.ones_like(den), den)[..., None]


def kernel_unsupported_reason(head_dim: int, dtype: torch.dtype
                              ) -> Optional[str]:
    """``None`` when the kernel takes caches of this head_dim and dtype,
    else why not (any ``max_seq`` is taken)."""
    if dtype not in KERNEL_DTYPES:
        return (f"cache dtype {dtype} (the kernel takes float32, bfloat16 "
                "and int8)")
    if head_dim not in KERNEL_HEAD_DIMS:
        return f"head_dim={head_dim} (the kernel takes {KERNEL_HEAD_DIMS})"
    return None


def keys_per_split(head_dim: int, dtype: torch.dtype) -> int:
    """Keys one CTA of the split kernel takes (the kernel's ``Split::KS``):
    the largest of 128, 64, 32 whose K and V fit ``SPLIT_KV_BYTES``, else
    16.  Raises ``ValueError`` for what the kernel does not take."""
    reason = kernel_unsupported_reason(head_dim, dtype)
    if reason is not None:
        raise ValueError(f"decode_attention kernel: {reason}")
    raw = SPLIT_KV_BYTES // (2 * head_dim * dtype.itemsize)
    return next((k for k in (128, 64, 32) if raw >= k), 16)


def num_splits(max_seq: int, head_dim: int, dtype: torch.dtype) -> int:
    """CTAs per row of the launch: ``ceil(max_seq / keys_per_split)``,
    sized from the cache on the host (the length stays on the device).
    Raises ``ValueError`` for an empty cache or more splits than a grid
    dimension holds (65535)."""
    keys = keys_per_split(head_dim, dtype)
    if max_seq < 1:
        raise ValueError(f"decode_attention kernel: max_seq={max_seq}")
    n = -(-max_seq // keys)
    if n > 65535:
        raise ValueError(f"decode_attention kernel: max_seq={max_seq} needs "
                         f"{n} splits of {keys} keys (at most 65535)")
    return n


def workspace_shapes(rows: int, splits: int, head_dim: int
                     ) -> Dict[str, tuple]:
    """The split kernel's workspace for ``rows`` = batch x heads rows:
    fp32 partials, ``acc`` [rows, splits, head_dim] then ``(m, l)``
    [rows, splits, 2], as one flat buffer, and one int32 ticket a row.
    Raises ``ValueError`` for no rows or more than a grid dimension
    holds."""
    if rows < 1 or rows > 0x7fffffff or splits < 1:
        raise ValueError(f"decode_attention kernel: {rows} rows x {splits} "
                         "splits (the grid takes 1 to 2**31 - 1 rows)")
    return {"partials": (rows * splits * (head_dim + 2),),
            "tickets": (rows,)}


# workspaces of the split kernels, by (device index, stream): fp32
# partials grown as needed, int32 tickets zeroed when made (the kernels
# leave them 0); launches on one stream run in order, so they share one
_workspaces: Dict[tuple, Dict[str, torch.Tensor]] = {}


def workspace(dev: torch.device, stream: int, shapes: Dict[str, tuple]
              ) -> Dict[str, torch.Tensor]:
    """Cached buffers of at least ``shapes`` (fp32 ``partials``, zeroed
    int32 ``tickets``) on ``dev`` for launches on ``stream``; made with
    ``torch.empty``/``torch.zeros``, with no host sync."""
    key = (dev.index, stream)
    ws = _workspaces.get(key, {})
    for name, shape in shapes.items():
        t = ws.get(name)
        if t is None or t.numel() < shape[0]:
            ws[name] = (torch.zeros(shape, dtype=torch.int32, device=dev)
                        if name == "tickets" else
                        torch.empty(shape, dtype=torch.float32, device=dev))
    _workspaces[key] = ws
    return ws


def q_dtype(cache_dtype: torch.dtype) -> torch.dtype:
    """The dtype q is cast to, and the output's: the cache's for a float
    cache, fp32 for an int8 one (an int8 q would destroy the queries)."""
    return torch.float32 if cache_dtype == torch.int8 else cache_dtype


def scale_pointers(k_scale, v_scale):
    """Device pointers of contiguous scales (0 for a float cache)."""
    if k_scale is None:
        return 0, 0
    if not (k_scale.is_contiguous() and v_scale.is_contiguous()):
        raise ValueError("the kernels take contiguous k_scale/v_scale")
    return k_scale.data_ptr(), v_scale.data_ptr()


def kernel_info(dtype: torch.dtype, head_dim: int, device: int = 0) -> dict:
    """What a contiguous-cache launch of the split kernel at this cache
    dtype and head_dim runs on CUDA device ``device``: its shared memory
    per CTA (bytes), registers per thread, CTAs resident per SM, threads
    per CTA, local memory per thread (bytes) and keys per split
    (``paged_attention.kernel_info`` reports the paged launch)."""
    return query_kernel_info("decode_attention",
                             "decode_attention_kernel_info",
                             "decode_attention_error_string",
                             KERNEL_DTYPES[dtype], head_dim, device)


def query_kernel_info(lib_name: str, entry: str, error_entry: str,
                      dtype_code: int, head_dim: int, device: int) -> dict:
    """Call a library's ``<entry>(device, dtype, head_dim, int info[6])``
    and name its six numbers; raise with the library's error string."""
    lib = _build.library(lib_name)
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 6)()
    err = fn(device, dtype_code, head_dim, info)
    if err != 0:
        err_fn = getattr(lib, error_entry)
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{lib_name} kernel_info: "
                           f"{err_fn(err).decode()} (cudaError {err})")
    return dict(zip(("smem", "registers", "ctas_per_sm", "threads",
                     "local_bytes", "keys_per_split"), info))


_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        lib = _build.library("decode_attention")
        fn = lib.decode_attention_forward
        i32, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = [i32, i32, i32, ptr, i64, i64, ptr, ptr, ptr, ptr, i64,
                       i64, i64, ptr, ptr, i32, i32, i32, ctypes.c_float,
                       i32, i32, ptr, ptr, ptr]
        fn.restype = i32
        lib.decode_attention_error_string.argtypes = [i32]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.decode_attention_error_string)
    return _fn


def check_rows(name: str, t: torch.Tensor, dims: int, dev: torch.device,
               dtype: torch.dtype) -> None:
    """Raise unless ``t`` has ``dims`` dimensions, ``dtype``, lies on
    ``dev`` and has 16-byte aligned rows of contiguous elements."""
    if t.dim() != dims or t.dtype != dtype or t.device != dev:
        raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)} on {t.device}"
                         f"; expected {dims} dimensions of {dtype} on {dev}")
    align = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % align for s in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name} strides {t.stride()}: rows must be "
                         "contiguous and 16-byte aligned")


def check_scales(pool: torch.Tensor, k_scale, v_scale, shape) -> None:
    """Raise ``ValueError`` unless an int8 ``pool`` (a KV cache or page
    pool) comes with fp32 ``k_scale`` and ``v_scale`` of ``shape`` on its
    device, and a float one with neither."""
    given = (k_scale is not None, v_scale is not None)
    if pool.dtype != torch.int8:
        if any(given):
            raise ValueError(f"k_scale/v_scale given with a {pool.dtype} KV "
                             "cache: scales belong to an int8 cache only")
        return
    if not all(given):
        raise ValueError("an int8 KV cache needs both k_scale and v_scale "
                         f"(fp32 {tuple(shape)})")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
                or t.device != pool.device:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}; expected float32 {tuple(shape)} "
                             f"on {pool.device}")


def device_lengths(length, n: int, dev: torch.device) -> torch.Tensor:
    """``length`` (an int, or an integer tensor of ``n`` elements on
    ``dev``) as a contiguous int32 ``[n]`` tensor on ``dev``, made without
    a host sync."""
    if isinstance(length, torch.Tensor):
        if length.device != dev or length.numel() != n \
                or length.dtype.is_floating_point:
            raise ValueError(f"length must be an integer tensor of {n} "
                             f"element(s) on {dev}; got {length.dtype} "
                             f"{tuple(length.shape)} on {length.device}")
        return length.reshape(n).to(torch.int32).contiguous()
    return torch.full((n,), int(length), dtype=torch.int32, device=dev)


def _launch(q, k_cache, v_cache, length, scale: float, k_scale=None,
            v_scale=None) -> torch.Tensor:
    """Check everything the kernel assumes, then launch it on the current
    stream."""
    dev = k_cache.device
    b, h, s, d = k_cache.shape
    reason = kernel_unsupported_reason(d, k_cache.dtype)
    if reason is not None:
        raise ValueError(f"decode_attention kernel: {reason}")
    check_rows("k_cache", k_cache, 4, dev, k_cache.dtype)
    check_rows("v_cache", v_cache, 4, dev, k_cache.dtype)
    if v_cache.shape != k_cache.shape or v_cache.stride() != k_cache.stride():
        raise ValueError(f"v_cache {tuple(v_cache.shape)} {v_cache.stride()} "
                         f"must match k_cache {tuple(k_cache.shape)} "
                         f"{k_cache.stride()}")
    qd = q_dtype(k_cache.dtype)
    if q.shape != (b, h, d) or q.dtype != qd or q.device != dev \
            or q.stride(2) != 1:
        raise ValueError(f"q is {q.dtype} {tuple(q.shape)} {q.stride()} on "
                         f"{q.device}; expected {qd} ({b}, {h}, "
                         f"{d}) with contiguous rows on {dev}")
    ks, vs = scale_pointers(k_scale, v_scale)
    keys = keys_per_split(d, k_cache.dtype)
    splits = num_splits(s, d, k_cache.dtype)
    shapes = workspace_shapes(b * h, splits, d)
    lengths = device_lengths(length, 1, dev)
    out = torch.empty((b, h, d), dtype=q.dtype, device=dev)
    fn, err_str = _kernel_fn()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = workspace(dev, stream, shapes)
    err = fn(dev.index, KERNEL_DTYPES[k_cache.dtype], d, q.data_ptr(),
             q.stride(0), q.stride(1), k_cache.data_ptr(), v_cache.data_ptr(),
             ks, vs, *k_cache.stride()[:3], out.data_ptr(),
             lengths.data_ptr(), b, h, s, float(scale), keys, splits,
             ws["partials"].data_ptr(), ws["tickets"].data_ptr(), stream)
    if err != 0:
        raise RuntimeError("decode_attention kernel launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    decode_attention.launches += 1
    return out


def decode_attention(q, k_cache, v_cache, length: Union[int, torch.Tensor],
                     *, sm_scale: Optional[float] = None, k_scale=None,
                     v_scale=None) -> torch.Tensor:
    """Single-query attention over a preallocated KV cache.

    q:        [B, H, D] -- the ONE new query per (batch, head); rows may be
              strided (a view into the fused QKV output)
    k_cache:  [B, H, max_seq, D] (a layer's view of the stacked cache)
    v_cache:  [B, H, max_seq, D]
    length:   valid cache positions: an int, or a 0-d integer tensor on
              the cache's device (read there, with no host sync)
    k_scale/v_scale: [B, H] fp32 dequantization scales of an int8 cache
              (given with an int8 cache, and only then)
    returns   [B, H, D] in the cache dtype (q is cast to it first); fp32
              for an int8 cache

    CPU tensors run the plain version; any other tensor launches the
    Hopper kernel or raises."""
    b, h, _, d = k_cache.shape
    scale = float(sm_scale if sm_scale is not None else 1.0 / (d ** 0.5))
    check_scales(k_cache, k_scale, v_scale, (b, h))
    q = q.to(q_dtype(k_cache.dtype))
    if k_cache.device.type == "cpu" and q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, length, scale,
                                      k_scale, v_scale)
    return _launch(q, k_cache, v_cache, length, scale, k_scale, v_scale)


# kernel launches made through the wrapper (plain-version calls on the
# CPU never count); callers reset it to 0 before a run they measure
decode_attention.launches = 0
