"""Int8 KV pages: the write-side quantizer and the dequantizing read
(port of ``paddle_tpu/quantization/kv.py``).

An int8 pool stores each page quantized, with ONE fp32 absmax scale per
(page, head) in a parallel ``[num_pages, H]`` buffer
(``serving/paged_cache.py``, ``dtype="int8"``).  The read side lives in
the attention kernels, which dequantize each page as they read it.

Scale update contract ("fresh-page step-absmax, stale-page clip"):

- a page is FRESH in a step when the step writes its offset-0 row (a
  page's first write always lands at offset 0: admission hands out whole
  pages), or when its scale is still the zero-initialised sentinel.  A
  fresh page's scale becomes the per-head absmax / 127 over ALL tokens
  the step writes into it;
- a STALE page (later decode tokens trickling into a partly filled page)
  keeps its scale; new tokens clip into +-127.

The update is two commutative scatters on the scale buffer: a multiply by
{0, 1} resets the fresh rows, then a scatter-max adds the step's
contributions.  Neither depends on the order in which duplicate indices
land, so identical token sequences give bitwise-identical pages AND
scales, on the card too.  Plain torch: XLA code in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["TINY_SCALE", "absmax_scale", "quantize_kv_write",
           "dequant_pages"]

# floor for effective scales: an all-zero page dequantizes to zeros
# instead of dividing by zero, and real contributions stay strictly
# positive, so the freshness sentinel (scale == 0.0) is unambiguous
TINY_SCALE = 1e-8


def absmax_scale(x: torch.Tensor, dim: int, eps: float,
                 keepdim: bool = False) -> torch.Tensor:
    """``max |x| / 127 + eps`` along ``dim``, in fp32, with a correctly
    rounded division on every device.  (On the card PyTorch divides by a
    Python scalar as a multiply by its rounded reciprocal, which can differ
    from ``x / 127`` in the last bit; a 0-d tensor on ``x``'s device is
    divided by exactly, as the CPU and the reference divide.)"""
    d = torch.full((), 127.0, dtype=torch.float32, device=x.device)
    return x.float().abs().amax(dim=dim, keepdim=keepdim) / d + eps


def quantize_kv_write(x: torch.Tensor, page_ids: torch.Tensor,
                      offs: torch.Tensor, scale: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize one step's K or V rows and update the per-page scales.

    x: ``[S, C, H, D]`` float values about to be written to
    ``pool[page_ids, :, offs]``; ``page_ids``/``offs``: ``[S, C]`` integer
    (padding rows point at the null page, whose scale row absorbs their
    updates and is never read validly); ``scale``: ``[P, H]`` fp32,
    UPDATED IN PLACE (the pool's sidecar, as the pool is written in place).

    Returns ``(q, scale)``: the int8 ``[S, C, H, D]`` payload for the same
    write, and the updated ``scale`` itself."""
    h = x.shape[2]
    xf = x.float()
    contrib = absmax_scale(xf, -1, TINY_SCALE)                  # [S, C, H]
    pid = page_ids.reshape(-1).long()
    fresh = (offs == 0).reshape(-1)
    # reset the fresh pages' rows (stale entries multiply the null page's
    # row by 1: a no-op)
    tgt = torch.where(fresh, pid, torch.zeros_like(pid))
    keep = (~fresh).to(torch.float32)
    scale.scatter_reduce_(0, tgt[:, None].expand(-1, h),
                          keep[:, None].expand(-1, h), "prod")
    # freshness per (token, head) AFTER the reset: the offset-0 writers and
    # the never-written pages (zero sentinel) alike
    contrib = contrib.reshape(-1, h)
    is_fresh = scale.index_select(0, pid) == 0.0
    scale.scatter_reduce_(0, pid[:, None].expand(-1, h),
                          torch.where(is_fresh, contrib,
                                      torch.zeros_like(contrib)), "amax")
    s_eff = scale.index_select(0, pid).clamp_min(TINY_SCALE)    # [S*C, H]
    s_eff = s_eff.reshape(*x.shape[:3], 1)
    q = torch.clamp(torch.round(xf / s_eff), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequant_pages(pool: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``[P, H, ps, D]`` int8 pages x ``[P, H]`` scales -> fp32."""
    return pool.float() * scale[:, :, None, None]
