"""Int8 weights for serving (port of ``paddle_tpu/quantization/int8.py``):
per-output-channel absmax weight scales, per-row dynamic activation
scales, an int8 x int8 -> int32 product and an fp32 epilogue.

The int32 product is ``torch._int_mm``, a library call, as the JAX
package leaves its ``dot_general(int8, int8 -> int32)`` to XLA outside any
Pallas kernel.  Every other step is an elementwise fp32 op, so a
quantized product gives the same bits on the card as on the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .kv import absmax_scale

__all__ = ["quantize_weight", "quantized_matmul", "Int8Linear",
           "quantize_for_serving", "int_mm_rows", "k_major",
           "activation_scales", "int8_accumulate", "int8_epilogue",
           "refuse_tensor_parallel"]

# torch._int_mm on the card (CUDA, cuBLASLt; chip_smoke.py phase 12
# probes the rules and prints them): PyTorch refuses 16 rows or fewer and
# a K or N that is not a positive multiple of 8.  cuBLASLt runs a
# row-major [K, N] right operand only on a slow sm80 compatibility kernel
# and refuses it at K = 64 or 72 for most row counts; stored K-contiguous
# (``k_major``: the transposed view of an [N, K] tensor, the int8
# tensor-core "TN" layout) it takes every row count above 16 and runs at
# bf16 ``addmm``'s speed or better (measured on an H100, PERF.md).  So
# the weights are stored k_major, and fewer than 17 rows are padded with
# zero rows, which quantize to 0 and are dropped from the result (a decode
# step's LM head has 8 rows).  The CPU takes any shape and layout.
_CUDA_MIN_ROWS = 17


def int_mm_rows(m: int) -> int:
    """The row count the card's int8 product runs ``m`` rows on."""
    return max(_CUDA_MIN_ROWS, m)


def k_major(q: torch.Tensor) -> torch.Tensor:
    """The same ``[..., K, N]`` int8 values with K contiguous (each
    ``[K, N]`` matrix column-major), the layout the card's int8 product
    takes on its tensor cores."""
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_weight(w: torch.Tensor, dim: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absmax int8 quantization of ``w`` with one fp32 scale per slice
    along ``dim`` reduced away: ``s = max|w| / 127 + 1e-12`` and ``q =
    clip(round(w / s), -127, 127)``, in fp32, the reference's numpy
    arithmetic op for op (each op correctly rounded on either device).
    Returns ``(q int8, s fp32)``."""
    wf = w.detach().float()
    s = absmax_scale(wf, dim, 1e-12)
    q = torch.clamp(torch.round(wf / s.unsqueeze(dim)), -127.0, 127.0)
    return q.to(torch.int8), s


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 ``a`` [M, K] x int8 ``b`` [K, N] -> int32 [M, N], exact."""
    m, k = a.shape
    n = b.shape[1]
    if a.device.type != "cuda":
        return torch._int_mm(a, b)
    if k % 8 or n % 8:
        raise ValueError(f"int8 product [{m}, {k}] x [{k}, {n}]: the card's "
                         "int8 product takes K and N multiples of 8")
    rows = int_mm_rows(m)
    if rows != m:
        pad = a.new_zeros((rows - m, k))
        return torch._int_mm(torch.cat([a, pad]), b)[:m]
    return torch._int_mm(a, b)


def activation_scales(x: torch.Tensor,
                      act_scale: Optional[float] = None) -> torch.Tensor:
    """The activation scale of :func:`quantized_matmul`: one absmax a row
    of ``x`` over its K features (``[..., 1]`` fp32), or the static
    ``act_scale`` as a 0-d tensor."""
    if act_scale is not None:
        return torch.as_tensor(act_scale, dtype=torch.float32,
                               device=x.device)
    return absmax_scale(x.float(), -1, 1e-12, keepdim=True)


def int8_accumulate(x: torch.Tensor, w_int8: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """``int8(x / xs) @ w_int8``: the exact int32 ``[..., N]`` accumulator
    of :func:`quantized_matmul`.  Integer sums are exact, so the
    accumulators of a contraction split over shards add up to the whole
    one's (the row-parallel int8 product of sharded serving)."""
    xq = torch.clamp(torch.round(x.float() / xs), -127.0,
                     127.0).to(torch.int8)
    k = x.shape[-1]
    return _int_mm(xq.reshape(-1, k), w_int8).reshape(*x.shape[:-1], -1)


def int8_epilogue(acc: torch.Tensor, xs: torch.Tensor,
                  w_scale: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fp32 epilogue in the reference's order, ``acc * xs * ws + b``,
    one op at a time."""
    out = acc.float() * xs * w_scale.float()
    if bias is not None:
        out = out + bias.float()
    return out


def quantized_matmul(x: torch.Tensor, w_int8: torch.Tensor,
                     w_scale: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     act_scale: Optional[float] = None) -> torch.Tensor:
    """``y = dequant(int8(x) @ w_int8) (+ bias)`` (``quantized_matmul_raw``
    of the reference).  x: float ``[..., K]``; w_int8: int8 ``[K, N]``
    (on the card best :func:`k_major`); w_scale: fp32 ``[N]``; returns
    fp32 ``[..., N]``.

    Dynamic activation scales are per row (one absmax per token over its K
    features), so a token's quantization grid never depends on its batch
    neighbours.  The epilogue runs in the reference's order,
    ``acc * xs * ws + b``, one fp32 op at a time."""
    xs = activation_scales(x, act_scale)
    return int8_epilogue(int8_accumulate(x, w_int8, xs), xs, w_scale, bias)


class Int8Linear(nn.Module):
    """Inference replacement for a ``Linear`` (the reference's
    ``Int8Linear``): its ``[in, out]`` weight quantized with one absmax
    scale per output channel and kept as the buffers ``weight_int8``
    (int8, :func:`k_major`) and ``w_scale`` (fp32 [out]), so they persist
    through ``state_dict``; the fp weight is dropped, the bias kept.
    ``forward`` is :func:`quantized_matmul` with a per-row dynamic (or the
    given static ``act_scale``) activation scale; it returns fp32."""

    def __init__(self, linear, act_scale: Optional[float] = None):
        super().__init__()
        q, s = quantize_weight(linear.weight, 0)
        self.register_buffer("weight_int8", k_major(q))
        self.register_buffer("w_scale", s)
        self.bias = getattr(linear, "bias", None)
        self._act_scale = (float(act_scale) if act_scale is not None
                           else None)

    def forward(self, x):
        return quantized_matmul(x, self.weight_int8, self.w_scale,
                                bias=self.bias, act_scale=self._act_scale)


def refuse_tensor_parallel(model):
    """The reference's refusal of a model whose config sets
    ``use_tensor_parallel``: its Linear layers are cut over mp, and
    per-channel scales need the whole weights."""
    cfg = getattr(model, "config", None)
    if cfg is not None and getattr(cfg, "use_tensor_parallel", False):
        raise ValueError(
            "quantize_for_serving: tensor-parallel Linear layers are "
            "sharded — per-channel PTQ needs the unsharded weights; "
            "serve TP models with fp weights")


def quantize_for_serving(model):
    """Quantize the serving hot path's projections (qkv, out, fc1 and fc2
    of every block) and the tied LM head to int8 with per-output-channel
    absmax scales, in place, for ``weight_dtype="int8"`` serving: the
    model's own ``quantize_weights`` (the stacked GPT's int8 slabs, the
    layered GPT's :class:`Int8Linear` layers).  Idempotent; a model whose
    config sets ``use_tensor_parallel`` raises the reference's
    ``ValueError`` (:func:`refuse_tensor_parallel`).  Returns ``model``."""
    if getattr(model, "weight_int8", False):
        return model
    refuse_tensor_parallel(model)
    if not hasattr(model, "quantize_weights"):
        raise ValueError(
            "quantize_for_serving: expected a GPTForPretraining or "
            f"GPTStackedForPretraining instance (got {type(model).__name__})")
    model.quantize_weights()
    return model
