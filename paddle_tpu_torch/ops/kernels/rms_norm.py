"""Fused residual add + RMSNorm / LayerNorm: ``(normed, h)`` with
``h = x + residual``.

Port of ``paddle_tpu/ops/pallas_kernels/rms_norm.py`` (``_build``, its
instances ``_rms_op`` and ``_ln_op``, and the public
``fused_add_rms_norm`` / ``fused_add_layer_norm``).  Parts:

- ``shape_supported``, copied: the TPU kernel's lane gate (hidden a
  multiple of 128).  The Hopper kernel has no such gate and takes every
  hidden size and row count; the copy documents which shapes the JAX
  package sends to its kernel;
- the plain PyTorch versions ``fused_add_rms_norm_plain`` and
  ``fused_add_layer_norm_plain``: the Pallas kernel's arithmetic, the add
  in fp32 (``float(x) + float(residual)``, not the JAX ``reference``'s add
  in x's dtype), the statistics and the normalisation in fp32, both
  outputs cast to x's dtype;
- ``FusedAddNorm``, a ``torch.autograd.Function`` -- the counterpart of
  the ``jax.custom_vjp`` -- whose forward is the kernel and whose
  backward is autograd of the plain version recomputed from the saved
  x, residual and parameters (the JAX ``vjp_bwd``, which has no Pallas
  kernel either);
- the public ``fused_add_rms_norm(x, residual, weight, eps=1e-6)`` and
  ``fused_add_layer_norm(x, residual, weight, bias, eps=1e-5)``.

CPU tensors take the plain version and count no launch.  Any other tensor
launches the Hopper kernel of ``csrc/rms_norm.cu`` (counted in
``fused_add_rms_norm.launches`` or ``fused_add_layer_norm.launches``) or
raises; nothing falls back.  A call with no element launches nothing and
returns empty outputs.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_add_rms_norm", "fused_add_layer_norm",
           "fused_add_rms_norm_plain", "fused_add_layer_norm_plain",
           "FusedAddNorm", "shape_supported"]

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def shape_supported(hidden: int) -> bool:
    """The TPU kernel's lane constraint: the hidden (row) dim must tile
    the 128-wide lanes.  The Hopper kernel takes every hidden size."""
    return hidden % 128 == 0


def _rms_math(h, params, eps):
    (g,) = params
    ms = (h * h).mean(-1, keepdim=True)
    return h * (1.0 / torch.sqrt(ms + eps)) * g


def _ln_math(h, params, eps):
    g, b = params
    mu = h.mean(-1, keepdim=True)
    d = h - mu
    var = (d * d).mean(-1, keepdim=True)
    return d * (1.0 / torch.sqrt(var + eps)) * g + b


def _plain(layer_norm: bool, x, residual, params, eps):
    h = x.float() + residual.float()
    math_ = _ln_math if layer_norm else _rms_math
    out = math_(h, [p.float() for p in params], eps)
    return out.to(x.dtype), h.to(x.dtype)


def fused_add_rms_norm_plain(x, residual, weight, eps=1e-6):
    """``(h * rsqrt(mean(h^2) + eps) * weight, h)`` with ``h = float(x) +
    float(residual)``, all in fp32, both cast to x's dtype."""
    return _plain(False, x, residual, (weight,), eps)


def fused_add_layer_norm_plain(x, residual, weight, bias, eps=1e-5):
    """``((h - mu) * rsqrt(var + eps) * weight + bias, h)`` with ``h =
    float(x) + float(residual)``, the mean and then the variance of the
    deviations in fp32, both cast to x's dtype."""
    return _plain(True, x, residual, (weight, bias), eps)


_fns = None


def _kernel_fns():
    global _fns
    if _fns is None:
        lib = _build.library("rms_norm")
        i32, ptr = ctypes.c_int, ctypes.c_void_p
        fn = lib.fused_add_norm
        fn.argtypes = [i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr,
                       ctypes.c_longlong, i32, ctypes.c_float, ptr]
        fn.restype = i32
        lib.fused_add_norm_error_string.argtypes = [i32]
        lib.fused_add_norm_error_string.restype = ctypes.c_char_p
        _fns = (fn, lib.fused_add_norm_error_string)
    return _fns


def _launch(layer_norm: bool, x, residual, params, eps):
    """The kernel's ``(normed, h)`` in x's dtype.  x and residual of two
    dtypes are both widened to their promoted dtype for the kernel (an
    exact cast, since the kernel adds them in fp32 anyway) and the
    outputs cast back to x's dtype."""
    hidden = x.shape[-1]
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fused_add_norm kernel: x is on {dev}; the kernel "
                         "takes CUDA tensors (CPU tensors run the plain "
                         "version)")
    for name, t in (("residual", residual), *zip(("weight", "bias"), params)):
        if t.device != dev:
            raise ValueError(f"fused_add_norm kernel: {name} is on "
                             f"{t.device}, x on {dev}")
    if residual.shape != x.shape:
        raise ValueError(f"fused_add_norm kernel: residual is "
                         f"{tuple(residual.shape)}, x {tuple(x.shape)}")
    for name, p in zip(("weight", "bias"), params):
        if p.shape != (hidden,):
            raise ValueError(f"fused_add_norm kernel: {name} is "
                             f"{tuple(p.shape)}, expected ({hidden},)")
    if x.numel() == 0:
        return torch.empty_like(x), torch.empty_like(x)
    cdt = torch.promote_types(x.dtype, residual.dtype)
    pdt = params[0].dtype if all(p.dtype == params[0].dtype
                                 for p in params) else torch.float32
    for what, dt in (("x/residual", cdt), ("weight/bias", pdt)):
        if dt not in KERNEL_DTYPES:
            raise ValueError(f"fused_add_norm kernel: {what} dtype {dt} (the "
                             "kernel takes float32 and bfloat16)")
    xs = x.to(cdt).reshape(-1, hidden).contiguous()
    rs = residual.to(cdt).reshape(-1, hidden).contiguous()
    ps = [p.to(pdt).contiguous() for p in params]
    out, h = torch.empty_like(xs), torch.empty_like(xs)
    fn, err_str = _kernel_fns()
    err = fn(dev.index, int(layer_norm), KERNEL_DTYPES[cdt],
             KERNEL_DTYPES[pdt], xs.data_ptr(), rs.data_ptr(),
             ps[0].data_ptr(), ps[1].data_ptr() if layer_norm else None,
             out.data_ptr(), h.data_ptr(), xs.shape[0], hidden, float(eps),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("fused_add_norm kernel launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    counted = fused_add_layer_norm if layer_norm else fused_add_rms_norm
    counted.launches += 1
    return (out.reshape(x.shape).to(x.dtype), h.reshape(x.shape).to(x.dtype))


class FusedAddNorm(torch.autograd.Function):
    """The kernel under autograd (the plain version on CPU tensors): the
    forward saves x, residual and the parameters; the backward is autograd
    of the plain version, recomputed from them."""

    @staticmethod
    def forward(ctx, layer_norm: bool, eps: float, x, residual, *params):
        ctx.save_for_backward(x, residual, *params)
        ctx.layer_norm, ctx.eps = layer_norm, eps
        if x.device.type == "cpu":
            return _plain(layer_norm, x, residual, params, eps)
        return _launch(layer_norm, x, residual, params, eps)

    @staticmethod
    def backward(ctx, d_out, d_h):
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = _plain(ctx.layer_norm, ins[0], ins[1], ins[2:], ctx.eps)
            grads = torch.autograd.grad(outs, ins, (d_out, d_h),
                                        allow_unused=True)
        return (None, None, *grads)


def fused_add_rms_norm(x, residual, weight, eps=1e-6):
    """``(normed, h)``: ``h = x + residual`` and ``normed =
    rms_norm(h) * weight``, statistics in fp32, both in x's dtype.  CPU
    tensors run the plain version; CUDA tensors launch the kernel
    (counted in ``fused_add_rms_norm.launches``) or raise."""
    return FusedAddNorm.apply(False, float(eps), x, residual, weight)


def fused_add_layer_norm(x, residual, weight, bias, eps=1e-5):
    """``(normed, h)``: ``h = x + residual`` and ``normed =
    layer_norm(h) * weight + bias``, statistics in fp32, both in x's
    dtype.  CPU tensors run the plain version; CUDA tensors launch the
    kernel (counted in ``fused_add_layer_norm.launches``) or raise."""
    return FusedAddNorm.apply(True, float(eps), x, residual, weight, bias)


# kernel launches made through the wrappers (plain-version calls on the
# CPU never count); callers reset them to 0 before a run they measure
fused_add_rms_norm.launches = 0
fused_add_layer_norm.launches = 0
