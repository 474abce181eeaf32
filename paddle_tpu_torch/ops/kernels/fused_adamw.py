"""Fused AdamW: one AdamW step in place over one parameter tensor.

Port of ``paddle_tpu/ops/pallas_kernels/fused_adamw.py``
(``fused_adamw_update``).  Parts:

- ``adamw_scalars``: the step's scalars (lr, betas, eps, the decay factor
  ``1 - lr * wd`` and the bias corrections ``1 - beta^t``) computed once
  on the host, so the kernel and the plain version use the same values;
- the plain PyTorch version, ``fused_adamw_plain``: the reference's
  update (``AdamW._apply_one`` of ``paddle_tpu/optimizer/optimizers.py``)
  in fp32, written back in place in each tensor's storage dtype;
- the public ``fused_adamw_update(p, g, m1, m2, lr, b1p, b2p, ...)``.

CPU tensors take the plain version and count no launch; CUDA tensors
launch the Hopper kernel of ``csrc/fused_adamw.cu`` (one launch per
tensor, counted in ``fused_adamw_update.launches``) or raise.  Unlike the
JAX function, which returns new arrays, both versions update ``p``,
``m1`` and ``m2`` in place and return nothing.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["fused_adamw_update", "fused_adamw_plain", "adamw_scalars"]

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def adamw_scalars(lr, b1p, b2p, *, beta1=0.9, beta2=0.999, eps=1e-8,
                  wd=0.01):
    """The nine fp32 scalars of one update, in the kernel's order: lr,
    beta1, beta2, 1 - beta1, 1 - beta2, eps, 1 - lr * wd, 1 - beta1^t,
    1 - beta2^t.  ``b1p``/``b2p`` are the beta powers after this step's
    advance (beta1^t, beta2^t), as the reference keeps them in fp32."""
    f = np.float32
    return (f(lr), f(beta1), f(beta2), f(1.0 - beta1), f(1.0 - beta2),
            f(eps), f(1.0 - float(lr) * float(wd)), f(1) - f(b1p),
            f(1) - f(b2p))


@torch.no_grad()
def fused_adamw_plain(p, g, m1, m2, scalars) -> None:
    """The reference update in fp32, written back in place:
    ``m1 = b1 m1 + (1 - b1) g``; ``m2 = b2 m2 + (1 - b2) g g``;
    ``p = p (1 - lr wd) - lr (m1 / (1 - b1^t)) / (sqrt(m2 / (1 - b2^t))
    + eps)``."""
    lr, b1, b2, omb1, omb2, eps, decay, bc1, bc2 = (float(s) for s in scalars)
    gf = g.float()
    new_m1 = b1 * m1.float() + omb1 * gf
    new_m2 = b2 * m2.float() + omb2 * gf * gf
    m1_hat = new_m1 / bc1
    m2_hat = new_m2 / bc2
    new_p = p.float() * decay - lr * m1_hat / (torch.sqrt(m2_hat) + eps)
    p.copy_(new_p)
    m1.copy_(new_m1)
    m2.copy_(new_m2)


_fns = None


def _kernel_fns():
    global _fns
    if _fns is None:
        lib = _build.library("fused_adamw")
        ptr = ctypes.c_void_p
        fn = lib.fused_adamw
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ptr, ptr, ptr, ptr,
                       ctypes.c_longlong, ptr, ptr]
        fn.restype = ctypes.c_int
        lib.fused_adamw_error_string.argtypes = [ctypes.c_int]
        lib.fused_adamw_error_string.restype = ctypes.c_char_p
        _fns = (fn, lib.fused_adamw_error_string)
    return _fns


def _launch(p, g, m1, m2, scalars) -> None:
    dev = p.device
    if p.dtype not in KERNEL_DTYPES:
        raise ValueError(f"fused_adamw kernel: dtype {p.dtype} (the kernel "
                         "takes float32 and bfloat16)")
    for name, t in (("g", g), ("m1", m1), ("m2", m2)):
        if t.dtype != p.dtype or t.shape != p.shape or t.device != dev:
            raise ValueError(f"fused_adamw kernel: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; p is "
                             f"{p.dtype} {tuple(p.shape)} on {dev}")
    for name, t in (("p", p), ("g", g), ("m1", m1), ("m2", m2)):
        if not t.is_contiguous():
            raise ValueError(f"fused_adamw kernel: {name} must be "
                             "contiguous")
    fn, err_str = _kernel_fns()
    sc = (ctypes.c_float * 9)(*(float(s) for s in scalars))
    err = fn(dev.index, KERNEL_DTYPES[p.dtype], p.data_ptr(), g.data_ptr(),
             m1.data_ptr(), m2.data_ptr(), p.numel(), sc,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("fused_adamw kernel launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")


def fused_adamw_update(p, g, m1, m2, lr, b1p, b2p, *, beta1=0.9,
                       beta2=0.999, eps=1e-8, wd=0.01) -> None:
    """One AdamW step on ``p`` with gradient ``g`` and moments ``m1``,
    ``m2`` (all the same dtype and shape), in place.  ``lr``, ``b1p`` and
    ``b2p`` (beta1^t and beta2^t after this step's advance) are runtime
    values; nothing is rebuilt when they change.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (counted in ``fused_adamw_update.launches``) or raise."""
    scalars = adamw_scalars(lr, b1p, b2p, beta1=beta1, beta2=beta2, eps=eps,
                            wd=wd)
    if p.device.type == "cpu":
        fused_adamw_plain(p, g, m1, m2, scalars)
        return
    _launch(p, g, m1, m2, scalars)
    fused_adamw_update.launches += 1


# kernel launches made through the wrapper (plain-version calls on the
# CPU never count); callers reset it to 0 before a run they measure
fused_adamw_update.launches = 0
