"""Fused AdamW: one AdamW step in place over one parameter tensor.

Port of ``paddle_tpu/ops/pallas_kernels/fused_adamw.py``
(``fused_adamw_update``).  Parts:

- ``adamw_scalars``: the step's scalars (lr, betas, eps, the decay factor
  ``1 - lr * wd`` and the bias corrections ``1 - beta^t``) computed once
  on the host, so the kernel and the plain version use the same values;
- the plain PyTorch version, ``fused_adamw_plain``: the reference's
  update (``AdamW._apply_one`` of ``paddle_tpu/optimizer/optimizers.py``)
  in fp32, written back in place in each tensor's storage dtype; with
  ``master=`` its fp32-master form (the composed master path of
  ``_apply_one``, which the Pallas kernel does not cover): the fp32
  master takes p's place, master and the fp32 moments are written in
  fp32, and p gets the new master rounded to its dtype;
- the public ``fused_adamw_update(p, g, m1, m2, lr, b1p, b2p, ...,
  master=None)``.

CPU tensors take the plain version and count no launch; CUDA tensors
launch the Hopper kernel of ``csrc/fused_adamw.cu`` (its master form when
``master`` is given; one launch per tensor either way, counted in
``fused_adamw_update.launches``) or raise.  Unlike the JAX function,
which returns new arrays, both versions update ``p``, ``m1``, ``m2`` (and
``master``) in place and return nothing.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from ._build import KernelError

__all__ = ["fused_adamw_update", "fused_adamw_plain", "adamw_scalars"]

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the master form's parameter and gradient dtypes (master and moments fp32)
MASTER_DTYPES = {torch.bfloat16: 1, torch.float16: 2}


def adamw_scalars(lr, b1p, b2p, *, beta1=0.9, beta2=0.999, eps=1e-8,
                  wd=0.01, fp32_lr=False):
    """The nine fp32 scalars of one update, in the kernel's order: lr,
    beta1, beta2, 1 - beta1, 1 - beta2, eps, 1 - lr * wd, 1 - beta1^t,
    1 - beta2^t.  ``b1p``/``b2p`` are the beta powers after this step's
    advance (beta1^t, beta2^t), as the reference keeps them in fp32.

    ``1 - lr * wd`` is rounded once from double, as the reference computes
    it from a Python float ``lr``; with ``fp32_lr`` (an ``lr`` that the
    reference holds as an fp32 tensor: a scheduler's) each operation is
    rounded to fp32, as it computes it then."""
    f = np.float32
    decay = (f(1) - f(lr) * f(wd) if fp32_lr
             else f(1.0 - float(lr) * float(wd)))
    return (f(lr), f(beta1), f(beta2), f(1.0 - beta1), f(1.0 - beta2),
            f(eps), decay, f(1) - f(b1p), f(1) - f(b2p))


@torch.no_grad()
def fused_adamw_plain(p, g, m1, m2, scalars, master=None) -> None:
    """The reference update in fp32, written back in place:
    ``m1 = b1 m1 + (1 - b1) g``; ``m2 = b2 m2 + (1 - b2) g g``;
    ``p = p (1 - lr wd) - lr (m1 / (1 - b1^t)) / (sqrt(m2 / (1 - b2^t))
    + eps)``.  With ``master`` (fp32, p's shape) the formula's p is the
    master: the new value goes to ``master`` and, rounded, to ``p``, which
    is not read."""
    lr, b1, b2, omb1, omb2, eps, decay, bc1, bc2 = (float(s) for s in scalars)
    gf = g.float()
    new_m1 = b1 * m1.float() + omb1 * gf
    new_m2 = b2 * m2.float() + omb2 * gf * gf
    m1_hat = new_m1 / bc1
    m2_hat = new_m2 / bc2
    pv = p.float() if master is None else master
    new_p = pv * decay - lr * m1_hat / (torch.sqrt(m2_hat) + eps)
    if master is not None:
        master.copy_(new_p)
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
        master = lib.fused_adamw_master
        master.argtypes = [ctypes.c_int, ctypes.c_int, ptr, ptr, ptr, ptr,
                           ptr, ctypes.c_longlong, ptr, ptr]
        master.restype = ctypes.c_int
        lib.fused_adamw_error_string.argtypes = [ctypes.c_int]
        lib.fused_adamw_error_string.restype = ctypes.c_char_p
        _fns = (fn, master, lib.fused_adamw_error_string)
    return _fns


def _check_operands(p, named, rule):
    """Raise unless every ``(name, tensor, dtype)`` of ``named`` has that
    dtype and p's shape and device, and p and all of them are contiguous;
    ``rule`` states the dtype rule in the message."""
    for name, t, dt in named:
        if t.dtype != dt or t.shape != p.shape or t.device != p.device:
            raise ValueError(f"fused_adamw kernel: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; expected "
                             f"{dt} {tuple(p.shape)} on {p.device} ({rule})")
    for name, t in [("p", p)] + [(n, t) for n, t, _ in named]:
        if not t.is_contiguous():
            raise ValueError(f"fused_adamw kernel: {name} must be "
                             "contiguous")


def _launch(p, g, m1, m2, scalars, master=None) -> None:
    if master is None:
        if p.dtype not in KERNEL_DTYPES:
            raise ValueError(f"fused_adamw kernel: dtype {p.dtype} (the "
                             "kernel takes float32 and bfloat16)")
        _check_operands(p, [("g", g, p.dtype), ("m1", m1, p.dtype),
                            ("m2", m2, p.dtype)], "all four one dtype")
    else:
        if p.dtype not in MASTER_DTYPES:
            raise ValueError(f"fused_adamw master kernel: dtype {p.dtype} "
                             "(it takes bfloat16 and float16 parameters)")
        f32 = torch.float32
        _check_operands(p, [("g", g, p.dtype), ("master", master, f32),
                            ("m1", m1, f32), ("m2", m2, f32)],
                        "g in p's dtype; master, m1 and m2 float32")
    dev = p.device
    fn, master_fn, err_str = _kernel_fns()
    sc = (ctypes.c_float * 9)(*(float(s) for s in scalars))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if master is None:
        err = fn(dev.index, KERNEL_DTYPES[p.dtype], p.data_ptr(),
                 g.data_ptr(), m1.data_ptr(), m2.data_ptr(), p.numel(), sc,
                 stream)
    else:
        err = master_fn(dev.index, MASTER_DTYPES[p.dtype], p.data_ptr(),
                        g.data_ptr(), master.data_ptr(), m1.data_ptr(),
                        m2.data_ptr(), p.numel(), sc, stream)
    if err != 0:
        raise KernelError("fused_adamw kernel launch failed: "
                        f"{err_str(err).decode()} (cudaError {err})")


def fused_adamw_update(p, g, m1, m2, lr, b1p, b2p, *, beta1=0.9,
                       beta2=0.999, eps=1e-8, wd=0.01, fp32_lr=False,
                       master=None) -> None:
    """One AdamW step on ``p`` with gradient ``g`` and moments ``m1``,
    ``m2`` (all the same dtype and shape), in place.  ``lr``, ``b1p`` and
    ``b2p`` (beta1^t and beta2^t after this step's advance) are runtime
    values; nothing is rebuilt when they change.  ``fp32_lr``: see
    :func:`adamw_scalars`.

    ``master``: the fp32 master weights of a bf16 or fp16 ``p`` (and
    ``g``), with fp32 ``m1`` and ``m2``: the master is updated in place
    and ``p`` gets it rounded.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (counted in ``fused_adamw_update.launches``) or raise."""
    scalars = adamw_scalars(lr, b1p, b2p, beta1=beta1, beta2=beta2, eps=eps,
                            wd=wd, fp32_lr=fp32_lr)
    if p.device.type == "cpu":
        fused_adamw_plain(p, g, m1, m2, scalars, master=master)
        return
    _launch(p, g, m1, m2, scalars, master=master)
    fused_adamw_update.launches += 1


# kernel launches made through the wrapper (plain-version calls on the
# CPU never count); callers reset it to 0 before a run they measure
fused_adamw_update.launches = 0
