"""AMP: ``auto_cast`` O1 and ``decorate`` O2 (port of
``paddle_tpu/amp/auto_cast.py``).

O1 casts the floating-point inputs of each op by the reference's lists:
an op of :data:`white_list` (products, attention) runs in the amp dtype,
an op of :data:`black_list` (norms, softmax, losses, reductions) in fp32,
any other op as its inputs come.  The reference casts at its dispatcher;
the port has none, so each of its entry points that the lists name
(``nn.functional.linear``, ``softmax``/``log_softmax``,
``scaled_dot_product_attention`` and its flash route, ``cross_entropy``,
``layer_norm``, the fused add + norm layers of ``incubate``) casts its
inputs through :func:`maybe_cast`, the counterpart of the reference's
``_maybe_cast_inputs``.  ``torch.autocast`` is not used: its lists are
not the reference's, and it never sees the kernels, which launch through
``ctypes``.

The stacked GPT's blocks read :func:`o1_dtype` and cast their weights
at the reference's rounding points themselves (``models/gpt.py``), as
the reference's fused block does; its loss head reads :func:`amp_state`.

The state is thread-local, as the reference's is.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch
from torch import nn

from ..core import to_torch_dtype

__all__ = ["auto_cast", "amp_guard", "amp_state", "decorate",
           "white_list", "black_list", "maybe_cast", "o1_dtype"]

# the reference's lists (its amp_lists.py, as paddle_tpu keeps them)
white_list = {"matmul", "linear", "conv2d", "conv1d", "conv3d", "einsum",
              "mm", "bmm", "sdpa", "flash_attention"}
black_list = {
    "exp", "square", "log", "mean", "sum", "cos_sim", "softmax",
    "log_softmax", "softmax_with_cross_entropy", "cross_entropy",
    "layer_norm", "batch_norm", "p_norm", "logsumexp", "cumsum",
    "fused_add_layer_norm", "fused_add_rms_norm",
}

# the dtypes auto_cast takes (float16 runs the plain versions on the CPU;
# the card's flash kernels refuse it, ROADMAP.md queue 2)
_AMP_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
               "float32": torch.float32}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_amp_state = _AmpState()


def amp_state() -> _AmpState:
    """This thread's amp state: ``enabled``, ``dtype``, ``level`` and the
    custom lists of the innermost ``auto_cast``."""
    return _amp_state


def o1_dtype():
    """The amp dtype when an ``auto_cast`` at level O1 is in effect on
    this thread, else ``None``."""
    st = _amp_state
    return st.dtype if st.enabled and st.level == "O1" else None


def maybe_cast(op_name: str, *tensors):
    """The reference's ``_maybe_cast_inputs`` under O1: ``tensors`` with
    every floating-point one cast to the amp dtype when ``op_name`` is on
    the white list (with the custom lists applied), to fp32 when it is on
    the black list, unchanged otherwise or outside O1.  ``None`` and
    integer tensors pass through.  Returns a tuple."""
    st = _amp_state
    if not (st.enabled and st.level == "O1"):
        return tensors
    if op_name in (white_list | st.custom_white) - st.custom_black:
        tgt = st.dtype
    elif op_name in (black_list | st.custom_black) - st.custom_white:
        tgt = torch.float32
    else:
        return tensors
    return tuple(t.to(tgt) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() and t.dtype != tgt else t
                 for t in tensors)


def _amp_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        if dtype not in _AMP_DTYPES.values():
            raise ValueError(f"auto_cast dtype {dtype}: expected one of "
                             f"{sorted(_AMP_DTYPES)}")
        return dtype
    try:
        return _AMP_DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"auto_cast dtype {dtype!r}: expected one of "
                         f"{sorted(_AMP_DTYPES)}") from None


@contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Within the block, cast op inputs by the lists (level ``"O1"``);
    ``custom_white_list``/``custom_black_list`` move op names onto a list
    (and off the other).  Level ``"O2"`` casts nothing per op (the model
    was decorated).  ``use_promote`` is accepted, as the reference
    accepts it.  Nests; the previous state comes back on exit."""
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"auto_cast level must be 'O0', 'O1' or 'O2', got "
                         f"{level!r}")
    dt = _amp_dtype(dtype)
    st = _amp_state
    prev = (st.enabled, st.dtype, st.level, st.custom_white, st.custom_black)
    st.enabled = bool(enable)
    st.dtype = dt
    st.level = level
    st.custom_white = set(custom_white_list or [])
    st.custom_black = set(custom_black_list or [])
    try:
        yield
    finally:
        st.enabled, st.dtype, st.level, st.custom_white, st.custom_black = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast every floating-point parameter and buffer of ``models`` (a
    module or a list of them) to ``dtype`` in place -- the parameters stay
    the same objects -- and return ``models`` (and ``optimizers`` when
    given) unchanged otherwise.  O1 casts nothing.

    The masters are the optimizer's, not this function's: as in the
    reference, an ``AdamW(multi_precision=True)`` makes each bf16 or fp16
    parameter's fp32 master when it is built, from the value it sees
    then.  So build the optimizer after ``decorate`` to train bf16 weights
    on fp32 masters; an optimizer built before it saw fp32 parameters and
    keeps no masters.  ``master_weight`` and ``save_dtype`` are accepted
    and ignored, as the reference ignores them."""
    if level not in ("O1", "O2"):
        raise ValueError(f"level must be 'O1' or 'O2', got {level!r}")
    single = isinstance(models, nn.Module)
    model_list = [models] if single else list(models)
    if level == "O2":
        dt = to_torch_dtype(dtype)
        for m in model_list:
            m.to(dtype=dt)
            # the ported models record their dtype; keep it true
            for sub in m.modules():
                if isinstance(getattr(sub, "dtype", None), torch.dtype):
                    sub.dtype = dt
    out = models if single else model_list
    return out if optimizers is None else (out, optimizers)
