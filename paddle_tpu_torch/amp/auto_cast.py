"""AMP O2 decoration (port of ``decorate`` of
``paddle_tpu/amp/auto_cast.py``).

O1, the reference's per-op casts inside ``auto_cast``, is not ported:
``FusedTrainStep(amp_level="O1")`` takes only a model whose weights are
already low precision."""
from __future__ import annotations

import torch
from torch import nn

from ..core import to_torch_dtype

__all__ = ["decorate"]


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
