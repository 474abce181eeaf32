"""Dtype names of the serving path -> torch dtypes (counterpart of
``paddle_tpu/core/dtype.py``, reduced to the two floating types this
slice serves in)."""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["to_torch_dtype", "dtype_name"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_NAMES = {v: k for k, v in _DTYPES.items()}


def to_torch_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """``"float32"``/``"bfloat16"`` (or the torch dtype itself) -> the
    torch dtype; anything else raises."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _NAMES:
            raise ValueError(f"unsupported dtype {dtype}: expected one of "
                             f"{sorted(_DTYPES)}")
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}: expected one of "
                         f"{sorted(_DTYPES)}") from None


def dtype_name(dtype: Union[str, torch.dtype]) -> str:
    """The canonical name (``"float32"``/``"bfloat16"``) of ``dtype``."""
    return _NAMES[to_torch_dtype(dtype)]
