"""Dtype names of the serving path -> torch dtypes (counterpart of
``paddle_tpu/core/dtype.py``, reduced to what the port serves in).

Activations and weights that compute are float32 or bfloat16.  ``"int8"``
is a *storage* dtype only: a quantized KV pool or a quantized weight
buffer, made with ``to_torch_dtype("int8", storage=True)``; everything
else refuses it."""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["to_torch_dtype", "dtype_name"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_STORAGE = {**_DTYPES, "int8": torch.int8}
_NAMES = {v: k for k, v in _STORAGE.items()}


def to_torch_dtype(dtype: Union[str, torch.dtype], *,
                   storage: bool = False) -> torch.dtype:
    """``"float32"``/``"bfloat16"`` (or the torch dtype itself) -> the
    torch dtype; with ``storage=True`` also ``"int8"``.  Anything else
    raises."""
    table = _STORAGE if storage else _DTYPES
    if isinstance(dtype, torch.dtype):
        if dtype not in table.values():
            raise ValueError(f"unsupported dtype {dtype}: expected one of "
                             f"{sorted(table)}")
        return dtype
    try:
        return table[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}: expected one of "
                         f"{sorted(table)}") from None


def dtype_name(dtype: Union[str, torch.dtype]) -> str:
    """The canonical name (``"float32"``/``"bfloat16"``/``"int8"``) of
    ``dtype``."""
    return _NAMES[to_torch_dtype(dtype, storage=True)]
