"""Device resolution for the port's entry points (counterpart of
``paddle_tpu/core/place.py``).

The port serves on the card: ``device=None`` means ``"cuda"``, and a
missing CUDA device is an error, never a silent move to the CPU.  Tests
and CPU parity runs ask for the CPU explicitly with ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "canonical_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; raises when a CUDA device is asked for and
    none is present.  ``meta`` builds a module's skeleton (no storage,
    nothing drawn), whose tensors are assigned after
    (``load_state_dict(..., assign=True)``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card by "
            "default; pass device='cpu' to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}: expected cuda, cpu or "
                         "meta")
    return dev


def canonical_device(device: Union[str, torch.device]) -> torch.device:
    """:func:`resolve_device` with the index filled in: ``cuda`` is the
    current card (``cuda:0`` unless the caller chose another), so two
    names of one card compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
