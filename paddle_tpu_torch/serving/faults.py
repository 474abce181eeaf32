"""Serving fault injection: the re-exports of :mod:`paddle_tpu_torch.faults`
(as ``paddle_tpu/serving/faults.py`` re-exports ``paddle_tpu/faults.py``).
See there for the kind/point table; ``FaultInjector.install(engine)``
hooks the engine's step pipeline and its allocator."""
from __future__ import annotations

from ..faults import (  # noqa: F401
    KIND_POINTS,
    KINDS,
    FaultInjector,
    FaultPlan,
    InjectedFault,
    random_schedule,
    random_transfer_schedule,
)

__all__ = ["InjectedFault", "FaultPlan", "FaultInjector", "random_schedule",
           "random_transfer_schedule", "KINDS"]
