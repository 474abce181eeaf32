"""Continuous-batching serving over the paged KV cache: the engine, its
request lifecycle and typed errors, the paged pool and its allocator, the
admission scheduler, the prefix cache, the watchdog's fault-injection
harness, speculative decoding and multi-tenant LoRA adapters."""
from .admission import AdmissionScheduler, Slot, StepWork
from .engine import (
    DeadlineExceeded, NaNLogitsError, Overloaded, Request, RequestCancelled,
    RequestQueue, RequestState, SamplingParams, ServingEngine, ServingError,
    StepStalledError,
)
from .faults import (
    FaultInjector, FaultPlan, InjectedFault, random_schedule,
    random_transfer_schedule,
)
from .lora import (
    AdapterError, AdapterInUse, LoRAAdapterPool, UnknownAdapter,
    random_adapter,
)
from .paged_cache import NULL_PAGE, BlockAllocator, PagedKVCache, \
    pages_for_tokens
from .prefix_cache import PrefixCache
from .speculative import SpeculativeEngine

__all__ = [
    "ServingEngine", "SpeculativeEngine", "SamplingParams", "Request",
    "RequestState", "RequestQueue", "ServingError", "Overloaded",
    "DeadlineExceeded", "RequestCancelled", "StepStalledError",
    "NaNLogitsError", "LoRAAdapterPool", "AdapterError", "AdapterInUse",
    "UnknownAdapter", "random_adapter", "FaultInjector", "FaultPlan",
    "InjectedFault", "random_schedule", "random_transfer_schedule",
    "PagedKVCache", "BlockAllocator", "NULL_PAGE", "pages_for_tokens",
    "PrefixCache", "AdmissionScheduler", "Slot", "StepWork",
]
