"""Continuous-batching serving over the paged KV cache (the port's first
slice): the engine, its request lifecycle and typed errors, the paged
pool and its allocator, and the admission scheduler."""
from .admission import AdmissionScheduler, Slot, StepWork
from .engine import (
    DeadlineExceeded, NaNLogitsError, Overloaded, Request, RequestCancelled,
    RequestQueue, RequestState, SamplingParams, ServingEngine, ServingError,
)
from .paged_cache import NULL_PAGE, BlockAllocator, PagedKVCache, \
    pages_for_tokens

__all__ = [
    "ServingEngine", "SamplingParams", "Request", "RequestState",
    "RequestQueue", "ServingError", "Overloaded", "DeadlineExceeded",
    "RequestCancelled", "NaNLogitsError", "PagedKVCache", "BlockAllocator",
    "NULL_PAGE", "pages_for_tokens", "AdmissionScheduler", "Slot",
    "StepWork",
]
