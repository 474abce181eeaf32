"""Input pipeline (port of ``paddle_tpu/io/device_prefetch.py``; the
``DataLoader`` and datasets are ROADMAP.md queue 1, item 10)."""
from .device_prefetch import DevicePrefetcher

__all__ = ["DevicePrefetcher"]
