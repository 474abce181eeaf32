"""Quantized serving: int8 KV pages with per-(page, head) scales, and
int8 weights with per-output-channel scales."""
from .int8 import (
    Int8Linear, quantize_for_serving, quantize_weight, quantized_matmul,
)
from .kv import TINY_SCALE, dequant_pages, quantize_kv_write

__all__ = ["TINY_SCALE", "quantize_kv_write", "dequant_pages",
           "quantize_weight", "quantized_matmul", "Int8Linear",
           "quantize_for_serving"]
