from .device import canonical_device, resolve_device
from .dtype import dtype_name, to_torch_dtype

__all__ = ["resolve_device", "canonical_device", "to_torch_dtype", "dtype_name"]
