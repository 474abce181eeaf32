"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  Importing this package builds nothing: a kernel's library is
compiled from ``csrc/`` on its first launch (``_build.py``)."""

from ._build import KernelError

__all__ = ["KernelError"]
