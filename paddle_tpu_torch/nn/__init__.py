from . import functional, layers

__all__ = ["functional", "layers"]
