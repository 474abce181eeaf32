"""AMP (port of ``paddle_tpu/amp``): ``auto_cast``/``amp_guard`` O1 by
the reference's op lists, ``decorate`` O2, and ``GradScaler``."""
from .auto_cast import (
    amp_guard, amp_state, auto_cast, black_list, decorate, white_list,
)
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["auto_cast", "amp_guard", "amp_state", "decorate", "white_list",
           "black_list", "AmpScaler", "GradScaler"]
