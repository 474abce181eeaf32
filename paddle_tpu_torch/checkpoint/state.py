"""Full resumable training state (port of ``paddle_tpu/checkpoint/
state.py``).

Captures what a preempted job needs to continue bit for bit: the model's
``state_dict``, the optimizer's (``AdamW.state_dict``: moments, masters,
the beta powers as ``aux_0``/``aux_1`` and the LR scheduler), the
GradScaler's, the random state and the trainer's position.  The port has
no global key: ``include_rng`` captures every ``torch.Generator`` the
bound model's modules hold as ``generator`` (the dropout seeds' host
generator of the ported models), ``torch.get_rng_state()`` and, where a
card is present, ``torch.cuda.get_rng_state()``.

``capture()`` returns a picklable tree of host leaves (the snapshot
``CheckpointManager`` writes): numpy arrays, or CPU tensors for dtypes
numpy lacks (bfloat16).  ``restore()`` pushes a tree back through
``load_state_dict``/``set_state_dict``, so ``train(k); resume;
train(N - k)`` matches ``train(N)``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["TrainState", "to_host"]


def to_host(obj):
    """Device tree -> host tree: tensors become numpy arrays (CPU tensors
    where numpy has no such dtype), copied; containers recurse; other
    leaves pass through."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().to("cpu", copy=True)
        return t if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _to_torch(obj):
    """A host tree's arrays as tensors (what ``load_state_dict`` takes)."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj.copy())
    if isinstance(obj, dict):
        return {k: _to_torch(v) for k, v in obj.items()}
    return obj


def _generators(model) -> Dict[str, torch.Generator]:
    """Every ``torch.Generator`` a module of ``model`` holds as its
    ``generator``, by module name (one entry per generator object)."""
    out, seen = {}, set()
    for name, mod in model.named_modules():
        gen = getattr(mod, "generator", None)
        if isinstance(gen, torch.Generator) and id(gen) not in seen:
            seen.add(id(gen))
            out[name] = gen
    return out


class TrainState:
    """Binds the live training objects whose state a checkpoint spans:
    ``model`` (an ``nn.Module``), ``optimizer`` (the port's ``AdamW``) and
    ``scaler`` (a ``GradScaler``), each optional; ``include_rng`` adds the
    random state (module docstring)."""

    def __init__(self, model=None, optimizer=None, scaler=None,
                 include_rng: bool = True):
        self.model = model
        self.optimizer = optimizer
        self.scaler = scaler
        self.include_rng = include_rng

    def _rng_state(self) -> Dict[str, Any]:
        rng = {"cpu": torch.get_rng_state().numpy()}
        if torch.cuda.is_available():
            rng["cuda"] = torch.cuda.get_rng_state().numpy()
        if self.model is not None:
            rng["generators"] = {k: g.get_state().numpy()
                                 for k, g in _generators(self.model).items()}
        return rng

    def capture(self, position: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        """Host snapshot of all bound state.  ``position`` is the trainer's
        cursor, e.g. ``{"epoch": e, "step": s}``, stored verbatim and
        handed back by :meth:`restore`."""
        tree: Dict[str, Any] = {"position": dict(position or {})}
        if self.model is not None:
            tree["model"] = to_host(dict(self.model.state_dict()))
        if self.optimizer is not None:
            tree["optimizer"] = to_host(self.optimizer.state_dict())
        if self.scaler is not None:
            tree["scaler"] = to_host(self.scaler.state_dict())
        if self.include_rng:
            tree["rng"] = self._rng_state()
        return tree

    def restore(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """Push a captured tree back into the bound objects; returns the
        stored position."""
        if self.model is not None and "model" in tree:
            self.model.load_state_dict(_to_torch(tree["model"]))
        if self.optimizer is not None and "optimizer" in tree:
            self.optimizer.set_state_dict(tree["optimizer"])
        if self.scaler is not None and "scaler" in tree:
            self.scaler.load_state_dict(tree["scaler"])
        if self.include_rng and "rng" in tree:
            rng = tree["rng"]
            torch.set_rng_state(torch.from_numpy(rng["cpu"].copy()))
            if "cuda" in rng and torch.cuda.is_available():
                torch.cuda.set_rng_state(torch.from_numpy(rng["cuda"].copy()))
            if self.model is not None:
                gens = _generators(self.model)
                for k, state in rng.get("generators", {}).items():
                    if k in gens:
                        gens[k].set_state(torch.from_numpy(state.copy()))
        return dict(tree.get("position", {}))
