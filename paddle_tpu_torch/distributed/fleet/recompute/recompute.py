"""Activation recomputation (port of
``paddle_tpu/distributed/fleet/recompute/recompute.py``): ``function``'s
activations are dropped after the forward and computed again in the
backward.

The port runs its own checkpoint (``core.recompute``, PyTorch's design
without re-entry, guarded for backward passes that span devices), so tensors
the function reads without taking them as arguments (a module's
parameters) get their gradients: the run without recompute's.  The
reference's eager recompute hands only the tensor arguments to its
``PyLayer``, so such parameters get none there (ROADMAP.md queue 3).

With ``preserve_rng_state`` the recomputed forward draws the masks the
forward drew.  The forward's random states are kept -- PyTorch's default
generators (the CPU's and each initialised card's), every stream of the
fleet ``RNGStatesTracker``, and each ``torch.Generator`` the function
holds (a ``Dropout``'s, or one passed as an argument) -- and the
recompute runs from them, then gives every generator back the state it
had before the recompute, so the streams go on as if it drew nothing.
The ``auto_cast`` state and the replica bindings a forward ran in
(``shards.bound_now``) are entered again around the recompute, which
runs in the backward, outside both.
"""
from __future__ import annotations

from contextlib import ExitStack
from functools import partial

import torch
from torch import nn

from ....amp.auto_cast import amp_state, auto_cast
from ....core.recompute import checkpoint
from ...shards import bound_now
from ..layers.mpu.random import get_rng_state_tracker

__all__ = ["recompute", "recompute_sequential"]


def _generators(function, args):
    """The explicit generators ``function`` may draw from: those among
    ``args``, and the ``generator`` attributes of the modules it holds --
    itself, a bound method's module, or a ``functools.partial``'s
    arguments (lists and tuples of them looked into)."""
    gens, seen = [], set()

    def visit(obj, depth=0):
        if isinstance(obj, torch.Generator):
            gens.append(obj)
        elif isinstance(obj, nn.Module):
            gens.extend(m.generator for m in obj.modules()
                        if isinstance(getattr(m, "generator", None),
                                      torch.Generator))
        elif isinstance(obj, partial):
            # the arguments name what the function runs (its own
            # module, if a bound method, may hold far more)
            for o in (*obj.args, *obj.keywords.values()):
                visit(o, depth)
        elif isinstance(obj, (list, tuple)) and depth < 2:
            for o in obj:
                visit(o, depth + 1)
        elif getattr(obj, "__self__", None) is not None \
                and id(obj.__self__) not in seen:
            seen.add(id(obj.__self__))
            visit(obj.__self__, depth)

    visit(function)
    for a in args:
        visit(a)
    return list({id(g): g for g in gens}.values())


def _default_generators():
    gens = [torch.default_generator]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        gens.extend(torch.cuda.default_generators)
    return gens


class _RngSnapshot:
    """The states of the generators a recomputed function may draw from
    (module docstring), taken now; :meth:`restore` sets them back."""

    def __init__(self, explicit):
        self.explicit = explicit
        self.gens = _default_generators() + explicit
        self.states = [g.get_state() for g in self.gens]
        tracker = get_rng_state_tracker()
        self.tracker = {name: (seed, {d: g.get_state()
                                      for d, g in gens.items()})
                        for name, (seed, gens) in tracker._states.items()}

    def restore(self):
        for g, s in zip(self.gens, self.states):
            g.set_state(s)
        tracker = get_rng_state_tracker()
        for name, (seed, states) in self.tracker.items():
            if name not in tracker._states:
                continue
            gens = tracker._states[name][1]
            for d in list(gens):
                if d not in states:
                    # made after the snapshot: made again from the seed
                    del gens[d]
            for d, s in states.items():
                if d not in gens:
                    gens[d] = torch.Generator(device=d)
                gens[d].set_state(s)


def recompute(function, *args, preserve_rng_state=True, use_reentrant=True,
              **kwargs):
    """``function(*args, **kwargs)``, its activations recomputed in the
    backward (module docstring).  Without grad mode, or when no tensor
    argument needs a gradient, it is a plain call, as in the reference.
    ``use_reentrant`` is accepted, as the reference accepts it; the port
    never re-enters."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not torch.is_grad_enabled() or not any(t.requires_grad
                                              for t in tensors):
        return function(*args, **kwargs)
    bindings = bound_now()
    st = amp_state()
    cast = (st.enabled, st.custom_white, st.custom_black, st.level, st.dtype)
    snap = _RngSnapshot(_generators(function, args)) \
        if preserve_rng_state else None
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return function(*a, **kwargs)
        now = _RngSnapshot(snap.explicit) if snap is not None else None
        try:
            with ExitStack() as stack:
                for b in bindings:
                    stack.enter_context(b)
                stack.enter_context(auto_cast(*cast))
                if snap is not None:
                    snap.restore()
                return function(*a, **kwargs)
        finally:
            if now is not None:
                now.restore()

    return checkpoint(run, *args, preserve_rng_state=False)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """The reference's chunked recompute over a sequence of layers:
    ``ctx["segments"]`` runs of ``len(functions) // segments`` layers
    (the last may be shorter), each under :func:`recompute`."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    per = max(1, len(layers) // segments)

    def run_segment(lo, hi):
        def seg(x):
            for layer in layers[lo:hi]:
                x = layer(x)
            return x
        return seg

    x = args[0]
    for lo in range(0, len(layers), per):
        x = recompute(run_segment(lo, min(lo + per, len(layers))), x,
                      **kwargs)
    return x
