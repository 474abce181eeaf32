"""Named random streams (port of
``paddle_tpu/distributed/fleet/layers/mpu/random.py``): dropout inside a
tensor-parallel region draws from a stream of its own, apart from the
one outside it.

Each named state is a set of explicit ``torch.Generator``s, one for the
CPU and one for each card, seeded with the state's seed.  Inside
``rng_state(name)`` the default generators (PyTorch's CPU one and those
of the cards CUDA has set up) take the named state's values, so any draw
that uses the default generator -- dropout without a generator of its
own -- draws from the named stream; on leaving, the stream keeps where it
got to and the default generators are given back as they were.
"""
from __future__ import annotations

import random as _pyrandom
import zlib
from contextlib import contextmanager

import torch

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed"]


def _default_generators():
    """PyTorch's default generators: the CPU's, and each initialised
    card's."""
    gens = [torch.default_generator]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        gens.extend(torch.cuda.default_generators)
    return gens


class RNGStatesTracker:
    def __init__(self):
        self._states = {}

    def reset(self):
        self._states = {}

    def add(self, name, seed):
        if name in self._states:
            raise ValueError(f"rng state {name} already exists")
        self._states[name] = (int(seed), {})

    def get_states_tracker(self):
        return dict(self._states)

    def set_states_tracker(self, states):
        self._states = dict(states)

    def _generator(self, name, device) -> torch.Generator:
        """The named state's generator on ``device``, made from its seed
        the first time it is needed."""
        seed, gens = self._states[name]
        if device not in gens:
            gens[device] = torch.Generator(device=device).manual_seed(seed)
        return gens[device]

    @contextmanager
    def rng_state(self, name="model_parallel_rng"):
        if name not in self._states:
            # a stable seed from the name (Python's str hash is salted)
            self.add(name, zlib.crc32(name.encode()) & 0x7FFFFFFF)
        defaults = _default_generators()
        outer = [g.get_state() for g in defaults]
        for g in defaults:
            g.set_state(self._generator(name, g.device).get_state())
        try:
            yield
        finally:
            for g, state in zip(defaults, outer):
                self._generator(name, g.device).set_state(g.get_state())
                g.set_state(state)


_tracker = RNGStatesTracker()


def get_rng_state_tracker():
    return _tracker


def model_parallel_random_seed(seed=None):
    """Seed PyTorch's default generators with ``seed`` (a random one when
    None) and reset the tracker to the reference's two streams:
    ``model_parallel_rng`` at ``seed + 1`` and ``global_seed`` at
    ``seed``."""
    base = seed if seed is not None else _pyrandom.randint(0, 2 ** 31 - 1)
    _tracker.reset()
    torch.manual_seed(base)
    _tracker.add("model_parallel_rng", base + 1)
    _tracker.add("global_seed", base)
