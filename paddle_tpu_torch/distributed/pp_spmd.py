"""Microbatch pipeline over the ``pp`` axis (port of
``paddle_tpu/distributed/fleet/meta_parallel/pp_spmd.py``).

The reference runs the whole pipeline as one SPMD program: the stacked
``[L, ...]`` block weights sharded over ``pp``, a ``lax.scan`` over
``V * n_micro + S - 1`` ticks in which stage ``s`` runs microbatch
``t - s`` and hands its activation to the next stage with a
``ppermute``; ``jax.vjp`` of that forward is the pipelined backward.

The port is a plain function on tensors driven by one process: each
stage's weights live on the stage's devices (the model places them), the
ticks run in order, and an activation moves to the next stage with
``Tensor.to``, whose backward carries its gradient back.  Autograd of
the forward is the backward, as in the reference.  On distinct cards the
launches of one tick's stages overlap on their devices' streams; on one
card the ticks run in stream order.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, List, Optional, Sequence

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, create_selective_checkpoint_contexts,
)

from ..core.recompute import checkpoint

__all__ = ["RECOMPUTE_POLICIES", "checkpointed", "stage_layers",
           "pipeline_blocks"]

_ATEN = torch.ops.aten
# recompute_policy -> the products whose outputs a recomputed group keeps
# (None: it keeps nothing)
RECOMPUTE_POLICIES = {
    None: None, "full": None,
    "dots": (_ATEN.mm.default, _ATEN.addmm.default),
    "dots_saveable": (_ATEN.mm.default, _ATEN.addmm.default,
                      _ATEN.bmm.default),
}


def _save_ops_policy(ops):
    """A selective-checkpoint policy: keep the outputs of ``ops``,
    recompute every other op."""
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def checkpointed(fn: Callable, policy: Optional[str]) -> Callable:
    """``fn`` under the port's checkpoint (``core.recompute``) with the
    named policy (the reference's ``_checkpoint``): None or "full"
    recompute everything in the backward; "dots"/"dots_saveable" keep the
    products' outputs."""
    if policy not in RECOMPUTE_POLICIES:
        raise ValueError(
            f"unknown remat policy {policy!r}; expected one of "
            "[None, 'full', 'dots', 'dots_saveable']")
    saved = RECOMPUTE_POLICIES[policy]
    kw = {} if saved is None else dict(context_fn=partial(
        create_selective_checkpoint_contexts, _save_ops_policy(saved)))

    def run(*args):
        return checkpoint(fn, *args, **kw)
    return run


def stage_layers(num_layers: int, n_stages: int, n_virtual: int = 1
                 ) -> List[List[int]]:
    """The layers each stage holds, in the order it runs them (the
    reference's ``stacked_param_sharding`` with the interleave layout of
    ``pipeline_blocks``): ``num_layers / n_stages`` a stage; with
    ``n_virtual`` V > 1, chunks of ``num_layers / (n_stages * V)``
    contiguous layers placed round-robin, chunk ``c`` on stage
    ``c % n_stages``, so stage ``d`` holds chunks ``d, S + d, 2S + d,
    ...``."""
    if num_layers % n_stages:
        raise ValueError(f"num_layers={num_layers} is not divisible by the "
                         f"pp axis ({n_stages} stages)")
    lps = num_layers // n_stages
    if lps % n_virtual:
        raise ValueError(f"layers_per_stage ({lps}) must be divisible by "
                         f"n_virtual ({n_virtual})")
    lpc = lps // n_virtual
    return [[(v * n_stages + d) * lpc + j for v in range(n_virtual)
             for j in range(lpc)] for d in range(n_stages)]


def pipeline_blocks(block_fn: Callable, stages: Sequence[Sequence],
                    x_micro: Sequence[torch.Tensor], *,
                    layers_per_stage: int, remat: bool = False,
                    remat_policy: Optional[str] = None,
                    block_takes_index: bool = False, n_virtual: int = 1,
                    stage_devices: Optional[Sequence[torch.device]] = None
                    ) -> List[torch.Tensor]:
    """Microbatch-pipelined execution of blocks over ``len(stages)``
    stages (the reference's ``pipeline_blocks``, same checks and
    schedule).

    - ``block_fn(params, h) -> h`` for one block; with
      ``block_takes_index`` it is ``(params, h, mb_idx) -> h``, so a
      stochastic block can tell the microbatches apart;
    - ``stages[s]``: stage ``s``'s blocks' params, one entry a block, in
      the order of :func:`stage_layers` (``layers_per_stage`` entries);
    - ``x_micro``: the ``M`` microbatch inputs (a sequence, or a tensor
      with the microbatches on its leading axis);
    - ``n_virtual`` V > 1: chunks of ``layers_per_stage / V`` blocks, and
      microbatches make V trips around the stages (needs ``M >= S``, so
      a trip's first tick never outruns the previous trip's drain);
    - ``remat``: each block under the port's checkpoint with
      ``remat_policy`` (per block and microbatch, as the reference
      checkpoints the block inside its tick scan);
    - ``stage_devices[s]``: where stage ``s`` takes its input (an
      activation is moved there before the stage runs it).

    At tick ``t`` stage ``s`` runs microbatch ``(t - s) mod M`` of trip
    ``(t - s) // M``; stage 0 takes trip 0 from ``x_micro`` and later
    trips from the last stage's parked outputs.  Returns the ``M``
    outputs of the last trip, on the last stage's device."""
    n_stages = len(stages)
    n_micro = len(x_micro)
    V = int(n_virtual)
    if V > 1:
        if n_micro < n_stages:
            raise ValueError(f"interleave needs n_micro ({n_micro}) >= "
                             f"n_stages ({n_stages})")
        if layers_per_stage % V:
            raise ValueError(f"layers_per_stage ({layers_per_stage}) must "
                             f"be divisible by n_virtual ({V})")
    if any(len(p) != layers_per_stage for p in stages):
        raise ValueError(f"each stage must hold layers_per_stage "
                         f"({layers_per_stage}) blocks, got "
                         f"{[len(p) for p in stages]}")
    if not block_takes_index:
        base = block_fn
        block_fn = lambda p, h, idx: base(p, h)  # noqa: E731
    body = checkpointed(block_fn, remat_policy) if remat else block_fn
    lpc = layers_per_stage // V

    def to_stage(h, s):
        if stage_devices is None or h.device == stage_devices[s]:
            return h
        return h.to(stage_devices[s])

    outputs: List[Optional[torch.Tensor]] = [None] * n_micro
    parked: List[Optional[torch.Tensor]] = [None] * n_micro
    carry: List[Optional[torch.Tensor]] = [None] * n_stages
    for t in range(V * n_micro + n_stages - 1):
        nxt: List[Optional[torch.Tensor]] = [None] * n_stages
        for s in range(n_stages):
            rel = t - s
            if not 0 <= rel < V * n_micro:
                continue
            v, mb = divmod(rel, n_micro)
            if s == 0:
                h = to_stage(x_micro[mb] if v == 0 else parked[mb], 0)
            else:
                h = carry[s]
            for p in stages[s][v * lpc:(v + 1) * lpc]:
                h = body(p, h, mb)
            if s < n_stages - 1:
                nxt[s + 1] = to_stage(h, s + 1)
            elif v == V - 1:
                outputs[mb] = h
            else:
                parked[mb] = h
        carry = nxt
    return outputs
