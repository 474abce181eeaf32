"""Parallelism planner and analytic cost model (port of
``paddle_tpu/distributed/auto_parallel/planner.py``; reference: Paddle's
``auto_parallel/static/completion.py:936``, ``tuner/parallel_tuner.py``
and ``cost_model.py``).

The planning problem is the JAX package's: pick the mesh factorization
(dp x mp x pp) of the device count and the Megatron placements for it.
The cost model is the same roofline: per-device compute time, the
tensor-parallel activation all-reduces over the link, the pipeline
bubble and the (half overlapped) data-parallel gradient all-reduce, with
an HBM-residency feasibility gate.  The formulas are copied as they
stand; only :class:`ClusterSpec`'s defaults are the H100's.

``plan()`` enumerates and scores the factorizations;
:func:`placement_decisions` walks the port's modules (``nn.Embedding``
tables vocabulary-parallel, the port's ``Linear`` weights, ``[in, out]``,
alternately column- and row-parallel over ``mp``, in the JAX model's
sublayer order) and names each decided weight by its state-dict key; the
Engine (``engine.py``) feeds the decisions to the propagation executor
as ``DistSpec``s (:func:`apply_placement_rules`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from .. import mesh as _mesh

__all__ = ["ModelSpec", "ClusterSpec", "Candidate", "plan", "plan_measured",
           "placement_decisions", "apply_placement_rules"]


@dataclasses.dataclass
class ModelSpec:
    """Transformer-shaped workload description (the flagship family)."""
    hidden: int
    layers: int
    seq: int
    vocab: int
    batch: int                      # global batch, sequences
    ffn_mult: int = 4
    param_bytes: int = 2            # bf16
    grad_bytes: int = 2
    moment_bytes: int = 4           # two bf16 moments
    act_bytes: int = 2
    n_micro: int = 4                # pipeline microbatches

    @property
    def params(self) -> int:
        h, L, V = self.hidden, self.layers, self.vocab
        per_layer = (4 + 2 * self.ffn_mult) * h * h
        return L * per_layer + V * h

    @property
    def step_flops(self) -> float:
        """Megatron fwd+bwd FLOPs per step (``bench.py``'s form)."""
        b, s, L, h, V = (self.batch, self.seq, self.layers, self.hidden,
                         self.vocab)
        return 72.0 * b * s * L * h * h * (
            1 + s / (6.0 * h) + V / (12.0 * L * h))

    @classmethod
    def from_gpt_config(cls, cfg, batch: int, seq: Optional[int] = None):
        """From the port's ``GPTConfig`` (``models/gpt.py``)."""
        return cls(hidden=cfg.hidden_size, layers=cfg.num_layers,
                   seq=seq or cfg.max_position_embeddings,
                   vocab=cfg.vocab_size, batch=batch)


@dataclasses.dataclass
class ClusterSpec:
    """Per-card numbers; the defaults are one host of eight NVIDIA H100
    SXM cards: 80 GB of HBM3, 989 TFLOP/s bf16 dense, and ``ici_bw`` the
    NVLink rate between two cards, 450 GB/s each way (the field keeps
    the JAX package's name, where it is the TPU interconnect, so callers'
    code carries over).  ``mfu``, the achievable fraction of peak, is an
    assumption of the model, not a measurement."""
    n_devices: int = 8
    hbm_bytes: float = 80e9
    flops: float = 989e12          # bf16 dense peak
    ici_bw: float = 450e9          # bytes/s, NVLink, each way
    mfu: float = 0.4               # assumed achievable fraction of peak


@dataclasses.dataclass
class Candidate:
    mesh: Dict[str, int]
    step_time: float               # seconds, estimated
    compute_time: float
    tp_comm_time: float
    dp_comm_time: float
    bubble_frac: float
    mem_bytes: float               # per-device residency
    feasible: bool
    reason: str = ""

    def as_dict(self):
        return dataclasses.asdict(self)


def _factorizations(n: int) -> List[Tuple[int, int, int]]:
    """(dp, mp, pp) triples with dp*mp*pp == n."""
    out = []
    for mp in [d for d in range(1, n + 1) if n % d == 0]:
        rest = n // mp
        for pp in [d for d in range(1, rest + 1) if rest % d == 0]:
            out.append((rest // pp, mp, pp))
    return out


def _score(m: ModelSpec, c: ClusterSpec, dp: int, mp: int, pp: int
           ) -> Candidate:
    mesh = {"dp": dp, "mp": mp, "pp": pp}
    n = dp * mp * pp
    h, s, L, V = m.hidden, m.seq, m.layers, m.vocab

    # feasibility: per-device HBM residency
    state_bytes = (m.params / (mp * pp)) * (
        m.param_bytes + m.grad_bytes + m.moment_bytes)
    # activations per device: microbatch activations on the live stages,
    # recomputed to layer boundaries -- one [b, s, h] boundary per layer
    # plus roughly one layer's working set (factor 2)
    b_local = max(1, m.batch // dp)
    b_micro = max(1, b_local // m.n_micro) if pp > 1 else b_local
    act_bytes = (L / pp) * b_micro * s * (h / mp) * m.act_bytes * 2
    mem = state_bytes + act_bytes
    feasible = mem < 0.9 * c.hbm_bytes
    reason = "" if feasible else (
        f"per-device residency {mem/1e9:.1f} GB > 90% of "
        f"{c.hbm_bytes/1e9:.0f} GB HBM")

    compute = m.step_flops / (n * c.flops * c.mfu)

    # tensor-parallel activation all-reduces (Megatron: 4 a layer, fwd+bwd)
    if mp > 1:
        per_ar = (2.0 * b_local * s * h * m.act_bytes * (mp - 1) / mp
                  / c.ici_bw)
        tp_comm = 4.0 * L / pp * per_ar * (m.n_micro if pp > 1 else 1)
    else:
        tp_comm = 0.0

    # pipeline bubble (1F1B): (pp-1)/m extra
    bubble = (pp - 1) / max(m.n_micro, 1) if pp > 1 else 0.0

    # data-parallel gradient all-reduce (bf16 grads, ring), half overlapped
    if dp > 1:
        dp_comm = 0.5 * (2.0 * (m.params / (mp * pp)) * m.grad_bytes
                         * (dp - 1) / dp) / c.ici_bw
    else:
        dp_comm = 0.0

    step_time = (compute + tp_comm) * (1 + bubble) + dp_comm
    return Candidate(mesh=mesh, step_time=step_time, compute_time=compute,
                     tp_comm_time=tp_comm, dp_comm_time=dp_comm,
                     bubble_frac=bubble, mem_bytes=mem, feasible=feasible,
                     reason=reason)


def plan(model: ModelSpec, cluster: ClusterSpec) -> List[Candidate]:
    """All factorizations of the device count, scored; feasible ones
    first, each group sorted by estimated step time."""
    cands = [_score(model, cluster, dp, mp, pp)
             for dp, mp, pp in _factorizations(cluster.n_devices)]
    return sorted(cands, key=lambda c: (not c.feasible, c.step_time))


def _score_measured(fwd_flops: float, act_bytes: float, param_bytes: float,
                    c: ClusterSpec, dp: int, mp: int, pp: int,
                    comm_bytes: float = 0.0) -> Candidate:
    """The roofline over measured graph numbers (``propagation.
    graph_cost``), for models that are not transformer-shaped: FLOPs,
    activation bytes and parameter bytes read off the captured nodes."""
    mesh = {"dp": dp, "mp": mp, "pp": pp}
    n = dp * mp * pp
    # forward measured; backward ~ 2x forward
    compute = 3.0 * fwd_flops / (n * c.flops * c.mfu)
    # optimizer state: p + g + 2 moments per shard
    state = param_bytes * 4.0 / (mp * pp)
    act = act_bytes / (dp * mp)
    mem = state + act
    feasible = mem < 0.9 * c.hbm_bytes
    reason = "" if feasible else (
        f"per-device residency {mem/1e9:.1f} GB > 90% HBM")
    # the propagation pass's measured reshard bytes ride the link too
    tp_comm = ((2.0 * act_bytes / dp * (mp - 1) / mp + comm_bytes / dp)
               / c.ici_bw if mp > 1 else 0.0)
    dp_comm = (0.5 * 2.0 * param_bytes / (mp * pp) * (dp - 1) / dp
               / c.ici_bw if dp > 1 else 0.0)
    bubble = (pp - 1) / 4.0 if pp > 1 else 0.0
    step_time = (compute + tp_comm) * (1 + bubble) + dp_comm
    return Candidate(mesh=mesh, step_time=step_time, compute_time=compute,
                     tp_comm_time=tp_comm, dp_comm_time=dp_comm,
                     bubble_frac=bubble, mem_bytes=mem, feasible=feasible,
                     reason=reason)


def plan_measured(fwd_flops: float, act_bytes: float, param_bytes: float,
                  cluster: ClusterSpec,
                  comm_bytes: float = 0.0) -> List[Candidate]:
    """Rank factorizations for an arbitrary captured graph."""
    cands = [_score_measured(fwd_flops, act_bytes, param_bytes, cluster,
                             dp, mp, pp, comm_bytes)
             for dp, mp, pp in _factorizations(cluster.n_devices)]
    return sorted(cands, key=lambda c: (not c.feasible, c.step_time))


def placement_decisions(model: torch.nn.Module, mp: int):
    """Yield ``(state-dict key, parameter, per-dim axes)``: the Megatron
    placement decisions, the one source both :func:`apply_placement_rules`
    and ``Engine._param_specs`` read -- ``nn.Embedding`` tables
    vocabulary-parallel, the port's ``Linear`` weights (``[in, out]``)
    alternately column- and row-parallel over ``mp`` (a column-parallel
    layer's bias with it), in module order, which is the JAX model's
    sublayer order.  A dimension ``mp`` does not divide is left whole,
    as the JAX planner leaves it."""
    from ...nn.layers import Linear

    if mp <= 1:
        return
    col_next = True
    for prefix, layer in model.named_modules():
        key = prefix + "." if prefix else ""
        if isinstance(layer, torch.nn.Embedding):
            w = layer.weight
            if w.shape[0] % mp == 0:
                yield key + "weight", w, ("mp",) + (None,) * (w.dim() - 1)
        elif isinstance(layer, Linear):
            w = layer.weight                      # [in, out]
            if col_next and w.shape[1] % mp == 0:
                yield key + "weight", w, (None, "mp")      # column parallel
                b = layer.bias
                if b is not None and b.shape[0] % mp == 0:
                    yield key + "bias", b, ("mp",)
            elif (not col_next) and w.shape[0] % mp == 0:
                yield key + "weight", w, ("mp", None)      # row parallel
            col_next = not col_next


def apply_placement_rules(model: torch.nn.Module, mesh_axes: Dict[str, int],
                          specs: Optional[dict] = None) -> int:
    """The placement decisions for the global mesh's ``mp``: the count of
    parameters placed, as the JAX function returns it.  There is no GSPMD
    to install shardings on: each decided parameter's ``DistSpec`` goes
    into ``specs`` (keyed by state-dict name), the Engine's plan, which
    the propagation executor reads."""
    from .propagation import DistSpec

    if not _mesh.has_mesh() or mesh_axes.get("mp", 1) <= 1:
        return 0
    count = 0
    for key, _, dims in placement_decisions(model, mesh_axes["mp"]):
        if specs is not None:
            specs[key] = DistSpec(tuple(dims))
        count += 1
    return count
