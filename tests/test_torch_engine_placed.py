"""The port's auto_parallel ``Engine`` with its planned parameters placed
(``paddle_tpu_torch/distributed/auto_parallel/placed.py``, ``engine.py``)
held against the JAX package's ``Engine`` on the CPU.

The JAX side runs on the 8-device CPU mesh of ``tests/conftest.py``;
the port lays its plans over ``["cpu"] * n``.  Weights go from the JAX
``gpt_tiny`` (fp32, dropout 0) into the port's layered GPT by
``load_jax_state``.  The plans are ``tests/test_torch_engine.py``'s:
``compute_bound_4`` (dp 2 x mp 2), ``forced_hbm_8`` (dp 2 x pp 4) and
``mp_only_4`` (mp 4).

- ``plan`` + ``fit`` under ZeRO stages 1, 2 and 3 over dp 2 x mp 2: the
  JAX Engine's losses within ``LOSS_REL`` and its weights after ``fit``
  within ``WEIGHT_REL``/``WEIGHT_ATOL``; the port's levels and
  its placement without ZeRO bit for bit;
- after ``plan()`` and between steps no tensor the plan cuts holds a
  whole copy anywhere, every part holds its block, and the bytes a
  position holds equal the count by hand at each level; ``p_g_os``
  gathers a block around its graph reads, never more than a quarter of
  the copies at once;
- the optimizer object the caller built steps the blocks, its decay
  mask and ``lr_ratio`` kept, against the JAX ``AdamW`` with the same;
- ``evaluate`` and ``predict`` run through the executor under a plan;
- ``save``/``load`` and ``save_checkpoint``/``load_checkpoint`` under a
  plan write whole tensors and round-trip bit for bit;
- ``forced_hbm_8``: the step-1 gradients are the unplanned Engine's (the
  pp copies' are not summed), and every pp copy stays equal;
- a second ``plan()`` places the model again from its whole values, bit
  for bit with the run that was never taken apart; ``gradient_merge``
  composes with ZeRO; ZeRO on a mesh without dp does nothing.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.distributed import mesh as JM
from paddle_tpu.distributed.auto_parallel import Strategy as JStrategy
from paddle_tpu.distributed.auto_parallel import planner as JP

from paddle_tpu_torch.distributed import mesh as M
from paddle_tpu_torch.distributed.auto_parallel import ClusterSpec, Strategy
from paddle_tpu_torch.distributed.auto_parallel.propagation import _ax
from paddle_tpu_torch.distributed.sharding import gathered_grads
from paddle_tpu_torch.distributed.shards import (
    ZeroPiece, replica_of, shard_info,
)
from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny
from paddle_tpu_torch.optimizer import AdamW

from test_torch_engine import (  # noqa: F401  (the fixtures)
    LOSS_REL, NO_DROP, PLANS, _batches, _close, _jax_engine, _port_engine,
    clean_mesh, jax_state,
)

torch.set_num_threads(2)

# the weights after 4 AdamW steps at lr 1e-3, elementwise: 1e-5 relative
# and 2e-5 absolute (2 % of a step).  AdamW's unit step turns a gradient
# that is rounding noise (the K bias's: softmax ignores it) into a move
# of up to lr either way: the unplanned port lands 9.97e-6 from JAX there
WEIGHT_REL, WEIGHT_ATOL = 1e-5, 2e-5
LEVELS = {1: "os", 2: "os_g", 3: "p_g_os"}


def _cluster(case):
    return PLANS[case][0]()


def _zero(stage, **more):
    cfg = dict(more)
    if stage:
        cfg["sharding"] = {"enable": True, "stage": stage}
    return cfg


def _jax_fit(state, case, cfg, data):
    je, jm = _jax_engine(state, JStrategy(cfg))
    je.plan(cluster=JP.ClusterSpec(**_cluster(case)))
    hist = je.fit(data, verbose=0)["loss"]
    JM._global_mesh = None
    return hist, {k: np.asarray(v.numpy()) for k, v in
                  jm.state_dict().items()}


def _planned(state, case, cfg=None, optimizer=None):
    e, m = _port_engine(state, Strategy(cfg or {}),
                        devices=["cpu"] * _cluster(case)["n_devices"])
    if optimizer is not None:
        e._optimizer = optimizer(m)
    e.plan(cluster=ClusterSpec(**_cluster(case)))
    return e, m


def _weights_close(got, want):
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w,
                                   rtol=WEIGHT_REL, atol=WEIGHT_ATOL,
                                   err_msg=k)


def _same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# plan + fit under ZeRO
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_under_a_plan_equals_the_jax_engines(jax_state, stage):
    data = _batches()
    jhist, jw = _jax_fit(jax_state, "compute_bound_4", _zero(stage), data)
    e, m = _planned(jax_state, "compute_bound_4", _zero(stage))
    hist = e.fit(data, verbose=0)["loss"]
    assert e.placement._zero_plan.level == LEVELS[stage]
    _close(hist, jhist, LOSS_REL)
    _weights_close(m.state_dict(), jw)
    M.set_mesh(None)
    plain, pm = _planned(jax_state, "compute_bound_4")
    assert plain.fit(data, verbose=0)["loss"] == hist
    _same_state(m.state_dict(), pm.state_dict())
    _same_state(e._optimizer.state_dict(), plain._optimizer.state_dict())


# ---------------------------------------------------------------------------
# the blocks and their bytes
# ---------------------------------------------------------------------------

def _by_hand(e, level, dp=2):
    """{position: {"params", "grads", "state"}} at rest: every position
    holds each tensor's block (fp32; two fp32 moments); ``os`` and
    ``os_g`` keep 1/dp of the moments, ``p_g_os`` also of the block."""
    mesh = e.placement.mesh
    params = state = 0
    for k, t in e._model.named_parameters():
        spec = e._plan_specs.get(k)
        n = t.numel()
        for d in (spec.dims if spec is not None else ()):
            for a in _ax(d):
                n //= mesh.shape[a]
        params += 4 * n
        state += 8 * n
    if level is not None:
        state //= dp
    if level == "p_g_os":
        params //= dp
    return {pos: {"params": params, "grads": 0, "state": state}
            for pos in ((d, 0, m) for d in range(2) for m in range(2))}


@pytest.mark.parametrize("level", [None, "os", "os_g", "p_g_os"])
def test_the_blocks_hold_no_whole_copy_and_count_by_hand(jax_state, level):
    stage = {v: k for k, v in LEVELS.items()}.get(level, 0)
    e, m = _planned(jax_state, "compute_bound_4", _zero(stage))
    whole = {k: tuple(p.shape) for k, p in m.named_parameters()}
    assert all(p.untyped_storage().nbytes() == 0 for p in m.parameters())
    for k, entry in e.placement.entries.items():
        spec = e._plan_specs.get(k)
        for part in entry.blocks:
            if spec is not None:
                assert tuple(part.shape) != whole[k], k
            assert shard_info(part) is not None
    held = []
    real_acquire, real_release = ZeroPiece.acquire, ZeroPiece.release

    def acquire(rec, r, backward=False):
        real_acquire(rec, r, backward)
        held.append(sum(c.untyped_storage().nbytes() > 0
                        for p in e.placement._zero_plan.pieces
                        for c in p.copies))

    ZeroPiece.acquire = acquire
    try:
        e.fit(_batches(2), verbose=0)
    finally:
        ZeroPiece.acquire, ZeroPiece.release = real_acquire, real_release
    assert e.placement.whole_copies() == []
    assert all(p.untyped_storage().nbytes() == 0 for p in m.parameters())
    assert e.placement.state_bytes(e._optimizer) == _by_hand(e, level)
    if level == "p_g_os":
        copies = sum(len(p.copies) for p in e.placement._zero_plan.pieces)
        assert held and max(held) < copies / 4, (max(held), copies)


# ---------------------------------------------------------------------------
# the caller's optimizer
# ---------------------------------------------------------------------------

def test_the_callers_optimizer_steps_the_blocks(jax_state):
    """Decay for matrices and tables only, the MLP's rate halved, in the
    JAX ``AdamW`` (names set on its parameters) and the port's (names
    from ``named_parameters()``; ``lr_ratio`` sees the whole parameter)."""
    def decay(name):
        return name.endswith("weight") and ".ln" not in name

    def ratio_of(name):
        return 0.5 if ".mlp." in name else 1.0

    je, jm = _jax_engine(jax_state)
    for k, p in jm.named_parameters():
        p.name = k
    je._optimizer = pt.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters(),
        apply_decay_param_fun=decay, weight_decay=0.1,
        lr_ratio=lambda p: ratio_of(p.name))
    je.plan(cluster=JP.ClusterSpec(**_cluster("compute_bound_4")))
    jhist = je.fit(_batches(), verbose=0)["loss"]
    jw = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    JM._global_mesh = None
    made = {}

    def build(m):
        names = {id(p): k for k, p in m.named_parameters()}
        made["opt"] = AdamW(
            learning_rate=1e-3, parameters=m.named_parameters(),
            apply_decay_param_fun=decay, weight_decay=0.1,
            lr_ratio=lambda p: ratio_of(names[id(p)]))
        return made["opt"]

    e, m = _planned(jax_state, "compute_bound_4", optimizer=build)
    opt = made["opt"]
    assert e._optimizer is opt
    parts = opt.param_groups[0]["params"]
    assert len(parts) == 4 * len(list(m.parameters()))
    assert all(shard_info(p) is not None for p in parts)
    assert {opt._names[id(p)] for p in parts} == {
        k for k, _ in m.named_parameters()}
    hist = e.fit(_batches(), verbose=0)["loss"]
    _close(hist, jhist, LOSS_REL)
    _weights_close(m.state_dict(), jw)


# ---------------------------------------------------------------------------
# evaluate and predict
# ---------------------------------------------------------------------------

def test_evaluate_and_predict_under_a_plan_equal_the_jax_engines(jax_state):
    data = _batches(2, seed=3)
    je, _ = _jax_engine(jax_state)
    je.plan(cluster=JP.ClusterSpec(**_cluster("compute_bound_4")))
    jev = je.evaluate(data)["eval_loss"]
    jout = je.predict([d[0] for d in data])
    JM._global_mesh = None
    e, _ = _planned(jax_state, "compute_bound_4")
    _close(e.evaluate(data)["eval_loss"], jev, LOSS_REL)
    out = e.predict([d[0] for d in data])
    assert set(e._execs) == {"eval", "predict"}
    assert len(out) == len(jout) == 2
    for a, b in zip(out, jout):
        assert not a.requires_grad
        b = b.numpy()
        np.testing.assert_allclose(a.numpy(), b, rtol=LOSS_REL,
                                   atol=LOSS_REL * np.abs(b).max())


# ---------------------------------------------------------------------------
# whole tensors at the edges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", [0, 3])
def test_save_load_and_checkpoints_under_a_plan_round_trip(jax_state,
                                                           tmp_path, stage):
    e, m = _planned(jax_state, "compute_bound_4", _zero(stage))
    e.fit(_batches(2), verbose=0)
    path = str(tmp_path / "engine")
    e.save(path)
    saved = torch.load(path + ".pdparams", weights_only=False)
    plain = GPTForPretraining(gpt_tiny(**NO_DROP), device="cpu")
    assert {k: tuple(v.shape) for k, v in saved.items()} == {
        k: tuple(v.shape) for k, v in plain.state_dict().items()}
    e.save_checkpoint(str(tmp_path / "ckpt"), step=2, blocking=True)
    want_w, want_o = m.state_dict(), e._optimizer.state_dict()
    want_next = e.fit(_batches(1, seed=5), verbose=0)["loss"][-1]
    for how in ("load", "checkpoint"):
        M.set_mesh(None)
        f, fm = _planned(jax_state, "compute_bound_4", _zero(stage))
        if stage:
            f.fit(_batches(1, seed=9), verbose=0)    # ZeRO applied first
        if how == "load":
            f.load(path)
        else:
            assert f.load_checkpoint(str(tmp_path / "ckpt")) == {
                "epoch": 0, "step": 2}
        _same_state(fm.state_dict(), want_w)
        _same_state(f._optimizer.state_dict(), want_o)
        assert f.fit(_batches(1, seed=5), verbose=0)["loss"][-1] == want_next


# ---------------------------------------------------------------------------
# pp copies, a second plan, gradient_merge, a mesh without dp
# ---------------------------------------------------------------------------

def test_forced_hbm_8_sums_no_pp_copy(jax_state):
    e, m = _planned(jax_state, "forced_hbm_8")
    grads = {}
    step = e._optimizer.step

    def first(*a, **k):
        if not grads:
            grads.update(gathered_grads(e.placement))
        return step(*a, **k)
    e._optimizer.step = first
    e.fit(_batches(2), verbose=0)
    M.set_mesh(None)
    plain, pm = _port_engine(jax_state)
    loss = plain._loss_value(pm(torch.from_numpy(_batches(1)[0][0])),
                             [torch.from_numpy(_batches(1)[0][1])])
    loss.backward()
    for k, p in pm.named_parameters():
        err = (grads[k] - p.grad).norm() / p.grad.norm()
        assert err <= 1e-5, (k, float(err))
    for entry in e.placement.entries.values():
        parts = list(entry.blocks)
        for t in parts:
            src = replica_of(t)
            if src is not None:
                assert torch.equal(t, src)


def test_a_second_plan_places_again_from_the_whole_values(jax_state):
    e, m = _planned(jax_state, "compute_bound_4", _zero(3))
    data = _batches(4)
    e.fit(data[:2], verbose=0)
    before = m.state_dict()
    e.plan(cluster=ClusterSpec(**_cluster("compute_bound_4")))
    _same_state(m.state_dict(), before)
    assert e.placement.whole_copies() == []
    hist = e.fit(data[2:], verbose=0)["loss"]
    M.set_mesh(None)
    once, om = _planned(jax_state, "compute_bound_4", _zero(3))
    assert once.fit(data, verbose=0)["loss"] == hist
    _same_state(m.state_dict(), om.state_dict())
    _same_state(e._optimizer.state_dict(), once._optimizer.state_dict())


def test_gradient_merge_composes_with_zero_under_a_plan(jax_state):
    cfg = _zero(2, gradient_merge={"enable": True, "k_steps": 2})
    data = [(b[0], b[0]) for s in range(4) for b in _batches(1, seed=s)]
    jhist, jw = _jax_fit(jax_state, "compute_bound_4", cfg, data)
    e, m = _planned(jax_state, "compute_bound_4", cfg)
    _close(e.fit(data, verbose=0)["loss"], jhist, LOSS_REL)
    _weights_close(m.state_dict(), jw)


def test_zero_on_a_mesh_without_dp_does_nothing(jax_state):
    data = _batches()
    jhist, _ = _jax_fit(jax_state, "mp_only_4", _zero(2), data)
    e, m = _planned(jax_state, "mp_only_4", _zero(2))
    _close(e.fit(data, verbose=0)["loss"], jhist, LOSS_REL)
    assert getattr(e.placement, "_zero_plan", None) is None
