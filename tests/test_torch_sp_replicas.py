"""dp replicas and ZeRO over a layered GPT whose sp positions hold copies
on devices of their own, and a serving mesh over a placed model under
ZeRO: the port (``distributed/parallel.py``, ``distributed/sharding/``,
``distributed/shards.py``, the layered GPT's ``sequence_copies`` and
``leave_training_mesh``) held against the JAX package on the CPU, the
JAX side on the conftest's 8 host devices.  Mesh positions are named
``cpu:i``, so that the sp positions stand for distinct cards: each
replica's sp position 1 holds a copy of its body.  ``gpt_tiny`` with 2
layers, fp32, dropout 0; inputs are numpy draws from fixed seeds.

- The layered GPT with ``sequence_parallel`` carries the JAX model's
  weights (``load_jax_state``) under ``DataParallel`` at ``{"dp": 2,
  "sp": 2}`` and at ``{"dp": 2, "sp": 2, "mp": 2}`` with
  ``use_tensor_parallel`` and ``recompute_interval=1``, under
  ``group_sharded_parallel`` at ``{"sharding": 2, "sp": 2}`` at ``os``,
  ``os_g`` and ``p_g_os``, and over the dp fallback at ``{"dp": 2, "sp":
  2}`` at ``p_g_os``.  Each is held to the JAX layered GPT on its mesh:
  ``DataParallel`` with ``group_sharded_parallel`` at ``p_g_os`` over its
  dp axis on ``{"dp": 2, "sp": 2}``, ``DataParallel`` on the mp mesh (its
  eager recompute leaves no gradients, so the JAX side runs without it;
  the math is the same), ``group_sharded_parallel`` at ``p_g_os`` on the
  sharding mesh (the JAX levels only lay out the same program).  Step
  1's loss within 1e-6 relative, every gradient within 1e-5 of that
  parameter's largest (a sum counted twice fails by a factor of 2), and
  the weights after 2 AdamW steps by the rule of
  ``test_fleet_gpt_dp2_pp2_mp2_matches_jax``.
- Against the port itself: each run equals the same mesh named ``["cpu"]
  * n``, which has no sp copies -- step 1's loss and every gradient bit
  for bit, except the tied word table's, whose three uses (each part's
  lookup and the head) meet in another order (within 1e-6 of its
  largest), and the weights after 2 steps within 1e-6 of each tensor's
  largest; every copy, dp or sp, holds its source's gradient (where
  copies keep gradients: without ZeRO and at ``os``) and equals its
  source after each step; ``weight_bytes_by_position`` has one entry for
  each (replica, sp position, stage, shard) and no two copies share one;
  at ``p_g_os`` no copy keeps storage after the forward or after the
  backward.
- What the reference refuses on these meshes still raises its error: a
  one-token decode step of a model whose sp axis is > 1.
- A serving mesh over a placed model under ZeRO, after one training
  step: the stacked GPT at ``{"sharding": 2, "pp": 2}`` and the layered
  GPT at ``{"sharding": 2, "mp": 2}``, each at ``os`` and ``p_g_os``,
  through ``ServingEngine(mesh=)`` and ``ShardedServingEngine`` at (dp,
  mp) = (1, 2): the JAX engine's greedy tokens over the same weights
  (the port's ``state_dict()`` loaded into the JAX model); no part, copy
  or slice keeps storage; the plan is gone; training afterwards raises
  naming ROADMAP.md queue 1, item 9.  ``clone_model`` of such a model
  gives an unplaced clone of its weights and leaves it training.
"""
import hashlib

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.distributed import mesh as JM
from paddle_tpu.distributed import parallel as jparallel
from paddle_tpu.distributed.sharding import (
    group_sharded_parallel as jax_group_sharded,
)
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import GPTStackedForPretraining as JaxStacked
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine

from paddle_tpu_torch.distributed import DataParallel
from paddle_tpu_torch.distributed import mesh as M
from paddle_tpu_torch.distributed.serving_mesh import clone_model
from paddle_tpu_torch.distributed.sharding import (
    gathered_grads, group_sharded_parallel,
)
from paddle_tpu_torch.distributed.shards import (
    position_of, replica_of, weight_bytes_by_position,
)
from paddle_tpu_torch.models import (
    GPTForPretraining, GPTPretrainingCriterion, GPTStackedForPretraining,
    gpt_tiny,
)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import ServingEngine, ShardedServingEngine

torch.set_num_threads(2)

NO_DROP = dict(hidden_dropout=0.0, attention_dropout=0.0)
LAYERS, LR, STEPS = 2, 1e-3, 2
BATCH = (4, 16)                       # 2 rows a replica, 8 tokens a part
WORD = "gpt.embeddings.word_embeddings.weight"
# test_fleet_gpt_dp2_pp2_mp2_matches_jax's rule for the weights after the
# steps: an element whose gradient parts by more than ZERO_REL is zero to
# rounding and held to two steps of the rate, at most ZERO_SHARE of them
ZERO_REL, ZERO_SHARE = 1e-3, 1e-2

# name: (mesh axes, under DataParallel, ZeRO level, use_tensor_parallel
# with recompute_interval 1, the JAX run it is held to)
CASES = {
    "dp2_sp2": ({"dp": 2, "sp": 2}, True, None, False, "dp"),
    "dp2_sp2_mp2_rc1": ({"dp": 2, "sp": 2, "mp": 2}, True, None, True,
                        "dp_mp"),
    "sharding2_sp2_os": ({"sharding": 2, "sp": 2}, False, "os", False,
                         "sharding"),
    "sharding2_sp2_os_g": ({"sharding": 2, "sp": 2}, False, "os_g", False,
                           "sharding"),
    "sharding2_sp2_p_g_os": ({"sharding": 2, "sp": 2}, False, "p_g_os",
                             False, "sharding"),
    "dp2_sp2_p_g_os": ({"dp": 2, "sp": 2}, False, "p_g_os", False, "dp"),
}
# the JAX runs: (mesh axes, under DataParallel, ZeRO level, tp)
JAX_RUNS = {
    "dp": ({"dp": 2, "sp": 2}, True, "p_g_os", False),
    "dp_mp": ({"dp": 2, "sp": 2, "mp": 2}, True, None, True),
    "sharding": ({"sharding": 2, "sp": 2}, False, "p_g_os", False),
}

_CACHE: dict = {}


def _np(t):
    return np.asarray(t.numpy(), np.float32)


def _ids():
    return np.random.RandomState(1).randint(0, 1024, BATCH)


def _state():
    """The layered model's weights by the JAX model's keys (the port's
    unplaced model's draws: its state-dict keys are the JAX model's),
    biases and gains moved off 0/1."""
    if "state" not in _CACHE:
        m = GPTForPretraining(gpt_tiny(num_layers=LAYERS, **NO_DROP),
                              device="cpu", seed=0)
        rng = np.random.RandomState(0)
        out = {}
        for k, v in m.state_dict().items():
            a = _np(v)
            if k.endswith(("bias", "ln1.weight", "ln2.weight",
                           "final_ln.weight")):
                a = a + 0.1 * rng.randn(*a.shape).astype(np.float32)
            out[k] = a
        _CACHE["state"] = out
    return _CACHE["state"]


def _jax_run(key):
    """One JAX run of :data:`JAX_RUNS`, under ``jit.to_static``: each
    step's loss, step 1's gradients by name and the weights after
    STEPS AdamW steps on one batch."""
    if ("jax", key) in _CACHE:
        return _CACHE["jax", key]
    axes, wrap, level, tp = JAX_RUNS[key]
    saved = JM._global_mesh
    JM.set_mesh(JM.build_mesh({"dp": 1, **axes}))
    try:
        cfg = jax_gpt_tiny(num_layers=LAYERS, **NO_DROP,
                           sequence_parallel=True, use_tensor_parallel=tp)
        m = JaxGPT(cfg)
        m.set_state_dict(_state())
        crit = JaxCriterion(cfg)
        model = jparallel.DataParallel(m) if wrap else m
        opt = pt.optimizer.AdamW(learning_rate=LR,
                                 parameters=m.parameters())
        if level is not None:
            model, opt, _ = jax_group_sharded(model, opt, level)

        @pt.jit.to_static
        def step(x):
            loss = crit(model(x), x)
            loss.backward()
            grads = [p.grad for p in m.parameters()]
            opt.step()
            opt.clear_grad()
            return loss, grads

        ids = pt.to_tensor(_ids(), dtype="int64")
        losses, grads = [], None
        for _ in range(STEPS):
            loss, g = step(ids)
            losses.append(float(loss.numpy()))
            if grads is None:
                grads = {n: _np(x) for (n, _), x in zip(m.named_parameters(),
                                                        g)}
        after = {k: _np(v) for k, v in m.state_dict().items()}
    finally:
        JM.set_mesh(saved)
    _CACHE["jax", key] = out = dict(losses=losses, grads=grads, after=after)
    return out


def _copies(model):
    return [p for p in model.parameters() if replica_of(p) is not None]


def _port_run(case, own):
    """The port on ``CASES[case]``, its positions ``cpu:i`` (``own``: sp
    copies) or all ``"cpu"`` (no copies), carrying :func:`_state`: each
    step's loss, step 1's gathered gradients, the weights after STEPS
    AdamW steps, and what the copies held on the way."""
    if ("port", case, own) in _CACHE:
        return _CACHE["port", case, own]
    axes, wrap, level, tp, _ = CASES[case]
    n = int(np.prod(list(axes.values())))
    M.set_mesh(M.build_mesh(axes, [f"cpu:{i}" for i in range(n)] if own
                            else ["cpu"] * n))
    try:
        cfg = gpt_tiny(num_layers=LAYERS, **NO_DROP, sequence_parallel=True,
                       use_tensor_parallel=tp,
                       recompute_interval=1 if tp else 0)
        m = GPTForPretraining(cfg, **({} if tp else {"device": "cpu"}))
        m.load_jax_state(_state())
        crit = GPTPretrainingCriterion(cfg)
        model = DataParallel(m) if wrap else m
        opt = AdamW(LR, parameters=model.parameters())
        if level is not None:
            model, opt, _ = group_sharded_parallel(model, opt, level)
        model.train()
        ids = torch.from_numpy(_ids())
        copies = _copies(model)
        out = dict(losses=[], copy_grads=[], copies_equal=[], kept=[],
                   sp_copies=len(m.gpt.sequence_copies),
                   n_copies=len(copies),
                   body=len(list(m.parameters())) - len(_copies(m)))
        for i in range(STEPS):
            loss = crit(model(ids), ids)
            kept_fwd = [p for p in copies + [replica_of(p) for p in copies]
                        if p.untyped_storage().nbytes()]
            loss.backward()
            kept_bwd = [p for p in copies if p.untyped_storage().nbytes()]
            out["kept"].append((len(kept_fwd), len(kept_bwd)))
            out["losses"].append(loss.item())
            if i == 0:
                out["grads"] = {k: g.numpy().copy() for k, g in
                                gathered_grads(m).items()}
            out["copy_grads"].append(
                [None if p.grad is None else
                 torch.equal(p.grad, replica_of(p).grad) for p in copies])
            opt.step()
            opt.clear_grad()
            out["copies_equal"].append(all(
                torch.equal(p, replica_of(p)) for p in copies
                if p.untyped_storage().nbytes()))
        plan = getattr(m, "_zero_plan", None)
        if plan is not None:
            # every copy filled from its group's slices: each must hold
            # replica 0's values
            for rec in plan.pieces:
                for k in range(len(rec.copies)):
                    rec.acquire(k)
            out["gathered_equal"] = all(
                torch.equal(c, rec.copies[0]) for rec in plan.pieces
                for c in rec.copies)
            for rec in plan.pieces:
                for k in range(len(rec.copies)):
                    rec.release(k)
        out["after"] = {k: v.numpy().copy()
                        for k, v in model.state_dict().items()}
        out["positions"] = sorted({position_of(p)
                                   for p in model.parameters()})
        out["bytes"] = weight_bytes_by_position(model)
    finally:
        M.set_mesh(None)
    _CACHE["port", case, own] = out
    return out


def _grads_close(got, want, rel=1e-5):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=rel * np.abs(w).max(), err_msg=k)


def _weights_rule(got, want, grads_got, grads_want):
    """``test_fleet_gpt_dp2_pp2_mp2_matches_jax``'s rule for the weights
    after the steps."""
    assert set(got) == set(want)
    n_zero = n_all = 0
    for k, w in want.items():
        g, gw = grads_got[k], grads_want[k]
        zero = np.abs(g - gw) > ZERO_REL * np.abs(gw)
        n_zero += int(zero.sum())
        n_all += zero.size
        err = np.abs(got[k] - w)
        tol = 1e-5 * np.abs(w) + 1e-5 * np.abs(w).max()
        assert (err <= tol)[~zero].all(), (k, float((err - tol).max()))
        assert (err <= 2 * LR * STEPS)[zero].all(), k
    assert n_zero <= ZERO_SHARE * n_all, (n_zero, n_all)


@pytest.fixture
def clean_mesh():
    yield
    M.set_mesh(None)


# ---------------------------------------------------------------------------
# dp replicas and ZeRO over sp copies, against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax(case):
    want = _jax_run(CASES[case][4])
    got = _port_run(case, True)
    assert got["sp_copies"] == 1
    assert abs(got["losses"][0] - want["losses"][0]) \
        <= 1e-6 * abs(want["losses"][0])
    _grads_close(got["grads"], want["grads"])
    _weights_rule(got["after"], want["after"], got["grads"], want["grads"])


# ---------------------------------------------------------------------------
# against the port's own mesh without copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_equals_the_mesh_without_copies(case):
    own, shared = _port_run(case, True), _port_run(case, False)
    assert own["sp_copies"] == 1 and shared["sp_copies"] == 0
    assert own["losses"][0] == shared["losses"][0]
    for k, g in shared["grads"].items():
        if k == WORD:
            np.testing.assert_allclose(own["grads"][k], g, rtol=0,
                                       atol=1e-6 * np.abs(g).max())
        else:
            np.testing.assert_array_equal(own["grads"][k], g, err_msg=k)
    assert abs(own["losses"][1] - shared["losses"][1]) \
        <= 1e-6 * abs(shared["losses"][1])
    for k, w in shared["after"].items():
        np.testing.assert_allclose(own["after"][k], w, rtol=0,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_copy_holds_its_source(case):
    """Every copy holds its source's gradient where copies keep gradients
    (none at os_g and p_g_os, whose gradients land in the slices), and
    equals its source after each step; under ZeRO every copy gathered
    from its group's slices holds replica 0's values."""
    _, wrap, level, _, _ = CASES[case]
    run = _port_run(case, True)
    replicas = 2 if wrap else 1
    # the body's copies: the other replicas' bodies and every sp copy
    assert run["n_copies"] == (2 * replicas - 1) * run["body"]
    for flags in run["copy_grads"]:
        if level in ("os_g", "p_g_os"):
            assert flags == [None] * len(flags)
        else:
            assert flags and all(flags)
    assert run["copies_equal"] == [True] * STEPS
    if level is not None:
        assert run["gathered_equal"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_positions_do_not_collide(case):
    """One entry for each (replica, sp position) a copy lies at, the sp
    coordinate fourth; every copy at its own position (mp shards as the
    third coordinate)."""
    axes, wrap, level, tp, _ = CASES[case]
    run = _port_run(case, True)
    replicas, mp = (2 if wrap else 1), axes.get("mp", 1)
    want = {(r, 0, i) + ((s,) if s else ()) for r in range(replicas)
            for s in range(2) for i in range(mp)}
    held = set(run["bytes"])
    assert want <= held
    # ZeRO's bare model: its slice 1 at sharding (or dp) coordinate 1
    assert held - want == ({(1, 0, 0)} if not wrap else set())
    assert set(run["positions"]) == want
    if level != "p_g_os":
        # whole copies: each (replica, sp) position holds the same bytes
        per = {k: v for k, v in run["bytes"].items() if k in want}
        assert len(set(per.values())) == mp


@pytest.mark.parametrize("case", ["sharding2_sp2_p_g_os", "dp2_sp2_p_g_os"])
def test_p_g_os_keeps_no_copy(case):
    """At p_g_os no copy (an sp copy or the replica's own) keeps storage
    after the forward or after the backward."""
    run = _port_run(case, True)
    assert run["kept"] == [(0, 0)] * STEPS


def test_fault12_p_g_os_over_sequence_parts(clean_mesh):
    """Fault 12 (ROADMAP.md queue 3): ZeRO at p_g_os over a layered GPT
    with ``sequence_parallel``, its sp positions on one device (no
    copies), raised a ``TypeError`` in ``group_sharded_parallel``: ZeRO
    took any attribute named ``_tied`` for a module's tied modules, and
    the model's copies-tied flag (a bool) had that name.  ZeRO now reads
    only its own marker (``_zero_tied_modules``).  The run trains, bit for
    bit the run without ZeRO: loss, gradients and the weights after a
    step."""
    ids = torch.from_numpy(_ids())
    runs = []
    for level in (None, "p_g_os"):
        M.set_mesh(M.build_mesh({"sharding": 2, "sp": 2}, ["cpu"] * 4))
        cfg = gpt_tiny(num_layers=LAYERS, **NO_DROP, sequence_parallel=True)
        m = GPTForPretraining(cfg, device="cpu")
        m.load_jax_state(_state())
        opt = AdamW(LR, parameters=m.parameters())
        if level is not None:
            group_sharded_parallel(m, opt, level)
        loss = GPTPretrainingCriterion(cfg)(m(ids), ids)
        loss.backward()
        grads = gathered_grads(m)
        opt.step()
        opt.clear_grad()
        runs.append((loss.item(), grads, m.state_dict()))
        M.set_mesh(None)
    (l0, g0, w0), (l1, g1, w1) = runs
    assert l0 == l1
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(w0[k], w1[k]) for k in w0)


# ---------------------------------------------------------------------------
# what the reference refuses still raises
# ---------------------------------------------------------------------------

def test_decode_of_sp_replicas_raises_the_references_error(clean_mesh):
    """A one-token decode step does not split over sp = 2: ``generate()``
    of a replica under ``DataParallel`` raises the reference's
    ``ValueError`` (``models/gpt.py`` ``_refuse_sequence_parts``), as does
    the JAX model on the same mesh."""
    M.set_mesh(M.build_mesh({"dp": 2, "sp": 2},
                            [f"cpu:{i}" for i in range(4)]))
    m = GPTForPretraining(gpt_tiny(num_layers=LAYERS, **NO_DROP,
                                   sequence_parallel=True), device="cpu")
    dp = DataParallel(m)
    assert dp.num_replicas == 2 and len(m.gpt.sequence_copies) == 1
    prompt = np.array([[1, 2], [3, 4]])
    with pytest.raises(ValueError, match="does not split over sp=2"):
        m.generate(prompt, 2, max_seq_len=16)
    saved = JM._global_mesh
    JM.set_mesh(JM.build_mesh({"dp": 2, "sp": 2}))
    try:
        jm = JaxGPT(jax_gpt_tiny(num_layers=LAYERS, **NO_DROP,
                                 sequence_parallel=True))
        jm.eval()
        # its decode step's [2, 1, H] hidden states over ("dp", "sp")
        with pytest.raises(ValueError, match=r"dimension 1 should be "
                           r"divisible by 2, but it is equal to 1"):
            jm.generate(pt.to_tensor(prompt, dtype="int64"), 2,
                        max_seq_len=16)
    finally:
        JM.set_mesh(saved)


# ---------------------------------------------------------------------------
# a serving mesh over a placed model under ZeRO
# ---------------------------------------------------------------------------

SERVE_LAYERS = {"stacked": 4, "layered": 2}
SERVE_AXES = {"stacked": {"sharding": 2, "pp": 2},
              "layered": {"sharding": 2, "mp": 2}}
ENG = dict(num_slots=3, page_size=16, max_context=64, cache_dtype="float32")
SERVE_NEW = 5


def _serve_prompts():
    rng = np.random.RandomState(2)
    return [rng.randint(0, 1024, (s,)) for s in (5, 17, 9)]


def _trained_under_zero(kind, level):
    """The port's placed model of ``kind`` under ZeRO at ``level``, after
    one AdamW step; the global mesh stays set."""
    axes = SERVE_AXES[kind]
    M.set_mesh(M.build_mesh(axes, ["cpu"] * int(np.prod(list(
        axes.values())))))
    cfg = gpt_tiny(num_layers=SERVE_LAYERS[kind], **NO_DROP,
                   use_tensor_parallel=kind == "layered")
    cls = GPTStackedForPretraining if kind == "stacked" else \
        GPTForPretraining
    m = cls(cfg, seed=7)
    assert m._train_mesh is not None
    opt = AdamW(LR, parameters=m.parameters())
    group_sharded_parallel(m, opt, level)
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, 1024, (4, 16)))
    if kind == "stacked":
        loss = m(ids, labels=ids)
    else:
        loss = GPTPretrainingCriterion(cfg)(m(ids), ids)
    loss.backward()
    opt.step()
    opt.clear_grad()
    m.eval()
    return m, opt


def _jax_tokens(kind, state):
    """The JAX engine's greedy tokens over ``state`` (the port's
    ``state_dict()``), run once for each distinct state."""
    digest = hashlib.sha1(b"".join(
        state[k].tobytes() for k in sorted(state))).hexdigest()
    if ("tokens", digest) not in _CACHE:
        cls = JaxStacked if kind == "stacked" else JaxGPT
        jm = cls(jax_gpt_tiny(num_layers=SERVE_LAYERS[kind], **NO_DROP))
        jm.set_state_dict(state)
        jm.eval()
        _CACHE["tokens", digest] = JaxEngine(jm, **ENG).generate_batch(
            _serve_prompts(), SERVE_NEW)
    return _CACHE["tokens", digest]


@pytest.mark.parametrize("engine", ["mesh", "sharded"])
@pytest.mark.parametrize("level", ["os", "p_g_os"])
@pytest.mark.parametrize("kind", ["stacked", "layered"])
def test_serving_mesh_over_a_model_under_zero(kind, level, engine,
                                              clean_mesh):
    m, opt = _trained_under_zero(kind, level)
    plan = m._zero_plan
    state = {k: v.numpy().copy() for k, v in m.state_dict().items()}
    held = [p for g in opt.param_groups for p in g["params"]]
    parts = list(m.parameters())
    assert {id(sl.tensor) for sl in plan.slices} == {id(t) for t in held}
    if engine == "mesh":
        got = ServingEngine(m, mesh=("cpu",), **ENG).generate_batch(
            _serve_prompts(), SERVE_NEW)
    else:
        eng = ShardedServingEngine(m, dp=1, mp=2, devices=["cpu"] * 2,
                                   **ENG)
        reqs = [eng.submit(p, SERVE_NEW) for p in _serve_prompts()]
        eng.run_until_idle(max_steps=2000)
        got = [r.output_ids() for r in reqs]
        assert all(r.finished for r in reqs)
        eng.close()
    for g, w in zip(got, _jax_tokens(kind, state)):
        np.testing.assert_array_equal(g, w)
    # every part, copy and slice freed; the plan gone
    assert m._train_mesh is None and getattr(m, "_zero_plan", None) is None
    assert all(t.untyped_storage().nbytes() == 0
               for t in held + parts + [c for rec in plan.pieces
                                        for c in rec.copies])
    assert plan.hooks == []
    assert set(m.state_dict()) == set(state)
    # training afterwards raises: its optimizer holds the freed slices
    m.train()
    with pytest.raises(NotImplementedError, match=r"queue 1, item 9"):
        m(torch.zeros((2, 8), dtype=torch.long))


@pytest.mark.parametrize("level", ["os", "p_g_os"])
def test_clone_of_a_model_under_zero(level, clean_mesh):
    """``clone_model`` of a placed model under ZeRO (no factory) gives an
    unplaced model with replica 0's weights, bit for bit, and leaves the
    source on its training mesh under its plan: it trains on."""
    m, opt = _trained_under_zero("stacked", level)
    state = {k: v.clone() for k, v in m.state_dict().items()}
    clone = clone_model(m)
    assert clone._train_mesh is None and m._train_mesh is not None
    assert getattr(clone, "_zero_plan", None) is None
    assert m._zero_plan is not None
    got = clone.state_dict()
    assert set(got) == set(state)
    assert all(torch.equal(got[k], v) for k, v in state.items())
    m.train()
    ids = torch.from_numpy(np.random.RandomState(4).randint(0, 1024, (4, 16)))
    m(ids, labels=ids).backward()
    opt.step()
    opt.clear_grad()
