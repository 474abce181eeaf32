"""The port's auto_parallel ``Strategy``, planner and ``Engine`` held
against the JAX package's on the CPU
(``paddle_tpu_torch.distributed.auto_parallel`` ``strategy.py``,
``planner.py``, ``engine.py`` against
``paddle_tpu.distributed.auto_parallel``).

The JAX side runs on the 8-device CPU mesh of ``tests/conftest.py``;
the port's plans lay their mesh over ``["cpu"] * n`` and train through
the propagation executor.  Weights go from the JAX ``gpt_tiny`` (fp32,
dropout 0) into the port's layered GPT by ``load_jax_state``.

- ``Strategy``: the same dicts give the same ``to_dict()`` (top level and
  each nested config), the same keys are refused with the same message;
- ``plan`` and ``plan_measured``: every candidate equal to the JAX
  package's (mesh order, ``feasible``, ``step_time``, ``mem_bytes`` within
  1e-12 relative) on ``tests/test_planner.py``'s three cases and GPT-3 13B
  over 4, 8 and 64 devices, each ``ClusterSpec`` given to both packages;
  the port's defaults are the H100's;
- ``placement_decisions`` over the layered ``gpt_tiny``: the JAX
  decisions' state-dict keys and dims;
- ``Engine.cost``: ``gpt_tiny``'s candidates and best mesh; a non-GPT MLP
  through the measured path: equal FLOPs and the same best mesh;
- ``Engine.plan`` and ``fit``: the JAX test's forced HBM over 8 devices
  (dp 2 x pp 4) and a compute-bound 4-device cluster at two HBMs (dp 2 x
  mp 2, and mp 4: the Megatron placements through the executor): the
  same mesh, 4 steps' losses within 1e-5 relative of the JAX
  ``Engine.fit``, and within 1e-6 of the port's unplanned fit;
- ``evaluate`` and ``predict``, ``gradient_merge`` (k = 2) and ZeRO
  stage 1 over a dp mesh without a plan against the JAX Engine's (ZeRO
  under a plan: ``tests/test_torch_engine_placed.py``);
- the counterparts of ``test_engine_fit_descends``,
  ``test_engine_save_load`` and ``TestEngineCheckpoint``; the Strategy's
  amp and the one-time notes; ``plan`` over too few devices raises; an
  Engine without a card and without ``device="cpu"`` raises.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.distributed import mesh as JM
from paddle_tpu.distributed.auto_parallel import Engine as JEngine
from paddle_tpu.distributed.auto_parallel import Strategy as JStrategy
from paddle_tpu.distributed.auto_parallel import planner as JP
from paddle_tpu.models import GPTForPretraining as JGPT
from paddle_tpu.models import GPTPretrainingCriterion as JCriterion
from paddle_tpu.models import gpt_13b as jgpt_13b
from paddle_tpu.models import gpt_tiny as jgpt_tiny

from paddle_tpu_torch.distributed import mesh as M
from paddle_tpu_torch.distributed.auto_parallel import (
    ClusterSpec, DistSpec, Engine, ModelSpec, Strategy, graph_cost,
    placement_decisions, plan,
)
from paddle_tpu_torch.distributed.auto_parallel import planner as P
from paddle_tpu_torch.models import (
    GPTForPretraining, GPTPretrainingCriterion, gpt_13b, gpt_tiny,
)
from paddle_tpu_torch.nn.layers import Linear, init_weights
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(2)

NO_DROP = dict(hidden_dropout=0.0, attention_dropout=0.0)
LOSS_REL, PLANNED_REL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def clean_mesh():
    """Both packages' global meshes cleared around a test, as
    ``tests/test_planner.py``'s ``clean_mesh`` does."""
    prev, jprev = M._global_mesh, JM._global_mesh
    M.set_mesh(None)
    JM._global_mesh = None
    yield
    M.set_mesh(prev)
    JM._global_mesh = jprev


@pytest.fixture(scope="module")
def jax_state():
    pt.seed(0)
    m = JGPT(jgpt_tiny(**NO_DROP))
    return {k: np.asarray(v.numpy(), np.float32)
            for k, v in m.state_dict().items()}


def _batches(n=4, batch=8, seq=16, seed=0):
    ids = np.random.RandomState(seed).randint(0, 1024, (batch, seq))
    return [(ids, ids) for _ in range(n)]


def _jax_engine(state, strategy=None):
    m = JGPT(jgpt_tiny(**NO_DROP))
    m.set_state_dict(state)
    opt = pt.optimizer.AdamW(learning_rate=1e-3, parameters=m.parameters())
    return JEngine(model=m, loss=JCriterion(jgpt_tiny(**NO_DROP)),
                   optimizer=opt, strategy=strategy or JStrategy()), m


def _port_engine(state, strategy=None, devices=None):
    m = GPTForPretraining(gpt_tiny(**NO_DROP), device="cpu")
    m.load_jax_state(state)
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
    return Engine(model=m, loss=GPTPretrainingCriterion(gpt_tiny(**NO_DROP)),
                  optimizer=opt, strategy=strategy or Strategy(),
                  device="cpu", devices=devices), m


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert np.all(np.abs(got - want) <= rel * np.abs(want)), (got, want)


# ---------------------------------------------------------------------------
# Strategy
# ---------------------------------------------------------------------------

STRATEGIES = [
    {},
    {"seed": 7, "split_data": False},
    {"amp": {"enable": True, "dtype": "float16", "level": "O2"},
     "sharding": {"enable": True, "stage": 2, "degree": 4},
     "gradient_merge": {"enable": True, "k_steps": 4, "avg": False},
     "pipeline": {"enable": True, "micro_batch_size": 2},
     "mp": {"enable": True, "degree": 2},
     "recompute": {"enable": True, "checkpoints": ["a"]}},
]


@pytest.mark.parametrize("config", STRATEGIES)
def test_strategy_dicts_equal_the_jax_packages(config):
    got, want = Strategy(config), JStrategy(config)
    assert got.to_dict() == want.to_dict()
    for name in Strategy._nested:
        assert getattr(got, name).to_dict() == getattr(want, name).to_dict()


@pytest.mark.parametrize("config", [{"bogus": 1},
                                    {"amp": {"enable": True, "nope": 2}}])
def test_strategy_refuses_the_same_keys(config):
    with pytest.raises(ValueError) as want:
        JStrategy(config)
    with pytest.raises(ValueError) as got:
        Strategy(config)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

def _case(name):
    if name.startswith("gpt3_13b"):
        n = int(name.split("_")[-1])
        return (dict(hidden=5120, layers=40, seq=2048, vocab=50304, batch=8),
                dict(n_devices=n, hbm_bytes=80e9, flops=989e12,
                     ici_bw=450e9, mfu=0.4))
    tpu = dict(n_devices=8, hbm_bytes=16e9, flops=197e12, ici_bw=4.5e10,
               mfu=0.4)
    return {"small": (dict(hidden=768, layers=12, seq=1024, vocab=50304,
                           batch=64), tpu),
            "large": (dict(hidden=4096, layers=32, seq=1024, vocab=50304,
                           batch=16), tpu),
            "comm": (dict(hidden=2048, layers=24, seq=1024, vocab=50304,
                          batch=32), tpu)}[name]


def _same_candidates(got, want):
    assert [c.mesh for c in got] == [c.mesh for c in want]
    for a, b in zip(got, want):
        assert a.feasible == b.feasible and a.reason == b.reason
        for f in ("step_time", "compute_time", "tp_comm_time",
                  "dp_comm_time", "bubble_frac", "mem_bytes"):
            x, y = getattr(a, f), getattr(b, f)
            assert abs(x - y) <= 1e-12 * abs(y), (f, x, y)


@pytest.mark.parametrize("name", ["small", "large", "comm", "gpt3_13b_4",
                                  "gpt3_13b_8", "gpt3_13b_64"])
def test_plan_equals_the_jax_planners(name):
    spec, cluster = _case(name)
    got = plan(ModelSpec(**spec), ClusterSpec(**cluster))
    want = JP.plan(JP.ModelSpec(**spec), JP.ClusterSpec(**cluster))
    _same_candidates(got, want)
    assert ModelSpec(**spec).params == JP.ModelSpec(**spec).params
    assert ModelSpec(**spec).step_flops == JP.ModelSpec(**spec).step_flops
    if name.startswith("gpt3_13b"):
        n = cluster["n_devices"]
        pure = next(c for c in got if c.mesh == {"dp": n, "mp": 1, "pp": 1})
        assert not pure.feasible and got[0].feasible


@pytest.mark.parametrize("n", [4, 8, 64])
def test_plan_measured_equals_the_jax_planners(n):
    cluster = dict(n_devices=n, hbm_bytes=2e9, flops=989e12, ici_bw=450e9,
                   mfu=0.4)
    args = (3.7e12, 5.1e9, 1.3e9)
    got = P.plan_measured(*args, ClusterSpec(**cluster), comm_bytes=2.2e8)
    want = JP.plan_measured(*args, JP.ClusterSpec(**cluster),
                            comm_bytes=2.2e8)
    _same_candidates(got, want)


def test_cluster_defaults_are_the_h100s():
    c = ClusterSpec()
    assert (c.n_devices, c.hbm_bytes, c.flops, c.ici_bw, c.mfu) == (
        8, 80e9, 989e12, 450e9, 0.4)
    m = ModelSpec.from_gpt_config(gpt_13b(), batch=8)
    j = JP.ModelSpec.from_gpt_config(jgpt_13b(), batch=8)
    assert (m.hidden, m.layers, m.seq, m.vocab, m.batch) == (
        j.hidden, j.layers, j.seq, j.vocab, j.batch)


@pytest.mark.parametrize("mp", [2, 4])
def test_placement_decisions_are_the_jax_packages(jax_state, mp):
    jm = JGPT(jgpt_tiny(**NO_DROP))
    jnames = {id(p): n for n, p in jm.named_parameters()}
    want = [(jnames[id(p)], tuple(d))
            for p, d in JP.placement_decisions(jm, mp)]
    m = GPTForPretraining(gpt_tiny(**NO_DROP), device="cpu")
    got = [(k, tuple(d)) for k, _, d in placement_decisions(m, mp)]
    assert got == want and len(got) > 0
    state = m.state_dict()
    for k, p, _ in placement_decisions(m, mp):
        assert state[k] is not None and tuple(state[k].shape) == \
            tuple(p.shape)


# ---------------------------------------------------------------------------
# Engine.cost and Engine.plan + fit
# ---------------------------------------------------------------------------

def test_engine_cost_on_gpt_tiny_equals_the_jax_engines(jax_state):
    cluster = dict(n_devices=8, hbm_bytes=1e6, flops=197e12, ici_bw=4.5e10,
                   mfu=0.4)
    je, _ = _jax_engine(jax_state)
    e, _ = _port_engine(jax_state)
    want = je.cost(cluster=JP.ClusterSpec(**cluster))
    got = e.cost(cluster=ClusterSpec(**cluster))
    assert got["best"] == want["best"]
    assert [c["mesh"] for c in got["candidates"]] == \
        [c["mesh"] for c in want["candidates"]]
    for a, b in zip(got["candidates"], want["candidates"]):
        assert a["feasible"] == b["feasible"]
        assert abs(a["step_time"] - b["step_time"]) <= 1e-12 * b["step_time"]


class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = Linear(64, 256, device="cpu")
        self.fc2 = Linear(256, 64, device="cpu")

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def test_engine_cost_of_a_non_gpt_model_through_the_measured_path():
    """An MLP has no GPT config: both Engines score its captured graph.
    The FLOPs are the same count; the bytes differ (aten and jaxpr
    intermediates), and the best mesh is the same."""
    cluster = dict(n_devices=8, hbm_bytes=4e5, flops=1e12, ici_bw=4.5e10,
                   mfu=0.4)
    rng = np.random.RandomState(0)
    x = rng.randn(32, 64).astype(np.float32)
    y = rng.randn(32, 64).astype(np.float32)
    pt.seed(0)
    jm = pt.nn.Sequential(pt.nn.Linear(64, 256), pt.nn.ReLU(),
                          pt.nn.Linear(256, 64))
    je = JEngine(model=jm, loss=pt.nn.MSELoss())
    je.capture_graph(x, y)
    m = _MLP()
    init_weights(m, 0)
    e = Engine(model=m, loss=torch.nn.MSELoss(), device="cpu")
    with pytest.raises(ValueError, match="capture_graph"):
        e.cost(cluster=ClusterSpec(**cluster))
    gm = e.capture_graph(x, y)
    from paddle_tpu.distributed.auto_parallel import propagation as JPR
    assert graph_cost(gm)["flops"] == JPR.graph_cost(je._captured[0])["flops"]
    want = je.cost(cluster=JP.ClusterSpec(**cluster))
    got = e.cost(cluster=ClusterSpec(**cluster))
    assert got["best"] == want["best"]


def _tiny_bytes():
    m = GPTForPretraining(gpt_tiny(**NO_DROP), device="cpu")
    return sum(p.numel() for p in m.parameters()) * 8


PLANS = {
    # tests/test_planner.py's forced HBM: dp 8 infeasible
    "forced_hbm_8": (lambda: dict(n_devices=8, hbm_bytes=_tiny_bytes() / 2,
                                  flops=197e12, ici_bw=4.5e10, mfu=0.4),
                     {"dp": 2, "mp": 1, "pp": 4}),
    # compute-bound at 1 TFLOP/s: the Megatron placements at mp 2
    "compute_bound_4": (lambda: dict(n_devices=4, hbm_bytes=_tiny_bytes(),
                                     flops=1e12, ici_bw=4.5e10, mfu=0.4),
                        {"dp": 2, "mp": 2, "pp": 1}),
    # half that HBM: mp 4 alone (the vocabulary-parallel lookup's partial
    # reaches products whose operands both cut a free dim on mp)
    "mp_only_4": (lambda: dict(n_devices=4, hbm_bytes=_tiny_bytes() / 2,
                               flops=1e12, ici_bw=4.5e10, mfu=0.4),
                  {"dp": 1, "mp": 4, "pp": 1}),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_engine_plan_and_fit_equal_the_jax_engines(jax_state, case):
    make, mesh = PLANS[case]
    cluster = make()
    je, jm = _jax_engine(jax_state)
    jbest = je.plan(cluster=JP.ClusterSpec(**cluster))
    jhist = je.fit(_batches(), verbose=0)["loss"]
    JM._global_mesh = None
    e, m = _port_engine(jax_state, devices=["cpu"] * cluster["n_devices"])
    best = e.plan(cluster=ClusterSpec(**cluster))
    assert best.mesh == jbest.mesh == mesh
    assert M.has_mesh() and M.get_mesh().shape == {
        k: v for k, v in mesh.items() if v > 1}
    placed = e._plan_specs
    if mesh["mp"] > 1:
        assert placed["gpt.layer_0.attn.qkv_proj.weight"] == \
            DistSpec((None, "mp"))
        assert e._planned[1] == len(placed) > 0
    hist = e.fit(_batches(), verbose=0)["loss"]
    _close(hist, jhist, LOSS_REL)
    assert hist[-1] < hist[0]
    M.set_mesh(None)
    plain, _ = _port_engine(jax_state)
    _close(hist, plain.fit(_batches(), verbose=0)["loss"], PLANNED_REL)


def test_plan_over_too_few_devices_raises(jax_state):
    e, _ = _port_engine(jax_state, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="mesh needs 4 devices"):
        e.plan(cluster=ClusterSpec(n_devices=4, hbm_bytes=_tiny_bytes(),
                                   flops=1e12))


def test_evaluate_and_predict_equal_the_jax_engines(jax_state):
    je, _ = _jax_engine(jax_state)
    e, _ = _port_engine(jax_state)
    data = _batches(2, seed=3)
    _close(e.evaluate(data)["eval_loss"], je.evaluate(data)["eval_loss"],
           1e-6)
    got = e.predict([d[0] for d in data])
    want = je.predict([d[0] for d in data])
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_gradient_merge_equals_the_jax_engines(jax_state):
    cfg = {"gradient_merge": {"enable": True, "k_steps": 2}}
    je, jm = _jax_engine(jax_state, JStrategy(cfg))
    e, m = _port_engine(jax_state, Strategy(cfg))
    data = [(b[0], b[0]) for b in _batches(1, seed=0) + _batches(1, seed=1)
            + _batches(1, seed=2) + _batches(1, seed=3)]
    _close(e.fit(data, verbose=0)["loss"], je.fit(data, verbose=0)["loss"],
           LOSS_REL)
    jw = jm.state_dict()["gpt.layer_1.mlp.fc2.weight"].numpy()
    np.testing.assert_allclose(
        m.state_dict()["gpt.layer_1.mlp.fc2.weight"].numpy(), jw,
        rtol=1e-5, atol=1e-5 * np.abs(jw).max())


def test_zero_stage_1_over_a_dp_mesh_equals_the_jax_engines(jax_state):
    cfg = {"sharding": {"enable": True, "stage": 1}}
    JM.set_mesh(JM.build_mesh({"dp": 8}))
    je, _ = _jax_engine(jax_state, JStrategy(cfg))
    jhist = je.fit(_batches(2), verbose=0)["loss"]
    JM._global_mesh = None
    M.set_mesh(M.build_mesh({"dp": 2}, ["cpu"] * 2))
    e, m = _port_engine(jax_state, Strategy(cfg))
    hist = e.fit(_batches(2), verbose=0)["loss"]
    assert m._zero_plan is not None
    _close(hist, jhist, LOSS_REL)


# ---------------------------------------------------------------------------
# the JAX Engine tests' counterparts
# ---------------------------------------------------------------------------

def test_engine_fit_descends():
    """``tests/test_moe_ring_engine.py::test_engine_fit_descends``."""
    cfg = gpt_tiny(**NO_DROP)
    model = GPTForPretraining(cfg, device="cpu", seed=0)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    engine = Engine(model=model, loss=GPTPretrainingCriterion(cfg),
                    optimizer=opt, strategy=Strategy(), device="cpu")
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 16))
    hist = engine.fit([(ids, ids) for _ in range(6)], epochs=1, verbose=0)
    assert hist["loss"][-1] < hist["loss"][0]


def test_engine_save_load(tmp_path):
    """``tests/test_moe_ring_engine.py::test_engine_save_load``, with the
    optimizer's file beside the model's."""
    cfg = gpt_tiny()
    model = GPTForPretraining(cfg, device="cpu", seed=0)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    engine = Engine(model=model, loss=GPTPretrainingCriterion(cfg),
                    optimizer=opt, device="cpu")
    path = str(tmp_path / "ckpt")
    engine.save(path)
    assert (tmp_path / "ckpt.pdparams").exists()
    assert (tmp_path / "ckpt.pdopt").exists()
    assert not [p for p in tmp_path.iterdir() if ".tmp-" in p.name]
    w = model.gpt.embeddings.word_embeddings.weight
    before = w.detach().clone()
    with torch.no_grad():
        w.zero_()
    engine.load(path)
    torch.testing.assert_close(w.detach(), before, rtol=0, atol=0)


def _linear_engine(seed):
    net = Linear(4, 2, device="cpu")
    init_weights(net, seed)
    opt = AdamW(learning_rate=1e-2, parameters=net.parameters())
    return Engine(model=net, loss=torch.nn.MSELoss(), optimizer=opt,
                  device="cpu"), net, opt


class TestEngineCheckpoint:
    """``tests/test_checkpoint.py::TestEngineCheckpoint``."""

    def test_engine_checkpoint_roundtrip(self, tmp_path):
        eng, net, opt = _linear_engine(5)
        rng = np.random.RandomState(0)
        data = [(rng.randn(4, 4).astype(np.float32),
                 rng.randn(4, 2).astype(np.float32)) for _ in range(3)]
        eng.fit(data, epochs=1, verbose=0)
        eng.save_checkpoint(str(tmp_path), step=3, epoch=0, blocking=True)
        eng2, net2, opt2 = _linear_engine(50)
        assert eng2.load_checkpoint(str(tmp_path)) == {"epoch": 0, "step": 3}
        assert torch.equal(net2.weight, net.weight)
        for p, q in zip(opt._params(), opt2._params()):
            assert torch.equal(opt.state[p]["moment1"],
                               opt2.state[q]["moment1"])

    def test_engine_load_checkpoint_empty_dir(self, tmp_path):
        eng = Engine(model=Linear(2, 2, device="cpu"), device="cpu")
        assert eng.load_checkpoint(str(tmp_path)) is None


def test_amp_and_the_one_time_notes(capsys):
    """The Strategy's amp runs the port's ``auto_cast`` (O1 bf16: the
    products in bf16, the loss finite); pipeline and mp print their note
    once."""
    cfg = gpt_tiny(**NO_DROP)
    model = GPTForPretraining(cfg, device="cpu", seed=0)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    st = Strategy({"amp": {"enable": True}, "pipeline": {"enable": True},
                   "mp": {"enable": True}})
    e = Engine(model=model, loss=GPTPretrainingCriterion(cfg), optimizer=opt,
               strategy=st, device="cpu")
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 16))
    gm = e.capture_graph(ids, ids)
    mms = [n for n in gm.graph.nodes if n.op == "call_function"
           and "mm" in str(n.target)]
    assert mms and all(n.meta["val"].dtype == torch.bfloat16 for n in mms)
    for _ in range(2):
        hist = e.fit([(ids, ids)], verbose=0)
    assert np.isfinite(hist["loss"]).all()
    err = capsys.readouterr().err
    assert err.count("Strategy.pipeline") == 1
    assert err.count("Strategy.mp") == 1


def test_an_engine_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model=Linear(2, 2, device="cpu"))
