"""The port's fleet API held against the JAX package on the CPU.

One process of the port drives every mesh position; the CPU runs lay a
mesh out over ``["cpu"] * n`` (all positions on one device, as a
one-card run puts them on ``cuda:0``).  The JAX side runs on the
8-device CPU mesh of ``tests/conftest.py``; each JAX reference is
computed once per module.

- the topology's rank arithmetic and the strategy's defaults equal the
  reference's;
- the mpu layers at mp 2 and 4 (fp32): outputs, input and weight
  gradients against the JAX mpu layers on a JAX ``{"mp": n}`` mesh
  carrying the same weights, rtol 1e-5; no whole tensor beside the
  parts;
- the 1F1B runtime on the reference's toy (4 x ``Linear(8, 8)``, S = 2,
  M = 4) with AdamW on both sides (the port has no SGD): the loss and
  weights after a ``train_batch`` against JAX's; S = 2 against S = 1;
  ``last_peak_inflight``; the ``GradScaler`` path;
- GPT (``gpt_tiny(use_tensor_parallel=True)``, 3 layers, fp32, dropout
  0) through the reference's fleet recipe (``tests/test_pipeline.py``,
  ``test_fleet_api_gpt_tp2_pp2_trains``) at dp 1 x pp 2 x mp 2 on both
  sides, the JAX weights carried across: each step's loss and the weights
  after 2 AdamW steps by ``test_torch_mesh_training.py``'s rule (rtol
  1e-5, atol 1e-5 x the largest reference value; an element whose step-1
  gradients part by more than ``ZERO_REL`` is zero to rounding and held
  to two steps of the rate, at most ``ZERO_SHARE`` of them); the tied
  table's gradient is the lookup's and the head's, applied once;
- ``HybridParallelOptimizer``'s global-norm clip over mp parts against
  the hand-computed norm (``tests/test_pipeline.py``,
  ``test_hybrid_optimizer_global_clip``);
- the layered ``GPTForPretraining`` under an mp mesh holds mp parts and
  matches the JAX model placed the same way; sp, sep and sharding axes
  raise; ``fused_linear_cross_entropy``'s three reductions;
- ``RNGStatesTracker`` by property.
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as pt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as JM
from paddle_tpu.distributed.fleet.base import distributed_strategy as jds
from paddle_tpu.distributed.fleet.base import topology as jtopo
from paddle_tpu.distributed.fleet.layers import mpu as jmpu
from paddle_tpu.distributed.fleet.meta_parallel import pipeline_parallel as jpp
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.nn.functional.loss import (
    fused_linear_cross_entropy as jax_flce,
)
from paddle_tpu.nn.modules.common import Linear as JaxLinear
from paddle_tpu.nn.modules.norm import LayerNorm as JaxLayerNorm

from paddle_tpu_torch import amp
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed import mesh as M
from paddle_tpu_torch.distributed.fleet.base.topology import (
    CommunicateTopology,
)
from paddle_tpu_torch.distributed.fleet.layers import mpu
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    HybridParallelOptimizer, LayerDesc, PipelineLayer, PipelineParallel,
)
from paddle_tpu_torch.distributed.shards import (
    Part, ShardedParameter, load_state, sharded_parameters,
    weight_bytes_by_position,
)
from paddle_tpu_torch.models import (
    GPTForPretraining, GPTPretrainingCriterion, gpt_tiny,
)
from paddle_tpu_torch.models.gpt import (
    GPTDecoderLayer, GPTEmbeddings, GPTLMHead,
)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn.functional import fused_linear_cross_entropy
from paddle_tpu_torch.nn.layers import LayerNorm, Linear
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(2)

ZERO_REL, ZERO_SHARE = 1e-3, 1e-2
GPT_CFG = dict(use_tensor_parallel=True, num_layers=3, hidden_dropout=0.0,
               attention_dropout=0.0)
GPT_LR, GPT_STEPS, GPT_BATCH, GPT_SEQ = 1e-3, 2, 8, 16
PIPE = {"accumulate_steps": 4, "micro_batch_size": 2}


class _JaxState:
    """Clear the JAX package's global mesh and hybrid group for a
    computation, and put them back after."""

    def __enter__(self):
        self.mesh = JM._global_mesh
        self.hcg = jtopo.get_hybrid_communicate_group()
        JM._global_mesh = None
        jtopo.set_hybrid_communicate_group(None)

    def __exit__(self, *exc):
        JM._global_mesh = self.mesh
        jtopo.set_hybrid_communicate_group(self.hcg)


@pytest.fixture
def mesh():
    """Set the port's global mesh over CPU positions for a test; clear it
    and the fleet topology after."""
    def set_(axes):
        M.set_mesh(M.build_mesh(axes, ["cpu"] * int(np.prod(
            list(axes.values())))))
    yield set_
    M.set_mesh(None)
    fleet.set_hybrid_communicate_group(None)


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max(), err_msg=what)


def _np(t):
    return np.asarray(t.numpy(), np.float32)


# ---------------------------------------------------------------------------
# topology and strategy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(2, 2, 1, 1, 2), (1, 2, 1, 1, 2)])
def test_topology_equals_the_reference(dims):
    names = ["data", "pipe", "sharding", "sep", "model"]
    ours, ref = CommunicateTopology(names, dims), jtopo.CommunicateTopology(
        names, dims)
    assert ours.world_size() == ref.world_size()
    for r in range(ref.world_size()):
        assert ours.get_coord(r) == ref.get_coord(r)
        assert ours.get_rank(**dict(zip(names, ref.get_coord(r)))) == r
    for name in names:
        assert ours.get_comm_list(name) == ref.get_comm_list(name)
        for i in range(ref.get_dim(name)):
            assert ours.get_axis_list(name, i) == ref.get_axis_list(name, i)


def test_strategy_defaults_equal_the_reference():
    assert vars(fleet.DistributedStrategy()) == vars(
        jds.DistributedStrategy())


def test_init_holds_the_mesh_to_the_degrees(mesh):
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 1, "pp_degree": 2, "mp_degree": 2}
    mesh({"pp": 2, "mp": 2})
    fleet.init(is_collective=True, strategy=st)
    hcg = fleet.get_hybrid_communicate_group()
    assert hcg.get_parallel_mode() == "pipeline"
    assert (hcg.get_pipe_parallel_world_size(),
            hcg.get_model_parallel_world_size(),
            hcg.get_data_parallel_world_size()) == (2, 2, 1)
    assert (fleet.worker_index(), fleet.worker_num(),
            fleet.is_first_worker()) == (0, 1, True)
    mesh({"pp": 2, "mp": 1, "dp": 2})
    with pytest.raises(ValueError, match="degrees"):
        fleet.init(is_collective=True, strategy=st)


def test_init_without_a_mesh_never_falls_back_to_the_cpu(mesh):
    """Without a mesh set, ``fleet.init`` builds one over the visible
    cards; none here, so it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the mesh would be built over it")
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 1, "pp_degree": 2, "mp_degree": 2}
    with pytest.raises(ValueError, match="visible CUDA devices"):
        fleet.init(is_collective=True, strategy=st)


# ---------------------------------------------------------------------------
# the mpu layers against the JAX mpu layers
# ---------------------------------------------------------------------------

IN, OUT, VOCAB = 8, 16, 32


def _jax_grads(layer, x, cot, ids=None):
    """The JAX layer's output, input gradient and weight gradients for
    the cotangent ``cot``."""
    xt = pt.to_tensor(x, stop_gradient=False) if ids is None else \
        pt.to_tensor(ids, dtype="int64")
    out = layer(xt)
    pt.ops.sum(out * pt.to_tensor(cot)).backward()
    return (_np(out), None if ids is not None else _np(xt.grad),
            {n: _np(p.grad) for n, p in layer.named_parameters()})


@pytest.fixture(scope="module", params=[2, 4])
def mpu_case(request):
    """At mp = n: each JAX mpu layer's weights (biases moved off 0), and
    its output and gradients on random inputs."""
    n = request.param
    rng = np.random.RandomState(n)
    x = rng.randn(2, 3, IN).astype(np.float32)
    ids = rng.randint(0, VOCAB, (2, 3))
    case = dict(n=n, x=x, ids=ids, layers={})
    with _JaxState():
        JM.set_mesh(JM.build_mesh({"mp": n}))
        pt.seed(n)
        layers = {
            "column_gathered": jmpu.ColumnParallelLinear(IN, OUT),
            "column": jmpu.ColumnParallelLinear(IN, OUT,
                                                gather_output=False),
            "row": jmpu.RowParallelLinear(OUT, IN),
            "row_parallel_input": jmpu.RowParallelLinear(
                OUT, IN, input_is_parallel=True),
            "vocab": jmpu.VocabParallelEmbedding(VOCAB, IN),
        }
        for name, layer in layers.items():
            state = {k: _np(v) + (0.1 * rng.randn(*v.shape).astype(
                np.float32) if k == "bias" else 0)
                for k, v in layer.state_dict().items()}
            layer.set_state_dict(state)
            width = IN if name in ("column_gathered", "column", "vocab") \
                else OUT
            xin = x if width == IN else rng.randn(2, 3, OUT).astype(
                np.float32)
            out_w = OUT if name.startswith("column") else IN
            cot = rng.randn(2, 3, out_w).astype(np.float32)
            got = _jax_grads(layer, xin, cot,
                             ids=ids if name == "vocab" else None)
            case["layers"][name] = dict(state=state, x=xin, cot=cot,
                                        out=got[0], dx=got[1],
                                        dw=got[2])
        logits = rng.randn(2, 3, VOCAB).astype(np.float32)
        labels = rng.randint(0, VOCAB, (2, 3))
        labels[0, 0] = -100
        lt = pt.to_tensor(logits, stop_gradient=False)
        loss = jmpu.ParallelCrossEntropy()(lt, pt.to_tensor(labels,
                                                            dtype="int64"))
        pt.ops.sum(loss).backward()
        case["ce"] = dict(logits=logits, labels=labels, loss=_np(loss),
                          grad=_np(lt.grad))
    return case


def _port_layer(name):
    return {
        "column_gathered": lambda: mpu.ColumnParallelLinear(IN, OUT),
        "column": lambda: mpu.ColumnParallelLinear(IN, OUT,
                                                   gather_output=False),
        "row": lambda: mpu.RowParallelLinear(OUT, IN),
        "row_parallel_input": lambda: mpu.RowParallelLinear(
            OUT, IN, input_is_parallel=True),
        "vocab": lambda: mpu.VocabParallelEmbedding(VOCAB, IN),
    }[name]()


@pytest.mark.parametrize("name", ["column_gathered", "column", "row",
                                  "row_parallel_input", "vocab"])
def test_mpu_layer_matches_jax(mpu_case, mesh, name):
    n, ref = mpu_case["n"], mpu_case["layers"][name]
    mesh({"mp": n})
    layer = _port_layer(name)
    load_state(layer, ref["state"])
    # the cut weights are parts only: one a shard, no whole tensor
    w = layer.weight
    assert isinstance(w, ShardedParameter) and len(w.parts) == n
    assert all(tuple(p.shape) != w.whole_shape for p in w)
    for k, v in layer.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref["state"][k])
    if name == "vocab":
        x = torch.from_numpy(mpu_case["ids"])
    else:
        x = torch.tensor(ref["x"], requires_grad=True)
    inp = x
    if name == "row_parallel_input":
        inp = mpu.ShardedTensor(x.chunk(n, -1))
    out = layer(inp)
    if name == "column":
        assert isinstance(out, mpu.ShardedTensor) and len(out.parts) == n
        with pytest.raises(TypeError):
            out + 1.0                     # never a tensor by accident
        out = out.gather()
    _close(out.detach().numpy(), ref["out"], name)
    (out * torch.from_numpy(ref["cot"])).sum().backward()
    if ref["dx"] is not None:
        _close(x.grad.numpy(), ref["dx"], name + " dx")
    grads = {k: sp.gather([p.grad for p in sp]).numpy()
             for k, sp in sharded_parameters(layer).items()}
    grads.update({k: p.grad.numpy() for k, p in layer.named_parameters()
                  if not hasattr(p, "shard")})
    assert set(grads) == set(ref["dw"])
    for k, g in ref["dw"].items():
        _close(grads[k], g, f"{name} d{k}")


def test_parallel_cross_entropy_matches_jax(mpu_case):
    """Over vocabulary shards (a ``ShardedTensor``) as over the whole
    logits; an ignored label gives 0."""
    n, ref = mpu_case["n"], mpu_case["ce"]
    labels = torch.from_numpy(ref["labels"])
    for sharded in (True, False):
        logits = torch.tensor(ref["logits"], requires_grad=True)
        inp = mpu.ShardedTensor(logits.chunk(n, -1)) if sharded else logits
        loss = mpu.ParallelCrossEntropy()(inp, labels)
        assert tuple(loss.shape) == tuple(labels.shape) and loss[0, 0] == 0
        _close(loss.detach().numpy(), ref["loss"], f"sharded {sharded}")
        loss.sum().backward()
        _close(logits.grad.numpy(), ref["grad"], f"grad, sharded {sharded}")


# ---------------------------------------------------------------------------
# the 1F1B runtime on the reference's toy
# ---------------------------------------------------------------------------

class _Pipe:
    pipeline_configs = dict(PIPE)


def _toy_batch():
    rng = np.random.RandomState(0)
    return (rng.randn(8, 8).astype(np.float32),
            rng.randn(8, 8).astype(np.float32))


@pytest.fixture(scope="module")
def toy_jax():
    """The JAX toy: its weights, then the loss and weights after one
    ``train_batch`` of AdamW (lr 0.1) at S = 2."""
    xb, yb = _toy_batch()
    with _JaxState():
        pt.seed(7)
        pl = jpp.PipelineLayer(
            [jpp.LayerDesc(JaxLinear, 8, 8) for _ in range(4)],
            num_stages=2, loss_fn=lambda o, y: pt.ops.mean((o - y) ** 2))
        state = {k: _np(v) for k, v in pl.state_dict().items()}
        pp = jpp.PipelineParallel(pl, strategy=_Pipe())
        opt = pt.optimizer.AdamW(learning_rate=0.1,
                                 parameters=pl.parameters())
        loss = pp.train_batch((pt.to_tensor(xb), pt.to_tensor(yb)), opt)
        after = {k: _np(v) for k, v in pl.state_dict().items()}
    return dict(state=state, loss=float(loss), after=after)


def _toy_port(state, stages):
    pl = PipelineLayer([LayerDesc(Linear, 8, 8, device="cpu")
                        for _ in range(4)], num_stages=stages,
                       loss_fn=lambda o, y: ((o - y) ** 2).mean())
    pl.load_jax_state(state)
    return PipelineParallel(pl, strategy=_Pipe()), pl


def _toy_step(state, stages, scaler=None):
    pp, pl = _toy_port(state, stages)
    xb, yb = _toy_batch()
    loss = pp.train_batch((torch.from_numpy(xb), torch.from_numpy(yb)),
                          AdamW(0.1, parameters=pl.parameters()),
                          scaler=scaler)
    return pp, float(loss), {k: v.numpy() for k, v in pl.state_dict().items()}


def test_1f1b_matches_jax(toy_jax):
    pp, loss, after = _toy_step(toy_jax["state"], 2)
    np.testing.assert_allclose(loss, toy_jax["loss"], rtol=1e-5)
    for k, v in toy_jax["after"].items():
        np.testing.assert_allclose(after[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert pp.accumulate_steps == 4 and pp.last_peak_inflight == 2


def test_1f1b_matches_plain_accumulation(toy_jax):
    """S = 2 against S = 1 (plain accumulation), and against the batch's
    gradients summed by hand."""
    _, loss2, after2 = _toy_step(toy_jax["state"], 2)
    pp1, loss1, after1 = _toy_step(toy_jax["state"], 1)
    assert pp1.last_peak_inflight == 1
    np.testing.assert_allclose(loss2, loss1, rtol=1e-6)
    for k in after1:
        np.testing.assert_allclose(after2[k], after1[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_grad_scaler_path(toy_jax):
    """A power-of-two scale is undone exactly: the scaled step is the
    unscaled one, bit for bit; the loss returned is unscaled."""
    scaler = amp.GradScaler(init_loss_scaling=256.0, device="cpu")
    _, loss, after = _toy_step(toy_jax["state"], 2, scaler=scaler)
    _, loss_plain, plain = _toy_step(toy_jax["state"], 2)
    assert np.isfinite(loss) and loss == loss_plain
    for k in plain:
        np.testing.assert_array_equal(after[k], plain[k], err_msg=k)


def test_eval_batch_is_the_mean_loss(toy_jax):
    pp, pl = _toy_port(toy_jax["state"], 2)
    xb, yb = (torch.from_numpy(a) for a in _toy_batch())
    got = pp.eval_batch((xb, yb))
    with torch.no_grad():
        want = np.mean([float(((pl(x) - y) ** 2).mean())
                        for x, y in zip(xb.split(2), yb.split(2))])
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert not got.requires_grad


def test_lr_scheduler_is_stepped(toy_jax):
    from paddle_tpu_torch.optimizer.lr import StepDecay

    pp, pl = _toy_port(toy_jax["state"], 2)
    sched = StepDecay(0.1, step_size=1, gamma=0.5)
    xb, yb = (torch.from_numpy(a) for a in _toy_batch())
    pp.train_batch((xb, yb), AdamW(sched, parameters=pl.parameters()),
                   lr_scheduler=sched)
    assert sched() == pytest.approx(0.05)


def _shared_descs(desc_mod, linear, **kw):
    """[the shared layer, a Linear, the shared layer again through a
    forward_func]: the reference's tied-weight pattern."""
    return [desc_mod.SharedLayerDesc("w", linear, None, "weight", 8, 8, **kw),
            desc_mod.LayerDesc(linear, 8, 8, **kw),
            desc_mod.SharedLayerDesc("w", linear,
                                     lambda layer, x: layer(x) * 0.5,
                                     "weight", 8, 8, **kw)]


def test_shared_layer_desc_matches_jax():
    """A ``SharedLayerDesc`` key built once and used on both stages: one
    set of weights, its gradient both uses', the loss and weights after
    a ``train_batch`` equal to JAX's."""
    import paddle_tpu_torch.distributed.fleet.meta_parallel as ours

    xb, yb = _toy_batch()
    with _JaxState():
        pt.seed(9)
        jl = jpp.PipelineLayer(_shared_descs(jpp, JaxLinear), num_stages=2,
                               loss_fn=lambda o, y: pt.ops.mean((o - y) ** 2))
        state = {k: _np(v) for k, v in jl.state_dict().items()}
        loss = jpp.PipelineParallel(jl, strategy=_Pipe()).train_batch(
            (pt.to_tensor(xb), pt.to_tensor(yb)), pt.optimizer.AdamW(
                learning_rate=0.1, parameters=jl.parameters()))
        after = {k: _np(v) for k, v in jl.state_dict().items()}
    pl = PipelineLayer(_shared_descs(ours, Linear, device="cpu"),
                       num_stages=2,
                       loss_fn=lambda o, y: ((o - y) ** 2).mean())
    assert set(pl.state_dict()) == set(state) and len(state) == 4
    pl.load_jax_state(state)
    got = PipelineParallel(pl, strategy=_Pipe()).train_batch(
        (torch.from_numpy(xb), torch.from_numpy(yb)),
        AdamW(0.1, parameters=pl.parameters()))
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-5)
    for k, v in pl.state_dict().items():
        np.testing.assert_allclose(v.numpy(), after[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# GPT through the fleet recipe, dp 1 x pp 2 x mp 2
# ---------------------------------------------------------------------------

def _strategy(cls):
    st = cls()
    st.hybrid_configs = {"dp_degree": 1, "pp_degree": 2, "mp_degree": 2,
                         "order": ["dp", "pp", "sharding", "sep", "mp"]}
    st.pipeline_configs = dict(PIPE)
    return st


def _gpt_batches():
    rng = np.random.RandomState(1)
    return [(rng.randint(0, 1024, (GPT_BATCH, GPT_SEQ)),
             rng.randint(0, 1024, (GPT_BATCH, GPT_SEQ)))
            for _ in range(GPT_STEPS)]


class _Capture:
    """An optimizer wrapper that keeps the gradients ``step`` sees."""

    def __init__(self, opt, grads_of):
        self.opt, self.grads_of, self.grads = opt, grads_of, None

    def step(self):
        self.grads = self.grads_of()
        self.opt.step()

    def clear_grad(self, *a):
        self.opt.clear_grad(*a)


class _JaxHead(pt.nn.Layer):
    """The reference test's tied head."""

    def __init__(self, emb):
        super().__init__()
        self._emb = emb

    def forward(self, h):
        return pt.ops.matmul(h, self._emb.word_embeddings.weight,
                             transpose_y=True)


@pytest.fixture(scope="module")
def fleet_jax():
    """The JAX recipe: its weights (every bias and LayerNorm gain moved
    off 0/1), step 1's gradients, each step's loss and the weights after
    ``GPT_STEPS`` AdamW steps."""
    cfg = jgpt.gpt_tiny(**GPT_CFG)
    with _JaxState():
        jfleet.init(is_collective=True, strategy=_strategy(
            jfleet.DistributedStrategy))
        pt.seed(0)
        emb = jgpt.GPTEmbeddings(cfg)
        crit = jgpt.GPTPretrainingCriterion(cfg)
        descs = [emb] + [jgpt.GPTDecoderLayer(cfg)
                         for _ in range(cfg.num_layers)]
        descs += [JaxLayerNorm(cfg.hidden_size), _JaxHead(emb)]
        pl = jpp.PipelineLayer(descs, num_stages=2,
                               loss_fn=lambda lg, lb: crit(lg, lb))
        rng = np.random.RandomState(0)
        state = {}
        for k, p in pl.named_parameters():
            a = _np(p)
            if a.ndim == 1:
                # kept where the mesh placed it (set_state_dict would not)
                a = a + 0.1 * rng.randn(*a.shape).astype(np.float32)
                where = p._value.sharding
                p._set_value(jax.device_put(a, where)
                             if len(where.device_set) > 1
                             else jax.numpy.asarray(a))
            state[k] = a
        assert set(state) == set(pl.state_dict())
        model = jfleet.distributed_model(pl)
        named = dict(pl.named_parameters())
        opt = _Capture(jfleet.distributed_optimizer(pt.optimizer.AdamW(
            learning_rate=GPT_LR, parameters=pl.parameters(),
            multi_precision=False)),
            lambda: {k: _np(p.grad) for k, p in named.items()})
        losses = []
        for ids, labels in _gpt_batches():
            losses.append(float(model.train_batch(
                (pt.to_tensor(ids, dtype="int64"),
                 pt.to_tensor(labels, dtype="int64")), opt)))
            if len(losses) == 1:
                grads = opt.grads
        after = {k: _np(v) for k, v in pl.state_dict().items()}
        peak = model.last_peak_inflight
    return dict(state=state, grads=grads, losses=losses, after=after,
                peak=peak)


def _fleet_port(state):
    """The port's recipe on a ``["cpu"] * 4`` mesh, carrying ``state``."""
    cfg = gpt_tiny(**GPT_CFG)
    fleet.init(is_collective=True, strategy=_strategy(
        fleet.DistributedStrategy))
    emb = GPTEmbeddings(cfg)
    descs = [emb] + [GPTDecoderLayer(cfg) for _ in range(cfg.num_layers)]
    descs += [LayerNorm(cfg.hidden_size, cfg.layer_norm_eps), GPTLMHead(emb)]
    pl = PipelineLayer(descs, num_stages=2,
                       loss_fn=GPTPretrainingCriterion(cfg))
    pl.load_jax_state(state)
    return pl


def _gathered_grads(module):
    out = {k: sp.gather([p.grad for p in sp]).numpy()
           for k, sp in sharded_parameters(module).items()}
    out.update({k: p.grad.numpy() for k, p in module.named_parameters()
                if not hasattr(p, "shard")})
    return out


def test_fleet_gpt_tp2_pp2_matches_jax(fleet_jax, mesh):
    mesh({"dp": 1, "pp": 2, "mp": 2})
    pl = _fleet_port(fleet_jax["state"])
    model = fleet.distributed_model(pl)
    assert isinstance(model, PipelineParallel)
    inner = fleet.distributed_optimizer(AdamW(
        GPT_LR, parameters=pl.parameters(), multi_precision=False))
    assert isinstance(inner, HybridParallelOptimizer)
    opt = _Capture(inner, lambda: _gathered_grads(pl))
    losses = []
    for ids, labels in _gpt_batches():
        losses.append(float(model.train_batch(
            (torch.from_numpy(ids), torch.from_numpy(labels)), opt)))
        if len(losses) == 1:
            grads = opt.grads
    assert model.last_peak_inflight == fleet_jax["peak"] == 2
    np.testing.assert_allclose(losses, fleet_jax["losses"], rtol=1e-5)
    assert set(grads) == set(fleet_jax["grads"])
    for k, g in fleet_jax["grads"].items():
        _close(grads[k], g, "step 1 gradient of " + k)
    got = pl.state_dict()
    assert set(got) == set(fleet_jax["after"])
    n_zero = n_all = 0
    for k, want in fleet_jax["after"].items():
        g = fleet_jax["grads"][k]
        zero = np.abs(grads[k] - g) > ZERO_REL * np.abs(g)
        n_zero += int(zero.sum())
        n_all += zero.size
        err = np.abs(got[k].numpy() - want)
        tol = 1e-5 * np.abs(want) + 1e-5 * np.abs(want).max()
        assert (err <= tol)[~zero].all(), (k, float((err - tol).max()))
        assert (err <= 2 * GPT_LR * GPT_STEPS)[zero].all(), k
    assert n_zero <= ZERO_SHARE * n_all, (n_zero, n_all)


def test_fleet_gpt_tied_table_is_one_set_of_parts(fleet_jax, mesh):
    """The head on the last stage reads stage 0's word-table parts: one
    set of parts among the parameters (the optimizer steps each once),
    none in the head's state, and the table's gradient is the lookup's
    plus the head's: JAX's, with every row the batch never looks up
    carrying the head's share."""
    mesh({"dp": 1, "pp": 2, "mp": 2})
    pl = _fleet_port(fleet_jax["state"])
    table = pl.run_function[0].word_embeddings.weight
    params = list(pl.parameters())
    assert len({id(p) for p in params}) == len(params)
    assert [p for p in params if getattr(p, "shard", (None,))[0]
            is table] == list(table)
    assert [p.position for p in table.parts] == [(0, 0, 0), (0, 0, 1)]
    assert pl.run_function[-1]._tied[0].word_embeddings.weight is table
    assert not pl.run_function[-1].state_dict()
    ids, labels = (torch.from_numpy(a) for a in _gpt_batches()[0])
    fleet.distributed_model(pl).train_batch((ids, labels), _NoStep())
    grad = table.gather([p.grad for p in table])
    _close(grad.numpy(),
           fleet_jax["grads"]["run_function.0.word_embeddings.weight"],
           "tied table")
    seen = np.zeros(grad.shape[0], bool)
    seen[ids.numpy().ravel()] = True
    assert (grad[torch.from_numpy(~seen)].abs().sum(1) > 0).all()


class _NoStep:
    """An optimizer that keeps the gradients: no step, no clearing."""

    def step(self):
        pass

    def clear_grad(self, *a):
        pass


def test_fleet_placement_and_bytes(mesh):
    """Stage s's layers on positions (0, s, i); every parameter's bytes
    counted at its position; the stages' bytes add up to the model's."""
    mesh({"dp": 1, "pp": 2, "mp": 2})
    cfg = gpt_tiny(**GPT_CFG)
    whole = GPTForPretraining(cfg, device="cpu")
    fleet.init(is_collective=True, strategy=_strategy(
        fleet.DistributedStrategy))
    emb = GPTEmbeddings(cfg)
    pl = PipelineLayer([emb] + [GPTDecoderLayer(cfg) for _ in range(3)]
                       + [LayerNorm(cfg.hidden_size), GPTLMHead(emb)],
                       num_stages=2, loss_fn=GPTPretrainingCriterion(cfg))
    assert pl.segment_bounds == [0, 3, 6]
    by_pos = weight_bytes_by_position(pl)
    assert sorted(by_pos) == [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)]
    assert sum(by_pos.values()) == sum(
        t.numel() * 4 for t in whole.state_dict().values())
    layer = pl.run_function[3]            # stage 1's decoder layer
    assert {p.position for p in layer.attn.qkv_proj.weight.parts} == {
        (0, 1, 0), (0, 1, 1)}
    assert layer.ln1.weight.mesh_position == (0, 1, 0)


# ---------------------------------------------------------------------------
# the hybrid optimizer's global-norm clip
# ---------------------------------------------------------------------------

def test_hybrid_optimizer_global_clip(mesh):
    """A [8, 4] weight cut over mp 4 (by rows) and a whole [4] one,
    gradients 3 and 4: the clip scales both by 1 / the global norm, each
    logical tensor counted once; AdamW's first moment is (1 - beta1) x
    the clipped gradient."""
    mesh({"mp": 4})
    devs = M.stage_devices(0)
    w1 = ShardedParameter((8, 4), torch.float32, [
        Part((0, 0, i), d, ((0, torch.arange(2 * i, 2 * i + 2)),))
        for i, d in enumerate(devs)])
    w1.load_whole(torch.ones(8, 4))
    w2 = torch.nn.Parameter(torch.full((4,), 2.0))
    for p in w1:
        p.grad = torch.full_like(p, 3.0)
    w2.grad = torch.full((4,), 4.0)
    opt = HybridParallelOptimizer(AdamW(
        1.0, parameters=list(w1) + [w2],
        grad_clip=ClipGradByGlobalNorm(clip_norm=1.0)))
    opt.step()
    gnorm = np.sqrt(3.0 ** 2 * 32 + 4.0 ** 2 * 4)
    sd = opt.state_dict()
    np.testing.assert_allclose(sd["moment1_0"].numpy(),
                               np.full((8, 4), 0.1 * 3.0 / gnorm), rtol=1e-5)
    np.testing.assert_allclose(sd["moment1_1"].numpy(),
                               np.full((4,), 0.1 * 4.0 / gnorm), rtol=1e-5)


# ---------------------------------------------------------------------------
# faults 6 and 7
# ---------------------------------------------------------------------------

def test_layered_gpt_under_mp_holds_parts(mesh):
    """Fault 6: under {"mp": 2} with ``use_tensor_parallel`` the layered
    model holds QKV, out, fc1, fc2 and the word table as two parts each
    and no whole tensor beside them; the same seed draws the unplaced
    model's weights, and the logits and gathered gradients are the
    unplaced model's (which ``test_torch_layered_gpt.py`` holds to the
    JAX model)."""
    cfg = gpt_tiny(use_tensor_parallel=True, hidden_dropout=0.0,
                   attention_dropout=0.0)
    ref = GPTForPretraining(cfg, device="cpu", seed=3)
    mesh({"mp": 2})
    m = GPTForPretraining(cfg, seed=3)
    layer = m.gpt.layer_0
    for sp in (layer.attn.qkv_proj.weight, layer.attn.out_proj.weight,
               layer.mlp.fc1.weight, layer.mlp.fc2.weight,
               m.gpt.embeddings.word_embeddings.weight):
        assert isinstance(sp, ShardedParameter) and len(sp.parts) == 2
        assert all(tuple(p.shape) != sp.whole_shape for p in sp)
    whole = {tuple(p.shape) for p in ref.parameters() if p.dim() == 2}
    assert not any(tuple(p.shape) in whole for p in m.parameters()
                   if p.dim() == 2 and p.shape[0] != 128), \
        "a whole 2-D weight is kept beside the parts"
    want = ref.state_dict()
    got = m.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, 1024,
                                                            (2, 16)))
    crit = GPTPretrainingCriterion(cfg)
    logits, ref_logits = m(ids), ref(ids)
    _close(logits.detach().numpy(), ref_logits.detach().numpy(), "logits")
    crit(logits, ids).backward()
    crit(ref_logits, ids).backward()
    grads = _gathered_grads(m)
    for k, p in ref.named_parameters():
        _close(grads[k], p.grad.numpy(), k)
    # generation from the placed parts (ROADMAP.md item 9, step 5): the
    # unplaced model's tokens and logits
    kw = dict(max_seq_len=32, cache_dtype="float32", return_logits=True)
    out, lg = m.generate(ids.numpy(), 2, **kw)
    want, wlg = ref.generate(ids.numpy(), 2, **kw)
    assert torch.equal(out, want)
    _close(lg.numpy(), wlg.numpy(), "generate logits")


def test_tensor_parallel_wrapper_delegates(mesh):
    """At mp 2 without pipeline stages ``distributed_model`` gives a
    ``TensorParallel``: its forward, its state_dict (the model's keys) and
    set_state_dict are the placed model's; ``load_jax_state`` of the
    placed model takes whole tensors."""
    cfg = gpt_tiny(use_tensor_parallel=True, hidden_dropout=0.0,
                   attention_dropout=0.0)
    ref = GPTForPretraining(cfg, device="cpu", seed=5)
    state = {k: v.numpy() for k, v in ref.state_dict().items()}
    mesh({"mp": 2})
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 1, "pp_degree": 1, "mp_degree": 2}
    fleet.init(is_collective=True, strategy=st)
    m = GPTForPretraining(cfg, seed=1)
    m.load_jax_state(state)
    tp = fleet.distributed_model(m)
    assert isinstance(tp, fleet.TensorParallel)
    ids = torch.randint(0, 1024, (2, 8))
    _close(tp(ids).detach().numpy(), ref(ids).detach().numpy(), "logits")
    assert list(tp.state_dict()) == list(ref.state_dict())
    other = GPTForPretraining(cfg, seed=2)
    fleet.TensorParallel(other).set_state_dict(tp.state_dict())
    for k, v in other.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)


@pytest.mark.parametrize("axes", [{"sp": 2}, {"sep": 2},
                                  {"sharding": 2, "sp": 2}])
def test_layered_gpt_refuses_unported_axes(mesh, axes):
    """Fault 6's axes, taken since sequence parallelism was ported: an sp
    axis without ``sequence_parallel`` and a sep axis are read at
    coordinate 0, as the reference's layered model reads them, with
    ``use_tensor_parallel`` or without, a sharding axis beside them too:
    the model holds the unplaced model's whole weights and gives its
    logits and gradients bit for bit (``sequence_parallel`` on an sp axis
    is ``tests/test_torch_sequence_parallel.py``'s)."""
    ids = torch.from_numpy(np.random.RandomState(5).randint(0, 1024, (2, 8)))
    for tp in (True, False):
        cfg = gpt_tiny(use_tensor_parallel=tp)
        M.set_mesh(None)
        ref = GPTForPretraining(cfg, device="cpu", seed=4).eval()
        mesh(axes)
        m = GPTForPretraining(cfg, device="cpu", seed=4).eval()
        assert not sharded_parameters(m) and m.gpt.sequence_parts == 1
        got, want = m(ids), ref(ids)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        got.sum().backward()
        want.sum().backward()
        for (k, p), q in zip(m.named_parameters(), ref.parameters()):
            torch.testing.assert_close(p.grad, q.grad, rtol=0, atol=0,
                                       msg=k)


def test_layered_gpt_under_dp_and_pp_stays_whole(mesh):
    """dp and pp keep the reference's meaning for the bare model: it
    neither shards its batch nor pipelines."""
    mesh({"dp": 2, "pp": 2})
    m = GPTForPretraining(gpt_tiny(use_tensor_parallel=True), device="cpu")
    assert not sharded_parameters(m)
    M.set_mesh(None)
    ref = GPTForPretraining(gpt_tiny(), device="cpu")
    ids = torch.randint(0, 1024, (2, 8))
    torch.testing.assert_close(m(ids), ref(ids), rtol=0, atol=0)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("chunk", [64, 16])
def test_fused_linear_cross_entropy_reduction_matches_jax(reduction, chunk):
    """Fault 7: the reference's three reductions, one chunk and several."""
    rng = np.random.RandomState(7)
    h = rng.randn(4, 12, 32).astype(np.float32)
    w = rng.randn(96, 32).astype(np.float32) * 0.2
    labels = rng.randint(0, 96, (4, 12))
    with _JaxState():
        want = _np(jax_flce(pt.to_tensor(h), pt.to_tensor(w),
                            pt.to_tensor(labels, dtype="int64"),
                            chunk_tokens=chunk, reduction=reduction))
    got = fused_linear_cross_entropy(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(labels),
        chunk_tokens=chunk, reduction=reduction)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


# ---------------------------------------------------------------------------
# the random streams
# ---------------------------------------------------------------------------

def test_rng_tracker_streams_differ_and_repeat():
    from paddle_tpu_torch.distributed.fleet.layers.mpu import (
        get_rng_state_tracker, model_parallel_random_seed,
    )

    def draw():
        model_parallel_random_seed(11)
        x = torch.ones(4096)
        outside = torch.nn.functional.dropout(x, 0.5)
        with get_rng_state_tracker().rng_state():
            inside = torch.nn.functional.dropout(x, 0.5)
        after = torch.nn.functional.dropout(x, 0.5)
        return outside, inside, after

    outside, inside, after = draw()
    assert not torch.equal(outside, inside)
    assert not torch.equal(outside, after)
    for a, b in zip((outside, inside, after), draw()):
        assert torch.equal(a, b)
    # the stream outside goes on as if the region had drawn nothing
    model_parallel_random_seed(11)
    x = torch.ones(4096)
    torch.nn.functional.dropout(x, 0.5)
    assert torch.equal(torch.nn.functional.dropout(x, 0.5), after)
