"""The rest of the port's fleet API held against the JAX package on the CPU:
dp replicas through the wrappers, ``fleet.recompute`` with pipeline
recompute and virtual stages, and the meta-optimizers with ``SGD`` and
``Momentum``.

One process of the port drives every mesh position (``["cpu"] * n``);
the JAX side runs on the 8-device CPU mesh of ``tests/conftest.py``.
Inputs come from numpy seeds.

- fault 8: ``fleet.distributed_optimizer`` with ``gradient_merge`` (k 2)
  over ``AdamW``: the weights after each of 4 steps against JAX's (rtol
  1e-5, atol 1e-6);
- ``DataParallel`` at dp 2 against the JAX one (losses rtol 1e-6, weights
  after 2 AdamW steps rtol 1e-5, atol 1e-6); the replicas bit-equal;
- ``PipelineParallel.train_batch`` at dp 2 x pp 2 on the reference's toy
  (4 x ``Linear(8, 8)``, 4 microbatches) against JAX's (the same rule);
- the layered ``gpt_tiny`` (3 layers, fp32, dropout 0) through the fleet
  recipe at dp 2 x pp 2 x mp 2, plain and with ``recompute_interval=1``
  and ``num_virtual_pipeline_stages=2``: each step's loss (rtol 1e-5)
  and the weights after 2 AdamW steps against the JAX ``PipelineLayer``
  given the knobs, which it takes and never reads, so its one run is
  also the run without them (``test_torch_fleet.py``'s rule: rtol 1e-5,
  atol 1e-5 x the largest reference value; an element whose step-1
  gradients part by more than ``ZERO_REL`` is zero to rounding and held
  to two steps of the rate, at most ``ZERO_SHARE`` of them); the
  replicas bit-equal; weight bytes by position;
- ``fleet.recompute``: outputs and input gradients against the JAX
  ``recompute`` (rtol 1e-6); parameter gradients against the port's run
  without recompute (the reference's eager recompute gives closed-over
  parameters none); at dropout > 0 (the default generator, a tracker
  stream, a layer's own generator) bit-equal with recompute and without;
- the interleaved 1F1B order and Paddle's warm-up bound on
  ``last_peak_inflight``;
- ``SGD``, ``Momentum`` (plain and nesterov), ``LarsMomentum``,
  ``DGCMomentum`` (warm-up, sparsification, residual), ``LocalSGD`` and
  ``GradientMerge`` (a mid-window ``state_dict`` round trip) over 3
  steps against their JAX classes on the same gradients (rtol 1e-5, atol
  1e-7); LARS and DGC on a parameter cut into mp = 2 parts against JAX
  on the whole tensor; the selection pass and its ``ValueError``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as JM
from paddle_tpu.distributed import parallel as jparallel
from paddle_tpu.distributed.fleet import meta_optimizers as jmeta
from paddle_tpu.distributed.fleet.base import topology as jtopo
from paddle_tpu.distributed.fleet.meta_parallel import pipeline_parallel as jpp
from paddle_tpu.distributed.fleet.recompute.recompute import (
    recompute as jax_recompute, recompute_sequential as jax_recompute_seq,
)
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.nn.modules.common import Linear as JaxLinear
from paddle_tpu.nn.modules.norm import LayerNorm as JaxLayerNorm
from paddle_tpu.optimizer import optimizers as jopt

from paddle_tpu_torch.distributed import DataParallel, fleet
from paddle_tpu_torch.distributed import mesh as M
from paddle_tpu_torch.distributed.fleet import meta_optimizers as meta
from paddle_tpu_torch.distributed.fleet.layers.mpu import (
    get_rng_state_tracker, model_parallel_random_seed,
)
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, PipelineLayer, PipelineParallel, schedule,
)
from paddle_tpu_torch.distributed.shards import (
    Part, ShardedParameter, replica_of, sharded_parameters,
    weight_bytes_by_position,
)
from paddle_tpu_torch.models import GPTPretrainingCriterion, gpt_tiny
from paddle_tpu_torch.models.gpt import (
    GPTDecoderLayer, GPTEmbeddings, GPTLMHead,
)
from paddle_tpu_torch.nn.layers import (
    Dropout, LayerNorm, Linear, init_weights, load_jax_state,
)
from paddle_tpu_torch.optimizer import AdamW, Momentum, SGD

torch.set_num_threads(2)

ZERO_REL, ZERO_SHARE = 1e-3, 1e-2
GPT_CFG = dict(use_tensor_parallel=True, num_layers=3, hidden_dropout=0.0,
               attention_dropout=0.0)
GPT_LR, GPT_STEPS, GPT_BATCH, GPT_SEQ = 1e-3, 2, 8, 16
PIPE = {"accumulate_steps": 4, "micro_batch_size": 2}
HYBRID = {"dp_degree": 2, "pp_degree": 2, "mp_degree": 2}


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


def _np(t):
    return np.asarray(t.numpy(), np.float32)


def _close(got, want, what="", rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _replicas_equal(module):
    """Every replica copy equals its replica-0 source, bit for bit."""
    n = 0
    for p in module.parameters():
        src = replica_of(p)
        if src is not None:
            assert torch.equal(p, src)
            n += 1
    return n


def _strategy(cls, hybrid=None, **flags):
    st = cls()
    st.hybrid_configs = dict(hybrid or HYBRID,
                             order=["dp", "pp", "sharding", "sep", "mp"])
    st.pipeline_configs = dict(PIPE)
    for k, v in flags.items():
        setattr(st, k, v)
    return st


# ---------------------------------------------------------------------------
# fault 8: gradient_merge was ignored
# ---------------------------------------------------------------------------

def _mlp_data(steps):
    rng = np.random.RandomState(8)
    return [(rng.randn(6, 8).astype(np.float32),
             rng.randn(6, 8).astype(np.float32)) for _ in range(steps)]


def test_distributed_optimizer_applies_gradient_merge():
    """Fault 8: with ``gradient_merge`` k 2 the optimizer steps once every
    two calls on the mean of their gradients, as the JAX package's
    ``GradientMerge`` does; the bare ``AdamW`` (the optimizer the port
    returned) steps on every call and parts from JAX after step 1."""
    data = _mlp_data(4)
    flags = dict(gradient_merge=True,
                 gradient_merge_configs={"k_steps": 2, "avg": True})
    with _JaxState():
        pt.seed(3)
        jl = JaxLinear(8, 8)
        state = {k: _np(v) for k, v in jl.state_dict().items()}
        jo = jfleet.distributed_optimizer(pt.optimizer.AdamW(
            learning_rate=0.1, parameters=jl.parameters()),
            strategy=_strategy(jfleet.DistributedStrategy, **flags))
        want = []
        for x, y in data:
            pt.ops.mean((jl(pt.to_tensor(x)) - pt.to_tensor(y)) ** 2
                        ).backward()
            jo.step()
            jo.clear_grad()
            want.append({k: _np(v) for k, v in jl.state_dict().items()})
    layer = Linear(8, 8, device="cpu")
    load_jax_state(layer, state)
    opt = fleet.distributed_optimizer(
        AdamW(0.1, parameters=layer.parameters()),
        strategy=_strategy(fleet.DistributedStrategy, **flags))
    assert isinstance(opt, meta.GradientMerge)
    for i, (x, y) in enumerate(data):
        ((layer(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean(
            ).backward()
        opt.step()
        opt.clear_grad()
        for k, v in layer.state_dict().items():
            _close(v.numpy(), want[i][k], f"step {i + 1} {k}")


# ---------------------------------------------------------------------------
# DataParallel
# ---------------------------------------------------------------------------

def _mlp_jax():
    return pt.nn.Sequential(JaxLinear(8, 16), JaxLinear(16, 4))


def _mlp_port():
    return torch.nn.Sequential(Linear(8, 16, device="cpu"),
                               Linear(16, 4, device="cpu"))


def test_data_parallel_matches_jax(mesh):
    rng = np.random.RandomState(4)
    batches = [(rng.randn(8, 8).astype(np.float32),
                rng.randn(8, 4).astype(np.float32)) for _ in range(2)]
    with _JaxState():
        JM.set_mesh(JM.build_mesh({"dp": 2}))
        pt.seed(4)
        jm = _mlp_jax()
        state = {k: _np(v) for k, v in jm.state_dict().items()}
        jdp = jparallel.DataParallel(jm)
        jo = pt.optimizer.AdamW(learning_rate=0.01,
                                parameters=jm.parameters())
        want_losses = []
        for x, y in batches:
            loss = pt.ops.mean((jdp(pt.to_tensor(x)) - pt.to_tensor(y)) ** 2)
            jdp.scale_loss(loss).backward()
            jdp.apply_collective_grads()
            jo.step()
            jo.clear_grad()
            want_losses.append(float(loss))
        want = {k: _np(v) for k, v in jm.state_dict().items()}
    mesh({"dp": 2})
    model = _mlp_port()
    dp = DataParallel(model)
    dp.set_state_dict(state)
    assert dp.num_replicas == 2 and _replicas_equal(dp) == 4
    opt = AdamW(0.01, parameters=dp.parameters())
    losses = []
    for x, y in batches:
        out = dp(torch.from_numpy(x))
        assert tuple(out.shape) == (8, 4)
        loss = ((out - torch.from_numpy(y)) ** 2).mean()
        dp.scale_loss(loss).backward()
        dp.apply_collective_grads()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    _close(losses, want_losses, "losses", rtol=1e-6, atol=0)
    assert list(dp.state_dict()) == list(state)
    for k, v in dp.state_dict().items():
        _close(v.numpy(), want[k], k)
    assert _replicas_equal(dp) == 4
    # the optimizer state holds one entry a logical tensor
    assert sorted(k for k in opt.state_dict() if k.startswith("moment1")) \
        == [f"moment1_{i}" for i in range(4)]
    with pytest.raises(ValueError, match="dp=2"):
        dp(torch.zeros(3, 8))


def test_fleet_distributed_model_data_mode(mesh):
    """dp > 1 alone gives ``DataParallel``; so does sharding > 1, over the
    dp x sharding replicas (ZeRO's data axis); sep, refused until
    sequence parallelism was ported, is read by no wrapper, as in the
    reference: the module itself, its output unchanged."""
    st = _strategy(fleet.DistributedStrategy,
                   {"dp_degree": 2, "pp_degree": 1, "mp_degree": 1})
    mesh({"dp": 2})
    fleet.init(is_collective=True, strategy=st)
    assert isinstance(fleet.distributed_model(_mlp_port()), DataParallel)
    st = _strategy(fleet.DistributedStrategy,
                   {"dp_degree": 2, "sharding_degree": 2})
    mesh({"dp": 2, "sharding": 2})
    fleet.init(is_collective=True, strategy=st)
    dp = fleet.distributed_model(_mlp_port())
    assert isinstance(dp, DataParallel) and dp.num_replicas == 4
    st = _strategy(fleet.DistributedStrategy, {"sep_degree": 2})
    mesh({"sep": 2})
    fleet.init(is_collective=True, strategy=st)
    mlp = _mlp_port()
    with torch.no_grad():
        for p in mlp.parameters():
            p.copy_(torch.linspace(-1.0, 1.0, p.numel()).view_as(p))
    x = torch.from_numpy(np.random.RandomState(3).randn(4, 8)
                         .astype(np.float32))
    want = mlp(x)
    model = fleet.distributed_model(mlp)
    assert model is mlp
    assert torch.equal(model(x), want)


# ---------------------------------------------------------------------------
# the toy pipeline at dp 2 x pp 2
# ---------------------------------------------------------------------------

class _Pipe:
    pipeline_configs = dict(PIPE)


def _toy_batch():
    rng = np.random.RandomState(0)
    return (rng.randn(8, 8).astype(np.float32),
            rng.randn(8, 8).astype(np.float32))


def test_toy_pipeline_dp2_matches_jax(mesh):
    xb, yb = _toy_batch()
    with _JaxState():
        jfleet.init(is_collective=True, strategy=_strategy(
            jfleet.DistributedStrategy,
            {"dp_degree": 2, "pp_degree": 2, "mp_degree": 1}))
        pt.seed(7)
        jl = jpp.PipelineLayer(
            [jpp.LayerDesc(JaxLinear, 8, 8) for _ in range(4)],
            num_stages=2, loss_fn=lambda o, y: pt.ops.mean((o - y) ** 2))
        state = {k: _np(v) for k, v in jl.state_dict().items()}
        loss = jfleet.distributed_model(jl).train_batch(
            (pt.to_tensor(xb), pt.to_tensor(yb)), pt.optimizer.AdamW(
                learning_rate=0.1, parameters=jl.parameters()))
        after = {k: _np(v) for k, v in jl.state_dict().items()}
    mesh({"dp": 2, "pp": 2})
    pl = PipelineLayer([LayerDesc(Linear, 8, 8, device="cpu")
                        for _ in range(4)], num_stages=2,
                       loss_fn=lambda o, y: ((o - y) ** 2).mean())
    pl.load_jax_state(state)
    assert pl.num_replicas == 2 and _replicas_equal(pl) == 8
    assert sorted(weight_bytes_by_position(pl)) == [
        (r, s, 0) for r in range(2) for s in range(2)]
    pp = PipelineParallel(pl, strategy=_Pipe())
    got = pp.train_batch((torch.from_numpy(xb), torch.from_numpy(yb)),
                         AdamW(0.1, parameters=pl.parameters()))
    _close(float(got), float(loss), "loss", rtol=1e-6, atol=0)
    assert set(pl.state_dict()) == set(after)
    for k, v in pl.state_dict().items():
        _close(v.numpy(), after[k], k)
    assert _replicas_equal(pl) == 8 and pp.last_peak_inflight == 2
    with pytest.raises(ValueError, match="dp=2"):
        pp.train_batch((torch.zeros(4, 8), torch.zeros(4, 8)),
                       AdamW(0.1, parameters=pl.parameters()))


# ---------------------------------------------------------------------------
# GPT through the fleet recipe at dp 2 x pp 2 x mp 2
# ---------------------------------------------------------------------------

# (recompute_interval, num_virtual_pipeline_stages)
KNOBS = [(0, None), (1, 2)]
JAX_KNOBS = KNOBS[1]


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
    def __init__(self, emb):
        super().__init__()
        self._emb = emb

    def forward(self, h):
        return pt.ops.matmul(h, self._emb.word_embeddings.weight,
                             transpose_y=True)


@pytest.fixture(scope="module")
def fleet_jax():
    """The JAX recipe at dp 2 x pp 2 x mp 2 given ``JAX_KNOBS`` (which the
    JAX ``PipelineLayer`` does not read): its weights (biases and
    LayerNorm gains moved off 0/1), step 1's gradients, each step's loss
    and the weights after ``GPT_STEPS`` AdamW steps."""
    import jax

    interval, virtual = JAX_KNOBS
    cfg = jgpt.gpt_tiny(**GPT_CFG)
    with _JaxState():
        jfleet.init(is_collective=True,
                    strategy=_strategy(jfleet.DistributedStrategy))
        pt.seed(0)
        emb = jgpt.GPTEmbeddings(cfg)
        crit = jgpt.GPTPretrainingCriterion(cfg)
        descs = [emb] + [jgpt.GPTDecoderLayer(cfg)
                         for _ in range(cfg.num_layers)]
        descs += [JaxLayerNorm(cfg.hidden_size), _JaxHead(emb)]
        pl = jpp.PipelineLayer(descs, num_stages=2,
                               loss_fn=lambda lg, lb: crit(lg, lb),
                               recompute_interval=interval,
                               num_virtual_pipeline_stages=virtual)
        rng = np.random.RandomState(0)
        state = {}
        for k, p in pl.named_parameters():
            a = _np(p)
            if a.ndim == 1:
                a = a + 0.1 * rng.randn(*a.shape).astype(np.float32)
                where = p._value.sharding
                p._set_value(jax.device_put(a, where)
                             if len(where.device_set) > 1
                             else jax.numpy.asarray(a))
            state[k] = a
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
    return dict(state=state, grads=grads, losses=losses, after=after)


def _fleet_port(state, interval, virtual, dropout=0.0):
    cfg = gpt_tiny(**dict(GPT_CFG, hidden_dropout=dropout))
    fleet.init(is_collective=True,
               strategy=_strategy(fleet.DistributedStrategy))
    emb = GPTEmbeddings(cfg)
    descs = [emb] + [GPTDecoderLayer(cfg) for _ in range(cfg.num_layers)]
    descs += [LayerNorm(cfg.hidden_size, cfg.layer_norm_eps), GPTLMHead(emb)]
    pl = PipelineLayer(descs, num_stages=2,
                       loss_fn=GPTPretrainingCriterion(cfg),
                       recompute_interval=interval,
                       num_virtual_pipeline_stages=virtual)
    if state is None:
        init_weights(pl, 0, cfg.initializer_range)
    else:
        pl.load_jax_state(state)
    return pl


def _gathered_grads(module):
    out = {k: sp.gather([p.grad for p in sp]).numpy()
           for k, sp in sharded_parameters(module).items()}
    out.update({k: p.grad.numpy() for k, p in module.named_parameters()
                if not hasattr(p, "shard") and replica_of(p) is None})
    return out


def _train(pl, opt_of, batches):
    model = fleet.distributed_model(pl)
    assert isinstance(model, PipelineParallel)
    opt = _Capture(fleet.distributed_optimizer(opt_of(pl)),
                   lambda: _gathered_grads(pl))
    losses = []
    for ids, labels in batches:
        losses.append(float(model.train_batch(
            (torch.from_numpy(ids), torch.from_numpy(labels)), opt)))
        if len(losses) == 1:
            grads = opt.grads
    return model, losses, grads


def _adamw(pl):
    return AdamW(GPT_LR, parameters=pl.parameters(), multi_precision=False)


@pytest.mark.parametrize("knobs", KNOBS, ids=["plain", "rc1_v2"])
def test_fleet_gpt_dp2_pp2_mp2_matches_jax(fleet_jax, mesh, knobs):
    interval, virtual = knobs
    mesh({"dp": 2, "pp": 2, "mp": 2})
    pl = _fleet_port(fleet_jax["state"], interval, virtual)
    assert pl.num_replicas == 2 and pl.num_chunks == 2 * (virtual or 1)
    # every replica's copy is a parameter: AdamW steps each, once
    params = list(pl.parameters())
    assert len(params) == 2 * len([p for p in params
                                   if replica_of(p) is None])
    model, losses, grads = _train(pl, _adamw, _gpt_batches())
    # Paddle's warm-up bound: S - 1 forwards (plain), 2 (S - 1) + (V - 1)
    # S interleaved, then one more before the first backward
    S, V = 2, virtual or 1
    bound = (S - 1 if V == 1 else 2 * (S - 1) + (V - 1) * S) + 1
    assert model.last_peak_inflight == bound
    np.testing.assert_allclose(losses, fleet_jax["losses"], rtol=1e-5)
    assert set(grads) == set(fleet_jax["grads"])
    for k, g in fleet_jax["grads"].items():
        _close(grads[k], g, "step 1 gradient of " + k, rtol=1e-5,
               atol=1e-5 * np.abs(g).max())
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
    assert _replicas_equal(pl) == len(params) // 2
    by_pos = weight_bytes_by_position(pl)
    assert sorted(by_pos) == [(r, s, i) for r in range(2) for s in range(2)
                              for i in range(2)]
    for s in range(2):
        for i in range(2):
            assert by_pos[(0, s, i)] == by_pos[(1, s, i)]


def test_fleet_pipeline_recompute_and_virtual_equal_the_plain_run(mesh):
    """The JAX ``PipelineLayer`` takes both knobs and reads neither; the
    port's losses and weights with them equal its own plain run: bit for
    bit with recompute alone at dropout 0.1 (the recompute redraws the
    forward's masks); with virtual stages the tied table sums its two
    uses' gradients in another order, so the losses and step-1 gradients
    agree to rtol 1e-6 and the weights to 1e-6 (the key third of the QKV
    bias has a zero gradient in exact arithmetic, which AdamW divides by
    its own size: rounding moves it by ~2e-7 here)."""
    batches = _gpt_batches()
    runs = {}
    for knobs, dropout in (((0, None), 0.0), ((0, None), 0.1),
                           ((1, None), 0.1), ((1, 2), 0.0)):
        mesh({"dp": 2, "pp": 2, "mp": 2})
        torch.manual_seed(5)
        pl = _fleet_port(None, *knobs, dropout=dropout)
        _, losses, grads = _train(pl, _adamw, batches)
        runs[knobs + (dropout,)] = (losses, pl.state_dict(), grads)
    plain, rc = runs[(0, None, 0.1)], runs[(1, None, 0.1)]
    assert plain[0] == rc[0]
    for k, v in plain[1].items():
        assert torch.equal(v, rc[1][k]), k
    assert runs[(0, None, 0.1)][0] != runs[(0, None, 0.0)][0]
    plain, inter = runs[(0, None, 0.0)], runs[(1, 2, 0.0)]
    np.testing.assert_allclose(inter[0], plain[0], rtol=1e-6)
    for k, g in plain[2].items():
        _close(inter[2][k], g, "step 1 gradient of " + k, rtol=1e-6,
               atol=1e-6 * np.abs(g).max())
    for k, v in plain[1].items():
        _close(inter[1][k].numpy(), v.numpy(), k, rtol=1e-6, atol=1e-6)


def test_interleaved_schedule_is_paddles():
    """Paddle's order: warm-up forwards, then one forward and one
    backward, then the rest; units in groups of S microbatches, round by
    round (the backwards' rounds reversed); every unit's forward comes
    after its previous round's and its backward after its next round's;
    the units in flight peak at Paddle's warm-up + 1."""
    assert schedule(4, 2) == [("F", 0, 0), ("F", 1, 0), ("B", 0, 0),
                              ("F", 2, 0), ("B", 1, 0), ("F", 3, 0),
                              ("B", 2, 0), ("B", 3, 0)]
    assert schedule(4, 2, 2)[:7] == [
        ("F", 0, 0), ("F", 1, 0), ("F", 0, 1), ("F", 1, 1), ("F", 2, 0),
        ("B", 0, 1), ("F", 3, 0)]
    for M_, S, V in ((4, 2, 2), (8, 2, 2), (4, 4, 2), (6, 3, 3), (2, 2, 2)):
        order = schedule(M_, S, V)
        done, live, peak = set(), set(), 0
        for op, j, v in order:
            if op == "F":
                assert v == 0 or ("F", j, v - 1) in done
                live.add((j, v))
            else:
                assert ("F", j, v) in done
                assert v == V - 1 or ("B", j, v + 1) in done
                live.remove((j, v))
            done.add((op, j, v))
            peak = max(peak, len(live))
        assert len(done) == 2 * M_ * V and not live
        warm = M_ * V if M_ == S else min(2 * (S - 1) + (V - 1) * S, M_ * V)
        assert peak == min(warm + 1, M_ * V), (M_, S, V)
    with pytest.raises(ValueError, match="divisible"):
        schedule(3, 2, 2)


# ---------------------------------------------------------------------------
# fleet.recompute
# ---------------------------------------------------------------------------

def _block_pair(seed=2):
    """A JAX two-layer block and the port's with the same weights."""
    with _JaxState():
        pt.seed(seed)
        jl1, jl2 = JaxLinear(8, 16), JaxLinear(16, 8)
        states = [{k: _np(v) for k, v in m.state_dict().items()}
                  for m in (jl1, jl2)]
    l1, l2 = Linear(8, 16, device="cpu"), Linear(16, 8, device="cpu")
    load_jax_state(l1, states[0])
    load_jax_state(l2, states[1])
    return (jl1, jl2), (l1, l2)


def test_recompute_matches_jax():
    (jl1, jl2), (l1, l2) = _block_pair()
    x = np.random.RandomState(3).randn(4, 8).astype(np.float32)
    with _JaxState():
        xt = pt.to_tensor(x, stop_gradient=False)
        out = jax_recompute(lambda h: jl2(pt.nn.functional.gelu(jl1(h))), xt)
        pt.ops.sum(out * out).backward()
        want_out, want_dx = _np(out), _np(xt.grad)
        xs = pt.to_tensor(x, stop_gradient=False)
        seq = jax_recompute_seq({"segments": 2}, [jl1, jl2], xs)
        pt.ops.sum(seq).backward()
        want_seq, want_seq_dx = _np(seq), _np(xs.grad)

    def fn(h):
        return l2(torch.nn.functional.gelu(l1(h)))

    grads = {}
    for rc in (True, False):
        for p in (*l1.parameters(), *l2.parameters()):
            p.grad = None
        xt = torch.tensor(x, requires_grad=True)
        out = fleet.recompute(fn, xt) if rc else fn(xt)
        (out * out).sum().backward()
        if rc:
            _close(out.detach().numpy(), want_out, "out", rtol=1e-6)
            _close(xt.grad.numpy(), want_dx, "dx", rtol=1e-6)
        grads[rc] = [p.grad.clone() for p in (*l1.parameters(),
                                              *l2.parameters())]
    # the reference's eager recompute leaves closed-over parameters without
    # a gradient; the port gives the run without recompute's
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)
    xs = torch.tensor(x, requires_grad=True)
    seq = fleet.recompute_sequential({"segments": 2}, [l1, l2], xs)
    seq.sum().backward()
    _close(seq.detach().numpy(), want_seq, "sequential", rtol=1e-6)
    _close(xs.grad.numpy(), want_seq_dx, "sequential dx", rtol=1e-6)
    # no tensor needs a gradient: a plain call
    with torch.no_grad():
        assert fleet.recompute(fn, torch.zeros(2, 8)).grad_fn is None


class _Noisy(torch.nn.Module):
    """Dropout from the default generator, from a tracker stream and from
    a layer's own generator."""

    def __init__(self, lin):
        super().__init__()
        self.lin = lin
        self.own = Dropout(0.3, generator=torch.Generator().manual_seed(9))

    def forward(self, h):
        h = torch.nn.functional.dropout(self.lin(h), 0.3)
        with get_rng_state_tracker().rng_state():
            h = torch.nn.functional.dropout(h, 0.3)
        return self.own(h)


def test_recompute_at_dropout_is_bit_equal():
    """Each random stream draws the same masks in the recompute as in the
    forward, and goes on afterwards as if the recompute drew nothing."""
    _, (l1, _) = _block_pair()
    x = np.random.RandomState(5).randn(16, 8).astype(np.float32)
    got = {}
    for rc in (True, False):
        model_parallel_random_seed(21)
        module = _Noisy(l1)
        l1.weight.grad = l1.bias.grad = None
        outs = []
        for _ in range(2):
            xt = torch.tensor(x, requires_grad=True)
            out = fleet.recompute(module, xt) if rc else module(xt)
            (out * out).sum().backward()
            outs.append((out.detach(), xt.grad))
        with get_rng_state_tracker().rng_state():
            tail = [torch.rand(4)]
        tail += [torch.rand(4), module.own.generator.initial_seed()]
        got[rc] = (outs, l1.weight.grad.clone(), tail)
    (o1, w1, t1), (o2, w2, t2) = got[True], got[False]
    assert torch.equal(w1, w2) and not torch.equal(o1[0][0], o1[1][0])
    for (a, da), (b, db) in zip(o1, o2):
        assert torch.equal(a, b) and torch.equal(da, db)
    assert torch.equal(t1[0], t2[0]) and torch.equal(t1[1], t2[1])


# ---------------------------------------------------------------------------
# SGD, Momentum and the meta-optimizers against their JAX classes
# ---------------------------------------------------------------------------

SHAPES = {"weight": (16, 8), "bias": (8,), "scale": (1,)}


def _opt_case(seed=6, steps=3):
    rng = np.random.RandomState(seed)
    init = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(steps)]
    return init, grads


def _run_jax(make, steps_grads, init, wrap=None):
    """JAX parameters from ``init`` (named by their keys), ``make(params)``
    (and ``wrap`` around it), the steps on ``steps_grads``: the weights
    after each step."""
    with _JaxState():
        params = []
        for k, v in init.items():
            p = pt.to_tensor(v, stop_gradient=False)
            p.name = k
            params.append(p)
        opt = make(params)
        opt = wrap(opt) if wrap else opt
        out = []
        for grads in steps_grads:
            for p in params:
                p.grad = pt.to_tensor(grads[p.name])
            opt.step()
            opt.clear_grad()
            out.append({p.name: _np(p) for p in params})
    return out


def _port_params(init):
    return [(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
            for k, v in init.items()]


def _run_port(opt, named, steps_grads, check=None):
    out = []
    for i, grads in enumerate(steps_grads):
        for k, p in named:
            p.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        opt.clear_grad()
        out.append({k: p.detach().numpy().copy() for k, p in named})
        if check:
            check(i)
    return out


def _same(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            _close(g[k], w[k], f"step {i + 1} {k}", rtol=1e-5, atol=1e-7)


OPTIMIZERS = {
    "sgd": (lambda ps: jopt.SGD(0.1, parameters=ps, weight_decay=0.01),
            lambda ps: SGD(0.1, parameters=ps, weight_decay=0.01)),
    "momentum": (
        lambda ps: jopt.Momentum(0.1, 0.9, parameters=ps, weight_decay=0.01),
        lambda ps: Momentum(0.1, 0.9, parameters=ps, weight_decay=0.01)),
    "nesterov": (
        lambda ps: jopt.Momentum(0.1, 0.8, parameters=ps, use_nesterov=True),
        lambda ps: Momentum(0.1, 0.8, parameters=ps, use_nesterov=True)),
    "lars": (
        lambda ps: jmeta.LarsMomentum(
            0.5, 0.9, parameters=ps, lars_coeff=0.01,
            exclude_from_weight_decay=["bias"]),
        lambda ps: meta.LarsMomentum(
            0.5, 0.9, parameters=ps, lars_coeff=0.01,
            exclude_from_weight_decay=["bias"])),
    "dgc": (
        lambda ps: jmeta.DGCMomentum(0.1, 0.9, parameters=ps,
                                     rampup_begin_step=1, sparsity=0.75),
        lambda ps: meta.DGCMomentum(0.1, 0.9, parameters=ps,
                                    rampup_begin_step=1, sparsity=0.75)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax(name):
    init, grads = _opt_case()
    make_jax, make_port = OPTIMIZERS[name]
    want = _run_jax(make_jax, grads, init)
    named = _port_params(init)
    opt = make_port(named)
    _same(_run_port(opt, named, grads), want)
    if name == "dgc":
        # after the warm-up step, three quarters of the weight's
        # accumulated values stay behind as the residual
        v = opt.state[named[0][1]]["v"]
        assert 0.6 < float((v != 0).float().mean()) < 0.9


def test_sgd_refuses_a_regularizer_object():
    with pytest.raises(NotImplementedError, match="item 10"):
        SGD(0.1, parameters=[torch.nn.Parameter(torch.zeros(2))],
            weight_decay=object())


def _momentum_pair(lr=0.1):
    return (lambda ps: jopt.Momentum(lr, 0.9, parameters=ps),
            lambda ps: Momentum(lr, 0.9, parameters=ps))


def test_local_sgd_matches_jax_and_keeps_replicas_equal(mesh):
    init, grads = _opt_case()
    make_jax, make_port = _momentum_pair()
    want = _run_jax(make_jax, grads, init,
                    wrap=lambda o: jmeta.LocalSGD(o, k_steps=2))
    named = _port_params(init)
    _same(_run_port(meta.LocalSGD(make_port(named), k_steps=2), named,
                    grads), want)
    # over a DataParallel's replicas: averaged every 2 steps, still equal
    mesh({"dp": 2})
    model = _mlp_port()
    init_weights(model, 0)
    dp = DataParallel(model)
    opt = fleet.distributed_optimizer(
        AdamW(0.01, parameters=dp.parameters()),
        strategy=_strategy(fleet.DistributedStrategy, localsgd=True,
                           localsgd_configs={"k_steps": 2}))
    assert isinstance(opt, meta.LocalSGD)
    x = torch.from_numpy(np.random.RandomState(2).randn(8, 8).astype(
        np.float32))
    for _ in range(3):
        dp(x).square().mean().backward()
        opt.step()
        opt.clear_grad()
        assert _replicas_equal(dp) == 4


def test_gradient_merge_matches_jax_and_resumes_mid_window():
    init, grads = _opt_case(steps=4)
    make_jax, make_port = _momentum_pair()
    want = _run_jax(make_jax, grads, init,
                    wrap=lambda o: jmeta.GradientMerge(o, k_steps=2))
    with _JaxState():
        params = [pt.to_tensor(v, stop_gradient=False)
                  for v in init.values()]
        jo = jmeta.GradientMerge(jopt.Momentum(0.1, 0.9, parameters=params),
                                 k_steps=2)
        for p, k in zip(params, init):
            p.grad = pt.to_tensor(grads[0][k])
        jo.step()
        want_sd = jo.state_dict()["gradient_merge"]
    named = _port_params(init)
    opt = meta.GradientMerge(make_port(named), k_steps=2)
    got = _run_port(opt, named, grads[:1])
    sd = opt.state_dict()
    assert int(sd["gradient_merge"]["step"]) == int(want_sd["step"]) == 1
    for a, b in zip(sd["gradient_merge"]["acc"], want_sd["acc"]):
        _close(a, np.asarray(b), "acc")
    # a new optimizer over the same parameters resumes mid-window
    resumed = meta.GradientMerge(make_port(named), k_steps=2)
    resumed.set_state_dict(sd)
    got += _run_port(resumed, named, grads[1:])
    _same(got, want)
    # the weights moved only at steps 2 and 4
    assert np.array_equal(got[0]["weight"], init["weight"])
    assert np.array_equal(got[1]["weight"], got[2]["weight"])


def _cut(init, mp=2):
    """``weight`` as a ShardedParameter of ``mp`` row parts on the CPU."""
    sp = ShardedParameter(SHAPES["weight"], torch.float32, [
        Part((0, 0, i), torch.device("cpu"),
             ((0, torch.arange(i * 8 // mp * 2, (i + 1) * 8 // mp * 2)),))
        for i in range(mp)])
    sp.load_whole(torch.from_numpy(init["weight"]))
    return sp


@pytest.mark.parametrize("name", ["lars", "dgc"])
def test_lars_and_dgc_on_parts_equal_the_whole_tensor(name):
    """A weight cut into two row parts: the norms (LARS) and the threshold
    (DGC) are the whole tensor's, so the update is JAX's on the whole."""
    init, grads = _opt_case()
    init = {"weight": init["weight"]}
    grads = [{"weight": g["weight"]} for g in grads]
    make_jax, make_port = OPTIMIZERS[name]
    want = _run_jax(make_jax, grads, init)
    sp = _cut(init)
    opt = make_port([("weight", p) for p in sp])
    for i, g in enumerate(grads):
        for p, c in zip(sp, sp.cut_whole(torch.from_numpy(g["weight"]))):
            p.grad = c
        opt.step()
        opt.clear_grad()
        _close(sp.gather().numpy(), want[i]["weight"], f"step {i + 1}",
               rtol=1e-5, atol=1e-7)


def test_percentile_is_jnp_percentile():
    """The same order statistics and interpolation weights: XLA may fold
    ``q / 100`` into a product by the reciprocal, which moves the
    position by an ulp, so the value is held to 1e-4 of the gap between
    the two order statistics."""
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    for n, q in ((1000, 99.9), (37, 75.0), (4096, 0.5), (5, 50.0)):
        a = np.abs(rng.randn(n)).astype(np.float32)
        parts = [torch.from_numpy(a[: n // 3]), torch.from_numpy(a[n // 3:])]
        s = np.sort(a)
        pos = q / 100 * (n - 1)
        gap = s[int(np.ceil(pos))] - s[int(np.floor(pos))]
        got = float(meta.percentile(parts, q))
        want = float(jnp.percentile(jnp.asarray(a), q))
        assert abs(got - want) <= 1e-4 * gap + 1e-6 * want, (n, q)


@pytest.mark.parametrize("flags,want", [
    (dict(lars=True), "LarsMomentum"),
    (dict(dgc=True), "DGCMomentum"),
    (dict(lars=True, dgc=True), "LarsMomentum"),
    (dict(localsgd=True), "LocalSGD"),
    (dict(gradient_merge=True, gradient_merge_configs={"k_steps": 2}),
     "GradientMerge"),
    (dict(gradient_merge=True, gradient_merge_configs={"k_steps": 1}),
     "Momentum"),
    (dict(localsgd=True, gradient_merge=True), "LocalSGD"),
    ({}, "Momentum"),
])
def test_selection_pass_matches_jax(flags, want):
    with _JaxState():
        p = pt.to_tensor(np.zeros(4, np.float32), stop_gradient=False)
        st = _strategy(jfleet.DistributedStrategy, **flags)
        ref = jmeta.apply_strategy_meta_optimizers(
            jopt.Momentum(0.1, parameters=[p]), st)
    got = meta.apply_strategy_meta_optimizers(
        Momentum(0.1, parameters=[torch.nn.Parameter(torch.zeros(4))]),
        _strategy(fleet.DistributedStrategy, **flags))
    assert type(got).__name__ == type(ref).__name__ == want


@pytest.mark.parametrize("flag", ["lars", "dgc"])
def test_lars_and_dgc_refuse_adamw_as_jax_does(flag):
    with _JaxState():
        p = pt.to_tensor(np.zeros(4, np.float32), stop_gradient=False)
        with pytest.raises(ValueError, match="momentum-family"):
            jmeta.apply_strategy_meta_optimizers(
                pt.optimizer.AdamW(parameters=[p]),
                _strategy(jfleet.DistributedStrategy, **{flag: True}))
    with pytest.raises(ValueError, match="momentum-family"):
        fleet.distributed_optimizer(
            AdamW(parameters=[torch.nn.Parameter(torch.zeros(4))]),
            strategy=_strategy(fleet.DistributedStrategy, **{flag: True}))
