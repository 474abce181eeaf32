"""ZeRO (``paddle_tpu_torch.distributed.sharding.group_sharded_parallel``)
held against the JAX package on the CPU.

One process of the port drives every mesh position (``["cpu"] * n``);
the JAX side runs on the 8-device CPU mesh of ``tests/conftest.py``.
Inputs come from numpy seeds.

- ``tests/test_group_sharded.py``'s cases on the port's positions:
  ``Sequential(Linear(16, 32), GELU, Linear(32, 16))`` with AdamW on
  ``{"dp": 2, "sharding": 4}``: ``os`` slices the moments (and state made
  after the call) and leaves parameters and gradients whole, ``os_g``
  slices the gradients, ``p_g_os`` the parameters; 3 steps' losses at
  each level against the JAX run at that level (rtol 1e-5), and every
  level bit-equal to the port without ZeRO; the dp fallback; the
  ``ValueError``; the unchanged triple without a ZeRO axis; ``p_g_os``
  holding at most half of ``os``'s parameter and state bytes a position
  on ``4 x Linear(512, 512)`` with SGD (the counterpart of
  ``test_zero3_reduces_compiled_residency``).
- The fleet recipe: ``gpt_tiny`` (3 layers, fp32, dropout 0) at pp 2 x
  sharding 2 x mp 2, without ZeRO, at each level, and at ``p_g_os`` with
  ``recompute_interval=1`` (the tied head reads the gathered table),
  against the JAX recipe with ``group_sharded_parallel`` at ``p_g_os``:
  losses (rtol 1e-5), step-1 gradients and the weights after 2 steps by
  the rule of ``test_fleet_gpt_dp2_pp2_mp2_matches_jax``; every run
  bit-equal to the port's run without ZeRO; the state bytes by position
  at each level.
- The stacked GPT (2 layers) at ``{"dp": 2, "sharding": 2, "mp": 2}``
  without ZeRO and at ``p_g_os`` against the JAX model at ``p_g_os`` on
  its mesh (losses rtol 1e-5, weights after 3 AdamW steps rtol 1e-5 with
  atol 1e-5 x the largest value), bit-equal to each other.
- Against the port's own run without ZeRO, at ``os_g`` on a
  ``DataParallel`` MLP over ``{"dp": 2, "sharding": 2}``: the
  global-norm clip, ``GradScaler`` (a step with an inf in one slice
  leaves every position bit-unchanged), ``GradientMerge`` k 2 with a
  mid-window ``state_dict`` round trip, LARS and DGC (weights to 1e-6
  relative).
- At ``p_g_os`` no copy keeps storage after the forward or after the
  backward (storages counted); ``save_group_sharded_model`` writes whole
  state dicts that load into an unsharded model and optimizer bit-equal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as JM
from paddle_tpu.distributed.fleet.base import topology as jtopo
from paddle_tpu.distributed.fleet.meta_parallel import pipeline_parallel as jpp
from paddle_tpu.distributed.sharding import (
    group_sharded_parallel as jax_group_sharded,
)
from paddle_tpu.models import GPTStackedForPretraining as JaxGPT
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.nn.modules.norm import LayerNorm as JaxLayerNorm

from paddle_tpu_torch import amp
from paddle_tpu_torch.distributed import DataParallel, fleet
from paddle_tpu_torch.distributed import mesh as M
from paddle_tpu_torch.distributed.fleet import meta_optimizers as meta
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    PipelineLayer, PipelineParallel,
)
from paddle_tpu_torch.distributed.sharding import (
    gathered_grads, group_sharded_parallel, save_group_sharded_model,
)
from paddle_tpu_torch.distributed.shards import (
    slice_info, state_bytes_by_position,
)
from paddle_tpu_torch.models import (
    GPTPretrainingCriterion, GPTStackedForPretraining, gpt_tiny,
)
from paddle_tpu_torch.models.gpt import (
    GPTDecoderLayer, GPTEmbeddings, GPTLMHead, train_mesh,
)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn.layers import LayerNorm, Linear, load_jax_state
from paddle_tpu_torch.optimizer import AdamW, FusedTrainStep, SGD

torch.set_num_threads(2)

LEVELS = ("os", "os_g", "p_g_os")
ZERO_AXES = {"dp": 2, "sharding": 4}


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


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))


def _bit_equal(a, b, what=""):
    assert set(a) == set(b), what
    for k, v in a.items():
        if isinstance(v, dict):
            _bit_equal(v, b[k], f"{what} {k}")
        else:
            assert torch.equal(_tensor(v), _tensor(b[k])), f"{what} {k}"


def _bit_equal_bool(a, b) -> bool:
    try:
        _bit_equal(a, b)
    except AssertionError:
        return False
    return True


def _storage_free(t) -> bool:
    return t.untyped_storage().nbytes() == 0


# ---------------------------------------------------------------------------
# tests/test_group_sharded.py's cases
# ---------------------------------------------------------------------------

def _mlp_xy():
    rng = np.random.RandomState(0)
    return (rng.randn(8, 16).astype(np.float32),
            rng.randn(8, 16).astype(np.float32))


@pytest.fixture(scope="module")
def mlp_jax():
    """The JAX ``_build``/``_step`` of ``tests/test_group_sharded.py`` on
    its ``{"dp": 2, "sharding": 4}`` mesh: the initial weights and, at
    each level, 3 steps' losses."""
    x, y = _mlp_xy()
    out = {}
    with _JaxState():
        JM.set_mesh(JM.build_mesh(ZERO_AXES))
        for level in LEVELS:
            pt.seed(3)
            model = pt.nn.Sequential(pt.nn.Linear(16, 32), pt.nn.GELU(),
                                     pt.nn.Linear(32, 16))
            if level == LEVELS[0]:
                out["state"] = {k: _np(v)
                                for k, v in model.state_dict().items()}
            opt = pt.optimizer.AdamW(learning_rate=1e-3,
                                     parameters=model.parameters())
            jax_group_sharded(model, opt, level)
            losses = []
            for _ in range(3):
                loss = pt.ops.mean((model(pt.to_tensor(x))
                                    - pt.to_tensor(y)) ** 2)
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(float(loss))
            out[level] = losses
    return out


def _mlp(state, level=None):
    """The port's counterpart on the global mesh, ``level`` applied."""
    model = torch.nn.Sequential(Linear(16, 32, device="cpu"),
                                torch.nn.GELU(),
                                Linear(32, 16, device="cpu"))
    load_jax_state(model, state)
    opt = AdamW(1e-3, parameters=model.parameters())
    if level is not None:
        got = group_sharded_parallel(model, opt, level)
        assert got[0] is model and got[1] is opt and got[2] is None
    return model, opt


def _mlp_loss(model):
    x, y = (torch.from_numpy(a) for a in _mlp_xy())
    return ((model(x) - y) ** 2).mean()


def _mlp_steps(model, opt, n=3):
    losses = []
    for _ in range(n):
        loss = _mlp_loss(model)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    return losses


def _slices(opt):
    return [p for g in opt.param_groups for p in g["params"]]


def test_os_slices_moments_and_later_state(mesh, mlp_jax):
    """``os``: each of the 4 tensors becomes 4 slices over the sharding
    positions, each with moments of its own; the parameters and the
    gradients stay whole; a ``GradientMerge`` made after the call keeps a
    sliced accumulator."""
    mesh(ZERO_AXES)
    model, opt = _mlp(mlp_jax["state"], "os")
    slices = _slices(opt)
    assert len(slices) == 4 * 4
    params = list(model.parameters())
    for p in params:
        info = [slice_info(s) for s in slices if slice_info(s).owner is p]
        assert [i.position[0] for i in info] == [0, 1, 2, 3]
        assert sum(i.hi - i.lo for i in info) == p.numel()
        assert not _storage_free(p)
    for s in slices:
        st = opt.state[s]
        assert st["moment1"].shape == s.shape == st["moment2"].shape
        assert st["moment1"]._base is None
    _mlp_loss(model).backward()
    assert all(p.grad is not None and p.grad.shape == p.shape
               for p in params)
    gm = meta.GradientMerge(opt, k_steps=2)
    assert set(gm._acc) == {id(s) for s in slices}
    assert all(a.shape == s.shape for s in slices
               for a in [gm._acc[id(s)]])
    gm.step()
    gm.clear_grad()
    assert all(p.grad is None for p in params)


def test_lars_made_after_the_call_steps_the_slices(mesh, mlp_jax):
    """The strategy's selection pass run after ``group_sharded_parallel``
    (LARS over ``Momentum``, the reference's state made later): its
    velocity is sliced with the parameters, and 3 steps at ``os`` give
    the run without ZeRO's weights within 1e-6."""
    from paddle_tpu_torch.optimizer import Momentum

    class _Lars:
        lars = True
        lars_configs = {"lars_coeff": 0.01}

    got = {}
    for level in (None, "os"):
        mesh(ZERO_AXES)
        model = _mlp(mlp_jax["state"])[0]
        opt = Momentum(0.5, parameters=list(model.named_parameters()))
        if level:
            group_sharded_parallel(model, opt, level)
        opt = meta.apply_strategy_meta_optimizers(opt, _Lars())
        assert isinstance(opt, meta.LarsMomentum)
        if level:
            assert all(opt.state[s]["velocity"].shape == s.shape
                       and slice_info(s) is not None for s in _slices(opt))
        _mlp_steps(model, opt)
        got[level] = model.state_dict()
    for k, v in got[None].items():
        _close(got["os"][k].numpy(), v.numpy(), k, rtol=1e-6, atol=1e-7)


def test_os_g_slices_gradients(mesh, mlp_jax):
    """``os_g``: the backward leaves no whole gradient; each slice holds
    its range of the gradient, which gathers to the run without ZeRO's,
    bit for bit."""
    mesh(ZERO_AXES)
    ref, _ = _mlp(mlp_jax["state"])
    _mlp_loss(ref).backward()
    model, opt = _mlp(mlp_jax["state"], "os_g")
    _mlp_loss(model).backward()
    assert all(p.grad is None for p in model.parameters())
    assert all(s.grad is not None and s.grad.shape == s.shape
               for s in _slices(opt))
    got = gathered_grads(model)
    for k, p in ref.named_parameters():
        assert torch.equal(got[k], p.grad), k
    assert all(not _storage_free(p) for p in model.parameters())


def test_p_g_os_slices_parameters(mesh, mlp_jax):
    """``p_g_os``: the parameters keep no storage (each slice holds its
    range), before and after a step; ``state_dict()`` is whole, and
    ``load_state_dict()`` lands in the slices."""
    mesh(ZERO_AXES)
    model, opt = _mlp(mlp_jax["state"], "p_g_os")
    assert all(_storage_free(p) for p in model.parameters())
    assert all(s._base is None for s in _slices(opt))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), mlp_jax["state"][k], k)
    _mlp_steps(model, opt, 1)
    assert all(_storage_free(p) for p in model.parameters())
    stepped = model.state_dict()
    model.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in mlp_jax["state"].items()})
    assert all(_storage_free(p) for p in model.parameters())
    _bit_equal(model.state_dict(), mlp_jax["state"], "loaded")
    assert not _bit_equal_bool(stepped, mlp_jax["state"])
    load_jax_state(model, {k: 2 * v for k, v in mlp_jax["state"].items()})
    assert all(_storage_free(p) for p in model.parameters())
    _bit_equal(model.state_dict(), {k: 2 * v for k, v in
                                    mlp_jax["state"].items()}, "jax state")


@pytest.mark.parametrize("level", LEVELS)
def test_levels_match_jax_and_each_other(mesh, mlp_jax, level):
    """3 steps' losses against the JAX run at the level (rtol 1e-5); the
    losses, weights and optimizer state bit-equal to the port without
    ZeRO on the same mesh."""
    mesh(ZERO_AXES)
    ref, ref_opt = _mlp(mlp_jax["state"])
    want = _mlp_steps(ref, ref_opt)
    model, opt = _mlp(mlp_jax["state"], level)
    losses = _mlp_steps(model, opt)
    np.testing.assert_allclose(losses, mlp_jax[level], rtol=1e-5)
    assert losses == want
    _bit_equal(model.state_dict(), ref.state_dict(), "weights")
    _bit_equal(opt.state_dict(), ref_opt.state_dict(), "optimizer")


def test_dp_fallback(mesh, mlp_jax):
    """Without a sharding axis ZeRO cuts over dp (the reference's default
    group): 8 slices a tensor at ``p_g_os`` (the 16-element bias, under 8
    x 16 bytes, stays one slice on position 0), the losses JAX's."""
    mesh({"dp": 8})
    model, opt = _mlp(mlp_jax["state"], "p_g_os")
    assert len(_slices(opt)) == 3 * 8 + 1
    assert sorted({slice_info(s).position for s in _slices(opt)}) == [
        (j, 0, 0) for j in range(8)]
    np.testing.assert_allclose(_mlp_steps(model, opt), mlp_jax["p_g_os"],
                               rtol=1e-5)


def test_bad_level_and_no_zero_axis(mesh, mlp_jax):
    model, opt = _mlp(mlp_jax["state"])
    with pytest.raises(ValueError, match="os | os_g | p_g_os"):
        group_sharded_parallel(model, opt, "stage3")
    # no mesh, then a mesh without dp or sharding: the triple unchanged
    scaler = object()
    for axes in (None, {"pp": 2, "mp": 2}):
        if axes:
            mesh(axes)
        params = _slices(opt)
        got = group_sharded_parallel(model, opt, "p_g_os", scaler)
        assert got == (model, opt, scaler) and _slices(opt) == params
        assert not hasattr(model, "_zero_plan")


def _residency(level):
    torch.manual_seed(3)
    layers = []
    for _ in range(4):
        layers += [Linear(512, 512, device="cpu"), torch.nn.GELU()]
    model = torch.nn.Sequential(*layers)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.02)
    opt = SGD(0.1, parameters=model.parameters())
    group_sharded_parallel(model, opt, level)
    rng = np.random.RandomState(0)
    x, y = (torch.from_numpy(rng.randn(8, 512).astype(np.float32))
            for _ in range(2))
    ((model(x) - y) ** 2).mean().backward()
    opt.step()
    opt.clear_grad()
    return max(r["params"] + r["state"]
               for r in state_bytes_by_position(model, opt).values())


def test_zero3_reduces_residency(mesh):
    """``p_g_os`` holds at most half of ``os``'s parameter and optimizer
    state bytes on any position (4 MiB of weights over dp 8)."""
    mesh({"dp": 8})
    s1 = _residency("os")
    s3 = _residency("p_g_os")
    assert s3 <= 0.5 * s1, (s3, s1)


# ---------------------------------------------------------------------------
# the fleet recipe at pp 2 x sharding 2 x mp 2
# ---------------------------------------------------------------------------

FLEET_HYBRID = {"dp_degree": 1, "pp_degree": 2, "sharding_degree": 2,
                "mp_degree": 2}
FLEET_AXES = {"pp": 2, "sharding": 2, "mp": 2}
PIPE = {"accumulate_steps": 4, "micro_batch_size": 2}
GPT_CFG = dict(use_tensor_parallel=True, num_layers=3, hidden_dropout=0.0,
               attention_dropout=0.0)
GPT_LR, GPT_STEPS = 1e-3, 2
ZERO_REL, ZERO_SHARE = 1e-3, 1e-2


def _strategy(cls):
    st = cls()
    st.hybrid_configs = dict(FLEET_HYBRID,
                             order=["dp", "pp", "sharding", "sep", "mp"])
    st.pipeline_configs = dict(PIPE)
    return st


def _gpt_batches():
    rng = np.random.RandomState(1)
    return [(rng.randint(0, 1024, (8, 16)), rng.randint(0, 1024, (8, 16)))
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
    """The JAX recipe at FLEET_HYBRID with ``group_sharded_parallel`` at
    ``p_g_os``: its weights (biases and LayerNorm gains moved off 0/1),
    step 1's gradients, each step's loss and the weights after
    GPT_STEPS AdamW steps."""
    import jax

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
                               loss_fn=lambda lg, lb: crit(lg, lb))
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
        opt = jfleet.distributed_optimizer(pt.optimizer.AdamW(
            learning_rate=GPT_LR, parameters=pl.parameters(),
            multi_precision=False))
        model, opt, _ = jax_group_sharded(model, opt, "p_g_os")
        named = dict(pl.named_parameters())
        cap = _Capture(opt, lambda: {k: _np(p.grad)
                                     for k, p in named.items()})
        losses = []
        for ids, labels in _gpt_batches():
            losses.append(float(model.train_batch(
                (pt.to_tensor(ids, dtype="int64"),
                 pt.to_tensor(labels, dtype="int64")), cap)))
            if len(losses) == 1:
                grads = cap.grads
        after = {k: _np(v) for k, v in pl.state_dict().items()}
    return dict(state=state, grads=grads, losses=losses, after=after)


def _fleet_run(state, level, interval=0):
    """The port's recipe at FLEET_HYBRID on the global mesh, ``level``
    applied after ``distributed_optimizer``: losses, step-1 gradients,
    the state bytes by position then, the weights and the optimizer's
    state after GPT_STEPS steps, and the ``PipelineLayer``."""
    cfg = gpt_tiny(**GPT_CFG)
    fleet.init(is_collective=True,
               strategy=_strategy(fleet.DistributedStrategy))
    emb = GPTEmbeddings(cfg)
    descs = [emb] + [GPTDecoderLayer(cfg) for _ in range(cfg.num_layers)]
    descs += [LayerNorm(cfg.hidden_size, cfg.layer_norm_eps), GPTLMHead(emb)]
    pl = PipelineLayer(descs, num_stages=2,
                       loss_fn=GPTPretrainingCriterion(cfg),
                       recompute_interval=interval)
    pl.load_jax_state(state)
    model = fleet.distributed_model(pl)
    assert isinstance(model, PipelineParallel) and pl.num_replicas == 2
    opt = fleet.distributed_optimizer(AdamW(
        GPT_LR, parameters=pl.parameters(), multi_precision=False))
    if level is not None:
        model, opt, _ = group_sharded_parallel(model, opt, level)
    seen = {}

    def grads():
        seen["bytes"] = state_bytes_by_position(model, opt)
        return {k: g.numpy() for k, g in gathered_grads(model).items()}

    cap = _Capture(opt, grads)
    losses = []
    for ids, labels in _gpt_batches():
        losses.append(float(model.train_batch(
            (torch.from_numpy(ids), torch.from_numpy(labels)),
            cap if not losses else opt)))
    return dict(losses=losses, grads=cap.grads, bytes=seen["bytes"],
                after={k: v.clone() for k, v in pl.state_dict().items()},
                opt=opt.state_dict(), pl=pl)


@pytest.fixture(scope="module")
def fleet_plain(fleet_jax):
    """The port's run without ZeRO on the same mesh."""
    M.set_mesh(M.build_mesh(FLEET_AXES, ["cpu"] * 8))
    try:
        return _fleet_run(fleet_jax["state"], None)
    finally:
        M.set_mesh(None)
        fleet.set_hybrid_communicate_group(None)


FLEET_CASES = {"none": (None, 0), "os": ("os", 0), "os_g": ("os_g", 0),
               "p_g_os": ("p_g_os", 0), "p_g_os_rc1": ("p_g_os", 1)}


@pytest.mark.parametrize("case", list(FLEET_CASES))
def test_fleet_gpt_pp2_sharding2_mp2_matches_jax(fleet_jax, fleet_plain,
                                                 mesh, case):
    level, interval = FLEET_CASES[case]
    mesh(FLEET_AXES)
    run = _fleet_run(fleet_jax["state"], level, interval)
    np.testing.assert_allclose(run["losses"], fleet_jax["losses"],
                               rtol=1e-5)
    assert set(run["grads"]) == set(fleet_jax["grads"])
    for k, g in fleet_jax["grads"].items():
        _close(run["grads"][k], g, "step 1 gradient of " + k, rtol=1e-5,
               atol=1e-5 * np.abs(g).max())
    n_zero = n_all = 0
    for k, want in fleet_jax["after"].items():
        g = fleet_jax["grads"][k]
        zero = np.abs(run["grads"][k] - g) > ZERO_REL * np.abs(g)
        n_zero += int(zero.sum())
        n_all += zero.size
        err = np.abs(run["after"][k].numpy() - want)
        tol = 1e-5 * np.abs(want) + 1e-5 * np.abs(want).max()
        assert (err <= tol)[~zero].all(), (k, float((err - tol).max()))
        assert (err <= 2 * GPT_LR * GPT_STEPS)[zero].all(), k
    assert n_zero <= ZERO_SHARE * n_all, (n_zero, n_all)
    # every level (and the recompute) is the run without ZeRO, bit for bit
    assert run["losses"] == fleet_plain["losses"]
    for k, g in fleet_plain["grads"].items():
        assert np.array_equal(run["grads"][k], g), k
    _bit_equal(run["after"], fleet_plain["after"], "weights")
    _bit_equal(run["opt"], fleet_plain["opt"], "optimizer")
    # bytes summed over the 8 positions: W the model's weight bytes, two
    # replicas; whole gradients below os_g, sliced once from os_g on;
    # moments (2W) per replica without ZeRO, once with it
    W = sum(v.numel() * v.element_size() for v in run["after"].values())
    total = {k: sum(r[k] for r in run["bytes"].values())
             for k in ("params", "grads", "state")}
    want = {None: (2 * W, 2 * W, 4 * W), "os": (2 * W, 2 * W, 2 * W),
            "os_g": (2 * W, W, 2 * W), "p_g_os": (W, W, 2 * W)}[level]
    assert (total["params"], total["grads"], total["state"]) == want
    assert len(run["bytes"]) == 8
    if level == "p_g_os":
        assert all(_storage_free(p) for p in run["pl"].parameters())


# ---------------------------------------------------------------------------
# the stacked GPT at dp 2 x sharding 2 x mp 2
# ---------------------------------------------------------------------------

STACKED_AXES = {"dp": 2, "sharding": 2, "mp": 2}
STACKED_CFG = dict(num_layers=2, hidden_dropout=0.0, attention_dropout=0.0)
STACKED_LR, STACKED_STEPS = 1e-4, 3


def _stacked_batches():
    rng = np.random.RandomState(1)
    return [(rng.randint(0, 1024, (8, 16)), rng.randint(0, 1024, (8, 16)))
            for _ in range(STACKED_STEPS)]


@pytest.fixture(scope="module")
def stacked_jax():
    """The JAX stacked model on its STACKED_AXES mesh at ``p_g_os``: its
    weights (biases and gains moved off 0/1), the losses and weights of
    STACKED_STEPS AdamW steps."""
    with _JaxState():
        pt.seed(0)
        m = JaxGPT(jgpt.gpt_tiny(**STACKED_CFG))
        rng = np.random.RandomState(0)
        state = {}
        for k, v in m.state_dict().items():
            a = np.asarray(v.numpy(), np.float32)
            if k.endswith(("_b", "_g", "bias")) or k == "final_ln.weight":
                a = a + 0.1 * rng.randn(*a.shape).astype(np.float32)
            state[k] = a
        JM.set_mesh(JM.build_mesh(STACKED_AXES))
        jm = JaxGPT(jgpt.gpt_tiny(**STACKED_CFG))
        jm.set_state_dict(state)
        opt = pt.optimizer.AdamW(learning_rate=STACKED_LR,
                                 parameters=jm.parameters(),
                                 multi_precision=False)
        jax_group_sharded(jm, opt, "p_g_os")
        step = pt.optimizer.FusedTrainStep(lambda i, l: jm(i, labels=l), opt)
        losses = [float(step(pt.to_tensor(i, dtype="int64"),
                             pt.to_tensor(l, dtype="int64")))
                  for i, l in _stacked_batches()]
        weights = {k: np.asarray(v.numpy(), np.float32)
                   for k, v in jm.state_dict().items()}
    return dict(state=state, losses=losses, weights=weights)


@pytest.fixture(scope="module")
def stacked_runs(stacked_jax):
    """The port at STACKED_AXES without ZeRO and at ``p_g_os``."""
    out = {}
    try:
        for level in (None, "p_g_os"):
            M.set_mesh(M.build_mesh(STACKED_AXES, ["cpu"] * 8))
            m = GPTStackedForPretraining(gpt_tiny(**STACKED_CFG))
            assert train_mesh(m.config).dp == 4
            m.load_jax_state(stacked_jax["state"])
            opt = AdamW(STACKED_LR, parameters=m.parameters(),
                        multi_precision=False)
            if level is not None:
                group_sharded_parallel(m, opt, level)
            step = FusedTrainStep(lambda i, l: m(i, labels=l), opt)
            losses = [float(step(torch.from_numpy(i), torch.from_numpy(l)))
                      for i, l in _stacked_batches()]
            out[level] = dict(losses=losses, weights=m.state_dict(),
                              opt=opt.state_dict(), model=m)
    finally:
        M.set_mesh(None)
    return out


@pytest.mark.parametrize("level", [None, "p_g_os"], ids=["none", "p_g_os"])
def test_stacked_gpt_dp2_sharding2_mp2_matches_jax(stacked_jax,
                                                   stacked_runs, level):
    run = stacked_runs[level]
    np.testing.assert_allclose(run["losses"], stacked_jax["losses"],
                               rtol=1e-5)
    for k, want in stacked_jax["weights"].items():
        _close(run["weights"][k].numpy(), want, k, rtol=1e-5,
               atol=1e-5 * np.abs(want).max())
    other = stacked_runs[None if level else "p_g_os"]
    assert run["losses"] == other["losses"]
    _bit_equal(run["weights"], other["weights"], "weights")
    _bit_equal(run["opt"], other["opt"], "optimizer")
    if level == "p_g_os":
        assert all(_storage_free(p) for p in run["model"].parameters())


# ---------------------------------------------------------------------------
# the optimizer's companions at os_g, against the port without ZeRO
# ---------------------------------------------------------------------------

DP_AXES = {"dp": 2, "sharding": 2}


def _dp_mlp(seed=4):
    rng = np.random.RandomState(seed)
    model = torch.nn.Sequential(Linear(8, 16, device="cpu"),
                                torch.nn.GELU(),
                                Linear(16, 4, device="cpu"))
    load_jax_state(model, {"0.weight": rng.randn(8, 16) * 0.3,
                           "0.bias": rng.randn(16) * 0.1,
                           "2.weight": rng.randn(16, 4) * 0.3,
                           "2.bias": rng.randn(4) * 0.1})
    return DataParallel(model)


def _dp_batches(n=4):
    rng = np.random.RandomState(5)
    return [(torch.from_numpy(rng.randn(8, 8).astype(np.float32)),
             torch.from_numpy(rng.randn(8, 4).astype(np.float32)))
            for _ in range(n)]


def _named(dp):
    return [(n, p) for n, p in dp.named_parameters()]


COMPANIONS = {
    "clip": lambda dp: AdamW(0.05, parameters=dp.parameters(),
                             grad_clip=ClipGradByGlobalNorm(0.05)),
    "gradient_merge": lambda dp: meta.GradientMerge(
        AdamW(0.05, parameters=dp.parameters()), k_steps=2),
    "lars": lambda dp: meta.LarsMomentum(
        0.5, 0.9, parameters=_named(dp), lars_coeff=0.01,
        exclude_from_weight_decay=["bias"]),
    "dgc": lambda dp: meta.DGCMomentum(0.1, 0.9, parameters=_named(dp),
                                       rampup_begin_step=1, sparsity=0.75),
    "scaler": lambda dp: AdamW(0.05, parameters=dp.parameters()),
}


def _companion_run(name, zero, mesh):
    mesh(DP_AXES)
    dp = _dp_mlp()
    opt = COMPANIONS[name](dp)
    if zero:
        group_sharded_parallel(dp, opt, "os_g")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 8, device="cpu") \
        if name == "scaler" else None
    for i, (x, y) in enumerate(_dp_batches()):
        loss = ((dp(x) - y) ** 2).mean()
        if scaler is None:
            loss.backward()
            opt.step()
        else:
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
        opt.clear_grad()
        if name == "gradient_merge" and i == 2:
            # mid-window: a fresh wrapper resumes from the state dict
            sd = opt.state_dict()
            fresh = meta.GradientMerge(opt._inner, k_steps=2)
            fresh.set_state_dict(sd)
            assert fresh._step == opt._step
            opt = fresh
    return {k: v.clone() for k, v in dp.state_dict().items()}


@pytest.mark.parametrize("name", sorted(COMPANIONS))
def test_os_g_companions_match_the_unsharded_run(mesh, name):
    """The global-norm clip (each logical element counted once over the
    slices), ``GradScaler``, ``GradientMerge`` (sliced accumulators, a
    mid-window round trip), LARS and DGC (norms and percentile over the
    whole tensor) at ``os_g``: the weights after 4 steps within 1e-6 of
    the run without ZeRO."""
    want = _companion_run(name, False, mesh)
    got = _companion_run(name, True, mesh)
    for k, v in want.items():
        _close(got[k].numpy(), v.numpy(), k, rtol=1e-6, atol=1e-7)


def test_scaler_skips_every_position_on_an_inf_in_one_slice(mesh):
    """One non-finite slice of one gradient: the step is skipped on every
    position, weights, slices and moments bit-unchanged."""
    mesh(DP_AXES)
    dp = _dp_mlp()
    opt = AdamW(0.05, parameters=dp.parameters())
    group_sharded_parallel(dp, opt, "os_g")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 8, device="cpu")
    x, y = _dp_batches(1)[0]
    scaler.scale(((dp(x) - y) ** 2).mean()).backward()
    slices = _slices(opt)
    before = [s.clone() for s in slices]
    moments = [opt.state[s]["moment1"].clone() for s in slices]
    weights = [p.detach().clone() for p in dp.parameters()]
    slices[5].grad[0] = float("inf")
    scaler.step(opt)
    assert all(torch.equal(a, s) for a, s in zip(before, slices))
    assert all(torch.equal(m, opt.state[s]["moment1"])
               for m, s in zip(moments, slices))
    assert all(torch.equal(w, p) for w, p in zip(weights, dp.parameters()))
    assert scaler.get_loss_scaling() == 2.0 ** 7


# ---------------------------------------------------------------------------
# p_g_os storage, saving, and the wrappers
# ---------------------------------------------------------------------------

def test_p_g_os_keeps_no_gathered_copy(mesh):
    """After the forward and after the backward no copy of any replica
    holds storage; the slices got their gradients."""
    mesh(DP_AXES)
    dp = _dp_mlp()
    opt = AdamW(0.05, parameters=dp.parameters())
    group_sharded_parallel(dp, opt, "p_g_os")
    copies = list(dp.parameters())
    assert len(copies) == 4 * 4
    x, y = _dp_batches(1)[0]
    loss = ((dp(x) - y) ** 2).mean()
    assert all(_storage_free(p) for p in copies)
    loss.backward()
    assert all(_storage_free(p) for p in copies)
    assert all(p.grad is None for p in copies)
    assert all(s.grad is not None for s in _slices(opt))


def test_save_group_sharded_model_loads_unsharded(mesh, tmp_path):
    """The two files hold whole state dicts: an unsharded model and
    optimizer loaded from them hold the sharded run's bits."""
    mesh(DP_AXES)
    dp = _dp_mlp()
    opt = AdamW(0.05, parameters=dp.parameters())
    group_sharded_parallel(dp, opt, "p_g_os")
    for x, y in _dp_batches(2):
        ((dp(x) - y) ** 2).mean().backward()
        opt.step()
        opt.clear_grad()
    save_group_sharded_model(dp, str(tmp_path), opt)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "model.pdopt", "model.pdparams"]
    M.set_mesh(None)
    plain = _dp_mlp(seed=9)
    plain_opt = AdamW(0.05, parameters=plain.parameters())
    plain.set_state_dict(torch.load(tmp_path / "model.pdparams"))
    plain_opt.set_state_dict(torch.load(tmp_path / "model.pdopt"))
    _bit_equal(plain.state_dict(), dp.state_dict(), "weights")
    _bit_equal(plain_opt.state_dict(), opt.state_dict(), "optimizer")
    # and back: a load into the sharded model lands in its slices
    mesh(DP_AXES)
    dp2 = _dp_mlp(seed=9)
    opt2 = AdamW(0.05, parameters=dp2.parameters())
    group_sharded_parallel(dp2, opt2, "p_g_os")
    dp2.set_state_dict(torch.load(tmp_path / "model.pdparams"))
    opt2.set_state_dict(torch.load(tmp_path / "model.pdopt"))
    _bit_equal(dp2.state_dict(), dp.state_dict(), "weights")
    _bit_equal(opt2.state_dict(), opt.state_dict(), "optimizer")


def test_replicas_run_over_dp_x_sharding(mesh):
    """A sharding axis is a data axis: ``distributed_model`` at sharding
    > 1 gives ``DataParallel`` over dp x sharding replicas, the stacked
    model's ``train_mesh`` and the pipeline hold that many, and the
    layered model builds (it neither shards its batch nor pipelines);
    sep > 1 beside it, refused until sequence parallelism was ported, is
    read by no wrapper: the replicas over sharding alone, their output
    the module's."""
    from paddle_tpu_torch.models import GPTForPretraining

    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 2, "sharding_degree": 2}
    mesh({"dp": 2, "sharding": 2})
    fleet.init(is_collective=True, strategy=st)
    dp = fleet.distributed_model(torch.nn.Linear(2, 2))
    assert isinstance(dp, DataParallel) and dp.num_replicas == 4
    assert M.stage_devices(0, 3) == (torch.device("cpu"),)
    tm = train_mesh(gpt_tiny(num_layers=2))
    assert (tm.dp, tm.pp, tm.mp) == (4, 1, 1)
    GPTForPretraining(gpt_tiny(use_tensor_parallel=True), device="cpu")
    st.hybrid_configs = {"sharding_degree": 2, "sep_degree": 2}
    mesh({"sharding": 2, "sep": 2})
    fleet.init(is_collective=True, strategy=st)
    lin = torch.nn.Linear(2, 2)
    x = torch.arange(8.0).reshape(4, 2)
    want = lin(x)
    dp = fleet.distributed_model(lin)
    assert isinstance(dp, DataParallel) and dp.num_replicas == 2
    assert torch.equal(dp(x), want)
