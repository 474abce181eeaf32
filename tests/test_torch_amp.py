"""AMP O1 and the gradient scaler of the port, held against the JAX
package on the CPU.

- ``auto_cast``'s state nests, restores and is per thread, as the
  reference's; ``maybe_cast`` decides each op's dtype as the reference's
  ``_maybe_cast_inputs`` does, over the lists and custom lists that move
  an op from one list to the other.
- A Linear -> LayerNorm -> softmax -> cross-entropy stack under
  ``auto_cast`` O1 (bf16) gives the JAX stack's loss within 1e-3
  relative and its gradients within 2^-6 of each gradient's largest
  element (bf16 products rounded at the same points, fp32 norms and
  losses summed in another order); with ``linear`` moved to the black
  list everything runs in fp32 (1e-5).
- The stacked GPT at ``gpt_tiny(hidden 128, 2 heads)`` over fp32 weights
  under O1: the first step's loss (1e-3 relative) and gradients (2^-5 of
  each parameter's largest gradient: bf16 activations through two
  blocks), the logits without labels and ``generate``'s logits (2^-5 of
  the largest logit), and float16 (the plain versions on the CPU).
- ``GradScaler``: ``unscale_`` unscales as the JAX scaler does and flags
  a non-finite gradient; ``step`` skips it and halves the scale; the
  dynamic rule's scale over a run of good and bad steps is the JAX
  scaler's; state round-trips; no gradients, a disabled scaler and
  ``minimize`` behave as the reference's.
- ``FusedTrainStep(scaler=)`` with ``AdamW`` (the port of
  ``tests/test_train_perf.py::test_traced_scaler_skips_nonfinite_step``):
  a step whose scaled fp16 gradient overflows leaves the parameter, its
  fp32 master, both moments and the beta powers bitwise unchanged and
  halves the scale; the next finite steps apply (the parameter within
  one fp16 rounding of the JAX step's) and regrow the scale, as JAX's
  fused step does.
- Fault 11: a loss on another device than the scale (a pipeline whose
  data replicas end on different cards) is scaled by a copy of the scale
  made there (the ``meta`` device stands for the other card: every CPU
  device compares equal); each copy equals the master bit for bit after
  ``update()`` (finite and non-finite), ``load_state_dict`` and
  ``FusedTrainStep``'s traced update; the toy pipeline at dp 2 x pp 2
  with ``scaler=`` skips a non-finite step as the JAX pipeline does and
  then takes the JAX pipeline's step."""
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.amp.auto_cast import _maybe_cast_inputs, amp_state
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as JM
from paddle_tpu.distributed.fleet.base import topology as jtopo
from paddle_tpu.distributed.fleet.meta_parallel import pipeline_parallel as jpp
from paddle_tpu.models import GPTStackedForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn import functional as jF
from paddle_tpu.nn.modules.common import Linear as JaxLinear

from paddle_tpu_torch import amp
from paddle_tpu_torch.amp.auto_cast import maybe_cast
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed import mesh as M
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, PipelineLayer, PipelineParallel,
)
from paddle_tpu_torch.models import GPTStackedForPretraining, gpt_tiny
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.optimizer import AdamW, FusedTrainStep

torch.set_num_threads(2)

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "float16": torch.float16, "int64": torch.int64}


def test_auto_cast_state_nests_restores_and_is_per_thread():
    st = amp.amp_state()
    jst = amp_state()
    assert not st.enabled
    with amp.auto_cast(level="O1", dtype="float16",
                       custom_white_list=["exp"]), \
            pt.amp.auto_cast(level="O1", dtype="float16",
                             custom_white_list=["exp"]):
        assert (st.enabled, st.level, st.custom_white) == (
            jst.enabled, jst.level, jst.custom_white)
        assert st.dtype == torch.float16
        with amp.amp_guard(enable=False):
            assert not st.enabled
        assert st.enabled
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            amp.amp_state().enabled))
        t.start()
        t.join()
        assert seen == [False]
    assert not st.enabled and st.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="dtype"):
        with amp.auto_cast(dtype="int8"):
            pass


LIST_CASES = {
    "white": ("linear", {}),
    "white sdpa": ("sdpa", {}),
    "black": ("layer_norm", {}),
    "black cross_entropy": ("cross_entropy", {}),
    "neither": ("gelu", {}),
    "white moved black": ("linear", dict(custom_black_list=["linear"])),
    "black moved white": ("softmax", dict(custom_white_list=["softmax"])),
    "neither made white": ("gelu", dict(custom_white_list=["gelu"])),
}


@pytest.mark.parametrize("case", sorted(LIST_CASES))
def test_cast_decisions_follow_the_reference_lists(case):
    op, lists = LIST_CASES[case]
    arrays = [np.ones(3, np.float32), np.ones(3, np.float32),
              np.arange(3)]
    jin = [pt.to_tensor(arrays[0]),
           pt.to_tensor(arrays[1]).astype("bfloat16"),
           pt.to_tensor(arrays[2], dtype="int64")]
    tin = [torch.ones(3), torch.ones(3, dtype=torch.bfloat16),
           torch.arange(3)]
    with pt.amp.auto_cast(level="O1", **lists), \
            amp.auto_cast(level="O1", **lists):
        want = [str(t._value.dtype) for t in _maybe_cast_inputs(op, jin)]
        got = maybe_cast(op, *tin, None)
    assert [t.dtype for t in got[:3]] == [_DT[w] for w in want]
    assert got[3] is None
    outside = maybe_cast(op, *tin)
    assert all(a is b for a, b in zip(outside, tin))


def _stack_inputs(seed=0, n=8, d=16, c=10):
    rng = np.random.RandomState(seed)
    return dict(x=rng.randn(n, d).astype(np.float32),
                w=(rng.randn(d, c) * 0.3).astype(np.float32),
                b=(rng.randn(c) * 0.1).astype(np.float32),
                g=(1 + 0.1 * rng.randn(c)).astype(np.float32),
                beta=(0.1 * rng.randn(c)).astype(np.float32),
                label=rng.randint(0, c, (n,)))


def _jax_stack(a, **lists):
    p = {k: pt.to_tensor(v) for k, v in a.items() if k != "label"}
    for k in ("w", "b", "g", "beta"):
        p[k].stop_gradient = False
    with pt.amp.auto_cast(level="O1", **lists):
        y = jF.linear(p["x"], p["w"], p["b"])
        y = jF.layer_norm(y, y.shape[-1], p["g"], p["beta"])
        y = jF.softmax(y)
        loss = jF.cross_entropy(y, pt.to_tensor(a["label"], dtype="int64"),
                                use_softmax=False)
    loss.backward()
    return float(loss), {k: np.asarray(p[k].grad.numpy(), np.float32)
                         for k in ("w", "b", "g", "beta")}


def _port_stack(a, **lists):
    p = {k: torch.tensor(v, requires_grad=k != "x")
         for k, v in a.items() if k != "label"}
    with amp.auto_cast(level="O1", **lists):
        y = F.linear(p["x"], p["w"], p["b"])
        assert y.dtype == (torch.float32 if "linear" in
                           lists.get("custom_black_list", ())
                           else torch.bfloat16)
        y = F.layer_norm(y, y.shape[-1], p["g"], p["beta"])
        y = F.softmax(y)
        loss = F.cross_entropy(y, torch.from_numpy(a["label"]),
                               use_softmax=False)
    loss.backward()
    return float(loss.detach()), {k: p[k].grad.float().numpy()
                         for k in ("w", "b", "g", "beta")}


@pytest.mark.parametrize("lists,tol", [
    ({}, 2.0 ** -6),
    (dict(custom_black_list=["linear"]), 1e-5),
    (dict(custom_white_list=["layer_norm"]), 2.0 ** -5),
], ids=["lists", "linear black", "layer_norm white"])
def test_o1_stack_matches_jax(lists, tol):
    a = _stack_inputs()
    jloss, jg = _jax_stack(a, **lists)
    tloss, tg = _port_stack(a, **lists)
    np.testing.assert_allclose(tloss, jloss, rtol=max(tol, 1e-3))
    for k, want in jg.items():
        np.testing.assert_allclose(tg[k], want, rtol=0,
                                   atol=tol * np.abs(want).max(), err_msg=k)


# -- the stacked GPT under O1 ------------------------------------------------

CFG = dict(hidden_size=128, num_heads=2, hidden_dropout=0.0,
           attention_dropout=0.0)
GPT_TOL = 2.0 ** -5


@pytest.fixture(scope="module")
def gpt_state():
    pt.seed(0)
    m = JaxGPT(jax_gpt_tiny(**CFG))
    rng = np.random.RandomState(0)
    out = {}
    for k, v in m.state_dict().items():
        a = np.asarray(v.numpy(), np.float32)
        if k.endswith(("_b", "_g", "bias")) or k == "final_ln.weight":
            a = a + 0.1 * rng.randn(*a.shape).astype(np.float32)
        out[k] = a
    return out


def _models(state, **kw):
    jm = JaxGPT(jax_gpt_tiny(**{**CFG, **kw}))
    jm.set_state_dict(state)
    tm = GPTStackedForPretraining(gpt_tiny(**{**CFG, **kw}), device="cpu")
    tm.load_jax_state(state)
    return jm, tm


def _ids(seed, shape=(2, 128)):
    return np.random.RandomState(seed).randint(0, 1024, shape)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_o1_gpt_first_step_matches_jax(gpt_state, dtype):
    jm, tm = _models(gpt_state, recompute_interval=1)
    ids, labels = _ids(1), _ids(2)
    with pt.amp.auto_cast(level="O1", dtype=dtype):
        jloss = jm(pt.to_tensor(ids, dtype="int64"),
                   labels=pt.to_tensor(labels, dtype="int64"))
    jloss.backward()
    with amp.auto_cast(level="O1", dtype=dtype):
        tloss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-3)
    for name, p in tm.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        want = np.asarray(dict(jm.named_parameters())[name].grad.numpy(),
                          np.float32)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=GPT_TOL * np.abs(want).max(),
                                   err_msg=name)


def test_o1_gpt_logits_and_generate_match_jax(gpt_state):
    """The full forward's logits and ``generate``'s (the cached bodies
    cast as the training block does) under O1, against JAX's."""
    jm, tm = _models(gpt_state)
    jm.eval()
    tm.eval()
    ids = _ids(3, (2, 20))
    with pt.amp.auto_cast(level="O1"):
        jl = np.asarray(jm(pt.to_tensor(ids, dtype="int64")).numpy(),
                        np.float32)
        jout, jlog = jm.generate(pt.to_tensor(ids, dtype="int64"), 4,
                                 max_seq_len=64, cache_dtype="float32",
                                 return_logits=True)
    with amp.auto_cast(level="O1"), torch.no_grad():
        tl = tm(torch.from_numpy(ids)).float().numpy()
        tout, tlog = tm.generate(ids, 4, max_seq_len=64,
                                 cache_dtype="float32", return_logits=True)
    np.testing.assert_allclose(tl, jl, rtol=0,
                               atol=GPT_TOL * np.abs(jl).max())
    jlog = np.asarray(jlog.numpy(), np.float32)
    np.testing.assert_allclose(tlog.float().numpy(), jlog, rtol=0,
                               atol=GPT_TOL * np.abs(jlog).max())
    np.testing.assert_array_equal(tout.numpy()[:, :20], ids)


def test_o1_float16_on_the_card_raises_naming_queue_2():
    """The card's flash kernels take float32 and bfloat16: an O1 float16
    training forward raises the kernels' dtype error, which names
    ROADMAP.md queue 2, before anything launches (meta tensors stand in
    for the card's)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa

    m = GPTStackedForPretraining(gpt_tiny(**CFG), device="cpu").to("meta")
    ids = torch.zeros((1, 128), dtype=torch.long, device="meta")
    before = tfa.flash_attention_fwd.launches
    with amp.auto_cast(level="O1", dtype="float16"), \
            pytest.raises(ValueError, match="float16 is ROADMAP.md queue 2"):
        m(ids, labels=ids)
    assert tfa.flash_attention_fwd.launches == before


# -- GradScaler --------------------------------------------------------------

def _linear_pair(seed=0):
    rng = np.random.RandomState(seed)
    w0 = rng.randn(4, 4).astype(np.float32)
    x = np.ones((2, 4), np.float32)
    jlin = pt.nn.Linear(4, 4)
    jlin.weight.set_value(w0)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    tb = torch.nn.Parameter(torch.zeros(4))
    return jlin, (tw, tb), x


def test_scaler_unscale_and_skip_match_jax():
    """The reference's fused semantics (``TestSentry::
    test_grad_scaler_fused_semantics``): a good step's gradients come out
    divided by the scale, as JAX's; a NaN gradient sets ``_found_inf``,
    skips the update and halves the scale."""
    jlin, (tw, tb), x = _linear_pair()
    jopt = pt.optimizer.AdamW(learning_rate=0.1,
                              parameters=jlin.parameters())
    topt = AdamW(0.1, parameters=[tw, tb])
    js = pt.amp.GradScaler(init_loss_scaling=256.0)
    ts = amp.GradScaler(init_loss_scaling=256.0, device="cpu")
    js.scale(jlin(pt.to_tensor(x)).mean()).backward()
    ts.scale(F.linear(torch.from_numpy(x), tw, tb).mean()).backward()
    js.unscale_(jopt)
    ts.unscale_(topt)
    assert ts._found_inf is js._found_inf is False
    np.testing.assert_allclose(tw.grad.numpy(),
                               np.asarray(jlin.weight.grad.numpy()),
                               rtol=1e-6)
    jopt.clear_grad()
    topt.zero_grad()
    ts.scale(F.linear(torch.from_numpy(x), tw, tb).mean()).backward()
    tw.grad.fill_(float("nan"))
    w0 = tw.detach().clone()
    ts.step(topt)
    assert torch.equal(tw.detach(), w0)
    assert ts.get_loss_scaling() == 128.0
    assert ts.get_loss_scaling() == js.get_loss_scaling() / 2


def test_scaler_dynamic_rule_matches_jax():
    """A run of good and bad steps: the scale after each is the JAX
    scaler's (``incr_every_n_steps`` 2, ``decr_every_n_nan_or_inf`` 2)."""
    kw = dict(init_loss_scaling=64.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=2)
    js, ts = pt.amp.GradScaler(**kw), amp.GradScaler(device="cpu", **kw)
    seen = []
    for bad in (False, False, True, False, True, True, True, True, False):
        for s in (js, ts):
            s._found_inf = bad
            s.update()
        seen.append((js.get_loss_scaling(), ts.get_loss_scaling()))
        assert (js._good_steps, js._bad_steps) == (ts._good_steps,
                                                   ts._bad_steps)
    assert all(a == b for a, b in seen), seen


def test_scaler_state_round_trip_and_passthroughs():
    ts = amp.GradScaler(init_loss_scaling=32.0, device="cpu")
    ts._good_steps = 3
    sd = ts.state_dict()
    jsd = pt.amp.GradScaler(init_loss_scaling=32.0).state_dict()
    assert set(sd) == set(jsd)
    other = amp.GradScaler(device="cpu")
    other.load_state_dict({**sd, "scale": np.float32(32.0)})
    assert other.get_loss_scaling() == 32.0 and other._good_steps == 3
    # no gradients: nothing flagged
    w = torch.nn.Parameter(torch.ones(2))
    opt = AdamW(1e-3, parameters=[w])
    other.unscale_(opt)
    assert other._found_inf is False
    # disabled: the loss and the step pass through
    off = amp.GradScaler(enable=False, device="cpu")
    loss = (w * 2).sum()
    assert off.scale(loss) is loss and off.get_loss_scaling() == 1.0
    # minimize: backward, step, clear
    on = amp.GradScaler(init_loss_scaling=4.0, device="cpu")
    on.minimize(opt, on.scale((w * 2).sum()))
    assert w.grad is None and not torch.equal(w.detach(), torch.ones(2))
    assert on.is_enable() and on.is_use_dynamic_loss_scaling()


def test_fused_step_scaler_skips_nonfinite_step():
    """The port of ``test_traced_scaler_skips_nonfinite_step`` with
    ``AdamW`` in place of ``SGD``, held step by step against JAX's fused
    step on the same fp16 parameter and inputs."""
    kw = dict(enable=True, init_loss_scaling=2.0 ** 14,
              incr_every_n_steps=2, decr_every_n_nan_or_inf=1)
    from paddle_tpu.tensor import Parameter as JParameter

    jp = JParameter(jnp.ones((4, 4), jnp.float16))
    jopt = pt.optimizer.AdamW(learning_rate=0.1, parameters=[jp])
    jsc = pt.amp.GradScaler(**kw)
    jstep = pt.optimizer.FusedTrainStep(
        lambda x: (jp * x).astype("float32").sum(), jopt, scaler=jsc)
    tp = torch.nn.Parameter(torch.ones((4, 4), dtype=torch.float16))
    topt = AdamW(0.1, parameters=[tp])
    tsc = amp.GradScaler(device="cpu", **kw)
    tstep = FusedTrainStep(lambda x: (tp * x).float().sum(), topt,
                           scaler=tsc)
    x_ok = np.full((4, 4), 0.01, np.float16)
    x_bad = np.full((4, 4), np.float16(60000))

    def state():
        st = topt.state[tp]
        return [t.clone() for t in (tp.detach(), st["master"],
                                    st["moment1"], st["moment2"])]

    def both(x):
        jstep(pt.to_tensor(x))
        tstep(torch.from_numpy(x))

    before = state()
    both(x_bad)                       # the scaled gradient overflows fp16
    assert not tstep.last_step_applied and not jstep.last_step_applied
    assert all(torch.equal(a, b) for a, b in zip(before, state()))
    assert (topt.beta1_pow, topt.beta2_pow) == (1.0, 1.0)
    assert float(tsc._scale) == 2.0 ** 13 == float(
        np.asarray(jsc._scale._value))
    both(x_ok)
    assert tstep.last_step_applied and jstep.last_step_applied
    assert not torch.equal(before[0], tp.detach())
    np.testing.assert_allclose(tp.detach().float().numpy(),
                               np.asarray(jp._value, np.float32),
                               rtol=2.0 ** -10)
    assert topt.beta1_pow == np.float32(0.9)
    both(x_ok)                        # second good step in a row: regrow
    assert float(tsc._scale) == 2.0 ** 14 == float(
        np.asarray(jsc._scale._value))
    assert tstep.dispatch_count == 3
    # the host counters stay untouched, as in the reference's fused mode
    assert (tsc._good_steps, tsc._bad_steps) == (0, 0)


# ---------------------------------------------------------------------------
# fault 11: losses on another device than the scale
# ---------------------------------------------------------------------------

OTHER = torch.device("meta")


def test_fault11_loss_on_another_device_scales():
    """The parent raised "the loss is on ..., the scale on ..."."""
    ts = amp.GradScaler(init_loss_scaling=8.0, device="cpu")
    loss = torch.ones((), device=OTHER)
    out = ts.scale(loss)
    assert out.device == OTHER and out.shape == () \
        and out.dtype == torch.float32
    assert list(ts._copies) == [OTHER]
    assert ts._scale.device == torch.device("cpu")
    # the master's device takes the master, with no copy
    assert float(ts.scale(torch.ones(()))) == 8.0 and len(ts._copies) == 1


def _with_copy(**kw):
    """A scaler on the CPU with a copy of its scale under a second device
    key; the copy is a CPU tensor, so its values can be read."""
    ts = amp.GradScaler(device="cpu", **kw)
    ts.scale(torch.ones((), device=OTHER))
    ts._copies[OTHER] = ts._scale.clone()
    return ts


def _copy_is_master(ts):
    return torch.equal(ts._copies[OTHER], ts._scale)


def test_fault11_copies_follow_update_and_load():
    ts = _with_copy(init_loss_scaling=64.0, incr_every_n_steps=2)
    for bad, want in ((True, 32.0), (False, 32.0), (False, 64.0),
                      (True, 32.0)):
        ts._found_inf = bad
        ts.update()
        assert ts.get_loss_scaling() == want and _copy_is_master(ts)
    ts.load_state_dict({**ts.state_dict(), "scale": np.float32(3.0)})
    assert ts.get_loss_scaling() == 3.0 and _copy_is_master(ts)


def test_fault11_copies_follow_the_traced_update():
    kw = dict(init_loss_scaling=2.0 ** 14, incr_every_n_steps=1)
    ts = _with_copy(**kw)
    tp = torch.nn.Parameter(torch.ones((4, 4), dtype=torch.float16))
    step = FusedTrainStep(lambda x: (tp * x).float().sum(),
                          AdamW(0.1, parameters=[tp]), scaler=ts)
    step(torch.full((4, 4), 60000.0, dtype=torch.float16))   # overflows
    assert not step.last_step_applied
    assert ts.get_loss_scaling() == 2.0 ** 13 and _copy_is_master(ts)
    step(torch.full((4, 4), 0.01, dtype=torch.float16))
    assert ts.get_loss_scaling() == 2.0 ** 14 and _copy_is_master(ts)


class _Pipe:
    pipeline_configs = {"accumulate_steps": 4, "micro_batch_size": 2}


def _jax_strategy():
    st = jfleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 2, "pp_degree": 2, "mp_degree": 1,
                         "order": ["dp", "pp", "sharding", "sep", "mp"]}
    st.pipeline_configs = dict(_Pipe.pipeline_configs)
    return st


def _toy_batches():
    """A batch with an inf in one row (every gradient non-finite), then a
    finite one."""
    rng = np.random.RandomState(11)
    bad = rng.randn(8, 8).astype(np.float32)
    bad[5, 3] = np.inf
    return [(bad, rng.randn(8, 8).astype(np.float32)),
            (rng.randn(8, 8).astype(np.float32),
             rng.randn(8, 8).astype(np.float32))]


def test_fault11_pipeline_dp2_skips_as_jax():
    """The toy pipeline at dp 2 x pp 2 with ``scaler=``: the non-finite
    step leaves every weight (both replicas) unchanged and halves the
    scale, as the JAX pipeline's; the next step is the JAX one's."""
    batches = _toy_batches()
    mesh, hcg = JM._global_mesh, jtopo.get_hybrid_communicate_group()
    JM._global_mesh = None
    jtopo.set_hybrid_communicate_group(None)
    try:
        jfleet.init(is_collective=True, strategy=_jax_strategy())
        pt.seed(7)
        jl = jpp.PipelineLayer(
            [jpp.LayerDesc(JaxLinear, 8, 8) for _ in range(4)],
            num_stages=2, loss_fn=lambda o, y: pt.ops.mean((o - y) ** 2))
        state = {k: np.asarray(v.numpy(), np.float32)
                 for k, v in jl.state_dict().items()}
        jpipe = jfleet.distributed_model(jl)
        jopt = pt.optimizer.AdamW(learning_rate=0.1,
                                  parameters=jl.parameters())
        jsc = pt.amp.GradScaler(init_loss_scaling=256.0)
        jwant = []
        for x, y in batches:
            loss = jpipe.train_batch((pt.to_tensor(x), pt.to_tensor(y)),
                                     jopt, scaler=jsc)
            jwant.append((float(loss), jsc.get_loss_scaling(),
                          {k: np.asarray(v.numpy(), np.float32)
                           for k, v in jl.state_dict().items()}))
    finally:
        JM._global_mesh = mesh
        jtopo.set_hybrid_communicate_group(hcg)
    M.set_mesh(M.build_mesh({"dp": 2, "pp": 2}, ["cpu"] * 4))
    try:
        pl = PipelineLayer([LayerDesc(Linear, 8, 8, device="cpu")
                            for _ in range(4)], num_stages=2,
                           loss_fn=lambda o, y: ((o - y) ** 2).mean())
        pl.load_jax_state(state)
        pipe = PipelineParallel(pl, strategy=_Pipe())
        opt = AdamW(0.1, parameters=pl.parameters())
        ts = amp.GradScaler(init_loss_scaling=256.0, device="cpu")
        copies = [p.detach().clone() for p in pl.parameters()]
        for i, ((x, y), (jloss, jscale, jafter)) in enumerate(
                zip(batches, jwant)):
            loss = pipe.train_batch((torch.from_numpy(x),
                                     torch.from_numpy(y)), opt, scaler=ts)
            assert ts.get_loss_scaling() == jscale
            after = {k: v.numpy() for k, v in pl.state_dict().items()}
            if i == 0:
                assert not np.isfinite(float(loss)) \
                    and not np.isfinite(jloss)
                assert jscale == 128.0
                for k, v in after.items():
                    np.testing.assert_array_equal(v, state[k], err_msg=k)
                assert all(torch.equal(p, c) for p, c in
                           zip(pl.parameters(), copies))
            else:
                np.testing.assert_allclose(float(loss), jloss, rtol=1e-6)
                for k, v in jafter.items():
                    np.testing.assert_allclose(after[k], v, rtol=1e-5,
                                               atol=1e-6, err_msg=k)
    finally:
        M.set_mesh(None)
        fleet.set_hybrid_communicate_group(None)
