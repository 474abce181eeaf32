"""The port's AdamW held against the JAX package on the CPU.

The same numpy inputs go through the port's update (the plain version of
the fused kernel, ``fused_adamw_update`` on CPU tensors), the JAX
package's Pallas kernel ``fused_adamw_update(..., interpret=True)``, and
the JAX package's composed chain (``AdamW._apply_one``, through its
``AdamW`` optimizer), over two consecutive steps in which the beta powers
advance.  Tolerances are those of the JAX package's own kernel test:
1e-6 in fp32, 1e-2 in bf16 (the chain rounds ``beta1 * m1`` to bf16
before adding; the kernels widen first).  Then the port's ``AdamW``
optimizer and ``FusedTrainStep``: CPU tensors count no kernel launch, and
O1 over fp32 weights, not ported, raises.

The master form (bf16/fp16 parameters with fp32 master weights) and the
whole recipe -- a scheduler, ``lr_ratio``, ``apply_decay_param_fun``
over ``named_parameters()``-style names, ``grad_clip`` -- are held
against the JAX package's ``AdamW`` (its composed master path) over four
steps on the same gradients: fp32 masters, moments and fp32 parameters
within 1e-6 relative (the same fp32 formula, op for op, with the
global norm summed in another order: its scale may differ in the last
ulp), and a bf16/fp16 parameter within one rounding of its dtype of the
JAX parameter (both round the fp32 master once; a master a few ulps
either side of a rounding midpoint may round the other way).  A JAX
``state_dict()`` resumes in the port bit for bit."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.ops.pallas_kernels.fused_adamw import (
    fused_adamw_update as jax_fused_adamw,
)

from paddle_tpu_torch import amp, nn as tnn
from paddle_tpu_torch.ops.kernels import fused_adamw as tfw
from paddle_tpu_torch.optimizer import AdamW, FusedTrainStep
from paddle_tpu_torch.optimizer import lr as tlr

torch.set_num_threads(2)

B1, B2, EPS, WD = 0.9, 0.999, 1e-8, 0.01
SHAPES = [((512, 1024), "float32"),     # lane-aligned
          ((3, 257), "float32"),        # unaligned tail
          ((24, 64, 64), "bfloat16")]   # slab-shaped bf16 (bench regime)


def _tol(dtype):
    t = 1e-2 if dtype == "bfloat16" else 1e-6
    return dict(rtol=t, atol=t)


def _state(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape), rng.randn(*shape) * 0.01,
            np.abs(rng.randn(*shape)) * 0.001,
            [rng.randn(*shape) * 0.1 for _ in range(2)])


def _powers(steps):
    b1p, b2p = np.float32(1.0), np.float32(1.0)
    out = []
    for _ in range(steps):
        b1p = np.float32(b1p * np.float32(B1))
        b2p = np.float32(b2p * np.float32(B2))
        out.append((b1p, b2p))
    return out


def _f32(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape,dtype", SHAPES)
def test_update_matches_the_pallas_kernel_over_two_steps(shape, dtype):
    p0, m10, m20, grads = _state(shape, 0)
    lr = 1e-3
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    jp, jm1, jm2 = (jnp.asarray(a, jd) for a in (p0, m10, m20))
    tp, tm1, tm2 = (torch.from_numpy(np.asarray(a, np.float32)).to(td)
                    for a in (p0, m10, m20))
    for g, (b1p, b2p) in zip(grads, _powers(2)):
        jp, jm1, jm2 = jax_fused_adamw(
            jp, jnp.asarray(g, jd), jm1, jm2, lr, b1p, b2p, beta1=B1,
            beta2=B2, eps=EPS, wd=WD, interpret=True)
        tfw.fused_adamw_update(tp, torch.from_numpy(_f32(g)).to(td), tm1,
                               tm2, lr, b1p, b2p, beta1=B1, beta2=B2,
                               eps=EPS, wd=WD)
        for name, got, want in (("p", tp, jp), ("m1", tm1, jm1),
                                ("m2", tm2, jm2)):
            assert got.dtype == td and tuple(got.shape) == shape
            np.testing.assert_allclose(got.float().numpy(), _f32(want),
                                       err_msg=name, **_tol(dtype))


@pytest.mark.parametrize("shape,dtype", SHAPES)
def test_optimizer_matches_the_composed_chain_over_two_steps(shape, dtype):
    """The port's AdamW and the JAX package's AdamW (composed chain,
    ``multi_precision=False``) from the same parameter, given the same
    gradients: ``loss = sum(w * g)`` has gradient exactly ``g``."""
    p0, _, _, grads = _state(shape, 1)
    lr = 1e-3
    jw = pt.to_tensor(_f32(p0)).astype(dtype)
    jw.stop_gradient = False
    jopt = pt.optimizer.AdamW(learning_rate=lr, parameters=[jw],
                              multi_precision=False)
    tw = torch.nn.Parameter(torch.from_numpy(_f32(p0)).to(getattr(torch,
                                                                  dtype)))
    topt = AdamW([tw], learning_rate=lr, multi_precision=False)
    for g in grads:
        (jw * pt.to_tensor(_f32(g)).astype(dtype)).sum().backward()
        jopt.step()
        jopt.clear_grad()
        tw.grad = torch.from_numpy(_f32(g)).to(tw.dtype)
        topt.step()
        topt.zero_grad()
        np.testing.assert_allclose(tw.detach().float().numpy(),
                                   _f32(jw.numpy()), **_tol(dtype))
    assert (topt.beta1_pow, topt.beta2_pow) == _powers(2)[-1]


def test_cpu_tensors_count_no_launch():
    before = tfw.fused_adamw_update.launches
    p, g, m1, m2 = (torch.ones(8) for _ in range(4))
    tfw.fused_adamw_update(p, g, m1, m2, 1e-3, 0.9, 0.999)
    assert tfw.fused_adamw_update.launches == before
    assert not torch.equal(p, torch.ones(8))      # updated in place


def test_fused_step_refuses_o1_over_fp32():
    w32 = torch.nn.Parameter(torch.zeros(4))
    with pytest.raises(NotImplementedError, match="O1"):
        FusedTrainStep(lambda x: (w32 * x).sum(), AdamW([w32]),
                       amp_level="O1")
    with pytest.raises(ValueError, match="amp_level"):
        FusedTrainStep(lambda x: (w32 * x).sum(), AdamW([w32]),
                       amp_level="O2")


def test_fused_step_runs_forward_backward_update_and_zeroes_grads():
    w = torch.nn.Parameter(torch.full((4,), 2.0, dtype=torch.bfloat16))
    step = FusedTrainStep(lambda x: (w.float() * x).sum(),
                          AdamW([w], learning_rate=0.1,
                                multi_precision=False), amp_level="O1")
    loss = step(torch.ones(4))
    assert float(loss) == 8.0 and not loss.requires_grad
    assert w.grad is None
    assert float(w.detach()[0]) < 2.0


# -- the fp32-master form and the recipe ------------------------------------

MASTER_TOL = dict(rtol=1e-6, atol=1e-7)
# one rounding of the storage dtype (2^-8 relative for bf16, 2^-11 fp16)
ROUND_TOL = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


@pytest.mark.parametrize("shape,dtype", [((512, 1024), "bfloat16"),
                                         ((3, 257), "bfloat16"),
                                         ((24, 64, 64), "float16")])
def test_master_form_matches_the_composed_master_chain(shape, dtype):
    """``fused_adamw_update(..., master=)`` on CPU tensors (the kernel's
    plain version) against the JAX package's ``AdamW`` over a bf16/fp16
    parameter with its fp32 master, three steps: the master and the fp32
    moments within ``MASTER_TOL``, p exactly the master rounded."""
    p0, _, _, grads = _state(shape, 5)
    grads = grads + [np.random.RandomState(6).randn(*shape) * 0.1]
    lr = 1e-3
    td = getattr(torch, dtype)
    jw = pt.to_tensor(_f32(p0)).astype(dtype)
    jw.stop_gradient = False
    jopt = pt.optimizer.AdamW(learning_rate=lr, parameters=[jw])
    tp = torch.from_numpy(_f32(p0)).to(td)
    master = tp.float()
    m1, m2 = torch.zeros(shape), torch.zeros(shape)
    for g, (b1p, b2p) in zip(grads, _powers(3)):
        (jw * pt.to_tensor(_f32(g)).astype(dtype)).sum().backward()
        jopt.step()
        jopt.clear_grad()
        tfw.fused_adamw_update(tp, torch.from_numpy(_f32(g)).to(td), m1, m2,
                               lr, b1p, b2p, master=master)
        jsd = jopt.state_dict()
        for name, got in (("master", master), ("m1", m1), ("m2", m2)):
            key = {"master": "master_0", "m1": "moment1_0",
                   "m2": "moment2_0"}[name]
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), _f32(jsd[key].numpy()),
                                       err_msg=name, **MASTER_TOL)
        assert tp.dtype == td and torch.equal(tp, master.to(td))
        np.testing.assert_allclose(tp.float().numpy(), _f32(jw.numpy()),
                                   rtol=ROUND_TOL[dtype], atol=0)


NAMES = ("enc.fc.weight", "enc.fc.bias", "enc.ln.weight", "head.weight")
SHAPES_BY_NAME = ((64, 48), (48,), (48,), (48, 100))


def _no_decay(name):
    return not any(w in name for w in ("bias", "ln", "layer_norm"))


def _ratio(p):
    return 0.5 if len(p.shape) == 1 else 1.0


def _schedule(mod, lr):
    """The BERT recipe's schedule: linear warmup over 2 steps, then linear
    decay to 0 at step 10."""
    return mod.LinearWarmup(mod.PolynomialDecay(lr, 10, end_lr=0.0,
                                                power=1.0), 2, lr / 10, lr)


RECIPES = {
    "fp32 float lr, lr_ratio, decay mask": dict(
        dtype="float32", sched=False, clip=None, ratio=True, mask=True),
    "bf16 masters, schedule, global-norm clip": dict(
        dtype="bfloat16", sched=True, clip="global", ratio=False,
        mask=False),
    "bf16 masters, the whole recipe": dict(
        dtype="bfloat16", sched=True, clip="global", ratio=True, mask=True),
    "bf16 without masters, schedule, per-tensor clip": dict(
        dtype="bfloat16", sched=True, clip="norm", ratio=True, mask=True,
        multi_precision=False),
}


class _NamedParameter(torch.nn.Parameter):
    """A parameter whose ``name`` the caller sets, as a ``ParamAttr`` names
    a reference parameter (torch 2.13's tensors reserve a read-only
    ``name`` that reads ``None``; this class attribute shadows it)."""
    name = None


def _port_adamw(tparams, how, **kw):
    """The port's AdamW over ``tparams``, named by ``NAMES`` in one of four
    ways: ``(name, param)`` pairs; bare parameters that carry ``p.name``;
    two dict param groups of those; or pairs, half of them in a group
    added by ``add_param_group`` after the optimizer is built."""
    pairs = list(zip(NAMES, tparams))
    if how == "pairs":
        return AdamW(pairs, **kw)
    if how == "added":
        opt = AdamW(pairs[:2], **kw)
        opt.add_param_group({"params": pairs[2:]})
        return opt
    for name, p in pairs:
        p.name = name
    if how == "bare":
        return AdamW(tparams, **kw)
    return AdamW([{"params": tparams[:2]}, {"params": tparams[2:]}], **kw)


def _recipe_pair(recipe, lr=1e-2, seed=7, how="pairs"):
    """The JAX and the port's AdamW over the same named parameters (the
    port's named as ``_port_adamw``'s ``how`` says)."""
    rng = np.random.RandomState(seed)
    dtype = recipe["dtype"]
    mp = recipe.get("multi_precision", True)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES_BY_NAME]
    jparams, tparams = [], []
    for name, a in zip(NAMES, init):
        jw = pt.to_tensor(a).astype(dtype)
        jw.stop_gradient = False
        jw.name = name
        jparams.append(jw)
        tparams.append(_NamedParameter(
            torch.from_numpy(a).to(getattr(torch, dtype))))
    clip = recipe["clip"]
    jclip = tclip = None
    if clip == "global":
        jclip, tclip = (pt.nn.ClipGradByGlobalNorm(1.0),
                        tnn.ClipGradByGlobalNorm(1.0))
    elif clip == "norm":
        jclip, tclip = pt.nn.ClipGradByNorm(0.5), tnn.ClipGradByNorm(0.5)
    kw = dict(weight_decay=0.01, multi_precision=mp,
              lr_ratio=_ratio if recipe["ratio"] else None,
              apply_decay_param_fun=_no_decay if recipe["mask"] else None)
    jsched = _schedule(pt.optimizer.lr, lr) if recipe["sched"] else lr
    tsched = _schedule(tlr, lr) if recipe["sched"] else lr
    jopt = pt.optimizer.AdamW(learning_rate=jsched, parameters=jparams,
                              grad_clip=jclip, **kw)
    topt = _port_adamw(tparams, how, learning_rate=tsched, grad_clip=tclip,
                       **kw)
    return jparams, tparams, jopt, topt, jsched, tsched


def _grads(steps, seed=8, scale=1.0):
    rng = np.random.RandomState(seed)
    return [[(rng.randn(*s) * scale).astype(np.float32)
             for s in SHAPES_BY_NAME] for _ in range(steps)]


def _jax_step(jparams, jopt, jsched, gs, dtype):
    loss = None
    for w, g in zip(jparams, gs):
        term = (w * pt.to_tensor(g).astype(dtype)).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    jopt.step()
    jopt.clear_grad()
    if not isinstance(jsched, float):
        jsched.step()


def _port_step(tparams, topt, tsched, gs):
    for w, g in zip(tparams, gs):
        w.grad = torch.from_numpy(g).to(w.dtype)
    topt.step()
    topt.zero_grad()
    if not isinstance(tsched, float):
        tsched.step()


def _assert_same_state(jparams, tparams, jopt, topt, dtype):
    """fp32 state within MASTER_TOL and a low-precision parameter within
    one rounding of the JAX one; without masters (bf16 moments) the whole
    state within the bf16 chain's ``_tol``, as above."""
    jsd, tsd = jopt.state_dict(), topt.state_dict()
    bf16_chain = tsd["moment1_0"].dtype != torch.float32
    for key, got in tsd.items():
        if key == "LR_Scheduler":
            assert got == jsd[key]
            continue
        want = _f32(jsd[key].numpy())
        np.testing.assert_allclose(
            got.float().numpy(), want, err_msg=key,
            **(_tol(dtype) if bf16_chain else MASTER_TOL))
    assert set(tsd) == set(jsd)
    for name, jw, tw in zip(NAMES, jparams, tparams):
        tol = (_tol(dtype) if bf16_chain
               else dict(rtol=ROUND_TOL[dtype], atol=0) if dtype in ROUND_TOL
               else MASTER_TOL)
        np.testing.assert_allclose(tw.detach().float().numpy(),
                                   _f32(jw.numpy()), err_msg=name, **tol)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_recipe_matches_jax_adamw_over_four_steps(recipe):
    r = RECIPES[recipe]
    jparams, tparams, jopt, topt, jsched, tsched = _recipe_pair(r)
    for gs in _grads(4):
        _jax_step(jparams, jopt, jsched, gs, r["dtype"])
        _port_step(tparams, topt, tsched, gs)
        assert topt.get_lr() == jopt.get_lr()
        _assert_same_state(jparams, tparams, jopt, topt, r["dtype"])
    masters = [k for k in topt.state_dict() if k.startswith("master_")]
    assert len(masters) == (4 if r["dtype"] == "bfloat16"
                            and r.get("multi_precision", True) else 0)


@pytest.mark.parametrize("how", ["bare", "groups", "added"])
def test_names_and_state_reach_every_param_group(how):
    """Bare parameters named by ``p.name`` (the reference's ``p.name or
    ""``), dict param groups, and a group added after the optimizer is
    built all carry their names to ``apply_decay_param_fun`` and get their
    moments and masters: four steps of the whole bf16 recipe against JAX's
    AdamW, whose parameters carry the same names.  A parameter named ``""``
    would be decayed, off by ~1e-4 a step from JAX (MASTER_TOL: 1e-6)."""
    r = RECIPES["bf16 masters, the whole recipe"]
    jparams, tparams, jopt, topt, jsched, tsched = _recipe_pair(r, how=how)
    assert len(topt.param_groups) == (1 if how == "bare" else 2)
    for gs in _grads(4):
        _jax_step(jparams, jopt, jsched, gs, r["dtype"])
        _port_step(tparams, topt, tsched, gs)
        _assert_same_state(jparams, tparams, jopt, topt, r["dtype"])


@pytest.mark.parametrize("scheduled", [True, False])
def test_decay_factor_is_rounded_as_jax_rounds_it(scheduled):
    """``adamw_scalars``' ``1 - lr * wd`` bit for bit against the
    reference's: from a scheduler's fp32 lr tensor (``fp32_lr``, as AdamW
    passes it) each operation is rounded to fp32; from a float lr it is
    computed in double and rounded once.  At lr 1.0 and wd 0.3 the two
    roundings differ at 4 of these 60 steps, so the test tells them
    apart."""
    wd = 0.3
    sched = pt.optimizer.lr.LinearWarmup(pt.optimizer.lr.PolynomialDecay(
        1.0, 50, end_lr=0.0, power=1.0), 10, 0.1, 1.0)
    differ = 0
    for _ in range(60):
        lr = float(sched())
        if scheduled:
            jlr = sched._lr_tensor()._value
            want = np.asarray(1.0 - jlr * wd)
        else:
            want = np.asarray(jnp.ones((), jnp.float32) * (1.0 - lr * wd))
        lr_arg = np.float32(lr) if scheduled else lr
        got = tfw.adamw_scalars(lr_arg, 0.9, 0.999, wd=wd,
                                fp32_lr=scheduled)[6]
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes(), lr
        other = tfw.adamw_scalars(lr_arg, 0.9, 0.999, wd=wd,
                                  fp32_lr=not scheduled)[6]
        differ += other != got
        sched.step()
    assert differ > 0


def test_jax_state_dict_resumes_in_the_port():
    """Two JAX steps of the whole bf16 recipe; its ``state_dict()`` (numpy
    arrays, the scheduler's dict) and parameters go into a fresh port
    optimizer, which then takes two more steps beside the JAX one."""
    r = RECIPES["bf16 masters, the whole recipe"]
    jparams, _, jopt, _, jsched, _ = _recipe_pair(r)
    grads = _grads(4, seed=9)
    for gs in grads[:2]:
        _jax_step(jparams, jopt, jsched, gs, "bfloat16")
    sd = {k: (v if k == "LR_Scheduler" else v.numpy())
          for k, v in jopt.state_dict().items()}
    tparams = [torch.nn.Parameter(torch.from_numpy(
        _f32(jw.numpy())).to(torch.bfloat16)) for jw in jparams]
    tsched = _schedule(tlr, 1e-2)
    topt = AdamW(list(zip(NAMES, tparams)), learning_rate=tsched,
                 grad_clip=tnn.ClipGradByGlobalNorm(1.0), weight_decay=0.01,
                 lr_ratio=_ratio, apply_decay_param_fun=_no_decay)
    topt.set_state_dict(sd)
    for key, got in topt.state_dict().items():
        if key != "LR_Scheduler":
            np.testing.assert_array_equal(got.numpy(), sd[key], err_msg=key)
    assert tsched.last_epoch == jsched.last_epoch == 2
    assert topt.get_lr() == jopt.get_lr()
    for gs in grads[2:]:
        _jax_step(jparams, jopt, jsched, gs, "bfloat16")
        _port_step(tparams, topt, tsched, gs)
        _assert_same_state(jparams, tparams, jopt, topt, "bfloat16")


def test_state_dict_round_trip_continues_bit_for_bit():
    r = RECIPES["bf16 masters, the whole recipe"]
    runs = []
    for resume in (False, True):
        _, tparams, _, topt, _, tsched = _recipe_pair(r)
        grads = _grads(4, seed=10)
        for gs in grads[:2]:
            _port_step(tparams, topt, tsched, gs)
        if resume:
            sd = {k: (v if k == "LR_Scheduler" else v.clone())
                  for k, v in topt.state_dict().items()}
            params = [p.detach().clone() for p in tparams]
            _, tparams, _, topt, _, tsched = _recipe_pair(r)
            with torch.no_grad():
                for p, v in zip(tparams, params):
                    p.copy_(v)
            topt.set_state_dict(sd)
        for gs in grads[2:]:
            _port_step(tparams, topt, tsched, gs)
        runs.append([p.detach().clone() for p in tparams]
                    + [v for k, v in topt.state_dict().items()
                       if k != "LR_Scheduler"])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_masters_are_made_from_what_the_optimizer_sees_when_built():
    """``amp.decorate`` O2 before ``AdamW`` gives bf16 weights with fp32
    masters (of the bf16 values); an optimizer built before it saw fp32
    parameters and keeps none, as in the reference."""
    m = torch.nn.Linear(8, 4)
    before = AdamW(m.parameters())
    assert amp.decorate(m, level="O2") is m
    assert m.weight.dtype == torch.bfloat16
    after = AdamW(m.parameters())
    assert not any(k.startswith("master_") for k in before.state_dict())
    sd = after.state_dict()
    assert torch.equal(sd["master_0"], m.weight.detach().float())
    assert sd["moment1_0"].dtype == torch.float32
    m2 = torch.nn.Linear(8, 4)
    model, opt = amp.decorate(m2, after, level="O1")
    assert model is m2 and opt is after and m2.weight.dtype == torch.float32


def test_card_tensors_launch_the_master_form_or_raise():
    """Off the CPU a master update is the kernel or an error: operands the
    master form does not take raise before anything is built or launched
    (meta tensors stand in for the card's)."""
    meta = dict(device="meta")
    p = torch.empty(8, dtype=torch.bfloat16, **meta)
    f32 = torch.empty(8, **meta)
    before = tfw.fused_adamw_update.launches
    for kw in (dict(p=torch.empty(8, **meta), g=f32),            # fp32 p
               dict(p=p, g=torch.empty(8, dtype=torch.float16, **meta)),
               dict(p=p, g=p, master=p),                          # bf16 master
               dict(p=p, g=p, m1=torch.empty(9, **meta))):
        args = {**dict(p=p, g=p, m1=f32, m2=f32, master=f32), **kw}
        with pytest.raises(ValueError, match="fused_adamw"):
            tfw.fused_adamw_update(args["p"], args["g"], args["m1"],
                                   args["m2"], 1e-3, 0.9, 0.999,
                                   master=args["master"])
    assert tfw.fused_adamw_update.launches == before
