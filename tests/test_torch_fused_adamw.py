"""The port's AdamW held against the JAX package on the CPU.

The same numpy inputs go through the port's update (the plain version of
the fused kernel, ``fused_adamw_update`` on CPU tensors), the JAX
package's Pallas kernel ``fused_adamw_update(..., interpret=True)``, and
the JAX package's composed chain (``AdamW._apply_one``, through its
``AdamW`` optimizer), over two consecutive steps in which the beta powers
advance.  Tolerances are those of the JAX package's own kernel test:
1e-6 in fp32, 1e-2 in bf16 (the chain rounds ``beta1 * m1`` to bf16
before adding; the kernels widen first).  Then the port's ``AdamW``
optimizer and ``FusedTrainStep``: what is not ported raises, and CPU
tensors count no kernel launch."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.ops.pallas_kernels.fused_adamw import (
    fused_adamw_update as jax_fused_adamw,
)

from paddle_tpu_torch.ops.kernels import fused_adamw as tfw
from paddle_tpu_torch.optimizer import AdamW, FusedTrainStep

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


@pytest.mark.parametrize("kwargs,match", [
    (dict(learning_rate=object()), "learning-rate scheduler"),
    (dict(grad_clip=object()), "grad_clip"),
    (dict(lr_ratio=lambda p: 1.0), "lr_ratio"),
    (dict(apply_decay_param_fun=lambda name: True), "apply_decay_param_fun"),
])
def test_unported_adamw_options_raise(kwargs, match):
    w = torch.nn.Parameter(torch.zeros(4))
    with pytest.raises(NotImplementedError, match=match):
        AdamW([w], **kwargs)


def test_master_weights_for_bf16_parameters_raise():
    w = torch.nn.Parameter(torch.zeros(4, dtype=torch.bfloat16))
    with pytest.raises(NotImplementedError, match="master weights"):
        AdamW([w])                       # multi_precision=True by default
    AdamW([w], multi_precision=False)
    AdamW([torch.nn.Parameter(torch.zeros(4))])   # fp32: no masters needed


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
