"""The port's gradient clipping (``paddle_tpu_torch.nn.clip``) held
against the JAX package's (``paddle_tpu.nn.clip``) on the CPU.

The same numpy gradients, in fp32 and in bf16, go through each clip on
both sides, at a clip value that scales them and at one that leaves them
be.  Tolerances: fp32 within 1e-6 relative (the same arithmetic with the
sums in another order); bf16 within one bf16 rounding (2^-7 relative) for
the global norm, whose sum and scale are fp32 and whose result is
rounded once to bf16, and within two (2^-6) for the per-tensor norms,
whose norm and scale are themselves bf16 values (a sum rounded to bf16
may land one ulp apart).  The norms and scales stay tensors: nothing is
read back to the host."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt

from paddle_tpu_torch import nn as tnn

SHAPES = ((16, 24), (24,), (3, 5, 7))
TOL = {"float32": dict(rtol=1e-6, atol=1e-7),
       "bfloat16": dict(rtol=2.0 ** -7, atol=0)}
NORM_TOL = {"float32": TOL["float32"], "bfloat16": dict(rtol=2.0 ** -6,
                                                         atol=0)}


def _grads(seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in SHAPES]


def _jax_pairs(grads, dtype):
    return [(None, pt.to_tensor(g).astype(dtype)) for g in grads]


def _port_pairs(grads, dtype):
    return [(None, torch.from_numpy(g).to(getattr(torch, dtype)))
            for g in grads]


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t.numpy(), np.float32)


CLIPS = {
    "value": (lambda m: m.ClipGradByValue(0.7), TOL),
    "value min": (lambda m: m.ClipGradByValue(0.5, min=-0.2), TOL),
    "norm": (lambda m: m.ClipGradByNorm(2.0), NORM_TOL),
    "norm unclipped": (lambda m: m.ClipGradByNorm(1e3), NORM_TOL),
    "global norm": (lambda m: m.ClipGradByGlobalNorm(1.0), TOL),
    "global norm unclipped": (lambda m: m.ClipGradByGlobalNorm(1e3), TOL),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_clip_matches_jax(clip, dtype):
    build, tol = CLIPS[clip]
    grads = _grads(1)
    jout = build(pt.nn)(_jax_pairs(grads, dtype))
    tout = build(tnn)(_port_pairs(grads, dtype))
    assert len(tout) == len(jout)
    for (_, tg), (_, jg), g in zip(tout, jout, grads):
        assert tg.dtype == getattr(torch, dtype) and tg.shape == g.shape
        np.testing.assert_allclose(_f32(tg), _f32(jg), **tol[dtype])
    if "unclipped" in clip:
        for (_, tg), g in zip(tout, _port_pairs(grads, dtype)):
            assert torch.equal(tg, g[1])


def test_global_norm_keeps_none_gradients_and_the_device():
    pairs = [("a", None), ("b", torch.ones(4) * 3.0)]
    out = tnn.ClipGradByGlobalNorm(1.0)(pairs)
    assert out[0] == ("a", None) and out[1][0] == "b"
    torch.testing.assert_close(out[1][1], torch.full((4,), 0.5))
    assert tnn.ClipGradByGlobalNorm(1.0)([("a", None)]) == [("a", None)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_jax(norm_type, dtype):
    grads = _grads(2, scale=3.0)
    jparams, tparams = [], []
    for g in grads:
        jw = pt.to_tensor(np.zeros_like(g)).astype(dtype)
        jw.stop_gradient = False
        (jw * pt.to_tensor(g).astype(dtype)).sum().backward()
        jparams.append(jw)
        tw = torch.nn.Parameter(torch.zeros(g.shape,
                                            dtype=getattr(torch, dtype)))
        tw.grad = torch.from_numpy(g).to(tw.dtype)
        tparams.append(tw)
    jt = pt.nn.clip_grad_norm_(jparams, 5.0, norm_type=norm_type)
    tt = tnn.clip_grad_norm_(tparams, 5.0, norm_type=norm_type)
    assert isinstance(tt, torch.Tensor) and tt.dim() == 0
    np.testing.assert_allclose(_f32(tt), _f32(jt), **NORM_TOL[dtype])
    for tw, jw in zip(tparams, jparams):
        np.testing.assert_allclose(_f32(tw.grad), _f32(jw.grad),
                                   **NORM_TOL[dtype])


def test_clip_grad_norm_without_gradients():
    out = tnn.clip_grad_norm_([torch.nn.Parameter(torch.ones(2))], 1.0)
    assert out.dim() == 0 and float(out) == 0.0
