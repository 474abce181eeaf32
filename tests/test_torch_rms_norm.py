"""The port's fused residual add + RMSNorm / LayerNorm held against the JAX
package on the CPU.

The same numpy inputs go through the port's plain versions (which the
wrappers run on CPU tensors) and the JAX package's functions: the Pallas
kernel in interpret mode at a shape its gate takes ([16, 256]), and its
``reference`` at shapes the gate refuses ([257, 128], [16, 100]).  Bounds:

- against the Pallas kernel, which adds in fp32 as the port does: fp32
  normed within 1e-6 absolute (the same fp32 arithmetic summed in another
  order; |normed| stays below ~10), h equal; bf16 within one bf16 rounding
  (2^-7 relative of the larger side, plus 1e-6), h equal (one fp32 add,
  one cast on both sides);
- against ``reference`` in fp32, where its add in x's dtype is the fp32
  add: the same bounds;
- gradients of ``sum(normed^2) + sum(h)`` through the port's autograd
  Function against ``jax.grad`` of the same loss through the JAX op
  (whose backward is autograd of ``reference``): 1e-4 absolute, as the
  JAX package's own kernel test holds them.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` phase 16
holds it against these plain versions."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas_kernels import rms_norm as jrn

from paddle_tpu_torch.ops.kernels import rms_norm as trn

torch.set_num_threads(2)

TOL = {"float32": dict(rtol=0.0, atol=1e-6),
       "bfloat16": dict(rtol=2.0 ** -7, atol=1e-6)}


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    hidden = shape[-1]
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32),
            rng.randn(hidden).astype(np.float32),
            rng.randn(hidden).astype(np.float32))


def _jax_op(layer_norm, interpret):
    if layer_norm:
        return lambda x, r, g, b, eps: jrn.fused_add_layer_norm(
            x, r, g, b, eps, interpret)
    return lambda x, r, g, b, eps: jrn.fused_add_rms_norm(x, r, g, eps,
                                                          interpret)


def _port_op(layer_norm, plain):
    if layer_norm:
        fn = (trn.fused_add_layer_norm_plain if plain
              else trn.fused_add_layer_norm)
        return lambda x, r, g, b, eps: fn(x, r, g, b, eps)
    fn = trn.fused_add_rms_norm_plain if plain else trn.fused_add_rms_norm
    return lambda x, r, g, b, eps: fn(x, r, g, eps)


def _run_both(arrays, dtype, layer_norm, eps, interpret, plain=True):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j = _jax_op(layer_norm, interpret)(*(jnp.asarray(a, jd) for a in arrays),
                                       eps)
    t = _port_op(layer_norm, plain)(*(torch.from_numpy(a).to(td)
                                      for a in arrays), eps)
    return ([np.asarray(a, np.float32) for a in j],
            [b.float().numpy() for b in t], t)


@pytest.mark.parametrize("layer_norm", [True, False], ids=["ln", "rms"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(layer_norm, dtype):
    """[16, 256]: the Pallas gate takes it (a row block of 16 >= 8), so
    ``interpret=True`` runs the kernel body."""
    assert jrn.shape_supported(256) and jrn._pick_rows(16, 256) >= 8
    eps = 1e-5 if layer_norm else 1e-6
    (jo, jh), (to, th), t = _run_both(_inputs((16, 256), 0), dtype,
                                      layer_norm, eps, interpret=True)
    assert t[0].dtype == t[1].dtype == getattr(torch, dtype)
    np.testing.assert_allclose(to, jo, **TOL[dtype])
    np.testing.assert_array_equal(th, jh)


@pytest.mark.parametrize("layer_norm", [True, False], ids=["ln", "rms"])
@pytest.mark.parametrize("shape", [(257, 128), (16, 100), (2, 3, 64)])
@pytest.mark.parametrize("eps", [1e-12, 1e-5])
def test_plain_matches_reference_where_the_tpu_gate_refuses(layer_norm,
                                                            shape, eps):
    """Shapes the TPU gate sends to ``reference`` (257 rows: no row block
    of 8 divides them; hidden 100: not a 128-multiple); the port's
    wrapper runs every shape the same way."""
    (jo, jh), (to, th), _ = _run_both(_inputs(shape, 1), "float32",
                                      layer_norm, eps, interpret=True,
                                      plain=False)
    np.testing.assert_allclose(to, jo, **TOL["float32"])
    np.testing.assert_array_equal(th, jh)


@pytest.mark.parametrize("layer_norm", [True, False], ids=["ln", "rms"])
def test_zero_rows(layer_norm):
    arrays = [a[:0] if a.ndim == 2 else a for a in _inputs((4, 256), 2)]
    (jo, jh), (to, th), _ = _run_both(arrays, "float32", layer_norm, 1e-5,
                                      interpret=True, plain=False)
    assert to.shape == th.shape == jo.shape == jh.shape == (0, 256)


@pytest.mark.parametrize("layer_norm", [True, False], ids=["ln", "rms"])
def test_function_gradients_match_jax(layer_norm):
    """``sum(normed^2) + sum(h)`` differentiated through the port's
    ``FusedAddNorm`` and through the JAX custom-VJP op (the Pallas kernel
    in interpret mode forward, autograd of ``reference`` backward)."""
    x, r, g, b = _inputs((16, 256), 3)
    eps = 1e-5 if layer_norm else 1e-6
    nparams = 2 if layer_norm else 1
    jop = _jax_op(layer_norm, True)

    def jloss(x, r, g, b):
        o, h = jop(x, r, g, b, eps)
        return jnp.sum(o * o) + jnp.sum(h)

    jg = jax.grad(jloss, argnums=tuple(range(2 + nparams)))(
        *(jnp.asarray(a) for a in (x, r, g, b)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, r, g, b)]
    o, h = _port_op(layer_norm, False)(*ts, eps)
    assert o.grad_fn is not None and "FusedAddNorm" in type(o.grad_fn).__name__
    ((o * o).sum() + h.sum()).backward()
    for a, t in zip(jg, ts):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(a), atol=1e-4,
                                   rtol=0)
    if not layer_norm:
        assert ts[3].grad is None


def test_cpu_calls_count_no_launch_and_other_devices_raise():
    """CPU tensors take the plain version and count nothing; a tensor on
    any other device goes to the kernel, which here refuses it (meta
    tensors stand in for a device without one): no fallback."""
    x, r, g, b = (torch.from_numpy(a) for a in _inputs((4, 128), 4))
    before = (trn.fused_add_layer_norm.launches,
              trn.fused_add_rms_norm.launches)
    trn.fused_add_layer_norm(x, r, g, b)
    trn.fused_add_rms_norm(x, r, g)
    assert (trn.fused_add_layer_norm.launches,
            trn.fused_add_rms_norm.launches) == before
    meta = [t.to("meta") for t in (x, r, g, b)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        trn.fused_add_layer_norm(*meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        trn.fused_add_rms_norm(*meta[:3])


def test_bf16_activations_keep_their_dtype_with_fp32_params():
    """Outputs come back in x's dtype whatever the parameters' dtype; h is
    the fp32 sum rounded once."""
    x, r, g, b = (torch.from_numpy(a) for a in _inputs((8, 128), 5))
    xb, rb = x.to(torch.bfloat16), r.to(torch.bfloat16)
    o, h = trn.fused_add_layer_norm(xb, rb, g, b, 1e-12)
    assert o.dtype == h.dtype == torch.bfloat16
    assert torch.equal(h, (xb.float() + rb.float()).to(torch.bfloat16))
    assert not trn.shape_supported(100) and trn.shape_supported(768)
