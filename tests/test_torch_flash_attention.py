"""The port's flash attention held against the JAX package on the CPU.

The same numpy inputs go through four paths: the port's plain version
(``flash_attention_plain``, differentiated by autograd), the JAX
package's ``_xla_reference_bnsd`` (and ``jax.vjp`` of it), and the JAX
package's own Pallas kernels ``_flash_fwd``/``_flash_bwd`` run in
interpret mode (``pltpu.force_tpu_interpret_mode``).  O, the per-row
logsumexp, dq, dk and dv must agree; so must the port's plain versions of
the two backward kernels, fed the Pallas forward's lse and delta, and
the Pallas backward kernels: fp32 within 1e-5 (the same
arithmetic summed in another order), bf16 within 2e-2 absolute plus 2e-2
relative (each path rounds its outputs, and the probabilities and dS, to
bf16 at its own points; a bf16 ulp is 2^-8 relative).

The kernels themselves (CUDA) run only on the card, where ``chip_smoke.py``
holds them against this plain version."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu.analysis.codes import flash_gate_reason
from paddle_tpu.ops.pallas_kernels import flash_attention as jfa

from paddle_tpu_torch.ops.kernels import flash_attention as tfa

torch.set_num_threads(2)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
BLOCK = 128          # the Pallas kernels' q and kv blocks


def _inputs(b, n, s, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, n, s, d).astype(np.float32) for _ in range(4)]


def _port(arrays, dtype, causal, scale):
    """O, lse and (dq, dk, dv) of the port's plain version under
    autograd."""
    td = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(td) for a in arrays)
    for t in (q, k, v):
        t.requires_grad_(True)
    out, lse = tfa.flash_attention_plain(q, k, v, causal, scale)
    out.backward(do)
    return [np.asarray(t.detach().float()) for t in
            (out, lse, q.grad, k.grad, v.grad)]


def _jax_reference(arrays, dtype, causal, scale):
    """O of ``_xla_reference_bnsd`` and (dq, dk, dv) of its ``jax.vjp``."""
    q, k, v, do = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    out, vjp = jax.vjp(
        lambda q, k, v: jfa._xla_reference_bnsd(q, k, v, causal, scale),
        q, k, v)
    return [np.asarray(t, np.float32) for t in (out, *vjp(do))]


def _jax_pallas(arrays, dtype, causal, scale):
    """O, lse, dq, dk, dv of the Pallas kernels in interpret mode, on the
    flattened [B * N, S, D] layout they take (O, dq, dk, dv reshaped to
    [B, N, S, D], lse as [B * N, S])."""
    b, n, s, d = arrays[0].shape
    q, k, v, do = (jnp.asarray(a.reshape(b * n, s, d), getattr(jnp, dtype))
                   for a in arrays)
    with pltpu.force_tpu_interpret_mode():
        out, lse = jfa._flash_fwd(q, k, v, scale, causal, BLOCK, BLOCK)
        grads = jfa._flash_bwd(q, k, v, out, lse, do, scale, causal, BLOCK,
                               BLOCK)
    shaped = [np.asarray(t, np.float32).reshape(b, n, s, d)
              for t in (out, *grads)]
    return [shaped[0], np.asarray(lse, np.float32)] + shaped[1:]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d", [(128, 64), (384, 64), (128, 128),
                                 (384, 128)])
def test_plain_matches_jax_reference_and_pallas_kernels(dtype, causal, s, d):
    arrays = _inputs(1, 2, s, d, seed=s + d + int(causal))
    scale = 1.0 / np.sqrt(d)
    o, lse, dq, dk, dv = _port(arrays, dtype, causal, scale)
    ref = _jax_reference(arrays, dtype, causal, scale)
    pallas = _jax_pallas(arrays, dtype, causal, scale)
    tol = TOL[dtype]
    names = ("O", "dq", "dk", "dv")
    for name, got, want in zip(names, (o, dq, dk, dv), ref):
        np.testing.assert_allclose(got, want, err_msg=f"{name} vs reference",
                                   **tol)
    for name, got, want in zip(("O", "lse", "dq", "dk", "dv"),
                               (o, lse, dq, dk, dv), pallas):
        np.testing.assert_allclose(got, want, err_msg=f"{name} vs Pallas",
                                   **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d", [(128, 64), (384, 128)])
def test_backward_kernels_plain_versions_match_pallas_kernels(dtype, causal,
                                                               s, d):
    """Each backward kernel's plain version, fed the Pallas forward's O and
    lse and ``delta = rowsum(dO * O)``, against the Pallas dK/dV and dQ
    kernels; the CPU wrappers return the same and count no launch."""
    arrays = _inputs(1, 2, s, d, seed=2 * s + d + int(causal))
    scale = 1.0 / np.sqrt(d)
    o, lse, want_dq, want_dk, want_dv = _jax_pallas(arrays, dtype, causal,
                                                    scale)
    td = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(td) for a in arrays)
    lse = torch.from_numpy(np.array(lse))
    delta = tfa.backward_delta(do, torch.from_numpy(np.array(o)).to(td))
    args = (q, k, v, do, lse, delta, causal, scale)
    dk, dv = tfa.flash_attention_bwd_dkv_plain(*args)
    dq = tfa.flash_attention_bwd_dq_plain(*args)
    tol = TOL[dtype]
    for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        assert got.dtype == td
        np.testing.assert_allclose(got.float().numpy(), want, err_msg=name,
                                   **tol)
    before = _launch_counts()
    wk, wv = tfa.flash_attention_bwd_dkv(*args)
    wq = tfa.flash_attention_bwd_dq(*args)
    assert _launch_counts() == before
    for got, want in ((wq, dq), (wk, dk), (wv, dv)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("seq", [64, 127, 128, 200, 256, 384, 1024])
@pytest.mark.parametrize("head_dim", [16, 64, 96, 128, 256])
def test_gate_is_the_jax_packages_rule(seq, head_dim):
    mine = tfa.shape_unsupported_reason(seq, head_dim)
    theirs = flash_gate_reason(seq, head_dim)
    assert (mine is None) == (theirs is None)
    if theirs is not None:
        assert theirs.detail in mine and mine.startswith("[GL002]")


def test_kernel_takes_fp32_and_bf16_at_head_dims_64_and_128():
    assert tfa.kernel_unsupported_reason(128, 64, torch.float32) is None
    assert tfa.kernel_unsupported_reason(1024, 128, torch.bfloat16) is None
    assert "head_dim=256" in tfa.kernel_unsupported_reason(
        128, 256, torch.bfloat16)
    assert "float16" in tfa.kernel_unsupported_reason(128, 64,
                                                      torch.float16)
    assert "seq_len=192" in tfa.kernel_unsupported_reason(192, 64,
                                                          torch.float32)


def test_kernel_head_dims_by_dtype_and_direction():
    """The bf16 forward takes head_dim 64, 128, 192 and 256; the backward
    and every fp32 kernel 64 and 128.  A head dim still refused names
    ROADMAP.md queue 2, and is refused off the CPU before anything
    launches (meta tensors stand in for the card's)."""
    for d in (64, 128, 192, 256):
        assert tfa.fwd_kernel_unsupported_reason(200, d, torch.bfloat16) \
            is None
    for d in (64, 128):
        assert tfa.kernel_unsupported_reason(1024, d, torch.bfloat16) is None
    for reason in (tfa.fwd_kernel_unsupported_reason(200, 192, torch.float32),
                   tfa.fwd_kernel_unsupported_reason(200, 96, torch.bfloat16),
                   tfa.kernel_unsupported_reason(1024, 192, torch.bfloat16)):
        assert "ROADMAP.md queue 2" in reason, reason
    q = torch.zeros((1, 2, 200, 96), dtype=torch.bfloat16, device="meta")
    before = tfa.flash_attention_fwd.launches
    with pytest.raises(ValueError, match="head_dim=96"):
        tfa.flash_attention_fwd(q, q, q, True, 0.1)
    assert tfa.flash_attention_fwd.launches == before


def _launch_counts():
    return (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd_dkv.launches,
            tfa.flash_attention_bwd_dq.launches)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    """The public wrapper and the forward kernel's wrapper on CPU tensors:
    the plain version's forward and autograd backward, equal to calling
    it directly, and no launch counted."""
    q, k, v, do = (torch.from_numpy(a).requires_grad_(i < 3)
                   for i, a in enumerate(_inputs(2, 2, 128, 64, seed=5)))
    before = _launch_counts()
    out = tfa.flash_attention_bnsd(q, k, v, causal=True)
    out.backward(do)
    fwd_out, fwd_lse = tfa.flash_attention_fwd(q, k, v, True, 1.0 / 8.0)
    assert _launch_counts() == before
    want, want_lse = tfa.flash_attention_plain(q, k, v, True, 1.0 / 8.0)
    for got in (out, fwd_out):
        np.testing.assert_array_equal(got.detach().numpy(),
                                      want.detach().numpy())
    assert torch.equal(fwd_lse, want_lse)
    assert q.grad is not None and k.grad is not None and v.grad is not None


@pytest.mark.parametrize("s,d,dtype,reason", [
    (100, 64, torch.float32, "seq_len=100"),
    (128, 16, torch.float32, "head_dim=16"),
    (128, 64, torch.float16, "float16")])
def test_a_device_tensor_the_kernels_refuse_raises(s, d, dtype, reason):
    """Off the CPU there is no plain route: a shape or dtype the kernels
    refuse raises before any kernel is built or launched (meta tensors
    stand in for the card's)."""
    q, k, v = (torch.empty((1, 2, s, d), dtype=dtype, device="meta")
               for _ in range(3))
    before = _launch_counts()
    with pytest.raises(ValueError, match=reason):
        tfa.flash_attention_bnsd(q, k, v, causal=True)
    assert _launch_counts() == before


def test_strided_views_into_a_fused_qkv_buffer_give_the_same_result():
    """The training block passes q, k and v as [B, N, S, D] views into its
    fused [B, S, 3, N, D] output; the result is that of contiguous
    copies."""
    rng = np.random.RandomState(6)
    buf = torch.from_numpy(rng.randn(2, 128, 3, 2, 64).astype(np.float32))
    views = [t.transpose(1, 2) for t in buf.unbind(2)]
    got = tfa.flash_attention_bnsd(*views, causal=True)
    want = tfa.flash_attention_bnsd(*(t.contiguous() for t in views),
                                    causal=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
