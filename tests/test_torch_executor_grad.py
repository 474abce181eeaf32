"""Gradients through auto_parallel's propagation executor, on the CPU
(``paddle_tpu_torch.distributed.auto_parallel.propagation.
apply_propagation(..., grad=True)`` and the flash attention node's
autograd formula, ``ops/kernels/flash_attention.py``).

- the node returns ``(O, lse)``; on CPU tensors its gradients are
  autograd's through the plain forward, O's and lse's both, and the same
  values through the JAX package's reference attention (``jax.vjp`` of
  ``_xla_reference_bnsd``, rtol 1e-5); a graph captured on fake tensors
  holds it as one node of two outputs, and ``flash_attention_bnsd`` on
  fake tensors takes output 0;
- the layered GPT (head_dim 64, 128 positions: the flash node) with its
  loss over (dp 2, mp 2) on ``["cpu"] * 4``: the loss and every
  parameter's gradient equal the unplaced model's backward (relative
  norm 1e-6), the forward node run once a position and layer;
- ``gpt_tiny``'s 4 heads at (dp 1, mp 8), where the pass may not cut
  heads, and a slice of a column-cut product to a width the mesh axis
  does not divide: the slice's output is held whole, and the gradients
  equal the unplaced ones;
- a random node (dropout) draws once: over a mesh of two distinct
  devices both positions hold the same mask, and the op is called once;
- an in-place node on a tensor autograd saved (``exp`` then ``mul_``,
  which eager autograd refuses) runs out of place, with the out-of-place
  function's gradients; an in-place update of an argument raises;
- ``grad=False`` (the default) keeps the forward under ``no_grad``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas_kernels import flash_attention as jfa

from paddle_tpu_torch.distributed import mesh as M
from paddle_tpu_torch.distributed.auto_parallel import (
    DistSpec, ProcessMesh, apply_propagation, capture_graph,
    parameters_as_inputs,
)
from paddle_tpu_torch.distributed.auto_parallel.propagation import _op_name
from paddle_tpu_torch.models import (
    GPTForPretraining, GPTPretrainingCriterion, gpt_tiny,
)
from paddle_tpu_torch.ops.kernels import flash_attention as fa

torch.set_num_threads(2)

GRAD_REL = 1e-6
# the ops a captured dropout draws its mask with (make_fx decomposes it
# into bernoulli on the CPU)
DRAWS = ("native_dropout", "bernoulli")


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _qkv(seed, shape=(2, 3, 128, 64)):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32))
            for _ in range(3)]


def test_node_autograd_on_the_cpu_is_the_plain_forwards():
    """O's and lse's gradients through the node equal autograd through
    ``flash_attention_plain`` and the JAX reference's VJP."""
    q, k, v = _qkv(0)
    rng = np.random.RandomState(1)
    do = torch.from_numpy(rng.randn(*q.shape).astype(np.float32))
    dl = torch.from_numpy(rng.randn(*q.shape[:3]).astype(np.float32))
    scale = 0.125
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = fa.flash_attention_node(*leaves, True, scale)
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    torch.autograd.backward((out, lse), (do, dl))
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    o2, l2 = fa.flash_attention_plain(*ref, True, scale)
    torch.autograd.backward((o2, l2), (do, dl.reshape(-1, q.shape[2])))
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-7)
    # O's gradient alone against the JAX reference's VJP
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention_node(*leaves, True, scale)[0].backward(do)
    _, vjp = jax.vjp(lambda a, b, c: jfa._xla_reference_bnsd(
        a, b, c, True, scale), *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for a, g in zip(leaves, vjp(jnp.asarray(do.numpy()))):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-5)


def test_node_is_one_captured_node_of_two_outputs():
    q, k, v = _qkv(2)
    gm = capture_graph(lambda a, b, c: fa.flash_attention_bnsd(
        a, b, c, causal=True), q, k, v)
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"
             and _op_name(n) == "flash_attention"]
    assert len(nodes) == 1
    out, lse = nodes[0].meta["val"]
    assert tuple(out.shape) == tuple(q.shape)
    assert tuple(lse.shape) == tuple(q.shape[:3])
    assert lse.dtype == torch.float32


def _megatron(name, nd, mp="mp"):
    if name.endswith(("qkv_proj.weight", "fc1.weight")):
        return DistSpec((None, mp))
    if name.endswith(("qkv_proj.bias", "fc1.bias", "out_proj.weight",
                      "fc2.weight")):
        return DistSpec((mp,) + (None,) * (nd - 1))
    if name.endswith("word_embeddings.weight"):
        return DistSpec((mp, None))
    return None


def _gpt_grads(hidden, heads, seq, batch, shape):
    """(placed loss, unplaced loss, worst relative gradient norm) of the
    layered GPT and its loss over a (dp, mp) ``shape`` mesh on the CPU."""
    cfg = gpt_tiny(hidden_size=hidden, num_heads=heads,
                   max_position_embeddings=seq, hidden_dropout=0.0,
                   attention_dropout=0.0)
    model = GPTForPretraining(cfg, device="cpu", seed=5)
    crit = GPTPretrainingCriterion(cfg)
    fwd, names, tensors = parameters_as_inputs(model)

    def loss(*a):
        return crit(fwd(*a[:-1]), a[-1])

    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq)))
    specs = [_megatron(n, t.dim()) for n, t in zip(names, tensors)] \
        + [DistSpec(("dp", None))] * 2
    mesh = ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape),
                       ["dp", "mp"], device="cpu")
    run = apply_propagation(loss, mesh, specs, *tensors, ids, ids,
                            grad=True)
    live = [t.clone().requires_grad_() for t in tensors]
    got = run(*live, ids, ids).gather()
    got.backward()
    ref_live = [t.clone().requires_grad_() for t in tensors]
    want = loss(*ref_live, ids, ids)
    want.backward()
    worst = max(_rel(a.grad, b.grad) for a, b in zip(live, ref_live))
    return float(got), float(want), worst


def test_gradients_through_the_executor_equal_the_unplaced(monkeypatch):
    """(dp 2, mp 2) on four CPU positions, the attention the flash node:
    the loss and every gradient equal the unplaced backward's."""
    calls = []
    real = fa.flash_attention_fwd

    def counted(q, k, v, causal, scale):
        calls.append(tuple(q.shape))
        return real(q, k, v, causal, scale)
    monkeypatch.setattr(fa, "flash_attention_fwd", counted)
    got, want, worst = _gpt_grads(256, 4, 128, 4, (2, 2))
    assert abs(got - want) <= 1e-6 * abs(want)
    assert worst <= GRAD_REL, worst
    # the unplaced reference adds one whole-batch call a layer
    placed = [c for c in calls if c == (2, 2, 128, 64)]
    assert len(placed) == 4 * 2                      # positions x layers


def test_heads_the_mesh_axis_does_not_divide():
    """gpt_tiny's 4 heads at mp 8 (the JAX planner can pick that mesh)."""
    got, want, worst = _gpt_grads(64, 4, 16, 8, (1, 8))
    assert abs(got - want) <= 1e-6 * abs(want)
    assert worst <= GRAD_REL, worst


def test_an_output_dim_the_axis_does_not_divide_is_held_whole():
    """A column-cut product sliced to 3 columns at mp 8: the slice's
    output is held whole (run whole), not cut by an axis that does not
    divide it, and the gradients are the unplaced ones."""
    def f(x, w):
        y = x @ w
        return (y[:, :3] * 2.0).sum()

    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(4, 5).astype(np.float32))
    w = torch.from_numpy(rng.randn(5, 16).astype(np.float32))
    mesh = ProcessMesh(np.arange(8).reshape(1, 8), ["dp", "mp"],
                       device="cpu")
    run = apply_propagation(f, mesh, [None, DistSpec((None, "mp"))], x, w,
                            grad=True)
    res = run.propagation
    sl = next(n for n in res.graph.graph.nodes
              if n.op == "call_function" and _op_name(n) == "slice")
    assert res.var_specs[sl].dims == (None, None)
    assert res.plan[sl][2]                            # run whole
    wl = w.clone().requires_grad_()
    out = run(x, wl).gather()
    out.backward()
    wr = w.clone().requires_grad_()
    ref = f(x, wr)
    ref.backward()
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(wl.grad, wr.grad, rtol=1e-6, atol=1e-6)


def test_a_random_node_draws_once_for_every_position():
    """Dropout over a mesh of two distinct devices (``cpu`` and
    ``cpu:0``): one draw on the first position's device, the same mask
    at both positions, as GSPMD's one global mask."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._overloadpacket.__name__ in DRAWS:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    def f(x):
        return torch.nn.functional.dropout(x, 0.5, training=True) * 3.0

    x = torch.ones((8, 64))
    mesh = M.build_mesh({"dp": 2}, ["cpu", "cpu:0"])
    run = apply_propagation(f, mesh, [None], x, grad=True)
    assert sum(_op_name(n) in DRAWS
               for n in run.propagation.graph.graph.nodes
               if n.op == "call_function") == 1
    xl = x.clone().requires_grad_()
    torch.manual_seed(0)
    with Count():
        out = run(xl)
    assert Count.n == 1
    a, b = out.on((0,)), out.on((1,))
    assert torch.equal(a, b)
    kept = a != 0
    assert 0 < int(kept.sum()) < a.numel()
    out.gather().sum().backward()
    torch.testing.assert_close(xl.grad, kept.float() * 6.0)


def test_an_inplace_node_on_a_saved_tensor_runs_out_of_place():
    """``exp`` saves its output, which ``mul_`` then updates: eager
    autograd refuses the backward; the executor's graph (captured again
    through functionalize) holds no in-place node and gives the
    out-of-place function's gradients."""
    def f(x):
        y = x.exp()
        y.mul_(2.0)
        return (y * x).sum()

    def g(x):
        return (x.exp() * 2.0 * x).sum()

    x = torch.from_numpy(np.random.RandomState(4).randn(4, 8)
                         .astype(np.float32))
    with pytest.raises(RuntimeError, match="inplace"):
        f(x.clone().requires_grad_()).backward()
    mesh = ProcessMesh(np.arange(2).reshape(2, 1), ["dp", "mp"],
                       device="cpu")
    run = apply_propagation(f, mesh, [DistSpec(("dp", None))], x, grad=True)
    names = [_op_name(n) for n in run.propagation.graph.graph.nodes
             if n.op == "call_function"]
    assert not any(n.endswith("_") for n in names), names
    xl = x.clone().requires_grad_()
    run(xl).gather().backward()
    xr = x.clone().requires_grad_()
    g(xr).backward()
    torch.testing.assert_close(xl.grad, xr.grad, rtol=1e-6, atol=1e-6)

    def h(x):
        x.add_(1.0)
        return x.sum()
    with pytest.raises(ValueError, match="argument in place"):
        apply_propagation(h, mesh, [None], x.clone())


def test_the_forward_stays_under_no_grad_by_default():
    x = torch.ones((4, 6))
    w = torch.ones((6, 8), requires_grad=True)
    pm = ProcessMesh([0, 1], ["mp"], device="cpu")
    run = apply_propagation(torch.mm, pm, [None, DistSpec((None, "mp"))],
                            x, w)
    out = run(x, w).gather()
    assert out.grad_fn is None and not out.requires_grad
    torch.testing.assert_close(out, x @ w.detach())
