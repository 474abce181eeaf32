"""The port's sharding propagation over a captured aten graph held against
the JAX package's over a jaxpr, on the CPU
(``paddle_tpu_torch.distributed.auto_parallel.propagation`` against
``paddle_tpu.distributed.auto_parallel.propagation``).

The port's graph is ``make_fx``'s aten graph, where an einsum or a 4-D
product is a ``bmm`` over merged batch dims ([B, heads] -> B·heads), a
reshape is ``view``/``_unsafe_view`` and a loop is unrolled; the JAX
graph is a jaxpr of ``dot_general``s and ``scan``s.  So each test checks
the spec of the same tensor on both sides (the scores [B, N, S, S], the
projections' outputs [B, S, ·]), and the merged ``bmm`` operands carry
both axes, ("dp", "mp"), in one dim.  The port's pass is given the (2,
4) mesh's axis sizes, which decide how a reshape keeps its axes.

- the Megatron placement re-derived from the input annotations alone
  (the JAX test's block, written in torch);
- conflicting annotations record one reshard;
- the executor on a (2, 4) mesh (``["cpu"] * 8``) against the unplaced
  port and the JAX package's GSPMD run on its 8 CPU devices (rtol 1e-4,
  atol 1e-5);
- ``graph_cost``'s FLOPs exactly the JAX package's and the shapes'
  count;
- the scatter, cumsum and sort rules, and a sharded scattered update's
  reshard;
- the JAX scan tests, unrolled: the same 3-slab loop in Python;
- the port's 2-layer layered GPT captured whole at (dp 2, mp 2): a spec
  for every node and a replicated scalar loss (the JAX counterpart goes
  through its ``Engine``; ``tests/test_torch_engine.py`` holds the
  port's); at head_dim 64 and 128 positions its attention is one flash
  node (output 0 of ``(O, lse)``), head-sharded, which the
  executor runs once a position and layer on the position's block, with
  no call during the capture, and the output equals the unplaced model's
  (rtol 1e-4, atol 1e-5), a vocabulary-parallel word table included.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from paddle_tpu.distributed.auto_parallel import propagation as JP

from paddle_tpu_torch.distributed.auto_parallel import (
    DistSpec, ProcessMesh, apply_propagation, capture_graph, graph_cost,
    parameters_as_inputs, propagate_graph,
)
from paddle_tpu_torch.distributed.auto_parallel.propagation import (
    _ax, _op_name,
)
from paddle_tpu_torch.models import (
    GPTForPretraining, GPTPretrainingCriterion, gpt_tiny,
)
from paddle_tpu_torch.ops.kernels import flash_attention as fa

B, S, H, HEADS, FF = 2, 8, 16, 4, 32
HD = H // HEADS
SIZES = {"dp": 2, "mp": 4}


def _block(x, wqkv, wo, w1, w2):
    qkv = x @ wqkv
    q, k, v = torch.split(qkv, H, dim=-1)
    q = q.reshape(B, S, HEADS, HD)
    k = k.reshape(B, S, HEADS, HD)
    v = v.reshape(B, S, HEADS, HD)
    scores = torch.einsum("bshd,bthd->bhst", q, k)
    probs = torch.softmax(scores, -1)
    ctx = torch.einsum("bhst,bthd->bshd", probs, v).reshape(B, S, H)
    attn = ctx @ wo
    h = x + attn
    ff = torch.nn.functional.gelu(h @ w1) @ w2
    return h + ff


def _jax_block(x, wqkv, wo, w1, w2):
    qkv = x @ wqkv
    q, k, v = jnp.split(qkv, 3, axis=-1)
    q = q.reshape(B, S, HEADS, HD)
    k = k.reshape(B, S, HEADS, HD)
    v = v.reshape(B, S, HEADS, HD)
    scores = jnp.einsum("bshd,bthd->bhst", q, k)
    probs = jax.nn.softmax(scores, -1)
    ctx = jnp.einsum("bhst,bthd->bshd", probs, v).reshape(B, S, H)
    attn = ctx @ wo
    h = x + attn
    ff = jax.nn.gelu(h @ w1, approximate=False) @ w2
    return h + ff


def _block_args():
    rng = np.random.RandomState(0)
    return [rng.randn(*s).astype(np.float32) * 0.1
            for s in [(B, S, H), (H, 3 * H), (H, H), (H, FF), (FF, H)]]


MEGATRON = [("dp", None, None), (None, "mp"), ("mp", None), (None, "mp"),
            ("mp", None)]


def _port_specs():
    return [DistSpec(d) for d in MEGATRON]


def _jax_specs():
    return [JP.DistSpec(d) for d in MEGATRON]


def _nodes(gm, name):
    return [n for n in gm.graph.nodes
            if n.op == "call_function" and _op_name(n) == name]


def _user(node, name):
    """The first user of ``node`` whose op is ``name``."""
    return next(u for u in node.users if _op_name(u) == name)


def _jax_dots():
    closed = JP.capture_jaxpr(_jax_block, *_block_args())
    res = JP.propagate_jaxpr(closed, _jax_specs())
    return [res.var_specs[e.outvars[0]] for e in closed.jaxpr.eqns
            if e.primitive.name == "dot_general"]


def test_propagation_reproduces_megatron_placement():
    """From ONLY the input and parameter annotations the pass re-derives
    the hand-placed Megatron layout on the same tensors as the JAX pass:
    the QKV and FFN-up outputs cut on mp, the scores [B, N, S, S] on (dp,
    mp), both attention products over the merged (dp, mp) batch, the
    row-parallel products mp-partial, the dp shard everywhere."""
    jd = _jax_dots()
    gm = capture_graph(_block, *_block_args())
    res = propagate_graph(gm, _port_specs(), SIZES)
    spec = res.var_specs
    mms = _nodes(gm, "mm")
    qkv, attn_out, ffn_up, ffn_down = (
        spec[_user(m, "_unsafe_view")] for m in mms)
    assert qkv.dims == jd[0].dims == ("dp", None, "mp")
    scores = spec[_nodes(gm, "_softmax")[0].args[0]]
    assert scores.dims == jd[1].dims == ("dp", "mp", None, None)
    for bmm, j in zip(_nodes(gm, "bmm"), (jd[1], jd[2])):
        assert _ax(spec[bmm].dims[0]) == tuple(j.dims[:2]) == ("dp", "mp")
    assert "mp" in attn_out.partial and "mp" in jd[3].partial
    assert attn_out.dims == jd[3].dims == ("dp", None, None)
    assert ffn_up.dims == jd[4].dims == ("dp", None, "mp")
    assert "mp" in ffn_down.partial and "mp" in jd[5].partial
    for m in mms:
        assert spec[m].dims[0] == "dp"


def test_conflicting_annotations_insert_reshard():
    def f(x, y):
        return x + y

    x = np.zeros((4, 8), np.float32)
    res = propagate_graph(capture_graph(f, x, x),
                          [DistSpec(("mp", None)), DistSpec((None, "mp"))])
    jres = JP.propagate_jaxpr(JP.capture_jaxpr(f, x, x),
                              [JP.DistSpec(("mp", None)),
                               JP.DistSpec((None, "mp"))])
    assert len(res.reshards) == len(jres.reshards) == 1
    r = res.reshards[0]
    assert r.primitive == "add" == jres.reshards[0].primitive
    assert r.src.dims != r.dst.dims
    assert r.bytes == 4 * 8 * 4


def test_apply_propagation_executes_on_mesh():
    """The executor over a (2, 4) mesh against the unplaced port and the
    JAX package's run under its (2, 4) mesh of CPU devices."""
    args = _block_args()
    mesh = ProcessMesh(np.arange(8).reshape(2, 4), ["dp", "mp"],
                       device="cpu")
    run = apply_propagation(_block, mesh, _port_specs(), *args)
    out = run(*[torch.from_numpy(a) for a in args])
    assert out.sharding.spec == (("dp",), (), ())
    assert {tuple(b.shape) for b in out.blocks.values()} == {(1, S, H)}
    got = out.gather().numpy()
    ref = _block(*[torch.from_numpy(a) for a in args]).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "mp"))
    jrun = JP.apply_propagation(_jax_block, jmesh, _jax_specs(), *args)
    with jmesh:
        jout = np.asarray(jrun(*args))
    np.testing.assert_allclose(got, jout, rtol=1e-4, atol=1e-5)
    assert run.propagation.reshards is not None


def test_graph_cost_measures_real_flops():
    args = _block_args()
    c = graph_cost(capture_graph(_block, *args), _port_specs(), SIZES)
    jc = JP.graph_cost(JP.capture_jaxpr(_jax_block, *args), _jax_specs())
    # qkv: 2*B*S*H*3H; scores+ctx: 2*2*B*S*S*H; out: 2*B*S*H*H;
    # ffn: 2*2*B*S*H*FF
    expect = (2 * B * S * H * 3 * H + 2 * 2 * B * S * S * H
              + 2 * B * S * H * H + 2 * 2 * B * S * H * FF)
    assert c["flops"] == jc["flops"] == expect
    assert c["bytes"] > 0
    # the one reshard: the split of the mp-cut QKV output gathers it
    assert c["n_reshards"] == 1 and c["comm_bytes"] == B * S * 3 * H * 4


def _slabs(x, w_stack):
    h = x
    for i in range(3):
        h = torch.tanh(h @ w_stack[i])
    return h


def _jax_scan(x, w_stack):
    def body(h, w):
        return jax.nn.tanh(h @ w), ()
    out, _ = jax.lax.scan(body, x, w_stack)
    return out


def test_unrolled_slab_loop_keeps_the_batch_shard():
    """The JAX ``test_scan_carry_fixpoint`` unrolled: the capture has no
    scan (a Python loop runs three slab products), so the carry's spec
    flows through three ``mm``s instead of a fixpoint; the output keeps
    ("dp", None), as the JAX scan's carry does."""
    x = np.zeros((4, 16), np.float32)
    ws = np.zeros((3, 16, 16), np.float32)
    specs = [DistSpec(("dp", None)), DistSpec((None, None, None))]
    res = propagate_graph(capture_graph(_slabs, x, ws), specs)
    jres = JP.propagate_jaxpr(JP.capture_jaxpr(_jax_scan, x, ws),
                              [JP.DistSpec(("dp", None)),
                               JP.DistSpec((None, None, None))])
    assert res.out_specs[0].dims == jres.out_specs[0].dims == ("dp", None)
    assert not res.reshards


def test_unrolled_slab_loop_records_reshards_at_the_products():
    """The JAX ``test_scan_inner_reshards_surface`` unrolled: a carry cut
    on BOTH dims cannot keep its contracting-dim cut through the first
    product, so the reshard is recorded at that ``mm`` (bytes > 0), where
    the JAX pass records it at scan entry (``scan_carry``): the unrolled
    graph has no loop boundary."""
    x = np.zeros((4, 16), np.float32)
    ws = np.zeros((3, 16, 16), np.float32)
    specs = [DistSpec(("dp", "mp")), DistSpec((None, None, None))]
    res = propagate_graph(capture_graph(_slabs, x, ws), specs)
    jres = JP.propagate_jaxpr(JP.capture_jaxpr(_jax_scan, x, ws),
                              [JP.DistSpec(("dp", "mp")),
                               JP.DistSpec((None, None, None))])
    assert any(r.primitive == "scan_carry" for r in jres.reshards)
    assert res.reshards and all(r.primitive == "mm" and r.bytes > 0
                                for r in res.reshards)
    assert not any(r.primitive == "scan_carry" for r in res.reshards)
    assert res.out_specs[0].dims == ("dp", None)


def _scatter(tbl, upd, x):
    # tbl.at[0].set(upd) in its functional torch form
    return (torch.select_scatter(tbl, upd, 0, 0), torch.cumsum(x, 1),
            torch.sort(x, 1)[0])


def _jax_scatter(tbl, upd, x):
    return tbl.at[0].set(upd), jnp.cumsum(x, axis=1), jnp.sort(x, axis=1)


def test_scatter_and_scan_primitive_rules():
    """scatter-family keeps the operand layout; axis-local cumsum/sort
    drop only the scanned axis's shard."""
    tbl = np.zeros((8, 16), np.float32)
    upd = np.zeros((16,), np.float32)
    x = np.zeros((8, 16), np.float32)
    res = propagate_graph(capture_graph(_scatter, tbl, upd, x),
                          [DistSpec(("mp", None)), None,
                           DistSpec(("dp", "mp"))])
    jres = JP.propagate_jaxpr(JP.capture_jaxpr(_jax_scatter, tbl, upd, x),
                              [JP.DistSpec(("mp", None)), None,
                               JP.DistSpec(("dp", "mp"))])
    out_tbl, out_c, out_s = res.out_specs
    assert out_tbl.dims == jres.out_specs[0].dims == ("mp", None)
    assert out_c.dims == jres.out_specs[1].dims == ("dp", None)
    assert out_s.dims == jres.out_specs[2].dims == ("dp", None)


def test_scatter_mismatched_update_records_reshard():
    """A sharded update scattered into a differently laid out operand is
    a real collective: the cost model sees it; set semantics carry no
    pending sum."""
    tbl = np.zeros((8, 16), np.float32)
    upd = np.zeros((16,), np.float32)
    res = propagate_graph(
        capture_graph(lambda t, u: torch.select_scatter(t, u, 0, 0), tbl,
                      upd),
        [DistSpec(("mp", None)), DistSpec(("dp",))])
    assert any(r.primitive == "select_scatter" and r.bytes > 0
               for r in res.reshards)
    assert res.out_specs[0].partial == frozenset()


def test_executor_runs_scatter_scan_and_sort_whole():
    """The same three ops executed on a (2, 4) mesh (each run whole at the
    positions, then cut by its spec) give the unplaced outputs."""
    rng = np.random.RandomState(3)
    args = [rng.randn(8, 16).astype(np.float32),
            rng.randn(16).astype(np.float32),
            rng.randn(8, 16).astype(np.float32)]
    mesh = ProcessMesh(np.arange(8).reshape(2, 4), ["dp", "mp"],
                       device="cpu")
    run = apply_propagation(_scatter, mesh, [DistSpec(("mp", None)), None,
                                             DistSpec(("dp", "mp"))], *args)
    got = run(*[torch.from_numpy(a) for a in args])
    ref = _scatter(*[torch.from_numpy(a) for a in args])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.gather().numpy(), r.numpy())


def _reductions(x):
    return (x.sum(0), x.mean(-1), x.amax(-1), (x * 2.0).sum(),
            torch.softmax(x, -1))


def test_executor_reductions_over_cut_dims():
    """Sums and means over cut dims leave pending partials that the
    executor sums (a mean's blocks scaled to their share of the count);
    a max or softmax over a cut dim gathers it first (one reshard each,
    recorded)."""
    x = np.random.RandomState(4).randn(8, 16).astype(np.float32)
    mesh = ProcessMesh(np.arange(8).reshape(2, 4), ["dp", "mp"],
                       device="cpu")
    run = apply_propagation(_reductions, mesh, [DistSpec(("dp", "mp"))], x)
    res = run.propagation
    assert [r.primitive for r in res.reshards] == ["amax", "_softmax"]
    assert res.out_specs[0].dims == ("mp",)
    assert "dp" in res.out_specs[0].partial
    assert res.out_specs[1].dims == ("dp",)
    assert "mp" in res.out_specs[1].partial
    got = run(torch.from_numpy(x))
    for g, r in zip(got, _reductions(torch.from_numpy(x))):
        np.testing.assert_allclose(g.gather().numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the port's layered GPT
# ---------------------------------------------------------------------------

def megatron_spec(name, ndim):
    """Megatron placements of the layered GPT's weights (``[in, out]``):
    QKV and FFN-up column-parallel, out and FFN-down row-parallel, the
    word table cut by vocabulary rows; the rest replicated."""
    if name.endswith(("qkv_proj.weight", "fc1.weight")):
        return DistSpec((None, "mp"))
    if name.endswith(("qkv_proj.bias", "fc1.bias")):
        return DistSpec(("mp",))
    if name.endswith(("out_proj.weight", "fc2.weight",
                      "word_embeddings.weight")):
        return DistSpec(("mp", None))
    return None


def _gpt(hidden, heads):
    cfg = gpt_tiny(hidden_size=hidden, num_heads=heads, num_layers=2,
                   hidden_dropout=0.0, attention_dropout=0.0)
    return GPTForPretraining(cfg, device="cpu", seed=5).eval(), cfg


def test_propagation_through_the_layered_gpt():
    """The port's 2-layer ``gpt_tiny`` with its loss, captured whole and
    propagated at (dp 2, mp 2): every node gets a spec, the loss a
    replicated scalar's."""
    model, cfg = _gpt(64, 4)
    crit = GPTPretrainingCriterion(cfg)
    fwd, names, tensors = parameters_as_inputs(model)

    def loss(*a):
        return crit(fwd(*a[:-1]), a[-1])

    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 16))
    gm = capture_graph(loss, *tensors, ids, ids)
    specs = [megatron_spec(n, t.dim()) for n, t in zip(names, tensors)] \
        + [DistSpec(("dp", None))] * 2
    res = propagate_graph(gm, specs, {"dp": 2, "mp": 2})
    nodes = [n for n in gm.graph.nodes
             if n.op in ("placeholder", "call_function", "get_attr")]
    assert len(nodes) > 100
    assert all(n in res.var_specs for n in nodes)
    assert res.out_specs[0].dims == ()                # scalar loss


def test_flash_node_is_one_head_sharded_node_run_on_blocks(monkeypatch):
    """At head_dim 64 and 128 positions the layered GPT's attention is the
    flash node, once a layer, its output cut (dp, mp) on [B, N, S, D].
    The capture calls no kernel wrapper; the executor calls the forward
    once a position and layer at the position's block (the card's launch
    count), and gives the unplaced model's output."""
    model, cfg = _gpt(256, 4)
    fwd, names, tensors = parameters_as_inputs(model)
    calls = []
    real = fa.flash_attention_fwd

    def counted(q, k, v, causal, scale):
        calls.append(tuple(q.shape))
        return real(q, k, v, causal, scale)
    monkeypatch.setattr(fa, "flash_attention_fwd", counted)
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, (4, 128))
    gm = capture_graph(fwd, *tensors, ids)
    assert calls == []
    flash = _nodes(gm, "flash_attention")
    assert len(flash) == 2
    specs = [megatron_spec(n, t.dim()) for n, t in zip(names, tensors)] \
        + [DistSpec(("dp", None))]
    mesh = ProcessMesh(np.arange(4).reshape(2, 2), ["dp", "mp"],
                       device="cpu")
    run = apply_propagation(fwd, mesh, specs, *tensors, ids)
    res = run.propagation
    for n in _nodes(res.graph, "flash_attention"):
        out_spec, lse_spec = res.var_specs[n]           # (O, lse)
        assert out_spec.dims == ("dp", "mp", None, None)
        assert lse_spec.dims == ("dp", "mp", None)
    assert calls == []
    out = run(*tensors, torch.from_numpy(ids))
    assert calls == [(2, 2, 128, 64)] * (4 * 2)       # positions x layers
    with torch.no_grad():
        ref = fwd(*tensors, torch.from_numpy(ids))
    np.testing.assert_allclose(out.gather().numpy(), ref.numpy(),
                               rtol=1e-4, atol=1e-5)
