"""Sequence parallelism with ring attention: the port
(``paddle_tpu_torch/nn/functional/ring_attention.py`` and the layered
GPT's sequence parts, ``models/gpt.py`` ``layered_sp``) held against the
JAX package on the CPU, the JAX side on the conftest's 8 host devices,
the port's mesh positions all on the CPU.  Inputs are numpy draws from
fixed seeds; everything is fp32.

- ``ring_attention`` equals the JAX ``ring_attention`` at sp 1, 2 and 4,
  causal and not, with its input gradients (1e-5 relative and absolute
  for the output, 1e-4 for the gradients: the same fp32 arithmetic,
  blocks merged in another form).
- ``RingAttention`` (the flash kernels' plain versions on the CPU, merged
  by lse) equals ``ring_attention_plain`` (the reference's m/l merge):
  outputs, lse and gradients within 1e-5; each block pair reaches each
  flash wrapper once; a block the card's kernels refuse raises naming
  ``ROADMAP.md`` queue 2.
- The tiny layered GPT with ``sequence_parallel`` at ``{"sp": 2}``,
  ``{"sp": 4}`` and ``{"sp": 2, "mp": 2}`` carries the JAX model's weights
  (``load_jax_state``, unchanged) and gives its logits (2e-5 + 1e-5
  relative), loss (1e-6 relative) and every gradient (within 1e-5 of each
  parameter's largest), as ``tests/test_torch_layered_gpt.py`` holds the
  unplaced model; recompute gives the gradients of the run without it;
  the flash wrappers are reached mp x L x sp(sp+1)/2 times each a step.
- Without the ring's condition (a mask, or attention dropout) the parts
  attend over q, k and v gathered along the sequence: equal to the
  unplaced model with the same mask, and under dropout reproducible from
  one seed with no ring block.
- Mesh positions on CPU devices of their own (``cpu:i``) stand for
  distinct cards: each sp position from 1 on holds a copy of the body,
  tied to the others, with the same results, every copy holding its
  source's summed gradient and equal to it after a step.
- An sp axis without ``sequence_parallel`` and a sep axis are read at
  coordinate 0: bit for bit the run without the axis, for the layered
  and the stacked model (the fleet wrappers' at sep 2 are
  ``tests/test_torch_package.py``'s and ``test_torch_fleet_hybrid.py``'s)."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.distributed import mesh as JM
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn.functional.ring_attention import (
    ring_attention as jax_ring_attention,
)

from paddle_tpu_torch.distributed import mesh as M
from paddle_tpu_torch.distributed.sharding import gathered_grads
from paddle_tpu_torch.models import (
    GPTForPretraining, GPTPretrainingCriterion, GPTStackedForPretraining,
    gpt_tiny,
)
from paddle_tpu_torch.nn.functional import ring_attention as R

torch.set_num_threads(2)

NO_DROP = dict(hidden_dropout=0.0, attention_dropout=0.0)
RING_SHAPE = (2, 16, 4, 8)            # B, S, N, D
GPT_MESHES = [{"sp": 2}, {"sp": 4}, {"sp": 2, "mp": 2}]


@pytest.fixture
def mesh():
    """Set the port's global mesh over CPU positions; clear it after."""
    def set_(axes):
        M.set_mesh(None if axes is None else M.build_mesh(
            axes, ["cpu"] * int(np.prod(list(axes.values())))))
    yield set_
    M.set_mesh(None)


def _np(t):
    return np.asarray(t.numpy(), np.float32)


def _jax_mesh(axes):
    """The JAX package's mesh of ``axes`` (its sequence sharding names
    dp too), or none."""
    JM.set_mesh(None if axes is None else JM.build_mesh({"dp": 1, **axes}))


# ---------------------------------------------------------------------------
# ring attention against the JAX function
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ring_inputs():
    rng = np.random.RandomState(0)
    return [rng.randn(*RING_SHAPE).astype(np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def jax_ring(ring_inputs):
    """{(sp, causal): (out, dq, dk, dv)} of the JAX ``ring_attention`` for
    the cotangent ``ring_inputs[3]``."""
    q, k, v, cot = ring_inputs
    out = {}
    try:
        for sp in (1, 2, 4):
            _jax_mesh({"sp": sp} if sp > 1 else None)
            for causal in (True, False):
                ts = [pt.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
                o = jax_ring_attention(*ts, causal=causal)
                pt.ops.sum(o * pt.to_tensor(cot)).backward()
                out[sp, causal] = [_np(o)] + [_np(t.grad) for t in ts]
    finally:
        JM.set_mesh(None)
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sp", [1, 2, 4])
def test_ring_attention_matches_jax(jax_ring, ring_inputs, mesh, sp, causal):
    q, k, v, cot = ring_inputs
    mesh({"sp": sp} if sp > 1 else None)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = R.ring_attention(*ts, causal=causal)
    (o * torch.from_numpy(cot)).sum().backward()
    want = jax_ring[sp, causal]
    np.testing.assert_allclose(o.detach().numpy(), want[0], rtol=1e-5,
                               atol=1e-5)
    for name, t, w in zip("qkv", ts, want[1:]):
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg="d" + name)


# ---------------------------------------------------------------------------
# the Function against the reference's arithmetic
# ---------------------------------------------------------------------------

class _Counted:
    """Count the calls of the ring module's three flash wrappers (each one
    launch on the card; on the CPU their plain versions run)."""

    NAMES = ("flash_attention_fwd", "flash_attention_bwd_dkv",
             "flash_attention_bwd_dq")

    def __init__(self, monkeypatch):
        self.n = dict.fromkeys(self.NAMES, 0)
        for name in self.NAMES:
            fn = getattr(R, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                self.n[_name] += 1
                return _fn(*a, **kw)
            monkeypatch.setattr(R, name, counted)

    def counts(self):
        return tuple(self.n[k] for k in self.NAMES)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sp", [2, 4])
def test_ring_function_matches_plain(ring_inputs, monkeypatch, sp, causal):
    q, k, v, cot = ring_inputs
    n = RING_SHAPE[1] // sp

    def shards(*arrays):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        return ts, [list(t.split(n, 1)) for t in ts]

    count = _Counted(monkeypatch)
    (tq, tk, tv), (qs, ks, vs) = shards(q, k, v)
    res = R.RingAttention.apply(causal, *qs, *ks, *vs)
    outs, lses = res[:sp], res[sp:]
    pairs = sp * (sp + 1) // 2 if causal else sp * sp
    assert count.counts() == (pairs, 0, 0)
    assert len(R.ring_blocks(sp, causal)) == pairs
    (torch.cat(outs, 1) * torch.from_numpy(cot)).sum().backward()
    assert count.counts() == (pairs, pairs, pairs)
    (pq, pk, pv), (pqs, pks, pvs) = shards(q, k, v)
    pouts, plses = R.ring_attention_plain(pqs, pks, pvs, causal)
    (torch.cat(pouts, 1) * torch.from_numpy(cot)).sum().backward()
    for a, b in zip(outs + lses, pouts + plses):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
    for a, b in ((tq, pq), (tk, pk), (tv, pv)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_ring_refuses_blocks_the_kernels_refuse():
    """Off the CPU a shard's block must be one the flash kernels take (seq
    a 128-multiple, head_dim 64 or 128): else ``ValueError`` naming queue
    2, before any launch."""
    q = torch.empty((1, 96, 2, 64), device="meta")
    with pytest.raises(ValueError, match=r"ROADMAP\.md queue 2"):
        R.RingAttention.apply(True, q, q, q, q, q, q)


# ---------------------------------------------------------------------------
# the layered GPT on sp meshes against the JAX model
# ---------------------------------------------------------------------------

def _jax_state(seed=0):
    pt.seed(seed)
    m = JaxGPT(jax_gpt_tiny(**NO_DROP))
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in m.state_dict().items():
        a = _np(v)
        if k.endswith(("bias", "ln1.weight", "ln2.weight", "final_ln.weight")):
            a = a + 0.1 * rng.randn(*a.shape).astype(np.float32)
        out[k] = a
    return out


def _gpt_ids():
    return np.random.RandomState(1).randint(0, 1024, (2, 16))


@pytest.fixture(scope="module")
def state():
    return _jax_state()


@pytest.fixture(scope="module")
def jax_gpt(state):
    """The JAX layered GPT with ``sequence_parallel`` on each mesh of
    GPT_MESHES (``use_tensor_parallel`` at mp > 1), one training step's
    forward and backward under ``jit.to_static`` on the same weights and
    ids: {mesh key: (logits, loss, gradients by name)}, and the state."""
    ids = pt.to_tensor(_gpt_ids(), dtype="int64")
    out = {}
    try:
        for axes in GPT_MESHES:
            _jax_mesh(axes)
            cfg = jax_gpt_tiny(**NO_DROP, sequence_parallel=True,
                               use_tensor_parallel="mp" in axes)
            m = JaxGPT(cfg)
            m.set_state_dict(state)
            crit = JaxCriterion(cfg)

            @pt.jit.to_static
            def step(x):
                logits = m(x)
                loss = crit(logits, x)
                loss.backward()
                return logits, loss, [p.grad for p in m.parameters()]

            logits, loss, grads = step(ids)
            out[str(axes)] = (_np(logits), float(loss.numpy()), {
                n: _np(g) for (n, _), g in zip(m.named_parameters(), grads)})
    finally:
        JM.set_mesh(None)
    return state, out


def _port_grads(m):
    """Every gradient of ``m`` by state-dict key, a cut tensor's
    gathered."""
    return {k: g.numpy() for k, g in gathered_grads(m).items()}


def _port_sp(state, axes, mesh, **cfg):
    """The port's layered GPT with ``sequence_parallel`` on ``axes``
    carrying ``state``."""
    mesh(axes)
    cfg = gpt_tiny(**{**NO_DROP, **cfg}, sequence_parallel=True,
                   use_tensor_parallel="mp" in axes)
    m = GPTForPretraining(cfg, **({} if "mp" in axes else {"device": "cpu"}))
    m.load_jax_state(state)
    return m, GPTPretrainingCriterion(cfg)


def _grads_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("axes", GPT_MESHES, ids=str)
def test_layered_gpt_sequence_parallel_matches_jax(jax_gpt, mesh, axes,
                                                   monkeypatch):
    state, runs = jax_gpt
    want_logits, want_loss, want_grads = runs[str(axes)]
    m, crit = _port_sp(state, axes, mesh)
    sp, mp = axes["sp"], axes.get("mp", 1)
    assert m.gpt.sequence_parts == sp
    assert list(m.state_dict()) == list(state)
    count = _Counted(monkeypatch)
    ids = torch.from_numpy(_gpt_ids())
    logits = m(ids)
    loss = crit(logits, ids)
    loss.backward()
    pairs = mp * m.config.num_layers * sp * (sp + 1) // 2
    assert count.counts() == (pairs, pairs, pairs)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               rtol=1e-5, atol=2e-5)
    assert abs(loss.item() - want_loss) <= 1e-6 * abs(want_loss)
    _grads_close(_port_grads(m), want_grads)


def test_layered_gpt_sequence_parallel_recompute(jax_gpt, mesh):
    """``recompute_interval`` 1 and 2 give the gradients of the run
    without recompute (the JAX model's; its eager recompute leaves them
    None)."""
    state, runs = jax_gpt
    _, want_loss, want_grads = runs[str({"sp": 2})]
    ids = torch.from_numpy(_gpt_ids())
    for k in (1, 2):
        m, crit = _port_sp(state, {"sp": 2}, mesh, recompute_interval=k)
        m.train()
        loss = crit(m(ids), ids)
        loss.backward()
        assert abs(loss.item() - want_loss) <= 1e-6 * abs(want_loss)
        _grads_close(_port_grads(m), want_grads)


def test_gathered_route_under_a_mask(state, mesh, monkeypatch):
    """With ``attn_mask`` the parts attend over the gathered sequence (no
    ring block): the unplaced model's logits and gradients under the
    same additive causal mask, at sp 2 and at sp 2 x mp 2."""
    ids = torch.from_numpy(_gpt_ids())
    s = ids.shape[1]
    mask = torch.zeros((s, s)).masked_fill(
        ~torch.ones((s, s), dtype=torch.bool).tril(), -1e9)[None, None]
    mesh(None)
    ref = GPTForPretraining(gpt_tiny(**NO_DROP), device="cpu")
    ref.load_jax_state(state)
    want = ref(ids, attn_mask=mask)
    want.square().mean().backward()
    want_grads = {k: p.grad.numpy() for k, p in ref.named_parameters()}
    for axes in ({"sp": 2}, {"sp": 2, "mp": 2}):
        m, _ = _port_sp(state, axes, mesh)
        count = _Counted(monkeypatch)
        got = m(ids, attn_mask=mask)
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), rtol=1e-5,
                                   atol=2e-5)
        got.square().mean().backward()
        assert count.counts() == (0, 0, 0)
        _grads_close(_port_grads(m), want_grads)


def test_gathered_route_under_attention_dropout(state, mesh, monkeypatch):
    """Attention dropout takes the gathered route: in training no ring
    block runs, the loss is finite and reproducible from one seed, and
    differs from the run without dropout; in eval (no dropout) the logits
    are the unplaced model's."""
    ids = torch.from_numpy(_gpt_ids())
    cfg = dict(hidden_dropout=0.0, attention_dropout=0.2)

    def ring_called(*a, **kw):
        raise AssertionError("the ring ran under attention dropout")

    losses = []
    for run in range(2):
        m, crit = _port_sp(state, {"sp": 2}, mesh, **cfg)
        with monkeypatch.context() as mp:
            mp.setattr(R.RingAttention, "apply", ring_called)
            m.train()
            losses.append(crit(m(ids), ids))
        if run == 0:
            m.eval()
            got = m(ids)
    assert torch.isfinite(losses[0]) and torch.equal(losses[0], losses[1])
    mesh(None)
    ref = GPTForPretraining(gpt_tiny(**cfg), device="cpu")
    ref.load_jax_state(state)
    ref.eval()
    np.testing.assert_allclose(got.detach().numpy(),
                               ref(ids).detach().numpy(), rtol=1e-5,
                               atol=2e-5)
    m, crit = _port_sp(state, {"sp": 2}, mesh)
    m.train()
    assert crit(m(ids), ids).item() != losses[0].item()


# ---------------------------------------------------------------------------
# axes no model reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes,without", [
    ({"sp": 2}, None), ({"sep": 2}, None), ({"sp": 2, "mp": 2}, {"mp": 2}),
    ({"sep": 2, "mp": 2}, {"mp": 2})], ids=str)
def test_unread_axes_equal_the_run_without(mesh, axes, without):
    """sp without ``sequence_parallel`` and sep: the layered model's
    logits and gradients, and the stacked model's loss and gradients,
    bit for bit the mesh's without the axis (the stacked model with
    ``sequence_parallel`` too: its block never reads sp)."""
    ids = torch.from_numpy(_gpt_ids())
    results = []
    for ax in (axes, without):
        mesh(ax)
        tp = "mp" in axes
        lay = GPTForPretraining(gpt_tiny(**NO_DROP, use_tensor_parallel=tp),
                                seed=3, **({} if tp else {"device": "cpu"}))
        assert lay.gpt.sequence_parts == 1
        logits = lay(ids)
        logits.square().mean().backward()
        stk = GPTStackedForPretraining(
            gpt_tiny(**NO_DROP, sequence_parallel=True,
                     use_tensor_parallel=tp), device="cpu", seed=3)
        loss = stk(ids, labels=ids)
        loss.backward()
        results.append((logits, _port_grads(lay), loss,
                        [p.grad for p in stk.parameters()]))
    (la, ga, sa, gsa), (lb, gb, sb, gsb) = results
    assert torch.equal(la, lb) and torch.equal(sa, sb)
    for k in gb:
        np.testing.assert_array_equal(ga[k], gb[k], err_msg=k)
    assert len(gsa) == len(gsb) and all(torch.equal(a, b)
                                        for a, b in zip(gsa, gsb))


# ---------------------------------------------------------------------------
# sp positions on devices of their own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes", GPT_MESHES, ids=str)
def test_sp_positions_on_cards_of_their_own(jax_gpt, axes):
    """Mesh positions on CPU devices of their own (``cpu:i``, as distinct
    cards are): each sp position from 1 on holds a copy of the body, and
    the copies are tied.  The JAX model's logits, loss and gradients (at
    sp 2 x mp 2 under recompute, which replays the binding); every copy
    holds its source's gradient, the sum over the parts; the state dict
    is the unplaced model's; after an AdamW step every copy still equals
    its source, and the next loss is the one-card run's within 1e-6."""
    from paddle_tpu_torch.distributed.shards import replica_of
    from paddle_tpu_torch.optimizer import AdamW

    state, runs = jax_gpt
    want_logits, want_loss, want_grads = runs[str(axes)]
    sp, tp = axes["sp"], "mp" in axes
    n = int(np.prod(list(axes.values())))
    ids = torch.from_numpy(_gpt_ids())
    after = []
    for devices in (["cpu"] * n, [f"cpu:{i}" for i in range(n)]):
        M.set_mesh(M.build_mesh(axes, devices))
        try:
            cfg = gpt_tiny(**NO_DROP, sequence_parallel=True,
                           use_tensor_parallel=tp,
                           recompute_interval=1 if tp else 0)
            m = GPTForPretraining(cfg, **({} if tp else {"device": "cpu"}))
            m.load_jax_state(state)
            crit = GPTPretrainingCriterion(cfg)
            own = devices[1] != "cpu"
            assert len(m.gpt.sequence_copies) == (sp - 1 if own else 0)
            assert list(m.state_dict()) == list(state)
            m.train()
            logits = m(ids)
            loss = crit(logits, ids)
            loss.backward()
            np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                                       rtol=1e-5, atol=2e-5)
            assert abs(loss.item() - want_loss) <= 1e-6 * abs(want_loss)
            _grads_close(_port_grads(m), want_grads)
            copies = [p for p in m.parameters() if replica_of(p) is not None]
            body = len(list(m.gpt.parameters())) - len(copies)
            assert len(copies) == (sp - 1 if own else 0) * body
            for p in copies:
                assert torch.equal(p.grad, replica_of(p).grad)
            opt = AdamW(1e-3, parameters=m.parameters())
            opt.step()
            for p in copies:
                assert torch.equal(p, replica_of(p))
            with torch.no_grad():
                after.append(crit(m(ids), ids).item())
        finally:
            M.set_mesh(None)
    assert abs(after[1] - after[0]) <= 1e-6 * abs(after[0])
