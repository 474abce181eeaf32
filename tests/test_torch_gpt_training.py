"""The port's training slice held against the JAX package on the CPU.

Both models start from the same weights (the JAX model's, with every bias
and LayerNorm gain perturbed off its 0/1 init, carried across by
``load_jax_state``) at ``gpt_tiny(hidden_size=128, num_heads=2)``: head_dim
64 and seq 128, so the flash gate passes and the port's block takes its
flash-attention path (the plain version, on the CPU).  Batch 2 x seq 128.

- The first step's loss and every parameter's gradient match the JAX
  model's, with and without per-block recompute: fp32 within 1e-5 of the
  largest gradient of each parameter.
- Three ``FusedTrainStep`` steps of ``AdamW(multi_precision=False)`` give
  the JAX package's losses, and then its parameters.  AdamW's first steps
  move an element by about ``lr * sign(g)`` whatever the size of g, so
  where a gradient is ~0 the two sides may step opposite ways: the
  parameter tolerance allows ``2 * lr`` per step, and the bulk (99.9 % of
  the elements) must agree to 1e-6 in fp32.  The bf16 case (the bench
  regime: bf16 weights and moments, O1) allows one bf16 rounding
  (2^-7 relative) on top, and 1e-3 on the losses.
- The serving step still builds no autograd graph now that the
  parameters are trainable.
- Dropout (the config's default 0.1, and the attention dropout that
  sends attention to the reference's plain causal route): a model with
  dropout equals the JAX model in ``eval()`` and at p = 0; a step with
  dropout equals the JAX step when both draw the same masks.  The JAX
  package draws its masks with ``jax.random.bernoulli`` and the port with
  ``nn/functional/common.keep_mask``; the tests that hold one to the other
  patch both, in the test only, to return one fixed numpy mask for each
  (shape, keep probability), so every layer and site of one shape sees
  the same mask on both sides, whatever order ``scan`` traces them in.
  Gradients within 1e-5 of the largest gradient of each parameter, as
  above.  Recompute on and off, and one generator seed twice, give the
  same bits; the kept share lies within 5 binomial sigmas of 1 - p.
- ``use_flash_attention=False`` gives the JAX plain route's loss and
  gradients; ``GPTPretrainingCriterion`` with and without ``loss_mask``
  gives the JAX criterion's loss (fp32, 1e-6 relative)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import GPTStackedForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny

from paddle_tpu_torch.models import (
    GPTPretrainingCriterion, GPTStackedForPretraining, gpt_tiny,
)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn.functional import common as tcommon
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.optimizer import AdamW, FusedTrainStep
from paddle_tpu_torch.serving import ServingEngine

torch.set_num_threads(2)

CFG = dict(hidden_size=128, num_heads=2, hidden_dropout=0.0,
           attention_dropout=0.0)
BATCH, SEQ, LR, STEPS = 2, 128, 1e-4, 3


@pytest.fixture(scope="module")
def state():
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


def _batches(n, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 1024, (BATCH, SEQ)),
             rng.randint(0, 1024, (BATCH, SEQ))) for _ in range(n)]


def _jax_model(state, **kw):
    m = JaxGPT(jax_gpt_tiny(**{**CFG, **kw}))
    m.set_state_dict(state)
    return m


def _port_model(state, dtype="float32", seed=0, **kw):
    m = GPTStackedForPretraining(gpt_tiny(**{**CFG, **kw}), device="cpu",
                                 dtype=dtype, seed=seed)
    m.load_jax_state(state)
    return m


def _jt(a):
    return pt.to_tensor(a, dtype="int64")


@pytest.mark.parametrize("recompute_interval", [0, 1])
def test_first_step_loss_and_gradients_match_jax(state, recompute_interval):
    (ids, labels), = _batches(1)
    jm = _jax_model(state, recompute_interval=recompute_interval)
    jloss = jm(_jt(ids), labels=_jt(labels))
    jloss.backward()
    jgrads = {n: np.asarray(p.grad.numpy(), np.float32)
              for n, p in jm.named_parameters()}
    tm = _port_model(state, recompute_interval=recompute_interval)
    tloss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-6)
    tgrads = dict(tm.named_parameters())
    assert set(tgrads) == set(jgrads)
    for name, want in jgrads.items():
        got = tgrads[name].grad.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("dtype,recompute_interval", [
    ("float32", 0), ("float32", 1), ("bfloat16", 1)])
def test_three_train_steps_match_jax(state, dtype, recompute_interval):
    bf16 = dtype == "bfloat16"
    amp = "O1" if bf16 else None
    jm = _jax_model(state, recompute_interval=recompute_interval)
    if bf16:
        pt.amp.decorate(jm, level="O2", dtype="bfloat16")
    jopt = pt.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters(),
                              multi_precision=False)
    jstep = pt.optimizer.FusedTrainStep(
        lambda i, l: jm(i, labels=l), jopt, amp_level=amp,
        amp_dtype="bfloat16")
    tm = _port_model(state, dtype, recompute_interval=recompute_interval)
    tstep = FusedTrainStep(
        lambda i, l: tm(i, labels=l),
        AdamW(parameters=tm.parameters(), learning_rate=LR,
              multi_precision=False),
        amp_level=amp)
    batches = _batches(STEPS, seed=2)
    jl = [float(jstep(_jt(i), _jt(l))) for i, l in batches]
    tl = [float(tstep(torch.from_numpy(i), torch.from_numpy(l)))
          for i, l in batches]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-3 if bf16 else 0)
    want = {k: np.asarray(v.numpy(), np.float32)
            for k, v in jm.state_dict().items()}
    allowance = 2 * LR * STEPS
    for name, p in tm.state_dict().items():
        got = p.float().numpy()
        np.testing.assert_allclose(got, want[name], atol=allowance,
                                   rtol=2.0 ** -7 if bf16 else 1e-5,
                                   err_msg=name)
        if not bf16:
            bulk = np.quantile(np.abs(got - want[name]), 0.999)
            assert bulk <= 1e-6, (name, bulk)


def test_logits_without_labels_match_jax(state):
    (ids, _), = _batches(1, seed=3)
    jm = _jax_model(state)
    want = np.asarray(jm(_jt(ids)).numpy(), np.float32)
    tm = _port_model(state)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert got.shape == (BATCH, SEQ, 1024)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_recompute_and_the_plain_attention_give_the_same_gradients(state):
    """Per-block recompute (every block, or groups of two) replays the same
    forward; ``use_flash_attention=False`` runs the reference's plain
    causal expression, whose fp32 arithmetic on the CPU is the flash
    kernels' plain version's: all give bitwise-equal gradients."""
    (ids, labels), = _batches(1, seed=4)
    grads = []
    for kw in (dict(recompute_interval=0), dict(recompute_interval=1),
               dict(recompute_interval=2),
               dict(recompute_interval=0, use_flash_attention=False)):
        tm = _port_model(state, **kw)
        tm(torch.from_numpy(ids), labels=torch.from_numpy(labels)).backward()
        grads.append({n: p.grad.clone() for n, p in tm.named_parameters()})
    for other in grads[1:]:
        for name, g in grads[0].items():
            assert torch.equal(g, other[name]), name


def test_train_forward_on_the_cpu_counts_no_flash_launch(state):
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd_dkv.launches,
              tfa.flash_attention_bwd_dq.launches)
    (ids, labels), = _batches(1, seed=5)
    tm = _port_model(state, recompute_interval=1)
    tm(torch.from_numpy(ids), labels=torch.from_numpy(labels)).backward()
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd_dkv.launches,
            tfa.flash_attention_bwd_dq.launches) == before


def test_a_recompute_interval_that_does_not_divide_raises():
    ids = torch.zeros((1, 128), dtype=torch.long)
    m = GPTStackedForPretraining(gpt_tiny(**CFG, recompute_interval=3),
                                 device="cpu")
    with pytest.raises(ValueError, match="recompute_interval"):
        m(ids, labels=ids)


@pytest.mark.parametrize("kw,error,match", [
    (dict(), ValueError, "head_dim=16"),
    (dict(hidden_size=128, num_heads=2, max_position_embeddings=256),
     ValueError, "seq_len=200")])
def test_training_off_the_cpu_raises_where_the_kernels_do_not_run(kw, error,
                                                                  match):
    """Off the CPU the block's flash route is the flash kernels or an
    error, never their plain version: a head_dim or seq the kernels refuse
    raises (meta tensors stand in for the card's) and nothing is
    launched."""
    cfg = gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0, **kw)
    m = GPTStackedForPretraining(cfg, device="cpu").to("meta")
    seq = 200 if "max_position_embeddings" in kw else 128
    ids = torch.zeros((1, seq), dtype=torch.long, device="meta")
    before = tfa.flash_attention_fwd.launches
    with pytest.raises(error, match=match):
        m(ids, labels=ids)
    assert tfa.flash_attention_fwd.launches == before


def test_serving_step_builds_no_autograd_graph(state):
    tm = _port_model(state)
    assert all(p.requires_grad for p in tm.parameters())
    outs = []
    step = tm._paged_lm_logits

    def capture(*a, **kw):
        out = step(*a, **kw)
        outs.append(out)
        return out

    tm._paged_lm_logits = capture
    eng = ServingEngine(tm, num_slots=2, page_size=16, max_context=64,
                        cache_dtype="float32")
    rng = np.random.RandomState(6)
    toks = eng.generate_batch([rng.randint(0, 1024, (n,)) for n in (5, 9)],
                              4)
    assert [len(t) for t in toks] == [5 + 4, 9 + 4] and outs
    assert all(not o.requires_grad and o.grad_fn is None for o in outs)
    assert all(p.grad is None for p in tm.parameters())


def _offset_positions(seed=7, seq=64):
    """Positions of offset / packed rows: row 0 starts at 50, row 1 is two
    packed sequences (0..31, then 0..31)."""
    pos = np.stack([np.arange(seq) + 50, np.arange(seq) % 32])
    (ids, _), = _batches(1, seed=seed)
    return ids[:, :seq], pos


def test_explicit_position_ids_give_the_jax_logits(state):
    ids, pos = _offset_positions()
    jm = _jax_model(state)
    want = np.asarray(jm(_jt(ids), position_ids=_jt(pos)).numpy())
    tm = _port_model(state)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), position_ids=torch.from_numpy(pos))
    assert got.shape == (BATCH, 64, 1024)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # the default positions differ: the offsets were really read
    assert not np.allclose(tm(torch.from_numpy(ids)).detach().numpy(), want,
                           atol=1e-3)


def test_second_positional_argument_is_position_ids_as_in_jax(state):
    """``model(ids, pos)``: the reference reads ``pos`` as position ids and
    returns logits, not a loss."""
    ids, pos = _offset_positions(seed=8)
    want = np.asarray(_jax_model(state)(_jt(ids), _jt(pos)).numpy())
    with torch.no_grad():
        got = _port_model(state)(torch.from_numpy(ids),
                                 torch.from_numpy(pos))
    assert got.shape == want.shape == (BATCH, 64, 1024)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_position_ids_on_the_cache_paths(state):
    """The contiguous cache's prefill honours explicit positions (the
    logits path's result); the paged path reads positions from
    ``cache_index`` and refuses ids that disagree."""
    ids, pos = _offset_positions(seed=9)
    tm = _port_model(state)
    tids, tpos = torch.from_numpy(ids), torch.from_numpy(pos)
    with torch.no_grad():
        want = tm(tids, position_ids=tpos)
        cache = tm.new_kv_cache(BATCH, 64, dtype="float32")
        got = tm(tids, position_ids=tpos, kv_cache=cache, cache_index=0)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())
        pool = tm.new_paged_kv_cache(5, 16, dtype="float32")
        step = dict(kv_cache=pool, cache_index=torch.tensor([0, 3]),
                    page_tables=torch.tensor([[1, 2], [3, 4]]))
        short = tids[:, :4]
        plain = tm(short, **step)
        same = tm(short, position_ids=torch.tensor([[0, 1, 2, 3],
                                                    [3, 4, 5, 6]]), **step)
        np.testing.assert_allclose(same.numpy(), plain.numpy(), rtol=1e-6)
        with pytest.raises(ValueError, match="cache_index"):
            tm(short, position_ids=torch.arange(4), **step)


# -- dropout, the plain route and the criterion ------------------------------

DROP = dict(hidden_dropout=0.1, attention_dropout=0.2)


@pytest.fixture
def fixed_masks(monkeypatch):
    """Patch, for this test only, the JAX package's ``jax.random.bernoulli``
    and the port's ``keep_mask`` to return one fixed numpy mask per
    (shape, keep probability)."""
    rng = np.random.RandomState(123)
    masks = {}

    def mask(shape, keep):
        key = (tuple(int(d) for d in shape), round(float(keep), 9))
        if key not in masks:
            masks[key] = rng.rand(*key[0]) < keep
        return masks[key]

    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.asarray(
                            mask(shape, p)))
    monkeypatch.setattr(tcommon, "keep_mask",
                        lambda shape, p, generator, device: torch.from_numpy(
                            mask(shape, 1.0 - p)).to(device))
    return masks


def _jax_loss_and_grads(jm, ids, labels):
    loss = jm(_jt(ids), labels=_jt(labels))
    loss.backward()
    return float(loss), {n: np.asarray(p.grad.numpy(), np.float32)
                         for n, p in jm.named_parameters()}


def _port_loss_and_grads(tm, ids, labels):
    loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in tm.named_parameters()}


def _assert_grads_match(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["eval, dropout 0.1", "train, dropout 0"])
def test_dropout_model_equals_jax_in_eval_and_at_p0(state, mode):
    """The default-dropout config in ``eval()``, and training at p = 0,
    give the JAX model's loss and gradients."""
    kw = dict(hidden_dropout=0.1, attention_dropout=0.1) \
        if mode.startswith("eval") else {}
    (ids, labels), = _batches(1, seed=11)
    jm, tm = _jax_model(state, **kw), _port_model(state, **kw)
    if mode.startswith("eval"):
        jm.eval()
        tm.eval()
    jloss, jgrads = _jax_loss_and_grads(jm, ids, labels)
    tloss, tgrads = _port_loss_and_grads(tm, ids, labels)
    np.testing.assert_allclose(float(tloss), jloss, rtol=1e-6)
    _assert_grads_match(tgrads, jgrads)


@pytest.mark.parametrize("recompute_interval", [0, 1])
def test_dropout_step_matches_jax_with_the_same_masks(state, fixed_masks,
                                                      recompute_interval):
    """Training with hidden dropout 0.1 and attention dropout 0.2 (the
    plain causal route on both sides), the same masks: the JAX loss and
    gradients, with and without per-block recompute."""
    (ids, labels), = _batches(1, seed=12)
    kw = dict(DROP, recompute_interval=recompute_interval)
    jloss, jgrads = _jax_loss_and_grads(_jax_model(state, **kw), ids, labels)
    tloss, tgrads = _port_loss_and_grads(_port_model(state, **kw), ids,
                                         labels)
    # the embeddings, both block sites and the probabilities were dropped
    assert {k[0] for k in fixed_masks} == {(BATCH, SEQ, 128),
                                           (BATCH, 2, SEQ, SEQ)}
    np.testing.assert_allclose(float(tloss), jloss, rtol=1e-6)
    _assert_grads_match(tgrads, jgrads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_use_flash_attention_false_gives_the_jax_plain_route(state, dtype):
    """``use_flash_attention=False`` without dropout: the JAX plain route's
    loss (fp32: 1e-6 relative, and the gradients as above; bf16 weights:
    within the bf16 training test's 1e-3), and the plain expression ran."""
    (ids, labels), = _batches(1, seed=13)
    kw = dict(use_flash_attention=False)
    jm = _jax_model(state, **kw)
    if dtype == "bfloat16":
        pt.amp.decorate(jm, level="O2", dtype="bfloat16")
    tm = _port_model(state, dtype, **kw)
    calls = []
    plain = tgpt.causal_attention_plain
    tgpt.causal_attention_plain = lambda *a, **k: calls.append(1) or \
        plain(*a, **k)
    try:
        tloss, tgrads = _port_loss_and_grads(tm, ids, labels)
    finally:
        tgpt.causal_attention_plain = plain
    jloss, jgrads = _jax_loss_and_grads(jm, ids, labels)
    assert len(calls) == 2                          # one a layer
    if dtype == "float32":
        np.testing.assert_allclose(float(tloss), jloss, rtol=1e-6)
        _assert_grads_match(tgrads, jgrads)
    else:
        np.testing.assert_allclose(float(tloss), jloss, atol=1e-3)


def test_recompute_redraws_the_same_masks(state):
    """Under dropout, recompute off, every block and groups of two give
    bitwise-equal losses and gradients from one generator seed: the
    recompute reseeds each layer from its seed."""
    (ids, labels), = _batches(1, seed=14)
    runs = [_port_loss_and_grads(_port_model(state, seed=5,
                                             recompute_interval=k, **DROP),
                                 ids, labels) for k in (0, 1, 2)]
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for name, g in runs[0][1].items():
            assert torch.equal(grads[name], g), name


def test_the_same_generator_seed_gives_the_same_bits(state):
    """Two models from one seed (or one explicit CPU generator seeded
    alike) train to the same bits; another seed draws other masks; a
    second forward of one model draws new ones; eval is deterministic."""
    (ids, labels), = _batches(1, seed=15)
    a = _port_loss_and_grads(_port_model(state, seed=3, **DROP), ids, labels)
    m = GPTStackedForPretraining(gpt_tiny(**{**CFG, **DROP}), device="cpu",
                                 generator=torch.Generator().manual_seed(3))
    m.load_jax_state(state)
    b = _port_loss_and_grads(m, ids, labels)
    c = _port_loss_and_grads(_port_model(state, seed=4, **DROP), ids, labels)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    assert all(torch.equal(g, b[1][n]) for n, g in a[1].items())
    x = torch.from_numpy(ids)
    assert not torch.equal(m(x, labels=x), m(x, labels=x))
    m.eval()
    with torch.no_grad():
        assert torch.equal(m(x), m(x))
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        # a generator on the card (this host has none: its stand-in)
        card_gen = type("Gen", (), {"device": torch.device("cuda")})()
        GPTStackedForPretraining(gpt_tiny(), device="cpu",
                                 generator=card_gen)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_kept_share_is_within_a_binomial_bound(state, monkeypatch, p):
    """Every dropout of a training forward keeps a share of its elements
    within 5 binomial sigmas of 1 - p (attention: of the causal
    positions), and scales the kept ones by 1 / (1 - p)."""
    seen = []
    drop = tgpt.dropout

    def spy(x, rate, **kw):
        out = drop(x, rate, **kw)
        if rate > 0:
            if x.dim() == 4:                       # probabilities
                live = torch.ones(x.shape[-2:], dtype=torch.bool).tril()
                live = live.expand_as(x)
            else:
                live = torch.ones_like(x, dtype=torch.bool)
            kept = (out != 0) & live
            seen.append((x.dim(), kept.sum().item(), live.sum().item()))
            torch.testing.assert_close(out[kept], x[kept] / (1 - rate))
        return out

    monkeypatch.setattr(tgpt, "dropout", spy)
    (ids, labels), = _batches(1, seed=16)
    _port_model(state, hidden_dropout=p, attention_dropout=p)(
        torch.from_numpy(ids), labels=torch.from_numpy(labels))
    # embeddings, then per layer: probabilities, projection, MLP
    assert [d for d, _, _ in seen] == [3, 4, 3, 3, 4, 3, 3]
    for _, kept, n in seen:
        assert abs(kept / n - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)


@pytest.mark.parametrize("mask", ["none", "half", "zeros"])
def test_pretraining_criterion_matches_jax(mask):
    """``GPTPretrainingCriterion`` (the analogue of ``tests/test_gpt.py``'s
    loss-mask test): the mean token loss, or the masked mean over at
    least one token."""
    rng = np.random.RandomState(17)
    logits = rng.randn(2, 16, 50).astype(np.float32)
    labels = rng.randint(0, 50, (2, 16))
    m = {"none": None, "half": (rng.rand(2, 16) < 0.5).astype(np.float32),
         "zeros": np.zeros((2, 16), np.float32)}[mask]
    want = float(JaxCriterion(jax_gpt_tiny())(
        pt.to_tensor(logits), _jt(labels),
        None if m is None else pt.to_tensor(m)))
    got = GPTPretrainingCriterion(gpt_tiny())(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if m is None else torch.from_numpy(m))
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    if mask == "zeros":
        assert float(got) == 0.0


# -- AMP O1 over fp32 weights with the gradient scaler ----------------------

O1_STEPS = 5


def _o1_pair(state, scale=2.0 ** 15, **kw):
    """The JAX and the port's ``FusedTrainStep(amp_level="O1", scaler=)``
    over the same fp32 weights, ``AdamW(LR)``."""
    from paddle_tpu_torch import amp as tamp

    jm = _jax_model(state, recompute_interval=1, **kw)
    jsc = pt.amp.GradScaler(enable=True, init_loss_scaling=scale)
    jstep = pt.optimizer.FusedTrainStep(
        lambda i, l: jm(i, labels=l),
        pt.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters()),
        scaler=jsc, amp_level="O1", amp_dtype="bfloat16")
    tm = _port_model(state, recompute_interval=1, **kw)
    topt = AdamW(LR, parameters=tm.parameters())
    tsc = tamp.GradScaler(enable=True, init_loss_scaling=scale,
                          device="cpu")
    tstep = FusedTrainStep(lambda i, l: tm(i, labels=l), topt, scaler=tsc,
                           amp_level="O1")
    return (jm, jstep, jsc), (tm, tstep, tsc, topt)


def test_o1_scaler_steps_match_jax(state):
    """Five O1 steps over fp32 weights with an enabled scaler: the JAX
    fused step's losses within 1e-3 (bf16 products rounded at the same
    points, summed in another order), then its parameters within two
    rate-sized steps each (AdamW's sign-sized first moves where a
    gradient is ~0), fp32 throughout."""
    (jm, jstep, jsc), (tm, tstep, tsc, _) = _o1_pair(state)
    batches = _batches(O1_STEPS, seed=21)
    jl = [float(jstep(_jt(i), _jt(l))) for i, l in batches]
    tl = [float(tstep(torch.from_numpy(i), torch.from_numpy(l)))
          for i, l in batches]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-3)
    assert tstep.last_step_applied and tstep.dispatch_count == O1_STEPS
    want = {k: np.asarray(v.numpy(), np.float32)
            for k, v in jm.state_dict().items()}
    for name, p in tm.state_dict().items():
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.numpy(), want[name], rtol=1e-5,
                                   atol=2 * LR * O1_STEPS, err_msg=name)
    assert float(tsc._scale) == float(np.asarray(jsc._scale._value))


def test_a_forced_overflow_leaves_every_state_bitwise(state):
    """One step whose word-embedding gradient a hook makes non-finite (as
    an overflow of the scaled gradients does): every parameter, moment and
    beta power stays bitwise as it was and the scale halves -- the JAX
    scaler's rule for the same flag; the next steps apply.  (A scale of
    3e38 alone does not overflow this model's fp32 gradients: the largest
    unscaled one is ~0.16.)"""
    (_, _, jsc), (tm, tstep, tsc, topt) = _o1_pair(state)
    batches = _batches(3, seed=22)
    i, l = batches[0]
    tstep(torch.from_numpy(i), torch.from_numpy(l))
    snap = [t.clone() for p in tm.parameters()
            for t in (p.detach(), topt.state[p]["moment1"],
                      topt.state[p]["moment2"])]
    pows, scale = topt._pows.clone(), float(tsc._scale)
    hook = tm.embeddings.word_embeddings.weight.register_hook(
        lambda g: g * float("inf"))
    i, l = batches[1]
    tstep(torch.from_numpy(i), torch.from_numpy(l))
    hook.remove()
    assert not tstep.last_step_applied
    now = [t for p in tm.parameters()
           for t in (p.detach(), topt.state[p]["moment1"],
                     topt.state[p]["moment2"])]
    assert all(torch.equal(a, b) for a, b in zip(snap, now))
    assert torch.equal(topt._pows, pows)
    jsc._found_inf = True
    jsc.update()
    assert float(tsc._scale) == scale / 2 == jsc.get_loss_scaling()
    i, l = batches[2]
    tstep(torch.from_numpy(i), torch.from_numpy(l))
    assert tstep.last_step_applied
    assert not torch.equal(topt._pows, pows)


# -- recompute policies -------------------------------------------------------

def _remat_losses(state, interval, policy, **kw):
    tm = _port_model(state, recompute_interval=interval,
                     recompute_policy=policy, **kw)
    step = FusedTrainStep(lambda i, l: tm(i, labels=l),
                          AdamW(LR, parameters=tm.parameters()), **(
                              dict(amp_level="O1") if kw.pop("o1", False)
                              else {}))
    return [float(step(torch.from_numpy(i), torch.from_numpy(l)))
            for i, l in _batches(3, seed=23)]


@pytest.mark.parametrize("interval,policy", [(2, "full"), (2, "dots"),
                                             (1, "dots"),
                                             (1, "dots_saveable")])
def test_recompute_policies_give_the_same_losses(state, interval, policy):
    """The port of ``tests/test_train_perf.py::TestRematInterval``: what a
    recomputed group keeps changes memory, never math -- three steps'
    losses equal per-block full recompute exactly."""
    assert (_remat_losses(state, interval, policy)
            == _remat_losses(state, 1, "full"))


def test_dots_keeps_the_products_and_recomputes_the_rest(state):
    """Under "dots" the backward's recompute runs no 2-D product (their
    outputs were kept: 4 a block fewer than under "full"), and with
    dropout it redraws the same masks: the gradients equal full
    recompute's bit for bit."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in (torch.ops.aten.mm.default,
                               torch.ops.aten.addmm.default)
            return func(*args, **(kwargs or {}))

    (ids, labels), = _batches(1, seed=24)
    counts, grads = {}, {}
    for policy in ("full", "dots"):
        torch.manual_seed(0)
        tm = _port_model(state, recompute_interval=1, recompute_policy=policy,
                         hidden_dropout=0.1, attention_dropout=0.1)
        loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        with Count() as c:
            loss.backward()
        counts[policy] = c.n
        grads[policy] = {n: p.grad for n, p in tm.named_parameters()}
    assert counts["full"] - counts["dots"] == 4 * 2
    for name, g in grads["full"].items():
        assert torch.equal(g, grads["dots"][name]), name


def test_an_unknown_recompute_policy_raises_as_jax_does():
    with pytest.raises(ValueError, match="remat policy"):
        jax_gpt_tiny(recompute_policy="dot")
    with pytest.raises(ValueError, match="remat policy"):
        gpt_tiny(recompute_policy="dot")
