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
  parameters are trainable."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import GPTStackedForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny

from paddle_tpu_torch.models import GPTStackedForPretraining, gpt_tiny
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
    m = JaxGPT(jax_gpt_tiny(**CFG, **kw))
    m.set_state_dict(state)
    return m


def _port_model(state, dtype="float32", **kw):
    m = GPTStackedForPretraining(gpt_tiny(**CFG, **kw), device="cpu",
                                 dtype=dtype)
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
        AdamW(tm.parameters(), learning_rate=LR, multi_precision=False),
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
    forward; ``use_flash_attention=False``, taken across from a JAX
    config, runs the same plain version on the CPU: all give
    bitwise-equal gradients."""
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


def test_dropout_and_a_recompute_interval_that_does_not_divide_raise():
    ids = torch.zeros((1, 128), dtype=torch.long)
    m = GPTStackedForPretraining(gpt_tiny(hidden_size=128, num_heads=2),
                                 device="cpu")          # dropout 0.1
    with pytest.raises(NotImplementedError, match="dropout"):
        m(ids, labels=ids)
    m.eval()                                            # dropout is off
    assert m(ids).shape == (1, 128, 1024)
    m = GPTStackedForPretraining(gpt_tiny(**CFG, recompute_interval=3),
                                 device="cpu")
    with pytest.raises(ValueError, match="recompute_interval"):
        m(ids, labels=ids)


@pytest.mark.parametrize("kw,error,match", [
    (dict(), ValueError, "head_dim=16"),
    (dict(hidden_size=128, num_heads=2, max_position_embeddings=256),
     ValueError, "seq_len=200"),
    (dict(hidden_size=128, num_heads=2, use_flash_attention=False),
     NotImplementedError, "use_flash_attention=False")])
def test_training_off_the_cpu_raises_where_the_kernels_do_not_run(kw, error,
                                                                  match):
    """Off the CPU the block's attention is the flash kernels or an error,
    never the plain version: a head_dim or seq the kernels refuse, or
    ``use_flash_attention=False``, raises (meta tensors stand in for the
    card's) and nothing is launched."""
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
