"""The port's speculative decoding held against the JAX package on the CPU
(``tests/test_speculative.py``): ``SpeculativeEngine`` and
``truncated_draft`` over ``gpt_tiny`` carried across from the JAX stacked
GPT by ``load_jax_state`` (fp32).

- greedy: the port's speculative tokens equal the JAX plain engine's and
  the JAX speculative engine's, token for token, with the same draft,
  proposed and accepted counts (the same-model draft accepts everything);
  the truncated draft gives the same tokens whatever it proposes;
- sampling, checked by property (the draws come from ``torch.Generator``,
  not threefry): at every verify position the emitted token's empirical
  distribution is the target's within 0.05 (4096 draws: a bucket's
  standard deviation is at most ~0.008, so 0.05 is over 5 sigma); an
  identical draft is always accepted; dead q rows are masked; greedy
  slots ignore q;
- accounting: draft-pool exhaustion degrades to fewer proposals and never
  to other tokens, a cancel mid-flight rolls the draft's speculative
  pages back, a randomized fault schedule drains both pools exactly, and
  ``free + used + spec + shared == capacity`` holds on both pools at every
  step.

The layered GPT (``GPTForPretraining``) takes the greedy case with its
truncated draft, against the JAX layered target and ``truncated_draft``
of it."""
import time

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import GPTForPretraining as JaxLayered
from paddle_tpu.models import GPTStackedForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models import truncated_draft as jax_truncated_draft
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import SpeculativeEngine as JaxSpeculativeEngine

from paddle_tpu_torch.models import (
    GPTForPretraining, GPTStackedForPretraining, gpt_tiny, truncated_draft,
)
from paddle_tpu_torch.serving import (
    RequestState, SamplingParams, ServingEngine, SpeculativeEngine,
    random_schedule,
)
from paddle_tpu_torch.serving.speculative import _verify_tokens

torch.set_num_threads(2)

ENG_KW = dict(num_slots=3, page_size=16, max_context=64,
              cache_dtype="float32")
SPEC_COUNTS = ("spec_proposed_tokens", "spec_accepted_tokens",
               "spec_verify_steps", "spec_draft_steps", "spec_draft_skips")


def _jax_state(seed):
    pt.seed(seed)
    m = JaxGPT(jax_gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0))
    rng = np.random.RandomState(seed)
    state = {}
    for k, v in m.state_dict().items():
        a = np.asarray(v.numpy(), np.float32)
        if k.endswith(("_b", "_g", "bias")) or k == "final_ln.weight":
            a = a + 0.1 * rng.randn(*a.shape).astype(np.float32)
        state[k] = a
    return state


@pytest.fixture(scope="module")
def models():
    state = _jax_state(0)
    jm = JaxGPT(jax_gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0))
    jm.eval()
    jm.set_state_dict(state)
    tm = GPTStackedForPretraining(gpt_tiny(), device="cpu")
    tm.load_jax_state(state)
    return jm, tm


def layered_models():
    """The layered JAX model (seed 0) and the port's with its weights."""
    pt.seed(0)
    jm = JaxLayered(jax_gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0))
    jm.eval()
    tm = GPTForPretraining(gpt_tiny(), device="cpu")
    tm.load_jax_state({k: np.asarray(v.numpy())
                       for k, v in jm.state_dict().items()})
    tm.eval()
    return jm, tm


def _prompts(lengths=(5, 18, 9, 26, 13), seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, (s,)) for s in lengths]


def _ledger(a):
    return a.free_pages + a.used_pages + a.spec_pages + a.shared_pages


def _drain(eng, reqs, max_steps=3000):
    """Step to idle, holding both pools' ledgers at every step."""
    steps = 0
    while eng.queue.depth or eng.scheduler.active_slots:
        met = eng.step()
        steps += 1
        for a in (eng.allocator, eng.draft.allocator):
            assert _ledger(a) == a.capacity
        assert steps < max_steps
        if not met["active_slots"] and not met["tokens_this_step"]:
            time.sleep(0.001)
    for a in (eng.allocator, eng.draft.allocator):
        assert a.used_pages == 0 and a.spec_pages == 0
        assert a.free_pages == a.capacity
    return reqs


# ---------------------------------------------------------------------------
# greedy parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft", ["same_model", "truncated_1", "layered"])
def test_greedy_speculation_matches_jax(models, draft):
    """Same tokens as the JAX plain engine and as the JAX speculative
    engine with the same draft, and the same speculation counts."""
    jm, tm = layered_models() if draft == "layered" else models
    prompts = _prompts()
    if draft == "same_model":
        jd, td = jm, tm
    elif draft == "layered":
        # the layered target and its truncated draft: gpt.layer_0 by key
        jd, td = jax_truncated_draft(jm, 1), truncated_draft(tm, 1)
        assert td.config.num_layers == 1 and not td.stacked
        np.testing.assert_array_equal(
            td.gpt.layer_0.attn.qkv_proj.weight.detach().numpy(),
            tm.gpt.layer_0.attn.qkv_proj.weight.detach().numpy())
    else:
        jd, td = jax_truncated_draft(jm, 1), truncated_draft(tm, 1)
        assert td.config.num_layers == 1
        np.testing.assert_array_equal(td.decoder.qkv_w.detach().numpy(),
                                      tm.decoder.qkv_w[:1].detach().numpy())
    want = JaxEngine(jm, **ENG_KW).generate_batch(prompts, 7)
    je = JaxSpeculativeEngine(jm, jd, spec_k=3, **ENG_KW)
    jgot = je.generate_batch(prompts, 7)
    te = SpeculativeEngine(tm, td, spec_k=3, **ENG_KW)
    got = _drain(te, [te.submit(p, 7) for p in prompts])
    for g, jg, w in zip(got, jgot, want):
        assert g.finished
        np.testing.assert_array_equal(g.output_ids(), w)
        np.testing.assert_array_equal(jg, w)
    jmet, tmet = je.metrics(), te.metrics()
    assert {k: tmet[k] for k in SPEC_COUNTS} == \
        {k: jmet[k] for k in SPEC_COUNTS}
    if draft == "same_model":
        assert tmet["spec_acceptance_rate"] == 1.0
    assert tmet["spec_proposed_tokens"] > 0
    je.close()
    te.close()


def test_speculation_matches_generate(models):
    _, tm = models
    prompts = _prompts(lengths=(6, 14, 9))
    refs = [tm.generate(p[None], 5, max_seq_len=64,
                        cache_dtype="float32")[0].numpy() for p in prompts]
    eng = SpeculativeEngine(tm, tm, spec_k=4, **ENG_KW)
    got = eng.generate_batch(prompts, 5)
    for g, w in zip(got, refs):
        np.testing.assert_array_equal(g, w)


def test_eos_truncates_accepted_run(models):
    _, tm = models
    prompts = _prompts(lengths=(6, 11))
    ref = ServingEngine(tm, **ENG_KW)
    r_ref = [ref.submit(p, 8, eos_token_id=int(t))
             for p, t in zip(prompts, (3, 7))]
    ref.run_until_idle()
    # eos at the reference's third token: the speculative run must stop
    # there even when the verify step accepted past it
    eos = [r.tokens[2] for r in r_ref]
    r_ref = [ref.submit(p, 8, eos_token_id=e) for p, e in zip(prompts, eos)]
    ref.run_until_idle()
    eng = SpeculativeEngine(tm, tm, spec_k=4, **ENG_KW)
    r_got = _drain(eng, [eng.submit(p, 8, eos_token_id=e)
                         for p, e in zip(prompts, eos)])
    for g, w in zip(r_got, r_ref):
        assert g.tokens == w.tokens and len(g.tokens) <= 3


def test_speculation_disabled_decodes_plainly(models):
    """``speculation_enabled = False``: no draft dispatch, the same
    tokens; re-enabled, the shadow drains its backlog and proposes
    again."""
    _, tm = models
    prompts = _prompts(lengths=(6, 11, 9))
    want = ServingEngine(tm, **ENG_KW).generate_batch(prompts, 12)
    eng = SpeculativeEngine(tm, tm, spec_k=3, **ENG_KW)
    reqs = [eng.submit(p, 12) for p in prompts]
    eng.speculation_enabled = False
    for _ in range(4):
        eng.step()
    assert eng.metrics()["spec_draft_steps"] == 0
    eng.speculation_enabled = True
    _drain(eng, reqs)
    for r, w in zip(reqs, want):
        np.testing.assert_array_equal(r.output_ids(), w)
    assert eng.metrics()["spec_proposed_tokens"] > 0


# ---------------------------------------------------------------------------
# sampling: leftover-distribution resampling, by property
# ---------------------------------------------------------------------------

def _verify(lg, d, nd, qprobs, do_sample, gen):
    s = lg.shape[0]
    return _verify_tokens(
        torch.from_numpy(lg), torch.from_numpy(d), torch.from_numpy(nd),
        torch.ones(s), torch.ones(s), torch.zeros(s, dtype=torch.int32),
        torch.from_numpy(do_sample),
        qprobs=None if qprobs is None else [torch.from_numpy(q)
                                            for q in qprobs],
        generator=gen)


def test_per_position_distribution_is_the_target(models):
    """Target rows identical at every position and proposals drawn from a
    different q: at each position j, the token emitted there (over the
    slots whose run reached j) is distributed as the target's p."""
    V, k, S, rounds = 8, 2, 256, 16
    rng = np.random.RandomState(3)
    p_logits = rng.randn(V).astype(np.float32)
    q = rng.rand(V).astype(np.float32) + 0.1
    q /= q.sum()
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros((k + 1, V))
    lg = np.broadcast_to(p_logits, (S, k + 1, V)).copy()
    for _ in range(rounds):
        d = rng.choice(V, size=(S, k), p=q).astype(np.int32)
        out, n_acc, fin = _verify(lg, d, np.full((S,), k, np.int32),
                                  [np.broadcast_to(q, (S, V)).copy()] * k,
                                  np.ones((S,), bool), gen)
        out, n_acc = out.numpy(), n_acc.numpy()
        assert fin.all() and ((n_acc >= 0) & (n_acc <= k)).all()
        for j in range(k + 1):
            for t in out[n_acc >= j, j]:
                counts[j, t] += 1
    want = np.exp(p_logits) / np.exp(p_logits).sum()
    for j in range(k + 1):
        emp = counts[j] / counts[j].sum()
        assert counts[j].sum() >= 256, (j, counts[j].sum())
        assert np.abs(emp - want).max() < 0.05, (j, emp, want)


def test_identical_draft_always_accepts():
    V, k, S = 8, 3, 16
    rng = np.random.RandomState(5)
    lg = rng.randn(S, k + 1, V).astype(np.float32)
    p = np.exp(lg) / np.exp(lg).sum(-1, keepdims=True)
    d = np.stack([[rng.choice(V, p=p[s, j]) for j in range(k)]
                  for s in range(S)]).astype(np.int32)
    out, n_acc, fin = _verify(lg, d, np.full((S,), k, np.int32),
                              [p[:, j].copy() for j in range(k)],
                              np.ones((S,), bool),
                              torch.Generator().manual_seed(0))
    assert (n_acc.numpy() == k).all() and fin.all()
    np.testing.assert_array_equal(out.numpy()[:, :k], d)


def test_dead_qrows_masked_per_slot():
    """n_draft 0: the bonus token comes from the pure target row, whatever
    the (another slot's) q rows hold."""
    V, k, S = 8, 2, 256
    rng = np.random.RandomState(11)
    row = rng.randn(V).astype(np.float32)
    lg = np.broadcast_to(row, (S, k + 1, V)).copy()
    garbage = rng.rand(S, V).astype(np.float32)
    garbage /= garbage.sum(-1, keepdims=True)
    gen = torch.Generator().manual_seed(4)
    counts = np.zeros(V)
    for _ in range(16):
        out, n_acc, _fin = _verify(lg, np.zeros((S, k), np.int32),
                                   np.zeros((S,), np.int32), [garbage] * k,
                                   np.ones((S,), bool), gen)
        assert (n_acc.numpy() == 0).all()
        for t in out.numpy()[:, 0]:
            counts[t] += 1
    emp = counts / counts.sum()
    want = np.exp(row) / np.exp(row).sum()
    assert np.abs(emp - want).max() < 0.05, (emp, want)


def test_greedy_chain_ignores_qprobs():
    V, k, S = 8, 2, 4
    rng = np.random.RandomState(7)
    lg = rng.randn(S, k + 1, V).astype(np.float32)
    g = lg.argmax(-1)
    for qprobs in (None, [rng.rand(S, V).astype(np.float32)] * k):
        out, n_acc, fin = _verify(lg, g[:, :k].astype(np.int32),
                                  np.full((S,), k, np.int32), qprobs,
                                  np.zeros((S,), bool),
                                  torch.Generator().manual_seed(0))
        assert (n_acc.numpy() == k).all()
        np.testing.assert_array_equal(out.numpy(), g)
    # a mismatch at position 1 stops the chain there
    d = g[:, :k].astype(np.int32).copy()
    d[:, 1] = (d[:, 1] + 1) % V
    out, n_acc, _ = _verify(lg, d, np.full((S,), k, np.int32), None,
                            np.zeros((S,), bool), None)
    assert (n_acc.numpy() == 1).all()


def test_sampled_speculation_completes_and_drains(models):
    _, tm = models
    prompts = _prompts(lengths=(6, 12, 9))
    eng = SpeculativeEngine(tm, tm, spec_k=3, seed=5, **ENG_KW)
    sp = SamplingParams(do_sample=True, temperature=0.9, top_k=50,
                        top_p=0.95)
    reqs = _drain(eng, [eng.submit(p, 6, sampling=sp if i % 2 else None)
                        for i, p in enumerate(prompts)])
    assert all(r.finished and len(r.tokens) == 6 for r in reqs)
    # the greedy request among them is exact
    want = ServingEngine(tm, **ENG_KW).generate_batch(prompts[:1], 6)
    np.testing.assert_array_equal(reqs[0].output_ids(), want[0])
    assert eng.metrics()["spec_proposed_tokens"] > 0


# ---------------------------------------------------------------------------
# accounting under degradation, faults and churn
# ---------------------------------------------------------------------------

def test_draft_pool_exhaustion_degrades_not_corrupts(models):
    jm, tm = models
    prompts = _prompts()
    want = JaxEngine(jm, **ENG_KW).generate_batch(prompts, 7)
    # 3 draft pages for 3 slots needing up to 4 pages each
    eng = SpeculativeEngine(tm, tm, spec_k=3, draft_num_pages=4, **ENG_KW)
    got = _drain(eng, [eng.submit(p, 7) for p in prompts])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.output_ids(), w)
    assert eng.metrics()["spec_draft_skips"] > 0


def test_cancel_mid_flight_rolls_back_draft(models):
    _, tm = models
    eng = SpeculativeEngine(tm, tm, spec_k=3, **ENG_KW)
    r1 = eng.submit(_prompts()[0], 20)
    r2 = eng.submit(_prompts()[1], 20)
    for _ in range(3):
        eng.step()
    assert eng.draft.allocator.used_pages + eng.draft.allocator.spec_pages
    r1.cancel()
    _drain(eng, [r1, r2])
    assert r1.state == RequestState.CANCELLED and r2.finished


@pytest.mark.parametrize("seed", [0, 3, 13])
def test_randomized_fault_schedules_drain_exact(models, seed):
    _, tm = models
    prompts = _prompts()
    want = ServingEngine(tm, **ENG_KW).generate_batch(prompts, 6)
    eng = SpeculativeEngine(tm, tm, spec_k=3, **ENG_KW)
    random_schedule(np.random.RandomState(seed), horizon=25, n_faults=4,
                    num_slots=3).install(eng)
    reqs = _drain(eng, [eng.submit(p, 6) for p in prompts])
    for r, w in zip(reqs, want):
        assert r.terminal and (r.finished or r.error is not None)
        if r.finished:
            np.testing.assert_array_equal(r.output_ids(), w)


def test_stall_rebuilds_both_pools(models):
    """A stalled verify step: both pools rebuilt, the zombie releases both
    old ones when it returns."""
    from paddle_tpu_torch.serving import FaultInjector, StepStalledError

    _, tm = models
    eng = SpeculativeEngine(tm, tm, spec_k=2, stall_budget_s=0.5, **ENG_KW)
    eng.generate_batch(_prompts()[:1], 3)          # warm every variant
    old_t, old_d, worker = eng.cache, eng.draft.cache, eng._worker
    FaultInjector().inject("before_decode", at=0, kind="step_stall",
                           duration=1.5).install(eng)
    reqs = _drain(eng, [eng.submit(p, 4) for p in _prompts()[:4]])
    m = eng.metrics()
    assert m["recoveries"] == 1 and m["rebuilds"] == 1
    assert sum(isinstance(r.error, StepStalledError) for r in reqs) == 3
    worker._t.join(timeout=5.0)
    assert old_t.k is None and old_d.k is None
    assert eng.cache.k is not None and eng.draft.cache.k is not None


def test_multi_token_itl_convention(models):
    _, tm = models
    eng = SpeculativeEngine(tm, tm, spec_k=3, **ENG_KW)
    reqs = [eng.submit(p, 7) for p in _prompts(lengths=(6, 11))]
    eng.run_until_idle()
    m = eng.metrics()
    assert m["slo"]["itl"]["count"] == sum(len(r.tokens) - 1 for r in reqs)
    hist = m["spec_accepted_per_step"]
    assert hist["count"] >= 1 and hist["max"] <= eng.spec_k


def test_metrics_and_validation(models):
    _, tm = models
    eng = SpeculativeEngine(tm, tm, spec_k=2, **ENG_KW)
    eng.generate_batch(_prompts(lengths=(6,)), 4)
    m = eng.metrics()
    for key in SPEC_COUNTS + ("spec_acceptance_rate",
                              "spec_accepted_per_step", "draft_pages_used",
                              "draft_spec_pages"):
        assert key in m, key
    assert m["spec_k"] == 2
    with pytest.raises(ValueError, match="spec_k"):
        SpeculativeEngine(tm, tm, spec_k=0, **ENG_KW)
    other = GPTStackedForPretraining(gpt_tiny(vocab_size=512), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeEngine(tm, other, spec_k=2, **ENG_KW)
    with pytest.raises(ValueError, match="num_layers"):
        truncated_draft(tm, 3)
