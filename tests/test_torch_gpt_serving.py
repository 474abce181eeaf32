"""The port's serving slice held against the JAX package on the CPU:
weights carried across by ``load_jax_state``, one fused step's logits and
pool writes, and whole engines -- the JAX ``ServingEngine`` over its
``GPTStackedForPretraining`` and the port's over carried-over fp32
weights must give the same greedy tokens, token for token.  Then the
port's own engine invariants: sampling properties, typed terminals with
exact page accounting, and admission backpressure.

Sizes are small (``gpt_tiny``: hidden 64, 2 layers, 4 heads, head_dim 16;
page 16; max_context 64).  fp32 logits agree within 1e-5: the same
arithmetic, summed in another order by XLA and by PyTorch."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import GPTStackedForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.tensor import to_tensor

from paddle_tpu_torch.models import GPTStackedForPretraining, gpt_tiny
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as tra
from paddle_tpu_torch.serving import (
    DeadlineExceeded, NaNLogitsError, Overloaded, RequestCancelled,
    RequestState, SamplingParams, ServingEngine,
)

torch.set_num_threads(2)

ENGINE_KW = dict(page_size=16, max_context=64, cache_dtype="float32")


def _jax_model(seed):
    """A JAX stacked GPT with every bias and LayerNorm gain perturbed
    away from its 0/1 init, so the parity covers them too."""
    pt.seed(seed)
    m = JaxGPT(jax_gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0))
    m.eval()
    rng = np.random.RandomState(seed)
    state = {}
    for k, v in m.state_dict().items():
        a = np.asarray(v.numpy(), np.float32)
        if k.endswith(("_b", "_g", "bias")) or k == "final_ln.weight":
            a = a + 0.1 * rng.randn(*a.shape).astype(np.float32)
        state[k] = a
    m.set_state_dict(state)
    return m, state


def _port_model(state):
    m = GPTStackedForPretraining(gpt_tiny(), device="cpu", dtype="float32")
    m.load_jax_state(state)
    return m


@pytest.fixture(scope="module")
def models():
    jm, state = _jax_model(3)
    return jm, _port_model(state), state


def test_load_jax_state_round_trips_every_key(models):
    jm, tm, state = models
    got = {k: p.detach().numpy() for k, p in tm.named_parameters()}
    assert set(got) == set(state) == set(jm.state_dict())
    for k, a in state.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    with pytest.raises(KeyError, match="missing"):
        tm.load_jax_state({k: a for k, a in state.items()
                           if k != "decoder.qkv_w"})
    with pytest.raises(KeyError, match="unknown"):
        tm.load_jax_state({**state, "decoder.extra": state["decoder.ln1_g"]})
    with pytest.raises(ValueError, match="shape"):
        tm.load_jax_state({**state, "decoder.ln1_g": state["decoder.ln1_b"][:1]})


def test_fused_step_logits_and_pool_match_jax(models):
    """One fused mixed step (a 10-token prefill chunk straddling a page,
    a decode at position 20 over a pre-filled pool, padding tokens) gives
    the JAX model's logits and the same pool writes."""
    jm, tm, _ = models
    cfg = tm.config
    rng = np.random.RandomState(4)
    num_pages, t_max, nb_max, mp = 9, 16, 4, 4
    runs = [(6, 10, np.array([3, 5, 0, 0], np.int32)),
            (20, 1, np.array([1, 2, 0, 0], np.int32))]
    plan, stats = tra.build_ragged_plan(
        runs, token_block=tra.TOKEN_BLOCK, page_size=16, t_max=t_max,
        nb_max=nb_max, wl_max=nb_max * mp)
    ids = np.zeros((t_max, 1), np.int64)
    tables = np.zeros((t_max, mp), np.int32)
    positions = np.zeros((t_max,), np.int32)
    for (base, count, tbl), start in zip(runs, stats["run_starts"]):
        ids[start:start + count, 0] = rng.randint(0, cfg.vocab_size, count)
        tables[start:start + count] = tbl
        positions[start:start + count] = base + np.arange(count)
    out_rows = np.array([9, 10], np.int32)
    shape = (cfg.num_layers, num_pages, cfg.num_heads, 16, cfg.head_dim)
    k0 = rng.randn(*shape).astype(np.float32)
    v0 = rng.randn(*shape).astype(np.float32)

    jc = jm.new_paged_kv_cache(num_pages, 16, dtype="float32")
    jc.k._set_value(to_tensor(k0)._value)
    jc.v._set_value(to_tensor(v0)._value)
    jlog = jm._paged_lm_logits(
        to_tensor(ids), jc, to_tensor(tables), to_tensor(positions),
        ragged_plan=tuple(to_tensor(plan[k]) for k in tra.RAGGED_PLAN_FIELDS),
        out_rows=to_tensor(out_rows)).numpy()

    tc = tm.new_paged_kv_cache(num_pages, 16, dtype="float32")
    tc.k.copy_(torch.from_numpy(k0))
    tc.v.copy_(torch.from_numpy(v0))
    with torch.no_grad():
        tlog = tm._paged_lm_logits(
            torch.from_numpy(ids), tc, torch.from_numpy(tables),
            torch.from_numpy(positions),
            ragged_plan=tuple(torch.from_numpy(plan[k])
                              for k in tra.RAGGED_PLAN_FIELDS),
            out_rows=torch.from_numpy(out_rows)).numpy()
    assert tlog.shape == jlog.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(tlog, jlog, rtol=1e-5, atol=1e-5)
    for t_pool, j_pool, before in ((tc.k, jc.k, k0), (tc.v, jc.v, v0)):
        jp = np.asarray(j_pool.numpy())
        tp = t_pool.numpy()
        np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-5)
        # the same positions were written: the 10 prefill rows, the decode
        # row and the padding sink at page 0, position 0
        changed_t = np.argwhere((tp != before).any(axis=(0, 2, 4)))
        changed_j = np.argwhere((jp != before).any(axis=(0, 2, 4)))
        np.testing.assert_array_equal(changed_t, changed_j)
        assert len(changed_t) == 10 + 1 + 1


def _drive(engine, arrivals, per_step, max_new):
    """Submit ``per_step`` arrivals before each step until everything has
    drained; returns the requests in submission order."""
    reqs, it, pending = [], iter(zip(arrivals, max_new)), True
    while pending or engine.queue.depth or engine.scheduler.active_slots:
        for _ in range(per_step):
            try:
                p, n = next(it)
            except StopIteration:
                pending = False
                break
            reqs.append(engine.submit(p, n))
        engine.step()
    return reqs


SLICE_CASES = {
    # tests/test_serving.py::test_fused_mixed_step_parity: a tiny budget
    # forces multi-step prefills to overlap other slots' decode
    "mixed_arrivals": dict(lengths=(4, 17, 7, 21, 11, 5), new=None,
                           prompt_seed=2, per_step=1,
                           engine=dict(num_slots=2, prefill_token_budget=6)),
    # tests/test_serving.py::test_continuous_batching_churn_matches_generate:
    # 20 varying-length requests, two arrivals per step
    "churn": dict(lengths=(3, 17, 5, 9, 14, 4, 19, 7, 11, 6) * 2, new="rand",
                  prompt_seed=1, per_step=2,
                  engine=dict(num_slots=4, prefill_token_budget=8)),
}


@pytest.mark.parametrize("case", sorted(SLICE_CASES))
def test_slice_greedy_tokens_equal_jax_engine(models, case):
    jm, tm, _ = models
    c = SLICE_CASES[case]
    rng = np.random.RandomState(c["prompt_seed"])
    prompts = [rng.randint(0, tm.config.vocab_size, (s,))
               for s in c["lengths"]]
    if c["new"] == "rand":
        max_new = [int(rng.randint(2, 9)) for _ in prompts]
    else:
        max_new = [4] * len(prompts)
    je = JaxEngine(jm, **ENGINE_KW, **c["engine"])
    te = ServingEngine(tm, **ENGINE_KW, **c["engine"])
    jreqs = _drive(je, prompts, c["per_step"], max_new)
    treqs = _drive(te, prompts, c["per_step"], max_new)
    for jr, tr in zip(jreqs, treqs):
        assert jr.finished and tr.finished
        assert np.array_equal(tr.output_ids(), jr.output_ids()), (
            case, tr.tokens, jr.tokens)
    assert je.allocator.used_pages == te.allocator.used_pages == 0
    jmet, tmet = je.metrics(), te.metrics()
    assert tmet["completed"] == jmet["completed"] == len(prompts)
    assert tmet["tokens"] == jmet["tokens"] == sum(max_new)
    je.close()
    te.close()


def _prompts(n, seed=5, lo=3, hi=20, vocab=1024):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (int(rng.randint(lo, hi)),))
            for _ in range(n)]


def test_greedy_rows_exact_inside_mixed_batch(models):
    _, tm, _ = models
    prompts = _prompts(4)
    greedy = ServingEngine(tm, num_slots=4, **ENGINE_KW).generate_batch(
        prompts, 6)
    eng = ServingEngine(tm, num_slots=4, seed=7, **ENGINE_KW)
    hot = SamplingParams(do_sample=True, temperature=1.5)
    reqs = [eng.submit(p, 6, sampling=hot if i % 2 else None)
            for i, p in enumerate(prompts)]
    eng.run_until_idle()
    for i, (r, ref) in enumerate(zip(reqs, greedy)):
        assert r.finished
        if i % 2 == 0:
            assert np.array_equal(r.output_ids(), ref)
    assert eng.allocator.used_pages == 0


def test_top_k_one_sampling_equals_greedy(models):
    _, tm, _ = models
    prompts = _prompts(3, seed=6)
    greedy = ServingEngine(tm, num_slots=2, **ENGINE_KW).generate_batch(
        prompts, 5)
    got = ServingEngine(tm, num_slots=2, seed=11, **ENGINE_KW).generate_batch(
        prompts, 5, sampling=SamplingParams(do_sample=True, temperature=0.7,
                                            top_k=1))
    for a, b in zip(got, greedy):
        np.testing.assert_array_equal(a, b)


def test_engine_seed_reproduces_sampled_tokens(models):
    _, tm, _ = models
    prompts = _prompts(4, seed=8)
    sp = SamplingParams(do_sample=True, temperature=1.0, top_p=0.9)

    def run(seed):
        eng = ServingEngine(tm, num_slots=2, seed=seed, **ENGINE_KW)
        return [r.tolist() for r in eng.generate_batch(prompts, 8,
                                                       sampling=sp)]

    first = run(123)
    assert run(123) == first
    assert run(124) != first


def test_nan_sentry_quarantines_only_the_poisoned_slot(models):
    """A request whose first KV page turns non-finite ends FAILED with
    NaNLogitsError; the requests seated beside it finish with their clean
    tokens; every page comes back."""
    _, tm, _ = models
    prompts = _prompts(4, seed=9, hi=12)
    clean = ServingEngine(tm, num_slots=4, **ENGINE_KW).generate_batch(
        prompts, 4)
    eng = ServingEngine(tm, num_slots=4, **ENGINE_KW)
    reqs = [eng.submit(p, 4) for p in prompts]
    eng.step()                       # all four seated
    victim = reqs[1]
    idx = next(i for i, s in eng.scheduler.seated() if s.request is victim)
    with torch.no_grad():
        eng.cache.k[:, int(eng.scheduler.tables[idx, 0])] = float("nan")
    eng.run_until_idle()
    assert victim.state == RequestState.FAILED
    assert isinstance(victim.error, NaNLogitsError)
    for r, ref in zip(reqs, clean):
        if r is not victim:
            assert r.finished and np.array_equal(r.output_ids(), ref)
    m = eng.metrics()
    assert m["quarantined"] == 1 and m["failed"] == 1
    assert eng.allocator.used_pages == 0


def test_cancel_deadline_and_shedding_end_typed_with_exact_pages(models):
    _, tm, _ = models
    prompts = _prompts(5, seed=10)
    eng = ServingEngine(tm, num_slots=2, max_queue_depth=3, **ENGINE_KW)
    seated = eng.submit(prompts[0], 20)
    doomed = eng.submit(prompts[1], 20, deadline_s=1e-3)
    queued = eng.submit(prompts[2], 4)
    with pytest.raises(Overloaded):
        for p in prompts[3:]:
            eng.submit(p, 4)
    eng.step()                       # seats the first two
    assert eng.allocator.used_pages > 0
    seated.cancel()
    queued.cancel()
    import time

    time.sleep(2e-3)                 # the deadline passes mid-decode
    eng.step()
    assert seated.state == RequestState.CANCELLED
    assert isinstance(seated.error, RequestCancelled)
    assert queued.state == RequestState.CANCELLED
    assert doomed.state == RequestState.TIMED_OUT
    assert isinstance(doomed.error, DeadlineExceeded)
    assert not seated.cancel()       # already terminal
    eng.run_until_idle()
    assert eng.allocator.used_pages == 0
    assert eng.allocator.free_pages == eng.allocator.capacity
    m = eng.metrics()
    assert (m["cancelled"], m["timed_out"], m["shed"]) == (2, 1, 1)


def test_queue_wait_shedding(models):
    _, tm, _ = models
    eng = ServingEngine(tm, num_slots=1, max_queue_wait_s=0.0, **ENGINE_KW)
    r = eng.submit(_prompts(1, seed=12)[0], 3)
    eng.step()
    assert r.state == RequestState.TIMED_OUT
    assert isinstance(r.error, Overloaded)
    assert eng.metrics()["shed"] == 1 and eng.allocator.used_pages == 0


def test_out_of_pages_admission_backpressures(models):
    """tests/test_serving.py::test_out_of_pages_admission_backpressures:
    4 slots but 6 allocatable pages and 2 pages per request -- the pool,
    not the slot count, binds; the overflow queues and every request
    still ends with the tokens of an unconstrained engine."""
    _, tm, _ = models
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 1024, (20,)) for _ in range(6)]
    free = ServingEngine(tm, num_slots=4, **ENGINE_KW).generate_batch(
        prompts, 3)
    eng = ServingEngine(tm, num_slots=4, num_pages=7, **ENGINE_KW)
    reqs = [eng.submit(p, 3) for p in prompts]
    saw_backpressure, peak, steps = False, 0, 0
    while eng.queue.depth or eng.scheduler.active_slots:
        met = eng.step()
        steps += 1
        peak = max(peak, met["pages_used"])
        assert met["pages_used"] <= eng.allocator.capacity
        if met["queue_depth"] > 0 and met["active_slots"] > 0:
            saw_backpressure = True
        assert steps < 200, "engine made no progress"
    assert saw_backpressure and peak == 6
    for r, ref in zip(reqs, free):
        np.testing.assert_array_equal(r.output_ids(), ref)
    assert eng.allocator.used_pages == 0
    assert eng.metrics()["completed"] == 6


def test_metrics_and_close(models):
    _, tm, _ = models
    eng = ServingEngine(tm, num_slots=2, **ENGINE_KW)
    eng.step()                       # idle tick: no fused step ran
    assert eng.metrics()["fused_steps"] == 0
    eng.generate_batch(_prompts(3, seed=13), 3)
    m = eng.metrics()
    assert m["fused_steps"] > 0 and m["completed"] == 3 and m["tokens"] == 9
    assert 0.0 < m["mean_grid_occupancy"] <= 1.0
    assert 0.0 < m["mean_q_row_occupancy"] <= 1.0
    assert m["slo"]["ttft"]["count"] == 3
    assert m["cache_bytes"] > 0
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.step()


def test_eos_stops_early_and_on_token_streams(models):
    _, tm, _ = models
    prompts = _prompts(2, seed=14)
    ref = ServingEngine(tm, num_slots=2, **ENGINE_KW).generate_batch(
        prompts, 6)
    gen0 = [int(t) for t in ref[0][len(prompts[0]):]]
    eos = gen0[2]
    seen = []
    eng = ServingEngine(tm, num_slots=2, **ENGINE_KW)
    r0 = eng.submit(prompts[0], 6, eos_token_id=eos,
                    on_token=lambda r, t: seen.append((r.id, t)))

    def gone(r, t):
        raise ValueError("client went away")

    r1 = eng.submit(prompts[1], 6, on_token=gone)
    with pytest.warns(RuntimeWarning, match="on_token"):
        eng.run_until_idle()
    assert r0.wait(timeout=0) and r0.finished
    assert r0.tokens == gen0[:gen0.index(eos) + 1]
    assert seen == [(r0.id, t) for t in r0.tokens]
    # a raising callback is recorded, and never stops serving
    assert r1.finished and isinstance(r1.callback_error, ValueError)
    np.testing.assert_array_equal(r1.output_ids(), ref[1])
    assert eng.allocator.used_pages == 0


def test_wait_raises_the_typed_error_of_a_failed_request(models):
    _, tm, _ = models
    eng = ServingEngine(tm, num_slots=1, **ENGINE_KW)
    r = eng.submit(_prompts(1, seed=15)[0], 4)
    r.cancel()
    eng.step()
    with pytest.raises(RequestCancelled):
        r.wait(timeout=0, raise_on_failure=True)
    assert not r.cancel()


@pytest.mark.parametrize("prompt,new,kw,match", [
    ([], 4, {}, "at least one token"),
    ([1, 2], 0, {}, "max_new_tokens"),
    ([1] * 60, 8, {}, "max_context"),
    ([1, 2], 4, {"deadline_s": 0.0}, "deadline_s"),
])
def test_submit_validates_requests(models, prompt, new, kw, match):
    _, tm, _ = models
    eng = ServingEngine(tm, num_slots=1, **ENGINE_KW)
    with pytest.raises(ValueError, match=match):
        eng.submit(np.array(prompt, np.int64), new, **kw)
    assert eng.queue.depth == 0


@pytest.mark.parametrize("kw,match", [
    (dict(do_sample=True, temperature=0.0), "temperature"),
    (dict(top_p=0.0), "top_p"),
    (dict(top_k=-1), "top_k"),
])
def test_sampling_params_validate(kw, match):
    with pytest.raises(ValueError, match=match):
        SamplingParams(**kw)


def test_fp32_model_serves_from_a_bf16_pool(models):
    """The engine's default pool dtype is bf16: K/V are rounded into the
    pool and the attention output comes back in bf16 to fp32 weights."""
    _, tm, _ = models
    eng = ServingEngine(tm, num_slots=2, page_size=16, max_context=64)
    assert eng.cache.k.dtype == torch.bfloat16
    reqs = [eng.submit(p, 5) for p in _prompts(3, seed=16)]
    eng.run_until_idle()
    assert all(r.finished and len(r.tokens) == 5 for r in reqs)
    assert eng.allocator.used_pages == 0


def _stamped(engine):
    """One request served to the end and one cancelled while queued (it
    never seats): their ``timestamps()``."""
    prompts = _prompts(2, seed=12)
    served = engine.submit(prompts[0], 3)
    queued = engine.submit(prompts[1], 3)
    queued.cancel()
    engine.run_until_idle()
    engine.close()
    return served.timestamps(), queued.timestamps()


def test_request_timestamps_match_the_jax_engines(models):
    jm, tm, _ = models
    want = _stamped(JaxEngine(jm, num_slots=1, **ENGINE_KW))
    got = _stamped(ServingEngine(tm, num_slots=1, **ENGINE_KW))
    for g, w in zip(got, want):
        assert list(g) == list(w) == ["submitted", "admitted",
                                      "first_token", "terminal"]
        assert [v is None for v in g.values()] == \
            [v is None for v in w.values()]
    served, queued = got
    assert None not in served.values()
    assert list(served.values()) == sorted(served.values())
    assert queued["admitted"] is None and queued["first_token"] is None
    assert queued["submitted"] <= queued["terminal"]


def _progress(engine, prompts, n_new):
    """Each request's generated-token count after every step."""
    reqs = [engine.submit(p, n_new) for p in prompts]
    steps = []
    while engine.queue.depth or engine.scheduler.active_slots:
        engine.step()
        steps.append([len(r.tokens) for r in reqs])
    engine.close()
    return steps


def test_prefill_chunk_is_the_alias_of_prefill_token_budget(models):
    jm, tm, _ = models
    prompts = _prompts(4, seed=13, lo=12, hi=30)
    kw = dict(num_slots=2, **ENGINE_KW)
    want = _progress(JaxEngine(jm, prefill_chunk=8, **kw), prompts, 3)
    assert _progress(ServingEngine(tm, prefill_chunk=8, **kw), prompts,
                     3) == want
    assert _progress(ServingEngine(tm, prefill_token_budget=8, **kw),
                     prompts, 3) == want
    # the reference's rule when both are given: the budget wins
    both = dict(prefill_token_budget=8, prefill_chunk=16, **kw)
    assert ServingEngine(tm, **both).prefill_token_budget == \
        JaxEngine(jm, **both).prefill_token_budget == 8
