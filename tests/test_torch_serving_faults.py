"""The port's fault containment held against the JAX package on the CPU
(``tests/test_serving_faults.py``): the watchdog, retry-once, recovery
and rebuild, re-admission backoff, the finiteness sentry, injected pool
exhaustion and callback errors, driven by the same ``FaultInjector``
schedules through the JAX ``ServingEngine`` over its stacked GPT and the
port's over the same weights (``gpt_tiny``, fp32, ``load_jax_state``).

Under the same schedule both engines end every request in the same state
with the same typed error and, for the survivors, the same tokens, token
for token; the retry, recovery and rebuild counts agree; the page ledger
``free + used + spec + shared == capacity`` holds at every step and
drains to zero.  Then what only the port has: the watchdog's zombie keeps
the old pool alive until it returns and then releases it, the first
dispatch of a step variant gets the compile budget, and a kernel's
refusal or a CUDA error that leaves the context unusable is not
contained."""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.faults import random_schedule as jax_random_schedule
from paddle_tpu.models import GPTStackedForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import FaultInjector as JaxInjector
from paddle_tpu.serving import ServingEngine as JaxEngine

from paddle_tpu_torch.models import GPTStackedForPretraining, gpt_tiny
from paddle_tpu_torch.ops.kernels import KernelError
from paddle_tpu_torch.serving import (
    FaultInjector, FaultPlan, InjectedFault, NaNLogitsError, RequestState,
    ServingEngine, ServingError, StepStalledError, random_schedule,
)

torch.set_num_threads(2)

N_NEW = 4


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
def served():
    """Both models, the prompts, and the unfaulted JAX engine's tokens."""
    state = _jax_state(0)
    jm = JaxGPT(jax_gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0))
    jm.eval()
    jm.set_state_dict(state)
    tm = GPTStackedForPretraining(gpt_tiny(), device="cpu")
    tm.load_jax_state(state)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 1024, (s,)) for s in (5, 9, 7, 12, 17, 4, 11,
                                                    6)]
    refs = _jax_engine(jm, num_slots=3).generate_batch(prompts, N_NEW)
    return jm, tm, prompts, refs


def _kw(kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("page_size", 16)
    kw.setdefault("max_context", 64)
    kw.setdefault("cache_dtype", "float32")
    return kw


def _jax_engine(m, **kw):
    return JaxEngine(m, **_kw(kw))


def _engine(m, **kw):
    return ServingEngine(m, **_kw(kw))


def _ledger(a):
    return a.free_pages + a.used_pages + a.spec_pages + a.shared_pages


def _drain(eng, reqs, max_steps=2000):
    """Step to idle, holding the 4-term ledger at every step boundary."""
    steps = 0
    while eng.queue.depth or eng.scheduler.active_slots:
        met = eng.step()
        steps += 1
        a = eng.allocator
        assert _ledger(a) == a.capacity
        assert met["pages_used"] <= a.capacity
        assert steps < max_steps, "engine stopped making progress"
        if not met["active_slots"] and not met["tokens_this_step"]:
            time.sleep(0.001)          # post-recovery backoff window
    assert eng.allocator.used_pages == 0
    assert eng.allocator.free_pages + eng.allocator.shared_pages == \
        eng.allocator.capacity
    return reqs


def _outcome(reqs):
    """What a run gives a client: per request its state, its error's type
    and its tokens."""
    return [(r.state, type(r.error).__name__ if r.error else None,
             list(r.tokens)) for r in reqs]


COUNTS = ("step_retries", "recoveries", "rebuilds", "failed", "quarantined",
          "completed")


def _both(served, inject, *, n=4, must_fire=True, **kw):
    """Run prompts[:n] through the JAX and the port engine under the same
    injected faults (``inject(injector_cls)`` builds the injector);
    returns (port engine, port requests, port metrics) after checking the
    shots fired, the outcomes and the counts agree."""
    jm, tm, prompts, refs = served
    runs = []
    for make, cls, m in ((_jax_engine, JaxInjector, jm),
                         (_engine, FaultInjector, tm)):
        eng = make(m, **kw)
        inj = inject(cls).install(eng)
        reqs = _drain(eng, [eng.submit(p, N_NEW) for p in prompts[:n]])
        runs.append((eng, inj, reqs))
    (je, jinj, jreqs), (te, tinj, treqs) = runs
    assert [(s.point, s.occurrence, s.kind) for s in tinj.log] == \
        [(s.point, s.occurrence, s.kind) for s in jinj.log]
    assert tinj.log or not must_fire, "the schedule never fired"
    assert _outcome(treqs) == _outcome(jreqs)
    jmet, tmet = je.metrics(), te.metrics()
    assert {k: tmet[k] for k in COUNTS} == {k: jmet[k] for k in COUNTS}
    for r, ref in zip(treqs, refs):
        if r.state == RequestState.DONE:
            np.testing.assert_array_equal(r.output_ids(), ref)
    je.close()
    return te, treqs, tmet


# ---------------------------------------------------------------------------
# the harness itself
# ---------------------------------------------------------------------------

def test_fault_plan_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan(point="before_decode", at=0, kind="nope")
    with pytest.raises(ValueError, match="cannot fire at point"):
        FaultPlan(point="alloc", at=0, kind="nan_logits")


@pytest.mark.parametrize("seed", [0, 7, 23])
def test_random_schedule_is_the_reference_one(seed):
    got = random_schedule(np.random.RandomState(seed), horizon=25,
                          n_faults=6, num_slots=3, include_stalls=True)
    want = jax_random_schedule(np.random.RandomState(seed), horizon=25,
                               n_faults=6, num_slots=3, include_stalls=True)
    assert [vars(p) for p in got.plans] == [vars(p) for p in want.plans]


# ---------------------------------------------------------------------------
# retry once, recovery, rebuild, backoff: the JAX engine's outcomes
# ---------------------------------------------------------------------------

def test_transient_step_crash_retries_and_nothing_fails(served):
    te, treqs, m = _both(served, lambda c: c().inject(
        "before_decode", at=2, kind="step_exception"))
    assert m["step_retries"] == 1 and m["recoveries"] == 0
    assert all(r.finished for r in treqs)


def test_persistent_step_crash_fails_only_seated_requests(served):
    te, treqs, m = _both(served, lambda c: c().inject(
        "before_decode", at=1, times=2, kind="step_exception"))
    assert m["recoveries"] == 1 and m["rebuilds"] == 0
    failed = [r for r in treqs if r.state == RequestState.FAILED]
    assert len(failed) == 2
    assert all(isinstance(r.error, InjectedFault) for r in failed)


def test_non_intact_crash_rebuilds_the_pool(served):
    jm, tm, prompts, refs = served
    eng = _engine(tm)
    old = eng.cache
    FaultInjector().inject("before_decode", at=1, times=2,
                           kind="step_exception",
                           state_intact=False).install(eng)
    reqs = _drain(eng, [eng.submit(p, N_NEW) for p in prompts[:4]])
    m = eng.metrics()
    assert m["recoveries"] == 1 and m["rebuilds"] == 1
    assert old.k is None and old.v is None, "the suspect pool was kept"
    assert eng.cache is not old and eng.cache.k is not None
    assert len([r for r in reqs if r.finished]) == 2
    for r, ref in zip(reqs, refs):
        if r.finished:
            np.testing.assert_array_equal(r.output_ids(), ref)


def test_recovery_arms_readmission_backoff(served):
    jm, tm, prompts, refs = served
    eng = _engine(tm, readmission_backoff_s=0.2, backoff_max_s=0.3)
    FaultInjector().inject("before_decode", at=0, times=4,
                           kind="step_exception").install(eng)
    reqs = [eng.submit(p, N_NEW) for p in prompts[:6]]
    eng.step()                   # seats 2, crashes twice -> recovery
    assert eng.metrics()["recoveries"] == 1 and eng.queue.depth == 4
    assert eng._backoff_s == pytest.approx(0.3)     # 0.2 doubled, capped
    eng.step()                   # within the backoff window: no admission
    assert eng.scheduler.active_slots == 0
    time.sleep(0.25)
    eng.step()                   # admission resumes, crashes twice again
    assert eng.metrics()["recoveries"] == 2 and eng.queue.depth == 2
    eng.step()
    assert eng.scheduler.active_slots == 0          # 0.3 s window now
    time.sleep(0.35)
    _drain(eng, reqs)
    assert [r.state for r in reqs[4:]] == [RequestState.DONE] * 2
    # a clean step resets the backoff
    assert eng._backoff_s == pytest.approx(0.2)
    for r, ref in zip(reqs[4:], refs[4:]):
        np.testing.assert_array_equal(r.output_ids(), ref)


# ---------------------------------------------------------------------------
# the watchdog: stall, abandon, rebuild, zombie cleanup
# ---------------------------------------------------------------------------

def test_watchdog_abandons_stalled_step_and_zombie_releases_old_pool(served):
    jm, tm, prompts, refs = served
    eng = _engine(tm, stall_budget_s=0.5, compile_budget_s=60.0)
    w = eng.submit(prompts[0], 2)        # first dispatch: compile budget
    _drain(eng, [w])
    assert w.finished and ("fused", False) in eng._warm
    old, old_worker = eng.cache, eng._worker
    inj = FaultInjector().inject("before_decode", at=0, kind="step_stall",
                                 duration=2.0).install(eng)
    t0 = time.perf_counter()
    reqs = _drain(eng, [eng.submit(p, N_NEW) for p in prompts[:4]])
    assert inj.fired("step_stall") == 1
    m = eng.metrics()
    assert m["recoveries"] == 1 and m["rebuilds"] == 1
    stalled = [r for r in reqs if isinstance(r.error, StepStalledError)]
    assert len(stalled) == 2                    # the seated pair
    for r, ref in zip(reqs, refs):
        if r.finished:
            np.testing.assert_array_equal(r.output_ids(), ref)
    # the zombie keeps the old pool until it returns, then releases it;
    # the rebuilt pool stays live
    assert old_worker is not eng._worker and old_worker.dead
    if time.perf_counter() - t0 < 1.5:
        assert old.k is not None, "the old pool went before the zombie"
    old_worker._t.join(timeout=5.0)
    assert not old_worker._t.is_alive(), "the dead worker's thread leaked"
    assert old.k is None and old.v is None
    assert eng.cache.k is not None


def test_watchdog_outcome_matches_jax(served):
    """The same stall through both engines: the same requests fail with
    StepStalledError and the rest give the same tokens."""
    _both(served, lambda c: c().inject("before_decode", at=2,
                                       kind="step_stall", duration=1.5),
          stall_budget_s=0.5)


def test_compile_budget_covers_each_variants_first_dispatch(served):
    _, tm, prompts, _ = served
    eng = _engine(tm, stall_budget_s=0.25, compile_budget_s=30.0)
    assert eng._budget_for([("fused", False)]) == 30.0
    eng.generate_batch(prompts[:1], 2)
    assert eng._budget_for([("fused", False)]) == 0.25
    assert eng._budget_for([("fused", True)]) == 30.0   # sampling: not yet
    # the compile budget never falls below the stall budget
    assert _engine(tm, stall_budget_s=5.0,
                   compile_budget_s=1.0).compile_budget_s == 5.0
    assert _engine(tm)._budget_for([("fused", False)]) is None


def test_stall_budget_off_dispatches_inline(served):
    _, tm, prompts, refs = served
    eng = _engine(tm)
    seen = []
    eng._fault_hook = lambda point, ctx: seen.append(
        (point, threading.current_thread() is threading.main_thread()))
    eng.generate_batch(prompts[:1], 2)
    assert eng._worker is None
    assert ("before_decode", True) in seen
    eng2 = _engine(tm, stall_budget_s=30.0)
    seen.clear()
    eng2._fault_hook = eng._fault_hook
    eng2.generate_batch(prompts[:1], 2)
    assert ("before_decode", False) in seen      # on the worker's thread


# ---------------------------------------------------------------------------
# sentry, exhaustion, callbacks
# ---------------------------------------------------------------------------

def test_nan_quarantine_fails_only_poisoned_slot(served):
    te, treqs, m = _both(served, lambda c: c().inject(
        "after_decode", at=1, kind="nan_logits", slots=[0]))
    assert m["quarantined"] == 1 and m["recoveries"] == 0
    assert len([r for r in treqs
                if isinstance(r.error, NaNLogitsError)]) == 1


def test_real_nan_weights_trip_the_in_step_sentry(served):
    _, tm, _, _ = served
    m = GPTStackedForPretraining(gpt_tiny(), device="cpu")
    with torch.no_grad():
        m.decoder.qkv_w.fill_(float("nan"))
    eng = _engine(m)
    r = eng.submit(np.array([1, 2, 3], np.int64), N_NEW)
    eng.run_until_idle(max_steps=10)
    assert r.state == RequestState.FAILED
    assert isinstance(r.error, NaNLogitsError) and r.tokens == []
    assert eng.allocator.used_pages == 0
    assert eng.metrics()["quarantined"] == 1


def test_injected_pool_exhaustion_backpressures_then_completes(served):
    te, treqs, m = _both(served, lambda c: c().inject(
        "alloc", at=0, times=4, kind="alloc_exhausted"))
    assert m["failed"] == 0 and all(r.finished for r in treqs)


def test_injected_callback_fault(served):
    jm, tm, prompts, refs = served
    eng = _engine(tm)
    inj = FaultInjector().inject("callback", at=0,
                                 kind="callback_error").install(eng)
    seen = []
    with pytest.warns(RuntimeWarning, match="on_token callback"):
        r = eng.submit(prompts[1], N_NEW,
                       on_token=lambda rq, t: seen.append(t))
        eng.run_until_idle()
    assert inj.fired("callback_error") == 1
    assert r.state == RequestState.DONE
    assert isinstance(r.callback_error, InjectedFault)
    np.testing.assert_array_equal(r.output_ids(), refs[1])
    assert len(seen) == N_NEW - 1


# ---------------------------------------------------------------------------
# the acceptance property: randomized schedules, exact accounting, parity
# ---------------------------------------------------------------------------

# the reference's seeds (7 fires nothing in this traffic), then 3 (pool
# exhaustion beside a recovery) and 13 (two recoveries)
@pytest.mark.parametrize("seed", [7, 23, 101, 3, 13])
def test_randomized_fault_schedule_matches_jax(served, seed):
    def inject(cls):
        make = (random_schedule if cls is FaultInjector
                else jax_random_schedule)
        return make(np.random.RandomState(seed), horizon=25, n_faults=4,
                    num_slots=3)

    te, treqs, m = _both(served, inject, n=8, must_fire=False, num_slots=3)
    for r in treqs:
        assert r.terminal and (r.finished or r.error is not None)


@pytest.mark.parametrize("seed", [11, 29])
def test_randomized_fault_schedule_with_prefix_cache(served, seed):
    """The property extended to shared pages: shared-prefix traffic
    through a prefix-cache engine under a randomized schedule keeps the
    4-term ledger at every step (splicing, unref, eviction, the rebuild's
    flush), ends with every shared page unreferenced, and the survivors
    give the cache-off engine's tokens."""
    jm, tm, prompts, _ = served
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, 1024, (16,))
    sprompts = [np.concatenate([prefix, p]) for p in prompts]
    srefs = _engine(tm, num_slots=3).generate_batch(sprompts, N_NEW)
    eng = _engine(tm, num_slots=3, prefix_cache=True)
    random_schedule(rng, horizon=25, n_faults=4, num_slots=3).install(eng)
    reqs = _drain(eng, [eng.submit(p, N_NEW) for p in sprompts])
    assert all(c == 0 for c in eng.allocator._shared.values())
    for r, ref in zip(reqs, srefs):
        assert r.terminal and (r.finished or r.error is not None)
        if r.finished:
            np.testing.assert_array_equal(r.output_ids(), ref)


def test_generate_batch_raises_on_failed_requests(served):
    _, tm, prompts, _ = served
    eng = _engine(tm)
    FaultInjector().inject("before_decode", at=0, times=2,
                           kind="step_exception").install(eng)
    with pytest.raises(ServingError, match="did not complete"):
        eng.generate_batch(prompts[:2], N_NEW)
    assert eng.allocator.used_pages == 0


def test_step_metrics_expose_fault_counters(served):
    _, tm, prompts, _ = served
    eng = _engine(tm)
    eng.submit(prompts[0], 2)
    met = eng.step()
    for key in ("failed", "cancelled", "timed_out", "shed", "recoveries"):
        assert key in met
    for key in ("quarantined", "step_retries", "rebuilds"):
        assert key in eng.metrics()
    eng.run_until_idle()


# ---------------------------------------------------------------------------
# what containment must not hide
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("error,contained", [
    (RuntimeError("transient"), True),
    (ValueError("ragged_paged_attention kernel: head_dim=80"), False),
    (RuntimeError("ragged_paged_attention kernel launch failed: an illegal "
                  "memory access was encountered (cudaError 700)"), False),
    (RuntimeError("CUDA error: unspecified launch failure"), False),
    (RuntimeError("CUDA error: device-side assert triggered"), False),
])
def test_uncontainable_errors_propagate(served, error, contained):
    _, tm, prompts, _ = served
    eng = _engine(tm)

    def hook(point, ctx):
        if point == "before_decode":
            raise error

    eng._fault_hook = hook
    r = eng.submit(prompts[0], N_NEW)
    if contained:
        eng.step()
        m = eng.metrics()
        assert m["step_retries"] == 1 and m["recoveries"] == 1
        assert r.state == RequestState.FAILED and r.error is error
    else:
        with pytest.raises(type(error)) as info:
            eng.step()
        assert info.value is error
        assert eng.metrics()["step_retries"] == 0
        assert eng.metrics()["recoveries"] == 0


@pytest.mark.parametrize("budget", [None, 30.0], ids=["inline", "watched"])
@pytest.mark.parametrize("message", [
    "kernel build failed: ragged_paged_attention (nvcc exit 1)",
    "ragged_paged_attention kernel launch failed: invalid configuration "
    "argument (cudaError 9)",
    "ragged_paged_attention kernel launch failed: too many resources "
    "requested for launch (cudaError 701)",
    "ragged_paged_attention kernel launch failed: no kernel image is "
    "available for execution on the device (cudaError 209)",
], ids=["build", "config", "resources", "image"])
def test_kernel_error_in_the_step_propagates(served, monkeypatch, message,
                                             budget):
    """A kernel that cannot be built or launched fails again on a retry
    and after a rebuild, so the (watched or inline) step re-raises it on
    its first call: no retry, no recovery, no rebuild."""
    from paddle_tpu_torch.models import gpt as tgpt
    _, tm, prompts, _ = served
    error = KernelError(message)
    calls = []

    def broken(*args, **kwargs):
        calls.append(threading.current_thread().name)
        raise error

    monkeypatch.setattr(tgpt, "ragged_paged_attention", broken)
    watch = {} if budget is None else {"stall_budget_s": budget,
                                       "compile_budget_s": budget}
    eng = _engine(tm, **watch)
    r = eng.submit(prompts[0], N_NEW)
    with pytest.raises(KernelError) as info:
        eng.step()
    assert info.value is error and len(calls) == 1
    if budget is not None:
        assert calls[0] != threading.current_thread().name
    m = eng.metrics()
    assert (m["step_retries"], m["recoveries"], m["rebuilds"]) == (0, 0, 0)
    assert r.state != RequestState.FAILED
    eng.close()
