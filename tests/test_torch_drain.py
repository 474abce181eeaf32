"""Graceful drain, replica loss and re-homing of the port held against the
JAX package on the CPU (``tests/test_drain.py``), at ``gpt_tiny`` with the
JAX model's weights carried across by ``load_jax_state``.  Each scenario
runs through the JAX engine or cluster and through the port's (on
``devices=["cpu"] * dp``), and their outcomes must be equal: the requests
harvested, checkpointed and re-homed, the tokens emitted before a fold,
the final output ids (equal to an undrained run's, token for token), the
replica states and the page ledgers.

- ``begin_drain`` stops admission (typed ``Overloaded``, not a shed) and
  hands back the queue; seated work finishes and ``drained`` turns true;
- ``checkpoint_seated`` folds the emitted tokens into the prompt
  (``output_ids()`` unchanged), shrinks the grant, and the same request
  object requeues elsewhere; a sampling request carries the generator's
  state (``Request.rng_state``) and its continuation is checked by
  property, not bit for bit;
- the placement layer re-homes onto survivors, holds what no survivor
  can seat, reaps held requests that cancel or expire, and fails them
  typed only when no eligible replica is left;
- the placement signals (adapter residency, speculative acceptance,
  prefix match) rank a set of fake engines as the JAX policies do;
- a drain or a kill at a random tick under speculative, prefix-shared and
  LoRA traffic keeps every ledger exact and every output the undrained
  one's."""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import FaultInjector as JaxInjector
from paddle_tpu.serving import PlacementScheduler as JaxPlacement
from paddle_tpu.serving import PrefixLocalityPlacement as JaxPrefixPolicy
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import ShardedServingEngine as JaxSharded
from paddle_tpu.serving.placement import LeastLoadedPlacement as JaxLeast
from paddle_tpu.serving.placement import replica_signals as jax_signals

from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny
from paddle_tpu_torch.serving import (
    FaultInjector, LeastLoadedPlacement, LoRAAdapterPool, Overloaded,
    PlacementScheduler, PrefixLocalityPlacement, RequestState,
    SamplingParams, ServingEngine, ShardedServingEngine, SpeculativeEngine,
    random_adapter,
)
from paddle_tpu_torch.serving.placement import replica_signals

torch.set_num_threads(2)

N_NEW = 4
KW = dict(num_slots=2, page_size=16, max_context=64, cache_dtype="float32")


@pytest.fixture(scope="module")
def served():
    """(JAX model, port model, prompts, undrained outputs of the JAX
    engine) over one set of weights."""
    pt.seed(0)
    jm = JaxGPT(jax_gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0))
    rng = np.random.RandomState(0)
    state = {}
    for k, v in jm.state_dict().items():
        a = np.asarray(v.numpy(), np.float32)
        if k.endswith(("bias", "ln1.weight", "ln2.weight",
                       "final_ln.weight")):
            a = a + 0.1 * rng.randn(*a.shape).astype(np.float32)
        state[k] = a
    jm.set_state_dict(state)
    jm.eval()
    tm = GPTForPretraining(gpt_tiny(), device="cpu")
    tm.load_jax_state(state)
    tm.eval()
    prng = np.random.RandomState(1)
    prompts = [prng.randint(0, 1024, (s,)) for s in (5, 9, 7, 12, 17, 4)]
    eng = JaxEngine(jm, **KW)
    refs = eng.generate_batch(prompts, N_NEW)
    eng.close()
    return jm, tm, prompts, refs


def _engines(served, **kw):
    jm, tm, _, _ = served
    base = dict(KW, **kw)
    return JaxEngine(jm, **base), ServingEngine(tm, **base)


def _clusters(served, **kw):
    jm, tm, _, _ = served
    base = dict(KW, **kw)
    return (JaxSharded(jm, dp=2, mp=1, **base),
            ShardedServingEngine(tm, dp=2, mp=1, devices=["cpu"] * 2,
                                 **base))


def _same(outcomes):
    assert outcomes[0] == outcomes[1], outcomes


# ---------------------------------------------------------------------------
# the engine's drain lifecycle
# ---------------------------------------------------------------------------

def test_begin_drain_stops_admission_and_harvests_queue(served):
    _, _, prompts, refs = served
    outcomes = []
    for eng in _engines(served):
        reqs = [eng.submit(p, N_NEW) for p in prompts]
        eng.step()
        queued = eng.queue.depth
        harvested = eng.begin_drain()
        assert len(harvested) == queued > 0 and eng.queue.depth == 0
        assert eng.draining and not eng.drained
        shed = eng.metrics()["shed"]
        with pytest.raises(Exception, match="draining") as info:
            eng.submit(prompts[0], N_NEW)
        assert type(info.value).__name__ == "Overloaded"
        assert eng.metrics()["shed"] == shed
        steps = 0
        while not eng.drained:
            eng.step()
            steps += 1
            assert steps < 500
        seated = [r for r in reqs if r not in harvested]
        assert all(r.state == RequestState.DONE for r in seated)
        met = eng.metrics()
        assert met["draining"] is True
        eng.resume_admission()
        assert not eng.draining
        r = eng.submit(prompts[0], N_NEW)
        eng.run_until_idle()
        np.testing.assert_array_equal(r.output_ids(), refs[0])
        outcomes.append((len(harvested), steps,
                         [r.output_ids().tolist() for r in seated]))
        eng.close()
    _same(outcomes)


def test_checkpoint_fold_preserves_output_ids(served):
    _, _, prompts, refs = served
    outcomes = []
    for src, dst in zip(_engines(served), _engines(served)):
        reqs = [src.submit(p, N_NEW) for p in prompts[:2]]
        steps = 0
        while not any(r.tokens for r in reqs):
            src.step()
            steps += 1
            assert steps < 200
        emitted = {r.id: len(r.tokens) for r in reqs}
        ckpt = src.checkpoint_seated()
        assert src.scheduler.active_slots == 0
        assert src.allocator.used_pages == 0
        for r in ckpt:
            assert r.state == RequestState.SUBMITTED and r.tokens == []
            assert r.rehomed == emitted[r.id]
            assert r.max_new_tokens == N_NEW - emitted[r.id]
        assert src.metrics()["drained"] == len(ckpt)
        for r in ckpt:
            dst.requeue(r)
        dst.run_until_idle()
        for r, ref in zip(reqs, refs):
            assert r.state == RequestState.DONE, (r.state, r.error)
            np.testing.assert_array_equal(r.output_ids(), ref)
        outcomes.append((steps, sorted(emitted.values()), len(ckpt)))
        src.close()
        dst.close()
    _same(outcomes)


def test_requeue_resets_queue_wait_clock(served):
    _, _, prompts, refs = served
    src_p = ServingEngine(served[1], **KW)
    r = src_p.submit(prompts[0], N_NEW)
    r.submit_t -= 3600.0       # a long stay on the source queue
    [h] = src_p.begin_drain()
    assert h is r
    dst = ServingEngine(served[1], max_queue_wait_s=5.0, **KW)
    dst.requeue(h)
    assert time.monotonic() - h.submit_t < 1.0
    dst.run_until_idle()
    assert h.state == RequestState.DONE, (h.state, h.error)
    np.testing.assert_array_equal(h.output_ids(), refs[0])
    src_p.close()
    dst.close()


def test_requeue_refusals_match_jax(served):
    _, _, prompts, _ = served
    msgs = []
    for src, dst in zip(_engines(served), _engines(served)):
        src.submit(prompts[0], N_NEW)
        [h] = src.begin_drain()
        dst.begin_drain()
        with pytest.raises(Exception, match="draining") as a:
            dst.requeue(h)
        dst.resume_admission()
        h.adapter = "tenant-x"
        with pytest.raises(Exception, match="LoRA") as b:
            dst.requeue(h)
        assert type(a.value).__name__ == type(b.value).__name__ \
            == "Overloaded"
        msgs.append((str(a.value).replace(str(h.id), "#"),
                     str(b.value).replace(str(h.id), "#")))
        src.close()
        dst.close()
    _same(msgs)


def test_sampled_checkpoint_carries_the_generator_state(served):
    """A sampling request checkpointed mid-run stores the engine
    generator's state; its continuation on another engine ends with the
    full grant of in-vocabulary tokens, the folded prefix kept.  (The
    reference's threefry stream is not the port's: sampling is checked
    by property.)"""
    _, tm, prompts, _ = served
    src = ServingEngine(tm, seed=5, **KW)
    sp = SamplingParams(do_sample=True, temperature=0.8, top_k=20)
    r = src.submit(prompts[1], 6, sampling=sp)
    while len(r.tokens) < 2:
        src.step()
    state = src._generator.get_state()
    first = list(r.tokens)
    [c] = src.checkpoint_seated()
    assert c is r and isinstance(r.rng_state, torch.Tensor)
    assert torch.equal(r.rng_state, state)
    assert r.rehomed == 2 and list(r.prompt[-2:]) == first
    dst = ServingEngine(tm, seed=9, **KW)
    dst.requeue(r)
    dst.run_until_idle()
    assert r.state == RequestState.DONE
    out = r.output_ids()
    assert len(out) == len(prompts[1]) + 6
    assert list(out[len(prompts[1]):len(prompts[1]) + 2]) == first
    assert all(0 <= t < 1024 for t in out)
    src.close()
    dst.close()


# ---------------------------------------------------------------------------
# cluster drain and replica loss
# ---------------------------------------------------------------------------

def test_cluster_drain_parks_replica(served):
    _, _, prompts, refs = served
    outcomes = []
    for eng in _clusters(served):
        reqs = [eng.submit(p, N_NEW) for p in prompts]
        eng.step()
        eng.begin_drain_replica(0, deadline_s=0.0)
        eng.run_until_idle(max_steps=500)
        assert eng.replica_states()[0] == "parked" and eng.active_dp == 1
        for r, ref in zip(reqs, refs):
            assert r.state == RequestState.DONE, (r.id, r.state, r.error)
            np.testing.assert_array_equal(r.output_ids(), ref)
        for rep in eng.replicas:
            a = rep.allocator
            assert a.free_pages + a.used_pages + a.spec_pages \
                + a.shared_pages == a.capacity
            assert a.used_pages == 0
        before = eng.metrics()["replica_steps"]
        eng.step()
        assert eng.metrics()["replica_steps"] == before + 1
        eng.activate_replica(0)
        assert eng.replica_states()[0] == "active"
        out = eng.generate_batch(prompts[:2], N_NEW)
        for g, ref in zip(out, refs):
            np.testing.assert_array_equal(g, ref)
        met = eng.metrics()
        outcomes.append(([r.rehomed for r in reqs], [r.replica for r in reqs],
                         met["rehomed"], met["replica_steps"],
                         [m["drained"] for m in met["per_replica"]]))
        eng.close()
    _same(outcomes)


def test_replica_kill_rehomes_live_requests(served):
    _, _, prompts, refs = served
    outcomes = []
    for eng in _clusters(served):
        reqs = [eng.submit(p, N_NEW) for p in prompts]
        for _ in range(2):
            eng.step()
        harvested = eng.kill_replica(1)
        assert eng.replica_states()[1] == "dead"
        eng.run_until_idle(max_steps=500)
        for r, ref in zip(reqs, refs):
            assert r.state == RequestState.DONE, (r.id, r.state, r.error)
            np.testing.assert_array_equal(r.output_ids(), ref)
        met = eng.metrics()
        assert met["rehomed"] >= 1 and met["active_dp"] == 1
        outcomes.append((harvested, met["rehomed"],
                         [r.rehomed for r in reqs]))
        eng.close()
    _same(outcomes)


def test_kill_all_replicas_fails_held_requests_typed(served):
    _, _, prompts, _ = served
    for eng in _clusters(served):
        reqs = [eng.submit(p, N_NEW) for p in prompts]
        eng.kill_replica(0)
        eng.kill_replica(1)
        for r in reqs:
            assert r.state == RequestState.FAILED
            assert type(r.error).__name__ == "Overloaded"
        assert len(eng.placement.held) == 0
        eng.close()


def test_replica_kill_via_fault_injection(served):
    _, _, prompts, refs = served
    outcomes = []
    for eng, Inj in zip(_clusters(served), (JaxInjector, FaultInjector)):
        inj = Inj().inject("cluster_step", at=2, kind="replica_kill",
                           slots=[1])
        eng._fault_hook = inj.hook
        reqs = [eng.submit(p, N_NEW) for p in prompts]
        eng.run_until_idle(max_steps=500)
        assert inj.fired("replica_kill") == 1
        assert eng.replica_states()[1] == "dead"
        for r, ref in zip(reqs, refs):
            assert r.state == RequestState.DONE
            np.testing.assert_array_equal(r.output_ids(), ref)
        outcomes.append(([r.rehomed for r in reqs],
                         eng.metrics()["rehomed"]))
        eng.close()
    _same(outcomes)


# ---------------------------------------------------------------------------
# the placement layer's held queue
# ---------------------------------------------------------------------------

def _held(served):
    """One live request parked in a placement held queue: harvested off a
    draining engine, the only survivor's bounded queue full."""
    _, tm, prompts, _ = served
    src = ServingEngine(tm, **KW)
    req = src.submit(prompts[0], N_NEW)
    [h] = src.begin_drain()
    dst = ServingEngine(tm, max_queue_depth=1, **KW)
    blocker = dst.submit(prompts[1], N_NEW)
    ps = PlacementScheduler([dst])
    assert not ps.resubmit(h)
    assert list(ps.held) == [h] and h is req
    return src, dst, ps, h, blocker


def test_cancel_while_held_is_reaped_by_sweep(served):
    src, dst, ps, h, _ = _held(served)
    assert h.cancel()
    assert ps.sweep() == 1
    assert h.state == RequestState.CANCELLED and h._done.is_set()
    assert h.error is not None and len(ps.held) == 0
    src.close()
    dst.close()


def test_deadline_expiry_while_held_is_reaped(served):
    src, dst, ps, h, _ = _held(served)
    h.deadline = time.monotonic() - 1.0
    assert ps.sweep() == 1
    assert h.state == RequestState.TIMED_OUT
    src.close()
    dst.close()


def test_flush_held_seats_when_capacity_frees(served):
    refs = served[3]
    src, dst, ps, h, _ = _held(served)
    dst.run_until_idle()
    assert ps.sweep() == 0
    assert ps.flush_held() == 1 and len(ps.held) == 0
    dst.run_until_idle()
    assert h.state == RequestState.DONE
    np.testing.assert_array_equal(h.output_ids(), refs[0])
    assert ps.rehomed_total == 1 and h.rehomed == 1
    src.close()
    dst.close()


# ---------------------------------------------------------------------------
# placement signals: the port's policies rank as the JAX ones
# ---------------------------------------------------------------------------

def _fake(depth=0, used=0, cap=10, active=0, adapters=None, accept=None,
          match=0):
    e = SimpleNamespace(
        queue=SimpleNamespace(depth=depth, max_depth=None),
        allocator=SimpleNamespace(used_pages=used, capacity=cap),
        scheduler=SimpleNamespace(active_slots=active))
    if adapters is not None:
        e.lora = SimpleNamespace(adapters=lambda: {a: 0 for a in adapters})
    if accept is not None:
        e._spec_totals = {"proposed_tokens": 100,
                          "accepted_tokens": int(accept * 100)}
    if match:
        e.prefix_cache = SimpleNamespace(match_len=lambda p: match)
    return e


SIGNAL_CASES = {
    "residency outranks load": (
        lambda: [_fake(depth=0), _fake(depth=5, adapters=("t1",))], "t1"),
    "no tenant: least loaded": (
        lambda: [_fake(depth=0), _fake(depth=5, adapters=("t1",))], None),
    "acceptance breaks ties": (
        lambda: [_fake(accept=0.2), _fake(accept=0.9)], None),
    "load beats acceptance": (
        lambda: [_fake(accept=0.2), _fake(depth=3, accept=0.9)], None),
    "prefix match first": (
        lambda: [_fake(match=0, accept=0.9),
                 _fake(depth=4, match=16, accept=0.1)], None),
    "residency beats prefix": (
        lambda: [_fake(adapters=("t1",)), _fake(depth=4, match=16)], "t1"),
    "pages then slots": (
        lambda: [_fake(used=5, active=1), _fake(used=2, active=2),
                 _fake(used=2, active=1)], None),
}


@pytest.mark.parametrize("case", sorted(SIGNAL_CASES))
def test_policies_rank_as_jax(case):
    build, adapter = SIGNAL_CASES[case]
    engines = build()
    prompt = np.arange(20)
    for jp, tp in ((JaxLeast(), LeastLoadedPlacement()),
                   (JaxPrefixPolicy(), PrefixLocalityPlacement())):
        assert tp.rank_for(engines, prompt, adapter=adapter) == \
            jp.rank_for(engines, prompt, adapter=adapter)
        assert tp.rank(engines) == jp.rank(engines)
    for e in engines:
        for a in (adapter, "t2", None):
            assert replica_signals(e, a) == jax_signals(e, a)


def test_old_signature_rank_for_policies_still_work(served):
    _, tm, prompts, _ = served

    class OldPolicy:
        def rank(self, engines):
            return list(range(len(engines)))

        def rank_for(self, engines, prompt):
            return list(range(len(engines)))

    eng = ServingEngine(tm, **KW)
    ps = PlacementScheduler([eng], policy=OldPolicy())
    r = ps.submit(prompts[0], N_NEW, adapter=None)
    eng.run_until_idle()
    assert r.state == RequestState.DONE
    assert JaxPlacement([eng], policy=OldPolicy())._order(prompts[0]) \
        == ps._order(prompts[0])
    eng.close()


# ---------------------------------------------------------------------------
# the randomized drain property: speculative + prefix + LoRA traffic
# ---------------------------------------------------------------------------

def test_randomized_drain_property_spec_prefix_lora(served):
    """A drain or a kill (the seed picks) of one replica at a random tick
    under in-flight speculative, prefix-shared and LoRA traffic: the
    4-term ledger holds at every step on every survivor, a drained
    replica ends with both pools empty, and every output is the undrained
    engine's."""
    _, tm, prompts, _ = served
    cfg = tm.config
    rng = np.random.RandomState(13)
    prefix = rng.randint(0, cfg.vocab_size, (16,))
    sprompts = [np.concatenate([prefix, p]) for p in prompts]
    adapters = ["t1" if i % 2 == 0 else None for i in range(len(sprompts))]

    def pool():
        p = LoRAAdapterPool(cfg, num_adapter_pages=2, rank=2,
                            dtype="float32", device="cpu")
        p.register("t1", random_adapter(cfg, 2, np.random.RandomState(7)))
        return p

    kw = dict(num_slots=2, page_size=16, max_context=80,
              cache_dtype="float32")
    ref = ServingEngine(tm, lora=pool(), prefix_cache=True, **kw)
    oreqs = [ref.submit(p, N_NEW, adapter=a)
             for p, a in zip(sprompts, adapters)]
    ref.run_until_idle()
    oracle = [r.output_ids() for r in oreqs]
    ref.close()

    def factory(model, mesh, index, **kw):
        return SpeculativeEngine(model, model, spec_k=2, mesh=mesh,
                                 lora=pool(), prefix_cache=True, **kw)

    eng = ShardedServingEngine(tm, dp=2, mp=1, devices=["cpu"] * 2,
                               engine_factory=factory, **kw)
    reqs = [eng.submit(p, N_NEW, adapter=a)
            for p, a in zip(sprompts, adapters)]
    victim, drain_at = int(rng.randint(2)), int(rng.randint(1, 6))
    kill, deadline = bool(rng.randint(2)), float(rng.choice([0.0, 30.0]))
    steps = 0
    while eng.placement.pending():
        if steps == drain_at:
            if kill:
                eng.kill_replica(victim)
            else:
                eng.begin_drain_replica(victim, deadline_s=deadline)
        eng.step()
        steps += 1
        assert steps < 1000
        for i, rep in enumerate(eng.replicas):
            if i in eng._dead:
                continue
            a = rep.allocator
            assert a.free_pages + a.used_pages + a.spec_pages \
                + a.shared_pages == a.capacity, (i, steps)
    if not kill:
        v = eng.replicas[victim]
        assert eng.replica_states()[victim] == "parked"
        assert v.allocator.used_pages == v.allocator.spec_pages == 0
        assert v.draft.allocator.used_pages == 0
    for r, want in zip(reqs, oracle):
        assert r.state == RequestState.DONE, (r.id, r.state, r.error)
        np.testing.assert_array_equal(r.output_ids(), want)
    eng.close()


def test_speculation_toggle_mid_run_keeps_greedy_parity(served):
    _, tm, prompts, refs = served
    eng = SpeculativeEngine(tm, tm, spec_k=3, **KW)
    reqs = [eng.submit(p, N_NEW) for p in prompts[:3]]
    eng.step()
    eng.speculation_enabled = False
    for _ in range(3):
        eng.step()
    eng.speculation_enabled = True
    eng.run_until_idle()
    for r, ref in zip(reqs, refs):
        assert r.state == RequestState.DONE
        np.testing.assert_array_equal(r.output_ids(), ref)
    assert eng.allocator.used_pages == eng.draft.allocator.used_pages == 0
    eng.close()


def test_speculative_engine_refuses_head_shards(served):
    tm = served[1]
    with pytest.raises(ValueError, match="mp>1 head-sharding"):
        SpeculativeEngine(tm, tm, spec_k=2, mesh=("cpu", "cpu"), **KW)
    with pytest.raises(Overloaded):
        e = ServingEngine(tm, **KW)
        e.begin_drain()
        e.submit([1, 2, 3], 2)
