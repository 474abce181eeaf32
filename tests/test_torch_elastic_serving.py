"""The port's elastic serving controller held against the JAX package's on
the CPU (``tests/test_elastic_serving.py``).

The policy is deterministic host code, so the JAX controller and the
port's are driven headless (``cluster=None``) with the same
:class:`ClusterSignals` and a fake clock, and must emit the same typed
actions, reasons included, tick for tick: the hysteresis bands and sustain
timers, scale-up before brownout, the ladder engaged in order and released
LIFO before any scale-down, ``min_dp``, the dead zone, and the anti-flap
property over ``test_anti_flap_property_random_signals``'s seeds (two
scale actions at least ``cooldown_s`` apart, for any signals).  Then the
port alone on a real ``dp=2`` gpt_tiny cluster: the controller's loop
(scale-up on a spike, scale-down when idle), every brownout actuator and
its LIFO restore, the speculation rung reaching
``SpeculativeEngine.speculation_enabled``, the whole ladder sequence
scale-up -> rungs -> LIFO release -> scale-down under a fake clock,
the registry's exposition, and queue-wait shedding that reads only the
monotonic clock."""
import time

import numpy as np
import pytest
import torch

from paddle_tpu.serving import ClusterSignals as JaxSignals
from paddle_tpu.serving import ElasticConfig as JaxConfig
from paddle_tpu.serving import ElasticServingController as JaxController
from paddle_tpu.serving import SLOTargets as JaxTargets

from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny
from paddle_tpu_torch.serving import (
    BROWNOUT_RUNGS, Brownout, ClusterSignals, ElasticConfig,
    ElasticServingController, Recover, RequestState, SLOTargets, ScaleDown,
    ScaleUp, ServingEngine, ShardedServingEngine, SpeculativeEngine,
)
from paddle_tpu_torch.telemetry import metrics as tmetrics

torch.set_num_threads(2)

OVER = dict(ttft=2.0, queue=10.0)
UNDER = dict(ttft=0.01, queue=0.0)
MID = dict(ttft=0.3, queue=2.0)


def _cfg_kw(**kw):
    base = dict(window_s=10.0, min_samples=4, cooldown_s=5.0,
                brownout_cooldown_s=2.0, overload_sustain_s=1.0,
                underload_sustain_s=1.0, min_dp=1)
    base.update(kw)
    return base


def _targets(Targets, **kw):
    base = dict(ttft_p99_s=0.5, queue_high=4.0, queue_low=0.5,
                recover_frac=0.5)
    base.update(kw)
    return Targets(**base)


class _Pair:
    """The JAX controller and the port's, fed the same signals."""

    def __init__(self, **kw):
        self.ctl = [
            C(None, Cfg(targets=_targets(T), **_cfg_kw(**kw)),
              clock=lambda: 0.0)
            for C, Cfg, T in ((JaxController, JaxConfig, JaxTargets),
                              (ElasticServingController, ElasticConfig,
                               SLOTargets))]

    def tick(self, now, *, ttft=0.0, n=100, queue=0.0, active=2, parked=(),
             scalable=(0, 1)):
        out = []
        for S, c in zip((JaxSignals, ClusterSignals), self.ctl):
            acts = c.tick(S(now=now, ttft_p99=ttft, itl_p99=0.0,
                            window_count=n, queue_per_replica=queue,
                            occupancy=0.5, active_dp=active,
                            parked=tuple(parked), scalable=tuple(scalable)))
            out.append([(type(a).__name__, tuple(vars(a).items()))
                        for a in acts])
        assert out[0] == out[1], out
        assert self.ctl[0].brownout_level == self.ctl[1].brownout_level
        return out[1]

    @property
    def port(self):
        return self.ctl[1]

    def close(self):
        for c in self.ctl:
            c.close()


def _kinds(acts):
    return [k for k, _ in acts]


def test_scale_up_prefers_lowest_parked_and_waits_for_cooldown():
    p = _Pair()
    assert _kinds(p.tick(0.0, parked=(2, 3), **OVER)) == ["ScaleUp"]
    assert p.tick(1.0, parked=(3,), **OVER) == []
    assert _kinds(p.tick(5.0, parked=(3,), **OVER)) == ["ScaleUp"]
    p.close()


def test_untrusted_window_does_not_breach():
    p = _Pair()
    assert p.tick(0.0, ttft=99.0, n=1, queue=0.0, parked=(2,)) == []
    p.close()


def test_brownout_engages_only_at_max_dp_after_sustain():
    p = _Pair()
    assert p.tick(0.0, **OVER) == []
    assert p.tick(0.5, **OVER) == []
    acts = p.tick(1.5, **OVER)
    assert _kinds(acts) == ["Brownout"] and p.port.brownout_level == 1
    p.close()


def test_ladder_engages_in_order_and_releases_lifo():
    p = _Pair()
    t = 0.0
    while p.port.brownout_level < len(BROWNOUT_RUNGS):
        p.tick(t, **OVER)
        t += 0.5
    t += 10.0
    while p.port.brownout_level > 0:
        p.tick(t, **UNDER)
        t += 0.5
    acts = p.port.actions
    assert [a.rung for a in acts if isinstance(a, Brownout)] == \
        list(BROWNOUT_RUNGS)
    assert [a.rung for a in acts if isinstance(a, Recover)] == \
        list(reversed(BROWNOUT_RUNGS))
    p.close()


def test_scale_down_only_after_ladder_released():
    p = _Pair()
    for c in p.ctl:
        c.brownout_level = 2
    acts, t = [], 0.0
    for _ in range(20):
        acts += p.tick(t, **UNDER)
        t += 0.5
    assert _kinds(acts)[:3] == ["Recover", "Recover", "ScaleDown"]
    assert [a for a in p.port.actions
            if isinstance(a, ScaleDown)][0].replica == 1
    p.close()


def test_scale_down_respects_min_dp():
    p = _Pair(min_dp=1)
    acts = []
    for t in range(20):
        acts += p.tick(float(t), active=1, scalable=(0,), **UNDER)
    assert acts == []
    p.close()


def test_dead_zone_resets_sustain_and_holds_still():
    p = _Pair()
    p.tick(0.0, **OVER)
    assert p.port._overload_since == 0.0
    p.tick(0.5, **MID)
    assert p.port._overload_since is None
    assert p.tick(1.0, **OVER) == []
    q = _Pair()
    for c in q.ctl:
        c.brownout_level = 1
    for t in range(30):
        assert q.tick(float(t), parked=(2,), **MID) == []
    p.close()
    q.close()


@pytest.mark.parametrize("seed", range(8))
def test_anti_flap_property_random_signals(seed):
    """The JAX test's seeds: the same random signal sequence gives the
    same actions from both controllers, and consecutive scale actions are
    at least ``cooldown_s`` apart."""
    rng = np.random.RandomState(seed)
    p = _Pair(cooldown_s=3.0)
    t, scale_times = 0.0, []
    for _ in range(400):
        t += float(rng.uniform(0.05, 0.5))
        band = rng.randint(3)
        kw = OVER if band == 0 else UNDER if band == 1 else MID
        parked = (2,) if rng.rand() < 0.5 else ()
        for kind, _ in p.tick(t, parked=parked, **kw):
            if kind in ("ScaleUp", "ScaleDown"):
                scale_times.append(t)
    for a, b in zip(scale_times, scale_times[1:]):
        assert b - a >= 3.0 - 1e-9
    p.close()


def test_adversarial_oscillation_cannot_flap():
    p = _Pair(cooldown_s=5.0, underload_sustain_s=0.0)
    t, scale_times = 0.0, []
    for i in range(600):
        t += 0.1
        for kind, _ in p.tick(t, parked=(2,), **(OVER if i % 2 == 0
                                                  else UNDER)):
            if kind in ("ScaleUp", "ScaleDown"):
                scale_times.append(t)
    assert scale_times
    for a, b in zip(scale_times, scale_times[1:]):
        assert b - a >= 5.0 - 1e-9
    p.close()


def test_policy_immune_to_wall_clock_jumps(monkeypatch):
    def run(patch):
        ctl = ElasticServingController(
            None, ElasticConfig(targets=_targets(SLOTargets), **_cfg_kw()),
            clock=lambda: 0.0)
        jump = [0.0]
        if patch:
            monkeypatch.setattr(time, "time", lambda: 1e9 + jump[0])
        out, t = [], 0.0
        for i in range(60):
            t += 0.5
            jump[0] = -1e6 if i % 3 else 1e6
            kw = OVER if i < 30 else UNDER
            out += [type(a).__name__ for a in ctl.tick(ClusterSignals(
                now=t, ttft_p99=kw["ttft"], itl_p99=0.0, window_count=100,
                queue_per_replica=kw["queue"], occupancy=0.5, active_dp=2,
                parked=(2,) if i < 30 else (), scalable=(0, 1, 2)))]
        ctl.close()
        return out
    assert run(False) == run(True)


def test_itl_signal_and_config_validation():
    p = _Pair(signal="itl")
    acts = p.tick(0.0, ttft=9.0, queue=0.0, parked=(2,))
    assert acts == []
    p.close()
    with pytest.raises(ValueError, match="signal"):
        ElasticConfig(signal="tpot")


def test_controller_exposition():
    ctl = ElasticServingController(
        None, ElasticConfig(targets=_targets(SLOTargets), **_cfg_kw()),
        clock=lambda: 0.0)

    def sig(now, parked):
        return ClusterSignals(now=now, ttft_p99=2.0, itl_p99=0.0,
                              window_count=100, queue_per_replica=10.0,
                              occupancy=0.5, active_dp=2,
                              parked=parked, scalable=(0, 1))

    ctl.tick(sig(0.0, (2,)))
    for t in (6.0, 7.5):
        ctl.tick(sig(t, ()))
    text = tmetrics.registry().prometheus_text()
    assert 'action="scale_up"' in text and 'action="brownout"' in text
    lvl = tmetrics.registry().get("serving_brownout_level")
    assert lvl.value(**ctl._label) == ctl.brownout_level > 0
    ctl.close()
    text = tmetrics.registry().prometheus_text()
    assert f'controller="{ctl._label["controller"]}"' not in text


# ---------------------------------------------------------------------------
# the port on a real cluster
# ---------------------------------------------------------------------------

KW = dict(num_slots=2, page_size=16, max_context=64, cache_dtype="float32")


@pytest.fixture(scope="module")
def model():
    return GPTForPretraining(gpt_tiny(), device="cpu", seed=2).eval()


def test_closed_loop_scale_up_then_down(model):
    rng = np.random.RandomState(2)
    eng = ShardedServingEngine(model, dp=2, mp=1, devices=["cpu"] * 2,
                               max_queue_depth=64, **KW)
    t = [0.0]
    ctl = ElasticServingController(eng, ElasticConfig(
        targets=SLOTargets(ttft_p99_s=0.2, queue_high=2.0, queue_low=0.5),
        **_cfg_kw(cooldown_s=3.0, drain_deadline_s=0.0)),
        clock=lambda: t[0])
    eng.drain_replica(1)
    assert eng.replica_states() == ["active", "parked"]
    reqs = [eng.submit(rng.randint(0, 1024, (int(rng.randint(3, 18)),)), 4)
            for _ in range(20)]
    for _ in range(80):
        t[0] += 0.5
        ctl.tick()
        eng.step()
        if not eng.placement.pending():
            break
    assert any(isinstance(a, ScaleUp) for a in ctl.actions)
    assert all(r.state == RequestState.DONE for r in reqs)
    for _ in range(30):
        t[0] += 0.5
        ctl.tick()
        eng.step()
    assert any(isinstance(a, ScaleDown) for a in ctl.actions)
    assert eng.active_dp == 1
    ctl.close()
    eng.close()


def test_brownout_actuators_engage_and_restore_lifo(model):
    """Each rung's actuator against a cluster of speculative replicas: the
    max_new clamp, ``speculation_enabled`` off on every replica, the
    prefill budget shrink, the shed refusal; then the LIFO release
    restores every knob."""
    def factory(m, mesh, index, **kw):
        return SpeculativeEngine(m, m, spec_k=2, mesh=mesh, **kw)

    eng = ShardedServingEngine(model, dp=2, mp=1, devices=["cpu"] * 2,
                               engine_factory=factory, **KW)
    ctl = ElasticServingController(eng, ElasticConfig(
        targets=_targets(SLOTargets), **_cfg_kw(), brownout_max_new=2))
    budgets = [e.prefill_token_budget for e in eng.replicas]

    def sig(now, kw):
        return ClusterSignals(now=now, ttft_p99=kw["ttft"], itl_p99=0.0,
                              window_count=100,
                              queue_per_replica=kw["queue"], occupancy=0.5,
                              active_dp=2, parked=(), scalable=(0, 1))

    t, seen = 0.0, []
    while ctl.brownout_level < len(BROWNOUT_RUNGS):
        ctl.tick(sig(t, OVER))
        seen.append((ctl.brownout_level, eng.max_new_cap,
                     [e.speculation_enabled for e in eng.replicas]))
        t += 0.5
    assert eng.max_new_cap == 2 and eng.shedding
    assert not any(e.speculation_enabled for e in eng.replicas)
    assert all(e.prefill_token_budget < b
               for e, b in zip(eng.replicas, budgets))
    with pytest.raises(Exception, match="browned out"):
        eng.submit(np.arange(5), 4)
    assert eng.metrics()["brownout_shed"] == 1
    t += 10.0
    while ctl.brownout_level > 0:
        ctl.tick(sig(t, UNDER))
        t += 0.5
    assert eng.max_new_cap is None and not eng.shedding
    assert all(e.speculation_enabled for e in eng.replicas)
    assert [e.prefill_token_budget for e in eng.replicas] == budgets
    r = eng.submit(np.arange(5), 4)
    eng.run_until_idle()
    assert r.state == RequestState.DONE
    ctl.close()
    eng.close()


def test_ladder_sequence_on_a_cluster(model):
    """Scale-up, then the brownout rungs at max dp, the LIFO release, then
    the scale-down, actuated on a real cluster under a fake clock."""
    eng = ShardedServingEngine(model, dp=2, mp=1, devices=["cpu"] * 2, **KW)
    eng.drain_replica(1)
    ctl = ElasticServingController(eng, ElasticConfig(
        targets=_targets(SLOTargets), **_cfg_kw(drain_deadline_s=0.0)))

    def sig(now, kw):
        parked = tuple(sorted(eng._parked))
        stepping = [i for i in range(2) if eng._stepping(i)]
        return ClusterSignals(
            now=now, ttft_p99=kw["ttft"], itl_p99=0.0, window_count=100,
            queue_per_replica=kw["queue"], occupancy=0.5,
            active_dp=len(stepping), parked=parked,
            scalable=tuple(i for i in stepping
                           if not eng.replicas[i].draining))

    t = 0.0
    for _ in range(30):
        ctl.tick(sig(t, OVER))
        eng.step()
        t += 0.5
    for _ in range(40):
        ctl.tick(sig(t, UNDER))
        eng.step()
        t += 0.5
    kinds = [type(a).__name__ for a in ctl.actions]
    first_down = kinds.index("ScaleDown")
    assert kinds[0] == "ScaleUp"
    assert kinds[1:5] == ["Brownout"] * 4
    assert kinds[5:9] == ["Recover"] * 4 and first_down == 9
    assert eng.replica_states()[1] == "parked"
    assert eng.max_new_cap is None and not eng.shedding
    ctl.close()
    eng.close()


def test_queue_wait_shedding_reads_the_monotonic_clock(monkeypatch, model):
    eng = ServingEngine(model, max_queue_wait_s=30.0, **KW)
    monkeypatch.setattr(time, "time", lambda: 1e9)
    reqs = [eng.submit(np.arange(5), 3), eng.submit(np.arange(7), 3)]
    eng.run_until_idle()
    assert all(r.state == RequestState.DONE for r in reqs)
    assert eng.metrics()["shed"] == 0
    eng.close()
