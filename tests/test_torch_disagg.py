"""Disaggregated serving of the port (prefill and decode replicas with
page hand-off) held against the JAX package's ``DisaggServingEngine`` on
the CPU (``tests/test_disagg.py``), at ``gpt_tiny`` with the JAX model's
weights carried across by ``load_jax_state``; the port's replicas on
``devices=["cpu"] * n``.

- Greedy tokens: a disaggregated cluster (every decode token after the
  first made on a replica the request was not admitted to) gives the
  colocated cluster's ids and the JAX disaggregated engine's, token for
  token, for both pool layouts in fp32, bf16 and int8 (the int8 pages move
  with their scales), at mp=1 and at mp=2 (the hand-off per shard);
  ``transferred_in`` = ``transferred_out`` = the transfers committed, and
  the transfer counts, pages and bytes are the JAX engine's.
- Ownership: both ledgers hold ``free + used + spec + shared ==
  capacity`` after every tick under the same random transfer-fault and
  step-fault schedules as the JAX engine, with the JAX engine's request
  states, token counts and transfer counts; a ``transfer_error`` and a
  ``transfer_partial`` roll the destination back and the source keeps the
  request.
- The page gather/scatter moves every pool tensor of every shard, scales
  included; role placement ranks decode replicas last, as the JAX policy
  does; construction refusals and the transfer fault points; the
  transfer metrics and role labels reach the exposition."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import GPTForPretraining as JaxLayered
from paddle_tpu.models import GPTStackedForPretraining as JaxStacked
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import DisaggServingEngine as JaxDisagg
from paddle_tpu.serving import FaultInjector as JaxInjector
from paddle_tpu.serving import FaultPlan as JaxPlan
from paddle_tpu.serving import RolePlacement as JaxRolePlacement
from paddle_tpu.serving import random_schedule as jax_random_schedule
from paddle_tpu.serving import \
    random_transfer_schedule as jax_random_transfer_schedule

from paddle_tpu_torch.models import GPTForPretraining, \
    GPTStackedForPretraining, gpt_tiny
from paddle_tpu_torch.serving import (
    ROLE_COLOCATED, ROLE_DECODE, ROLE_PREFILL, DisaggServingEngine,
    FaultInjector, FaultPlan, PagedKVCache, PageTransfer, RolePlacement,
    ShardedServingEngine, random_schedule, random_transfer_schedule,
)
from paddle_tpu_torch.telemetry import metrics as tmetrics

torch.set_num_threads(2)

CLASSES = {"layered": (JaxLayered, GPTForPretraining),
           "stacked": (JaxStacked, GPTStackedForPretraining)}
KW = dict(num_slots=2, page_size=16, max_context=64)
ROLES = (ROLE_PREFILL, ROLE_DECODE)
_STATES: dict = {}


def _state(kind):
    if kind not in _STATES:
        pt.seed(0)
        m = CLASSES[kind][0](jax_gpt_tiny(hidden_dropout=0.0,
                                          attention_dropout=0.0))
        rng = np.random.RandomState(0)
        out = {}
        for k, v in m.state_dict().items():
            a = np.asarray(v.numpy(), np.float32)
            if k.endswith(("bias", "_b", "_g", "ln1.weight", "ln2.weight",
                           "final_ln.weight")):
                a = a + 0.1 * rng.randn(*a.shape).astype(np.float32)
            out[k] = a
        _STATES[kind] = out
    return _STATES[kind]


def _jax(kind):
    m = CLASSES[kind][0](jax_gpt_tiny(hidden_dropout=0.0,
                                      attention_dropout=0.0))
    m.set_state_dict(_state(kind))
    m.eval()
    return m


def _port(kind):
    m = CLASSES[kind][1](gpt_tiny(), device="cpu")
    m.load_jax_state(_state(kind))
    m.eval()
    return m


def _workload(n=4, seed=1):
    rng = np.random.RandomState(seed)
    lengths = [3, 17, 5, 26, 14, 4][:n]
    prompts = [rng.randint(0, 1024, (s,)) for s in lengths]
    new = [int(rng.randint(2, 7)) for _ in prompts]
    return prompts, new


def _ledgers_ok(cluster):
    for i, rep in enumerate(cluster.replicas):
        a = rep.allocator
        assert a.free_pages + a.used_pages + a.spec_pages \
            + a.shared_pages == a.capacity, f"replica {i}"


def _run(eng, prompts, new):
    reqs = [eng.submit(p, n) for p, n in zip(prompts, new)]
    steps = 0
    while eng.placement.pending():
        eng.step()
        _ledgers_ok(eng)
        steps += 1
        assert steps < 2000
    return reqs


def _transfer_counts(met):
    return {k: met[k] for k in ("transfers_total", "transferred_in",
                                "transferred_out", "transfer_pages",
                                "transfer_bytes", "transfers_failed")}


CASES = [("layered", "float32", 1), ("stacked", "bfloat16", 1),
         ("layered", "int8", 1), ("stacked", "int8", 1),
         ("stacked", "float32", 2), ("layered", "int8", 2)]


@pytest.mark.parametrize("kind,dtype,mp", CASES)
def test_disagg_greedy_parity(kind, dtype, mp):
    prompts, new = _workload()
    kw = dict(KW, cache_dtype=dtype)
    col = ShardedServingEngine(_port(kind), dp=2, mp=mp,
                               devices=["cpu"] * (2 * mp), **kw)
    col_out = [r.output_ids() for r in _run(col, prompts, new)]
    col.close()
    jd = JaxDisagg(_jax(kind), roles=ROLES, mp=mp, **kw)
    jreqs = _run(jd, prompts, new)
    jmet = jd.metrics()
    jd.close()
    dis = DisaggServingEngine(_port(kind), roles=ROLES, mp=mp,
                              devices=["cpu"] * (2 * mp), **kw)
    reqs = _run(dis, prompts, new)
    met = dis.metrics()
    assert met["transfers_total"] >= len(prompts) // 2
    assert met["transferred_in"] == met["transferred_out"] \
        == met["transfers_total"]
    assert met["transfer_pages"] > 0 and met["transfer_bytes"] > 0
    assert _transfer_counts(met) == _transfer_counts(jmet)
    assert met["roles"] == list(ROLES)
    for r, c, j in zip(reqs, col_out, jreqs):
        assert r.finished, r.state
        np.testing.assert_array_equal(r.output_ids(), c)
        np.testing.assert_array_equal(r.output_ids(), j.output_ids())
    for rep in dis.replicas:
        assert rep.allocator.used_pages == rep.allocator.spec_pages == 0
        assert rep.cache.mesh_shards == mp
    dis.close()


@pytest.mark.parametrize("seed", [0, 1])
def test_ownership_under_transfer_and_step_faults_matches_jax(seed):
    """The same random transfer-fault schedule on the cluster and step-
    fault schedules on each replica (re-admission backoff 0, so no wall
    clock enters): both ledgers exact after every tick, every request
    typed, and the JAX engine's states, token counts and transfer
    counts."""
    outcomes = []
    for Eng, model, tsched, ssched in (
            (JaxDisagg, _jax("layered"), jax_random_transfer_schedule,
             jax_random_schedule),
            (DisaggServingEngine, _port("layered"), random_transfer_schedule,
             random_schedule)):
        kw = dict(KW, cache_dtype="float32", readmission_backoff_s=0.0)
        if Eng is DisaggServingEngine:
            kw["devices"] = ["cpu"] * 2
        dis = Eng(model, roles=ROLES, mp=1, **kw)
        tsched(np.random.RandomState(100 + seed), horizon=10,
               n_faults=3).install(dis)
        for i, rep in enumerate(dis.replicas):
            ssched(np.random.RandomState(30 + 10 * seed + i), horizon=16,
                   num_slots=2).install(rep)
        rng = np.random.RandomState(seed)
        reqs = [dis.submit(rng.randint(0, 1024, (int(rng.randint(3, 20)),)),
                           int(rng.randint(2, 6))) for _ in range(8)]
        steps = 0
        while dis.placement.pending() and steps < 4000:
            met = dis.step()
            steps += 1
            _ledgers_ok(dis)
            if not met["active_slots"] and not met["tokens_this_step"] \
                    and not dis.placement.pending():
                break
        assert all(r.terminal for r in reqs)
        assert all(r.finished or r.error is not None for r in reqs)
        for rep in dis.replicas:
            assert rep.allocator.used_pages == rep.allocator.spec_pages == 0
        met = dis.metrics()
        outcomes.append(([(r.state, len(r.tokens)) for r in reqs],
                         _transfer_counts(met)))
        dis.close()
    assert outcomes[0] == outcomes[1]


def test_transfer_error_rolls_back_and_source_keeps_the_request():
    prompts, new = _workload(n=2, seed=3)
    kw = dict(KW, cache_dtype="float32")
    clean = DisaggServingEngine(_port("layered"), roles=ROLES,
                                devices=["cpu"] * 2, **kw)
    want = [o.tolist() for o in clean.generate_batch(prompts, new[0])]
    clean.close()
    got, failed = [], []
    for Eng, Inj, Plan, model in (
            (JaxDisagg, JaxInjector, JaxPlan, _jax("layered")),
            (DisaggServingEngine, FaultInjector, FaultPlan,
             _port("layered"))):
        extra = {"devices": ["cpu"] * 2} if Eng is DisaggServingEngine \
            else {}
        dis = Eng(model, roles=ROLES, **kw, **extra)
        Inj([Plan(kind="transfer_error", point="page_transfer", at=0),
             Plan(kind="transfer_partial", point="page_transfer", at=1)]
            ).install(dis)
        got.append([o.tolist() for o in dis.generate_batch(prompts,
                                                            new[0])])
        met = dis.metrics()
        failed.append(met["transfers_failed"])
        _ledgers_ok(dis)
        dis.close()
    assert got[0] == got[1] == want
    assert failed == [2, 2]


@pytest.mark.parametrize("kind", sorted(CLASSES))
@pytest.mark.parametrize("mp", [1, 2])
def test_gather_scatter_moves_every_shard_and_scale(kind, mp):
    """Pages copied between two int8 pools (one sharded per head when
    mp=2): every page tensor and scale of every shard lands, nothing
    else moves."""
    m = _port(kind)
    mesh = ("cpu",) * mp if mp > 1 else None
    src = m.new_paged_kv_cache(6, 4, dtype="int8", mesh=mesh)
    dst = m.new_paged_kv_cache(6, 4, dtype="int8", mesh=mesh)
    g = torch.Generator().manual_seed(0)
    for t, _ in src.pool_tensors() + dst.pool_tensors():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g))
        else:
            t.copy_(torch.rand(t.shape, generator=g))
    before = [t.clone() for t, _ in dst.pool_tensors()]
    PageTransfer.copy_pages(src, dst, [1, 4], [5, 2])
    n = len(src.pool_tensors())
    assert n == (4 if kind == "stacked" else 8) * mp
    for (s, ax), (d, _), b in zip(src.pool_tensors(), dst.pool_tensors(),
                                  before):
        assert torch.equal(d.select(ax, 5), s.select(ax, 1))
        assert torch.equal(d.select(ax, 2), s.select(ax, 4))
        for p in (0, 1, 3, 4):
            assert torch.equal(d.select(ax, p), b.select(ax, p))
    with pytest.raises(ValueError, match="mismatch"):
        PageTransfer.copy_pages(src, dst, [1], [2, 3])
    assert isinstance(src, PagedKVCache)


def test_role_placement_ranks_decode_last():
    class _Fake:
        def __init__(self, role, depth=0):
            self.role = role
            self.queue = type("Q", (), {"depth": depth})()
            self.scheduler = type("S", (), {"active_slots": 0})()
            self.allocator = type("A", (), {"used_pages": 0,
                                            "capacity": 8})()
            self.prefix_cache = None

    engines = [_Fake(ROLE_DECODE), _Fake(ROLE_PREFILL, 2),
               _Fake(ROLE_COLOCATED), _Fake(ROLE_DECODE, 1)]
    order = RolePlacement().rank_for(engines, np.arange(5))
    assert order == JaxRolePlacement().rank_for(engines, np.arange(5))
    assert set(order[:2]) == {1, 2} and set(order[2:]) == {0, 3}


def test_construction_refusals():
    m = _port("layered")
    with pytest.raises(ValueError, match="admit"):
        DisaggServingEngine(m, roles=(ROLE_DECODE, ROLE_DECODE),
                            devices=["cpu"] * 2, **KW)
    with pytest.raises(ValueError, match="unknown replica role"):
        DisaggServingEngine(m, roles=("prefil",), devices=["cpu"], **KW)
    FaultPlan(kind="transfer_error", point="page_transfer", at=0)
    for kind in ("transfer_error", "transfer_partial", "transfer_stall"):
        with pytest.raises(ValueError):
            FaultPlan(kind=kind, point="before_decode", at=0)


def test_transfer_metrics_and_role_labels_reach_exposition():
    prompts, new = _workload(n=2, seed=5)
    dis = DisaggServingEngine(_port("layered"), roles=ROLES,
                              devices=["cpu"] * 2, cache_dtype="float32",
                              **KW)
    dis.generate_batch(prompts, new[0])
    assert [e.role for e in dis.replicas] == list(ROLES)
    text = tmetrics.registry().prometheus_text()
    for name in ("serving_transfer_pages", "serving_transfer_bytes",
                 "serving_transfer_total", "serving_transfer_seconds"):
        assert name in text
    assert 'role="decode"' in text and 'role="prefill"' in text
    dis.close()
