"""Sharded serving (``dp`` replicas x ``mp`` head shards) of the port held
against the JAX package's ``ShardedServingEngine`` on the CPU
(``tests/test_sharded_serving.py``), at ``gpt_tiny`` (4 heads, head_dim
16) with the JAX model's weights carried across by ``load_jax_state``.
The JAX engines run on the 8-device CPU mesh ``tests/conftest.py`` sets
up; the port's on ``devices=["cpu"] * (dp * mp)`` (co-resident shards).

- Greedy tokens equal the JAX single-chip engine's (the JAX sharded
  parity test's own oracle) and, in fp32, the JAX sharded engine's, token
  for token, at (dp, mp) in {(1, 2), (2, 1), (2, 2)}, for both GPT
  classes, from an fp32 pool and from an int8 pool with int8 weights;
  each request lands on the replica the JAX placement chose; every page
  comes back; the ``metrics()`` key sets (cluster and per replica) are
  the JAX ones.
- The QKV head split: every bias and LayerNorm gain is perturbed and the
  random weights differ head by head, so a shard holding the wrong heads
  gives other logits.  The sharded paged step's logits are the JAX
  unsharded step's within 2e-5 + 1e-5 relative (fp32: the row-parallel
  partials add in another order) and, with int8 weights and pool, the
  port's unsharded step's bit for bit (the int8 products reduce exact
  int32 accumulators).
- Per-shard pools: ``[P, H/mp, page, D]`` on each shard's device, the
  int8 scales ``[P, H/mp]``, each shard ``nbytes / mp``, and
  ``cache_bytes_per_chip`` says so; aggregate capacity grows with dp.
- Placement: least-loaded routing, a shed only when every replica
  backpressures, validation errors raised once, no pool past capacity
  under churn, the placement layer over plain engines, the refusal of an
  indivisible head split in the JAX engine's words.
- Fault schedules: the same random per-replica schedules give the JAX
  cluster's request states and page counts.
- Threads: launch counters and the kernels' workspace cache stay exact
  when two replica threads step at once."""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import GPTForPretraining as JaxLayered
from paddle_tpu.models import GPTStackedForPretraining as JaxStacked
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import LoRAAdapterPool as JaxPool
from paddle_tpu.serving import PlacementScheduler as JaxPlacement
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import ShardedServingEngine as JaxSharded
from paddle_tpu.serving import random_schedule as jax_random_schedule

from paddle_tpu_torch.distributed import serving_mesh as sm
from paddle_tpu_torch.models import GPTForPretraining, \
    GPTStackedForPretraining, gpt_tiny
from paddle_tpu_torch.models import gpt as port_gpt
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import decode_attention as tda
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as tra
from paddle_tpu_torch.serving import sharded as port_sharded
from paddle_tpu_torch.serving import (
    LeastLoadedPlacement, LoRAAdapterPool, PlacementScheduler,
    ServingEngine, ShardedServingEngine, random_adapter, random_schedule,
)

torch.set_num_threads(2)

MESHES = [(1, 2), (2, 1), (2, 2)]
KW = dict(num_slots=2, page_size=16, max_context=64)
CLASSES = {"layered": (JaxLayered, GPTForPretraining),
           "stacked": (JaxStacked, GPTStackedForPretraining)}
# int8: an int8 pool and int8 weights (the JAX and port buffers are equal
# bit for bit); fp32: both fp32
DTYPES = {"float32": dict(cache_dtype="float32"),
          "int8": dict(kv_dtype="int8", weight_dtype="int8")}


def _state(kind, seed=0):
    """The JAX model's state with every bias and LayerNorm gain moved off
    its 0/1 init (the random projections already differ head by head)."""
    pt.seed(seed)
    m = CLASSES[kind][0](jax_gpt_tiny(hidden_dropout=0.0,
                                      attention_dropout=0.0))
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in m.state_dict().items():
        a = np.asarray(v.numpy(), np.float32)
        if k.endswith(("bias", "_b", "_g", "ln1.weight", "ln2.weight",
                       "final_ln.weight")):
            a = a + 0.1 * rng.randn(*a.shape).astype(np.float32)
        out[k] = a
    return out


def _jax(kind, state):
    m = CLASSES[kind][0](jax_gpt_tiny(hidden_dropout=0.0,
                                      attention_dropout=0.0))
    m.set_state_dict(state)
    m.eval()
    return m


def _port(kind, state):
    m = CLASSES[kind][1](gpt_tiny(), device="cpu")
    m.load_jax_state(state)
    m.eval()
    return m


def _workload(n=6, seed=1):
    rng = np.random.RandomState(seed)
    lengths = [3, 17, 5, 26, 14, 4, 19, 7][:n]
    prompts = [rng.randint(0, 1024, (s,)) for s in lengths]
    new = [int(rng.randint(2, 7)) for _ in prompts]
    return prompts, new


_STATES: dict = {}
_ORACLES: dict = {}


def _state_of(kind):
    if kind not in _STATES:
        _STATES[kind] = _state(kind)
    return _STATES[kind]


def _oracle(kind, dtype, dp, mp):
    """The JAX engines' answers, run once per configuration: the
    single-chip engine's output ids (the reference's own oracle for
    sharded parity), and the sharded engine's output ids, replicas and
    metrics keys."""
    key = (kind, dtype, dp, mp)
    if key not in _ORACLES:
        prompts, new = _workload()
        single = (kind, dtype)
        if single not in _ORACLES:
            eng = JaxEngine(_jax(kind, _state_of(kind)), **DTYPES[dtype],
                            **KW)
            reqs = [eng.submit(p, n) for p, n in zip(prompts, new)]
            eng.run_until_idle()
            _ORACLES[single] = [r.output_ids() for r in reqs]
            eng.close()
        eng = JaxSharded(_jax(kind, _state_of(kind)), dp=dp, mp=mp,
                         **DTYPES[dtype], **KW)
        reqs = [eng.submit(p, n) for p, n in zip(prompts, new)]
        eng.run_until_idle(max_steps=2000)
        met = eng.metrics()
        _ORACLES[key] = (_ORACLES[single], [r.output_ids() for r in reqs],
                         [r.replica for r in reqs], set(met),
                         set(met["per_replica"][0]))
        eng.close()
    return _ORACLES[key]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", sorted(CLASSES))
@pytest.mark.parametrize("dp,mp", MESHES)
def test_sharded_greedy_parity(kind, dtype, dp, mp):
    """Tokens equal the JAX single-chip engine's (the oracle of the JAX
    sharded parity test) and, in fp32, the JAX sharded engine's too.  With
    int8 weights the JAX sharded engine itself parts from its single-chip
    engine on one request of this workload (layered, dp=2, at a near-tie
    of two logits), so in int8 only the single-chip tokens are held."""
    single, sharded, replicas, keys, rep_keys = _oracle(kind, dtype, dp, mp)
    prompts, new = _workload()
    eng = ShardedServingEngine(_port(kind, _state_of(kind)), dp=dp, mp=mp,
                               devices=["cpu"] * (dp * mp), **DTYPES[dtype],
                               **KW)
    reqs = [eng.submit(p, n) for p, n in zip(prompts, new)]
    eng.run_until_idle(max_steps=2000)
    for r, w, j in zip(reqs, single, sharded):
        assert r.finished, r.state
        np.testing.assert_array_equal(r.output_ids(), w,
                                      err_msg=f"request {r.id}")
        if dtype == "float32":
            np.testing.assert_array_equal(r.output_ids(), j)
    assert [r.replica for r in reqs] == replicas
    met = eng.metrics()
    assert set(met) == keys
    assert set(met["per_replica"][0]) == rep_keys
    for i, rep in enumerate(eng.replicas):
        assert rep.allocator.used_pages == 0, f"replica {i} leaked"
        assert rep.scheduler.active_slots == 0
        assert rep.cache.mesh_shards == mp
    assert met["mp"] == mp and met["dp"] == dp
    eng.close()


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_qkv_head_split_logits(kind):
    """The sharded paged step against the unsharded one: a chunked prefill
    against the JAX step, then one token a row against the port's
    unsharded step (itself held to JAX in test_torch_gpt_serving.py and
    test_torch_layered_serving.py).  The shard holding heads i*H/mp.. of
    each of q, k and v is the only split that gives these logits.  The
    unsharded step runs on a twin with the same weights (a sharded model
    holds its projections only in its shards)."""
    state = _state_of(kind)
    jm, tm, um = _jax(kind, state), _port(kind, state), _port(kind, state)
    ids = np.random.RandomState(3).randint(0, 1024, (2, 12))
    tables = np.array([[3, 1, 4, 0], [2, 5, 6, 0]], np.int32)
    jc = jm.new_paged_kv_cache(7, 4, dtype="float32")
    uc = um.new_paged_kv_cache(7, 4, dtype="float32")
    sm.shard_model_for_serving(tm, ("cpu", "cpu"))
    tc = tm.new_paged_kv_cache(7, 4, dtype="float32", mesh=("cpu", "cpu"))
    for lo, hi in ((0, 7), (7, 8)):
        pos = np.full((2,), lo, np.int32)
        args = (torch.from_numpy(tables), torch.from_numpy(pos))
        with torch.no_grad():
            got = tm._paged_lm_logits(torch.from_numpy(ids[:, lo:hi]), tc,
                                      *args).numpy()
            ref = um._paged_lm_logits(torch.from_numpy(ids[:, lo:hi]), uc,
                                      *args).numpy()
        if lo == 0:
            ref = np.asarray(jm._paged_lm_logits(
                pt.to_tensor(ids[:, lo:hi], dtype="int64"), jc,
                pt.to_tensor(tables), pt.to_tensor(pos)).numpy())
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)
    # each shard's q, k and v columns are its own heads
    layer = tm._serving_shards[0]
    w = (um.decoder.qkv_w[0] if kind == "stacked"
         else um.gpt.layer_0.attn.qkv_proj.weight)
    cfg = tm.config
    hidden, part = cfg.hidden_size, cfg.hidden_size // 2
    for i, sh in enumerate(layer.shards):
        for j in range(3):
            torch.testing.assert_close(
                sh["qkv_w"][:, j * part:(j + 1) * part],
                w[:, j * hidden + i * part:j * hidden + (i + 1) * part],
                rtol=0, atol=0)


def _tp_bytes(layer):
    return [sum(t.untyped_storage().nbytes() for k, t in sh.items()
                if k in sm.TP_KEYS) for sh in layer.shards]


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_sharded_model_holds_each_weight_once(kind, int8):
    """At mp=2 the shards own the tensor-parallel weights: the model's
    whole QKV/out/fc1/fc2 tensors are dropped to ``meta``, each shard
    holds half of their bytes in storage of its own, and the (co-resident)
    device holds the unsharded model's bytes, not those plus the slices
    (a quantized stacked decoder's unused fp slabs go too).  A forward
    without the sharded pool refuses; ``unshard_model`` gives back the
    same tensors, int8 matrices k-major again, and a clone of the sharded
    model equals the unsharded one."""
    tm = _port(kind, _state_of(kind))
    if int8:
        tm.quantize_weights()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    strides = {k: v.stride() for k, v in tm.state_dict().items()}
    total = sm.weight_bytes_by_device(tm)[torch.device("cpu")]
    dead = 0
    if kind == "stacked" and int8:
        dead = sum(getattr(tm.decoder, n).untyped_storage().nbytes()
                   for n in tm.decoder.QUANTIZED)
    whole = sum(getattr(m, n).untyped_storage().nbytes()
                for own in sm._tp_owners(tm) for m, n in own.values())
    sm.shard_model_for_serving(tm, ("cpu", "cpu"))
    assert all(getattr(m, n).device.type == "meta"
               for own in sm._tp_owners(tm) for m, n in own.values())
    shard_bytes = [_tp_bytes(layer) for layer in tm._serving_shards]
    assert all(b[0] == b[1] for b in shard_bytes)
    assert sum(sum(b) for b in shard_bytes) == whole
    after = sm.weight_bytes_by_device(tm)
    assert list(after) == [torch.device("cpu")]
    assert after[torch.device("cpu")] == total - dead
    # on distinct devices: shard 0's holds the embeddings, the head and
    # half the projections; shard 1's the replicated layer tensors and
    # the other half
    per = sm.shard_weight_bytes(tm)
    assert len(per) == 2 and per[1] < per[0] < total - dead
    assert per[0] + per[1] > total - dead    # replicated tensors twice
    with pytest.raises(ValueError, match="unshard_model"):
        tm(torch.zeros((1, 4), dtype=torch.int64))
    clone = sm.clone_model(tm)
    sm.unshard_model(tm)
    for m in (tm, clone):
        got = m.state_dict()
        for k, v in before.items():
            if got[k].device.type == "meta":
                assert kind == "stacked" and int8 and \
                    k.rsplit(".", 1)[-1] in tm.decoder.QUANTIZED
                continue
            assert torch.equal(got[k], v), k
            assert got[k].stride() == strides[k], k
    ids = torch.from_numpy(np.random.RandomState(5).randint(0, 1024, (2, 6)))
    tables = torch.tensor([[3, 1, 0, 0], [2, 5, 0, 0]], dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    with torch.no_grad():
        a, b = (m._paged_lm_logits(ids, m.new_paged_kv_cache(7, 4), tables,
                                   pos) for m in (tm, clone))
    twin = _port(kind, _state_of(kind))
    if int8:
        twin.quantize_weights()
    with torch.no_grad():
        c = twin._paged_lm_logits(ids, twin.new_paged_kv_cache(7, 4),
                                  tables, pos)
    assert torch.equal(a, c) and torch.equal(b, c)
    assert sm.shard_weight_bytes(tm) == [total - dead]


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_quantizing_a_sharded_model_gathers_it_first(kind):
    """An engine asked for int8 weights over a model already sharded in
    fp32 gathers the whole weights, quantizes them and shards again: the
    tokens of a twin quantized before it was ever sharded."""
    prompts, _ = _workload(4)
    kw = dict(KW, mesh=("cpu", "cpu"), kv_dtype="int8", weight_dtype="int8")
    tm, twin = (_port(kind, _state_of(kind)) for _ in range(2))
    sm.shard_model_for_serving(tm, ("cpu", "cpu"))
    outs = []
    for m in (tm, twin):
        eng = ServingEngine(m, **kw)
        outs.append([o.tolist() for o in eng.generate_batch(prompts, 5)])
        eng.close()
    assert tm.weight_int8 and tm._serving_released
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_int8_sharded_step_is_the_unsharded_bits(kind):
    """int8 weights and pool: the row-parallel products reduce exact int32
    accumulators under the whole row's activation scale, so mp=2 gives
    the unsharded step's logits bit for bit (the unsharded step on a
    twin quantized from the same weights)."""
    um, tm = (_port(kind, _state_of(kind)) for _ in range(2))
    for m in (um, tm):
        m.quantize_weights()
    ids = np.random.RandomState(4).randint(0, 1024, (2, 12))
    tables = torch.tensor([[3, 1, 4, 0], [2, 5, 6, 0]], dtype=torch.int32)
    caches = [um.new_paged_kv_cache(7, 4, dtype="int8")]
    sm.shard_model_for_serving(tm, ("cpu", "cpu"))
    caches.append(tm.new_paged_kv_cache(7, 4, dtype="int8",
                                        mesh=("cpu", "cpu")))
    for lo, hi in ((0, 7), (7, 8)):
        pos = torch.full((2,), lo, dtype=torch.int32)
        with torch.no_grad():
            a, b = (m._paged_lm_logits(torch.from_numpy(ids[:, lo:hi]), c,
                                       tables, pos)
                    for m, c in zip((um, tm), caches))
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_lora_over_head_shards_matches_jax(kind):
    """Per-request LoRA at mp=2 (the JAX engine takes it over its mesh):
    two tenants and the null adapter give the JAX sharded engine's tokens.
    Column-parallel projections add the delta through their B columns;
    row-parallel ones reduce the first contraction across the shards."""
    prompts, new = _workload(4)
    adapters = ["a", "b", None, "a"]
    stacked = kind == "stacked"
    cfg = jax_gpt_tiny()

    def register(pool):
        for name, seed in (("a", 7), ("b", 8)):
            pool.register(name, random_adapter(gpt_tiny(), 3,
                                               np.random.RandomState(seed)))
        return pool

    outs = []
    for Eng, model, Pool, extra in (
            (JaxSharded, _jax(kind, _state_of(kind)), JaxPool, {}),
            (ShardedServingEngine, _port(kind, _state_of(kind)),
             LoRAAdapterPool, {"devices": ["cpu"] * 2})):
        pkw = {} if Pool is JaxPool else {"device": "cpu"}

        def factory(m, mesh, index, **kw):
            pool = register(Pool(cfg, num_adapter_pages=3, rank=3,
                                 dtype="float32", stacked=stacked, **pkw))
            eng_cls = JaxEngine if Pool is JaxPool else ServingEngine
            return eng_cls(m, mesh=mesh, lora=pool, **kw)

        eng = Eng(model, dp=1, mp=2, engine_factory=factory,
                  cache_dtype="float32", **KW, **extra)
        reqs = [eng.submit(p, n, adapter=a)
                for p, n, a in zip(prompts, new, adapters)]
        eng.run_until_idle(max_steps=2000)
        assert all(r.finished for r in reqs)
        assert eng.replicas[0].allocator.used_pages == 0
        outs.append([r.output_ids().tolist() for r in reqs])
        eng.close()
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_per_shard_pools(kind, kv):
    mp = 2
    eng = ShardedServingEngine(_port(kind, _state_of(kind)), dp=1, mp=mp,
                               devices=["cpu"] * mp, cache_dtype=kv, **KW)
    cache = eng.replicas[0].cache
    cfg = eng.replicas[0].model.config
    assert cache.k is None and len(cache.shards) == mp
    for sh in cache.shards:
        assert sh.num_heads == cfg.num_heads // mp
        k = sh.k if kind == "stacked" else sh.k[0]
        assert k.shape[-3] == cfg.num_heads // mp and k.is_contiguous()
        if kv == "int8":
            ks = sh.k_scale if kind == "stacked" else sh.k_scale[0]
            assert ks.shape[-1] == cfg.num_heads // mp
        assert sh.nbytes * mp == cache.nbytes
    met = eng.metrics()
    assert met["cache_bytes_per_chip"] * mp == met["cache_bytes"] \
        == cache.nbytes
    eng.close()


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_shard_paged_cache_splits_a_filled_pool_per_head(kind):
    """``shard_paged_cache`` of a written int8 pool: shard i holds heads
    i*H/mp.. of every page tensor and scale, contiguous, nbytes / mp."""
    m = _port(kind, _state_of(kind))
    c = m.new_paged_kv_cache(5, 4, dtype="int8")
    g = torch.Generator().manual_seed(1)
    for t, _ in c.pool_tensors():
        t.copy_(torch.randint(-127, 128, t.shape, generator=g)
                if t.dtype == torch.int8 else torch.rand(t.shape,
                                                         generator=g))
    whole = [t.clone() for t, _ in c.pool_tensors()]
    nbytes = c.nbytes
    sm.shard_paged_cache(c, ("cpu", "cpu"))
    assert c.mesh_shards == 2 and c.k is None and c.nbytes == nbytes
    hax = 2 if kind == "stacked" else 1
    per_shard = len(whole)
    shards = [sh.pool_tensors() for sh in c.shards]
    for i, tensors in enumerate(shards):
        assert len(tensors) == per_shard and c.shards[i].nbytes * 2 == nbytes
        for (t, _), w in zip(tensors, whole):
            assert t.is_contiguous()
            assert torch.equal(t, w.narrow(hax, 2 * i, 2))
    with pytest.raises(ValueError, match="sharded over 2"):
        c.layer(0) if kind == "layered" else c.layer_scales(0)
    with pytest.raises(ValueError, match="num_heads=4 is not divisible"):
        sm.shard_paged_cache(m.new_paged_kv_cache(5, 4), ("cpu",) * 3)


def test_dp_scaling_is_linear():
    base = None
    for dp in (1, 2):
        eng = ShardedServingEngine(_port("layered", _state_of("layered")),
                                   dp=dp, mp=1, devices=["cpu"] * dp,
                                   cache_dtype="float32", **KW)
        met = eng.metrics()
        if base is None:
            base = met
        else:
            for k in ("slot_capacity", "pages_capacity", "cache_bytes"):
                assert met[k] == 2 * base[k], k
            assert met["cache_bytes_per_chip"] == base["cache_bytes_per_chip"]
            assert eng.replicas[0].model is not eng.replicas[1].model
        eng.close()


def test_indivisible_head_split_refused_in_the_reference_words():
    with pytest.raises(ValueError) as want:
        JaxSharded(JaxLayered(jax_gpt_tiny()), dp=1, mp=3, num_slots=1,
                   page_size=16, max_context=32)
    m = GPTForPretraining(gpt_tiny(), device="cpu")
    with pytest.raises(ValueError) as got:
        ShardedServingEngine(m, dp=1, mp=3, devices=["cpu"] * 3,
                             num_slots=1, page_size=16, max_context=32)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="num_heads=4.*mp=3"):
        ServingEngine(m, mesh=("cpu",) * 3, num_slots=1, page_size=16,
                      max_context=32)


def test_replica_meshes_need_their_devices():
    assert sm.replica_meshes(2, 2, ["cpu"] * 4) == [
        (torch.device("cpu"),) * 2] * 2
    with pytest.raises(ValueError, match="needs 4 devices, found 3"):
        sm.replica_meshes(2, 2, ["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="found 0 visible CUDA"):
            sm.replica_meshes(1, 1)
    with pytest.raises(TypeError, match="sequence of devices"):
        ServingEngine(GPTForPretraining(gpt_tiny(), device="cpu"),
                      mesh="cpu", **KW)


def _cancel_all(eng, reqs):
    """Reap every request before any dispatch (placement is host
    bookkeeping)."""
    for r in reqs:
        r.cancel()
    eng.step()


@pytest.fixture(scope="module")
def layered_state():
    return _state_of("layered")


def _pair(state, **kw):
    """The JAX cluster and the port's over the same weights and knobs."""
    dp = kw.pop("dp", 2)
    return (JaxSharded(_jax("layered", state), dp=dp, mp=1, **kw),
            ShardedServingEngine(_port("layered", state), dp=dp, mp=1,
                                 devices=["cpu"] * dp, **kw))


def test_placement_least_loaded_routing(layered_state):
    for eng in _pair(layered_state, num_slots=1, page_size=16,
                     max_context=64, cache_dtype="float32"):
        rng = np.random.RandomState(3)
        rs = [eng.submit(rng.randint(0, 1024, (5,)), 4) for _ in range(2)]
        assert [r.replica for r in rs] == [0, 1]
        assert eng.placement.routed == [1, 1]
        _cancel_all(eng, rs)
        assert all(rep.allocator.used_pages == 0 for rep in eng.replicas)
        eng.close()


def test_placement_sheds_only_when_all_replicas_backpressure(layered_state):
    for eng in _pair(layered_state, num_slots=1, page_size=16,
                     max_context=64, cache_dtype="float32",
                     max_queue_depth=1):
        rng = np.random.RandomState(4)
        a, b = (eng.submit(rng.randint(0, 1024, (5,)), 4) for _ in range(2))
        # each package's own typed Overloaded
        with pytest.raises(Exception, match="all 2 replicas backpressured"
                           ) as info:
            eng.submit(rng.randint(0, 1024, (5,)), 4)
        assert type(info.value).__name__ == "Overloaded"
        met = eng.metrics()
        assert met["placement_shed"] == 1 and met["shed"] == 1
        rep0 = eng.replicas[0]
        with rep0._lock:
            rep0._admit(time.monotonic())
        c = eng.submit(rng.randint(0, 1024, (5,)), 4)
        assert c.replica == 0
        _cancel_all(eng, [a, b, c])
        assert all(r.terminal for r in (a, b, c))
        eng.close()


def test_placement_validation_error_raised_once(layered_state):
    for eng in _pair(layered_state, num_slots=1, page_size=16,
                     max_context=64, cache_dtype="float32"):
        with pytest.raises(ValueError):
            eng.submit(np.arange(60) % 100, 32)
        assert eng.placement.routed == [0, 0]
        eng.close()


def test_placement_capacity_never_exceeded_under_churn(layered_state):
    outs = []
    for eng in _pair(layered_state, num_slots=2, page_size=16,
                     max_context=64, num_pages=5, cache_dtype="float32"):
        rng = np.random.RandomState(5)
        reqs, left = [], 14
        while left or any(e.queue.depth + e.scheduler.active_slots
                          for e in eng.replicas):
            for _ in range(min(2, left)):
                reqs.append(eng.submit(
                    rng.randint(0, 1024, (int(rng.randint(3, 25)),)),
                    int(rng.randint(2, 6))))
                left -= 1
            eng.step()
            for rep in eng.replicas:
                assert rep.allocator.used_pages <= rep.allocator.capacity
        assert all(r.finished for r in reqs)
        assert all(rep.allocator.used_pages == 0 for rep in eng.replicas)
        outs.append(([r.output_ids().tolist() for r in reqs],
                     [r.replica for r in reqs]))
        eng.close()
    assert outs[0] == outs[1]


def test_placement_over_plain_engines(layered_state):
    routed = []
    for Eng, Sched, m in (
            (JaxEngine, JaxPlacement, _jax("layered", layered_state)),
            (ServingEngine, PlacementScheduler,
             _port("layered", layered_state))):
        engines = [Eng(m, num_slots=1, page_size=16, max_context=64,
                       cache_dtype="float32") for _ in range(2)]
        sched = Sched(engines, policy=None)
        rng = np.random.RandomState(6)
        reqs = [sched.submit(rng.randint(0, 1024, (5,)), 3)
                for _ in range(4)]
        assert sched.pending() == 4
        routed.append(list(sched.routed))
        for r in reqs:
            r.cancel()
        for e in engines:
            e.step()
            assert e.allocator.used_pages == 0
            e.close()
        assert all(r.terminal for r in reqs)
    assert routed[0] == routed[1] == [2, 2]
    assert isinstance(PlacementScheduler([object()]).policy,
                      LeastLoadedPlacement)


def test_page_accounting_under_random_faults_matches_jax(layered_state):
    """The same per-replica fault schedules (re-admission backoff 0, so no
    wall-clock timing enters) give the JAX cluster's request states, token
    counts and page ledgers."""
    outcomes = []
    for eng, sched in zip(_pair(layered_state, num_slots=2, page_size=16,
                                max_context=64, cache_dtype="float32",
                                readmission_backoff_s=0.0),
                          (jax_random_schedule, random_schedule)):
        for i, rep in enumerate(eng.replicas):
            sched(np.random.RandomState(30 + i), horizon=16,
                  num_slots=2).install(rep)
        rng = np.random.RandomState(0)
        reqs = [eng.submit(rng.randint(0, 1024, (int(rng.randint(3, 20)),)),
                           int(rng.randint(2, 6))) for _ in range(10)]
        eng.run_until_idle(max_steps=4000)
        assert all(r.terminal for r in reqs)
        assert all(r.finished or r.error is not None for r in reqs)
        for rep in eng.replicas:
            assert rep.allocator.used_pages == 0
            assert rep.allocator.free_pages == rep.allocator.capacity
        outcomes.append([(r.state, len(r.tokens), r.replica) for r in reqs])
        eng.close()
    assert outcomes[0] == outcomes[1]


# ---------------------------------------------------------------------------
# replica threads: exact launch counts and a safe workspace cache
# ---------------------------------------------------------------------------

def _run_threads(target, n, args=lambda i: ()):
    """``n`` threads (more than the cores) under a short switch interval,
    each joined with a timeout."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=target, args=args(i))
              for i in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)


def test_count_launch_is_exact_under_threads():
    def fn():
        pass
    fn.launches = 0
    n, k = max(8, 2 * (os.cpu_count() or 1)), 5000

    def hammer():
        for _ in range(k):
            _build.count_launch(fn)

    _run_threads(hammer, n)
    assert fn.launches == n * k


def test_two_replica_threads_count_every_launch(monkeypatch, layered_state):
    """Two replicas of two shards stepped by the cluster's pool threads:
    every ragged call is counted as a launch (on the CPU the wrapper runs
    the plain version, so the test counts at the model's call site), and
    the count is exactly fused steps x layers x shards."""
    real = port_gpt.ragged_paged_attention
    seen = set()

    def counted(*a, **kw):
        seen.add(threading.current_thread().name)
        out = real(*a, **kw)
        _build.count_launch(tra.ragged_paged_attention)
        return out

    monkeypatch.setattr(port_gpt, "ragged_paged_attention", counted)
    # co-resident replicas step in order: the rule is patched so that
    # these two step on the pool's threads
    monkeypatch.setattr(port_sharded, "steps_on_threads", lambda m: True)
    tra.ragged_paged_attention.launches = 0
    eng = ShardedServingEngine(_port("layered", layered_state), dp=2, mp=2,
                               devices=["cpu"] * 4, cache_dtype="float32",
                               **KW)
    prompts, new = _workload(8)
    eng.generate_batch(prompts, 6)
    met = eng.metrics()
    layers = eng.replicas[0].model.config.num_layers
    assert tra.ragged_paged_attention.launches == \
        met["fused_steps"] * layers * 2
    assert all(m["fused_steps"] for m in met["per_replica"])
    assert any(n.startswith("sharded-serving-step") for n in seen), seen
    tra.ragged_paged_attention.launches = 0
    eng.close()


def test_replicas_step_on_threads_only_when_their_devices_are_disjoint(
        monkeypatch, layered_state):
    """Co-resident replicas step in order on the caller's thread, replicas
    on disjoint devices on the pool; the outputs are the same either way
    (the disjoint case forced by patching the rule, one CPU)."""
    assert port_sharded.steps_on_threads(
        [(torch.device("cuda", 0),), (torch.device("cuda", 1),)])
    assert not port_sharded.steps_on_threads(
        [(torch.device("cuda", 0),), (torch.device("cuda", 0),)])
    assert not port_sharded.steps_on_threads(
        [(torch.device("cuda", 0), torch.device("cuda", 1)),
         (torch.device("cuda", 1), torch.device("cuda", 2))])
    prompts, new = _workload(4)
    outs = []
    for threads in (False, True):
        if threads:
            monkeypatch.setattr(port_sharded, "steps_on_threads",
                                lambda m: True)
        eng = ShardedServingEngine(_port("layered", layered_state), dp=2,
                                   mp=1, devices=["cpu"] * 2,
                                   cache_dtype="float32", **KW)
        assert (eng._pool is not None) == threads
        outs.append([o.tolist() for o in eng.generate_batch(prompts, 4)])
        eng.close()
    assert outs[0] == outs[1]


def test_workspace_cache_is_safe_under_threads():
    dev = torch.device("cpu")
    stream = 12345
    got, errors = [], []

    def grow(i):
        try:
            for j in range(200):
                n = 1 + (i * 200 + j) % 997
                ws = tda.workspace(dev, stream, {"partials": (n,),
                                                 "tickets": (n // 2 + 1,)})
                assert ws["partials"].numel() >= n
                assert ws["tickets"].numel() >= n // 2 + 1
                got.append(ws["partials"].numel())
        except Exception as e:  # noqa: BLE001 -- surfaced below
            errors.append(e)

    _run_threads(grow, max(6, 2 * (os.cpu_count() or 1)),
                 args=lambda i: (i,))
    assert not errors, errors
    final = tda.workspace(dev, stream, {})
    assert final["partials"].numel() == max(got) == 997
    assert int(final["tickets"].abs().sum()) == 0
    tda._workspaces.pop((None, stream), None)
