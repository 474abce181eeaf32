"""The port's multi-tenant LoRA held against the JAX package on the CPU
(``tests/test_lora.py``): ``LoRAAdapterPool``, ``ops/lora.py`` and
``ServingEngine(lora=...)`` over ``gpt_tiny`` carried across from the JAX
stacked GPT by ``load_jax_state``.

- the gathered low-rank product against the JAX ``lora_delta_raw``: fp32
  slabs within 1e-6 (the same fp32 sums in another order); bf16 slabs
  within 2^-7 of the result's magnitude (the reference rounds ``u`` to
  bf16 between the two products, and a sum in another order can move ``u``
  across a bf16 rounding point: one bf16 ulp of ``u``, 2^-8 relative, then
  summed over r terms);
- one fused step with adapters: logits within 1e-5 of the JAX step's
  (fp32, the tolerance of ``tests/test_torch_gpt_serving.py``);
- whole engines, fp32, token for token: the port's LoRA engine against
  the JAX LoRA engine and against the port serving ``merged_state_dict``
  weights without LoRA; the null adapter is the base model; mixed tenants
  in one batch; speculation over LoRA;
- lifecycle: the pool's ledger, typed errors (``AdapterInUse``,
  ``UnknownAdapter``), and register/evict churn writing the same slab
  tensors in place (the step never changes)."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import GPTStackedForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.ops.lora import lora_delta_raw as jax_lora_delta_raw
from paddle_tpu.ops.pallas_kernels import ragged_paged_attention as jra
from paddle_tpu.serving import LoRAAdapterPool as JaxPool
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.tensor import to_tensor

from paddle_tpu_torch.models import GPTStackedForPretraining, gpt_tiny
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as tra
from paddle_tpu_torch.ops.lora import lora_delta_raw
from paddle_tpu_torch.serving import (
    AdapterError, AdapterInUse, LoRAAdapterPool, RequestState,
    ServingEngine, SpeculativeEngine, UnknownAdapter, random_adapter,
)

torch.set_num_threads(2)

ENG_KW = dict(num_slots=3, page_size=16, max_context=64,
              cache_dtype="float32")


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


def _pools(cfg, names_seeds, rank=3, pages=3, dtype="float32"):
    """The same adapters registered in a JAX and a port pool."""
    jp = JaxPool(cfg, num_adapter_pages=pages, rank=rank, dtype=dtype,
                 stacked=True)
    tp = LoRAAdapterPool(cfg, num_adapter_pages=pages, rank=rank,
                         dtype=dtype, device="cpu")
    for name, seed in names_seeds:
        w = random_adapter(cfg, rank, np.random.RandomState(seed))
        assert jp.register(name, w) == tp.register(name, w)
    return jp, tp


def _merged(tm, pool, name):
    m = GPTStackedForPretraining(tm.config, device="cpu")
    m.load_state_dict(pool.merged_state_dict(tm, name))
    return m


def _prompts(lengths=(5, 11, 8), seed=2):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, (s,)) for s in lengths]


# ---------------------------------------------------------------------------
# the gathered product and the slabs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_dtype,slab_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("float32", "bfloat16")])
def test_lora_delta_matches_jax(x_dtype, slab_dtype):
    rng = np.random.RandomState(0)
    T, S, din, dout, r, P = 7, 3, 24, 40, 4, 5
    x = rng.randn(T, S, din).astype(np.float32)
    a = (rng.randn(P, din, r) * 0.3).astype(np.float32)
    b = (rng.randn(P, r, dout) * 0.3).astype(np.float32)
    a[0] = 0
    b[0] = 0                                   # the null adapter
    ids = np.array([0, 3, 1, 1, 4, 0, 2], np.int32)
    jx, ja, jb = (to_tensor(v).astype(d) for v, d in
                  ((x, x_dtype), (a, slab_dtype), (b, slab_dtype)))
    want = np.asarray(jax_lora_delta_raw(
        jx._value, ja._value, jb._value, to_tensor(ids)._value,
        2.0).astype("float32"))
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    tx, ta, tb = (torch.from_numpy(v).to(tdt[d]) for v, d in
                  ((x, x_dtype), (a, slab_dtype), (b, slab_dtype)))
    got = lora_delta_raw(tx, ta, tb, torch.from_numpy(ids), 2.0)
    assert got.dtype == tdt[x_dtype] and got.shape == (T, S, dout)
    got = got.float().numpy()
    assert (got[[0, 5]] == 0).all()            # null-adapter rows
    mag = np.abs(want).max()
    tol = 1e-6 if slab_dtype == "float32" and x_dtype == "float32" \
        else 2.0 ** -7
    assert np.abs(got - want).max() <= tol * mag, np.abs(got - want).max()
    # one position a row (the fused step's per-token rows), within the
    # same bound: a product with fewer rows may sum in another order
    one = lora_delta_raw(tx[:, :1], ta, tb, torch.from_numpy(ids), 2.0)
    assert np.abs(one.float().numpy() - want[:, :1]).max() <= tol * mag


def test_slabs_match_jax_after_register():
    cfg = gpt_tiny()
    jp, tp = _pools(cfg, [("a", 1), ("b", 2)])
    for j, t in zip(jp.stacked_slabs(), tp.stacked_slabs()):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))
    assert tp.nbytes == jp.nbytes
    assert tp.adapters() == jp.adapters()


def test_pool_ledger_and_typed_errors():
    cfg = gpt_tiny()
    pool = LoRAAdapterPool(cfg, num_adapter_pages=2, rank=2, device="cpu")
    p1 = pool.register("a", random_adapter(cfg, 2, np.random.RandomState(0)))
    p2 = pool.register("b", random_adapter(cfg, 2, np.random.RandomState(1)))
    assert p1 != p2 and 0 not in (p1, p2)
    assert pool.allocator.used_pages == 2
    with pytest.raises(AdapterError, match="full"):
        pool.register("c", random_adapter(cfg, 2, np.random.RandomState(2)))
    with pytest.raises(AdapterError, match="already"):
        pool.register("a", random_adapter(cfg, 2, np.random.RandomState(0)))
    pool.evict("a")
    with pytest.raises(UnknownAdapter):
        pool.evict("a")
    with pytest.raises(AdapterError, match="shapes"):   # wrong rank, no leak
        pool.register("d", random_adapter(cfg, 3, np.random.RandomState(0)))
    assert pool.allocator.used_pages == 1
    pool.evict("b")
    assert pool.allocator.free_pages == pool.allocator.capacity
    with pytest.raises(NotImplementedError, match="item 3"):
        LoRAAdapterPool(cfg, stacked=False, device="cpu")


# ---------------------------------------------------------------------------
# one fused step, whole engines
# ---------------------------------------------------------------------------

def test_fused_step_with_adapters_matches_jax(models):
    """A 10-token prefill chunk on adapter 2 and a decode on adapter 1,
    padding rows on the null adapter, over a pre-filled pool."""
    jm, tm = models
    cfg = tm.config
    jp, tp = _pools(cfg, [("t1", 7), ("t2", 8)])
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
    adapters = np.zeros((t_max,), np.int32)
    for (base, count, tbl), start, page in zip(runs, stats["run_starts"],
                                               (2, 1)):
        ids[start:start + count, 0] = rng.randint(0, cfg.vocab_size, count)
        tables[start:start + count] = tbl
        positions[start:start + count] = base + np.arange(count)
        adapters[start:start + count] = page
    out_rows = np.array([9, 10], np.int32)
    shape = (cfg.num_layers, num_pages, cfg.num_heads, 16, cfg.head_dim)
    k0, v0 = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    jc = jm.new_paged_kv_cache(num_pages, 16, dtype="float32")
    jc.k._set_value(to_tensor(k0)._value)
    jc.v._set_value(to_tensor(v0)._value)
    jlog = jm._paged_lm_logits(
        to_tensor(ids), jc, to_tensor(tables), to_tensor(positions),
        ragged_plan=tuple(to_tensor(plan[k]) for k in jra.RAGGED_PLAN_FIELDS),
        out_rows=to_tensor(out_rows),
        lora=(jp, to_tensor(adapters))).numpy()
    tc = tm.new_paged_kv_cache(num_pages, 16, dtype="float32")
    tc.k.copy_(torch.from_numpy(k0))
    tc.v.copy_(torch.from_numpy(v0))
    with torch.no_grad():
        args = (torch.from_numpy(ids), tc, torch.from_numpy(tables),
                torch.from_numpy(positions))
        kw = dict(ragged_plan=tuple(torch.from_numpy(plan[k])
                                    for k in tra.RAGGED_PLAN_FIELDS),
                  out_rows=torch.from_numpy(out_rows))
        tlog = tm._paged_lm_logits(
            *args, lora=(tp, torch.from_numpy(adapters)), **kw).numpy()
        base = tm._paged_lm_logits(*args, **kw).numpy()
    np.testing.assert_allclose(tlog, jlog, rtol=1e-5, atol=1e-5)
    assert np.abs(tlog - base).max() > 1e-3, "the adapters did nothing"
    with pytest.raises(ValueError, match="paged"):
        tm(torch.from_numpy(ids[:, 0][None]), lora=(tp, torch.zeros(1)))


def test_engine_tokens_match_jax_and_merged_weights(models):
    jm, tm = models
    jp, tp = _pools(tm.config, [("t1", 7)])
    prompts = _prompts()
    want = JaxEngine(jm, lora=jp, **ENG_KW).generate_batch(
        prompts, 6, adapter="t1")
    merged = ServingEngine(_merged(tm, tp, "t1"), **ENG_KW).generate_batch(
        prompts, 6)
    eng = ServingEngine(tm, lora=tp, **ENG_KW)
    got = eng.generate_batch(prompts, 6, adapter="t1")
    for g, w, m in zip(got, want, merged):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, m)
    assert tp.refcount("t1") == 0               # released at retirement
    met = eng.metrics()
    assert met["lora_adapters"] == 1 and met["lora_pages_used"] == 1
    assert met["lora_slab_bytes"] == tp.nbytes


def test_null_adapter_is_the_base_model(models):
    _, tm = models
    _, tp = _pools(tm.config, [("t1", 1)])
    prompts = _prompts()
    want = ServingEngine(tm, **ENG_KW).generate_batch(prompts, 5)
    got = ServingEngine(tm, lora=tp, **ENG_KW).generate_batch(prompts, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_mixed_tenants_one_batch(models):
    jm, tm = models
    jp, tp = _pools(tm.config, [("t1", 4), ("t2", 5)])
    prompts = _prompts()
    tenants = ("t1", "t2", None)
    je = JaxEngine(jm, lora=jp, **ENG_KW)
    jreqs = [je.submit(p, 5, adapter=a) for p, a in zip(prompts, tenants)]
    je.run_until_idle()
    eng = ServingEngine(tm, lora=tp, **ENG_KW)
    reqs = [eng.submit(p, 5, adapter=a) for p, a in zip(prompts, tenants)]
    eng.run_until_idle()
    for r, jr, p, a in zip(reqs, jreqs, prompts, tenants):
        assert r.finished
        np.testing.assert_array_equal(r.output_ids(), jr.output_ids())
        oracle = _merged(tm, tp, a) if a else tm
        want = ServingEngine(oracle, **ENG_KW).generate_batch([p], 5)[0]
        np.testing.assert_array_equal(r.output_ids(), want)


def test_evict_while_seated_and_evicted_while_queued(models):
    _, tm = models
    _, tp = _pools(tm.config, [("t1", 0), ("t2", 1)])
    eng = ServingEngine(tm, lora=tp, **ENG_KW)
    r = eng.submit(_prompts()[0], 8, adapter="t1")
    eng.step()                                  # seats + pins
    assert tp.refcount("t1") == 1
    with pytest.raises(AdapterInUse):
        tp.evict("t1")
    q = eng.submit(_prompts()[1], 4, adapter="t2")
    tp.evict("t2")                              # queued, not pinned yet
    eng.run_until_idle(max_steps=50)
    assert r.finished
    assert q.state == RequestState.FAILED
    assert isinstance(q.error, UnknownAdapter)
    tp.evict("t1")                              # drained: now legal
    assert eng.allocator.used_pages == 0
    bare = ServingEngine(tm, **ENG_KW)
    with pytest.raises(ValueError, match="no LoRA pool"):
        bare.submit(_prompts()[0], 4, adapter="t1")


def test_register_evict_churn_writes_the_slabs_in_place(models):
    """Three tenants through a 2-page pool, one engine: every generation
    matches its merged-weight oracle, and the slabs the step reads are the
    same tensors throughout (registration writes them in place)."""
    _, tm = models
    cfg = tm.config
    prompts = _prompts(lengths=(6, 9))
    weights = [random_adapter(cfg, 2, np.random.RandomState(i))
               for i in range(3)]
    scratch = LoRAAdapterPool(cfg, num_adapter_pages=3, rank=2,
                              device="cpu")
    wants = []
    for i, w in enumerate(weights):
        scratch.register(f"gen{i}", w)
        wants.append(ServingEngine(_merged(tm, scratch, f"gen{i}"),
                                   **ENG_KW).generate_batch(prompts, 4))
    pool = LoRAAdapterPool(cfg, num_adapter_pages=2, rank=2, device="cpu")
    ptrs = [t.data_ptr() for t in pool.stacked_slabs()]
    eng = ServingEngine(tm, lora=pool, **ENG_KW)
    for i, w in enumerate(weights):
        pool.register(f"gen{i}", w)
        outs = eng.generate_batch(prompts, 4, adapter=f"gen{i}")
        for g, want in zip(outs, wants[i]):
            np.testing.assert_array_equal(g, want)
        pool.evict(f"gen{i}")
    assert [t.data_ptr() for t in pool.stacked_slabs()] == ptrs
    assert pool.allocator.free_pages == pool.allocator.capacity


def test_speculation_over_lora(models):
    """The verify step applies the tenant's adapter, the draft proposes
    adapter-less: the tokens are the merged-weight oracle's."""
    _, tm = models
    _, tp = _pools(tm.config, [("t1", 9)])
    prompts = _prompts()
    want = ServingEngine(_merged(tm, tp, "t1"), **ENG_KW).generate_batch(
        prompts, 5)
    eng = SpeculativeEngine(tm, tm, spec_k=3, lora=tp, **ENG_KW)
    got = eng.generate_batch(prompts, 5, adapter="t1")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    m = eng.metrics()
    assert m["lora_adapters"] == 1 and m["spec_proposed_tokens"] > 0
    assert eng.draft.allocator.spec_pages == 0


def test_prefix_cache_bypasses_lora_requests(models):
    """LoRA'd K/V depends on the adapter: such requests neither hit nor
    register, and adapter-less ones still share."""
    _, tm = models
    _, tp = _pools(tm.config, [("t1", 3)])
    rng = np.random.RandomState(1)
    shared = rng.randint(0, 1024, (32,))
    prompts = [np.concatenate([shared, rng.randint(0, 1024, (4,))])
               for _ in range(3)]
    eng = ServingEngine(tm, lora=tp, prefix_cache=True, **ENG_KW)
    for p, a in zip(prompts, ("t1", None, "t1")):
        eng.generate_batch([p], 3, adapter=a)
    m = eng.metrics()
    assert m["prefix_misses"] == 1 and m["prefix_hits"] == 0
    eng.generate_batch([prompts[0]], 3)
    assert eng.metrics()["prefix_hits"] == 1
