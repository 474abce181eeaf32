"""The layered GPT (``GPTForPretraining``) served by the port's engine,
held against the JAX package's layered engine on the CPU
(``tests/test_serving.py``, ``test_quantized_serving.py``,
``test_prefix_cache.py``, ``test_serving_faults.py`` and
``test_lora.py``'s layered cases), at ``gpt_tiny`` with the JAX model's
weights carried across by ``load_jax_state``.

- The engine gives the JAX engine's greedy tokens from fp32 and bf16
  pools, and from an int8 pool with ``weight_dtype="int8"`` (whose
  ``Int8Linear`` buffers equal the JAX ones bit for bit).
- The paged step without a plan (a chunked prefill, then one token a
  row) gives the JAX logits: fp32 within 2e-5 + 1e-5 relative; an int8
  pool within 1e-4 (a value on a rounding tie of the K/V quantizer may
  take the other integer).
- The per-layer caches (``stacked=False``, the reference's default) hold
  one pair a layer, their scales for an int8 pool, count and release
  them; the stacked layout refuses ``layer()``.
- Layered LoRA (``LoRAAdapterPool()``, page axis first) gives the JAX
  engine's tokens over a JAX ``stacked=False`` pool, and each adapter
  the tokens of its merged weights.
- The prefix cache gives the JAX engine's tokens and counts; a
  non-intact step crash rebuilds the per-layer pool with the JAX
  engine's outcome."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import FaultInjector as JaxInjector
from paddle_tpu.serving import LoRAAdapterPool as JaxPool
from paddle_tpu.serving import ServingEngine as JaxEngine

from paddle_tpu_torch.models import (
    GPTForPretraining, GPTStackedForPretraining, KVCache, gpt_tiny,
)
from paddle_tpu_torch.serving import (
    FaultInjector, LoRAAdapterPool, PagedKVCache, ServingEngine,
    random_adapter,
)

torch.set_num_threads(2)

ENG_KW = dict(num_slots=3, page_size=16, max_context=64)
N_NEW = 6


def _state(seed=0):
    pt.seed(seed)
    m = JaxGPT(jax_gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0))
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in m.state_dict().items():
        a = np.asarray(v.numpy(), np.float32)
        if k.endswith(("bias", "ln1.weight", "ln2.weight", "final_ln.weight")):
            a = a + 0.1 * rng.randn(*a.shape).astype(np.float32)
        out[k] = a
    return out


def _jax(state):
    m = JaxGPT(jax_gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0))
    m.set_state_dict(state)
    m.eval()
    return m


def _port(state):
    m = GPTForPretraining(gpt_tiny(), device="cpu")
    m.load_jax_state(state)
    m.eval()
    return m


@pytest.fixture(scope="module")
def state():
    return _state(0)


def _prompts(lengths=(5, 18, 9, 26, 13), seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, (s,)) for s in lengths]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_engine_tokens_match_jax(state, cache_dtype):
    prompts = _prompts()
    want = JaxEngine(_jax(state), cache_dtype=cache_dtype,
                     **ENG_KW).generate_batch(prompts, N_NEW)
    eng = ServingEngine(_port(state), cache_dtype=cache_dtype, **ENG_KW)
    assert not eng.cache.stacked and len(eng.cache.k) == 2
    _same(eng.generate_batch(prompts, N_NEW), want)
    assert eng.metrics()["pages_used"] == 0


def test_int8_engine_matches_jax(state):
    prompts = _prompts()
    jm, tm = _jax(state), _port(state)
    want = JaxEngine(jm, kv_dtype="int8", weight_dtype="int8",
                     **ENG_KW).generate_batch(prompts, N_NEW)
    eng = ServingEngine(tm, kv_dtype="int8", weight_dtype="int8", **ENG_KW)
    _same(eng.generate_batch(prompts, N_NEW), want)
    assert tm.weight_int8 and eng.cache.quantized
    js = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    for k, v in tm.state_dict().items():
        if k.endswith(("int8", "scale")):
            np.testing.assert_array_equal(v.numpy(), js[k], err_msg=k)
    scales = list(eng.cache.k_scale) + list(eng.cache.v_scale)
    assert len(scales) == 4 and all(bool(torch.isfinite(s).all())
                                    for s in scales)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_paged_step_without_plan_matches_jax(state, kv_dtype):
    jm, tm = _jax(state), _port(state)
    ids = np.random.RandomState(3).randint(0, 1024, (2, 12))
    tables = np.array([[3, 1, 4, 0], [2, 5, 6, 0]], np.int32)
    caches = (jm.new_paged_kv_cache(7, 4, dtype=kv_dtype),
              tm.new_paged_kv_cache(7, 4, dtype=kv_dtype))
    atol = 2e-5 if kv_dtype == "float32" else 1e-4
    for lo, hi in ((0, 7), (7, 8), (8, 9)):
        pos = np.full((2,), lo, np.int32)
        want = np.asarray(jm._paged_lm_logits(
            pt.to_tensor(ids[:, lo:hi], dtype="int64"), caches[0],
            pt.to_tensor(tables), pt.to_tensor(pos)).numpy())
        with torch.no_grad():
            got = tm._paged_lm_logits(
                torch.from_numpy(ids[:, lo:hi]), caches[1],
                torch.from_numpy(tables), torch.from_numpy(pos)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def test_per_layer_caches():
    c = PagedKVCache(2, 9, 4, 16, 16, dtype="int8", device="cpu")
    assert not c.stacked and c.quantized and len(c.k) == 2
    k, v = c.layer(1)
    assert k.shape == (9, 4, 16, 16) and k.dtype == torch.int8
    ks, vs = c.layer_scales(0)
    assert ks.shape == (9, 4) and ks.dtype == torch.float32
    assert c.nbytes == 2 * 2 * 9 * 4 * 16 * 16 + 2 * 2 * 9 * 4 * 4
    c.release()
    assert c.nbytes == 0 and c.k is None and c.k_scale is None
    f = PagedKVCache(2, 9, 4, 16, 16, dtype="bfloat16", device="cpu")
    assert f.layer_scales(1) == (None, None)
    assert f.nbytes == 2 * 2 * 9 * 4 * 16 * 16 * 2
    s = PagedKVCache(2, 9, 4, 16, 16, stacked=True, device="cpu")
    with pytest.raises(ValueError, match="per-layer"):
        s.layer(0)
    with pytest.raises(ValueError, match="per-layer"):
        s.layer_scales(0)
    kc = KVCache(3, 2, 4, 32, 16, dtype="float32", device="cpu")
    assert not kc.stacked and kc.layer(2)[0].shape == (2, 4, 32, 16)
    assert kc.nbytes == 2 * 3 * 2 * 4 * 32 * 16 * 4
    kc.release()
    assert kc.nbytes == 0
    with pytest.raises(ValueError, match="per-layer"):
        KVCache(3, 2, 4, 32, 16, stacked=True, device="cpu").layer(0)


def test_stacked_model_keeps_the_stacked_layout():
    m = GPTStackedForPretraining(gpt_tiny(), device="cpu")
    assert m.stacked and m.new_kv_cache(2, 16).stacked
    assert m.new_paged_kv_cache(3, 16).k.shape == (2, 3, 4, 16, 16)


def test_layered_lora_matches_jax(state):
    cfg = gpt_tiny()
    prompts = _prompts(lengths=(6, 11, 8, 14))
    tenants = ["a", None, "b", "a"]
    w = {n: random_adapter(cfg, 3, np.random.RandomState(s), scale=0.3)
         for n, s in (("a", 1), ("b", 2))}
    jp = JaxPool(cfg, num_adapter_pages=2, rank=3)
    tp = LoRAAdapterPool(cfg, num_adapter_pages=2, rank=3, device="cpu")
    assert not jp.stacked and not tp.stacked
    for n in ("a", "b"):
        assert jp.register(n, w[n]) == tp.register(n, w[n])
    for i in range(cfg.num_layers):
        for j, t in zip(jp.layer_slabs(i), tp.layer_slabs(i)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))
    je = JaxEngine(_jax(state), lora=jp, cache_dtype="float32", **ENG_KW)
    jreqs = [je.submit(p, N_NEW, adapter=a) for p, a in zip(prompts, tenants)]
    je.run_until_idle(max_steps=1000)
    tm = _port(state)
    te = ServingEngine(tm, lora=tp, cache_dtype="float32", **ENG_KW)
    treqs = [te.submit(p, N_NEW, adapter=a) for p, a in zip(prompts, tenants)]
    te.run_until_idle()
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_array_equal(tr.output_ids(), jr.output_ids())
    # each adapter's tokens are those of its merged weights
    for n in ("a", "b"):
        merged = GPTForPretraining(cfg, device="cpu")
        merged.load_state_dict(tp.merged_state_dict(tm, n))
        idx = [i for i, a in enumerate(tenants) if a == n]
        want = ServingEngine(merged, cache_dtype="float32",
                             **ENG_KW).generate_batch(
            [prompts[i] for i in idx], N_NEW)
        _same([treqs[i].output_ids() for i in idx], want)
    assert te.metrics()["lora_pages_used"] == 2 and tp.refcount("a") == 0


PREFIX_KEYS = ("prefix_hits", "prefix_partial_hits", "prefix_misses",
               "prefix_cached_tokens", "prefix_evictions", "shared_pages")


def test_prefix_cache_matches_jax(state):
    rng = np.random.RandomState(5)
    system = rng.randint(0, 1024, (20,))
    prompts = [np.concatenate([system, rng.randint(0, 1024, (n,))])
               for n in (3, 7, 5, 9)]
    kw = dict(prefix_cache=True, cache_dtype="float32", **ENG_KW)
    je = JaxEngine(_jax(state), **kw)
    jreqs = [je.submit(p, N_NEW) for p in prompts]
    je.run_until_idle(max_steps=1000)
    te = ServingEngine(_port(state), **kw)
    treqs = [te.submit(p, N_NEW) for p in prompts]
    te.run_until_idle()
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_array_equal(tr.output_ids(), jr.output_ids())
    jmet, tmet = je.metrics(), te.metrics()
    assert {k: tmet[k] for k in PREFIX_KEYS} == \
        {k: jmet[k] for k in PREFIX_KEYS}
    assert tmet["prefix_cached_tokens"] >= 16


def test_rebuild_of_the_per_layer_pool_matches_jax(state):
    prompts = _prompts(lengths=(6, 11, 8, 14))
    outs = []
    for eng, inj in ((JaxEngine(_jax(state), **ENG_KW), JaxInjector),
                     (ServingEngine(_port(state), **ENG_KW), FaultInjector)):
        old = eng.cache
        inj().inject("before_decode", at=1, times=2, kind="step_exception",
                     state_intact=False).install(eng)
        reqs = [eng.submit(p, N_NEW) for p in prompts]
        eng.run_until_idle(max_steps=1000)
        m = eng.metrics()
        assert m["recoveries"] == 1 and m["rebuilds"] == 1
        assert eng.cache is not old
        outs.append([(str(r.state), list(r.tokens)) for r in reqs])
    assert outs[0] == outs[1]
    assert not eng.cache.stacked and len(eng.cache.k) == 2
    assert eng.metrics()["pages_used"] == 0
