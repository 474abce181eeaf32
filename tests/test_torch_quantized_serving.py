"""Quantized serving of the port held against the JAX package on the CPU:
``ServingEngine(kv_dtype="int8")``, with and without
``weight_dtype="int8"``, over gpt_tiny in fp32 carried across from the JAX
stacked GPT.

- whole engines: the port's greedy tokens equal the JAX int8 engine's, and
  fp32 ``generate()``'s (``tests/test_quantized_serving.py:161-174``);
  pages drain to 0 and every scale stays finite;
- one fused step: logits, int8 pools and scales against the JAX step;
- the paged step without a plan, chunked prefill (C > 1) and decode steps
  (C == 1), against the JAX model;
- ``load_jax_state`` of a quantized JAX model, and the refusals of a
  quantized model (``generate()``, training).

Tolerances.  Logits: 1e-5 (fp32, the same arithmetic summed in another
order, as tests/test_torch_gpt_serving.py states).  Pools: an fp32
difference of an ulp in a K/V value or its scale can move a value across
a rounding midpoint, so at most 0.5 % of the written elements may differ,
each by one int8 step.  Scales: 1e-6 relative (absmax / 127 of values that
differ by ulps)."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import GPTStackedForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.quantization.int8 import (
    quantize_for_serving as jax_quantize_for_serving,
)
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.tensor import to_tensor

from paddle_tpu_torch.models import GPTStackedForPretraining, gpt_tiny
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as tra
from paddle_tpu_torch.serving import PagedKVCache, ServingEngine

torch.set_num_threads(2)

N_NEW = 4
ENGINE_KW = dict(num_slots=3, page_size=16, max_context=64)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
FLIP_SHARE = 0.005


def _jax_state(seed):
    """A JAX stacked GPT's fp32 state with every bias and LayerNorm gain
    perturbed away from its 0/1 init."""
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
    return state


def _jax_model(state, int8_weights):
    m = JaxGPT(jax_gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0))
    m.eval()
    m.set_state_dict(state)
    if int8_weights:
        jax_quantize_for_serving(m)
    return m


def _port_model(state, int8_weights=False):
    m = GPTStackedForPretraining(gpt_tiny(), device="cpu", dtype="float32")
    m.load_jax_state(state)
    if int8_weights:
        m.quantize_weights()
    return m


@pytest.fixture(scope="module")
def served():
    state = _jax_state(3)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 1024, (s,)) for s in (5, 9, 7, 12, 17, 4, 11,
                                                    6)]
    fp32 = _port_model(state)
    refs = [fp32.generate(p[None], N_NEW, max_seq_len=64,
                          cache_dtype="float32")[0].numpy() for p in prompts]
    return state, prompts, refs


# ---------------------------------------------------------------------------
# whole engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight_dtype", [None, "int8"])
def test_int8_engine_matches_jax_engine_and_fp32_generate(served,
                                                          weight_dtype):
    state, prompts, refs = served
    jeng = JaxEngine(_jax_model(state, False), kv_dtype="int8",
                     weight_dtype=weight_dtype, **ENGINE_KW)
    want = jeng.generate_batch(prompts, N_NEW)
    model = _port_model(state)
    eng = ServingEngine(model, kv_dtype="int8", weight_dtype=weight_dtype,
                        **ENGINE_KW)
    assert eng.cache.quantized and eng.cache.k.dtype == torch.int8
    assert model.weight_int8 == (weight_dtype == "int8")
    got = eng.generate_batch(prompts, N_NEW)
    for g, w, r in zip(got, want, refs):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)
    assert eng.metrics()["pages_used"] == 0
    for t in (eng.cache.k_scale, eng.cache.v_scale):
        assert bool(torch.isfinite(t).all()) and bool((t >= 0).all())
        assert float(t.max()) > 0.0         # the pages were written


def test_kv_dtype_wins_over_cache_dtype_and_int8_cache_dtype_works(served):
    state, prompts, refs = served
    for kw, quantized in ((dict(kv_dtype="int8", cache_dtype="float32"),
                           True),
                          (dict(kv_dtype="float32", cache_dtype="int8"),
                           False),
                          (dict(cache_dtype="int8"), True)):
        eng = ServingEngine(_port_model(state), **kw, **ENGINE_KW)
        assert eng.cache.quantized == quantized
        assert eng.cache_dtype == ("int8" if quantized else "float32")
        got = eng.generate_batch(prompts[:3], N_NEW)
        for g, r in zip(got, refs):
            np.testing.assert_array_equal(g, r)


def test_weight_dtype_other_than_int8_raises(served):
    state, _, _ = served
    for bad in ("bfloat16", "float32", "int4"):
        with pytest.raises(ValueError, match="only 'int8'"):
            ServingEngine(_port_model(state), weight_dtype=bad, **ENGINE_KW)


def test_int8_pool_counts_and_releases_its_scales():
    c = PagedKVCache(2, 9, 4, 16, 16, dtype="int8", device="cpu")
    assert c.quantized and c.k.dtype == torch.int8
    assert c.k_scale.shape == c.v_scale.shape == (2, 9, 4)
    assert c.k_scale.dtype == torch.float32 and not bool(c.k_scale.any())
    assert c.nbytes == 2 * 2 * 9 * 4 * 16 * 16 + 2 * 2 * 9 * 4 * 4
    c.release()
    assert c.nbytes == 0 and c.k_scale is None and c.v_scale is None
    f = PagedKVCache(2, 9, 4, 16, 16, dtype="bfloat16", device="cpu")
    assert not f.quantized and f.k_scale is None
    assert f.nbytes == 2 * 2 * 9 * 4 * 16 * 16 * 2


# ---------------------------------------------------------------------------
# one fused step, and the paged step without a plan, against JAX
# ---------------------------------------------------------------------------

def _random_int8_pool(rng, cfg, num_pages):
    shape = (cfg.num_layers, num_pages, cfg.num_heads, 16, cfg.head_dim)
    pools = [rng.randint(-127, 128, shape).astype(np.int8) for _ in range(2)]
    scales = [(rng.rand(*shape[:3]) * 0.03 + 0.005).astype(np.float32)
              for _ in range(2)]
    for s in scales:
        s[:, 3] = 0.0          # a never-written page: the zero sentinel
    return pools + scales


def _caches(jm, tm, arrays, num_pages):
    jc = jm.new_paged_kv_cache(num_pages, 16, dtype="int8")
    tc = tm.new_paged_kv_cache(num_pages, 16, dtype="int8")
    for name, a in zip(("k", "v", "k_scale", "v_scale"), arrays):
        getattr(jc, name)._set_value(to_tensor(a)._value)
        getattr(tc, name).copy_(torch.from_numpy(a))
    return jc, tc


def _hold_pools(jc, tc, before):
    for name, b in zip(("k", "v"), before):
        t = getattr(tc, name).numpy().astype(np.int64)
        j = np.asarray(getattr(jc, name).numpy()).astype(np.int64)
        steps = np.abs(t - j)
        written = int((j != b).sum())
        assert written > 0
        assert steps.max() <= 1, f"{name}: a value off by {steps.max()} steps"
        assert (steps > 0).sum() <= FLIP_SHARE * written, \
            f"{name}: {(steps > 0).sum()} flips in {written} written values"
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name).numpy()),
                                   rtol=1e-6, atol=0, err_msg=name)


@pytest.mark.parametrize("int8_weights", [False, True])
def test_fused_step_logits_pools_and_scales_match_jax(served, int8_weights):
    """One fused mixed step over a pre-filled int8 pool: a 10-token prefill
    chunk into a never-written page (scale 0: fresh by the sentinel) and a
    stale one, a decode at position 20 into a stale page, padding tokens
    into the null page."""
    state, _, _ = served
    jm, tm = _jax_model(state, int8_weights), _port_model(state, int8_weights)
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
    arrays = _random_int8_pool(rng, cfg, num_pages)
    jc, tc = _caches(jm, tm, arrays, num_pages)
    jlog = jm._paged_lm_logits(
        to_tensor(ids), jc, to_tensor(tables), to_tensor(positions),
        ragged_plan=tuple(to_tensor(plan[k]) for k in tra.RAGGED_PLAN_FIELDS),
        out_rows=to_tensor(out_rows)).numpy()
    with torch.no_grad():
        tlog = tm._paged_lm_logits(
            torch.from_numpy(ids), tc, torch.from_numpy(tables),
            torch.from_numpy(positions),
            ragged_plan=tuple(torch.from_numpy(plan[k])
                              for k in tra.RAGGED_PLAN_FIELDS),
            out_rows=torch.from_numpy(out_rows))
    assert tlog.dtype == torch.float32
    assert tlog.shape == jlog.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), jlog, **LOGIT_TOL)
    _hold_pools(jc, tc, arrays[:2])
    # the never-written page 3 took the step's absmax; the stale page 1
    # kept its scale
    assert bool((tc.k_scale[:, 3] > 0).all())
    np.testing.assert_array_equal(tc.k_scale[:, 1].numpy(), arrays[2][:, 1])


def test_paged_step_without_a_plan_matches_jax(served):
    """Int8 KV and int8 weights: a chunked prefill of 12 tokens (C > 1,
    attention over the gathered, dequantized pages), then a C == 1 decode
    step through the paged kernel's plain int8 version, two slots over
    shuffled pages.  (Each JAX call here compiles for seconds: two calls
    cover both paths.)"""
    state, prompts, _ = served
    jm, tm = _jax_model(state, True), _port_model(state, True)
    num_pages = 9
    jc = jm.new_paged_kv_cache(num_pages, 16, dtype="int8")
    tc = tm.new_paged_kv_cache(num_pages, 16, dtype="int8")
    tables = np.array([[4, 7, 1, 0], [2, 8, 5, 0]], np.int32)
    ids = np.stack([prompts[4][:12], prompts[3][:12]])
    before = [np.zeros(tc.k.shape, np.int8)] * 2

    def step(tok, pos):
        p = np.full((2,), pos, np.int32)
        j = jm._paged_lm_logits(to_tensor(tok), jc, to_tensor(tables),
                                to_tensor(p)).numpy()
        with torch.no_grad():
            t = tm._paged_lm_logits(torch.from_numpy(tok), tc,
                                    torch.from_numpy(tables),
                                    torch.from_numpy(p)).numpy()
        np.testing.assert_allclose(t, j, **LOGIT_TOL)
        return t

    last = step(ids, 0)[:, -1]
    step(last.argmax(-1)[:, None].astype(np.int64), 12)
    _hold_pools(jc, tc, before)


# ---------------------------------------------------------------------------
# a quantized JAX model carried across; what a quantized model refuses
# ---------------------------------------------------------------------------

def test_load_jax_state_carries_a_quantized_model(served):
    state, prompts, _ = served
    jm = _jax_model(state, True)
    qstate = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    assert qstate["decoder.qkv_w_int8"].dtype == np.int8
    tm = GPTStackedForPretraining(gpt_tiny(), device="cpu", dtype="float32")
    tm.load_jax_state(qstate)
    assert tm.weight_int8
    buffers = dict(tm.named_buffers())
    for k, a in qstate.items():
        if k in buffers:
            np.testing.assert_array_equal(buffers[k].numpy(), a, err_msg=k)
    assert len([k for k in qstate if k in buffers]) == 10
    # serving it needs no weight_dtype: the weights are int8 already
    want = JaxEngine(jm, kv_dtype="int8", **ENGINE_KW).generate_batch(
        prompts[:4], N_NEW)
    got = ServingEngine(tm, kv_dtype="int8", **ENGINE_KW).generate_batch(
        prompts[:4], N_NEW)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    partial = {k: a for k, a in qstate.items() if k != "lm_head_scale"}
    fresh = GPTStackedForPretraining(gpt_tiny(), device="cpu")
    with pytest.raises(KeyError, match="lm_head_scale"):
        fresh.load_jax_state(partial)
    with pytest.raises(ValueError, match="quantized"):
        tm.load_jax_state(state)


def test_a_quantized_model_refuses_generate_and_training(served):
    state, prompts, _ = served
    m = _port_model(state, True)
    m.config.hidden_dropout = m.config.attention_dropout = 0.0
    ids = torch.from_numpy(prompts[0][None])
    with pytest.raises(ValueError, match="quantized for serving"):
        m.generate(ids, 2, max_seq_len=32, cache_dtype="float32")
    for mode in (m.eval, m.train):
        mode()
        with pytest.raises(ValueError, match="quantized for serving"):
            m(ids, labels=ids)
        with pytest.raises(ValueError, match="quantized for serving"):
            m(ids)
