"""The port's prefix cache held against the JAX package on the CPU
(``tests/test_prefix_cache.py``):

- the radix index and its allocator ledger: the same script of
  registrations, hits, evictions and flushes run on the JAX
  ``PrefixCache`` and the port's gives the same pages, nodes, refcounts
  and stats at every step;
- whole engines on ``gpt_tiny`` carried across by ``load_jax_state``:
  the JAX ``ServingEngine(prefix_cache=True)`` over its stacked GPT and
  the port's give the same greedy tokens, token for token, and the same
  hit, partial-hit, miss and cached-token counts; with the cache on the
  port's tokens equal its own cache-off run bit for bit (the COW
  guarantee), in fp32 and from a bf16 pool;
- eviction under pool pressure, the speculative engine over the cache,
  and the metrics keys with the cache off.

Every comparison is exact: tokens, page ids and counts.  The page
accounting ``free + used + spec + shared == capacity`` is checked at
every step boundary."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import GPTStackedForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import BlockAllocator as JaxAllocator
from paddle_tpu.serving import PrefixCache as JaxPrefixCache
from paddle_tpu.serving import ServingEngine as JaxEngine

from paddle_tpu_torch.models import GPTStackedForPretraining, gpt_tiny
from paddle_tpu_torch.serving import (
    BlockAllocator, PrefixCache, RequestState, ServingEngine,
    SpeculativeEngine,
)
from paddle_tpu_torch.telemetry import metrics as tmetrics

torch.set_num_threads(2)

N_NEW = 4
ENGINE_KW = dict(num_slots=2, page_size=16, max_context=64,
                 cache_dtype="float32")


def _jax_state(seed):
    """A JAX stacked GPT's fp32 state with every bias and LayerNorm gain
    perturbed away from its 0/1 init."""
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
    state = _jax_state(5)
    jm = JaxGPT(jax_gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0))
    jm.eval()
    jm.set_state_dict(state)
    tm = GPTStackedForPretraining(gpt_tiny(), device="cpu")
    tm.load_jax_state(state)
    return jm, tm


def _ledger(a):
    return a.free_pages + a.used_pages + a.spec_pages + a.shared_pages


def _shared_prefix_prompts(rng, vocab=1024):
    """Two system-prompt families x unique tails + one loner, interleaved
    so family siblings are in flight together (the COW window)."""
    fam = [rng.randint(0, vocab, (20,)), rng.randint(0, vocab, (20,))]
    tails = [rng.randint(0, vocab, (k,)) for k in (3, 7, 5, 9)]
    return [np.concatenate([fam[0], tails[0]]),
            np.concatenate([fam[1], tails[1]]),
            np.concatenate([fam[0], tails[2]]),
            rng.randint(0, vocab, (11,)),
            np.concatenate([fam[1], tails[3]]),
            np.concatenate([fam[0], tails[1]])]


# ---------------------------------------------------------------------------
# the radix index: one script, both implementations
# ---------------------------------------------------------------------------

PS = 4


def _script_register(cache, alloc, toks):
    """The engine's registration at page completion (extend a fresh page,
    free the duplicate on dedup), then the registering slot's release."""
    nodes = []
    for i in range(len(toks) // PS):
        (page,) = alloc.alloc(1)
        node, owned = cache.extend(nodes[-1] if nodes else None,
                                   toks[i * PS:(i + 1) * PS], page)
        if not owned:
            alloc.free([page])
        nodes.append(node)
    cache.release(nodes)
    return [nd.page for nd in nodes]


def _run_script(alloc_cls, cache_cls, name):
    """One scenario of ``tests/test_prefix_cache.py``'s radix tests;
    returns every observable it produced, in order."""
    a = alloc_cls(num_pages=12)
    c = cache_cls(a, page_size=PS)
    log = []

    def snap():
        log.append((c.nodes, a.free_pages, a.used_pages, a.shared_pages,
                    _ledger(a), dict(c.stats)))

    if name == "longest_match":
        log.append(_script_register(c, a, np.arange(12, dtype=np.int64)))
        log.append([c.match_len(np.arange(13)),
                    c.match_len(np.concatenate([np.arange(8), [99, 98]])),
                    c.match_len(np.array([7, 7, 7]))])
        nodes, pages, n = c.acquire(np.arange(13))
        log.append((pages, n, [a.refcount(p) for p in pages]))
        c.release(nodes)
        log.append([a.refcount(p) for p in pages])
    elif name == "last_page_cap":
        toks = np.arange(8, dtype=np.int64)
        _script_register(c, a, toks)
        _, pages, n = c.acquire(toks)
        log.append((pages, n, c.match_len(toks)))
    elif name == "dedup":
        toks = np.arange(PS, dtype=np.int64)
        (p1,) = _script_register(c, a, toks)
        (p2,) = a.alloc(1)
        node, owned = c.extend(None, toks, p2)
        log.append((node.page, p1, owned, a.refcount(p1)))
        a.free([p2])
        a.unref(p1)
    elif name == "lru_eviction":
        _script_register(c, a, np.arange(8, dtype=np.int64))
        _script_register(c, a, np.full(PS, 77, dtype=np.int64))
        held, _, _ = c.acquire(np.full(8, 77, dtype=np.int64))
        log.append((len(held), c.evict(10), c.nodes))
        c.release(held)
        log.append(c.evict(10))
    elif name == "flush":
        _script_register(c, a, np.arange(PS, dtype=np.int64))
        nodes, _, _ = c.acquire(np.arange(8, dtype=np.int64))
        with pytest.raises(RuntimeError, match="reader"):
            c.flush()
        c.release(nodes)
        c.flush()
    elif name == "reclaim_under_pressure":
        # the allocator's reclaimer hook: cache-held pages are evicted
        # BEFORE an allocation backpressures
        _script_register(c, a, np.arange(40, dtype=np.int64))
        log.append((a.free_pages, a.shared_pages))
        got = a.alloc(4)
        log.append((got, a.free_pages, a.shared_pages))
        log.append(a.alloc(20))
    snap()
    return log


@pytest.mark.parametrize("name", ["longest_match", "last_page_cap", "dedup",
                                  "lru_eviction", "flush",
                                  "reclaim_under_pressure"])
def test_radix_index_script_matches_jax(name):
    got = _run_script(BlockAllocator, PrefixCache, name)
    want = _run_script(JaxAllocator, JaxPrefixCache, name)
    assert got == want


# ---------------------------------------------------------------------------
# whole engines
# ---------------------------------------------------------------------------

def _drain_checked(eng, reqs):
    """Step ``eng`` to idle, holding the 4-term ledger at every step."""
    a = eng.allocator
    steps = 0
    while eng.queue.depth or eng.scheduler.active_slots:
        eng.step()
        steps += 1
        assert _ledger(a) == a.capacity
        assert steps < 1000
    for r in reqs:
        assert r.state == RequestState.DONE, (r.state, r.error)


PREFIX_KEYS = ("prefix_hits", "prefix_partial_hits", "prefix_misses",
               "prefix_cached_tokens", "prefix_evictions",
               "prefix_cache_pages", "shared_pages", "prefill_tokens")


def test_cow_parity_and_counts_match_jax_fp32(models):
    """Interleaved shared-prefix arrivals over 2 slots: the JAX engine and
    the port's, both with the cache on, give the same tokens and counts;
    the port's cache-off run gives the same tokens (COW)."""
    jm, tm = models
    prompts = _shared_prefix_prompts(np.random.RandomState(5))
    je = JaxEngine(jm, prefix_cache=True, **ENGINE_KW)
    jreqs = [je.submit(p, N_NEW) for p in prompts]
    je.run_until_idle(max_steps=1000)
    te = ServingEngine(tm, prefix_cache=True, **ENGINE_KW)
    treqs = [te.submit(p, N_NEW) for p in prompts]
    _drain_checked(te, treqs)
    off = ServingEngine(tm, **ENGINE_KW).generate_batch(prompts, N_NEW)
    for jr, tr, o in zip(jreqs, treqs, off):
        assert jr.finished
        np.testing.assert_array_equal(tr.output_ids(), jr.output_ids())
        np.testing.assert_array_equal(tr.output_ids(), o)
    jmet, tmet = je.metrics(), te.metrics()
    assert {k: tmet[k] for k in PREFIX_KEYS} == \
        {k: jmet[k] for k in PREFIX_KEYS}
    assert tmet["prefix_hits"] + tmet["prefix_partial_hits"] >= 1
    assert tmet["prefix_cached_tokens"] >= 16
    a = te.allocator
    assert a.used_pages == 0 and a.spec_pages == 0
    assert a.free_pages + a.shared_pages == a.capacity
    je.close()
    te.close()


def test_cow_parity_from_a_bf16_pool(models):
    """The COW guarantee from a bf16 pool: cache on == cache off, bit for
    bit, through a real hit (the family's first member completes before
    its siblings arrive)."""
    _, tm = models
    rng = np.random.RandomState(9)
    shared = rng.randint(0, 1024, (32,))
    fam = [np.concatenate([shared, rng.randint(0, 1024, (3 + 2 * i,))])
           for i in range(4)]
    outs = {}
    for cached in (False, True):
        eng = ServingEngine(tm, prefix_cache=cached,
                            **dict(ENGINE_KW, cache_dtype="bfloat16"))
        first = eng.submit(fam[0], N_NEW)
        _drain_checked(eng, [first])
        rest = [eng.submit(p, N_NEW) for p in fam[1:]]
        _drain_checked(eng, rest)
        outs[cached] = [r.output_ids() for r in [first] + rest]
        if cached:
            m = eng.metrics()
            assert m["prefix_hits"] == 3 and m["prefix_misses"] == 1
            assert m["prefix_cached_tokens"] == 3 * 32
        eng.close()
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)


def test_eviction_under_pool_pressure_matches_jax(models):
    """An admission the free list alone cannot satisfy evicts LRU
    refcount-0 cache pages before it backpressures -- the same evictions,
    the same pages and the same tokens as the JAX engine."""
    jm, tm = models
    rng = np.random.RandomState(11)
    work = [(rng.randint(0, 1024, (n,)), k)
            for n, k in ((20, 4), (40, 6), (44, 2), (30, N_NEW))]
    kw = dict(num_slots=1, page_size=16, max_context=48, num_pages=7,
              cache_dtype="float32", prefix_cache=True)
    runs = []
    for eng in (JaxEngine(jm, **kw), ServingEngine(tm, **kw)):
        seen = []
        for i, (p, k) in enumerate(work):
            r = eng.submit(p, k)
            eng.run_until_idle(max_steps=300)
            a = eng.allocator
            assert r.state == RequestState.DONE, (r.state, r.error)
            assert _ledger(a) == a.capacity
            if i == 2:
                # the cache-full pool before the last admission
                assert (a.free_pages, a.shared_pages) == (1, 5)
            seen.append((r.output_ids().tolist(), a.free_pages,
                         a.shared_pages, sorted(a._shared),
                         eng.metrics()["prefix_evictions"]))
        runs.append(seen)
        assert eng.allocator.used_pages == 0
        eng.close()
    assert runs[1] == runs[0]
    assert runs[1][-1][-1] >= 2


def test_speculative_engine_over_the_cache_matches_jax_tokens(models):
    """A cached-prefix admission seeds the draft's catch-up backlog:
    greedy speculative tokens equal the JAX plain engine's, and BOTH pools
    drain (the target's shared pages stay cache-held)."""
    jm, tm = models
    prompts = _shared_prefix_prompts(np.random.RandomState(3))[:4]
    want = JaxEngine(jm, **ENGINE_KW).generate_batch(prompts, N_NEW)
    eng = SpeculativeEngine(tm, tm, spec_k=2, prefix_cache=True,
                            **ENGINE_KW)
    reqs = [eng.submit(p, N_NEW) for p in prompts]
    steps = 0
    while eng.queue.depth or eng.scheduler.active_slots:
        eng.step()
        steps += 1
        for a in (eng.allocator, eng.draft.allocator):
            assert _ledger(a) == a.capacity
        assert steps < 1000
    for r, w in zip(reqs, want):
        assert r.finished
        np.testing.assert_array_equal(r.output_ids(), w)
    m = eng.metrics()
    assert m["spec_acceptance_rate"] == 1.0
    assert m["prefix_hits"] + m["prefix_partial_hits"] >= 1
    for a in (eng.allocator, eng.draft.allocator):
        assert a.used_pages == 0 and a.spec_pages == 0
    assert (eng.allocator.free_pages + eng.allocator.shared_pages
            == eng.allocator.capacity)
    eng.close()


def test_prefix_metrics_exist_with_cache_disabled(models):
    _, tm = models
    eng = ServingEngine(tm, num_slots=1, page_size=16, max_context=32,
                        cache_dtype="float32")
    assert eng.prefix_cache is None
    m = eng.metrics()
    for k in ("prefix_hits", "prefix_partial_hits", "prefix_misses",
              "prefix_evictions", "prefix_cached_tokens", "prefix_hit_rate",
              "cached_tokens_share", "prefix_cache_pages",
              "prefix_cache_nodes", "shared_pages"):
        assert m[k] == 0, (k, m[k])
    text = tmetrics.registry().prometheus_text()
    for name in ("serving_prefix_hits_total",
                 "serving_prefix_evictions_total",
                 "serving_prefix_cached_tokens"):
        assert name in text
    eng.close()
