"""The port's ``generate()`` and paged step without a plan, held against the
JAX package on the CPU.

The JAX ``GPTStackedForPretraining(gpt_tiny(dropout 0))``, with every bias
and LayerNorm gain perturbed away from its 0/1 init, is carried across
with ``load_jax_state``.  Then the same token ids go through both models:
prefill plus per-token decode through the contiguous cache, a chunked
prefill at a nonzero position, greedy ``generate`` (tokens and logits),
its eos padding and validations, and the paged step without a ragged plan
(C > 1 chunks, then C == 1 decode steps).  Sampling is checked by property
(support, mass, reproducibility from one generator), not against JAX's
random bits.

Sizes are small (``gpt_tiny``: hidden 64, 2 layers, 4 heads, head_dim 16,
vocab 1024).  Tolerances: fp32 within 1e-5 (the same arithmetic, summed in
another order by XLA and by PyTorch, on logits of magnitude ~1); a bf16
cache within 2e-3: both sides round K/V to bf16 identically and the
attention output to bf16 at the same points, and differ only where an
fp32 sum lands on the other side of a bf16 rounding (2^-8 relative) of a
probability or an output element, which the later layers carry into the
logits (about 1.5e-4 at most over these runs)."""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import GPTStackedForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.tensor import to_tensor

from paddle_tpu_torch.models import (
    GPTStackedForPretraining, KVCache, generation, gpt_tiny,
)
from paddle_tpu_torch.ops.kernels import decode_attention as tda
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as tra

torch.set_num_threads(2)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-3, atol=2e-3)}


def _jax_model(seed):
    """A JAX stacked GPT with every bias and LayerNorm gain perturbed."""
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
    m = GPTStackedForPretraining(
        gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0), device="cpu",
        dtype="float32")
    m.load_jax_state(state)
    return m


@pytest.fixture(scope="module")
def models():
    jm, state = _jax_model(5)
    return jm, _port_model(state)


def _ids(b, s, seed):
    return np.random.RandomState(seed).randint(0, 1024, (b, s)).astype(
        np.int64)


def _launches():
    return (tda.decode_attention.launches, tpa.paged_attention.launches,
            tfa.flash_attention_fwd.launches,
            tra.ragged_paged_attention.launches)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# the contiguous cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_cached_prefill_and_decode_match_jax(models, cache_dtype):
    """Prefill at position 0, then one token per step at a device
    position, against the JAX model's ``_cached_lm_logits`` at every
    step; the caches hold the same K/V afterwards."""
    jm, tm = models
    ids = _ids(2, 12, seed=1)
    jc = jm.new_kv_cache(2, 64, dtype=cache_dtype)
    tc = tm.new_kv_cache(2, 64, dtype=cache_dtype)
    assert isinstance(tc, KVCache) and tc.k.shape == (2, 2, 4, 64, 16)
    with torch.no_grad():
        got = tm._cached_lm_logits(_t(ids[:, :8]), tc, 0).numpy()
        want = jm._cached_lm_logits(to_tensor(ids[:, :8]), jc, 0).numpy()
        np.testing.assert_allclose(got, want, err_msg="prefill",
                                   **TOL[cache_dtype])
        for t in range(8, 12):
            pos = torch.tensor(t, dtype=torch.int32)
            got = tm._cached_lm_logits(_t(ids[:, t:t + 1]), tc, pos).numpy()
            want = jm._cached_lm_logits(to_tensor(ids[:, t:t + 1]), jc,
                                        t).numpy()
            np.testing.assert_allclose(got, want, err_msg=f"decode {t}",
                                       **TOL[cache_dtype])
    for mine, theirs in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(mine.float().numpy()[..., :12, :],
                                   np.asarray(theirs.numpy(), np.float32)
                                   [..., :12, :], **TOL[cache_dtype])
        assert not mine[..., 12:, :].any()


def test_chunked_prefill_at_a_nonzero_position_matches_jax(models):
    """S > 1 at a nonzero position attends over the whole cache, earlier
    chunks included (the JAX package's XLA route)."""
    jm, tm = models
    ids = _ids(2, 12, seed=3)
    jc = jm.new_kv_cache(2, 64, dtype="float32")
    tc = tm.new_kv_cache(2, 64, dtype="float32")
    with torch.no_grad():
        for lo, hi, pos in ((0, 4, 0), (4, 9, torch.tensor(4)), (9, 12, 9)):
            got = tm._cached_lm_logits(_t(ids[:, lo:hi]), tc, pos).numpy()
            want = jm._cached_lm_logits(to_tensor(ids[:, lo:hi]), jc,
                                        lo).numpy()
            np.testing.assert_allclose(got, want, err_msg=f"chunk {lo}",
                                       **TOL["float32"])
        # and the chunks reproduce the no-cache forward
        full = tm(_t(ids)).numpy()
    np.testing.assert_allclose(got, full[:, 9:12], **TOL["float32"])


# ---------------------------------------------------------------------------
# generate()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s0", [6, 13])
def test_greedy_generate_matches_jax_tokens_and_logits(models, s0):
    jm, tm = models
    ids = _ids(2, s0, seed=s0)
    kw = dict(max_new_tokens=8, max_seq_len=64, cache_dtype="float32",
              return_logits=True)
    j_out, j_logits = jm.generate(to_tensor(ids), **kw)
    t_out, t_logits = tm.generate(ids, **kw)
    assert t_out.shape == (2, s0 + 8) and t_out.dtype == torch.int64
    assert t_logits.shape == (2, 8, 1024) and t_logits.dtype == torch.float32
    np.testing.assert_array_equal(t_out.numpy(), j_out.numpy())
    np.testing.assert_allclose(t_logits.numpy(), j_logits.numpy(),
                               **TOL["float32"])
    # greedy consistency: each emitted token is the argmax of its logits
    np.testing.assert_array_equal(t_out.numpy()[:, s0:],
                                  t_logits.numpy().argmax(-1))


def test_greedy_generate_with_a_bf16_cache_tracks_jax(models):
    """The default bf16 cache: logits within the bf16 tolerance of the JAX
    model's (the tokens follow the logits and match here)."""
    jm, tm = models
    ids = _ids(2, 6, seed=11)
    kw = dict(max_new_tokens=6, max_seq_len=32, return_logits=True)
    j_out, j_logits = jm.generate(to_tensor(ids), **kw)
    t_out, t_logits = tm.generate(torch.from_numpy(ids), **kw)
    np.testing.assert_array_equal(t_out.numpy(), j_out.numpy())
    np.testing.assert_allclose(t_logits.numpy(), j_logits.numpy(),
                               **TOL["bfloat16"])


def test_generate_eos_padding_matches_jax(models):
    """Rows freeze at their first eos as the JAX function pads them, with
    and without ``return_logits``."""
    jm, tm = models
    ids = _ids(2, 6, seed=9)
    kw = dict(max_new_tokens=6, max_seq_len=64, cache_dtype="float32")
    base = tm.generate(ids, **kw).numpy()
    eos = int(base[0, 6 + 2])      # whatever greedy emits at step 2 of row 0
    want = jm.generate(to_tensor(ids), eos_token_id=eos, **kw).numpy()
    got = tm.generate(ids, eos_token_id=eos, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    for row in got[:, 6:]:
        hits = np.nonzero(row == eos)[0]
        if hits.size:
            assert (row[hits[0]:] == eos).all()
    got2, logits = tm.generate(ids, eos_token_id=eos, return_logits=True,
                               **kw)
    np.testing.assert_array_equal(got2.numpy(), want)
    assert logits.shape == (2, 6, 1024) and torch.isfinite(logits).all()


@pytest.mark.parametrize("kw,match", [
    (dict(max_new_tokens=60, max_seq_len=64), "exceeds the"),
    (dict(max_new_tokens=4, max_seq_len=4096), "max_position_embeddings"),
    (dict(max_new_tokens=0), "max_new_tokens must be"),
    (dict(max_new_tokens=4, do_sample=True, temperature=0.0),
     "temperature must be")])
def test_generate_validates_as_jax_does(models, kw, match):
    jm, tm = models
    ids = _ids(2, 6, seed=0)
    for m, x in ((jm, to_tensor(ids)), (tm, ids)):
        with pytest.raises(ValueError, match=match):
            m.generate(x, **kw)


def test_filter_logits_top_k_and_top_p_as_jax():
    logits = torch.tensor([[0., 1., 2., 3., 4.], [4., 3., 2., 1., 0.]])
    kept = generation.filter_logits(logits, top_k=2) > -1e29
    assert kept.tolist() == [[False, False, False, True, True],
                             [True, True, False, False, False]]
    raw = torch.tensor([[0., 1., 2., 3., 4.]])
    probs = torch.softmax(raw[0], -1)
    # p=0.6: the argmax alone carries ~0.636 >= 0.6 -> keep exactly it
    kept = generation.filter_logits(raw, top_p=0.6) > -1e29
    assert kept.tolist() == [[False, False, False, False, True]]
    # p=0.8: top-1 (0.636) < 0.8, top-2 (0.87) >= 0.8 -> keep two
    kept = generation.filter_logits(raw, top_p=0.8) > -1e29
    assert int(kept.sum()) == 2 and float(probs[kept[0]].sum()) >= 0.8


def test_sampling_stays_in_the_top_k_support_and_top_p_mass():
    logits = torch.tensor([[0.0, 5.0, 1.0, 4.0, 2.0, 3.0, -1.0, 0.5]])
    gen = torch.Generator().manual_seed(123)
    seen = {int(generation.sample_tokens(logits, do_sample=True,
                                         temperature=1.0, top_k=3,
                                         generator=gen)[0])
            for _ in range(64)}
    assert seen <= {1, 3, 5} and len(seen) > 1     # the top-3 ids, sampled
    # top_p=0.8 over these logits keeps ids 1 and 3 (0.63 + 0.23)
    seen = {int(generation.sample_tokens(logits, do_sample=True, top_p=0.8,
                                         generator=gen)[0])
            for _ in range(64)}
    assert seen == {1, 3}
    with pytest.raises(ValueError, match="Generator"):
        generation.sample_tokens(logits, do_sample=True)


def test_sampled_generate_is_reproducible_from_one_generator(models):
    _, tm = models
    ids = _ids(2, 6, seed=2)
    kw = dict(max_new_tokens=6, do_sample=True, temperature=0.8, top_k=50,
              top_p=0.9, max_seq_len=64, cache_dtype="float32")
    a = tm.generate(ids, generator=torch.Generator().manual_seed(42), **kw)
    b = tm.generate(ids, generator=torch.Generator().manual_seed(42), **kw)
    c = tm.generate(ids, generator=torch.Generator().manual_seed(43), **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert (a >= 0).all() and (a < 1024).all()
    assert torch.equal(a[:, :6], torch.from_numpy(ids))


def test_decode_caches_are_lru_bounded_and_released(models):
    """Each engine pins a KV cache: distinct request shapes do not
    accumulate past the bound, the oldest is evicted and released, and
    ``clear_decode_cache`` releases the rest."""
    _, tm = models
    tm.clear_decode_cache()
    ids = _ids(2, 6, seed=4)
    first = None
    for b in (16, 24, 32, 40, 48):   # five distinct max_seq_len keys
        tm.generate(ids, max_new_tokens=2, max_seq_len=b + 16,
                    cache_dtype="float32")
        if first is None:
            first = tm.__dict__["_decode_engines"][(2, 32, "float32")]
    engines = tm.__dict__["_decode_engines"]
    assert len(engines) == generation._MAX_ENGINES
    assert (2, 32, "float32") not in engines           # evicted
    assert first.released and first.cache.k is None
    # reuse refreshes recency: the reused key survives the next insert
    tm.generate(ids, max_new_tokens=2, max_seq_len=40, cache_dtype="float32")
    tm.generate(ids, max_new_tokens=2, max_seq_len=33, cache_dtype="float32")
    assert (2, 40, "float32") in engines and (2, 48, "float32") not in engines
    kept = list(engines.values())
    tm.clear_decode_cache()
    assert "_decode_engines" not in tm.__dict__
    assert all(e.released and e.cache.k is None and e.cache.nbytes == 0
               for e in kept)


def test_concurrent_generates_of_one_shape_serialize(models):
    """Threads sharing one request shape share one cache; the engine's
    lock keeps their steps apart, so each gets the single-thread tokens."""
    _, tm = models
    ids = _ids(2, 6, seed=12)
    kw = dict(max_new_tokens=6, max_seq_len=64, cache_dtype="float32")
    want = tm.generate(ids, **kw)
    outs = [None] * 4

    def run(i):
        outs[i] = tm.generate(ids, **kw)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(o is not None and torch.equal(o, want) for o in outs)


# ---------------------------------------------------------------------------
# the paged step without a plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_paged_step_without_a_plan_matches_jax(models, cache_dtype):
    """Two slots over shuffled pool pages and one inactive slot (null-page
    table, position 0): C > 1 chunks of the prompts, then C == 1 decode
    steps, against the JAX ``_paged_lm_logits``; the pools hold the same
    values afterwards."""
    jm, tm = models
    ids = _ids(3, 16, seed=6)
    tables = np.array([[7, 2, 9, 4], [3, 8, 1, 5], [0, 0, 0, 0]], np.int32)
    jc = jm.new_paged_kv_cache(10, 16, dtype=cache_dtype)
    tc = tm.new_paged_kv_cache(10, 16, dtype=cache_dtype)
    steps = [(0, 5), (5, 9), (9, 12)] + [(t, t + 1) for t in range(12, 16)]
    with torch.no_grad():
        for lo, hi in steps:
            pos = np.array([lo, lo, 0], np.int32)
            got = tm._paged_lm_logits(_t(ids[:, lo:hi]), tc, _t(tables),
                                      _t(pos)).numpy()
            want = jm._paged_lm_logits(to_tensor(ids[:, lo:hi]), jc,
                                       to_tensor(tables),
                                       to_tensor(pos)).numpy()
            assert got.shape == want.shape == (3, hi - lo, 1024)
            np.testing.assert_allclose(got, want, err_msg=f"step {lo}",
                                       **TOL[cache_dtype])
    for mine, theirs in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(mine.float().numpy(),
                                   np.asarray(theirs.numpy(), np.float32),
                                   **TOL[cache_dtype])


def test_paged_decode_without_a_plan_equals_the_contiguous_decode(models):
    """The same prompt through the paged step (chunked prefill, then C == 1
    decode) and through the contiguous cache gives the same logits."""
    _, tm = models
    ids = _ids(1, 10, seed=8)
    tc = tm.new_kv_cache(1, 64, dtype="float32")
    pc = tm.new_paged_kv_cache(6, 16, dtype="float32")
    tables = torch.tensor([[4, 1, 5, 2]], dtype=torch.int32)
    with torch.no_grad():
        a = tm._cached_lm_logits(_t(ids[:, :7]), tc, 0)
        b = tm._paged_lm_logits(_t(ids[:, :7]), pc, tables,
                                torch.tensor([0]))
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL["float32"])
        for t in range(7, 10):
            a = tm._cached_lm_logits(_t(ids[:, t:t + 1]), tc,
                                     torch.tensor(t))
            b = tm._paged_lm_logits(_t(ids[:, t:t + 1]), pc, tables,
                                    torch.tensor([t]))
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       **TOL["float32"])


# ---------------------------------------------------------------------------
# the CPU launches nothing; off the CPU a refused shape raises
# ---------------------------------------------------------------------------

def test_generation_on_the_cpu_launches_no_kernel(models):
    _, tm = models
    before = _launches()
    tm.generate(_ids(2, 6, seed=1), max_new_tokens=4, max_seq_len=32)
    pc = tm.new_paged_kv_cache(6, 16, dtype="float32")
    with torch.no_grad():
        for lo, hi in ((0, 3), (3, 4)):
            tm._paged_lm_logits(_t(_ids(2, 4, seed=2)[:, lo:hi]), pc,
                                torch.tensor([[1, 2], [3, 4]]),
                                torch.tensor([lo, lo]))
    assert _launches() == before


@pytest.mark.parametrize("step", ["prefill", "decode", "paged"])
def test_a_head_dim_the_kernels_refuse_raises_off_the_cpu(step):
    """Off the CPU each attention route is its kernel or an error: at
    head_dim 80 (which neither the flash nor the decode kernels take) the
    prefill, the decode step and the paged step raise ``ValueError``
    (meta tensors stand in for the card's) and nothing launches."""
    cfg = gpt_tiny(hidden_size=160, num_heads=2)
    m = GPTStackedForPretraining(cfg, device="cpu").to("meta")
    before = _launches()
    with torch.no_grad(), pytest.raises(ValueError, match="head_dim=80"):
        if step == "paged":
            pool = torch.empty((2, 4, 2, 16, 80), device="meta")
            cache = type("Pool", (), dict(paged=True, k=pool, v=pool))
            m(torch.zeros((2, 1), dtype=torch.long, device="meta"),
              kv_cache=cache, cache_index=torch.zeros(
                  2, dtype=torch.int32, device="meta"),
              page_tables=torch.zeros((2, 4), dtype=torch.int32,
                                      device="meta"))
        else:
            kv = torch.empty((2, 1, 2, 32, 80), device="meta")
            cache = type("Cache", (), dict(paged=False, k=kv, v=kv))
            s, pos = (5, 0) if step == "prefill" else (1, torch.zeros(
                (), dtype=torch.int32, device="meta"))
            m(torch.zeros((1, s), dtype=torch.long, device="meta"),
              kv_cache=cache, cache_index=pos)
    assert _launches() == before
