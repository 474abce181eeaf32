"""The port's layered GPT (``GPTForPretraining``) held against the JAX
package's on the CPU (``tests/test_generate.py``'s layered cases).

Both models start from the same weights: the JAX model's, with every bias
and LayerNorm gain perturbed off its 0/1 init, carried across by
``load_jax_state`` (every one of the 28 keys of ``gpt_tiny``).  Inputs
are numpy draws from fixed seeds.

- Logits equal the JAX model's in fp32, causal and under a boolean and
  an additive ``attn_mask``: within 2e-5 + 1e-5 relative (the same fp32
  arithmetic summed in another order).
- The first training step's loss (1e-6 relative) and every parameter's
  gradient (within 1e-5 of the largest gradient of each parameter) equal
  the JAX model's, at ``recompute_interval`` 0, 1 and 2, at seq 16 (the
  plain attention route) and at hidden 128, 2 heads, seq 128 (the flash
  gate passes: the flash kernels' plain versions here).  The gradients
  are held against the JAX model's without recompute: its eager
  ``fleet.recompute`` leaves the recomputed layers' parameters without a
  gradient (``grad`` None), where the port's checkpoint
  (``core.recompute``) gives the gradients the recompute must reproduce.
- The cached decode reproduces the full forward for fp32 and bf16 caches
  (the reference's tolerances: 5e-5 and 0.08 absolute, 1e-2 relative),
  and the chunked prefill does too (5e-5, 1e-4).
- Greedy ``generate()`` gives the JAX tokens; its logits equal the full
  forward's.  Sampling is checked by property (reproducible from one
  generator seed, in vocabulary, top-k 1 is greedy, every token within
  the top k of its logits).
- ``quantize_for_serving`` swaps the four projections of every layer for
  ``Int8Linear``: the buffers equal the JAX ones bit for bit, under the
  same keys, and the quantized logits equal the JAX quantized model's
  (2e-4 absolute: an activation on a rounding tie may quantize to the
  other integer); a quantized JAX ``state_dict`` loads.
- ``truncated_draft`` copies the first layers by key, quantized or not.
- Dropout: recompute on and off draw the same masks (the per-layer seeds)
  and give the same bits; under ``auto_cast`` O1 the recompute casts as
  the forward did."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models import truncated_draft as jax_truncated_draft
from paddle_tpu.quantization import quantize_for_serving as jax_quantize

from paddle_tpu_torch import amp
from paddle_tpu_torch.models import (
    GPTForPretraining, GPTPretrainingCriterion, gpt_tiny, truncated_draft,
)
from paddle_tpu_torch.quantization import Int8Linear, quantize_for_serving

torch.set_num_threads(2)

NO_DROP = dict(hidden_dropout=0.0, attention_dropout=0.0)
FLASH = dict(hidden_size=128, num_heads=2)


def jax_state(seed=0, **cfg):
    pt.seed(seed)
    m = JaxGPT(jax_gpt_tiny(**NO_DROP, **cfg))
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in m.state_dict().items():
        a = np.asarray(v.numpy(), np.float32)
        if k.endswith(("bias", "ln1.weight", "ln2.weight", "final_ln.weight")):
            a = a + 0.1 * rng.randn(*a.shape).astype(np.float32)
        out[k] = a
    return out


def jax_model(state, **cfg):
    m = JaxGPT(jax_gpt_tiny(**{**NO_DROP, **cfg}))
    m.set_state_dict(state)
    m.eval()
    return m


def port_model(state, dtype="float32", **cfg):
    m = GPTForPretraining(gpt_tiny(**{**NO_DROP, **cfg}), device="cpu",
                          dtype=dtype)
    m.load_jax_state(state)
    m.eval()
    return m


@pytest.fixture(scope="module")
def state():
    return jax_state(0)


def _ids(b, s, seed):
    return np.random.RandomState(seed).randint(0, 1024, (b, s))


def _jt(a):
    return pt.to_tensor(a, dtype="int64")


def test_parameter_names_are_the_jax_state_dict_keys(state):
    m = GPTForPretraining(gpt_tiny(), device="cpu")
    assert len(state) == 28
    assert set(dict(m.named_parameters())) == set(state)
    assert not m.stacked and m.gpt.layers[1] is m.gpt.layer_1


@pytest.mark.parametrize("mask", ["causal", "bool", "additive"])
def test_logits_match_jax(state, mask):
    ids = _ids(2, 12, 1)
    m = None
    if mask == "bool":
        m = np.tril(np.ones((12, 12), bool))
        m[:, :2] = True          # a non-causal pattern the mask must carry
        m = m[None, None]
    elif mask == "additive":
        m = np.where(np.random.RandomState(2).rand(2, 1, 12, 12) < 0.3,
                     -1e9, 0.0).astype(np.float32)
    want = np.asarray(jax_model(state)(
        _jt(ids), attn_mask=None if m is None else pt.to_tensor(m)).numpy())
    with torch.no_grad():
        got = port_model(state)(
            torch.from_numpy(ids),
            attn_mask=None if m is None else torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("shape", ["plain", "flash"])
@pytest.mark.parametrize("recompute_interval", [0, 1, 2])
def test_loss_and_gradients_match_jax(shape, recompute_interval):
    cfg = dict(FLASH) if shape == "flash" else {}
    seq = 128 if shape == "flash" else 16
    st = jax_state(3, **cfg)
    ids, labels = _ids(2, seq, 4), _ids(2, seq, 5)
    jloss = {}
    for k in {0, recompute_interval}:
        jm = jax_model(st, recompute_interval=k, **cfg)
        jm.train()
        jloss[k] = JaxCriterion()(jm(_jt(ids)), _jt(labels))
        if k == 0:
            jloss[k].backward()
            jgrads = {n: np.asarray(p.grad.numpy(), np.float32)
                      for n, p in jm.named_parameters()}
    jloss = jloss[recompute_interval]
    tm = port_model(st, recompute_interval=recompute_interval, **cfg)
    tm.train()
    tloss = GPTPretrainingCriterion()(tm(torch.from_numpy(ids)),
                                      torch.from_numpy(labels))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-6)
    tgrads = dict(tm.named_parameters())
    assert set(tgrads) == set(jgrads)
    for name, want in jgrads.items():
        np.testing.assert_allclose(tgrads[name].grad.numpy(), want,
                                   rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("cache_dtype,atol", [("float32", 5e-5),
                                              ("bfloat16", 0.08)])
def test_cached_decode_matches_full_forward(state, cache_dtype, atol):
    m = port_model(state)
    ids = torch.from_numpy(_ids(2, 12, 6))
    with torch.no_grad():
        full = m(ids).numpy()
        cache = m.new_kv_cache(2, 64, dtype=cache_dtype)
        assert not cache.stacked and len(cache.k) == 2
        pre = m(ids[:, :8], kv_cache=cache, cache_index=0).numpy()
        np.testing.assert_allclose(pre, full[:, :8], rtol=1e-2, atol=atol)
        for t in range(8, 12):
            step = m(ids[:, t:t + 1], kv_cache=cache,
                     cache_index=torch.tensor(t)).numpy()
            np.testing.assert_allclose(step[:, 0], full[:, t], rtol=1e-2,
                                       atol=atol)


def test_chunked_prefill_matches_full_forward(state):
    m = port_model(state)
    ids = torch.from_numpy(_ids(2, 12, 7))
    with torch.no_grad():
        full = m(ids).numpy()
        cache = m.new_kv_cache(2, 64, dtype="float32")
        m(ids[:, :4], kv_cache=cache, cache_index=0)
        mid = m(ids[:, 4:9], kv_cache=cache, cache_index=4).numpy()
        tail = m(ids[:, 9:], kv_cache=cache,
                 cache_index=torch.tensor(9)).numpy()
    np.testing.assert_allclose(mid, full[:, 4:9], rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(tail, full[:, 9:], rtol=1e-4, atol=5e-5)


def test_greedy_generate_matches_jax(state):
    ids = _ids(2, 6, 8)
    want = np.asarray(jax_model(state).generate(
        _jt(ids), max_new_tokens=8, max_seq_len=64,
        cache_dtype="float32").numpy())
    m = port_model(state)
    out, logits = m.generate(ids, 8, max_seq_len=64, cache_dtype="float32",
                             return_logits=True)
    np.testing.assert_array_equal(out.numpy(), want)
    with torch.no_grad():
        full = m(out).numpy()
    for i in range(8):
        np.testing.assert_allclose(logits[:, i].numpy(), full[:, 5 + i],
                                   rtol=1e-4, atol=5e-5)
    np.testing.assert_array_equal(out[:, 6:].numpy(),
                                  logits.argmax(-1).numpy())


def test_sampling_properties(state):
    m = port_model(state)
    ids = _ids(2, 6, 9)
    kw = dict(max_seq_len=64, cache_dtype="float32", do_sample=True,
              temperature=0.8)
    draws = [m.generate(ids, 6, top_k=5, return_logits=True,
                        generator=torch.Generator().manual_seed(7), **kw)
             for _ in range(2)]
    out, logits = draws[0]
    assert torch.equal(out, draws[1][0])
    assert bool(((out >= 0) & (out < 1024)).all())
    # every sampled token is within the top 5 of its own logits
    top5 = logits.topk(5, dim=-1).indices
    assert bool((top5 == out[:, 6:, None]).any(-1).all())
    greedy = m.generate(ids, 6, max_seq_len=64, cache_dtype="float32")
    k1 = m.generate(ids, 6, top_k=1, generator=torch.Generator().manual_seed(3),
                    **kw)
    assert torch.equal(k1, greedy)


def test_quantize_for_serving_matches_jax(state):
    jm = jax_quantize(jax_model(state))
    tm = quantize_for_serving(port_model(state))
    assert quantize_for_serving(tm) is tm and tm.weight_int8
    assert all(isinstance(getattr(owner, n), Int8Linear)
               for layer in tm.gpt.layers
               for owner, n in ((layer.attn, "qkv_proj"),
                                (layer.attn, "out_proj"), (layer.mlp, "fc1"),
                                (layer.mlp, "fc2")))
    js = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    ts = {k: v.numpy() for k, v in tm.state_dict().items()}
    assert set(js) == set(ts)
    quantized = [k for k in js if k.endswith(("int8", "scale"))]
    assert len(quantized) == 2 * 4 * 2 + 2
    for k in quantized:
        assert ts[k].dtype == js[k].dtype, k
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    ids = _ids(2, 12, 10)
    want = np.asarray(jm(_jt(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-4)
    # a quantized JAX state_dict loads into a fresh model
    fresh = GPTForPretraining(gpt_tiny(**NO_DROP), device="cpu")
    fresh.load_jax_state(js)
    fresh.eval()
    assert fresh.weight_int8
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(torch.from_numpy(ids)).numpy(),
                                      got)
    with pytest.raises(ValueError, match="quantized"):
        fresh.load_jax_state(state)


@pytest.mark.parametrize("quantized", [False, True])
def test_truncated_draft_copies_the_first_layers(state, quantized):
    jm, tm = jax_model(state), port_model(state)
    if quantized:
        jax_quantize(jm)
        quantize_for_serving(tm)
    jd, td = jax_truncated_draft(jm, 1), truncated_draft(tm, 1)
    assert td.config.num_layers == 1 and td.weight_int8 == quantized
    ts = {k: v.numpy() for k, v in td.state_dict().items()}
    assert not any(k.startswith("gpt.layer_1.") for k in ts)
    src = {k: v.numpy() for k, v in tm.state_dict().items()}
    for k, v in ts.items():
        np.testing.assert_array_equal(v, src[k], err_msg=k)
    if not quantized:
        # the JAX draft of the fp model holds the same weights
        js = {k: np.asarray(v.numpy()) for k, v in jd.state_dict().items()}
        assert set(js) == set(ts)
        for k in js:
            np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


def _train_grads(m, ids, labels, o1=False):
    m.zero_grad()
    ctx = amp.auto_cast(level="O1") if o1 else amp.auto_cast(enable=False)
    with ctx:
        loss = GPTPretrainingCriterion()(m(ids), labels)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                                  for n, p in m.named_parameters()}


@pytest.mark.parametrize("o1", [False, True])
def test_recompute_redraws_the_same_masks(state, o1):
    """One generator seed, recompute on and off: the same loss and
    gradients, bit for bit (dropout 0.1 on every site)."""
    ids = torch.from_numpy(_ids(2, 16, 11))
    labels = torch.from_numpy(_ids(2, 16, 12))
    runs = []
    for k in (0, 1):
        m = GPTForPretraining(gpt_tiny(recompute_interval=k), device="cpu",
                              generator=torch.Generator().manual_seed(5))
        m.load_jax_state(state)
        m.train()
        runs.append(_train_grads(m, ids, labels, o1))
    (l0, g0), (l1, g1) = runs
    assert l0 == l1
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    # the masks are real: eval gives another loss
    m.eval()
    with torch.no_grad():
        ev = float(GPTPretrainingCriterion()(m(ids), labels))
    assert ev != l0
