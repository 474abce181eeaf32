"""Generation and serving from a model placed on a training mesh (the
port's ``GPTStackedForPretraining`` under ``train_mesh`` and
``GPTForPretraining`` under ``layered_tp``), held against the JAX package
on the CPU.  The JAX models run under the same mesh on the 8 forced host
devices of ``tests/conftest.py``; the port's are placed on ``["cpu"] *
n`` (every position on one device).  Each side loads the same numpy
weights, every bias and LayerNorm gain moved off its init so that a shard
holding the wrong heads gives other logits.

- ``generate(..., return_logits=True)`` of the stacked GPT at ``{"pp":
  2}``, ``{"mp": 2}`` and ``{"dp": 2, "pp": 2, "mp": 2}``, and of the
  layered GPT at ``{"mp": 2}``: tokens equal, logits within fp32 rtol and
  atol 1e-5; the caches hold each layer cut by heads on its stage.
- ``ServingEngine`` at those meshes, from bf16 and from int8 pools: the
  JAX engine's tokens under the same mesh, every page back.
- Int8 weights at ``{"pp": 2}``: each stage's slabs bit-equal to the
  unplaced quantized model's, and the served tokens the JAX engine's.
- Fault 9: quantizing a ``use_tensor_parallel`` model, and the stacked
  model under a mesh with mp > 1, raise the reference's ``ValueError``
  with its words; sp > 1 raises ``ValueError`` at generation and
  serving, as the reference fails.
- ZeRO at ``os`` and ``p_g_os``: the unplaced model's tokens, nothing
  left gathered after.  Training after generation and serving gives the
  bits of training without them.
"""
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.distributed import mesh as JM
from paddle_tpu.models import GPTForPretraining as JaxLayered
from paddle_tpu.models import GPTStackedForPretraining as JaxStacked
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.quantization import quantize_for_serving as jax_quantize
from paddle_tpu.serving import ServingEngine as JaxEngine

from paddle_tpu_torch.distributed import mesh as M
from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
from paddle_tpu_torch.models import (
    GPTForPretraining, GPTStackedForPretraining, gpt_tiny,
)
from paddle_tpu_torch.optimizer import AdamW, FusedTrainStep
from paddle_tpu_torch.quantization import quantize_for_serving
from paddle_tpu_torch.serving import ServingEngine

torch.set_num_threads(2)

CFG = dict(num_layers=4, hidden_dropout=0.0, attention_dropout=0.0)
CLASSES = {"stacked": (JaxStacked, GPTStackedForPretraining),
           "layered": (JaxLayered, GPTForPretraining)}
STACKED_MESHES = [{"pp": 2}, {"mp": 2}, {"dp": 2, "pp": 2, "mp": 2}]
GEN = dict(max_seq_len=32, cache_dtype="float32", return_logits=True)
ENG = dict(num_slots=2, page_size=16, max_context=64)
POOLS = {"bfloat16": dict(cache_dtype="bfloat16"),
         "int8": dict(kv_dtype="int8")}


@contextmanager
def meshes(axes):
    """The JAX package's and the port's global meshes over ``axes``."""
    JM.set_mesh(JM.build_mesh(axes))
    M.set_mesh(M.build_mesh(axes, ["cpu"] * 8))
    try:
        yield
    finally:
        JM.set_mesh(None)
        M.set_mesh(None)


def _cfg(tp, jax=False):
    return (jax_gpt_tiny if jax else gpt_tiny)(
        **CFG, use_tensor_parallel=tp)


_STATES: dict = {}


def _state(kind, tp=False):
    """The unplaced JAX model's weights, biases and gains perturbed."""
    key = (kind, tp)
    if key not in _STATES:
        pt.seed(0)
        m = CLASSES[kind][0](_cfg(tp, jax=True))
        rng = np.random.RandomState(1)
        out = {}
        for k, v in m.state_dict().items():
            a = np.asarray(v.numpy(), np.float32)
            if k.endswith(("bias", "_b", "_g", "ln1.weight", "ln2.weight",
                           "final_ln.weight")):
                a = a + 0.1 * rng.randn(*a.shape).astype(np.float32)
            out[k] = a
        _STATES[key] = out
    return _STATES[key]


def _jax(kind, tp=False):
    """The JAX model on the current JAX mesh, carrying the state."""
    m = CLASSES[kind][0](_cfg(tp, jax=True))
    m.set_state_dict(_state(kind, tp))
    m.eval()
    return m


def _port(kind, tp=False, **kw):
    """The port's model, placed on the current mesh (or unplaced with
    ``device="cpu"``), carrying the state."""
    m = CLASSES[kind][1](_cfg(tp), **kw)
    m.load_jax_state(_state(kind, tp))
    m.eval()
    return m


def _ids(seed=0, shape=(2, 6)):
    return np.random.RandomState(seed).randint(0, 1024, shape)


def _prompts():
    rng = np.random.RandomState(5)
    return [rng.randint(0, 1024, (n,)) for n in (3, 17, 9)]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _generate_both(kind, axes, tp=False):
    ids = _ids()
    with meshes(axes):
        jout, jlg = _jax(kind, tp).generate(ids, 5, **GEN)
        m = _port(kind, tp)
        out, lg = m.generate(ids, 5, **GEN)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout.numpy()))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg.numpy()),
                               rtol=1e-5, atol=1e-5)
    return m


@pytest.mark.parametrize("axes", STACKED_MESHES,
                         ids=lambda a: "x".join(f"{k}{v}" for k, v in
                                                a.items()))
def test_stacked_generate_matches_jax_on_mesh(axes):
    m = _generate_both("stacked", axes)
    tm = m._train_mesh
    cache = m.new_kv_cache(2, 32, dtype="float32")
    heads = m.config.num_heads // tm.mp
    # one stacked cache a stage and shard, on the shard's device
    assert [g[0] for g in cache.groups] == [tuple(x) for x in tm.layers]
    for (_, subs), s in zip(cache.groups, range(tm.pp)):
        assert [c.device for c in subs] == list(tm.grid[0, s])
        assert all(tuple(c.k.shape) == (len(tm.layers[s]), 2, heads, 32, 16)
                   for c in subs)
    assert cache.nbytes == m.config.num_layers * 2 * 2 * 4 * 32 * 16 * 4


def test_layered_generate_matches_jax_on_mp_mesh():
    m = _generate_both("layered", {"mp": 2}, tp=True)
    cache = m.new_paged_kv_cache(5, 16, dtype="int8")
    kp, vp, ks, vs = cache.layer_shards(1)[1]
    assert tuple(kp.shape) == (5, 2, 16, 16) and tuple(ks.shape) == (5, 2)
    with pytest.raises(ValueError, match="layer_shards"):
        cache.layer(0)


@pytest.mark.parametrize("pool", sorted(POOLS))
@pytest.mark.parametrize("kind, axes", [
    ("stacked", {"pp": 2}), ("stacked", {"mp": 2}),
    ("stacked", {"dp": 2, "pp": 2, "mp": 2}), ("layered", {"mp": 2})],
    ids=["stacked-pp2", "stacked-mp2", "stacked-dp2pp2mp2", "layered-mp2"])
def test_serving_matches_jax_on_mesh(kind, axes, pool):
    tp = kind == "layered"
    prompts = _prompts()
    with meshes(axes):
        want = JaxEngine(_jax(kind, tp), **ENG,
                         **POOLS[pool]).generate_batch(prompts, 5)
        eng = ServingEngine(_port(kind, tp), **ENG, **POOLS[pool])
        got = eng.generate_batch(prompts, 5)
    _same(got, want)
    assert eng.cache.groups is not None and eng.metrics()["pages_used"] == 0
    assert eng.allocator.free_pages == eng.allocator.capacity


def test_int8_weights_on_pp_mesh():
    """At mp = 1 each stage quantizes its slabs on its device: the values
    are the unplaced quantized model's bit for bit, and the int8 serve is
    the JAX engine's under the same mesh."""
    whole = quantize_for_serving(_port("stacked", device="cpu"))
    prompts = _prompts()
    with meshes({"pp": 2}):
        want = JaxEngine(_jax("stacked"), kv_dtype="int8", weight_dtype="int8",
                         **ENG).generate_batch(prompts, 5)
        m = _port("stacked")
        eng = ServingEngine(m, kv_dtype="int8", weight_dtype="int8", **ENG)
        got = eng.generate_batch(prompts, 5)
    _same(got, want)
    tm = m._train_mesh
    for st, layers in enumerate(tm.layers):
        for name in m.decoder.QUANTIZED:
            for key in (name + "_int8", name + "_s"):
                t = m.decoder.stage_int8[st][key]
                assert t.device == tm.dev(0, st)
                assert torch.equal(t, getattr(whole.decoder, key)[layers])
    assert torch.equal(m.placed_head_int8[0], whole.lm_head_int8)
    assert torch.equal(m.placed_head_int8[1], whole.lm_head_scale)
    # a quantized placed model serves only; its state dict is its fp one
    assert set(m.state_dict()) == set(_state("stacked"))
    with pytest.raises(ValueError, match="quantized for serving"):
        m(torch.from_numpy(_ids()), labels=torch.from_numpy(_ids()))


def _jax_error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_fault9_quantizing_tensor_parallel_raises(kind):
    """Fault 9: the port quantized a ``use_tensor_parallel`` model (and
    served it with int8 weights) where the reference raises."""
    words = _jax_error(lambda: jax_quantize(CLASSES[kind][0](
        _cfg(True, jax=True))))
    m = CLASSES[kind][1](_cfg(True), device="cpu")
    for fn in (lambda: quantize_for_serving(m), m.quantize_weights,
               lambda: ServingEngine(m, weight_dtype="int8", **ENG)):
        with pytest.raises(ValueError) as info:
            fn()
        assert str(info.value) == words
    assert not m.weight_int8


def test_stacked_quantize_under_mp_mesh_raises():
    with meshes({"mp": 2}):
        words = _jax_error(lambda: jax_quantize(_jax("stacked")))
        m = GPTStackedForPretraining(_cfg(False))
        with pytest.raises(ValueError) as info:
            m.quantize_weights()
    assert str(info.value) == words and not m.weight_int8


def test_sequence_parallel_generation_raises():
    """One token does not split over sp: the reference fails at its first
    decode step with a ``ValueError``; the port refuses generation and
    serving with one naming sp."""
    cfg = gpt_tiny(sequence_parallel=True, hidden_dropout=0.0,
                   attention_dropout=0.0)
    JM.set_mesh(JM.build_mesh({"dp": 1, "sp": 2}))
    try:
        jm = JaxLayered(jax_gpt_tiny(sequence_parallel=True,
                                     hidden_dropout=0.0,
                                     attention_dropout=0.0))
        with pytest.raises(ValueError):
            jm.generate(_ids(), 2, max_seq_len=32)
    finally:
        JM.set_mesh(None)
    for devices in (["cpu"] * 2, ["cpu:0", "cpu:1"]):
        M.set_mesh(M.build_mesh({"sp": 2}, devices))
        try:
            m = GPTForPretraining(cfg, device="cpu")
            for fn in (lambda: m.generate(_ids(), 2, max_seq_len=32),
                       lambda: ServingEngine(m, **ENG),
                       m.quantize_weights):
                with pytest.raises(ValueError, match="sp=2"):
                    fn()
        finally:
            M.set_mesh(None)


@pytest.mark.parametrize("level", ["os", "p_g_os"])
def test_generation_under_zero(level):
    """A model under ``group_sharded_parallel`` generates and serves
    through the same forward: at ``p_g_os`` each call gathers its parts
    and frees them after."""
    ids = _ids()
    jm = _jax("stacked")
    jout, jlg = jm.generate(ids, 5, **GEN)
    want = JaxEngine(jm, **ENG, cache_dtype="float32").generate_batch(
        _prompts(), 5)
    M.set_mesh(M.build_mesh({"pp": 2, "sharding": 2}, ["cpu"] * 4))
    try:
        m = _port("stacked")
        opt = AdamW(1e-3, parameters=m.parameters())
        m, opt, _ = group_sharded_parallel(m, opt, level)
        out, lg = m.generate(ids, 5, **GEN)
        got = ServingEngine(m, **ENG, cache_dtype="float32").generate_batch(
            _prompts(), 5)
    finally:
        M.set_mesh(None)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout.numpy()))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg.numpy()),
                               rtol=1e-5, atol=1e-5)
    _same(got, want)
    held = [p.untyped_storage().nbytes() for p in m.parameters()]
    assert (not any(held)) if level == "p_g_os" else all(held)


def _train_run(generate_between):
    """Two AdamW steps of the placed (2, 2, 2) model, with a generate and
    a serve between them or not: the losses, weights and moments."""
    ids = torch.from_numpy(_ids(3, (4, 8)))
    m = _port("stacked", tp=True, n_micro=2)
    m.train()
    step = FusedTrainStep(lambda i, lab: m(i, labels=lab),
                          AdamW(1e-3, parameters=m.parameters()))
    losses = [step(ids, ids)]
    if generate_between:
        m.generate(_ids(), 3, max_seq_len=32)
        ServingEngine(m, **ENG).generate_batch(_prompts(), 3)
        assert m.training
    losses.append(step(ids, ids))
    grads = [p.grad for p in m.parameters()]
    return losses, m.state_dict(), step._optimizer.state_dict(), grads


def test_training_after_generation():
    with meshes({"dp": 2, "pp": 2, "mp": 2}):
        base = _train_run(False)
        after = _train_run(True)
    for a, b in zip(base[0], after[0]):
        assert torch.equal(a, b)
    for want, got in ((base[1], after[1]), (base[2], after[2])):
        assert set(want) == set(got)
        for k, v in want.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, got[k]), k
    assert all(g is None for g in after[3])
