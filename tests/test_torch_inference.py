"""The port's ``inference`` Predictor held against the JAX package's on
the CPU (``tests/test_generate.py:369-415``, ``tests/test_serving.py:
821-932``, ``tests/test_serving_faults.py:519-555``), over a live layered
GPT at ``gpt_tiny`` carrying the JAX model's weights.

- Decode mode: the output handle gives ``model.generate()``'s tokens, and
  the JAX Predictor's; serving mode gives ``generate()``'s tokens too
  (fp32 caches), rows stopped early on eos padded with it.
- The refusals: a mode without a live model, a live model without a
  mode, the two modes together, a saved program (not ported: ROADMAP.md
  queue 1, item 10), ``disable_gpu()`` with a model on the card (the
  Predictor never moves the model).
- ``PredictorPool``: concurrent acquire/run/release from 6 threads over 3
  predictors gives the serial tokens every time and never hands one
  predictor out twice; the release guards and the context manager.
- Serving mode's fault surface: a mid-batch ``Overloaded`` leaves no row
  queued in the shared engine; an expired deadline re-raises
  ``DeadlineExceeded``."""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import inference as jax_inference
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny

from paddle_tpu_torch import inference
from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny
from paddle_tpu_torch.serving import DeadlineExceeded, Overloaded

torch.set_num_threads(2)

DECODE = dict(max_new_tokens=5, max_seq_len=64, cache_dtype="float32")


@pytest.fixture(scope="module")
def models():
    pt.seed(2)
    jm = JaxGPT(jax_gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0))
    jm.eval()
    tm = GPTForPretraining(gpt_tiny(), device="cpu")
    tm.load_jax_state({k: np.asarray(v.numpy())
                       for k, v in jm.state_dict().items()})
    tm.eval()
    return jm, tm


def _ids(b=2, s=6, seed=0):
    return np.random.RandomState(seed).randint(0, 1024, (b, s))


def _run(config, ids):
    p = config if isinstance(config, inference.Predictor) else \
        inference.create_predictor(config)
    h = p.get_input_handle(p.get_input_names()[0])
    h.copy_from_cpu(ids)
    assert p.run() is True
    return p.get_output_handle(p.get_output_names()[0]).copy_to_cpu()


def test_decode_mode_matches_generate_and_jax(models):
    jm, tm = models
    ids = _ids()
    ref = tm.generate(ids, **DECODE).numpy()
    config = inference.Config().set_causal_lm_model(tm)
    config.enable_causal_lm_decode(**DECODE)
    assert "causal_lm_decode" in config.summary()
    out = _run(config, ids)
    np.testing.assert_array_equal(out, ref)
    jconfig = jax_inference.Config().set_causal_lm_model(jm)
    jconfig.enable_causal_lm_decode(**DECODE)
    jp = jax_inference.create_predictor(jconfig)
    jp.get_input_handle("x0").copy_from_cpu(ids)
    jp.run()
    np.testing.assert_array_equal(
        out, jp.get_output_handle(jp.get_output_names()[0]).copy_to_cpu())
    # run(inputs) binds x0 and returns the outputs
    got = inference.create_predictor(config).run([torch.from_numpy(ids)])
    np.testing.assert_array_equal(got[0].numpy(), ref)


def test_serving_mode_matches_generate(models):
    _, tm = models
    ids = _ids(b=3)
    ref = tm.generate(ids, **DECODE).numpy()
    config = inference.Config().set_causal_lm_model(tm)
    config.enable_serving_mode(max_new_tokens=5, num_slots=4, page_size=16,
                               max_context=64, cache_dtype="float32")
    assert "serving_mode" in config.summary()
    np.testing.assert_array_equal(_run(config, ids), ref)
    # one engine per Config, shared by its predictors
    eng = config._get_serving_engine()
    np.testing.assert_array_equal(_run(config, ids[:1]), ref[:1])
    assert config._get_serving_engine() is eng
    assert eng.metrics()["pages_used"] == 0


def test_serving_mode_pads_with_eos(models):
    _, tm = models
    ids = _ids(b=2)
    ref = tm.generate(ids, **DECODE).numpy()
    eos = int(ref[0, 7])                   # row 0's second generated token
    config = inference.Config().set_causal_lm_model(tm)
    config.enable_serving_mode(max_new_tokens=5, page_size=16,
                               max_context=64, cache_dtype="float32",
                               eos_token_id=eos)
    out = _run(config, ids)
    want = tm.generate(ids, eos_token_id=eos, **DECODE).numpy()
    np.testing.assert_array_equal(out, want)
    assert (out[0, 8:] == eos).all()


def test_refusals(models, tmp_path):
    _, tm = models
    config = inference.Config(str(tmp_path / "nope"))
    config.enable_causal_lm_decode(max_new_tokens=2)
    with pytest.raises(RuntimeError, match="live model"):
        inference.create_predictor(config)
    config = inference.Config(str(tmp_path / "nope"))
    config.enable_serving_mode(max_new_tokens=2)
    with pytest.raises(RuntimeError, match="live model"):
        inference.create_predictor(config)
    with pytest.raises(RuntimeError, match="enable_causal_lm_decode"):
        inference.create_predictor(
            inference.Config().set_causal_lm_model(tm))
    both = inference.Config().set_causal_lm_model(tm)
    both.enable_serving_mode(max_new_tokens=2)
    with pytest.raises(RuntimeError, match="mutually exclusive"):
        both.enable_causal_lm_decode(max_new_tokens=2)
    both = inference.Config().set_causal_lm_model(tm)
    both.enable_causal_lm_decode(max_new_tokens=2)
    with pytest.raises(RuntimeError, match="mutually exclusive"):
        both.enable_serving_mode(max_new_tokens=2)
    with pytest.raises(NotImplementedError, match="queue 1, item 10"):
        inference.create_predictor(inference.Config(str(tmp_path / "prog")))


class _CardModel:
    """A live model that reports a card device (no card is needed to see
    the refusal)."""
    device = torch.device("cuda")

    def generate(self, ids, **kw):
        raise AssertionError("the Predictor ran a model it must refuse")


def test_disable_gpu_never_moves_the_model(models):
    _, tm = models
    config = inference.Config().set_causal_lm_model(_CardModel())
    config.enable_causal_lm_decode(max_new_tokens=2)
    assert config.use_gpu()
    config.disable_gpu()
    assert not config.use_gpu() and "device: cpu" in config.summary()
    with pytest.raises(RuntimeError, match="never moves"):
        inference.create_predictor(config)
    # a model on the CPU runs with the card disabled or enabled
    ids = _ids()
    cpu = inference.Config().set_causal_lm_model(tm)
    cpu.enable_causal_lm_decode(**DECODE)
    cpu.disable_gpu()
    np.testing.assert_array_equal(_run(cpu, ids),
                                  tm.generate(ids, **DECODE).numpy())


def test_inert_knobs_are_recorded(models, capsys):
    config = inference.Config()
    config.switch_ir_optim(False)
    config.enable_memory_optim()
    config.set_cpu_math_library_num_threads(4)
    config.switch_ir_optim(True)
    s = config.summary()
    assert "ir_optim: True" in s and "cpu_threads: 4" in s
    assert capsys.readouterr().err.count("ir_optim") == 1


def _pool(tm, size):
    config = inference.Config().set_causal_lm_model(tm)
    config.enable_causal_lm_decode(max_new_tokens=4, max_seq_len=64,
                                   cache_dtype="float32")
    return inference.PredictorPool(config, size)


def test_predictor_pool_concurrent_acquire_run_release(models):
    _, tm = models
    ids = _ids()
    ref = tm.generate(ids, 4, max_seq_len=64, cache_dtype="float32").numpy()
    pool = _pool(tm, 3)
    in_flight, lock, errors, results = set(), threading.Lock(), [], []

    def work():
        try:
            for _ in range(3):
                p = pool.acquire(timeout=60)
                with lock:
                    assert id(p) not in in_flight, "predictor handed twice"
                    in_flight.add(id(p))
                try:
                    results.append(p.run([ids])[0].numpy())
                finally:
                    with lock:
                        in_flight.discard(id(p))
                    pool.release(p)
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(results) == 18
    for out in results:
        np.testing.assert_array_equal(out, ref)


def test_predictor_pool_release_guards(models):
    _, tm = models
    pool = _pool(tm, 2)
    assert pool.size == 2 and pool.retrive(1) is pool.retrieve(1)
    p = pool.acquire()
    pool.release(p)
    with pytest.raises(ValueError, match="not checked out"):
        pool.release(p)
    a, b = pool.acquire(), pool.acquire()
    with pytest.raises(TimeoutError):
        pool.acquire(timeout=0.05)
    pool.release(a)
    pool.release(b)
    with pool.predictor() as q:
        assert q is not None
    with pytest.raises(ValueError, match=">= 1"):
        inference.PredictorPool(inference.Config(), 0)


def test_serving_overload_does_not_strand_queued_rows(models):
    _, tm = models
    config = inference.Config().set_causal_lm_model(tm)
    config.enable_serving_mode(max_new_tokens=4, num_slots=2, page_size=16,
                               max_context=64, cache_dtype="float32",
                               max_queue_depth=2)
    predictor = inference.create_predictor(config)
    predictor.get_input_handle("x0").copy_from_cpu(_ids(b=4, s=5))
    with pytest.raises(Overloaded):
        predictor.run()
    eng = config._get_serving_engine()
    assert eng.queue.depth == 0, "shed batch left rows queued"
    assert eng.allocator.used_pages == 0


def test_serving_deadline_surfaces_typed(models):
    _, tm = models
    config = inference.Config().set_causal_lm_model(tm)
    config.enable_serving_mode(max_new_tokens=4, num_slots=2, page_size=16,
                               max_context=64, cache_dtype="float32",
                               deadline_s=0.001)
    predictor = inference.create_predictor(config)
    predictor.get_input_handle("x0").copy_from_cpu(_ids(b=1))
    with pytest.raises(DeadlineExceeded):
        predictor.run()
