"""``io.DevicePrefetcher`` held against the JAX package's on the CPU (the
port of ``tests/test_train_perf.py::TestDevicePrefetcher``): the same
source gives the same batches in the same order (values equal, numpy
leaves as tensors, other leaves passed through), one stall observation
per batch in the ``train_input_stall_seconds`` histogram, a source error
raised in the consumer, ``close()`` retiring the producer, an invalid
depth refused, and a mesh placement (``sharding=``) refused naming its
roadmap item.  On the CPU the port copies each numpy leaf into a CPU
tensor (``device="cpu"``); the card's side-stream copies are
``chip_smoke.py``'s."""
import numpy as np
import pytest
import torch

from paddle_tpu.io import DevicePrefetcher as JaxPrefetcher

from paddle_tpu_torch.io import DevicePrefetcher
from paddle_tpu_torch.telemetry import registry

torch.set_num_threads(2)


def _source():
    for i in range(5):
        yield {"x": np.full((2,), i, np.float32),
               "pair": (np.int64(i), [np.float32(i)]),
               "ids": np.arange(3) + i}


def _as_numpy(b):
    if isinstance(b, dict):
        return {k: _as_numpy(v) for k, v in b.items()}
    if isinstance(b, (list, tuple)):
        return type(b)(_as_numpy(v) for v in b)
    if isinstance(b, torch.Tensor):
        return b.numpy()
    if hasattr(b, "_value"):
        return np.asarray(b._value)
    return np.asarray(b)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_order_values_and_stats_match_jax(depth):
    want = [_as_numpy(b) for b in JaxPrefetcher(_source(), depth=depth)]
    pf = DevicePrefetcher(_source(), depth=depth, device="cpu")
    got = list(pf)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert isinstance(g["x"], torch.Tensor) and g["x"].device.type == "cpu"
        assert isinstance(g["pair"], tuple) and isinstance(g["pair"][1], list)
        gn = _as_numpy(g)
        np.testing.assert_array_equal(gn["x"], w["x"])
        np.testing.assert_array_equal(gn["ids"], w["ids"])
        assert gn["pair"][0] == w["pair"][0]
    st = pf.stats()
    assert st["batches"] == 5 and st["stall_seconds_total"] >= 0.0
    assert set(st) == {"batches", "stall_seconds_total",
                       "stall_seconds_mean"}


def test_stall_histogram_records_per_batch():
    hist = registry().histogram("train_input_stall_seconds")
    before = hist.summary().get("count", 0)
    pf = DevicePrefetcher((np.zeros((2,), np.float32) for _ in range(4)),
                          depth=1, device="cpu")
    assert sum(1 for _ in pf) == 4
    assert hist.summary().get("count", 0) - before == 4


def test_source_error_propagates():
    def gen():
        yield np.zeros((2,), np.float32)
        raise RuntimeError("boom in source")

    pf = DevicePrefetcher(gen(), depth=2, device="cpu")
    next(pf)
    with pytest.raises(RuntimeError, match="boom in source"):
        for _ in pf:
            pass


def test_early_close_releases_producer():
    pf = DevicePrefetcher((np.full((2,), i, np.float32) for i in range(100)),
                          depth=2, device="cpu")
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)
    with DevicePrefetcher(iter([np.ones(2)]), device="cpu") as pf2:
        next(pf2)
    assert not pf2._thread.is_alive()


def test_wrap_tensors_false_still_yields_tensors():
    """The reference's ``wrap_tensors=False`` yields raw arrays instead of
    its Tensor wrapper; the port has no wrapper: tensors either way, and a
    tensor already on the device passes through untouched."""
    t = torch.ones(2)
    pf = DevicePrefetcher(iter([np.ones((2,), np.float32), t]), depth=1,
                          wrap_tensors=False, device="cpu")
    a, b = next(pf), next(pf)
    assert isinstance(a, torch.Tensor) and b is t
    pf.close()


def test_invalid_depth_and_sharding_raise():
    with pytest.raises(ValueError):
        DevicePrefetcher(iter(()), depth=0, device="cpu")
    with pytest.raises(ValueError):
        JaxPrefetcher(iter(()), depth=0)
    with pytest.raises(NotImplementedError, match="queue 1, item 9"):
        DevicePrefetcher(iter(()), sharding=object(), device="cpu")
