"""``io.DevicePrefetcher`` held against the JAX package's on the CPU (the
port of ``tests/test_train_perf.py::TestDevicePrefetcher``): the same
source gives the same batches in the same order (values equal, numpy
leaves as tensors, other leaves passed through), one stall observation
per batch in the ``train_input_stall_seconds`` histogram, a source error
raised in the consumer, ``close()`` retiring the producer, an invalid
depth and a malformed mesh placement refused; and batches placed over a
mesh (``sharding=``) against the JAX prefetcher's shards.  On the CPU the port copies each numpy leaf into a CPU
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
    # a placement is taken since item 9's step 4; a malformed one raises
    with pytest.raises(TypeError):
        DevicePrefetcher(iter(()), sharding=object(), device="cpu")


# ---------------------------------------------------------------------------
# batches placed over a mesh (ROADMAP.md item 9, step 4)
# ---------------------------------------------------------------------------

PLACED = [({"dp": 2, "pp": 2, "mp": 2}, ("dp",)),
          ({"dp": 2, "pp": 2, "mp": 2}, (("dp", "mp"),)),
          ({"dp": 2, "sp": 2, "mp": 2}, (None, "sp")),
          ({"dp": 2, "pp": 2, "mp": 2}, ())]


@pytest.mark.parametrize("axes, spec", PLACED,
                         ids=["dp", "dp_mp", "none_sp", "replicated"])
def test_placed_parts_match_jax_shards(axes, spec):
    """Every mesh position's part is the data the JAX prefetcher puts on
    that position's device; each distinct (block, device) pair is one
    copy, so on one device the bytes copied are the batch's once."""
    from jax.sharding import NamedSharding as JaxSharding
    from jax.sharding import PartitionSpec

    from paddle_tpu.distributed import mesh as JM

    from paddle_tpu_torch.distributed import mesh as M

    x = np.arange(8 * 6 * 4, dtype=np.float32).reshape(8, 6, 4)
    jm = JM.build_mesh(axes)
    jb = next(iter(JaxPrefetcher(iter([x]), sharding=JaxSharding(
        jm, PartitionSpec(*spec)))))
    by_device = {s.device: np.asarray(s.data)
                 for s in getattr(jb, "_value", jb).addressable_shards}
    M.set_mesh(M.build_mesh(axes, ["cpu"] * 8))
    try:
        pf = DevicePrefetcher(iter([x]), sharding=spec)
        got = next(pf)
        pf.close()
    finally:
        M.set_mesh(None)
    assert isinstance(got, M.PlacedTensor)
    for coords in np.ndindex(*jm.devices.shape):
        np.testing.assert_array_equal(got.on(coords).numpy(),
                                      by_device[jm.devices[coords]])
    assert pf.bytes_copied == x.nbytes
    # any other consumer gets the whole batch
    np.testing.assert_array_equal(got.gather().numpy(), x)
    np.testing.assert_array_equal((got + 1).numpy(), x + 1)
    assert torch.equal(torch.as_tensor(np.asarray(got)), torch.from_numpy(x))


def test_placed_spec_errors():
    from paddle_tpu_torch.distributed import mesh as M

    M.set_mesh(M.build_mesh({"dp": 2, "mp": 2}, ["cpu"] * 4))
    try:
        for spec, err in ((("pp",), ValueError), (("dp", "dp"), ValueError),
                          ((3,), TypeError), ("dp", TypeError)):
            with pytest.raises(err):
                DevicePrefetcher(iter(()), sharding=spec)
        # a dimension the axes do not divide raises in the consumer, as
        # jax.device_put refuses it
        pf = DevicePrefetcher(iter([np.zeros((3, 2))]),
                              sharding=(("dp", "mp"),))
        with pytest.raises(ValueError, match="not divisible"):
            next(pf)
    finally:
        M.set_mesh(None)


def _grads(model, ids, labels, loss_fn=None):
    from paddle_tpu_torch.distributed.shards import sharded_parameters

    loss = (model(ids, labels=labels) if loss_fn is None
            else loss_fn(model(ids), labels))
    loss.backward()
    parts = sharded_parameters(model)
    grads = ({k: sp.gather([p.grad for p in sp]) for k, sp in parts.items()}
             if parts else {k: p.grad.clone()
                            for k, p in model.named_parameters()})
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


@pytest.mark.parametrize("axes, spec", [
    ({"dp": 2, "pp": 2, "mp": 2}, ("dp",)),
    ({"dp": 2, "sharding": 2, "pp": 2}, (("dp", "sharding"),)),
    ({"dp": 2, "sharding": 2, "pp": 2}, ("dp",))],
    ids=["dp2pp2mp2-dp", "dp2sh2pp2-dp_sharding", "dp2sh2pp2-dp"])
def test_placed_forward_bit_equal(axes, spec):
    """The stacked GPT's placed forward fed a placed batch reads each
    replica's rows where they lie: the loss and gradients of the batch fed
    whole, bit for bit."""
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.models import GPTStackedForPretraining, gpt_tiny

    rng = np.random.RandomState(0)
    ids, labels = (rng.randint(0, 1024, (8, 16)) for _ in range(2))
    M.set_mesh(M.build_mesh(axes, ["cpu"] * 8))
    try:
        m = GPTStackedForPretraining(gpt_tiny(
            num_layers=4, hidden_dropout=0.0, attention_dropout=0.0,
            use_tensor_parallel=True), 2)
        whole = _grads(m, torch.from_numpy(ids), torch.from_numpy(labels))
        with DevicePrefetcher(iter([(ids, labels)]), sharding=spec) as pf:
            placed = _grads(m, *next(pf))
    finally:
        M.set_mesh(None)
    assert torch.equal(whole[0], placed[0])
    for k, g in whole[1].items():
        assert torch.equal(g, placed[1][k]), k


def test_sequence_parts_fed_placed_batch():
    """The layered GPT's sequence parts at sp 2 read ``(None, "sp")``
    blocks where they lie: the whole batch's loss and gradients; the
    criterion, another consumer, gets the whole labels."""
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.models import (
        GPTForPretraining, GPTPretrainingCriterion, gpt_tiny,
    )

    rng = np.random.RandomState(1)
    ids, labels = (rng.randint(0, 1024, (2, 16)) for _ in range(2))
    cfg = gpt_tiny(sequence_parallel=True, hidden_dropout=0.0,
                   attention_dropout=0.0)
    M.set_mesh(M.build_mesh({"sp": 2}, ["cpu"] * 2))
    try:
        m = GPTForPretraining(cfg, device="cpu")
        crit = GPTPretrainingCriterion(cfg)
        whole = _grads(m, torch.from_numpy(ids), torch.from_numpy(labels),
                       crit)
        with DevicePrefetcher(iter([(ids, labels)]),
                              sharding=(None, "sp")) as pf:
            placed = _grads(m, *next(pf), crit)
    finally:
        M.set_mesh(None)
    assert torch.equal(whole[0], placed[0])
    for k, g in whole[1].items():
        assert torch.equal(g, placed[1][k]), k
