"""The port's auto_parallel annotation API and checkpoint converter held
against the JAX package on the CPU (``paddle_tpu_torch.distributed.
auto_parallel`` against ``paddle_tpu.distributed.auto_parallel``).

The JAX side runs on the 8-device CPU mesh of ``tests/conftest.py``; the
port lays its meshes out on ``["cpu"] * 8`` (``ProcessMesh(...,
device="cpu")``).  Inputs come from numpy seeds.

- placement parity: ``shard_tensor`` and ``reshard`` on a (2, 4) mesh for
  ``Shard``/``Replicate``/``Partial`` lists, two mesh axes on one tensor
  dimension among them: every position's block equals, bit for bit, the
  JAX array's addressable shard on the device of the same index;
- the four cases of ``tests/test_converter.py`` (TP=2 -> TP=4, pp off with
  target specs, merge against the global tensor with 8 shards, no mesh);
- checkpoints that cross packages, fp32 and bf16, each way, loaded bit for
  bit; the JAX package records bf16 shards as raw 2-byte words (numpy has
  no bfloat16, ``np.savez`` keeps them as ``<V2``), which ``np.load`` gives
  back as ``|V2``.  Numpy has no cast from those words into the bfloat16
  array the JAX ``Converter.merge`` fills, so the JAX package cannot merge
  bf16 shards, its own included (held below); its side of the test is
  handed the words viewed as ``ml_dtypes.bfloat16``;
- the tiling check's error on an incomplete shard set;
- ``shard_op``, ``dtensor_from_fn``, the spec a dimension the axes do not
  divide refuses, and ``ProcessMesh``'s API.
"""
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.distributed import auto_parallel as JA
from paddle_tpu.distributed import mesh as JM
from paddle_tpu.ops.sharding_ops import shard_param
from paddle_tpu.tensor import Tensor as JaxTensor

from paddle_tpu_torch.distributed import auto_parallel as A
from paddle_tpu_torch.distributed import mesh as M

IDS = np.arange(8).reshape(2, 4)


def _meshes():
    return (JA.ProcessMesh(IDS, ["dp", "mp"]),
            A.ProcessMesh(IDS, ["dp", "mp"], device="cpu"))


def _placements(kinds):
    out = []
    for k in kinds:
        out.append((JA.Replicate(), A.Replicate()) if k == "R" else
                   (JA.Partial(), A.Partial()) if k == "P" else
                   (JA.Shard(int(k[1])), A.Shard(int(k[1]))))
    return [p[0] for p in out], [p[1] for p in out]


PLACEMENTS = [("S0", "S1"), ("R", "S0"), ("S1", "R"), ("S0", "S0"),
              ("S1", "S1"), ("P", "S1"), ("R", "R"), ("S1", "S0")]


def _assert_blocks_equal_jax(placed, jarr):
    """Each position's block against the JAX shard on the device of the
    same index (the (2, 4) mesh's row-major position)."""
    by_device = {sh.device.id: np.asarray(sh.data)
                 for sh in jarr.addressable_shards}
    for coords in np.ndindex(2, 4):
        k = coords[0] * 4 + coords[1]
        np.testing.assert_array_equal(placed.on(coords).numpy(),
                                      by_device[k])


@pytest.mark.parametrize("kinds", PLACEMENTS,
                         ids=["-".join(k) for k in PLACEMENTS])
def test_shard_tensor_blocks_equal_the_jax_shards(kinds):
    jm, pm = _meshes()
    jp, pp = _placements(kinds)
    x = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    jt = JA.shard_tensor(x, jm, jp)
    pt_ = A.shard_tensor(x, pm, pp)
    assert pt_.process_mesh is pm
    # the port's spec is the JAX PartitionSpec, each entry a tuple of axes
    want = tuple(() if e is None else (e,) if isinstance(e, str) else
                 tuple(e) for e in tuple(jt._value.sharding.spec))
    assert tuple(pt_.sharding.spec) == want
    _assert_blocks_equal_jax(pt_, jt._value)
    np.testing.assert_array_equal(pt_.gather().numpy(), x)


@pytest.mark.parametrize("src,dst", [(("S0", "S1"), ("S1", "S0")),
                                     (("S0", "S0"), ("R", "S1")),
                                     (("R", "S1"), ("S0", "R"))])
def test_reshard_blocks_equal_the_jax_shards(src, dst):
    jm, pm = _meshes()
    x = np.random.RandomState(1).randn(8, 16).astype(np.float32)
    jt = JA.shard_tensor(x, jm, _placements(src)[0])
    pt_ = A.shard_tensor(x, pm, _placements(src)[1])
    jr = JA.reshard(jt, jm, _placements(dst)[0])
    pr = A.reshard(pt_, pm, _placements(dst)[1])
    _assert_blocks_equal_jax(pr, jr._value)


def test_shard_tensor_refuses_an_undivided_dimension():
    _, pm = _meshes()
    with pytest.raises(ValueError, match="not divisible"):
        A.shard_tensor(np.zeros((6, 12), np.float32), pm,
                       [A.Replicate(), A.Shard(0)])


def test_process_mesh_api():
    jm, pm = _meshes()
    assert pm.shape == jm.shape == [2, 4]
    assert pm.process_ids == jm.process_ids
    assert pm.dim_names == ["dp", "mp"] and pm.ndim == 2
    assert pm.get_dim_size("mp") == jm.get_dim_size("mp") == 4
    assert pm == A.ProcessMesh(IDS, ["x", "y"], device="cpu")
    assert pm != A.ProcessMesh(IDS.reshape(4, 2), ["dp", "mp"],
                               device="cpu")
    prev = M._global_mesh
    try:
        assert pm.activate() is pm and M.get_mesh() is pm.mesh
        assert M.get_mesh().shape == {"dp": 2, "mp": 4}
    finally:
        M.set_mesh(prev)


def test_dtensor_from_fn_and_shard_op():
    jm, pm = _meshes()
    d = A.dtensor_from_fn(torch.ones, pm, [A.Shard(0), A.Replicate()], 4, 3)
    assert d.on((1, 2)).shape == (2, 3) and d.sharding.spec == (("dp",),)
    op = A.shard_op(lambda a, b: (a + b, a * b), pm,
                    out_specs=[("dp", "mp"), (None, "mp")])
    a = torch.from_numpy(np.random.RandomState(2).randn(4, 8))
    s, p = op(a, a)
    assert s.sharding.spec == (("dp",), ("mp",))
    assert p.sharding.spec == ((), ("mp",))
    np.testing.assert_array_equal(s.gather().numpy(), (a + a).numpy())
    np.testing.assert_array_equal(p.on((1, 3)).numpy(),
                                  (a * a)[:, 6:8].numpy())
    assert A.shard_op(lambda a: a * 2)(a) is not None


def test_engine_and_strategy_are_not_ported_yet():
    """Step 6b has since ported them (the name is the stubs' test's): the
    package exports the working ``Engine`` and ``Strategy``, no stub
    raises ``NotImplementedError``; ``tests/test_torch_engine.py`` holds
    them against the JAX package."""
    from paddle_tpu_torch.distributed.auto_parallel import engine, strategy

    assert A.Engine is engine.Engine and A.Strategy is strategy.Strategy
    assert A.Strategy().to_dict() == JA.Strategy().to_dict()
    assert A.Engine(device="cpu").history == {"loss": []}


# ---------------------------------------------------------------------------
# the converter: tests/test_converter.py's cases, ported
# ---------------------------------------------------------------------------

@pytest.fixture
def tmp_ckpt(tmp_path):
    return str(tmp_path / "ckpt")


@pytest.fixture
def keep_meshes():
    prev_j, prev_p = JM._global_mesh, M._global_mesh
    yield
    JM._global_mesh, M._global_mesh = prev_j, prev_p


def _set(axes):
    M.set_mesh(M.build_mesh(axes, ["cpu"] * 8))
    return M.get_mesh()


def _placed(t, spec):
    return A.api._place(torch.as_tensor(t), M.NamedSharding(None, spec))


def _mk_state():
    """Params sharded over an mp axis of the CURRENT mesh (the JAX test's
    ``_mk_state``)."""
    rng = np.random.RandomState(5)
    w1 = rng.randn(8, 16).astype(np.float32)
    w2 = rng.randn(16).astype(np.float32)
    return {"fc.w": _placed(w1, (None, "mp")), "fc.b": _placed(w2, ("mp",))}


def test_reshard_tp2_to_tp4(tmp_ckpt, keep_meshes):
    _set({"dp": 4, "mp": 2})
    state = _mk_state()
    ref = {k: v.gather().numpy() for k, v in state.items()}
    A.save_distributed_checkpoint(state, tmp_ckpt)
    _set({"dp": 2, "mp": 4})
    loaded = A.load_distributed_checkpoint(tmp_ckpt)
    for k, v in loaded.items():
        np.testing.assert_array_equal(v.gather().numpy(), ref[k])
    # the layout followed the checkpoint's spec onto the NEW mesh
    assert ("mp",) in loaded["fc.w"].sharding.spec
    assert loaded["fc.w"].sharding.mesh.shape["mp"] == 4
    assert loaded["fc.w"].on((1, 3)).shape == (8, 4)


def test_reshard_pp_off_and_target_specs(tmp_ckpt, keep_meshes):
    _set({"pp": 4, "mp": 2})
    stacked = _placed(np.arange(4 * 6 * 4, dtype=np.float32).reshape(4, 6, 4),
                      ("pp", None, "mp"))
    A.save_distributed_checkpoint({"blocks.w": stacked}, tmp_ckpt)
    ref = stacked.gather().numpy()
    _set({"dp": 8})
    loaded = A.load_distributed_checkpoint(
        tmp_ckpt, target_specs={"blocks.w": (None, None, None)})
    got = loaded["blocks.w"]
    np.testing.assert_array_equal(got.gather().numpy(), ref)
    assert all(e == () for e in got.sharding.spec)


def test_converter_merge_matches_global(tmp_ckpt, keep_meshes):
    _set({"mp": 8})
    w = np.random.RandomState(0).randn(32, 8).astype(np.float32)
    A.save_distributed_checkpoint({"w": _placed(w, ("mp", None))}, tmp_ckpt)
    conv = A.Converter.load(tmp_ckpt)
    np.testing.assert_array_equal(conv.merge("w").numpy(), w)
    # 8 distinct shards were written (one per device slice)
    assert len(conv._meta["tensors"]["w"]["shards"]) == 8


def test_no_mesh_roundtrip(tmp_ckpt, keep_meshes):
    M.set_mesh(None)
    A.save_distributed_checkpoint({"w": torch.ones((4, 4))}, tmp_ckpt)
    loaded = A.load_distributed_checkpoint(tmp_ckpt)
    assert isinstance(loaded["w"], torch.Tensor)
    np.testing.assert_array_equal(loaded["w"].numpy(), 1.0)


def test_merge_refuses_a_shard_set_that_does_not_tile(tmp_ckpt, keep_meshes):
    _set({"mp": 8})
    w = np.random.RandomState(0).randn(32, 8).astype(np.float32)
    A.save_distributed_checkpoint({"w": _placed(w, ("mp", None))}, tmp_ckpt)
    conv = A.Converter.load(tmp_ckpt)
    conv._meta["tensors"]["w"]["shards"].pop(3)
    with pytest.raises(ValueError, match="does not tile"):
        conv.merge("w")
    # the JAX converter refuses the same set with the same words
    jconv = JA.Converter.load(tmp_ckpt)
    jconv._meta["tensors"]["w"]["shards"].pop(3)
    with pytest.raises(ValueError, match="does not tile"):
        jconv.merge("w")


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

def _jax_state(dtype):
    """A JAX state dict under a (dp 2, mp 4) mesh: a column-parallel
    weight, a row-sharded vector and a replicated scalar table."""
    rng = np.random.RandomState(7)
    w = JaxTensor(jnp.asarray(rng.randn(8, 16), dtype=dtype))
    b = JaxTensor(jnp.asarray(rng.randn(16), dtype=dtype))
    r = JaxTensor(jnp.asarray(rng.randn(3, 5), dtype=dtype))
    shard_param(w, None, "mp")
    shard_param(b, ("dp", "mp"))
    return {"w": w, "b": b, "r": r}


def _bits(a):
    """The raw bits of an array, numpy or torch, fp32 or bf16."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a.view(torch.int32)).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


def _jax_converter(path):
    """The JAX package's converter over ``path``, its bf16 words viewed as
    ``ml_dtypes.bfloat16`` (module docstring)."""
    conv = JA.Converter.load(path)
    for name, info in conv._meta["tensors"].items():
        if info["dtype"] == "bfloat16":
            for e in info["shards"]:
                conv._arrays[e["id"]] = conv._arrays[e["id"]].view(
                    ml_dtypes.bfloat16)
    return conv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_loads_in_the_port(tmp_ckpt, keep_meshes, dtype):
    JM.set_mesh(JM.build_mesh({"dp": 2, "mp": 4}))
    state = _jax_state(getattr(jnp, dtype))
    JA.save_distributed_checkpoint(state, tmp_ckpt)
    with open(os.path.join(tmp_ckpt, "meta.json")) as f:
        assert json.load(f)["tensors"]["w"]["dtype"] == dtype
    conv = A.Converter.load(tmp_ckpt)
    for name, t in state.items():
        got = conv.merge(name)
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_bits(got), _bits(t._value))
    # placed under the port's mesh of the same axes, by the recorded spec
    _set({"dp": 2, "mp": 4})
    loaded = A.load_distributed_checkpoint(tmp_ckpt)
    assert loaded["w"].sharding.spec == ((), ("mp",))
    assert loaded["b"].sharding.spec == (("dp", "mp"),)
    _assert_blocks_equal_jax_bits(loaded["w"], state["w"]._value)


def _assert_blocks_equal_jax_bits(placed, jarr):
    by_device = {sh.device.id: np.asarray(sh.data)
                 for sh in jarr.addressable_shards}
    for coords in np.ndindex(2, 4):
        np.testing.assert_array_equal(
            _bits(placed.on(coords)), _bits(by_device[coords[0] * 4
                                                      + coords[1]]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_loads_in_jax(tmp_ckpt, keep_meshes, dtype):
    _set({"dp": 2, "mp": 4})
    rng = np.random.RandomState(8)
    td = getattr(torch, dtype)
    w = torch.from_numpy(rng.randn(8, 16)).to(td)
    b = torch.from_numpy(rng.randn(16)).to(td)
    state = {"w": _placed(w, (None, "mp")), "b": _placed(b, (("dp", "mp"),)),
             "r": torch.from_numpy(rng.randn(3, 5)).to(td)}
    A.save_distributed_checkpoint(state, tmp_ckpt)
    conv = _jax_converter(tmp_ckpt)
    whole = {"w": w, "b": b, "r": state["r"]}
    for name, t in whole.items():
        np.testing.assert_array_equal(_bits(conv.merge(name)), _bits(t))
    # the JAX loader places them under its mesh by the recorded spec
    JM.set_mesh(JM.build_mesh({"dp": 2, "mp": 4}))
    jw = conv.convert()["w"]._value
    assert tuple(jw.sharding.spec) == (None, "mp")
    _assert_blocks_equal_jax_bits(state["w"], jw)


def test_the_jax_converter_cannot_merge_its_own_bf16_shards(tmp_ckpt,
                                                            keep_meshes):
    """The reference's own bf16 round trip stops in ``merge`` (module
    docstring); the port's files are of the same form."""
    JM.set_mesh(JM.build_mesh({"dp": 2, "mp": 4}))
    JA.save_distributed_checkpoint(_jax_state(jnp.bfloat16), tmp_ckpt)
    assert JA.Converter.load(tmp_ckpt)._arrays["w::0"].dtype == np.dtype("V2")
    with pytest.raises(ValueError, match="No cast function"):
        JA.Converter.load(tmp_ckpt).merge("w")
