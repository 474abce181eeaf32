"""Serving from a model placed on a training mesh with per-request LoRA,
speculative drafts and the sharded engine (the port's
``GPTStackedForPretraining`` under ``train_mesh`` and
``GPTForPretraining`` under ``layered_tp``), held against the JAX
package's unplaced models on the CPU (``tests/test_lora.py``,
``tests/test_speculative.py``, ``tests/test_sharded_serving.py`` are the
reference's).  The port's models are placed on ``["cpu"] * n`` (every
position on one device); each side loads the same numpy weights, every
bias and LayerNorm gain moved off its init so that a shard holding the
wrong heads gives other logits.

- LoRA: the stacked GPT (4 layers) at (dp, pp, mp) = (1, 2, 2) and the
  layered GPT (2 layers) at ``{"mp": 2}`` with ``use_tensor_parallel``
  serve a mix of two
  tenants and the null adapter: the JAX engine's greedy tokens with the
  same adapters; one fused ragged step's logits within rtol 1e-5 and atol
  2e-5 of the JAX step's (the row-parallel sums add in another order),
  and away from the logits without adapters.
- Drafts: ``truncated_draft`` of the placed stacked model at pp 2 is
  placed over the mesh (one layer a stage, the target's first two
  layers); at one layer it raises the JAX package's ``ValueError`` in its
  words.  Speculative serving from the placed target with a draft of
  half its layers, for both classes, gives the JAX target's greedy tokens
  and proposes tokens.
- The sharded engine at (dp, mp) = (2, 1) and (1, 2) over a placed model
  gives the JAX engine's tokens over the same weights (the oracle of the
  JAX sharded parity test; in fp32 the JAX ``ShardedServingEngine`` gives
  them at these meshes, as ``tests/test_torch_sharded_serving.py``
  holds);
  the model has left its training mesh (no placement, every part freed);
  training it again raises naming ROADMAP.md queue 1, item 9, and a
  forward under ``torch.no_grad()`` gives the unplaced model's logits.
- Step 3's leftover (dp replicas and ZeRO over sp copies, once refused
  naming item 9, step 3): on the same ``{axis: 2, "sp": 2}`` mesh over
  ``cpu:i`` the replicas, or the ZeRO plan, are built with one copy for
  each (replica, sp position) (``tests/test_torch_sp_replicas.py`` holds
  their training to the JAX package).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.distributed import mesh as JM
from paddle_tpu.models import GPTForPretraining as JaxLayered
from paddle_tpu.models import GPTStackedForPretraining as JaxStacked
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models import truncated_draft as jax_truncated_draft
from paddle_tpu.ops.pallas_kernels import ragged_paged_attention as jra
from paddle_tpu.quantization.int8 import (
    quantize_for_serving as jax_quantize_for_serving,
)
from paddle_tpu.serving import LoRAAdapterPool as JaxPool
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import SpeculativeEngine as JaxSpeculativeEngine
from paddle_tpu.tensor import to_tensor

from paddle_tpu_torch.distributed import DataParallel
from paddle_tpu_torch.distributed import mesh as M
from paddle_tpu_torch.distributed.serving_mesh import clone_model
from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
from paddle_tpu_torch.models import (
    GPTForPretraining, GPTStackedForPretraining, gpt_tiny, truncated_draft,
)
from paddle_tpu_torch.models.gpt import GPTStackedDecoder
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as tra
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import (
    LoRAAdapterPool, ServingEngine, ShardedServingEngine, SpeculativeEngine,
    random_adapter,
)

torch.set_num_threads(2)

CFG = dict(hidden_dropout=0.0, attention_dropout=0.0)
# the stacked model's 4 layers over pp 2 (its draft: 2, one a stage); the
# layered JAX model's programs unroll their layers, so it keeps 2
LAYERS = {"stacked": 4, "layered": 2}
CLASSES = {"stacked": (JaxStacked, GPTStackedForPretraining),
           "layered": (JaxLayered, GPTForPretraining)}
# each class's training mesh: the stacked model over pp and mp, the
# layered one by tensor parallelism
AXES = {"stacked": {"pp": 2, "mp": 2}, "layered": {"mp": 2}}
ENG = dict(num_slots=3, page_size=16, max_context=64, cache_dtype="float32")
TENANTS = ("t1", "t2", None)

_STATES: dict = {}


def _state(kind):
    """The unplaced JAX model's weights, biases and gains perturbed."""
    if kind not in _STATES:
        pt.seed(0)
        m = CLASSES[kind][0](jax_gpt_tiny(num_layers=LAYERS[kind], **CFG))
        rng = np.random.RandomState(1)
        out = {}
        for k, v in m.state_dict().items():
            a = np.asarray(v.numpy(), np.float32)
            if k.endswith(("bias", "_b", "_g", "ln1.weight", "ln2.weight",
                           "final_ln.weight")):
                a = a + 0.1 * rng.randn(*a.shape).astype(np.float32)
            out[k] = a
        _STATES[kind] = out
    return _STATES[kind]


def _jax(kind):
    m = CLASSES[kind][0](jax_gpt_tiny(num_layers=LAYERS[kind], **CFG))
    m.set_state_dict(_state(kind))
    m.eval()
    return m


def _placed(kind, axes=None):
    """The port's model placed on ``axes`` (the class's training mesh by
    default) over CPU positions, carrying the state; the global mesh
    stays set (``clean_mesh`` clears it)."""
    axes = axes or AXES[kind]
    M.set_mesh(M.build_mesh(axes, ["cpu"] * int(np.prod(list(
        axes.values())))))
    m = CLASSES[kind][1](gpt_tiny(num_layers=LAYERS[kind], **CFG,
                                  use_tensor_parallel=kind == "layered"))
    m.load_jax_state(_state(kind))
    m.eval()
    assert m._train_mesh is not None
    return m


@pytest.fixture
def clean_mesh():
    yield
    M.set_mesh(None)


def _prompts(lengths=(5, 17, 9), seed=2):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, (s,)) for s in lengths]


def _pools(kind, rank=3, pages=3):
    """The same two adapters in a JAX and a port pool of the class's
    layout."""
    cfg = gpt_tiny(num_layers=LAYERS[kind], **CFG)
    stacked = kind == "stacked"
    jp = JaxPool(jax_gpt_tiny(num_layers=LAYERS[kind], **CFG),
                 num_adapter_pages=pages, rank=rank, stacked=stacked)
    tp = LoRAAdapterPool(cfg, num_adapter_pages=pages, rank=rank,
                         stacked=stacked, device="cpu")
    for name, seed in (("t1", 7), ("t2", 8)):
        w = random_adapter(cfg, rank, np.random.RandomState(seed))
        assert jp.register(name, w) == tp.register(name, w)
    return jp, tp


# ---------------------------------------------------------------------------
# per-request LoRA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_lora_serving_matches_jax(kind, clean_mesh):
    jp, tp = _pools(kind)
    prompts = _prompts()
    je = JaxEngine(_jax(kind), lora=jp, **ENG)
    jreqs = [je.submit(p, 5, adapter=a) for p, a in zip(prompts, TENANTS)]
    je.run_until_idle()
    eng = ServingEngine(_placed(kind), lora=tp, **ENG)
    reqs = [eng.submit(p, 5, adapter=a) for p, a in zip(prompts, TENANTS)]
    eng.run_until_idle()
    for r, jr in zip(reqs, jreqs):
        assert r.finished
        np.testing.assert_array_equal(r.output_ids(), jr.output_ids())
    assert eng.cache.groups is not None
    assert eng.allocator.free_pages == eng.allocator.capacity
    assert tp.refcount("t1") == tp.refcount("t2") == 0


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_lora_fused_step_logits_match_jax(kind, clean_mesh):
    """One fused ragged step over empty pools: a 10-token prefill on
    adapter 2 and a 1-token run on adapter 1, padding rows on the null
    adapter."""
    jp, tp = _pools(kind)
    jm = _jax(kind)
    tm = _placed(kind)
    rng = np.random.RandomState(4)
    num_pages, t_max, nb_max, mp = 9, 16, 4, 4
    runs = [(0, 10, np.array([3, 5, 0, 0], np.int32)),
            (0, 1, np.array([1, 2, 0, 0], np.int32))]
    plan, stats = tra.build_ragged_plan(
        runs, token_block=tra.TOKEN_BLOCK, page_size=16, t_max=t_max,
        nb_max=nb_max, wl_max=nb_max * mp)
    ids = np.zeros((t_max, 1), np.int64)
    tables = np.zeros((t_max, mp), np.int32)
    positions = np.zeros((t_max,), np.int32)
    adapters = np.zeros((t_max,), np.int32)
    for (base, count, tbl), start, page in zip(runs, stats["run_starts"],
                                               (2, 1)):
        ids[start:start + count, 0] = rng.randint(0, 1024, count)
        tables[start:start + count] = tbl
        positions[start:start + count] = base + np.arange(count)
        adapters[start:start + count] = page
    out_rows = np.array([9, 10], np.int32)
    jlog = jm._paged_lm_logits(
        to_tensor(ids), jm.new_paged_kv_cache(num_pages, 16, dtype="float32"),
        to_tensor(tables), to_tensor(positions),
        ragged_plan=tuple(to_tensor(plan[k]) for k in jra.RAGGED_PLAN_FIELDS),
        out_rows=to_tensor(out_rows),
        lora=(jp, to_tensor(adapters))).numpy()
    with torch.no_grad():
        args = (torch.from_numpy(ids), torch.from_numpy(tables),
                torch.from_numpy(positions))
        kw = dict(ragged_plan=tuple(torch.from_numpy(plan[k])
                                    for k in tra.RAGGED_PLAN_FIELDS),
                  out_rows=torch.from_numpy(out_rows))
        got = {}
        for name, lora in (("lora", (tp, torch.from_numpy(adapters))),
                           ("base", None)):
            cache = tm.new_paged_kv_cache(num_pages, 16, dtype="float32")
            assert cache.groups is not None
            got[name] = tm._paged_lm_logits(args[0], cache, *args[1:],
                                            lora=lora, **kw).numpy()
    np.testing.assert_allclose(got["lora"], jlog, rtol=1e-5, atol=2e-5)
    assert np.abs(got["lora"] - got["base"]).max() > 1e-3, \
        "the adapters did nothing"


# ---------------------------------------------------------------------------
# speculative drafts
# ---------------------------------------------------------------------------

def test_truncated_draft_of_placed_model(clean_mesh):
    tm = _placed("stacked")
    draft = truncated_draft(tm, 2)
    dm = draft._train_mesh
    assert dm is not None and dm.pp == 2 and dm.mp == 2
    assert dm.layers == [[0], [1]] and not draft.training
    want = tm.state_dict()
    for k, v in draft.state_dict().items():
        w = want[k][:2] if want[k].shape != v.shape else want[k]
        assert torch.equal(v, w), k
    with pytest.raises(ValueError) as port_error:
        truncated_draft(tm, 1)
    M.set_mesh(None)
    JM.set_mesh(JM.build_mesh(AXES["stacked"]))
    try:
        with pytest.raises(ValueError) as jax_error:
            jax_truncated_draft(_jax("stacked"), 1)
    finally:
        JM.set_mesh(None)
    assert str(port_error.value) == str(jax_error.value)


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_speculative_serving_from_placed_target(kind, clean_mesh):
    prompts = _prompts((5, 18, 9))
    jm = _jax(kind)
    want = JaxEngine(jm, **ENG).generate_batch(prompts, 6)
    n = LAYERS[kind] // 2
    jgot = JaxSpeculativeEngine(jm, jax_truncated_draft(jm, n), spec_k=3,
                                **ENG).generate_batch(prompts, 6)
    tm = _placed(kind)
    eng = SpeculativeEngine(tm, truncated_draft(tm, n), spec_k=3, **ENG)
    got = eng.generate_batch(prompts, 6)
    for g, jg, w in zip(got, jgot, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(jg, w)
    met = eng.metrics()
    assert met["spec_proposed_tokens"] > 0
    assert eng.draft.cache.groups is not None
    for a in (eng.allocator, eng.draft.allocator):
        assert a.used_pages == 0 and a.spec_pages == 0


# a draft that agrees with the target often enough to commit accepted
# proposals: the stacked target's whole depth (its 2-layer draft accepts
# none here), the layered target's first layer (some proposals accepted,
# some rolled back)
AGREEING = {"stacked": 4, "layered": 1}


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_placed_speculation_accepts_as_unplaced(kind, clean_mesh):
    """The placed verify step commits accepted proposals and rolls the
    rest back as the unplaced model does: the same tokens, the same
    proposed and accepted counts, both pools drained."""
    prompts = _prompts((5, 18, 9), seed=3)
    twin = CLASSES[kind][1](gpt_tiny(num_layers=LAYERS[kind], **CFG),
                            device="cpu")
    twin.load_jax_state(_state(kind))
    twin.eval()
    n = AGREEING[kind]
    ref = SpeculativeEngine(twin, truncated_draft(twin, n), spec_k=3, **ENG)
    want = ref.generate_batch(prompts, 12)
    tm = _placed(kind)
    eng = SpeculativeEngine(tm, truncated_draft(tm, n), spec_k=3, **ENG)
    got = eng.generate_batch(prompts, 12)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    met, rmet = eng.metrics(), ref.metrics()
    for k in ("spec_proposed_tokens", "spec_accepted_tokens"):
        assert met[k] == rmet[k], k
    assert met["spec_accepted_tokens"] > 0
    if kind == "layered":
        assert met["spec_accepted_tokens"] < met["spec_proposed_tokens"]
    for a in (eng.allocator, eng.draft.allocator):
        assert a.used_pages == 0 and a.spec_pages == 0


# ---------------------------------------------------------------------------
# the sharded engine over a placed model
# ---------------------------------------------------------------------------

SHARD_KW = dict(num_slots=2, page_size=16, max_context=64,
                cache_dtype="float32")
_ORACLES: dict = {}


def _workload():
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 1024, (s,)) for s in (3, 17, 5, 26)]
    return prompts, [4, 3, 5, 2]


def _oracle(kind):
    """The JAX engine's output ids of :func:`_workload`, run once."""
    if kind not in _ORACLES:
        je = JaxEngine(_jax(kind), **SHARD_KW)
        reqs = [je.submit(p, n) for p, n in zip(*_workload())]
        je.run_until_idle()
        _ORACLES[kind] = [r.output_ids() for r in reqs]
        je.close()
    return _ORACLES[kind]


@pytest.mark.parametrize("dp,mp", [(2, 1), (1, 2)])
@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_sharded_engine_over_placed_model(kind, dp, mp, clean_mesh):
    prompts, new = _workload()
    want = _oracle(kind)
    axes = {"dp": 2, "pp": 2, "mp": 2} if kind == "stacked" else None
    tm = _placed(kind, axes)
    parts = list(tm.parameters())
    opt = AdamW(1e-3, parameters=parts)
    eng = ShardedServingEngine(tm, dp=dp, mp=mp, devices=["cpu"] * (dp * mp),
                               **SHARD_KW)
    reqs = [eng.submit(p, n) for p, n in zip(prompts, new)]
    eng.run_until_idle(max_steps=2000)
    for r, w in zip(reqs, want):
        assert r.finished, r.state
        np.testing.assert_array_equal(r.output_ids(), w)
    assert {r.replica for r in reqs} == set(range(dp))
    for rep in eng.replicas:
        assert rep.allocator.used_pages == 0
        assert rep.cache.mesh_shards == mp
        assert getattr(rep.cache, "groups", None) is None
        assert rep.model._train_mesh is None
    # the training placement is gone: every part freed
    assert tm._train_mesh is None and eng.replicas[0].model is tm
    assert all(p.untyped_storage().nbytes() == 0 for p in parts)
    assert all(p.device.type == "cpu" for p in tm.parameters()
               if p.device.type != "meta")
    assert set(tm.state_dict()) == set(_state(kind))
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, 1024, (2, 8)))
    # training it again raises: its optimizer holds the freed parts
    with pytest.raises(NotImplementedError, match=r"queue 1, item 9"):
        tm(ids)
    assert opt.param_groups[0]["params"][0] is parts[0]
    if mp == 1:
        jlog = _jax(kind)(pt.to_tensor(ids.numpy())).numpy()
        with torch.no_grad():
            np.testing.assert_allclose(tm(ids).numpy(), jlog, rtol=1e-5,
                                       atol=2e-5)
    eng.close()


# ---------------------------------------------------------------------------
# int8 weights: a quantized placed stacked model (pp 2, mp 1) serves as
# the JAX package's quantized unplaced model
# ---------------------------------------------------------------------------

INT8_AXES = {"pp": 2}
INT8_PROMPTS = _prompts((5, 18, 9))
_INT8: dict = {}


def _int8_twin():
    """The port's unplaced stacked model, quantized: the int8 values every
    placed, drafted, cloned or unplaced copy must hold."""
    if "twin" not in _INT8:
        saved = M.get_mesh() if M.has_mesh() else None
        M.set_mesh(None)
        try:
            m = GPTStackedForPretraining(
                gpt_tiny(num_layers=LAYERS["stacked"], **CFG), device="cpu")
        finally:
            M.set_mesh(saved)
        m.load_jax_state(_state("stacked"))
        m.quantize_weights()
        _INT8["twin"] = m
    return _INT8["twin"]


def _jax_int8():
    jm = _jax("stacked")
    jax_quantize_for_serving(jm)
    return jm


def _int8_oracle():
    """The JAX int8 engine's greedy tokens of :data:`INT8_PROMPTS`."""
    if "tokens" not in _INT8:
        _INT8["tokens"] = JaxEngine(_jax_int8(), **ENG).generate_batch(
            INT8_PROMPTS, 6)
    return _INT8["tokens"]


def _assert_int8_as_twin(model):
    """``model``'s int8 weights (each stage's rows of a placed model, the
    buffers of an unplaced one) are the twin's of its first layers, bit
    for bit."""
    twin = _int8_twin()
    assert model.weight_int8
    tm, n = model._train_mesh, model.config.num_layers
    for name in GPTStackedDecoder.QUANTIZED:
        for key in (name + "_int8", name + "_s"):
            want = getattr(twin.decoder, key)[:n]
            if tm is None:
                assert torch.equal(getattr(model.decoder, key), want), key
                continue
            for st, layers in enumerate(tm.layers):
                assert torch.equal(model.decoder.stage_int8[st][key],
                                   want[layers]), (key, st)
    head = ((model.lm_head_int8, model.lm_head_scale) if tm is None
            else model.placed_head_int8)
    assert torch.equal(head[0], twin.lm_head_int8)
    assert torch.equal(head[1], twin.lm_head_scale)


def test_int8_placed_lora_matches_jax(clean_mesh):
    jp, tp = _pools("stacked")
    je = JaxEngine(_jax_int8(), lora=jp, **ENG)
    jreqs = [je.submit(p, 5, adapter=a) for p, a in zip(_prompts(), TENANTS)]
    je.run_until_idle()
    tm = _placed("stacked", INT8_AXES)
    eng = ServingEngine(tm, weight_dtype="int8", lora=tp, **ENG)
    reqs = [eng.submit(p, 5, adapter=a) for p, a in zip(_prompts(), TENANTS)]
    eng.run_until_idle()
    for r, jr in zip(reqs, jreqs):
        assert r.finished
        np.testing.assert_array_equal(r.output_ids(), jr.output_ids())
    assert tm._train_mesh is not None and eng.cache.groups is not None
    _assert_int8_as_twin(tm)


def test_int8_placed_draft_and_speculation_match_jax(clean_mesh):
    tm = _placed("stacked", INT8_AXES)
    tm.quantize_weights()
    draft = truncated_draft(tm, 2)
    assert draft._train_mesh.layers == [[0], [1]]
    _assert_int8_as_twin(draft)
    eng = SpeculativeEngine(tm, draft, spec_k=3, **ENG)
    got = eng.generate_batch(INT8_PROMPTS, 6)
    for g, w in zip(got, _int8_oracle()):
        np.testing.assert_array_equal(g, w)
    assert eng.metrics()["spec_proposed_tokens"] > 0


def test_int8_draft_takes_weights_by_its_own_placement(clean_mesh):
    """An unplaced quantized target drafted under a mesh gives a placed
    draft that quantizes the same weights; a placed one drafted without
    its mesh, whose state dict holds no int8 weights, raises."""
    M.set_mesh(M.build_mesh(INT8_AXES, ["cpu"] * 2))
    draft = truncated_draft(_int8_twin(), 2)
    assert draft._train_mesh is not None
    _assert_int8_as_twin(draft)
    tm = _placed("stacked", INT8_AXES)
    tm.quantize_weights()
    M.set_mesh(None)
    with pytest.raises(ValueError, match="int8 weights beside its parts"):
        truncated_draft(tm, 2)


@pytest.mark.parametrize("dp,mp", [(2, 1), (1, 2)])
def test_int8_sharded_engine_over_placed_model_matches_jax(dp, mp,
                                                           clean_mesh):
    """Replica 0 leaves its training mesh and quantizes its whole weights
    again; at dp 2 the copy comes from a factory that builds a placed
    model (the mesh still set), which quantizes after loading and leaves
    the mesh in its turn."""
    tm = _placed("stacked", INT8_AXES)
    tm.quantize_weights()
    cfg = tm.config

    def factory():
        m = GPTStackedForPretraining(cfg)
        assert m._train_mesh is not None
        return m

    if dp == 2:
        copy = clone_model(tm, factory)
        assert copy._train_mesh is not None
        _assert_int8_as_twin(copy)
    eng = ShardedServingEngine(tm, dp=dp, mp=mp, devices=["cpu"] * (dp * mp),
                               model_factory=factory, **SHARD_KW)
    reqs = [eng.submit(p, 6) for p in INT8_PROMPTS]
    eng.run_until_idle(max_steps=2000)
    for r, w in zip(reqs, _int8_oracle()):
        assert r.finished, r.state
        np.testing.assert_array_equal(r.output_ids(), w)
    for rep in eng.replicas:
        assert rep.model._train_mesh is None
        if mp == 1:
            _assert_int8_as_twin(rep.model)
    eng.close()


# ---------------------------------------------------------------------------
# step 3's leftover: what was refused is built
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", ["dp", "sharding"])
def test_step3_refusals_still_raise(axis, clean_mesh):
    """Once refused (ROADMAP.md queue 1, item 9, step 3), now built: dp
    replicas hold a copy of the body for each (replica, sp position);
    ZeRO's plan gives each piece one copy for
    each sp position of its one replica, the sp copy filled from the
    replica's group.  No two copies share a mesh position."""
    from paddle_tpu_torch.distributed.shards import (
        copy_key, position_of, replica_of,
    )

    M.set_mesh(M.build_mesh({axis: 2, "sp": 2},
                            [f"cpu:{i}" for i in range(4)]))
    m = GPTForPretraining(gpt_tiny(sequence_parallel=True), device="cpu")
    body = len([p for p in m.parameters() if replica_of(p) is None])
    if axis == "dp":
        wrapped = DataParallel(m)
        keys = [(r, s) for r in range(2) for s in range(2)]
    else:
        wrapped = m
        opt = AdamW(parameters=m.parameters())
        group_sharded_parallel(m, opt, "os")
        keys = [(0, 0), (0, 1)]
        assert all(len(rec.copies) == 2 and rec.replicas == 1
                   for rec in m._zero_plan.pieces)
    by_key = {}
    for p in wrapped.parameters():
        by_key.setdefault(copy_key(position_of(p)), []).append(p)
    assert sorted(by_key) == keys
    assert all(len(ps) == body for ps in by_key.values())
