"""Package boundaries of the PyTorch port: it imports neither JAX nor
anything of ``paddle_tpu`` (checked in a fresh interpreter, for the
package and for ``chip_smoke.py``), its entry points refuse to run on the
CPU unless asked, ``chip_smoke.py`` refuses to run without a card, the
knobs that wait for later slices raise ``NotImplementedError`` naming
the ``ROADMAP.md`` item that brings them -- an item that exists, whose
title names the feature -- and the knobs ported since are taken (an
engine built with each steps once) and their item's title says so."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch import inference
from paddle_tpu_torch.distributed import mesh as M
from paddle_tpu_torch.models import (
    GPTForPretraining, GPTStackedForPretraining, gpt_tiny, truncated_draft,
)
from paddle_tpu_torch.optimizer import AdamW, FusedTrainStep
from paddle_tpu_torch.quantization import quantize_for_serving
from paddle_tpu_torch.serving import (
    LoRAAdapterPool, ServingEngine, SpeculativeEngine, random_adapter,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import sys
{imports}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")
             or m.startswith("jax_"))
assert not bad, bad
assert "paddle_tpu_torch" in sys.modules
print("CLEAN")
"""


def _run_clean(imports: str):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", _CHECK.format(imports=imports)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and "CLEAN" in res.stdout, res.stderr[-2000:]


def test_port_imports_no_jax_and_nothing_of_paddle_tpu():
    """Every module of the package, found by walking it, imported in one
    fresh interpreter."""
    _run_clean("""
import pkgutil
import paddle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                               "paddle_tpu_torch.")]
for name in names:
    __import__(name)
assert len(names) >= 20, names
assert "paddle_tpu_torch.ops.kernels.flash_attention" in names
assert "paddle_tpu_torch.optimizer.fused_step" in names
for name in ("ops.kernels.rms_norm", "incubate.nn", "models.bert",
             "nn.layers", "nn.functional.attention", "nn.functional.loss"):
    assert "paddle_tpu_torch." + name in names, name
""")


def test_chip_smoke_imports_no_jax_and_nothing_of_paddle_tpu():
    _run_clean("import chip_smoke\nchip_smoke.import_port()")


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_model_without_device_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None selects it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTStackedForPretraining(gpt_tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTStackedForPretraining(gpt_tiny(), device="cuda")


def test_engine_follows_the_model_device():
    m = GPTStackedForPretraining(gpt_tiny(), device="cpu")
    eng = ServingEngine(m, num_slots=2, page_size=16, max_context=64,
                        cache_dtype="float32")
    assert eng.device == m.device == torch.device("cpu")
    assert eng.cache.k.device == m.device
    assert eng.cache.k.shape == (2, 2 * 4 + 1, 4, 16, 16)


@pytest.mark.parametrize("knob,value", [
    ("mesh", object()),
    ("role", "prefill"),
])
def test_unported_engine_knobs_raise(knob, value):
    """``mesh`` and ``role`` were refused until sharded and disaggregated
    serving was ported (ROADMAP.md queue 1, item 9).  Now a mesh that is
    not a sequence of devices raises a ``TypeError`` saying what a mesh
    is, and a role is taken and labels the engine's metrics."""
    m = GPTStackedForPretraining(gpt_tiny(), device="cpu")
    kw = dict(num_slots=2, page_size=16, max_context=64)
    if knob == "mesh":
        with pytest.raises(TypeError, match="sequence of devices"):
            ServingEngine(m, **kw, mesh=value)
        return
    eng = ServingEngine(m, **kw, role=value)
    assert eng.role == value and eng._engine_label["role"] == value


@pytest.mark.parametrize("knob,value", [
    ("kv_dtype", "int8"),
    ("kv_dtype", "bfloat16"),
    ("cache_dtype", "int8"),
    ("weight_dtype", "int8"),
])
def test_int8_engine_knobs_are_accepted(knob, value):
    """Quantized serving is ported: the knobs that raised until then make
    the pool and the weights they name."""
    m = GPTStackedForPretraining(gpt_tiny(), device="cpu")
    eng = ServingEngine(m, num_slots=2, page_size=16, max_context=64,
                        **{knob: value})
    assert eng.cache.quantized == (value == "int8" and knob != "weight_dtype")
    assert m.weight_int8 == (knob == "weight_dtype")


def _lora_pool(cfg, stacked=True):
    pool = LoRAAdapterPool(cfg, num_adapter_pages=2, rank=2, stacked=stacked,
                           device="cpu")
    pool.register("a", random_adapter(cfg, 2, np.random.RandomState(0)))
    return pool


def _engine_step(model_cls=GPTStackedForPretraining, **kw):
    """Construct an engine of a ``model_cls`` model with ``kw`` and step it
    once over one request (on the LoRA pool's adapter when there is one):
    the knob is taken."""
    m = model_cls(gpt_tiny(), device="cpu")
    if kw.get("lora") == "pool":
        kw["lora"] = _lora_pool(m.config, stacked=m.stacked)
    eng = ServingEngine(m, num_slots=2, page_size=16, max_context=64, **kw)
    r = eng.submit([1, 2, 3], 2,
                   adapter="a" if eng.lora is not None else None)
    met = eng.step()
    assert met["tokens_this_step"] == 1 and len(r.tokens) == 1
    assert eng.metrics()["fused_steps"] == 1
    return eng


@pytest.mark.parametrize("knob,value", [
    ("prefix_cache", True),
    ("stall_budget_s", 1.0),
    ("compile_budget_s", 300.0),
    ("readmission_backoff_s", 0.05),
    ("backoff_max_s", 5.0),
    ("lora", "pool"),
])
def test_ported_engine_knobs_construct_and_step(knob, value):
    eng = _engine_step(**{knob: value})
    if knob == "prefix_cache":
        assert eng.prefix_cache is not None
    elif knob == "lora":
        assert eng.lora.refcount("a") == 1
    else:
        assert getattr(eng, knob) == value


def _gpt_paged_lora():
    """``forward(lora=)`` on the paged step without a plan: the null
    adapter's row is the base model's, the adapter's row is not."""
    m = GPTStackedForPretraining(gpt_tiny(), device="cpu")
    pool = _lora_pool(m.config)
    ids = torch.tensor([[3], [4]])
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    with torch.no_grad():
        got, base = (m._paged_lm_logits(
            ids, m.new_paged_kv_cache(5, 16, dtype="float32"), tables, pos,
            lora=lora) for lora in ((pool, torch.tensor([1, 0])), None))
    assert torch.equal(got[1], base[1]) and not torch.equal(got[0], base[0])


def _roadmap_queue1():
    """{item number: its bold title} of ROADMAP.md's queue 1."""
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        text = f.read()
    queue = text.split("### 1. ", 1)[1].split("\n### ", 1)[0]
    return {int(n): t for n, t in
            re.findall(r"^(\d+)\. \*\*(.+?)\*\*", queue, re.M)}


def _engine(**kw):
    ServingEngine(GPTStackedForPretraining(gpt_tiny(), device="cpu"),
                  num_slots=2, page_size=16, max_context=64, **kw)


def _params(dtype=torch.float32):
    return [torch.nn.Parameter(torch.zeros(4, dtype=dtype))]


def _layered_quantized():
    m = quantize_for_serving(GPTForPretraining(gpt_tiny(), device="cpu"))
    assert m.weight_int8 and m.gpt.layer_0.attn.qkv_proj.weight_int8.dtype \
        == torch.int8


def _predictor(mode):
    """A Predictor of a live layered model in ``mode`` runs one batch."""
    m = GPTForPretraining(gpt_tiny(), device="cpu")
    config = inference.Config().set_causal_lm_model(m)
    if mode == "serving":
        config.enable_serving_mode(max_new_tokens=2, page_size=16,
                                   max_context=64)
    else:
        config.enable_causal_lm_decode(max_new_tokens=2, max_seq_len=64)
    out = inference.create_predictor(config).run([np.array([[1, 2, 3]])])
    assert tuple(out[0].shape) == (1, 5)


def _sequence_parallel(cls=GPTStackedForPretraining, axes=(("sp", 2),),
                       own=False, **cfg):
    """``sequence_parallel`` over an sp axis (one process, every position
    on the CPU, or with ``own`` on CPU devices of their own, ``cpu:i``,
    as on distinct cards): a training forward equals the unplaced
    model's (the stacked model does not read sp; the layered one runs
    ring attention over the sequence parts)."""
    cfg = gpt_tiny(sequence_parallel=True, hidden_dropout=0.0,
                   attention_dropout=0.0, **cfg)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 1024, (2, 16)))

    def loss(m):
        if cls is GPTStackedForPretraining:
            return m(ids, labels=ids)
        return torch.nn.functional.cross_entropy(
            m(ids).flatten(0, 1), ids.flatten())

    want = loss(cls(cfg, device="cpu", seed=1))
    axes = dict(axes)
    n = int(np.prod(list(axes.values())))
    M.set_mesh(M.build_mesh(axes, [f"cpu:{i}" for i in range(n)] if own
                            else ["cpu"] * n))
    try:
        m = cls(cfg, seed=1, **({} if cfg.use_tensor_parallel else
                                {"device": "cpu"}))
        got = loss(m)
        got.backward()
    finally:
        M.set_mesh(None)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _sp_copies_replicated(axis):
    """dp replicas (``axis`` "dp") or ZeRO (``axis`` "sharding") of a
    layered GPT whose sp positions hold copies on devices of their own:
    built, each copy at its own (replica, sp) position."""
    from paddle_tpu_torch.distributed import DataParallel
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.distributed.shards import (
        copy_key, weight_bytes_by_position,
    )

    M.set_mesh(M.build_mesh({axis: 2, "sp": 2},
                            [f"cpu:{i}" for i in range(4)]))
    try:
        m = GPTForPretraining(gpt_tiny(sequence_parallel=True), device="cpu")
        if axis == "dp":
            m = DataParallel(m)
        else:
            group_sharded_parallel(m, AdamW(parameters=m.parameters()), "os")
        # ZeRO's bare model is one replica; its slice 1 lies at sharding 1
        want = [(0, 0), (0, 1), (1, 0)] + ([(1, 1)] if axis == "dp" else [])
        assert [copy_key(k) for k in weight_bytes_by_position(m)] == want
    finally:
        M.set_mesh(None)


def _placed_generate():
    """``generate()`` of the layered GPT placed on an mp mesh."""
    M.set_mesh(M.build_mesh({"mp": 2}, ["cpu"] * 2))
    try:
        m = GPTForPretraining(gpt_tiny(use_tensor_parallel=True))
        out = m.generate(np.array([[1, 2]]), 2, max_seq_len=16)
        assert tuple(out.shape) == (1, 4)
    finally:
        M.set_mesh(None)


def _placed_serving(knob):
    """Serving from the stacked GPT placed on a pp x mp mesh: per-request
    LoRA, a placed ``truncated_draft`` for speculation, or a serving mesh
    (``mesh=``), which takes the model off its training mesh."""
    M.set_mesh(M.build_mesh({"pp": 2, "mp": 2}, ["cpu"] * 4))
    try:
        m = GPTStackedForPretraining(gpt_tiny())
        kw = dict(num_slots=2, page_size=16, max_context=64)
        if knob == "lora":
            eng = ServingEngine(m, lora=_lora_pool(m.config), **kw)
            out = eng.generate_batch([[1, 2, 3]], 2, adapter="a")
        elif knob == "draft":
            eng = SpeculativeEngine(m, truncated_draft(m, 2), spec_k=2, **kw)
            out = eng.generate_batch([[1, 2, 3]], 2)
            assert eng.draft.model._train_mesh is not None
        else:
            out = ServingEngine(m, mesh=("cpu", "cpu"), **kw).generate_batch(
                [[1, 2, 3]], 2)
            assert m._train_mesh is None
        assert len(out[0]) == 5
    finally:
        M.set_mesh(None)


def _train_after_serving_mesh():
    """A training forward of a placed GPT after a serving mesh took it off
    its training mesh (its optimizer would hold the freed parts)."""
    M.set_mesh(M.build_mesh({"pp": 2}, ["cpu"] * 2))
    try:
        m = GPTStackedForPretraining(gpt_tiny())
        ServingEngine(m, mesh=("cpu",), num_slots=2, page_size=16,
                      max_context=64)
        ids = torch.zeros(2, 8, dtype=torch.long)
        m(ids, labels=ids)
    finally:
        M.set_mesh(None)


def _sharded_prefetch():
    """A batch placed over the dp axis: one block a replica."""
    from paddle_tpu_torch.io import DevicePrefetcher

    M.set_mesh(M.build_mesh({"dp": 2}, ["cpu"] * 2))
    try:
        batch = next(DevicePrefetcher(iter([np.arange(4)]),
                                      sharding=("dp",)))
        assert batch.on((1,)).tolist() == [2, 3]
    finally:
        M.set_mesh(None)


def _sep_step(fleet, st):
    """At sep 2 ``distributed_model`` gives the module itself, whose
    output is the module's."""
    from paddle_tpu_torch.nn.layers import Linear, init_weights

    lin = Linear(4, 4, device="cpu")
    # drawn weights: an allocated one may hold NaN, which equals nothing
    init_weights(lin, 0)
    model = fleet.distributed_model(lin)
    assert model is lin
    x = torch.ones((2, 4))
    assert torch.equal(model(x), lin(x))


def _pipelined():
    """Four microbatches over two pipeline stages on the CPU."""
    M.set_mesh(M.build_mesh({"pp": 2}, ["cpu"] * 2))
    try:
        m = GPTStackedForPretraining(gpt_tiny(hidden_dropout=0.0,
                                              attention_dropout=0.0), 4)
        ids = torch.zeros((4, 8), dtype=torch.long)
        m(ids, labels=ids).backward()
    finally:
        M.set_mesh(None)


def _layered_on(axes, **factory):
    """The layered GPT built under a mesh of ``axes`` (CPU positions)."""
    M.set_mesh(M.build_mesh(axes, ["cpu"] * int(np.prod(list(axes.values())))))
    try:
        GPTForPretraining(gpt_tiny(use_tensor_parallel=True), **factory)
    finally:
        M.set_mesh(None)


def _fleet(hybrid, use, **flags):
    """``use(fleet, strategy)`` after ``fleet.init`` at ``hybrid`` degrees
    on a mesh of CPU positions; ``flags`` set on the strategy."""
    from paddle_tpu_torch.distributed import fleet

    st = fleet.DistributedStrategy()
    st.hybrid_configs = dict(hybrid)
    st.pipeline_configs = {"accumulate_steps": 2, "micro_batch_size": 1}
    for k, v in flags.items():
        setattr(st, k, v)
    axes = {k[:-len("_degree")]: v for k, v in hybrid.items()}
    M.set_mesh(M.build_mesh(axes, ["cpu"] * int(np.prod(list(axes.values())))))
    try:
        fleet.init(is_collective=True, strategy=st)
        return use(fleet, st)
    finally:
        M.set_mesh(None)
        fleet.set_hybrid_communicate_group(None)


def _pipeline_layer(**kw):
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer,
    )
    from paddle_tpu_torch.nn.layers import Linear

    return PipelineLayer([LayerDesc(Linear, 4, 4, device="cpu")
                          for _ in range(4)], num_stages=2,
                         loss_fn=lambda o, y: ((o - y) ** 2).mean(), **kw)


def _fleet_train_batch(fleet, st):
    """The fleet recipe at pp 2 x mp 2 runs a train_batch."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        PipelineLayer,
    )
    from paddle_tpu_torch.models.gpt import (
        GPTDecoderLayer, GPTEmbeddings, GPTLMHead, GPTPretrainingCriterion,
    )
    from paddle_tpu_torch.nn.layers import LayerNorm, init_weights

    cfg = gpt_tiny(use_tensor_parallel=True, hidden_dropout=0.0,
                   attention_dropout=0.0)
    emb = GPTEmbeddings(cfg)
    pl = PipelineLayer([emb, GPTDecoderLayer(cfg), GPTDecoderLayer(cfg),
                        LayerNorm(cfg.hidden_size), GPTLMHead(emb)],
                       num_stages=2, loss_fn=GPTPretrainingCriterion(cfg))
    init_weights(pl, 0, cfg.initializer_range)
    model = fleet.distributed_model(pl)
    opt = fleet.distributed_optimizer(AdamW(parameters=pl.parameters()))
    ids = torch.zeros((2, 8), dtype=torch.long)
    assert torch.isfinite(model.train_batch((ids, ids), opt))


def _toy_train_batch(fleet, st, **kw):
    """The toy pipeline (with ``kw``) through ``distributed_model`` (under
    ``fleet.init``) or ``PipelineParallel`` runs a train_batch."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        PipelineParallel,
    )
    from paddle_tpu_torch.nn.layers import init_weights

    pl = _pipeline_layer(**kw)
    init_weights(pl, 0)

    class _Pipe:
        pipeline_configs = {"accumulate_steps": 2}

    model = fleet.distributed_model(pl) if fleet else PipelineParallel(
        pl, strategy=_Pipe())
    x = torch.ones((4, 4))
    assert torch.isfinite(model.train_batch(
        (x, x), AdamW(parameters=pl.parameters())))


def _meta_step(flag, want, **configs):
    """``distributed_optimizer`` under ``flag`` wraps ``Momentum`` in the
    meta-optimizer ``want``, which steps."""
    from paddle_tpu_torch.optimizer import Momentum

    def use(fleet, st):
        p = _params()
        opt = fleet.distributed_optimizer(Momentum(0.1, parameters=p))
        assert type(opt._inner_opt).__name__ == want
        p[0].grad = torch.ones(4)
        opt.step()
        assert bool((p[0] != 0).any()) or flag == "gradient_merge"
    _fleet(_PP_MP, use, **{flag: True}, **configs)


_PP_MP = {"dp_degree": 1, "pp_degree": 2, "mp_degree": 2}


def _sharded_step(fleet, st):
    """``distributed_model`` at sharding 2 gives ``DataParallel`` over two
    replicas, and ``group_sharded_parallel`` at ``p_g_os`` steps it."""
    from paddle_tpu_torch.distributed import DataParallel
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.nn.layers import Linear, init_weights

    lin = Linear(4, 4, device="cpu")
    init_weights(lin, 0)          # an allocated weight may not be finite
    model = fleet.distributed_model(lin)
    assert isinstance(model, DataParallel) and model.num_replicas == 2
    opt = fleet.distributed_optimizer(AdamW(parameters=model.parameters()))
    model, opt, _ = group_sharded_parallel(model, opt, "p_g_os")
    model(torch.ones((2, 4))).sum().backward()
    opt.step()
    assert torch.isfinite(model.state_dict()["weight"]).all()


def _auto_parallel_placed():
    """``shard_tensor`` then ``reshard`` on a CPU ``ProcessMesh``."""
    from paddle_tpu_torch.distributed import auto_parallel as ap

    pm = ap.ProcessMesh([[0, 1], [2, 3]], ["dp", "mp"], device="cpu")
    x = torch.arange(32.0).reshape(4, 8)
    placed = ap.shard_tensor(x, pm, [ap.Shard(0), ap.Shard(1)])
    assert placed.on((1, 1)).shape == (2, 4)
    assert torch.equal(ap.reshard(placed, pm, [ap.Replicate(),
                                               ap.Shard(0)]).gather(), x)


def _auto_parallel_converter():
    """A placed tensor saved and merged back by the converter."""
    import tempfile

    from paddle_tpu_torch.distributed import auto_parallel as ap

    pm = ap.ProcessMesh([0, 1], ["mp"], device="cpu")
    x = torch.arange(8.0).reshape(2, 4)
    with tempfile.TemporaryDirectory() as d:
        ap.save_distributed_checkpoint(
            {"w": ap.shard_tensor(x, pm, [ap.Shard(1)])}, d)
        assert torch.equal(ap.Converter.load(d).merge("w"), x)


def _auto_parallel_propagated():
    """A captured product propagated and run over a CPU mesh."""
    from paddle_tpu_torch.distributed import auto_parallel as ap

    pm = ap.ProcessMesh([0, 1], ["mp"], device="cpu")
    x, w = torch.ones((2, 4)), torch.ones((4, 6))
    run = ap.apply_propagation(torch.mm, pm, [None, ap.DistSpec((None, "mp"))],
                               x, w)
    assert torch.equal(run(x, w).gather(), x @ w)


def _auto_parallel_engine():
    """``Engine.plan`` over four CPU positions, then one ``fit`` step
    through the propagation executor."""
    from paddle_tpu_torch.distributed import auto_parallel as ap
    from paddle_tpu_torch.models import GPTPretrainingCriterion

    cfg = gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0)
    model = GPTForPretraining(cfg, device="cpu")
    eng = ap.Engine(model=model, loss=GPTPretrainingCriterion(cfg),
                    optimizer=AdamW(parameters=model.parameters()),
                    device="cpu", devices=["cpu"] * 4)
    n = sum(p.numel() for p in model.parameters())
    try:
        best = eng.plan(cluster=ap.ClusterSpec(n_devices=4, hbm_bytes=8 * n,
                                               flops=1e12))
        ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (4, 16))
        hist = eng.fit([(ids, ids)], verbose=0)
    finally:
        M.set_mesh(None)
    assert best.mesh["mp"] > 1 and np.isfinite(hist["loss"]).all()


def _auto_parallel_strategy():
    """A ``Strategy`` from a nested dict, and its refusal of a key."""
    from paddle_tpu_torch.distributed import auto_parallel as ap

    st = ap.Strategy({"amp": {"enable": True}, "seed": 3})
    assert st.amp.enable and st.to_dict()["seed"] == 3
    with pytest.raises(ValueError, match="unknown Strategy keys"):
        ap.Strategy({"bogus": 1})


# every refused knob: (how to provoke it, words its item's title must hold)
REFUSALS = {
    "training a placed gpt after a serving mesh took it": (
        _train_after_serving_mesh, "sharded engine"),
    "fleet init_server": (
        lambda: __import__("paddle_tpu_torch.distributed.fleet",
                           fromlist=["x"]).init_server(), "long-tail"),
    "predictor saved program": (
        lambda: inference.create_predictor(inference.Config("model")),
        "long-tail"),
}


# knobs refused until their item was ported: (how to use one, its item,
# words its title must hold); each is now taken, and its item's title
# says it is ported
PORTED = {
    "gpt n_micro": (_pipelined, 2, "training"),
    "layered gpt sp copies under dp replicas": (
        lambda: _sp_copies_replicated("dp"), 9, "sequence parallelism"),
    "layered gpt sp copies under zero": (
        lambda: _sp_copies_replicated("sharding"), 9,
        "sequence parallelism"),
    "engine mesh": (lambda: _engine_step(mesh=("cpu", "cpu")), 9,
                    "sharded"),
    "engine role": (lambda: _engine_step(role="prefill"), 9,
                    "disaggregated"),
    "engine lora over head shards": (
        lambda: _engine_step(mesh=("cpu", "cpu"), lora="pool"), 9,
        "sharded"),
    "engine prefix_cache": (lambda: _engine_step(prefix_cache=True), 6,
                            "prefix cache"),
    "engine stall_budget_s": (lambda: _engine_step(stall_budget_s=1.0), 7,
                              "watchdog"),
    "engine compile_budget_s": (
        lambda: _engine_step(compile_budget_s=300.0), 7, "watchdog"),
    "engine readmission_backoff_s": (
        lambda: _engine_step(readmission_backoff_s=0.05), 7, "watchdog"),
    "engine backoff_max_s": (lambda: _engine_step(backoff_max_s=5.0), 7,
                             "watchdog"),
    "gpt forward lora": (_gpt_paged_lora, 8, "lora"),
    "fused_train_step amp O1 over fp32": (
        lambda: FusedTrainStep(lambda: None, AdamW(parameters=_params()),
                               amp_level="O1"), 2, "training"),
    "engine lora": (lambda: _engine_step(lora="pool"), 8, "lora"),
    "quantize_for_serving layered": (_layered_quantized, 4,
                                     "quantized serving"),
    "lora pool stacked=False": (
        lambda: _engine_step(GPTForPretraining, lora="pool"), 3,
        "layered gpt"),
    "engine layered gpt": (lambda: _engine_step(GPTForPretraining), 3,
                           "layered gpt"),
    "generate layered gpt": (
        lambda: GPTForPretraining(gpt_tiny(), device="cpu").generate(
            np.array([[1, 2]]), 2, max_seq_len=16), 3, "layered gpt"),
    "predictor decode mode": (
        lambda: _predictor("decode"), 3, "predictor"),
    "predictor serving mode": (
        lambda: _predictor("serving"), 3, "predictor"),
    "fleet train_batch at pp 2 x mp 2": (
        lambda: _fleet(_PP_MP, _fleet_train_batch), 9, "fleet"),
    "fleet distributed_model dp": (
        lambda: _fleet({"dp_degree": 2, "pp_degree": 2}, _toy_train_batch),
        9, "fleet"),
    "pipeline layer recompute_interval": (
        lambda: _toy_train_batch(None, None, recompute_interval=1), 9,
        "fleet"),
    "pipeline layer virtual stages": (
        lambda: _toy_train_batch(None, None, num_virtual_pipeline_stages=2),
        9, "fleet"),
    "fleet lars": (lambda: _meta_step("lars", "LarsMomentum"), 9, "fleet"),
    "fleet dgc": (lambda: _meta_step("dgc", "DGCMomentum"), 9, "fleet"),
    "fleet localsgd": (lambda: _meta_step("localsgd", "LocalSGD"), 9,
                       "fleet"),
    "fleet gradient_merge": (
        lambda: _meta_step("gradient_merge", "GradientMerge",
                           gradient_merge_configs={"k_steps": 2}), 9,
        "fleet"),
    "layered gpt on a sharding axis": (
        lambda: _layered_on({"sharding": 2}, device="cpu"), 9,
        "mesh training"),
    "fleet distributed_model sharding": (
        lambda: _fleet({"sharding_degree": 2}, _sharded_step), 9, "fleet"),
    "gpt sequence_parallel": (_sequence_parallel, 9, "sequence parallelism"),
    "layered gpt on an sp axis": (
        lambda: _sequence_parallel(GPTForPretraining,
                                   (("sp", 2), ("mp", 2)),
                                   use_tensor_parallel=True), 9,
        "sequence parallelism"),
    "layered gpt sp positions on cards of their own": (
        lambda: _sequence_parallel(GPTForPretraining,
                                   (("sp", 2), ("mp", 2)), own=True,
                                   use_tensor_parallel=True), 9,
        "sequence parallelism"),
    "layered gpt on a sep axis": (
        lambda: _layered_on({"sep": 2}, device="cpu"), 9,
        "sequence parallelism"),
    "fleet distributed_model sep": (
        lambda: _fleet({"sep_degree": 2}, _sep_step), 9, "fleet"),
    "fleet distributed_model sep with sharding": (
        lambda: _fleet({"sharding_degree": 2, "sep_degree": 2},
                       _sharded_step), 9, "fleet"),
    "layered gpt generate on a mesh": (
        _placed_generate, 9, "generation from a training mesh"),
    "placed gpt lora": (lambda: _placed_serving("lora"), 9,
                        "placed model with lora"),
    "placed gpt truncated_draft": (lambda: _placed_serving("draft"), 9,
                                   "drafts"),
    "engine mesh over a placed gpt": (lambda: _placed_serving("mesh"), 9,
                                      "sharded engine"),
    "device prefetcher sharding": (_sharded_prefetch, 9, "placed batches"),
    "auto_parallel shard_tensor and reshard": (_auto_parallel_placed, 9,
                                               "auto_parallel"),
    "auto_parallel converter": (_auto_parallel_converter, 9,
                                "auto_parallel"),
    "auto_parallel propagation": (_auto_parallel_propagated, 9,
                                  "auto_parallel"),
    "auto_parallel engine": (_auto_parallel_engine, 9, "auto_parallel"),
    "auto_parallel strategy": (_auto_parallel_strategy, 9, "auto_parallel"),
}


def test_lora_pool_defaults_to_the_layered_layout():
    """The reference's default (``stacked=False``); a pool whose layout is
    not the model's is refused when the engine is built."""
    cfg = gpt_tiny()
    assert not LoRAAdapterPool(cfg, device="cpu").stacked
    for cls, stacked in ((GPTStackedForPretraining, False),
                         (GPTForPretraining, True)):
        pool = LoRAAdapterPool(cfg, stacked=stacked, device="cpu")
        with pytest.raises(ValueError, match="layout"):
            ServingEngine(cls(cfg, device="cpu"), lora=pool, num_slots=2,
                          page_size=16, max_context=64)


@pytest.mark.parametrize("flag", ["lars", "dgc"])
def test_lars_and_dgc_refuse_adamw(flag):
    """The reference's selection pass: LARS and DGC take a momentum-family
    optimizer; ``AdamW`` raises its ``ValueError``."""
    with pytest.raises(ValueError, match="momentum-family"):
        _fleet(_PP_MP, lambda f, st: f.distributed_optimizer(
            AdamW(parameters=_params())), **{flag: True})


@pytest.mark.parametrize("knob", sorted(REFUSALS) + sorted(PORTED))
def test_refusals_name_their_roadmap_item(knob):
    titles = _roadmap_queue1()
    if knob in PORTED:
        use, item, words = PORTED[knob]
        use()
        title = titles[item].lower()
        assert words in title and "ported in pr" in title, \
            f"{knob}: item {item} is {titles[item]!r}"
        return
    provoke, words = REFUSALS[knob]
    with pytest.raises(NotImplementedError) as info:
        provoke()
    found = re.search(r"ROADMAP\.md queue 1, item (\d+)", str(info.value))
    assert found, f"{knob}: {info.value}"
    item = int(found.group(1))
    assert item in titles, f"{knob}: ROADMAP.md queue 1 has no item {item}"
    assert words in titles[item].lower(), \
        f"{knob}: item {item} is {titles[item]!r}, not {words!r}"
