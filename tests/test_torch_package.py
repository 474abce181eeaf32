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

from paddle_tpu_torch.models import GPTStackedForPretraining, gpt_tiny
from paddle_tpu_torch.optimizer import AdamW, FusedTrainStep
from paddle_tpu_torch.quantization import quantize_for_serving
from paddle_tpu_torch.serving import (
    LoRAAdapterPool, ServingEngine, random_adapter,
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
    m = GPTStackedForPretraining(gpt_tiny(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ServingEngine(m, num_slots=2, page_size=16, max_context=64,
                      **{knob: value})


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


def _lora_pool(cfg):
    pool = LoRAAdapterPool(cfg, num_adapter_pages=2, rank=2, device="cpu")
    pool.register("a", random_adapter(cfg, 2, np.random.RandomState(0)))
    return pool


def _engine_step(**kw):
    """Construct an engine with ``kw`` and step it once over one request
    (on the LoRA pool's adapter when there is one): the knob is taken."""
    m = GPTStackedForPretraining(gpt_tiny(), device="cpu")
    if kw.get("lora") == "pool":
        kw["lora"] = _lora_pool(m.config)
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



class _Layered(torch.nn.Module):
    gpt = object()          # the layered GPT's shape, not ported


# every refused knob: (how to provoke it, words its item's title must hold)
REFUSALS = {
    "engine mesh": (lambda: _engine(mesh=object()), "sharded"),
    "engine role": (lambda: _engine(role="prefill"), "disaggregated"),
    "fused_train_step amp O1 over fp32": (
        lambda: FusedTrainStep(lambda: None, AdamW(_params()),
                               amp_level="O1"), "training"),
    "quantize_for_serving layered": (lambda: quantize_for_serving(_Layered()),
                                     "quantized serving"),
}


# knobs refused until their item was ported: (how to use one, its item,
# words its title must hold); each is now taken, and its item's title
# says it is ported
PORTED = {
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
    "engine lora": (lambda: _engine_step(lora="pool"), 8, "lora"),
}


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
