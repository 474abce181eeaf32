"""Package boundaries of the PyTorch port: it imports neither JAX nor
anything of ``paddle_tpu`` (checked in a fresh interpreter, for the
package and for ``chip_smoke.py``), its entry points refuse to run on the
CPU unless asked, ``chip_smoke.py`` refuses to run without a card, and
the engine knobs that wait for later slices raise."""
import os
import subprocess
import sys

import pytest
import torch

from paddle_tpu_torch.models import GPTStackedForPretraining, gpt_tiny
from paddle_tpu_torch.serving import ServingEngine

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
    ("prefix_cache", True),
    ("kv_dtype", "int8"),
    ("kv_dtype", "bfloat16"),
    ("cache_dtype", "int8"),
    ("weight_dtype", "int8"),
    ("stall_budget_s", 1.0),
    ("lora", object()),
    ("mesh", object()),
    ("role", "prefill"),
])
def test_unported_engine_knobs_raise(knob, value):
    m = GPTStackedForPretraining(gpt_tiny(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ServingEngine(m, num_slots=2, page_size=16, max_context=64,
                      **{knob: value})

