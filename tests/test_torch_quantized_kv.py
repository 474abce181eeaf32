"""The port's quantizers held against the JAX package on the CPU, bit for
bit: the int8 KV write (``quantize_kv_write``) and read
(``dequant_pages``), the int8 product (``quantized_matmul`` against
``quantized_matmul_raw``), and the weight quantizers of serving
(``GPTStackedDecoder.quantize_weights`` and the tied LM head's, against
``quantize_for_serving`` of the JAX stacked GPT).  Every one of them is a
chain of correctly rounded fp32 ops (abs, max, a division by 127, an add,
a division, round-half-even, a clip) or an exact int32 sum, so equality
is exact; a division that XLA's CPU code rounded differently would show
as one int8 step, and the tests would say so.

Then the write contract's own cases, as ``tests/test_quantized_serving.py``
states them for the JAX quantizer: a fresh page's scale is the step's
absmax, a stale page keeps its scale and clips, identical writes give
identical pages and scales, zero pages dequantize to zeros, and the int8
product is batch-invariant."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.models import GPTStackedForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.quantization import kv as jkv
from paddle_tpu.quantization.int8 import (
    quantize_for_serving as jax_quantize_for_serving, quantized_matmul_raw,
)

from paddle_tpu_torch.models import (
    GPTForPretraining, GPTStackedForPretraining, gpt_tiny,
)
from paddle_tpu_torch.quantization import (
    TINY_SCALE, dequant_pages, quantize_for_serving, quantize_kv_write,
    quantized_matmul,
)

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# against the JAX functions, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_quantize_kv_write_matches_jax_bitwise(seed):
    """Fresh and stale pages mixed, duplicate page ids within the step,
    zero-sentinel pages, and values from 1e-3 to 30 in size."""
    rng = np.random.RandomState(seed)
    s, c, h, d, p = 3, 16, 4, 16, 7
    x = (rng.randn(s, c, h, d) * [1e-3, 1.0, 30.0][seed % 3]).astype(
        np.float32)
    pid = rng.randint(0, p, (s, c)).astype(np.int32)
    offs = rng.randint(0, 4, (s, c)).astype(np.int32)
    scale = (np.abs(rng.randn(p, h)) * (rng.rand(p, h) > 0.4)).astype(
        np.float32)
    jq, js = jkv.quantize_kv_write(jnp.asarray(x), jnp.asarray(pid),
                                   jnp.asarray(offs), jnp.asarray(scale))
    ts = _t(scale.copy())
    tq, ts2 = quantize_kv_write(_t(x), _t(pid), _t(offs), ts)
    assert ts2 is ts                       # updated in place
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    steps = np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int))
    assert steps.max() == 0, f"{(steps > 0).sum()} elements one int8 step off"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_write_takes_the_weight_dtype(dtype):
    """A bf16 model's K/V rows quantize from their bf16 values, as the
    reference's ``x.astype(float32)`` does."""
    rng = np.random.RandomState(11)
    x = rng.randn(2, 16, 2, 8).astype(np.float32)
    pid = np.array([[1] * 16, [2] * 16], np.int32)
    offs = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jq, js = jkv.quantize_kv_write(jx, jnp.asarray(pid), jnp.asarray(offs),
                                   jnp.zeros((4, 2), jnp.float32))
    tq, ts = quantize_kv_write(_t(x).to(getattr(torch, dtype)), _t(pid),
                               _t(offs), torch.zeros(4, 2))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_dequant_pages_matches_jax_bitwise():
    rng = np.random.RandomState(2)
    pool = rng.randint(-127, 128, (5, 3, 8, 16)).astype(np.int8)
    scale = rng.rand(5, 3).astype(np.float32) * 0.05
    want = np.asarray(jkv.dequant_pages(jnp.asarray(pool),
                                        jnp.asarray(scale)))
    np.testing.assert_array_equal(dequant_pages(_t(pool), _t(scale)).numpy(),
                                  want)


@pytest.mark.parametrize("m,k,n,bias,act", [
    (8, 64, 192, True, None), (5, 128, 40, False, None),
    (33, 256, 1024, True, None), (4, 64, 64, True, 0.05)])
def test_quantized_matmul_matches_jax_bitwise(m, k, n, bias, act):
    rng = np.random.RandomState(m + n)
    x = (rng.randn(2, m, k) * 3).astype(np.float32)    # [..., K] inputs
    w = rng.randn(k, n).astype(np.float32)
    ws = (np.abs(w).max(axis=0) / 127.0 + 1e-12).astype(np.float32)
    wq = np.clip(np.round(w / ws), -127, 127).astype(np.int8)
    b = rng.randn(n).astype(np.float32) if bias else None
    want = np.asarray(quantized_matmul_raw(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws),
        None if b is None else jnp.asarray(b), act_scale=act))
    got = quantized_matmul(_t(x), _t(wq), _t(ws),
                           None if b is None else _t(b), act_scale=act)
    assert got.dtype == torch.float32 and got.shape == (2, m, n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def quantized_pair():
    """A JAX stacked gpt_tiny quantized by ``quantize_for_serving`` and the
    port's model carrying its fp weights, quantized by the port."""
    pt.seed(7)
    jm = JaxGPT(jax_gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0))
    jm.eval()
    fp = {k: np.asarray(v.numpy(), np.float32)
          for k, v in jm.state_dict().items()}
    jax_quantize_for_serving(jm)
    tm = GPTStackedForPretraining(gpt_tiny(), device="cpu", dtype="float32")
    tm.load_jax_state(fp)
    assert quantize_for_serving(tm) is tm and tm.weight_int8
    return jm, tm


@pytest.mark.parametrize("name", [
    "decoder.qkv_w_int8", "decoder.qkv_w_s", "decoder.proj_w_int8",
    "decoder.proj_w_s", "decoder.fc1_w_int8", "decoder.fc1_w_s",
    "decoder.fc2_w_int8", "decoder.fc2_w_s", "lm_head_int8",
    "lm_head_scale"])
def test_weight_quantizers_match_jax_bitwise(quantized_pair, name):
    jm, tm = quantized_pair
    want = np.asarray(jm.state_dict()[name].numpy())
    got = dict(tm.named_buffers())[name]
    assert got.dtype == (torch.int8 if name.endswith("int8")
                         else torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_for_serving_is_idempotent_and_refuses_other_models(
        quantized_pair):
    _, tm = quantized_pair
    before = {k: v.clone() for k, v in tm.named_buffers()}
    quantize_for_serving(tm)
    assert all(torch.equal(before[k], v) for k, v in tm.named_buffers())

    # the layered GPT is quantized too (Int8Linear), no longer refused
    layered = quantize_for_serving(GPTForPretraining(gpt_tiny(),
                                                     device="cpu"))
    assert layered.weight_int8
    with pytest.raises(ValueError, match="GPTStackedForPretraining"):
        quantize_for_serving(torch.nn.Linear(2, 2))


# ---------------------------------------------------------------------------
# the write contract (tests/test_quantized_serving.py:75-154)
# ---------------------------------------------------------------------------

def test_fresh_page_scale_is_step_absmax():
    P, H, D, C = 4, 2, 8, 16
    rng = np.random.RandomState(0)
    x = _t(rng.randn(1, C, H, D).astype(np.float32))
    pid = torch.full((1, C), 2, dtype=torch.int32)
    offs = torch.arange(C, dtype=torch.int32)[None]
    q, s = quantize_kv_write(x, pid, offs, torch.zeros(P, H))
    want = x[0].abs().amax(dim=(0, 2)) / 127.0 + TINY_SCALE
    np.testing.assert_allclose(s[2].numpy(), want.numpy(), rtol=1e-6)
    # untouched pages keep the zero sentinel
    assert float(s[[0, 1, 3]].abs().max()) == 0.0
    # the round trip is off by at most half a quantization step per head
    deq = q[0].float() * s[2][None, :, None]
    assert float((deq - x[0]).abs().max()) <= float(s[2].max()) * 0.51


def test_stale_page_keeps_scale_and_clips():
    P, H, D = 4, 2, 8
    one = torch.ones((1, 1), dtype=torch.int32)
    # an offset-0 write of SMALL values fixes the page's scale ...
    _, s0 = quantize_kv_write(torch.full((1, 1, H, D), 0.1), one,
                              torch.zeros((1, 1), dtype=torch.int32),
                              torch.zeros(P, H))
    before = s0.clone()
    # ... then a LARGER decode token at offset 3: the scale must not move,
    # and the payload clips to +127
    q1, s1 = quantize_kv_write(torch.full((1, 1, H, D), 5.0), one,
                               torch.full((1, 1), 3, dtype=torch.int32), s0)
    assert torch.equal(s1, before)
    assert int(q1.min()) == 127


def test_quantize_kv_write_is_deterministic():
    rng = np.random.RandomState(3)
    x = _t(rng.randn(2, 16, 2, 8).astype(np.float32))
    pid = _t(rng.randint(1, 5, (2, 16)).astype(np.int32))
    offs = _t(np.tile(np.arange(16, dtype=np.int32), (2, 1)))
    outs = [quantize_kv_write(x, pid, offs, torch.zeros(6, 2))
            for _ in range(2)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_dequant_zero_pages_are_zero():
    pool = torch.zeros((3, 2, 4, 8), dtype=torch.int8)
    assert float(dequant_pages(pool, torch.zeros(3, 2)).abs().max()) == 0.0


def test_quantized_matmul_is_batch_invariant():
    """Per-row activation scales: a token's quantization grid never depends
    on its batch neighbours, so a batched step reproduces a single
    request's result bit for bit."""
    rng = np.random.RandomState(4)
    w = rng.randn(16, 8).astype(np.float32)
    ws = (np.abs(w).max(axis=0) / 127.0 + 1e-12).astype(np.float32)
    wq = _t(np.clip(np.round(w / ws), -127, 127).astype(np.int8))
    x1 = rng.randn(1, 16).astype(np.float32)
    x2 = rng.randn(3, 16).astype(np.float32) * 50.0   # huge batch-mates
    solo = quantized_matmul(_t(x1), wq, _t(ws))
    batched = quantized_matmul(_t(np.concatenate([x1, x2])), wq, _t(ws))
    assert torch.equal(solo[0], batched[0])
