"""The port's public signatures in the reference's argument order, held
against the JAX package on the CPU.

- ``nn.functional.dropout(x, p, axis, training, mode)``: a positional
  ``axis`` is an axis (not ``training``): ``dropout(x, 0.5, None)`` drops
  about half of the elements, ``dropout(x, 0.5, 1)`` drops whole columns,
  as the reference does.  The bits differ (PyTorch's generator against
  threefry), so the masks are held by shape and by a binomial bound on
  the kept share, and the kept values exactly: ``x / (1 - p)`` in
  ``"upscale_in_train"``, ``x`` in ``"downscale_in_infer"`` (whose eval
  multiplies by ``1 - p``, as the reference's does, exactly).  The layer
  ``nn.layers.Dropout(p, axis, mode)`` the same.
- ``nn.functional.cross_entropy(input, label, weight, ...)``: a positional
  ``weight`` weighs the classes, with the reference's weighted mean;
  ``soft_label``, ``use_softmax=False``, ``label_smoothing`` and
  ``ignore_index`` with and without weights, each reduction: fp32 within
  1e-6 relative of the JAX function (the same formula).
- ``optimizer.AdamW(learning_rate, beta1, beta2, epsilon, parameters,
  ...)``: ``AdamW(1e-3, parameters=ps)`` runs and updates as the JAX
  ``AdamW(1e-3, parameters=...)`` does; ``lazy_mode=True`` raises by
  name.
- ``GPTStackedForPretraining(cfg, n_micro=1, *, device, ...)``: a
  positional 1 is ``n_micro`` and the model equals the JAX
  ``GPTStackedForPretraining(cfg, 1)``'s logits on the same weights;
  ``n_micro`` > 1 raises naming ROADMAP.md queue 1, item 2."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import GPTStackedForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn import functional as jF

from paddle_tpu_torch.models import GPTStackedForPretraining, gpt_tiny
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import Dropout
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(2)


def _binomial_ok(kept, n, p):
    return abs(kept / n - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)


def _jax_dropout(x, *args, **kw):
    pt.seed(0)
    return np.asarray(jF.dropout(pt.to_tensor(x), *args, **kw).numpy())


def _port_dropout(x, *args, **kw):
    return F.dropout(torch.from_numpy(x), *args,
                     generator=torch.Generator().manual_seed(0), **kw).numpy()


def test_positional_axis_none_drops_about_half_as_the_reference():
    """``dropout(x, 0.5, None)`` on ones: the third positional argument is
    ``axis``, so training stays on and about half the elements drop, in
    both packages; each kept element is 2."""
    x = np.ones((64, 96), np.float32)
    for out in (_jax_dropout(x, 0.5, None), _port_dropout(x, 0.5, None)):
        kept = out != 0
        assert _binomial_ok(kept.sum(), kept.size, 0.5)
        np.testing.assert_array_equal(out[kept], 2.0)


@pytest.mark.parametrize("axis", [1, [0], [0, 2]])
def test_positional_axis_drops_whole_slices_as_the_reference(axis):
    """``dropout(x, 0.5, axis)``: one mask over the named axes, broadcast
    over the others -- every slice along the other axes is all kept or all
    dropped, in both packages."""
    x = np.ones((8, 64, 6), np.float32)
    axes = axis if isinstance(axis, list) else [axis]
    others = tuple(i for i in range(3) if i not in axes)
    for out in (_jax_dropout(x, 0.5, axis), _port_dropout(x, 0.5, axis)):
        kept = out != 0
        assert np.all(kept.all(axis=others) == kept.any(axis=others))
        n = int(np.prod([x.shape[a] for a in axes]))
        assert _binomial_ok(kept.any(axis=others).sum(), n, 0.5)


def test_downscale_in_infer_matches_the_reference():
    """``mode="downscale_in_infer"``: training keeps values unscaled, eval
    multiplies by ``1 - p`` (the JAX function's output exactly)."""
    x = np.random.RandomState(3).randn(32, 48).astype(np.float32)
    for out in (_jax_dropout(x, 0.25, None, True, "downscale_in_infer"),
                _port_dropout(x, 0.25, None, True, "downscale_in_infer")):
        kept = out != 0
        assert _binomial_ok(kept.sum(), kept.size, 0.25)
        np.testing.assert_array_equal(out[kept], x[kept])
    want = _jax_dropout(x, 0.25, None, False, "downscale_in_infer")
    np.testing.assert_array_equal(
        _port_dropout(x, 0.25, None, False, "downscale_in_infer"), want)
    np.testing.assert_array_equal(_port_dropout(x, 0.25, None, False), x)
    with pytest.raises(ValueError, match="mode"):
        _port_dropout(x, 0.25, None, True, "scale")


def test_dropout_layer_takes_the_reference_order():
    """``Dropout(p, axis, mode)``: the layer's positional arguments are
    the reference layer's; in eval it applies the mode's inference rule
    as the JAX layer does."""
    x = np.random.RandomState(4).randn(16, 32).astype(np.float32)
    layer = Dropout(0.5, 1, "downscale_in_infer")
    out = layer(torch.from_numpy(x)).numpy()
    kept = out != 0
    assert np.all(kept.all(axis=0) == kept.any(axis=0))
    np.testing.assert_array_equal(out[kept], x[kept])
    jlayer = pt.nn.Dropout(0.5, 1, "downscale_in_infer")
    jlayer.eval()
    layer.eval()
    np.testing.assert_array_equal(
        layer(torch.from_numpy(x)).numpy(),
        np.asarray(jlayer(pt.to_tensor(x)).numpy()))


def _ce_inputs(seed=0, n=5, c=5):
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, c).astype(np.float32)
    label = rng.randint(0, c, (n,)).astype(np.int64)
    weight = np.arange(1, c + 1, dtype=np.float32)
    return logits, label, weight


def test_positional_weight_is_the_class_weight():
    """``cross_entropy(logits, label, weight)``: the third positional
    argument weighs the classes (the reference's weighted mean), not
    ``ignore_index``; the unweighted loss differs."""
    logits, label, weight = _ce_inputs()
    want = float(jF.cross_entropy(pt.to_tensor(logits), pt.to_tensor(label),
                                  pt.to_tensor(weight)).numpy())
    got = float(F.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(label),
                                torch.from_numpy(weight)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    plain = float(F.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(label)))
    assert abs(plain - want) > 1e-3


CE_CASES = {
    "weight ignore": dict(weight=True, ignore_index=2),
    "smoothing": dict(label_smoothing=0.1),
    "weight smoothing": dict(weight=True, label_smoothing=0.2),
    "no softmax": dict(use_softmax=False),
    "soft label": dict(soft_label=True),
    "soft label smoothing": dict(soft_label=True, label_smoothing=0.1),
}


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_cross_entropy_options_match_jax(case, reduction):
    opts = dict(CE_CASES[case])
    logits, label, weight = _ce_inputs(seed=1, n=7, c=6)
    if opts.pop("weight", False):
        opts["weight"] = weight
    if opts.get("soft_label"):
        rng = np.random.RandomState(2)
        label = rng.rand(7, 6).astype(np.float32)
        label /= label.sum(-1, keepdims=True)
    if opts.get("use_softmax") is False:
        logits = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    jkw = {k: pt.to_tensor(v) if k == "weight" else v
           for k, v in opts.items()}
    tkw = {k: torch.from_numpy(v) if k == "weight" else v
           for k, v in opts.items()}
    want = np.asarray(jF.cross_entropy(pt.to_tensor(logits),
                                       pt.to_tensor(label),
                                       reduction=reduction, **jkw).numpy())
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(label),
                          reduction=reduction, **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_adamw_takes_the_learning_rate_first():
    """``AdamW(1e-3, parameters=ps)``: three steps on the same gradients
    give the JAX optimizer's parameters (fp32, 1e-6 relative)."""
    rng = np.random.RandomState(5)
    w0 = rng.randn(6, 4).astype(np.float32)
    grads = [rng.randn(6, 4).astype(np.float32) for _ in range(3)]
    jw = pt.to_tensor(w0)
    jw.stop_gradient = False
    jopt = pt.optimizer.AdamW(1e-3, parameters=[jw])
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    topt = AdamW(1e-3, parameters=[tw])
    for g in grads:
        (jw * pt.to_tensor(g)).sum().backward()
        jopt.step()
        jopt.clear_grad()
        tw.grad = torch.from_numpy(g)
        topt.step()
        topt.zero_grad()
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw.numpy()),
                               rtol=1e-6)
    with pytest.raises(NotImplementedError, match="lazy_mode"):
        AdamW(1e-3, parameters=[tw], lazy_mode=True)
    with pytest.raises(ValueError, match="parameters"):
        AdamW(1e-3)


def test_gpt_takes_n_micro_second():
    """``GPTStackedForPretraining(cfg, 1)``: the second positional argument
    is ``n_micro``; the model gives the JAX model's logits on the same
    weights.  More than one microbatch is taken since the pipeline was
    ported: without a mesh it has no effect, as in the reference (the same
    logits); ``n_micro`` below 1 raises."""
    cfg = dict(hidden_dropout=0.0, attention_dropout=0.0)
    pt.seed(0)
    jm = JaxGPT(jax_gpt_tiny(**cfg), 1)
    tm = GPTStackedForPretraining(gpt_tiny(**cfg), 1, device="cpu")
    tm.load_jax_state({k: np.asarray(v.numpy())
                       for k, v in jm.state_dict().items()})
    ids = np.random.RandomState(6).randint(0, 1024, (2, 16))
    jm.eval()
    tm.eval()
    want = np.asarray(jm(pt.to_tensor(ids, dtype="int64")).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    tm2 = GPTStackedForPretraining(gpt_tiny(**cfg), 2, device="cpu")
    assert tm2.n_micro == 2
    tm2.load_state_dict(tm.state_dict())
    tm2.eval()
    with torch.no_grad():
        assert torch.equal(tm2(torch.from_numpy(ids)), torch.from_numpy(got))
    with pytest.raises(ValueError, match="n_micro=0"):
        GPTStackedForPretraining(gpt_tiny(**cfg), 0, device="cpu")
