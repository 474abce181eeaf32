"""The port's fused transformer layers (``paddle_tpu_torch.incubate``)
held against the JAX package's (``paddle_tpu.incubate.nn``) on the CPU,
mirroring ``tests/test_fused_layers.py``.

The JAX layers' weights are carried across with ``load_jax_state`` and
the same numpy inputs go through both.  On the CPU the post-LN layers'
fused add + LayerNorm is the plain version of the port's kernel (the add
in fp32) and the JAX package's ``reference`` (the add in x's dtype); in
fp32 the two are the same arithmetic, so every comparison here is fp32:
1e-5 absolute plus 1e-4 relative (sums of up to 256 terms taken in
another order, through two layers), as the JAX test holds its layers to
the numpy composition.  Dropout is held by property, not against JAX's
bits, except in ``FusedMultiTransformer``'s training step, which is held
to the JAX layer's gradients with both sides' mask draws patched, in the
test only, to one fixed numpy mask per (shape, keep probability), as
``tests/test_torch_gpt_training.py`` holds the stacked GPT."""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.incubate import nn as jnn

from paddle_tpu_torch.incubate import (
    FusedFeedForward, FusedLinear, FusedMultiHeadAttention,
    FusedMultiTransformer,
)
from paddle_tpu_torch.nn.functional import common as tcommon
from paddle_tpu_torch.ops.kernels import rms_norm as trn

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)


def _carry(jax_layer, port_layer):
    port_layer.load_jax_state({k: v.numpy() for k, v in
                               jax_layer.state_dict().items()})
    return port_layer


def _np_ln(v, g, b, eps):
    mu = v.mean(-1, keepdims=True)
    d = v - mu
    var = (d * d).mean(-1, keepdims=True)
    return d / np.sqrt(var + eps) * g + b


def _np(t):
    return t.detach().numpy()


def _layers(normalize_before, embed=128, heads=2, ffn=256, seed=5,
            activation="relu", dropout=0.3):
    """A JAX (MHA, FFN) pair and the port's, carrying the JAX weights."""
    pt.seed(seed)
    kw = dict(normalize_before=normalize_before)
    jm = jnn.FusedMultiHeadAttention(embed, heads, dropout_rate=dropout,
                                     attn_dropout_rate=0.0, **kw)
    jf = jnn.FusedFeedForward(embed, ffn, dropout_rate=dropout,
                              activation=activation, **kw)
    tm = _carry(jm, FusedMultiHeadAttention(embed, heads, dropout, 0.0,
                                            device="cpu", **kw))
    tf = _carry(jf, FusedFeedForward(embed, ffn, dropout,
                                     activation=activation, device="cpu",
                                     **kw))
    for m in (jm, jf, tm, tf):
        m.eval()
    return (jm, jf), (tm, tf)


def test_fused_multi_transformer_matches_composition():
    """The port's stacked block equals the plain pre-LN composition in
    numpy with its own weights, and the JAX layer with the same weights."""
    E, NH, FFN, L = 16, 2, 32, 2
    pt.seed(3)
    jm = jnn.FusedMultiTransformer(embed_dim=E, num_heads=NH,
                                   dim_feedforward=FFN, num_layers=L,
                                   dropout_rate=0.0)
    m = _carry(jm, FusedMultiTransformer(E, NH, FFN, num_layers=L,
                                         device="cpu"))
    jm.eval()
    m.eval()
    x = np.random.RandomState(0).randn(2, 4, E).astype(np.float32)
    d = {k: _np(v) for k, v in m.decoder.named_parameters()}
    h = x.copy()
    for li in range(L):
        xx = _np_ln(h, d["ln1_g"][li], d["ln1_b"][li], 1e-5)
        B, S, _ = xx.shape
        hd = E // NH
        qkv = (xx @ d["qkv_w"][li] + d["qkv_b"][li]).reshape(B, S, 3, NH, hd)
        q, k, v = (np.swapaxes(qkv[:, :, i], 1, 2) for i in range(3))
        scores = np.einsum("bnqd,bnkd->bnqk", q, k) / np.sqrt(hd)
        scores = np.where(np.tril(np.ones((S, S), bool)), scores, -1e9)
        att = np.exp(scores - scores.max(-1, keepdims=True))
        att = att / att.sum(-1, keepdims=True)
        out = np.swapaxes(np.einsum("bnqk,bnkd->bnqd", att, v), 1,
                          2).reshape(B, S, E)
        h = h + (out @ d["proj_w"][li] + d["proj_b"][li])
        y = _np_ln(h, d["ln2_g"][li], d["ln2_b"][li], 1e-5) @ d["fc1_w"][li] \
            + d["fc1_b"][li]
        # the stacked block's tanh-approximate GELU
        gelu = 0.5 * y * (1 + np.tanh(np.sqrt(2 / np.pi)
                                      * (y + 0.044715 * y ** 3)))
        h = h + (gelu @ d["fc2_w"][li] + d["fc2_b"][li])
    expect = _np_ln(h, _np(m.norm.weight), _np(m.norm.bias), 1e-5)
    got = _np(m(torch.from_numpy(x)))
    np.testing.assert_allclose(got, expect, **TOL)
    np.testing.assert_allclose(got, jm(pt.to_tensor(x)).numpy(), **TOL)


def test_fused_multi_transformer_takes_the_references_arguments():
    """The reference's positional order (src, attn_mask, caches,
    pre_caches, rotary_embs, rotary_emb_dims, seq_lens, time_step, name):
    rotary_embs, rotary_emb_dims, seq_lens and name are accepted and
    ignored, as the JAX layer ignores them (its source reads none of them
    past the signature), and the result is the JAX layer's."""
    import inspect

    src = inspect.getsource(jnn.FusedMultiTransformer.forward)
    params = list(inspect.signature(
        jnn.FusedMultiTransformer.forward).parameters)
    assert params == list(inspect.signature(
        FusedMultiTransformer.forward).parameters)
    body = src.split(":\n", 1)[1]
    for name in ("rotary_embs", "rotary_emb_dims", "seq_lens", "name"):
        assert not re.search(rf"\b{name}\b", body), name
    E, NH, FFN = 16, 2, 32
    pt.seed(4)
    jm = jnn.FusedMultiTransformer(embed_dim=E, num_heads=NH,
                                   dim_feedforward=FFN, num_layers=2,
                                   dropout_rate=0.0)
    m = _carry(jm, FusedMultiTransformer(E, NH, FFN, num_layers=2,
                                         device="cpu"))
    jm.eval()
    m.eval()
    rng = np.random.RandomState(5)
    x = rng.randn(2, 4, E).astype(np.float32)
    rot = rng.randn(2, 2, 4, 1, E // NH).astype(np.float32)
    seq_lens = np.array([4, 3], np.int32)
    want = jm(pt.to_tensor(x), None, None, None, pt.to_tensor(rot), 1,
              pt.to_tensor(seq_lens)).numpy()
    got = m(torch.from_numpy(x), None, None, None, torch.from_numpy(rot), 1,
            torch.from_numpy(seq_lens), None, "stack")
    np.testing.assert_allclose(_np(got), want, **TOL)
    np.testing.assert_allclose(_np(got), _np(m(torch.from_numpy(x))),
                               rtol=0, atol=0)


def test_fused_multi_transformer_refusals():
    """The reference's own refusals; training with dropout runs."""
    with pytest.raises(NotImplementedError, match="pre-LN"):
        FusedMultiTransformer(16, 2, 32, normalize_before=False,
                              device="cpu")
    with pytest.raises(NotImplementedError, match="GELU"):
        FusedMultiTransformer(16, 2, 32, activation="relu", device="cpu")
    m = FusedMultiTransformer(16, 2, 32, dropout_rate=0.1, device="cpu")
    x = torch.zeros(1, 4, 16)
    with pytest.raises(NotImplementedError, match="causal fast path"):
        m.eval()(x, attn_mask=torch.zeros(1, 1, 4, 4))
    with pytest.raises(NotImplementedError, match="incremental"):
        m(x, caches=[])
    assert m.train()(x).shape == m.eval()(x).shape == (1, 4, 16)


def test_fused_mha_and_ffn_layers_gradients_flow():
    torch.manual_seed(1)
    mha = FusedMultiHeadAttention(16, 2, 0.0, 0.0, device="cpu")
    ffn = FusedFeedForward(16, 32, 0.0, device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 4, 16)
                         .astype(np.float32))
    out = ffn(mha(x))
    assert out.shape == (2, 4, 16)
    (out ** 2).mean().backward()
    for p in list(mha.parameters()) + list(ffn.parameters()):
        assert p.grad is not None and torch.isfinite(p.grad).all()


def test_fused_post_ln_path_matches_composition_and_jax():
    """Post-LN in eval (dropout 0.3 inactive) takes the fused add +
    LayerNorm: it equals the numpy residual + LN composition with the same
    weights and the JAX layers' output, and the JAX layers' gradients
    with respect to the input."""
    (jm, jf), (tm, tf) = _layers(normalize_before=False)
    x = np.random.RandomState(0).randn(2, 8, 128).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    mid = tm(tx)
    assert "FusedAddNorm" in type(mid.grad_fn).__name__
    out = tf(mid)
    B, S, E = x.shape
    w = {k: _np(v) for k, v in list(tm.named_parameters())
         + [("f." + k, v) for k, v in tf.named_parameters()]}
    qkv = (x @ w["qkv.weight"] + w["qkv.bias"]).reshape(B, S, 3, 2, E // 2)
    q, k, v = (np.swapaxes(qkv[:, :, i], 1, 2) for i in range(3))
    sc = np.einsum("bnqd,bnkd->bnqk", q, k) / np.sqrt(E // 2)
    att = np.exp(sc - sc.max(-1, keepdims=True))
    att = att / att.sum(-1, keepdims=True)
    ao = np.swapaxes(np.einsum("bnqk,bnkd->bnqd", att, v), 1,
                     2).reshape(B, S, E)
    ao = ao @ w["out_proj.weight"] + w["out_proj.bias"]
    h1 = _np_ln(x + ao, w["ln.weight"], w["ln.bias"], 1e-5)
    f = np.maximum(h1 @ w["f.linear1.weight"] + w["f.linear1.bias"], 0.0)
    f = f @ w["f.linear2.weight"] + w["f.linear2.bias"]
    expect = _np_ln(h1 + f, w["f.ln.weight"], w["f.ln.bias"], 1e-5)
    np.testing.assert_allclose(_np(out), expect, **TOL)
    jx = pt.to_tensor(x, stop_gradient=False)
    jout = jf(jm(jx))
    np.testing.assert_allclose(_np(out), jout.numpy(), **TOL)
    pt.ops.mean(jout ** 2).backward()
    (out ** 2).mean().backward()
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_pre_ln_path_matches_jax(activation):
    """Pre-LN takes the plain composition (no fused norm) in both
    packages."""
    (jm, jf), (tm, tf) = _layers(normalize_before=True,
                                 activation=activation, seed=6)
    x = np.random.RandomState(1).randn(2, 8, 128).astype(np.float32)
    got = tf(tm(torch.from_numpy(x)))
    assert "FusedAddNorm" not in type(got.grad_fn).__name__
    np.testing.assert_allclose(_np(got), jf(jm(pt.to_tensor(x))).numpy(),
                               **TOL)


def test_masked_attention_matches_jax():
    """An additive mask takes the plain masked route in both packages
    (the flash gate refuses masks)."""
    (jm, _), (tm, _) = _layers(normalize_before=False, seed=7)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 128).astype(np.float32)
    mask = np.where(rng.rand(2, 1, 1, 8) < 0.3, -1e9, 0.0).astype(np.float32)
    got = tm(torch.from_numpy(x), attn_mask=torch.from_numpy(mask))
    want = jm(pt.to_tensor(x), attn_mask=pt.to_tensor(mask)).numpy()
    np.testing.assert_allclose(_np(got), want, **TOL)


def test_forward_takes_the_reference_parameter_order():
    """``forward(query, key, value, attn_mask, cache)`` as in the JAX
    layer: a mask passed positionally is applied in both packages, and
    key/value that are the query itself are the same self-attention."""
    (jm, jf), (tm, tf) = _layers(normalize_before=False, seed=9)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 128).astype(np.float32)
    mask = np.where(rng.rand(2, 1, 1, 8) < 0.3, -1e9, 0.0).astype(np.float32)
    tx, tmask = torch.from_numpy(x), torch.from_numpy(mask)
    jx = pt.to_tensor(x)
    want = jm(jx, None, None, pt.to_tensor(mask)).numpy()
    np.testing.assert_allclose(_np(tm(tx, None, None, tmask)), want, **TOL)
    np.testing.assert_allclose(_np(tm(tx, tx, tx, tmask)), want, **TOL)
    assert not np.allclose(_np(tm(tx)), want, **TOL)
    np.testing.assert_allclose(_np(tf(tx, None)), jf(jx, None).numpy(),
                               **TOL)


def test_cross_attention_and_caches_raise():
    """The reference ignores other key/value tensors and caches; the port
    refuses them rather than dropping them."""
    (_, _), (tm, tf) = _layers(normalize_before=False, seed=10)
    x, y = torch.zeros(1, 4, 128), torch.ones(1, 4, 128)
    with pytest.raises(NotImplementedError, match="self-attention"):
        tm(x, y, y)
    with pytest.raises(NotImplementedError, match="self-attention"):
        tm(x, None, y)
    with pytest.raises(NotImplementedError, match="incremental cache"):
        tm(x, cache=object())
    with pytest.raises(NotImplementedError, match="incremental cache"):
        tf(x, object())


def test_dropout_by_property():
    """Eval is the identity on the branch (the layer equals its
    dropout-free self); in training the FFN's residual branch keeps a
    share ~1-p of its elements, each scaled by 1/(1-p); a fixed generator
    repeats itself, another seed does not."""
    p, n = 0.25, 256
    ffn = FusedFeedForward(n, 2 * n, p, act_dropout_rate=0.0,
                           normalize_before=True, device="cpu", seed=3)
    plain = FusedFeedForward(n, 2 * n, 0.0, normalize_before=True,
                             device="cpu", seed=3)
    x = torch.from_numpy(np.random.RandomState(3).randn(8, 64, n)
                         .astype(np.float32))
    ffn.eval()
    plain.eval()
    assert torch.equal(ffn(x), plain(x))
    branch = plain(x) - x                      # the undropped residual branch
    ffn.train()
    gen = torch.Generator().manual_seed(11)
    ffn.dropout.generator = gen
    got = ffn(x) - x
    kept = got != 0
    share = kept.float().mean().item()
    # 131072 Bernoulli(0.75) draws: the share is within 5 sigma of 0.75
    assert abs(share - (1 - p)) < 5 * np.sqrt(p * (1 - p) / kept.numel())
    np.testing.assert_allclose(_np(got[kept]), _np(branch[kept] / (1 - p)),
                               rtol=1e-5, atol=1e-6)
    gen.manual_seed(11)
    assert torch.equal(ffn(x) - x, got)
    gen.manual_seed(12)
    assert not torch.equal(ffn(x) - x, got)


def test_post_ln_training_with_dropout_takes_the_plain_branch():
    """Training with dropout > 0 runs the composition (no fused norm); the
    fused branch still carries gradients in eval."""
    (_, _), (tm, tf) = _layers(normalize_before=False, seed=8)
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 8, 128)
                         .astype(np.float32)).requires_grad_(True)
    tm.train()
    tf.train()
    out = tf(tm(x))
    assert "FusedAddNorm" not in type(out.grad_fn).__name__
    (out ** 2).mean().backward()
    assert torch.isfinite(x.grad).all()


def test_fused_linear_is_a_linear_in_the_jax_layout():
    pt.seed(9)
    j = jnn.FusedLinear(16, 8)
    t = _carry(j, FusedLinear(16, 8, device="cpu"))
    x = np.random.RandomState(5).randn(3, 16).astype(np.float32)
    assert t.weight.shape == (16, 8)
    np.testing.assert_allclose(_np(t(torch.from_numpy(x))),
                               j(pt.to_tensor(x)).numpy(), **TOL)


def test_load_jax_state_refuses_missing_unknown_and_misshaped_keys():
    (jm, _), (tm, _) = _layers(normalize_before=False, seed=10)
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    with pytest.raises(KeyError, match="missing"):
        tm.load_jax_state({k: v for k, v in state.items() if k != "ln.bias"})
    with pytest.raises(KeyError, match="unknown"):
        tm.load_jax_state({**state, "extra": np.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        tm.load_jax_state({**state, "qkv.weight": state["qkv.weight"].T})


def test_layers_count_no_launch_on_the_cpu():
    before = trn.fused_add_layer_norm.launches
    (_, _), (tm, tf) = _layers(normalize_before=False, seed=11)
    tf(tm(torch.zeros(1, 8, 128)))
    assert trn.fused_add_layer_norm.launches == before


def test_fused_multi_transformer_trains_with_dropout(monkeypatch):
    """Training with ``dropout_rate`` 0.1 (both rates; attention on the
    block's plain causal route; recompute on every block): the JAX
    layer's output and gradients with the same masks (fp32, 1e-5 of each
    parameter's largest gradient), and the recompute redraws the same
    masks: two steps from one generator seed give the same bits."""
    rng = np.random.RandomState(9)
    masks = {}

    def mask(shape, keep):
        key = (tuple(int(d) for d in shape), round(float(keep), 9))
        if key not in masks:
            masks[key] = rng.rand(*key[0]) < keep
        return masks[key]

    E, NH, FFN, L = 128, 2, 256, 2
    pt.seed(10)
    jm = jnn.FusedMultiTransformer(embed_dim=E, num_heads=NH,
                                   dim_feedforward=FFN, num_layers=L,
                                   dropout_rate=0.1)
    x, r = np.random.RandomState(11).randn(2, 2, 16, E).astype(np.float32)
    tr = torch.from_numpy(r)                   # the loss's random weights
    runs = []
    for _ in range(2):
        m = _carry(jm, FusedMultiTransformer(E, NH, FFN, num_layers=L,
                                             dropout_rate=0.1, device="cpu",
                                             seed=12))
        out = m.train()(torch.from_numpy(x))
        (out * tr).sum().backward()
        runs.append((out.detach(), {n: p.grad for n, p in
                                    m.named_parameters()}))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(g, runs[1][1][n]) for n, g in runs[0][1].items())
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.asarray(
                            mask(shape, p)))
    monkeypatch.setattr(tcommon, "keep_mask",
                        lambda shape, p, generator, device: torch.from_numpy(
                            mask(shape, 1.0 - p)).to(device))
    jx = pt.to_tensor(x)
    jout = jm(jx)
    (jout * pt.to_tensor(r)).sum().backward()
    m = _carry(jm, FusedMultiTransformer(E, NH, FFN, num_layers=L,
                                         dropout_rate=0.1, device="cpu"))
    out = m.train()(torch.from_numpy(x))
    (out * tr).sum().backward()
    assert {k[0] for k in masks} == {(2, 16, E), (2, NH, 16, 16)}
    np.testing.assert_allclose(_np(out), jout.numpy(), **TOL)
    jgrads = dict(jm.named_parameters())
    for name, p in m.named_parameters():
        want = np.asarray(jgrads[name].grad.numpy(), np.float32)
        np.testing.assert_allclose(_np(p.grad), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
