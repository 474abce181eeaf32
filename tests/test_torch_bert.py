"""The port's BERT (``paddle_tpu_torch.models.bert``) held against the JAX
package's (``paddle_tpu.models.bert``) on the CPU.

A JAX ``BertForPretraining`` in eval mode and the port's, carrying its
weights with ``load_jax_state``, see the same numpy ids, with and without
``attention_mask`` and ``masked_positions``: MLM and NSP logits, the
pooled output and the pretraining criterion must agree in fp32 within
1e-5 absolute plus 1e-4 relative (the same fp32 arithmetic summed in
another order, through two layers and the tied vocabulary product).  Two
configurations: ``bert_tiny`` (head_dim 16: both packages' flash gate
refuses it, so attention is the plain expression) and ``bert_tiny``
with hidden 128 and 2 heads (head_dim 64, seq 128: the gate takes it
without a mask, so the JAX package runs its flash route's CPU reference
and the port its flash kernel's plain version)."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import bert as jb

from paddle_tpu_torch.models import (
    BertForPretraining, BertModel, BertPretrainingCriterion, bert_base,
    bert_tiny,
)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)
CONFIGS = {"tiny": {}, "tiny_d64": dict(hidden_size=128, num_heads=2)}
B, S, M = 2, 128, 12


def _pair(cfg_kw, seed=0, name="BertForPretraining"):
    pt.seed(seed)
    jm = getattr(jb, name)(jb.bert_tiny(**cfg_kw))
    tm = {"BertForPretraining": BertForPretraining,
          "BertModel": BertModel}[name](bert_tiny(**cfg_kw), device="cpu")
    tm.load_jax_state({k: v.numpy() for k, v in jm.state_dict().items()})
    jm.eval()
    tm.eval()
    return jm, tm


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, (B, S))
    types = rng.randint(0, 2, (B, S))
    mask = np.ones((B, S), np.int64)
    mask[0, 100:] = 0
    mask[1, 37:] = 0
    positions = np.stack([rng.choice(S, M, replace=False) for _ in range(B)])
    labels = rng.randint(0, 1024, (B, M))
    labels[0, :3] = -100                     # ignored
    return dict(ids=ids, types=types, mask=mask, positions=positions,
                labels=labels, nsp=rng.randint(0, 2, (B,)),
                weights=(rng.rand(B, M) < 0.8).astype(np.float32))


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else pt.to_tensor(np.asarray(a))


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("gather", [False, True], ids=["all", "positions"])
def test_pretraining_logits_and_criterion_match_jax(config, masked, gather):
    jm, tm = _pair(CONFIGS[config])
    d = _batch()
    mask = d["mask"] if masked else None
    pos = d["positions"] if gather else None
    jmlm, jnsp = jm(_j(d["ids"]), _j(d["types"]), attention_mask=_j(mask),
                    masked_positions=_j(pos))
    tmlm, tnsp = tm(_t(d["ids"]), _t(d["types"]), attention_mask=_t(mask),
                    masked_positions=_t(pos))
    assert tuple(tmlm.shape) == (B, M if gather else S, 1024)
    np.testing.assert_allclose(tmlm.detach().numpy(), jmlm.numpy(), **TOL)
    np.testing.assert_allclose(tnsp.detach().numpy(), jnsp.numpy(), **TOL)
    if not gather:
        return
    for weights in (None, d["weights"]):
        for nsp in (None, d["nsp"]):
            jl = jb.BertPretrainingCriterion()(jmlm, jnsp, _j(d["labels"]),
                                               _j(nsp), _j(weights))
            tl = BertPretrainingCriterion()(tmlm, tnsp, _t(d["labels"]),
                                            _t(nsp), _t(weights))
            np.testing.assert_allclose(tl.item(), float(jl), **TOL)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_bert_model_hidden_and_pooled_match_jax(masked):
    jm, tm = _pair(CONFIGS["tiny_d64"], seed=1, name="BertModel")
    d = _batch(1)
    mask = d["mask"] if masked else None
    jh, jp = jm(_j(d["ids"]), attention_mask=_j(mask))
    th, tp = tm(_t(d["ids"]), attention_mask=_t(mask))
    np.testing.assert_allclose(th.detach().numpy(), jh.numpy(), **TOL)
    np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(), **TOL)


def test_attention_routes_as_the_jax_gate_says():
    """Flash where the JAX gate takes the shape (no mask, no dropout, seq a
    128-multiple, head_dim a 64-multiple), the plain expression
    elsewhere; on the CPU neither counts a launch."""
    shape = (1, 128, 2, 64)
    assert F.flash_eligible(shape, 0.0, None)
    assert not F.flash_eligible(shape, 0.0, torch.zeros(1, 1, 1, 128))
    assert not F.flash_eligible(shape, 0.1, None)
    assert not F.flash_eligible((1, 100, 2, 64), 0.0, None)
    assert not F.flash_eligible((1, 128, 2, 16), 0.0, None)
    assert F.flash_eligible((1, 128, 2, 192), 0.0, None)
    before = tfa.flash_attention_fwd.launches
    jm, tm = _pair(CONFIGS["tiny_d64"], seed=2)
    tm(_t(_batch(2)["ids"]))
    assert tfa.flash_attention_fwd.launches == before


def test_bf16_score_plus_fp32_mask_promotes():
    """The plain route keeps the JAX dtypes: a bf16 score plus an fp32
    additive mask is fp32 before the softmax, so a -1e9 mask leaves no
    weight on a padded key, and the output is fp32."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, 8, 2, 16).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    mask = torch.zeros(1, 1, 1, 8)
    mask[..., 5:] = -1e9
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    assert out.dtype == torch.float32
    v2 = v.clone()
    v2[:, 5:] = 1e4                          # padded keys' values
    out2 = F.scaled_dot_product_attention(q, k, v2, attn_mask=mask)
    assert torch.equal(out, out2)


def test_refused_shapes_on_the_card():
    """A head_dim the JAX gate takes but the card's flash kernels do not
    (192; they take 64 and 128) raises ``ValueError`` off the CPU, with no
    fallback to the plain route (meta tensors stand in for the card's)."""
    cfg = bert_tiny(hidden_size=384, num_heads=2)
    m = BertModel(cfg, device="cpu").to("meta").eval()
    ids = torch.zeros((1, 128), dtype=torch.long, device="meta")
    with pytest.raises(ValueError, match="head_dim=192"):
        m(ids)
    q = torch.zeros((1, 128, 2, 256), device="meta")
    with pytest.raises(ValueError, match="head_dim=256"):
        F.scaled_dot_product_attention(q, q, q)


def test_cross_entropy_matches_jax():
    from paddle_tpu.nn import functional as jF

    rng = np.random.RandomState(4)
    logits = rng.randn(3, 5, 7).astype(np.float32)
    labels = rng.randint(0, 7, (3, 5))
    labels[0, 1] = labels[2, 4] = -100
    for reduction in ("mean", "sum", "none"):
        want = jF.cross_entropy(_j(logits), _j(labels),
                                reduction=reduction).numpy()
        got = F.cross_entropy(_t(logits), _t(labels), reduction=reduction)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="reduction"):
        F.cross_entropy(_t(logits), _t(labels), reduction="avg")


def test_training_dropout_draws_from_the_generator():
    """In training mode every dropout of the model draws from the
    generator it was given: the same seed repeats the logits, another
    seed does not, and eval mode is deterministic."""
    gen = torch.Generator().manual_seed(0)
    m = BertForPretraining(bert_tiny(), device="cpu", generator=gen)
    ids = _t(_batch(5)["ids"])
    m.eval()
    assert torch.equal(m(ids)[0], m(ids)[0])
    m.train()
    gen.manual_seed(7)
    a = m(ids)[0]
    gen.manual_seed(7)
    assert torch.equal(m(ids)[0], a)
    gen.manual_seed(8)
    assert not torch.equal(m(ids)[0], a)


def test_presets_and_load_jax_state_refusals():
    assert (bert_base().hidden_size, bert_base().num_layers,
            bert_base().layer_norm_eps) == (768, 12, 1e-12)
    jm, tm = _pair({}, seed=6)
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    with pytest.raises(KeyError, match="missing"):
        tm.load_jax_state({k: v for k, v in state.items()
                           if k != "nsp_head.bias"})
    with pytest.raises(KeyError, match="unknown"):
        tm.load_jax_state({**state, "bert.layer_9.ln1.bias": np.zeros(64)})
    with pytest.raises(ValueError, match="shape"):
        tm.load_jax_state({**state, "mlm_ln.weight": np.zeros(63)})
