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
and the port its flash kernel's plain version).

Training: three steps of BERT-base's pretraining recipe (the original
release's and PaddleNLP's: linear warmup then linear decay, global-norm
clipping at 1.0, weight decay 0.01 kept off biases and LayerNorm
parameters by name) at ``bert_tiny`` with dropout 0, the JAX model and
optimizer beside the port's ``FusedTrainStep``: the losses within 1e-5
relative, and the parameters as the GPT training test holds them (AdamW's
first steps move an element by about ``lr * sign(g)``, so an element
whose gradient is ~0 may step the other way: ``2 * lr`` per step, and
99.9 % of the elements within 1e-6).  With bf16 weights on fp32 masters
(``amp.decorate`` O2 on both sides before the optimizers), the losses
within 2e-3 relative and the masters as above plus one bf16 rounding of
the forward's activations (2^-7 relative)."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import bert as jb

from paddle_tpu_torch import amp, nn as tnn
from paddle_tpu_torch.models import (
    BertForPretraining, BertModel, BertPretrainingCriterion, bert_base,
    bert_tiny,
)
from paddle_tpu_torch.optimizer import AdamW, FusedTrainStep
from paddle_tpu_torch.optimizer import lr as tlr
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


RECIPE_LR, RECIPE_STEPS = 1e-3, 3


def _no_decay(name):
    return not any(w in name for w in ("bias", "ln", "layer_norm"))


def _recipe_schedule(mod):
    return mod.LinearWarmup(mod.PolynomialDecay(RECIPE_LR, 10, end_lr=0.0,
                                                power=1.0), 2,
                            RECIPE_LR / 10, RECIPE_LR)


def _change_error(got, want, start, name):
    """``|(got - start) - (want - start)| / |want - start|``: the error of a
    master's change, relative to JAX's change.  The key third of a qkv
    bias is left out: softmax is blind to it, so its gradient is zero but
    for rounding, and Adam scales that noise to lr-sized steps on both
    sides."""
    change, diff = (want - start).ravel(), (got - want).ravel()
    if name.endswith("qkv.bias"):
        h = change.size // 3
        change = np.concatenate([change[:h], change[2 * h:]])
        diff = np.concatenate([diff[:h], diff[2 * h:]])
    return np.linalg.norm(diff) / np.linalg.norm(change)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_recipe_steps_match_jax(dtype):
    """The analogue of ``tests/test_bert_hapi_native.py``'s
    ``test_bert_pretraining_trains``, held to the JAX model: three steps of
    the whole recipe, then the JAX parameters (and masters).

    In bf16 the gradients differ by bf16 rounding, so two readings hold
    the masters, besides the elementwise bound:

    - each master's change from its start against JAX's change
      (``_change_error``) within 0.1: measured at most 0.043; a master
      that is never updated reads 1.0;
    - for the LayerNorm weights (kept off decay, starting at 1) the
      component of ``port - JAX`` along the start, in units of the decay
      that ``wd * sum(lr)`` would have made, within 0.5: measured at most
      0.15; with the decay mask inverted it reads 0.95 to 1.15.  (On the
      decayed weights rounding noise swamps this reading at this size.)"""
    cfg_kw = dict(hidden_dropout=0.0, attention_dropout=0.0)
    jm, tm = _pair(cfg_kw, seed=7)
    jm.train()
    tm.train()
    bf16 = dtype == "bfloat16"
    if bf16:
        pt.amp.decorate(jm, level="O2", dtype="bfloat16")
        amp.decorate(tm, level="O2", dtype="bfloat16")
    for name, p in jm.named_parameters():
        p.name = name
    jsched, tsched = _recipe_schedule(pt.optimizer.lr), _recipe_schedule(tlr)
    jopt = pt.optimizer.AdamW(
        learning_rate=jsched, parameters=jm.parameters(), weight_decay=0.01,
        grad_clip=pt.nn.ClipGradByGlobalNorm(1.0),
        apply_decay_param_fun=_no_decay)
    topt = AdamW(parameters=tm.named_parameters(), learning_rate=tsched,
                 weight_decay=0.01, grad_clip=tnn.ClipGradByGlobalNorm(1.0),
                 apply_decay_param_fun=_no_decay)
    crit, jcrit = BertPretrainingCriterion(), jb.BertPretrainingCriterion()

    def loss_fn(ids, types, pos, labels, nsp, weights):
        mlm, ns = tm(ids, types, masked_positions=pos)
        return crit(mlm, ns, labels, nsp, weights)

    step = FusedTrainStep(loss_fn, topt)
    start = {n: p.detach().float().numpy() for n, p in tm.named_parameters()}
    jl, tl, lr_sum = [], [], 0.0
    for i in range(RECIPE_STEPS):
        lr_sum += jopt.get_lr()
        d = _batch(20 + i)
        args = [d[k] for k in ("ids", "types", "positions", "labels", "nsp",
                               "weights")]
        mlm, ns = jm(_j(args[0]), _j(args[1]), masked_positions=_j(args[2]))
        loss = jcrit(mlm, ns, *(_j(a) for a in args[3:]))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jsched.step()
        jl.append(float(loss))
        tl.append(float(step(*(_t(a) for a in args))))
        tsched.step()
        assert topt.get_lr() == jopt.get_lr()
    np.testing.assert_allclose(tl, jl, rtol=2e-3 if bf16 else 1e-5)
    allowance = 2 * RECIPE_LR * RECIPE_STEPS
    jsd = jopt.state_dict()
    tsd = topt.state_dict()
    names = [n for n, _ in tm.named_parameters()]
    assert [n for n, _ in jm.named_parameters()] == names
    masters = {f"master_{i}": n for i, n in enumerate(names)}
    assert set(k for k in tsd if k.startswith("master_")) == (
        set(masters) if bf16 else set())
    want = {n: np.asarray(p.numpy(), np.float32)
            for n, p in jm.named_parameters()}
    got = {n: p.detach().float().numpy() for n, p in tm.named_parameters()}
    if bf16:
        want = {n: np.asarray(jsd[k].numpy()) for k, n in masters.items()}
        got = {n: tsd[k].numpy() for k, n in masters.items()}
    for name in names:
        np.testing.assert_allclose(got[name], want[name], atol=allowance,
                                   rtol=2.0 ** -7 if bf16 else 1e-5,
                                   err_msg=name)
        if not bf16:
            bulk = np.quantile(np.abs(got[name] - want[name]), 0.999)
            assert bulk <= 1e-6, (name, bulk)
        else:
            assert _change_error(got[name], want[name], start[name],
                                 name) <= 0.1, name
            if name.endswith("weight") and not _no_decay(name):
                p0 = start[name].ravel()
                decay = (np.dot(got[name].ravel() - want[name].ravel(), p0)
                         / np.dot(p0, p0) / (0.01 * lr_sum))
                assert abs(decay) <= 0.5, (name, decay)
