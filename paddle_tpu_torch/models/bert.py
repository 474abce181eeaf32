"""BERT encoder family, in PyTorch (port of ``paddle_tpu/models/bert.py``;
``BASELINE.json`` config 1 is BERT-base).

The modules keep the JAX model's structure, names and layout
(``Linear.weight`` ``[in, out]``; the encoder layers as ``layer_0`` ...),
so ``load_jax_state`` copies a JAX ``BertForPretraining`` or ``BertModel``
``state_dict()`` unchanged.  ``BertLayer`` is post-LN as the reference
writes it, ``ln(x + y)`` with the plain LayerNorm: the fused add + norm
kernel is the incubate layers' route, not this one's.  Attention is the
port's ``scaled_dot_product_attention``: without ``attention_mask`` (and
without active dropout) the flash forward kernel on the card at a
128-multiple sequence with head_dim 64 or 128; with a mask, the plain
masked expression, whose fp32 mask promotes the scores, as the JAX
package computes it.

``device=None`` means the card; weights are drawn N(0,
``initializer_range``) from ``torch.Generator(seed)`` (LayerNorm gains 1,
biases 0, as the JAX model initialises); dropout draws from
``generator`` (``None``: PyTorch's default generator).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..nn import functional as F
from ..nn.layers import Dropout, LayerNorm, Linear, PortModule, init_weights

__all__ = ["BertConfig", "BertModel", "BertForPretraining",
           "BertPretrainingCriterion", "bert_tiny", "bert_base"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02


def bert_tiny(**kw) -> BertConfig:
    d = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=256, max_position_embeddings=128)
    d.update(kw)
    return BertConfig(**d)


def bert_base(**kw) -> BertConfig:
    return BertConfig(**kw)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None, **factory):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h, **factory)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                h, **factory)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h,
                                                  **factory)
        self.layer_norm = LayerNorm(h, cfg.layer_norm_eps, **factory)
        self.dropout = Dropout(cfg.hidden_dropout, generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            s = input_ids.shape[-1]
            position_ids = torch.arange(
                s, device=input_ids.device).expand_as(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        h = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(h))


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None, **factory):
        super().__init__()
        h = cfg.hidden_size
        self.qkv = Linear(h, 3 * h, **factory)
        self.out = Linear(h, h, **factory)
        self.dropout = Dropout(cfg.hidden_dropout, generator)
        self._cfg = cfg
        self.generator = generator

    def forward(self, x, attn_mask=None):
        cfg = self._cfg
        b, s = x.shape[0], x.shape[1]
        nh = cfg.num_heads
        hd = cfg.hidden_size // nh
        q, k, v = self.qkv(x).view(b, s, 3, nh, hd).unbind(2)
        o = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=cfg.attention_dropout,
            is_causal=False, training=self.training,
            generator=self.generator)
        return self.dropout(self.out(o.reshape(b, s, nh * hd)))


class BertLayer(nn.Module):
    """Post-LN encoder block (BERT convention)."""

    def __init__(self, cfg: BertConfig, generator=None, **factory):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = BertSelfAttention(cfg, generator, **factory)
        self.ln1 = LayerNorm(h, eps, **factory)
        self.fc1 = Linear(h, cfg.intermediate_size, **factory)
        self.fc2 = Linear(cfg.intermediate_size, h, **factory)
        self.ln2 = LayerNorm(h, eps, **factory)
        self.dropout = Dropout(cfg.hidden_dropout, generator)

    def forward(self, x, attn_mask=None):
        x = self.ln1(x + self.attention(x, attn_mask))
        y = self.fc2(F.gelu(self.fc1(x)))
        return self.ln2(x + self.dropout(y))


class BertModel(PortModule):
    """Embeddings, ``num_layers`` post-LN layers and the tanh pooler over
    the first token.  Returns ``(hidden [B, S, H], pooled [B, H])``.
    ``draw_weights=False`` leaves the weights undrawn, for a caller that
    draws them itself (``BertForPretraining``, with its heads)."""

    def __init__(self, cfg: BertConfig, device=None, dtype="float32",
                 seed: int = 0, generator: Optional[torch.Generator] = None,
                 *, draw_weights: bool = True):
        super().__init__()
        factory = self._place(device, dtype)
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg, generator, **factory)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg, generator,
                                                    **factory))
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, **factory)
        if draw_weights:
            init_weights(self, seed, cfg.initializer_range)

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}")
                for i in range(self.config.num_layers)]

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is not None:
            # [B, S] 1/0 -> additive fp32 [B, 1, 1, S]
            m = attention_mask[:, None, None, :].float()
            attention_mask = (1.0 - m) * -1e9
        h = self.embeddings(input_ids, token_type_ids, position_ids)
        for layer in self.layers:
            h = layer(h, attention_mask)
        pooled = torch.tanh(self.pooler(h[:, 0]))
        return h, pooled


class BertForPretraining(PortModule):
    """MLM + NSP heads (the reference's ``PretrainModelLayer``): the MLM
    logits of the gathered ``masked_positions`` (every position without
    them), tied to the word embeddings, and the NSP logits of the pooled
    first token.  Returns ``(mlm_logits [B, M, V], nsp_logits [B, 2])``."""

    def __init__(self, cfg: BertConfig, device=None, dtype="float32",
                 seed: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        factory = self._place(device, dtype)
        self.config = cfg
        # its weights are drawn below, with the heads, from this seed
        self.bert = BertModel(cfg, self.device, self.dtype, seed, generator,
                              draw_weights=False)
        self.mlm_transform = Linear(cfg.hidden_size, cfg.hidden_size,
                                    **factory)
        self.mlm_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                **factory)
        self.nsp_head = Linear(cfg.hidden_size, 2, **factory)
        init_weights(self, seed, cfg.initializer_range)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, masked_positions=None):
        h, pooled = self.bert(input_ids, token_type_ids, position_ids,
                              attention_mask)
        if masked_positions is not None:
            idx = masked_positions.long()[..., None].expand(
                -1, -1, h.shape[-1])
            g = torch.gather(h, 1, idx)                       # [B, M, H]
        else:
            g = h
        g = self.mlm_ln(F.gelu(self.mlm_transform(g)))
        w = self.bert.embeddings.word_embeddings.weight
        g, w = F.promote(g, w)
        mlm_logits = g @ w.t()
        nsp_logits = self.nsp_head(pooled)
        return mlm_logits, nsp_logits


class BertPretrainingCriterion(nn.Module):
    """The mean MLM loss (weighted by ``mlm_weights`` when given, over at
    least 1) plus the NSP loss when ``nsp_labels`` are given."""

    def forward(self, mlm_logits, nsp_logits, mlm_labels, nsp_labels=None,
                mlm_weights=None):
        mlm = F.cross_entropy(mlm_logits, mlm_labels, reduction="none")
        if mlm_weights is not None:
            w = mlm_weights.to(mlm.dtype)
            mlm = (mlm * w).sum() / w.sum().clamp_min(1.0)
        else:
            mlm = mlm.mean()
        if nsp_labels is None:
            return mlm
        return mlm + F.cross_entropy(nsp_logits, nsp_labels)
