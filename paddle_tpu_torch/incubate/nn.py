"""The fused transformer layers (port of ``paddle_tpu/incubate/nn``:
``FusedMultiHeadAttention``, ``FusedFeedForward``, ``FusedLinear`` and
``FusedMultiTransformer``).

Post-LN (``normalize_before=False``) with no active dropout, the
attention and feed-forward layers end in ONE fused residual add and
LayerNorm, ``ln(residual + branch)``, through
``ops/kernels/rms_norm.py``'s ``fused_add_layer_norm`` (the Hopper kernel
on the card, its plain version on the CPU), as the JAX package's
``_fused_post_ln`` does.  Pre-LN, or training with dropout, they run the
plain composition, as the reference does.  Attention is the port's
``scaled_dot_product_attention`` (the flash kernels where the JAX gate
takes the shape).

Weights keep the JAX layout (``Linear.weight`` ``[in, out]``), so
``load_jax_state`` copies a JAX layer's ``state_dict()`` unchanged.  Each
layer takes ``device`` (``None``: the card), ``dtype`` and a ``seed`` for
its weights, and a ``generator`` for its dropout (``None``: PyTorch's
default generator); dropout bits are PyTorch's, not the JAX package's.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..amp.auto_cast import maybe_cast
from ..core import resolve_device, to_torch_dtype
from ..models.gpt import (
    GPTConfig, GPTStackedDecoder, _dropout_seeds, _host_generator,
)
from ..nn import functional as F
from ..nn.layers import Dropout, LayerNorm, Linear, PortModule, init_weights
from ..ops.kernels.rms_norm import fused_add_layer_norm

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward", "FusedLinear",
           "FusedMultiTransformer"]


def _fused_post_ln(residual, branch, ln: LayerNorm):
    """``ln(residual + branch)`` in one fused kernel launch (the JAX
    ``_fused_post_ln``: x is the branch, the residual is added to it).
    Under ``auto_cast`` O1 every operand is cast to fp32 (a black-list
    op)."""
    branch, residual, w, b = maybe_cast("fused_add_layer_norm", branch,
                                        residual, ln.weight, ln.bias)
    out, _ = fused_add_layer_norm(branch, residual, w, b, ln.epsilon)
    return out


def _refuse_cross_or_cache(query, key, value, cache):
    if any(t is not None and t is not query for t in (key, value)):
        raise NotImplementedError(
            "the fused layers are self-attention: key and value are the "
            "query (the reference ignores other key/value tensors)")
    if cache is not None:
        raise NotImplementedError(
            "the fused layers take no incremental cache (the reference "
            "ignores it): run full-sequence forwards")


class FusedMultiHeadAttention(PortModule):
    """Self-attention over ``[B, S, embed_dim]`` with a fused QKV
    projection (``qkv`` ``[E, 3E]``, split as ``(3, heads, head_dim)``),
    ``out_proj`` and the one active LayerNorm ``ln`` (before the
    attention when ``normalize_before``, after the residual add
    otherwise)."""

    def __init__(self, embed_dim: int, num_heads: int,
                 dropout_rate: float = 0.5, attn_dropout_rate: float = 0.5,
                 *, normalize_before: bool = False, epsilon: float = 1e-5,
                 device=None, dtype="float32", seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"num_heads ({num_heads}) must divide "
                             f"embed_dim ({embed_dim})")
        factory = self._place(device, dtype)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.qkv = Linear(embed_dim, 3 * embed_dim, **factory)
        self.out_proj = Linear(embed_dim, embed_dim, **factory)
        self.ln = LayerNorm(embed_dim, epsilon, **factory)
        self.dropout = Dropout(dropout_rate, generator=generator)
        self.attn_dropout_rate = float(attn_dropout_rate)
        self.generator = generator
        init_weights(self, seed)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        """Self-attention over ``query``, with the reference's parameter
        order.  The reference ignores ``key``, ``value`` and ``cache``;
        here ``key``/``value`` other than ``query`` itself (cross-attention)
        and an incremental ``cache`` raise ``NotImplementedError`` instead
        of being dropped."""
        _refuse_cross_or_cache(query, key, value, cache)
        residual = query
        x = self.ln(query) if self.normalize_before else query
        b, s = x.shape[0], x.shape[1]
        q, k, v = self.qkv(x).view(b, s, 3, self.num_heads,
                                   self.head_dim).unbind(2)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.attn_dropout_rate,
            training=self.training, generator=self.generator)
        out = self.out_proj(out.reshape(b, s, self.embed_dim))
        drop_active = self.training and self.dropout.p > 0.0
        if not self.normalize_before and not drop_active:
            return _fused_post_ln(residual, out, self.ln)
        out = residual + self.dropout(out)
        return out if self.normalize_before else self.ln(out)


class FusedFeedForward(PortModule):
    """``linear2(act(linear1(x)))`` with a residual and the one active
    LayerNorm ``ln`` (pre- or post-LN, as the attention layer)."""

    def __init__(self, d_model: int, dim_feedforward: int,
                 dropout_rate: float = 0.1, epsilon: float = 1e-5,
                 activation: str = "relu",
                 act_dropout_rate: Optional[float] = None, *,
                 normalize_before: bool = False, device=None,
                 dtype="float32", seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if activation not in ("relu", "gelu"):
            raise ValueError(f"activation {activation!r}: expected 'relu' "
                             "or 'gelu'")
        factory = self._place(device, dtype)
        self.normalize_before = normalize_before
        self.linear1 = Linear(d_model, dim_feedforward, **factory)
        self.linear2 = Linear(dim_feedforward, d_model, **factory)
        self.ln = LayerNorm(d_model, epsilon, **factory)
        self.dropout = Dropout(dropout_rate, generator=generator)
        self.act_dropout = Dropout(dropout_rate if act_dropout_rate is None
                                   else act_dropout_rate,
                                   generator=generator)
        self.activation = getattr(F, activation)
        init_weights(self, seed)

    def forward(self, src, cache=None):
        _refuse_cross_or_cache(src, None, None, cache)
        residual = src
        x = self.ln(src) if self.normalize_before else src
        x = self.linear2(self.act_dropout(self.activation(self.linear1(x))))
        drop_active = self.training and self.dropout.p > 0.0
        if not self.normalize_before and not drop_active:
            return _fused_post_ln(residual, x, self.ln)
        x = residual + self.dropout(x)
        return x if self.normalize_before else self.ln(x)


class FusedLinear(Linear, PortModule):
    """The reference's fused matmul + bias epilogue: a plain ``Linear``
    (one ``addmm``), as in the JAX package, with its own weights from
    ``seed``."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, device=None, dtype="float32",
                 seed: int = 0):
        device, dtype = resolve_device(device), to_torch_dtype(dtype)
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=dtype)
        self.device, self.dtype = device, dtype
        init_weights(self, seed)


class FusedMultiTransformer(PortModule):
    """The whole pre-LN stack as one module: the port's
    ``GPTStackedDecoder`` (every block's weights as ``[L, ...]`` slabs,
    causal attention through the flash kernels on the card) and a final
    LayerNorm ``norm``, as the JAX layer wraps its stacked decoder.
    ``dropout_rate`` is both the block's hidden and attention rate; in
    training above 0, attention takes the block's plain causal route and
    the masks come from one seed a layer, drawn from ``generator`` (a CPU
    ``torch.Generator``; ``None``: one seeded with ``seed``), so the
    recompute of every block redraws the same masks.  The reference's
    refusals are kept: post-LN, an activation other than GELU, a mask and
    incremental caches raise ``NotImplementedError``; on the card a shape
    the flash kernels refuse raises ``ValueError``."""

    def __init__(self, embed_dim: int, num_heads: int, dim_feedforward: int,
                 dropout_rate: float = 0.0, activation: str = "gelu",
                 normalize_before: bool = True, *, epsilon: float = 1e-5,
                 num_layers: int = 1, device=None, dtype="float32",
                 seed: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        if not normalize_before:
            raise NotImplementedError(
                "FusedMultiTransformer is the pre-LN fast path "
                "(normalize_before=True), like the reference kernel")
        if activation != "gelu":
            raise NotImplementedError(
                f"activation {activation!r}: the fused block is GELU")
        if embed_dim % num_heads:
            raise ValueError(f"num_heads ({num_heads}) must divide "
                             f"embed_dim ({embed_dim})")
        factory = self._place(device, dtype)
        self._cfg = GPTConfig(
            vocab_size=1, hidden_size=embed_dim, num_layers=num_layers,
            num_heads=num_heads, intermediate_size=dim_feedforward,
            hidden_dropout=dropout_rate, attention_dropout=dropout_rate,
            layer_norm_eps=epsilon, recompute_interval=1)
        self.embed_dim, self.num_layers = embed_dim, num_layers
        self.decoder = GPTStackedDecoder(self._cfg, **factory)
        self.norm = LayerNorm(embed_dim, epsilon, **factory)
        self.generator = _host_generator(generator, seed)
        self._init_decoder(seed)

    @torch.no_grad()
    def _init_decoder(self, seed: int):
        """Slab gains 1 and biases 0, every other slab N(0, 0.02) from
        ``torch.Generator(seed)``, as the stacked GPT initialises."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        for name, p in self.decoder.named_parameters():
            if name.endswith("_g"):
                p.fill_(1.0)
            elif name.endswith("_b"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=gen,
                                    device=self.device) * 0.02)

    def forward(self, src, attn_mask=None, caches=None, pre_caches=None,
                rotary_embs=None, rotary_emb_dims=0, seq_lens=None,
                time_step=None, name=None):
        """The reference's parameters, in its order.  ``rotary_embs``,
        ``rotary_emb_dims``, ``seq_lens`` and ``name`` are accepted and
        ignored, as the JAX layer ignores them."""
        if attn_mask is not None:
            raise NotImplementedError(
                "FusedMultiTransformer runs the causal fast path; a mask "
                "goes through FusedMultiHeadAttention(attn_mask=) or "
                "paddle_tpu_torch.nn.functional."
                "scaled_dot_product_attention")
        if caches is not None or pre_caches is not None \
                or time_step is not None:
            raise NotImplementedError(
                "FusedMultiTransformer: incremental KV-cached decoding "
                "is not implemented — run full-sequence forwards")
        seeds = (_dropout_seeds(self.generator, self.num_layers)
                 if self.decoder.dropout_active() else None)
        return self.norm(self.decoder(src, seeds))
