"""GPT for serving and training, in PyTorch (port of the stacked GPT of
``paddle_tpu/models/gpt.py``).

``GPTStackedForPretraining`` keeps the JAX model's layout: every decoder
weight is one ``[L, ...]`` slab (``x @ w`` with ``w`` as ``[in, out]``, not
``nn.Linear``'s ``[out, in]``), the QKV output splits as ``(3, heads,
head_dim)``, and the LM head is tied to the word embeddings.  Its
``state_dict`` keys are the JAX model's, so ``load_jax_state`` carries
trained weights across unchanged.

The model serves, generates and trains:

- serving runs the fused mixed prefill/decode step of ``ServingEngine``
  (one flat token per row, C == 1, with a ragged plan), through
  ``ops/kernels/ragged_paged_attention.py``;
- the paged step without a plan (``_paged_lm_logits`` with no
  ``ragged_plan``, ``[S, C]`` ids at per-slot positions): C == 1 decodes
  one token per slot through ``ops/kernels/paged_attention.py``; C > 1 is
  the chunked prefill, attention over each slot's gathered pages with the
  absolute-position mask (XLA code in the JAX package, plain torch here);
- both paged paths over an int8 pool (``k_scale``/``v_scale``): every K/V
  write is quantized by ``quantization/kv.py``, and the kernels' int8
  variants read the pages; after ``quantize_weights()`` the projections
  and the tied LM head run as int8 products (``quantization/int8.py``).
  A quantized model serves only: training and ``generate()`` refuse it;
- ``generate()`` (``models/generation.py``) over a contiguous stacked
  ``[L, B, H, max_seq, D]`` cache: the whole-prompt prefill at position 0
  through the flash forward kernel at any prompt length, every later
  token through ``ops/kernels/decode_attention.py``, and a chunked
  prefill at any other position through masked attention over the whole
  cache (XLA code in the JAX package, plain torch here);
- training runs ``forward(input_ids, labels=...)``: the stacked block of
  the reference's ``_block_fn`` per layer, groups of
  ``recompute_interval`` blocks under activation checkpointing (as
  ``scan_blocks`` remats them), and the chunked loss head of
  ``nn/functional.py``.  Causal attention goes through
  ``ops/kernels/flash_attention.py``, except where the reference leaves
  its flash kernel: with attention dropout in training, or with
  ``use_flash_attention=False``, it is the reference's plain causal
  expression (:func:`causal_attention_plain`, on any device).

Dropout in training is the reference's: hidden dropout after the
embeddings and after each block's attention projection and MLP, attention
dropout on the probabilities.  Each training forward draws one host seed
per layer (and one for the embeddings) from the model's CPU
``torch.Generator``; a layer draws its masks, in block order, from a
generator on the activations' device seeded with its seed.  The
recompute of a checkpointed group reseeds from the same seeds, so it
redraws the same masks, as the reference recomputes with the same
per-layer key.  Nothing is read back from the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import resolve_device, to_torch_dtype
from ..nn.functional import (
    cross_entropy, dropout, fused_linear_cross_entropy,
)
from ..nn.layers import load_jax_state
from ..ops.kernels.decode_attention import decode_attention
from ..ops.kernels.flash_attention import (
    flash_attention_bnsd, flash_attention_fwd,
)
from ..ops.kernels.paged_attention import gather_pages, paged_attention
from ..ops.kernels.ragged_paged_attention import ragged_paged_attention
from ..quantization.int8 import k_major, quantize_weight, quantized_matmul
from ..quantization.kv import quantize_kv_write
from .generation import GenerationMixin, KVCache

__all__ = [
    "GPTConfig",
    "GPTStackedForPretraining",
    "GPTPretrainingCriterion",
    "causal_attention_plain",
    "gpt_tiny",
    "gpt_small",
    "gpt_1p3b",
    "gpt_13b",
]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None  # default 4*hidden
    max_position_embeddings: int = 1024
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    recompute_interval: int = 0         # 0 = off; k = remat every k blocks
    # None or True: training attention runs through flash_attention_bnsd
    # (the kernels on the card, their plain version on the CPU) unless
    # attention dropout is active; False: the reference's plain causal
    # expression (causal_attention_plain) on every device
    use_flash_attention: Optional[bool] = None

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden_size={self.hidden_size} is not a "
                             f"multiple of num_heads={self.num_heads}")
        return self.hidden_size // self.num_heads


def _preset(defaults, kw):
    return GPTConfig(**{**defaults, **kw})


def gpt_tiny(**kw) -> GPTConfig:
    return _preset(dict(vocab_size=1024, hidden_size=64, num_layers=2,
                        num_heads=4, max_position_embeddings=128), kw)


def gpt_small(**kw) -> GPTConfig:
    """GPT-2 small class (117M)."""
    return _preset(dict(hidden_size=768, num_layers=12, num_heads=12,
                        max_position_embeddings=1024), kw)


def gpt_1p3b(**kw) -> GPTConfig:
    """GPT-3 1.3B."""
    return _preset(dict(hidden_size=2048, num_layers=24, num_heads=16,
                        max_position_embeddings=2048), kw)


def gpt_13b(**kw) -> GPTConfig:
    """GPT-3 13B."""
    return _preset(dict(hidden_size=5120, num_layers=40, num_heads=40,
                        max_position_embeddings=2048), kw)


def causal_attention_plain(q, k, v, scale: float, dropout_p: float = 0.0,
                           generator: Optional[torch.Generator] = None):
    """The reference block's plain causal attention
    (``paddle_tpu/models/gpt.py`` ``_block_fn``'s ``sdpa`` off the flash
    kernel): scores ``q k^T`` summed in fp32 (the operands are widened,
    which keeps every product of two bf16 values exact, as
    ``preferred_element_type=float32`` does), times ``scale``; the causal
    mask sets -1e9; softmax in fp32; dropout on the probabilities (drawn
    from ``generator``); the probabilities cast to q's dtype for the
    product with v.  ``q``/``k``/``v`` [B, N, S, D] -> [B, N, S, D]."""
    s = q.shape[2]
    scores = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float()) * scale
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(causal, scores, torch.full_like(scores, -1e9))
    att = dropout(torch.softmax(scores, dim=-1), dropout_p, True, generator)
    return torch.einsum("bnqk,bnkd->bnqd", att.to(q.dtype), v)


def _dropout_seeds(generator: torch.Generator, n: int):
    """``n`` host seeds for one training forward's dropout, drawn from the
    model's CPU generator (no device work, nothing read back)."""
    return torch.randint(0, 2 ** 62, (n,), generator=generator).tolist()


def _seeded(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``: the same seed gives
    the same masks, in the recompute as in the forward."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _identity(x):
    return x


def _layer_norm(x, g, b, eps):
    """The JAX ``_ln_f32`` followed by the cast back to the weight dtype:
    ``F.layer_norm`` accumulates in fp32 for bf16 inputs and rounds the
    result once, in one kernel."""
    return F.layer_norm(x, (x.shape[-1],), g, b, eps)


class GPTEmbeddings(nn.Module):
    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            **factory)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, **factory)

    def forward(self, input_ids, position_ids):
        return (self.word_embeddings(input_ids)
                + self.position_embeddings(position_ids))


class GPTStackedDecoder(nn.Module):
    """All decoder blocks as stacked ``[L, ...]`` parameters, run as a
    loop over the leading layer axis.  Activations share the weights'
    dtype (the pool may hold another); LayerNorm statistics and
    matrix-product sums are fp32 inside their kernels."""

    PARAM_NAMES = ("ln1_g", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
                   "ln2_g", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")
    # the block's weights after quantize_weights(): each projection's int8
    # [L, in, out] buffer and fp32 [L, out] scales in place of its weight
    QUANTIZED = ("qkv_w", "proj_w", "fc1_w", "fc2_w")
    INT8_NAMES = ("ln1_g", "ln1_b", "qkv_w_int8", "qkv_w_s", "qkv_b",
                  "proj_w_int8", "proj_w_s", "proj_b", "ln2_g", "ln2_b",
                  "fc1_w_int8", "fc1_w_s", "fc1_b", "fc2_w_int8", "fc2_w_s",
                  "fc2_b")

    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        self._cfg = cfg
        self.weight_int8 = False
        L, h, f = cfg.num_layers, cfg.hidden_size, cfg.ffn_size
        shapes = {"ln1_g": (L, h), "ln1_b": (L, h), "qkv_w": (L, h, 3 * h),
                  "qkv_b": (L, 3 * h), "proj_w": (L, h, h), "proj_b": (L, h),
                  "ln2_g": (L, h), "ln2_b": (L, h), "fc1_w": (L, h, f),
                  "fc1_b": (L, f), "fc2_w": (L, f, h), "fc2_b": (L, h)}
        for name in self.PARAM_NAMES:
            self.register_parameter(
                name, nn.Parameter(torch.empty(shapes[name], **factory)))

    def _block(self, h, weights, attend, int8: bool = False,
               drop=_identity):
        """One block (the reference's ``_block_fn``, ``_cached_block_fn``
        and ``_paged_block_fn`` bodies): ``h`` [B, S, hidden] -> [B, S,
        hidden].  ``attend(q, k, v)`` takes the fresh [B, S, H, D] views
        into the fused QKV output (the backward of unbind stacks dQ/dK/dV
        into the QKV gradient in one pass) and returns the attention
        output as [B, S, H, D], in any dtype; a cached ``attend`` also
        writes K/V into its cache.  ``drop`` is the hidden dropout, applied
        to the attention projection and to the MLP output in their dtype,
        before the cast to ``h``'s (the training block's; the identity
        elsewhere).

        ``int8``: ``weights`` are the 16 of :data:`INT8_NAMES`, and each
        projection is ``quantized_matmul``, which takes the fp32 LayerNorm
        output (not rounded to the weight dtype) and returns fp32; the
        residual adds are cast back to ``h``'s dtype, as the reference's
        ``_paged_block_fn`` does."""
        cfg = self._cfg
        nh, hd, eps = cfg.num_heads, cfg.head_dim, cfg.layer_norm_eps
        if int8:
            (l1g, l1b, qkvw, qkvs, qkvb, pw, pws, pb, l2g, l2b, f1w, f1s, f1b,
             f2w, f2s, f2b) = weights

            def norm(x, g, beta):
                return _layer_norm(x.float(), g.float(), beta.float(), eps)

            proj = quantized_matmul
        else:
            (l1g, l1b, qkvw, qkvb, pw, pb, l2g, l2b, f1w, f1b, f2w,
             f2b) = weights
            qkvs = pws = f1s = f2s = None

            def norm(x, g, beta):
                return _layer_norm(x, g, beta, eps)

            def proj(x, w, ws, bias):
                return torch.addmm(bias, x, w)
        b, s, hidden = h.shape
        x = norm(h, l1g, l1b).reshape(b * s, hidden)
        qkv = proj(x, qkvw, qkvs, qkvb).view(b, s, 3, nh, hd)
        out = attend(*qkv.unbind(2))
        out = out.reshape(b * s, hidden).to(x.dtype)  # cache dtype may differ
        h = h + drop(proj(out, pw, pws, pb).view(b, s, hidden)).to(h.dtype)
        y = norm(h, l2g, l2b).reshape(b * s, hidden)
        y = F.gelu(proj(y, f1w, f1s, f1b), approximate="tanh")
        return h + drop(proj(y, f2w, f2s, f2b).view(b, s, hidden)).to(h.dtype)

    def _train_attend(self, q, k, v, gen=None):
        """Causal attention of the training block, [B, S, H, D] views in
        and out.  ``gen``: the layer's dropout generator, given when
        dropout is active.  The flash kernels (on the card a shape or
        dtype they refuse raises here), unless attention dropout is active
        or ``use_flash_attention`` is False: then the reference's plain
        expression, :func:`causal_attention_plain`."""
        cfg = self._cfg
        scale = float(1.0 / np.sqrt(cfg.head_dim))
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        attn_p = cfg.attention_dropout if gen is not None else 0.0
        if attn_p > 0.0 or cfg.use_flash_attention is False:
            out = causal_attention_plain(q, k, v, scale, attn_p, gen)
        else:
            out = flash_attention_bnsd(q, k, v, causal=True, sm_scale=scale)
        return out.transpose(1, 2)

    def _blocks(self, h, seeds, *weights):
        """Consecutive training blocks; ``weights`` holds each block's 12
        slices, block after block; ``seeds`` one dropout seed per block,
        or None without dropout.  A block draws its masks from a generator
        seeded with its seed, in block order: the attention probabilities,
        the attention projection, the MLP output."""
        n = len(self.PARAM_NAMES)
        hid_p = self._cfg.hidden_dropout
        for j, i in enumerate(range(0, len(weights), n)):
            if seeds is None:
                h = self._block(h, weights[i:i + n], self._train_attend)
                continue
            gen = _seeded(seeds[j], h.device)
            h = self._block(
                h, weights[i:i + n],
                lambda q, k, v: self._train_attend(q, k, v, gen),
                drop=lambda x: dropout(x, hid_p, True, gen))
        return h

    def _layers(self, names=PARAM_NAMES):
        """Each layer's weight slices (the 12 of ``PARAM_NAMES``, or the
        16 of ``INT8_NAMES``), layer after layer (one unbind per slab: its
        backward stacks the layers' gradients)."""
        return zip(*(getattr(self, n).unbind(0) for n in names))

    def _check_fp_weights(self, what: str):
        if self.weight_int8:
            raise ValueError(
                f"the decoder was quantized for serving (quantize_weights); "
                f"{what} needs the fp weights: serve it through the paged "
                "engine")

    @torch.no_grad()
    def quantize_weights(self):
        """Quantize the four projection slabs to int8 for serving: per
        (layer, output channel) absmax scales, stored as the buffers of
        :data:`INT8_NAMES` (``qkv_w_int8``/``qkv_w_s`` and so on) in the
        reference's fp32 arithmetic.  The fp weights stay (the serving step
        reads only the int8 ones).  Each int8 ``[in, out]`` matrix is stored
        :func:`k_major` (its values and shape are the reference's).
        Idempotent; a quantized decoder serves only: training and the
        contiguous-cache path refuse it."""
        if self.weight_int8:
            return
        for name in self.QUANTIZED:
            q, s = quantize_weight(getattr(self, name), 1)   # [L, in, out]
            self.register_buffer(name + "_int8", k_major(q))
            self.register_buffer(name + "_s", s)
        self.weight_int8 = True

    def dropout_active(self) -> bool:
        """Whether a forward now applies dropout: in training mode with a
        hidden or attention rate above 0."""
        cfg = self._cfg
        return self.training and (cfg.hidden_dropout > 0.0
                                  or cfg.attention_dropout > 0.0)

    def forward(self, h, seeds=None):
        """The training stack: ``h`` [B, S, hidden] through every layer.
        ``seeds``: one dropout seed per layer (a list of ints), given
        exactly when :meth:`dropout_active`.  With ``recompute_interval``
        k > 0 (and the module in training mode) each group of k blocks
        runs under ``torch.utils.checkpoint``: the backward recomputes the
        group's forward from its input and its seeds instead of keeping
        its activations."""
        cfg = self._cfg
        self._check_fp_weights("the training forward")
        if (seeds is not None) != self.dropout_active():
            raise ValueError("GPTStackedDecoder.forward: pass one dropout "
                             "seed per layer exactly when dropout is active")
        k = cfg.recompute_interval if self.training else 0
        if k > 0 and cfg.num_layers % k:
            raise ValueError(f"recompute_interval={k} must divide "
                             f"num_layers={cfg.num_layers}")
        layers = list(self._layers())
        if k <= 0:
            return self._blocks(h, seeds,
                                *(w for layer in layers for w in layer))
        for g0 in range(0, cfg.num_layers, k):
            group = [w for layer in layers[g0:g0 + k] for w in layer]
            group_seeds = None if seeds is None else seeds[g0:g0 + k]
            h = checkpoint(self._blocks, h, group_seeds, *group,
                           use_reentrant=False)
        return h

    def forward_cached(self, h, k_cache, v_cache, pos):
        """Prefill or decode over a contiguous cache (the reference's
        ``_forward_cached`` with ``_raw_attend_with_cache``).  ``h``
        [B, S, hidden]; ``k_cache``/``v_cache`` the stacked
        ``[L, B, H, max_seq, D]`` cache, written in place at positions
        ``pos .. pos + S - 1``; ``pos`` the Python int 0 (the whole-prompt
        prefill) or a 0-d integer tensor on the cache's device.

        - S == 1: the decode kernel over ``pos + 1`` positions;
        - S > 1 at a Python 0: the flash forward kernel, causal, over the
          fresh q/k/v;
        - S > 1 at any other position (chunked prefill): attention over
          the whole cache, each query row seeing the positions up to its
          own (the reference's XLA code, in plain torch)."""
        self._check_fp_weights("the contiguous-cache path (generate)")
        hd = self._cfg.head_dim
        s = h.shape[1]
        scale = float(1.0 / np.sqrt(hd))
        prefill = isinstance(pos, int) and pos == 0 and s > 1
        # device indices: a Python slice at a tensor position would sync
        idx = torch.arange(s, device=h.device) + (
            pos if isinstance(pos, int) else pos.long())
        length = pos + 1

        def attend(q, k, v, kc, vc):
            kc.index_copy_(2, idx, k.transpose(1, 2).to(kc.dtype))
            vc.index_copy_(2, idx, v.transpose(1, 2).to(vc.dtype))
            if s == 1:
                return decode_attention(q[:, 0], kc, vc, length,
                                        sm_scale=scale)
            if prefill:
                # [B, N, S, D] views of [B, S, N, D] memory both ways
                out, _ = flash_attention_fwd(*(t.transpose(1, 2)
                                               for t in (q, k, v)),
                                             True, scale)
                return out.transpose(1, 2)
            return _masked_attention(q.transpose(1, 2), kc, vc, idx,
                                     scale).transpose(1, 2)

        for weights, kc, vc in zip(self._layers(), k_cache.unbind(0),
                                   v_cache.unbind(0)):
            h = self._block(h, weights,
                            lambda q, k, v: attend(q, k, v, kc, vc))
        return h

    def forward_paged(self, h, k_pool, v_pool, tables, pos, ragged_plan,
                      k_scale=None, v_scale=None):
        """One paged step over every layer.  ``h`` [S, C, hidden]: C tokens
        of each of S rows at positions ``pos[s] .. pos[s] + C - 1``;
        ``k_pool``/``v_pool`` the stacked ``[L, P, H, page_size, D]`` pool,
        written in place; ``tables`` [S, max_pages] the rows' page tables;
        ``k_scale``/``v_scale`` the stacked ``[L, P, H]`` scales of an int8
        pool, updated in place (None for a float pool).

        - C == 1 with a ``ragged_plan``: the serving engine's fused step
          (each row one flat token), through the ragged kernel;
        - C == 1 without one: the paged kernel over ``pos + 1``;
        - C > 1: the chunked prefill, attention over each row's gathered
          (for an int8 pool, dequantized) pages with the absolute-position
          mask (the reference's XLA code, in plain torch).

        An int8 pool's K/V rows go through ``quantize_kv_write`` (which
        updates the layer's scales) before they are written, and the
        kernels read the pages with the updated scales."""
        cfg = self._cfg
        nh, hd = cfg.num_heads, cfg.head_dim
        c = h.shape[1]
        page_size = k_pool.shape[3]
        max_pages = tables.shape[1]
        scale = float(1.0 / np.sqrt(hd))
        tbl = tables.long()
        abs_pos = pos.long()[:, None] + torch.arange(c, device=h.device)
        # each token's K/V lands at pool[page_ids, :, offs]; padding rows
        # carry the null-page table and position 0, so their writes sink
        # into page 0, which no valid read ever resolves to.  The clip is
        # defensive: admission reserves every page a token can touch.
        page_slot = torch.clamp(abs_pos // page_size, 0, max_pages - 1)
        page_ids = torch.gather(tbl, 1, page_slot)[..., None]    # [S, C, 1]
        offs = (abs_pos % page_size)[..., None]                  # [S, C, 1]
        heads = torch.arange(nh, device=h.device)                # [H]
        lengths = (pos + 1).to(torch.int32)

        def attend(q, k, v, kp, vp, ks, vs):
            # ALL of the step's K/V rows go into the pool BEFORE attention,
            # so a chunk's tokens see each other through the pool.  In
            # place: index_put_ on the pool tensor (and, for an int8 pool,
            # the quantizer's scatters on the scales).
            if ks is not None:
                k, _ = quantize_kv_write(k, page_ids[..., 0], offs[..., 0],
                                         ks)
                v, _ = quantize_kv_write(v, page_ids[..., 0], offs[..., 0],
                                         vs)
            kp.index_put_((page_ids, heads, offs), k.to(kp.dtype))
            vp.index_put_((page_ids, heads, offs), v.to(vp.dtype))
            if c == 1 and ragged_plan is not None:
                out = ragged_paged_attention(q[:, 0], kp, vp, tables,
                                             lengths, ragged_plan,
                                             sm_scale=scale, k_scale=ks,
                                             v_scale=vs)
                return out[:, None]
            if c == 1:
                return paged_attention(q[:, 0], kp, vp, tables, lengths,
                                       sm_scale=scale, k_scale=ks,
                                       v_scale=vs)[:, None]
            out = _masked_attention(q.transpose(1, 2),
                                    gather_pages(kp, tbl, ks),
                                    gather_pages(vp, tbl, vs), abs_pos, scale)
            return out.transpose(1, 2)

        int8 = self.weight_int8
        names = self.INT8_NAMES if int8 else self.PARAM_NAMES
        pools = [k_pool.unbind(0), v_pool.unbind(0)]
        pools += ([k_scale.unbind(0), v_scale.unbind(0)]
                  if k_scale is not None else [[None] * cfg.num_layers] * 2)
        for weights, kp, vp, ks, vs in zip(self._layers(names), *pools):
            h = self._block(
                h, weights,
                lambda q, k, v: attend(q, k, v, kp, vp, ks, vs), int8=int8)
        return h


def _masked_attention(q, k, v, q_pos, scale: float) -> torch.Tensor:
    """Attention of queries at absolute positions ``q_pos`` ([S] shared by
    every row, or [B, S] per row) over a whole context ``k``/``v``
    [B, N, ctx, D]: a query sees the context positions up to its own.
    The reference's XLA chunked-prefill code: fp32 scores of q in the
    context dtype, the -1e9 mask, an fp32 softmax, probabilities in the
    context dtype, the output in the q dtype.  ``q`` [B, N, S, D]."""
    scores = torch.einsum("bnqd,bnkd->bnqk", q.to(k.dtype).float(),
                          k.float()) * scale
    cols = torch.arange(k.shape[2], device=k.device)
    mask = cols <= q_pos[..., None]             # [S, ctx] or [B, S, ctx]
    if mask.dim() == 3:
        mask = mask[:, None]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e9))
    att = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bnqk,bnkd->bnqd", att.float(),
                        v.float()).to(v.dtype).to(q.dtype)


def _host_generator(generator, seed: int) -> torch.Generator:
    """The CPU generator a module draws its dropout seeds from."""
    if generator is None:
        return torch.Generator().manual_seed(int(seed))
    if generator.device.type != "cpu":
        raise ValueError("the dropout seeds come from a CPU "
                         f"torch.Generator, got one on {generator.device}")
    return generator


class GPTStackedForPretraining(nn.Module, GenerationMixin):
    """Embeddings + stacked decoder + tied LM head, for training, serving
    and ``generate()``.

    ``device=None`` means ``"cuda"`` and raises when no CUDA device is
    present; pass ``device="cpu"`` to run on the CPU.  Weights are drawn
    N(0, initializer_range) from ``torch.Generator(seed)`` on the model's
    device (LayerNorm gains 1, biases 0, as the JAX model initialises).
    Dropout seeds come from ``generator``, a CPU ``torch.Generator``
    (``None``: a CPU generator seeded with ``seed``).
    """

    def __init__(self, cfg: GPTConfig, device=None, dtype="float32",
                 seed: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg
        self.device = resolve_device(device)
        self.dtype = to_torch_dtype(dtype)
        self.generator = _host_generator(generator, seed)
        factory = dict(device=self.device, dtype=self.dtype)
        self.embeddings = GPTEmbeddings(cfg, **factory)
        self.decoder = GPTStackedDecoder(cfg, **factory)
        self.final_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                     **factory)
        self._init_weights(seed)

    @torch.no_grad()
    def _init_weights(self, seed: int):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        std = self.config.initializer_range
        for name, p in self.named_parameters():
            short = name.rsplit(".", 1)[-1]
            if short in ("ln1_g", "ln2_g") or name == "final_ln.weight":
                p.fill_(1.0)
            elif short.endswith("_b") or name == "final_ln.bias":
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=gen,
                                    device=self.device) * std)

    @property
    def weight_int8(self) -> bool:
        """Whether ``quantize_weights`` (or ``load_jax_state`` of a
        quantized JAX model) made this model serve on int8 weights."""
        return self.decoder.weight_int8

    def _int8_shapes(self):
        """The int8 buffers of a quantized model and their shapes, keyed
        as the JAX model's ``state_dict`` keys them."""
        cfg = self.config
        L, h, f, v = (cfg.num_layers, cfg.hidden_size, cfg.ffn_size,
                      cfg.vocab_size)
        out = {"qkv_w": (h, 3 * h), "proj_w": (h, h), "fc1_w": (h, f),
               "fc2_w": (f, h)}
        shapes = {}
        for name, (i, o) in out.items():
            shapes[f"decoder.{name}_int8"] = (L, i, o)
            shapes[f"decoder.{name}_s"] = (L, o)
        shapes["lm_head_int8"] = (h, v)
        shapes["lm_head_scale"] = (v,)
        return shapes

    @torch.no_grad()
    def quantize_weights(self):
        """Quantize the decoder's projections (``GPTStackedDecoder.
        quantize_weights``) and the tied LM head to int8 for serving: the
        head as ``lm_head_int8`` [hidden, V] (the transposed embedding) with
        ``lm_head_scale`` [V], one absmax scale per vocabulary row.
        Idempotent."""
        if self.weight_int8:
            return
        self.decoder.quantize_weights()
        q, s = quantize_weight(self.embeddings.word_embeddings.weight, 1)
        self.register_buffer("lm_head_int8", q.t())        # k_major already
        self.register_buffer("lm_head_scale", s)

    def load_jax_state(self, state: Mapping[str, np.ndarray]):
        """Carry the JAX model's weights across: ``state`` maps every key
        of ``paddle_tpu``'s ``GPTStackedForPretraining.state_dict()``
        (``embeddings.word_embeddings.weight``, ``decoder.qkv_w``, ...,
        ``final_ln.bias``) to a numpy array of the same shape.  A quantized
        JAX model's int8 buffers (``decoder.qkv_w_int8``, ...,
        ``lm_head_scale``), when present, are carried across unchanged and
        mark this model quantized.  Missing, unknown or mis-shaped keys
        raise."""
        int8_shapes = self._int8_shapes()
        int8 = {k: state[k] for k in int8_shapes if k in state}
        if int8 and len(int8) != len(int8_shapes):
            raise KeyError("load_jax_state: int8 buffers missing "
                           f"{sorted(set(int8_shapes) - set(int8))}")
        if self.weight_int8 and not int8:
            raise ValueError("load_jax_state: this model is quantized; load "
                             "fp weights into a fresh model")
        loaded = {}
        for name, a in int8.items():
            a = np.asarray(a)
            want = np.int8 if name.endswith("int8") else np.float32
            if a.dtype != want or tuple(a.shape) != int8_shapes[name]:
                raise ValueError(f"load_jax_state: {name} is {a.dtype} "
                                 f"{a.shape}, expected {np.dtype(want)} "
                                 f"{int8_shapes[name]}")
            t = torch.from_numpy(a.copy()).to(self.device)
            loaded[name] = k_major(t) if name.endswith("int8") else t
        load_jax_state(self, {k: v for k, v in state.items()
                              if k not in int8_shapes})
        for name, t in loaded.items():
            owner, _, short = name.rpartition(".")
            (self.decoder if owner else self).register_buffer(short, t)
        if loaded:
            self.decoder.weight_int8 = True

    def forward(self, input_ids, position_ids=None, labels=None,
                kv_cache=None, cache_index=None, page_tables=None,
                ragged_plan=None, out_rows=None, lora=None):
        """The reference's parameters, in its order.

        Without a cache: ``input_ids`` [B, S] at ``position_ids`` [B, S]
        (or [S]; default ``0..S-1``: packed or offset sequences pass their
        own); with ``labels`` [B, S] (used as given, no shift) returns the
        mean token loss of the chunked fused head, without them the [B, S,
        V] logits.

        With a contiguous ``kv_cache`` (:class:`KVCache`): ``input_ids``
        [B, S] written at cache slots ``cache_index + arange(S)``, where
        ``cache_index`` is the Python int 0 (the whole-prompt prefill) or
        a 0-d integer tensor on the model's device; the position
        embeddings read ``position_ids`` when given, else those slots.
        Returns [B, S, V] logits; the step's K/V are written into the
        cache in place.

        With a paged ``kv_cache``: ``input_ids`` [S, C] -- C tokens of
        each of S rows -- at positions ``cache_index[s] + arange(C)``
        (``cache_index`` [S]), ``page_tables`` [S, max_pages] the rows'
        page tables.  With ``ragged_plan`` (C == 1) it is the serving
        engine's fused step: each row is one flat token and ``out_rows``
        [S'] selects the rows the LM head projects.  Returns [S, C, V]
        logits ([S', 1, V] with ``out_rows``); every token's K/V is
        written into the pool in place.  The positions come from
        ``cache_index`` here: a ``position_ids`` that disagrees raises.

        ``lora`` (per-request adapters) is not ported yet: it raises."""
        if lora is not None:
            raise NotImplementedError(
                "lora= (per-request LoRA adapters) is not ported yet "
                "(ROADMAP.md queue 1, item 8, speculative decoding and "
                "LoRA)")
        if kv_cache is None:
            return self._forward_train(input_ids, labels, position_ids)
        cfg = self.config
        ids = input_ids.long()
        s = ids.shape[1]
        rel = torch.arange(s, device=ids.device)
        if not getattr(kv_cache, "paged", False):
            pos = int(cache_index) if isinstance(
                cache_index, (int, np.integer)) else cache_index.reshape(())
            pos_ids = (rel + pos).expand_as(ids) if position_ids is None \
                else position_ids.long().expand_as(ids)
            h = self.embeddings(ids, pos_ids)                # [B, S, hidden]
            h = self.decoder.forward_cached(h, kv_cache.k, kv_cache.v, pos)
        else:
            if page_tables is None:
                raise ValueError("a paged KV cache needs page_tables")
            pos = cache_index.long()
            if position_ids is not None and not torch.equal(
                    position_ids.long().expand_as(ids), pos[:, None] + rel):
                raise ValueError(
                    "position_ids disagree with cache_index: the paged and "
                    "ragged paths place each token at cache_index[s] + "
                    "arange(C), and read positions from there")
            pos_ids = torch.clamp(pos[:, None] + rel, 0,
                                  cfg.max_position_embeddings - 1)
            h = self.embeddings(ids, pos_ids)                # [S, C, hidden]
            # a pool without scales is a float pool
            h = self.decoder.forward_paged(
                h, kv_cache.k, kv_cache.v, page_tables, pos, ragged_plan,
                getattr(kv_cache, "k_scale", None),
                getattr(kv_cache, "v_scale", None))
            if out_rows is not None:
                # gather each slot's output row BEFORE the vocab
                # projection: the LM head projects [S'] rows, not the
                # padded token axis
                h = h[out_rows.long()]
        h = self.final_ln(h)
        if self.weight_int8:
            # the tied head as one int8 product (fp32 logits)
            return quantized_matmul(h, self.lm_head_int8, self.lm_head_scale)
        return h @ self.embeddings.word_embeddings.weight.t()

    def _forward_train(self, input_ids, labels, position_ids=None):
        cfg = self.config
        ids = input_ids.long()
        pos = (torch.arange(ids.shape[-1], device=ids.device)
               if position_ids is None else position_ids.long())
        h = self.embeddings(ids, pos.expand_as(ids))        # [B, S, hidden]
        seeds = None
        if self.decoder.dropout_active():
            # the embeddings' seed, then one per layer
            seeds = _dropout_seeds(self.generator, cfg.num_layers + 1)
            h = dropout(h, cfg.hidden_dropout, True,
                        _seeded(seeds.pop(0), h.device))
        h = self.final_ln(self.decoder(h, seeds))
        w = self.embeddings.word_embeddings.weight
        if labels is not None:
            return fused_linear_cross_entropy(h, w, labels)
        return h @ w.t()

    # -- GenerationMixin cache contract ------------------------------------
    def new_kv_cache(self, batch_size: int, max_seq: int,
                     dtype="bfloat16") -> KVCache:
        cfg = self.config
        return KVCache(cfg.num_layers, batch_size, cfg.num_heads, max_seq,
                       cfg.head_dim, dtype=dtype, device=self.device)

    def _cached_lm_logits(self, input_ids, kv_cache, cache_index):
        return self.forward(input_ids, kv_cache=kv_cache,
                            cache_index=cache_index)

    # -- ServingEngine paged-cache contract --------------------------------
    def new_paged_kv_cache(self, num_pages: int, page_size: int,
                           dtype="bfloat16"):
        from ..serving.paged_cache import PagedKVCache

        cfg = self.config
        return PagedKVCache(cfg.num_layers, num_pages, cfg.num_heads,
                            page_size, cfg.head_dim, dtype=dtype,
                            device=self.device)

    def _paged_lm_logits(self, input_ids, paged_cache, page_tables,
                         positions, ragged_plan=None, out_rows=None):
        return self.forward(input_ids, kv_cache=paged_cache,
                            cache_index=positions, page_tables=page_tables,
                            ragged_plan=ragged_plan, out_rows=out_rows)


class GPTPretrainingCriterion(nn.Module):
    """Next-token cross entropy with an optional loss mask (the reference's
    ``GPTPretrainingCriterion``): the mean of the per-token losses, or
    ``sum(loss * mask) / max(sum(mask), 1)`` with ``loss_mask``.
    ``logits`` [B, S, V], ``labels`` [B, S] (used as given, no shift).
    ``cfg`` is accepted, as the reference takes it."""

    def __init__(self, cfg: Optional[GPTConfig] = None):
        super().__init__()

    def forward(self, logits, labels, loss_mask=None):
        losses = cross_entropy(logits, labels, reduction="none").reshape(-1)
        if loss_mask is None:
            return losses.mean()
        mask = loss_mask.reshape(-1).to(losses.dtype)
        return (losses * mask).sum() / mask.sum().clamp_min(1.0)
