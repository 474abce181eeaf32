"""GPT for serving and training, in PyTorch (port of the stacked and the
layered GPT of ``paddle_tpu/models/gpt.py``).

``GPTForPretraining`` is the reference's layered flagship class
(``GPTModel`` of ``GPTDecoderLayer``s, each ``GPTAttention`` and
``GPTMLP`` over the port's ``Linear``/``LayerNorm``/``Dropout`` layers),
with the reference's ``state_dict`` keys and per-layer caches; its blocks
follow the layered code (LayerNorm in the input's dtype, ``Int8Linear``
after ``quantize_weights``).  Both classes attend through the same
module-level bodies, :func:`attend_with_cache` and :func:`attend_paged`
(the reference's ``_raw_attend_with_cache`` and ``_attend_paged_shard``),
so every route below and every kernel is shared.  Under a mesh with mp > 1
and ``use_tensor_parallel`` its blocks are built of the fleet API's mpu
layers (:func:`layered_tp`), as the reference's are, and stack into a
``PipelineLayer`` with :class:`GPTLMHead`, the head tied to the word
table, for the fleet recipe.

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

from collections import OrderedDict
from contextlib import ExitStack, contextmanager, nullcontext
from dataclasses import dataclass
from functools import lru_cache, partial
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..amp.auto_cast import amp_state, auto_cast, maybe_cast, o1_dtype
from ..core import canonical_device, resolve_device, to_torch_dtype
from ..core.recompute import checkpoint
from ..distributed import mesh as _mesh
from ..distributed.pp_spmd import (
    RECOMPUTE_POLICIES, checkpointed, pipeline_blocks, stage_layers,
)
from ..distributed.fleet.layers.mpu.mp_layers import (
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    ShardedTensor, VocabParallelEmbedding, vocab_parallel_lookup,
)
from ..distributed.serving_mesh import (
    broadcast, qkv_columns, reduce_sum, take_weights,
)
from ..distributed.shards import (
    Bound, Part, ShardedParameter, bound_now, load_state, param_slots,
    place_on_stage, replicate, sharded_parameters, tie_replicas, tie_slots,
)
from ..nn import functional as NF
from ..nn.functional import (
    cross_entropy, dropout, fused_linear_cross_entropy, promote,
)
from ..nn.layers import (
    Dropout, LayerNorm, Linear, init_weights, load_jax_state,
)
from ..nn.functional.ring_attention import RingAttention
from ..ops.kernels.decode_attention import decode_attention
from ..ops.kernels.flash_attention import (
    flash_attention_bnsd, flash_attention_fwd,
)
from ..ops.kernels.paged_attention import gather_pages, paged_attention
from ..ops.kernels.ragged_paged_attention import ragged_paged_attention
from ..ops.lora import lora_down, lora_up
from ..quantization.int8 import (
    Int8Linear, activation_scales, int8_accumulate, int8_epilogue, k_major,
    quantize_weight, quantized_matmul, refuse_tensor_parallel,
)
from ..quantization.kv import quantize_kv_write
from .generation import GenerationMixin, KVCache

__all__ = [
    "GPTConfig",
    "GPTModel",
    "GPTForPretraining",
    "GPTAttention",
    "GPTMLP",
    "GPTDecoderLayer",
    "GPTStackedForPretraining",
    "GPTPretrainingCriterion",
    "GPTLMHead",
    "causal_attention_plain",
    "gpt_tiny",
    "gpt_small",
    "gpt_1p3b",
    "gpt_13b",
    "truncated_draft",
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
    # on a mesh with an mp axis > 1 (``distributed.mesh.set_mesh``): the
    # stacked model cuts the word embeddings by vocabulary rows over mp and
    # the tied head's loss over the vocabulary shards (the reference's
    # VocabParallelEmbedding and ParallelCrossEntropy), its decoder's
    # projections being cut over mp either way; the layered model's
    # blocks are built of the mpu layers (``layered_tp``), and without it
    # stay whole
    use_tensor_parallel: bool = False
    # on a mesh with an 'sp' axis > 1: the layered model holds its
    # activations as sp sequence parts and attends over them by ring
    # attention (``layered_sp``); the stacked model, as the reference's
    # stacked block, does not read it
    sequence_parallel: bool = False
    recompute_interval: int = 0         # 0 = off; k = remat every k blocks
    # what a recomputed group keeps (recompute_interval > 0): None or
    # "full" recompute the whole group in the backward; "dots" keeps the
    # outputs of the 2-D products (the projections: aten.mm/addmm) and
    # recomputes the rest; "dots_saveable" also keeps batched products
    # (aten.bmm) -- the reference's jax checkpoint policies
    # dots_with_no_batch_dims_saveable and dots_saveable
    recompute_policy: Optional[str] = None
    # interleaved virtual pipeline stages per pp stage (chunk c of the
    # layers on stage c % pp; distributed.pp_spmd.stage_layers)
    virtual_pp_degree: int = 1
    # None or True: training attention runs through flash_attention_bnsd
    # (the kernels on the card, their plain version on the CPU) unless
    # attention dropout is active; False: the reference's plain causal
    # expression (causal_attention_plain) on every device
    use_flash_attention: Optional[bool] = None

    def __post_init__(self):
        # a typo'd policy fails when the config is made, not only when
        # recompute engages, as in the reference
        if self.recompute_policy not in RECOMPUTE_POLICIES:
            raise ValueError(
                f"unknown remat policy {self.recompute_policy!r}; expected "
                "one of [None, 'full', 'dots', 'dots_saveable']")

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
    att = dropout(torch.softmax(scores, dim=-1), dropout_p,
                  generator=generator)
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


class BlockOps(NamedTuple):
    """The rounding points of one GPT class's decoder block, shared by its
    unsharded block, its tensor-parallel training block
    (:func:`shard_block_ops`) and the sharded serving body
    (:func:`sharded_paged_layers`), so each is written once:

    - ``norm(x, g, beta)``: a LayerNorm and its output in the products'
      input dtype;
    - ``col(x, w, ws, bias, act)``: a product over whole input rows (the
      int8 scales ``ws`` and static activation scale ``act``, or None);
    - ``partial(x, w)``: a float row-parallel partial, without the bias
      (added once, after the reduce);
    - ``row(x, w, ws, bias, act)``: a row-parallel projection (``col``
      unsharded; the shards' partials, their reduce and the bias under
      tensor parallelism);
    - ``each(fn, y)``: ``fn(y_i, i)`` on each shard ``i`` of a
      column-parallel value (``fn(y, 0)`` unsharded);
    - ``lora_in(x, a_dtype)`` / ``lora_out(delta)``: the LoRA delta's
      input and the delta as the product adds it;
    - ``residual(h, y)``: the residual add."""
    norm: object
    col: object
    partial: object
    row: object
    each: object
    lora_in: object
    lora_out: object
    residual: object


def _one_shard(fn, y):
    return fn(y, 0)


def stacked_block_ops(eps: float, int8: bool, pdt) -> BlockOps:
    """The stacked block's (the reference's ``_block_fn`` family): an fp32
    LayerNorm feeding fp32 into ``quantized_matmul`` for int8 weights,
    else the LayerNorm rounded to the products' dtype ``pdt`` and
    ``addmm``; an int8 projection's LoRA input rounded to the slab dtype
    and its delta added in fp32; the residual cast back to h's dtype."""
    if int8:
        def norm(x, g, beta):
            return _layer_norm(x.float(), g.float(), beta.float(), eps)

        def col(x, w, ws, bias, act=None):
            return quantized_matmul(x, w, ws, bias=bias)
    else:
        def norm(x, g, beta):
            return _layer_norm(x, g, beta, eps).to(pdt)

        def col(x, w, ws, bias, act=None):
            return torch.addmm(bias, x, w)
    return BlockOps(
        norm, col, torch.mm, col, _one_shard,
        (lambda x, adt: x.to(adt)) if int8 else (lambda x, adt: x),
        (lambda d: d.float()) if int8 else _identity,
        lambda h, y: h + y.to(h.dtype))


def layered_block_ops(eps: float) -> BlockOps:
    """The layered block's: the bodies of ``LayerNorm.forward``,
    ``Linear.forward`` and ``Int8Linear.forward`` (static activation
    scale ``act``), the LoRA delta in the input's dtype, a plain residual
    add."""
    def norm(x, g, beta):
        return NF.layer_norm(x, x.shape[-1], g, beta, eps)

    def col(x, w, ws, bias, act=None):
        if ws is not None:
            return quantized_matmul(x, w, ws, bias=bias, act_scale=act)
        return NF.linear(x, w, bias)

    return BlockOps(norm, col, NF.linear, col, _one_shard,
                    lambda x, adt: x, _identity, lambda h, y: h + y)


def shard_block_ops(base: BlockOps, devices) -> BlockOps:
    """``base`` over ``mp`` shards on ``devices`` (one a shard; a device
    may repeat), for float weights: the replicated values (the residual
    stream, LayerNorm outputs, row-parallel sums) live on ``devices[0]``,
    a column-parallel value is a list of shard tensors.  ``col`` runs
    each shard's product on the LayerNorm output sent to its device;
    ``row`` sums the shards' partials on ``devices[0]`` in shard order
    (``serving_mesh.reduce_sum``) and adds the bias once."""
    root = devices[0]

    def col(x, w, ws, bias, act=None):
        xs = broadcast(x, devices)
        return [base.col(xs[d], wi, None, bi)
                for d, wi, bi in zip(devices, w, bias)]

    def row(x, w, ws, bias, act=None):
        tot = reduce_sum([base.partial(xi, wi) for xi, wi in zip(x, w)],
                         (root,))[root]
        return tot + bias

    def each(fn, y):
        return [fn(t, i) for i, t in enumerate(y)]

    return base._replace(col=col, row=row, each=each)


def lora_cuts(cfg: GPTConfig, mp: int, device) -> dict:
    """What shard ``i`` of ``mp`` tensor-parallel shards holds of each
    projection ``j`` (qkv, out, fc1, fc2), for its LoRA factors on
    ``device``: the fused QKV's columns (its heads of q, k and v,
    ``serving_mesh.qkv_columns``, on ``device``), then ``(offset,
    length)`` of the output projection's rows and of fc1's columns and
    fc2's rows.  Made once for each widths, mp and device."""
    return _lora_cuts(cfg.num_heads, cfg.head_dim, cfg.ffn_size, int(mp),
                      torch.device(device))


@lru_cache(maxsize=None)
def _lora_cuts(nh: int, hd: int, f: int, mp: int, device) -> dict:
    hs = nh // mp
    return {0: [qkv_columns(nh, hd, mp, i, device) for i in range(mp)],
            1: [(i * hs * hd, hs * hd) for i in range(mp)],
            2: [(i * (f // mp), f // mp) for i in range(mp)],
            3: [(i * (f // mp), f // mp) for i in range(mp)]}


def _lora_shard(t, cuts: dict, j: int, i: int, axis: int):
    """Shard ``i``'s part of a gathered factor of projection ``j`` along
    ``axis`` (``cuts`` made for ``t``'s device)."""
    cut = cuts[j][i]
    if j == 0:
        return t.index_select(axis, cut)
    return t.narrow(axis, *cut)


class LayerLoRA(NamedTuple):
    """One layer's adapter factors for a step (``ops/lora.py``'s
    arithmetic, its rounding points those of the block's
    :class:`BlockOps`): ``factors[j]`` for each of qkv, out, fc1 and fc2
    is ``(A [T, in, r], B [T, r, out], A dtype, B dtype)``, the slabs
    gathered at each row's adapter page and widened to fp32.  The delta
    of a whole projection (:meth:`whole`), and under tensor parallelism
    each shard's (:meth:`cols`, :meth:`row`), as the reference's GSPMD
    computes the whole one: a column-parallel shard adds its columns of
    the delta, a row-parallel projection sums the shards' first
    contractions (fp32 ``u``) and adds the delta once.  Factors move to
    the device that reads them (a no-op on one card); ``cuts`` is
    :func:`lora_cuts` for :attr:`device`."""
    factors: list
    scaling: float

    @classmethod
    def gather(cls, slabs, ids, scaling) -> "LayerLoRA":
        """The eight slabs of one layer (``serving/lora.py`` order) at
        ``ids`` [T], each row's adapter page."""
        idx = ids.long().to(slabs[0].device)
        return cls([(slabs[2 * j].index_select(0, idx).float(),
                     slabs[2 * j + 1].index_select(0, idx).float(),
                     slabs[2 * j].dtype, slabs[2 * j + 1].dtype)
                    for j in range(4)], float(scaling))

    @property
    def device(self) -> torch.device:
        """The device the factors lie on (the pool's)."""
        return self.factors[0][0].device

    def whole(self, ops, x, j: int):
        """Projection ``j``'s delta of ``x`` [T, S, in] on its device."""
        a, b, adt, bdt = self.factors[j]
        lx = ops.lora_in(x, adt)
        d = x.device
        u = lora_down(lx, a.to(d), adt)
        return ops.lora_out(lora_up(u, b.to(d), bdt, self.scaling,
                                    lx.dtype))

    def cols(self, ops, cuts: dict, x, j: int, devices) -> list:
        """Each shard's columns of column-parallel projection ``j``'s
        delta of the whole input ``x`` [T, S, in], shard ``i``'s on
        ``devices[i]``: the first contraction once, on ``x``'s device, and
        its rank-wide result moved to each shard for the second."""
        a, b, adt, bdt = self.factors[j]
        lx = ops.lora_in(x, adt)
        u = lora_down(lx, a.to(x.device), adt)
        return [ops.lora_out(lora_up(
            u.to(d), _lora_shard(b, cuts, j, i, 2).to(d), bdt, self.scaling,
            lx.dtype)) for i, d in enumerate(devices)]

    def row(self, ops, cuts: dict, parts, j: int, mesh) -> dict:
        """Row-parallel projection ``j``'s delta from the shards' inputs
        ``parts`` ([T, S, in/mp] each on its shard's device): each
        shard's first contraction over its rows of A, summed in shard
        order on every device of ``mesh`` (``serving_mesh.reduce_sum``),
        then the second product there: ``{device: [T, S, out]}``."""
        a, b, adt, bdt = self.factors[j]
        lx = [ops.lora_in(p, adt) for p in parts]
        u = reduce_sum([lora_down(x, _lora_shard(a, cuts, j, i, 1).to(
            x.device), adt) for i, x in enumerate(lx)], mesh)
        return {d: ops.lora_out(lora_up(ud, b.to(d), bdt, self.scaling,
                                        lx[0].dtype))
                for d, ud in u.items()}


def stacked_loras(lora, num_layers: int):
    """Each layer's :class:`LayerLoRA` from ``lora``, ``(a stacked
    LoRAAdapterPool, ids)``, gathered as the layer's turn comes (an
    iterator: one layer's gathered factors alive at a time); Nones
    without ``lora``."""
    if lora is None:
        return [None] * num_layers
    pool, ids = lora
    return (LayerLoRA.gather(sl, ids, pool.scaling)
            for sl in zip(*(t.unbind(0) for t in pool.stacked_slabs())))


def _cast(t, dtype):
    """``t``, or each shard of a list, cast to ``dtype``."""
    if isinstance(t, list):
        return [x.to(dtype) for x in t]
    return t.to(dtype)


def _first(t):
    return t[0] if isinstance(t, list) else t


def layered_tp(cfg: GPTConfig, factory: dict):
    """The tensor-parallel placement the global mesh asks of the layered
    blocks: ``(devices, factory)`` -- stage 0's shard devices
    (``mesh.stage_devices``) and ``factory`` with their first as the
    device of the whole parameters -- when ``use_tensor_parallel`` is set
    and the mesh's mp > 1 (the reference's mpu layers), else ``(None,
    factory)``.  dp, sharding and pp keep the reference's meaning: a
    bare block neither shards its batch nor pipelines (``PipelineLayer``
    and the fleet wrappers do); sp and sep are read at coordinate 0 (the
    sequence parts are :func:`layered_sp`'s)."""
    if not _mesh.has_mesh():
        return None, factory
    mp = _mesh.get_mesh().shape.get("mp", 1)
    if not (cfg.use_tensor_parallel and mp > 1):
        return None, factory
    for what, n in (("num_heads", cfg.num_heads), ("ffn size", cfg.ffn_size),
                    ("vocab_size", cfg.vocab_size)):
        if n % mp:
            raise ValueError(f"{what}={n} is not divisible by mp={mp}")
    devs = _mesh.stage_devices(0)
    asked = factory.get("device")
    if asked is not None and canonical_device(asked) != devs[0]:
        raise ValueError(f"device={asked}: a block placed on a mesh lives "
                         f"on the mesh's devices, first {devs[0]}")
    return devs, dict(factory, device=devs[0])


def layered_sp(cfg: GPTConfig) -> int:
    """The sequence parts the global mesh asks of the layered GPT: its
    ``sp`` axis with ``sequence_parallel`` (the reference's ``_seq_shard``
    and ring attention), else 1.  Where the sp positions name devices of
    their own (:func:`_sp_rows`) each position from 1 on holds a copy of
    the weights (:meth:`GPTModel.copy_over_sp`); else the parts share the
    one set."""
    if not (cfg.sequence_parallel and _mesh.has_mesh()):
        return 1
    return _mesh.get_mesh().shape.get("sp", 1)


def _sp_rows(cfg: GPTConfig):
    """The devices of each sp position of the global mesh (stage 0 of
    replica 0): one a tensor-parallel shard under :func:`layered_tp`,
    else the first alone.  None where every position names position 0's
    devices (one card named for each, as ``["cuda:0"] * n`` does)."""
    grid = _mesh.get_mesh().grid(("dp", "sharding", "pp", "sep", "sp", "mp"))
    grid = grid.reshape((-1,) + grid.shape[2:])[0, 0, 0]
    tp = layered_tp(cfg, {})[0] is not None
    rows = [tuple(row) if tp else (row[0],) for row in grid]
    return rows if any(row != rows[0] for row in rows) else None


class GPTEmbeddings(nn.Module):
    """The word and position tables.  Under tensor parallelism
    (:func:`layered_tp`) the word table is a ``VocabParallelEmbedding``
    and the position table stays whole on the first shard's device.
    ``position_ids`` default to ``0 .. S-1``."""

    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        devs, factory = layered_tp(cfg, factory)
        if devs is None:
            self.word_embeddings = nn.Embedding(cfg.vocab_size,
                                                cfg.hidden_size, **factory)
        else:
            self.word_embeddings = VocabParallelEmbedding(
                cfg.vocab_size, cfg.hidden_size, dtype=factory.get("dtype"))
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, **factory)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)
            position_ids = position_ids.expand_as(input_ids)
        return (self.word_embeddings(input_ids)
                + self.position_embeddings(position_ids))


def _part_seed(seed: int, part: int) -> int:
    """A seed for one part of a layer's masks (a replica's or a
    microbatch's rows, a shard's heads), derived from the layer's seed by
    splitmix64: parts draw different masks, and a rerun the same."""
    z = (seed + (part + 1) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) % 2 ** 62


# mesh axes a training placement reads (dp x sharding the replicas); the
# others must have size 1
_TRAIN_AXES = ("dp", "sharding", "pp", "mp")
# axes the stacked model reads at coordinate 0: the reference's stacked
# block never reads them
_SEQUENCE_AXES = ("sp", "sep")


class TrainMesh(NamedTuple):
    """Where a model placed for training on a mesh holds what:
    ``grid[r, s, i]`` is the device of replica ``r`` (over dp x sharding,
    dp major, as ``mesh.stage_devices`` counts them), pipeline stage
    ``s``, tensor-parallel shard ``i``; ``layers[s]`` the decoder layers
    stage ``s`` holds, in the order it runs them
    (``pp_spmd.stage_layers``); ``vocab_parallel``: the word embeddings
    are cut by vocabulary rows over mp (``use_tensor_parallel``)."""
    grid: np.ndarray
    layers: list
    vocab_parallel: bool

    @property
    def dp(self) -> int:
        return self.grid.shape[0]

    @property
    def pp(self) -> int:
        return self.grid.shape[1]

    @property
    def mp(self) -> int:
        return self.grid.shape[2]

    def dev(self, r: int, s: int, i: int = 0) -> torch.device:
        return self.grid[r, s, i]

    def tp(self, r: int, s: int):
        """The shard devices of stage ``s`` of replica ``r`` (None at
        mp = 1)."""
        return None if self.mp == 1 else tuple(self.grid[r, s])


def train_mesh(cfg: GPTConfig) -> Optional[TrainMesh]:
    """The training placement the global mesh (``distributed.mesh``) asks
    of a stacked GPT, or None: no mesh, or one whose dp, sharding, pp and
    mp are all 1.  The replicas run over dp x sharding (ZeRO,
    ``distributed.sharding``, cuts their state over the sharding axis).
    An sp or sep axis is read at coordinate 0: the result is the run's
    without it.  A shape the cuts cannot take raises ``ValueError``."""
    if not _mesh.has_mesh():
        return None
    mesh = _mesh.get_mesh()
    grid = mesh.grid(_TRAIN_AXES + _SEQUENCE_AXES)[..., 0, 0]
    grid = grid.reshape((-1,) + grid.shape[2:])
    dp, pp, mp = grid.shape
    if dp * pp * mp == 1:
        return None
    if mp > 1:
        for what, n in (("num_heads", cfg.num_heads),
                        ("ffn size", cfg.ffn_size)):
            if n % mp:
                raise ValueError(f"{what}={n} is not divisible by mp={mp}")
        if cfg.use_tensor_parallel and cfg.vocab_size % mp:
            raise ValueError(f"vocab_size={cfg.vocab_size} is not "
                             f"divisible by mp={mp} (VocabParallelEmbedding)")
    if cfg.num_layers % pp:
        # the reference's stacked decoder refuses it, in these words
        raise ValueError(
            f"num_layers={cfg.num_layers} must be divisible by the pp mesh "
            f"axis size {pp} (uniform stage segmenting)")
    # without pipeline stages the interleave has no effect, as in the
    # reference
    vpp = cfg.virtual_pp_degree if pp > 1 else 1
    return TrainMesh(grid, stage_layers(cfg.num_layers, pp, vpp),
                     bool(cfg.use_tensor_parallel and mp > 1))


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

    # the tensor-parallel cuts on a mesh with mp > 1: name -> (the axis
    # cut, what it cuts: QKV's heads, the ffn width or the hidden width)
    TP_CUTS = {"qkv_w": (2, "qkv"), "qkv_b": (1, "qkv"), "fc1_w": (2, "ffn"),
               "fc1_b": (1, "ffn"), "proj_w": (1, "hidden"),
               "fc2_w": (1, "ffn")}

    def __init__(self, cfg: GPTConfig, **factory):
        """Under a global training mesh (:func:`train_mesh`, read here as
        the reference's ``_shard_params`` reads it) each slab is a
        :class:`~paddle_tpu_torch.distributed.shards.ShardedParameter`:
        stage ``s`` of each replica holds its layers' rows
        (``mesh.layers[s]``) on its devices, the :data:`TP_CUTS` slabs cut
        over the stage's mp shards -- QKV by head within each of q, k and
        v (``serving_mesh.qkv_columns``), fc1 by contiguous columns, the
        output projection and fc2 by rows -- and the LayerNorms and the
        row-parallel biases whole on the stage's first shard."""
        super().__init__()
        self._cfg = cfg
        self._mesh = mesh = train_mesh(cfg)
        self.weight_int8 = False
        L, h, f = cfg.num_layers, cfg.hidden_size, cfg.ffn_size
        shapes = {"ln1_g": (L, h), "ln1_b": (L, h), "qkv_w": (L, h, 3 * h),
                  "qkv_b": (L, 3 * h), "proj_w": (L, h, h), "proj_b": (L, h),
                  "ln2_g": (L, h), "ln2_b": (L, h), "fc1_w": (L, h, f),
                  "fc1_b": (L, f), "fc2_w": (L, f, h), "fc2_b": (L, h)}
        for name in self.PARAM_NAMES:
            if mesh is None:
                self.register_parameter(
                    name, nn.Parameter(torch.empty(shapes[name], **factory)))
            else:
                self.add_module(name, ShardedParameter(
                    shapes[name], factory["dtype"], self._parts(name)))

    def _parts(self, name: str):
        """The :class:`Part` of every mesh position that holds a piece of
        slab ``name``."""
        from ..distributed.serving_mesh import qkv_columns

        cfg, tm = self._cfg, self._mesh
        mp = tm.mp
        cut = self.TP_CUTS.get(name) if mp > 1 else None
        parts = []
        for r in range(tm.dp):
            for s in range(tm.pp):
                rows = (0, torch.tensor(tm.layers[s]))
                if cut is None:
                    parts.append(Part((r, s, 0), tm.dev(r, s), (rows,)))
                    continue
                axis, kind = cut
                for i in range(mp):
                    if kind == "qkv":
                        idx = qkv_columns(cfg.num_heads, cfg.head_dim, mp, i)
                    else:
                        n = (cfg.ffn_size if kind == "ffn"
                             else cfg.hidden_size) // mp
                        idx = torch.arange(i * n, (i + 1) * n)
                    parts.append(Part((r, s, i), tm.dev(r, s, i),
                                      (rows, (axis, idx))))
        return parts

    def _block(self, h, weights, attend, int8: bool = False,
               drop=_identity, lora=None, cdt=None, tp=None):
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
        ``_paged_block_fn`` does.

        ``lora``: this layer's :class:`LayerLoRA`, one row a token row of
        ``h``.  Each projection then adds its low-rank delta
        (``ops/lora.py``) on the same input as its base product: in the
        weight dtype, or, for int8 projections, on the fp32 input rounded
        to the slab dtype, added in fp32 (the reference's
        ``_paged_block_fn``); under ``tp`` each shard's part of it
        (:meth:`LayerLoRA.col`, :meth:`LayerLoRA.row`).
        ``cdt``: the amp dtype of an ``auto_cast`` at O1 the caller read
        (:func:`~paddle_tpu_torch.amp.auto_cast.o1_dtype`; passed, not read
        here, because a recompute runs outside the ``auto_cast`` block),
        or None.  With it, the eight projection weights and biases are
        cast to ``cdt`` and each LayerNorm output is rounded to it before
        its product, while the LayerNorms and the residual stream keep
        h's dtype -- the reference's block under ``auto_cast``
        (``paddle_tpu/models/gpt.py`` ``_block_fn``); int8 projections
        are never cast.

        ``tp``: the devices of ``mp > 1`` tensor-parallel shards (one a
        shard; a device may repeat), or None.  Then the column-parallel
        weights (``qkv_w``, ``qkv_b``, ``proj_w``, ``fc1_w``, ``fc1_b``,
        ``fc2_w``) are lists of shard slices, ``attend`` a list of one
        route a shard, and the same body runs through
        :func:`shard_block_ops`: each shard's QKV product and attention
        at ``H/mp`` heads, the output projection's partials summed on
        ``tp[0]`` and its bias added once, then fc1 per shard and fc2's
        partials likewise; ``h`` and the LayerNorms stay on ``tp[0]``."""
        cfg = self._cfg
        hd, eps = cfg.head_dim, cfg.layer_norm_eps
        if int8:
            (l1g, l1b, qkvw, qkvs, qkvb, pw, pws, pb, l2g, l2b, f1w, f1s, f1b,
             f2w, f2s, f2b) = weights
        else:
            (l1g, l1b, qkvw, qkvb, pw, pb, l2g, l2b, f1w, f1b, f2w,
             f2b) = weights
            qkvs = pws = f1s = f2s = None
            if cdt is not None:
                # AMP O1 (the reference's block under auto_cast): the
                # products run in the amp dtype, LayerNorm in the weights'
                # (fp32) dtype, the residual stream stays in h's
                qkvw, qkvb, pw, pb, f1w, f1b, f2w, f2b = (
                    _cast(t, cdt) for t in (qkvw, qkvb, pw, pb, f1w, f1b,
                                            f2w, f2b))
        # the LayerNorm output is rounded to the projections' dtype (a
        # no-op unless O1 casts the weights; int8 products take fp32)
        ops = stacked_block_ops(eps, int8, _first(qkvw).dtype)
        if tp is not None:
            ops = shard_block_ops(ops, tp)
        b, s, hidden = h.shape
        if lora is not None and tp is not None:
            cuts = lora_cuts(cfg, len(tp), lora.device)

        def rows(t):
            return t.view(b, s, t.shape[-1])

        def lin(x, w, ws, bias, j):
            """Projection ``j`` (qkv, out, fc1, fc2), with its delta (each
            row's ``s`` positions share the row's adapter)."""
            y = (ops.row if j % 2 else ops.col)(x, w, ws, bias)
            if lora is None:
                return y
            if tp is None:
                return y + lora.whole(ops, rows(x), j).view(b * s, -1)
            if j % 2:
                d = lora.row(ops, cuts, [rows(p) for p in x], j,
                             tp[:1])[tp[0]]
                return y + d.view(b * s, -1)
            ds = lora.cols(ops, cuts, rows(x), j, tp)
            return [yi + di.view(b * s, -1) for yi, di in zip(y, ds)]

        def heads(qkv, i):
            """One shard's attention: its [B*S, 3, heads, D] QKV columns
            -> [B*S, heads*D] in the products' dtype (the cache dtype may
            differ)."""
            route = attend if tp is None else attend[i]
            out = route(*qkv.view(b, s, 3, -1, hd).unbind(2))
            return out.reshape(b * s, -1).to(x.dtype)

        def gelu(u, i):
            return F.gelu(u, approximate="tanh")

        x = ops.norm(h, l1g, l1b).reshape(b * s, hidden)
        out = ops.each(heads, lin(x, qkvw, qkvs, qkvb, 0))
        h = ops.residual(h, drop(lin(out, pw, pws, pb, 1).view(b, s, hidden)))
        y = ops.norm(h, l2g, l2b).reshape(b * s, hidden)
        y = ops.each(gelu, lin(y, f1w, f1s, f1b, 2))
        return ops.residual(h, drop(lin(y, f2w, f2s, f2b, 3).view(b, s,
                                                                  hidden)))

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

    def _blocks(self, h, seeds, cdt, tp, *weights):
        """Consecutive training blocks; ``weights`` holds each block's 12
        slices, block after block; ``seeds`` one dropout seed per block,
        or None without dropout; ``cdt`` the amp dtype and ``tp`` the
        shard devices for :meth:`_block`.  A block draws its masks from a
        generator seeded with its seed, in block order: the attention
        probabilities, the attention projection, the MLP output; under
        ``tp`` each shard draws its heads' attention masks from a seed of
        its own (:func:`_part_seed`)."""
        n = len(self.PARAM_NAMES)
        hid_p = self._cfg.hidden_dropout
        attend = (self._train_attend if tp is None
                  else [self._train_attend] * len(tp))
        for j, i in enumerate(range(0, len(weights), n)):
            if seeds is None:
                h = self._block(h, weights[i:i + n], attend, cdt=cdt, tp=tp)
                continue
            gen = _seeded(seeds[j], h.device)
            if tp is None:
                route = partial(self._train_attend, gen=gen)
            else:
                route = [partial(self._train_attend, gen=_seeded(
                    _part_seed(seeds[j], k), d)) for k, d in enumerate(tp)]
            h = self._block(
                h, weights[i:i + n], route,
                drop=lambda x: dropout(x, hid_p, generator=gen), cdt=cdt,
                tp=tp)
        return h

    def _scan(self, h, seeds, layers, cdt, tp=None):
        """``h`` through ``layers`` (each a block's 12 weights) in order,
        groups of ``recompute_interval`` blocks under activation
        checkpointing in training (:meth:`forward`)."""
        cfg = self._cfg
        k = cfg.recompute_interval if self.training else 0
        if k > 0 and len(layers) % k:
            raise ValueError(f"recompute_interval={k} must divide "
                             f"num_layers={len(layers)}")
        if k <= 0:
            return self._blocks(h, seeds, cdt, tp,
                                *(w for layer in layers for w in layer))
        group_fn = checkpointed(self._blocks, cfg.recompute_policy)
        for g0 in range(0, len(layers), k):
            group = [w for layer in layers[g0:g0 + k] for w in layer]
            group_seeds = None if seeds is None else seeds[g0:g0 + k]
            h = group_fn(h, group_seeds, cdt, tp, *group)
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
        contiguous-cache path refuse it.

        Under a global mesh with mp > 1, or placed at mp > 1, it raises the
        reference's ``ValueError``.  Placed at mp = 1 (dp, sharding or pp
        only), each pipeline stage quantizes replica 0's rows of its layers
        on the stage's device (:attr:`stage_int8`, beside the parts and
        out of the state dict); the scales are per layer and output
        channel, so the values are the unplaced model's."""
        if self.weight_int8:
            return
        tm = self._mesh
        if (_mesh.has_mesh() and _mesh.get_mesh().shape.get("mp", 1) > 1) \
                or (tm is not None and tm.mp > 1):
            raise ValueError(
                "quantize_weights: the stacked projection weights are "
                "mp-sharded; per-channel PTQ over gathered shards is not "
                "supported — serve tensor-parallel models with fp weights")
        if tm is None:
            for name in self.QUANTIZED:
                q, s = quantize_weight(getattr(self, name), 1)  # [L, in, out]
                self.register_buffer(name + "_int8", k_major(q))
                self.register_buffer(name + "_s", s)
        else:
            self.stage_int8 = []
            for st in range(tm.pp):
                slabs = {}
                for name in self.QUANTIZED:
                    q, s = quantize_weight(
                        getattr(self, name).at((0, st, 0)), 1)
                    slabs[name + "_int8"], slabs[name + "_s"] = k_major(q), s
                self.stage_int8.append(slabs)
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
        runs under the port's checkpoint: the backward recomputes the
        group's forward from its input and its seeds instead of keeping
        its activations -- all of it, or, under ``recompute_policy``
        "dots"/"dots_saveable", all but the products the policy keeps
        (PyTorch's selective checkpoint contexts).  The flash
        kernels and the dropout masks are recomputed under every policy:
        the kernels launch outside PyTorch's dispatcher, and each block
        reseeds its generator from its seed.

        Under ``amp.auto_cast`` O1 each block casts its projection
        weights to the amp dtype (:meth:`_block`)."""
        self._check_fp_weights("the training forward")
        if (seeds is not None) != self.dropout_active():
            raise ValueError("GPTStackedDecoder.forward: pass one dropout "
                             "seed per layer exactly when dropout is active")
        if self._mesh is not None:
            raise ValueError("a decoder placed on a mesh runs through "
                             "forward_mesh (GPTStackedForPretraining)")
        return self._scan(h, seeds, list(self._layers()), o1_dtype())

    def stage_weights(self, tied, r: int, s: int):
        """The layers of stage ``s`` of replica ``r`` on a mesh, in run
        order: each a block's 12 weights, a list of shard slices for the
        :data:`TP_CUTS` slabs at mp > 1.  ``tied``: each slab's parts by
        mesh position (after :func:`tie_replicas`); one unbind a part."""
        tm = self._mesh
        per_name = []
        for name in self.PARAM_NAMES:
            parts = tied[name]
            if tm.mp > 1 and name in self.TP_CUTS:
                shards = [parts[(r, s, i)].unbind(0) for i in range(tm.mp)]
                per_name.append([list(x) for x in zip(*shards)])
            else:
                per_name.append(parts[(r, s, 0)].unbind(0))
        return list(zip(*per_name))

    def forward_mesh(self, h, tied, r: int, seeds, cdt, n_micro: int):
        """Replica ``r``'s decoder on the mesh: ``h`` [b, S, hidden] on its
        stage 0's first device -> the last stage's output there.
        ``seeds``: one dropout seed per layer and part (``seeds(layer,
        microbatch)``), or None.

        Without pipeline stages (pp = 1) the layers run as
        :meth:`forward` runs them, with the stage's shards (``n_micro``
        has no effect, as in the reference).  With pp > 1 the batch splits
        into ``n_micro`` microbatches through
        ``pp_spmd.pipeline_blocks`` (interleaved over
        ``virtual_pp_degree`` trips); under ``recompute_interval > 0``
        each block is recomputed per microbatch, and the interval is not
        read, as in the reference."""
        cfg, tm = self._cfg, self._mesh
        self._check_fp_weights("the training forward")
        if tm.pp == 1:
            layer_seeds = (None if seeds is None
                           else [seeds(l, 0) for l in tm.layers[0]])
            return self._scan(h, layer_seeds, self.stage_weights(tied, r, 0),
                              cdt, tm.tp(r, 0))
        b = h.shape[0]
        if b % n_micro:
            raise ValueError(f"the batch of {b} rows a replica does not "
                             f"split into n_micro={n_micro} microbatches")
        stages = [[(w, tm.tp(r, s), layer) for w, layer in zip(
            self.stage_weights(tied, r, s), tm.layers[s])]
            for s in range(tm.pp)]

        def block(p, x, mb):
            w, tp, layer = p
            sd = None if seeds is None else [seeds(layer, mb)]
            return self._blocks(x, sd, cdt, tp, *w)

        remat = self.training and cfg.recompute_interval > 0
        outs = pipeline_blocks(
            block, stages, h.split(b // n_micro),
            layers_per_stage=cfg.num_layers // tm.pp, remat=remat,
            remat_policy=cfg.recompute_policy, block_takes_index=True,
            n_virtual=cfg.virtual_pp_degree,
            stage_devices=[tm.dev(r, s) for s in range(tm.pp)])
        return torch.cat(outs)

    def forward_placed(self, h, held, routes, lora=None):
        """Replica 0's layers on the mesh for the cache paths: ``h`` [B, S,
        hidden] on its stage 0's first device through layers 0 .. L-1 in
        order (a plain scan, not pipelined, as the reference's cached
        path), each on the devices of its stage's parts -- the training
        block (:meth:`_block`) at mp > 1 with each shard attending over its
        heads -- the hidden state moved to a stage's first device where
        the layers cross to it.  ``held``: each slab's parts by mesh
        position; ``routes``: each layer's attention route (a list of one
        a shard at mp > 1, :func:`placed_routes`).  After
        :meth:`quantize_weights` (mp = 1) each layer runs its stage's int8
        slabs.  ``lora``: ``(a stacked LoRAAdapterPool, ids)``, each
        layer's delta on its stage's devices (per shard at mp > 1).
        Returns the last layer's output on its device."""
        tm, cdt = self._mesh, o1_dtype()
        dec = {n: held["decoder." + n] for n in self.PARAM_NAMES}
        stages = []
        for st in range(tm.pp):
            if not self.weight_int8:
                stages.append(self.stage_weights(dec, 0, st))
                continue
            slabs = self.stage_int8[st]
            stages.append(list(zip(*(
                (slabs[n] if n in slabs else dec[n][(0, st, 0)]).unbind(0)
                for n in self.INT8_NAMES))))
        where = {layer: (st, j) for st in range(tm.pp)
                 for j, layer in enumerate(tm.layers[st])}
        loras = stacked_loras(lora, self._cfg.num_layers)
        for layer, lr in zip(range(self._cfg.num_layers), loras):
            st, j = where[layer]
            h = h.to(tm.dev(0, st))
            h = self._block(h, stages[st][j], routes[layer],
                            int8=self.weight_int8, lora=lr, cdt=cdt,
                            tp=tm.tp(0, st))
        return h

    def forward_cached(self, h, k_cache, v_cache, pos):
        """Prefill or decode over a contiguous cache (the reference's
        ``_forward_cached`` with ``_raw_attend_with_cache``).  ``h``
        [B, S, hidden]; ``k_cache``/``v_cache`` the stacked
        ``[L, B, H, max_seq, D]`` cache, written in place at positions
        ``pos .. pos + S - 1``; ``pos`` the Python int 0 (the whole-prompt
        prefill) or a 0-d integer tensor on the cache's device.  Each
        layer attends through :func:`attend_with_cache`."""
        self._check_fp_weights("the contiguous-cache path (generate)")
        scale = float(1.0 / np.sqrt(self._cfg.head_dim))
        idx = cache_positions(h.shape[1], pos, h.device)
        cdt = o1_dtype()
        for weights, kc, vc in zip(self._layers(), k_cache.unbind(0),
                                   v_cache.unbind(0)):
            h = self._block(h, weights, partial(
                attend_with_cache, kc=kc, vc=vc, pos=pos, idx=idx,
                scale=scale), cdt=cdt)
        return h

    def forward_paged(self, h, k_pool, v_pool, tables, pos, ragged_plan,
                      k_scale=None, v_scale=None, lora=None):
        """One paged step over every layer.  ``h`` [S, C, hidden]: C tokens
        of each of S rows at positions ``pos[s] .. pos[s] + C - 1``;
        ``k_pool``/``v_pool`` the stacked ``[L, P, H, page_size, D]`` pool,
        written in place; ``tables`` [S, max_pages] the rows' page tables;
        ``k_scale``/``v_scale`` the stacked ``[L, P, H]`` scales of an int8
        pool, updated in place (None for a float pool).  Each layer
        attends through :func:`attend_paged` (the ragged kernel with a
        ``ragged_plan``, the paged kernel for C == 1 without one, the
        chunked prefill for C > 1).

        ``lora``: ``(LoRAAdapterPool, ids)`` with ``ids`` [S] the adapter
        page of each row; the pool's stacked slabs are read layer by layer
        beside the stacked weights."""
        cfg = self._cfg
        geo = paged_geometry(tables, pos, h.shape[1], k_pool.shape[3],
                             cfg.num_heads)
        scale = float(1.0 / np.sqrt(cfg.head_dim))
        int8 = self.weight_int8
        names = self.INT8_NAMES if int8 else self.PARAM_NAMES
        pools = [k_pool.unbind(0), v_pool.unbind(0)]
        pools += ([k_scale.unbind(0), v_scale.unbind(0)]
                  if k_scale is not None else [[None] * cfg.num_layers] * 2)
        loras = stacked_loras(lora, cfg.num_layers)
        cdt = o1_dtype()
        for weights, kp, vp, ks, vs, lr in zip(self._layers(names), *pools,
                                               loras):
            h = self._block(
                h, weights, partial(attend_paged, kp=kp, vp=vp, ks=ks, vs=vs,
                                    geo=geo, ragged_plan=ragged_plan,
                                    scale=scale),
                int8=int8, lora=lr, cdt=cdt)
        return h


def cache_positions(s: int, pos, device) -> torch.Tensor:
    """The cache slots ``pos .. pos + s - 1`` of a step as a device index
    tensor (a Python slice at a tensor position would sync)."""
    return torch.arange(s, device=device) + (
        pos if isinstance(pos, int) else pos.long())


def attend_with_cache(q, k, v, *, kc, vc, pos, idx, scale: float):
    """One layer's cache write and attention over a contiguous cache (the
    reference's ``_raw_attend_with_cache``, shared by both GPT classes).
    ``q``/``k``/``v`` [B, S, H, D], the fresh views into the fused QKV
    output; ``kc``/``vc`` the layer's [B, H, max_seq, D] cache, written in
    place at ``idx`` (:func:`cache_positions`); ``pos`` the Python int 0
    or a 0-d integer tensor on the cache's device.  Returns [B, S, H, D]
    in the cache's dtype (fp32 for fp32 q over a bf16 cache's decode).

    - S == 1: the decode kernel over ``pos + 1`` positions;
    - S > 1 at a Python 0 (the port's ``_pos_is_static_zero``: a tensor
      position never syncs to decide it): the flash forward kernel,
      causal, over the fresh q/k/v;
    - S > 1 at any other position (chunked prefill): attention over the
      whole cache, each query row seeing the positions up to its own
      (the reference's XLA code, in plain torch)."""
    kc.index_copy_(2, idx, k.transpose(1, 2).to(kc.dtype))
    vc.index_copy_(2, idx, v.transpose(1, 2).to(vc.dtype))
    if q.shape[1] == 1:
        return decode_attention(q[:, 0], kc, vc, pos + 1,
                                sm_scale=scale)[:, None]
    if isinstance(pos, int) and pos == 0:
        # [B, N, S, D] views of [B, S, N, D] memory both ways
        out, _ = flash_attention_fwd(*(t.transpose(1, 2) for t in (q, k, v)),
                                     True, scale)
        return out.transpose(1, 2)
    return _masked_attention(q.transpose(1, 2), kc, vc, idx,
                             scale).transpose(1, 2)


class PagedGeometry(NamedTuple):
    """Where a paged step's tokens land, computed once per step and
    shared by every layer (:func:`paged_geometry`)."""
    tables: torch.Tensor      # [S, max_pages] as given (the kernels' table)
    tbl: torch.Tensor         # the same, int64 (the gathers' index)
    abs_pos: torch.Tensor     # [S, C] each token's absolute position
    page_ids: torch.Tensor    # [S, C, 1] each token's pool page
    offs: torch.Tensor        # [S, C, 1] its offset in the page
    heads: torch.Tensor       # [H]
    lengths: torch.Tensor     # [S] int32, pos + 1


def paged_geometry(tables, pos, c: int, page_size: int,
                   num_heads: int) -> PagedGeometry:
    """The geometry of a paged step of ``c`` tokens a row at positions
    ``pos[s] .. pos[s] + c - 1`` over ``tables`` [S, max_pages].  Each
    token's K/V lands at ``pool[page_ids, :, offs]``; padding rows carry
    the null-page table and position 0, so their writes sink into page 0,
    which no valid read ever resolves to.  The clip is defensive:
    admission reserves every page a token can touch."""
    tbl = tables.long()
    abs_pos = pos.long()[:, None] + torch.arange(c, device=tables.device)
    page_slot = torch.clamp(abs_pos // page_size, 0, tbl.shape[1] - 1)
    page_ids = torch.gather(tbl, 1, page_slot)[..., None]
    offs = (abs_pos % page_size)[..., None]
    return PagedGeometry(tables, tbl, abs_pos, page_ids, offs,
                         torch.arange(num_heads, device=tables.device),
                         (pos + 1).to(torch.int32))


def attend_paged(q, k, v, *, kp, vp, ks, vs, geo: PagedGeometry,
                 ragged_plan, scale: float):
    """One layer's paged write and attention (the reference's
    ``_attend_paged_shard``, shared by both GPT classes).  ``q``/``k``/
    ``v`` [S, C, H, D]; ``kp``/``vp`` the layer's [P, H, page_size, D]
    pool, written in place; ``ks``/``vs`` its [P, H] scales of an int8
    pool (updated in place), or None.  Returns [S, C, H, D].

    - C == 1 with a ``ragged_plan``: the serving engine's fused step
      (each row one flat token), through the ragged kernel;
    - C == 1 without one: the paged kernel over ``pos + 1``;
    - C > 1: the chunked prefill, attention over each row's gathered
      (for an int8 pool, dequantized) pages with the absolute-position
      mask (the reference's XLA code, in plain torch).

    ALL of the step's K/V rows go into the pool BEFORE attention, so a
    chunk's tokens see each other through the pool.  An int8 pool's rows
    go through ``quantize_kv_write`` (which updates the layer's scales)
    first, and the kernels read the pages with the updated scales."""
    if ks is not None:
        k, _ = quantize_kv_write(k, geo.page_ids[..., 0], geo.offs[..., 0],
                                 ks)
        v, _ = quantize_kv_write(v, geo.page_ids[..., 0], geo.offs[..., 0],
                                 vs)
    kp.index_put_((geo.page_ids, geo.heads, geo.offs), k.to(kp.dtype))
    vp.index_put_((geo.page_ids, geo.heads, geo.offs), v.to(vp.dtype))
    if q.shape[1] == 1 and ragged_plan is not None:
        return ragged_paged_attention(q[:, 0], kp, vp, geo.tables,
                                      geo.lengths, ragged_plan,
                                      sm_scale=scale, k_scale=ks,
                                      v_scale=vs)[:, None]
    if q.shape[1] == 1:
        return paged_attention(q[:, 0], kp, vp, geo.tables, geo.lengths,
                               sm_scale=scale, k_scale=ks,
                               v_scale=vs)[:, None]
    out = _masked_attention(q.transpose(1, 2), gather_pages(kp, geo.tbl, ks),
                            gather_pages(vp, geo.tbl, vs), geo.abs_pos, scale)
    return out.transpose(1, 2)


def paged_step_on(devices, tables, pos, c: int, page_size: int,
                  num_heads: int, ragged_plan) -> dict:
    """``{device: (geometry, ragged plan)}``: a paged step's
    :func:`paged_geometry` at ``num_heads`` (a head shard's) and its
    ``ragged_plan``, sent to each of ``devices`` once."""
    return {d: (paged_geometry(tables.to(d), pos.to(d), c, page_size,
                               num_heads),
                None if ragged_plan is None
                else tuple(t.to(d) for t in ragged_plan))
            for d in devices}


def placed_routes(kv_cache, ids_device, s: int, pos, page_tables,
                  ragged_plan, scale: float) -> list:
    """Each layer's attention route over a cache placed on a training mesh
    (``kv_cache.layer_shards``): :func:`attend_with_cache` over each
    shard's contiguous cache, or :func:`attend_paged` over its pages, on
    the shard's device at ``H/mp`` heads -- one callable a layer at mp =
    1, a list of one a shard above.  ``s``: the step's tokens a row;
    ``pos``: the contiguous cache's position (the Python int 0 or a 0-d
    tensor on ``ids_device``) or the paged rows' [S] positions; the
    positions, tables and plan are sent to each device once."""
    shards = [kv_cache.layer_shards(layer)
              for layer in range(kv_cache.num_layers)]
    devices = list(dict.fromkeys(sh[0].device for ls in shards for sh in ls))
    if kv_cache.paged:
        at = paged_step_on(devices, page_tables, pos, s, kv_cache.page_size,
                           shards[0][0][0].shape[1], ragged_plan)
    else:
        idx = cache_positions(s, pos, ids_device)
        at = {d: (pos if isinstance(pos, int) else pos.to(d), idx.to(d))
              for d in devices}

    def route(sh):
        d = sh[0].device
        if not kv_cache.paged:
            return partial(attend_with_cache, kc=sh[0], vc=sh[1],
                           pos=at[d][0], idx=at[d][1], scale=scale)
        return partial(attend_paged, kp=sh[0], vp=sh[1], ks=sh[2], vs=sh[3],
                       geo=at[d][0], ragged_plan=at[d][1], scale=scale)

    out = []
    for ls in shards:
        routes = [route(sh) for sh in ls]
        out.append(routes[0] if len(routes) == 1 else routes)
    return out


def _shard_pools(cache, num_layers: int):
    """Per shard of a sharded pool, its (k, v, k_scale, v_scale) tensors
    a layer."""
    out = []
    for sh in cache.shards:
        if sh.stacked:
            pools = [sh.k.unbind(0), sh.v.unbind(0)]
            pools += ([sh.k_scale.unbind(0), sh.v_scale.unbind(0)]
                      if sh.quantized else [[None] * num_layers] * 2)
        else:
            pools = [sh.k, sh.v]
            pools += ([sh.k_scale, sh.v_scale] if sh.quantized
                      else [[None] * num_layers] * 2)
        out.append(list(zip(*pools)))
    return out


def sharded_paged_layers(model, h, cache, tables, pos, ragged_plan,
                         lora=None):
    """Every decoder layer of ``model`` over a pool sharded per head over
    ``mp > 1`` devices (``cache.shards``; ``serving_mesh``).  ``h`` [S, C,
    hidden] on ``mesh[0]``; returns the last layer's output there.

    Each layer runs the reference's steps with the split explicit: the
    replicated LayerNorm (on every device of the mesh); per shard the
    column-parallel QKV product, :func:`attend_paged` over the shard's own
    pool at ``H/mp`` heads, and the row-parallel output projection into a
    partial; one reduce of the partials (``serving_mesh.reduce_sum``); the
    bias, added once, and the residual add; the same for the MLP (fc1
    column-parallel, GELU, fc2 row-parallel, reduce).  A row-parallel
    int8 product reduces its exact int32 accumulators under the whole
    row's activation scale, so it gives the unsharded product's bits.
    Each class keeps its own rounding points: the :class:`BlockOps` its
    unsharded block uses (``stacked_block_ops``, ``layered_block_ops``).

    ``lora``: ``(LoRAAdapterPool, ids)`` as for the unsharded step.  A
    column-parallel projection adds its delta through the B factor's
    columns of the shard; a row-parallel one sums the shards' first
    contractions (``u``, fp32) in the reduce and adds the delta once,
    after the bias, on every device."""
    from ..distributed.serving_mesh import reduce_max, unique_devices

    mesh = tuple(sh.device for sh in cache.shards)
    layers = getattr(model, "_serving_shards", None)
    if layers is None or getattr(model, "_serving_mesh", None) != mesh:
        raise ValueError(
            f"the pool is sharded over {list(map(str, mesh))}: shard the "
            "model for the same mesh first "
            "(serving_mesh.shard_model_for_serving)")
    cfg = model.config
    stacked, int8 = model.stacked, model.weight_int8
    mp = len(mesh)
    hs, hd, eps = cfg.num_heads // mp, cfg.head_dim, cfg.layer_norm_eps
    ops = (stacked_block_ops(eps, int8, model.decoder.ln1_g.dtype)
           if stacked else layered_block_ops(eps))
    b, c, hidden = h.shape
    scale = float(1.0 / np.sqrt(hd))
    devs = unique_devices(mesh)
    at = paged_step_on(devs, tables, pos, c, cache.page_size, hs,
                       ragged_plan)
    pools = _shard_pools(cache, cfg.num_layers)
    if lora is not None:
        lpool, lids = lora
        loras = (stacked_loras(lora, cfg.num_layers) if stacked
                 else (LayerLoRA.gather(lpool.layer_slabs(li), lids,
                                        lpool.scaling)
                       for li in range(cfg.num_layers)))
    else:
        loras = [None] * cfg.num_layers

    def col_lora(ys, x, lr, j):
        """The shards' column-parallel outputs ``ys`` of projection ``j``
        plus each one's columns of its delta of ``x`` (on ``mesh[0]``)."""
        if lr is None:
            return ys
        ds = lr.cols(ops, lora_cuts(cfg, mp, lr.device), x.view(b, c, -1),
                     j, mesh)
        return [y + d.view(b * c, -1) for y, d in zip(ys, ds)]

    def norm(x, g, beta):
        return ops.norm(x, g, beta).reshape(b * c, hidden)

    def row(layer, parts, name, lr, j):
        """The row-parallel product of the shards' inputs ``parts``, its
        reduce, its bias and its LoRA delta: ``{device: [S*C, hidden]}``."""
        out = _row(layer, parts, name)
        if lr is None:
            return out
        dl = lr.row(ops, lora_cuts(cfg, mp, lr.device),
                    [p.view(b, c, -1) for p in parts], j, mesh)
        return {d: out[d] + dl[d].view(b * c, -1) for d in devs}

    def _row(layer, parts, name):
        w = [sh[name + "_w"] for sh in layer.shards]
        act = layer.act[name]
        if int8:
            if act is None:
                xs = reduce_max([activation_scales(p) for p in parts], mesh)
            else:
                xs = {d: activation_scales(parts[0], act).to(d)
                      for d in devs}
            acc = reduce_sum([int8_accumulate(p, wi, xs[p.device])
                              for p, wi in zip(parts, w)], mesh)
            return {d: int8_epilogue(acc[d], xs[d], r[name + "_s"],
                                     r[name + "_b"])
                    for d, r in layer.rep.items()}
        tot = reduce_sum([ops.partial(p, wi) for p, wi in zip(parts, w)],
                         mesh)
        return {d: tot[d] + r[name + "_b"] for d, r in layer.rep.items()}

    def residual(hh, y):
        return ops.residual(hh, y.view(b, c, hidden))

    hh = broadcast(h, mesh)
    for li, (layer, lg) in enumerate(zip(layers, loras)):
        x = {d: norm(hh[d], r["ln1_g"], r["ln1_b"])
             for d, r in layer.rep.items()}
        qkvs = col_lora([ops.col(x[d], sh["qkv_w"], sh.get("qkv_s"),
                                 sh["qkv_b"], layer.act["qkv"])
                         for sh, d in zip(layer.shards, mesh)],
                        x[mesh[0]], lg, 0)
        outs = []
        for i, (d, qkv) in enumerate(zip(mesh, qkvs)):
            q, k, v = qkv.view(b, c, 3, hs, hd).unbind(2)
            kp, vp, ks, vs = pools[i][li]
            out = attend_paged(q, k, v, kp=kp, vp=vp, ks=ks, vs=vs,
                               geo=at[d][0], ragged_plan=at[d][1],
                               scale=scale)
            outs.append(out.to(qkv.dtype).reshape(b * c, hs * hd))
        attn = row(layer, outs, "proj", lg, 1)
        hh = {d: residual(hh[d], attn[d]) for d in devs}
        y = {d: norm(hh[d], r["ln2_g"], r["ln2_b"])
             for d, r in layer.rep.items()}
        us = [F.gelu(u, approximate="tanh") for u in col_lora(
            [ops.col(y[d], sh["fc1_w"], sh.get("fc1_s"), sh["fc1_b"],
                     layer.act["fc1"]) for sh, d in zip(layer.shards, mesh)],
            y[mesh[0]], lg, 2)]
        mlp = row(layer, us, "fc2", lg, 3)
        hh = {d: residual(hh[d], mlp[d]) for d in devs}
    return hh[mesh[0]]


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


def _span(x, dim: int, lo: int, hi: int, device):
    """Elements ``lo .. hi - 1`` of ``x`` along ``dim``: of a batch placed
    over the mesh (``mesh.PlacedTensor``) the block that lies on
    ``device``, else a slice of ``x`` where it is."""
    if isinstance(x, _mesh.PlacedTensor):
        return x.take(dim, lo, hi, device)
    return x.narrow(dim, lo, hi - lo)


def _host_generator(generator, seed: int) -> torch.Generator:
    """The CPU generator a module draws its dropout seeds from."""
    if generator is None:
        return torch.Generator().manual_seed(int(seed))
    if generator.device.type != "cpu":
        raise ValueError("the dropout seeds come from a CPU "
                         f"torch.Generator, got one on {generator.device}")
    return generator


class _CacheContract(GenerationMixin):
    """The cache contracts both GPT classes share, in the layout their
    class attribute ``stacked`` names: ``generate()``'s
    (``new_kv_cache``, ``_cached_lm_logits``) and the serving engine's
    (``new_paged_kv_cache``, ``_paged_lm_logits``)."""

    stacked: bool

    def cache_placement(self):
        """Where the caches of a model placed on a training mesh hold each
        layer: ``(layers, shard devices)`` groups (``KVCache`` and
        ``PagedKVCache``'s ``placement``), or None for an unplaced
        model."""
        return None

    def _refuse_sequence_parts(self):
        """The reference's failure at the first decode step of a model
        whose activations run as sequence parts: one token does not split
        over sp."""
        sp = getattr(getattr(self, "gpt", None), "sequence_parts", 1)
        if sp > 1:
            raise ValueError(
                f"a one-token decode step does not split over sp={sp} "
                "sequence parts: generation and serving of a "
                "sequence_parallel model on an sp axis > 1 fail, as in the "
                "reference; load its state_dict() into a model built "
                "without the sp axis to generate or serve")

    @torch.no_grad()
    def leave_training_mesh(self):
        """Take a model placed on a training mesh off it, as a serving
        mesh takes it (``serving_mesh.shard_model_for_serving``: the
        reference commits every parameter to the serving mesh): replica
        0's whole weights (:meth:`state_dict` gathers them onto the
        model's device) become the tensors of this class's unplaced
        modules, built as a skeleton on ``meta`` without the global mesh
        (nothing drawn, nothing copied), and a quantized model quantizes
        them again (the same values: the scales are per layer and
        channel).  Every part of the placement, the other replicas'
        copies included, is freed (its storage emptied: an optimizer over
        the parts holds nothing) before the skeleton is filled, so the
        peak is the placement and one gathered copy (and a temporary of
        one tensor at most).  A model under ZeRO
        (``group_sharded_parallel``, any level) first leaves its plan
        (``ZeroPlan.dissolve``: the hooks go, and piece by piece replica
        0's copy takes its whole value from the slices where ``p_g_os``
        keeps only slices, while the piece's slices and other copies are
        freed), then gives replica 0's weights the same way, at the same
        peak.  A no-op for an unplaced model.  Returns the model.

        Training the model afterwards raises (:meth:`_refuse_training`,
        naming ROADMAP.md queue 1, item 9): its optimizer holds the freed
        parts (and, under ZeRO, the freed slices)."""
        if self._train_mesh is None:
            return self
        int8 = self.weight_int8
        fresh = self._unplaced_twin(free=True)
        for name, child in list(fresh.named_children()):
            setattr(self, name, child)
        self._train_mesh = None
        self.__dict__.pop("placed_head_int8", None)
        self._left_training_mesh = True
        if int8:
            self.quantize_weights()
        return self.train(self.training)

    @torch.no_grad()
    def _unplaced_twin(self, free: bool = False):
        """An unplaced model of this class holding replica 0's whole fp
        weights (:meth:`state_dict`, gathered onto the model's device),
        built as a skeleton on ``meta`` without the global mesh (nothing
        drawn, nothing copied) and filled by assignment.  With ``free``
        the ZeRO plan, if any, is dissolved first, and every part and copy
        of this model is freed before the skeleton is filled
        (:meth:`leave_training_mesh`); without it the weights are copies
        and this model is untouched."""
        plan = getattr(self, "_zero_plan", None) if free else None
        if plan is not None:
            plan.dissolve()
        state = {k: v.to(self.device) for k, v in self.state_dict().items()}
        if free:
            for p in self.parameters():
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        else:
            state = {k: v.clone() for k, v in state.items()}
        saved = _mesh.get_mesh() if _mesh.has_mesh() else None
        _mesh.set_mesh(None)
        try:
            kw = {"n_micro": self.n_micro} if self.stacked else {}
            fresh = type(self)(self.config, device="meta", dtype=self.dtype,
                               generator=self.generator, **kw)
        finally:
            _mesh.set_mesh(saved)
        fresh.load_state_dict(state, assign=True)
        return fresh

    def _refuse_training(self):
        """Refuse a forward without a cache that builds a graph on a model
        :meth:`leave_training_mesh` took off its mesh: an optimizer over
        its parts would silently step nothing."""
        if getattr(self, "_left_training_mesh", False) \
                and torch.is_grad_enabled():
            raise NotImplementedError(
                "training a model that a serving mesh took off its training "
                "mesh is not ported (ROADMAP.md queue 1, item 9): its "
                "optimizer holds the freed parts of the placement; build "
                "the placed model again and load this model's state_dict(), "
                "or run the forward under torch.no_grad()")

    def _require_whole_weights(self, what: str):
        """Refuse ``what`` on a model sharded for serving at mp > 1, whose
        tensor-parallel weights live only in its shards."""
        if getattr(self, "_serving_released", False):
            raise ValueError(
                f"{what} needs the whole weights: this model's tensor-"
                "parallel weights live in its serving shards over "
                f"{list(map(str, self._serving_mesh))}; "
                "serving_mesh.unshard_model(model) gathers them back")

    # -- GenerationMixin cache contract ------------------------------------
    def new_kv_cache(self, batch_size: int, max_seq: int,
                     dtype="bfloat16") -> KVCache:
        self._refuse_sequence_parts()
        cfg = self.config
        return KVCache(cfg.num_layers, batch_size, cfg.num_heads, max_seq,
                       cfg.head_dim, dtype=dtype, stacked=self.stacked,
                       device=self.device, placement=self.cache_placement())

    # the cached steps call the module, not forward(): ZeRO at p_g_os
    # gathers a model's parts around its calls
    def _cached_lm_logits(self, input_ids, kv_cache, cache_index):
        return self(input_ids, kv_cache=kv_cache, cache_index=cache_index)

    # -- ServingEngine paged-cache contract --------------------------------
    def new_paged_kv_cache(self, num_pages: int, page_size: int,
                           dtype="bfloat16", mesh=None):
        """A zeroed page pool in this class's layout on the model's device,
        or, with a replica ``mesh`` of mp > 1 devices, sharded per head
        over it (``serving_mesh``); for a model placed on a training mesh,
        placed as its layers are (:meth:`cache_placement`)."""
        from ..serving.paged_cache import PagedKVCache

        self._refuse_sequence_parts()
        cfg = self.config
        return PagedKVCache(cfg.num_layers, num_pages, cfg.num_heads,
                            page_size, cfg.head_dim, dtype=dtype,
                            stacked=self.stacked, device=self.device,
                            mesh=mesh, placement=self.cache_placement())

    def _paged_lm_logits(self, input_ids, paged_cache, page_tables,
                         positions, ragged_plan=None, out_rows=None,
                         lora=None):
        return self(input_ids, kv_cache=paged_cache, cache_index=positions,
                    page_tables=page_tables, ragged_plan=ragged_plan,
                    out_rows=out_rows, lora=lora)


class GPTStackedForPretraining(nn.Module, _CacheContract):
    """Embeddings + stacked decoder + tied LM head, for training, serving
    and ``generate()``.

    ``device=None`` means ``"cuda"`` and raises when no CUDA device is
    present; pass ``device="cpu"`` to run on the CPU.  Weights are drawn
    N(0, initializer_range) from ``torch.Generator(seed)`` on the model's
    device (LayerNorm gains 1, biases 0, as the JAX model initialises).
    Dropout seeds come from ``generator``, a CPU ``torch.Generator``
    (``None``: a CPU generator seeded with ``seed``).

    ``(cfg, n_micro=1)`` is the reference's order; the port's own
    arguments are keyword-only.

    Under a global mesh (``distributed.mesh.set_mesh``) with dp, sharding,
    pp or mp above 1 the model is placed for training (:class:`TrainMesh`;
    the replicas over dp x sharding), as the
    reference's ``_shard_params`` places it: every logical weight is a
    ``ShardedParameter`` whose parts live on their mesh positions' devices
    (the decoder's as :class:`GPTStackedDecoder` cuts them; the word
    embeddings whole on each replica's stage 0, or cut by vocabulary rows
    over mp under ``use_tensor_parallel``; the position embeddings on
    stage 0, the final LayerNorm on the last stage), made from the same
    draws as the unplaced model of the same seed.  ``device`` is then
    the mesh's first device.  ``parameters()`` yields the parts;
    ``state_dict()`` and ``load_jax_state`` speak whole tensors under the
    reference's names.  The training forward splits the batch over the dp
    replicas and pipelines ``n_micro`` microbatches over pp stages
    (:meth:`GPTStackedDecoder.forward_mesh`).  ``generate()`` and serving
    run from replica 0's parts (:meth:`_forward_placed_cached`): each
    layer on its stage's devices, per head shard at mp > 1, over caches
    placed the same way (:meth:`cache_placement`), with per-request LoRA
    and speculative drafts (``truncated_draft`` builds a placed draft); at
    mp = 1 ``quantize_weights`` quantizes each stage's slabs on its
    device.  A serving mesh (``ServingEngine(mesh=)``,
    ``ShardedServingEngine``) takes it off its training mesh
    (:meth:`leave_training_mesh`), under ZeRO too.  Under ZeRO at
    ``p_g_os`` (``distributed.sharding``) every call gathers every part
    before it runs and frees them after (``_zero_unit``).
    """

    stacked = True        # the cache and LoRA layout this class reads
    _zero_unit = True     # ZeRO p_g_os gathers the whole tree around a call

    def __init__(self, cfg: GPTConfig, n_micro: int = 1, *, device=None,
                 dtype="float32", seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if int(n_micro) < 1:
            raise ValueError(f"n_micro={n_micro} must be >= 1")
        self.config = cfg
        self.n_micro = int(n_micro)
        tm = self._train_mesh = train_mesh(cfg)
        if tm is not None:
            root, asked = tm.dev(0, 0), torch.device(device or tm.dev(0, 0))
            if asked.type != root.type or asked.index not in (None,
                                                              root.index):
                raise ValueError(f"device={device}: a model placed on a mesh "
                                 f"lives on the mesh's devices, first "
                                 f"{root}")
            device = tm.dev(0, 0)
        self.device = resolve_device(device)
        self.dtype = to_torch_dtype(dtype)
        self.generator = _host_generator(generator, seed)
        factory = dict(device=self.device, dtype=self.dtype)
        if tm is None:
            self.embeddings = GPTEmbeddings(cfg, **factory)
            self.final_ln = nn.LayerNorm(cfg.hidden_size,
                                         eps=cfg.layer_norm_eps, **factory)
        else:
            self._place_outer(tm)
        self.decoder = GPTStackedDecoder(cfg, **factory)
        self._init_weights(seed)

    def _place_outer(self, tm: TrainMesh):
        """The embeddings and the final LayerNorm on a mesh, under the
        unplaced model's module names."""
        cfg, dt = self.config, self.dtype
        V, h = cfg.vocab_size, cfg.hidden_size
        last = tm.pp - 1
        if tm.vocab_parallel:
            n = V // tm.mp
            word = [Part((r, 0, i), tm.dev(r, 0, i),
                         ((0, torch.arange(i * n, (i + 1) * n)),))
                    for r in range(tm.dp) for i in range(tm.mp)]
        else:
            word = [Part((r, 0, 0), tm.dev(r, 0), ()) for r in range(tm.dp)]
        first = [Part((r, 0, 0), tm.dev(r, 0), ()) for r in range(tm.dp)]
        final = [Part((r, last, 0), tm.dev(r, last), ())
                 for r in range(tm.dp)]
        self.embeddings = nn.Module()
        self.embeddings.word_embeddings = nn.Module()
        self.embeddings.word_embeddings.weight = ShardedParameter(
            (V, h), dt, word)
        self.embeddings.position_embeddings = nn.Module()
        self.embeddings.position_embeddings.weight = ShardedParameter(
            (cfg.max_position_embeddings, h), dt, first)
        self.final_ln = nn.Module()
        self.final_ln.weight = ShardedParameter((h,), dt, final)
        self.final_ln.bias = ShardedParameter((h,), dt, final)

    @torch.no_grad()
    def _init_weights(self, seed: int):
        if self.device.type == "meta":
            return                  # a skeleton: its tensors are assigned
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        std = self.config.initializer_range
        if self._train_mesh is None:
            items = self.named_parameters()
        else:
            # each whole tensor drawn on the first device, then cut
            items = sharded_parameters(self).items()
        for name, p in items:
            short = name.rsplit(".", 1)[-1]
            placed = isinstance(p, ShardedParameter)
            shape = p.whole_shape if placed else p.shape
            if short in ("ln1_g", "ln2_g") or name == "final_ln.weight":
                t = torch.ones(shape, device=self.device)
            elif short.endswith("_b") or name == "final_ln.bias":
                t = torch.zeros(shape, device=self.device)
            else:
                t = torch.randn(shape, generator=gen, device=self.device) * std
            if placed:
                p.load_whole(t.to(self.dtype))
            else:
                p.copy_(t)

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
        Idempotent.  A config with ``use_tensor_parallel``, or a mesh with
        mp > 1, raises the reference's ``ValueError``.  A model placed on
        a training mesh at mp = 1 quantizes each stage's slabs
        (:meth:`GPTStackedDecoder.quantize_weights`) and the head on its
        last stage (:attr:`placed_head_int8`); its state dict stays the fp
        weights it trains."""
        if self.weight_int8:
            return
        refuse_tensor_parallel(self)
        self._require_whole_weights("quantize_weights")
        tm = self._train_mesh
        if tm is None:
            self.decoder.quantize_weights()
            q, s = quantize_weight(self.embeddings.word_embeddings.weight, 1)
            self.register_buffer("lm_head_int8", q.t())    # k_major already
            self.register_buffer("lm_head_scale", s)
            return
        plan = getattr(self, "_zero_plan", None)
        with plan.reading() if plan is not None else nullcontext():
            self.decoder.quantize_weights()
            q, s = quantize_weight(
                self.embeddings.word_embeddings.weight.at((0, 0, 0)), 1)
        last = tm.dev(0, tm.pp - 1)
        self.placed_head_int8 = (q.t().to(last), s.to(last))

    def load_jax_state(self, state: Mapping[str, np.ndarray]):
        """Carry the JAX model's weights across: ``state`` maps every key
        of ``paddle_tpu``'s ``GPTStackedForPretraining.state_dict()``
        (``embeddings.word_embeddings.weight``, ``decoder.qkv_w``, ...,
        ``final_ln.bias``) to a numpy array of the same shape.  A quantized
        JAX model's int8 buffers (``decoder.qkv_w_int8``, ...,
        ``lm_head_scale``), when present, are carried across unchanged and
        mark this model quantized.  Missing, unknown or mis-shaped keys
        raise.  A model placed on a mesh cuts each array onto its parts
        (a quantized JAX model's buffers are refused there)."""
        if self._train_mesh is not None:
            return self._load_placed(state)
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

        ``lora`` (paged cache only): ``(LoRAAdapterPool, ids)``, ``ids``
        [S] int the adapter page of each row (0 = the null adapter); every
        projection of every layer adds its row's low-rank delta."""
        if kv_cache is None:
            if lora is not None:
                raise ValueError("per-request LoRA adapters ride the paged "
                                 "serving step (kv_cache + page_tables)")
            self._refuse_training()
            if self._train_mesh is not None:
                return self._forward_placed(input_ids, labels, position_ids)
            self._require_whole_weights("a forward without a sharded pool")
            return self._forward_train(input_ids, labels, position_ids)
        ids, pos, pos_ids = self._cached_positions(
            input_ids, position_ids, kv_cache, cache_index, page_tables)
        if self._train_mesh is not None:
            return self._forward_placed_cached(ids, pos, pos_ids, kv_cache,
                                               page_tables, ragged_plan,
                                               out_rows, lora)
        if lora is not None and not kv_cache.paged:
            raise ValueError("per-request LoRA adapters ride the paged "
                             "serving step (kv_cache + page_tables)")
        if getattr(kv_cache, "shards", None) is None:
            self._require_whole_weights("a forward without a sharded pool")
        h = self.embeddings(ids, pos_ids)          # [B or S, S or C, hidden]
        if not kv_cache.paged:
            h = self.decoder.forward_cached(h, kv_cache.k, kv_cache.v, pos)
        else:
            if getattr(kv_cache, "shards", None) is not None:
                # a pool sharded per head over mp devices
                h = sharded_paged_layers(self, h, kv_cache, page_tables,
                                         pos, ragged_plan, lora)
            else:
                # a pool without scales is a float pool
                h = self.decoder.forward_paged(
                    h, kv_cache.k, kv_cache.v, page_tables, pos,
                    ragged_plan, getattr(kv_cache, "k_scale", None),
                    getattr(kv_cache, "v_scale", None), lora=lora)
            if out_rows is not None:
                # gather each slot's output row BEFORE the vocab
                # projection: the LM head projects [S'] rows, not the
                # padded token axis
                h = h[out_rows.long()]
        h = self.final_ln(h)
        if self.weight_int8:
            # the tied head as one int8 product (fp32 logits)
            return quantized_matmul(h, self.lm_head_int8, self.lm_head_scale)
        h, w = maybe_cast("matmul", h, self.embeddings.word_embeddings.weight)
        return h @ w.t()

    def _cached_positions(self, input_ids, position_ids, kv_cache,
                          cache_index, page_tables):
        """``(ids, pos, pos_ids)`` of a cached step (:meth:`forward`'s
        arguments): the contiguous cache's position (the Python int 0 or
        a 0-d tensor) or the paged rows' [S] positions, and the position
        embeddings' ids; a paged step's ``position_ids`` must agree."""
        ids = input_ids.long()
        rel = torch.arange(ids.shape[1], device=ids.device)
        if not kv_cache.paged:
            pos = int(cache_index) if isinstance(
                cache_index, (int, np.integer)) else cache_index.reshape(())
            pos_ids = (rel + pos).expand_as(ids) if position_ids is None \
                else position_ids.long().expand_as(ids)
            return ids, pos, pos_ids
        if page_tables is None:
            raise ValueError("a paged KV cache needs page_tables")
        pos = cache_index.long()
        if position_ids is not None and not torch.equal(
                position_ids.long().expand_as(ids), pos[:, None] + rel):
            raise ValueError(
                "position_ids disagree with cache_index: the paged and "
                "ragged paths place each token at cache_index[s] + "
                "arange(C), and read positions from there")
        return ids, pos, torch.clamp(pos[:, None] + rel, 0,
                                     self.config.max_position_embeddings - 1)

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
            h = dropout(h, cfg.hidden_dropout,
                        generator=_seeded(seeds.pop(0), h.device))
        h = self.final_ln(self.decoder(h, seeds))
        w = self.embeddings.word_embeddings.weight
        if labels is not None:
            # the reference passes the amp dtype whenever auto_cast is on
            st = amp_state()
            return fused_linear_cross_entropy(
                h, w, labels, compute_dtype=st.dtype if st.enabled else None)
        h, w = maybe_cast("matmul", h, w)
        return h @ w.t()

    # -- placed on a training mesh ------------------------------------------
    def cache_placement(self):
        """Each pipeline stage's layers and the devices of replica 0's
        shards of that stage; None unplaced."""
        tm = self._train_mesh
        if tm is None:
            return None
        return [(tm.layers[s], tuple(tm.grid[0, s])) for s in range(tm.pp)]

    def _held_parts(self):
        """``{state-dict key: {mesh position: part}}``: replica 0's parts,
        untied (the cached paths run no backward)."""
        return {key: {p.position: t for t, p in zip(sp, sp.parts)
                      if p.replica == 0}
                for key, sp in sharded_parameters(self).items()}

    def _forward_placed_cached(self, ids, pos, pos_ids, kv_cache,
                               page_tables, ragged_plan, out_rows, lora):
        """The cached forward on the mesh (contiguous or paged, at the
        positions :meth:`_cached_positions` gives): replica 0's embeddings
        on its stage 0, the layers in order on their stages' devices
        (:meth:`GPTStackedDecoder.forward_placed`) over ``kv_cache``
        placed as :meth:`cache_placement` places it, the final LayerNorm
        and the tied head on the last stage (the head over the vocabulary
        shards under ``use_tensor_parallel``, the int8 head after
        ``quantize_weights``).  ``lora``: each layer's delta on its
        stage's devices (:meth:`GPTStackedDecoder.forward_placed`).  The
        other replicas hold the same weights and do not run.  Returns the
        logits on ``self.device``."""
        if lora is not None and not kv_cache.paged:
            raise ValueError("per-request LoRA adapters ride the paged "
                             "serving step (kv_cache + page_tables)")
        if getattr(kv_cache, "groups", None) is None:
            raise ValueError("a model placed on a training mesh reads a cache "
                             "placed as its layers are: make it with "
                             "new_kv_cache or new_paged_kv_cache")
        cfg, tm = self.config, self._train_mesh
        routes = placed_routes(kv_cache, ids.device, ids.shape[1], pos,
                               page_tables, ragged_plan,
                               float(1.0 / np.sqrt(cfg.head_dim)))
        held = self._held_parts()
        h = self._embed_placed(held, 0, ids, pos_ids)
        h = self.decoder.forward_placed(h, held, routes, lora)
        if out_rows is not None:
            h = h[out_rows.to(h.device).long()]
        last = (0, tm.pp - 1, 0)
        h = F.layer_norm(h, (cfg.hidden_size,), held["final_ln.weight"][last],
                         held["final_ln.bias"][last], cfg.layer_norm_eps)
        if self.weight_int8:
            return quantized_matmul(h, *self.placed_head_int8).to(
                self.device)
        return self._head_placed(held, 0, h, None).to(self.device)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """``nn.Module.load_state_dict``; a model placed on a mesh cuts
        each whole tensor into its parts (``shards.load_state``)."""
        if self._train_mesh is None:
            return super().load_state_dict(state_dict, strict, assign)
        return nn.modules.module._IncompatibleKeys(
            *load_state(self, state_dict, strict))

    @torch.no_grad()
    def _load_placed(self, state: Mapping[str, np.ndarray]):
        owned = sharded_parameters(self)
        missing = sorted(set(owned) - set(state))
        unknown = sorted(set(state) - set(owned))
        if missing or unknown:
            raise KeyError(f"load_jax_state: missing {missing}, unknown "
                           f"{unknown} (a placed model takes fp weights)")
        arrays = {}
        for name, sp in owned.items():
            a = np.array(state[name], np.float32)
            if tuple(a.shape) != sp.whole_shape:
                raise ValueError(f"load_jax_state: {name} has shape "
                                 f"{a.shape}, expected {sp.whole_shape}")
            arrays[name] = torch.from_numpy(a)
        load_state(self, arrays)

    def _tied_parts(self):
        """``{state-dict key: {mesh position: tensor}}``: every part, with
        the dp replicas of each part tied (:func:`tie_replicas`: their
        gradients are summed in replica order, and each applies the
        sum)."""
        out = {}
        for key, sp in sharded_parameters(self).items():
            groups = {}
            for t, p in zip(sp, sp.parts):
                groups.setdefault(p.position[1:], []).append((p.position, t))
            out[key] = {}
            for copies in groups.values():
                tied = tie_replicas([t for _, t in copies])
                out[key].update((pos, t) for (pos, _), t in zip(copies, tied))
        return out

    def _embed_placed(self, tied, r: int, ids, pos):
        """Replica ``r``'s embeddings on its stage 0's first device.  Over
        vocabulary shards (the reference's ``VocabParallelEmbedding``)
        each shard looks up the ids in its rows, zeros the others, and the
        parts are summed."""
        tm = self._train_mesh
        root = tm.dev(r, 0)
        word = tied["embeddings.word_embeddings.weight"]
        if tm.vocab_parallel:
            h = vocab_parallel_lookup(
                ids, [word[(r, 0, i)] for i in range(tm.mp)], root)
        else:
            h = F.embedding(ids.to(root), word[(r, 0, 0)])
        pe = tied["embeddings.position_embeddings.weight"][(r, 0, 0)]
        return h + F.embedding(pos.to(root), pe)

    def _head_placed(self, tied, r: int, h, labels):
        """Replica ``r``'s tied head on its last stage: the mean token loss
        of its rows with ``labels``, else its logits.  Over vocabulary
        shards the loss is ``vocab_parallel_cross_entropy`` (a global max
        and sum of exponentials over the shards' logits, token chunks as
        the unsharded head takes them) and the logits are the shards'
        side by side.  The table is read from stage 0's parts: its
        gradient from both uses meets there."""
        tm = self._train_mesh
        last = tm.pp - 1
        word = tied["embeddings.word_embeddings.weight"]
        devs = [tm.dev(r, last, i) for i in range(tm.mp if tm.vocab_parallel
                                                  else 1)]
        ws = [word[(r, 0, i)].to(d) for i, d in enumerate(devs)]
        if labels is not None:
            st = amp_state()
            cdt = st.dtype if st.enabled else None
            if tm.vocab_parallel:
                return NF.vocab_parallel_cross_entropy(
                    h, ws, labels, devices=devs, compute_dtype=cdt)
            return fused_linear_cross_entropy(h, ws[0], labels,
                                              compute_dtype=cdt)
        xs = broadcast(h, devs)
        logits = []
        for d, w in zip(devs, ws):
            x, w = maybe_cast("matmul", xs[d], w)
            logits.append((x @ w.t()).to(h.device))
        return torch.cat(logits, -1)

    def _forward_placed(self, input_ids, labels, position_ids=None):
        """The training forward on the mesh: the batch's rows split
        evenly over the dp replicas; each replica's embeddings, decoder
        (:meth:`GPTStackedDecoder.forward_mesh`), final LayerNorm and
        head on its own parts.  With ``labels`` returns the whole batch's
        mean token loss (the replicas' means, summed in replica order over
        dp) on ``self.device``; without, the [B, S, V] logits there.
        Dropout draws the unplaced model's seeds; each replica and
        microbatch of a layer derives its own from the layer's
        (:func:`_part_seed`), unless there is one part.

        ``input_ids`` and ``labels`` may be batches placed over the mesh
        (``mesh.PlacedTensor``, ``io.DevicePrefetcher(sharding=("dp",))``
        or ``(("dp", "sharding"),)``): each replica reads its rows from the
        block on its stage 0's device (the labels from its last stage's),
        with no further copy."""
        cfg, tm = self.config, self._train_mesh
        n_rows, seq = input_ids.shape
        pos = (torch.arange(seq, device=self.device)
               if position_ids is None else position_ids.long())
        pos = pos.expand(n_rows, seq)
        if n_rows % tm.dp:
            raise ValueError(f"a batch of {n_rows} rows does not split "
                             f"over dp={tm.dp} replicas")
        b = n_rows // tm.dp
        micro = self.n_micro if tm.pp > 1 else 1
        parts = tm.dp * micro
        seeds = None
        if self.decoder.dropout_active():
            seeds = _dropout_seeds(self.generator, cfg.num_layers + 1)
        tied = self._tied_parts()
        dec = {n: tied["decoder." + n] for n in GPTStackedDecoder.PARAM_NAMES}
        cdt = o1_dtype()
        outs = []
        for r in range(tm.dp):
            rows = slice(r * b, (r + 1) * b)
            ids = _span(input_ids, 0, r * b, (r + 1) * b, tm.dev(r, 0))
            h = self._embed_placed(tied, r, ids.long(), pos[rows])
            layer_seeds = None
            if seeds is not None:
                emb = seeds[0] if tm.dp == 1 else _part_seed(seeds[0], r)
                h = dropout(h, cfg.hidden_dropout,
                            generator=_seeded(emb, h.device))

                def layer_seeds(layer, mb, r=r):
                    seed = seeds[layer + 1]
                    return seed if parts == 1 else _part_seed(
                        seed, r * micro + mb)
            h = self.decoder.forward_mesh(h, dec, r, layer_seeds, cdt,
                                          micro)
            fin = (tied["final_ln.weight"][(r, tm.pp - 1, 0)],
                   tied["final_ln.bias"][(r, tm.pp - 1, 0)])
            h = F.layer_norm(h, (cfg.hidden_size,), *fin, cfg.layer_norm_eps)
            outs.append(self._head_placed(
                tied, r, h, None if labels is None else _span(
                    labels, 0, r * b, (r + 1) * b, tm.dev(r, tm.pp - 1))))
        if labels is None:
            return torch.cat([o.to(self.device) for o in outs])
        loss = reduce_sum(outs, (self.device,))[self.device]
        return loss if tm.dp == 1 else loss / tm.dp


def _head_mask(mask, i: int, n: int, device):
    """The attention mask of head group ``i`` of ``n`` heads (a mask of one
    head, or none, serves every group), on ``device``."""
    if mask is None:
        return None
    if mask.dim() == 4 and mask.shape[1] > 1:
        mask = mask[:, i * n:(i + 1) * n]
    return mask.to(device)


def _shard_generator(generator, i: int, device):
    """Tensor-parallel shard ``i``'s dropout generator, seeded from
    ``generator``'s seed and the shard (None without one)."""
    return None if generator is None else _seeded(
        _part_seed(generator.initial_seed(), i), device)


class GPTAttention(nn.Module):
    """Causal multi-head self-attention of the layered GPT (the
    reference's ``GPTAttention``): the fused QKV ``Linear(h, 3h)``, its
    output split as ``[B, S, 3, heads, head_dim]``, the attention route,
    the output projection and the hidden dropout.  Without ``attend`` (no
    cache) the route is ``scaled_dot_product_attention`` (the flash
    kernels where the JAX flash gate takes the shape, the plain expression
    elsewhere); with it, ``attend(q, k, v)`` (:func:`attend_with_cache` or
    :func:`attend_paged` bound to the layer's cache).  ``lora``: the
    layer's :class:`LayerLoRA`: qkv and out each add their low-rank delta
    on the same input as the base product.

    Under tensor parallelism (:func:`layered_tp`) QKV is a
    ``ColumnParallelLinear`` cut by heads (shard ``i`` holds the q, k and
    v columns of its ``heads/mp`` heads, ``serving_mesh.qkv_columns``)
    and the output projection a ``RowParallelLinear``: each shard attends
    over its heads on its device, and the output projection sums the
    shards' partials.  With a cache ``attend`` is a list of one route a
    shard (:func:`placed_routes`), each over its heads' cache, and with
    ``lora`` each QKV shard adds its columns of the delta, the output
    projection the delta of the shards' summed first contractions.
    Attention dropout draws each shard's masks
    from a generator of its own, seeded from ``generator``'s seed and the
    shard."""

    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        self._cfg = cfg
        h = cfg.hidden_size
        devs, factory = layered_tp(cfg, factory)
        self._tp = devs is not None
        if self._tp:
            dtype = factory.get("dtype")
            self.qkv_proj = ColumnParallelLinear(
                h, 3 * h, gather_output=False, dtype=dtype,
                columns=lambda i, mp: qkv_columns(cfg.num_heads,
                                                  cfg.head_dim, mp, i))
            self.out_proj = RowParallelLinear(h, h, input_is_parallel=True,
                                              dtype=dtype)
        else:
            self.qkv_proj = Linear(h, 3 * h, **factory)
            self.out_proj = Linear(h, h, **factory)
        self.dropout = Dropout(cfg.hidden_dropout)

    def forward(self, x, attn_mask=None, attend=None, lora=None,
                generator=None):
        if self._tp:
            return self._forward_tp(x, attn_mask, attend, lora, generator)
        cfg = self._cfg
        b, s = x.shape[0], x.shape[1]
        nh, hd = cfg.num_heads, cfg.head_dim
        qkv = self.qkv_proj(x)                               # [B, S, 3H]
        if lora is not None:
            qkv = qkv + _whole_lora(lora, cfg, x, 0)
        q, k, v = qkv.view(b, s, 3, nh, hd).unbind(2)        # [B, S, nh, hd]
        if attend is not None:
            if attn_mask is not None:
                raise ValueError(
                    "attn_mask is not supported on the KV-cache path (it "
                    "is causal+length-masked); left-padded batches would "
                    "write pad positions into the cache -- right-pad or "
                    "serve per-sequence")
            out = attend(q, k, v).to(q.dtype)
        else:
            out = NF.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask,
                dropout_p=cfg.attention_dropout, is_causal=attn_mask is None,
                training=self.training, use_flash=cfg.use_flash_attention,
                generator=generator)
        out = out.reshape(b, s, nh * hd)
        proj = self.out_proj(out)
        if lora is not None:
            proj = proj + _whole_lora(lora, cfg, out, 1)
        return self.dropout(proj, generator)

    def _forward_tp(self, x, attn_mask, attend, lora, generator):
        if attend is not None and attn_mask is not None:
            raise ValueError("attn_mask is not supported on the KV-cache "
                             "path (it is causal+length-masked)")
        cfg = self._cfg
        b, s = x.shape[0], x.shape[1]
        hd = cfg.head_dim

        def heads(qkv, i):
            q, k, v = qkv.view(b, s, 3, -1, hd).unbind(2)
            n = q.shape[2]
            if attend is not None:
                out = attend[i](q, k, v).to(q.dtype)
            else:
                out = self._sdpa(q, k, v,
                                 _head_mask(attn_mask, i, n, q.device),
                                 _shard_generator(generator, i, q.device))
            return out.reshape(b, s, n * hd)

        qkv = self.qkv_proj(x)
        if lora is not None:
            qkv = _col_lora(lora, cfg, x, qkv, 0)
        out = qkv.map(heads)
        proj = self.out_proj(out)
        if lora is not None:
            proj = _row_lora(lora, cfg, out, proj, 1)
        return self.dropout(proj, generator)

    def _sdpa(self, q, k, v, mask, generator):
        cfg = self._cfg
        return NF.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=cfg.attention_dropout,
            is_causal=mask is None, training=self.training,
            use_flash=cfg.use_flash_attention, generator=generator)

    def forward_parts(self, xs, attn_mask=None, generators=None,
                      copies=None):
        """The training forward over sequence parts (:func:`layered_sp`):
        ``xs`` the sp parts ``[B, S/sp, H]`` in sequence order, part ``r``
        on ``copies[r]`` (this module, or its copy on the part's sp
        position; default this module for every part); returns each
        part's output projection after the hidden dropout (part ``r``'s
        drawn from ``generators[r]``).  The projections run per part;
        attention runs per head group (all heads, or each tensor-parallel
        shard's) over the parts' q, k and v, as the reference's layered
        block attends: by ring attention
        (:class:`~paddle_tpu_torch.nn.functional.ring_attention.
        RingAttention`) without a mask and without attention dropout,
        else over q, k and v gathered along the sequence on part 0's
        device, on the route :meth:`forward` takes, the output cut back
        into the parts."""
        gens = list(generators or [None] * len(xs))
        copies = list(copies or [self] * len(xs))
        qkv = [c.qkv_proj(x) for c, x in zip(copies, xs)]
        if self._tp:
            mp = len(qkv[0].parts)
            by_shard = [self._attend_parts([t.parts[i] for t in qkv],
                                           attn_mask, gens[0], i)
                        for i in range(mp)]
            outs = [ShardedTensor([by_shard[i][r] for i in range(mp)])
                    for r in range(len(xs))]
        else:
            outs = self._attend_parts(qkv, attn_mask, gens[0], None)
        return [c.dropout(c.out_proj(o), g)
                for c, o, g in zip(copies, outs, gens)]

    def _attend_parts(self, qkv, attn_mask, generator, shard):
        """One head group's attention over the parts' fused QKV outputs
        ``[B, S/sp, 3 n hd]`` (``shard``: its tensor-parallel shard, None
        for all heads): the parts' ``[B, S/sp, n hd]`` outputs."""
        cfg = self._cfg
        b, n, hd = qkv[0].shape[0], qkv[0].shape[1], cfg.head_dim
        split = [t.view(b, n, 3, -1, hd).unbind(2) for t in qkv]
        heads = split[0][0].shape[2]
        if attn_mask is None and cfg.attention_dropout == 0.0:
            outs = RingAttention.apply(
                True, *(p[j] for j in range(3) for p in split))[:len(qkv)]
        else:
            dev = qkv[0].device
            q, k, v = (torch.cat([p[j].to(dev) for p in split], 1)
                       for j in range(3))
            i = 0 if shard is None else shard
            gen = generator if shard is None else _shard_generator(
                generator, shard, dev)
            out = self._sdpa(q, k, v, _head_mask(attn_mask, i, heads, dev),
                             gen)
            outs = [o.to(t.device) for o, t in zip(out.split(n, 1), qkv)]
        return [o.reshape(b, n, heads * hd) for o in outs]


def _whole_lora(lora: LayerLoRA, cfg: GPTConfig, x, j: int):
    """The layered block's projection ``j``'s delta of ``x``, in its
    dtype."""
    return lora.whole(layered_block_ops(cfg.layer_norm_eps), x, j)


def _col_lora(lora: LayerLoRA, cfg: GPTConfig, x, y: ShardedTensor,
              j: int) -> ShardedTensor:
    """The column-parallel output ``y`` of the layered block's projection
    ``j`` with each shard's columns of its delta of the whole input
    ``x``."""
    ops = layered_block_ops(cfg.layer_norm_eps)
    ds = lora.cols(ops, lora_cuts(cfg, len(y.parts), lora.device), x, j,
                   y.devices)
    return y.map(lambda t, i: t + ds[i])


def _row_lora(lora: LayerLoRA, cfg: GPTConfig, parts: ShardedTensor, y,
              j: int):
    """The row-parallel output ``y`` (on its first shard's device) of the
    layered block's projection ``j`` plus its delta from the shards'
    inputs ``parts``."""
    ops = layered_block_ops(cfg.layer_norm_eps)
    return y + lora.row(ops, lora_cuts(cfg, len(parts.parts), lora.device),
                        parts.parts, j, (y.device,))[y.device]


class GPTMLP(nn.Module):
    """``fc2(gelu_tanh(fc1(x)))`` and the hidden dropout, with the LoRA
    deltas of fc1 and fc2 when ``lora`` (the layer's :class:`LayerLoRA`)
    is given.  Under
    tensor parallelism (:func:`layered_tp`) fc1 is a
    ``ColumnParallelLinear`` and fc2 a ``RowParallelLinear``, the gelu
    per shard."""

    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        self._cfg = cfg
        h, f = cfg.hidden_size, cfg.ffn_size
        devs, factory = layered_tp(cfg, factory)
        if devs is not None:
            dtype = factory.get("dtype")
            self.fc1 = ColumnParallelLinear(h, f, gather_output=False,
                                            dtype=dtype)
            self.fc2 = RowParallelLinear(f, h, input_is_parallel=True,
                                         dtype=dtype)
        else:
            self.fc1 = Linear(h, f, **factory)
            self.fc2 = Linear(f, h, **factory)
        self.dropout = Dropout(cfg.hidden_dropout)

    def forward(self, x, lora=None, generator=None):
        u = self.fc1(x)
        if isinstance(u, ShardedTensor):
            if lora is not None:
                u = _col_lora(lora, self._cfg, x, u, 2)
            g = u.map(lambda t, i: NF.gelu(t, approximate=True))
            y = self.fc2(g)
            if lora is not None:
                y = _row_lora(lora, self._cfg, g, y, 3)
            return self.dropout(y, generator)
        if lora is not None:
            u = u + _whole_lora(lora, self._cfg, x, 2)
        g = NF.gelu(u, approximate=True)
        y = self.fc2(g)
        if lora is not None:
            y = y + _whole_lora(lora, self._cfg, g, 3)
        return self.dropout(y, generator)


class GPTDecoderLayer(nn.Module):
    """Pre-LN decoder block: ``x + attn(ln1(x))``, then ``x +
    mlp(ln2(x))``.  The LayerNorms are the port's ``LayerNorm`` in the
    input's dtype (the reference's layered ``layer_norm``), not the
    stacked block's fp32 ``_ln_f32``; under tensor parallelism they stay
    whole on the first shard's device, where the residual stream lives.
    ``seed``: the layer's dropout seed when dropout is active; its masks
    are drawn, in order (attention probabilities, attention projection,
    MLP output), from a generator on the activations' device seeded with
    it, so a recompute redraws them."""

    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        _, whole = layered_tp(cfg, factory)
        self.ln1 = LayerNorm(h, eps, **whole)
        self.attn = GPTAttention(cfg, **factory)
        self.ln2 = LayerNorm(h, eps, **whole)
        self.mlp = GPTMLP(cfg, **factory)

    def forward(self, x, attn_mask=None, attend=None, lora=None, seed=None):
        gen = None if seed is None else _seeded(seed, x.device)
        x = x + self.attn(self.ln1(x), attn_mask, attend, lora, gen)
        return x + self.mlp(self.ln2(x), lora, gen)

    def forward_parts(self, xs, attn_mask=None, seed=None, copies=None):
        """The training forward over sequence parts (:func:`layered_sp`):
        ``xs`` the sp parts ``[B, S/sp, H]`` in sequence order, part ``r``
        on ``copies[r]`` (this layer, or its copy on the part's sp
        position; default this layer for every part), each part's masks
        drawn from a generator seeded from ``seed`` and the part (the
        gathered attention's from part 0's)."""
        copies = list(copies or [self] * len(xs))
        gens = [None if seed is None else _seeded(_part_seed(seed, r),
                                                  p.device)
                for r, p in enumerate(xs)]
        att = self.attn.forward_parts(
            [c.ln1(p) for c, p in zip(copies, xs)], attn_mask, gens,
            [c.attn for c in copies])
        xs = [p + a for p, a in zip(xs, att)]
        return [p + c.mlp(c.ln2(p), None, g)
                for c, p, g in zip(copies, xs, gens)]


class GPTModel(nn.Module):
    """The layered decoder body (the reference's ``GPTModel``): embeddings,
    ``layer_0`` .. ``layer_{L-1}`` and the final LayerNorm; returns the
    final hidden states.  ``generator``: the CPU generator a training
    forward draws its dropout seeds from (one for the embeddings, one per
    layer).  With ``recompute_interval`` k > 0 in training, layers 0, k,
    2k, ... each run under the port's checkpoint (the reference's
    eager per-layer ``recompute``; ``recompute_policy`` is the stacked
    path's, as in the reference).  The cache paths route each layer's
    attention through :func:`attend_with_cache` or :func:`attend_paged`
    bound to its cache tensors (``kv_cache.layer(i)``).  Under sequence
    parallelism (``sequence_parts`` > 1, :func:`layered_sp`) the forward
    without a cache runs on the sequence parts (:meth:`_forward_parts`)
    and joins them; ``sequence_copies`` holds the body's copies on sp
    positions of their own (:meth:`copy_over_sp`)."""

    def __init__(self, cfg: GPTConfig, generator: torch.Generator,
                 **factory):
        super().__init__()
        self.config = cfg
        self.generator = generator
        self.sequence_parts = layered_sp(cfg)
        self.embeddings = GPTEmbeddings(cfg, **factory)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", GPTDecoderLayer(cfg, **factory))
        _, whole = layered_tp(cfg, factory)
        self.final_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                  **whole)
        self.sequence_copies = nn.ModuleList()
        self._copies_tied = False

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}")
                for i in range(self.config.num_layers)]

    def dropout_active(self) -> bool:
        cfg = self.config
        return self.training and (cfg.hidden_dropout > 0.0
                                  or cfg.attention_dropout > 0.0)

    def _attends(self, ids, position_ids, kv_cache, cache_index, page_tables,
                 ragged_plan):
        """(position ids, one attention route per layer) of a forward."""
        cfg = self.config
        s = ids.shape[-1]
        rel = torch.arange(s, device=ids.device)
        if kv_cache is None:
            pos_ids = rel if position_ids is None else position_ids.long()
            return pos_ids.expand_as(ids), [None] * cfg.num_layers
        scale = float(1.0 / np.sqrt(cfg.head_dim))
        placed = getattr(kv_cache, "groups", None) is not None
        if not getattr(kv_cache, "paged", False):
            pos = int(cache_index) if isinstance(
                cache_index, (int, np.integer)) else cache_index.reshape(())
            idx = cache_positions(s, pos, ids.device)
            pos_ids = idx if position_ids is None else position_ids.long()
            if placed:
                return pos_ids.expand_as(ids), placed_routes(
                    kv_cache, ids.device, s, pos, None, None, scale)
            return pos_ids.expand_as(ids), [
                partial(attend_with_cache, kc=kc, vc=vc, pos=pos, idx=idx,
                        scale=scale)
                for kc, vc in map(kv_cache.layer, range(cfg.num_layers))]
        if page_tables is None:
            raise ValueError("a paged KV cache needs page_tables "
                             "([B, max_pages] int32 pool page ids)")
        if position_ids is None:
            # prefill padding may carry positions past the table; the
            # write already sinks them into the null page -- keep the
            # embedding lookup in range too
            position_ids = torch.clamp(cache_index.long()[:, None] + rel, 0,
                                       cfg.max_position_embeddings - 1)
        if placed:
            return position_ids.long().expand_as(ids), placed_routes(
                kv_cache, ids.device, s, cache_index, page_tables,
                ragged_plan, scale)
        geo = paged_geometry(page_tables, cache_index, s,
                             kv_cache.page_size, cfg.num_heads)
        return position_ids.long().expand_as(ids), [
            partial(attend_paged, kp=kp, vp=vp, ks=ks, vs=vs, geo=geo,
                    ragged_plan=ragged_plan, scale=scale)
            for (kp, vp), (ks, vs) in zip(
                map(kv_cache.layer, range(cfg.num_layers)),
                map(kv_cache.layer_scales, range(cfg.num_layers)))]

    def forward(self, input_ids, position_ids=None, attn_mask=None,
                kv_cache=None, cache_index=None, page_tables=None,
                ragged_plan=None, lora=None):
        if self.sequence_parts > 1 and kv_cache is None and lora is None:
            with self.tied_copies():
                return self._forward_parts(input_ids, position_ids,
                                           attn_mask)
        cfg = self.config
        ids = input_ids.long()
        pos_ids, attends = self._attends(ids, position_ids, kv_cache,
                                         cache_index, page_tables,
                                         ragged_plan)
        h = self.embeddings(ids, pos_ids)
        seeds = self._seeds()
        if seeds[0] is not None:
            h = dropout(h, cfg.hidden_dropout,
                        generator=_seeded(seeds[0], h.device))

        def step(i, x):
            lr = None
            if lora is not None:
                pool_, ids_ = lora
                lr = LayerLoRA.gather(pool_.layer_slabs(i), ids_,
                                      pool_.scaling)
            return self.layers[i](x, attn_mask, attends[i], lr, seeds[i + 1])

        return self.final_ln(self._layer_loop(h, step, kv_cache is None))

    def _seeds(self):
        """A forward's dropout seeds (the embeddings', then each layer's)
        drawn from ``generator`` while dropout is active, else Nones."""
        n = self.config.num_layers + 1
        if not self.dropout_active():
            return [None] * n
        return _dropout_seeds(self.generator, n)

    def _layer_loop(self, h, step, recompute: bool):
        """``h`` through the layers, ``step(i, h)`` running layer ``i``;
        with ``recompute`` in training, layers 0, k, 2k, ... (k =
        ``recompute_interval`` > 0) under the port's checkpoint
        (``core.recompute``)."""
        cfg = self.config
        k = cfg.recompute_interval if self.training and recompute else 0
        for i in range(cfg.num_layers):
            if k and i % k == 0:
                h = checkpoint(_amp_replayed(partial(step, i), amp_state()),
                               h)
            else:
                h = step(i, h)
        return h

    def _forward_parts(self, input_ids, position_ids, attn_mask):
        """The forward without a cache under sequence parallelism
        (``sequence_parts`` > 1, :func:`layered_sp`): ``input_ids`` [B, S]
        cut into sp parts of S/sp tokens, each at its own positions (part
        ``r`` at ``r S/sp ..``, or its slice of ``position_ids``), part
        ``r`` on sp position ``r``'s copy of the body (:meth:`_bodies`);
        the embeddings, every layer (:meth:`GPTDecoderLayer.forward_parts`)
        and the final LayerNorm run per part, attention over all of them.
        Returns the final hidden states, the parts joined on part 0's
        device.  Dropout draws the unplaced model's seeds, each part its
        own masks from them (:func:`_part_seed`).  ``input_ids`` may be
        placed over the mesh as ``(None, "sp")`` (``mesh.PlacedTensor``):
        each part reads its tokens from the block on its device."""
        cfg, sp = self.config, self.sequence_parts
        shape = input_ids.shape
        s, last = shape[-1], len(shape) - 1
        if s % sp:
            raise ValueError(f"a sequence of {s} tokens does not split into "
                             f"sp={sp} parts")
        pos = (torch.arange(s, device=input_ids.device) if position_ids is None
               else position_ids.long()).expand(shape)
        n, bodies = s // sp, self._bodies()
        h = []
        for r, body in enumerate(bodies):
            dev = body[0].position_embeddings.weight.device
            ids = _span(input_ids, last, r * n, (r + 1) * n, dev)
            h.append(body[0](ids.long().to(dev),
                             pos[..., r * n:(r + 1) * n].to(dev)))
        seeds = self._seeds()
        if seeds[0] is not None:
            h = [dropout(x, cfg.hidden_dropout, generator=_seeded(
                _part_seed(seeds[0], r), x.device)) for r, x in enumerate(h)]

        def step(i, xs):
            return self.layers[i].forward_parts(
                xs, attn_mask, seeds[i + 1], [b[1 + i] for b in bodies])

        h = self._layer_loop(h, step, True)
        return torch.cat([b[-1](x).to(h[0].device)
                          for b, x in zip(bodies, h)], -2)

    def _bodies(self):
        """Each sequence part's modules, in run order (embeddings, layers,
        final LayerNorm): part 0's this model's, the others' their sp
        position's copy (:meth:`copy_over_sp`), or without copies this
        model's again."""
        body = [self.embeddings, *self.layers, self.final_ln]
        if not len(self.sequence_copies):
            return [body] * self.sequence_parts
        return [body] + [list(c) for c in self.sequence_copies]

    def copy_over_sp(self) -> bool:
        """Where the global mesh's sp positions name devices of their own
        (:func:`_sp_rows`), a copy of the body (``shards.replicate``) on
        each position s from 1 on, placed there at mesh position (replica
        0, stage 0, shard, s) (``shards.place_on_stage`` with ``sp``):
        the sequence parts run on their position's copy, tied to the
        others while they run (:meth:`tied_copies`), so every copy
        applies the sum of the parts' gradients.  The copies are
        parameters of the model and stay out of its ``state_dict``.  dp
        replicas (``DataParallel``, ZeRO's replicas) copy them with the
        model, each replica's onto its own sp positions' devices.
        Returns whether copies were made."""
        rows = _sp_rows(self.config) if self.sequence_parts > 1 else None
        if rows is None or len(self.sequence_copies):
            return False
        body = self._bodies()[0]
        for s in range(1, len(rows)):
            copy = _SequenceCopy(replicate(body), s)
            place_on_stage(copy, 0, rows[s], 0, s)
            self.sequence_copies.append(copy)
        return True

    @contextmanager
    def tied_copies(self):
        """Each sp position's body bound to its views tied over the
        positions (``shards.tie_slots``, ``shards.Bound``): in the
        backward every copy receives the sum of all the copies'
        gradients.  A no-op without copies, or inside an active
        binding."""
        if not len(self.sequence_copies) or self._copies_tied:
            yield
            return
        slots = [param_slots(b) for b in self._bodies()]
        with ExitStack() as stack:
            for s, v in zip(slots, tie_slots(slots)):
                stack.enter_context(Bound(s, v))
            self._copies_tied = True
            try:
                yield
            finally:
                self._copies_tied = False


class _SequenceCopy(nn.ModuleList):
    """One sp position's copy of the layered body
    (:meth:`GPTModel.copy_over_sp`), at sp coordinate ``sp_coordinate``
    (which ``shards.place_on_stage`` reads): trained with the model, and
    left out of its ``state_dict``, which is the unplaced model's."""

    def __init__(self, modules, sp: int):
        super().__init__(modules)
        self.sp_coordinate = sp

    def state_dict(self, *args, destination=None, prefix="",
                   keep_vars=False):
        return OrderedDict() if destination is None else destination


def _amp_replayed(fn, st):
    """``fn`` run under the amp state ``st`` had when this was made, and
    in the replica bindings active then (``shards.bound_now``: a dp
    replica's tied copies, and inside it the ties of its sp copies): a
    recompute runs in the backward, outside the forward's ``auto_cast``
    and bindings, and must run as the forward did."""
    state = (st.enabled, st.custom_white, st.custom_black, st.level,
             st.dtype)
    bindings = bound_now()

    def run(*args):
        with ExitStack() as stack:
            for b in bindings:
                stack.enter_context(b)
            with auto_cast(*state):
                return fn(*args)
    return run


class GPTLMHead(nn.Module):
    """The LM head tied to ``embeddings``' word table: ``h @ E^T``.  The
    table is read, not owned: the head has no parameters and its
    ``state_dict`` is empty, so the table is one tensor (or one set of
    parts) however many stages read it, and its gradient sums the
    lookup's and the head's.  Over a ``VocabParallelEmbedding`` the
    logits are a ``ShardedTensor`` cut by vocabulary, each shard's on
    ``stage_devices[i]`` (the table's own devices until
    ``shards.place_on_stage`` gives the head its stage's): the head's
    stage reads the table's parts across devices."""

    def __init__(self, embeddings: GPTEmbeddings):
        super().__init__()
        self._tied = (embeddings,)          # a tuple: not a submodule
        w = embeddings.word_embeddings.weight
        self.stage_devices = (tuple(p.device for p in w.parts)
                              if isinstance(w, ShardedParameter) else None)

    @property
    def _zero_tied_modules(self):
        """The modules whose parameters the head reads: ZeRO's
        ``p_g_os`` gathers them around its forward."""
        return self._tied

    def forward(self, h):
        w = self._tied[0].word_embeddings.weight
        if not isinstance(w, ShardedParameter):
            h, w = promote(*maybe_cast("matmul", h, w.to(h.device)))
            return h @ w.t()
        hs = broadcast(h, self.stage_devices)
        logits = []
        for d, part in zip(self.stage_devices, w):
            x, wd = promote(*maybe_cast("matmul", hs[d], part.to(d)))
            logits.append(x @ wd.t())
        return ShardedTensor(logits)


class GPTForPretraining(nn.Module, _CacheContract):
    """The layered GPT (the reference's ``GPTForPretraining``): ``gpt``, a
    :class:`GPTModel`, and the LM head tied to the word embeddings.  Its
    ``state_dict`` keys are the JAX model's (``gpt.layer_{i}.attn.qkv_proj
    .weight``, ...), so :meth:`load_jax_state` carries weights across.

    It trains (``forward`` gives the [B, S, V] logits, for
    ``GPTPretrainingCriterion``), generates (``generate()`` over a
    per-layer :class:`KVCache`) and serves (``ServingEngine`` over a
    per-layer ``PagedKVCache``); after :meth:`quantize_weights`
    (``quantize_for_serving``) its projections are ``Int8Linear`` and the
    head an int8 product.  The attention routes, kernels and cache
    arithmetic are the stacked model's (:func:`attend_with_cache`,
    :func:`attend_paged`); the blocks are the reference's layered code.

    ``device=None`` means ``"cuda"`` and raises when no CUDA device is
    present; pass ``device="cpu"`` to run on the CPU.  Weights are drawn
    N(0, initializer_range) from ``torch.Generator(seed)`` on the model's
    device, in module order (LayerNorm gains 1, biases 0).  Dropout seeds
    come from ``generator``, a CPU ``torch.Generator`` (``None``: one
    seeded with ``seed``).

    Under a global mesh with mp > 1 and ``use_tensor_parallel``
    (:func:`layered_tp`) the model is placed, as the reference places it:
    QKV, the output projection, fc1, fc2 and the word table are mpu
    layers holding one part on each mp device of stage 0 of replica 0
    and no whole tensor (the same seed draws the unplaced model's
    weights, then cuts them); the LayerNorms, the position table and the
    row-parallel biases stay whole on the first of them, ``device``.
    ``forward`` returns the logits gathered there; ``state_dict()``
    gathers each whole tensor and ``load_jax_state`` /
    ``load_state_dict`` cut them.  It generates and serves from its parts:
    each layer's mpu layers attend per head shard over caches cut by heads
    on the shards' devices (:meth:`cache_placement`), per-request LoRA
    adding each shard's part of the deltas (:class:`LayerLoRA`);
    quantization raises the reference's ``ValueError``
    (``use_tensor_parallel``).  A serving mesh takes it off its training
    mesh (:meth:`leave_training_mesh`), under ZeRO too.  dp and pp
    keep the reference's meaning: the bare model neither shards its batch
    nor pipelines (a ``PipelineLayer`` of its blocks and the fleet
    wrappers do).

    With ``sequence_parallel`` on a mesh whose sp axis is > 1
    (:func:`layered_sp`) the body's forward without a cache runs on sp
    sequence parts and joins them; the head runs on the joined hidden
    states.  Attention is ring attention under the reference's
    condition, and under mp > 1 per head shard.  The weights are one set
    (the state dict is the unplaced model's), each gradient the sum over
    the parts: where the sp positions name cards of their own
    (:func:`_sp_rows`) each from 1 on holds a copy of the body
    (:meth:`GPTModel.copy_over_sp`), tied to the others in every forward.
    ``DataParallel`` (fleet's ``TensorParallel`` too) and
    ``group_sharded_parallel`` take such a model: each dp replica holds
    its own copies on its own sp positions' devices, and every copy
    applies the sum over all dp x sp parts; under ZeRO each copy is
    filled from its replica's slices.  Generation, serving and
    quantization of a model whose sp axis is > 1 raise the reference's
    ``ValueError``: a one-token step does not split over sp.  sep, and
    sp without ``sequence_parallel``, are read at coordinate 0."""

    stacked = False       # the cache and LoRA layout this class reads

    def __init__(self, cfg: GPTConfig, *, device=None, dtype="float32",
                 seed: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg
        devs, _ = layered_tp(cfg, {"device": device})
        self._train_mesh = devs
        self.device = devs[0] if devs else resolve_device(device)
        self.dtype = to_torch_dtype(dtype)
        self.generator = _host_generator(generator, seed)
        self.gpt = GPTModel(cfg, self.generator, device=self.device,
                            dtype=self.dtype)
        self.lm_head = GPTLMHead(self.gpt.embeddings)
        if devs:
            place_on_stage(self, 0, devs)
        if self.gpt.copy_over_sp() and devs is None:
            # a model with copies on other cards trains only, as a model
            # placed by tensor parallelism does
            self._train_mesh = (self.device,)
        self._weight_int8 = False
        if self.device.type != "meta":   # a skeleton's tensors are assigned
            init_weights(self, seed, cfg.initializer_range)

    @property
    def weight_int8(self) -> bool:
        """Whether :meth:`quantize_weights` (or ``load_jax_state`` of a
        quantized JAX model) made this model run on int8 weights."""
        return self._weight_int8

    @torch.no_grad()
    def quantize_weights(self):
        """The reference's ``quantize_for_serving`` of the layered model:
        qkv_proj, out_proj, fc1 and fc2 of every layer become
        ``Int8Linear`` (per-output-channel absmax int8 weights, the fp
        weights dropped), and the tied head ``lm_head_int8`` [hidden, V]
        with ``lm_head_scale`` [V].  Idempotent.  A config with
        ``use_tensor_parallel`` raises the reference's ``ValueError``, as
        does a model whose sp axis is > 1 (it cannot serve)."""
        if self._weight_int8:
            return
        refuse_tensor_parallel(self)
        self._refuse_sequence_parts()
        self._require_whole_weights("quantize_weights")
        for layer in self.gpt.layers:
            for owner, name in ((layer.attn, "qkv_proj"),
                                (layer.attn, "out_proj"),
                                (layer.mlp, "fc1"), (layer.mlp, "fc2")):
                setattr(owner, name, Int8Linear(getattr(owner, name)))
        q, s = quantize_weight(self.gpt.embeddings.word_embeddings.weight, 1)
        self.register_buffer("lm_head_int8", q.t())        # k_major already
        self.register_buffer("lm_head_scale", s)
        self._weight_int8 = True

    @torch.no_grad()
    def load_jax_state(self, state: Mapping[str, np.ndarray]):
        """Carry the JAX model's weights across: ``state`` maps every key
        of ``paddle_tpu``'s ``GPTForPretraining.state_dict()`` to a numpy
        array of the same shape.  A quantized JAX model's buffers
        (``...weight_int8``, ``...w_scale``, ``lm_head_int8``,
        ``lm_head_scale``) quantize this model's structure first and are
        then copied unchanged.  Missing, unknown or mis-shaped keys
        raise."""
        int8 = any(k.endswith(".weight_int8") for k in state)
        if self._weight_int8 and not int8:
            raise ValueError("load_jax_state: this model is quantized; load "
                             "fp weights into a fresh model")
        if int8:
            self.quantize_weights()
        bufs = dict(self.named_buffers())
        missing = sorted(set(bufs) - set(state))
        if missing:
            raise KeyError(f"load_jax_state: int8 buffers missing {missing}")
        for name, b in bufs.items():
            a = np.asarray(state[name])
            want = np.int8 if name.endswith("int8") else np.float32
            if a.dtype != want or tuple(a.shape) != tuple(b.shape):
                raise ValueError(f"load_jax_state: {name} is {a.dtype} "
                                 f"{a.shape}, expected {np.dtype(want)} "
                                 f"{tuple(b.shape)}")
            b.copy_(torch.from_numpy(a.copy()))    # keeps b's k_major layout
        load_jax_state(self, {k: v for k, v in state.items()
                              if k not in bufs})

    def cache_placement(self):
        """One group a layer on the mp shard devices of a model placed by
        tensor parallelism (:func:`layered_tp`); None otherwise."""
        if self._train_mesh is None:
            return None
        devs = tuple(self._train_mesh)
        return [((layer,), devs) for layer in range(self.config.num_layers)]

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """``nn.Module.load_state_dict``; a placed model cuts each whole
        tensor into its parts (``shards.load_state``)."""
        if self._train_mesh is None:
            return super().load_state_dict(state_dict, strict, assign)
        return nn.modules.module._IncompatibleKeys(
            *load_state(self, state_dict, strict))

    def forward(self, input_ids, position_ids=None, attn_mask=None,
                kv_cache=None, cache_index=None, page_tables=None,
                ragged_plan=None, out_rows=None, lora=None):
        """The reference's parameters, in its order.  Without a cache:
        ``input_ids`` [B, S] at ``position_ids`` (default ``0..S-1``),
        causal attention, or ``attn_mask`` (boolean or additive,
        broadcastable to [B, heads, S, S]) in its place; returns the
        [B, S, V] logits.  With a contiguous ``kv_cache`` (a per-layer
        :class:`KVCache`) and ``cache_index`` (the Python int 0 for the
        whole-prompt prefill, or a 0-d device tensor) or a paged one with
        ``page_tables`` and per-row ``cache_index`` [S]: the step's K/V
        are written in place and the logits returned; ``ragged_plan``
        and ``out_rows`` are the serving engine's fused step's (``out_rows``
        [S'] selects the rows the head projects).  ``lora``:
        ``(LoRAAdapterPool, ids)``, ``ids`` [B] the adapter page of each
        row; a contiguous cache refuses it."""
        if kv_cache is not None:
            self._refuse_sequence_parts()
        else:
            self._refuse_training()
        if self._train_mesh is not None:
            if lora is not None and not getattr(kv_cache, "paged", False):
                raise ValueError("per-request LoRA adapters ride the paged "
                                 "serving step (page_tables required)")
            # the head reads the word table: inside the binding, so the
            # sp copies' tables receive its gradient too
            with self.gpt.tied_copies():
                h = self.gpt(input_ids, position_ids, attn_mask, kv_cache,
                             cache_index, page_tables, ragged_plan, lora)
                if out_rows is not None:
                    h = h[out_rows.to(h.device).long()]
                return self._logits(h)
        if lora is not None and kv_cache is not None and not getattr(
                kv_cache, "paged", False):
            raise ValueError("per-request LoRA adapters ride the paged "
                             "serving step (page_tables required)")
        if getattr(kv_cache, "shards", None) is None:
            self._require_whole_weights("a forward without a sharded pool")
        if getattr(kv_cache, "shards", None) is not None:
            h = self._forward_sharded(input_ids, position_ids, kv_cache,
                                      cache_index, page_tables, ragged_plan,
                                      lora)
        else:
            h = self.gpt(input_ids, position_ids, attn_mask, kv_cache,
                         cache_index, page_tables, ragged_plan, lora)
        if out_rows is not None:
            # gather each slot's output row BEFORE the vocab projection
            h = h[out_rows.long()]
        return self._logits(h)

    def _logits(self, h):
        """The head on final hidden states ``h``: the int8 product after
        :meth:`quantize_weights`, else the tied head, its vocabulary
        shards gathered under tensor parallelism."""
        if self._weight_int8:
            return quantized_matmul(h, self.lm_head_int8, self.lm_head_scale)
        out = self.lm_head(h)
        return out.gather() if isinstance(out, ShardedTensor) else out

    def _forward_sharded(self, input_ids, position_ids, kv_cache,
                         cache_index, page_tables, ragged_plan, lora):
        """The paged forward over a pool sharded per head (mp > 1):
        :func:`sharded_paged_layers` between the embeddings and the final
        LayerNorm, at the positions :meth:`GPTModel._attends` gives."""
        cfg, body = self.config, self.gpt
        if page_tables is None:
            raise ValueError("a paged KV cache needs page_tables "
                             "([B, max_pages] int32 pool page ids)")
        ids = input_ids.long()
        if position_ids is None:
            rel = torch.arange(ids.shape[-1], device=ids.device)
            position_ids = torch.clamp(cache_index.long()[:, None] + rel, 0,
                                       cfg.max_position_embeddings - 1)
        h = body.embeddings(ids, position_ids.long().expand_as(ids))
        h = sharded_paged_layers(self, h, kv_cache, page_tables, cache_index,
                                 ragged_plan, lora)
        return body.final_ln(h)


def truncated_draft(model, num_layers: int = 1):
    """A weight-sharing TRUNCATED draft for speculative serving
    (``serving/speculative.py``; the reference's ``truncated_draft``): the
    same class and config but only the first ``num_layers`` decoder
    blocks, with the target's embeddings, final LayerNorm and tied head.
    The weights are loaded from ``model`` by state-dict key
    (``serving_mesh.take_weights``: the layered model's ``gpt.layer_{i}``
    for i < ``num_layers``; the stacked slabs sliced on their layer axis),
    on its device and in its dtype.  A model quantized for serving gives a
    draft quantized the same way.  The draft owns its own paged pool
    inside the engine.

    As in the reference, the draft is built under the active global mesh:
    the draft of a model placed on a training mesh is placed on it too
    (the stacked draft's layers over its pp stages, which raises the
    reference's ``ValueError`` where ``num_layers`` does not divide into
    them), and takes the target's whole weights cut onto its parts."""
    import dataclasses

    model._require_whole_weights("truncated_draft")
    cfg = model.config
    n = int(num_layers)
    if not 1 <= n <= cfg.num_layers:
        raise ValueError(f"truncated_draft: num_layers={n} not in "
                         f"[1, {cfg.num_layers}]")
    draft = type(model)(dataclasses.replace(cfg, num_layers=n),
                        device=model.device, dtype=model.dtype)
    take_weights(draft, model)
    draft.eval()
    return draft


class GPTPretrainingCriterion(nn.Module):
    """Next-token cross entropy with an optional loss mask (the reference's
    ``GPTPretrainingCriterion``): the mean of the per-token losses, or
    ``sum(loss * mask) / max(sum(mask), 1)`` with ``loss_mask``.
    ``logits`` [B, S, V], ``labels`` [B, S] (used as given, no shift).
    With ``cfg.use_tensor_parallel`` the per-token losses come from
    ``ParallelCrossEntropy``, as in the reference: the logits may then be
    a ``ShardedTensor`` cut by vocabulary (``GPTLMHead`` over a
    ``VocabParallelEmbedding``)."""

    def __init__(self, cfg: Optional[GPTConfig] = None):
        super().__init__()
        tp = bool(cfg and cfg.use_tensor_parallel)
        self.loss_fn = ParallelCrossEntropy() if tp else None

    def forward(self, logits, labels, loss_mask=None):
        if self.loss_fn is not None:
            losses = self.loss_fn(logits, labels).reshape(-1)
        else:
            losses = cross_entropy(logits, labels,
                                   reduction="none").reshape(-1)
        if loss_mask is None:
            return losses.mean()
        mask = loss_mask.reshape(-1).to(losses.dtype)
        return (losses * mask).sum() / mask.sum().clamp_min(1.0)
