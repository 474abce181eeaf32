"""Ring attention over the mesh's ``sp`` axis (port of
``paddle_tpu/nn/functional/ring_attention.py``).

The reference keeps each sp shard's queries in place and rotates the K/V
blocks around the ring (``ppermute`` rank -> rank + 1), merging each
block pair's partial softmax online, so a sequence of length S costs a
shard ``O(S/sp * S)`` work and ``O(S/sp)`` memory.  Its block pairs are
XLA einsums.  Here every block pair runs through the flash kernels of
``ops/kernels/flash_attention.py``:

- :class:`RingAttention`, the main path: a ``torch.autograd.Function``
  over the shards' ``[B, S/sp, N, D]`` q, k and v.  At ring step ``i``
  shard ``r`` holds the K/V block of ``src = (r - i) % sp``.  Under
  causal masking the diagonal block (``src == r``) takes the causal
  forward kernel, a block of earlier keys (``src < r``) the full one, and
  a block of later keys (``src > r``) is skipped: every score there is
  masked, and the reference's contribution from it is exactly 0.  The
  blocks' ``(O, lse)`` merge in fp32 (``lse = logaddexp(lse, lse_blk)``,
  each O reweighted by ``exp(lse_old - lse)`` and ``exp(lse_blk -
  lse)``), rounded to the q dtype once.  The backward takes ``delta =
  rowsum(dO * O)`` and the global lse to the dQ and dK/dV kernels over
  the same block pairs: dQ accumulates on the query shard's device, dK/dV
  on the key shard's.  K/V move device to device with ``.to`` (a no-op
  where the shards share a card).  On CPU tensors the kernels' wrappers
  run their plain versions, so the same Function runs in the CPU tests;
- :func:`ring_attention_plain`, the reference's arithmetic (its
  ``_block_attend`` with the ``-1e9`` mask, the online m/l/O merge, ``o /
  max(l, 1e-20)``) over lists of shards, under autograd: the check the
  Function is held to;
- :func:`ring_attention`, the reference's tensor-level API on whole
  ``[B, S, N, D]`` tensors: plain causal attention at mesh ``sp <= 1``
  (the flash kernel on the card), else S cut over the mesh's sp devices
  and the Function.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from ...distributed import mesh as _mesh
from ...ops.kernels.flash_attention import (
    backward_delta, flash_attention_bnsd, flash_attention_bwd_dkv,
    flash_attention_bwd_dq, flash_attention_fwd, kernel_unsupported_reason,
)

__all__ = ["RingAttention", "ring_attention", "ring_attention_plain",
           "ring_blocks"]

# the reference's mask value
_NEG = -1e9


def ring_blocks(sp: int, causal: bool):
    """The block pairs of a ring of ``sp`` shards, in ring order: ``(i, r,
    src)`` for step ``i`` and query shard ``r``, ``src`` the key shard,
    with the pairs a causal mask leaves whole left out (``src > r``):
    ``sp (sp + 1) / 2`` pairs causal, ``sp^2`` full."""
    return [(i, r, (r - i) % sp) for i in range(sp) for r in range(sp)
            if not (causal and (r - i) % sp > r)]


def _unsupported(q: torch.Tensor) -> Optional[str]:
    """Why the flash kernels refuse this shard's block on the card (None
    on the CPU, where their plain versions run)."""
    if q.device.type == "cpu":
        return None
    return kernel_unsupported_reason(q.shape[1], q.shape[3], q.dtype)


def _row_major(t: torch.Tensor) -> torch.Tensor:
    """``t`` with rows the kernels can load: contiguous in the last axis,
    16-byte aligned strides."""
    align = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % align for s in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        return t.contiguous()
    return t


def _weights(lse_a: torch.Tensor, lse: torch.Tensor, shape):
    """``exp(lse_a - lse)`` as a ``[B, N, S, 1]`` factor."""
    b, n, s, _ = shape
    return torch.exp(lse_a - lse).view(b, n, s, 1)


class RingAttention(torch.autograd.Function):
    """``RingAttention.apply(causal, *qs, *ks, *vs)``: the sp shards'
    ``[B, S/sp, N, D]`` q, k and v (shard ``r``'s on its device), in
    shard order; returns the sp outputs ``[B, S/sp, N, D]`` in the q
    dtype, then the sp global ``lse`` ``[B * N, S/sp]`` fp32 (not
    differentiable).  The softmax scale is ``1 / sqrt(D)``.  Each block
    pair launches the forward kernel once, and the dK/dV and dQ kernels
    once each in the backward (module docstring); a shape the kernels
    refuse on the card raises ``ValueError`` before any launch."""

    @staticmethod
    def forward(ctx, causal: bool, *qkv):
        sp = len(qkv) // 3
        qs, ks, vs = qkv[:sp], qkv[sp:2 * sp], qkv[2 * sp:]
        reason = _unsupported(qs[0])
        if reason is not None:
            raise ValueError(f"ring attention: a shard's block "
                             f"{tuple(qs[0].shape)} {qs[0].dtype}: {reason} "
                             "(ROADMAP.md queue 2)")
        scale = 1.0 / math.sqrt(qs[0].shape[-1])
        acc_o: List[Optional[torch.Tensor]] = [None] * sp
        acc_lse: List[Optional[torch.Tensor]] = [None] * sp
        # the K/V block each shard holds at the current step
        kv = [(k, v) for k, v in zip(ks, vs)]
        step = 0
        for i, r, src in ring_blocks(sp, causal):
            while step < i:          # one hop of the ring: r-1 -> r
                kv = [(kv[(j - 1) % sp][0].to(qs[j].device),
                       kv[(j - 1) % sp][1].to(qs[j].device))
                      for j in range(sp)]
                step += 1
            q = qs[r].transpose(1, 2)
            k, v = (t.transpose(1, 2) for t in kv[r])
            o, lse = flash_attention_fwd(q, k, v, causal and src == r, scale)
            if acc_o[r] is None:
                acc_o[r], acc_lse[r] = o.float(), lse
                continue
            new = torch.logaddexp(acc_lse[r], lse)
            acc_o[r] = (acc_o[r] * _weights(acc_lse[r], new, o.shape)
                        + o.float() * _weights(lse, new, o.shape))
            acc_lse[r] = new
        outs = [a.transpose(1, 2).to(
                    q.dtype, memory_format=torch.contiguous_format)
                for a, q in zip(acc_o, qs)]
        ctx.causal, ctx.sp = causal, sp
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *acc_lse)
        ctx.mark_non_differentiable(*acc_lse)
        return (*outs, *acc_lse)

    @staticmethod
    def backward(ctx, *grads):
        sp, causal = ctx.sp, ctx.causal
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:sp], saved[sp:2 * sp], saved[2 * sp:3 * sp]
        outs, lses = saved[3 * sp:4 * sp], saved[4 * sp:]
        scale = 1.0 / math.sqrt(qs[0].shape[-1])
        bnsd = [t.transpose(1, 2) for t in (*qs, *ks, *vs)]
        q_h, k_h, v_h = bnsd[:sp], bnsd[sp:2 * sp], bnsd[2 * sp:]
        dos = [_row_major(torch.zeros_like(o) if g is None
                          else g.to(o.dtype)).transpose(1, 2)
               for g, o in zip(grads[:sp], outs)]
        deltas = [backward_delta(do, o.transpose(1, 2))
                  for do, o in zip(dos, outs)]

        def acc(like):
            return torch.zeros(like.shape, dtype=torch.float32,
                               device=like.device)

        dq = [acc(q) for q in qs]
        dk = [acc(k) for k in ks]
        dv = [acc(v) for v in vs]
        for _, r, src in ring_blocks(sp, causal):
            blk = causal and src == r
            dev_r, dev_s = qs[r].device, ks[src].device
            # dQ on the query shard's device, from the key block sent there
            g = flash_attention_bwd_dq(
                q_h[r], k_h[src].to(dev_r), v_h[src].to(dev_r), dos[r],
                lses[r], deltas[r], blk, scale)
            dq[r].add_(g.transpose(1, 2))
            # dK/dV on the key shard's device, from the query side sent
            # there
            gk, gv = flash_attention_bwd_dkv(
                q_h[r].to(dev_s), k_h[src], v_h[src], dos[r].to(dev_s),
                lses[r].to(dev_s), deltas[r].to(dev_s), blk, scale)
            dk[src].add_(gk.transpose(1, 2))
            dv[src].add_(gv.transpose(1, 2))
        return (None, *[g.to(t.dtype) for g, t in zip(dq, qs)],
                *[g.to(t.dtype) for g, t in zip(dk, ks)],
                *[g.to(t.dtype) for g, t in zip(dv, vs)])


def _block_attend(q, k, v, scale: float, mask):
    """One block pair, the reference's ``_block_attend``: ``(m, exp(s -
    m) @ v, rowsum exp(s - m))`` in q's dtype, ``mask`` [sq, sk] boolean
    or None.  q [B, sq, N, D], k/v [B, sk, N, D]."""
    s = torch.einsum("bqnd,bknd->bnqk", q, k) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    o = torch.einsum("bnqk,bknd->bqnd", p, v)
    return m, o, p.sum(-1)


def ring_attention_plain(qs: Sequence[torch.Tensor],
                         ks: Sequence[torch.Tensor],
                         vs: Sequence[torch.Tensor], causal: bool = True):
    """The reference's ring arithmetic over the sp shards' ``[B, S/sp, N,
    D]`` q, k and v, each shard on its device: ``(outs, lses)``, the
    shards' outputs in their dtype and ``m + log(l)`` flat ``[B * N,
    S/sp]`` (the kernels' layout), under autograd."""
    sp = len(qs)
    b, s_loc, n, d = qs[0].shape
    scale = float(1.0 / d ** 0.5)
    outs, lses = [], []
    for r, q in enumerate(qs):
        dev = q.device
        q_pos = r * s_loc + torch.arange(s_loc, device=dev)
        m_acc = torch.full((b, n, s_loc), _NEG, dtype=q.dtype, device=dev)
        l_acc = torch.zeros((b, n, s_loc), dtype=q.dtype, device=dev)
        o_acc = torch.zeros_like(q)
        for i in range(sp):
            src = (r - i) % sp
            k_pos = src * s_loc + torch.arange(s_loc, device=dev)
            mask = (q_pos[:, None] >= k_pos[None, :]) if causal else None
            m_blk, o_blk, l_blk = _block_attend(
                q, ks[src].to(dev), vs[src].to(dev), scale, mask)
            m_new = torch.maximum(m_acc, m_blk)
            alpha, beta = torch.exp(m_acc - m_new), torch.exp(m_blk - m_new)
            l_acc = l_acc * alpha + l_blk * beta
            o_acc = (o_acc * alpha.transpose(1, 2)[..., None]
                     + o_blk * beta.transpose(1, 2)[..., None])
            m_acc = m_new
        outs.append(o_acc / l_acc.transpose(1, 2)[..., None].clamp_min(1e-20))
        lses.append((m_acc + torch.log(l_acc)).reshape(b * n, s_loc))
    return outs, lses


def ring_attention(q, k, v, causal: bool = True, axis_name: str = "sp"):
    """The reference's tensor-level API: ``[B, S, N, D]`` q, k and v,
    softmax scale ``1 / sqrt(D)``; returns ``[B, S, N, D]`` on q's
    device.  Without a mesh, or with its ``axis_name`` axis at most 1,
    plain attention (causal or not): the flash kernels on the card, their
    plain version on the CPU.  Else S is cut into the axis's positions,
    shard ``r`` sent to the device of position ``r`` (every other axis at
    coordinate 0), and :class:`RingAttention` runs; S must divide by the
    axis."""
    mesh = _mesh.get_mesh() if _mesh.has_mesh() else None
    sp = 1 if mesh is None else mesh.shape.get(axis_name, 1)
    if sp <= 1:
        return flash_attention_bnsd(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2),
                                    causal=causal).transpose(1, 2)
    s = q.shape[1]
    if s % sp:
        raise ValueError(f"ring attention: seq {s} does not split over "
                         f"{axis_name}={sp}")
    devs = mesh.devices[tuple(slice(None) if a == axis_name else 0
                              for a in mesh.axis_names)]
    cut = [[t.narrow(1, r * (s // sp), s // sp).to(devs[r])
            for r in range(sp)] for t in (q, k, v)]
    outs = RingAttention.apply(bool(causal), *cut[0], *cut[1], *cut[2])
    return torch.cat([o.to(q.device) for o in outs[:sp]], 1)
