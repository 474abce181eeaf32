"""Per-row gathered low-rank (LoRA) matmul (port of
``paddle_tpu/ops/lora.py``; plain PyTorch, as the reference's is XLA).

The multi-tenant serving step (``serving/lora.py``) keeps every registered
adapter's low-rank factors in paged SLABS -- ``A`` of shape
``[num_adapter_pages, in_dim, r]`` and ``B`` of
``[num_adapter_pages, r, out_dim]`` per target matrix -- and each token of
the fused step carries the int32 adapter-page id of its tenant.  The delta
each projection adds is

    delta[t] = scaling * (x[t] @ A[ids[t]]) @ B[ids[t]]

Page 0 is the null adapter (zero factors), so tokens of adapter-less
requests flow through the same step with a zero delta.

The rounding points are the reference's: the first contraction takes x
rounded to the A-slab dtype and sums in fp32; ``u`` is rounded to the
B-slab dtype; the second product, the scaling and the sum are fp32; the
result is cast to x's dtype once.  A bf16 ``torch.bmm`` would round its
output to bf16 before the scaling, so the operands are widened to fp32
instead: a product of two bf16 values is exact in fp32.  Callers that
need fp32 products on the card keep TF32 off
(``torch.backends.cuda.matmul.allow_tf32``, PyTorch's default).

Each row gathers its own page's factors (``A[ids]``, ``B[ids]``) as the
reference does, so the work grows with the rows of the step and not with
the pages of the pool.
"""
from __future__ import annotations

import torch

__all__ = ["lora_delta_raw"]


def lora_delta_raw(x, a_slab, b_slab, ids, scaling):
    """x: ``[T, S, in]`` (T rows, each row's S positions share the row's
    adapter); a_slab: ``[P, in, r]``; b_slab: ``[P, r, out]``; ids: ``[T]``
    integer adapter-page ids -> ``[T, S, out]`` in x's dtype."""
    idx = ids.long()
    ag = a_slab.index_select(0, idx).float()            # [T, in, r]
    bg = b_slab.index_select(0, idx).float()            # [T, r, out]
    u = torch.bmm(x.to(a_slab.dtype).float(), ag)       # [T, S, r]
    d = torch.bmm(u.to(b_slab.dtype).float(), bg)       # [T, S, out]
    return (d * float(scaling)).to(x.dtype)
