"""Flash attention (forward and backward) over head-major ``[B, N, S, D]``
operands: the training block's attention.

Port of ``paddle_tpu/ops/pallas_kernels/flash_attention.py``.  Parts:

- the shape gate, ``shape_unsupported_reason``,
  copied from the JAX package's ``analysis/codes.py`` rule (seq a multiple
  of 128, at least 128; head_dim a multiple of 64), which the backward
  kernels keep; the forward kernel takes any seq (the whole-prompt
  prefill of ``generate()`` runs it at every prompt length);
- the plain PyTorch versions: ``flash_attention_plain``, the counterpart
  of ``_xla_reference_bnsd`` (fp32 scores, the finite ``NEG_INF`` causal
  mask, fp32 softmax, probabilities cast to the V dtype before PV), which
  also returns the per-row logsumexp; ``flash_attention_bwd_dkv_plain``
  and ``flash_attention_bwd_dq_plain``, the counterparts of the two
  backward Pallas kernels (P recomputed from q, k and lse, P rounded to
  the dO dtype before dV, dS to the q/k dtype before dK and dQ, fp32
  sums);
- ``FlashAttention``, a ``torch.autograd.Function`` -- the counterpart of
  the ``_flash_bnsd`` custom VJP -- that saves q, k, v, O and lse and
  runs the two backward kernels, with ``delta = rowsum(dO * O)`` as a
  plain torch op outside them, as the JAX package computes it outside
  Pallas;
- the public ``flash_attention_bnsd(q, k, v, *, causal, sm_scale)``;
- ``flash_attention_node``, the forward registered as the operator
  ``torch.ops.paddle_tpu_torch.flash_attention`` returning ``(O, lse)``,
  which a graph captured with fake tensors holds as one node; its
  autograd formula runs the same backward calls as ``FlashAttention``.

Every wrapper takes its plain version on CPU tensors and counts no
launch (``flash_attention_bnsd`` lets autograd differentiate the plain
forward).  Any other tensor launches the Hopper kernels of
``csrc/flash_attention.cu`` -- forward, dK/dV and dQ, each counted on
its own function attribute ``launches`` -- or raises; nothing falls
back.
q, k, v and dO may be strided views (the training block passes views
into its fused QKV output); O, dQ, dK and dV are returned as ``[B, N, S,
D]`` views of ``[B, S, N, D]`` memory, so the block's transpose back to
``[B, S, hidden]`` and the stack of dQ/dK/dV into the QKV gradient read
them contiguously.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from . import _build
from ._build import KernelError, count_launch

__all__ = [
    "flash_attention_bnsd",
    "flash_attention_node",
    "flash_attention_plain",
    "flash_attention_bwd_dkv_plain",
    "flash_attention_bwd_dq_plain",
    "flash_attention_fwd",
    "flash_attention_bwd_dkv",
    "flash_attention_bwd_dq",
    "backward_delta",
    "FlashAttention",
    "shape_unsupported_reason",
    "fwd_kernel_unsupported_reason",
    "kernel_unsupported_reason",
    "kernel_info",
    "NEG_INF",
]

NEG_INF = -1e30
# the JAX package's KV blocking tile (analysis/codes.py TILE_LANE)
TILE_LANE = 128
# head dims each kernel takes: (forward, backward) by dtype
KERNEL_HEAD_DIMS = {torch.float32: ((64, 128), (64, 128)),
                    torch.bfloat16: ((64, 128, 192, 256), (64, 128))}
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# operand slots of csrc/flash_attention.cu's pointer and stride arrays
_SLOTS = ("q", "k", "v", "o", "do", "dq", "dk", "dv")


# ---------------------------------------------------------------------------
# the shape gate (copied rule of paddle_tpu/analysis/codes.py)
# ---------------------------------------------------------------------------

def shape_unsupported_reason(seq_len: int, head_dim: int) -> Optional[str]:
    """``None`` when the flash kernel accepts the shape, else why not: the
    rule of the JAX package's ``flash_gate_reason``."""
    problems = []
    if seq_len < TILE_LANE or seq_len % TILE_LANE:
        problems.append(f"seq_len={seq_len} is not a {TILE_LANE}-multiple "
                        f">= {TILE_LANE} (KV blocking)")
    if head_dim % 64:
        problems.append(f"head_dim={head_dim} is not a 64-multiple "
                        "(MXU contraction width)")
    if not problems:
        return None
    return "[GL002] flash_attention: " + "; ".join(problems)


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------

def _scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """fp32 ``scale * q k^T`` [B, N, S, S], causal-masked with the finite
    ``NEG_INF``."""
    s = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=s.device).tril(sk - sq)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s


def flash_attention_plain(q, k, v, causal: bool, scale: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(O [B, N, S, D] in the q dtype, lse [B * N, S] fp32)``: fp32
    scores times ``scale``, the finite ``NEG_INF`` causal mask, an fp32
    softmax, probabilities cast to the q dtype before the PV product with
    an fp32 sum -- ``_xla_reference_bnsd`` -- and the per-row logsumexp of
    the scaled, masked scores, as the forward kernel returns it."""
    s = _scores(q, k, causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bnqk,bnkd->bnqd", p.float(), v.float()).to(q.dtype)
    b, n, sq = lse.shape
    return out, lse.reshape(b * n, sq)


def _probs_and_ds(q, k, v, do, lse, delta, causal: bool, scale: float):
    """(P, dS) in fp32, as the backward kernels recompute them:
    ``P = exp(scale q k^T - lse)``, ``dS = P * (dO v^T - delta)``."""
    b, n, sq, _ = q.shape
    p = torch.exp(_scores(q, k, causal, scale) - lse.view(b, n, sq, 1))
    dp = torch.einsum("bnqd,bnkd->bnqk", do.float(), v.float())
    return p, p * (dp - delta.view(b, n, sq, 1))


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool,
                                  scale: float):
    """The dK/dV kernel's plain version: ``(dK, dV)`` in the q dtype from
    the forward's lse and ``delta = rowsum(dO * O)``; P is rounded to the
    dO dtype before dV, dS to the q dtype before dK, and the scale enters
    dK only (the reference's ``_bwd_dkv_kernel``)."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    dv = torch.einsum("bnqk,bnqd->bnkd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bnqk,bnqd->bnkd", ds.to(q.dtype).float(),
                      q.float()) * scale
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool,
                                 scale: float):
    """The dQ kernel's plain version: dQ in the q dtype, dS rounded to the
    k dtype before the product (the reference's ``_bwd_dq_kernel``)."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum("bnqk,bnkd->bnqd", ds.to(k.dtype).float(),
                      k.float()) * scale
    return dq.to(q.dtype)


# ---------------------------------------------------------------------------
# the Hopper kernels
# ---------------------------------------------------------------------------

def _head_dim_reason(head_dim: int, dtype: torch.dtype,
                     backward: bool) -> Optional[str]:
    if dtype not in KERNEL_DTYPES:
        return (f"dtype {dtype} (the kernels take float32 and bfloat16; "
                "float16 is ROADMAP.md queue 2)")
    dims = KERNEL_HEAD_DIMS[dtype][int(backward)]
    if head_dim not in dims:
        which = "backward" if backward else "forward"
        return (f"head_dim={head_dim} (the {which} kernels take {dims} in "
                f"{dtype}; other head dims are ROADMAP.md queue 2)")
    return None


def fwd_kernel_unsupported_reason(seq_len: int, head_dim: int,
                                  dtype: torch.dtype) -> Optional[str]:
    """``None`` when the forward kernel takes this shape and dtype, else
    why not.  It takes any ``seq_len >= 1``: the last block's rows past
    the sequence are masked."""
    reason = _head_dim_reason(head_dim, dtype, backward=False)
    if reason is None and seq_len < 1:
        reason = f"seq_len={seq_len}"
    return reason


def kernel_unsupported_reason(seq_len: int, head_dim: int,
                              dtype: torch.dtype) -> Optional[str]:
    """``None`` when the backward kernels -- and so training through
    ``FlashAttention`` -- take this shape and dtype, else why not: their
    head dims plus the JAX package's shape rule (seq a multiple of
    128)."""
    return (fwd_kernel_unsupported_reason(seq_len, head_dim, dtype)
            or _head_dim_reason(head_dim, dtype, backward=True)
            or shape_unsupported_reason(seq_len, head_dim))


_fns = None


def _kernel_fns():
    global _fns
    if _fns is None:
        lib = _build.library("flash_attention")
        i32, ptr = ctypes.c_int, ctypes.c_void_p
        fns = {}
        for name in ("fwd", "bwd_dkv", "bwd_dq"):
            fn = getattr(lib, "flash_attention_" + name)
            fn.argtypes = [i32] * 7 + [ctypes.c_float, ptr, ptr, ptr]
            fn.restype = i32
            fns[name] = fn
        lib.flash_attention_kernel_info.argtypes = [i32] * 4 + [ptr]
        lib.flash_attention_kernel_info.restype = i32
        fns["info"] = lib.flash_attention_kernel_info
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        fns["error"] = lib.flash_attention_error_string
        _fns = fns
    return _fns


_WHICH = {"fwd": 0, "bwd_dkv": 1, "bwd_dq": 2}


def kernel_info(which: str, dtype: torch.dtype, head_dim: int,
                device: int = 0) -> dict:
    """What a launch of kernel ``which`` ("fwd", "bwd_dkv", "bwd_dq") at
    this dtype and head_dim runs on CUDA device ``device``: its dynamic
    shared memory per CTA (bytes), registers per thread, CTAs resident per
    SM, threads per CTA and local memory per thread (bytes)."""
    fns = _kernel_fns()
    info = (ctypes.c_int * 5)()
    err = fns["info"](device, _WHICH[which], KERNEL_DTYPES[dtype], head_dim,
                      info)
    if err != 0:
        raise KernelError(f"flash_attention kernel_info: "
                        f"{fns['error'](err).decode()} (cudaError {err})")
    return dict(zip(("smem", "registers", "ctas_per_sm", "threads",
                     "local_bytes"), info))


def _bsnd_empty(like: torch.Tensor) -> torch.Tensor:
    """An empty ``[B, N, S, D]`` tensor laid out as ``[B, S, N, D]``."""
    b, n, s, d = like.shape
    return torch.empty((b, s, n, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _launch(which: str, causal: bool, scale: float, ops: dict,
            lse: torch.Tensor, delta: Optional[torch.Tensor]):
    """Check what the kernel assumes of every operand, then launch kernel
    ``which`` on the current stream."""
    q = ops["q"]
    b, n, s, d = q.shape
    dev = q.device
    gate = (fwd_kernel_unsupported_reason if which == "fwd"
            else kernel_unsupported_reason)
    reason = gate(s, d, q.dtype)
    if reason is not None:
        raise ValueError(f"flash_attention kernel: {reason}")
    align = 16 // q.element_size()
    for name, t in ops.items():
        if t.shape != q.shape or t.dtype != q.dtype or t.device != dev:
            raise ValueError(f"flash_attention kernel: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; q is "
                             f"{q.dtype} {tuple(q.shape)} on {dev}")
        if t.stride(3) != 1 or any(st % align for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel: {name} strides "
                             f"{t.stride()} (rows must be contiguous and "
                             "16-byte aligned)")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.dtype != torch.float32 or t.device != dev
                              or t.shape != (b * n, s)
                              or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"flash_attention kernel: {name} must be "
                             f"contiguous 16-byte aligned fp32 [{b * n}, "
                             f"{s}] on {dev}")
    ptrs = (ctypes.c_void_p * 10)(
        *[ops[k].data_ptr() if k in ops else None for k in _SLOTS],
        lse.data_ptr(), None if delta is None else delta.data_ptr())
    strides = (ctypes.c_longlong * 24)(
        *[st for k in _SLOTS
          for st in (ops[k].stride()[:3] if k in ops else (0, 0, 0))])
    fns = _kernel_fns()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fns[which](dev.index, KERNEL_DTYPES[q.dtype], d, int(causal), b,
                     n, s, float(scale), ptrs, strides, stream)
    if err != 0:
        raise KernelError(f"flash_attention {which} kernel launch failed: "
                        f"{fns['error'](err).decode()} (cudaError {err})")


def flash_attention_fwd(q, k, v, causal: bool, scale: float):
    """Forward kernel: ``(O, lse)`` as :func:`flash_attention_plain`
    returns them, at any seq; O is a ``[B, N, S, D]`` view of ``[B, S,
    N, D]`` memory."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale)
    b, n, s, _ = q.shape
    out = _bsnd_empty(q)
    lse = torch.empty((b * n, s), dtype=torch.float32, device=q.device)
    _launch("fwd", causal, scale, dict(q=q, k=k, v=v, o=out), lse, None)
    count_launch(flash_attention_fwd)
    return out, lse


def backward_delta(do, out):
    """rowsum(dO * O) in fp32, flat ``[B * N, S]``: the backward kernels'
    delta, computed outside them as the JAX package computes it outside
    Pallas."""
    b, n, s, _ = out.shape
    return (do.float() * out.float()).sum(-1).reshape(b * n, s)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool,
                            scale: float):
    """dK/dV kernel: ``(dK, dV)``, each a ``[B, N, S, D]`` view of
    ``[B, S, N, D]`` memory; ``delta`` from :func:`backward_delta`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                             causal, scale)
    dk, dv = _bsnd_empty(k), _bsnd_empty(v)
    _launch("bwd_dkv", causal, scale,
            dict(q=q, k=k, v=v, do=do, dk=dk, dv=dv), lse, delta)
    count_launch(flash_attention_bwd_dkv)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool,
                           scale: float):
    """dQ kernel: dQ as a ``[B, N, S, D]`` view of ``[B, S, N, D]``
    memory; ``delta`` from :func:`backward_delta`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                            scale)
    dq = _bsnd_empty(q)
    _launch("bwd_dq", causal, scale, dict(q=q, k=k, v=v, do=do, dq=dq),
            lse, delta)
    count_launch(flash_attention_bwd_dq)
    return dq


# kernel launches made through the wrappers (plain-version calls on the
# CPU never count); callers reset them to 0 before a run they measure
flash_attention_fwd.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0


class FlashAttention(torch.autograd.Function):
    """The kernels under autograd: the forward saves q, k, v, O and lse;
    the backward computes delta once and runs the dK/dV and dQ
    kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        # a shape the backward kernels refuse raises here, before the
        # forward runs, not in the backward
        reason = kernel_unsupported_reason(q.shape[2], q.shape[3], q.dtype)
        if reason is not None:
            raise ValueError(f"flash_attention kernel: {reason}")
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        # the dO rows must be contiguous for the kernels' 16-byte loads
        if do.stride(3) != 1:
            do = do.contiguous()
        delta = backward_delta(do, out)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                         ctx.causal, ctx.scale)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.causal,
                                    ctx.scale)
        return dq, dk, dv, None, None


def _flash_node(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention node's body: ``(O, lse [B, N, S] fp32)`` from the
    forward kernel (counted) on the card, its plain version on the
    CPU."""
    b, n, s, _ = q.shape
    out, lse = flash_attention_fwd(q, k, v, causal, scale)
    return out, lse.view(b, n, s)


def _flash_node_fake(q, k, v, causal, scale):
    b, n, s, _ = q.shape
    return _bsnd_empty(q), q.new_empty((b, n, s), dtype=torch.float32)


def _flash_node_setup(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    # a shape the backward kernels refuse raises before any backward runs
    # (the forward kernel takes more head dims than they do)
    if q.device.type != "cpu":
        reason = kernel_unsupported_reason(q.shape[2], q.shape[3], q.dtype)
        if reason is not None:
            raise ValueError(f"flash_attention kernel: {reason}")
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.scale = causal, scale


def _flash_node_backward(ctx, dout, dlse):
    """dQ, dK and dV of ``(O, lse)``: on the card ``backward_delta``, the
    dK/dV kernel and the dQ kernel, as ``FlashAttention.backward`` runs
    them, with lse's gradient folded into delta (``d lse / d S = P``, so
    ``dS = P (dP - (delta - dlse))``); on the CPU autograd through the
    plain forward.  Autograd passes zeros for an output no loss reads
    (lse, on the training path)."""
    q, k, v, out, lse = ctx.saved_tensors
    b, n, s, _ = q.shape
    if q.device.type == "cpu":
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o, l = flash_attention_plain(*leaves, ctx.causal, ctx.scale)
            dq, dk, dv = torch.autograd.grad(
                (o, l), leaves, (dout, dlse.reshape(b * n, s)))
        return dq, dk, dv, None, None
    # the dO rows must be contiguous for the kernels' 16-byte loads
    if dout.stride(3) != 1:
        dout = dout.contiguous()
    delta = backward_delta(dout, out) - dlse.reshape(b * n, s)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse.view(b * n, s),
                                     delta, ctx.causal, ctx.scale)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse.view(b * n, s), delta,
                                ctx.causal, ctx.scale)
    return dq, dk, dv, None, None


def _register_flash_node():
    """``torch.ops.paddle_tpu_torch.flash_attention(q, k, v, causal,
    scale) -> (O, lse)``: the flash forward as one operator, so a graph
    captured with fake tensors (``distributed.auto_parallel.
    capture_graph``) holds attention as one node, which launches the
    kernel when the graph runs.  It returns lse ([B, N, S] fp32, what
    ``FlashAttention.forward`` saves) so that its autograd formula runs
    the two backward kernels without a second forward launch.  Its fake
    version only makes the outputs' shapes: a capture counts no launch.
    Registered once a process (a second copy of this module takes the
    first one's)."""
    try:
        return torch.ops.paddle_tpu_torch.flash_attention.default
    except (AttributeError, RuntimeError):
        pass
    op = torch.library.custom_op("paddle_tpu_torch::flash_attention",
                                 _flash_node, mutates_args=())
    op.register_fake(_flash_node_fake)
    op.register_autograd(_flash_node_backward,
                         setup_context=_flash_node_setup)
    return torch.ops.paddle_tpu_torch.flash_attention.default


flash_attention_node = _register_flash_node()


def flash_attention_bnsd(q, k, v, *, causal: bool = False,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v: ``[B, N, S, D]`` -> ``[B, N, S, D]`` (head-major), the
    softmax scale ``sm_scale`` or ``1/sqrt(D)``.

    CPU tensors run the plain version, which autograd differentiates;
    any other tensor runs the forward kernel and, under autograd, the two
    backward kernels (counted in ``flash_attention_fwd.launches``,
    ``flash_attention_bwd_dkv.launches`` and
    ``flash_attention_bwd_dq.launches``), or raises: a shape or dtype the
    kernels do not take raises ``ValueError`` with the reason.  Fake
    tensors (a graph capture) take ``flash_attention_node``, the forward
    as one operator (its output 0)."""
    scale = float(sm_scale if sm_scale is not None
                  else 1.0 / (q.shape[-1] ** 0.5))
    if is_fake(q):
        return flash_attention_node(q, k, v, bool(causal), scale)[0]
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale)[0]
    return FlashAttention.apply(q, k, v, bool(causal), scale)
