"""Per-op sharding propagation and reshard insertion over a captured graph
(port of ``paddle_tpu/distributed/auto_parallel/propagation.py``;
reference: Paddle's ``auto_parallel/static/completion.py:107,936``, the
per-op rule files ``static/operators/dist_*.py`` and ``static/
reshard.py:1010,2772``).

The graph is PyTorch's, not a jaxpr: :func:`capture_graph` is the
counterpart of ``capture_jaxpr``, an aten-level ``torch.fx.GraphModule``
from ``make_fx(fn, tracing_mode="fake")``.  It is shape-only, as
``make_jaxpr`` over ``ShapeDtypeStruct``s is: the example arguments may
be fake tensors, so a 1.3B model is captured without its weights in
memory, and a module's parameters enter as inputs through
``torch.func.functional_call`` (:func:`parameters_as_inputs`).  Python
loops are unrolled in the capture, so the graph has no scan, while or
cond, and the reference's ``_rule_scan``, ``_rule_while`` and
``_rule_cond`` have no counterpart here.  The port's flash attention is
one node (``torch.ops.paddle_tpu_torch.flash_attention``, the
hand-written kernel on the card), never its inlined body.

The pass (:func:`propagate_graph`) walks the nodes in order and gives
every node a :class:`DistSpec` from the input annotations alone, by a
rule keyed on the aten overload (products, elementwise and unary ops,
reductions, layout, split/cat/slice/select, embedding, the norms and
softmax, the scatter family, scans and sorts, factories, the attention
node; unknown ops replicate, as the reference's do).  A dimension's spec
may be a tuple of mesh axes, major first: aten merges [B, heads] into one
batch dimension before every ``bmm``, and the merge keeps both axes when
the layout allows it (see :func:`_reshape_dims`).  Where an operand's
spec conflicts with what the op needs, the pass records a
:class:`Reshard` (the Resharder's trigger) with the operand's bytes.

The executor (:func:`apply_propagation`) cannot hand the graph to a
compiler as the reference hands it to GSPMD.  It evaluates the graph per
mesh position on local blocks: each node on a position's blocks, with the
shape arguments of ``view``/``expand`` made local; each reshard
materialised (the whole tensor gathered on the position's device, then
cut again); a node the pass cannot run on blocks (an unknown op, a
reshape or cut across a sharded dimension, a scatter, a scan) run whole
at every position and cut by its spec.  A pending partial sum is summed
across its axes (``serving_mesh.reduce_sum``) before any consumer that is
not linear in it, even where the pass's spec still carries the partial
(the reference lets partials flow into elementwise ops, which GSPMD
corrects silently), and at the graph's outputs.  Random nodes
(dropout's ``native_dropout``, ``bernoulli``, the ``rand*`` factories)
draw once, on the first position's device, and every position takes its
block of that one draw: one global mask, as GSPMD draws it.  A dimension
an output's axes do not divide is held whole: the node runs whole and its
output is cut by the axes that do divide it.

An argument may also be a :class:`HeldBlocks`: one block a mesh position
that its owner hands over at the graph's first read of it (tied, or
gathered from ZeRO slices), frees after the last node that reads it or a
view of it, and gathers again when a gradient first reaches such a
node's outputs (``auto_parallel.placed``, the Engine's placed model).

The executor runs a forward under ``torch.no_grad``, or with
``grad=True`` on autograd's tape: every block op, gather, cut (``narrow``),
move (``.to``) and partial sum is then recorded, so the gradient of a
whole tensor given as an argument lands on that tensor.  The attention
node's autograd formula runs the flash backward kernels.  A graph
captured with in-place nodes is captured again through
``torch.func.functionalize``, so no node overwrites a value autograd
saved; an in-place update of an argument still raises.

:func:`graph_cost` reads FLOPs (products from their shapes; the
attention node as the two products of the plain expression, 4 B N S^2 D),
bytes, and reshard bytes off the same walk.
"""
from __future__ import annotations

import contextlib
import math
import operator
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.fx as fx

from .. import mesh as _mesh
from ..serving_mesh import reduce_sum

__all__ = ["DistSpec", "PropagationResult", "Reshard", "propagate_graph",
           "apply_propagation", "graph_cost", "capture_graph",
           "parameters_as_inputs", "HeldBlocks"]


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _ax(entry) -> tuple:
    """The mesh axes of one dimension's entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _ent(axes):
    """A dimension's entry from its axes: None, a name or a tuple."""
    axes = tuple(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


class DistSpec(NamedTuple):
    """dims: per tensor dimension, None, a mesh axis name, or a tuple of
    axes cutting it together (major first) -- the reference's
    dims_mapping; partial: axes with a pending cross-shard sum -- the
    reference's partial state."""
    dims: Tuple[Any, ...]
    partial: frozenset = frozenset()

    @staticmethod
    def replicated(ndim: int) -> "DistSpec":
        return DistSpec(dims=(None,) * ndim)

    @property
    def n_sharded(self) -> int:
        return sum(d is not None for d in self.dims)

    def drop_partial(self) -> "DistSpec":
        return DistSpec(self.dims, frozenset())

    def __repr__(self):  # compact, for plan dumps
        d = ",".join("*".join(_ax(a)) or "-" for a in self.dims)
        p = ("+" + "+".join(sorted(self.partial))) if self.partial else ""
        return f"[{d}]{p}"


def _spec(dims, partial=frozenset()) -> DistSpec:
    return DistSpec(tuple(_ent(_ax(d)) for d in dims), frozenset(partial))


class Reshard(NamedTuple):
    """One inserted reshard (Resharder analog): the node that needed it
    (its index in the graph), its aten op, which operand, the from/to
    specs, and the operand's bytes (the cost model's charge)."""
    node_index: int
    primitive: str
    operand: int
    src: DistSpec
    dst: DistSpec
    bytes: float = 0.0


class PropagationResult(NamedTuple):
    graph: Any                       # the captured fx.GraphModule
    var_specs: Dict[Any, Any]        # every node -> DistSpec (a list of
    #                                  them for a node of several outputs)
    out_specs: List[DistSpec]
    reshards: List[Reshard]
    plan: Dict[Any, Any]             # node -> how the executor runs it

    def spec_of_output(self, i=0) -> DistSpec:
        return self.out_specs[i]


# ---------------------------------------------------------------------------
# spec algebra
# ---------------------------------------------------------------------------

def _merge_dim(a, b):
    """Merge one dim's entries; returns (merged, conflict)."""
    if a == b:
        return a, False
    if a is None:
        return b, False
    if b is None:
        return a, False
    return a, True          # both sharded differently: keep a, conflict


def _dedup_axes(dims):
    """One mesh axis may shard at most ONE tensor dim: keep its first
    occurrence, drop repeats."""
    seen, out = set(), []
    for d in dims:
        kept = [a for a in _ax(d) if a not in seen]
        seen.update(kept)
        out.append(_ent(kept))
    return tuple(out)


def _unify(dims_list: Sequence[Sequence]) -> tuple:
    """Elementwise unification of same-rank dims: the operand with the
    MOST sharded dims wins per-dim ties (the reference's policy)."""
    order = sorted(range(len(dims_list)),
                   key=lambda i: -sum(d is not None for d in dims_list[i]))
    base = list(dims_list[order[0]])
    for i in order[1:]:
        for d, ax in enumerate(dims_list[i]):
            base[d], _ = _merge_dim(base[d], ax)
    return _dedup_axes(base)


def _moves(src: Sequence, dst: Sequence) -> bool:
    """Whether going from ``src`` to ``dst`` dims moves data (a dim that
    is cut in ``src`` and not the same way in ``dst``; cutting a whole
    dim is a local slice)."""
    return any(s is not None and s != d for s, d in zip(src, dst))


# ---------------------------------------------------------------------------
# aten op sets
# ---------------------------------------------------------------------------

_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "pow", "maximum", "minimum",
    "atan2", "remainder", "fmod", "floor_divide", "bitwise_and",
    "bitwise_or", "bitwise_xor", "logical_and", "logical_or", "logical_xor",
    "eq", "ne", "lt", "le", "gt", "ge", "where", "masked_fill", "lerp",
    "addcmul", "addcdiv", "copysign", "hypot", "xlogy",
}
_UNARY = {
    "neg", "exp", "exp2", "log", "log1p", "log2", "expm1", "tanh", "sin",
    "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "asinh", "acosh",
    "atanh", "sqrt", "rsqrt", "abs", "sign", "floor", "ceil", "round",
    "trunc", "erf", "erfc", "erfinv", "sigmoid", "logical_not",
    "bitwise_not", "isnan", "isinf", "isfinite", "reciprocal", "gelu",
    "relu", "silu", "clamp", "clamp_min", "clamp_max", "_to_copy", "clone",
    "alias", "detach", "lift_fresh_copy", "contiguous", "nan_to_num",
    "square", "hardtanh", "leaky_relu", "elu", "softplus", "mish",
}
_REDUCE_SUM = {"sum", "mean"}
_REDUCE_OTHER = {"amax", "amin", "max", "min", "argmax", "argmin", "prod",
                 "logsumexp", "any", "all", "var", "std"}
_VIEWS = {"view", "_unsafe_view", "reshape", "view_copy"}
_CUTS = {"split", "split_with_sizes", "unbind", "slice", "select", "narrow",
         "chunk"}
_SCATTER = {"index_put", "select_scatter", "slice_scatter", "scatter",
            "scatter_add", "index_copy", "index_add", "masked_scatter",
            "diagonal_scatter"}
_SCATTER_ADD = {"scatter_add", "index_add"}
_SCANS = {"cumsum", "cumprod", "cummax", "cummin", "logcumsumexp", "sort",
          "argsort"}
_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm"}
# random ops: the executor draws each once (module docstring)
_RANDOM = {"native_dropout", "bernoulli", "rand", "randn", "rand_like",
           "randn_like", "randint", "randint_like", "randperm", "normal",
           "uniform", "multinomial", "exponential", "geometric",
           "log_normal", "cauchy", "poisson", "random"}
# ops the executor runs on blocks with a pending partial kept (linear in
# each operand; add/sub only when every operand carries the same partial)
_LINEAR_LAYOUT = {"view", "_unsafe_view", "reshape", "view_copy", "permute",
                  "t", "transpose", "expand", "unsqueeze", "squeeze",
                  "clone", "alias", "detach", "contiguous", "lift_fresh_copy",
                  "split", "split_with_sizes", "unbind", "slice", "select",
                  "narrow", "chunk", "cat", "neg"}
# ops whose output may share its input's storage: a held input's storage
# must outlive every node that reads it through them (HeldBlocks)
_ALIASING = {"view", "_unsafe_view", "reshape", "_reshape_alias", "permute",
             "t", "transpose", "expand", "unsqueeze", "squeeze", "alias",
             "detach", "split", "split_with_sizes", "unbind", "slice",
             "select", "narrow", "chunk", "as_strided", "diagonal",
             "getitem", "view_as"}


def _op_name(node) -> str:
    t = node.target
    if t is operator.getitem:
        return "getitem"
    packet = getattr(t, "_overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(t, "__name__", str(t))


def _is_inplace(name: str) -> bool:
    return name.endswith("_") and not name.endswith("__")


def _val(node):
    return node.meta.get("val") if isinstance(node, fx.Node) else None


def _is_tensor_node(a) -> bool:
    return isinstance(a, fx.Node) and isinstance(_val(a), torch.Tensor)


def _visit_operands(a, out: list):
    if _is_tensor_node(a):
        out.append(a)
    elif isinstance(a, (list, tuple)):
        for x in a:
            _visit_operands(x, out)


def _operands(node) -> List[fx.Node]:
    """The node's tensor operands, in argument order (lists flattened)."""
    out: List[fx.Node] = []
    for a in node.args:
        _visit_operands(a, out)
    for a in node.kwargs.values():
        _visit_operands(a, out)
    return out


def _substitute(a, local):
    """``a`` (an argument: a node, or lists and tuples of them) with each
    node in ``local`` replaced by its value there.  A module function, not
    a closure that calls itself: that would be a reference cycle holding
    ``local``'s tensors, and their autograd graph, until a garbage
    collection."""
    if isinstance(a, fx.Node):
        return local[a] if a in local else a
    if isinstance(a, (list, tuple)):
        return type(a)(_substitute(x, local) for x in a)
    return a


def _shape(node) -> tuple:
    v = _val(node)
    return tuple(v.shape) if isinstance(v, torch.Tensor) else ()


def _nbytes(node) -> float:
    v = _val(node)
    if not isinstance(v, torch.Tensor):
        return 0.0
    return float(math.prod(v.shape)) * v.element_size()


def _out_vals(node) -> list:
    v = _val(node)
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _arg(node, i, name, default=None):
    if len(node.args) > i:
        return node.args[i]
    return node.kwargs.get(name, default)


def _norm_dim(d, ndim):
    return d + ndim if d < 0 else d


# ---------------------------------------------------------------------------
# reshape: size runs, tuples of axes
# ---------------------------------------------------------------------------

def _groups(in_shape, out_shape):
    """Runs of input and output dims whose sizes multiply to the same
    number, in order; None when the shapes do not pair up (a zero)."""
    if 0 in in_shape or 0 in out_shape:
        return None
    i = j = 0
    groups = []
    while i < len(in_shape) or j < len(out_shape):
        I, J, pa, pb = [], [], 1, 1
        if i < len(in_shape):
            pa = in_shape[i]
            I.append(i)
            i += 1
        if j < len(out_shape):
            pb = out_shape[j]
            J.append(j)
            j += 1
        while pa != pb:
            if pa < pb and i < len(in_shape):
                pa *= in_shape[i]
                I.append(i)
                i += 1
            elif pb < pa and j < len(out_shape):
                pb *= out_shape[j]
                J.append(j)
                j += 1
            else:
                return None
        groups.append((I, J))
    return groups


def _reshape_dims(dims, in_shape, out_shape, sizes):
    """(output dims, exact) of a reshape.  Within each run of dims whose
    sizes match, the input's axes in order (major first) form one block
    cut of the flattened run -- exact when every input dim before the
    last cut one holds one element a position -- and are laid onto the
    output dims from the leading one while each divides what is left of
    it, moving on only when a dim is used up.  Exact both ways, a
    position's block of the input is its block of the output: the merge
    of [B, heads] (dp, mp) into one batch dim keeps ("dp", "mp"), and the
    split back gives (dp, mp).  Otherwise the reshape moves data: each
    axis goes to the first output dim of its run it divides (else it is
    dropped) and exact is False.  ``sizes`` None (no mesh given): every
    axis is taken to divide, one axis an output dim of the run in order."""
    groups = _groups(in_shape, out_shape)
    out = [None] * len(out_shape)
    if groups is None:
        return out, not any(d is not None for d in dims)
    exact = True
    for I, J in groups:
        axes = [a for i in I for a in _ax(dims[i])]
        if not axes:
            continue
        placed = {j: [] for j in J}
        ok = True
        if sizes is None:
            big = [j for j in J if out_shape[j] > 1] or J
            for k, a in enumerate(axes):
                if big:
                    placed[big[min(k, len(big) - 1)]].append(a)
        else:
            last = max(i for i in I if dims[i] is not None)
            ok = all(in_shape[i] == math.prod(sizes[a] for a in _ax(dims[i]))
                     for i in I if i < last)
            rem = {j: out_shape[j] for j in J}
            k = 0
            if ok:
                for j in J:
                    while k < len(axes) and rem[j] % sizes[axes[k]] == 0:
                        placed[j].append(axes[k])
                        rem[j] //= sizes[axes[k]]
                        k += 1
                    if rem[j] != 1:
                        break
                ok = k == len(axes)
            if not ok:
                placed = {j: [] for j in J}
                rem = {j: out_shape[j] for j in J}
                for a in axes:
                    for j in J:
                        if rem[j] % sizes[a] == 0 and rem[j] >= sizes[a]:
                            placed[j].append(a)
                            rem[j] //= sizes[a]
                            break
        exact = exact and ok
        for j in J:
            out[j] = _ent(placed[j])
    return out, exact


# ---------------------------------------------------------------------------
# per-op rules: (out specs, what each operand must be, whole)
#   need[i]: the spec operand i must have for the op to run on blocks;
#   whole: the executor runs the op on whole tensors and cuts the output
# ---------------------------------------------------------------------------

def _dot(ls, rs, lc, rc, lb, rb):
    """dist_matmul analog (``_rule_dot_general``): free dims inherit their
    operand's axes; contracting dims cut by the SAME axes on both sides
    give a partial (pending sum); a one-sided or mismatched contracting
    cut is a conflict -> that operand is gathered on the dim.  An axis
    that cuts free dims of both operands cuts the output's first of them
    only, so the other operand is gathered on its dim (GSPMD's runtime
    does that gather; the executor runs on the operands' blocks)."""
    lhs, rhs = list(ls.dims), list(rs.dims)
    partial = set(ls.partial | rs.partial)
    for bl, br in zip(lb, rb):
        m, _ = _merge_dim(lhs[bl], rhs[br])
        lhs[bl] = rhs[br] = m
    for cl, cr in zip(lc, rc):
        a, b = lhs[cl], rhs[cr]
        if a is not None and a == b:
            partial.update(_ax(a))
        elif a != b:
            lhs[cl] = rhs[cr] = None
    srcs = ([(lhs, i) for i in lb]
            + [(lhs, i) for i in range(len(lhs)) if i not in lc and i not in lb]
            + [(rhs, i) for i in range(len(rhs)) if i not in rc and i not in rb])
    out = _dedup_axes([side[i] for side, i in srcs])
    for (side, i), d in zip(srcs, out):
        side[i] = d
    return (DistSpec(out, frozenset(partial)),
            [DistSpec(tuple(lhs), ls.partial), DistSpec(tuple(rhs),
                                                       rs.partial)])


def _aligned(dims, shape, out_shape):
    """An operand's dims aligned to the broadcast output (None where it
    has no dim or broadcasts one of size 1)."""
    R, r = len(out_shape), len(shape)
    out = [None] * R
    for i in range(r):
        od = R - r + i
        if shape[i] == out_shape[od]:
            out[od] = dims[i]
    return out


def _unaligned(dims, shape, out_shape):
    R, r = len(out_shape), len(shape)
    return tuple(dims[R - r + i] if shape[i] == out_shape[R - r + i]
                 else None for i in range(r))


def _rule_elementwise(specs, shapes, out_shape):
    al = [_aligned(s.dims, sh, out_shape) for s, sh in zip(specs, shapes)]
    merged = _unify(al)
    partial = frozenset().union(*[s.partial for s in specs])
    need = [DistSpec(_unaligned(merged, sh, out_shape), s.partial)
            for s, sh in zip(specs, shapes)]
    return [DistSpec(merged, partial)], need


def _rule_product(name, node, specs, shapes):
    if name in ("mm", "bmm"):
        ls, rs = specs
        if name == "mm":
            out, need = _dot(ls, rs, [1], [0], [], [])
        else:
            out, need = _dot(ls, rs, [2], [1], [0], [0])
        return [out], need
    # addmm / baddbmm: the product, then the bias joins it elementwise
    bs, ls, rs = specs
    if name == "addmm":
        prod, need = _dot(ls, rs, [1], [0], [], [])
    else:
        prod, need = _dot(ls, rs, [2], [1], [0], [0])
    out_shape = _shape(node)
    [out], (bneed, _) = _rule_elementwise([bs, prod], [shapes[0], out_shape],
                                          out_shape)
    return [out], [bneed] + need


def _reduced(node, ndim) -> set:
    """The dims a reduction of an ``ndim``-dim operand reduces."""
    dims = _arg(node, 1, "dim")
    if dims is None or dims == []:
        return set(range(ndim))
    return {_norm_dim(d, ndim) for d in
            (dims if isinstance(dims, (list, tuple)) else [dims])}


def _rule_reduce(name, node, spec, shape):
    """A sum or mean over cut dims gives a partial; max, min and the like
    over a cut dim need the whole dim (gathered)."""
    axes = _reduced(node, len(shape))
    outs = _out_vals(node)
    keep = len(outs[0].shape) == len(shape)
    partial = set(spec.partial)
    need = spec
    if name in _REDUCE_SUM:
        for i in axes:
            partial.update(_ax(spec.dims[i]))
    elif any(spec.dims[i] is not None for i in axes):
        need = DistSpec(tuple(None if i in axes else d
                              for i, d in enumerate(spec.dims)), spec.partial)
    out = tuple(None if i in axes else d for i, d in enumerate(need.dims)
                if keep or i not in axes)
    return [DistSpec(out, frozenset(partial))] * len(outs), [need]


def _rule_view(node, spec, sizes):
    in_shape = _shape(node.args[0])
    out_shape = _shape(node)
    dims, exact = _reshape_dims(spec.dims, in_shape, out_shape, sizes)
    need = spec if exact else DistSpec.replicated(len(in_shape))
    return [DistSpec(tuple(dims), spec.partial)], [need], not exact


def _rule_cut(name, node, spec, shape):
    """split/unbind/slice/select/narrow: the other dims keep their
    shards; a cut dimension that is sharded is gathered (the chunks of an
    even split, and a slice, keep its axes, as the reference keeps them:
    each output is cut again)."""
    ndim = len(shape)
    if name in ("unbind", "select"):
        dim = _arg(node, 1, "dim", 0)
    elif name in ("split", "split_with_sizes", "chunk"):
        dim = _arg(node, 2, "dim", 0)
    else:                               # slice, narrow
        dim = _arg(node, 1, "dim", 0)
    dim = _norm_dim(dim, ndim)
    outs = _out_vals(node)
    cut = spec.dims[dim] is not None
    need = DistSpec(tuple(None if i == dim else d
                          for i, d in enumerate(spec.dims)), spec.partial) \
        if cut else spec
    if name in ("unbind", "select"):
        dims = tuple(d for i, d in enumerate(spec.dims) if i != dim)
        specs = [DistSpec(dims, spec.partial)] * len(outs)
    elif name in ("split", "split_with_sizes", "chunk") and \
            len({tuple(o.shape)[dim] for o in outs}) > 1:
        specs = [DistSpec(need.dims, spec.partial)] * len(outs)
    else:
        specs = [DistSpec(spec.dims, spec.partial)] * len(outs)
    return specs, [need], cut


def _rule_cat(node, specs, shapes):
    dim = _norm_dim(_arg(node, 1, "dim", 0), len(shapes[0]))
    merged = list(_unify([s.dims for s in specs]))
    merged[dim] = None                      # the concat dim is whole
    partial = frozenset().union(*[s.partial for s in specs])
    need = [DistSpec(tuple(merged), s.partial) for s in specs]
    return [DistSpec(tuple(merged), partial)], need


def _rule_embedding(spec_w, spec_i):
    """dist_embedding analog: output dims = the indices' dims + the
    table's column cut; a cut of the table's rows (vocabulary-parallel)
    gives a partial: a masked lookup a shard, summed later."""
    partial = set(spec_w.partial | spec_i.partial)
    partial.update(_ax(spec_w.dims[0]))
    out = _dedup_axes(tuple(spec_i.dims) + (spec_w.dims[1],))
    return [DistSpec(out, frozenset(partial))], [spec_w, spec_i]


def _rule_layer_norm(node, specs, shapes):
    x = specs[0]
    k = len(_arg(node, 1, "normalized_shape"))
    nd = len(shapes[0])
    xdims = tuple(None if i >= nd - k else d for i, d in enumerate(x.dims))
    need = [DistSpec(xdims, x.partial)] + [
        DistSpec.replicated(len(sh)) if s.n_sharded else s
        for s, sh in zip(specs[1:], shapes[1:])]
    stats = DistSpec(xdims[:nd - k] + (None,) * k, x.partial)
    return [DistSpec(xdims, x.partial), stats, stats], need


def _rule_softmax(node, spec, shape):
    dim = _norm_dim(_arg(node, 1, "dim"), len(shape))
    need = DistSpec(tuple(None if i == dim else d
                          for i, d in enumerate(spec.dims)), spec.partial)
    return [need], [need]


def _rule_tril(spec):
    """tril/triu: which elements stay depends on the global row and
    column, so the last two dims are whole."""
    need = DistSpec(tuple(spec.dims[:-2]) + (None, None), spec.partial) \
        if len(spec.dims) >= 2 else spec
    return [need], [need]


def _rule_expand(spec, in_shape, out_shape):
    R, r = len(out_shape), len(in_shape)
    out = [None] * R
    for i in range(r):
        od = R - r + i
        if in_shape[i] == out_shape[od]:
            out[od] = spec.dims[i]
    return [DistSpec(tuple(out), spec.partial)], [spec]


def _rule_attention(specs):
    """The flash attention node over [B, N, S, D] q, k and v, giving O
    [B, N, S, D] and lse [B, N, S]: batch and head dims keep their shards
    (unified over the three), the sequence and head_dim dims must be
    whole."""
    lead = _unify([tuple(s.dims[:2]) for s in specs])
    need = [DistSpec(tuple(lead) + (None, None), s.partial) for s in specs]
    partial = frozenset().union(*[s.partial for s in specs])
    return [DistSpec(tuple(lead) + (None, None), partial),
            DistSpec(tuple(lead) + (None,), partial)], need


def _rule_scatter(name, node, specs):
    """.at[].set / .add style updates keep the OPERAND's layout; a sharded
    or partial update is a real collective, recorded; the partial
    survives only through an add."""
    s = specs[0]
    is_add = name in _SCATTER_ADD or (
        name == "index_put" and bool(_arg(node, 3, "accumulate", False)))
    need = list(specs)
    if s.partial and not is_add:
        need[0] = s.drop_partial()
    for i in range(1, len(specs)):
        sp = specs[i]
        if sp.n_sharded or (sp.partial and not is_add):
            need[i] = DistSpec.replicated(len(sp.dims))
    part = frozenset().union(*[sp.partial for sp in specs]) if is_add \
        else frozenset()
    return [DistSpec(s.dims, part)], need


def _rule_scan(name, node, spec, shape):
    """Axis-local scans and sorts: the layout passes through, the scanned
    axis whole; a partial commutes only with the linear cumsum."""
    need = spec
    if spec.partial and name != "cumsum":
        need = spec.drop_partial()
    dim = _arg(node, 1, "dim", -1)
    dims = list(need.dims)
    if isinstance(dim, int) and dims:
        dims[_norm_dim(dim, len(shape))] = None
    return [DistSpec(tuple(dims), need.partial)] * len(_out_vals(node)), \
        [need]


def _fit(dims, shape, sizes) -> tuple:
    """``dims`` with each dimension's axes cut back to those whose product
    divides its size (major first)."""
    out = []
    for d, n in zip(dims, shape):
        kept, prod = [], 1
        for a in _ax(d):
            if n % (prod * sizes.get(a, 1)):
                break
            kept.append(a)
            prod *= sizes.get(a, 1)
        out.append(_ent(kept))
    return tuple(out)


def _replicated_outs(node):
    return [DistSpec.replicated(len(v.shape))
            if isinstance(v, torch.Tensor) else DistSpec(())
            for v in _out_vals(node)]


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

def _mesh_sizes(mesh) -> Optional[Dict[str, int]]:
    if mesh is None:
        return None
    if isinstance(mesh, dict):
        return {k: int(v) for k, v in mesh.items()}
    m = getattr(mesh, "mesh", mesh)          # a ProcessMesh
    return dict(m.shape)


def _norm_in_spec(s, ndim) -> DistSpec:
    if s is None:
        return DistSpec.replicated(ndim)
    dims = tuple(s.dims) + (None,) * (ndim - len(s.dims))
    if len(dims) != ndim:
        raise ValueError(f"spec {s!r} names {len(s.dims)} dims for a "
                         f"{ndim}-dim input")
    return _spec(dims, s.partial)


def _propagate(gm: fx.GraphModule, in_specs, sizes):
    specs: Dict[fx.Node, Any] = {}
    plan: Dict[fx.Node, Any] = {}
    reshards: List[Reshard] = []
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    in_specs = list(in_specs) + [None] * (len(placeholders) - len(in_specs))
    for n, s in zip(placeholders, in_specs):
        specs[n] = _norm_in_spec(s, len(_shape(n)))

    def spec_of(a):
        return specs.get(a) if isinstance(specs.get(a), DistSpec) else \
            DistSpec.replicated(len(_shape(a)))

    for k, node in enumerate(gm.graph.nodes):
        if node.op == "get_attr":
            specs[node] = DistSpec.replicated(len(_shape(node)))
            continue
        if node.op != "call_function":
            continue
        name = _op_name(node)
        if name == "getitem":
            src, i = node.args
            specs[node] = specs[src][i]
            continue
        if _is_inplace(name):
            # capture_graph functionalizes every other in-place node
            raise ValueError(f"the captured graph updates an argument in "
                             f"place ({node.target}); write the function "
                             "without updating its arguments")
        ops = _operands(node)
        ins = [spec_of(a) for a in ops]
        shapes = [_shape(a) for a in ops]
        whole, linear = False, False
        if name in _PRODUCTS:
            outs, need = _rule_product(name, node, ins, shapes)
        elif name == "flash_attention":
            outs, need = _rule_attention(ins)
        elif name in _ELEMENTWISE:
            outs, need = _rule_elementwise(ins, shapes, _shape(node))
            # a sum of partials is the partial of the sums (the executor
            # also wants every operand to carry the same partial); a
            # product with one tensor is linear in it
            linear = (name in ("add", "sub")
                      and all(isinstance(a, fx.Node) for a in node.args)) \
                or (name in ("mul", "div") and len(ops) == 1
                    and node.args[0] is ops[0])
        elif name in ("tril", "triu"):
            outs, need = _rule_tril(ins[0])
        elif name in _UNARY:
            outs, need = [ins[0]], [ins[0]]
        elif name in _REDUCE_SUM or name in _REDUCE_OTHER:
            outs, need = _rule_reduce(name, node, ins[0], shapes[0])
            linear = name in _REDUCE_SUM
        elif name in ("permute", "transpose", "t"):
            s = ins[0]
            nd = len(s.dims)
            if name == "permute":
                perm = [_norm_dim(p, nd) for p in node.args[1]]
            elif name == "transpose":
                a, b = (_norm_dim(d, nd) for d in node.args[1:3])
                perm = list(range(nd))
                perm[a], perm[b] = perm[b], perm[a]
            else:
                perm = list(range(nd))[::-1]
            outs, need = [DistSpec(tuple(s.dims[p] for p in perm),
                                   s.partial)], [s]
        elif name == "expand":
            outs, need = _rule_expand(ins[0], shapes[0], _shape(node))
        elif name == "unsqueeze":
            s = ins[0]
            d = _norm_dim(node.args[1], len(s.dims) + 1)
            dims = list(s.dims)
            dims.insert(d, None)
            outs, need = [DistSpec(tuple(dims), s.partial)], [s]
        elif name == "squeeze":
            s, sh = ins[0], shapes[0]
            out_sh = _shape(node)
            if len(node.args) > 1:
                ds = node.args[1] if isinstance(node.args[1], (list, tuple)) \
                    else [node.args[1]]
                gone = {_norm_dim(d, len(sh)) for d in ds if sh[d] == 1}
            else:
                gone = {i for i, n in enumerate(sh) if n == 1}
            dims = tuple(d for i, d in enumerate(s.dims) if i not in gone)
            if len(dims) != len(out_sh):
                dims = (None,) * len(out_sh)
            outs, need = [DistSpec(dims, s.partial)], [s]
        elif name in _VIEWS:
            outs, need, whole = _rule_view(node, ins[0], sizes)
        elif name in _CUTS:
            outs, need, whole = _rule_cut(name, node, ins[0], shapes[0])
        elif name == "cat":
            outs, need = _rule_cat(node, ins, shapes)
        elif name == "embedding":
            outs, need = _rule_embedding(ins[0], ins[1])
        elif name == "native_layer_norm":
            outs, need = _rule_layer_norm(node, ins, shapes)
        elif name in ("_softmax", "_log_softmax", "softmax", "log_softmax"):
            outs, need = _rule_softmax(node, ins[0], shapes[0])
        elif name in _SCATTER:
            outs, need = _rule_scatter(name, node, ins)
            whole = True
        elif name in _SCANS:
            outs, need = _rule_scan(name, node, ins[0], shapes[0])
            whole = True
        else:
            # unknown ops (factories among them) replicate; a sharded
            # operand flowing in is gathered where the op runs
            outs, need = _replicated_outs(node), [
                DistSpec.replicated(len(sh)) for sh in shapes]
            whole = True
        if name in _LINEAR_LAYOUT:
            linear = True
        for i, (src, dst) in enumerate(zip(ins, need)):
            if _moves(src.dims, dst.dims) or (src.partial - dst.partial):
                reshards.append(Reshard(k, name, i, src, dst,
                                        _nbytes(ops[i])))
        n_out = len(_out_vals(node))
        outs = list(outs)[:n_out] + [DistSpec(())] * (n_out - len(outs))
        outs = [DistSpec(_dedup_axes(o.dims), o.partial) for o in outs]
        if sizes is not None:
            # an axis that does not divide an output dim: run whole and
            # hold that dim whole
            fitted = [DistSpec(_fit(o.dims, v.shape, sizes), o.partial)
                      if isinstance(v, torch.Tensor) else o
                      for o, v in zip(outs, _out_vals(node))]
            if fitted != outs:
                outs, whole = fitted, True
        specs[node] = outs[0] if not isinstance(_val(node), (list, tuple)) \
            else outs
        plan[node] = (name, need, whole, linear)
    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    flat = torch.utils._pytree.tree_leaves(out_node.args[0])
    out_specs = [spec_of(a) if isinstance(a, fx.Node) else DistSpec(())
                 for a in flat]
    return specs, out_specs, reshards, plan


def capture_graph(fn, *example_args) -> fx.GraphModule:
    """The aten-level graph of ``fn`` at the example arguments' shapes
    (``make_fx`` with fake tensors: nothing is computed, and fake example
    tensors hold no memory).  numpy arrays are taken as tensors.  A graph
    with in-place nodes is captured again through
    ``torch.func.functionalize``: each becomes its out-of-place op, with
    the aliases it updated rebuilt, so running the graph never overwrites
    a value (one autograd saved); an update of an argument stays, as a
    ``copy_`` the propagation pass refuses."""
    from torch.fx.experimental.proxy_tensor import make_fx

    args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in example_args]
    gm = make_fx(fn, tracing_mode="fake")(*args)
    if any(n.op == "call_function" and _is_inplace(_op_name(n))
           for n in gm.graph.nodes):
        gm = make_fx(torch.func.functionalize(fn), tracing_mode="fake")(
            *args)
    return gm


def parameters_as_inputs(module: torch.nn.Module):
    """``(fn, names, tensors)``: ``fn(*tensors, *inputs)`` runs ``module``
    on ``inputs`` with its parameters and buffers taken from the leading
    arguments (``torch.func.functional_call``), so a capture sees them as
    graph inputs, in ``names``' order."""
    state = dict(module.named_parameters())
    state.update(module.named_buffers())
    names = list(state)
    tensors = [state[k].detach() for k in names]

    def fn(*args):
        return torch.func.functional_call(
            module, dict(zip(names, args[:len(names)])),
            tuple(args[len(names):]))
    return fn, names, tensors


def propagate_graph(gm: fx.GraphModule, in_specs: Sequence[Optional[DistSpec]],
                    mesh=None) -> PropagationResult:
    """The Completer pass: a :class:`DistSpec` for every node of ``gm``
    from the placeholders' annotations alone (None: replicated).
    ``mesh`` (a ``Mesh``, ``ProcessMesh`` or ``{axis: size}``) gives the
    axes' sizes, which decide how a reshape keeps them
    (:func:`_reshape_dims`)."""
    specs, outs, reshards, plan = _propagate(gm, in_specs,
                                             _mesh_sizes(mesh))
    return PropagationResult(gm, specs, outs, reshards, plan)


# ---------------------------------------------------------------------------
# executor: the graph per mesh position on local blocks
# ---------------------------------------------------------------------------

class HeldBlocks(_mesh.PlacedTensor):
    """A leaf held as one block a mesh position (``at[coords]``), laid
    out by ``sharding``, which the executor reads through calls to its
    owner: ``bind()`` at the first node that reads it gives the blocks to
    read (``{coords: tensor}``; the owner may tie them for the backward,
    or gather them from slices first); ``release()`` after the last node
    that reads it or a view of it; ``again()`` (optional) when a
    gradient first reaches an output of such a node in the backward, so
    the owner can gather what that node saved.  Without an owner's calls
    ``bind()`` gives ``at`` and ``release()`` does nothing."""

    def __init__(self, sharding, shape, dtype, at, bind=None, release=None,
                 again=None):
        at = {tuple(c): t for c, t in at.items()}
        blocks = {}
        for c, t in at.items():
            blocks.setdefault((sharding.block_of(c), t.device), t)
        super().__init__(sharding, shape, dtype, blocks)
        self.at = at
        self._bind, self._release, self.again = bind, release, again

    def bind(self):
        return self._bind() if self._bind is not None else dict(self.at)

    def release(self):
        if self._release is not None:
            self._release()

    def on(self, coords) -> torch.Tensor:
        return self.at[tuple(coords)]


class _Value:
    """A node's value over the mesh: ``blocks[coords]`` each position's
    block, laid out by ``dims``, with a pending sum over ``partial``."""

    __slots__ = ("blocks", "dims", "partial", "shape", "dtype")

    def __init__(self, blocks, dims, partial, shape, dtype):
        self.blocks, self.dims = blocks, tuple(dims)
        self.partial, self.shape, self.dtype = frozenset(partial), \
            tuple(shape), dtype


class _Executor:
    def __init__(self, mesh: _mesh.Mesh, result: PropagationResult):
        self.mesh = mesh
        self.result = result
        self.coords = list(np.ndindex(*mesh.devices.shape))
        self.names = mesh.axis_names
        self.sizes = mesh.shape

    def device(self, c):
        return self.mesh.devices[c]

    def sharding(self, dims):
        return _mesh.NamedSharding(self.mesh, tuple(_ax(d) for d in dims))

    # -- layouts --------------------------------------------------------
    def materialize(self, v: _Value) -> _Value:
        """The pending sum over ``v.partial`` done: each group of
        positions that differ only along those axes sums its blocks (in
        mesh order, on each device of the group)."""
        if not v.partial:
            return v
        ks = [self.names.index(a) for a in v.partial]
        groups: Dict[tuple, list] = {}
        for c in self.coords:
            key = tuple(0 if i in ks else x for i, x in enumerate(c))
            groups.setdefault(key, []).append(c)
        blocks = {}
        for members in groups.values():
            sums = reduce_sum([v.blocks[c] for c in members],
                              [self.device(c) for c in members])
            for c in members:
                blocks[c] = sums[self.device(c)]
        return _Value(blocks, v.dims, (), v.shape, v.dtype)

    def whole_on(self, v: _Value):
        """{device: the whole tensor there} (partial summed first)."""
        v = self.materialize(v)
        sh = self.sharding(v.dims)
        blocks = {}
        for c in self.coords:
            blocks.setdefault((sh.block_of(c), self.device(c)), v.blocks[c])
        placed = _mesh.PlacedTensor(sh, v.shape, v.dtype, blocks)
        return {self.device(c): placed.gather(self.device(c))
                for c in self.coords}

    def cut(self, whole: Dict[Any, torch.Tensor], dims, shape):
        """Each position's block of the whole tensors by ``dims``."""
        sh = self.sharding(dims)
        cuts = sh.cuts(shape)
        cache, blocks = {}, {}
        for c in self.coords:
            idx, dev = sh.block_of(c), self.device(c)
            if (idx, dev) not in cache:
                t = whole[dev]
                for k, (i, n) in enumerate(zip(idx, cuts)):
                    if n > 1:
                        size = shape[k] // n
                        t = t.narrow(k, i * size, size)
                cache[(idx, dev)] = t
            blocks[c] = cache[(idx, dev)]
        return blocks

    def conform(self, v: _Value, need: DistSpec, keep_partial: bool
                ) -> _Value:
        """``v`` laid out by ``need``'s dims: unchanged, cut further
        locally, or gathered and cut again."""
        if v.partial and not keep_partial:
            v = self.materialize(v)
        dims = tuple(need.dims)
        if dims == v.dims:
            return v
        if not _moves(v.dims, dims):
            sh = self.sharding(dims)
            cuts = sh.cuts(v.shape)
            blocks = {}
            for c in self.coords:
                t = v.blocks[c]
                idx = sh.block_of(c)
                for k, d in enumerate(dims):
                    if d is not None and v.dims[k] is None and cuts[k] > 1:
                        size = v.shape[k] // cuts[k]
                        t = t.narrow(k, idx[k] * size, size)
                blocks[c] = t
            return _Value(blocks, dims, v.partial, v.shape, v.dtype)
        v = self.materialize(v)
        return _Value(self.cut(self.whole_on(v), dims, v.shape), dims, (),
                      v.shape, v.dtype)

    def local(self, dims, shape):
        """``shape`` as a position's block of a tensor cut by ``dims``."""
        return [n // math.prod(self.sizes[a] for a in _ax(d))
                for n, d in zip(shape, dims)]

    # -- nodes ----------------------------------------------------------
    def run(self, args):
        gm = self.result.graph
        specs, plan = self.result.var_specs, self.result.plan
        env: Dict[fx.Node, Any] = {}
        placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
        held = {}
        for n, a in zip(placeholders, args):
            if isinstance(a, HeldBlocks):
                self.check_held(a, specs[n])
                held[n] = a
            else:
                env[n] = self.place_input(a, specs[n])
        reads, last = self.held_reads(gm, held)
        for node in gm.graph.nodes:
            if node.op == "get_attr":
                t = getattr(gm, node.target)
                env[node] = _Value({c: t.to(self.device(c))
                                    for c in self.coords},
                                   (None,) * t.dim(), (), t.shape, t.dtype)
            elif node.op == "call_function":
                for a in _operands(node):
                    if a in held and a not in env:
                        # bound at the first node that reads it
                        h, s = held[a], specs[a]
                        env[a] = _Value(h.bind(), s.dims, (), h.shape,
                                        h.dtype)
                if node.target is operator.getitem:
                    src, i = node.args
                    env[node] = env[src][i]
                else:
                    env[node] = self.node(node, env, plan[node],
                                          specs[node])
                if node in reads:
                    self.hook_again(env[node], [held[a] for a in reads[node]])
                for a in last.get(node, ()):
                    held[a].release()
        out_node = next(n for n in gm.graph.nodes if n.op == "output")
        return torch.utils._pytree.tree_map(
            lambda a: self.placed(env[a]) if isinstance(a, fx.Node) else a,
            out_node.args[0])

    def check_held(self, h: "HeldBlocks", spec: DistSpec):
        want = tuple(_ax(d) for d in spec.dims)
        have = tuple(h.sharding.spec) + ((),) * (len(want) -
                                               len(h.sharding.spec))
        if have != want or h.sharding.mesh is not self.mesh:
            raise ValueError(f"held input laid out {h.sharding.spec} on "
                             f"{h.sharding.mesh!r}; the pass needs {want} "
                             f"on {self.mesh!r}")

    @staticmethod
    def held_reads(gm, held):
        """``(reads, last)``: the held inputs each node reads, directly or
        through nodes that may alias them (:data:`_ALIASING`), and the
        held inputs whose last such reader each node is."""
        if not held:
            return {}, {}
        alias = {n: {n} for n in held}        # node -> held inputs it may be
        reads: Dict[fx.Node, set] = {}
        for node in gm.graph.nodes:
            if node.op != "call_function":
                continue
            srcs = set().union(*[alias.get(a, set())
                                 for a in _operands(node)])
            if node.target is operator.getitem:
                srcs |= alias.get(node.args[0], set())
            if srcs:
                reads[node] = srcs
                if _op_name(node) in _ALIASING:
                    alias[node] = srcs
        last: Dict[fx.Node, list] = {}
        seen = set()
        for node in reversed(list(reads)):
            new = [a for a in held if a in reads[node] and a not in seen]
            seen.update(new)
            if new:
                last[node] = new
        return {n: sorted(r, key=list(held).index)
                for n, r in reads.items()}, last

    @staticmethod
    def hook_again(value, inputs):
        """In the backward, the first gradient to reach an output of a
        node that read ``inputs`` calls their ``again()`` once, before
        the node's own backward reads what it saved of them.  Positions
        on distinct cards run their backward on threads of their own, so
        every output's hook waits until that call has finished."""
        inputs = [h for h in inputs if h.again is not None]
        if not inputs or not torch.is_grad_enabled():
            return
        done, lock = [], threading.Lock()

        def again(grad):
            with lock:
                if not done:
                    for h in inputs:
                        h.again()
                    done.append(True)
        vals = value if isinstance(value, list) else [value]
        for v in vals:
            if isinstance(v, _Value):
                for t in v.blocks.values():
                    if isinstance(t, torch.Tensor) and t.requires_grad:
                        t.register_hook(again)

    def place_input(self, a, spec: DistSpec) -> _Value:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a)
        if isinstance(a, _mesh.PlacedTensor):
            have = tuple(a.sharding.spec) + ((),) * (
                len(spec.dims) - len(a.sharding.spec))
            if have == tuple(_ax(d) for d in spec.dims) and \
                    a.sharding.mesh is self.mesh:
                return _Value({c: a.on(c) for c in self.coords}, spec.dims,
                              (), a.shape, a.dtype)
            a = a.gather()
        whole = {}
        for c in self.coords:
            d = self.device(c)
            if d not in whole:
                whole[d] = a if a.device == d else a.to(d)
        return _Value(self.cut(whole, spec.dims, tuple(a.shape)), spec.dims,
                      (), a.shape, a.dtype)

    def placed(self, v: _Value):
        v = self.materialize(v)
        sh = self.sharding(v.dims)
        blocks = {}
        for c in self.coords:
            blocks.setdefault((sh.block_of(c), self.device(c)), v.blocks[c])
        return _mesh.PlacedTensor(sh, v.shape, v.dtype, blocks)

    def node(self, node, env, step, spec):
        name, need, whole, linear = step
        ops = _operands(node)
        vals = [env[a] for a in ops]
        out_vals = _out_vals(node)
        out_specs = spec if isinstance(spec, list) else [spec]
        if whole:
            return self.run_whole(node, ops, vals, out_vals, out_specs)
        if name in ("addmm", "baddbmm"):
            return self.run_addmm(node, ops, vals, need, spec)
        if name == "embedding":
            return self.run_embedding(node, ops, vals, spec)
        if name in ("add", "sub", "cat") and \
                len({v.partial for v in vals}) > 1:
            linear = False
        vals = [self.conform(v, n, linear) for v, n in zip(vals, need)]
        partial = frozenset().union(*[v.partial for v in vals]) \
            if linear else frozenset()
        if name in ("mm", "bmm"):
            partial = self.contraction(vals, name)
        args, kwargs, target = node.args, dict(node.kwargs), None
        if name in _VIEWS:
            # a block cut from a whole tensor may not be viewable where the
            # whole was: reshape (a view where one exists)
            target = torch.ops.aten.reshape.default
        if name in _VIEWS or name == "expand":
            shape = list(node.args[1])
            loc = self.local(out_specs[0].dims, _shape(node))
            if name == "expand":
                loc = [-1 if s == -1 else n for s, n in zip(
                    [-1] * (len(loc) - len(shape)) + shape, loc)]
            args = (node.args[0], loc) + tuple(node.args[2:])
        scale = None
        if name in _REDUCE_SUM:
            # each block's sum (or mean, scaled to its share of the
            # count) is pending over the reduced dims' axes
            cut = [_ax(vals[0].dims[k])
                   for k in _reduced(node, len(vals[0].shape))]
            partial = partial | {a for axes in cut for a in axes}
            if name == "mean":
                scale = 1.0 / math.prod(self.sizes[a] for axes in cut
                                        for a in axes)
        blocks, memo = {}, {}
        for c in self.coords:
            local = {a: v.blocks[c] for a, v in zip(ops, vals)}
            key = (self.device(c),) + tuple(id(local[a]) for a in ops)
            if key not in memo:
                memo[key] = self.call(node, args, kwargs, local, c,
                                      target)
                if scale not in (None, 1.0):
                    memo[key] = memo[key] * scale
            blocks[c] = memo[key]
        return self.wrap(blocks, out_vals, out_specs, partial)

    def wrap(self, blocks, out_vals, out_specs, partial):
        if len(out_vals) == 1 and not isinstance(
                next(iter(blocks.values())), (list, tuple)):
            s, v = out_specs[0], out_vals[0]
            return _Value(blocks, s.dims, partial, v.shape, v.dtype)
        return [_Value({c: b[i] for c, b in blocks.items()}, s.dims,
                       partial, v.shape, v.dtype)
                for i, (s, v) in enumerate(zip(out_specs, out_vals))]

    def call(self, node, args, kwargs, local, coords, target=None):
        dev = self.device(coords)
        kw = {k: _substitute(v, local) for k, v in kwargs.items()}
        if "device" in kw:
            kw["device"] = dev
        return (target or node.target)(*_substitute(args, local), **kw)

    def contraction(self, vals, name):
        lhs, rhs = vals
        lc, rc = (1, 0) if name == "mm" else (2, 1)
        a, b = lhs.dims[lc], rhs.dims[rc]
        return frozenset(_ax(a)) if a is not None and a == b else frozenset()

    def run_whole(self, node, ops, vals, out_vals, out_specs):
        wholes = [self.whole_on(v) for v in vals]
        per_dev = {}
        for c in self.coords:
            dev = self.device(c)
            if dev in per_dev:
                continue
            if per_dev and _op_name(node) in _RANDOM:
                # one draw, on the first position's device
                first = next(iter(per_dev.values()))
                per_dev[dev] = torch.utils._pytree.tree_map(
                    lambda t: t.to(dev) if isinstance(t, torch.Tensor)
                    else t, first)
                continue
            local = {a: w[dev] for a, w in zip(ops, wholes)}
            per_dev[dev] = self.call(node, node.args, dict(node.kwargs),
                                     local, c)
        outs = []
        many = isinstance(_val(node), (list, tuple))
        for i, (s, v) in enumerate(zip(out_specs, out_vals)):
            if not isinstance(v, torch.Tensor):
                outs.append(None)
                continue
            w = {d: (o[i] if many else o) for d, o in per_dev.items()}
            outs.append(_Value(self.cut(w, s.dims, tuple(v.shape)), s.dims,
                               (), v.shape, v.dtype))
        return outs if many else outs[0]

    def run_addmm(self, node, ops, vals, need, spec):
        """beta * bias + alpha * (a @ b): the product on blocks, its
        partial summed, then laid out as the output and the bias added."""
        bias, a, b = [self.conform(v, n, False) for v, n in zip(vals, need)]
        mm = torch.mm if _op_name(node) == "addmm" else torch.bmm
        beta = node.kwargs.get("beta", 1)
        alpha = node.kwargs.get("alpha", 1)
        name = "mm" if mm is torch.mm else "bmm"
        partial = self.contraction([a, b], name)
        out_shape = _shape(node)
        prod_dims = _dot(DistSpec(a.dims), DistSpec(b.dims),
                         *(([1], [0], [], []) if name == "mm"
                           else ([2], [1], [0], [0])))[0].dims
        if not partial and tuple(prod_dims) == tuple(spec.dims):
            blocks = {c: node.target(bias.blocks[c], a.blocks[c],
                                     b.blocks[c], beta=beta, alpha=alpha)
                      for c in self.coords}
            return _Value(blocks, spec.dims, (), out_shape, _val(node).dtype)
        prod = _Value({c: mm(a.blocks[c], b.blocks[c]) * alpha
                       if alpha != 1 else mm(a.blocks[c], b.blocks[c])
                       for c in self.coords}, prod_dims, partial, out_shape,
                      _val(node).dtype)
        prod = self.conform(prod, DistSpec(spec.dims), False)
        bias = self.conform(bias, DistSpec(_unaligned(
            spec.dims, bias.shape, out_shape)), False)
        blocks = {c: prod.blocks[c] + (bias.blocks[c] * beta if beta != 1
                                       else bias.blocks[c])
                  for c in self.coords}
        return _Value(blocks, spec.dims, (), out_shape, _val(node).dtype)

    def run_embedding(self, node, ops, vals, spec):
        """A lookup on each position's block of the table: rows cut over
        the vocabulary look up their own ids (others give zeros), a
        pending sum over the rows' axes."""
        w, ids = (self.materialize(v) for v in vals)
        w = self.conform(w, DistSpec((w.dims[0], spec.dims[-1])), False)
        sh = self.sharding(w.dims)
        cuts = sh.cuts(w.shape)
        ids = self.conform(ids, DistSpec(spec.dims[:-1]), False)
        rows = w.shape[0] // cuts[0] if cuts else w.shape[0]
        blocks = {}
        for c in self.coords:
            wt, it = w.blocks[c], ids.blocks[c]
            if cuts and cuts[0] > 1:
                off = sh.block_of(c)[0] * rows
                loc = it - off
                ok = (loc >= 0) & (loc < rows)
                out = torch.nn.functional.embedding(
                    torch.where(ok, loc, torch.zeros_like(loc)), wt)
                blocks[c] = out * ok.unsqueeze(-1).to(out.dtype)
            else:
                blocks[c] = torch.nn.functional.embedding(it, wt)
        partial = frozenset(_ax(w.dims[0]))
        return _Value(blocks, spec.dims, partial, _shape(node),
                      _val(node).dtype)


def apply_propagation(fn, mesh, in_specs: Sequence[Optional[DistSpec]],
                      *example_args, grad: bool = False):
    """A callable that evaluates ``fn`` over ``mesh`` (a ``ProcessMesh``
    or the port's ``Mesh``) as the pass decided (module docstring):
    arguments whole or placed, outputs ``PlacedTensor``s; ``run.
    propagation`` holds the :class:`PropagationResult`.  A mesh of one
    position (or none) runs the plain function.  The run is a forward
    under ``torch.no_grad``; with ``grad=True`` it is recorded by
    autograd, and a ``backward()`` from an output's ``gather()`` reaches
    the arguments."""
    m = getattr(mesh, "mesh", mesh)
    gm = capture_graph(fn, *example_args)
    result = propagate_graph(gm, in_specs, m)
    mode = contextlib.nullcontext if grad else torch.no_grad
    if m is None or m.devices.size <= 1:
        def run(*args):
            with mode():
                return fn(*args)
    else:
        ex = _Executor(m, result)

        def run(*args):
            with mode():
                return ex.run(args)
    run.propagation = result
    return run


# ---------------------------------------------------------------------------
# measured cost model
# ---------------------------------------------------------------------------

def _flops(node) -> float:
    name = _op_name(node)
    if name in _PRODUCTS:
        ops = _operands(node)
        a = ops[1] if name in ("addmm", "baddbmm") else ops[0]
        k = _shape(a)[-1]
        return 2.0 * float(math.prod(_shape(node))) * k
    if name == "flash_attention":
        b, n, s, d = _shape(_operands(node)[0])
        s_k = _shape(_operands(node)[1])[2]
        return 4.0 * b * n * s * s_k * d
    return 0.0


def graph_cost(gm: fx.GraphModule, in_specs=None, mesh=None
               ) -> Dict[str, float]:
    """FLOPs and bytes measured from the captured nodes: products' FLOPs
    from their shapes (the attention node's as its two products, 4 B N S^2
    D), the bytes of every node's outputs, and (when ``in_specs`` is
    given) the reshards' bytes from the propagation pass."""
    flops = 0.0
    bytes_touched = 0.0
    for node in gm.graph.nodes:
        if node.op != "call_function" or node.target is operator.getitem:
            continue
        flops += _flops(node)
        for v in _out_vals(node):
            if isinstance(v, torch.Tensor):
                bytes_touched += float(math.prod(v.shape)) * v.element_size()
    comm_bytes, n_reshard = 0.0, 0
    if in_specs is not None:
        res = propagate_graph(gm, in_specs, mesh)
        n_reshard = len(res.reshards)
        comm_bytes = float(sum(r.bytes for r in res.reshards))
    return {"flops": flops, "bytes": bytes_touched,
            "comm_bytes": comm_bytes, "n_reshards": n_reshard}
