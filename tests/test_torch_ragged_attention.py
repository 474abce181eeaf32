"""Ragged paged attention of the PyTorch port held against the JAX
package: the host plan builder (identical arrays), the plain PyTorch
version (vs ``_xla_ragged_reference`` and the Pallas kernel in interpret
mode), and the wrapper's CPU routing.  The Hopper kernel itself runs only
on the card; ``chip_smoke.py`` holds it against the plain version there.

Tolerances are the JAX test's own (tests/test_serving.py): 5e-6 in fp32
(the same arithmetic in another summation order) and 2e-2 in bf16 (one
bf16 rounding of the output and of the probabilities)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas_kernels import ragged_paged_attention as jra
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as tra

torch.set_num_threads(2)

# the mixed runs of tests/test_serving.py::test_ragged_kernel_parity_interpret
RUNS = [
    (200, 1, np.array([4, 2, 9, 1], np.int32)),    # decode, 2 pages
    (0, 1, np.array([3, 0, 0, 0], np.int32)),      # decode at pos 0
    (120, 16, np.array([7, 5, 8, 6], np.int32)),   # prefill straddling
    (17, 5, np.array([10, 0, 0, 0], np.int32)),    # short prefill tail
]
T_MAX, NB_MAX, WL_MAX, MP = 32, 8, 32, 4
P, H, PS, D = 11, 2, 128, 64


def _tables_lengths(runs, stats, t_max, mp):
    tables = np.zeros((t_max, mp), np.int32)
    lengths = np.zeros((t_max,), np.int32)
    for (base, count, tbl), start in zip(runs, stats["run_starts"]):
        for i in range(count):
            tables[start + i] = tbl
            lengths[start + i] = base + i + 1
    return tables, lengths


@pytest.mark.parametrize("token_block", [8, 16])
@pytest.mark.parametrize("runs", [RUNS, RUNS[::-1], RUNS[2:3]],
                         ids=["mixed", "reversed", "prefill_only"])
def test_plan_builder_matches_jax(runs, token_block):
    kw = dict(token_block=token_block, page_size=PS, t_max=T_MAX,
              nb_max=NB_MAX, wl_max=WL_MAX)
    jplan, jstats = jra.build_ragged_plan(runs, **kw)
    tplan, tstats = tra.build_ragged_plan(runs, **kw)
    assert tra.RAGGED_PLAN_FIELDS == jra.RAGGED_PLAN_FIELDS
    for k in jra.RAGGED_PLAN_FIELDS:
        assert tplan[k].dtype == jplan[k].dtype == np.int32
        np.testing.assert_array_equal(tplan[k], jplan[k], err_msg=k)
    assert tstats == jstats


@pytest.mark.parametrize("bad,match", [
    (dict(runs=[(0, 20, np.array([2, 3], np.int32))], t_max=16), "overflow"),
    (dict(runs=[(0, 10, np.array([2, 3], np.int32))], nb_max=1), "overflow"),
    (dict(runs=[(0, 10, np.array([2, 3], np.int32))], wl_max=1), "overflow"),
    (dict(runs=[(0, 0, np.array([2, 3], np.int32))]), "at least one token"),
    (dict(runs=[]), "empty plan"),
])
def test_plan_builder_guards_match_jax(bad, match):
    kw = dict(token_block=8, page_size=128, t_max=16, nb_max=4, wl_max=8)
    kw.update(bad)
    for mod in (jra, tra):
        with pytest.raises(ValueError, match=match):
            mod.build_ragged_plan(**kw)


@pytest.mark.parametrize("dtype,tol", [("float32", 5e-6),
                                       ("bfloat16", 2e-2)])
def test_plain_matches_jax_reference_and_interpret_kernel(dtype, tol):
    """The plain version against the JAX gather oracle AND the Pallas
    kernel in interpret mode: page-straddling blocks, shuffled pool pages,
    a decode at position 0, fp32 and bf16."""
    rng = np.random.RandomState(0)
    plan_np, stats = tra.build_ragged_plan(
        RUNS, token_block=8, page_size=PS, t_max=T_MAX, nb_max=NB_MAX,
        wl_max=WL_MAX)
    tables, lengths = _tables_lengths(RUNS, stats, T_MAX, MP)
    q = rng.randn(T_MAX, H, D).astype(np.float32)
    kp = rng.randn(P, H, PS, D).astype(np.float32)
    vp = rng.randn(P, H, PS, D).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, kp, vp))
    jplan = tuple(jnp.asarray(plan_np[k]) for k in jra.RAGGED_PLAN_FIELDS)
    ref = np.asarray(jra._xla_ragged_reference(
        jq, jk, jv, jnp.asarray(tables), jnp.asarray(lengths), 0.125),
        np.float32)
    interp = np.asarray(jra.ragged_paged_attention(
        jq, jk, jv, jnp.asarray(tables), jnp.asarray(lengths), jplan,
        sm_scale=0.125, interpret=True), np.float32)
    got = tra.ragged_paged_attention_plain(
        torch.tensor(q).to(tdt), torch.tensor(kp).to(tdt),
        torch.tensor(vp).to(tdt), torch.tensor(tables),
        torch.tensor(lengths), 0.125)
    assert got.dtype == tdt and got.shape == (T_MAX, H, D)
    got = got.float().numpy()
    real = stats["n_tokens"]
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(got[:real], interp[:real], rtol=tol,
                               atol=tol)


def test_plain_zero_length_and_decode_equivalence():
    """Length-0 tokens give zeros, and one token per slot is the paged
    decode reference (``_xla_paged_reference``) of the JAX package."""
    from paddle_tpu.ops.pallas_kernels import paged_attention as jpa

    rng = np.random.RandomState(1)
    q = rng.randn(3, H, D).astype(np.float32)
    kp = rng.randn(7, H, PS, D).astype(np.float32)
    vp = rng.randn(7, H, PS, D).astype(np.float32)
    tbl = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
    lens = np.array([0, 130, 256], np.int32)
    want = np.asarray(jpa._xla_paged_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
        jnp.asarray(lens), 0.125))
    got = tra.ragged_paged_attention_plain(
        torch.tensor(q), torch.tensor(kp), torch.tensor(vp),
        torch.tensor(tbl), torch.tensor(lens), 0.125).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-6, atol=5e-6)
    assert not got[0].any(), "a length-0 token must give zeros"


def test_gather_pages_matches_jax():
    from paddle_tpu.ops.pallas_kernels import paged_attention as jpa

    pool = np.arange(5 * 2 * 4 * 3, dtype=np.float32).reshape(5, 2, 4, 3)
    tbl = np.array([[3, 1], [0, 4]], np.int32)
    want = np.asarray(jpa.gather_pages(jnp.asarray(pool), jnp.asarray(tbl)))
    got = tra.gather_pages(torch.tensor(pool), torch.tensor(tbl)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_runs_plain_and_counts_no_launch(dtype):
    """CPU tensors route to the plain version (q cast to the pool dtype)
    and the launch counter stays where it was."""
    rng = np.random.RandomState(2)
    plan_np, stats = tra.build_ragged_plan(
        RUNS, token_block=tra.TOKEN_BLOCK, page_size=PS, t_max=T_MAX,
        nb_max=NB_MAX, wl_max=WL_MAX)
    tables, lengths = _tables_lengths(RUNS, stats, T_MAX, MP)
    q = torch.tensor(rng.randn(T_MAX, H, D), dtype=torch.float32)
    kp = torch.tensor(rng.randn(P, H, PS, D), dtype=torch.float32).to(dtype)
    vp = torch.tensor(rng.randn(P, H, PS, D), dtype=torch.float32).to(dtype)
    plan = tuple(torch.tensor(plan_np[k]) for k in tra.RAGGED_PLAN_FIELDS)
    tra.ragged_paged_attention.launches = 0
    got = tra.ragged_paged_attention(q, kp, vp, torch.tensor(tables),
                                     torch.tensor(lengths), plan)
    assert tra.ragged_paged_attention.launches == 0
    want = tra.ragged_paged_attention_plain(
        q.to(dtype), kp, vp, torch.tensor(tables), torch.tensor(lengths),
        1.0 / D ** 0.5)
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("page_size,head_dim,token_block,dtype,ok", [
    (128, 128, 16, torch.bfloat16, True),
    (16, 16, 16, torch.float32, True),
    (48, 256, 16, torch.float32, True),
    (128, 192, 16, torch.bfloat16, True),     # head_dim 192
    (128, 128, 8, torch.bfloat16, False),      # not the port's block
    (128, 80, 16, torch.bfloat16, False),      # head_dim not supported
    (256, 128, 16, torch.bfloat16, False),     # page above 128
    (24, 64, 16, torch.bfloat16, False),       # page not a 16-multiple
    (128, 128, 16, torch.float16, False),      # dtype not supported
])
def test_kernel_shape_gate(page_size, head_dim, token_block, dtype, ok):
    reason = tra.kernel_unsupported_reason(page_size, head_dim, token_block,
                                           dtype)
    assert (reason is None) == ok, reason


def _served_plan():
    plan_np, _ = tra.build_ragged_plan(
        RUNS, token_block=tra.TOKEN_BLOCK, page_size=PS, t_max=T_MAX,
        nb_max=NB_MAX, wl_max=WL_MAX)
    return [torch.tensor(plan_np[k]) for k in tra.RAGGED_PLAN_FIELDS]


@pytest.mark.parametrize("break_it,match", [
    (lambda p: p[:-1], "expected 9"),
    (lambda p: [p[0].long()] + p[1:], "blk_tok"),
    (lambda p: p[:2] + [p[2][:-1]] + p[3:], "tok_row"),
    (lambda p: p[:5] + [p[5][:-1]] + p[6:], "wl_page"),
    (lambda p: p[:8] + [torch.zeros(2, dtype=torch.int32)], "n_items"),
    (lambda p: [p[0].t().contiguous().t()] + p[1:], "contiguous"),
])
def test_kernel_plan_check_rejects_what_the_kernel_cannot_take(break_it,
                                                               match):
    """The wrapper's plan check (run before every kernel launch on a new
    plan) on CPU tensors: a well-formed plan passes, each broken one
    raises."""
    plan = _served_plan()
    tra._check_plan(tuple(plan), torch.device("cpu"))
    with pytest.raises(ValueError, match=match):
        tra._check_plan(tuple(break_it(plan)), torch.device("cpu"))


# ---------------------------------------------------------------------------
# the split kernel: its arithmetic in plain PyTorch, the plan layout it
# relies on, and its host pieces
# ---------------------------------------------------------------------------

def _kernel_block_case(seed, dtype):
    """RUNS planned with the kernel's token block (16), a pool whose
    positions no run may see hold NaN (and the same pool with zeros
    there), q, and the JAX results on the clean pool."""
    rng = np.random.RandomState(seed)
    plan_np, stats = tra.build_ragged_plan(
        RUNS, token_block=tra.TOKEN_BLOCK, page_size=PS, t_max=T_MAX,
        nb_max=NB_MAX, wl_max=WL_MAX)
    tables, lengths = _tables_lengths(RUNS, stats, T_MAX, MP)
    q = rng.randn(T_MAX, H, D).astype(np.float32)
    kp = rng.randn(P, H, PS, D).astype(np.float32)
    vp = rng.randn(P, H, PS, D).astype(np.float32)
    seen = np.zeros((P, PS), bool)
    for base, count, tbl in RUNS:
        pos = np.arange(base + count)
        seen[tbl[pos // PS], pos % PS] = True
    unseen = ~seen[:, None, :, None]
    kz, vz = (np.where(unseen, np.float32(0), a) for a in (kp, vp))
    kn, vn = (np.where(unseen, np.float32(np.nan), a) for a in (kp, vp))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, kz, vz))
    jplan = tuple(jnp.asarray(plan_np[k]) for k in tra.RAGGED_PLAN_FIELDS)
    ref = np.asarray(jra._xla_ragged_reference(
        jq, jk, jv, jnp.asarray(tables), jnp.asarray(lengths), 0.125),
        np.float32)
    interp = np.asarray(jra.ragged_paged_attention(
        jq, jk, jv, jnp.asarray(tables), jnp.asarray(lengths), jplan,
        sm_scale=0.125, interpret=True), np.float32)
    plan = tuple(torch.tensor(plan_np[k]) for k in tra.RAGGED_PLAN_FIELDS)
    tdt = getattr(torch, dtype)
    return dict(q=torch.tensor(q).to(tdt), clean=(torch.tensor(kz).to(tdt),
                torch.tensor(vz).to(tdt)), stale=(torch.tensor(kn).to(tdt),
                torch.tensor(vn).to(tdt)), plan=plan, ref=ref, interp=interp,
                real=stats["n_tokens"])


@pytest.mark.parametrize("dtype,tol", [("float32", 5e-6),
                                       ("bfloat16", 2e-2)])
def test_split_merge_plain_matches_jax_reference_and_interpret_kernel(dtype,
                                                                      tol):
    """The ragged kernel's arithmetic (``split_merge_plain``: each block's
    pages cut into splits, partials merged in work-list order) with the
    kernel's own keys per split and with 16 -- many splits, some of them
    with no key a prefill row may see -- against the JAX reference and the
    Pallas kernel in interpret mode: runs straddling page edges, shuffled
    pool pages, a decode at position 0.  A pool holding NaN wherever no run
    may look gives the zero-filled pool's output bit for bit, and the
    padding tokens are zeros.  Tolerances are this file's (5e-6 fp32: the
    same arithmetic in another order; 2e-2 bf16: one rounding of the
    output and of P, against a split's max here)."""
    c = _kernel_block_case(3, dtype)
    for keys in (tra.keys_per_split(D, c["q"].dtype), 16):
        got = tra.split_merge_plain(c["q"], *c["clean"], c["plan"], 0.125,
                                    keys)
        stale = tra.split_merge_plain(c["q"], *c["stale"], c["plan"], 0.125,
                                      keys)
        assert got.dtype == c["q"].dtype and got.shape == (T_MAX, H, D)
        assert torch.equal(stale, got), f"keys {keys}: stale pool"
        got = got.float().numpy()
        real = c["real"]
        assert not got[real:].any(), "padding tokens must be zeros"
        np.testing.assert_allclose(got[:real], c["ref"][:real], rtol=tol,
                                   atol=tol, err_msg=f"keys {keys}")
        np.testing.assert_allclose(got[:real], c["interp"][:real], rtol=tol,
                                   atol=tol, err_msg=f"keys {keys}")


@pytest.mark.parametrize("runs", [RUNS, RUNS[::-1], RUNS[2:3],
                                  [(130, 40, np.array([3, 1, 2, 0],
                                                      np.int32))]],
                         ids=["mixed", "reversed", "prefill_only",
                              "three_blocks_two_pages"])
def test_plan_lists_each_blocks_page_slots_in_order(runs):
    """The kernel finds a block's first split at w - wl_pageslot[w] and
    counts the block's splits from its last position: build_ragged_plan
    lists each block's page slots 0 .. max_pos // page_size, one item
    each, in order and together."""
    plan, stats = tra.build_ragged_plan(
        runs, token_block=tra.TOKEN_BLOCK, page_size=PS, t_max=T_MAX + 16,
        nb_max=NB_MAX, wl_max=WL_MAX)
    n = stats["n_items"]
    for w in range(n):
        blk, ps = plan["wl_blk"][w], plan["wl_pageslot"][w]
        w0 = w - ps
        max_pos = plan["blk_base"][blk] + plan["blk_rows"][blk] - 1
        assert ps <= max_pos // PS
        assert list(plan["wl_pageslot"][w0:w + 1]) == list(range(ps + 1))
        assert (plan["wl_blk"][w0:w0 + max_pos // PS + 1] == blk).all()
    # every real block's items, counted as the kernel counts them
    blocks = [b for b in range(NB_MAX) if plan["blk_rows"][b] > 0]
    counted = sum((plan["blk_base"][b] + plan["blk_rows"][b] - 1) // PS + 1
                  for b in blocks)
    assert counted == n


def test_split_host_pieces_and_what_they_refuse():
    """The wrapper's keys per split, splits per page and workspace, and
    ``ValueError`` for what the kernel cannot take."""
    assert tra.keys_per_split(128, torch.bfloat16) == 64
    assert tra.keys_per_split(64, torch.bfloat16) == 128
    assert tra.keys_per_split(192, torch.bfloat16) == 32
    assert tra.keys_per_split(128, torch.float32) == 32
    assert tra.keys_per_split(128, torch.int8) == 64
    assert tra.splits_per_page(128, 128, torch.bfloat16) == 2
    assert tra.splits_per_page(48, 192, torch.bfloat16) == 2
    assert tra.splits_per_page(16, 64, torch.bfloat16) == 1
    assert tra.workspace_shapes(64, 16, 16, 128, 128, torch.bfloat16) == {
        "partials": (64 * 2 * 16 * 16 * 130,), "tickets": (16 * 16,)}
    with pytest.raises(ValueError, match="head_dim=80"):
        tra.keys_per_split(80, torch.bfloat16)
    with pytest.raises(ValueError, match="float16"):
        tra.keys_per_split(128, torch.float16)
    with pytest.raises(ValueError, match="page_size=24"):
        tra.splits_per_page(24, 128, torch.bfloat16)
    for bad in (dict(wl_max=40000), dict(wl_max=0), dict(nb_max=0),
                dict(heads=0), dict(heads=70000)):
        kw = dict(wl_max=64, nb_max=16, heads=16, page_size=128,
                  head_dim=128, dtype=torch.bfloat16)
        kw.update(bad)
        with pytest.raises(ValueError, match="wl_max="):
            tra.workspace_shapes(**kw)
