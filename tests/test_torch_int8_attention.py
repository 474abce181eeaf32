"""The int8 variants of the port's ragged, paged and decode attention held
against the JAX package on the CPU.

The same numpy inputs -- int8 pages or caches with fp32 scales, fp32
queries -- go through the port's plain versions and through the JAX
package's XLA references (``_xla_ragged_reference``,
``_xla_paged_reference``, ``_xla_decode_reference``) and Pallas kernels in
interpret mode (``_ragged_pallas`` through the ragged wrapper,
``_paged_pallas``, ``_decode_pallas``, each with ``k_scale``/``v_scale``),
as the JAX package's own tests run them.  Tolerance 5e-6 absolute and
1e-6 relative: both sides dequantize with the same fp32 product
(float(int8) x scale) and keep P in fp32, and sum in another order over at
most 512 keys; dequantized values reach 127 x 0.035 = 4.4, whose fp32 ulp
is 4.8e-7, so 5e-6 is about ten ulps of the largest value.

The Hopper kernels run only on the card, where ``chip_smoke.py`` phase 12
holds them against these plain versions.  Off the CPU a wrapper launches
its kernel or raises: meta tensors stand in for the card's tensors in the
refusal tests."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas_kernels import decode_attention as jda
from paddle_tpu.ops.pallas_kernels import paged_attention as jpa
from paddle_tpu.ops.pallas_kernels import ragged_paged_attention as jra

from paddle_tpu_torch.ops.kernels import decode_attention as tda
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as tra

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=5e-6)
SCALE = 0.125          # 1 / sqrt(64)


def _int8(rng, *shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


def _scales(rng, *shape):
    """Scales of an absmax-quantized N(0, 1) page or row: ~3-4 / 127."""
    return (rng.rand(*shape) * 0.03 + 0.005).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _launches():
    return (tda.decode_attention.launches, tpa.paged_attention.launches,
            tra.ragged_paged_attention.launches)


# ---------------------------------------------------------------------------
# ragged
# ---------------------------------------------------------------------------

# the mixed runs of tests/test_serving.py::test_ragged_kernel_parity_interpret
RUNS = [
    (200, 1, np.array([4, 2, 9, 1], np.int32)),    # decode, 2 pages
    (0, 1, np.array([3, 0, 0, 0], np.int32)),      # decode at pos 0
    (120, 16, np.array([7, 5, 8, 6], np.int32)),   # prefill straddling
    (17, 5, np.array([10, 0, 0, 0], np.int32)),    # short prefill tail
]
T_MAX, NB_MAX, WL_MAX, MP = 32, 8, 32, 4
P, H, PS, D = 11, 2, 128, 64


@pytest.mark.parametrize("token_block", [8, 16])
def test_ragged_int8_plain_matches_jax_reference_and_pallas_kernel(
        token_block):
    rng = np.random.RandomState(token_block)
    plan_np, stats = tra.build_ragged_plan(
        RUNS, token_block=token_block, page_size=PS, t_max=T_MAX,
        nb_max=NB_MAX, wl_max=WL_MAX)
    tables = np.zeros((T_MAX, MP), np.int32)
    lengths = np.zeros((T_MAX,), np.int32)
    for (base, count, tbl), start in zip(RUNS, stats["run_starts"]):
        tables[start:start + count] = tbl
        lengths[start:start + count] = base + np.arange(count) + 1
    q = rng.randn(T_MAX, H, D).astype(np.float32)
    kp, vp = _int8(rng, P, H, PS, D), _int8(rng, P, H, PS, D)
    ks, vs = _scales(rng, P, H), _scales(rng, P, H)
    j = [jnp.asarray(a) for a in (q, kp, vp, tables, lengths)]
    jsc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    jplan = tuple(jnp.asarray(plan_np[k]) for k in jra.RAGGED_PLAN_FIELDS)
    ref = np.asarray(jra._xla_ragged_reference(*j, SCALE, **jsc))
    interp = np.asarray(jra.ragged_paged_attention(
        *j, jplan, sm_scale=SCALE, interpret=True, **jsc))
    before = _launches()
    got = tra.ragged_paged_attention(
        _t(q), _t(kp), _t(vp), _t(tables), _t(lengths),
        tuple(_t(plan_np[k]) for k in tra.RAGGED_PLAN_FIELDS),
        sm_scale=SCALE, k_scale=_t(ks), v_scale=_t(vs))
    assert _launches() == before
    assert got.dtype == torch.float32 and got.shape == (T_MAX, H, D)
    real = stats["n_tokens"]
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_allclose(got.numpy()[:real], interp[:real], **TOL)
    # a bf16 q joins the fp32 dequantization too (the reference casts it)
    got_bf = tra.ragged_paged_attention(
        _t(q).bfloat16(), _t(kp), _t(vp), _t(tables), _t(lengths),
        tuple(_t(plan_np[k]) for k in tra.RAGGED_PLAN_FIELDS),
        sm_scale=SCALE, k_scale=_t(ks), v_scale=_t(vs))
    ref_bf = np.asarray(jra._xla_ragged_reference(
        jnp.asarray(q, jnp.bfloat16).astype(jnp.float32), *j[1:], SCALE,
        **jsc))
    assert got_bf.dtype == torch.float32
    np.testing.assert_allclose(got_bf.numpy(), ref_bf, **TOL)


# ---------------------------------------------------------------------------
# paged
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lengths", [(0, 1, 40, 16), (17, 64, 33, 2)])
def test_paged_int8_plain_matches_jax_reference_and_pallas_kernel(lengths):
    rng = np.random.RandomState(sum(lengths))
    s, h, ps, d, max_pages = 4, 2, 16, 64, 4
    num_pages = s * max_pages + 1
    tables = rng.permutation(np.arange(1, num_pages)).astype(
        np.int32).reshape(s, max_pages)
    lens = np.array(lengths, np.int32)
    q = rng.randn(s, h, d).astype(np.float32)
    kp, vp = _int8(rng, num_pages, h, ps, d), _int8(rng, num_pages, h, ps, d)
    ks, vs = _scales(rng, num_pages, h), _scales(rng, num_pages, h)
    j = [jnp.asarray(a) for a in (q, kp, vp, tables, lens)]
    jsc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    ref = np.asarray(jpa._xla_paged_reference(*j, SCALE, **jsc))
    q8 = jnp.broadcast_to(j[0].reshape(s * h, 1, d), (s * h, 8, d))
    pallas = np.asarray(jpa._paged_pallas(
        q8, *j[1:], SCALE, interpret=True, **jsc))[:, 0].reshape(s, h, d)
    got = tpa.paged_attention(_t(q), _t(kp), _t(vp), _t(tables), _t(lens),
                              sm_scale=SCALE, k_scale=_t(ks), v_scale=_t(vs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    assert not got.numpy()[lens == 0].any()


def test_gather_pages_dequantizes_as_jax():
    rng = np.random.RandomState(5)
    pool, sc = _int8(rng, 9, 2, 16, 8), _scales(rng, 9, 2)
    tables = rng.randint(0, 9, (3, 4)).astype(np.int32)
    want = np.asarray(jpa.gather_pages(jnp.asarray(pool), jnp.asarray(tables),
                                       jnp.asarray(sc)))
    got = tpa.gather_pages(_t(pool), _t(tables), _t(sc))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# decode over a contiguous cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", [1, 100, 129, 256])
def test_decode_int8_plain_matches_jax_reference_and_pallas_kernel(length):
    rng = np.random.RandomState(length)
    b, h, max_seq, d = 2, 2, 256, 64
    q = rng.randn(b, h, d).astype(np.float32)
    kc, vc = _int8(rng, b, h, max_seq, d), _int8(rng, b, h, max_seq, d)
    ks, vs = _scales(rng, b, h), _scales(rng, b, h)
    jq, jk, jv = (jnp.asarray(a) for a in (q, kc, vc))
    jsc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    ref = np.asarray(jda._xla_decode_reference(jq, jk, jv, jnp.int32(length),
                                               SCALE, **jsc))
    q8 = jnp.broadcast_to(jq.reshape(b * h, 1, d), (b * h, 8, d))
    pallas = np.asarray(jda._decode_pallas(
        q8, jk.reshape(b * h, max_seq, d), jv.reshape(b * h, max_seq, d),
        jnp.int32(length), SCALE, interpret=True,
        **jsc))[:, 0].reshape(b, h, d)
    got = tda.decode_attention(_t(q), _t(kc), _t(vc), length, sm_scale=SCALE,
                               k_scale=_t(ks), v_scale=_t(vs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)


# ---------------------------------------------------------------------------
# what the kernels take, and what every wrapper refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim", [16, 64, 128, 192, 256])
def test_kernels_take_int8_pools(head_dim):
    assert tda.kernel_unsupported_reason(head_dim, torch.int8) is None
    assert tpa.kernel_unsupported_reason(head_dim, torch.int8) is None
    assert tra.kernel_unsupported_reason(16, head_dim, tra.TOKEN_BLOCK,
                                         torch.int8) is None


def _meta(*shape, dt):
    return torch.empty(shape, dtype=dt, device="meta")


def _calls(pool_dtype, scales):
    """One call of each wrapper over a meta pool or cache of
    ``pool_dtype``, with ``scales`` (None or fp32 meta tensors)."""
    i32 = torch.int32
    d = 16
    sc = {} if scales is None else dict(k_scale=scales(5, 4),
                                        v_scale=scales(5, 4))
    dc = {} if scales is None else dict(k_scale=scales(2, 4),
                                        v_scale=scales(2, 4))
    pool = (_meta(5, 4, 16, d, dt=pool_dtype), _meta(5, 4, 16, d,
                                                     dt=pool_dtype))
    plan = tuple(_meta(*shape, dt=i32) for shape in (
        (2, 16), (2,), (2,), (2,), (2,), (4,), (4,), (4,), (1,)))
    return {
        "ragged": lambda: tra.ragged_paged_attention(
            _meta(2, 4, d, dt=torch.float32), *pool, _meta(2, 3, dt=i32),
            _meta(2, dt=i32), plan, **sc),
        "paged": lambda: tpa.paged_attention(
            _meta(2, 4, d, dt=torch.float32), *pool, _meta(2, 3, dt=i32),
            _meta(2, dt=i32), **sc),
        "decode": lambda: tda.decode_attention(
            _meta(2, 4, d, dt=torch.float32),
            _meta(2, 4, 32, d, dt=pool_dtype),
            _meta(2, 4, 32, d, dt=pool_dtype), 5, **dc),
    }


@pytest.mark.parametrize("kernel", ["ragged", "paged", "decode"])
def test_int8_pool_without_scales_raises(kernel):
    """An int8 pool or cache with no scales raises ``ValueError`` before
    anything is built or launched."""
    before = _launches()
    with pytest.raises(ValueError, match="needs both k_scale and v_scale"):
        _calls(torch.int8, None)[kernel]()
    assert _launches() == before


@pytest.mark.parametrize("kernel", ["ragged", "paged", "decode"])
def test_scales_with_a_float_pool_raise(kernel):
    before = _launches()
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="scales belong to an int8"):
            _calls(dt, lambda *s: _meta(*s, dt=torch.float32))[kernel]()
    assert _launches() == before


@pytest.mark.parametrize("kernel", ["ragged", "paged", "decode"])
def test_int8_scales_of_the_wrong_dtype_raise(kernel):
    with pytest.raises(ValueError, match="expected float32"):
        _calls(torch.int8, lambda *s: _meta(*s, dt=torch.bfloat16))[kernel]()


def test_an_int8_pool_without_scales_raises_on_the_cpu_too():
    """The check does not depend on the device: the plain version would
    otherwise attend over raw int8 values."""
    kp = torch.zeros((5, 4, 16, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="needs both"):
        tpa.paged_attention(torch.zeros(2, 4, 16), kp, kp,
                            torch.zeros(2, 3, dtype=torch.int32),
                            torch.ones(2, dtype=torch.int32),
                            k_scale=torch.zeros(5, 4))


# ---------------------------------------------------------------------------
# the split kernels' arithmetic over int8 pools and caches
# ---------------------------------------------------------------------------

def test_decode_int8_split_merge_plain_matches_jax():
    """``split_merge_plain`` over an int8 cache (dequantized as it is
    read, P unrounded), with the kernel's keys per split and with 16,
    against the Pallas kernel in interpret mode at lengths around the
    split boundaries (0 gives zeros, the Pallas kernel's l == 0 guard) and
    the XLA reference at every length but 0; this file's TOL."""
    rng = np.random.RandomState(21)
    b, h, max_seq, d = 2, 2, 256, 64
    q = rng.randn(b, h, d).astype(np.float32)
    kc, vc = _int8(rng, b, h, max_seq, d), _int8(rng, b, h, max_seq, d)
    ks, vs = _scales(rng, b, h), _scales(rng, b, h)
    jq, jk, jv = (jnp.asarray(a) for a in (q, kc, vc))
    jsc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    q8 = jnp.broadcast_to(jq.reshape(b * h, 1, d), (b * h, 8, d))
    kernel_keys = tda.keys_per_split(d, torch.int8)
    for n in (0, 1, kernel_keys - 1, kernel_keys, kernel_keys + 1, max_seq):
        pallas = np.asarray(jda._decode_pallas(
            q8, jk.reshape(b * h, max_seq, d), jv.reshape(b * h, max_seq, d),
            jnp.int32(n), SCALE, interpret=True,
            **jsc))[:, 0].reshape(b, h, d)
        for keys in (kernel_keys, 16):
            got = tda.split_merge_plain(_t(q), _t(kc), _t(vc), n, SCALE,
                                        keys, _t(ks), _t(vs))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), pallas, **TOL)
            if n:
                ref = np.asarray(jda._xla_decode_reference(
                    jq, jk, jv, jnp.int32(n), SCALE, **jsc))
                np.testing.assert_allclose(got.numpy(), ref, **TOL)
            else:
                assert not got.numpy().any()


def test_ragged_int8_split_merge_plain_matches_jax():
    """``split_merge_plain`` over int8 pools, with the kernel's keys per
    split and with 16, against the JAX reference and the Pallas kernel in
    interpret mode (this file's runs, the kernel's token block); NaN
    scales on the pages no run owns and 127 at every position no run may
    see leave the output unchanged bit for bit; this file's TOL."""
    rng = np.random.RandomState(22)
    plan_np, stats = tra.build_ragged_plan(
        RUNS, token_block=tra.TOKEN_BLOCK, page_size=PS, t_max=T_MAX,
        nb_max=NB_MAX, wl_max=WL_MAX)
    tables = np.zeros((T_MAX, MP), np.int32)
    lengths = np.zeros((T_MAX,), np.int32)
    for (base, count, tbl), start in zip(RUNS, stats["run_starts"]):
        tables[start:start + count] = tbl
        lengths[start:start + count] = base + np.arange(count) + 1
    q = rng.randn(T_MAX, H, D).astype(np.float32)
    kp, vp = _int8(rng, P, H, PS, D), _int8(rng, P, H, PS, D)
    ks, vs = _scales(rng, P, H), _scales(rng, P, H)
    j = [jnp.asarray(a) for a in (q, kp, vp, tables, lengths)]
    jsc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    jplan = tuple(jnp.asarray(plan_np[k]) for k in jra.RAGGED_PLAN_FIELDS)
    ref = np.asarray(jra._xla_ragged_reference(*j, SCALE, **jsc))
    interp = np.asarray(jra.ragged_paged_attention(
        *j, jplan, sm_scale=SCALE, interpret=True, **jsc))
    seen = np.zeros((P, PS), bool)
    for base, count, tbl in RUNS:
        pos = np.arange(base + count)
        seen[tbl[pos // PS], pos % PS] = True
    unseen = ~seen[:, None, :, None]
    kf, vf = (np.where(unseen, np.int8(127), a) for a in (kp, vp))
    page_unseen = ~seen.any(axis=1)[:, None]
    ksf, vsf = (np.where(page_unseen, np.float32(np.nan), a)
                for a in (ks, vs))
    plan = tuple(_t(plan_np[k]) for k in tra.RAGGED_PLAN_FIELDS)
    real = stats["n_tokens"]
    for keys in (tra.keys_per_split(D, torch.int8), 16):
        got = tra.split_merge_plain(_t(q), _t(kp), _t(vp), plan, SCALE, keys,
                                    _t(ks), _t(vs))
        stale = tra.split_merge_plain(_t(q), _t(kf), _t(vf), plan, SCALE,
                                      keys, _t(ksf), _t(vsf))
        assert got.dtype == torch.float32
        assert torch.equal(stale, got), f"keys {keys}: stale values"
        assert not got[real:].any()
        np.testing.assert_allclose(got.numpy()[:real], ref[:real], **TOL)
        np.testing.assert_allclose(got.numpy()[:real], interp[:real], **TOL)


@pytest.mark.parametrize("page,max_pages", [(16, 17), (128, 3)])
def test_paged_int8_split_merge_plain_matches_jax(page, max_pages):
    """``paged_attention.split_merge_plain`` over int8 pools (dequantized
    as they are read with each page's scales, P unrounded), with the
    kernel's keys per split and with 16, one slot a length -- 0, 1, a key
    either side of the first split boundary, one past the second, a page
    edge and one past it, the full table -- against the XLA reference and
    the Pallas kernel in interpret mode; NaN scales on the pages no slot
    sees, 127 at every position no slot may see and table entries past
    each slot's last live page naming no pool page leave the output
    unchanged bit for bit; this file's TOL."""
    keys = tpa.keys_per_split(D, torch.int8)
    full = max_pages * page
    lengths = sorted({min(n, full) for n in (0, 1, keys - 1, keys, keys + 1,
                                             2 * keys + 1, page, page + 1,
                                             full)})
    rng = np.random.RandomState(23 + page)
    s, num_pages = len(lengths), len(lengths) * max_pages + 1
    tables = rng.permutation(np.arange(1, num_pages)).astype(
        np.int32)[:s * max_pages].reshape(s, max_pages)
    lens = np.array(lengths, np.int32)
    q = rng.randn(s, H, D).astype(np.float32)
    kp, vp = _int8(rng, num_pages, H, page, D), _int8(rng, num_pages, H, page,
                                                      D)
    ks, vs = _scales(rng, num_pages, H), _scales(rng, num_pages, H)
    j = [jnp.asarray(a) for a in (q, kp, vp, tables, lens)]
    jsc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    ref = np.asarray(jpa._xla_paged_reference(*j, SCALE, **jsc))
    q8 = jnp.broadcast_to(j[0].reshape(s * H, 1, D), (s * H, 8, D))
    pallas = np.asarray(jpa._paged_pallas(
        q8, *j[1:], SCALE, interpret=True, **jsc))[:, 0].reshape(s, H, D)
    seen = np.zeros((num_pages, page), bool)
    poisoned = tables.copy()
    for i, n in enumerate(lengths):
        pos = np.arange(n)
        seen[tables[i, pos // page], pos % page] = True
        poisoned[i, -(-n // page):] = 10 ** 6
    kf, vf = (np.where(seen[:, None, :, None], a, np.int8(127))
              for a in (kp, vp))
    page_unseen = ~seen.any(axis=1)[:, None]
    ksf, vsf = (np.where(page_unseen, np.float32(np.nan), a)
                for a in (ks, vs))
    for k in (keys, 16):
        got = tpa.split_merge_plain(_t(q), _t(kp), _t(vp), _t(tables),
                                    _t(lens), SCALE, k, _t(ks), _t(vs))
        stale = tpa.split_merge_plain(_t(q), _t(kf), _t(vf), _t(poisoned),
                                      _t(lens), SCALE, k, _t(ksf), _t(vsf))
        assert got.dtype == torch.float32
        assert torch.equal(stale, got), f"keys {k}: stale values"
        assert not got.numpy()[lens == 0].any()
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
        np.testing.assert_allclose(got.numpy(), pallas, **TOL)
