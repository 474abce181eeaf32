"""The port's decode-attention and paged-attention plain versions, its
``gather_pages`` and its flash forward at ragged sequence lengths, held
against the JAX package on the CPU.

The same numpy inputs go through the port's plain version and the JAX
package's XLA reference (``_xla_decode_reference``,
``_xla_paged_reference``, ``_xla_reference_bnsd``) and its Pallas kernels
(``_decode_pallas``, ``_paged_pallas``) run in interpret mode, as the JAX
package's own tests run them.  Tolerances: fp32 within 5e-6 (the same
arithmetic summed in another order over at most 512 keys); bf16 within
1e-2 absolute and relative: the plain version and the XLA reference both
round the normalised probabilities and the output to bf16, the Pallas
kernels round P against the running max instead, and a bf16 ulp is 2^-8
relative.

The kernels themselves (CUDA) run only on the card, where ``chip_smoke.py``
holds them against these plain versions.  Off the CPU a wrapper launches
its kernel or raises: meta tensors stand in for the card's here."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas_kernels import decode_attention as jda
from paddle_tpu.ops.pallas_kernels import flash_attention as jfa
from paddle_tpu.ops.pallas_kernels import paged_attention as jpa

from paddle_tpu_torch.ops.kernels import decode_attention as tda
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as tra

torch.set_num_threads(2)

TOL = {"float32": dict(rtol=5e-6, atol=5e-6),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}
SCALE = 0.125          # 1 / sqrt(64)


def _f32(x):
    return np.asarray(x, np.float32)


def _port(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _launches():
    return (tda.decode_attention.launches, tpa.paged_attention.launches,
            tfa.flash_attention_fwd.launches)


# ---------------------------------------------------------------------------
# decode attention over a contiguous cache
# ---------------------------------------------------------------------------

B, H, MAX_SEQ, D = 2, 2, 256, 64


def _decode_inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, D).astype(np.float32),
            rng.randn(B, H, MAX_SEQ, D).astype(np.float32),
            rng.randn(B, H, MAX_SEQ, D).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [1, 100, 128, 129, MAX_SEQ])
def test_decode_plain_matches_jax_reference_and_pallas_kernel(dtype, length):
    q, k, v = _decode_inputs(seed=length)
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    ref = _f32(jda._xla_decode_reference(jq, jk, jv, jnp.int32(length),
                                         SCALE))
    q8 = jnp.broadcast_to(jq.reshape(B * H, 1, D), (B * H, 8, D))
    pallas = _f32(jda._decode_pallas(
        q8, jk.reshape(B * H, MAX_SEQ, D), jv.reshape(B * H, MAX_SEQ, D),
        jnp.int32(length), SCALE, interpret=True)[:, 0].reshape(B, H, D))
    got = tda.decode_attention_plain(_port(q, dtype), _port(k, dtype),
                                     _port(v, dtype), length, SCALE)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, H, D)
    got = got.float().numpy()
    np.testing.assert_allclose(got, ref, err_msg="vs reference",
                               **TOL[dtype])
    np.testing.assert_allclose(got, pallas, err_msg="vs Pallas",
                               **TOL[dtype])


def test_decode_wrapper_on_the_cpu_is_the_plain_version():
    """The wrapper casts q to the cache dtype, takes the length as an int
    or a 0-d tensor, runs the plain version and counts no launch."""
    q, k, v = (torch.from_numpy(a) for a in _decode_inputs(seed=3))
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    before = _launches()
    got = tda.decode_attention(q, kb, vb, 77)
    got_t = tda.decode_attention(q, kb, vb,
                                 torch.tensor(77, dtype=torch.int32))
    assert _launches() == before
    want = tda.decode_attention_plain(q.to(torch.bfloat16), kb, vb, 77,
                                      1.0 / np.sqrt(D))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want) and torch.equal(got_t, want)


def test_decode_plain_reads_the_first_length_positions_only_by_weight():
    """Positions past ``length`` weigh exactly 0 in the plain version: any
    finite value there leaves the output unchanged."""
    q, k, v = (torch.from_numpy(a) for a in _decode_inputs(seed=4))
    want = tda.decode_attention_plain(q, k, v, 50, SCALE)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 50:] = 1e3
    v2[:, :, 50:] = -7.0
    assert torch.equal(tda.decode_attention_plain(q, k2, v2, 50, SCALE), want)


# ---------------------------------------------------------------------------
# paged attention over the page pool
# ---------------------------------------------------------------------------

P, PS, MP = 9, 128, 4
# shuffled pool pages (page 0 is the null page)
TABLES = np.array([[5, 2, 8, 1], [3, 7, 0, 0], [6, 4, 0, 0]], np.int32)


def _paged_inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(3, H, D).astype(np.float32),
            rng.randn(P, H, PS, D).astype(np.float32),
            rng.randn(P, H, PS, D).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths", [(0, 1, 127), (128, 129, 256),
                                     (512, 0, 200)])
def test_paged_plain_matches_jax_reference_and_pallas_kernel(dtype, lengths):
    """Lengths at a page edge, one past it, a full table, and length-0
    slots, which give zeros."""
    q, kp, vp = _paged_inputs(seed=sum(lengths))
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, kp, vp))
    jt, jl = jnp.asarray(TABLES), jnp.asarray(np.array(lengths, np.int32))
    ref = _f32(jpa._xla_paged_reference(jq, jk, jv, jt, jl, SCALE))
    q8 = jnp.broadcast_to(jq.reshape(3 * H, 1, D), (3 * H, 8, D))
    pallas = _f32(jpa._paged_pallas(q8, jk, jv, jt, jl, SCALE,
                                    interpret=True)[:, 0].reshape(3, H, D))
    got = tpa.paged_attention_plain(
        _port(q, dtype), _port(kp, dtype), _port(vp, dtype),
        torch.from_numpy(TABLES), torch.tensor(lengths, dtype=torch.int32),
        SCALE)
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, H, D)
    got = got.float().numpy()
    np.testing.assert_allclose(got, ref, err_msg="vs reference",
                               **TOL[dtype])
    np.testing.assert_allclose(got, pallas, err_msg="vs Pallas",
                               **TOL[dtype])
    for i, n in enumerate(lengths):
        if n == 0:
            assert not got[i].any(), "a length-0 slot must give zeros"


def test_paged_wrapper_on_the_cpu_is_the_plain_version():
    q, kp, vp = (torch.from_numpy(a) for a in _paged_inputs(seed=7))
    tables = torch.from_numpy(TABLES)
    lengths = torch.tensor([300, 5, 0], dtype=torch.int32)
    before = _launches()
    got = tpa.paged_attention(q, kp, vp, tables, lengths)
    assert _launches() == before
    want = tpa.paged_attention_plain(q, kp, vp, tables, lengths,
                                     1.0 / np.sqrt(D))
    assert torch.equal(got, want)


def test_paged_plain_equals_the_decode_plain_on_a_contiguous_table():
    """Pages laid out in order are a contiguous cache: the two plain
    versions agree bit for bit."""
    rng = np.random.RandomState(8)
    q = torch.from_numpy(rng.randn(2, H, D).astype(np.float32))
    cache = [torch.from_numpy(rng.randn(2, H, 2 * PS, D).astype(np.float32))
             for _ in range(2)]
    # slot s's pages 1 + 2s and 2 + 2s hold its positions in order
    pools = [torch.zeros(5, H, PS, D) for _ in range(2)]
    for pool, c in zip(pools, cache):
        for s in range(2):
            for j in range(2):
                pool[1 + 2 * s + j] = c[s, :, j * PS:(j + 1) * PS]
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    got = tpa.paged_attention_plain(q, *pools, tables,
                                    torch.tensor([200, 200]), SCALE)
    want = tda.decode_attention_plain(q, *cache, 200, SCALE)
    assert torch.equal(got, want)


def test_gather_pages_matches_jax_and_serves_the_ragged_module():
    rng = np.random.RandomState(9)
    pool = rng.randn(P, H, 16, 8).astype(np.float32)
    want = np.asarray(jpa.gather_pages(jnp.asarray(pool),
                                       jnp.asarray(TABLES)))
    got = tpa.gather_pages(torch.from_numpy(pool), torch.from_numpy(TABLES))
    assert got.shape == (3, H, MP * 16, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tra.gather_pages is tpa.gather_pages


# ---------------------------------------------------------------------------
# the flash forward at any sequence length
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [77, 200])
def test_flash_plain_at_ragged_lengths_matches_jax_reference(dtype, causal,
                                                             s):
    """The whole-prompt prefill of ``generate()`` runs the flash forward at
    every prompt length; its plain version agrees with the reference at
    lengths that are not 128-multiples."""
    rng = np.random.RandomState(s + int(causal))
    q, k, v = (rng.randn(1, 2, s, D).astype(np.float32) for _ in range(3))
    jd = getattr(jnp, dtype)
    ref = _f32(jfa._xla_reference_bnsd(*(jnp.asarray(a, jd)
                                         for a in (q, k, v)), causal, SCALE))
    out, lse = tfa.flash_attention_plain(*(_port(a, dtype)
                                           for a in (q, k, v)), causal,
                                         SCALE)
    assert out.shape == (1, 2, s, D) and lse.shape == (2, s)
    np.testing.assert_allclose(out.float().numpy(), ref, **TOL[dtype])


def test_flash_gates_forward_any_length_backward_128_multiples():
    assert tfa.fwd_kernel_unsupported_reason(77, 64, torch.float32) is None
    assert tfa.fwd_kernel_unsupported_reason(200, 128, torch.bfloat16) is None
    assert "seq_len=200" in tfa.kernel_unsupported_reason(200, 128,
                                                          torch.bfloat16)
    assert "head_dim=16" in tfa.fwd_kernel_unsupported_reason(
        77, 16, torch.float32)


# ---------------------------------------------------------------------------
# what the kernels take, and refusals off the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim", [16, 32, 64, 128, 192, 256])
def test_kernels_take_the_ragged_kernels_head_dims(head_dim):
    for dtype in (torch.float32, torch.bfloat16):
        assert tda.kernel_unsupported_reason(head_dim, dtype) is None
    assert "float16" in tda.kernel_unsupported_reason(head_dim,
                                                      torch.float16)


@pytest.mark.parametrize("head_dim,dtype,reason", [
    (80, torch.float32, "head_dim=80"),
    (512, torch.bfloat16, "head_dim=512"),
    (64, torch.float16, "float16")])
def test_a_device_tensor_the_kernels_refuse_raises(head_dim, dtype, reason):
    """Off the CPU there is no plain route: a head_dim or dtype the kernels
    refuse raises ``ValueError`` before anything is built or launched
    (meta tensors stand in for the card's)."""
    def meta(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    before = _launches()
    with pytest.raises(ValueError, match=reason):
        tda.decode_attention(meta(2, 4, head_dim), meta(2, 4, 32, head_dim),
                             meta(2, 4, 32, head_dim), 5)
    with pytest.raises(ValueError, match=reason):
        tpa.paged_attention(meta(2, 4, head_dim), meta(5, 4, 16, head_dim),
                            meta(5, 4, 16, head_dim),
                            meta(2, 3, dt=torch.int32),
                            meta(2, dt=torch.int32))
    with pytest.raises(ValueError, match=reason):
        tfa.flash_attention_fwd(*(meta(1, 2, 77, head_dim)
                                  for _ in range(3)), True, 0.1)
    assert _launches() == before


# ---------------------------------------------------------------------------
# the split kernel: its arithmetic in plain PyTorch, and its host pieces
# ---------------------------------------------------------------------------

def _around_splits(keys, n_max):
    """Lengths 0 and 1, a key either side of the first two split
    boundaries, and the whole cache."""
    return sorted(n for n in {0, 1, keys - 1, keys, keys + 1, 2 * keys - 1,
                              2 * keys + 1, n_max} if 0 <= n <= n_max)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_merge_plain_matches_jax_pallas_kernel_and_reference(dtype):
    """The split kernel's arithmetic (``split_merge_plain``: partials over
    ranges of keys, merged in order), with the kernel's own keys per split
    and with 16 (many splits), against the Pallas kernel in interpret mode
    at lengths around the split boundaries, and against the XLA reference
    at every length but 0: there the Pallas kernel's l == 0 guard gives
    zeros, as the kernel does, where the reference averages V.  Tolerance
    ``TOL[dtype]``: fp32, the same arithmetic in another order over at
    most 256 keys; bf16, both round P once (against a split's or a
    block's max) and the output once."""
    q, k, v = _decode_inputs(seed=11)
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    q8 = jnp.broadcast_to(jq.reshape(B * H, 1, D), (B * H, 8, D))
    tq, tk, tv = (_port(a, dtype) for a in (q, k, v))
    kernel_keys = tda.keys_per_split(D, getattr(torch, dtype))
    for n in _around_splits(kernel_keys, MAX_SEQ):
        pallas = _f32(jda._decode_pallas(
            q8, jk.reshape(B * H, MAX_SEQ, D), jv.reshape(B * H, MAX_SEQ, D),
            jnp.int32(n), SCALE, interpret=True)[:, 0].reshape(B, H, D))
        for keys in (kernel_keys, 16):
            got = tda.split_merge_plain(tq, tk, tv, n, SCALE, keys)
            assert got.dtype == getattr(torch, dtype)
            got = got.float().numpy()
            np.testing.assert_allclose(got, pallas, err_msg=f"{n} {keys}",
                                       **TOL[dtype])
            if n == 0:
                assert not got.any(), "length 0 must give zeros"
            else:
                ref = _f32(jda._xla_decode_reference(jq, jk, jv,
                                                     jnp.int32(n), SCALE))
                np.testing.assert_allclose(got, ref, err_msg=f"{n} {keys}",
                                           **TOL[dtype])


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 200])
def test_split_merge_plain_never_reads_past_the_length(n):
    """NaN at every position at or past the length gives, bit for bit,
    the output of the same cache with zeros there (the kernel reads no key
    past the length; the plain version's 0 x NaN would not be 0)."""
    q, k, v = (torch.from_numpy(a) for a in _decode_inputs(seed=12))
    outs = []
    for fill in (float("nan"), 0.0):
        k2, v2 = k.clone(), v.clone()
        k2[:, :, n:] = fill
        v2[:, :, n:] = fill
        outs.append(tda.split_merge_plain(q, k2, v2, n, SCALE, 64))
    assert torch.isfinite(outs[0]).all()
    assert torch.equal(outs[0], outs[1])


def test_merge_partials_skips_a_split_with_no_key():
    """A partial with no valid key (m = NEG_INF, l = 0, acc = 0) adds
    nothing to the merge: no NaN from exp(-inf - -inf), the others' result
    unchanged; all partials empty give zeros (the l == 0 guard)."""
    rng = np.random.RandomState(13)
    m, l = (torch.from_numpy(rng.randn(3).astype(np.float32)) for _ in "ml")
    l = l.abs() + 0.5
    acc = torch.from_numpy(rng.randn(3, D).astype(np.float32))
    empty = (torch.full((3,), tda.NEG_INF), torch.zeros(3), torch.zeros(3, D))
    want = tda.merge_partials([(m, l, acc)])
    for parts in ([(m, l, acc), empty], [empty, (m, l, acc)]):
        got = tda.merge_partials(parts)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    zeros = tda.merge_partials([empty, empty])
    assert torch.isfinite(zeros).all() and not zeros.any()


def test_split_host_pieces_and_what_they_refuse():
    """The wrapper's split count and workspace, from the cache shape on the
    host (the length stays on the device), and ``ValueError`` for what the
    kernel cannot take."""
    assert tda.keys_per_split(128, torch.bfloat16) == 64
    assert tda.keys_per_split(128, torch.float32) == 32
    assert tda.keys_per_split(128, torch.int8) == 128
    assert tda.keys_per_split(192, torch.bfloat16) == 32
    assert tda.keys_per_split(16, torch.bfloat16) == 128
    assert tda.num_splits(1024, 128, torch.bfloat16) == 16
    assert tda.num_splits(1025, 128, torch.bfloat16) == 17
    assert tda.num_splits(1, 192, torch.float32) == 1
    assert tda.workspace_shapes(128, 16, 128) == {
        "partials": (128 * 16 * 130,), "tickets": (128,)}
    with pytest.raises(ValueError, match="head_dim=80"):
        tda.keys_per_split(80, torch.bfloat16)
    with pytest.raises(ValueError, match="float16"):
        tda.num_splits(64, 64, torch.float16)
    with pytest.raises(ValueError, match="max_seq=0"):
        tda.num_splits(0, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="65535"):
        tda.num_splits(65535 * 128 + 1, 64, torch.bfloat16)
    for rows in (0, 2 ** 31):
        with pytest.raises(ValueError, match="rows"):
            tda.workspace_shapes(rows, 4, 64)


def test_paged_kernel_refuses_head_dim_192_naming_roadmap_queue_2():
    """The paged kernel's head-dim refusal: it refused head_dim 192 until
    the paged launch moved onto the split kernel, which takes it; now it
    takes 192 in every dtype, as the decode kernel does, and refuses the
    head dims past 256 (320 here) naming ROADMAP.md queue 2, off the CPU
    before anything launches (meta tensors stand in for the card's)."""
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        assert tda.kernel_unsupported_reason(192, dtype) is None
        assert tpa.kernel_unsupported_reason(192, dtype) is None
        assert tpa.keys_per_split(192, dtype) == tda.keys_per_split(192,
                                                                    dtype)
        reason = tpa.kernel_unsupported_reason(320, dtype)
        assert "head_dim=320" in reason and "ROADMAP.md queue 2" in reason
        assert tpa.kernel_unsupported_reason(128, dtype) is None

    def meta(*shape, dt=torch.bfloat16):
        return torch.empty(shape, dtype=dt, device="meta")

    before = _launches()
    with pytest.raises(ValueError, match="ROADMAP.md queue 2"):
        tpa.paged_attention(meta(2, 4, 320), meta(5, 4, 16, 320),
                            meta(5, 4, 16, 320), meta(2, 3, dt=torch.int32),
                            meta(2, dt=torch.int32))
    assert _launches() == before


# ---------------------------------------------------------------------------
# the paged launch of the split kernel: its arithmetic over the pool in
# plain PyTorch, and its host pieces
# ---------------------------------------------------------------------------

# (page, max_pages): splits that straddle pages, and splits inside one
# page; each table holds 2 x 128 + 1 positions or more
PAGED_SPLIT_TABLES = [(16, 17), (128, 3)]


def _paged_split_lengths(keys, page, max_pages):
    """One slot per length: 0 and 1, a key either side of the first split
    boundary, one past the second, a page edge and one past it, and the
    full table."""
    full = max_pages * page
    return sorted({min(n, full) for n in (0, 1, keys - 1, keys, keys + 1,
                                          2 * keys + 1, page, page + 1,
                                          full)})


def _paged_split_inputs(seed, page, max_pages, lengths):
    """fp32 q, pools and shuffled tables (one slot a length), and the
    pool positions no slot may see."""
    rng = np.random.RandomState(seed)
    slots = len(lengths)
    num_pages = slots * max_pages + 1
    tables = rng.permutation(np.arange(1, num_pages)).astype(
        np.int32)[:slots * max_pages].reshape(slots, max_pages)
    seen = np.zeros((num_pages, page), bool)
    for s, n in enumerate(lengths):
        pos = np.arange(n)
        seen[tables[s, pos // page], pos % page] = True
    return (rng.randn(slots, H, D).astype(np.float32),
            rng.randn(num_pages, H, page, D).astype(np.float32),
            rng.randn(num_pages, H, page, D).astype(np.float32),
            tables, seen)


@pytest.mark.parametrize("page,max_pages", PAGED_SPLIT_TABLES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_split_merge_plain_matches_jax_pallas_kernel_and_reference(
        dtype, page, max_pages):
    """The paged launch's arithmetic (``paged_attention.split_merge_plain``:
    per-slot lengths, partials over key ranges read page by page, merged
    in order), with the kernel's keys per split and with 16 (many splits,
    each inside a page of 16 or 128), against the Pallas kernel in
    interpret mode and the XLA reference, all lengths in one call.
    Tolerance ``TOL[dtype]``: fp32, the same arithmetic in another order
    over at most 384 keys; bf16, each rounds P once (against a split's, a
    page's or the row's max) and the output once."""
    keys = tpa.keys_per_split(D, getattr(torch, dtype))
    lengths = _paged_split_lengths(keys, page, max_pages)
    q, kp, vp, tables, _ = _paged_split_inputs(7 + page, page, max_pages,
                                               lengths)
    slots = len(lengths)
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, kp, vp))
    jt, jl = jnp.asarray(tables), jnp.asarray(np.array(lengths, np.int32))
    ref = _f32(jpa._xla_paged_reference(jq, jk, jv, jt, jl, SCALE))
    q8 = jnp.broadcast_to(jq.reshape(slots * H, 1, D), (slots * H, 8, D))
    pallas = _f32(jpa._paged_pallas(q8, jk, jv, jt, jl, SCALE,
                                    interpret=True)[:, 0].reshape(slots, H,
                                                                  D))
    args = (_port(q, dtype), _port(kp, dtype), _port(vp, dtype),
            torch.from_numpy(tables), torch.tensor(lengths, dtype=torch.int32),
            SCALE)
    for k in (keys, 16):
        got = tpa.split_merge_plain(*args, k)
        assert got.dtype == getattr(torch, dtype) and got.shape == (slots, H,
                                                                    D)
        got = got.float().numpy()
        np.testing.assert_allclose(got, pallas, err_msg=f"keys {k}",
                                   **TOL[dtype])
        np.testing.assert_allclose(got, ref, err_msg=f"keys {k}",
                                   **TOL[dtype])
        assert not got[np.array(lengths) == 0].any(), "length 0 gives zeros"


@pytest.mark.parametrize("page,max_pages", PAGED_SPLIT_TABLES)
def test_paged_split_merge_plain_never_reads_past_the_lengths(page,
                                                              max_pages):
    """NaN at every pool position no slot may see, read through tables
    whose entries past each slot's last live page name no pool page (an
    index that would raise if it were followed), gives bit for bit the
    output of the same pool with zeros there."""
    lengths = _paged_split_lengths(64, page, max_pages)
    q, kp, vp, tables, seen = _paged_split_inputs(8 + page, page, max_pages,
                                                  lengths)
    poisoned = tables.copy()
    for s, n in enumerate(lengths):
        poisoned[s, -(-n // page):] = 10 ** 6
    outs = []
    for fill, tbl in ((np.nan, poisoned), (0.0, tables)):
        kf, vf = (np.where(seen[:, None, :, None], a, np.float32(fill))
                  for a in (kp, vp))
        outs.append(tpa.split_merge_plain(
            torch.from_numpy(q), torch.from_numpy(kf), torch.from_numpy(vf),
            torch.from_numpy(tbl), torch.tensor(lengths), SCALE, 64))
    assert torch.isfinite(outs[0]).all()
    assert torch.equal(outs[0], outs[1])


def test_paged_split_host_pieces_and_what_they_refuse():
    """The paged launch's keys per split (the decode launch's), its split
    count from the table on the host (the lengths stay on the device), its
    workspace over slots x heads rows, and ``ValueError`` for what the
    kernel cannot take (a table past 65535 splits, int32 positions
    included)."""
    for d in tpa.KERNEL_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            assert tpa.keys_per_split(d, dtype) == tda.keys_per_split(d,
                                                                      dtype)
    assert tpa.num_splits(8, 128, 128, torch.bfloat16) == 16
    assert tpa.num_splits(8, 128, 128, torch.int8) == 8
    assert tpa.num_splits(17, 16, 64, torch.bfloat16) == 3
    assert tpa.num_splits(3, 16, 64, torch.float32) == 1
    assert tpa.num_splits(4, 128, 192, torch.bfloat16) == 16
    assert tda.workspace_shapes(8 * 16, tpa.num_splits(
        8, 128, 128, torch.bfloat16), 128) == {
            "partials": (128 * 16 * 130,), "tickets": (128,)}
    with pytest.raises(ValueError, match="ROADMAP.md queue 2"):
        tpa.keys_per_split(320, torch.bfloat16)
    with pytest.raises(ValueError, match="float16"):
        tpa.num_splits(4, 16, 64, torch.float16)
    for max_pages, page in ((0, 16), (4, 0)):
        with pytest.raises(ValueError, match="max_pages"):
            tpa.num_splits(max_pages, page, 64, torch.bfloat16)
    for max_pages, page in ((65536, 128), (2 ** 24, 2 ** 8)):
        with pytest.raises(ValueError, match="65535"):
            tpa.num_splits(max_pages, page, 128, torch.bfloat16)
