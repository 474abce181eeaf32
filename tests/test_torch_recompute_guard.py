"""Fault 10 of the port (ROADMAP.md queue 3): the port's one checkpoint,
``paddle_tpu_torch.core.recompute.checkpoint``, which every recomputed
region of the package calls.

Autograd runs each device's backward nodes on a thread of its own, so a
checkpointed function whose forward spans devices has its saved tensors
unpacked from several threads in one backward pass; unguarded, two
threads recompute one frame at once and the recomputations clash.  On
the CPU every device shares one autograd thread, so that race cannot show
here: ``chip_smoke.py``'s phase 54 shows it on the card, where the CPU
and ``cuda:0`` run on two threads.  These tests hold the guard itself,
by unpacking one frame from two Python threads at once inside one
backward pass's id, and each of the five places that checkpoint against
its run without recompute (bit for bit, on the CPU):

- ``distributed.pp_spmd.checkpointed`` (the stacked GPT's
  ``recompute_interval``, at the policies None, "dots" and
  "dots_saveable");
- the layered GPT's ``GPTModel._layer_loop``;
- ``fleet.recompute``;
- ``nn.functional.fused_linear_cross_entropy`` and
  ``vocab_parallel_cross_entropy`` (their chunks), against the same
  heads with their checkpoint a plain call.
"""
import gc
import sys
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import recompute as R
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.models import (
    GPTForPretraining, GPTPretrainingCriterion, GPTStackedForPretraining,
    gpt_tiny,
)
from paddle_tpu_torch.nn.functional import (
    fused_linear_cross_entropy, vocab_parallel_cross_entropy,
)
from paddle_tpu_torch.nn.functional import loss as loss_module


class _NoLock:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _unpack_from_two_threads(monkeypatch, guarded):
    """Forward a checkpointed function, then unpack two of its saved
    tensors from two threads at once under one backward-pass id; the
    recompute sleeps, so an unguarded frame is recomputed by both.
    Returns (recomputes, the two unpacked tensors, their forward
    values)."""
    monkeypatch.setattr(R, "_task_id", lambda: 7)
    if not guarded:
        init = R._Frame.__init__

        def no_lock(self, *a, **k):
            init(self, *a, **k)
            self.lock = _NoLock()
        monkeypatch.setattr(R._Frame, "__init__", no_lock)
    calls = [0]

    def fn(x):
        calls[0] += 1
        if calls[0] > 1:
            time.sleep(0.2)
        a = x.sin()
        return a * a.exp()

    x = torch.from_numpy(np.random.RandomState(0).randn(4, 8)) \
        .requires_grad_()
    y = R.checkpoint(fn, x)
    node = y.grad_fn                     # MulBackward0: saves a and exp(a)
    barrier = threading.Barrier(2)
    got = {}

    def unpack(name):
        barrier.wait()
        got[name] = getattr(node, name)

    threads = [threading.Thread(target=unpack, args=(n,))
               for n in ("_saved_self", "_saved_other")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    a = x.detach().sin()
    return calls[0] - 1, got, {"_saved_self": a, "_saved_other": a.exp()}


def test_two_threads_unpacking_one_frame_recompute_it_once(monkeypatch):
    """The guard: one lock a frame around check, recompute and mark, so
    the second thread waits and takes the first one's recompute."""
    n, got, want = _unpack_from_two_threads(monkeypatch, guarded=True)
    assert n == 1
    for name, value in want.items():
        assert torch.equal(got[name], value)


def test_the_two_threads_race_without_the_guard(monkeypatch):
    """The same two threads over a frame whose lock does nothing recompute
    it twice: the race the guard closes (what ``torch.utils.checkpoint``
    does, where the two recomputations then clash)."""
    n, _, _ = _unpack_from_two_threads(monkeypatch, guarded=False)
    assert n == 2


def test_many_threads_unpacking_one_frame_recompute_it_once(monkeypatch):
    """A stress run: 24 threads unpack the 24 saved tensors of one frame
    at once, under one backward-pass id and a short switch interval; the
    frame is recomputed once and every thread gets its own tensor's
    forward value."""
    monkeypatch.setattr(R, "_task_id", lambda: 11)
    n, calls = 24, [0]

    def fn(x):
        calls[0] += 1
        for _ in range(n):
            x = x.sin()
        return x

    x = torch.from_numpy(np.random.RandomState(1).randn(64)).requires_grad_()
    y = R.checkpoint(fn, x)
    nodes, node = [], y.grad_fn
    while node is not None and len(nodes) < n:
        nodes.append(node)
        node = node.next_functions[0][0]
    want, v = [], x.detach()
    for _ in range(n):
        want.append(v)
        v = v.sin()
    want = want[::-1]                    # nodes run from the output back
    got = [None] * n
    barrier = threading.Barrier(n)

    def unpack(i):
        barrier.wait()
        got[i] = nodes[i]._saved_self

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=unpack, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert calls[0] - 1 == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _count_frames(monkeypatch):
    frames = [0]
    init = R._Frame.__init__

    def counted(self, *a, **k):
        frames[0] += 1
        init(self, *a, **k)
    monkeypatch.setattr(R._Frame, "__init__", counted)
    return frames


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _gpt_grads(cls, interval, policy=None):
    cfg = gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0, num_layers=2,
                   recompute_interval=interval, recompute_policy=policy)
    model = cls(cfg, device="cpu", seed=3).train()
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 16)))
    if cls is GPTStackedForPretraining:
        loss = model(ids, labels=ids)
    else:
        loss = GPTPretrainingCriterion(cfg)(model(ids), ids)
    loss.backward()
    return {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("policy", [None, "dots", "dots_saveable"])
def test_pp_spmd_checkpointed_gives_the_gradients_without_recompute(
        monkeypatch, policy):
    """The stacked GPT's recomputed groups (``pp_spmd.checkpointed``)."""
    frames = _count_frames(monkeypatch)
    got = _gpt_grads(GPTStackedForPretraining, 1, policy)
    assert frames[0] >= 2
    _assert_same(got, _gpt_grads(GPTStackedForPretraining, 0))


def test_layered_layer_loop_gives_the_gradients_without_recompute(
        monkeypatch):
    """The layered GPT's ``recompute_interval`` (``_layer_loop``)."""
    frames = _count_frames(monkeypatch)
    got = _gpt_grads(GPTForPretraining, 1)
    assert frames[0] >= 2
    _assert_same(got, _gpt_grads(GPTForPretraining, 0))


def test_fleet_recompute_gives_the_gradients_without_recompute(
        monkeypatch):
    frames = _count_frames(monkeypatch)
    torch.manual_seed(0)
    lin = torch.nn.Linear(8, 8).double()
    x = torch.from_numpy(np.random.RandomState(2).randn(4, 8))

    def grads(wrap):
        xs = x.clone().requires_grad_()
        lin.zero_grad()
        y = wrap(lambda t: torch.tanh(lin(t)) * t, xs)
        y.square().sum().backward()
        return {"x": xs.grad, "w": lin.weight.grad.clone(),
                "b": lin.bias.grad.clone()}

    got = grads(fleet.recompute)
    assert frames[0] == 1
    _assert_same(got, grads(lambda f, t: f(t)))


def _loss_grads(loss_fn):
    rng = np.random.RandomState(4)
    h = torch.from_numpy(rng.randn(2, 12, 16).astype(np.float32))
    w = torch.from_numpy((rng.randn(40, 16) * 0.3).astype(np.float32))
    lab = torch.from_numpy(rng.randint(0, 40, (2, 12)))
    h.requires_grad_()
    w.requires_grad_()
    loss = loss_fn(h, w, lab)
    loss.backward()
    return {"loss": loss.detach(), "h": h.grad, "w": w.grad}


def _chunked_head_against_plain(monkeypatch, loss_fn, chunks):
    """``loss_fn``'s loss and gradients with its chunks checkpointed, then
    with the loss module's checkpoint a plain call: bit for bit."""
    frames = _count_frames(monkeypatch)
    got = _loss_grads(loss_fn)
    assert frames[0] == chunks
    monkeypatch.setattr(loss_module, "checkpoint",
                        lambda fn, *a, **k: fn(*a))
    _assert_same(got, _loss_grads(loss_fn))


def test_fused_linear_cross_entropy_chunks_without_recompute(
        monkeypatch):
    _chunked_head_against_plain(
        monkeypatch, lambda h, w, lab: fused_linear_cross_entropy(
            h, w, lab, chunk_tokens=5), 5)      # 24 tokens in chunks of 5


def test_vocab_parallel_cross_entropy_chunks_without_recompute(
        monkeypatch):
    """The vocabulary-parallel head: two shards of the table, each chunk
    checkpointed over both (a backward that spans the shards' cards when
    they are distinct)."""
    _chunked_head_against_plain(
        monkeypatch, lambda h, w, lab: vocab_parallel_cross_entropy(
            h, [w[:24], w[24:]], lab, devices=("cpu", "cpu"),
            chunk_tokens=7), 4)                 # 24 tokens in chunks of 7


def test_frames_and_their_inputs_are_freed_after_the_backward(monkeypatch):
    """After a backward the frames, with the inputs they keep for the
    recompute, are gone: the recompute's graph (whose nodes may save their
    own outputs) must hold no reference back to them, or every step's
    checkpointed activations would stay allocated."""
    frames = weakref.WeakSet()
    init = R._Frame.__init__

    def tracked(self, *a, **k):
        init(self, *a, **k)
        frames.add(self)
    monkeypatch.setattr(R._Frame, "__init__", tracked)
    w = torch.randn(8, 8, dtype=torch.float64, requires_grad=True)
    inputs = weakref.WeakSet()
    for _ in range(3):
        x = torch.randn(4, 8, dtype=torch.float64, requires_grad=True) * 2
        inputs.add(x)
        y = R.checkpoint(lambda t: torch.tanh(t @ w).sin().exp(), x)
        y.sum().backward()
        del x, y
    gc.collect()
    assert len(frames) == 0 and len(inputs) == 0


def test_without_grad_mode_a_checkpoint_is_a_plain_call():
    calls = [0]

    def fn(x):
        calls[0] += 1
        return x * 2

    with torch.no_grad():
        out = R.checkpoint(fn, torch.ones(3, requires_grad=True))
    assert calls[0] == 1 and out.grad_fn is None


def test_a_recompute_that_saves_other_tensors_raises():
    """A function that saves fewer tensors when it runs again is refused
    with the counts, not given wrong gradients."""
    calls = [0]

    def fn(x):
        calls[0] += 1
        return x.exp() * x if calls[0] == 1 else x * 2.0

    x = torch.ones(3, dtype=torch.float64, requires_grad=True)
    with pytest.raises(R.CheckpointError, match="saved"):
        R.checkpoint(fn, x).sum().backward()
