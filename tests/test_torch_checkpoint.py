"""Crash-consistent training in the port (``paddle_tpu_torch.checkpoint``),
held against the JAX package on the CPU: the ports of
``tests/test_checkpoint.py``'s ``TestManagerCrashConsistency``,
``TestAsyncWriter``, ``TestDeterministicResume``, ``TestSentry`` and
``TestPreemption``.

- The manager is a copy of the JAX package's: every crash scenario runs
  through both managers, each in its own directory, and both must pick
  the same checkpoint (and give the same tree back).
- Resume: GPT at ``gpt_tiny`` under O1 with an enabled scaler, trained 6
  steps, against 3 steps, an asynchronous save, a restore into a model
  built from another seed and 3 more steps: the losses and every
  parameter bit for bit (moments, masters, the device beta powers, the
  scale and the generators all restored); AdamW's beta powers, a
  scheduler's and a scaler's state, and the random state round-trip.
- The sentry and the fused unscale-and-check flag non-finite gradients as
  the JAX ones do, skip, count and roll back.
- Preemption: a SIGTERM sets the request, which saves and raises
  ``GracefulExit`` at the step boundary."""
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.checkpoint import CheckpointManager as JaxManager
from paddle_tpu.checkpoint import all_finite as jax_all_finite
from paddle_tpu.checkpoint.sentry import (
    unscale_and_check as jax_unscale_and_check,
)

from paddle_tpu_torch import amp
from paddle_tpu_torch.checkpoint import (
    BadStepSentry, CheckpointError, CheckpointManager, GracefulExit,
    PreemptionHandler, TrainState, all_finite, unscale_and_check,
    unscale_and_check_,
)
from paddle_tpu_torch.checkpoint.manager import MANIFEST_NAME, PAYLOAD_NAME
from paddle_tpu_torch.models import GPTStackedForPretraining, gpt_tiny
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW, FusedTrainStep
from paddle_tpu_torch.optimizer import lr as tlr

torch.set_num_threads(2)


def _tree(v):
    return {"w": np.full((4,), float(v), np.float32), "meta": {"v": v}}


def _both(tmp_path, scenario):
    """``scenario(manager_class, directory)`` run with the JAX and the
    port's manager; returns both results."""
    out = []
    for name, cls in (("jax", JaxManager), ("port", CheckpointManager)):
        d = tmp_path / name
        d.mkdir()
        out.append(scenario(cls, d))
    return out


class TestManagerCrashConsistency:
    INJECTION_POINTS = ("after_tmpdir", "mid_payload", "after_payload",
                        "before_manifest", "before_commit")

    @pytest.mark.parametrize("point", INJECTION_POINTS)
    def test_interrupted_write_never_selected(self, tmp_path, point):
        def scenario(cls, d):
            m = cls(str(d), async_save=False)
            m.save(_tree(1), step=1)

            def boom(p):
                if p == point:
                    raise KeyboardInterrupt(f"crash at {p}")

            m._fault_hook = boom
            with pytest.raises(KeyboardInterrupt):
                m.save(_tree(2), step=2)
            m._fault_hook = None
            info = m.latest()
            tree, manifest = m.restore(info)
            return info.step, tree["w"].tolist(), manifest["step"]

        jax_out, port_out = _both(tmp_path, scenario)
        assert port_out == jax_out == (1, [1.0] * 4, 1)

    @pytest.mark.parametrize("damage", ["truncate", "flip", "manifest",
                                        "no manifest"])
    def test_damaged_newest_falls_back(self, tmp_path, damage):
        def scenario(cls, d):
            m = cls(str(d), async_save=False)
            m.save(_tree(1), step=1)
            m.save(_tree(2), step=2)
            ck = d / "ckpt-00000002"
            p = ck / PAYLOAD_NAME
            if damage == "truncate":
                with open(p, "r+b") as f:
                    f.truncate(os.path.getsize(p) // 2)
            elif damage == "flip":
                raw = bytearray(p.read_bytes())
                raw[len(raw) // 2] ^= 0xFF
                p.write_bytes(bytes(raw))
            elif damage == "manifest":
                (ck / MANIFEST_NAME).write_text("{not json")
            else:
                os.unlink(ck / MANIFEST_NAME)
            return m.latest().step

        assert _both(tmp_path, scenario) == [1, 1]

    def test_no_valid_checkpoint(self, tmp_path):
        m = CheckpointManager(str(tmp_path), async_save=False)
        assert m.latest() is None
        with pytest.raises(CheckpointError, match="no valid checkpoint"):
            m.restore()

    def test_stale_tmp_dirs_cleaned_on_init(self, tmp_path):
        stale = tmp_path / ".tmp-ckpt-00000009-99999-deadbeef"
        stale.mkdir()
        (stale / PAYLOAD_NAME).write_bytes(b"partial")
        m = CheckpointManager(str(tmp_path), async_save=False)
        assert not stale.exists()
        assert m.latest() is None

    def test_retention_resave_and_ordering_match_jax(self, tmp_path):
        def scenario(cls, d):
            m = cls(str(d), keep_last_k=2, async_save=False)
            for s in range(1, 6):
                m.save(_tree(s), step=s)
            kept = [c.step for c in m.checkpoints()]
            m.save({"w": np.zeros(3, np.float32)}, step=5)
            resaved = m.restore()[0]["w"].shape
            m.save(_tree(7), step=99999999)
            m.save(_tree(8), step=100000000)
            return kept, resaved, [c.step for c in m.checkpoints()]

        jax_out, port_out = _both(tmp_path, scenario)
        assert port_out == jax_out == ([5, 4], (3,),
                                       [100000000, 99999999])

    def test_gc_never_deletes_only_valid(self, tmp_path):
        m0 = CheckpointManager(str(tmp_path), keep_last_k=3,
                               async_save=False)
        for s in (1, 2, 3):
            m0.save(_tree(s), step=s)
        for s in (2, 3):
            p = tmp_path / f"ckpt-0000000{s}" / PAYLOAD_NAME
            raw = bytearray(p.read_bytes())
            raw[0] ^= 0xFF
            p.write_bytes(bytes(raw))
        m = CheckpointManager(str(tmp_path), keep_last_k=1,
                              async_save=False)
        m._gc()
        assert m.latest().step == 1
        assert not (tmp_path / "ckpt-00000002").exists()
        assert not (tmp_path / "ckpt-00000003").exists()

    def test_failed_write_leaves_no_staging_dir(self, tmp_path):
        m = CheckpointManager(str(tmp_path), async_save=False)
        m._fault_hook = lambda p: (_ for _ in ()).throw(OSError("disk full"))
        with pytest.raises(OSError):
            m.save(_tree(1), step=1)
        assert [n for n in os.listdir(tmp_path)
                if n.startswith(".tmp")] == []

    def test_manifest_names_the_port(self, tmp_path):
        m = CheckpointManager(str(tmp_path), async_save=False)
        m.save(_tree(1), step=1, epoch=2, meta={"k": 1})
        info = m.latest()
        assert info.manifest["framework_version"].startswith(
            "paddle_tpu_torch")
        assert (info.step, info.epoch, info.manifest["meta"]) == (
            1, 2, {"k": 1})


class TestAsyncWriter:
    def test_async_save_and_wait(self, tmp_path):
        m = CheckpointManager(str(tmp_path), async_save=True)
        m.save(_tree(1), step=1)
        m.wait()
        assert m.latest().step == 1

    def test_writer_error_reraised_on_next_call(self, tmp_path):
        m = CheckpointManager(str(tmp_path), async_save=True)
        m._fault_hook = lambda p: (_ for _ in ()).throw(OSError("disk full"))
        m.save(_tree(1), step=1)
        with pytest.raises(CheckpointError, match="disk full"):
            m.wait()
        m._fault_hook = None
        m.save(_tree(2), step=2)
        m.wait()
        assert m.latest().step == 2

    def test_at_most_one_inflight(self, tmp_path):
        m = CheckpointManager(str(tmp_path), async_save=True)
        release, entered, order = threading.Event(), threading.Event(), []

        def hook(p):
            if p == "before_commit":
                entered.set()
                order.append("blocked")
                release.wait(timeout=10)

        m._fault_hook = hook
        m.save(_tree(1), step=1)
        assert entered.wait(timeout=10)
        m._fault_hook = None
        threading.Timer(0.3, release.set).start()
        t0 = time.monotonic()
        m.save(_tree(2), step=2)
        assert time.monotonic() - t0 > 0.1
        m.wait()
        assert order == ["blocked"]
        assert [c.step for c in m.checkpoints()] == [2, 1]

    def test_async_step_overhead_small(self, tmp_path):
        state = {"w": np.random.RandomState(0).randn(256, 256).astype(
            np.float32)}
        n = 20
        t0 = time.perf_counter()
        for _ in range(n):
            np.sum(state["w"])
        base = time.perf_counter() - t0
        m = CheckpointManager(str(tmp_path), keep_last_k=2, async_save=True)
        t0 = time.perf_counter()
        for s in range(n):
            np.sum(state["w"])
            m.save(dict(state), step=s)
        with_ckpt = time.perf_counter() - t0
        m.wait()
        assert with_ckpt < base + 5.0
        assert m.latest() is not None


# -- TrainState: bit-deterministic resume ------------------------------------

GPT_CFG = dict(hidden_dropout=0.0, attention_dropout=0.0,
               recompute_interval=1)


def _gpt_setup(seed=7):
    m = GPTStackedForPretraining(gpt_tiny(**GPT_CFG), device="cpu",
                                 seed=seed)
    opt = AdamW(1e-3, parameters=m.parameters())
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 12, device="cpu")
    step = FusedTrainStep(lambda i, l: m(i, labels=l), opt, scaler=scaler,
                          amp_level="O1")
    rng = np.random.RandomState(0)
    batch = tuple(torch.from_numpy(rng.randint(0, 1024, (2, 16)))
                  for _ in range(2))
    return m, opt, scaler, step, batch


class TestDeterministicResume:
    def test_gpt_resume_bitwise(self, tmp_path):
        """train(6) == train(3); async save; restore into a model built
        from another seed; train(3): losses and parameters bit for bit."""
        m, _, _, step, batch = _gpt_setup()
        ref = [float(step(*batch)) for _ in range(6)]

        m2, o2, s2, step2, batch = _gpt_setup()
        pre = [float(step2(*batch)) for _ in range(3)]
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(TrainState(m2, o2, s2).capture(position={"step": 3}),
                 step=3)
        mgr.wait()

        m3, o3, s3, step3, batch = _gpt_setup(seed=999)
        tree, _ = mgr.restore()
        assert TrainState(m3, o3, s3).restore(tree) == {"step": 3}
        post = [float(step3(*batch)) for _ in range(3)]
        assert pre == ref[:3]
        assert post == ref[3:]
        for (n, a), b in zip(m.state_dict().items(),
                             m3.state_dict().values()):
            assert torch.equal(a, b), n

    def test_adam_aux_state_roundtrip(self):
        """The beta powers survive ``state_dict``/``set_state_dict`` as
        the JAX optimizer's ``aux_0``/``aux_1`` do (host, and the device
        pair of a flagged step)."""
        x = np.ones((2, 4), np.float32)
        jlin = pt.nn.Linear(4, 4)
        jopt = pt.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jlin.parameters())
        w = torch.nn.Parameter(torch.zeros(4, 4))
        for flagged in (False, True):
            opt = AdamW(1e-3, parameters=[w])
            for _ in range(3):
                w.grad = torch.ones(4, 4)
                opt.step(**({"finite": torch.tensor(True)} if flagged
                            else {}))
            opt2 = AdamW(1e-3, parameters=[torch.nn.Parameter(
                torch.zeros(4, 4))])
            opt2.set_state_dict(opt.state_dict())
            assert (opt2.beta1_pow, opt2.beta2_pow) == (opt.beta1_pow,
                                                        opt.beta2_pow)
        for _ in range(3):
            jlin(pt.to_tensor(x)).mean().backward()
            jopt.step()
            jopt.clear_grad()
        jsd = jopt.state_dict()
        assert float(opt.state_dict()["aux_0"]) == float(
            np.asarray(jsd["aux_0"].numpy()))

    def test_scaler_and_scheduler_state_roundtrip(self, tmp_path):
        w = torch.nn.Parameter(torch.ones(4, 4))
        sched = tlr.CosineAnnealingDecay(learning_rate=0.1, T_max=10)
        opt = AdamW(sched, parameters=[w])
        scaler = amp.GradScaler(init_loss_scaling=128.0, device="cpu")
        x = torch.ones(2, 4)
        for _ in range(4):
            scaler.scale(F.linear(x, w).mean()).backward()
            scaler.step(opt)
            opt.zero_grad()
            sched.step()
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(TrainState(None, opt, scaler=scaler).capture(), step=4)
        w2 = torch.nn.Parameter(torch.ones(4, 4))
        sched2 = tlr.CosineAnnealingDecay(learning_rate=0.1, T_max=10)
        opt2 = AdamW(sched2, parameters=[w2])
        scaler2 = amp.GradScaler(init_loss_scaling=2.0 ** 15, device="cpu")
        TrainState(None, opt2, scaler=scaler2).restore(mgr.restore()[0])
        assert sched2.last_epoch == sched.last_epoch
        assert sched2.last_lr == sched.last_lr
        assert scaler2.get_loss_scaling() == scaler.get_loss_scaling()

    def test_rng_state_restored(self, tmp_path):
        """The global generator and every generator the model holds come
        back: the draws after a restore repeat those after the save."""
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        m = GPTStackedForPretraining(gpt_tiny(), device="cpu")
        torch.manual_seed(42)
        torch.rand(4)
        st = TrainState(m, include_rng=True)
        mgr.save(st.capture(), step=1)
        a = (torch.rand(8), torch.rand(3, generator=m.generator))
        st.restore(mgr.restore()[0])
        b = (torch.rand(8), torch.rand(3, generator=m.generator))
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# -- the sentry and the fused check ------------------------------------------

class TestSentry:
    def test_all_finite_matches_jax(self):
        cases = [[np.ones(3), torch.zeros(2, 2)],
                 [np.ones(3), np.array([1.0, np.nan])],
                 [torch.tensor([np.inf])],
                 [np.array([1, 2, 3]), torch.arange(3)],
                 [],
                 {"a": [torch.ones(2)], "b": (torch.tensor([np.nan]),)}]
        for c in cases:
            jc = ({k: [np.asarray(t) for t in v] for k, v in c.items()}
                  if isinstance(c, dict) else [np.asarray(t) for t in c])
            assert all_finite(c) == jax_all_finite(jc), c

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_unscale_and_check_matches_jax(self, dtype):
        rng = np.random.RandomState(1)
        grads = [rng.randn(5, 3).astype(np.float32) * 1e3,
                 rng.randn(7).astype(np.float32)]
        for poison in (False, True):
            if poison:
                grads[1][2] = np.inf
            jnew, jf = jax_unscale_and_check(
                [pt.to_tensor(g).astype(dtype)._value for g in grads],
                pt.to_tensor(np.float32(512.0))._value)
            tg = [torch.from_numpy(g).to(getattr(torch, dtype))
                  for g in grads]
            new, f = unscale_and_check(tg, torch.tensor(512.0))
            assert bool(f) == bool(jf) == (not poison)
            for a, b in zip(new, jnew):
                np.testing.assert_array_equal(a.float().numpy(),
                                              np.asarray(b, np.float32))
            flag = unscale_and_check_(tg, torch.tensor(512.0))
            assert bool(flag) == bool(jf)
            for a, b in zip(tg, new):
                assert torch.equal(a, b)

    def test_guard_step_skips_nan(self):
        w = torch.nn.Parameter(torch.ones(4, 4))
        opt = AdamW(0.1, parameters=[w])
        sentry = BadStepSentry(max_consecutive_bad=10)
        w.grad = torch.full((4, 4), float("nan"))
        assert sentry.guard_step(opt) is False
        assert torch.equal(w.detach(), torch.ones(4, 4))
        assert sentry.stats["bad_steps"] == 1
        w.grad = torch.ones(4, 4)
        assert sentry.guard_step(opt) is True
        assert sentry.stats["consecutive_bad"] == 0
        assert not torch.equal(w.detach(), torch.ones(4, 4))

    def test_rollback_after_n_bad_steps(self, tmp_path):
        w = torch.nn.Parameter(torch.ones(4, 4))
        opt = AdamW(0.1, parameters=[w])
        mod = torch.nn.Module()
        mod.w = w
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        state = TrainState(mod, opt)
        mgr.save(state.capture(), step=1)
        with torch.no_grad():
            w.add_(100.0)
        sentry = BadStepSentry(max_consecutive_bad=3, manager=mgr,
                               train_state=state)
        for _ in range(3):
            w.grad = torch.full((4, 4), float("nan"))
            assert sentry.guard_step(opt) is False
        assert sentry.stats["rollbacks"] == 1
        assert sentry.stats["bad_steps"] == 3
        assert torch.equal(w.detach(), torch.ones(4, 4))
        calls = []
        BadStepSentry(1, on_rollback=lambda: calls.append(1)).rollback()
        assert calls == [1]
        with pytest.raises(ValueError):
            BadStepSentry(max_consecutive_bad=0)


# -- preemption --------------------------------------------------------------

class TestPreemption:
    def test_signal_sets_request_and_uninstall_restores(self):
        prev = signal.getsignal(signal.SIGTERM)
        h = PreemptionHandler()
        with h:
            assert not h.requested
            os.kill(os.getpid(), signal.SIGTERM)
            deadline = time.time() + 5
            while not h.requested and time.time() < deadline:
                time.sleep(0.01)
            assert h.requested
        assert signal.getsignal(signal.SIGTERM) is prev

    def test_checkpoint_and_exit(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        lin = torch.nn.Linear(2, 2)
        state = TrainState(lin)
        h = PreemptionHandler()
        h.checkpoint_and_exit_if_requested(mgr, state, step=1)
        assert mgr.latest() is None
        h.request()
        with pytest.raises(GracefulExit) as exc:
            h.checkpoint_and_exit_if_requested(mgr, state, step=7, epoch=2)
        assert exc.value.code == 0
        info = mgr.latest()
        assert info.step == 7 and info.epoch == 2
        assert info.manifest["meta"]["preempted"] is True
        tree, _ = mgr.restore(info)
        assert tree["position"] == {"epoch": 2, "step": 7}

    def test_elastic_on_change_requests_checkpoint(self):
        h = PreemptionHandler()
        h.as_elastic_on_change()([0, 1])
        assert h.requested
        h.clear()
        assert not h.requested
