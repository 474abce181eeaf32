"""Semi-auto parallel Engine (port of ``paddle_tpu/distributed/
auto_parallel/engine.py``; reference: Paddle's ``auto_parallel/static/
engine.py:570`` ``_build``, ``:729`` ``_plan``, ``:757`` ``_parallel``,
``:853`` ``fit``).

The reference's pipeline, as the port runs it:

- ``_build`` (dygraph -> serial program): :meth:`Engine.capture_graph`,
  the model and loss captured on fake tensors as an aten graph with the
  parameters as inputs (``propagation.capture_graph``);
- ``_plan`` (the Completer's propagation): :meth:`Engine.plan` picks the
  mesh factorization by the planner's cost model, builds the mesh over
  ``devices`` and installs it, gives each parameter the Megatron
  placement (``planner.placement_decisions``) as a ``DistSpec``, and
  places the model (``placed.place_model``): every parameter and buffer
  becomes one block a mesh position, cut where its spec cuts it, on the
  position's device, and the model's whole tensors give up their
  storage.  The optimizer the caller passed is moved in place to the
  blocks (``placed.repoint_optimizer``: its groups, its state cut the
  same way, its names and ``lr_ratio`` kept).  A second ``plan()``
  gathers the whole values back and places them again;
- ``_parallel`` (the Partitioner and Resharder): the propagation
  executor (``propagation.apply_propagation``) runs the captured graph
  per mesh position on the blocks, with no cut, its gathers and partial
  sums inserted where the pass decided; with ``grad=True`` autograd
  records the blocks, and the parts of each block are tied, so every
  part receives the sum of all their gradients once;
- the passes: the Strategy's ``amp`` runs the port's ``auto_cast``,
  ``sharding`` its ``group_sharded_parallel`` (over the placed blocks
  under a plan: the ZeRO axis is ``dp``, a group the positions that hold
  one block and differ only along it; at ``p_g_os`` the executor gathers
  each block from its slices at the graph's first read and frees it
  after the last, and again for the backward; on a mesh without dp it
  does nothing), ``gradient_merge`` wraps the optimizer in
  ``GradientMerge``.

``fit``, ``evaluate`` and ``predict`` under a plan of more than one
position run through the executor, each on a graph captured for its
mode (``evaluate`` and ``predict`` under ``torch.no_grad``); without a
plan, or over one position, they run the model eagerly on its device.
``model.state_dict()``/``load_state_dict()`` (and so ``save``/``load``
and the checkpoints) read and write whole tensors under the model's
names while it is placed: gathered from the blocks, and cut straight
into them.  The port has one process, so a checkpoint directory is used
as given (the JAX Engine's per-host suffix waits for the multi-process
runtime, ROADMAP.md queue 1, item 10).
"""
from __future__ import annotations

import os
import sys
import time
import warnings
from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch

from ...core import canonical_device, resolve_device
from .. import mesh as _mesh
from .strategy import Strategy

__all__ = ["Engine", "Strategy"]


class Engine:
    """The reference's ``Engine(model, loss, optimizer, metrics, cluster,
    strategy)`` with ``fit``/``evaluate``/``predict``, checkpoints,
    ``save``/``load``, ``capture_graph``/``propagate``, ``cost`` and
    ``plan``.  ``cluster`` is accepted and not read, as the JAX Engine
    does (``cost`` and ``plan`` take theirs).

    ``device``: the model's device, ``None`` meaning the card (raises
    without one); pass ``device="cpu"`` for the CPU.  The model's
    parameters must already lie there.  ``devices``: where ``plan()``
    lays its mesh (``mesh.build_mesh``), default the visible cards, or
    the one CPU device of a CPU engine; naming a device more than once
    puts mesh positions on it together (``["cuda:0"] * 4`` is the
    one-card layout of four positions)."""

    def __init__(self, model=None, loss=None, optimizer=None, metrics=None,
                 cluster=None, strategy: Optional[Strategy] = None, *,
                 device=None, devices=None):
        self.device = canonical_device(resolve_device(device))
        self._model = model
        self._loss = loss
        self._optimizer = optimizer
        self._metrics = metrics or []
        self._strategy = strategy or Strategy()
        self._devices = None if devices is None else list(devices)
        self._sharding_applied = False
        self._gm_applied = False
        self._plan_mesh = None
        self._plan_specs = {}
        self._placement = None      # the placed blocks (placed.PlacedModel)
        self._placement_hooks = []
        self._execs = {}            # mode -> (key, run, names)
        self._n_labels = 1
        self.history = {"loss": []}
        if model is not None:
            on = {canonical_device(p.device) for p in model.parameters()}
            if on - {self.device}:
                raise ValueError(
                    f"Engine(device={self.device}): the model's parameters "
                    f"lie on {sorted(map(str, on))}; build it there, or "
                    "pass the device it lies on")
        if self._strategy.seed is not None:
            torch.manual_seed(self._strategy.seed)

    # -- devices and batches ----------------------------------------------
    def _device_list(self):
        if self._devices is not None:
            return self._devices
        if self.device.type == "cuda":
            return _mesh._visible_cards()
        return [self.device]

    def _to_batch(self, batch):
        """A batch (a tuple of inputs then labels, or one array) as tensors
        on the model's device."""
        items = batch if isinstance(batch, (list, tuple)) else (batch,)
        out = []
        for b in items:
            t = b if isinstance(b, torch.Tensor) else \
                torch.from_numpy(np.asarray(b))
            out.append(t.to(self.device))
        return tuple(out)

    # -- step pieces -------------------------------------------------------
    def _loss_value(self, outputs, labels):
        loss_fn = self._loss
        if loss_fn is None:
            return outputs
        if isinstance(outputs, (list, tuple)):
            return loss_fn(*outputs, *labels)
        return loss_fn(outputs, *labels)

    def _amp(self):
        amp_cfg = self._strategy.amp
        if not amp_cfg.enable:
            return nullcontext()
        from ...amp.auto_cast import auto_cast

        return auto_cast(enable=True, level=amp_cfg.level,
                         dtype=amp_cfg.dtype,
                         custom_white_list=amp_cfg.custom_white_list,
                         custom_black_list=amp_cfg.custom_black_list)

    def _placed(self) -> bool:
        """Whether a plan of more than one mesh position drives training."""
        return self._plan_mesh is not None and \
            self._plan_mesh.devices.size > 1

    def _inputs_fn(self, mode="train"):
        """``(fn, names, live)``: ``fn(*params_and_buffers, *batch)`` gives
        the loss (``mode`` "predict": the model's outputs), with the
        model's parameters and buffers (``names``) taken from the leading
        arguments; ``live`` the model's own tensors in that order."""
        from .propagation import parameters_as_inputs

        fwd, names, _ = parameters_as_inputs(self._model)
        state = dict(self._model.named_parameters())
        state.update(self._model.named_buffers())
        n_p = len(names)

        def fn(*args):
            data = args[n_p:]
            if mode == "predict":
                return fwd(*args[:n_p], *data)
            n_in = len(data) - self._n_labels
            out = fwd(*args[:n_p], *data[:n_in])
            return self._loss_value(out, data[n_in:])
        return fn, names, [state[k] for k in names]

    @staticmethod
    def _fake(tensors, device=None):
        """Fake copies of ``tensors`` (shape, dtype and device, or
        ``device``; no memory): a placed model's whole tensors have no
        storage."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        mode = FakeTensorMode()
        if device is None:
            return [mode.from_tensor(t.detach()) for t in tensors]
        with mode:
            return [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                        device=device) for t in tensors]

    @staticmethod
    def _dp_specs(shapes, dp):
        """Each batch input cut on ``dp`` by its leading dim where ``dp``
        (> 1) divides it; ``dp`` None: the nominal cut of every input of
        a dim or more, as the JAX Engine annotates a captured graph."""
        from .propagation import DistSpec

        return [DistSpec(("dp",) + (None,) * (len(s) - 1))
                if len(s) >= 1 and (dp is None or (dp > 1 and s[0] % dp == 0))
                else None for s in shapes]

    def _executor(self, batch, mode="train"):
        """``(run, names)``: the propagation executor of the loss (of the
        outputs, for "predict") over the plan's mesh for batches of
        ``batch``'s shapes and label count, captured and propagated once
        a mode; "train" records autograd, the others run under
        ``torch.no_grad``."""
        from .propagation import apply_propagation

        key = (mode, self._n_labels) + tuple((tuple(t.shape), t.dtype)
                                             for t in batch)
        hit = self._execs.get(mode)
        if hit is not None and hit[0] == key:
            return hit[1], hit[2]
        fn, names, live = self._inputs_fn(mode)
        specs = [self._plan_specs.get(k) for k in names] + self._dp_specs(
            [tuple(t.shape) for t in batch],
            self._plan_mesh.shape.get("dp", 1))
        # captured on the mesh's first device, where the graph runs (a
        # model on the CPU planned over cards takes the cards' kernels)
        example = self._fake(list(live) + list(batch),
                             self._plan_mesh.devices.flat[0])
        t0 = time.perf_counter()
        with self._amp():
            run = apply_propagation(fn, self._plan_mesh, specs, *example,
                                    grad=mode == "train")
        # host seconds of the capture and the pass, read by the smoke run
        run.capture_seconds = time.perf_counter() - t0
        self._execs[mode] = (key, run, names)
        return run, names

    def _run_placed(self, batch, mode):
        """The executor of ``mode`` over the placed blocks and ``batch``:
        its outputs gathered whole."""
        from ..mesh import PlacedTensor

        run, names = self._executor(batch, mode)
        out = run(*self._placement.inputs(names), *batch)
        return torch.utils._pytree.tree_map(
            lambda a: a.gather() if isinstance(a, PlacedTensor) else a, out)

    def _train_step(self, batch):
        opt = self._optimizer
        if self._placed():
            loss = self._run_placed(batch, "train")
        else:
            n_in = len(batch) - self._n_labels
            with self._amp():
                out = self._model(*batch[:n_in])
                loss = self._loss_value(out, batch[n_in:])
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    def _note_inert_strategy(self):
        """A one-time note for the enabled passes the Engine leaves to
        placement rather than running itself, so nothing enabled is
        silently ignored."""
        if getattr(self, "_inert_noted", False):
            return
        self._inert_noted = True
        notes = []
        if self._strategy.pipeline.enable:
            notes.append("pipeline (use fleet PipelineParallel / the pp "
                         "mesh axis; Engine delegates placement to the "
                         "propagation pass)")
        if self._strategy.mp.enable:
            notes.append("mp (shard params via Engine.plan()/shard_tensor;"
                         " the propagation pass inserts the collectives)")
        for n in notes:
            sys.stderr.write(
                f"[paddle_tpu_torch.auto_parallel] Strategy.{n}\n")

    def _apply_passes(self):
        strat = self._strategy
        if strat.sharding.enable and not self._sharding_applied:
            from ..sharding import group_sharded_parallel

            level = {1: "os", 2: "os_g", 3: "p_g_os"}[int(
                strat.sharding.stage)]
            if self._placement is not None:
                # over the placed blocks; the executors read them anew
                group_sharded_parallel(self._placement, self._optimizer,
                                       level)
                self._execs = {}
            else:
                self._model, self._optimizer, _ = group_sharded_parallel(
                    self._model, self._optimizer, level)
            self._sharding_applied = True
        gm = strat.gradient_merge
        if gm.enable and gm.k_steps > 1 and not self._gm_applied:
            from ..fleet.meta_optimizers import GradientMerge

            self._optimizer = GradientMerge(self._optimizer,
                                            k_steps=gm.k_steps, avg=gm.avg)
            self._gm_applied = True

    # -- public API --------------------------------------------------------
    def fit(self, train_data, epochs=1, batch_size=None, steps_per_epoch=None,
            valid_data=None, collate_fn=None, callbacks=None, verbose=1,
            log_freq=10, n_labels=1):
        """Train; ``train_data`` is an iterable of ``(inputs..., labels...)``
        batches of numpy arrays or tensors.  Returns ``history``."""
        self._n_labels = n_labels
        self._apply_passes()
        self._note_inert_strategy()
        if callbacks:
            warnings.warn("Engine.fit callbacks are not supported yet; "
                          "use hapi.Model for callback-driven training")
        self._model.train()
        for epoch in range(epochs):
            for step_idx, batch in enumerate(train_data):
                if steps_per_epoch is not None and step_idx >= steps_per_epoch:
                    break
                loss = self._train_step(self._to_batch(batch))
                lv = float(loss)
                self.history["loss"].append(lv)
                if verbose and step_idx % log_freq == 0:
                    print(f"[Engine] epoch {epoch} step {step_idx} loss "
                          f"{lv:.6f}")
            if valid_data is not None:
                ev = self.evaluate(valid_data, n_labels=n_labels)
                self.history.setdefault("eval_loss", []).append(
                    ev["eval_loss"])
                if verbose:
                    print(f"[Engine] epoch {epoch} eval_loss "
                          f"{ev['eval_loss']:.6f}")
        return self.history

    def evaluate(self, valid_data, batch_size=None, steps=None, verbose=1,
                 n_labels=1):
        self._n_labels = n_labels
        was_training = getattr(self._model, "training", True)
        self._model.eval()
        losses = []
        for step_idx, batch in enumerate(valid_data):
            if steps is not None and step_idx >= steps:
                break
            batch = self._to_batch(batch)
            if self._placed():
                losses.append(float(self._run_placed(batch, "eval")))
                continue
            n_in = len(batch) - n_labels
            with torch.no_grad(), self._amp():
                out = self._model(*batch[:n_in])
                losses.append(float(self._loss_value(out, batch[n_in:])))
        if was_training:
            self._model.train()
        return {"eval_loss": float(np.mean(losses)) if losses
                else float("nan")}

    def predict(self, test_data, steps=None):
        was_training = getattr(self._model, "training", True)
        self._model.eval()
        outs = []
        for step_idx, batch in enumerate(test_data):
            if steps is not None and step_idx >= steps:
                break
            if self._placed():
                outs.append(self._run_placed(self._to_batch(batch),
                                             "predict"))
                continue
            with torch.no_grad(), self._amp():
                outs.append(self._model(*self._to_batch(batch)))
        if was_training:
            self._model.train()
        return outs

    # -- checkpointing (reference dist_saver.py DistributedSaver) ----------
    def _checkpoint_root(self, directory: str) -> str:
        """The checkpoint root: ``directory`` as given.  The JAX Engine
        suffixes ``host-<i>`` on a multi-host job; the port runs one
        process (ROADMAP.md queue 1, item 10)."""
        return directory

    def checkpoint_manager(self, directory, keep_last_k=None,
                           async_save=None):
        """The Engine's ``CheckpointManager`` and ``TrainState`` for
        ``directory`` (cached per directory: a directory has one writer).
        ``keep_last_k``/``async_save`` default to None, "keep the
        manager's setting"; a value given updates the cached manager."""
        from ...checkpoint import CheckpointManager, TrainState

        cache = getattr(self, "_ckpt_managers", None)
        if cache is None:
            cache = self._ckpt_managers = {}
        if directory not in cache:
            cache[directory] = (
                CheckpointManager(
                    self._checkpoint_root(directory),
                    keep_last_k=3 if keep_last_k is None else keep_last_k,
                    async_save=True if async_save is None else async_save),
                TrainState(self._model, self._optimizer),
            )
        else:
            manager = cache[directory][0]
            if keep_last_k is not None:
                manager._keep = max(int(keep_last_k), 1)
            if async_save is not None:
                manager._async = bool(async_save)
        return cache[directory]

    def save_checkpoint(self, directory, step, epoch=0, blocking=None,
                        keep_last_k=None):
        """Crash-consistent save of model and optimizer (and RNG) through
        ``CheckpointManager``: atomic commit, async writer, keep-K."""
        manager, state = self.checkpoint_manager(directory,
                                                 keep_last_k=keep_last_k)
        manager.save(state.capture(position={"epoch": epoch, "step": step}),
                     step=step, epoch=epoch, blocking=blocking)
        return manager

    def load_checkpoint(self, directory):
        """Restore the newest valid checkpoint under ``directory``; returns
        its position dict, or None when nothing valid exists."""
        manager, state = self.checkpoint_manager(directory)
        info = manager.latest()
        if info is None:
            return None
        tree, _ = manager.restore(info)
        return state.restore(tree)

    def save(self, path, training=True):
        """``path.pdparams`` (the model's state dict) and, with
        ``training``, ``path.pdopt`` (the optimizer's), each written to a
        temporary file, synced and renamed into place."""
        from ..sharding import _atomic_save

        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        _atomic_save(self._model.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _atomic_save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, strict=True, load_optimizer=True):
        self._model.load_state_dict(
            torch.load(path + ".pdparams", map_location=self.device,
                       weights_only=False), strict=strict)
        if load_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(torch.load(
                path + ".pdopt", map_location=self.device,
                weights_only=False))

    # -- planning (reference static/engine.py:729 _plan + parallel_tuner) --
    def _model_spec(self, batch=8):
        """The transformer-shaped analytic spec, for a model carrying a GPT
        config; other models are planned from their measured graph."""
        from .planner import ModelSpec

        cfg = getattr(self._model, "config", None)
        if cfg is not None and hasattr(cfg, "hidden_size"):
            return ModelSpec.from_gpt_config(cfg, batch=batch)
        return None

    # -- graph capture + Completer-analog propagation ----------------------
    def capture_graph(self, *sample_batch, n_labels=1):
        """Capture the forward and loss as an aten graph with the model's
        parameters and buffers as its leading inputs, then the batch: on
        fake tensors, so nothing is computed."""
        from .propagation import capture_graph

        self._n_labels = n_labels
        sample = self._to_batch(sample_batch)
        fn, names, live = self._inputs_fn()
        with self._amp():
            gm = capture_graph(fn, *self._fake(list(live) + list(sample)))
        self._captured = (gm, names, live, len(sample))
        return gm

    def _param_specs(self, mesh_axes):
        """The Megatron placement decisions as a ``DistSpec`` a captured
        input (None: replicated), in the captured order."""
        from .planner import placement_decisions
        from .propagation import DistSpec

        _, names, _, _ = self._captured
        spec_by_key = {k: DistSpec(tuple(dims)) for k, _, dims in
                       placement_decisions(self._model,
                                           mesh_axes.get("mp", 1))}
        return [spec_by_key.get(k) for k in names]

    def _sample_shapes(self):
        """The captured batch inputs' shapes."""
        gm, names, _, _ = self._captured
        phs = [n for n in gm.graph.nodes if n.op == "placeholder"]
        return [tuple(n.meta["val"].shape) for n in phs[len(names):]]

    def propagate(self, mesh_axes=None):
        """Run the Completer-analog pass over the captured graph: a
        ``DistSpec`` for every node and the recorded reshards.  Needs
        :meth:`capture_graph` first."""
        from .propagation import propagate_graph

        gm = self._captured[0]
        if mesh_axes is None:
            if hasattr(self, "_planned"):
                mesh_axes = {ax: n for ax, n
                             in self._planned[0].mesh.items() if n > 1}
            else:
                mesh_axes = {}
        specs = self._param_specs(mesh_axes) + self._dp_specs(
            self._sample_shapes(), mesh_axes.get("dp", 1))
        self._propagation = propagate_graph(gm, specs, mesh_axes or None)
        return self._propagation

    def cost(self, mode="train", batch=8, cluster=None):
        """Per-candidate cost estimates: every dp*mp*pp factorization of
        the device count (default ``len(devices)``), scored by the
        roofline model, ranked feasible first.  A non-GPT model is scored
        from its captured graph's measured FLOPs and bytes."""
        from .planner import ClusterSpec, plan

        if cluster is None:
            cluster = ClusterSpec(n_devices=len(self._device_list()))
        spec = self._model_spec(batch=batch)
        if spec is not None:
            cands = plan(spec, cluster)
        else:
            cands = self._measured_candidates(cluster)
        return {"candidates": [c.as_dict() for c in cands],
                "best": cands[0].mesh if cands else None}

    def _measured_candidates(self, cluster):
        from .planner import plan_measured
        from .propagation import graph_cost

        if not hasattr(self, "_captured"):
            raise ValueError(
                "non-GPT models need a captured graph for planning: call "
                "Engine.capture_graph(*sample_batch) first (the analytic "
                "ModelSpec path only covers transformer configs)")
        gm, _, live, _ = self._captured
        # propagation under a nominal mp/dp layout gives the measured
        # reshard bytes (axis names suffice: sizes are scored per
        # candidate)
        specs = self._param_specs({"mp": 2}) + self._dp_specs(
            self._sample_shapes(), None)
        measured = graph_cost(gm, specs)
        param_bytes = float(sum(p.numel() * p.element_size()
                                for p in self._model.parameters()))
        return plan_measured(measured["flops"], measured["bytes"],
                             param_bytes, cluster,
                             comm_bytes=measured["comm_bytes"])

    def plan(self, batch=8, cluster=None, sample_batch=None, n_labels=1):
        """Pick the best mesh factorization, build it over ``devices``
        and install it (``mesh.set_mesh``), give the model's parameters
        the Megatron placements for ``fit``, and (with a captured graph)
        run the propagation pass.  GPT-config models use the analytic
        spec; any other model is planned from its captured graph."""
        from .planner import ClusterSpec, apply_placement_rules, plan

        devices = self._device_list()
        if cluster is None:
            cluster = ClusterSpec(n_devices=len(devices))
        spec = self._model_spec(batch=batch)
        if spec is not None:
            cands = plan(spec, cluster)
        else:
            if sample_batch is not None and not hasattr(self, "_captured"):
                self.capture_graph(*sample_batch, n_labels=n_labels)
            cands = self._measured_candidates(cluster)
        best = cands[0]
        mesh_axes = {ax: n for ax, n in best.mesh.items() if n > 1} or \
            {"dp": 1}
        mesh = _mesh.build_mesh(mesh_axes, devices)
        self._unplace()
        _mesh.set_mesh(mesh)
        self._plan_specs = {}
        n_placed = apply_placement_rules(self._model, best.mesh,
                                         self._plan_specs)
        self._planned = (best, n_placed)
        self._plan_mesh = mesh
        self._execs = {}
        if self._placed():
            self._place()
        if hasattr(self, "_captured"):
            self.propagate(mesh_axes)
        return best

    # -- placement ---------------------------------------------------------
    def _place(self):
        """The model's tensors as blocks over the plan's mesh, the
        optimizer moved to them, and the model's state dicts whole
        (module docstring)."""
        from .placed import place_model, repoint_optimizer, state_dict_hooks

        self._placement = place_model(self._model, self._plan_mesh,
                                      self._plan_specs)
        if self._optimizer is not None:
            repoint_optimizer(self._optimizer, self._placement)
        self._placement_hooks = state_dict_hooks(self._model,
                                                 self._placement)

    def _unplace(self):
        """The model whole on its device again, the optimizer with it and
        ZeRO undone (it is applied again over the next placement)."""
        if self._placement is None:
            return
        for h in self._placement_hooks:
            h.remove()
        self._placement_hooks = []
        self._placement.unplace(self._optimizer)
        self._placement = None
        self._sharding_applied = False
        self._execs = {}

    @property
    def placement(self):
        """The placed blocks (``placed.PlacedModel``) under a plan of more
        than one position, else None."""
        return self._placement
