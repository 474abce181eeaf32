"""The inference Predictor (port of ``paddle_tpu/inference/__init__.py``):
``Config``, ``Predictor``, ``create_predictor`` and ``PredictorPool``
over a LIVE causal LM.

Two modes, one of which ``Config`` must choose:

- ``enable_causal_lm_decode``: ``Predictor.run`` is ``model.generate()``
  over the prompt rows of input handle ``x0`` (``models/generation.py``:
  the flash forward for the prompt, the decode kernel for every later
  token);
- ``enable_serving_mode``: every prompt row becomes a request of ONE
  ``ServingEngine`` shared by every Predictor of the ``Config``, so
  concurrent predictors batch against each other; rows that stop early
  on eos are padded with it, and a row that ends CANCELLED, TIMED_OUT or
  FAILED re-raises its typed serving error.

The Predictor runs on the live model's device and never moves the model:
``disable_gpu()`` with a model on the card raises.  The reference's other
path, a saved StableHLO program loaded by ``jit.load``, is not ported
(ROADMAP.md queue 1, item 10).  The option handling is host code, copied
from the JAX package.
"""
from __future__ import annotations

import contextlib
import queue
import sys
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = [
    "Config", "Predictor", "Tensor", "create_predictor",
    "DataType", "PlaceType", "PrecisionType", "get_version",
    "get_num_bytes_of_data_type", "PredictorPool",
]


class DataType:
    FLOAT32 = "float32"
    FLOAT16 = "float16"
    BFLOAT16 = "bfloat16"
    INT32 = "int32"
    INT64 = "int64"
    INT8 = "int8"
    UINT8 = "uint8"
    BOOL = "bool"


class PlaceType:
    CPU = "cpu"
    GPU = "gpu"


class PrecisionType:
    Float32 = "fp32"
    Bfloat16 = "bf16"
    Half = "fp16"
    Int8 = "int8"


class Config:
    """The reference's ``Config``: the model and the run's options.  The
    pass toggles are accepted and recorded in ``summary()``; they change
    nothing (PyTorch runs eagerly)."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        self._model_prefix = prog_file
        self._use_gpu = True
        self._device_id = 0
        self._enable_memory_optim = True
        self._switches: Dict[str, object] = {}
        self._causal_lm_model = None
        self._decode_opts: Optional[Dict[str, object]] = None
        self._serving_opts: Optional[Dict[str, object]] = None
        # ONE ServingEngine (and page pool) per Config, shared by every
        # Predictor created from it
        self._serving_engine = None
        self._serving_lock = threading.Lock()

    def set_model(self, prog_file, params_file=None):
        self._model_prefix = prog_file

    # -- causal-LM decode mode --------------------------------------------
    def set_causal_lm_model(self, model):
        """Serve a LIVE causal LM (a model with ``generate()``)."""
        self._causal_lm_model = model
        return self

    def enable_causal_lm_decode(self, max_new_tokens: int = 32,
                                do_sample: bool = False,
                                temperature: float = 1.0, top_k: int = 0,
                                top_p: Optional[float] = None,
                                eos_token_id: Optional[int] = None,
                                max_seq_len: Optional[int] = None,
                                cache_dtype: str = "bfloat16"):
        """``Predictor.run`` decodes: input handle x0 takes int64 prompt
        ids [B, S0]; output handle out0 returns [B, S0 + max_new_tokens]
        ids."""
        if self._serving_opts is not None:
            raise RuntimeError(
                "enable_causal_lm_decode and enable_serving_mode are "
                "mutually exclusive -- pick the single-shot decode path or "
                "the paged continuous-batching engine")
        self._decode_opts = dict(
            max_new_tokens=int(max_new_tokens), do_sample=bool(do_sample),
            temperature=float(temperature), top_k=int(top_k), top_p=top_p,
            eos_token_id=eos_token_id, max_seq_len=max_seq_len,
            cache_dtype=str(cache_dtype))
        return self

    def causal_lm_decode_enabled(self) -> bool:
        return self._decode_opts is not None

    def enable_serving_mode(self, max_new_tokens: int = 32,
                            num_slots: int = 4, page_size: int = 128,
                            max_context: Optional[int] = None,
                            num_pages: Optional[int] = None,
                            cache_dtype: str = "bfloat16",
                            prefill_chunk: Optional[int] = None,
                            do_sample: bool = False,
                            temperature: float = 1.0, top_k: int = 0,
                            top_p: float = 1.0,
                            eos_token_id: Optional[int] = None,
                            deadline_s: Optional[float] = None,
                            max_queue_depth: Optional[int] = None,
                            max_queue_wait_s: Optional[float] = None,
                            stall_budget_s: Optional[float] = None):
        """``Predictor.run`` serves each prompt row as a request of the
        Config's shared ``ServingEngine``.  The fault-containment knobs
        pass through to the engine (``deadline_s`` to each request)."""
        if self._decode_opts is not None:
            raise RuntimeError(
                "enable_serving_mode and enable_causal_lm_decode are "
                "mutually exclusive -- pick the paged continuous-batching "
                "engine or the single-shot decode path")
        self._serving_opts = dict(
            max_new_tokens=int(max_new_tokens), num_slots=int(num_slots),
            page_size=int(page_size), max_context=max_context,
            num_pages=num_pages, cache_dtype=str(cache_dtype),
            prefill_chunk=prefill_chunk, do_sample=bool(do_sample),
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p), eos_token_id=eos_token_id,
            deadline_s=deadline_s, max_queue_depth=max_queue_depth,
            max_queue_wait_s=max_queue_wait_s,
            stall_budget_s=stall_budget_s)
        return self

    def serving_mode_enabled(self) -> bool:
        return self._serving_opts is not None

    def _get_serving_engine(self):
        """The Config-shared ServingEngine, built on first use."""
        with self._serving_lock:
            if self._serving_engine is None:
                from ..serving import ServingEngine

                o = self._serving_opts
                self._serving_engine = ServingEngine(
                    self._causal_lm_model, num_slots=o["num_slots"],
                    page_size=o["page_size"], max_context=o["max_context"],
                    num_pages=o["num_pages"], cache_dtype=o["cache_dtype"],
                    prefill_chunk=o["prefill_chunk"],
                    max_queue_depth=o["max_queue_depth"],
                    max_queue_wait_s=o["max_queue_wait_s"],
                    stall_budget_s=o["stall_budget_s"])
            return self._serving_engine

    def model_dir(self):
        return self._model_prefix

    def prog_file(self):
        return self._model_prefix

    # device selection (reference enable_use_gpu / disable_gpu)
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_gpu = True
        self._device_id = device_id

    def disable_gpu(self):
        self._use_gpu = False

    def use_gpu(self):
        return self._use_gpu

    def _note_inert(self, knob, value):
        """One notice per knob: the switch is recorded, and changes
        nothing."""
        if knob not in self._switches:
            sys.stderr.write(
                f"[paddle_tpu_torch.inference] Config.{knob}={value!r} "
                "accepted; inert (PyTorch runs eagerly)\n")
        self._switches[knob] = value

    def enable_memory_optim(self, flag=True):
        self._enable_memory_optim = flag
        self._note_inert("memory_optim", flag)

    def switch_ir_optim(self, flag=True):
        self._note_inert("ir_optim", flag)

    def switch_use_feed_fetch_ops(self, flag=False):
        self._note_inert("feed_fetch", flag)

    def set_cpu_math_library_num_threads(self, n):
        self._note_inert("cpu_threads", n)

    def summary(self):
        lines = [f"model: {self._model_prefix}",
                 f"device: {'gpu' if self._use_gpu else 'cpu'}:"
                 f"{self._device_id}"]
        if self._decode_opts is not None:
            lines.append(f"causal_lm_decode: {self._decode_opts}")
        if self._serving_opts is not None:
            lines.append(f"serving_mode: {self._serving_opts}")
        lines += [f"{k}: {v}" for k, v in self._switches.items()]
        return "\n".join(lines)


class Tensor:
    """A named input or output handle: ``copy_from_cpu`` binds,
    ``copy_to_cpu`` fetches (numpy)."""

    def __init__(self, name: str, owner: "Predictor"):
        self._name = name
        self._owner = owner

    def name(self):
        return self._name

    def copy_from_cpu(self, data):
        self._owner._inputs[self._name] = np.asarray(data)

    def share_external_data(self, tensor):
        self._owner._inputs[self._name] = tensor    # a torch tensor as is

    def copy_to_cpu(self):
        return _numpy(self._owner._outputs[self._name])

    def shape(self):
        v = (self._owner._outputs.get(self._name)
             if self._name in self._owner._outputs
             else self._owner._inputs.get(self._name))
        return list(v.shape) if v is not None else None


def _numpy(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class Predictor:
    """Runs ``Config``'s live model in its chosen mode.  One Predictor is
    not safe for concurrent ``run()`` (its handles are per-call state);
    distinct Predictors of one Config are."""

    def __init__(self, config: Config):
        self._config = config
        self._causal_lm = config._causal_lm_model
        modes = (config.causal_lm_decode_enabled()
                 or config.serving_mode_enabled())
        if modes and self._causal_lm is None:
            raise RuntimeError(
                "enable_causal_lm_decode()/enable_serving_mode() need a "
                "live model: attach it with Config.set_causal_lm_model("
                "model)")
        if self._causal_lm is not None and not modes:
            raise RuntimeError(
                "set_causal_lm_model() without enable_causal_lm_decode() "
                "or enable_serving_mode(): decode options must be chosen "
                "explicitly (max_new_tokens, sampling, cache dtype) -- "
                "call one of them before create_predictor")
        if self._causal_lm is None:
            raise NotImplementedError(
                "Predictor of a saved program (jit.load of "
                f"{config.prog_file()!r}) is not ported: ROADMAP.md queue "
                "1, item 10, jit; attach a live model with "
                "Config.set_causal_lm_model(model)")
        if not hasattr(self._causal_lm, "generate"):
            raise RuntimeError("set_causal_lm_model expects a model with "
                               "generate() (GenerationMixin)")
        self._check_device()
        self._input_names = ["x0"]
        self._inputs: Dict[str, object] = {}
        self._outputs: Dict[str, torch.Tensor] = {}
        self._output_names: List[str] = []

    def _check_device(self):
        """The Predictor runs on the live model's device; it never moves
        the model."""
        device = getattr(self._causal_lm, "device", None)
        if (not self._config.use_gpu() and device is not None
                and torch.device(device).type == "cuda"):
            raise RuntimeError(
                "Config.disable_gpu(): the live model is on the card, and "
                "the Predictor never moves it -- build the model with "
                "device='cpu' to run on the CPU")

    def get_input_names(self):
        return list(self._input_names)

    def get_input_handle(self, name: str) -> Tensor:
        return Tensor(name, self)

    def get_output_names(self):
        return list(self._output_names)

    def get_output_handle(self, name: str) -> Tensor:
        return Tensor(name, self)

    def run(self, inputs: Optional[list] = None):
        """Run the bound inputs (or ``inputs``, a list of arrays or
        tensors, bound to x0, x1, ...).  Returns True, or with ``inputs``
        the outputs as tensors."""
        self._check_device()
        if inputs is not None:
            for i, a in enumerate(inputs):
                self._inputs[f"x{i}"] = a
        ids = self._inputs["x0"]
        if self._config.serving_mode_enabled():
            out = self._run_serving(ids)
        else:
            out = self._causal_lm.generate(ids,
                                           **self._config._decode_opts)
        self._output_names = ["out0"]
        self._outputs = {"out0": out}
        if inputs is not None:
            return [out]
        return True

    def _run_serving(self, ids) -> torch.Tensor:
        """Serving mode: each prompt row becomes a request through the
        Config-shared engine; this thread steps the engine until ITS
        requests are terminal (other predictors' requests ride in the same
        steps).  Rows that stop early on eos are padded with it (0 without
        an eos id).  A row that ends CANCELLED / TIMED_OUT / FAILED
        re-raises its typed serving error (one such row: its own error;
        several: a ``ServingError`` naming each); an over-full queue raises
        ``Overloaded`` from submit, after cancelling the rows of this batch
        already queued."""
        from ..serving import RequestState, SamplingParams, ServingError

        o = self._config._serving_opts
        eng = self._config._get_serving_engine()
        sp = SamplingParams(do_sample=o["do_sample"],
                            temperature=o["temperature"],
                            top_k=o["top_k"], top_p=o["top_p"])
        prompts = _numpy(ids).astype(np.int64)
        if prompts.ndim == 1:
            prompts = prompts[None, :]
        reqs = []
        try:
            for row in prompts:
                reqs.append(eng.submit(row, o["max_new_tokens"], sampling=sp,
                                       eos_token_id=o["eos_token_id"],
                                       deadline_s=o["deadline_s"]))
        except Exception:
            # a mid-batch shed must not strand the rows already queued in
            # the SHARED engine: cancel them and step once so the reap
            # retires them before re-raising
            for r in reqs:
                r.cancel()
            if reqs:
                eng.step()
            raise
        while not all(r.terminal for r in reqs):
            eng.step()
        bad = [r for r in reqs if r.state != RequestState.DONE]
        if bad:
            detail = "; ".join(
                f"row {i}: {r.state}"
                + (f" ({type(r.error).__name__}: {r.error})" if r.error
                   else "")
                for i, r in enumerate(reqs) if r.state != RequestState.DONE)
            first = bad[0]
            if len(bad) == 1 and isinstance(first.error, ServingError):
                raise first.error
            raise ServingError(
                f"{len(bad)}/{len(reqs)} serving request(s) did not "
                f"complete: {detail}") from first.error
        n = o["max_new_tokens"]
        out = np.empty((len(reqs), prompts.shape[1] + n), np.int64)
        for i, r in enumerate(reqs):
            pad = r.eos_token_id if r.eos_token_id is not None else 0
            toks = list(r.tokens) + [pad] * (n - len(r.tokens))
            out[i] = np.concatenate([r.prompt, np.asarray(toks, np.int64)])
        return torch.from_numpy(out)

    def clear_intermediate_tensor(self):
        pass

    def try_shrink_memory(self):
        pass


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


def get_version():
    from .. import __version__

    return __version__


def get_num_bytes_of_data_type(dtype) -> int:
    return int(np.dtype(str(dtype)).itemsize)


class PredictorPool:
    """N predictors sharing one ``Config``: one live model, one decode
    engine cache or serving engine.  ``acquire``/``release`` (or the
    ``predictor()`` context) hand out exclusive predictors;
    ``retrive(idx)`` (sic, the reference's spelling) is the unmanaged
    accessor."""

    def __init__(self, config: Config, size: int = 1):
        if size < 1:
            raise ValueError(f"PredictorPool size must be >= 1, got {size}")
        self._predictors = [Predictor(config) for _ in range(size)]
        self._free: "queue.Queue[Predictor]" = queue.Queue()
        for p in self._predictors:
            self._free.put(p)
        self._out_lock = threading.Lock()
        self._out: set = set()

    @property
    def size(self) -> int:
        return len(self._predictors)

    def retrive(self, idx: int) -> Predictor:  # (sic) reference spelling
        return self._predictors[idx]

    retrieve = retrive

    def acquire(self, timeout: Optional[float] = None) -> Predictor:
        """An exclusive predictor; blocks until one is free."""
        try:
            p = self._free.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                f"no free predictor after {timeout}s (pool size "
                f"{len(self._predictors)})") from None
        with self._out_lock:
            self._out.add(id(p))
        return p

    def release(self, predictor: Predictor):
        with self._out_lock:
            if id(predictor) not in self._out:
                raise ValueError(
                    "release() of a predictor that is not checked out "
                    "(double release, or not from acquire())")
            self._out.discard(id(predictor))
        self._free.put(predictor)

    @contextlib.contextmanager
    def predictor(self, timeout: Optional[float] = None):
        """``with pool.predictor() as p: p.run(...)``"""
        p = self.acquire(timeout=timeout)
        try:
            yield p
        finally:
            self.release(p)
