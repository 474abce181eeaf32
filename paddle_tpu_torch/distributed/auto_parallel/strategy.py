"""auto_parallel Strategy (port of ``paddle_tpu/distributed/auto_parallel/
strategy.py``; reference: Paddle's ``auto_parallel/strategy.py`` and
``constants.py``): nested config objects with an ``enable`` switch per
pass, the same keys, defaults and refusals as the JAX package's."""
from __future__ import annotations

__all__ = ["Strategy", "AMPConfig", "RecomputeConfig", "ShardingConfig",
           "GradientMergeConfig", "PipelineConfig", "MPConfig"]


class _Config:
    _fields = {}

    def __init__(self, **kw):
        unknown = set(kw) - set(self._fields)
        if unknown:
            raise ValueError(
                f"unknown {type(self).__name__} keys: {sorted(unknown)}")
        for k, v in {**self._fields, **kw}.items():
            setattr(self, k, v)

    def to_dict(self):
        return {k: getattr(self, k) for k in self._fields}


class AMPConfig(_Config):
    _fields = {"enable": False, "dtype": "bfloat16", "level": "O1",
               "init_loss_scaling": 32768.0, "custom_white_list": None,
               "custom_black_list": None, "use_master_weights": True}


class RecomputeConfig(_Config):
    _fields = {"enable": False, "checkpoints": None,
               "refined_ops_patterns": None}


class ShardingConfig(_Config):
    _fields = {"enable": False, "stage": 1, "degree": 1,
               "overlap_grad_comm": True}


class GradientMergeConfig(_Config):
    _fields = {"enable": False, "k_steps": 1, "avg": True}


class PipelineConfig(_Config):
    _fields = {"enable": False, "schedule_mode": "1F1B",
               "micro_batch_size": 1, "accumulate_steps": 1}


class MPConfig(_Config):
    _fields = {"enable": False, "degree": 1}


class Strategy(_Config):
    """The reference's ``Strategy``: ``auto_mode``, ``seed`` and
    ``split_data``, and one nested config a pass (``amp``, ``recompute``,
    ``sharding``, ``gradient_merge``, ``pipeline``, ``mp``), each given as
    a dict or a config object.  ``to_dict()`` holds the top-level keys, as
    the JAX package's does."""

    _fields = {"auto_mode": "semi", "seed": None, "split_data": True}

    _nested = {"amp": AMPConfig, "recompute": RecomputeConfig,
               "sharding": ShardingConfig,
               "gradient_merge": GradientMergeConfig,
               "pipeline": PipelineConfig, "mp": MPConfig}

    def __init__(self, config=None):
        config = dict(config or {})
        nested_cfg = {k: config.pop(k) for k in list(config)
                      if k in self._nested}
        unknown = set(config) - set(self._fields)
        if unknown:
            raise ValueError(f"unknown Strategy keys: {sorted(unknown)}")
        super().__init__(**config)
        for name, cls in self._nested.items():
            sub = nested_cfg.get(name, {})
            if isinstance(sub, _Config):
                setattr(self, name, sub)
            else:
                setattr(self, name, cls(**sub))
