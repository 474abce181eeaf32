"""``DistributedStrategy`` (port of
``paddle_tpu/distributed/fleet/base/distributed_strategy.py``): a plain
config object carrying the reference's knobs and defaults.  The fleet
API reads ``hybrid_configs``, ``pipeline_configs`` and the meta-optimizer
flags ``lars``, ``dgc``, ``localsgd`` and ``gradient_merge`` with their
configs (``fleet.distributed_optimizer``)."""
from __future__ import annotations

import copy


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
            "order": ["dp", "pp", "sharding", "sep", "mp"],
        }
        self.amp = False
        self.amp_configs = {
            "init_loss_scaling": 32768.0,
            "custom_white_list": [],
            "custom_black_list": [],
            "use_pure_fp16": False,
            "use_bf16": True,
        }
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1,
                                 "schedule_mode": "1F1B"}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.sharding = False
        self.sharding_configs = {"stage": 1, "degree": 1}
        self.lamb = False
        self.lars = False
        self.lars_configs = {"lars_coeff": 0.001,
                             "lars_weight_decay": 0.0005,
                             "epsilon": 1e-9,
                             "exclude_from_weight_decay": []}
        self.dgc = False
        self.dgc_configs = {"rampup_begin_step": 0, "sparsity": [0.999]}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 4, "begin_step": 1}
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.find_unused_parameters = False
        self.heter_ccl_mode = False
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}
        self.without_graph_optimization = False

    def __deepcopy__(self, memo):
        new = DistributedStrategy()
        for k, v in self.__dict__.items():
            setattr(new, k, copy.deepcopy(v, memo))
        return new

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"
