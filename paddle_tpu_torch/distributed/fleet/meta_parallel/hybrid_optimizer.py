"""``HybridParallelOptimizer`` (port of
``paddle_tpu/distributed/fleet/meta_parallel/hybrid_optimizer.py``): a
delegator over the inner optimizer.

The reference (``hybrid_parallel_optimizer.py`` of Paddle) re-implements
the global-norm clip with all-reduces over the mp and pp groups, since
each rank holds only shards.  One process of the port holds every part,
and the inner optimizer's ``ClipGradByGlobalNorm`` already counts each
logical tensor once over its parts (``shards.shard_info``), so its norm
is the global one: the wrapper adds nothing to it."""
from __future__ import annotations

__all__ = ["HybridParallelOptimizer"]


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg

    def step(self):
        self._inner_opt.step()

    def clear_grad(self, set_to_zero=False):
        self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)
