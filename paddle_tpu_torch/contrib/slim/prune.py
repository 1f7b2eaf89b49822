"""Magnitude pruning (the port's ``paddle_tpu/contrib/slim/prune.py``; ref
``contrib/slim/prune/pruner.py`` RatioPruner + ``sensitive.py``
sensitivity analysis — the slim toolkit's prune strategy).

Sparsity here is value-level (zeroed weights in dense tensors): the
capability is the model-compression workflow (prune -> finetune -> export
a smaller int8 bundle), not sparse kernels (the 2019 reference's is
value-level too). Each pruned weight stays on its device."""

import numpy as np

from ...checkpoint import apply_updates
from ...core.executor import to_numpy

__all__ = ["Pruner", "sensitivity"]


class Pruner:
    """Zero the smallest-|w| fraction of each named parameter."""

    def __init__(self, ratios):
        # {param name: fraction in [0, 1)}
        self.ratios = dict(ratios)

    def prune(self, scope, lazy=False):
        """Apply masks in the scope; returns {name: mask} so finetuning
        loops can re-apply after each update (ref Pruner.prune's
        backup/lazy semantics)."""
        masks = {}
        for name, ratio in self.ratios.items():
            w = to_numpy(scope.get(name))
            k = int(round(w.size * ratio))
            mask = np.ones(w.shape, dtype=bool)
            if k > 0:
                thresh = np.partition(np.abs(w).reshape(-1), k - 1)[k - 1]
                mask = np.abs(w) > thresh
            masks[name] = mask
            if not lazy:
                apply_updates(scope, [(name, w * mask)])
        return masks


def sensitivity(eval_fn, scope, param_names, ratios=(0.1, 0.3, 0.5, 0.7)):
    """Per-parameter accuracy-vs-prune-ratio curves: prune one param at a
    time, call ``eval_fn() -> metric``, restore, move on."""
    out = {}
    for name in param_names:
        orig = to_numpy(scope.get(name))
        curve = {}
        for r in ratios:
            Pruner({name: r}).prune(scope)
            curve[r] = float(eval_fn())
            apply_updates(scope, [(name, orig)])
        out[name] = curve
    return out
