"""Imperative (dygraph) mode (``paddle_tpu/dygraph``; ref
``python/paddle/fluid/imperative/``).

Eager execution over torch tensors with a Layer/module system;
``to_variable`` wraps arrays, ``VarBase.backward`` differentiates the
tape autograd records, and ``Layer.functional()`` exports the pure apply
a train step differentiates and ``CapturedTrainStep`` captures as one
CUDA graph.
"""

from . import base
from .base import (guard, to_variable, enabled, no_grad,  # noqa: F401
                   record, VarBase)
from .layers import Layer  # noqa: F401
from . import nn  # noqa: F401
from . import optimizer  # noqa: F401
from .optimizer import (SGDOptimizer, AdamOptimizer,  # noqa: F401
                        MomentumOptimizer, AdagradOptimizer, LambOptimizer)
from .capture import CapturedTrainStep  # noqa: F401
