"""Parameter initializers (ref ``python/paddle/fluid/initializer.py``).

Each initializer appends ONE init op to the startup program. Running the
startup program draws every random parameter from the scope's
``torch.Generator``, which lives on the executor's device and is seeded
from ``program.random_seed`` (see ``core/executor.py``). Torch's Philox and
JAX's threefry give different numbers from one seed: parity tests copy
weights across (``bridge.py``) instead of re-drawing them.
"""

import math

import numpy as np

__all__ = [
    "Constant", "Uniform", "Normal", "Xavier",
    "ConstantInitializer", "UniformInitializer", "NormalInitializer",
    "XavierInitializer",
]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _fans(var):
        shape = var.shape
        if len(shape) < 2:
            fan_in = fan_out = int(shape[0]) if shape else 1
        else:
            receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
            fan_in = int(shape[1]) * receptive
            fan_out = int(shape[0]) * receptive
        return fan_in, fan_out


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            "fill_constant", outputs={"Out": var},
            attrs={"shape": var.shape, "dtype": str(var.dtype),
                   "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            "uniform_random", outputs={"Out": var},
            attrs={"shape": var.shape, "dtype": str(var.dtype),
                   "min": self.low, "max": self.high, "seed": self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            "gaussian_random", outputs={"Out": var},
            attrs={"shape": var.shape, "dtype": str(var.dtype),
                   "mean": self.loc, "std": self.scale, "seed": self.seed})


class XavierInitializer(Initializer):
    """Glorot init (ref ``initializer.py`` XavierInitializer)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in, self.fan_out, self.seed = fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = self._fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


# aliases matching the reference's short names
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
