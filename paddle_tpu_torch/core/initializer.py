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
    "Constant", "Uniform", "Normal", "TruncatedNormal", "Xavier", "MSRA",
    "Bilinear", "ConstantInitializer", "UniformInitializer",
    "NormalInitializer", "TruncatedNormalInitializer", "XavierInitializer",
    "MSRAInitializer", "BilinearInitializer", "NumpyArrayInitializer",
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


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            "truncated_gaussian_random", outputs={"Out": var},
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


class MSRAInitializer(Initializer):
    """Kaiming/He init (ref ``initializer.py`` MSRAInitializer)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = self._fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            NormalInitializer(0.0, math.sqrt(2.0 / fi), self.seed)(var, block)


class BilinearInitializer(Initializer):
    """Bilinear upsampling kernel for a transposed conv (ref
    ``initializer.py`` BilinearInitializer)."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("BilinearInitializer needs a 4-D weight")
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        size = shape[3]
        i = np.arange(int(np.prod(shape)))
        x, y = i % size, (i // size) % size
        weight = ((1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))).astype(
            "float32")
        block.append_op(
            "assign_value", outputs={"Out": var},
            attrs={"shape": shape, "dtype": "float32",
                   "values": weight.tolist()})


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        block.append_op(
            "assign_value", outputs={"Out": var},
            attrs={"shape": self.value.shape, "dtype": str(self.value.dtype),
                   "values": self.value.flatten().tolist()})


# aliases matching the reference's short names
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer
