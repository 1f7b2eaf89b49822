"""Dygraph Layer/module system (``paddle_tpu/dygraph/layers.py``; ref
``python/paddle/fluid/imperative/layers.py:28``).

Layers own named parameters (VarBases over tensors on the guard's
device) and compose; ``functional()`` exports ``apply(params, *inputs)``
and the parameter dict, so a train step differentiates its own tensors
and can be captured as one CUDA graph (``capture.py``). Parameters are
drawn on the host from one ``torch.Generator`` (:func:`seed` resets it),
then moved to the device, so a model built on the card and one built on
the CPU from one seed hold the same weights."""

import math

import numpy as np
import torch

from ..core import unique_name
from ..core.executor import to_tensor
from ..core.framework import convert_np_dtype, torch_dtype
from ..core.initializer import ConstantInitializer, XavierInitializer
from .base import VarBase, current_device, functional_mode, set_rng, \
    next_key, to_variable

__all__ = ["Layer", "seed"]

_HOST_GENERATOR = torch.Generator().manual_seed(0)


def seed(n):
    """Reset the host generator every new parameter is drawn from."""
    _HOST_GENERATOR.manual_seed(int(n))


class _HostBlock:
    """Block-protocol shim so the core initializers run eagerly: each
    init op is computed at once on the host, as the port's random op
    impls compute it (``core/opimpl/tensor_ops.py``)."""

    def __init__(self, generator):
        self.ops = []
        self.generator = generator

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        attrs = attrs or {}
        var = outputs["Out"] if not isinstance(outputs["Out"], list) \
            else outputs["Out"][0]
        shape = tuple(attrs.get("shape", var.shape))
        dtype = torch_dtype(convert_np_dtype(attrs.get("dtype", "float32")))
        gen = self.generator
        if type == "fill_constant":
            val = torch.full(shape, attrs["value"], dtype=dtype)
        elif type == "uniform_random":
            u = torch.rand(shape, generator=gen, dtype=torch.float32)
            val = attrs["min"] + (attrs["max"] - attrs["min"]) * u
        elif type == "gaussian_random":
            n = torch.randn(shape, generator=gen, dtype=torch.float32)
            val = attrs["mean"] + attrs["std"] * n
        elif type == "truncated_gaussian_random":
            lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
            u = torch.rand(shape, generator=gen, dtype=torch.float32)
            p = lo + (1.0 - 2.0 * lo) * u
            z = (math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)).clamp(-2, 2)
            val = attrs["mean"] + attrs["std"] * z
        elif type == "assign_value":
            val = torch.as_tensor(np.array(attrs["values"]).reshape(shape))
        else:
            raise NotImplementedError("eager init op %s" % type)
        var._eager_value = val.to(dtype)


class _InitVar:
    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self._eager_value = None


class Layer:
    """Base module (ref ``imperative/layers.py`` Layer)."""

    def __init__(self, name_scope=None, dtype="float32"):
        self._full_name = unique_name.generate(
            name_scope or self.__class__.__name__.lower())
        self._parameters = {}
        self._sub_layers = {}
        self._dtype = dtype
        self.training = True

    def full_name(self):
        return self._full_name

    # -- parameter management ----------------------------------------------
    def create_parameter(self, shape, dtype=None, name=None,
                         initializer=None, is_bias=False):
        init = initializer or (ConstantInitializer(0.0) if is_bias
                               else XavierInitializer())
        var = _InitVar(shape, dtype or self._dtype)
        init(var, _HostBlock(_HOST_GENERATOR))
        pname = name or unique_name.generate(self._full_name + ".w")
        p = VarBase(var._eager_value.to(current_device()), name=pname)
        self._parameters[pname] = p
        return p

    def add_parameter(self, name, param):
        self._parameters[name] = param
        return param

    def add_sublayer(self, name, layer):
        self._sub_layers[name] = layer
        return layer

    def __setattr__(self, name, value):
        if isinstance(value, Layer):
            self.__dict__.setdefault("_sub_layers", {})[name] = value
        object.__setattr__(self, name, value)

    def parameters(self, include_sublayers=True):
        out = list(self._parameters.values())
        if include_sublayers:
            for sub in self._sub_layers.values():
                out.extend(sub.parameters())
        return out

    def sublayers(self, include_sublayers=True):
        out = list(self._sub_layers.values())
        if include_sublayers:
            for sub in self._sub_layers.values():
                out.extend(sub.sublayers())
        return out

    def train(self):
        self.training = True
        for sub in self.sublayers():
            sub.training = True

    def eval(self):
        self.training = False
        for sub in self.sublayers():
            sub.training = False

    # -- call ---------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    # -- functional export ----------------------------------------------------
    def state_pytree(self):
        """{param_name: tensor} over self + sublayers."""
        return {p.name: p.value() for p in self.parameters()}

    def load_pytree(self, tree):
        """Set the named parameters from tensors or arrays, each on the
        device and in the dtype its parameter holds."""
        for p in self.parameters():
            if p.name in tree:
                p._value = torch.as_tensor(tree[p.name]).to(
                    device=p._value.device, dtype=p._value.dtype)

    def functional(self, rng=False):
        """Return (apply_fn, params) where apply_fn(params, *inputs) swaps
        the dict's tensors into the parameters and runs forward. With
        ``rng=True`` the signature is ``apply_fn(params, generator,
        *inputs)`` and stochastic layers draw from that generator."""
        params0 = self.state_pytree()
        plist = self.parameters()

        def apply_fn(params, *inputs):
            saved = [p._value for p in plist]
            prev_gen = next_key()
            if rng:
                gen, inputs = inputs[0], inputs[1:]
                set_rng(gen)
            try:
                for p in plist:
                    p._value = params[p.name]
                dev = plist[0]._value.device if plist else current_device()
                with functional_mode():
                    out = self.forward(*[
                        to_variable(i if isinstance(i, (VarBase, torch.Tensor))
                                    else to_tensor(i, dev)) for i in inputs])
                return out.value() if isinstance(out, VarBase) else out
            finally:
                set_rng(prev_gen)
                for p, s in zip(plist, saved):
                    p._value = s

        return apply_fn, params0
