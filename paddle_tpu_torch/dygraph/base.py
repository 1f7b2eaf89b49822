"""Dygraph base (``paddle_tpu/dygraph/base.py``; ref
``python/paddle/fluid/imperative/base.py``: ``guard:29``,
``to_variable:47``; VarBase/tape semantics from ``imperative/layer.h:113``
+ ``engine.cc``).

Eager mode runs torch ops at once. :func:`record` runs a pure function
over the unwrapped tensors with autograd recording, so the tape is
torch's own graph; each recorded VarBase also keeps the leaves it was
computed from (the VarBases without a producer), as the tensors the
forward read. ``backward`` takes ``torch.autograd.grad`` of the var with
respect to those tensors and adds each gradient into its leaf, so:

* the gradient is evaluated at the values the forward read: an
  optimizer replaces a parameter's tensor (out of place) instead of
  writing into it, and a graph holds the tensor it was built on
  (``paddle_tpu`` snapshots its inputs for the same reason);
* ``backward`` may run more than once over one graph, each run adding
  into the leaves (the graph is retained until the var is dropped).

``Layer.functional()`` (``layers.py``) runs the forward in functional
mode: :func:`record` then keeps no leaves and autograd follows whatever
tensors the caller made require grad, so a train step takes
``torch.autograd.grad`` over its own parameter tensors and may be
captured as one CUDA graph (``capture.py``).

Places: a ``guard(place)`` names the device that :func:`to_variable`
and new parameters go to; without one it is ``CUDAPlace(0)``, as every
entry point of the port. Randomness: stochastic layers draw from the
explicit generator :func:`set_rng` installs (``functional(rng=True)``
installs the step's), else from a generator of their own per device,
seeded as the reference seeds its module keys.
"""

import contextlib

import torch

from ..core.executor import resolve_device, to_numpy, to_tensor
from ..core.op_registry import single_rounding

__all__ = ["guard", "no_grad", "enabled", "VarBase", "record",
           "to_variable", "set_rng", "next_key", "current_device",
           "draw_generator", "functional_mode"]

_dygraph_tracer = None
_grad_enabled = True
_place = [None]
# the explicit generator stream of stochastic layers (Dropout, NCE, the
# attention dropout's seed): under Layer.functional(rng=True) the apply
# function installs the step's generator, so a captured step draws from a
# generator its graph registers
_rng_stream = [None]
_functional = [0]


def set_rng(generator):
    _rng_stream[0] = generator


def next_key():
    """The explicit stream's generator, or None when none is installed
    (layers then draw from their own, :func:`draw_generator`). The
    reference splits a new key off its stream on every call; a torch
    generator advances itself with each draw."""
    return _rng_stream[0]


def draw_generator(owner, device, seed):
    """The generator a stochastic layer draws from on ``device``: the
    explicit stream's, else ``owner``'s own (one per class and device,
    seeded with ``seed`` at its first use: the legacy eager stream)."""
    gen = next_key()
    if gen is not None:
        return gen
    gens = owner.__dict__.get("_generators")
    if gens is None:
        gens = {}
        setattr(owner, "_generators", gens)
    dev = torch.device(device)
    if dev not in gens:
        gens[dev] = torch.Generator(dev).manual_seed(seed)
    return gens[dev]


def current_device():
    """The guard's device (``CUDAPlace(0)`` outside a guard with a
    place)."""
    return resolve_device(_place[0])


def _in_dygraph_mode():
    return _dygraph_tracer is not None


def enabled():
    return _in_dygraph_mode()


@contextlib.contextmanager
def guard(place=None):
    global _dygraph_tracer
    prev, prev_place = _dygraph_tracer, _place[0]
    _dygraph_tracer = object()
    if place is not None:
        _place[0] = place
    try:
        yield
    finally:
        _dygraph_tracer = prev
        _place[0] = prev_place


@contextlib.contextmanager
def no_grad():
    """Suspend tape recording (ref imperative ``_no_grad_``)."""
    global _grad_enabled
    prev = _grad_enabled
    _grad_enabled = False
    try:
        yield
    finally:
        _grad_enabled = prev


@contextlib.contextmanager
def functional_mode():
    """:func:`record` keeps no leaves: autograd alone follows the
    tensors (``Layer.functional``)."""
    _functional[0] += 1
    try:
        yield
    finally:
        _functional[0] -= 1


def _as_tensor(value, device=None):
    if isinstance(value, torch.Tensor):
        return value
    return to_tensor(value, current_device() if device is None else device)


class VarBase:
    """Eager tensor (ref ``imperative/layer.h:113`` VarBase): holds a
    tensor and, when produced by a recorded op, the leaves it reads
    (``_producer``: {id: (leaf VarBase, [tensors the forward read])})."""

    def __init__(self, value, stop_gradient=False, name=None):
        self._value = _as_tensor(value)
        self.stop_gradient = stop_gradient
        self.name = name
        self._grad = None
        self._producer = None

    @property
    def shape(self):
        return tuple(self._value.shape)

    @property
    def dtype(self):
        return self._value.dtype

    def numpy(self):
        return to_numpy(self._value)

    def value(self):
        return self._value

    # -- autograd -----------------------------------------------------------
    def backward(self, grad=None):
        """Reverse mode from this var into its leaves (ref
        VarBase::RunBackward / engine.cc: gradients accumulate). bf16
        products round once, as under AMP."""
        if self._producer is None:
            return
        seed = torch.ones_like(self._value) if grad is None else \
            _as_tensor(grad, self._value.device).to(self._value.dtype)
        pairs = [(v, t) for v, ts in self._producer.values() for t in ts]
        if not pairs:
            return
        with single_rounding():
            grads = torch.autograd.grad(
                [self._value], [t for _, t in pairs], grad_outputs=[seed],
                retain_graph=True, allow_unused=True)
        for (v, _), g in zip(pairs, grads):
            if g is None or v.stop_gradient:
                continue
            v._grad = g if v._grad is None else v._grad + g

    def gradient(self):
        return None if self._grad is None else to_numpy(self._grad)

    def clear_gradient(self):
        self._grad = None

    def detach(self):
        return VarBase(self._value.detach(), stop_gradient=True,
                       name=self.name)

    # -- eager operator sugar (tape-recorded) -------------------------------
    def _binop(self, other, fn):
        if not isinstance(other, (VarBase, int, float, bool)):
            other = _as_tensor(other, self._value.device)
        return record(fn, self, other)

    def __add__(self, o):
        return self._binop(o, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._binop(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._binop(o, lambda a, b: a * b)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, lambda a, b: a / b)

    def __rtruediv__(self, o):
        return self._binop(o, lambda a, b: b / a)

    def __pow__(self, o):
        return self._binop(o, lambda a, b: a ** b)

    def __matmul__(self, o):
        return self._binop(o, lambda a, b: a @ b)

    def __neg__(self):
        return record(lambda a: -a, self)

    def mean(self, axis=None):
        return record(lambda a: a.mean() if axis is None
                      else a.mean(dim=axis), self)

    def sum(self, axis=None):
        return record(lambda a: a.sum() if axis is None
                      else a.sum(dim=axis), self)

    def reshape(self, shape):
        return record(lambda a: a.reshape(shape), self)

    def transpose(self, perm):
        return record(lambda a: a.permute(perm), self)

    def astype(self, dtype):
        from ..core.framework import torch_dtype

        return record(lambda a: a.to(torch_dtype(dtype)), self)

    def __repr__(self):
        return "VarBase(%s)" % (self._value,)


def _leaf_tensor(v):
    """The tensor a leaf's gradient is taken with respect to: its own,
    made to require grad where it is a float tensor autograd has not
    seen (None for an integer tensor)."""
    t = v._value
    if not (t.is_floating_point() or t.is_complex()):
        return None
    if not t.requires_grad:
        t.requires_grad_(True)
    return t


def record(fn, *inputs):
    """Run ``fn`` over the unwrapped inputs with autograd recording when
    any input is a VarBase that requires grad, and attach the leaves the
    result reads. ``fn`` must be pure (torch ops only)."""
    vals, leaves, tracked = [], {}, False
    functional = _functional[0] > 0
    for p in inputs:
        if not isinstance(p, VarBase):
            vals.append(p)
            continue
        t = p._value
        if p.stop_gradient or not _grad_enabled:
            vals.append(t.detach() if t.requires_grad else t)
            continue
        tracked = True
        if functional:
            vals.append(t)
        elif p._producer is None:
            lt = _leaf_tensor(p)
            if lt is not None:
                held = leaves.setdefault(id(p), (p, []))[1]
                if not any(x is lt for x in held):
                    held.append(lt)
            vals.append(p._value)
        else:
            for key, (v, ts) in p._producer.items():
                held = leaves.setdefault(key, (v, []))[1]
                held.extend(x for x in ts if not any(x is h for h in held))
            vals.append(t)
    if functional:
        out = VarBase(fn(*vals))
    else:
        with torch.set_grad_enabled(tracked):
            out = VarBase(fn(*vals))
        if tracked:
            out._producer = leaves
    return out


def to_variable(value, block=None, name=None):
    if isinstance(value, VarBase):
        return value
    return VarBase(value, name=name)
