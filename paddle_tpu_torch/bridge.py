"""Carry weights into the port as numpy arrays.

Torch's Philox and JAX's threefry draw different parameters from one seed,
so a comparison between the two packages initialises once and copies the
weights across. ``params.npz`` as ``paddle_tpu.io.save_inference_model``
writes it is plain numpy: reading it needs no JAX.
"""

import os

import numpy as np

from .core.executor import resolve_device, to_tensor

__all__ = ["load_numpy_params", "load_program_params",
           "load_reference_params", "load_dygraph_state"]


def load_numpy_params(scope, params, device=None, program=None):
    """Set ``{name: np.ndarray}`` into ``scope`` as tensors on ``device``
    (None = ``CUDAPlace(0)``). With ``program``, each array takes its
    var's dtype under the 32-bit convention and names the program lacks
    raise. Returns the names set."""
    device = resolve_device(device)
    gb = program.global_block() if program is not None else None
    for name, arr in params.items():
        var = None
        if gb is not None:
            if not gb.has_var(name):
                raise KeyError("program has no var %r" % name)
            var = gb.var(name)
        scope.set(name, to_tensor(np.asarray(arr), device, var))
    return sorted(params)


def load_program_params(scope, params, program, device=None):
    """Carry the trainable parameters of a program initialised elsewhere
    (``{name: np.ndarray}``, e.g. read from a ``paddle_tpu`` scope) into
    ``scope`` for the port's copy of that program. Every parameter of
    ``program`` must be given, and nothing else. Optimizer state needs no
    carrying: the port's startup program fills it with constants."""
    want = {p.name for p in program.all_parameters()}
    if set(params) != want:
        raise KeyError("parameters missing: %s; unknown: %s"
                       % (sorted(want - set(params)),
                          sorted(set(params) - want)))
    return load_numpy_params(scope, params, device, program)


def load_dygraph_state(layer, state, device=None):
    """Carry a dygraph model initialised elsewhere (``{name: array}``,
    e.g. ``paddle_tpu``'s ``Layer.state_pytree()`` read as numpy) into the
    port's copy of that ``dygraph.Layer``, each parameter by name as an
    f32 tensor on ``device`` (None = ``CUDAPlace(0)``). Every parameter of
    the layer must be given, and nothing else. Returns the names set."""
    params = {p.name: p for p in layer.parameters()}
    if set(state) != set(params):
        raise KeyError("parameters missing: %s; unknown: %s"
                       % (sorted(set(params) - set(state)),
                          sorted(set(state) - set(params))))
    device = resolve_device(device)
    for name, arr in state.items():
        p = params[name]
        if tuple(p.shape) != tuple(np.shape(arr)):
            raise ValueError("%s: shape %s, given %s"
                             % (name, p.shape, np.shape(arr)))
        p._value = to_tensor(np.asarray(arr), device).to(p._value.dtype)
    return sorted(state)


def load_reference_params(model_dir, scope, device=None, program=None,
                          filename="params.npz"):
    """Load the ``params.npz`` of a model directory saved by either
    package into ``scope`` on ``device``. Returns the names set."""
    with np.load(os.path.join(model_dir, filename),
                 allow_pickle=False) as data:
        arrays = {n: data[n] for n in data.files}
    return load_numpy_params(scope, arrays, device, program)
