"""Carry weights into the port as numpy arrays.

Torch's Philox and JAX's threefry draw different parameters from one seed,
so a comparison between the two packages initialises once and copies the
weights across. ``params.npz`` as ``paddle_tpu.io.save_inference_model``
writes it is plain numpy: reading it needs no JAX.
"""

import os

import numpy as np

from .core.executor import resolve_device, to_tensor

__all__ = ["load_numpy_params", "load_reference_params"]


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


def load_reference_params(model_dir, scope, device=None, program=None,
                          filename="params.npz"):
    """Load the ``params.npz`` of a model directory saved by either
    package into ``scope`` on ``device``. Returns the names set."""
    with np.load(os.path.join(model_dir, filename),
                 allow_pickle=False) as data:
        arrays = {n: data[n] for n in data.files}
    return load_numpy_params(scope, arrays, device, program)
