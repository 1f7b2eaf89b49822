"""Model persistence (ref ``python/paddle/fluid/io.py``: ``save_vars:92``,
``save_params:213``, ``save_persistables:441``, ``load_persistables:658``,
``save_inference_model:863``, ``load_inference_model:1015``).

The file layout is ``paddle_tpu/io.py``'s (:115-146): one ``.npz`` bundle
per save (written to a temp file, then renamed) plus a ``manifest.json``,
and for an inference model a pickled ``__model__`` holding the pruned
program (here the port's ``Program``) with its feed and fetch names. A
``params.npz`` saved by either package loads in the other
(``bridge.load_reference_params``). ``load_inference_model`` reads other
model and params file names; the StableHLO export is not ported.
"""

import json
import os
import pickle
import tempfile

import numpy as np

from .core import framework
from .core.framework import Parameter
from .core.executor import global_scope, to_numpy, to_tensor

__all__ = [
    "save_vars", "save_params", "save_persistables", "load_vars",
    "load_params", "load_persistables", "save_inference_model",
    "load_inference_model",
]


def _collect(program, predicate):
    return [v for v in program.list_vars() if predicate(v)]


def _atomic_savez(path, arrays):
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    main_program = main_program or framework.default_main_program()
    if vars is None:
        vars = _collect(main_program, predicate or (lambda v: v.persistable))
    scope = global_scope()
    arrays = {v.name: to_numpy(scope.get(v.name)) for v in vars
              if v.name in scope}
    path = os.path.join(dirname, filename or "__model_params__.npz")
    _atomic_savez(path, arrays)
    meta = {name: {"shape": list(a.shape), "dtype": str(a.dtype)}
            for name, a in arrays.items()}
    with open(os.path.join(dirname, "manifest.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return path


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=lambda v: isinstance(v, Parameter),
                     filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=lambda v: v.persistable, filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Load into the current scope, onto ``executor.device``."""
    main_program = main_program or framework.default_main_program()
    if vars is None:
        vars = _collect(main_program, predicate or (lambda v: v.persistable))
    path = os.path.join(dirname, filename or "__model_params__.npz")
    scope = global_scope()
    with np.load(path, allow_pickle=False) as data:
        for v in vars:
            if v.name in data:
                scope.set(v.name, to_tensor(data[v.name], executor.device, v))


def load_params(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program,
              predicate=lambda v: isinstance(v, Parameter), filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program,
              predicate=lambda v: v.persistable, filename=filename)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None):
    """Prune to the fetch targets, save program + params (ref ``io.py:863``)."""
    main_program = main_program or framework.default_main_program()
    inference_program = main_program.clone(for_test=True)
    targets = [inference_program.global_block().var(v.name)
               for v in target_vars]
    pruned = inference_program.prune(targets)
    os.makedirs(dirname, exist_ok=True)
    save_persistables(executor, dirname, pruned,
                      filename="params.npz")
    model = {
        "feed_names": list(feeded_var_names),
        "fetch_names": [v.name for v in target_vars],
        "program": pruned,
    }
    with open(os.path.join(dirname, "__model__"), "wb") as f:
        pickle.dump(model, f)
    return [v.name for v in target_vars]


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """Unpickles ``model_filename`` (``__model__``): load only model
    directories you trust. ``params_filename`` defaults to ``params.npz``,
    the file ``save_inference_model`` writes."""
    with open(os.path.join(dirname, model_filename or "__model__"),
              "rb") as f:
        model = pickle.load(f)
    program = model["program"]
    load_persistables(executor, dirname, program,
                      filename=params_filename or "params.npz")
    gb = program.global_block()
    fetch_vars = [gb.var(n) for n in model["fetch_names"]]
    return program, model["feed_names"], fetch_vars
