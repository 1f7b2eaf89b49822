"""Op registry: symbolic op type -> torch implementation.

The port's copy of ``paddle_tpu/core/op_registry.py``. Every op type maps
to ONE function ``impl(env, op)`` that reads input tensors from ``env`` (a
dict of name -> torch.Tensor) and writes its outputs back; the Executor
calls them one after another. Plain tensor code runs as PyTorch ops; the
ops that ``paddle_tpu`` sent to Pallas kernels call the port's hand-written
CUDA kernels (``paddle_tpu_torch/ops``).
"""

import os

OP_IMPLS = {}

# reserved env entries: the torch.Generator that random ops draw from
# (also kept in the scope), and the torch.device that ops which create
# tensors from nothing create them on
RNG_KEY = "@RNG@"
DEVICE_KEY = "@DEVICE@"


def register(*names):
    """Decorator: register an impl under one or more op type names."""

    def deco(fn):
        for n in names:
            if n in OP_IMPLS:
                raise ValueError("op %s registered twice" % n)
            OP_IMPLS[n] = fn
        return fn

    return deco


def env_flag(name):
    """gflags-style boolean env: '1'/'true'/'yes'/'on' (any case) = on."""
    return os.environ.get(name, "").strip().lower() in (
        "1", "true", "yes", "on")


def run_op(env, op):
    impl = OP_IMPLS.get(op.type)
    if impl is None:
        raise NotImplementedError(
            "paddle_tpu_torch has no impl for op type '%s' (inputs=%s)"
            % (op.type, op.input_arg_names))
    try:
        impl(env, op)
    except NotImplementedError:
        raise  # already names what is missing
    except Exception as e:
        # enforce-style context: name the failing op and its input shapes
        shapes = []
        for n in op.input_arg_names:
            v = env.get(n)
            shapes.append("%s=%s" % (
                n, tuple(v.shape) if hasattr(v, "shape") else "?"))
        e.add_note("  [operator '%s' at %s, inputs: %s -> outputs: %s]"
                   % (op.type, op.where(), ", ".join(shapes),
                      list(op.output_arg_names)))
        raise


def get(env, var):
    if var is None:
        return None
    try:
        return env[var.name]
    except KeyError:
        raise KeyError(
            "op input '%s' not materialized; feed it or run the startup "
            "program first" % var.name)


def get_list(env, op, slot):
    return [get(env, v) for v in op.input_list(slot)]


def put(env, var, val):
    if var is not None:
        env[var.name] = val


def next_rng(env):
    """The executor's ``torch.Generator`` (stateful: each draw advances
    it, the torch counterpart of splitting the threaded JAX key)."""
    return env[RNG_KEY]


def bcast_y(x, y, axis):
    """Reference elementwise broadcast semantics: y's shape aligns to x
    starting at ``axis`` (ref ``operators/elementwise/elementwise_op.h``).
    axis=-1 means align trailing dims (numpy broadcasting)."""
    if axis is None:
        axis = -1
    if y.dim() >= x.dim() or y.dim() == 0:
        return y
    if axis == -1:
        axis = x.dim() - y.dim()
    new_shape = [1] * x.dim()
    for i, s in enumerate(y.shape):
        new_shape[axis + i] = s
    return y.reshape(new_shape)


def static_bcast_shape(xs, ys, axis=-1):
    """Static-shape mirror of :func:`bcast_y` + numpy broadcasting, with -1
    as the unknown/batch wildcard (the layer builders' declared output
    shapes). Returns None when either side is unknown; raises ValueError
    for statically infeasible shapes."""
    if xs is None or ys is None:
        return None
    xs = tuple(-1 if (d is None or int(d) < 0) else int(d) for d in xs)
    ys = tuple(-1 if (d is None or int(d) < 0) else int(d) for d in ys)
    if 0 < len(ys) < len(xs):
        a = len(xs) - len(ys) if axis in (None, -1) else int(axis)
        if a < 0 or a + len(ys) > len(xs):
            raise ValueError(
                "broadcast axis %d places y shape %s outside x shape %s"
                % (a, list(ys), list(xs)))
        ys = (1,) * a + ys + (1,) * (len(xs) - a - len(ys))
    rank = max(len(xs), len(ys))
    xs = (1,) * (rank - len(xs)) + xs
    ys = (1,) * (rank - len(ys)) + ys
    out = []
    for dx, dy in zip(xs, ys):
        if dx == 1:
            out.append(dy)
        elif dy == 1:
            out.append(dx)
        elif dx == -1 or dy == -1:
            out.append(dx if dy == -1 else dy)
        elif dx == dy:
            out.append(dx)
        else:
            raise ValueError("cannot broadcast shapes %s and %s"
                             % (list(xs), list(ys)))
    return tuple(out)
