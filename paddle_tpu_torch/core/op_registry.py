"""Op registry: symbolic op type -> torch implementation.

The port's copy of ``paddle_tpu/core/op_registry.py``. Every op type maps
to ONE function ``impl(env, op)`` that reads input tensors from ``env`` (a
dict of name -> torch.Tensor) and writes its outputs back; the Executor
calls them one after another. Plain tensor code runs as PyTorch ops; the
ops that ``paddle_tpu`` sent to Pallas kernels call the port's hand-written
CUDA kernels (``paddle_tpu_torch/ops``).
"""

import contextlib
import os
import threading

import torch

OP_IMPLS = {}

# reserved env entries: the torch.Generator that random ops draw from
# (also kept in the scope), the torch.device that ops which create
# tensors from nothing create them on, in a training step with sparse
# gradients {table: [(ids, out leaf, padding_idx), ...]}: the sparse
# lookup sites in the order they ran, and the names of the feeds the
# caller lent for the step (a cache write into a lent feed writes it in
# place)
RNG_KEY = "@RNG@"
DEVICE_KEY = "@DEVICE@"
SPARSE_SITES_KEY = "@SPARSE_SITES@"
LENT_KEY = "@LENT@"
# inside a rematerialized segment of a training step: its RngTape
RNG_TAPE_KEY = "@RNG_TAPE@"


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


# ---------------------------------------------------------------------------
# Mixed precision (``paddle_tpu``'s op_registry.py:300-374). The Executor
# sets the flag for the whole run of a program marked by ``amp.py``; the
# forward records the casts on the tape, so the backward follows the
# forward's dtypes with no flag of its own. Parameters stay f32 leaves:
# the cast of an operand is an op on the tape, whose backward widens the
# gradient to f32 again.
# ---------------------------------------------------------------------------

class _AmpState(threading.local):
    """Per thread: the serving engine runs programs in threads."""
    enabled = False


AMP = _AmpState()


def amp_enabled():
    return AMP.enabled


class _SingleRounding:
    """cuBLAS's ``allow_bf16_reduced_precision_reduction`` held off while
    any thread is inside an AMP block, and given back as it was when the
    last one leaves. The flag is the process's, so the blocks of all
    threads share one count."""
    lock = threading.Lock()
    depth = 0
    saved = None


@contextlib.contextmanager
def single_rounding(enabled=True):
    """Inside the block cuBLAS reduces bf16 products in f32: with
    ``allow_bf16_reduced_precision_reduction`` (PyTorch's default) it may
    sum split-K partials in bf16 and round a product twice, where the
    reference's dots (``preferred_element_type=f32``) round once. That
    setting is restored when the last such block of the process ends.
    The AMP blocks and the dygraph tape (``dygraph/base.py``) hold it."""
    if not enabled:
        yield
        return
    matmul = torch.backends.cuda.matmul
    with _SingleRounding.lock:
        if _SingleRounding.depth == 0:
            _SingleRounding.saved = \
                matmul.allow_bf16_reduced_precision_reduction
            matmul.allow_bf16_reduced_precision_reduction = False
        _SingleRounding.depth += 1
    try:
        yield
    finally:
        with _SingleRounding.lock:
            _SingleRounding.depth -= 1
            if _SingleRounding.depth == 0:
                matmul.allow_bf16_reduced_precision_reduction = \
                    _SingleRounding.saved


@contextlib.contextmanager
def amp_scope(enabled):
    """Set the flag for a block and restore it afterwards; an AMP block
    also holds :func:`single_rounding`."""
    prev, AMP.enabled = AMP.enabled, bool(enabled)
    try:
        with single_rounding(enabled):
            yield
    finally:
        AMP.enabled = prev


def mxu_cast(*xs):
    """Cast the f32 operands of a matrix product, convolution or attention
    to bf16 when AMP is on; other tensors and None pass through."""
    if not AMP.enabled:
        return xs if len(xs) > 1 else xs[0]
    out = tuple(x.to(torch.bfloat16)
                if isinstance(x, torch.Tensor) and x.dtype == torch.float32
                else x for x in xs)
    return out if len(out) > 1 else out[0]


def amp_harmonize(x, y):
    """Binop promotion under AMP: bf16 wins. Torch, like jnp, promotes a
    ``bf16 (op) f32`` pair to f32, which would take the activation stream
    back to f32 at every bias add and residual; demoting the f32 side
    keeps it bf16 (``PADDLE_TPU_AMP_F32_ACTS=1`` turns this off)."""
    if (AMP.enabled and not env_flag("PADDLE_TPU_AMP_F32_ACTS")
            and isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)):
        if x.dtype == torch.bfloat16 and y.dtype == torch.float32:
            return x, y.to(torch.bfloat16)
        if x.dtype == torch.float32 and y.dtype == torch.bfloat16:
            return x.to(torch.bfloat16), y
    return x, y


def amp_out_cast(x):
    """Cast an f32 activation source (an embedding's gathered rows) to
    bf16 under AMP, as matrix products store their outputs."""
    if (AMP.enabled and not env_flag("PADDLE_TPU_AMP_F32_ACTS")
            and isinstance(x, torch.Tensor) and x.dtype == torch.float32):
        return x.to(torch.bfloat16)
    return x


def mxu_acc_dtype():
    """The stored dtype of a bf16 matrix product under AMP: None keeps
    bf16 (the product accumulates in f32 and rounds once);
    ``PADDLE_TPU_AMP_F32_ACTS=1`` stores f32."""
    if AMP.enabled and env_flag("PADDLE_TPU_AMP_F32_ACTS"):
        return torch.float32
    return None


def weak_scalar(x, s):
    """A Python number as JAX's weak typing applies it to ``x``: rounded
    to x's dtype when that is bf16 or f16 (``bf16 * 0.9`` multiplies by
    bf16(0.9)), as is. Torch would keep the number in f32 and round only
    the result."""
    if isinstance(x, torch.Tensor) and x.dtype in (torch.bfloat16,
                                                   torch.float16):
        return float(torch.tensor(s, dtype=x.dtype))
    return s


def run_op(env, op):
    impl = OP_IMPLS.get(op.type)
    if impl is None:
        raise NotImplementedError(
            "paddle_tpu_torch has no impl for op type '%s' (inputs=%s)"
            % (op.type, op.input_arg_names))
    cond_name = op.attrs.get("_switch_cond")
    old = None
    if cond_name is not None:
        old = {n: env[n] for n in op.output_arg_names if n in env}
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
    if cond_name is not None:
        # a Switch case's op (``layers.control_flow.Switch``): each output
        # that held a value keeps it where the case does not fire, on the
        # device (``paddle_tpu``'s ``op_registry.py:158``)
        pred = env[cond_name].reshape(())
        for n in op.output_arg_names:
            if n in old:
                env[n] = torch.where(pred, env[n], old[n])


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


class RngTape:
    """The random draws of one rematerialized forward segment: kept as its
    forward makes them (a dropout's keep mask, a flash kernel's seed) and
    handed out again, in order, to its recompute, which so draws exactly
    what the forward drew. Nothing touches the generator's state: the
    recompute runs in the backward, where the generator has moved on, and
    inside a captured step, where its state lives in the graph."""

    def __init__(self):
        self.draws = []
        self.replay = None  # the next draw's index while recomputing

    def draw(self, fn, generator):
        if self.replay is None:
            self.draws.append(fn(generator))
            return self.draws[-1]
        self.replay += 1
        return self.draws[self.replay - 1]


def rng_draw(env, fn):
    """``fn(generator)``: a random op's draw from the executor's generator,
    through the segment's :class:`RngTape` under rematerialization."""
    tape = env.get(RNG_TAPE_KEY)
    if tape is None:
        return fn(env[RNG_KEY])
    return tape.draw(fn, env[RNG_KEY])


def merge_sparse_rows(rows, vals, sentinel):
    """Merge the duplicate rows of a (rows, values) sparse grad at static
    length (``paddle_tpu``'s ``op_registry.py:225``; ref
    ``math/selected_rows_functor.cc`` MergeAdd): each row appears once, in
    ascending order, carrying its summed value; every duplicate slot holds
    ``sentinel`` (an out-of-range row) with a ZERO value, so scatters
    (which drop out-of-range rows) and norms (which must not count a row
    twice) are exact. A stable sort keeps each row's values in slot order,
    and the segment sum adds them in that order."""
    n = rows.shape[0]
    if n == 0:
        return rows, vals
    order = torch.argsort(rows, stable=True)
    r = rows[order]
    v = vals[order]
    is_start = torch.ones(n, dtype=torch.bool, device=rows.device)
    is_start[1:] = r[1:] != r[:-1]
    seg = torch.cumsum(is_start, 0) - 1
    counts = torch.unique_consecutive(r, return_counts=True)[1]
    totals = torch.segment_reduce(v, "sum", lengths=counts, axis=0)
    mask = is_start.reshape((-1,) + (1,) * (v.dim() - 1))
    vals_u = torch.where(mask, totals[seg], torch.zeros((), dtype=v.dtype,
                                                        device=v.device))
    rows_u = torch.where(is_start, r, torch.full_like(r, sentinel))
    return rows_u, vals_u


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
