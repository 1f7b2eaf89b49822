"""Debug-surface ops: Print and py_func (the port's
``paddle_tpu/layers/debug_ops.py``; ref ``paddle/fluid/operators/
print_op.cc`` with ``layers/control_flow.py:146``, and
``operators/py_func_op.cc`` with ``layers/nn.py:10346``).

Both run host Python every time they run. ``print`` formats its tensor
from a numpy copy, as the reference's host callback does, and prints the
gradient from the backward of an ``autograd.Function`` (the reference's
``custom_vjp`` around a second callback). ``py_func`` is an
``autograd.Function`` that calls ``func`` on numpy copies of its inputs,
and ``backward_func(*xs, *outs, *douts)`` in its backward when one is
given. A program that holds either is interpreted on the card, never
captured (``core/executor.py`` ``_NOT_CAPTURED``).
"""

import numpy as np
import torch

from ..core.framework import torch_dtype
from ..core.layer_helper import LayerHelper
from ..core.op_registry import DEVICE_KEY, RNG_TAPE_KEY, get, put, register

__all__ = ["Print", "py_func"]


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """Print the tensor (and/or its gradient) whenever it flows. Returns
    the wrapped tensor (identity in the compute graph)."""
    helper = LayerHelper("print", name=None)
    out = helper.create_variable_for_type_inference(
        dtype=str(input.dtype), shape=input.shape)
    helper.append_op(
        "print", {"In": input}, {"Out": out},
        {"first_n": first_n, "message": message or "",
         "summarize": summarize, "print_tensor_name": print_tensor_name,
         "print_tensor_type": print_tensor_type,
         "print_tensor_shape": print_tensor_shape,
         "print_phase": print_phase, "var_name": input.name})
    return out


def _host(t):
    """(numpy copy, its dtype's name): bf16 is printed as bf16 and widened
    to f32 for the text."""
    t = t.detach()
    name = None
    if t.dtype == torch.bfloat16:
        t, name = t.float(), "bfloat16"
    arr = t.cpu().numpy()
    return arr, name or str(arr.dtype)


def _tensor_report(tag, name, t, attrs):
    arr, dtype = _host(t)
    parts = [attrs.get("message") or ""]
    if attrs.get("print_tensor_name", True):
        parts.append("%s %s" % (tag, name))
    if attrs.get("print_tensor_type", True):
        parts.append("dtype: %s" % dtype)
    if attrs.get("print_tensor_shape", True):
        parts.append("shape: %s" % (tuple(arr.shape),))
    n = attrs.get("summarize", -1)
    flat = arr.reshape(-1)
    if n is not None and n >= 0:
        flat = flat[:n]
    parts.append("data: %s" % np.array2string(flat, threshold=20))
    print("  ".join(p for p in parts if p), flush=True)


class _PrintGrad(torch.autograd.Function):
    """Identity whose backward prints the incoming gradient."""

    @staticmethod
    def forward(ctx, x, report):
        ctx.report = report
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.report("bwd-grad", g)
        return g, None


@register("print")
def _print_op(env, op):
    x = get(env, op.input("In"))
    attrs = op.attrs
    first_n = attrs.get("first_n", -1)
    phase = attrs.get("print_phase", "both")
    counter = attrs.setdefault("_host_counter", [0])

    def report(tag, t):
        counter[0] += 1
        if first_n is None or first_n < 0 or counter[0] <= first_n:
            _tensor_report(tag, attrs.get("var_name", "?"), t, attrs)

    # a rematerialized segment runs its forward again in the backward:
    # that run prints nothing
    tape = env.get(RNG_TAPE_KEY)
    recompute = tape is not None and tape.replay is not None
    if phase in ("forward", "both") and not recompute:
        report("fwd", x)
    if phase in ("backward", "both") and x.requires_grad \
            and torch.is_grad_enabled():
        x = _PrintGrad.apply(x, report)
    put(env, op.output("Out"), x)


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """Run a user Python function as an op (ref ``py_func_op.cc``).

    ``x``: input Variable or list; ``out``: pre-created output Variable
    or list (shapes/dtypes declare the callback's result signature);
    ``backward_func(*xs, *outs, *douts) -> dxs`` supplies gradients.
    """
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    helper = LayerHelper("py_func", name=None)
    helper.append_op(
        "py_func", {"X": xs}, {"Out": outs},
        {"func": func, "backward_func": backward_func})
    return out


def _as_list(res):
    return list(res) if isinstance(res, (list, tuple)) else [res]


def _to_device(values, like):
    """Host results as tensors shaped, typed and placed like ``like``
    ([(shape, dtype, device)])."""
    return tuple(torch.as_tensor(np.asarray(v)).reshape(shape).to(
        device=dev, dtype=dt) for v, (shape, dt, dev) in zip(values, like))


def _numpy(t):
    return _host(t)[0]


class _PyFunc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, func, backward_func, specs, *xs):
        outs = _to_device(_as_list(func(*[_numpy(a) for a in xs])), specs)
        ctx.backward_func = backward_func
        ctx.save_for_backward(*xs, *outs)
        ctx.n_in = len(xs)
        return outs

    @staticmethod
    def backward(ctx, *gs):
        saved = ctx.saved_tensors
        xs = saved[:ctx.n_in]
        dxs = _to_device(
            _as_list(ctx.backward_func(*[_numpy(a) for a in
                                         saved + tuple(gs)])),
            [(tuple(a.shape), a.dtype, a.device) for a in xs])
        return (None, None, None) + dxs


@register("py_func")
def _py_func_op(env, op):
    xs = [get(env, v) for v in op.input_list("X")]
    out_vars = op.output_list("Out")
    func = op.attr("func")
    backward_func = op.attr("backward_func")
    batch = xs[0].shape[0] if xs and xs[0].dim() else 1
    dev = env[DEVICE_KEY]  # an op with no inputs too
    specs = [(tuple(batch if s == -1 else s for s in v.shape),
              torch_dtype(v.dtype), dev) for v in out_vars]
    if backward_func is None or not torch.is_grad_enabled():
        outs = _to_device(_as_list(func(*[_numpy(a) for a in xs])), specs)
    else:
        outs = _PyFunc.apply(func, backward_func, specs, *xs)
    for v, o in zip(out_vars, outs):
        put(env, v, o)
