"""Elementwise / activation / reduction / matmul ops (the subset of
``paddle_tpu/core/opimpl/math_ops.py`` the served and trained models run,
and the clip ops of ``clip.py``). All are plain PyTorch ops; ``paddle_tpu``
left them to XLA as well."""

import torch
import torch.nn.functional as F

from ..op_registry import register, get, get_list, put, bcast_y

_BINOPS = {
    "elementwise_add": torch.add,
    "elementwise_sub": torch.sub,
    "elementwise_mul": torch.mul,
    "elementwise_div": torch.div,
    "elementwise_max": torch.maximum,
}


def _make_binop(name, fn):
    @register(name)
    def _impl(env, op, fn=fn):
        x = get(env, op.input("X"))
        y = bcast_y(x, get(env, op.input("Y")), op.attr("axis", -1))
        put(env, op.output("Out"), fn(x, y))


for _n, _f in _BINOPS.items():
    _make_binop(_n, _f)


_UNARY = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "sqrt": torch.sqrt,
    "sign": torch.sign,
}


def _make_unary(name, fn):
    @register(name)
    def _impl(env, op, fn=fn):
        put(env, op.output("Out"), fn(get(env, op.input("X"))))


for _n, _f in _UNARY.items():
    _make_unary(_n, _f)


@register("gelu")
def _gelu(env, op):
    # exact erf form, as paddle_tpu computes it in f32 (math_ops.py:160-164);
    # its tanh form is an AMP-only choice and AMP is not ported yet
    approx = "tanh" if op.attr("approximate", False) else "none"
    put(env, op.output("Out"), F.gelu(get(env, op.input("X")),
                                      approximate=approx))


@register("scale")
def _scale(env, op):
    x = get(env, op.input("X"))
    s = op.attr("scale", 1.0)
    b = op.attr("bias", 0.0)
    if op.attr("bias_after_scale", True):
        out = x * s + b
    else:
        out = (x + b) * s
    put(env, op.output("Out"), out)


@register("mul")
def _mul(env, op):
    """Reference ``mul_op``: flatten x at x_num_col_dims, y at
    y_num_col_dims, then one 2-D matmul (``operators/mul_op.cc``)."""
    x = get(env, op.input("X"))
    y = get(env, op.input("Y"))
    xnc = op.attr("x_num_col_dims", 1)
    ync = op.attr("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(-1, _prod(xs[xnc:]))
    y2 = y.reshape(_prod(ys[:ync]), -1)
    put(env, op.output("Out"), _mm(x2, y2).reshape(xs[:xnc] + ys[ync:]))


def _mm(x, y):
    """Product whose rows do not depend on how many rows share the call:
    a served request must get the same bits alone as batched with others.
    BLAS sums a single row in another order (its matrix-vector path), so
    one row goes through the matrix path as two."""
    if x.dim() == 2 and x.shape[0] == 1:
        return torch.matmul(x.expand(2, -1), y)[:1]
    return torch.matmul(x, y)


def _prod(dims):
    out = 1
    for d in dims:
        out *= d
    return out


@register("matmul")
def _matmul(env, op):
    x = get(env, op.input("X"))
    y = get(env, op.input("Y"))
    if op.attr("transpose_X", False):
        x = x.transpose(-1, -2)
    if op.attr("transpose_Y", False):
        y = y.transpose(-1, -2)
    out = _mm(x, y)
    alpha = op.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    put(env, op.output("Out"), out)


@register("sum")
def _sum(env, op):
    xs = get_list(env, op, "X")
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    put(env, op.output("Out"), out)


@register("mean")
def _mean(env, op):
    put(env, op.output("Out"), get(env, op.input("X")).mean().reshape(()))


def _make_reduce(name, fn):
    @register(name)
    def _impl(env, op, fn=fn):
        x = get(env, op.input("X"))
        keep = op.attr("keep_dim", False)
        dim = op.attr("dim", [0])
        if op.attr("reduce_all", False) or dim is None:
            out = fn(x)
            if keep:
                out = out.reshape((1,) * x.dim())
        else:
            out = fn(x, dim=tuple(d if d >= 0 else d + x.dim() for d in dim),
                     keepdim=keep)
        put(env, op.output("Out"), out)


_make_reduce("reduce_sum", torch.sum)


@register("clip")
def _clip(env, op):
    put(env, op.output("Out"),
        torch.clamp(get(env, op.input("X")), op.attr("min"), op.attr("max")))


@register("clip_by_norm")
def _clip_by_norm(env, op):
    x = get(env, op.input("X"))
    max_norm = op.attr("max_norm")
    norm = torch.sqrt(torch.sum(torch.square(x)))
    put(env, op.output("Out"),
        torch.where(norm > max_norm,
                    x * (max_norm / torch.clamp_min(norm, 1e-12)), x))


@register("squared_l2_norm")
def _squared_l2_norm(env, op):
    x = get(env, op.input("X"))
    put(env, op.output("Out"), torch.sum(torch.square(x)).reshape(()))


@register("top_k")
def _top_k(env, op):
    """The k largest along the last axis, and their int32 indices (the
    32-bit convention of ``paddle_tpu``'s ``math_ops.py:416``)."""
    vals, idx = torch.topk(get(env, op.input("X")), op.attr("k", 1), dim=-1)
    put(env, op.output("Out"), vals)
    put(env, op.output("Indices"), idx.to(torch.int32))
