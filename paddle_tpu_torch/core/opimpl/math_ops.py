"""Elementwise / activation / reduction / matmul ops (the port's
``paddle_tpu/core/opimpl/math_ops.py``: every op type it registers). All
are plain PyTorch ops; ``paddle_tpu`` left them to XLA as well. A scalar
attribute meets a bf16 tensor as JAX's weak typing has it
(``weak_scalar``)."""

import torch
import torch.nn.functional as F

from ..op_registry import (register, get, get_list, put, bcast_y,
                           amp_enabled, amp_harmonize, env_flag, mxu_acc_dtype,
                           mxu_cast, weak_scalar)

_BINOPS = {
    "elementwise_add": torch.add,
    "elementwise_sub": torch.sub,
    "elementwise_mul": torch.mul,
    "elementwise_div": torch.div,
    "elementwise_max": torch.maximum,
    "elementwise_min": torch.minimum,
    "elementwise_pow": torch.pow,
    "elementwise_mod": torch.remainder,
    "elementwise_floordiv": torch.floor_divide,
}


def _make_binop(name, fn, harmonize=True):
    # harmonize=False: mod and floordiv give discrete results, which a
    # demoted (bf16) operand could flip at a rounding boundary
    @register(name)
    def _impl(env, op, fn=fn):
        x = get(env, op.input("X"))
        y = bcast_y(x, get(env, op.input("Y")), op.attr("axis", -1))
        if harmonize:
            x, y = amp_harmonize(x, y)
        put(env, op.output("Out"), fn(x, y))


for _n, _f in _BINOPS.items():
    _make_binop(_n, _f, harmonize=_n not in ("elementwise_mod",
                                            "elementwise_floordiv"))

# comparisons (``paddle_tpu``'s math_ops.py:52-82): bool outputs, never
# harmonized (a demoted operand could flip a result at a rounding boundary)
_CMPOPS = {
    "less_than": torch.lt,
    "less_equal": torch.le,
    "greater_than": torch.gt,
    "greater_equal": torch.ge,
    "equal": torch.eq,
    "not_equal": torch.ne,
}

for _n, _f in _CMPOPS.items():
    _make_binop(_n, _f, harmonize=False)


def _make_logical(name, fn, arity):
    @register(name)
    def _impl(env, op, fn=fn):
        args = [get(env, op.input(s)) for s in ("X", "Y")[:arity]]
        put(env, op.output("Out"), fn(*args))


for _n, _f, _a in (("logical_and", torch.logical_and, 2),
                   ("logical_or", torch.logical_or, 2),
                   ("logical_xor", torch.logical_xor, 2),
                   ("logical_not", torch.logical_not, 1)):
    _make_logical(_n, _f, _a)


_UNARY = {
    "sigmoid": torch.sigmoid,
    "logsigmoid": F.logsigmoid,
    "exp": torch.exp,
    "tanh": torch.tanh,
    "tanh_shrink": lambda x: x - torch.tanh(x),
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "abs": torch.abs,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "round": torch.round,  # half to even, as jnp.round
    "cos": torch.cos,
    "sin": torch.sin,
    "reciprocal": lambda x: 1.0 / x,
    "log": torch.log,
    "square": torch.square,
    # jax.nn.softplus is logaddexp(x, 0); F.softplus turns linear past 20
    "softplus": lambda x: torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                                         device=x.device)),
    "softsign": lambda x: x / (1 + torch.abs(x)),
    "relu": torch.relu,
    "sign": torch.sign,
    "erf": torch.erf,
}


def _make_unary(name, fn):
    @register(name)
    def _impl(env, op, fn=fn):
        put(env, op.output("Out"), fn(get(env, op.input("X"))))


for _n, _f in _UNARY.items():
    _make_unary(_n, _f)


@register("gelu")
def _gelu(env, op):
    # the exact erf form, except under AMP, where paddle_tpu takes the tanh
    # approximation (math_ops.py:153-164) unless PADDLE_TPU_AMP_F32_ACTS
    # is set; an explicit ``approximate`` attribute wins
    approx = op.attr("approximate", amp_enabled()
                     and not env_flag("PADDLE_TPU_AMP_F32_ACTS"))
    put(env, op.output("Out"), F.gelu(get(env, op.input("X")),
                                      approximate="tanh" if approx
                                      else "none"))


def _attr(env, op, name, default):
    """Attribute ``name`` as a scalar for X's dtype (``weak_scalar``)."""
    return weak_scalar(get(env, op.input("X")), op.attr(name, default))


@register("relu6")
def _relu6(env, op):
    put(env, op.output("Out"), torch.clamp(
        get(env, op.input("X")), 0.0, _attr(env, op, "threshold", 6.0)))


@register("leaky_relu")
def _leaky_relu(env, op):
    x = get(env, op.input("X"))
    put(env, op.output("Out"),
        torch.where(x > 0, x, _attr(env, op, "alpha", 0.02) * x))


@register("elu")
def _elu(env, op):
    x = get(env, op.input("X"))
    put(env, op.output("Out"), torch.where(
        x > 0, x, _attr(env, op, "alpha", 1.0) * (torch.exp(x) - 1)))


@register("prelu")
def _prelu(env, op):
    """``where(x > 0, x, alpha * x)``; ``channel`` mode aligns alpha [C]
    with axis 1, the other modes broadcast it as it is."""
    x = get(env, op.input("X"))
    alpha = get(env, op.input("Alpha"))
    if op.attr("mode", "all") == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    put(env, op.output("Out"), torch.where(x > 0, x, alpha * x))


@register("brelu")
def _brelu(env, op):
    put(env, op.output("Out"), torch.clamp(
        get(env, op.input("X")), _attr(env, op, "t_min", 0.0),
        _attr(env, op, "t_max", 24.0)))


@register("stanh")
def _stanh(env, op):
    put(env, op.output("Out"), _attr(env, op, "scale_b", 1.7159)
        * torch.tanh(_attr(env, op, "scale_a", 0.67)
                     * get(env, op.input("X"))))


@register("hard_sigmoid")
def _hard_sigmoid(env, op):
    x = get(env, op.input("X"))
    put(env, op.output("Out"), torch.clamp(
        _attr(env, op, "slope", 0.2) * x + _attr(env, op, "offset", 0.5),
        0.0, 1.0))


@register("hard_shrink")
def _hard_shrink(env, op):
    x = get(env, op.input("X"))
    t = _attr(env, op, "threshold", 0.5)
    put(env, op.output("Out"), torch.where(torch.abs(x) > t, x,
                                           torch.zeros_like(x)))


@register("soft_shrink")
def _soft_shrink(env, op):
    x = get(env, op.input("X"))
    lam = _attr(env, op, "lambda", 0.5)
    zero = torch.zeros_like(x)
    put(env, op.output("Out"), torch.where(
        x > lam, x - lam, torch.where(x < -lam, x + lam, zero)))


@register("thresholded_relu")
def _thresholded_relu(env, op):
    x = get(env, op.input("X"))
    put(env, op.output("Out"), torch.where(
        x > _attr(env, op, "threshold", 1.0), x, torch.zeros_like(x)))


@register("swish")
def _swish(env, op):
    x = get(env, op.input("X"))
    put(env, op.output("Out"),
        x * torch.sigmoid(_attr(env, op, "beta", 1.0) * x))


@register("maxout")
def _maxout(env, op):
    x = get(env, op.input("X"))  # NCHW
    g = op.attr("groups")
    n, c, h, w = x.shape
    put(env, op.output("Out"), x.reshape(n, c // g, g, h, w).amax(dim=2))


@register("pow")
def _pow(env, op):
    put(env, op.output("Out"),
        torch.pow(get(env, op.input("X")), op.attr("factor", 1.0)))


@register("scale")
def _scale(env, op):
    x = get(env, op.input("X"))
    s = weak_scalar(x, op.attr("scale", 1.0))
    b = weak_scalar(x, op.attr("bias", 0.0))
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
    one row goes through the matrix path as two.

    Under AMP the f32 operands are cast to bf16 and the product is stored
    in bf16, summed in f32 and rounded once (``paddle_tpu``'s
    math_ops.py:300-317); ``mxu_acc_dtype`` f32 stores it in f32, from the
    same bf16 operands, which f32 holds exactly."""
    x, y = mxu_cast(x, y)
    acc = mxu_acc_dtype()
    if acc is not None:
        x, y = x.to(acc), y.to(acc)
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
        out = out * weak_scalar(out, alpha)
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


def _reduce_prod(x, dim=None, keepdim=False):
    """``torch.prod`` over several dims (it takes one)."""
    if dim is None:
        return torch.prod(x)
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


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


for _n, _f in (("reduce_sum", torch.sum), ("reduce_mean", torch.mean),
               ("reduce_max", torch.amax), ("reduce_min", torch.amin),
               ("reduce_prod", _reduce_prod)):
    _make_reduce(_n, _f)


@register("cumsum")
def _cumsum(env, op):
    """Along ``axis`` (the flattened X with ``flatten``); ``reverse`` sums
    from the end, ``exclusive`` leaves each element out of its own sum."""
    x = get(env, op.input("X"))
    axis = op.attr("axis", -1)
    if op.attr("flatten", False):
        x, axis = x.reshape(-1), 0
    axis %= x.dim()
    reverse = op.attr("reverse", False)
    xx = torch.flip(x, (axis,)) if reverse else x
    out = torch.cumsum(xx, dim=axis)
    if op.attr("exclusive", False):
        out = torch.cat([torch.zeros_like(out.narrow(axis, 0, 1)),
                         out.narrow(axis, 0, out.shape[axis] - 1)], dim=axis)
    if reverse:
        out = torch.flip(out, (axis,))
    put(env, op.output("Out"), out)


@register("norm")
def _norm(env, op):
    """l2_normalize along ``axis``: Out = X / Norm, Norm = sqrt(sum(X^2) +
    epsilon), kept (``norm_op.cc``)."""
    x = get(env, op.input("X"))
    norm = torch.sqrt(torch.sum(torch.square(x), dim=op.attr("axis", -1),
                                keepdim=True) + op.attr("epsilon", 1e-10))
    put(env, op.output("Out"), x / norm)
    put(env, op.output("Norm"), norm)


# index outputs are int32, the reference's 32-bit convention; ties give
# the first index, as in jnp
@register("argmax")
def _argmax(env, op):
    put(env, op.output("Out"), torch.argmax(
        get(env, op.input("X")), dim=op.attr("axis", -1)).to(torch.int32))


@register("argmin")
def _argmin(env, op):
    put(env, op.output("Out"), torch.argmin(
        get(env, op.input("X")), dim=op.attr("axis", -1)).to(torch.int32))


@register("argsort")
def _argsort(env, op):
    """Ascending along ``axis``, stable (``jnp.argsort``'s default)."""
    out, idx = torch.sort(get(env, op.input("X")), dim=op.attr("axis", -1),
                          stable=True)
    put(env, op.output("Indices"), idx.to(torch.int32))
    put(env, op.output("Out"), out)


@register("isfinite")
def _isfinite(env, op):
    """One bool: whether every element of X is finite (``isfinite_op``)."""
    put(env, op.output("Out"),
        torch.isfinite(get(env, op.input("X"))).all().reshape(1))


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
