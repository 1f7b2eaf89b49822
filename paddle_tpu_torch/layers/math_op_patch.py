"""Operator sugar for Variables (the port's
``paddle_tpu/layers/math_op_patch.py``; ref ``python/paddle/fluid/layers/
math_op_patch.py`` monkey_patch_variable): importing this module (the
``layers`` package does) attaches ``+ - * / **``, unary minus and the
comparisons to ``framework.Variable``; each appends its elementwise or
compare op through :func:`binary`."""

from ..core.framework import Variable
from ..core.op_registry import static_bcast_shape

_CMP = {"less_than", "less_equal", "greater_than", "greater_equal",
        "equal", "not_equal"}


def binary(x, other, op_type, reverse=False, out=None):
    """``op_type`` of x and other (a Variable, or a number, which becomes
    a [1] ``fill_constant`` of x's dtype), operands swapped with
    ``reverse``, into a new var or into ``out`` (a While body updates its
    condition so). Compares give bool."""
    block = x.block.program.current_block()
    if not isinstance(other, Variable):
        from . import tensor

        other = tensor.fill_constant(shape=[1], dtype=str(x.dtype),
                                     value=float(other))
    a, b = (other, x) if reverse else (x, other)
    try:
        out_shape = static_bcast_shape(a.shape or (), b.shape or (), -1)
    except ValueError:
        out_shape = a.shape or ()  # infeasible: the op reports it when run
    if out is None:
        out = block.create_var(
            shape=out_shape,
            dtype="bool" if op_type in _CMP else str(a.dtype))
    block.append_op(op_type, {"X": a, "Y": b}, {"Out": out}, {"axis": -1})
    return out


def _operator(op_type, reverse=False):
    def method(self, other):
        return binary(self, other, op_type, reverse)

    return method


def _neg(self):
    from . import nn

    return nn.scale(self, scale=-1.0)


def monkey_patch_variable():
    """Attach the operators to ``Variable`` (ref ``math_op_patch.py``)."""
    for name, op_type, reverse in (
            ("__add__", "elementwise_add", False),
            ("__radd__", "elementwise_add", False),
            ("__sub__", "elementwise_sub", False),
            ("__rsub__", "elementwise_sub", True),
            ("__mul__", "elementwise_mul", False),
            ("__rmul__", "elementwise_mul", False),
            ("__truediv__", "elementwise_div", False),
            ("__rtruediv__", "elementwise_div", True),
            ("__pow__", "elementwise_pow", False),
            ("__lt__", "less_than", False),
            ("__le__", "less_equal", False),
            ("__gt__", "greater_than", False),
            ("__ge__", "greater_equal", False)):
        setattr(Variable, name, _operator(op_type, reverse))
    Variable.__neg__ = _neg


monkey_patch_variable()
