"""Unary activation and math layers (the port's
``paddle_tpu/layers/ops.py``; ref ``python/paddle/fluid/layers/ops.py:
21-58``, which generates them from the registered activation ops)."""

from ..core.layer_helper import LayerHelper

__all__ = [
    "sigmoid", "logsigmoid", "exp", "tanh", "tanh_shrink", "sqrt", "rsqrt",
    "abs", "ceil", "floor", "cos", "sin", "round", "reciprocal", "log",
    "square", "softplus", "softsign", "hard_shrink", "soft_shrink",
    "thresholded_relu", "sign", "erf",
]


def _make(op_type):
    def layer(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype=str(x.dtype),
                                                        shape=x.shape)
        helper.append_op(op_type, {"X": x}, {"Out": out}, {})
        return out

    layer.__name__ = op_type
    layer.__doc__ = "%s activation (ref activation_op.cc)" % op_type
    return layer


for _op in __all__:
    globals()[_op] = _make(_op)
