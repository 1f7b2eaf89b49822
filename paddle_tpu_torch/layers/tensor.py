"""Tensor creation / manipulation layers (the subset of
``paddle_tpu/layers/tensor.py`` this slice carries; ref
``python/paddle/fluid/layers/tensor.py``)."""

import numpy as np

from ..core.framework import Variable, convert_np_dtype
from ..core.layer_helper import LayerHelper

__all__ = ["fill_constant", "range", "reshape", "squeeze", "slice"]


def _dt(x):
    return str(x.dtype)


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=str(convert_np_dtype(dtype)), shape=tuple(shape))
    helper.append_op("fill_constant", outputs={"Out": out},
                     attrs={"shape": tuple(shape),
                            "dtype": str(convert_np_dtype(dtype)),
                            "value": float(value)})
    return out


def range(start, end, step, dtype):
    if isinstance(start, Variable) or isinstance(end, Variable) or \
            isinstance(step, Variable):
        # the length must be static (it sizes the output var)
        raise ValueError(
            "layers.range requires python-number start/end/step; use a "
            "fixed length + mask for dynamic ranges")
    helper = LayerHelper("range")
    n = int(np.ceil((end - start) / step))
    s = fill_constant([1], dtype, start)
    e = fill_constant([1], dtype, end)
    st = fill_constant([1], dtype, step)
    out = helper.create_variable_for_type_inference(
        dtype=str(convert_np_dtype(dtype)), shape=(n,))
    helper.append_op("range", {"Start": s, "End": e, "Step": st},
                     {"Out": out}, {})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape", act=act, name=name)
    out_shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    out = helper.create_variable_for_type_inference(dtype=_dt(x),
                                                    shape=tuple(out_shape))
    helper.append_op("reshape", {"X": x}, {"Out": out},
                     {"shape": list(shape)})
    return helper.append_activation(out)


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze", name=name)
    nd = len(input.shape)
    drop = {a % nd for a in axes} if axes else {
        i for i, s in enumerate(input.shape) if s == 1}
    shape = tuple(s for i, s in enumerate(input.shape) if i not in drop)
    out = helper.create_variable_for_type_inference(dtype=_dt(input),
                                                    shape=shape)
    helper.append_op("squeeze", {"X": input}, {"Out": out},
                     {"axes": list(axes)})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    shape = list(input.shape)
    for a, s, e in zip(axes, starts, ends):
        dim = shape[a]
        if dim >= 0:
            s_ = s + dim if s < 0 else min(s, dim)
            e_ = e + dim if e < 0 else min(e, dim)
            shape[a] = max(e_ - s_, 0)
        else:
            shape[a] = -1
    out = helper.create_variable_for_type_inference(dtype=_dt(input),
                                                    shape=tuple(shape))
    helper.append_op("slice", {"Input": input}, {"Out": out},
                     {"axes": list(axes), "starts": list(starts),
                      "ends": list(ends)})
    return out
