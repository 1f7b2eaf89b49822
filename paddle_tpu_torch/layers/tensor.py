"""Tensor creation / manipulation layers (the port's
``paddle_tpu/layers/tensor.py``; ref ``python/paddle/fluid/layers/
tensor.py`` and the manipulation members of ``nn.py``)."""

import builtins

import numpy as np

from ..core.framework import Variable, convert_np_dtype
from ..core.layer_helper import LayerHelper

__all__ = [
    "create_tensor", "create_global_var", "cast", "concat", "sums", "assign",
    "fill_constant", "fill_constant_batch_size_like", "ones", "zeros",
    "ones_like", "zeros_like", "reverse", "has_inf", "has_nan", "isfinite",
    "range", "linspace", "reshape", "squeeze", "unsqueeze", "flatten",
    "transpose", "slice", "strided_slice", "gather", "gather_nd", "scatter",
    "expand", "expand_as", "stack", "unstack", "shape", "where", "increment",
    "uniform_random", "gaussian_random", "uniform_random_batch_size_like",
    "gaussian_random_batch_size_like", "sampling_id", "arange",
]


def _dt(x):
    return str(x.dtype)


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.main_program.current_block().create_var(
        name=name, dtype=dtype, persistable=persistable, shape=None)


def sums(input, out=None):
    helper = LayerHelper("sums")
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=_dt(input[0]), shape=input[0].shape)
    helper.append_op("sum", {"X": list(input)}, {"Out": out}, {})
    return out


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


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    """``value`` in ``shape``, whose entry ``output_dim_idx`` is taken from
    ``input``'s dim ``input_dim_idx`` when the program runs
    (``paddle_tpu/layers/tensor.py:112``)."""
    helper = LayerHelper("fill_constant_batch_size_like")
    out_shape = list(shape)
    out_shape[output_dim_idx] = input.shape[input_dim_idx]
    dtype = str(convert_np_dtype(dtype))
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    shape=tuple(out_shape))
    helper.append_op("fill_constant_batch_size_like", {"Input": input},
                     {"Out": out},
                     {"shape": list(shape), "dtype": dtype,
                      "value": float(value), "input_dim_idx": input_dim_idx,
                      "output_dim_idx": output_dim_idx})
    return out


def ones(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def ones_like(x, out=None):
    helper = LayerHelper("ones_like")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=_dt(x),
                                                        shape=x.shape)
    helper.append_op("fill_constant_batch_size_like", {"Input": x},
                     {"Out": out},
                     {"shape": list(x.shape), "dtype": _dt(x), "value": 1.0})
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=_dt(x),
                                                        shape=x.shape)
    helper.append_op("fill_zeros_like", {"X": x}, {"Out": out}, {})
    return out


def reverse(x, axis):
    helper = LayerHelper("reverse")
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    out = helper.create_variable_for_type_inference(dtype=_dt(x),
                                                    shape=x.shape)
    helper.append_op("reverse", {"X": x}, {"Out": out}, {"axis": list(axes)})
    return out


def isfinite(x):
    helper = LayerHelper("isfinite")
    out = helper.create_variable_for_type_inference(dtype="bool", shape=(1,))
    helper.append_op("isfinite", {"X": x}, {"Out": out}, {})
    return out


def has_inf(x):
    """NOT ``isfinite(x)``: True where x holds an Inf or a NaN."""
    helper = LayerHelper("logical_not")
    out = helper.create_variable_for_type_inference(dtype="bool", shape=(1,))
    helper.append_op("logical_not", {"X": isfinite(x)}, {"Out": out}, {})
    return out


has_nan = has_inf


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global-block var the startup program fills with ``value``
    (``paddle_tpu/layers/tensor.py:32``)."""
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(name=name, shape=shape, dtype=dtype,
                                        persistable=persistable)
    from ..core import framework
    sb = framework.default_startup_program().global_block()
    sp = sb.create_var(name=var.name, shape=shape, dtype=dtype,
                       persistable=persistable)
    sb.append_op("fill_constant", outputs={"Out": sp},
                 attrs={"shape": tuple(shape), "dtype": dtype,
                        "value": float(value)})
    return var


def increment(x, value=1.0, in_place=True):
    """``x + value`` (``paddle_tpu/layers/tensor.py:387``), into ``x``
    itself unless ``in_place`` is False."""
    helper = LayerHelper("increment")
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(dtype=_dt(x),
                                                        shape=x.shape)
    helper.append_op("increment", {"X": x}, {"Out": out}, {"step": value})
    return out


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(
        dtype=str(convert_np_dtype(dtype)), shape=x.shape)
    helper.append_op("cast", {"X": x}, {"Out": out},
                     {"out_dtype": str(convert_np_dtype(dtype))})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    ax = axis % len(input[0].shape)
    dims = [t.shape[ax] for t in input]
    dim = -1 if any(d < 0 for d in dims) else sum(dims)
    shape = tuple(dim if i == ax else s for i, s in enumerate(input[0].shape))
    out = helper.create_variable_for_type_inference(dtype=_dt(input[0]),
                                                    shape=shape)
    helper.append_op("concat", {"X": list(input)}, {"Out": out}, {"axis": ax})
    return out


def assign(input, output=None):
    """Copy a Variable (``assign``) or a numpy array (``assign_value``,
    the values held in the op) into ``output``."""
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=_dt(input), shape=input.shape)
        helper.append_op("assign", {"X": input}, {"Out": output}, {})
        return output
    arr = np.asarray(input)
    if output is None:
        output = helper.create_variable_for_type_inference(
            dtype=str(arr.dtype), shape=arr.shape)
    helper.append_op("assign_value", outputs={"Out": output},
                     attrs={"shape": arr.shape, "dtype": str(arr.dtype),
                            "values": arr.flatten().tolist()})
    return output


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


arange = range


def linspace(start, stop, num, dtype="float32"):
    """``num`` evenly spaced values, held in the op (``assign_value``)."""
    return assign(np.linspace(start, stop, num).astype(
        convert_np_dtype(dtype)))


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


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", name=name)
    shape = list(input.shape)
    for a in sorted(axes):
        shape.insert(a, 1)
    out = helper.create_variable_for_type_inference(dtype=_dt(input),
                                                    shape=tuple(shape))
    helper.append_op("unsqueeze", {"X": input}, {"Out": out},
                     {"axes": list(axes)})
    return out


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten", name=name)
    lead = int(np.prod(x.shape[:axis])) if axis > 0 and all(
        s >= 0 for s in x.shape[:axis]) else -1
    trail = int(np.prod(x.shape[axis:])) if all(
        s >= 0 for s in x.shape[axis:]) else -1
    out = helper.create_variable_for_type_inference(dtype=_dt(x),
                                                    shape=(lead, trail))
    helper.append_op("flatten", {"X": x}, {"Out": out}, {"axis": axis})
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    shape = tuple(x.shape[p] for p in perm)
    out = helper.create_variable_for_type_inference(dtype=_dt(x), shape=shape)
    helper.append_op("transpose", {"X": x}, {"Out": out},
                     {"axis": list(perm)})
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


def strided_slice(input, axes, starts, ends, strides):
    helper = LayerHelper("strided_slice")
    out = helper.create_variable_for_type_inference(dtype=_dt(input),
                                                    shape=None)
    helper.append_op("strided_slice", {"Input": input}, {"Out": out},
                     {"axes": list(axes), "starts": list(starts),
                      "ends": list(ends), "strides": list(strides)})
    return out


def gather(input, index, overwrite=True):
    helper = LayerHelper("gather")
    n = index.shape[0] if index.shape else -1
    out = helper.create_variable_for_type_inference(
        dtype=_dt(input), shape=(n,) + tuple(input.shape[1:]))
    helper.append_op("gather", {"X": input, "Index": index}, {"Out": out}, {})
    return out


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd", name=name)
    out = helper.create_variable_for_type_inference(dtype=_dt(input),
                                                    shape=None)
    helper.append_op("gather_nd", {"X": input, "Index": index},
                     {"Out": out}, {})
    return out


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(dtype=_dt(input),
                                                    shape=input.shape)
    helper.append_op("scatter",
                     {"X": input, "Ids": index, "Updates": updates},
                     {"Out": out}, {"overwrite": overwrite})
    return out


def expand(x, expand_times, name=None):
    """``x`` tiled ``expand_times`` times along each dim
    (``paddle_tpu/layers/tensor.py:327``)."""
    helper = LayerHelper("expand", name=name)
    shape = tuple(s * t if s >= 0 else -1
                  for s, t in zip(x.shape, expand_times))
    out = helper.create_variable_for_type_inference(dtype=_dt(x), shape=shape)
    helper.append_op("expand", {"X": x}, {"Out": out},
                     {"expand_times": list(expand_times)})
    return out


def expand_as(x, target_tensor, name=None):
    helper = LayerHelper("expand_as", name=name)
    out = helper.create_variable_for_type_inference(dtype=_dt(x),
                                                    shape=target_tensor.shape)
    helper.append_op("expand_as", {"X": x, "target_tensor": target_tensor},
                     {"Out": out}, {})
    return out


def stack(x, axis=0):
    helper = LayerHelper("stack")
    xs = x if isinstance(x, (list, tuple)) else [x]
    shape = list(xs[0].shape)
    shape.insert(axis % (len(shape) + 1), len(xs))
    out = helper.create_variable_for_type_inference(dtype=_dt(xs[0]),
                                                    shape=tuple(shape))
    helper.append_op("stack", {"X": list(xs)}, {"Y": out}, {"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    ax = axis % len(x.shape)
    num = num or x.shape[ax]
    shape = tuple(s for i, s in enumerate(x.shape) if i != ax)
    outs = [helper.create_variable_for_type_inference(dtype=_dt(x),
                                                      shape=shape)
            for _ in builtins.range(num)]
    helper.append_op("unstack", {"X": x}, {"Y": outs}, {"axis": ax})
    return outs


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference(
        dtype="int32", shape=(len(input.shape),))
    helper.append_op("shape", {"Input": input}, {"Out": out}, {})
    return out


def where(condition, x, y):
    helper = LayerHelper("where")
    out = helper.create_variable_for_type_inference(dtype=_dt(x),
                                                    shape=x.shape)
    helper.append_op("where", {"Condition": condition, "X": x, "Y": y},
                     {"Out": out}, {})
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    shape=tuple(shape))
    helper.append_op("uniform_random", outputs={"Out": out},
                     attrs={"shape": tuple(shape), "dtype": dtype,
                            "min": min, "max": max, "seed": seed})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    shape=tuple(shape))
    helper.append_op("gaussian_random", outputs={"Out": out},
                     attrs={"shape": tuple(shape), "dtype": dtype,
                            "mean": mean, "std": std, "seed": seed})
    return out


def _random_batch_size_like(op_type, input, shape, dtype, input_dim_idx,
                            output_dim_idx, attrs):
    helper = LayerHelper(op_type)
    out_shape = list(shape)
    out_shape[output_dim_idx] = input.shape[input_dim_idx]
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    shape=tuple(out_shape))
    helper.append_op(op_type, {"Input": input}, {"Out": out},
                     dict(attrs, shape=list(shape), dtype=dtype,
                          input_dim_idx=input_dim_idx,
                          output_dim_idx=output_dim_idx))
    return out


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    return _random_batch_size_like(
        "uniform_random_batch_size_like", input, shape, dtype,
        input_dim_idx, output_dim_idx, {"min": min, "max": max})


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    return _random_batch_size_like(
        "gaussian_random_batch_size_like", input, shape, dtype,
        input_dim_idx, output_dim_idx, {"mean": mean, "std": std})


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    """One categorical draw per row of ``x`` [B, C] (probabilities): ids
    [B] (an int64 var, held in int32 under the 32-bit convention), from the
    executor's generator. ``min``/``max``/``seed`` are accepted for parity
    and unused, as in ``paddle_tpu``."""
    helper = LayerHelper("sampling_id")
    out = helper.create_variable_for_type_inference(dtype="int64",
                                                    shape=(x.shape[0],))
    helper.append_op("sampling_id", {"X": x}, {"Out": out}, {})
    return out
