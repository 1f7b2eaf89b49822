"""Neural layers (the subset of ``paddle_tpu/layers/nn.py`` this slice
carries; ref ``python/paddle/fluid/layers/nn.py``). Every layer appends
symbolic ops and creates its parameters exactly as ``paddle_tpu`` does, so
both packages give every var and parameter the same name."""

import copy

import numpy as np

from ..core.initializer import ConstantInitializer, XavierInitializer
from ..core.layer_helper import LayerHelper
from ..core.op_registry import static_bcast_shape
from ..core.param_attr import ParamAttr

__all__ = [
    "fc", "embedding", "layer_norm", "dropout", "softmax", "scale",
    "elementwise_add", "multi_head_attention",
]


def _dtype(x):
    return str(x.dtype)


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully-connected layer (ref ``nn.py`` fc). Multiple inputs are summed
    after projection, matching the reference."""
    helper = LayerHelper("fc", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    attrs = ParamAttr._to_attr(param_attr)
    if not isinstance(attrs, list):
        # one attr per input: unnamed copies each generate a fresh name,
        # named ones get a _<i> suffix
        copies = [attrs]
        for i in range(1, len(inputs)):
            c = copy.copy(attrs)
            if c.name is not None:
                c.name = "%s_%d" % (c.name, i)
            copies.append(c)
        attrs = copies
    mul_results = []
    for inp, attr in zip(inputs, attrs):
        in_shape = inp.shape
        flat_dim = int(np.prod(in_shape[num_flatten_dims:]))
        w = helper.create_parameter(attr, shape=[flat_dim, size],
                                    dtype=_dtype(inp))
        out_shape = tuple(in_shape[:num_flatten_dims]) + (size,)
        tmp = helper.create_variable_for_type_inference(
            dtype=_dtype(inp), shape=out_shape)
        helper.append_op("mul", {"X": inp, "Y": w}, {"Out": tmp},
                         {"x_num_col_dims": num_flatten_dims,
                          "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(
            dtype=_dtype(inputs[0]), shape=mul_results[0].shape)
        helper.append_op("sum", {"X": mul_results}, {"Out": pre_bias}, {})
    pre_act = helper.append_bias_op(pre_bias)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32", name=None):
    """Embedding lookup (ref ``nn.py`` embedding / ``lookup_table_op``)."""
    helper = LayerHelper("embedding", param_attr=param_attr, name=name)
    w = helper.create_parameter(helper.param_attr, shape=list(size),
                                dtype=dtype)
    w.is_distributed = is_distributed
    in_shape = input.shape
    base = in_shape[:-1] if (in_shape and in_shape[-1] == 1) else in_shape
    out = helper.create_variable_for_type_inference(
        dtype=dtype, shape=tuple(base) + (size[1],))
    helper.append_op(
        "lookup_table", {"W": w, "Ids": input}, {"Out": out},
        {"is_sparse": is_sparse,
         "padding_idx": padding_idx if padding_idx is not None else -1})
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = _dtype(input)
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": input}
    if scale:
        inputs["Scale"] = helper.create_parameter(
            helper.param_attr, shape=norm_shape, dtype=dtype,
            default_initializer=ConstantInitializer(1.0))
    if shift:
        inputs["Bias"] = helper.create_parameter(
            helper.bias_attr, shape=norm_shape, dtype=dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    shape=input.shape)
    mean = helper.create_variable_for_type_inference(
        dtype=dtype, shape=input.shape[:begin_norm_axis], stop_gradient=True)
    var = helper.create_variable_for_type_inference(
        dtype=dtype, shape=input.shape[:begin_norm_axis], stop_gradient=True)
    helper.append_op("layer_norm", inputs,
                     {"Y": out, "Mean": mean, "Variance": var},
                     {"epsilon": epsilon, "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(dtype=_dtype(x),
                                                    shape=x.shape)
    mask = helper.create_variable_for_type_inference(
        dtype=_dtype(x), shape=x.shape, stop_gradient=True)
    helper.append_op("dropout", {"X": x}, {"Out": out, "Mask": mask},
                     {"dropout_prob": dropout_prob, "is_test": is_test,
                      "dropout_implementation": dropout_implementation})
    return out


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(dtype=_dtype(input),
                                                    shape=input.shape)
    helper.append_op("softmax", {"X": input}, {"Out": out}, {"axis": axis})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = helper.create_variable_for_type_inference(dtype=_dtype(x),
                                                    shape=x.shape)
    helper.append_op("scale", {"X": x}, {"Out": out},
                     {"scale": scale, "bias": bias,
                      "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    helper = LayerHelper("elementwise_add", act=act, name=name)
    try:
        out_shape = static_bcast_shape(x.shape, y.shape, axis)
    except ValueError:
        out_shape = x.shape  # infeasible: the op reports it when run
    out = helper.create_variable_for_type_inference(dtype=_dtype(x),
                                                    shape=out_shape)
    helper.append_op("elementwise_add", {"X": x, "Y": y}, {"Out": out},
                     {"axis": axis})
    return helper.append_activation(out)


def multi_head_attention(queries, keys, values, attn_bias=None, d_key=None,
                         d_value=None, d_model=None, n_head=1,
                         dropout_rate=0.0, causal=False, param_attr=None,
                         name=None):
    """Multi-head attention (``paddle_tpu/layers/nn.py:1687``): q/k/v
    projections (``matmul``, no bias), the ``flash_attention`` op on the
    packed [B, T, H*D] layout, and the output projection."""
    helper = LayerHelper("multi_head_attention", param_attr=param_attr,
                         name=name)
    d_model = d_model or queries.shape[-1]
    d_key = d_key or d_model // n_head
    d_value = d_value or d_model // n_head
    dtype = _dtype(queries)

    def proj(x, dout, tag):
        w = helper.create_parameter(
            ParamAttr(name=None if name is None else name + "." + tag,
                      initializer=XavierInitializer(),
                      sharding=(None, "mp")),
            shape=[x.shape[-1], dout], dtype=dtype)
        out = helper.create_variable_for_type_inference(
            dtype=dtype, shape=tuple(x.shape[:-1]) + (dout,))
        helper.append_op("matmul", {"X": x, "Y": w}, {"Out": out}, {})
        return out

    q = proj(queries, d_key * n_head, "q")
    k = proj(keys, d_key * n_head, "k")
    v = proj(values, d_value * n_head, "v")
    ctx = helper.create_variable_for_type_inference(
        dtype=dtype, shape=tuple(queries.shape[:-1]) + (d_value * n_head,))
    inputs = {"Q": q, "K": k, "V": v}
    if attn_bias is not None:
        inputs["Bias"] = attn_bias
    helper.append_op("flash_attention", inputs, {"Out": ctx},
                     {"num_heads": n_head, "dropout_rate": dropout_rate,
                      "causal": causal})
    wo = helper.create_parameter(
        ParamAttr(name=None if name is None else name + ".out",
                  initializer=XavierInitializer(), sharding=("mp", None)),
        shape=[d_value * n_head, d_model], dtype=dtype)
    out = helper.create_variable_for_type_inference(
        dtype=dtype, shape=tuple(queries.shape[:-1]) + (d_model,))
    helper.append_op("matmul", {"X": ctx, "Y": wo}, {"Out": out}, {})
    return out
