"""Neural layers (the subset of ``paddle_tpu/layers/nn.py`` this slice
carries; ref ``python/paddle/fluid/layers/nn.py``). Every layer appends
symbolic ops and creates its parameters exactly as ``paddle_tpu`` does, so
both packages give every var and parameter the same name."""

import copy

import numpy as np

from ..core.initializer import (ConstantInitializer, NormalInitializer,
                                XavierInitializer)
from ..core.layer_helper import LayerHelper
from ..core.op_registry import static_bcast_shape
from ..core.param_attr import ParamAttr

__all__ = [
    "fc", "embedding", "conv2d", "pool2d", "batch_norm", "layer_norm",
    "dropout", "softmax", "scale", "mean", "pow", "elementwise_add",
    "elementwise_sub", "elementwise_mul", "elementwise_div", "reduce_sum",
    "topk", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "fused_linear_smooth_ce",
    "multi_head_attention",
]


def _dtype(x):
    return str(x.dtype)


def _conv_out(size, k, s, p, d=1):
    if size is None or size < 0:
        return -1
    return (size + 2 * p - (d * (k - 1) + 1)) // s + 1


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


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
    """Embedding lookup (ref ``nn.py`` embedding / ``lookup_table_op``).
    ``is_sparse`` gives the table a sparse (rows, values) gradient when
    only such lookups read it (``backward.append_backward``), which the
    optimizers apply as row updates. ``is_distributed`` is recorded and
    has no effect on one device."""
    helper = LayerHelper("embedding", param_attr=param_attr, name=name)
    w = helper.create_parameter(helper.param_attr, shape=list(size),
                                dtype=dtype)
    w.is_distributed = is_distributed
    if is_sparse:
        w.is_sparse_grad = True
    in_shape = input.shape
    base = in_shape[:-1] if (in_shape and in_shape[-1] == 1) else in_shape
    out = helper.create_variable_for_type_inference(
        dtype=dtype, shape=tuple(base) + (size[1],))
    helper.append_op(
        "lookup_table", {"W": w, "Ids": input}, {"Out": out},
        {"is_sparse": is_sparse,
         "padding_idx": padding_idx if padding_idx is not None else -1})
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    """2-D convolution, NCHW (ref ``nn.py`` conv2d / ``conv_op.cc``); the
    filter is drawn from N(0, 2 / (k*k*C)) as in ``paddle_tpu``.
    ``use_cudnn`` is accepted for parity."""
    helper = LayerHelper("conv2d", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    k, s, p, d = (_pair(v) for v in (filter_size, stride, padding, dilation))
    n, c, h, w_ = input.shape
    std = (2.0 / (k[0] * k[1] * c)) ** 0.5
    filt = helper.create_parameter(
        helper.param_attr, shape=[num_filters, c // groups, k[0], k[1]],
        dtype=_dtype(input), default_initializer=NormalInitializer(0.0, std))
    out_shape = (n, num_filters, _conv_out(h, k[0], s[0], p[0], d[0]),
                 _conv_out(w_, k[1], s[1], p[1], d[1]))
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(input), shape=out_shape)
    helper.append_op(
        "conv2d", {"Input": input, "Filter": filt}, {"Output": out},
        {"strides": list(s), "paddings": list(p), "dilations": list(d),
         "groups": groups})
    if helper.bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr, shape=[num_filters],
                                    dtype=_dtype(input), is_bias=True)
        tmp = helper.create_variable_for_type_inference(
            dtype=_dtype(input), shape=out_shape)
        helper.append_op("elementwise_add", {"X": out, "Y": b}, {"Out": tmp},
                         {"axis": 1})
        out = tmp
    return helper.append_activation(out)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None):
    helper = LayerHelper("pool2d", name=name)
    k, s, p = _pair(pool_size), _pair(pool_stride), _pair(pool_padding)
    n, c, h, w_ = input.shape
    if global_pooling:
        out_shape = (n, c, 1, 1)
    else:
        rnd = (lambda a, b: -(-a // b)) if ceil_mode else (lambda a, b: a // b)
        oh = rnd(h + 2 * p[0] - k[0], s[0]) + 1 if h > 0 else -1
        ow = rnd(w_ + 2 * p[1] - k[1], s[1]) + 1 if w_ > 0 else -1
        out_shape = (n, c, oh, ow)
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(input), shape=out_shape)
    helper.append_op(
        "pool2d", {"X": input}, {"Out": out},
        {"pooling_type": pool_type, "ksize": list(k), "strides": list(s),
         "paddings": list(p), "global_pooling": global_pooling,
         "ceil_mode": ceil_mode, "exclusive": exclusive})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               use_global_stats=False):
    """BatchNorm (ref ``nn.py`` batch_norm / ``batch_norm_op.cc``). The
    moving mean and variance are ``trainable=False`` parameters, updated
    by the op each training step (``MeanOut``/``VarianceOut`` alias them)."""
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    dtype = _dtype(input)
    scale = helper.create_parameter(
        helper.param_attr, shape=[c], dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(
        helper.bias_attr, shape=[c], dtype=dtype, is_bias=True)
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, trainable=False), shape=[c],
        dtype=dtype, default_initializer=ConstantInitializer(0.0))
    variance = helper.create_parameter(
        ParamAttr(name=moving_variance_name, trainable=False), shape=[c],
        dtype=dtype, default_initializer=ConstantInitializer(1.0))
    mean.stop_gradient = True
    variance.stop_gradient = True
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    shape=input.shape)
    saved_mean = helper.create_variable_for_type_inference(
        dtype=dtype, shape=(c,), stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        dtype=dtype, shape=(c,), stop_gradient=True)
    helper.append_op(
        "batch_norm",
        {"X": input, "Scale": scale, "Bias": bias, "Mean": mean,
         "Variance": variance},
        {"Y": out, "MeanOut": mean, "VarianceOut": variance,
         "SavedMean": saved_mean, "SavedVariance": saved_var},
        {"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
         "data_layout": data_layout, "use_global_stats": use_global_stats})
    return helper.append_activation(out)


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


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(dtype=_dtype(x),
                                                    shape=())
    helper.append_op("mean", {"X": x}, {"Out": out}, {})
    return out


def pow(x, factor=1.0, name=None):
    helper = LayerHelper("pow", name=name)
    out = helper.create_variable_for_type_inference(dtype=_dtype(x),
                                                    shape=x.shape)
    helper.append_op("pow", {"X": x}, {"Out": out}, {"factor": factor})
    return out


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, act=act, name=name)
    try:
        out_shape = static_bcast_shape(x.shape, y.shape, axis)
    except ValueError:
        out_shape = x.shape  # infeasible: the op reports it when run
    out = helper.create_variable_for_type_inference(dtype=_dtype(x),
                                                    shape=out_shape)
    helper.append_op(op_type, {"X": x, "Y": y}, {"Out": out}, {"axis": axis})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def _reduce_layer(op_type, input, dim, keep_dim, name):
    helper = LayerHelper(op_type, name=name)
    if dim is None:
        out_shape = ()
        reduce_all = True
        dims = [0]
    else:
        dims = dim if isinstance(dim, (list, tuple)) else [dim]
        reduce_all = False
        nd = len(input.shape)
        axes = {d % nd for d in dims}
        if keep_dim:
            out_shape = tuple(1 if i in axes else s
                              for i, s in enumerate(input.shape))
        else:
            out_shape = tuple(s for i, s in enumerate(input.shape)
                              if i not in axes)
    out = helper.create_variable_for_type_inference(dtype=_dtype(input),
                                                    shape=out_shape)
    helper.append_op(op_type, {"X": input}, {"Out": out},
                     {"dim": list(dims), "keep_dim": keep_dim,
                      "reduce_all": reduce_all})
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_sum", input, dim, keep_dim, name)


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    out_shape = tuple(input.shape[:-1]) + (k,)
    values = helper.create_variable_for_type_inference(
        dtype=_dtype(input), shape=out_shape)
    indices = helper.create_variable_for_type_inference(
        dtype="int32", shape=out_shape, stop_gradient=True)
    helper.append_op("top_k", {"X": input},
                     {"Out": values, "Indices": indices}, {"k": k})
    return values, indices


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    loss = helper.create_variable_for_type_inference(
        dtype=_dtype(logits), shape=tuple(logits.shape[:-1]) + (1,))
    softmax_out = helper.create_variable_for_type_inference(
        dtype=_dtype(logits), shape=logits.shape)
    helper.append_op("softmax_with_cross_entropy",
                     {"Logits": logits, "Label": label},
                     {"Loss": loss, "Softmax": softmax_out},
                     {"soft_label": soft_label, "ignore_index": ignore_index})
    if return_softmax:
        return loss, softmax_out
    return loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None,
                                      normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(dtype=_dtype(x),
                                                    shape=x.shape)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     {"X": x, "Label": label}, {"Out": out},
                     {"ignore_index": ignore_index, "normalize": normalize})
    return out


def fused_linear_smooth_ce(input, label, size, epsilon=0.0,
                           param_attr=None, bias_attr=None, name=None):
    """Vocab projection + label-smoothed softmax CE, fused
    (``paddle_tpu/layers/nn.py:766``: the [.., V] logits never reach device
    memory — ``ops/fused_ce.py``). ``input``: [..., D]; ``label``: int ids
    shaped like ``input[:-1]``. Returns the per-position f32 loss of shape
    ``input.shape[:-1]``."""
    helper = LayerHelper("fused_linear_smooth_ce", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    d_in = int(input.shape[-1])
    w = helper.create_parameter(helper.param_attr, shape=[d_in, size],
                                dtype=_dtype(input))
    inputs = {"X": input, "W": w, "Label": label}
    if bias_attr is not False:
        inputs["Bias"] = helper.create_parameter(
            helper.bias_attr, shape=[size], dtype=_dtype(input), is_bias=True)
    loss = helper.create_variable_for_type_inference(
        dtype="float32", shape=tuple(input.shape[:-1]))
    helper.append_op("fused_linear_smooth_ce", inputs, {"Loss": loss},
                     {"epsilon": float(epsilon)})
    return loss


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
