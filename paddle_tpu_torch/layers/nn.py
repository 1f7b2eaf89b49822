"""Neural layers (``paddle_tpu/layers/nn.py`` but ``moe_ffn``; ref
``python/paddle/fluid/layers/nn.py``). Every layer appends
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
    "elementwise_sub", "elementwise_mul", "elementwise_div",
    "elementwise_max", "elementwise_min", "elementwise_pow",
    "elementwise_mod", "reduce_sum",
    "topk", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "fused_linear_smooth_ce",
    "log_softmax", "cross_entropy", "smooth_softmax_with_cross_entropy",
    "square_error_cost", "smooth_l1", "huber_loss", "label_smooth",
    "kldiv_loss", "bpr_loss", "hinge_loss", "log_loss", "margin_rank_loss",
    "mse_loss",
    "multi_head_attention", "kv_cache_write", "cached_multi_head_attention",
    "kv_cache_write_chunk", "cached_multi_head_attention_chunk",
    "autoincreased_step_counter",
    "mul", "matmul", "clip", "clip_by_norm", "reduce_mean", "reduce_max",
    "reduce_min", "reduce_prod", "argmax", "argmin", "argsort",
    "l2_normalize", "cos_sim", "relu", "prelu", "maxout", "swish", "gelu",
    "brelu", "leaky_relu", "elu", "relu6", "stanh", "hard_sigmoid",
    "one_hot", "pad", "pad2d", "split", "cumsum",
    "dynamic_gru", "gru_unit", "beam_search", "beam_search_gather",
    "beam_search_decode", "dynamic_lstm", "dynamic_lstmp", "attention_lstm",
    "tree_conv", "lstm", "warpctc", "linear_chain_crf", "crf_decoding", "nce",
    "hsigmoid",
    "depthwise_conv2d", "conv3d", "conv2d_transpose", "adaptive_pool2d",
    "group_norm", "lrn", "lod_reset", "image_resize", "resize_bilinear",
    "resize_nearest", "grid_sampler", "pixel_shuffle", "im2sequence",
    "row_conv", "scaled_dot_product_attention",
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
    return _bias_act(helper, out, num_filters, _dtype(input))


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


def depthwise_conv2d(input, num_filters, filter_size, **kwargs):
    kwargs["groups"] = input.shape[1]
    return conv2d(input, num_filters, filter_size, **kwargs)


def _bias_act(helper, out, num_filters, dtype):
    """The per-channel bias (unless ``bias_attr`` is False) and the
    activation of a conv layer."""
    if helper.bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr, shape=[num_filters],
                                    dtype=dtype, is_bias=True)
        tmp = helper.create_variable_for_type_inference(dtype=dtype,
                                                        shape=out.shape)
        helper.append_op("elementwise_add", {"X": out, "Y": b}, {"Out": tmp},
                         {"axis": 1})
        out = tmp
    return helper.append_activation(out)


def _triple(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * 3


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("conv3d", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    k, s, p, d = (_triple(v) for v in (filter_size, stride, padding,
                                       dilation))
    n, c = input.shape[0], input.shape[1]
    filt = helper.create_parameter(
        helper.param_attr, shape=[num_filters, c // groups] + list(k),
        dtype=_dtype(input))
    out_shape = (n, num_filters) + tuple(
        _conv_out(sz, k[i], s[i], p[i], d[i])
        for i, sz in enumerate(input.shape[2:]))
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(input), shape=out_shape)
    helper.append_op(
        "conv3d", {"Input": input, "Filter": filt}, {"Output": out},
        {"strides": list(s), "paddings": list(p), "dilations": list(d),
         "groups": groups})
    return _bias_act(helper, out, num_filters, _dtype(input))


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None, name=None):
    """Transposed conv, NCHW, filter [C, num_filters / groups, kh, kw]; the
    filter size follows from ``output_size`` when not given."""
    helper = LayerHelper("conv2d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    s, p, d = _pair(stride), _pair(padding), _pair(dilation)
    n, c, h, w_ = input.shape
    if filter_size is None:
        assert output_size is not None
        osz = _pair(output_size)
        k = tuple(osz[i] - (input.shape[2 + i] - 1) * s[i] + 2 * p[i]
                  for i in range(2))
    else:
        k = _pair(filter_size)
    filt = helper.create_parameter(
        helper.param_attr, shape=[c, num_filters // groups, k[0], k[1]],
        dtype=_dtype(input))
    oh = (h - 1) * s[0] - 2 * p[0] + d[0] * (k[0] - 1) + 1 if h > 0 else -1
    ow = (w_ - 1) * s[1] - 2 * p[1] + d[1] * (k[1] - 1) + 1 if w_ > 0 else -1
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(input), shape=(n, num_filters, oh, ow))
    helper.append_op(
        "conv2d_transpose", {"Input": input, "Filter": filt},
        {"Output": out},
        {"strides": list(s), "paddings": list(p), "dilations": list(d),
         "groups": groups})
    return _bias_act(helper, out, num_filters, _dtype(input))


def adaptive_pool2d(input, pool_size, pool_type="max", name=None):
    helper = LayerHelper("adaptive_pool2d", name=name)
    k = _pair(pool_size)
    n, c = input.shape[0], input.shape[1]
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(input), shape=(n, c, k[0], k[1]))
    helper.append_op(
        "pool2d", {"X": input}, {"Out": out},
        {"pooling_type": pool_type, "ksize": list(k), "adaptive": True})
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


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, name=None):
    helper = LayerHelper("group_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    c = input.shape[1]
    dtype = _dtype(input)
    scale = helper.create_parameter(
        helper.param_attr, shape=[c], dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(helper.bias_attr, shape=[c], dtype=dtype,
                                   is_bias=True)
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    shape=input.shape)
    helper.append_op("group_norm",
                     {"X": input, "Scale": scale, "Bias": bias},
                     {"Y": out}, {"groups": groups, "epsilon": epsilon})
    return helper.append_activation(out)


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    return _unary_layer("lrn", input, {"n": n, "k": k, "alpha": alpha,
                                       "beta": beta}, name)


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


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, axis, act, name)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mod", x, y, axis, act, name)


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


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_prod", input, dim, keep_dim, name)


# ---------------------------------------------------------------------------
# the activations, products and tensor basics of paddle_tpu/layers/nn.py
# (:406-718, :1121-1157)
# ---------------------------------------------------------------------------

def _unary_layer(op_type, x, attrs=None, name=None, out_shape=None,
                 out_dtype=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(
        dtype=out_dtype or _dtype(x),
        shape=x.shape if out_shape is None else out_shape)
    helper.append_op(op_type, {"X": x}, {"Out": out}, attrs or {})
    return out


def relu(x, name=None):
    return _unary_layer("relu", x, name=name)


def relu6(x, threshold=6.0, name=None):
    return _unary_layer("relu6", x, {"threshold": threshold}, name)


def leaky_relu(x, alpha=0.02, name=None):
    return _unary_layer("leaky_relu", x, {"alpha": alpha}, name)


def elu(x, alpha=1.0, name=None):
    return _unary_layer("elu", x, {"alpha": alpha}, name)


def gelu(x, approximate=None, name=None):
    """``approximate=None`` lets the op pick (exact in f32, the tanh form
    under AMP); a bool pins the form."""
    attrs = {} if approximate is None else {"approximate": approximate}
    return _unary_layer("gelu", x, attrs, name)


def swish(x, beta=1.0, name=None):
    return _unary_layer("swish", x, {"beta": beta}, name)


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _unary_layer("brelu", x, {"t_min": t_min, "t_max": t_max}, name)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _unary_layer("stanh", x, {"scale_a": scale_a, "scale_b": scale_b},
                        name)


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return _unary_layer("hard_sigmoid", x, {"slope": slope, "offset": offset},
                        name)


def prelu(x, mode="all", param_attr=None, name=None):
    """``where(x > 0, x, alpha * x)`` with a learned alpha (0.25 at start):
    one, one a channel, or one an element of x's non-batch dims."""
    helper = LayerHelper("prelu", param_attr=param_attr, name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [x.shape[1]]
    else:
        alpha_shape = [int(np.prod(x.shape[1:]))]
    alpha = helper.create_parameter(
        helper.param_attr, shape=alpha_shape, dtype=_dtype(x),
        default_initializer=ConstantInitializer(0.25))
    out = helper.create_variable_for_type_inference(dtype=_dtype(x),
                                                    shape=x.shape)
    helper.append_op("prelu", {"X": x, "Alpha": alpha}, {"Out": out},
                     {"mode": mode})
    return out


def maxout(x, groups, name=None):
    n, c, h, w = x.shape
    return _unary_layer("maxout", x, {"groups": groups}, name,
                        out_shape=(n, c // groups, h, w))


def clip(x, min, max, name=None):
    return _unary_layer("clip", x, {"min": min, "max": max}, name)


def clip_by_norm(x, max_norm, name=None):
    return _unary_layer("clip_by_norm", x, {"max_norm": max_norm}, name)


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out_shape = (tuple(x.shape[:x_num_col_dims])
                 + tuple(y.shape[y_num_col_dims:]))
    out = helper.create_variable_for_type_inference(dtype=_dtype(x),
                                                    shape=out_shape)
    helper.append_op("mul", {"X": x, "Y": y}, {"Out": out},
                     {"x_num_col_dims": x_num_col_dims,
                      "y_num_col_dims": y_num_col_dims})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    xs, ys = list(x.shape), list(y.shape)
    if transpose_x and len(xs) >= 2:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if transpose_y and len(ys) >= 2:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    batch = xs[:-2] if len(xs) >= len(ys) else ys[:-2]
    out_shape = (tuple(batch) + (xs[-2], ys[-1])
                 if len(xs) >= 2 and len(ys) >= 2 else None)
    out = helper.create_variable_for_type_inference(dtype=_dtype(x),
                                                    shape=out_shape)
    helper.append_op("matmul", {"X": x, "Y": y}, {"Out": out},
                     {"transpose_X": transpose_x, "transpose_Y": transpose_y,
                      "alpha": alpha})
    return out


def cumsum(x, axis=-1, exclusive=False, reverse=False, name=None):
    return _unary_layer("cumsum", x, {"axis": axis, "exclusive": exclusive,
                                      "reverse": reverse}, name)


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    axis = dim % len(input.shape)
    if isinstance(num_or_sections, int):
        sections = [input.shape[axis] // num_or_sections] * num_or_sections
        attrs = {"num": num_or_sections, "axis": axis}
    else:
        sections = list(num_or_sections)
        attrs = {"sections": sections, "axis": axis}
    outs = [helper.create_variable_for_type_inference(
        dtype=_dtype(input),
        shape=tuple(sec if i == axis else s
                    for i, s in enumerate(input.shape)))
        for sec in sections]
    helper.append_op("split", {"X": input}, {"Out": outs}, attrs)
    return outs


def _drop_axis(x, axis):
    return tuple(s for i, s in enumerate(x.shape) if i != axis % len(x.shape))


def argmax(x, axis=0, name=None):
    return _unary_layer("argmax", x, {"axis": axis}, name,
                        out_shape=_drop_axis(x, axis), out_dtype="int32")


def argmin(x, axis=0, name=None):
    return _unary_layer("argmin", x, {"axis": axis}, name,
                        out_shape=_drop_axis(x, axis), out_dtype="int32")


def argsort(input, axis=-1, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(dtype=_dtype(input),
                                                    shape=input.shape)
    ids = helper.create_variable_for_type_inference(
        dtype="int32", shape=input.shape, stop_gradient=True)
    helper.append_op("argsort", {"X": input},
                     {"Out": out, "Indices": ids}, {"axis": axis})
    return out, ids


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(dtype=_dtype(x),
                                                    shape=x.shape)
    norm = helper.create_variable_for_type_inference(dtype=_dtype(x),
                                                     shape=x.shape)
    helper.append_op("norm", {"X": x}, {"Out": out, "Norm": norm},
                     {"axis": axis, "epsilon": epsilon})
    return out


def cos_sim(X, Y, name=None):
    return reduce_sum(elementwise_mul(l2_normalize(X, axis=-1),
                                      l2_normalize(Y, axis=-1)),
                      dim=-1, keep_dim=True)


def one_hot(input, depth, name=None):
    """float32 rows of ``depth``, 1 at each id (``paddle_tpu/layers/
    nn.py:1121``); a trailing dim of 1 on the ids is dropped."""
    base = (input.shape[:-1] if input.shape and input.shape[-1] == 1
            else input.shape)
    return _unary_layer("one_hot", input, {"depth": depth}, name,
                        out_shape=tuple(base) + (depth,), out_dtype="float32")


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    shape = tuple((s + paddings[2 * i] + paddings[2 * i + 1]) if s >= 0
                  else -1 for i, s in enumerate(x.shape))
    out = helper.create_variable_for_type_inference(dtype=_dtype(x),
                                                    shape=shape)
    helper.append_op("pad", {"X": x}, {"Out": out},
                     {"paddings": list(paddings), "pad_value": pad_value})
    return out


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper("pad2d", name=name)
    n, c, h, w = input.shape
    shape = (n, c, h + paddings[0] + paddings[1] if h >= 0 else -1,
             w + paddings[2] + paddings[3] if w >= 0 else -1)
    out = helper.create_variable_for_type_inference(dtype=_dtype(input),
                                                    shape=shape)
    helper.append_op("pad2d", {"X": input}, {"Out": out},
                     {"paddings": list(paddings), "mode": mode,
                      "pad_value": pad_value})
    return out


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


def _loss_layer(op_type, inputs, out_slot, shape, dtype, attrs=None,
                name=None, extra=(), helper_name=None):
    """One loss op: each of ``extra`` and then ``out_slot`` a new var
    shaped ``shape`` (in the reference's order of creation); returns the
    ``out_slot`` var."""
    helper = LayerHelper(helper_name or op_type, name=name)
    outs = {slot: helper.create_variable_for_type_inference(dtype=dtype,
                                                            shape=shape)
            for slot in tuple(extra) + (out_slot,)}
    helper.append_op(op_type, {k: v for k, v in inputs.items()
                               if v is not None}, outs, attrs or {})
    return outs[out_slot]


def log_softmax(input, axis=-1, name=None):
    return _loss_layer("log_softmax", {"X": input}, "Out", input.shape,
                       _dtype(input), {"axis": axis}, name)


def cross_entropy(input, label, soft_label=False, ignore_index=-100,
                  name=None):
    """-log of the label's probability (``input`` holds probabilities),
    [..., 1]."""
    return _loss_layer("cross_entropy", {"X": input, "Label": label}, "Y",
                       tuple(input.shape[:-1]) + (1,), _dtype(input),
                       {"soft_label": soft_label,
                        "ignore_index": ignore_index}, name)


def smooth_softmax_with_cross_entropy(logits, label, epsilon=0.0):
    """Label-smoothed softmax CE in closed form, one pass over the logits
    (``paddle_tpu/layers/nn.py:749``); the loss has the class axis
    reduced away."""
    return _loss_layer("smooth_softmax_ce", {"Logits": logits,
                                             "Label": label}, "Loss",
                       tuple(logits.shape[:-1]), "float32",
                       {"epsilon": float(epsilon)},
                       helper_name="smooth_softmax_with_cross_entropy")


def square_error_cost(input, label, name=None):
    return _loss_layer("square_error_cost", {"X": input, "Y": label}, "Out",
                       input.shape, _dtype(input), name=name)


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=1.0,
              name=None):
    helper = LayerHelper("smooth_l1_loss", name=name)
    diff = helper.create_variable_for_type_inference(dtype=_dtype(x),
                                                     shape=x.shape)
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(x), shape=(x.shape[0], 1))
    inputs = {"X": x, "Y": y, "InsideWeight": inside_weight,
              "OutsideWeight": outside_weight}
    helper.append_op("smooth_l1_loss",
                     {k: v for k, v in inputs.items() if v is not None},
                     {"Diff": diff, "Out": out}, {"sigma": sigma})
    return out


def huber_loss(input, label, delta, name=None):
    return _loss_layer("huber_loss", {"X": input, "Y": label}, "Out",
                       input.shape, _dtype(input), {"delta": delta}, name,
                       extra=("Residual",))


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    return _loss_layer("label_smooth", {"X": label, "PriorDist": prior_dist},
                       "Out", label.shape, dtype,
                       {"epsilon": float(epsilon)}, name)


def kldiv_loss(x, target, reduction="mean", name=None):
    shape = () if reduction in ("mean", "sum", "batchmean") else x.shape
    return _loss_layer("kldiv_loss", {"X": x, "Target": target}, "Loss",
                       shape, _dtype(x), {"reduction": reduction}, name)


def bpr_loss(input, label, name=None):
    return _loss_layer("bpr_loss", {"X": input, "Label": label}, "Y",
                       (input.shape[0], 1), _dtype(input), name=name)


def hinge_loss(input, label, name=None):
    return _loss_layer("hinge_loss", {"Logits": input, "Labels": label},
                       "Loss", input.shape, _dtype(input), name=name)


def log_loss(input, label, epsilon=1e-4, name=None):
    return _loss_layer("log_loss", {"Predicted": input, "Labels": label},
                       "Loss", input.shape, _dtype(input),
                       {"epsilon": epsilon}, name)


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", name=name)
    out, act = (helper.create_variable_for_type_inference(
        dtype=_dtype(left), shape=left.shape) for _ in range(2))
    helper.append_op("margin_rank_loss",
                     {"X1": left, "X2": right, "Label": label},
                     {"Out": out, "Activated": act}, {"margin": margin})
    return out


def mse_loss(input, label, name=None):
    return _loss_layer("mse_loss", {"X": input, "Y": label}, "Out", (),
                       _dtype(input), name=name)


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


def kv_cache_write(cache, x, pos, name=None):
    """Per-row KV-cache update ``cache[b, pos[b]] = x[b]``
    (``paddle_tpu/layers/nn.py:1737``; ``core/opimpl/attention_ops.py``).
    ``cache``: [B, C, ...], ``x``: [B, ...], ``pos``: [B] int. Returns the
    updated cache (a new tensor: the input cache is left as it was)."""
    helper = LayerHelper("kv_cache_write", name=name)
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(cache), shape=cache.shape)
    helper.append_op("kv_cache_write",
                     {"Cache": cache, "X": x, "Pos": pos}, {"Out": out}, {})
    return out


def kv_cache_write_chunk(cache, x, pos, name=None):
    """K-row KV-cache update ``cache[b, pos[b, j]] = x[b, j]``
    (``paddle_tpu/layers/nn.py:1794``). ``x``: [B, K, ...], ``pos``: [B, K]
    int; an out-of-range position writes nothing, so a padded chunk lane
    (pos = capacity) is dropped."""
    helper = LayerHelper("kv_cache_write_chunk", name=name)
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(cache), shape=cache.shape)
    helper.append_op("kv_cache_write_chunk",
                     {"Cache": cache, "X": x, "Pos": pos}, {"Out": out}, {})
    return out


def _cached_mha(x, cache_k, cache_v, pos, d_model, n_head, name, layer,
                write, attend):
    """The body both cached attention layers share: ``name.q/.k/.v/.out``
    projections (:func:`multi_head_attention`'s parameters), the K/V rows
    written at each row's ``pos``, attention over the filled prefix."""
    helper = LayerHelper(layer, name=name)
    d_model = d_model or x.shape[-1]
    dtype = _dtype(x)

    def proj(inp, tag, sharding):
        w = helper.create_parameter(
            ParamAttr(name=None if name is None else name + "." + tag,
                      initializer=XavierInitializer(), sharding=sharding),
            shape=[inp.shape[-1], d_model], dtype=dtype)
        out = helper.create_variable_for_type_inference(
            dtype=dtype, shape=tuple(inp.shape[:-1]) + (d_model,))
        helper.append_op("matmul", {"X": inp, "Y": w}, {"Out": out}, {})
        return out

    q = proj(x, "q", (None, "mp"))
    k = proj(x, "k", (None, "mp"))
    v = proj(x, "v", (None, "mp"))
    new_k = write(cache_k, k, pos, name=helper.name + "_kw")
    new_v = write(cache_v, v, pos, name=helper.name + "_vw")
    ctx = helper.create_variable_for_type_inference(
        dtype=dtype, shape=tuple(x.shape[:-1]) + (d_model,))
    helper.append_op(attend,
                     {"Q": q, "CacheK": new_k, "CacheV": new_v, "Pos": pos},
                     {"Out": ctx}, {"num_heads": n_head})
    return proj(ctx, "out", ("mp", None)), new_k, new_v


def cached_multi_head_attention(x, cache_k, cache_v, pos, d_model=None,
                                n_head=1, name=None):
    """One-token incremental attention for KV-cached decode step programs
    (``paddle_tpu/layers/nn.py:1749``), sharing
    :func:`multi_head_attention`'s weights by ``name``: ``x`` [B, d_model],
    caches [B, C, d_model], ``pos`` [B]. Returns ``(out [B, d_model],
    new_cache_k, new_cache_v)``."""
    return _cached_mha(x, cache_k, cache_v, pos, d_model, n_head, name,
                       "cached_multi_head_attention", kv_cache_write,
                       "cached_attention")


def cached_multi_head_attention_chunk(x, cache_k, cache_v, pos,
                                      d_model=None, n_head=1, name=None):
    """K-token incremental attention (chunked prefill, speculative verify;
    ``paddle_tpu/layers/nn.py:1807``): ``x`` [B, K, d_model], ``pos`` [B, K];
    query j of row b attends positions <= pos[b, j]. Returns ``(out [B, K,
    d_model], new_cache_k, new_cache_v)``."""
    return _cached_mha(x, cache_k, cache_v, pos, d_model, n_head, name,
                       "cached_multi_head_attention_chunk",
                       kv_cache_write_chunk, "cached_attention_chunk")


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A global step counter, incremented once per run of the program
    (``paddle_tpu/layers/nn.py:1642``): a persistable int64 [1] var the
    startup program sets to ``begin - step``, so a run's first value is
    ``begin``. Idempotent per program and counter name. The counter lives
    on the device and is written back in place with the other state."""
    helper = LayerHelper("global_step_counter")
    name = counter_name or "@STEP_COUNTER@"
    gb = helper.main_program.global_block()
    if name in gb.vars:
        for op in gb.ops:
            if op.type == "increment" and op.output("Out").name == name:
                return gb.vars[name]
    counter = gb.create_var(
        name=name, shape=(1,), dtype="int64", persistable=True)
    startup_block = helper.startup_program.global_block()
    if not any(op.output("Out") is not None
               and op.output("Out").name == name
               for op in startup_block.ops):
        sp_var = startup_block.create_var(name=name, shape=(1,),
                                          dtype="int64", persistable=True)
        startup_block.append_op(
            "fill_constant", outputs={"Out": sp_var},
            attrs={"shape": (1,), "dtype": "int64", "value": begin - step})
    helper.append_op("increment", {"X": counter}, {"Out": counter},
                     {"step": float(step)})
    return counter


# ---------------------------------------------------------------------------
# GRUs and beam search (paddle_tpu/layers/nn.py:1062-1120, :1529-1575)
# ---------------------------------------------------------------------------

def dynamic_gru(input, size, lengths=None, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", origin_mode=False, h_0=None,
                name=None):
    """GRU over a pre-projected ``[B, T, 3H]`` sequence (``gru_seq``);
    ``size`` is the hidden width H, ``lengths`` [B] the valid steps of
    each row. The activations are the reference's fixed ones."""
    helper = LayerHelper("dynamic_gru", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dtype = _dtype(input)
    w = helper.create_parameter(helper.param_attr, shape=[size, 3 * size],
                                dtype=dtype)
    b = helper.create_parameter(helper.bias_attr, shape=[3 * size],
                                dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(
        dtype=dtype, shape=(input.shape[0], input.shape[1], size))
    inputs = {"Input": input, "Weight": w, "Bias": b}
    if lengths is not None:
        inputs["Lengths"] = lengths
    helper.append_op("gru_seq", inputs, {"Hidden": hidden},
                     {"is_reverse": is_reverse, "origin_mode": origin_mode})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid", origin_mode=False,
             name=None):
    """One GRU step: ``input`` [B, 3H] pre-projected, ``hidden`` [B, H];
    ``size`` is 3H. Returns the new hidden [B, H] only, as the
    reference's composed models use."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    h = size // 3
    dtype = _dtype(input)
    w = helper.create_parameter(helper.param_attr, shape=[h, 3 * h],
                                dtype=dtype)
    b = helper.create_parameter(helper.bias_attr, shape=[3 * h], dtype=dtype,
                                is_bias=True)
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    shape=hidden.shape)
    helper.append_op("gru_unit", {"Input": input, "HiddenPrev": hidden,
                                  "Weight": w, "Bias": b},
                     {"Hidden": out}, {"origin_mode": origin_mode})
    return out


def beam_search(pre_ids, pre_scores, scores, beam_size, end_id,
                return_parent_idx=True, name=None):
    """One pruning step over dense beams: ``pre_ids``/``pre_scores``
    [B, K], ``scores`` [B, K, V] log-probs. Returns (selected_ids,
    selected_scores[, parent_idx]), each [B, K]. Start from pre_scores
    [0, -1e9, ...] so that the K copies of the start beam collapse to
    one."""
    helper = LayerHelper("beam_search", name=name)
    b, k = tuple(pre_ids.shape)[:2]
    sel_ids = helper.create_variable_for_type_inference(
        dtype=_dtype(pre_ids), shape=(b, k))
    sel_scores = helper.create_variable_for_type_inference(
        dtype=_dtype(pre_scores), shape=(b, k))
    parent = helper.create_variable_for_type_inference(dtype="int32",
                                                       shape=(b, k))
    helper.append_op(
        "beam_search_step",
        {"PreIds": pre_ids, "PreScores": pre_scores, "Scores": scores},
        {"SelectedIds": sel_ids, "SelectedScores": sel_scores,
         "ParentIdx": parent},
        {"beam_size": beam_size, "end_id": end_id})
    if return_parent_idx:
        return sel_ids, sel_scores, parent
    return sel_ids, sel_scores


def beam_search_gather(x, parent_idx, name=None):
    """Reorder per-beam state ``x`` [B, K, ...] by ``parent_idx`` [B, K]."""
    helper = LayerHelper("beam_search_gather", name=name)
    out = helper.create_variable_for_type_inference(dtype=_dtype(x),
                                                    shape=x.shape)
    helper.append_op("beam_search_gather", {"X": x, "Ids": parent_idx},
                     {"Out": out}, {})
    return out


def beam_search_decode(ids_array, parents_array, length, final_scores,
                       beam_size, end_id, name=None):
    """Backtrack the per-step (ids, parents) arrays that ``array_write``
    filled in the decode loop into sentences [B, K, T] and their scores
    [B, K]."""
    helper = LayerHelper("beam_search_decode", name=name)
    sent = helper.create_variable_for_type_inference(dtype="int64",
                                                     shape=None)
    sscores = helper.create_variable_for_type_inference(
        dtype=_dtype(final_scores), shape=final_scores.shape)
    helper.append_op(
        "beam_search_decode",
        {"IdsArray": ids_array, "ParentsArray": parents_array,
         "Length": length, "FinalScores": final_scores},
        {"SentenceIds": sent, "SentenceScores": sscores},
        {"beam_size": beam_size, "end_id": end_id})
    return sent, sscores


# ---------------------------------------------------------------------------
# LSTMs and tree conv (paddle_tpu/layers/nn.py:1235-1407, :1477-1526)
# ---------------------------------------------------------------------------

def dynamic_lstm(input, size, lengths=None, h_0=None, c_0=None,
                 param_attr=None, bias_attr=None,
                 use_peepholes=False, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype=None, name=None):
    """LSTM over a pre-projected sequence (ref ``nn.py`` dynamic_lstm).

    ``input`` is ``[B, T, 4H]`` — the x@W projection done by a preceding
    ``fc`` (matching the reference contract where ``size = 4*hidden`` and the
    input projection is the user's fc). ``lengths`` `[B]` masks padding (the
    LoD replacement); ``h_0``/``c_0`` `[B, H]` seed the recurrent state
    (zeros when omitted). Returns ``(hidden [B,T,H], cell [B,T,H])``.
    ``use_peepholes`` is accepted and ignored, as the reference ignores it
    (its bias stays [4H])."""
    helper = LayerHelper("dynamic_lstm", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    hidden_size = size // 4
    dtype = dtype or _dtype(input)
    w = helper.create_parameter(helper.param_attr,
                                shape=[hidden_size, 4 * hidden_size],
                                dtype=dtype)
    b = helper.create_parameter(helper.bias_attr, shape=[4 * hidden_size],
                                dtype=dtype, is_bias=True)
    b_sz, t_sz = input.shape[0], input.shape[1]
    hidden = helper.create_variable_for_type_inference(
        dtype=dtype, shape=(b_sz, t_sz, hidden_size))
    cell = helper.create_variable_for_type_inference(
        dtype=dtype, shape=(b_sz, t_sz, hidden_size))
    inputs = {"Input": input, "Weight": w, "Bias": b}
    if lengths is not None:
        inputs["Lengths"] = lengths
    if h_0 is not None:
        inputs["H0"] = h_0
    if c_0 is not None:
        inputs["C0"] = c_0
    helper.append_op("lstm_seq", inputs, {"Hidden": hidden, "Cell": cell},
                     {"is_reverse": is_reverse})
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, lengths=None, h_0=None, c_0=None,
                  param_attr=None, bias_attr=None, use_peepholes=False,
                  is_reverse=False, gate_activation="sigmoid",
                  cell_activation="tanh", candidate_activation="tanh",
                  proj_activation="tanh", cell_clip=0.0, proj_clip=0.0,
                  dtype=None, name=None):
    """Projection LSTM (ref ``nn.py`` dynamic_lstmp / ``lstmp_op.cc``):
    the recurrent state is the P-dim projection of the hidden state.
    ``input`` is ``[B, T, 4H]`` pre-projected; returns
    ``(projection [B,T,P], cell [B,T,H])``."""
    helper = LayerHelper("dynamic_lstmp", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    hidden_size = size // 4
    dtype = dtype or _dtype(input)
    w = helper.create_parameter(helper.param_attr,
                                shape=[proj_size, 4 * hidden_size],
                                dtype=dtype)
    pattr = ParamAttr._to_attr(param_attr)
    pattr = copy.copy(pattr)
    if pattr.name is not None:
        pattr.name = pattr.name + "_proj"
    wp = helper.create_parameter(pattr, shape=[hidden_size, proj_size],
                                 dtype=dtype)
    b = helper.create_parameter(helper.bias_attr, shape=[4 * hidden_size],
                                dtype=dtype, is_bias=True)
    b_sz, t_sz = input.shape[0], input.shape[1]
    proj = helper.create_variable_for_type_inference(
        dtype=dtype, shape=(b_sz, t_sz, proj_size))
    cell = helper.create_variable_for_type_inference(
        dtype=dtype, shape=(b_sz, t_sz, hidden_size))
    inputs = {"Input": input, "Weight": w, "ProjWeight": wp, "Bias": b}
    if lengths is not None:
        inputs["Lengths"] = lengths
    if h_0 is not None:
        inputs["H0"] = h_0
    if c_0 is not None:
        inputs["C0"] = c_0
    helper.append_op("lstmp_seq", inputs,
                     {"Projection": proj, "Cell": cell},
                     {"is_reverse": is_reverse, "cell_clip": cell_clip,
                      "proj_clip": proj_clip,
                      "proj_activation": proj_activation})
    return proj, cell


def attention_lstm(input, size, lengths=None, h_0=None, c_0=None,
                   param_attr=None, bias_attr=None, name=None):
    """Attention LSTM (ref ``attention_lstm_op.cc``): each step attends
    over the whole sequence with c_{t-1} and feeds the pooled vector to
    an LSTM cell. ``input`` [B, T, M]; returns (hidden [B,T,D], cell)."""
    helper = LayerHelper("attention_lstm", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    d = size
    m = int(input.shape[-1])
    dtype = _dtype(input)
    aw = helper.create_parameter(helper.param_attr, shape=[m + d, 1],
                                 dtype=dtype)
    ab = helper.create_parameter(helper.bias_attr, shape=[1], dtype=dtype,
                                 is_bias=True)
    asc = helper.create_parameter(None, shape=[1], dtype=dtype)
    asb = helper.create_parameter(None, shape=[1], dtype=dtype,
                                  is_bias=True)
    pattr = copy.copy(ParamAttr._to_attr(param_attr))
    if pattr.name is not None:
        pattr.name = pattr.name + "_lstm"
    lw = helper.create_parameter(pattr, shape=[m + d, 4 * d], dtype=dtype)
    lb = helper.create_parameter(None, shape=[4 * d], dtype=dtype,
                                 is_bias=True)
    b_sz, t_sz = input.shape[0], input.shape[1]
    hidden = helper.create_variable_for_type_inference(
        dtype=dtype, shape=(b_sz, t_sz, d))
    cell = helper.create_variable_for_type_inference(
        dtype=dtype, shape=(b_sz, t_sz, d))
    inputs = {"X": input, "AttentionWeight": aw, "AttentionBias": ab,
              "AttentionScalar": asc, "AttentionScalarBias": asb,
              "LSTMWeight": lw, "LSTMBias": lb}
    if lengths is not None:
        inputs["Lengths"] = lengths
    if h_0 is not None:
        inputs["H0"] = h_0
    if c_0 is not None:
        inputs["C0"] = c_0
    helper.append_op("attention_lstm", inputs,
                     {"Hidden": hidden, "Cell": cell}, {})
    return hidden, cell


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1,
              max_depth=2, act="tanh", param_attr=None, bias_attr=None,
              name=None):
    """Tree-based convolution (ref ``nn.py`` tree_conv /
    ``tree_conv_op.cc``, TBCNN): continuous-binary-tree filters over
    subtree patches. Returns [*, N, output_size, num_filters] (batched)
    like the reference's [N, output_size, num_filters]."""
    helper = LayerHelper("tree_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = _dtype(nodes_vector)
    fdim = int(nodes_vector.shape[-1])
    w = helper.create_parameter(
        helper.param_attr, shape=[fdim, 3, output_size, num_filters],
        dtype=dtype)
    lead = tuple(nodes_vector.shape[:-1])
    out = helper.create_variable_for_type_inference(
        dtype=dtype, shape=lead + (output_size, num_filters))
    helper.append_op("tree_conv",
                     {"NodesVector": nodes_vector, "EdgeSet": edge_set,
                      "Filter": w},
                     {"Out": out}, {"max_depth": max_depth})
    if bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr,
                                    shape=[num_filters], dtype=dtype,
                                    is_bias=True)
        biased = helper.create_variable_for_type_inference(
            dtype=dtype, shape=out.shape)
        helper.append_op("elementwise_add", {"X": out, "Y": b},
                         {"Out": biased}, {"axis": -1})
        out = biased
    return helper.append_activation(out)


def lstm(input, init_h=None, init_c=None, max_len=None, hidden_size=None,
         num_layers=1, dropout_prob=0.0, is_bidirec=False, lengths=None,
         is_test=False, name=None, default_initializer=None, seed=-1):
    """Multi-layer (optionally bidirectional) LSTM on ``[B, T, D]`` input
    (ref ``nn.py`` lstm / ``cudnn_lstm_op``). The per-layer input projection
    is an fc over [B*T] rows; the recurrence is ``lstm_seq``.
    ``init_h``/``init_c`` `[B, H]` seed layer 0's forward direction (zeros
    when omitted; deeper layers / the reverse direction always start at
    zero). ``max_len`` is unused (static shapes carry the length).
    Returns ``(out [B,T,H*dirs], last_h, last_c)`` where last_* are
    ``[B, H*dirs]`` of the final layer."""
    from . import tensor as tensor_layers
    from .sequence_lod import sequence_first_step, sequence_last_step

    x = input
    hidden = None
    cell = None
    h_r = c_r = None
    for layer in range(num_layers):
        lname = None if name is None else "%s_l%d" % (name, layer)
        proj = fc(x, size=4 * hidden_size, num_flatten_dims=2,
                  name=None if lname is None else lname + "_proj")
        hidden, cell = dynamic_lstm(proj, 4 * hidden_size, lengths=lengths,
                                    h_0=init_h if layer == 0 else None,
                                    c_0=init_c if layer == 0 else None,
                                    name=lname)
        if is_bidirec:
            proj_r = fc(x, size=4 * hidden_size, num_flatten_dims=2,
                        name=None if lname is None else lname + "_proj_r")
            h_r, c_r = dynamic_lstm(proj_r, 4 * hidden_size, lengths=lengths,
                                    is_reverse=True, name=lname)
            hidden = tensor_layers.concat([hidden, h_r], axis=-1)
        if dropout_prob and layer < num_layers - 1:
            hidden = dropout(hidden, dropout_prob, is_test=is_test)
        x = hidden
    # final states per direction: forward direction ends at t=len-1; the
    # reverse scan's final state sits at original position 0
    fwd_h = sequence_last_step(
        hidden if not is_bidirec else
        tensor_layers.slice(hidden, axes=[2], starts=[0],
                            ends=[hidden_size]), lengths=lengths)
    fwd_c = sequence_last_step(cell, lengths=lengths)
    if is_bidirec:
        last_h = tensor_layers.concat(
            [fwd_h, sequence_first_step(h_r)], axis=-1)
        last_c = tensor_layers.concat(
            [fwd_c, sequence_first_step(c_r)], axis=-1)
    else:
        last_h, last_c = fwd_h, fwd_c
    return hidden, last_h, last_c


# ---------------------------------------------------------------------------
# CTC, CRF, NCE and hierarchical sigmoid (paddle_tpu/layers/nn.py:907-1059)
# ---------------------------------------------------------------------------

def warpctc(input, label, blank=0, norm_by_times=False, input_length=None,
            label_length=None, name=None):
    """CTC loss (ref ``warpctc_op.cc``): padded ``[B, T, C]`` logits
    (softmax applied internally, warp-ctc convention), ``label`` [B, L],
    per-example ``input_length``/``label_length`` [B] (defaulting to the
    padded sizes). Returns [B, 1] negative log likelihood (the alpha
    recursion of ``core/opimpl/loss_ops.py``, no warp-ctc library)."""
    helper = LayerHelper("warpctc", name=name)
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(input), shape=(input.shape[0], 1))
    inputs = {"Logits": input, "Label": label}
    if input_length is not None:
        inputs["LogitsLength"] = input_length
    if label_length is not None:
        inputs["LabelLength"] = label_length
    helper.append_op("warpctc", inputs, {"Loss": out},
                     {"blank": blank, "norm_by_times": norm_by_times})
    return out


def linear_chain_crf(input, label, param_attr=None, length=None, name=None):
    """Linear-chain CRF negative log likelihood (ref
    ``linear_chain_crf_op.cc``): ``input`` [B, T, D] emissions, ``label``
    [B, T]; creates the [D+2, D] transition parameter (row 0 start, row 1
    end, rows 2.. pairwise). Returns [B, 1] cost to minimize."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr,
                         name=name)
    size = input.shape[-1]
    transition = helper.create_parameter(
        helper.param_attr, shape=[size + 2, size], dtype=_dtype(input))
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(input), shape=(input.shape[0], 1))
    inputs = {"Emission": input, "Transition": transition, "Label": label}
    if length is not None:
        inputs["Length"] = length
    helper.append_op("linear_chain_crf", inputs,
                     {"LogLikelihood": out}, {})
    return out


def crf_decoding(input, param_attr, label=None, length=None, name=None):
    """Viterbi decode with the CRF's transition parameter (ref
    ``crf_decoding_op.cc``); pass the same ``param_attr`` name used by
    ``linear_chain_crf``. With ``label`` given, returns the per-position
    correctness mask instead of the path (reference semantics)."""
    helper = LayerHelper("crf_decoding", param_attr=param_attr, name=name)
    size = input.shape[-1]
    from ..core import framework as _fw
    attr = ParamAttr._to_attr(param_attr)
    gb = _fw.default_main_program().global_block()
    if attr.name and gb.has_var(attr.name):
        # reuse the trained transition var in-program (no duplicate init)
        transition = gb.var(attr.name)
    else:
        # separate infer program: create under the shared name; values come
        # from the scope at run time
        transition = helper.create_parameter(
            helper.param_attr, shape=[size + 2, size], dtype=_dtype(input))
    out = helper.create_variable_for_type_inference(
        dtype="int32", shape=tuple(input.shape[:2]))
    inputs = {"Emission": input, "Transition": transition}
    if label is not None:
        inputs["Label"] = label
    if length is not None:
        inputs["Length"] = length
    helper.append_op("crf_decoding", inputs, {"ViterbiPath": out}, {})
    return out


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, name=None, sampler="uniform",
        custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation loss (ref ``nce_op.cc``): ``input``
    [B, D], ``label`` [B, 1]; samples ``num_neg_samples`` noise classes per
    example (uniform or log_uniform). ``seed`` != 0 fixes the sample draw
    (every run takes the same negatives); 0 draws them from the executor's
    generator each run."""
    if custom_dist is not None or sample_weight is not None:
        raise NotImplementedError(
            "nce custom_dist/sample_weight are not supported; use "
            "sampler='uniform' or 'log_uniform'")
    if sampler not in ("uniform", "log_uniform"):
        raise ValueError("unsupported nce sampler %r" % (sampler,))
    helper = LayerHelper("nce", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(helper.param_attr,
                                shape=[num_total_classes, dim],
                                dtype=_dtype(input))
    b = helper.create_parameter(helper.bias_attr,
                                shape=[num_total_classes],
                                dtype=_dtype(input), is_bias=True)
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(input), shape=(input.shape[0], 1))
    helper.append_op(
        "nce", {"Input": input, "Label": label, "Weight": w, "Bias": b},
        {"Cost": out},
        {"num_neg_samples": num_neg_samples or 10, "sampler": sampler,
         "seed": seed})
    return out


def _hsigmoid_simple_code_tables(num_classes):
    """Default complete-binary-tree paths (ref ``math/matrix_bit_code.h``
    SimpleCode): class c maps to code c + num_classes; node index at bit i
    is (code >> (i+1)) - 1, bit value (code >> i) & 1."""
    rows = []
    for c in range(num_classes):
        code = c + num_classes
        length = code.bit_length() - 1
        rows.append(([(code >> (i + 1)) - 1 for i in range(length)],
                     [(code >> i) & 1 for i in range(length)]))
    max_len = max(len(r[0]) for r in rows)
    table = [r[0] + [-1] * (max_len - len(r[0])) for r in rows]
    codes = [[float(v) for v in r[1]] + [0.0] * (max_len - len(r[1]))
             for r in rows]
    return table, codes


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None, is_custom=False,
             is_sparse=False):
    """Hierarchical sigmoid (ref ``hierarchical_sigmoid_op.cc``): log-time
    softmax over a class tree. Default: complete binary tree with
    ``num_classes - 1`` internal nodes; custom: ``path_table``/``path_code``
    vars [B, L] (pad with -1)."""
    helper = LayerHelper("hsigmoid", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dim = input.shape[-1]
    n_nodes = num_classes if is_custom else num_classes - 1
    w = helper.create_parameter(helper.param_attr, shape=[n_nodes, dim],
                                dtype=_dtype(input))
    b = helper.create_parameter(helper.bias_attr, shape=[n_nodes],
                                dtype=_dtype(input), is_bias=True)
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(input), shape=(input.shape[0], 1))
    inputs = {"Input": input, "Label": label, "W": w, "Bias": b}
    attrs = {"num_classes": num_classes}
    if is_custom:
        inputs["PathTable"] = path_table
        inputs["PathCode"] = path_code
    else:
        table, codes = _hsigmoid_simple_code_tables(num_classes)
        attrs["path_table"] = table
        attrs["path_code"] = codes
    helper.append_op("hsigmoid", inputs, {"Cost": out}, attrs)
    return out


def lod_reset(x, y=None, target_lod=None):
    """The identity: sequence lengths travel as explicit tensors."""
    return x


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", actual_shape=None, align_corners=True,
                 align_mode=1):
    helper = LayerHelper("image_resize", name=name)
    n, c, h, w = input.shape
    if out_shape is not None:
        oh, ow = out_shape
    else:
        oh, ow = int(h * scale), int(w * scale)
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(input), shape=(n, c, oh, ow))
    op_type = "bilinear_interp" if resample.upper() == "BILINEAR" \
        else "nearest_interp"
    helper.append_op(op_type, {"X": input}, {"Out": out},
                     {"out_h": oh, "out_w": ow,
                      "align_corners": align_corners})
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    actual_shape=None, align_corners=True, align_mode=1):
    return image_resize(input, out_shape, scale, name, "BILINEAR",
                        actual_shape, align_corners, align_mode)


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   actual_shape=None, align_corners=True):
    return image_resize(input, out_shape, scale, name, "NEAREST",
                        actual_shape, align_corners)


def grid_sampler(x, grid, name=None):
    helper = LayerHelper("grid_sampler", name=name)
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(x), shape=(x.shape[0], x.shape[1], grid.shape[1],
                                grid.shape[2]))
    helper.append_op("grid_sampler", {"X": x, "Grid": grid},
                     {"Output": out}, {})
    return out


def pixel_shuffle(x, upscale_factor, name=None):
    helper = LayerHelper("pixel_shuffle", name=name)
    n, c, h, w = x.shape
    r = upscale_factor
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(x), shape=(n, c // (r * r), h * r, w * r))
    helper.append_op("pixel_shuffle", {"X": x}, {"Out": out},
                     {"upscale_factor": r})
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0,
                input_image_size=None, out_stride=1, name=None):
    helper = LayerHelper("im2sequence", name=name)
    k, s = _pair(filter_size), _pair(stride)
    p = padding if isinstance(padding, (list, tuple)) else [padding] * 4
    n, c, h, w = input.shape
    oh = (h + p[0] + p[2] - k[0]) // s[0] + 1 if h > 0 else -1
    ow = (w + p[1] + p[3] - k[1]) // s[1] + 1 if w > 0 else -1
    rows = n * oh * ow if n > 0 and oh > 0 and ow > 0 else -1
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(input), shape=(rows, c * k[0] * k[1]))
    helper.append_op("im2sequence", {"X": input}, {"Out": out},
                     {"kernels": list(k), "strides": list(s),
                      "paddings": list(p)})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None,
             name=None):
    """Lookahead conv (ref ``row_conv_op``): a ``sequence_conv`` with
    context [0, future_context_size]."""
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act,
                         name=name)
    d = input.shape[-1]
    ctx = future_context_size + 1
    w = helper.create_parameter(helper.param_attr, shape=[ctx * d, d],
                                dtype=_dtype(input))
    out = helper.create_variable_for_type_inference(dtype=_dtype(input),
                                                    shape=input.shape)
    helper.append_op("sequence_conv", {"X": input, "Filter": w},
                     {"Out": out},
                     {"contextLength": ctx, "contextStart": 0})
    return helper.append_activation(out)


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """softmax(q k^T / sqrt(d)) v over ``num_heads`` heads, one
    ``flash_attention`` op: the port's flash kernels on the card."""
    helper = LayerHelper("scaled_dot_product_attention")
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(queries), shape=queries.shape)
    helper.append_op(
        "flash_attention", {"Q": queries, "K": keys, "V": values},
        {"Out": out},
        {"num_heads": num_heads, "dropout_rate": dropout_rate,
         "causal": False})
    return out
