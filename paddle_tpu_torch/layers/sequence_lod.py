"""Sequence layers over padded batches with explicit lengths (the port's
``paddle_tpu/layers/sequence_lod.py``; ref ``python/paddle/fluid/layers/
nn.py``'s sequence_* members): LoD is replaced by Length tensors, as
``core/opimpl/sequence_ops.py`` says. Each layer appends the ops and
creates the parameters ``paddle_tpu``'s does, under the same names."""

from ..core.layer_helper import LayerHelper
from ..core.initializer import XavierInitializer

__all__ = [
    "sequence_conv", "sequence_pool", "sequence_softmax", "sequence_reverse",
    "sequence_expand", "sequence_concat", "sequence_slice", "sequence_pad",
    "sequence_unpad", "sequence_mask", "sequence_enumerate", "sequence_erase",
    "sequence_first_step", "sequence_last_step",
]


def _dt(x):
    return str(x.dtype)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None, lengths=None):
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    d = input.shape[-1]
    w = helper.create_parameter(
        helper.param_attr, shape=[filter_size * d, num_filters],
        dtype=_dt(input), default_initializer=XavierInitializer())
    out = helper.create_variable_for_type_inference(
        dtype=_dt(input), shape=tuple(input.shape[:-1]) + (num_filters,))
    helper.append_op("sequence_conv", {"X": input, "Filter": w},
                     {"Out": out},
                     {"contextLength": filter_size,
                      "contextStart": -((filter_size - 1) // 2)})
    pre_act = helper.append_bias_op(out)
    return helper.append_activation(pre_act)


def sequence_pool(input, pool_type, lengths=None, is_test=False):
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(
        dtype=_dt(input), shape=(input.shape[0],) + tuple(input.shape[2:]))
    inputs = {"X": input}
    if lengths is not None:
        inputs["Lengths"] = lengths
    helper.append_op("sequence_pool", inputs, {"Out": out},
                     {"pooltype": pool_type.upper()})
    return out


def sequence_first_step(input, lengths=None):
    return sequence_pool(input, "first", lengths)


def sequence_last_step(input, lengths=None):
    return sequence_pool(input, "last", lengths)


def sequence_softmax(input, lengths=None, use_cudnn=False, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_variable_for_type_inference(dtype=_dt(input),
                                                    shape=input.shape)
    inputs = {"X": input}
    if lengths is not None:
        inputs["Lengths"] = lengths
    helper.append_op("sequence_softmax", inputs, {"Out": out}, {})
    return out


def sequence_reverse(x, lengths=None, name=None):
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_variable_for_type_inference(dtype=_dt(x),
                                                    shape=x.shape)
    inputs = {"X": x}
    if lengths is not None:
        inputs["Lengths"] = lengths
    helper.append_op("sequence_reverse", inputs, {"Y": out}, {})
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_variable_for_type_inference(
        dtype=_dt(x), shape=(x.shape[0], y.shape[1]) + tuple(x.shape[1:]))
    helper.append_op("sequence_expand", {"X": x, "Y": y}, {"Out": out}, {})
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", name=name)
    t = sum(x.shape[1] for x in input)
    out = helper.create_variable_for_type_inference(
        dtype=_dt(input[0]), shape=(input[0].shape[0], t) + tuple(input[0].shape[2:]))
    helper.append_op("sequence_concat", {"X": list(input)}, {"Out": out}, {})
    return out


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", name=name)
    out = helper.create_variable_for_type_inference(
        dtype=_dt(input),
        shape=(input.shape[0], length) + tuple(input.shape[2:]))
    helper.append_op("sequence_slice", {"X": input, "Offset": offset},
                     {"Out": out}, {"length": length})
    return out


def sequence_pad(x, pad_value=None, maxlen=None, lengths=None, name=None):
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_variable_for_type_inference(dtype=_dt(x),
                                                    shape=x.shape)
    length = helper.create_variable_for_type_inference(dtype="int64",
                                                       shape=(x.shape[0],))
    inputs = {"X": x}
    if lengths is not None:
        inputs["Lengths"] = lengths
    helper.append_op("sequence_pad", inputs,
                     {"Out": out, "Length": length}, {})
    return out, length


def sequence_unpad(x, length=None, name=None):
    helper = LayerHelper("sequence_unpad", name=name)
    out = helper.create_variable_for_type_inference(dtype=_dt(x),
                                                    shape=x.shape)
    helper.append_op("sequence_unpad", {"X": x}, {"Out": out}, {})
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    n = x.shape[0] if x.shape else -1
    out = helper.create_variable_for_type_inference(
        dtype=dtype, shape=(n, maxlen if maxlen else -1))
    helper.append_op("sequence_mask", {"X": x}, {"Y": out},
                     {"maxlen": maxlen or -1, "out_dtype": dtype})
    return out


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    helper = LayerHelper("sequence_enumerate", name=name)
    out = helper.create_variable_for_type_inference(
        dtype="int64", shape=tuple(input.shape) + (win_size,))
    helper.append_op("sequence_enumerate", {"X": input}, {"Out": out},
                     {"win_size": win_size, "pad_value": pad_value})
    return out


def sequence_erase(input, tokens, name=None):
    helper = LayerHelper("sequence_erase", name=name)
    out = helper.create_variable_for_type_inference(dtype=_dt(input),
                                                    shape=input.shape)
    helper.append_op("sequence_erase", {"X": input}, {"Out": out},
                     {"tokens": list(tokens)})
    return out
