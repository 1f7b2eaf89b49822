"""Layer wrappers for the long-tail ops (the port's
``paddle_tpu/layers/extras.py``; ref the corresponding entries in
``python/paddle/fluid/layers/nn.py`` and ``layers/detection.py``): the
losses and metrics, the image and tensor ops, the sequence utilities,
``chunk_eval``, ``ctc_greedy_decoder``, ``psroi_pool`` and
``detection_map``, with the reference's signatures."""

from ..core.layer_helper import LayerHelper

__all__ = [
    "rank_loss", "mean_iou", "multiplex", "affine_channel", "affine_grid",
    "space_to_depth", "shuffle_channel", "crop", "pad_constant_like",
    "similarity_focus", "hash", "selu", "add_position_encoding",
    "bilinear_tensor_product", "edit_distance", "spectral_norm",
    "modified_huber_loss", "teacher_student_sigmoid_loss",
    "squared_l2_distance", "unpool", "max_pool2d_with_index", "psroi_pool",
    "spp", "sequence_expand_as", "sequence_reshape", "sequence_scatter",
    "random_crop", "chunk_eval", "ctc_greedy_decoder",
    "detection_map",
]


def _dtype(x):
    return str(x.dtype)


def _one_out(op_type, inputs, attrs=None, dtype=None, shape=None,
             out_slot="Out", name=None):
    helper = LayerHelper(op_type, name=name)
    first = next(v for v in inputs.values()
                 if v is not None and not isinstance(v, (list, tuple)))
    out = helper.create_variable_for_type_inference(
        dtype=dtype or _dtype(first), shape=shape)
    helper.append_op(op_type, inputs, {out_slot: out}, attrs or {})
    return out


def rank_loss(label, left, right, name=None):
    return _one_out("rank_loss",
                    {"Label": label, "Left": left, "Right": right},
                    name=name)


def modified_huber_loss(input, label):
    return _one_out("modified_huber_loss", {"X": input, "Y": label})


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    return _one_out("teacher_student_sigmoid_loss",
                    {"X": input, "Label": label},
                    {"soft_max_up_bound": soft_max_up_bound,
                     "soft_max_lower_bound": soft_max_lower_bound},
                    out_slot="Y")


def squared_l2_distance(x, y):
    helper = LayerHelper("squared_l2_distance")
    sub = helper.create_variable_for_type_inference(dtype=_dtype(x))
    out = helper.create_variable_for_type_inference(dtype=_dtype(x))
    helper.append_op("squared_l2_distance", {"X": x, "Y": y},
                     {"sub_result": sub, "Out": out})
    return out


def mean_iou(input, label, num_classes):
    helper = LayerHelper("mean_iou")
    miou = helper.create_variable_for_type_inference(dtype="float32",
                                                     shape=())
    wrong = helper.create_variable_for_type_inference(dtype="int32",
                                                      shape=(num_classes,))
    correct = helper.create_variable_for_type_inference(
        dtype="int32", shape=(num_classes,))
    helper.append_op("mean_iou", {"Predictions": input, "Labels": label},
                     {"OutMeanIou": miou, "OutWrong": wrong,
                      "OutCorrect": correct},
                     {"num_classes": num_classes})
    return miou, wrong, correct


def multiplex(inputs, index):
    return _one_out("multiplex", {"Ids": index, "X": list(inputs)},
                    dtype=_dtype(inputs[0]))


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None):
    return _one_out("affine_channel",
                    {"X": x, "Scale": scale, "Bias": bias}, name=name)


def affine_grid(theta, out_shape, name=None):
    return _one_out("affine_grid", {"Theta": theta},
                    {"output_shape": list(out_shape)},
                    out_slot="Output", name=name)


def space_to_depth(x, blocksize, name=None):
    n, c, h, w = x.shape
    return _one_out("space_to_depth", {"X": x}, {"blocksize": blocksize},
                    shape=(n, c * blocksize * blocksize,
                           (h // blocksize) if h and h > 0 else -1,
                           (w // blocksize) if w and w > 0 else -1),
                    name=name)


def shuffle_channel(x, group, name=None):
    return _one_out("shuffle_channel", {"X": x}, {"group": group},
                    shape=tuple(x.shape), name=name)


def crop(x, shape=None, offsets=None, name=None):
    return _one_out("crop", {"X": x},
                    {"shape": list(shape), "offsets": list(offsets or
                                                           [0] * len(shape))},
                    shape=tuple(shape), name=name)


def pad_constant_like(x, y, pad_value=0.0, name=None):
    return _one_out("pad_constant_like", {"X": x, "Y": y},
                    {"pad_value": pad_value}, shape=tuple(x.shape),
                    dtype=_dtype(y), name=name)


def similarity_focus(input, axis, indexes, name=None):
    return _one_out("similarity_focus", {"X": input},
                    {"axis": axis, "indexes": list(indexes)}, name=name)


def hash(input, hash_size, num_hash=1, name=None):
    return _one_out("hash", {"X": input},
                    {"mod_by": hash_size, "num_hash": num_hash},
                    dtype="int32", name=name)


def selu(x, scale=None, alpha=None, name=None):
    attrs = {}
    if scale is not None:
        attrs["scale"] = scale
    if alpha is not None:
        attrs["alpha"] = alpha
    return _one_out("selu", {"X": x}, attrs, name=name)


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    return _one_out("add_position_encoding", {"X": input},
                    {"alpha": alpha, "beta": beta},
                    shape=tuple(input.shape), name=name)


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    helper = LayerHelper("bilinear_tensor_product", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    w = helper.create_parameter(
        helper.param_attr, shape=[size, x.shape[-1], y.shape[-1]],
        dtype=_dtype(x))
    inputs = {"X": x, "Y": y, "Weight": w}
    if bias_attr is not False:
        bias = helper.create_parameter(
            helper.bias_attr, shape=[size], dtype=_dtype(x), is_bias=True)
        inputs["Bias"] = bias
    out = helper.create_variable_for_type_inference(dtype=_dtype(x))
    helper.append_op("bilinear_tensor_product", inputs, {"Out": out})
    if act:
        act_out = helper.create_variable_for_type_inference(
            dtype=_dtype(x))
        helper.append_op(act, {"X": out}, {"Out": act_out}, {})
        return act_out
    return out


def edit_distance(input, label, normalized=True, input_length=None,
                  label_length=None, name=None):
    helper = LayerHelper("edit_distance", name=name)
    out = helper.create_variable_for_type_inference(dtype="float32")
    seq_num = helper.create_variable_for_type_inference(dtype="int32",
                                                        shape=())
    helper.append_op(
        "edit_distance",
        {"Hyps": input, "Refs": label, "HypsLength": input_length,
         "RefsLength": label_length},
        {"Out": out, "SequenceNum": seq_num},
        {"normalized": normalized})
    return out, seq_num


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    helper = LayerHelper("spectral_norm", name=name)
    h = weight.shape[dim]
    w = 1
    for i, s in enumerate(weight.shape):
        if i != dim:
            w *= s
    u = helper.create_parameter(None, shape=[h], dtype=_dtype(weight))
    v = helper.create_parameter(None, shape=[w], dtype=_dtype(weight))
    u.stop_gradient = True
    v.stop_gradient = True
    out = helper.create_variable_for_type_inference(
        dtype=_dtype(weight), shape=tuple(weight.shape))
    helper.append_op("spectral_norm",
                     {"Weight": weight, "U": u, "V": v}, {"Out": out},
                     {"dim": dim, "power_iters": power_iters, "eps": eps})
    return out


def max_pool2d_with_index(x, ksize, strides=None, paddings=(0, 0),
                          global_pooling=False, name=None):
    helper = LayerHelper("max_pool2d_with_index", name=name)
    out = helper.create_variable_for_type_inference(dtype=_dtype(x))
    mask = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op("pool_with_index", {"X": x},
                     {"Out": out, "Mask": mask},
                     {"ksize": list(ksize),
                      "strides": list(strides or ksize),
                      "paddings": list(paddings),
                      "global_pooling": global_pooling})
    return out, mask


def unpool(x, indices, unpooled_height, unpooled_width, name=None):
    return _one_out("unpool", {"X": x, "Indices": indices},
                    {"unpooled_height": unpooled_height,
                     "unpooled_width": unpooled_width}, name=name)


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, name=None):
    return _one_out("psroi_pool", {"X": input, "ROIs": rois},
                    {"output_channels": output_channels,
                     "spatial_scale": spatial_scale,
                     "pooled_height": pooled_height,
                     "pooled_width": pooled_width}, name=name)


def spp(input, pyramid_height, pool_type="max", name=None):
    return _one_out("spp", {"X": input},
                    {"pyramid_height": pyramid_height,
                     "pooling_type": pool_type}, name=name)


def sequence_expand_as(x, y_length, maxlen, name=None):
    return _one_out("sequence_expand_as", {"X": x, "YLength": y_length},
                    {"maxlen": maxlen}, name=name)


def sequence_reshape(input, new_dim, name=None):
    return _one_out("sequence_reshape", {"X": input}, {"new_dim": new_dim},
                    name=name)


def sequence_scatter(input, index, updates, mask=None, name=None):
    return _one_out("sequence_scatter",
                    {"X": input, "Ids": index, "Updates": updates,
                     "Mask": mask}, name=name)


def random_crop(x, shape, seed=None, name=None):
    attrs = {"shape": list(shape)}
    if seed is not None:
        attrs["seed"] = int(seed)
    return _one_out("random_crop", {"X": x}, attrs, name=name)


def chunk_eval(input, label, chunk_scheme, num_chunk_types, seq_length,
               excluded_chunk_types=None):
    """Chunk metrics (ref ``layers/nn.py`` chunk_eval): plain / IOB /
    IOE / IOBES schemes, optional ``excluded_chunk_types``."""
    if chunk_scheme not in ("plain", "IOB", "IOE", "IOBES"):
        raise ValueError("chunk_eval: unknown scheme %r" % chunk_scheme)
    helper = LayerHelper("chunk_eval")
    outs = {}
    for n, dt in (("Precision", "float32"), ("Recall", "float32"),
                  ("F1-Score", "float32"), ("NumInferChunks", "int32"),
                  ("NumLabelChunks", "int32"),
                  ("NumCorrectChunks", "int32")):
        outs[n] = helper.create_variable_for_type_inference(dtype=dt,
                                                            shape=())
    helper.append_op("chunk_eval",
                     {"Inference": input, "Label": label,
                      "SeqLength": seq_length},
                     outs, {"num_chunk_types": num_chunk_types,
                            "chunk_scheme": chunk_scheme,
                            "excluded_chunk_types":
                                list(excluded_chunk_types or ())})
    return (outs["Precision"], outs["Recall"], outs["F1-Score"],
            outs["NumInferChunks"], outs["NumLabelChunks"],
            outs["NumCorrectChunks"])


def ctc_greedy_decoder(input, blank, input_length=None, padding_value=0,
                       name=None):
    """Greedy CTC decode: argmax over classes then ``ctc_align`` merge/
    de-blank (ref ``layers/nn.py`` ctc_greedy_decoder over LoD; padded
    re-design returns ([B, T] ids front-compacted, [B] lengths)."""
    from . import nn

    helper = LayerHelper("ctc_greedy_decoder", name=name)
    ids = nn.argmax(input, axis=-1)
    out = helper.create_variable_for_type_inference(dtype="int32")
    out_len = helper.create_variable_for_type_inference(dtype="int32")
    inputs = {"Input": ids}
    if input_length is not None:
        inputs["InputLength"] = input_length
    helper.append_op("ctc_align", inputs,
                     {"Output": out, "OutputLength": out_len},
                     {"blank": blank, "padding_value": padding_value})
    return out, out_len


def detection_map(detect_res, gt_label, gt_box, class_num,
                  background_label=0, overlap_threshold=0.5,
                  ap_version="integral", name=None):
    helper = LayerHelper("detection_map", name=name)
    out = helper.create_variable_for_type_inference(dtype="float32",
                                                    shape=())
    helper.append_op("detection_map",
                     {"DetectRes": detect_res, "GtLabel": gt_label,
                      "GtBox": gt_box},
                     {"MAP": out},
                     {"class_num": class_num, "ap_type": ap_version,
                      "overlap_threshold": overlap_threshold,
                      "background_label": background_label})
    return out
