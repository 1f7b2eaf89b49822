"""Convolution / pooling / normalization / dropout / softmax / loss ops
(the subset of ``paddle_tpu/core/opimpl/nn_ops.py`` the served and trained
models run). ``layer_norm`` over the last axis, ``fused_linear_smooth_ce``
and ``fused_conv2d`` call the port's hand-written kernels on CUDA
(``paddle_tpu_torch/ops``). Plain ``conv2d`` is ``F.conv2d`` (cuDNN on the
card), as ``paddle_tpu`` leaves it to ``lax.conv_general_dilated``."""

import torch
import torch.nn.functional as F

from ..op_registry import register, get, put, next_rng, run_op


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


@register("conv2d")
def _conv2d(env, op):
    x = get(env, op.input("Input"))  # NCHW
    w = get(env, op.input("Filter"))  # OIHW
    put(env, op.output("Output"), F.conv2d(
        x, w, stride=_pair(op.attr("strides", [1, 1])),
        padding=_pair(op.attr("paddings", [0, 0])),
        dilation=_pair(op.attr("dilations", [1, 1])),
        groups=op.attr("groups", 1)))


@register("pool2d")
def _pool2d(env, op):
    """Max and average pooling with ``paddle_tpu``'s padding semantics
    (``nn_ops.py:112-162``): max pads with -inf; an exclusive average over a
    padded (or ceil-mode) window divides by the count of real inputs."""
    x = get(env, op.input("X"))  # NCHW
    ptype = op.attr("pooling_type", "max")
    ksize = _pair(op.attr("ksize"))
    strides = _pair(op.attr("strides", [1, 1]))
    pads = _pair(op.attr("paddings", [0, 0]))
    ceil_mode = op.attr("ceil_mode", False)
    if op.attr("global_pooling", False):
        out = x.amax(dim=(2, 3), keepdim=True) if ptype == "max" \
            else x.mean(dim=(2, 3), keepdim=True)
        put(env, op.output("Out"), out)
        return
    if ptype == "max":
        put(env, op.output("Out"), F.max_pool2d(
            x, ksize, strides, pads, ceil_mode=ceil_mode))
        return
    # average: sum over windows of the zero-padded input (padded on the
    # high side too in ceil mode, as the reference pads)
    hi = [0, 0]
    if ceil_mode:
        for i in range(2):
            size = x.shape[2 + i] + 2 * pads[i]
            out_i = -(-(size - ksize[i]) // strides[i]) + 1
            hi[i] = max(0, (out_i - 1) * strides[i] + ksize[i] - size)
    cfg = (pads[1], pads[1] + hi[1], pads[0], pads[0] + hi[0])
    area = float(ksize[0] * ksize[1])
    s = F.avg_pool2d(F.pad(x, cfg), ksize, strides) * area
    if op.attr("exclusive", True) and (pads != (0, 0) or ceil_mode):
        ones = F.pad(torch.ones_like(x[:1, :1]), cfg)
        s = s / (F.avg_pool2d(ones, ksize, strides) * area)
    else:
        s = s / area
    put(env, op.output("Out"), s)


@register("fused_conv2d")
def _fused_conv2d(env, op):
    """conv2d + batch_norm (+residual add)(+relu) as ONE op, produced by the
    epilogue-fusion rewrite (``core/epilogue_fusion.py``). An admitted
    geometry runs the fused kernels on CUDA (``ops/fused_conv.py``) and
    their plain versions on the CPU; a declined one replays the absorbed
    original ops verbatim on either device (``paddle_tpu``'s
    ``nn_ops.py:265-325``)."""
    from ...ops import fused_conv
    from ..framework import Operator

    is_test = op.attr("is_test", False)
    x = get(env, op.input("Input"))  # NCHW
    w = get(env, op.input("Filter"))  # OIHW
    strides = _pair(op.attr("strides", [1, 1]))
    pads = _pair(op.attr("paddings", [0, 0]))
    res_var = op.input("Residual")
    residual = get(env, res_var) if res_var is not None else None

    choice = fused_conv.gate(
        x.shape, w.shape, strides, pads,
        _pair(op.attr("dilations", [1, 1])), op.attr("groups", 1) or 1, x=x)
    # which kernel this op takes, and why a refusal replays the originals
    op.attrs["_kernel_choice"] = choice
    if not choice["admitted"]:
        for sub in op.attr("orig_ops") or ():
            if is_test and not sub.attr("is_test", False) \
                    and sub.type in ("batch_norm", "dropout"):
                # a for_test clone flips is_test on the FUSED op only
                sub = Operator(sub.block, sub.type, dict(sub.inputs),
                               dict(sub.outputs),
                               {**sub.attrs, "is_test": True})
            run_op(env, sub)
        return

    y, mean_out, var_out, saved_mean, saved_var = \
        fused_conv.fused_conv_bn_act(
            x, w, get(env, op.input("Scale")), get(env, op.input("Bias")),
            get(env, op.input("Mean")), get(env, op.input("Variance")),
            strides=strides, paddings=pads, eps=op.attr("epsilon", 1e-5),
            momentum=op.attr("momentum", 0.9), act=op.attr("act"),
            residual=residual, is_test=is_test,
            use_global_stats=op.attr("use_global_stats", False))
    put(env, op.output("Y"), y)
    put(env, op.output("MeanOut"), mean_out)
    put(env, op.output("VarianceOut"), var_out)
    if saved_mean is not None:
        put(env, op.output("SavedMean"), saved_mean)
        put(env, op.output("SavedVariance"), saved_var)


@register("batch_norm")
def _batch_norm(env, op):
    """Paddle's batch norm (``paddle_tpu``'s ``nn_ops.py:330-389``), not
    torch's: one-pass f32 statistics max(E[x^2] - E[x]^2, 0), the biased
    batch variance in the moving variance, and ``MeanOut = momentum * mean
    + (1 - momentum) * batch_mean`` (momentum 0.9). ``MeanOut`` and
    ``VarianceOut`` alias the moving-stat vars. Test: moving stats."""
    x = get(env, op.input("X"))
    scale = get(env, op.input("Scale"))
    bias = get(env, op.input("Bias"))
    mean = get(env, op.input("Mean"))
    var = get(env, op.input("Variance"))
    eps = op.attr("epsilon", 1e-5)
    momentum = op.attr("momentum", 0.9)
    ch = 1 if op.attr("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != ch)
    c_shape = [1] * x.dim()
    c_shape[ch] = -1
    in_dtype = x.dtype
    x = x.float()
    if op.attr("is_test", False) or op.attr("use_global_stats", False):
        use_mean, use_var = mean, var
        put(env, op.output("MeanOut"), mean)
        put(env, op.output("VarianceOut"), var)
    else:
        n = 1
        for i in axes:
            n *= x.shape[i]
        use_mean = x.sum(dim=axes) / n
        use_var = torch.clamp_min((x * x).sum(dim=axes) / n
                                  - use_mean * use_mean, 0.0)
        bm, bv = use_mean.detach(), use_var.detach()
        put(env, op.output("MeanOut"), momentum * mean + (1 - momentum) * bm)
        put(env, op.output("VarianceOut"),
            momentum * var + (1 - momentum) * bv)
        put(env, op.output("SavedMean"), bm)
        put(env, op.output("SavedVariance"), bv)
    inv = torch.rsqrt(use_var.reshape(c_shape) + eps)
    y = (x - use_mean.reshape(c_shape)) * inv * scale.reshape(c_shape) \
        + bias.reshape(c_shape)
    put(env, op.output("Y"), y.to(in_dtype))


@register("layer_norm")
def _layer_norm(env, op):
    x = get(env, op.input("X"))
    scale = get(env, op.input("Scale"))
    bias = get(env, op.input("Bias"))
    eps = op.attr("epsilon", 1e-5)
    begin = op.attr("begin_norm_axis", 1)
    if begin == x.dim() - 1:
        # every last-axis normalization takes the hand-written kernel on
        # CUDA (its plain version on the CPU): paddle_tpu's opt-in gate
        # (fused_layer_norm.py:27-39) was a TPU measurement
        from ...ops.fused_layer_norm import fused_layer_norm

        y, mean, var = fused_layer_norm(x, scale, bias, eps)
        put(env, op.output("Y"), y)
        put(env, op.output("Mean"), mean)
        put(env, op.output("Variance"), var)
        return
    # other axes: the composed form, stats in f32 (nn_ops.py:410-425)
    axes = tuple(range(begin, x.dim()))
    in_dtype = x.dtype
    x = x.float() if x.dtype == torch.bfloat16 else x
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, unbiased=False, keepdim=True)
    norm = (x - mean) * torch.rsqrt(var + eps)
    bshape = [1] * begin + list(x.shape[begin:])
    if scale is not None:
        norm = norm * scale.reshape(bshape)
    if bias is not None:
        norm = norm + bias.reshape(bshape)
    put(env, op.output("Y"), norm.to(in_dtype))
    put(env, op.output("Mean"), mean.reshape(mean.shape[:begin]))
    put(env, op.output("Variance"), var.reshape(var.shape[:begin]))


@register("dropout")
def _dropout(env, op):
    x = get(env, op.input("X"))
    p = op.attr("dropout_prob", 0.5)
    impl = op.attr("dropout_implementation", "downgrade_in_infer")
    if op.attr("is_test", False):
        put(env, op.output("Out"),
            x * (1.0 - p) if impl == "downgrade_in_infer" else x)
        return
    keep = torch.rand(x.shape, generator=next_rng(env),
                      device=x.device) < (1.0 - p)
    mask = keep.to(x.dtype)
    if impl == "upscale_in_train":
        out = torch.zeros_like(x) if p >= 1.0 else x * mask / (1.0 - p)
    else:
        out = x * mask
    put(env, op.output("Out"), out)
    put(env, op.output("Mask"), mask)


@register("softmax")
def _softmax(env, op):
    x = get(env, op.input("X"))
    out = torch.softmax(x.float(), dim=op.attr("axis", -1))
    put(env, op.output("Out"), out.to(x.dtype))


@register("fused_linear_smooth_ce")
def _fused_linear_smooth_ce(env, op):
    """Vocab projection + label-smoothed softmax CE in one kernel: the
    [.., V] logits never reach device memory (``ops/fused_ce.py``).
    ``paddle_tpu``'s AMP cast (``mxu_cast``) waits for the AMP slice."""
    from ...ops.fused_ce import linear_smooth_ce

    x = get(env, op.input("X"))
    ids = get(env, op.input("Label"))
    if ids.dim() == x.dim():
        ids = ids.squeeze(-1)
    put(env, op.output("Loss"), linear_smooth_ce(
        x, get(env, op.input("W")), get(env, op.input("Bias")), ids,
        op.attr("epsilon", 0.0)))


@register("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(env, op):
    logits = get(env, op.input("Logits"))
    label = get(env, op.input("Label"))
    log_p = torch.log_softmax(logits.float(), dim=-1)
    if op.attr("soft_label", False):
        loss = -(label * log_p).sum(dim=-1, keepdim=True)
    else:
        ids = label.long()
        if ids.dim() == logits.dim():
            ids = ids.squeeze(-1)
        ignore = ids == op.attr("ignore_index", -100)
        loss = -torch.gather(log_p, -1,
                             torch.where(ignore, 0, ids)[..., None])
        loss = torch.where(ignore[..., None], 0.0, loss)
    put(env, op.output("Loss"), loss)
    put(env, op.output("Softmax"), torch.exp(log_p))
