"""Convolution / pooling / normalization / dropout / softmax / loss /
interpolation ops (``paddle_tpu/core/opimpl/nn_ops.py``, all but
``moe_ffn``). ``layer_norm`` over the last axis, ``fused_linear_smooth_ce``
and ``fused_conv2d`` call the port's hand-written kernels on CUDA
(``paddle_tpu_torch/ops``). Plain ``conv2d``, ``conv3d`` and the
transposed convs are ``F.conv*d`` / ``F.conv_transpose*d`` (cuDNN on the
card), as ``paddle_tpu`` leaves them to ``lax.conv_general_dilated``: a
transposed conv there is the fractionally-strided conv of the flipped,
I/O-swapped kernel, which is what ``F.conv_transpose2d`` computes from the
reference's [Cin, Cout/groups, kh, kw] filter. ``lrn``, ``group_norm``,
``grid_sampler`` and the interpolations port the reference's formulas:
``F.local_response_norm`` divides alpha by n, ``F.grid_sample`` has no mode
that clamps the corners but keeps their weights, and ``jax.image.resize``
(the reference's resize outside align_corners bilinear) anti-aliases a
shrink with its own triangle weights and picks nearest pixels by
floor((i + 0.5) * in / out)."""

import numpy as np
import torch
import torch.nn.functional as F

from ..op_registry import (register, get, put, rng_draw, run_op, mxu_cast,
                           weak_scalar)


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _triple(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * 3


@register("conv2d", "depthwise_conv2d")
def _conv2d(env, op):
    x = get(env, op.input("Input"))  # NCHW
    w = get(env, op.input("Filter"))  # OIHW
    groups = op.attr("groups", 1)
    if op.type == "depthwise_conv2d":
        groups = x.shape[1]
    # under AMP bf16 in, bf16 out (paddle_tpu's nn_ops.py:35-41)
    x, w = mxu_cast(x, w)
    put(env, op.output("Output"), F.conv2d(
        x, w, stride=_pair(op.attr("strides", [1, 1])),
        padding=_pair(op.attr("paddings", [0, 0])),
        dilation=_pair(op.attr("dilations", [1, 1])), groups=groups))


@register("conv3d")
def _conv3d(env, op):
    x = get(env, op.input("Input"))  # NCDHW
    w = get(env, op.input("Filter"))  # OIDHW
    put(env, op.output("Output"), F.conv3d(
        x, w, stride=_triple(op.attr("strides", [1, 1, 1])),
        padding=_triple(op.attr("paddings", [0, 0, 0])),
        dilation=_triple(op.attr("dilations", [1, 1, 1])),
        groups=op.attr("groups", 1)))


@register("conv2d_transpose", "depthwise_conv2d_transpose")
def _conv2d_transpose(env, op):
    """Output (i - 1) * s - 2p + d * (k - 1) + 1 per axis, the filter
    [Cin, Cout/groups, kh, kw]; the depthwise form has groups = Cin."""
    x = get(env, op.input("Input"))
    w = get(env, op.input("Filter"))
    groups = op.attr("groups", 1) or 1
    if op.type == "depthwise_conv2d_transpose":
        groups = x.shape[1]
    x, w = mxu_cast(x, w)
    put(env, op.output("Output"), F.conv_transpose2d(
        x, w, stride=_pair(op.attr("strides", [1, 1])),
        padding=_pair(op.attr("paddings", [0, 0])),
        dilation=_pair(op.attr("dilations", [1, 1])), groups=groups))


@register("conv3d_transpose")
def _conv3d_transpose(env, op):
    x = get(env, op.input("Input"))
    w = get(env, op.input("Filter"))  # [Cin, Cout/g, kd, kh, kw]
    x, w = mxu_cast(x, w)
    put(env, op.output("Output"), F.conv_transpose3d(
        x, w, stride=_triple(op.attr("strides", [1, 1, 1])),
        padding=_triple(op.attr("paddings", [0, 0, 0])),
        dilation=_triple(op.attr("dilations", [1, 1, 1])),
        groups=op.attr("groups", 1) or 1))


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
    adaptive = op.attr("adaptive", False)
    if op.attr("global_pooling", False) or (adaptive and ksize == (1, 1)):
        out = x.amax(dim=(2, 3), keepdim=True) if ptype == "max" \
            else x.mean(dim=(2, 3), keepdim=True)
        put(env, op.output("Out"), out)
        return
    if adaptive:
        # equal bins of a divisible input (nn_ops.py:125-133)
        n, c, h, w = x.shape
        oh, ow = ksize
        assert h % oh == 0 and w % ow == 0, \
            "adaptive pool needs divisible dims"
        xr = x.reshape(n, c, oh, h // oh, ow, w // ow)
        put(env, op.output("Out"), xr.amax(dim=(3, 5)) if ptype == "max"
            else xr.mean(dim=(3, 5)))
        return
    # ceil mode extends the high-side padding so that the last window
    # fits, as the reference pads; that window is kept even where it
    # starts in the padding (torch's ceil_mode would drop it)
    pad_cfg = _ceil_pads(x.shape[2:], ksize, strides, pads, ceil_mode)
    cfg = [v for lo_hi in reversed(pad_cfg) for v in lo_hi]  # F.pad's order
    if ptype == "max":
        if all(lo == hi for lo, hi in pad_cfg) \
                and all(p <= k // 2 for p, k in zip(pads, ksize)):
            out = F.max_pool2d(x, ksize, strides, pads)  # pads with -inf
        else:
            out = F.max_pool2d(F.pad(x, cfg, value=float("-inf")), ksize,
                               strides)
        put(env, op.output("Out"), out)
        return
    # average: sum over windows of the zero-padded input
    area = float(ksize[0] * ksize[1])
    s = F.avg_pool2d(F.pad(x, cfg), ksize, strides) * area
    if op.attr("exclusive", True) and (pads != (0, 0) or ceil_mode):
        ones = F.pad(torch.ones_like(x[:1, :1]), cfg)
        s = s / (F.avg_pool2d(ones, ksize, strides) * area)
    else:
        s = s / area
    put(env, op.output("Out"), s)


def _ceil_pads(shape, ksize, strides, pads, ceil_mode):
    """(low, high) padding per spatial axis; ceil mode extends the high
    side so that the last window fits."""
    cfg = []
    for sp, k, st, p in zip(shape, ksize, strides, pads):
        hi = 0
        if ceil_mode:
            out_i = -(-(sp + 2 * p - k) // st) + 1
            hi = max(0, (out_i - 1) * st + k - (sp + 2 * p))
        cfg.append((p, p + hi))
    return cfg


@register("pool3d")
def _pool3d(env, op):
    """Max / average over 3-D windows, NCDHW (``nn_ops.py:171-218``), with
    pool2d's padding semantics."""
    x = get(env, op.input("X"))
    ptype = op.attr("pooling_type", "max")
    ksize = _triple(op.attr("ksize"))
    strides = _triple(op.attr("strides", [1, 1, 1]))
    pads = _triple(op.attr("paddings", [0, 0, 0]))
    ceil_mode = op.attr("ceil_mode", False)
    if op.attr("global_pooling", False):
        put(env, op.output("Out"), x.amax(dim=(2, 3, 4), keepdim=True)
            if ptype == "max" else x.mean(dim=(2, 3, 4), keepdim=True))
        return
    if op.attr("adaptive", False):
        n, c, d, h, w = x.shape
        od, oh, ow = ksize
        assert d % od == 0 and h % oh == 0 and w % ow == 0, \
            "adaptive pool3d needs divisible dims"
        xr = x.reshape(n, c, od, d // od, oh, h // oh, ow, w // ow)
        put(env, op.output("Out"), xr.amax(dim=(3, 5, 7)) if ptype == "max"
            else xr.mean(dim=(3, 5, 7)))
        return
    cfg = _ceil_pads(x.shape[2:], ksize, strides, pads, ceil_mode)
    flat = [v for lo_hi in reversed(cfg) for v in lo_hi]  # F.pad's order
    if ptype == "max":
        put(env, op.output("Out"), F.max_pool3d(
            F.pad(x, flat, value=float("-inf")), ksize, strides))
        return
    vol = float(ksize[0] * ksize[1] * ksize[2])
    s = F.avg_pool3d(F.pad(x, flat), ksize, strides) * vol
    if op.attr("exclusive", True) and (any(pads) or ceil_mode):
        ones = F.pad(torch.ones_like(x[:1, :1]), flat)
        s = s / (F.avg_pool3d(ones, ksize, strides) * vol)
    else:
        s = s / vol
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
    # under AMP the kernels take bf16 x and w (paddle_tpu's nn_ops.py:282)
    x, w = mxu_cast(x, w)
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

    if residual is not None and residual.dtype != x.dtype:
        # a bf16 site demotes an f32 residual (paddle_tpu's :311-313,
        # amp_harmonize); the kernels take one dtype for both
        residual = residual.to(x.dtype)
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

        op.attrs["_kernel_choice"] = {
            "kernel": "plain" if x.device.type == "cpu"
            else "cuda_layer_norm", "dtype": str(x.dtype).split(".")[-1]}
        y, mean, var = fused_layer_norm(x, scale, bias, eps)
        put(env, op.output("Y"), y)
        put(env, op.output("Mean"), mean)
        put(env, op.output("Variance"), var)
        return
    # other axes: the composed form, stats in f32 and Y in the input dtype
    # (nn_ops.py:410-425)
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


@register("group_norm")
def _group_norm(env, op):
    x = get(env, op.input("X"))  # NC...
    scale = get(env, op.input("Scale"))
    bias = get(env, op.input("Bias"))
    g = op.attr("groups")
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=axes, keepdim=True)
    var = torch.square(xg - mean).mean(dim=axes, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + op.attr("epsilon", 1e-5))
         ).reshape(x.shape)
    cshape = (1, c) + (1,) * (x.dim() - 2)
    if scale is not None:
        y = y * scale.reshape(cshape)
    if bias is not None:
        y = y + bias.reshape(cshape)
    put(env, op.output("Y"), y)


@register("lrn")
def _lrn(env, op):
    """x / (k + alpha * sum of x^2 over n channels)^beta: alpha is not
    divided by n (``nn_ops.py:449-460``)."""
    x = get(env, op.input("X"))  # NCHW
    n_size = op.attr("n", 5)
    half = n_size // 2
    pad = F.pad(torch.square(x), (0, 0, 0, 0, half, half))
    acc = sum(pad[:, i:i + x.shape[1]] for i in range(n_size))
    put(env, op.output("Out"), x / torch.pow(
        op.attr("k", 1.0) + op.attr("alpha", 1e-4) * acc,
        op.attr("beta", 0.75)))


@register("dropout")
def _dropout(env, op):
    x = get(env, op.input("X"))
    p = op.attr("dropout_prob", 0.5)
    impl = op.attr("dropout_implementation", "downgrade_in_infer")
    if op.attr("is_test", False):
        put(env, op.output("Out"), x * weak_scalar(x, 1.0 - p)
            if impl == "downgrade_in_infer" else x)
        return
    keep = rng_draw(env, lambda gen: torch.rand(
        x.shape, generator=gen, device=x.device) < (1.0 - p))
    mask = keep.to(x.dtype)
    if impl == "upscale_in_train":
        out = torch.zeros_like(x) if p >= 1.0 \
            else x * mask / weak_scalar(x, 1.0 - p)
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
    [.., V] logits never reach device memory (``ops/fused_ce.py``). Under
    AMP x, W and the bias go in as bf16 (``paddle_tpu``'s
    nn_ops.py:580-590); the loss is f32 either way."""
    from ...ops.fused_ce import ce_form, linear_smooth_ce

    x = get(env, op.input("X"))
    ids = get(env, op.input("Label"))
    if ids.dim() == x.dim():
        ids = ids.squeeze(-1)
    x, w, b = mxu_cast(x, get(env, op.input("W")), get(env, op.input("Bias")))
    op.attrs["_kernel_choice"] = (
        {"kernel": "plain"} if x.device.type == "cpu" else
        {"kernel": "cuda_fused_ce", "dtype": str(x.dtype).split(".")[-1],
         "form": ce_form(x.reshape(-1, x.shape[-1]), w)})
    put(env, op.output("Loss"), linear_smooth_ce(
        x, w, b, ids, op.attr("epsilon", 0.0)))


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


@register("sigmoid_cross_entropy_with_logits")
def _sigmoid_ce(env, op):
    """max(x, 0) - x * label + log(1 + exp(-|x|)) elementwise; entries whose
    label is ``ignore_index`` give 0, and ``normalize`` divides by the
    count of the others (``paddle_tpu``'s ``nn_ops.py:593-603``)."""
    x = get(env, op.input("X"))
    label = get(env, op.input("Label"))
    loss = torch.clamp_min(x, 0.0) - x * label + torch.log1p(
        torch.exp(-torch.abs(x)))
    ignore = label == op.attr("ignore_index", -100)
    loss = torch.where(ignore, 0.0, loss)
    if op.attr("normalize", False):
        loss = loss / torch.clamp_min((~ignore).sum().to(x.dtype), 1.0)
    put(env, op.output("Out"), loss)


# ---------------- the other losses (``paddle_tpu``'s nn_ops.py:495-721) ----

def _label_ids(label, x):
    """Hard labels as int64 ids shaped like ``x`` without its last axis."""
    ids = label.long()
    if ids.dim() == x.dim():
        ids = ids.squeeze(-1)
    return ids


def _gather_last(x, ids):
    """``x[..., ids]`` per row with ids that may be out of range (masked
    by the caller): they read column 0."""
    ok = (ids >= 0) & (ids < x.shape[-1])
    return torch.gather(x, -1, torch.where(ok, ids, 0)[..., None])


@register("log_softmax")
def _log_softmax(env, op):
    x = get(env, op.input("X"))
    out = torch.log_softmax(x.float(), dim=op.attr("axis", -1))
    put(env, op.output("Out"), out.to(x.dtype))


@register("cross_entropy")
def _cross_entropy(env, op):
    """Ref ``cross_entropy_op.cc``: X holds probabilities. A hard label
    gives -log(p[label] + 1e-8), 0 at ``ignore_index``; a soft one
    -sum(label * log(p + 1e-8))."""
    x = get(env, op.input("X"))
    label = get(env, op.input("Label"))
    eps = 1e-8
    if op.attr("soft_label", False):
        loss = -(label * torch.log(x + eps)).sum(dim=-1, keepdim=True)
    else:
        ids = _label_ids(label, x)
        loss = -torch.log(_gather_last(x, ids) + eps)
        loss = torch.where((ids == op.attr("ignore_index", -100))[..., None],
                           torch.zeros_like(loss), loss)
    put(env, op.output("Y"), loss)


@register("smooth_softmax_ce")
def _smooth_softmax_ce(env, op):
    """Label-smoothed softmax CE in closed form, f32 statistics:
    lse(logits) - (1 - eps) * logits[y] - eps * mean(logits)."""
    lf = get(env, op.input("Logits")).float()
    ids = _label_ids(get(env, op.input("Label")), lf)
    eps = op.attr("epsilon", 0.0)
    loss = torch.logsumexp(lf, dim=-1) - (1.0 - eps) * _gather_last(
        lf, ids)[..., 0]
    if eps:
        loss = loss - eps * lf.mean(dim=-1)
    put(env, op.output("Loss"), loss)


@register("square_error_cost")
def _square_error_cost(env, op):
    x = get(env, op.input("X"))
    put(env, op.output("Out"), torch.square(x - get(env, op.input("Y"))))


@register("smooth_l1_loss")
def _smooth_l1(env, op):
    x = get(env, op.input("X"))
    s2 = op.attr("sigma", 1.0) ** 2
    diff = x - get(env, op.input("Y"))
    iw = get(env, op.input("InsideWeight"))
    ow = get(env, op.input("OutsideWeight"))
    if iw is not None:
        diff = diff * iw
    ad = torch.abs(diff)
    loss = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)
    if ow is not None:
        loss = loss * ow
    put(env, op.output("Diff"), diff)
    put(env, op.output("Out"),
        loss.sum(dim=tuple(range(1, x.dim()))).reshape(x.shape[0], 1))


@register("huber_loss")
def _huber_loss(env, op):
    x = get(env, op.input("X"))
    delta = op.attr("delta", 1.0)
    r = get(env, op.input("Y")) - x
    ar = torch.abs(r)
    put(env, op.output("Residual"), r)
    put(env, op.output("Out"), torch.where(
        ar <= delta, 0.5 * r * r, delta * (ar - 0.5 * delta)))


@register("label_smooth")
def _label_smooth(env, op):
    x = get(env, op.input("X"))
    eps = op.attr("epsilon", 0.0)
    dist = get(env, op.input("PriorDist"))
    prior = eps * dist if dist is not None else eps / x.shape[-1]
    put(env, op.output("Out"), (1 - eps) * x + prior)


@register("kldiv_loss")
def _kldiv_loss(env, op):
    x = get(env, op.input("X"))  # log-probabilities
    target = get(env, op.input("Target"))
    loss = target * (torch.log(torch.clamp_min(target, 1e-12)) - x)
    red = op.attr("reduction", "mean")
    if red == "mean":
        loss = loss.mean()
    elif red == "sum":
        loss = loss.sum()
    elif red == "batchmean":
        loss = loss.sum() / x.shape[0]
    put(env, op.output("Loss"), loss)


@register("bpr_loss")
def _bpr_loss(env, op):
    """Bayesian personalised ranking: the mean over the other columns of
    -log(sigmoid(x[label] - x) + 1e-8)."""
    x = get(env, op.input("X"))
    ids = _label_ids(get(env, op.input("Label")), x)
    loss = -torch.log(torch.sigmoid(_gather_last(x, ids) - x) + 1e-8)
    others = 1.0 - F.one_hot(ids.clamp(0, x.shape[-1] - 1),
                             x.shape[-1]).to(x.dtype)
    put(env, op.output("Y"), (loss * others).sum(dim=-1, keepdim=True)
        / max(x.shape[-1] - 1, 1))


@register("hinge_loss")
def _hinge_loss(env, op):
    logits = get(env, op.input("Logits"))
    labels = get(env, op.input("Labels"))
    put(env, op.output("Loss"),
        torch.clamp_min(1.0 - (2.0 * labels - 1.0) * logits, 0.0))


@register("log_loss")
def _log_loss(env, op):
    p = get(env, op.input("Predicted"))
    label = get(env, op.input("Labels"))
    eps = op.attr("epsilon", 1e-4)
    put(env, op.output("Loss"), -label * torch.log(p + eps)
        - (1 - label) * torch.log(1 - p + eps))


@register("margin_rank_loss")
def _margin_rank_loss(env, op):
    x1 = get(env, op.input("X1"))
    x2 = get(env, op.input("X2"))
    label = get(env, op.input("Label"))
    out = torch.clamp_min(-label * (x1 - x2) + op.attr("margin", 0.0), 0.0)
    put(env, op.output("Out"), out)
    put(env, op.output("Activated"), (out > 0).to(x1.dtype))


@register("mse_loss")
def _mse_loss(env, op):
    x = get(env, op.input("X"))
    put(env, op.output("Out"),
        torch.square(x - get(env, op.input("Y"))).mean())


# ---------------- interpolation / resize ----------------

def _scalar(v, device):
    """``v`` as a 0-d f32 tensor: CUDA divides by a Python number as a
    product with its reciprocal, which moves a quotient by an ulp, and a
    floor of it (a pixel index) by one; a tensor divisor divides."""
    return torch.full((), float(v), dtype=torch.float32, device=device)


def jnp_linspace(start, stop, num, device):
    """``jnp.linspace(start, stop, num)`` in f32 as the reference computes
    it: start * (1 - t) + stop * t with t = iota / (num - 1), the last
    point exactly ``stop`` (``torch.linspace`` rounds some points the
    other way)."""
    if num == 1:
        return torch.full((1,), float(start), device=device)
    t = torch.arange(num - 1, dtype=torch.float32, device=device) \
        / _scalar(num - 1, device)
    head = start * (1 - t) + stop * t
    return torch.cat([head, torch.full((1,), float(stop), device=device)])


def _resize_weights(m, n, device):
    """[m, n] weights of ``jax.image.resize``'s linear kernel from m input
    to n output pixels (``scale.py`` compute_weight_mat): half-pixel
    centres, the triangle widened by in / out when shrinking
    (anti-aliasing), each column normalised to sum 1."""
    inv = 1.0 / (n / m)
    kscale = max(inv, 1.0)
    sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) \
        * inv - 0.5
    dist = torch.abs(sample[None, :] - torch.arange(
        m, dtype=torch.float32, device=device)[:, None]) \
        / _scalar(kscale, device)
    w = torch.clamp_min(1 - torch.abs(dist), 0)
    tot = w.sum(dim=0, keepdim=True)
    w = torch.where(torch.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _nearest_index(m, n, device):
    """``jax.image.resize``'s nearest pixel: floor((i + 0.5) * m / n) in
    f32 (torch's ``nearest`` floors i * m / n)."""
    off = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * m \
        / _scalar(n, device)
    return torch.floor(off).long()


@register("bilinear_interp", "nearest_interp")
def _interp(env, op):
    x = get(env, op.input("X"))  # NCHW
    out_h, out_w = op.attr("out_h"), op.attr("out_w")
    scale = op.attr("scale", 0.0)
    if scale and (not out_h or out_h <= 0):
        out_h = int(x.shape[2] * scale)
        out_w = int(x.shape[3] * scale)
    h_in, w_in = x.shape[2], x.shape[3]
    dev = x.device
    if op.type == "bilinear_interp" and op.attr("align_corners", True) \
            and out_h > 1 and out_w > 1:
        # align_corners: the reference's explicit gather (nn_ops.py:735-748)
        ys = jnp_linspace(0.0, h_in - 1.0, out_h, dev)
        xs = jnp_linspace(0.0, w_in - 1.0, out_w, dev)
        y0, x0 = torch.floor(ys).long(), torch.floor(xs).long()
        y1 = torch.clamp_max(y0 + 1, h_in - 1)
        x1 = torch.clamp_max(x0 + 1, w_in - 1)
        wy = (ys - y0)[None, None, :, None]
        wx = (xs - x0)[None, None, None, :]

        def g(yy, xx):
            return x[:, :, yy, :][:, :, :, xx]

        out = (g(y0, x0) * (1 - wy) * (1 - wx) + g(y1, x0) * wy * (1 - wx)
               + g(y0, x1) * (1 - wy) * wx + g(y1, x1) * wy * wx)
    elif op.type == "nearest_interp":
        out = x
        if out_h != h_in:
            out = out[:, :, _nearest_index(h_in, out_h, dev)]
        if out_w != w_in:
            out = out[:, :, :, _nearest_index(w_in, out_w, dev)]
    else:
        out = x if x.is_floating_point() else x.float()
        if out_h != h_in:
            out = torch.einsum("nchw,hy->ncyw", out, _resize_weights(
                h_in, out_h, dev).to(out.dtype))
        if out_w != w_in:
            out = torch.einsum("nchw,wx->nchx", out, _resize_weights(
                w_in, out_w, dev).to(out.dtype))
    put(env, op.output("Out"), out.to(x.dtype))


# ---------------- misc nn ----------------

@register("im2sequence")
def _im2sequence(env, op):
    """Every kh x kw patch as a row [N * oh * ow, C * kh * kw], features
    channel-major (``nn_ops.py:756-773``)."""
    x = get(env, op.input("X"))  # NCHW
    kh, kw = op.attr("kernels")
    strides = tuple(op.attr("strides", [1, 1]))
    p = op.attr("paddings", [0, 0, 0, 0])
    n, c = x.shape[0], x.shape[1]
    xp = F.pad(x, (p[1], p[3], p[0], p[2]))
    oh = (xp.shape[2] - kh) // strides[0] + 1
    ow = (xp.shape[3] - kw) // strides[1] + 1
    patches = F.unfold(xp, (kh, kw), stride=strides)  # [N, C*kh*kw, L]
    put(env, op.output("Out"), patches.transpose(1, 2).reshape(
        n * oh * ow, c * kh * kw))


@register("grid_sampler")
def _grid_sampler(env, op):
    """Bilinear sampling at grid [N, Ho, Wo, 2] in [-1, 1] (corners
    aligned): the corner indices are clamped into the image and the
    weights are those of the unclamped floor (``nn_ops.py:776-798``)."""
    x = get(env, op.input("X"))  # NCHW
    grid = get(env, op.input("Grid"))
    n, c, h, w = x.shape
    gx = (grid[..., 0] + 1) * (w - 1) / 2
    gy = (grid[..., 1] + 1) * (h - 1) / 2
    x0 = torch.clamp(torch.floor(gx).long(), 0, w - 1)
    y0 = torch.clamp(torch.floor(gy).long(), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    wx = gx - x0
    wy = gy - y0
    bidx = torch.arange(n, device=x.device)[:, None, None]

    def gat(yy, xx):
        return x[bidx, :, yy, xx]  # [N, Ho, Wo, C]

    out = (gat(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
           + gat(y0, x1) * ((1 - wy) * wx)[..., None]
           + gat(y1, x0) * (wy * (1 - wx))[..., None]
           + gat(y1, x1) * (wy * wx)[..., None])
    put(env, op.output("Output"), out.permute(0, 3, 1, 2))


@register("pixel_shuffle")
def _pixel_shuffle(env, op):
    x = get(env, op.input("X"))
    r = op.attr("upscale_factor")
    n, c, h, w = x.shape
    out = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    put(env, op.output("Out"), out.reshape(n, c // (r * r), h * r, w * r))
