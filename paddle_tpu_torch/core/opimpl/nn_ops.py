"""Normalization / dropout / softmax / loss ops (the subset of
``paddle_tpu/core/opimpl/nn_ops.py`` the served and trained models run).
``layer_norm`` over the last axis and ``fused_linear_smooth_ce`` call the
port's hand-written kernels on CUDA (``paddle_tpu_torch/ops``), forward and
backward."""

import torch

from ..op_registry import register, get, put, next_rng


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
