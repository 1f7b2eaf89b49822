"""Fake-quantization ops (QAT): the port's ``paddle_tpu/core/opimpl/
quant_ops.py`` (ref ``paddle/fluid/operators/fake_quantize_op.cc``).

The round/clip sits inside a straight-through estimator (``x + (q(x) -
x).detach()``): the forward gives q(x) and autograd the identity's
gradient, as the reference's ``_ste`` does under ``jax.grad``. The
moving-average op's state is a persistable the op reads and writes, so
the Executor writes its new value into the scope's own tensor and a
captured step advances it on every replay. Plain torch: nothing here is
a TPU kernel."""

import torch

from ..op_registry import get, put, register


def _ste(x, q):
    """Straight-through: forward q, gradient of identity."""
    return x + (q - x).detach()


def _true_div(x, c):
    """``x / c`` for a Python number ``c``, correctly rounded: on a CUDA
    tensor torch divides by a Python scalar as a product with its
    reciprocal, which rounds otherwise than the reference's division (and
    ``freeze_program``'s numpy, whose baked weights must equal this op's
    output). A 0-d tensor on x's device divides truly."""
    return x / x.new_full((), c)


def _quant_dequant(x, scale, bits):
    qmax = float(2 ** (bits - 1) - 1)
    s = torch.clamp(scale, min=1e-8)
    return _true_div(torch.round(torch.clamp(x / s, -1.0, 1.0) * qmax),
                     qmax) * s


@register("fake_quantize_abs_max")
def _fake_quantize_abs_max(env, op):
    x = get(env, op.input("X"))
    bits = op.attr("bit_length", 8)
    scale = x.detach().abs().amax()
    put(env, op.output("Out"), _ste(x, _quant_dequant(x, scale, bits)))
    put(env, op.output("OutScale"), scale.reshape(()))


@register("fake_quantize_moving_average_abs_max")
def _fake_quantize_moving_avg(env, op):
    """Activation quantization with a moving-average scale (state var),
    seeded with the first batch's abs-max (``paddle_tpu``'s rule: an EMA
    from the zero init would quantize early steps with a ~(1 - rate)x
    too-small scale)."""
    x = get(env, op.input("X"))
    state = get(env, op.input("InScale")).reshape(())
    bits = op.attr("bit_length", 8)
    rate = op.attr("moving_rate", 0.9)
    cur = x.detach().abs().amax()
    if op.attr("is_test", False):
        new_state = state
    else:
        new_state = torch.where(state > 0, rate * state + (1.0 - rate) * cur,
                                cur)
    scale = torch.where(new_state > 0, new_state, cur)
    put(env, op.output("Out"), _ste(x, _quant_dequant(x, scale, bits)))
    put(env, op.output("OutScale"), new_state.reshape(()))


@register("fake_channel_wise_quantize_abs_max")
def _fake_channel_wise_quant(env, op):
    """Per-output-channel weight quantization (axis 0 for OIHW conv
    weights; the transpiler passes ``quant_axis`` 1 for mul weights)."""
    x = get(env, op.input("X"))
    bits = op.attr("bit_length", 8)
    axis = op.attr("quant_axis", 0)
    red = tuple(i for i in range(x.dim()) if i != axis)
    scale = x.detach().abs().amax(dim=red, keepdim=True)
    put(env, op.output("Out"), _ste(x, _quant_dequant(x, scale, bits)))
    put(env, op.output("OutScale"), scale.reshape(-1))


@register("fake_dequantize_max_abs")
def _fake_dequantize(env, op):
    x = get(env, op.input("X"))
    scale = get(env, op.input("Scale"))
    qmax = float(2 ** (op.attr("bit_length", 8) - 1) - 1)
    put(env, op.output("Out"), _true_div(x.to(torch.float32) * scale, qmax))
