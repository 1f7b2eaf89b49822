"""Optimizer update ops (the dense subset of
``paddle_tpu/core/opimpl/optimizer_ops.py``; ref
``paddle/fluid/operators/optimizers/``). Each op's Out slots alias the
state var names; the Executor runs these ops under ``torch.no_grad()`` and
writes the new state back to the scope. Every gradient in the port is
dense; the sparse (``GradRows``) branches come with the DeepFM slice."""

import torch

from ..op_registry import register, get, put


def _lr(env, op):
    lr = get(env, op.input("LearningRate"))
    return lr.reshape(()) if lr.dim() else lr


@register("sgd")
def _sgd(env, op):
    p = get(env, op.input("Param"))
    g = get(env, op.input("Grad"))
    put(env, op.output("ParamOut"), p - _lr(env, op) * g)


@register("momentum")
def _momentum(env, op):
    p = get(env, op.input("Param"))
    g = get(env, op.input("Grad"))
    v = get(env, op.input("Velocity"))
    mu = op.attr("mu")
    lr = _lr(env, op)
    v_new = mu * v + g
    if op.attr("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    put(env, op.output("ParamOut"), p_new)
    put(env, op.output("VelocityOut"), v_new)


@register("adam")
def _adam(env, op):
    p = get(env, op.input("Param"))
    g = get(env, op.input("Grad"))
    m = get(env, op.input("Moment1"))
    v = get(env, op.input("Moment2"))
    b1p = get(env, op.input("Beta1Pow")).reshape(())
    b2p = get(env, op.input("Beta2Pow")).reshape(())
    b1 = op.attr("beta1", 0.9)
    b2 = op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-8)
    # ref adam_op.h: lr_t = lr * sqrt(1-beta2^t) / (1-beta1^t); the pow
    # accumulators arrive already holding beta^t for the current step t
    # (initialized to beta at t=1), so they are used directly
    lr_t = _lr(env, op) * torch.sqrt(1 - b2p) / (1 - b1p)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * torch.square(g)
    put(env, op.output("ParamOut"),
        p - lr_t * m_new / (torch.sqrt(v_new) + eps))
    put(env, op.output("Moment1Out"), m_new)
    put(env, op.output("Moment2Out"), v_new)
    put(env, op.output("Beta1PowOut"), (b1p * b1).reshape((1,)))
    put(env, op.output("Beta2PowOut"), (b2p * b2).reshape((1,)))
