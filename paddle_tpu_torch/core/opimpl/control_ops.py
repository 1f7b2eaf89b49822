"""Autodiff ops (the port's ``paddle_tpu/core/opimpl/control_ops.py:63,211``).

``paddle_tpu`` differentiates by re-tracing the recorded forward ops under
``jax.grad`` from a snapshot of the step-start env. The port needs no such
replay: the Executor runs the forward ops with autograd recording, from
parameters it turned into leaf tensors at step start
(``core/executor.py``), so the tape already holds the forward that just
ran, dropout masks included. ``autodiff`` is ``torch.autograd.grad`` of the
summed loss over that tape.

Not ported yet: sparse (SelectedRows) grads (DeepFM slice; every grad
here is dense), rematerialization (memory slice; ``append_backward``
raises for ``checkpoints``), the pipeline and gradient-scale strategies
(multi-device slice), and control flow (``cond_block``/``while_block``,
queue A.7 of ROADMAP.md), whose op types have no impl here.
"""

import torch

from ..op_registry import register, get, put


def _loss_seed(loss_val):
    """The loss cotangent seed: ``sum(loss)`` (``paddle_tpu``'s default
    GradientScaleStrategy; the others come with the multi-device slice)."""
    return loss_val.sum()


def _grads(outputs, grad_outputs, env, wrt_names):
    """d(outputs)/d(wrt) over the recorded tape; a wrt the outputs do not
    depend on gets zeros, as ``jax.grad`` gives."""
    inputs = [env[n] for n in wrt_names]
    for n, t in zip(wrt_names, inputs):
        if not t.requires_grad:
            raise RuntimeError(
                "autodiff: '%s' was not recorded for gradients; the "
                "Executor turns the op's wrt vars into leaves at step start"
                % n)
    grads = torch.autograd.grad(outputs, inputs, grad_outputs=grad_outputs,
                                allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(inputs, grads)]


@register("autodiff")
def _autodiff(env, op):
    seed = _loss_seed(get(env, op.input("Loss")))
    grads = _grads([seed], None, env, op.attr("wrt_names"))
    for v, g in zip(op.output_list("Grads"), grads):
        put(env, v, g)


@register("autodiff_vjp")
def _autodiff_vjp(env, op):
    """calc_gradient: vjp of arbitrary targets w.r.t. arbitrary inputs;
    the cotangents default to ones."""
    targets = [get(env, t) for t in op.input_list("Targets")]
    tgs = op.input_list("TargetGrads")
    if tgs:
        cot = [get(env, g).reshape(t.shape).to(t.dtype)
               for g, t in zip(tgs, targets)]
    else:
        cot = [torch.ones_like(t) for t in targets]
    wrt_names = op.attr("wrt_names")
    grads = _grads(targets, cot, env, wrt_names)
    for v, g in zip(op.output_list("Grads"), grads):
        put(env, v, g)
