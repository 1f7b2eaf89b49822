"""Automatic mixed precision: bf16 products with f32 master state.

The port of ``paddle_tpu/amp.py``. Parameters, optimizer state and the
normalisations' and softmaxes' statistics stay float32; under AMP the
operands of matrix products, convolutions and attention are cast to
bfloat16 at the op (``core/op_registry.py`` :func:`mxu_cast`), their
outputs are stored in bf16, and the activation stream between them stays
bf16 (:func:`~.core.op_registry.amp_harmonize`). bf16 keeps float32's
exponent range, so no loss scaling is needed; ``LossScaler`` is kept for
the API.

Usage::

    opt = fluid.amp.decorate(fluid.optimizer.Adam(1e-4))
    opt.minimize(loss)                     # marks loss's program bf16
    # or, program-level:
    fluid.amp.enable_bf16(main_program)

The mark is ``program._amp_bf16``; the Executor turns AMP on for the
whole run of a marked program (forward, ``torch.autograd`` backward and
update). ``Program.clone`` does not carry it, as in the reference.
"""

from .core import framework

__all__ = ["enable_bf16", "disable_bf16", "decorate", "LossScaler"]


def enable_bf16(program=None):
    """Mark a program for bf16 mixed-precision execution."""
    program = program or framework.default_main_program()
    program._amp_bf16 = True
    program._version += 1
    return program


def disable_bf16(program=None):
    program = program or framework.default_main_program()
    program._amp_bf16 = False
    program._version += 1
    return program


class LossScaler:
    """Static/dynamic loss scaling state (API parity with fp16 trainers; a
    no-op under bf16, whose exponent range makes it unnecessary)."""

    def __init__(self, init_loss_scaling=1.0, use_dynamic_loss_scaling=False,
                 incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
                 incr_ratio=2.0, decr_ratio=0.5):
        self.loss_scaling = init_loss_scaling
        self.use_dynamic = use_dynamic_loss_scaling
        self.incr_every_n_steps = incr_every_n_steps
        self.decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self.incr_ratio = incr_ratio
        self.decr_ratio = decr_ratio


class _DecoratedOptimizer:
    def __init__(self, optimizer, scaler):
        self._opt = optimizer
        self._scaler = scaler

    def __getattr__(self, name):
        return getattr(self._opt, name)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, accumulate_steps=None):
        enable_bf16(loss.block.program)
        return self._opt.minimize(loss, startup_program=startup_program,
                                  parameter_list=parameter_list,
                                  no_grad_set=no_grad_set,
                                  accumulate_steps=accumulate_steps)


def decorate(optimizer, init_loss_scaling=1.0,
             use_dynamic_loss_scaling=False, **scaler_kwargs):
    """Wrap an optimizer so that ``minimize`` enables bf16 compute on the
    loss's program (the reference's contrib mixed-precision ``decorate``)."""
    scaler = LossScaler(init_loss_scaling, use_dynamic_loss_scaling,
                        **scaler_kwargs)
    return _DecoratedOptimizer(optimizer, scaler)
