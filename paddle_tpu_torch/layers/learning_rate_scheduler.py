"""Learning-rate schedules (``paddle_tpu/layers/learning_rate_scheduler.py``;
ref ``python/paddle/fluid/layers/learning_rate_scheduler.py``): each
returns a 0-d float32 Variable recomputed every step from the global step
counter, one op per schedule (``core/opimpl/control_ops.py``). An
optimizer takes it as its ``learning_rate``."""

from ..core.framework import Variable
from ..core.layer_helper import LayerHelper
from . import tensor
from .nn import autoincreased_step_counter

__all__ = [
    "exponential_decay", "natural_exp_decay", "inverse_time_decay",
    "polynomial_decay", "piecewise_decay", "cosine_decay", "noam_decay",
    "linear_lr_warmup",
]


def _counter():
    return autoincreased_step_counter(counter_name="@LR_DECAY_COUNTER@",
                                      begin=0, step=1)


def _sched(op_type, attrs, inputs=None):
    helper = LayerHelper(op_type)
    step = _counter()
    out = helper.create_variable_for_type_inference(dtype="float32", shape=())
    helper.append_op(op_type, dict(inputs or {}, Step=step), {"Out": out},
                     attrs)
    return out


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    return _sched("lr_exponential_decay",
                  {"learning_rate": learning_rate, "decay_steps": decay_steps,
                   "decay_rate": decay_rate, "staircase": staircase})


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    return _sched("lr_natural_exp_decay",
                  {"learning_rate": learning_rate, "decay_steps": decay_steps,
                   "decay_rate": decay_rate, "staircase": staircase})


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    return _sched("lr_inverse_time_decay",
                  {"learning_rate": learning_rate, "decay_steps": decay_steps,
                   "decay_rate": decay_rate, "staircase": staircase})


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    return _sched("lr_polynomial_decay",
                  {"learning_rate": learning_rate, "decay_steps": decay_steps,
                   "end_learning_rate": end_learning_rate, "power": power,
                   "cycle": cycle})


def piecewise_decay(boundaries, values):
    if len(values) - len(boundaries) != 1:
        raise ValueError("piecewise_decay needs one more value than "
                         "boundaries")
    return _sched("lr_piecewise_decay",
                  {"boundaries": list(boundaries), "values": list(values)})


def cosine_decay(learning_rate, step_each_epoch, epochs):
    return _sched("lr_cosine_decay",
                  {"learning_rate": learning_rate,
                   "step_each_epoch": step_each_epoch, "epochs": epochs})


def noam_decay(d_model, warmup_steps):
    return _sched("lr_noam_decay",
                  {"d_model": d_model, "warmup_steps": warmup_steps})


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """``start_lr`` to ``end_lr`` linearly over ``warmup_steps``, then
    ``learning_rate`` (a number or a schedule's Variable)."""
    helper = LayerHelper("lr_linear_warmup")
    step = _counter()
    if not isinstance(learning_rate, Variable):
        learning_rate = tensor.fill_constant([], "float32", learning_rate)
    out = helper.create_variable_for_type_inference(dtype="float32", shape=())
    helper.append_op("lr_linear_warmup",
                     {"Step": step, "Base": learning_rate}, {"Out": out},
                     {"warmup_steps": warmup_steps, "start_lr": start_lr,
                      "end_lr": end_lr})
    return out
