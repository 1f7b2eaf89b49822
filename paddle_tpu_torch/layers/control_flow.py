"""Control-flow layers: the part of ``paddle_tpu/layers/control_flow.py``
the learning-rate schedules need (ref
``python/paddle/fluid/layers/control_flow.py``: Switch:1138). ``Switch``
records each case's ops in a sub-block and moves them into the global
block guarded by ``_switch_cond``; ``run_op`` then keeps each output's old
value where the case does not fire (``torch.where`` on the device), so a
step with a Switch is captured like any other. While, StaticRNN,
DynamicRNN, IfElse, ``cond`` and the array ops are not ported yet
(ROADMAP A4)."""

from ..core import framework
from ..core.framework import Variable
from ..core.layer_helper import LayerHelper
from ..core.op_registry import static_bcast_shape
from . import tensor

__all__ = ["Switch", "increment", "less_than", "equal"]


def _compare(x, y, op_type, cond=None):
    """``op_type`` of x and y (a Variable or a number, which becomes a [1]
    ``fill_constant`` of x's dtype) into a bool var, or into ``cond``
    (``paddle_tpu/layers/math_op_patch.py`` ``binary``)."""
    block = framework.default_main_program().current_block()
    if not isinstance(y, Variable):
        y = tensor.fill_constant(shape=[1], dtype=str(x.dtype),
                                 value=float(y))
    try:
        shape = static_bcast_shape(x.shape or (), y.shape or (), -1)
    except ValueError:
        shape = x.shape or ()
    if cond is None:
        cond = block.create_var(shape=shape, dtype="bool")
    block.append_op(op_type, {"X": x, "Y": y}, {"Out": cond}, {"axis": -1})
    return cond


def less_than(x, y, force_cpu=None, cond=None):
    return _compare(x, y, "less_than", cond)


def equal(x, y, cond=None):
    return _compare(x, y, "equal", cond)


def increment(x, value=1.0, in_place=True):
    return tensor.increment(x, value, in_place)


class Switch:
    """First-match cases (ref ``control_flow.py:1138``): a case's ops run
    guarded by ``its cond AND NOT(any earlier cond)``, the default's by
    ``NOT(any cond)``.

        with Switch() as switch:
            with switch.case(less_than(step, boundary)):
                assign(v0, lr)
            with switch.default():
                assign(v1, lr)
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._prior_conds = []

    def case(self, condition):
        return _SwitchCase(self, condition)

    def default(self):
        return _SwitchCase(self, None)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _SwitchCase:
    def __init__(self, switch, condition):
        self.switch = switch
        self.condition = condition
        self.prog = framework.default_main_program()

    def __enter__(self):
        self.block = self.prog._create_block()
        return self.block

    def __exit__(self, *a):
        self.prog._rollback()
        ops = list(self.block.ops)
        gb = self.prog.global_block()

        def _not(v):
            o = gb.create_var(shape=v.shape or (1,), dtype="bool")
            gb.append_op("logical_not", {"X": v}, {"Out": o}, {})
            return o

        def _and(a, b):
            o = gb.create_var(shape=a.shape or (1,), dtype="bool")
            gb.append_op("logical_and", {"X": a, "Y": b}, {"Out": o}, {})
            return o

        eff = self.condition
        for prior in self.switch._prior_conds:
            np_ = _not(prior)
            eff = np_ if eff is None else _and(eff, np_)
        if self.condition is not None:
            self.switch._prior_conds.append(self.condition)
        for op in ops:
            if eff is not None:
                op.attrs["_switch_cond"] = eff.name
            gb.ops.append(op)
            self.prog._version += 1
        return False
