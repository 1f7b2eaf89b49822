"""Optimizers (ref ``python/paddle/fluid/optimizer.py``: Optimizer base
``:44``, ``minimize:357`` = append_backward + apply_gradients; the port's
copy of ``paddle_tpu/optimizer.py``).

Each optimizer appends symbolic update ops whose Out slots alias the state
var names; the Executor runs them under ``torch.no_grad()`` and writes the
new state back to the scope. Accumulators (velocity, moments, beta powers)
are persistable vars the startup program fills with constants, as the
reference's ``_add_accumulator`` does. A parameter with a sparse (rows,
values) grad gets its rows var wired to the update op as ``GradRows``.

``minimize(..., accumulate_steps=k)`` sums the raw gradients into
persistable buffers over k runs and applies their mean on every k-th: the
update ops are marked ``_switch_cond`` with the apply condition, which
``run_op`` blends on the device, so an accumulating step is captured like
any other. ``ModelAverage`` and ``ExponentialMovingAverage`` keep their
averages as persistable state; their ``apply``/``restore`` swap the
averages into the scope's parameters and back.
"""

import contextlib

import torch

from .backward import append_backward
from .clip import append_gradient_clip_ops
from .core import framework, unique_name
from .core.framework import Parameter, Variable
from .regularizer import append_regularization_ops

__all__ = [
    "SGD", "Momentum", "Adagrad", "Adam", "Adamax", "DecayedAdagrad",
    "Adadelta", "RMSProp", "Ftrl", "Lamb", "LarsMomentum",
    "SGDOptimizer", "MomentumOptimizer", "AdagradOptimizer", "AdamOptimizer",
    "AdamaxOptimizer", "DecayedAdagradOptimizer", "AdadeltaOptimizer",
    "RMSPropOptimizer", "FtrlOptimizer", "LambOptimizer",
    "LarsMomentumOptimizer", "ModelAverage", "ExponentialMovingAverage",
]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._name = name
        self._accumulators = {}  # acc_name -> {param_name: var}
        self._lr_var = None

    # ---- learning rate ----
    def _create_lr_var(self, program):
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
            return
        if self._lr_var is not None:
            return
        name = unique_name.generate("learning_rate")
        self._lr_var = program.global_block().create_var(
            name=name, shape=(), dtype="float32", persistable=True)
        sb = framework.default_startup_program().global_block()
        sp = sb.create_var(name=name, shape=(), dtype="float32",
                           persistable=True)
        sb.append_op("fill_constant", outputs={"Out": sp},
                     attrs={"shape": (), "dtype": "float32",
                            "value": float(self._learning_rate)})

    def _lr_for(self, param):
        mult = 1.0
        if isinstance(param, Parameter) and param.optimize_attr:
            mult = param.optimize_attr.get("learning_rate", 1.0)
        if mult == 1.0:
            return self._lr_var
        from .layers import nn
        return nn.scale(self._lr_var, scale=float(mult))

    # ---- accumulators ----
    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype=None):
        if name in self._accumulators and \
                param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        var_name = unique_name.generate("%s_%s" % (param.name, name))
        shape = tuple(shape if shape is not None else param.shape)
        dtype = dtype or str(param.dtype)
        var = param.block.program.global_block().create_var(
            name=var_name, shape=shape, dtype=dtype, persistable=True)
        sb = framework.default_startup_program().global_block()
        sp = sb.create_var(name=var_name, shape=shape, dtype=dtype,
                           persistable=True)
        sb.append_op("fill_constant", outputs={"Out": sp},
                     attrs={"shape": shape, "dtype": dtype,
                            "value": float(fill_value)})
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # ---- the optimize pass ----
    def _create_optimization_pass(self, params_grads):
        prog = params_grads[0][0].block.program
        self._create_lr_var(prog)
        ops = []
        for p, g in params_grads:
            with framework.name_scope("optimizer"):
                op = self._append_optimize_op(prog.global_block(), (p, g))
                op.attrs["is_optimizer_op"] = True
                rows = getattr(g, "sparse_rows_var", None)
                if rows is not None:
                    # a (rows, values) grad: the update op takes its
                    # sparse branch (ref sparse optimizer kernels)
                    op.inputs["GradRows"] = [rows]
                ops.append(op)
        self._finish_update(prog.global_block(), params_grads)
        return ops

    def _finish_update(self, block, params_grads):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def _append_grad_accumulation(self, params_grads, k):
        """Gradient accumulation (``paddle_tpu/optimizer.py:127``; ref
        ``framework/ir/multi_batch_merge_pass.cc``): the raw grads sum into
        persistable buffers over ``k`` micro-steps; clip, regularization
        and the update consume the running mean, and the update ops fire
        on every k-th step only (``_switch_cond``: their outputs keep the
        old state in between). k micro-steps of batch b are one step of
        batch k*b (mean-loss grads). A sparse grad scatters into its dense
        buffer (the ``scatter`` op) and the apply takes the dense branch.

        Returns (averaged params_grads, apply-condition var)."""
        from .layers import control_flow as lcf
        from .layers import nn as lnn
        from .layers import tensor as ltensor

        block = params_grads[0][0].block.program.global_block()
        self._rescale_lr_decay_counter(block, k)
        sb = framework.default_startup_program().global_block()
        with framework.name_scope("grad_acc"):
            counter = lnn.autoincreased_step_counter(
                counter_name=unique_name.generate("@GRAD_ACC_COUNTER@"))
            kvar = ltensor.fill_constant([1], "int64", k)
            phase = block.create_var(
                name=unique_name.generate("grad_acc_phase"), shape=(1,),
                dtype="int64")
            block.append_op("elementwise_mod", {"X": counter, "Y": kvar},
                            {"Out": phase}, {})
            apply_cond = lcf.equal(phase,
                                   ltensor.fill_constant([1], "int64", 0))
            # keep factor: 0.0 on apply steps (reset), 1.0 otherwise
            not_apply = block.create_var(
                name=unique_name.generate("grad_acc_keep"), shape=(1,),
                dtype="bool")
            block.append_op("logical_not", {"X": apply_cond},
                            {"Out": not_apply}, {})
            keep_f = ltensor.cast(not_apply, "float32")
            new_pg = []
            for p, g in params_grads:
                dtype = str(g.dtype)
                acc = block.create_var(
                    name=unique_name.generate("%s@GRAD_ACC" % p.name),
                    shape=p.shape, dtype=dtype, persistable=True)
                sp = sb.create_var(name=acc.name, shape=p.shape, dtype=dtype,
                                   persistable=True)
                sb.append_op("fill_constant", outputs={"Out": sp},
                             attrs={"shape": tuple(p.shape), "dtype": dtype,
                                    "value": 0.0})
                acc_sum = block.create_var(
                    name=unique_name.generate("%s@GRAD_ACC_SUM" % p.name),
                    shape=p.shape, dtype=dtype)
                rows = getattr(g, "sparse_rows_var", None)
                if rows is not None:
                    block.append_op("scatter",
                                    {"X": acc, "Ids": rows, "Updates": g},
                                    {"Out": acc_sum}, {"overwrite": False})
                else:
                    block.append_op("elementwise_add", {"X": acc, "Y": g},
                                    {"Out": acc_sum}, {})
                avg = lnn.scale(acc_sum, scale=1.0 / k)
                # write-back: keep the sum between apply steps, reset after
                block.append_op("elementwise_mul",
                                {"X": acc_sum, "Y": keep_f},
                                {"Out": block.vars[acc.name]}, {"axis": -1})
                new_pg.append((p, avg))
        return new_pg, apply_cond

    def _rescale_lr_decay_counter(self, block, k):
        """An LR schedule reads ``@LR_DECAY_COUNTER@``, which ticks once a
        run; under accumulation the reference's merged program ticks once
        every k micro-steps (``paddle_tpu/optimizer.py:200``). Every
        reader of the counter is rewired to ``counter // k``: micro-steps
        t*k .. t*k+k-1 all see effective step t, so the k-th one's apply
        takes the rate the merged step t would."""
        from .core.framework import Operator

        name = "@LR_DECAY_COUNTER@"
        if not any(name in op.output_arg_names for op in block.ops):
            return
        inc_idx = max(i for i, op in enumerate(block.ops)
                      if name in op.output_arg_names)
        counter = block.vars[name]
        kconst = block.create_var(name=unique_name.generate("lr_counter_k"),
                                  shape=(1,), dtype="int64")
        eff = block.create_var(name=unique_name.generate("lr_counter_eff"),
                               shape=(1,), dtype="int64")
        new_ops = [
            Operator(block, "fill_constant", None, {"Out": kconst},
                     {"shape": (1,), "dtype": "int64", "value": float(k)}),
            Operator(block, "elementwise_floordiv",
                     {"X": counter, "Y": kconst}, {"Out": eff}, {}),
        ]
        inc_op = block.ops[inc_idx]
        for j, op in enumerate(new_ops):
            block.ops.insert(inc_idx + 1 + j, op)
        for op in block.ops[inc_idx + 1 + len(new_ops):]:
            for slot, vs in op.inputs.items():
                op.inputs[slot] = [eff if v.name == name else v for v in vs]
        # the autodiff op's recorded forward list mirrors the insertion
        for op in block.ops:
            if op.type != "autodiff":
                continue
            fwd = op.attrs.get("fwd_ops") or []
            for i, f in enumerate(fwd):
                if f is inc_op:
                    op.attrs["fwd_ops"] = fwd[:i + 1] + new_ops + fwd[i + 1:]
                    break
        block.program._version += 1

    def apply_gradients(self, params_grads, accumulate_steps=None):
        apply_cond = None
        if accumulate_steps is not None and accumulate_steps > 1:
            params_grads, apply_cond = self._append_grad_accumulation(
                params_grads, int(accumulate_steps))
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        self._final_params_grads = params_grads
        block = params_grads[0][0].block.program.global_block()
        n0 = len(block.ops)
        ops = self._create_optimization_pass(params_grads)
        if apply_cond is not None:
            # every persistable write of the pass (the updates and
            # _finish_update's, such as Adamax's beta-pow scale) fires on
            # apply steps only
            for op in block.ops[n0:]:
                if any(getattr(v, "persistable", False)
                       for vs in op.outputs.values() for v in vs):
                    op.attrs["_switch_cond"] = apply_cond.name
        return ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, accumulate_steps=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_gradients(params_grads, accumulate_steps)
        # the post-clip/regularization pairs the update ops consume
        return optimize_ops, self._final_params_grads


class SGD(Optimizer):
    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "sgd",
            {"Param": p, "Grad": g, "LearningRate": self._lr_for(p)},
            {"ParamOut": p}, {})


class Momentum(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._add_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            {"Param": p, "Grad": g, "Velocity": v,
             "LearningRate": self._lr_for(p)},
            {"ParamOut": p, "VelocityOut": v},
            {"mu": self._momentum, "use_nesterov": self._use_nesterov})


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None,
                 lazy_mode=False):
        super().__init__(learning_rate, regularization, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lazy_mode = lazy_mode

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._add_accumulator("moment1", p)
        m2 = self._add_accumulator("moment2", p)
        b1p = self._add_accumulator("beta1_pow_acc", p, self._beta1,
                                    shape=(1,))
        b2p = self._add_accumulator("beta2_pow_acc", p, self._beta2,
                                    shape=(1,))
        return block.append_op(
            "adam",
            {"Param": p, "Grad": g, "Moment1": m1, "Moment2": m2,
             "Beta1Pow": b1p, "Beta2Pow": b2p,
             "LearningRate": self._lr_for(p)},
            {"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
             "Beta1PowOut": b1p, "Beta2PowOut": b2p},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon, "lazy_mode": self._lazy_mode})


class LarsMomentum(Optimizer):
    """LARS (ref ``lars_momentum_op.cc`` / LarsMomentumOptimizer)."""

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._add_accumulator("velocity", p)
        return block.append_op(
            "lars_momentum",
            {"Param": p, "Grad": g, "Velocity": v,
             "LearningRate": self._lr_for(p)},
            {"ParamOut": p, "VelocityOut": v},
            {"mu": self._momentum, "lars_coeff": self._lars_coeff,
             "lars_weight_decay": self._lars_weight_decay})


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, regularization=None,
                 name=None, initial_accumulator_value=0.0):
        super().__init__(learning_rate, regularization, name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._add_accumulator("moment", p, fill_value=self._init_acc)
        return block.append_op(
            "adagrad",
            {"Param": p, "Grad": g, "Moment": m,
             "LearningRate": self._lr_for(p)},
            {"ParamOut": p, "MomentOut": m}, {"epsilon": self._epsilon})


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._add_accumulator("moment", p)
        inf = self._add_accumulator("inf_norm", p)
        b1p = self._add_accumulator("beta1_pow_acc", p, self._beta1,
                                    shape=(1,))
        return block.append_op(
            "adamax",
            {"Param": p, "Grad": g, "Moment": m, "InfNorm": inf,
             "Beta1Pow": b1p, "LearningRate": self._lr_for(p)},
            {"ParamOut": p, "MomentOut": m, "InfNormOut": inf},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon})

    def _finish_update(self, block, params_grads):
        for p, _ in params_grads:
            b1p = self._get_accumulator("beta1_pow_acc", p)
            op = block.append_op("scale", {"X": b1p}, {"Out": b1p},
                                 {"scale": self._beta1})
            op.attrs["is_optimizer_op"] = True


class DecayedAdagrad(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._decay, self._epsilon = decay, epsilon

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._add_accumulator("moment", p)
        return block.append_op(
            "decayed_adagrad",
            {"Param": p, "Grad": g, "Moment": m,
             "LearningRate": self._lr_for(p)},
            {"ParamOut": p, "MomentOut": m},
            {"decay": self._decay, "epsilon": self._epsilon})


class Adadelta(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._epsilon, self._rho = epsilon, rho

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        g2 = self._add_accumulator("avg_squared_grad", p)
        u2 = self._add_accumulator("avg_squared_update", p)
        return block.append_op(
            "adadelta",
            {"Param": p, "Grad": g, "AvgSquaredGrad": g2,
             "AvgSquaredUpdate": u2, "LearningRate": self._lr_for(p)},
            {"ParamOut": p, "AvgSquaredGradOut": g2,
             "AvgSquaredUpdateOut": u2},
            {"epsilon": self._epsilon, "rho": self._rho})


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        ms = self._add_accumulator("mean_square", p)
        mg = self._add_accumulator("mean_grad", p)
        mom = self._add_accumulator("momentum", p)
        return block.append_op(
            "rmsprop",
            {"Param": p, "Grad": g, "MeanSquare": ms, "MeanGrad": mg,
             "Moment": mom, "LearningRate": self._lr_for(p)},
            {"ParamOut": p, "MeanSquareOut": ms, "MeanGradOut": mg,
             "MomentOut": mom},
            {"decay": self._rho, "epsilon": self._epsilon,
             "momentum": self._momentum, "centered": self._centered})


class Ftrl(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._add_accumulator("squared", p)
        lin = self._add_accumulator("linear", p)
        return block.append_op(
            "ftrl",
            {"Param": p, "Grad": g, "SquaredAccumulator": sq,
             "LinearAccumulator": lin, "LearningRate": self._lr_for(p)},
            {"ParamOut": p, "SquaredAccumOut": sq, "LinearAccumOut": lin},
            {"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power})


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, regularization=None,
                 name=None):
        super().__init__(learning_rate, regularization, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._wd = lamb_weight_decay

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._add_accumulator("moment1", p)
        m2 = self._add_accumulator("moment2", p)
        b1p = self._add_accumulator("beta1_pow_acc", p, self._beta1,
                                    shape=(1,))
        b2p = self._add_accumulator("beta2_pow_acc", p, self._beta2,
                                    shape=(1,))
        return block.append_op(
            "lamb",
            {"Param": p, "Grad": g, "Moment1": m1, "Moment2": m2,
             "Beta1Pow": b1p, "Beta2Pow": b2p,
             "LearningRate": self._lr_for(p)},
            {"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
             "Beta1PowOut": b1p, "Beta2PowOut": b2p},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon, "weight_decay": self._wd})


def _scope_of(scope):
    from .core.executor import global_scope

    return scope if scope is not None else global_scope()


def _copy_into(dst, src):
    """``dst`` takes ``src``'s values in place: a captured step bound to
    the scope's tensor keeps its binding."""
    with (torch.inference_mode() if dst.is_inference()
          else torch.no_grad()):
        dst.copy_(src)


class _SwapsParams:
    """``apply``/``restore`` of the averaging optimizers: the scope's
    parameters take :meth:`_averaged` in place, and get their own values
    back on ``restore`` (at the end of the block with ``need_restore``)."""

    def _averaged(self, scope, name):
        raise NotImplementedError

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True, scope=None):
        scope = _scope_of(scope)
        self._backup = {}
        for name in self._param_names:
            t = scope.get(name)
            self._backup[name] = t.detach().clone()
            _copy_into(t, self._averaged(scope, name).to(t.dtype))
        try:
            yield
        finally:
            if need_restore:
                self.restore(executor, scope)

    def restore(self, executor=None, scope=None):
        scope = _scope_of(scope)
        for name, saved in getattr(self, "_backup", {}).items():
            _copy_into(scope.get(name), saved)
        self._backup = {}


class ModelAverage(Optimizer, _SwapsParams):
    """Parameter averaging (``paddle_tpu/optimizer.py:513``; ref
    ``optimizer.py`` ModelAverage): ``_append_average_ops(program)``, after
    ``minimize``, keeps a running sum and count of every parameter as
    persistable state; ``apply()`` swaps each parameter for sum / count,
    ``restore()`` swaps back. The window arguments are accepted and, as
    in ``paddle_tpu``, unused: the average runs over every step."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        super().__init__(0.0, regularization, name)
        self._param_names = []

    def _append_average_ops(self, program):
        gb = program.global_block()
        ops = []
        for p in program.all_parameters():
            acc = self._add_accumulator("sum", p)
            cnt = self._add_accumulator("cnt", p, shape=(1,))
            ops.append(gb.append_op("elementwise_add", {"X": acc, "Y": p},
                                    {"Out": acc}, {"is_optimizer_op": True}))
            ops.append(gb.append_op("increment", {"X": cnt}, {"Out": cnt},
                                    {"step": 1.0, "is_optimizer_op": True}))
            self._param_names.append(p.name)
        return ops

    def _averaged(self, scope, name):
        acc = self._accumulators["sum"][name].name
        cnt = self._accumulators["cnt"][name].name
        return scope.get(acc) / scope.get(cnt).reshape(())

    def minimize(self, loss, **kwargs):
        raise TypeError("ModelAverage wraps another optimizer's program; "
                        "call _append_average_ops after minimize")


class ExponentialMovingAverage(_SwapsParams):
    """EMA of the parameters (``paddle_tpu/optimizer.py:541``): ``update``
    appends shadow = decay * shadow + (1 - decay) * param for every
    parameter, the shadows persistable and 0 at startup; ``apply()`` swaps
    each parameter for its shadow, ``restore()`` swaps back."""

    def __init__(self, decay=0.999, name=None):
        self._decay = decay
        self._name = name or "ema"
        self._shadows = {}
        self._param_names = []

    def update(self, program=None):
        from .layers import nn

        program = program or framework.default_main_program()
        gb = program.global_block()
        sb = framework.default_startup_program().global_block()
        for p in program.all_parameters():
            name = "%s.%s" % (p.name, self._name)
            shadow = gb.create_var(name=name, shape=p.shape,
                                   dtype=str(p.dtype), persistable=True)
            sp = sb.create_var(name=name, shape=p.shape, dtype=str(p.dtype),
                               persistable=True)
            sb.append_op("fill_constant", outputs={"Out": sp},
                         attrs={"shape": p.shape, "dtype": str(p.dtype),
                                "value": 0.0})
            gb.append_op("scale", {"X": shadow}, {"Out": shadow},
                         {"scale": self._decay, "is_optimizer_op": True})
            scaled_p = nn.scale(p, scale=1.0 - self._decay)
            gb.append_op("elementwise_add", {"X": shadow, "Y": scaled_p},
                         {"Out": shadow}, {"is_optimizer_op": True})
            self._shadows[p.name] = shadow
            self._param_names.append(p.name)

    def _averaged(self, scope, name):
        return scope.get(self._shadows[name].name)


# reference-style aliases
SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdagradOptimizer = Adagrad
AdamOptimizer = Adam
AdamaxOptimizer = Adamax
DecayedAdagradOptimizer = DecayedAdagrad
AdadeltaOptimizer = Adadelta
RMSPropOptimizer = RMSProp
FtrlOptimizer = Ftrl
LambOptimizer = Lamb
LarsMomentumOptimizer = LarsMomentum
