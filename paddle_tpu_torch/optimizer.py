"""Optimizers (ref ``python/paddle/fluid/optimizer.py``: Optimizer base
``:44``, ``minimize:357`` = append_backward + apply_gradients; the port's
copy of ``paddle_tpu/optimizer.py``).

Each optimizer appends symbolic update ops whose Out slots alias the state
var names; the Executor runs them under ``torch.no_grad()`` and writes the
new state back to the scope. Accumulators (velocity, moments, beta powers)
are persistable vars the startup program fills with constants, as the
reference's ``_add_accumulator`` does. A parameter with a sparse (rows,
values) grad gets its rows var wired to the update op as ``GradRows``.
This slice carries SGD, Momentum and Adam (dense and sparse); the other
optimizers and gradient accumulation come later.
"""

from .backward import append_backward
from .clip import append_gradient_clip_ops
from .core import framework, unique_name
from .core.framework import Parameter, Variable
from .regularizer import append_regularization_ops

__all__ = ["SGD", "Momentum", "Adam", "SGDOptimizer", "MomentumOptimizer",
           "AdamOptimizer"]


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
        return ops

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads, accumulate_steps=None):
        if accumulate_steps is not None and accumulate_steps > 1:
            raise NotImplementedError(
                "gradient accumulation (accumulate_steps > 1) is not ported "
                "to paddle_tpu_torch yet")
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        self._final_params_grads = params_grads
        return self._create_optimization_pass(params_grads)

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


# reference-style aliases
SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdamOptimizer = Adam
