"""Dygraph optimizers (``paddle_tpu/dygraph/optimizer.py``; ref
``imperative`` mode's use of ``fluid.optimizer.*Optimizer(...).minimize
(loss)`` over tape gradients).

Tape-native: ``minimize(loss)`` runs ``loss.backward()`` (unless grads are
already populated), gives each parameter a new tensor holding its update
(out of place: a graph built before keeps the tensor it read, see
``base.py``), and clears gradients. Update rules mirror the static
kernels (``core/opimpl/optimizer_ops.py``); ``regularization=L2Decay(c)``
folds ``c * p`` into the grad like the static
``append_regularization_ops`` pass."""

import math

import torch

__all__ = ["SGDOptimizer", "AdamOptimizer", "MomentumOptimizer",
           "AdagradOptimizer", "LambOptimizer"]


class _DygraphOptimizer:
    def __init__(self, learning_rate, parameter_list, regularization=None):
        self._lr = learning_rate
        self._params = list(parameter_list)
        self._reg = regularization

    def _grad(self, p):
        g = p._grad
        if self._reg is not None:
            coeff = getattr(self._reg, "_coeff", 0.0)
            v = p._value.detach()
            if type(self._reg).__name__.startswith("L1"):
                g = g + coeff * torch.sign(v)
            else:
                g = g + coeff * v
        return g

    def minimize(self, loss, startup_program=None, parameter_list=None):
        if all(p._grad is None for p in self._params):
            loss.backward()
        with torch.no_grad():
            for p in self._params:
                if p._grad is None:
                    continue
                p._value = self._apply(p, p._value.detach())
        self.clear_gradients()

    def clear_gradients(self):
        for p in self._params:
            p.clear_gradient()


class SGDOptimizer(_DygraphOptimizer):
    def _apply(self, p, w):
        return w - self._lr * self._grad(p)


class MomentumOptimizer(_DygraphOptimizer):
    """Ref ``momentum_op.cc``: velocity accumulation (+ Nesterov)."""

    def __init__(self, learning_rate=1e-3, momentum=0.9,
                 use_nesterov=False, parameter_list=(),
                 regularization=None):
        super().__init__(learning_rate, parameter_list, regularization)
        self._mu = momentum
        self._nesterov = use_nesterov
        self._vel = {}

    def _apply(self, p, w):
        g = self._grad(p)
        v = self._vel.get(id(p))
        v = g if v is None else self._mu * v + g
        self._vel[id(p)] = v
        if self._nesterov:
            return w - self._lr * (g + self._mu * v)
        return w - self._lr * v


class AdagradOptimizer(_DygraphOptimizer):
    """Ref ``adagrad_op.cc``: accumulated squared grads."""

    def __init__(self, learning_rate=1e-2, epsilon=1e-6,
                 parameter_list=(), regularization=None):
        super().__init__(learning_rate, parameter_list, regularization)
        self._eps = epsilon
        self._acc = {}

    def _apply(self, p, w):
        g = self._grad(p)
        a = self._acc.get(id(p))
        a = g * g if a is None else a + g * g
        self._acc[id(p)] = a
        return w - self._lr * g / (torch.sqrt(a) + self._eps)


class _AdamMoments(_DygraphOptimizer):
    """The moments and step count Adam and Lamb share."""

    def __init__(self, learning_rate, beta1, beta2, epsilon, parameter_list,
                 regularization):
        super().__init__(learning_rate, parameter_list, regularization)
        self._b1, self._b2, self._eps = beta1, beta2, epsilon
        self._m = {}
        self._v = {}
        self._t = 0

    def minimize(self, loss, startup_program=None, parameter_list=None):
        self._t += 1
        super().minimize(loss, startup_program, parameter_list)

    def _moments(self, p):
        k = id(p)
        g = self._grad(p)
        m, v = self._m.get(k), self._v.get(k)
        m = (1 - self._b1) * g if m is None \
            else self._b1 * m + (1 - self._b1) * g
        v = (1 - self._b2) * g * g if v is None \
            else self._b2 * v + (1 - self._b2) * g * g
        self._m[k], self._v[k] = m, v
        return m, v


class AdamOptimizer(_AdamMoments):
    def __init__(self, learning_rate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameter_list=(), regularization=None):
        super().__init__(learning_rate, beta1, beta2, epsilon,
                         parameter_list, regularization)

    def _apply(self, p, w):
        m, v = self._moments(p)
        corr = math.sqrt(1 - self._b2 ** self._t) / (1 - self._b1 ** self._t)
        return w - self._lr * corr * m / (torch.sqrt(v) + self._eps)


class LambOptimizer(_AdamMoments):
    """LAMB (same rule as the static ``lamb`` kernel): adam direction +
    decoupled weight decay, scaled by the layer-wise trust ratio — the
    BERT-pretraining optimizer at large batch sizes."""

    def __init__(self, learning_rate=1e-3, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 parameter_list=(), regularization=None):
        super().__init__(learning_rate, beta1, beta2, epsilon,
                         parameter_list, regularization)
        self._wd = lamb_weight_decay

    def _apply(self, p, w):
        m, v = self._moments(p)
        m_hat = m / (1 - self._b1 ** self._t)
        v_hat = v / (1 - self._b2 ** self._t)
        r = m_hat / (torch.sqrt(v_hat) + self._eps) + self._wd * w
        p_norm = torch.linalg.vector_norm(w)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                            torch.ones_like(p_norm))
        return w - self._lr * trust * r
