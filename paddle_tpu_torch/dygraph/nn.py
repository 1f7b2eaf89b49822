"""Dygraph layers (``paddle_tpu/dygraph/nn.py``; ref
``python/paddle/fluid/imperative/nn.py``: Conv2D, Pool2D, FC, BatchNorm,
Embedding + extras needed by BERT). Each forward records one pure torch
function over its input and parameter tensors (``base.record``); the
running statistics and power-iteration buffers are written in place, so a
captured step advances them as an eager one does."""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.initializer import (ConstantInitializer, NormalInitializer,
                                XavierInitializer)
from .base import (VarBase, current_device, draw_generator, record,
                   to_variable)
from .layers import Layer

__all__ = ["FC", "Linear", "Conv2D", "Conv2DTranspose", "Pool2D",
           "BatchNorm", "GroupNorm", "SpectralNorm", "Embedding",
           "LayerNorm", "Dropout", "PRelu", "GRUUnit",
           "BilinearTensorProduct", "NCE"]

# jax.nn's activations by name, in torch
_ACTS = {"relu": torch.relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid,
         "softmax": lambda x: torch.softmax(x, dim=-1),
         "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
         "elu": F.elu, "softplus": F.softplus, "silu": F.silu,
         "swish": F.silu, "relu6": F.relu6, "leaky_relu": F.leaky_relu,
         "log_sigmoid": F.logsigmoid, "exp": torch.exp, "abs": torch.abs,
         "sqrt": torch.sqrt, "square": torch.square}


# jax.nn.gelu(approximate=True)'s constants, sqrt(2 / pi) and 0.044715, as
# a bf16 computation holds them
_GELU_C1, _GELU_C2 = 0.796875, 0.044677734375


def _gelu_tanh_parts(q):
    """``jax.nn.gelu(q, approximate=True)`` for a bf16 ``q`` as XLA computes
    it: op by op in bf16 (``q ** 3`` as ``(q * q) * q``), the constants
    rounded to bf16. Returns the output, the cdf factor and the tanh."""
    v = torch.tanh(_GELU_C1 * (q + _GELU_C2 * (q * q * q)))
    x = 0.5 * (1.0 + v)
    return q * x, x, v


def gelu_tanh_bf16_vjp(q, h):
    """JAX's VJP of :func:`_gelu_tanh_parts` at ``q`` for the cotangent
    ``h``, op by op in bf16 as its transposed JVP rules run: tanh's ``(g
    + g * t) * (1 - t)``, ``integer_pow``'s ``g * (3 * q ** 2)``."""
    _, x, v = _gelu_tanh_parts(q)
    l = (0.5 * (q * h)) * (1.0 - v)
    o = _GELU_C1 * (l + l * v)
    return (h * x + o) + (_GELU_C2 * o) * (3.0 * (q * q))


class _GeluTanhBf16(torch.autograd.Function):
    """The bf16 tanh gelu with the reference's rounding points, forward
    and backward (the cdf recomputed from the saved input)."""

    @staticmethod
    def forward(ctx, q):
        ctx.save_for_backward(q)
        return _gelu_tanh_parts(q)[0]

    @staticmethod
    def backward(ctx, h):
        q, = ctx.saved_tensors
        return gelu_tanh_bf16_vjp(q, h.to(q.dtype))


def gelu_tanh_bf16(q):
    return _GeluTanhBf16.apply(q)


class _TanhBf16(torch.autograd.Function):
    """tanh with JAX's gradient for a bf16 input, op by op in bf16: its
    JVP ``(g + g * t) * (1 - t)`` transposed, ``l + l * t`` with ``l = g *
    (1 - t)`` (torch's ``g * (1 - t * t)`` rounds once and elsewhere)."""

    @staticmethod
    def forward(ctx, x):
        t = torch.tanh(x)
        ctx.save_for_backward(t)
        return t

    @staticmethod
    def backward(ctx, g):
        t, = ctx.saved_tensors
        l = g.to(t.dtype) * (1.0 - t)
        return l + l * t


def _act(name, out):
    if not name:
        return out
    if name == "gelu":
        # tanh-approx for bf16 activations, matching the static AMP
        # policy (paddle_tpu's opimpl/math_ops.py:_gelu)
        if out.dtype == torch.bfloat16:
            return gelu_tanh_bf16(out)
        return F.gelu(out, approximate="none")
    if name == "tanh" and out.dtype == torch.bfloat16:
        return _TanhBf16.apply(out)
    if name not in _ACTS:
        raise ValueError("unknown activation %r" % name)
    return _ACTS[name](out)


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


class FC(Layer):
    def __init__(self, name_scope=None, size=None, input_dim=None,
                 num_flatten_dims=1, act=None, param_attr=None,
                 bias_attr=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._size = size
        self._num_flatten_dims = num_flatten_dims
        self._act = act
        self._input_dim = input_dim
        self._w = None
        self._b = None

    def _build_once(self, input_dim):
        self._w = self.create_parameter([input_dim, self._size])
        self._b = self.create_parameter([self._size], is_bias=True)

    def forward(self, x):
        x = to_variable(x)
        flat_in = int(np.prod(x.shape[self._num_flatten_dims:]))
        if self._w is None:
            self._build_once(flat_in)
        act, size, nfd = self._act, self._size, self._num_flatten_dims

        def fn(xv, w, b):
            if xv.dtype == torch.bfloat16:  # compute follows activation
                w, b = w.to(xv.dtype), b.to(xv.dtype)
            xv2 = xv.reshape(int(np.prod(xv.shape[:nfd])), -1)
            out = (xv2 @ w + b).reshape(tuple(xv.shape[:nfd]) + (size,))
            return _act(act, out)

        return record(fn, x, self._w, self._b)


Linear = FC


class Conv2D(Layer):
    def __init__(self, name_scope=None, num_channels=None, num_filters=None,
                 filter_size=3, stride=1, padding=0, dilation=1, groups=1,
                 act=None, dtype="float32", **kw):
        super().__init__(name_scope, dtype)
        k = _pair(filter_size)
        self._stride, self._padding = _pair(stride), _pair(padding)
        self._dilation = _pair(dilation)
        self._groups = groups
        self._act = act
        std = math.sqrt(2.0 / (k[0] * k[1] * num_channels))
        self._filter = self.create_parameter(
            [num_filters, num_channels // groups, k[0], k[1]],
            initializer=NormalInitializer(0.0, std))
        self._bias = self.create_parameter([num_filters], is_bias=True)

    def forward(self, x):
        stride, pad, dil = self._stride, self._padding, self._dilation
        groups, act = self._groups, self._act

        def fn(xv, w, b):
            out = F.conv2d(xv, w, None, stride, pad, dil, groups)
            out = out + b.reshape(1, -1, 1, 1)
            return torch.relu(out) if act == "relu" else out

        return record(fn, to_variable(x), self._filter, self._bias)


class Pool2D(Layer):
    def __init__(self, name_scope=None, pool_size=2, pool_type="max",
                 pool_stride=2, pool_padding=0, global_pooling=False,
                 dtype="float32", **kw):
        super().__init__(name_scope, dtype)
        self._size = _pair(pool_size)
        self._stride = _pair(pool_stride)
        self._padding = _pair(pool_padding)
        self._type = pool_type
        self._global = global_pooling

    def forward(self, x):
        size, stride, pad = self._size, self._stride, self._padding
        gpool, ptype = self._global, self._type

        def fn(xv):
            if gpool:
                if ptype == "max":
                    return xv.amax(dim=(2, 3), keepdim=True)
                return xv.mean(dim=(2, 3), keepdim=True)
            if ptype == "max":  # padding counts as -inf
                return F.max_pool2d(xv, size, stride, pad)
            # the window's sum over the whole window, padding included
            return F.avg_pool2d(xv, size, stride, pad,
                                count_include_pad=True)

        return record(fn, to_variable(x))


class BatchNorm(Layer):
    def __init__(self, name_scope=None, num_channels=None, act=None,
                 momentum=0.9, epsilon=1e-5, dtype="float32", **kw):
        super().__init__(name_scope, dtype)
        c = num_channels
        self._scale = self.create_parameter(
            [c], initializer=ConstantInitializer(1.0))
        self._bias = self.create_parameter([c], is_bias=True)
        dev = self._scale.value().device
        self._mean = VarBase(torch.zeros(c, device=dev), stop_gradient=True,
                             name=self._full_name + ".mean")
        self._var = VarBase(torch.ones(c, device=dev), stop_gradient=True,
                            name=self._full_name + ".var")
        self._momentum = momentum
        self._eps = epsilon
        self._act = act

    def forward(self, x):
        x = to_variable(x)
        xv = x.value()
        cshape = (1, -1) + (1,) * (xv.dim() - 2)
        eps, act, mom = self._eps, self._act, self._momentum
        if self.training:
            # the eager stats here feed ONLY the running-average update
            # (in place); the taped fn recomputes them for its gradient
            axes = tuple(i for i in range(xv.dim()) if i != 1)
            with torch.no_grad():
                mu = xv.mean(dim=axes)
                var = xv.var(dim=axes, unbiased=False)
                self._mean.value().mul_(mom).add_((1 - mom) * mu)
                self._var.value().mul_(mom).add_((1 - mom) * var)

            def fn(xv_, scale, bias):
                m = xv_.mean(dim=axes)
                v = xv_.var(dim=axes, unbiased=False)
                out = (xv_ - m.reshape(cshape)) * torch.rsqrt(
                    v.reshape(cshape) + eps)
                out = out * scale.reshape(cshape) + bias.reshape(cshape)
                return torch.relu(out) if act == "relu" else out

            return record(fn, x, self._scale, self._bias)

        def fn(xv_, scale, bias, mu, var):
            out = (xv_ - mu.reshape(cshape)) * torch.rsqrt(
                var.reshape(cshape) + eps)
            out = out * scale.reshape(cshape) + bias.reshape(cshape)
            return torch.relu(out) if act == "relu" else out

        return record(fn, x, self._scale, self._bias,
                      self._mean.value(), self._var.value())


class LayerNorm(Layer):
    def __init__(self, name_scope=None, normalized_shape=None, epsilon=1e-5,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._shape = list(normalized_shape)
        self._scale = self.create_parameter(
            self._shape, initializer=ConstantInitializer(1.0))
        self._bias = self.create_parameter(self._shape, is_bias=True)
        self._eps = epsilon

    def forward(self, x):
        x = to_variable(x)
        nshape, eps = len(self._shape), self._eps

        def fn(xv, scale, bias):
            in_dtype = xv.dtype
            if in_dtype == torch.bfloat16:  # f32 stats, bf16-resident out
                xv = xv.float()
            axes = tuple(range(xv.dim() - nshape, xv.dim()))
            mu = xv.mean(dim=axes, keepdim=True)
            var = xv.var(dim=axes, unbiased=False, keepdim=True)
            out = (xv - mu) * torch.rsqrt(var + eps) * scale + bias
            return out.to(in_dtype)

        return record(fn, x, self._scale, self._bias)


class Embedding(Layer):
    def __init__(self, name_scope=None, size=None, is_sparse=False,
                 padding_idx=None, dtype="float32", **kw):
        super().__init__(name_scope, dtype)
        self._size = size
        self._padding_idx = padding_idx
        self._w = self.create_parameter(
            list(size), initializer=XavierInitializer())

    def forward(self, ids):
        pad_idx = self._padding_idx

        def fn(iv, w):
            if iv.dim() >= 2 and iv.shape[-1] == 1:
                iv = iv.squeeze(-1)
            out = F.embedding(iv.to(torch.int64), w)
            if pad_idx is not None:
                out = out * (iv != pad_idx)[..., None].to(out.dtype)
            return out

        # integer ids carry no gradient; mark a LOCAL copy, never the
        # caller's VarBase
        ids = VarBase(to_variable(ids).value(), stop_gradient=True)
        return record(fn, ids, self._w)


class Dropout(Layer):
    _SEED = 1234

    def __init__(self, name_scope=None, p=0.5):
        super().__init__(name_scope)
        self._p = p

    def forward(self, x):
        x = to_variable(x)
        if not self.training or self._p == 0.0:
            return x
        p = self._p
        xv = x.value()
        gen = draw_generator(Dropout, xv.device, Dropout._SEED)
        keep = torch.rand(xv.shape, generator=gen, device=xv.device) \
            < (1.0 - p)

        def fn(v):
            return v * keep / (1.0 - p)

        return record(fn, x)


class PRelu(Layer):
    def __init__(self, name_scope=None, mode="all", dtype="float32"):
        super().__init__(name_scope, dtype)
        self._alpha = self.create_parameter(
            [1], initializer=ConstantInitializer(0.25))

    def forward(self, x):
        return record(lambda xv, a: torch.where(xv > 0, xv, a * xv),
                      to_variable(x), self._alpha)


class Conv2DTranspose(Layer):
    """Ref ``imperative/nn.py``-era Conv2DTranspose wrapping
    ``conv2d_transpose_op`` (IOHW kernel layout, as
    ``F.conv_transpose2d`` reads it; the port's ``conv2d_transpose`` op,
    ``core/opimpl/nn_ops.py``, computes it the same way)."""

    def __init__(self, name_scope=None, num_channels=None, num_filters=None,
                 filter_size=3, stride=1, padding=0, act=None,
                 dtype="float32", **kw):
        super().__init__(name_scope, dtype)
        self._stride, self._pad = _pair(stride), _pair(padding)
        self._act = act
        fs = _pair(filter_size)
        self._w = self.create_parameter(
            [num_channels, num_filters, fs[0], fs[1]])
        self._b = self.create_parameter([num_filters], is_bias=True)

    def forward(self, x):
        s, p, act = self._stride, self._pad, self._act

        def fn(xv, w, b):
            out = F.conv_transpose2d(xv, w, None, s, p)
            return _act(act, out + b.reshape(1, -1, 1, 1))

        return record(fn, to_variable(x), self._w, self._b)


class GroupNorm(Layer):
    """Ref ``group_norm_op`` as a module (NCHW)."""

    def __init__(self, name_scope=None, channels=None, groups=1,
                 epsilon=1e-5, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._groups = groups
        self._eps = epsilon
        self._scale = self.create_parameter(
            [channels], initializer=ConstantInitializer(1.0))
        self._bias = self.create_parameter([channels], is_bias=True)

    def forward(self, x):
        g, eps = self._groups, self._eps

        def fn(xv, scale, bias):
            n, c = xv.shape[0], xv.shape[1]
            xg = xv.reshape((n, g, c // g) + tuple(xv.shape[2:]))
            axes = tuple(range(2, xg.dim()))
            mu = xg.mean(dim=axes, keepdim=True)
            var = xg.var(dim=axes, unbiased=False, keepdim=True)
            y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(xv.shape)
            cshape = (1, c) + (1,) * (xv.dim() - 2)
            return y * scale.reshape(cshape) + bias.reshape(cshape)

        return record(fn, to_variable(x), self._scale, self._bias)


class SpectralNorm(Layer):
    """Ref ``spectral_norm_op``: weight / sigma_max via power iteration
    (u, v buffers advance in place per call, matching the op's in-place
    U/V update)."""

    _SEED = 17

    def __init__(self, name_scope=None, weight_shape=None, dim=0,
                 power_iters=1, eps=1e-12, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._dim = dim
        self._iters = power_iters
        self._eps = eps
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        # U/V are NO-GRAD buffers (ref spectral_norm_op: persistable state
        # advanced by the kernel, never optimizer-updated)
        gen = torch.Generator().manual_seed(SpectralNorm._SEED)
        dev = current_device()
        self._u = torch.randn(h, generator=gen).to(dev)
        self._v = torch.randn(w, generator=gen).to(dev)

    def forward(self, weight):
        weight = to_variable(weight)
        dim, iters, eps = self._dim, self._iters, self._eps
        # power iteration with the CURRENT buffers; sigma's u, v are
        # constants w.r.t. the gradient (the reference grad kernel treats
        # them as fixed vectors), so they enter fn by closure
        with torch.no_grad():
            wv = weight.value()
            wm0 = torch.movedim(wv, dim, 0).reshape(wv.shape[dim], -1)
            u, v = self._u, self._v
            for _ in range(iters):
                v = wm0.t() @ u
                v = v / (torch.linalg.vector_norm(v) + eps)
                u = wm0 @ v
                u = u / (torch.linalg.vector_norm(u) + eps)
            self._u.copy_(u)
            self._v.copy_(v)
            u, v = self._u.clone(), self._v.clone()

        def fn(w_in):
            wm = torch.movedim(w_in, dim, 0).reshape(w_in.shape[dim], -1)
            sigma = u @ wm @ v
            return w_in / sigma

        return record(fn, weight)


class BilinearTensorProduct(Layer):
    """Ref ``bilinear_tensor_product_op``: out_k = x^T W_k y + b_k."""

    def __init__(self, name_scope=None, input1_dim=None, input2_dim=None,
                 output_dim=None, act=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._act = act
        self._w = self.create_parameter(
            [output_dim, input1_dim, input2_dim])
        self._b = self.create_parameter([output_dim], is_bias=True)

    def forward(self, x, y):
        act = self._act

        def fn(xv, yv, w, b):
            out = torch.einsum("bi,kij,bj->bk", xv, w, yv) + b
            return _act(act, out)

        return record(fn, to_variable(x), to_variable(y), self._w, self._b)


class NCE(Layer):
    """Ref ``imperative`` NCE wrapping ``nce_op``: noise-contrastive loss
    with uniform negative sampling."""

    _SEED = 4321

    def __init__(self, name_scope=None, num_total_classes=None, dim=None,
                 num_neg_samples=10, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._n_classes = num_total_classes
        self._n_neg = num_neg_samples
        self._w = self.create_parameter([num_total_classes, dim])
        self._b = self.create_parameter([num_total_classes], is_bias=True)

    def forward(self, x, label):
        n_cls, n_neg = self._n_classes, self._n_neg
        x = to_variable(x)
        dev = x.value().device
        # own eager stream, independent of Dropout's
        gen = draw_generator(NCE, dev, NCE._SEED)
        neg = torch.randint(0, n_cls, (x.shape[0], n_neg), generator=gen,
                            device=dev)
        label = VarBase(to_variable(label).value(), stop_gradient=True)

        def fn(xv, lv, w, b):
            lv = lv.reshape(-1).to(torch.int64)
            pos_logit = (xv * w[lv]).sum(dim=-1) + b[lv]
            neg_logit = torch.einsum("bd,bnd->bn", xv, w[neg]) + b[neg]
            # uniform noise distribution q = 1/n_classes
            log_q = -math.log(float(n_cls))
            pos_loss = -F.logsigmoid(pos_logit - log_q)
            neg_loss = -F.logsigmoid(-(neg_logit - log_q)).sum(dim=-1)
            return (pos_loss + neg_loss).reshape(-1, 1)

        return record(fn, x, label, self._w, self._b)


class GRUUnit(Layer):
    """Single-step GRU cell (ref ``imperative/nn.py`` GRUUnit wrapping
    ``gru_unit_op``): gates from [x_t | h_{t-1}]."""

    def __init__(self, name_scope=None, size=None, dtype="float32", **kw):
        super().__init__(name_scope, dtype)
        # size is 3*hidden (the reference convention)
        self._hidden = size // 3
        self._gate_w = None
        self._cand_w = None

    def _build_once(self, input_dim):
        h = self._hidden
        self._gate_w = self.create_parameter([input_dim + h, 2 * h])
        self._gate_b = self.create_parameter([2 * h], is_bias=True)
        self._cand_w = self.create_parameter([input_dim + h, h])
        self._cand_b = self.create_parameter([h], is_bias=True)

    def forward(self, x, hidden):
        x = to_variable(x)
        hidden = to_variable(hidden)
        if self._gate_w is None:
            self._build_once(x.shape[-1])
        h = self._hidden

        # the gate projection is computed ONCE; hidden/reset_pre are taped
        # children of the shared gate node (reference GRUUnit's 3-output
        # contract: updated_hidden, reset_hidden_pre, gate)
        gate = record(
            lambda xv, hv, gw, gb: torch.sigmoid(
                torch.cat([xv, hv], dim=-1) @ gw + gb),
            x, hidden, self._gate_w, self._gate_b)

        def fn_hidden(g, xv, hv, cw, cb):
            u, r = g[..., :h], g[..., h:]
            cat_r = torch.cat([xv, r * hv], dim=-1)
            c = torch.tanh(cat_r @ cw + cb)
            return u * hv + (1.0 - u) * c

        out = record(fn_hidden, gate, x, hidden, self._cand_w,
                     self._cand_b)
        reset_pre = record(lambda g, hv: g[..., h:] * hv, gate, hidden)
        return out, reset_pre, gate
