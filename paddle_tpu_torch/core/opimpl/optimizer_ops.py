"""Optimizer update ops (``paddle_tpu/core/opimpl/optimizer_ops.py``: sgd,
momentum, lars_momentum, adam, adamax, adagrad, decayed_adagrad, adadelta,
rmsprop, ftrl, lamb; ref ``paddle/fluid/operators/optimizers/``). Each
op's Out slots alias the state var names; the Executor runs these ops
under ``torch.no_grad()`` and writes the new state back to the scope.
Every update makes new tensors: none writes into a parameter the tape or
the scope still holds.

Sparse (SelectedRows) gradients: when the op carries a ``GradRows`` input
(wired by ``Optimizer._create_optimization_pass`` for a table whose grad is
sparse), ``Grad`` holds one value row per id. Sparse SGD and the densify of
non-lazy Adam (the reference's default), LARS, Adamax, DecayedAdagrad,
Adadelta, RMSProp, Ftrl and Lamb are row scatter-adds through the port's
kernel (``ops/scatter.py``, where the reference's ``_densify`` takes its
Pallas kernel; the path it took is recorded in the op's
``_kernel_choice``). Momentum, Adagrad and lazy Adam merge the duplicate
rows and update only those rows (gather, then set), as the reference's
SelectedRows kernels do (``adam_op.h`` SparseAdamFunctor,
``adagrad_op.h`` SparseAdagradFunctor, ``sgd_op.h``).
"""

import torch

from ..op_registry import get, merge_sparse_rows, put, register


def _lr(env, op):
    lr = get(env, op.input("LearningRate"))
    return lr.reshape(()) if lr.dim() else lr


def _sparse_grad(env, op):
    """(grad, rows): rows is None for a dense grad."""
    g = get(env, op.input("Grad"))
    rv = op.input("GradRows")
    return g, (None if rv is None else env[rv.name])


def _densify(g, rows, p, op):
    """The dense grad of a (rows, values) grad: one scatter-add into zeros
    (duplicates accumulate, the sentinel and other out-of-range rows
    drop)."""
    from ...ops.scatter import scatter_add_rows

    return scatter_add_rows(torch.zeros_like(p), rows, g.to(p.dtype),
                            inplace=True, op=op)


def _dense_grad(env, op, p):
    """The op's grad, densified through the scatter-add when sparse."""
    g, rows = _sparse_grad(env, op)
    return g if rows is None else _densify(g, rows, p, op)


def _norm(t):
    return torch.sqrt(torch.sum(torch.square(t)))


def _merged(rows, g, p):
    """Duplicates merged (:func:`merge_sparse_rows`), then (index of every
    in-range row, its row ids, its summed values)."""
    rows_u, g_u = merge_sparse_rows(rows, g, p.shape[0])
    keep = (rows_u >= 0) & (rows_u < p.shape[0])
    idx = rows_u[keep].long()
    return idx, g_u[keep]


def _set_rows(t, idx, rows_val):
    out = t.clone()
    out[idx] = rows_val
    return out


@register("sparse_decay")
def _sparse_decay(env, op):
    """Row-wise weight decay on a sparse (rows, values) grad: values +=
    coeff * param[rows] (l2) or coeff * sign(param[rows]) (l1). Sentinel
    (out-of-range) rows, the merged duplicate and padding slots, stay
    zero."""
    g = get(env, op.input("Grad"))
    rows = env[op.input("Rows").name]
    p = get(env, op.input("Param"))
    valid = rows < p.shape[0]
    pr = p[torch.clamp(rows, 0, p.shape[0] - 1).long()]
    if op.attr("mode") == "l1":
        pr = torch.sign(pr)
    decay = op.attr("coeff") * pr * valid[:, None].to(g.dtype)
    put(env, op.output("Out"), g + decay)


@register("sgd")
def _sgd(env, op):
    p = get(env, op.input("Param"))
    g, rows = _sparse_grad(env, op)
    if rows is None:
        put(env, op.output("ParamOut"), p - _lr(env, op) * g)
        return
    # ref sgd_op.h SelectedRows branch: a scatter-add into a new table
    # (duplicates accumulate)
    from ...ops.scatter import scatter_add_rows

    put(env, op.output("ParamOut"),
        scatter_add_rows(p, rows, -_lr(env, op) * g, op=op))


@register("momentum")
def _momentum(env, op):
    p = get(env, op.input("Param"))
    g, rows = _sparse_grad(env, op)
    v = get(env, op.input("Velocity"))
    mu = op.attr("mu")
    lr = _lr(env, op)
    nesterov = op.attr("use_nesterov", False)
    if rows is not None:
        # touched rows only: their velocity and parameter move
        idx, g_u = _merged(rows, g, p)
        v_rows = mu * v[idx] + g_u
        upd = (g_u + mu * v_rows) * lr if nesterov else lr * v_rows
        put(env, op.output("ParamOut"), _set_rows(p, idx, p[idx] - upd))
        put(env, op.output("VelocityOut"), _set_rows(v, idx, v_rows))
        return
    v_new = mu * v + g
    if nesterov:
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    put(env, op.output("ParamOut"), p_new)
    put(env, op.output("VelocityOut"), v_new)


@register("adam")
def _adam(env, op):
    p = get(env, op.input("Param"))
    g, rows = _sparse_grad(env, op)
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
    put(env, op.output("Beta1PowOut"), (b1p * b1).reshape((1,)))
    put(env, op.output("Beta2PowOut"), (b2p * b2).reshape((1,)))
    if rows is not None and op.attr("lazy_mode", False):
        # ref SparseAdamFunctor (lazy_mode=true): only the touched rows'
        # moments advance; the pow accumulators advance every step
        idx, g_u = _merged(rows, g, p)
        m_rows = b1 * m[idx] + (1 - b1) * g_u
        v_rows = b2 * v[idx] + (1 - b2) * torch.square(g_u)
        p_rows = p[idx] - lr_t * m_rows / (torch.sqrt(v_rows) + eps)
        put(env, op.output("ParamOut"), _set_rows(p, idx, p_rows))
        put(env, op.output("Moment1Out"), _set_rows(m, idx, m_rows))
        put(env, op.output("Moment2Out"), _set_rows(v, idx, v_rows))
        return
    if rows is not None:
        # ref adam_op.h default (lazy_mode=false): the update runs over
        # EVERY row on the densified grad, the dense branch's math
        g = _densify(g.to(p.dtype), rows, p, op)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * torch.square(g)
    put(env, op.output("ParamOut"),
        p - lr_t * m_new / (torch.sqrt(v_new) + eps))
    put(env, op.output("Moment1Out"), m_new)
    put(env, op.output("Moment2Out"), v_new)


@register("lars_momentum")
def _lars_momentum(env, op):
    """LARS (ref ``lars_momentum_op.cc``): a layer-wise rate from the
    parameter's and the gradient's norms."""
    p = get(env, op.input("Param"))
    g = _dense_grad(env, op, p)
    v = get(env, op.input("Velocity"))
    mu = op.attr("mu")
    coeff = op.attr("lars_coeff", 0.001)
    wd = op.attr("lars_weight_decay", 0.0005)
    lr = _lr(env, op)
    p_norm, g_norm = _norm(p), _norm(g)
    local_lr = torch.where((p_norm > 0) & (g_norm > 0),
                           lr * coeff * p_norm / (g_norm + wd * p_norm
                                                  + 1e-12), lr)
    v_new = mu * v + local_lr * (g + wd * p)
    put(env, op.output("ParamOut"), p - v_new)
    put(env, op.output("VelocityOut"), v_new)


@register("adamax")
def _adamax(env, op):
    """Ref ``adamax_op.h``; the beta1 power advances in a ``scale`` op the
    optimizer appends after the updates (``Adamax._finish_update``)."""
    p = get(env, op.input("Param"))
    g = _dense_grad(env, op, p)
    m = get(env, op.input("Moment"))
    inf_norm = get(env, op.input("InfNorm"))
    b1p = get(env, op.input("Beta1Pow")).reshape(())
    b1 = op.attr("beta1", 0.9)
    b2 = op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    inf_new = torch.maximum(b2 * inf_norm, torch.abs(g) + eps)
    lr_t = _lr(env, op) / (1 - b1p)
    put(env, op.output("ParamOut"), p - lr_t * m_new / inf_new)
    put(env, op.output("MomentOut"), m_new)
    put(env, op.output("InfNormOut"), inf_new)


@register("adagrad")
def _adagrad(env, op):
    p = get(env, op.input("Param"))
    g, rows = _sparse_grad(env, op)
    mom = get(env, op.input("Moment"))
    eps = op.attr("epsilon", 1e-6)
    lr = _lr(env, op)
    if rows is not None:
        # ref adagrad_op.h SparseAdagradFunctor: merge the rows, update
        # only the touched ones; nothing densifies
        idx, g_u = _merged(rows, g.to(p.dtype), p)
        mom_rows = mom[idx] + torch.square(g_u)
        p_rows = p[idx] - lr * g_u / (torch.sqrt(mom_rows) + eps)
        put(env, op.output("ParamOut"), _set_rows(p, idx, p_rows))
        put(env, op.output("MomentOut"), _set_rows(mom, idx, mom_rows))
        return
    mom_new = mom + torch.square(g)
    put(env, op.output("ParamOut"),
        p - lr * g / (torch.sqrt(mom_new) + eps))
    put(env, op.output("MomentOut"), mom_new)


@register("decayed_adagrad")
def _decayed_adagrad(env, op):
    p = get(env, op.input("Param"))
    g = _dense_grad(env, op, p)
    mom = get(env, op.input("Moment"))
    decay = op.attr("decay", 0.95)
    eps = op.attr("epsilon", 1e-6)
    mom_new = decay * mom + (1 - decay) * torch.square(g)
    put(env, op.output("ParamOut"),
        p - _lr(env, op) * g / (torch.sqrt(mom_new) + eps))
    put(env, op.output("MomentOut"), mom_new)


@register("adadelta")
def _adadelta(env, op):
    p = get(env, op.input("Param"))
    g = _dense_grad(env, op, p)
    avg_sq_g = get(env, op.input("AvgSquaredGrad"))
    avg_sq_u = get(env, op.input("AvgSquaredUpdate"))
    rho = op.attr("rho", 0.95)
    eps = op.attr("epsilon", 1e-6)
    g2 = rho * avg_sq_g + (1 - rho) * torch.square(g)
    upd = torch.sqrt(avg_sq_u + eps) / torch.sqrt(g2 + eps) * g
    u2 = rho * avg_sq_u + (1 - rho) * torch.square(upd)
    put(env, op.output("ParamOut"), p - upd)
    put(env, op.output("AvgSquaredGradOut"), g2)
    put(env, op.output("AvgSquaredUpdateOut"), u2)


@register("rmsprop")
def _rmsprop(env, op):
    p = get(env, op.input("Param"))
    g = _dense_grad(env, op, p)
    ms = get(env, op.input("MeanSquare"))
    mom = get(env, op.input("Moment"))
    rho = op.attr("decay", 0.95)
    eps = op.attr("epsilon", 1e-6)
    ms_new = rho * ms + (1 - rho) * torch.square(g)
    if op.attr("centered", False):
        mg_new = rho * get(env, op.input("MeanGrad")) + (1 - rho) * g
        denom = torch.sqrt(ms_new - torch.square(mg_new) + eps)
        put(env, op.output("MeanGradOut"), mg_new)
    else:
        denom = torch.sqrt(ms_new + eps)
    mom_new = op.attr("momentum", 0.0) * mom + _lr(env, op) * g / denom
    put(env, op.output("ParamOut"), p - mom_new)
    put(env, op.output("MeanSquareOut"), ms_new)
    put(env, op.output("MomentOut"), mom_new)


@register("ftrl")
def _ftrl(env, op):
    p = get(env, op.input("Param"))
    g = _dense_grad(env, op, p)
    sq = get(env, op.input("SquaredAccumulator"))
    lin = get(env, op.input("LinearAccumulator"))
    l1 = op.attr("l1", 0.0)
    l2 = op.attr("l2", 0.0)
    lr_power = op.attr("lr_power", -0.5)
    lr = _lr(env, op)
    new_sq = sq + torch.square(g)
    if lr_power == -0.5:
        root_new, root_old = torch.sqrt(new_sq), torch.sqrt(sq)
    else:
        root_new = torch.pow(new_sq, -lr_power)
        root_old = torch.pow(sq, -lr_power)
    sigma = (root_new - root_old) / lr
    new_lin = lin + g - sigma * p
    denom = root_new / lr + 2 * l2
    pre_shrink = (l1 * torch.sign(new_lin) - new_lin) / denom
    put(env, op.output("ParamOut"),
        torch.where(torch.abs(new_lin) > l1, pre_shrink,
                    torch.zeros_like(p)))
    put(env, op.output("SquaredAccumOut"), new_sq)
    put(env, op.output("LinearAccumOut"), new_lin)


@register("lamb")
def _lamb(env, op):
    """LAMB (``paddle_tpu``'s ``optimizer_ops.py:332``): Adam's moments,
    a decoupled weight decay and a per-tensor trust ratio."""
    p = get(env, op.input("Param"))
    g = _dense_grad(env, op, p)
    m = get(env, op.input("Moment1"))
    v = get(env, op.input("Moment2"))
    b1p = get(env, op.input("Beta1Pow")).reshape(())
    b2p = get(env, op.input("Beta2Pow")).reshape(())
    b1 = op.attr("beta1", 0.9)
    b2 = op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-6)
    wd = op.attr("weight_decay", 0.01)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * torch.square(g)
    r = (m_new / (1 - b1p)) / (torch.sqrt(v_new / (1 - b2p)) + eps) + wd * p
    p_norm, r_norm = _norm(p), _norm(r)
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        torch.ones_like(p_norm))
    put(env, op.output("ParamOut"), p - _lr(env, op) * trust * r)
    put(env, op.output("Moment1Out"), m_new)
    put(env, op.output("Moment2Out"), v_new)
    put(env, op.output("Beta1PowOut"), (b1p * b1).reshape((1,)))
    put(env, op.output("Beta2PowOut"), (b2p * b2).reshape((1,)))
