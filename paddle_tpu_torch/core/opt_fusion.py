"""Batched ("foreach") optimizer updates (the port's copy of
``paddle_tpu/core/opt_fusion.py``).

The reference runs one CUDA kernel per parameter update (``operators/
optimizers/adam_op.h`` etc.); the port's per-op ``adam`` launches about ten
elementwise kernels per parameter, each a host round trip. This pass
groups the dense update ops of one family and one set of hyperparameters
and runs each group at once. ``paddle_tpu`` takes the ravel+concat of the
members' operands and splits the result back; here the same arithmetic
runs as PyTorch's multi-tensor ``torch._foreach_*`` ops over the members'
own tensors, so there is no concat and no split copy. Parameters stay
individual vars, so no Program or checkpoint format changes.

Only dense ops fuse; SelectedRows (``GradRows``) updates keep their
scatter kernels, and a Switch-guarded update (``_switch_cond``) keeps its
own op. The Executor runs the plan behind ``PADDLE_TPU_FUSED_OPT`` (off by
default, as in the reference).
"""

import torch

__all__ = ["plan_opt_fusion", "run_fused_group"]

_FUSIBLE = ("sgd", "momentum", "adam")


def plan_opt_fusion(ops):
    """Return (plan, skip): ``plan`` maps trigger op index -> member op
    list (executed batched at that index); ``skip`` is the set of member
    indices the main loop must not run individually."""
    groups = {}
    for i, op in enumerate(ops):
        if op.type not in _FUSIBLE or not op.attrs.get("is_optimizer_op"):
            continue
        if op.input("GradRows") is not None:
            continue
        if op.attrs.get("_switch_cond") is not None:
            # Switch-guarded update: run_op's conditional output revert
            # must apply, which the batched path would bypass
            continue
        lr = op.input("LearningRate")
        key = (op.type, lr.name if lr is not None else None,
               op.attr("beta1", None), op.attr("beta2", None),
               op.attr("epsilon", None), op.attr("mu", None),
               op.attr("use_nesterov", None))
        groups.setdefault(key, []).append((i, op))

    plan, skip = {}, set()
    for members in groups.values():
        if len(members) < 2:
            continue
        idxs = [i for i, _ in members]
        lo, hi = min(idxs), max(idxs)
        # safety: an op between the members must not read a member's
        # output (it would observe the pre-update value once batched) NOR
        # write a member's input or output (the deferred member would
        # observe the post-write value instead of its program-order one)
        outs, ins = set(), set()
        for _, op in members:
            for vs in op.outputs.values():
                outs.update(v.name for v in vs)
            for vs in op.inputs.values():
                ins.update(v.name for v in vs)
        member_set = set(idxs)
        hazard = False
        for j in range(lo, hi):
            if j in member_set:
                continue
            for vs in ops[j].inputs.values():
                if any(v.name in outs for v in vs):
                    hazard = True
                    break
            for vs in ops[j].outputs.values():
                if any(v.name in outs or v.name in ins for v in vs):
                    hazard = True
                    break
            if hazard:
                break
        if hazard:
            continue
        plan[hi] = [op for _, op in members]
        skip.update(i for i in idxs if i != hi)
    return plan, skip


def _gather(env, ops, slot, dtype=None):
    from .op_registry import get

    xs = [get(env, op.input(slot)) for op in ops]
    if dtype is None:
        return xs
    return [x if x.dtype == dtype else x.to(dtype) for x in xs]


def _put(env, ops, slot, values):
    for op, v in zip(ops, values):
        env[op.output(slot).name] = v


def run_fused_group(env, ops):
    """Execute one planned group batched. Members were validated dense and
    hyperparameter-identical by ``plan_opt_fusion``. Each step is one
    ``torch._foreach_*`` op over the members, in the per-op order of
    operations of ``opimpl/optimizer_ops.py``."""
    from .op_registry import get

    kind = ops[0].type
    # sub-group by parameter dtype (the multi-tensor ops take one dtype;
    # update math runs in it, matching the per-op promotion rules)
    by_dtype = {}
    for op in ops:
        p = get(env, op.input("Param"))
        by_dtype.setdefault(p.dtype, []).append(op)

    for dtype, grp in by_dtype.items():
        ps = _gather(env, grp, "Param")
        gs = _gather(env, grp, "Grad", dtype)
        lr = get(env, grp[0].input("LearningRate")).reshape(()).to(dtype)

        if kind == "sgd":
            _put(env, grp, "ParamOut",
                 torch._foreach_sub(ps, torch._foreach_mul(gs, lr)))
        elif kind == "momentum":
            mu = grp[0].attr("mu")
            vs = _gather(env, grp, "Velocity")
            v_new = torch._foreach_add(torch._foreach_mul(vs, mu), gs)
            if grp[0].attr("use_nesterov", False):
                upd = torch._foreach_add(gs, torch._foreach_mul(v_new, mu))
                p_new = torch._foreach_sub(ps, torch._foreach_mul(upd, lr))
            else:
                p_new = torch._foreach_sub(ps, torch._foreach_mul(v_new, lr))
            _put(env, grp, "ParamOut", p_new)
            _put(env, grp, "VelocityOut", v_new)
        elif kind == "adam":
            b1 = grp[0].attr("beta1", 0.9)
            b2 = grp[0].attr("beta2", 0.999)
            eps = grp[0].attr("epsilon", 1e-8)
            ms = _gather(env, grp, "Moment1")
            vs = _gather(env, grp, "Moment2")
            # Beta{1,2}Pow are per-parameter accumulator vars (identical
            # values in practice, but separate state): each member keeps
            # its own lr_t, computed for all members in one vector
            b1v = torch.stack(
                [get(env, op.input("Beta1Pow")).reshape(()) for op in grp])
            b2v = torch.stack(
                [get(env, op.input("Beta2Pow")).reshape(()) for op in grp])
            lrt = (lr * torch.sqrt(1 - b2v) / (1 - b1v)).to(dtype)
            m_new = torch._foreach_add(torch._foreach_mul(ms, b1),
                                       torch._foreach_mul(gs, 1 - b1))
            # g * g: torch.square's arithmetic in the per-op update
            v_new = torch._foreach_add(
                torch._foreach_mul(vs, b2),
                torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - b2))
            denom = torch._foreach_sqrt(v_new)
            torch._foreach_add_(denom, eps)
            step = torch._foreach_div(
                torch._foreach_mul(m_new, list(lrt.unbind())), denom)
            _put(env, grp, "ParamOut", torch._foreach_sub(ps, step))
            _put(env, grp, "Moment1Out", m_new)
            _put(env, grp, "Moment2Out", v_new)
            b1_new, b2_new = b1v * b1, b2v * b2
            for i, op in enumerate(grp):
                env[op.output("Beta1PowOut").name] = b1_new[i:i + 1]
                env[op.output("Beta2PowOut").name] = b2_new[i:i + 1]
        else:  # pragma: no cover - plan only admits _FUSIBLE kinds
            raise AssertionError(kind)
