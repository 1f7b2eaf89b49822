"""Autodiff API (ref ``python/paddle/fluid/backward.py``: ``append_backward
:394``, ``calc_gradient:613``; the port's copy of ``paddle_tpu/backward.py``).

As in ``paddle_tpu``, the backward pass is one symbolic ``autodiff`` op
appended after the forward ops. Its implementation
(``core/opimpl/control_ops.py``) is ``torch.autograd.grad`` over the tape
the forward ops recorded while the Executor ran them. Grad variables follow
the reference's ``<name>@GRAD`` convention, so clip, regularizer and
optimizer code composes as in ``paddle_tpu``.

Sparse (SelectedRows) gradients: a table marked ``is_sparse_grad``
(``embedding(is_sparse=True)``) and read only by sparse lookups gets a
(rows, values) gradient: ``<name>@GRAD`` holds one value row per looked-up
id and ``<name>@GRAD@ROWS`` the ids (ref ``lookup_table_op.cc``'s grad
kernel). The autodiff op takes it from the lookups' outputs, not from the
table (``core/opimpl/control_ops.py``).
"""

from .core.framework import Variable, grad_var_name

__all__ = ["append_backward", "calc_gradient", "gradients",
           "require_merged_sparse"]


def _collect_params(program, parameter_list=None, no_grad_set=None):
    params = [p for p in program.all_parameters() if p.trainable]
    if parameter_list is not None:
        wanted = {p.name if isinstance(p, Variable) else str(p)
                  for p in parameter_list}
        params = [p for p in params if p.name in wanted]
    if no_grad_set:
        banned = {v.name if isinstance(v, Variable) else str(v)
                  for v in no_grad_set}
        params = [p for p in params if p.name not in banned]
    return params


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Append gradient computation for ``loss`` w.r.t. trainable
    parameters; returns ``[(param, grad_var), ...]`` like the reference.
    ``checkpoints`` (rematerialization) raises until the memory slice is
    ported."""
    if checkpoints:
        raise NotImplementedError(
            "append_backward(checkpoints=...): rematerialization comes with "
            "the memory slice of paddle_tpu_torch")
    prog = loss.block.program
    gb = prog.global_block()
    fwd_ops = list(gb.ops)
    params = _collect_params(prog, parameter_list, no_grad_set)

    # a table consumed by anything but sparse lookups (e.g. weight tying
    # into an output projection) falls back to the dense grad
    def _sparse_ok(p):
        if not getattr(p, "is_sparse_grad", False):
            return False
        uses = [o for o in fwd_ops if p.name in o.input_arg_names]
        return bool(uses) and all(
            o.type == "lookup_table" and o.attr("is_sparse", True)
            and o.input("W") is not None and o.input("W").name == p.name
            for o in uses)

    sparse_names = [p.name for p in params if _sparse_ok(p)]
    grad_vars, rows_vars = [], []
    for p in params:
        gv = gb.create_var(name=grad_var_name(p.name), shape=p.shape,
                           dtype=str(p.dtype))
        if p.name in sparse_names:
            rv = gb.create_var(name=grad_var_name(p.name) + "@ROWS",
                               shape=None, dtype="int32")
            gv.sparse_rows_var = rv
            rows_vars.append(rv)
        grad_vars.append(gv)
    op = gb.append_op(
        "autodiff", {"Loss": loss},
        {"Grads": grad_vars, "SparseRows": rows_vars},
        {"fwd_ops": fwd_ops, "wrt_names": [p.name for p in params],
         "sparse_wrt_names": sparse_names})
    prog._backward_ops.append(op)
    return list(zip(params, grad_vars))


def require_merged_sparse(program):
    """Ask the program's autodiff op(s) to emit sparse (rows, values)
    grads with duplicates merged (each row once, zero-filled duplicate
    slots on an out-of-range sentinel). Called by consumers whose math
    needs once-per-row semantics: norm-based clipping and sparse weight
    decay. Everything else (the scatter-add of sparse SGD and of the
    non-lazy densify, the lazy optimizers' own merge) is duplicate-safe,
    and the merge (a sort and a segment sum per table per step) is not
    free."""
    for op in getattr(program, "_backward_ops", ()):
        if op.type == "autodiff":
            op.attrs["merge_sparse"] = True


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of ``targets`` w.r.t. arbitrary ``inputs`` (ref
    ``backward.py:613``). ``target_gradients`` supplies the cotangent;
    defaults to ones."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if target_gradients is not None and not isinstance(
            target_gradients, (list, tuple)):
        target_gradients = [target_gradients]
    prog = targets[0].block.program
    gb = prog.global_block()
    fwd_ops = list(gb.ops)
    grad_vars = [gb.create_var(name=grad_var_name(v.name), shape=v.shape,
                               dtype=str(v.dtype)) for v in inputs]
    gb.append_op(
        "autodiff_vjp",
        {"Targets": list(targets),
         **({"TargetGrads": list(target_gradients)}
            if target_gradients else {})},
        {"Grads": grad_vars},
        {"fwd_ops": fwd_ops, "wrt_names": [v.name for v in inputs]})
    return grad_vars


gradients = calc_gradient
