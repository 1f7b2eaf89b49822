"""Autodiff ops (the port's ``paddle_tpu/core/opimpl/control_ops.py:63,211``).

``paddle_tpu`` differentiates by re-tracing the recorded forward ops under
``jax.grad`` from a snapshot of the step-start env. The port needs no such
replay: the Executor runs the forward ops with autograd recording, from
parameters it turned into leaf tensors at step start
(``core/executor.py``), so the tape already holds the forward that just
ran, dropout masks included. ``autodiff`` is ``torch.autograd.grad`` of the
summed loss over that tape.

Sparse (SelectedRows) grads: ``paddle_tpu`` differentiates w.r.t. a zero
delta added to each sparse lookup's output (``control_ops.py:71-85``).
Here each such lookup made its output a leaf and recorded the site
(``lookup_table`` in ``tensor_ops.py``); ``autodiff`` takes the gradient
w.r.t. the dense leaves and the site outputs in one ``autograd.grad``, and
a table's (rows, values) grad is its sites' (ids, output grads)
concatenated in op order. Padded slots park on the sentinel row V with
zero values (``:176-183``); duplicates are merged only when a clip or a
decay asked for it (``backward.require_merged_sparse``).

The learning-rate schedule ops (``control_ops.py:338-431``) follow: one
op per schedule, reading the step counter (a persistable state var) on
the device and writing a 0-d float32 rate, no value read on the host, so
a scheduled training step is captured like any other.

Control flow (``control_ops.py:247-340``): the reference lowers its
sub-block bodies to ``lax.cond`` / ``lax.while_loop`` / ``lax.scan``; the
port runs the recorded body ops itself. ``while_block`` and
``cond_block`` read their condition on the host (once per trip, once per
run), so a program holding either is interpreted, never captured
(``core/executor.py`` ``_NOT_CAPTURED``); ``scan_block``'s trip count is
the static length of its inputs, so a StaticRNN's step is captured like
any other. Each trip, branch or step starts from the env the block op saw,
updated with the carries, as a traced body starts from its closure.

Not ported yet: the pipeline and gradient-scale strategies and the sparse
path under pipeline parallelism (multi-device slice).
"""

import math

import torch

from ..op_registry import (SPARSE_SITES_KEY, get, merge_sparse_rows, put,
                           register, run_op)


def _loss_seed(loss_val):
    """The loss cotangent seed: ``sum(loss)`` (``paddle_tpu``'s default
    GradientScaleStrategy; the others come with the multi-device slice)."""
    return loss_val.sum()


def _grads(outputs, grad_outputs, env, wrt_names, extra=()):
    """d(outputs)/d(wrt), then d(outputs)/d(each tensor of ``extra``), over
    the recorded tape; an input the outputs do not depend on gets zeros,
    as ``jax.grad`` gives."""
    inputs = [env[n] for n in wrt_names]
    for n, t in zip(wrt_names, inputs):
        if not t.requires_grad:
            raise RuntimeError(
                "autodiff: '%s' was not recorded for gradients; the "
                "Executor turns the op's wrt vars into leaves at step start"
                % n)
    inputs += list(extra)
    grads = torch.autograd.grad(outputs, inputs, grad_outputs=grad_outputs,
                                allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(inputs, grads)]


def _rows_and_values(table, sites, site_grads, merge):
    """(rows [N] int32, values [N, K]) of ``table`` from its lookup sites
    (ids, output, padding_idx) and their output grads, in site order."""
    vocab, width = table.shape[0], table.shape[-1]
    rows_parts, val_parts = [], []
    for (ids, _, pad), g in zip(sites, site_grads):
        ids = ids.reshape(-1).to(torch.int32)
        vals = g.reshape(-1, width)
        if pad is not None and pad >= 0:
            # the padding row's grad is zero (the lookup masks its
            # output): park padded slots on the dropped sentinel
            padded = ids == pad
            ids = torch.where(padded, vocab, ids)
            vals = torch.where(padded[:, None], 0.0, vals)
        rows_parts.append(ids)
        val_parts.append(vals)
    if not rows_parts:
        return (torch.zeros(0, dtype=torch.int32, device=table.device),
                torch.zeros(0, width, dtype=table.dtype, device=table.device))
    rows = torch.cat(rows_parts)
    vals = torch.cat(val_parts)
    if merge:
        # only when a consumer needs each row exactly once (norm clips,
        # sparse_decay): the scatter-adds are duplicate-safe and the lazy
        # optimizers merge for themselves
        rows, vals = merge_sparse_rows(rows, vals, vocab)
    return rows, vals


@register("autodiff")
def _autodiff(env, op):
    seed = _loss_seed(get(env, op.input("Loss")))
    wrt_names = op.attr("wrt_names")
    sparse_names = op.attr("sparse_wrt_names") or ()
    dense = [n for n in wrt_names if n not in sparse_names]
    recorded = env.get(SPARSE_SITES_KEY, {})
    sites = {n: recorded.get(n, []) for n in sparse_names}
    outs = [s[1] for n in sparse_names for s in sites[n]]
    grads = _grads([seed], None, env, dense, outs)
    dense_grads = dict(zip(dense, grads))
    rest = iter(grads[len(dense):])
    site_grads = {n: [next(rest) for _ in sites[n]] for n in sparse_names}
    rows_vars = dict(zip(sparse_names, op.output_list("SparseRows")))
    for name, v in zip(wrt_names, op.output_list("Grads")):
        if name not in sparse_names:
            put(env, v, dense_grads[name])
            continue
        rows, vals = _rows_and_values(env[name], sites[name],
                                      site_grads[name],
                                      op.attr("merge_sparse", False))
        put(env, v, vals)
        put(env, rows_vars[name], rows)


@register("autodiff_vjp")
def _autodiff_vjp(env, op):
    """calc_gradient: vjp of arbitrary targets w.r.t. arbitrary inputs;
    the cotangents default to ones."""
    targets = [get(env, t) for t in op.input_list("Targets")]
    tgs = op.input_list("TargetGrads")
    if tgs:
        cot = [get(env, g).reshape(t.shape).to(t.dtype)
               for g, t in zip(tgs, targets)]
    else:
        cot = [torch.ones_like(t) for t in targets]
    wrt_names = op.attr("wrt_names")
    grads = _grads(targets, cot, env, wrt_names)
    for v, g in zip(op.output_list("Grads"), grads):
        put(env, v, g)


# ---------------- control flow ----------------

def _run_body(env, ops, carry):
    """Run ``ops`` over a copy of ``env`` updated with ``carry``
    ({name: tensor}); returns the copy."""
    local = dict(env)
    local.update(carry)
    for o in ops:
        run_op(local, o)
    return local


@register("cond_block")
def _cond_block(env, op):
    """The branch the 0-d Cond selects (read on the host), its outputs
    merged into Out: ``true_out_names`` or ``false_out_names``, in
    order."""
    pred = bool(get(env, op.input("Cond")).reshape(()))
    outs = op.output_list("Out")
    names = op.attr("true_out_names" if pred else "false_out_names") or [
        v.name for v in outs]
    local = _run_body(env, op.attr("true_ops" if pred else "false_ops"), {})
    for v, n in zip(outs, names):
        put(env, v, local[n])


@register("while_block")
def _while_block(env, op):
    """Run the body while the bool var ``cond_name`` holds (read on the
    host before each trip; the body recomputes it). The carries are the
    condition, the listed loop vars (``Carry``) and the fill levels
    (``<array>@LEN``) of the arrays among them, so ``array_write`` in the
    body updates the carried array and ``array_length`` stays right; Out
    takes the loop vars' final values, the levels go back into the env."""
    body = op.attr("body_ops")
    cond_name = op.attr("cond_name")
    names = [cond_name] + [v.name for v in op.input_list("Carry")]
    names += [n + "@LEN" for n in names[1:] if n + "@LEN" in env]
    carry = {n: env[n] for n in names}
    while bool(carry[cond_name].reshape(())):
        local = _run_body(env, body, carry)
        carry = {n: local[n] for n in names}
    for v, src in zip(op.output_list("Out"), op.input_list("Carry")):
        put(env, v, carry[src.name])
    for n in names:
        if n.endswith("@LEN"):
            env[n] = carry[n]


@register("scan_block")
def _scan_block(env, op):
    """StaticRNN's step over the leading (time) axis of the X inputs:
    ``carry_names`` start from Init and take ``carry_out_names`` after
    each step, ``x_step_names`` read step t of X, and the ``y_names`` of
    every step are stacked into Ys; Last holds the final carries."""
    xs = [get(env, v) for v in op.input_list("X")]
    carry = [get(env, v) for v in op.input_list("Init")]
    carry_names = op.attr("carry_names")
    x_names = op.attr("x_step_names")
    ys = []
    for t in range(xs[0].shape[0]):
        step = dict(zip(carry_names, carry))
        step.update((n, x[t]) for n, x in zip(x_names, xs))
        local = _run_body(env, op.attr("step_ops"), step)
        carry = [local[n] for n in op.attr("carry_out_names")]
        ys.append([local[n] for n in op.attr("y_names")])
    for v, val in zip(op.output_list("Last"), carry):
        put(env, v, val)
    for i, v in enumerate(op.output_list("Ys")):
        put(env, v, torch.stack([y[i] for y in ys]))


# ---------------- learning-rate schedule ops ----------------

def _step(env, op):
    return get(env, op.input("Step")).reshape(()).to(torch.float32)


def _decay_div(env, op):
    div = _step(env, op) / op.attr("decay_steps")
    return torch.floor(div) if op.attr("staircase", False) else div


@register("lr_exponential_decay")
def _lr_exp_decay(env, op):
    div = _decay_div(env, op)
    put(env, op.output("Out"), op.attr("learning_rate")
        * torch.pow(op.attr("decay_rate"), div))


@register("lr_natural_exp_decay")
def _lr_natural_exp(env, op):
    div = _decay_div(env, op)
    put(env, op.output("Out"), op.attr("learning_rate")
        * torch.exp(-op.attr("decay_rate") * div))


@register("lr_inverse_time_decay")
def _lr_inverse_time(env, op):
    div = _decay_div(env, op)
    put(env, op.output("Out"), op.attr("learning_rate")
        / (1.0 + op.attr("decay_rate") * div))


@register("lr_polynomial_decay")
def _lr_polynomial(env, op):
    step = _step(env, op)
    lr0 = op.attr("learning_rate")
    decay_steps = op.attr("decay_steps")
    end_lr = op.attr("end_learning_rate", 1e-4)
    if op.attr("cycle", False):
        decay = decay_steps * torch.ceil(
            torch.clamp_min(step / decay_steps, 1.0))
    else:
        decay = decay_steps
        step = torch.clamp_max(step, decay_steps)
    put(env, op.output("Out"), (lr0 - end_lr) * torch.pow(
        1 - step / decay, op.attr("power", 1.0)) + end_lr)


@register("lr_piecewise_decay")
def _lr_piecewise(env, op):
    """values[i] for the i boundaries at or below the step (searchsorted,
    side right), as a chain of selects: no table is copied to the
    device."""
    step = _step(env, op)
    values = op.attr("values")
    out = torch.full((), values[0], dtype=torch.float32, device=step.device)
    for b, v in zip(op.attr("boundaries"), values[1:]):
        out = torch.where(step >= b, v, out)
    put(env, op.output("Out"), out)


@register("lr_cosine_decay")
def _lr_cosine(env, op):
    cur_epoch = torch.floor(_step(env, op) / op.attr("step_each_epoch"))
    put(env, op.output("Out"), op.attr("learning_rate") * 0.5 * (
        torch.cos(cur_epoch * math.pi / op.attr("epochs")) + 1))


@register("lr_noam_decay")
def _lr_noam(env, op):
    step = torch.clamp_min(_step(env, op), 1.0)
    warmup = op.attr("warmup_steps")
    put(env, op.output("Out"), op.attr("d_model") ** -0.5 * torch.minimum(
        step ** -0.5, step * warmup ** -1.5))


@register("lr_linear_warmup")
def _lr_linear_warmup(env, op):
    step = _step(env, op)
    base = get(env, op.input("Base")).reshape(())
    warmup = op.attr("warmup_steps")
    start_lr, end_lr = op.attr("start_lr"), op.attr("end_lr")
    warm = start_lr + (end_lr - start_lr) * step / warmup
    put(env, op.output("Out"), torch.where(step < warmup, warm, base))
