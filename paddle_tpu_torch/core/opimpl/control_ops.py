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

Not ported yet: rematerialization (memory slice; ``append_backward``
raises for ``checkpoints``), the pipeline and gradient-scale strategies
and the sparse path under pipeline parallelism (multi-device slice), and
control flow (``cond_block``/``while_block``, queue A.7 of ROADMAP.md),
whose op types have no impl here.
"""

import torch

from ..op_registry import (SPARSE_SITES_KEY, get, merge_sparse_rows, put,
                           register)


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
