"""GRU ops over padded batches with length masks (the ``gru_seq`` and
``gru_unit`` of ``paddle_tpu/core/opimpl/rnn_ops.py:86-162``; ref
``gru_op.cc``, ``gru_unit_op.cc``).

The reference scans one step function with ``lax.scan``; no Pallas kernel
is involved, so the port runs the same step as plain PyTorch, once per
time step in a Python loop, under autograd in a training step (the tape
records every step; on the card a captured step replays the whole loop
as one graph). Gate order as the reference (``math/detail/gru_kernel.h``):
update u, reset r, candidate c; Weight [H, 3H] holds the gates' [H, 2H]
then the candidate's [H, H]. ``lstm_seq``, ``lstmp_seq``,
``attention_lstm`` and ``tree_conv`` are not ported yet (ROADMAP A4).
"""

import torch

from ..op_registry import get, put, register


def _gru_step(x_t, h_prev, w_g, w_c, origin_mode):
    """One step from the biased projection x_t [B, 3H]."""
    h_sz = h_prev.shape[-1]
    g = torch.sigmoid(x_t[:, :2 * h_sz] + h_prev @ w_g)
    u, r = g[:, :h_sz], g[:, h_sz:]
    c = torch.tanh(x_t[:, 2 * h_sz:] + (r * h_prev) @ w_c)
    if origin_mode:
        return u * h_prev + (1 - u) * c
    return (1 - u) * h_prev + u * c


def _biased(x, bias):
    # adding the bias to the whole projection gives the bits of the
    # reference's per-step add
    return x if bias is None else x + bias.reshape(-1)


@register("gru_seq")
def _gru_seq(env, op):
    """Input [B, T, 3H] (pre-projected), Lengths [B] optional; Hidden
    [B, T, H]. ``is_reverse`` runs from the last step to the first; a step
    at or past a row's length keeps the row's previous state (the
    reference flips the inputs and the mask, scans, and flips back, so a
    reversed row's padded tail steps come first and keep h0 = 0)."""
    xproj = get(env, op.input("Input"))
    w = get(env, op.input("Weight"))
    lengths = get(env, op.input("Lengths"))
    b_sz, t_sz, three_h = xproj.shape
    h_sz = three_h // 3
    xs = _biased(xproj, get(env, op.input("Bias")))
    w_g, w_c = w[:, :2 * h_sz], w[:, 2 * h_sz:]
    alive = None
    if lengths is not None:
        alive = (torch.arange(t_sz, device=xproj.device)[:, None]
                 < lengths.reshape(1, -1)).unsqueeze(-1)   # [T, B, 1]
    order = range(t_sz - 1, -1, -1) if op.attr("is_reverse", False) \
        else range(t_sz)
    h = torch.zeros((b_sz, h_sz), dtype=xproj.dtype, device=xproj.device)
    hs = [None] * t_sz
    origin_mode = op.attr("origin_mode", False)
    for t in order:
        h_new = _gru_step(xs[:, t], h, w_g, w_c, origin_mode)
        h = h_new if alive is None else torch.where(alive[t], h_new, h)
        hs[t] = h
    put(env, op.output("Hidden"), torch.stack(hs, dim=1))


@register("gru_unit")
def _gru_unit(env, op):
    """One GRU step: Input [B, 3H] (pre-projected), HiddenPrev [B, H];
    Hidden [B, H]."""
    x = get(env, op.input("Input"))
    h_prev = get(env, op.input("HiddenPrev"))
    w = get(env, op.input("Weight"))
    h_sz = h_prev.shape[-1]
    put(env, op.output("Hidden"), _gru_step(
        _biased(x, get(env, op.input("Bias"))), h_prev, w[:, :2 * h_sz],
        w[:, 2 * h_sz:], op.attr("origin_mode", False)))
