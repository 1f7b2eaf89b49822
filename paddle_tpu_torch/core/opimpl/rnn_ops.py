"""Recurrent ops over padded batches with length masks (the port's
``paddle_tpu/core/opimpl/rnn_ops.py``: ``lstm_seq``, ``gru_seq``,
``gru_unit``, ``lstmp_seq``, ``attention_lstm``, ``tree_conv``; ref
``lstm_op.cc``, ``gru_op.cc``, ``gru_unit_op.cc``, ``lstmp_op.cc``,
``attention_lstm_op.cc``, ``tree_conv_op.cc``).

The reference scans one step function with ``lax.scan``; no Pallas kernel
is involved, so the port runs the same step as plain PyTorch, once per
time step in a Python loop, under autograd in a training step (the tape
records every step; on the card a captured step replays the whole loop
as one graph). A step at or past a row's length keeps the row's previous
state (h and, for the LSTMs, c). ``is_reverse`` runs from the last step to
the first: the reference flips the inputs and the mask, scans and flips
back, so a reversed row's padded tail steps come first and keep the
initial state (zeros, or H0/C0). Gate orders as the reference
(``math/detail/{gru,lstm}_kernel.h``): GRU update u, reset r, candidate
c, its Weight [H, 3H] holding the gates' [H, 2H] then the candidate's
[H, H]; LSTM i, f, c(hat), o, its bias the first 4H entries (a peephole
bias of 7H is accepted and its last 3H ignored, as the reference does).
"""

import torch

from ..op_registry import get, put, register


def _alive(lengths, t_sz, device):
    """[T, B, 1] bool: step t lies inside row b's length (None: all)."""
    if lengths is None:
        return None
    return (torch.arange(t_sz, device=device)[:, None]
            < lengths.reshape(1, -1)).unsqueeze(-1)


def _order(op, t_sz):
    return range(t_sz - 1, -1, -1) if op.attr("is_reverse", False) \
        else range(t_sz)


def _gru_step(x_t, h_prev, w_g, w_c, origin_mode):
    """One step from the biased projection x_t [B, 3H]. The gates are
    taken apart with ``split``, whose backward is one concatenation (a
    slice's would fill and add a whole-width gradient per part)."""
    h_sz = h_prev.shape[-1]
    xg, xc = x_t.split([2 * h_sz, h_sz], dim=1)
    u, r = torch.sigmoid(xg + h_prev @ w_g).split(h_sz, dim=1)
    c = torch.tanh(xc + (r * h_prev) @ w_c)
    if origin_mode:
        return u * h_prev + (1 - u) * c
    return (1 - u) * h_prev + u * c


def _lstm_cell(gates, c_prev):
    """(o, c) of one LSTM step from its pre-activation gates [B, 4H]:
    the output gate and the new cell."""
    i, f, g, o = gates.split(c_prev.shape[-1], dim=1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o), c


def _steps(x):
    """The T steps of [B, T, F] as contiguous [B, F] views of one
    time-major copy: ``unbind``'s backward is one stack (indexing a step
    would fill and add a whole [B, T, F] gradient per step)."""
    return x.transpose(0, 1).contiguous().unbind(0)


def _biased(x, bias):
    # adding the bias to the whole projection gives the bits of the
    # reference's per-step add
    return x if bias is None else x + bias.reshape(-1)


def _initial(env, op, slot, shape, like):
    v = get(env, op.input(slot))
    if v is None:
        return torch.zeros(shape, dtype=like.dtype, device=like.device)
    return v.to(like.dtype)


@register("gru_seq")
def _gru_seq(env, op):
    """Input [B, T, 3H] (pre-projected), Lengths [B] optional; Hidden
    [B, T, H]."""
    xproj = get(env, op.input("Input"))
    w = get(env, op.input("Weight"))
    b_sz, t_sz, three_h = xproj.shape
    h_sz = three_h // 3
    xs = _steps(_biased(xproj, get(env, op.input("Bias"))))
    w_g, w_c = w[:, :2 * h_sz], w[:, 2 * h_sz:]
    alive = _alive(get(env, op.input("Lengths")), t_sz, xproj.device)
    h = torch.zeros((b_sz, h_sz), dtype=xproj.dtype, device=xproj.device)
    hs = [None] * t_sz
    origin_mode = op.attr("origin_mode", False)
    for t in _order(op, t_sz):
        h_new = _gru_step(xs[t], h, w_g, w_c, origin_mode)
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


def _lstm_bias(env, op, h_sz):
    bias = get(env, op.input("Bias"))
    return None if bias is None else bias.reshape(-1)[:4 * h_sz]


@register("lstm_seq")
def _lstm_seq(env, op):
    """Input [B, T, 4H] (pre-projected: x @ W by a preceding fc), Weight
    [H, 4H] (recurrent), Bias [4H], Lengths [B], H0/C0 [B, H] optional;
    Hidden and Cell [B, T, H]. Each step's gates are one ``addmm`` of the
    biased projection and h_prev @ Weight."""
    xproj = get(env, op.input("Input"))
    w = get(env, op.input("Weight"))
    b_sz, t_sz, four_h = xproj.shape
    h_sz = four_h // 4
    xs = _steps(_biased(xproj, _lstm_bias(env, op, h_sz)))
    alive = _alive(get(env, op.input("Lengths")), t_sz, xproj.device)
    h = _initial(env, op, "H0", (b_sz, h_sz), xproj)
    c = _initial(env, op, "C0", (b_sz, h_sz), xproj)
    hs, cs = [None] * t_sz, [None] * t_sz
    for t in _order(op, t_sz):
        o, c_new = _lstm_cell(torch.addmm(xs[t], h, w), c)
        h_new = o * torch.tanh(c_new)
        if alive is None:
            h, c = h_new, c_new
        else:
            h = torch.where(alive[t], h_new, h)
            c = torch.where(alive[t], c_new, c)
        hs[t], cs[t] = h, c
    put(env, op.output("Hidden"), torch.stack(hs, dim=1))
    put(env, op.output("Cell"), torch.stack(cs, dim=1))


# the projection activations the reference's lstmp applies as named: it
# looks ``proj_activation`` up in ``jnp`` and takes tanh for a name ``jnp``
# lacks ('relu', 'sigmoid'), so only these two mean what they say there
_PROJ_ACT = {"tanh": torch.tanh, "identity": lambda v: v}


@register("lstmp_seq")
def _lstmp_seq(env, op):
    """Projection LSTM (ref ``lstmp_op.cc``): the recurrent state is the
    projection r = proj_act(h @ ProjWeight) [B, P], so the recurrent
    product is [P, 4H]. Input [B, T, 4H] (pre-projected gates), Weight
    [P, 4H], ProjWeight [H, P], Bias [4H]; H0 holds the initial
    projection [B, P], C0 the cell [B, H]. Outputs Projection [B, T, P]
    and Cell [B, T, H]; ``cell_clip`` and ``proj_clip`` clip where > 0."""
    xproj = get(env, op.input("Input"))
    w = get(env, op.input("Weight"))
    wproj = get(env, op.input("ProjWeight"))
    b_sz, t_sz, four_h = xproj.shape
    h_sz, p_sz = four_h // 4, wproj.shape[1]
    cell_clip = op.attr("cell_clip", 0.0)
    proj_clip = op.attr("proj_clip", 0.0)
    act_name = op.attr("proj_activation", "tanh")
    if act_name not in _PROJ_ACT:
        raise NotImplementedError(
            "lstmp_seq: proj_activation %r (the reference applies tanh for "
            "it); use 'tanh' or 'identity'" % (act_name,))
    pact = _PROJ_ACT[act_name]
    xs = _steps(_biased(xproj, _lstm_bias(env, op, h_sz)))
    alive = _alive(get(env, op.input("Lengths")), t_sz, xproj.device)
    r = _initial(env, op, "H0", (b_sz, p_sz), xproj)
    c = _initial(env, op, "C0", (b_sz, h_sz), xproj)
    rs, cs = [None] * t_sz, [None] * t_sz
    for t in _order(op, t_sz):
        o, c_new = _lstm_cell(torch.addmm(xs[t], r, w), c)
        if cell_clip > 0:
            c_new = c_new.clamp(-cell_clip, cell_clip)
        r_new = pact((o * torch.tanh(c_new)) @ wproj)
        if proj_clip > 0:
            r_new = r_new.clamp(-proj_clip, proj_clip)
        if alive is None:
            r, c = r_new, c_new
        else:
            r = torch.where(alive[t], r_new, r)
            c = torch.where(alive[t], c_new, c)
        rs[t], cs[t] = r, c
    put(env, op.output("Projection"), torch.stack(rs, dim=1))
    put(env, op.output("Cell"), torch.stack(cs, dim=1))


def _scalar(env, op, slot):
    v = get(env, op.input(slot))
    return None if v is None else v.reshape(-1)[0]


@register("attention_lstm")
def _attention_lstm(env, op):
    """Ref ``attention_lstm_op.cc``: each step attends over the whole
    input with c_{t-1},
      fc1 = relu(concat(x, expand(c_prev)) @ AttentionWeight + b)
      fc2 = relu(fc1 * scalar + scalar_bias); a = softmax_T(fc2)
      lstm_x = sum_t a_t * x_t,
    then takes one LSTM step on concat(lstm_x, h_prev) @ LSTMWeight. X
    [B, T, M], AttentionWeight [M + D, 1], LSTMWeight [M + D, 4D],
    LSTMBias [4D], Lengths [B]; Hidden and Cell [B, T, D]. Keys past a
    row's length are left out of the softmax. x's share of the score is
    the same every step, so it is computed once."""
    x = get(env, op.input("X"))
    aw = get(env, op.input("AttentionWeight"))
    ab = _scalar(env, op, "AttentionBias")
    asc = _scalar(env, op, "AttentionScalar")
    asb = _scalar(env, op, "AttentionScalarBias")
    lw = get(env, op.input("LSTMWeight"))
    lb = get(env, op.input("LSTMBias"))
    lengths = get(env, op.input("Lengths"))
    b_sz, t_sz, m_sz = x.shape
    d_sz = lw.shape[1] // 4
    valid = None if lengths is None else (
        torch.arange(t_sz, device=x.device)[None, :]
        < lengths.reshape(-1, 1)).unsqueeze(-1)              # [B, T, 1]
    alive = _alive(lengths, t_sz, x.device)
    h = _initial(env, op, "H0", (b_sz, d_sz), x)
    c = _initial(env, op, "C0", (b_sz, d_sz), x)
    x_score = x @ aw[:m_sz]                                   # [B, T, 1]
    aw_c = aw[m_sz:]
    hs, cs = [], []
    for t in range(t_sz):
        fc = x_score + (c @ aw_c)[:, None, :]
        if ab is not None:
            fc = fc + ab
        fc = torch.relu(fc)
        if asc is not None:
            fc = fc * asc
            if asb is not None:
                fc = fc + asb
            fc = torch.relu(fc)
        if valid is not None:
            fc = fc.masked_fill(~valid, float("-inf"))
        a = torch.softmax(fc, dim=1)
        lstm_x = torch.sum(a * x, dim=1)                      # [B, M]
        gates = torch.cat([lstm_x, h], dim=-1) @ lw
        if lb is not None:
            gates = gates + lb.reshape(-1)[:4 * d_sz]
        o, c_new = _lstm_cell(gates, c)
        h_new = o * torch.tanh(c_new)
        if alive is None:
            h, c = h_new, c_new
        else:
            h = torch.where(alive[t], h_new, h)
            c = torch.where(alive[t], c_new, c)
        hs.append(h)
        cs.append(c)
    put(env, op.output("Hidden"), torch.stack(hs, dim=1))
    put(env, op.output("Cell"), torch.stack(cs, dim=1))


@register("tree_conv")
def _tree_conv(env, op):
    """Ref ``tree_conv_op.cc`` + ``math/tree2col.cc`` (TBCNN, arXiv
    1409.5718): continuous-binary-tree convolution. For each root, the
    descendants up to ``max_depth`` levels down contribute eta_t-, eta_l-
    and eta_r-weighted features, which the three filter slots mix.
    EdgeSet [B, E, 2] (1-indexed parent -> child, 0 pads), NodesVector
    [B, N, F], Filter [F, 3, O, K] -> Out [B, N, O, K] (unbatched [N, F]
    and [E, 2] give [N, O, K]). A child's index among its siblings is its
    edge's rank among its parent's edges; depth d's nodes are the boolean
    adjacency's d-th power, each node counted at its first depth."""
    nodes = get(env, op.input("NodesVector"))
    edges = get(env, op.input("EdgeSet")).long()
    filt = get(env, op.input("Filter"))
    max_depth = int(op.attr("max_depth", 2))
    squeeze_batch = nodes.dim() == 2
    if squeeze_batch:
        nodes, edges = nodes[None], edges[None]
    b, n, _ = nodes.shape
    e = edges.shape[1]
    dev = nodes.device
    f32 = torch.float32
    ok = (edges[..., 0] > 0) & (edges[..., 1] > 0)           # [B, E]
    pu = torch.where(ok, edges[..., 0] - 1, n)
    pv = torch.where(ok, edges[..., 1] - 1, n)
    bidx = torch.arange(b, device=dev)[:, None].expand(b, e)
    adj = torch.zeros((b, n + 1, n + 1), dtype=torch.bool, device=dev)
    adj = adj.index_put((bidx, pu, pv), ok)[:, :n, :n]
    order = torch.arange(e, device=dev)
    same_parent = ((pu[:, None, :] == pu[:, :, None]) & ok[:, None, :]
                   & ok[:, :, None])                          # [B, E, E]
    rank = torch.sum(same_parent & (order[None, :] < order[:, None]),
                     dim=2)
    child_cnt = adj.sum(dim=2)                                # [B, N]
    parent_cnt = torch.gather(child_cnt, 1, pu.clamp(0, n - 1)).to(f32)
    # a child's index and its parent's child count; the dropped edges
    # (pv = N) write a scratch column past the end
    idx1 = torch.ones((b, n + 1), dtype=f32, device=dev).index_put(
        (bidx, pv), torch.where(ok, rank + 1.0, 1.0))[:, :n]
    pclen = torch.ones((b, n + 1), dtype=f32, device=dev).index_put(
        (bidx, pv), torch.where(ok, parent_cnt, 1.0))[:, :n]
    md = float(max_depth)
    acc = torch.zeros((b, n, n, 3), dtype=f32, device=dev)
    reach = torch.eye(n, dtype=torch.bool, device=dev).expand(b, n, n)
    seen = reach
    adj_f = adj.to(f32)
    for d in range(max_depth):
        eta_t = (md - d) / md
        if d == 0:
            temp = torch.full((b, n), 0.5, dtype=f32, device=dev)
        else:
            temp = torch.where(pclen == 1.0, 0.5,
                               (idx1 - 1.0) / torch.clamp(pclen - 1.0,
                                                          min=1.0))
        wts = torch.stack([torch.full_like(temp, eta_t),
                           (1.0 - eta_t) * temp,
                           (1.0 - eta_t) * (1.0 - temp)], dim=-1)
        acc = acc + reach[..., None].to(f32) * wts[:, None, :, :]
        nxt = ((reach.to(f32) @ adj_f) > 0) & ~seen
        seen = seen | nxt
        reach = nxt
    patch = torch.einsum("buvs,bvf->busf", acc, nodes.to(f32))
    out = torch.einsum("busf,fsok->buok", patch, filt)
    put(env, op.output("Out"), out[0] if squeeze_batch else out)
