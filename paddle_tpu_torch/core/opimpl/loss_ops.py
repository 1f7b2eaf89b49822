"""CTC, CRF, NCE and hierarchical-sigmoid losses (the port's
``paddle_tpu/core/opimpl/loss_ops.py``; ref ``warpctc_op.cc``,
``linear_chain_crf_op.cc``, ``crf_decoding_op.cc``, ``nce_op.cc``,
``hierarchical_sigmoid_op.cc`` with ``math/matrix_bit_code.h``).

The reference runs each dynamic program (the CTC alpha recursion, the CRF
forward algorithm, Viterbi) as a ``lax.scan`` over time in log space on
padded [B, T, ...] batches with length masks, and takes the gradients by
autodiff; the port runs the same recursions as Python loops over time
under autograd. No value is read on the host, so a captured step may hold
any of them. Tables an op carries in its attrs (the tree's paths, a seeded
nce's negatives) go to the device once per op and device, in the op's
first (interpreted) run, so a captured step replays no copy from the host.
"""

import math
import weakref

import torch
import torch.nn.functional as F

from ..op_registry import DEVICE_KEY, get, put, register, rng_draw

_NEG = -1e30

# op -> {key: device tensor}: an op's constant tables, made in its first run
_OP_TABLES = weakref.WeakKeyDictionary()


def _op_table(op, key, make):
    """The tensor ``make()`` gives, made once per (op, ``key``)."""
    tables = _OP_TABLES.setdefault(op, {})
    if key not in tables:
        tables[key] = make()
    return tables[key]


def _lengths(env, op, slot, batch, default, device):
    """A [B] int64 length input, or ``default`` for every row."""
    v = op.input(slot)
    if v is None:
        return torch.full((batch,), default, dtype=torch.long, device=device)
    return env[v.name].reshape(batch).long()


@register("warpctc")
def _warpctc(env, op):
    """CTC loss on padded Logits [B, T, C] (softmax applied inside, as
    warp-ctc does), Label [B, L], LogitsLength / LabelLength [B]
    (default the padded sizes); Loss [B, 1]. The alpha recursion runs over
    the blank-extended labels [blank, y1, blank, ..., yL, blank] in log
    space, the impossible states at -1e30 (not -inf: the loss of an
    impossible alignment stays finite, as the reference's). An empty
    label's only path is all blanks: its second readout is left out.
    ``norm_by_times`` divides the gradient by the input length and leaves
    the loss as it is, as the reference does."""
    logits = get(env, op.input("Logits"))
    label = get(env, op.input("Label")).long()
    b, t_max, _ = logits.shape
    l_max = label.shape[1]
    dev = logits.device
    in_len = _lengths(env, op, "LogitsLength", b, t_max, dev)
    lb_len = _lengths(env, op, "LabelLength", b, l_max, dev)
    blank = op.attr("blank", 0)

    logp = F.log_softmax(logits, dim=-1)
    s = 2 * l_max + 1
    ext = torch.full((b, s), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = label
    # state s may take from s - 2 when it is a label that differs from the
    # label two states back (the standard CTC transition)
    allow = ((torch.arange(s, device=dev) >= 2) & (ext != blank)
             & (ext != torch.roll(ext, 2, dims=1)))
    neg1 = torch.full((b, 1), _NEG, dtype=logp.dtype, device=dev)
    neg2 = torch.full((b, 2), _NEG, dtype=logp.dtype, device=dev)
    lp0 = torch.gather(logp[:, 0, :], 1, ext)
    alpha = torch.cat([lp0[:, :2], torch.full((b, s - 2), _NEG,
                                              dtype=logp.dtype,
                                              device=dev)], dim=1)
    for t in range(1, t_max):
        lp = torch.gather(logp[:, t, :], 1, ext)
        s1 = torch.cat([neg1, alpha[:, :-1]], dim=1)
        s2 = torch.where(allow, torch.cat([neg2, alpha[:, :-2]], dim=1),
                         _NEG)
        new = torch.logsumexp(torch.stack([alpha, s1, s2]), dim=0) + lp
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    end_b = torch.gather(alpha, 1, (2 * lb_len)[:, None])[:, 0]
    end_l = torch.gather(alpha, 1, torch.clamp(2 * lb_len - 1,
                                               min=0)[:, None])[:, 0]
    end_l = torch.where(lb_len > 0, end_l, _NEG)
    nll = -torch.logaddexp(end_b, end_l)
    if op.attr("norm_by_times", False):
        scaled = nll / in_len.to(nll.dtype)
        nll = scaled + (nll - scaled).detach()
    put(env, op.output("Loss"), nll[:, None])


def _crf_unpack(transition):
    """Fluid's transition layout (``linear_chain_crf_op.h``): row 0 the
    start weights, row 1 the end weights, rows 2.. the [D, D] matrix."""
    return transition[0], transition[1], transition[2:]


@register("linear_chain_crf")
def _linear_chain_crf(env, op):
    """Emission [B, T, D], Transition [D + 2, D], Label [B, T], Length
    [B]; LogLikelihood [B, 1] = log Z - the gold path's score (the cost
    to minimise), Z by the forward algorithm over each row's steps."""
    emission = get(env, op.input("Emission"))
    transition = get(env, op.input("Transition"))
    label = get(env, op.input("Label")).long()
    b, t_max, _ = emission.shape
    length = _lengths(env, op, "Length", b, t_max, emission.device)
    start, end, w = _crf_unpack(transition)
    mask = (torch.arange(t_max, device=emission.device)[None, :]
            < length[:, None]).to(emission.dtype)

    e_gold = torch.gather(emission, 2, label[..., None])[..., 0]
    e_sum = torch.sum(e_gold * mask, dim=1)
    t_sum = torch.sum(w[label[:, :-1], label[:, 1:]] * mask[:, 1:], dim=1)
    last = torch.gather(label, 1, torch.clamp(length - 1,
                                              min=0)[:, None])[:, 0]
    gold = start[label[:, 0]] + e_sum + t_sum + end[last]

    alpha = start[None, :] + emission[:, 0, :]
    for t in range(1, t_max):
        new = torch.logsumexp(alpha[:, :, None] + w[None], dim=1) \
            + emission[:, t]
        alpha = torch.where((t < length)[:, None], new, alpha)
    log_z = torch.logsumexp(alpha + end[None], dim=1)
    put(env, op.output("LogLikelihood"), (log_z - gold)[:, None])


@register("crf_decoding")
def _crf_decoding(env, op):
    """Viterbi decode (ref ``crf_decoding_op.h``): ViterbiPath [B, T]
    int32, 0 past a row's length; a step past it passes the scores through
    with an identity back-pointer. Ties go to the first index. With a
    Label input the output is the per-step correctness mask (1 where the
    path equals the label inside the length), as the reference's."""
    emission = get(env, op.input("Emission"))
    transition = get(env, op.input("Transition"))
    b, t_max, d = emission.shape
    dev = emission.device
    length = _lengths(env, op, "Length", b, t_max, dev)
    start, end, w = _crf_unpack(transition)
    ident = torch.arange(d, device=dev)[None, :].expand(b, d)

    v = start[None, :] + emission[:, 0, :]
    back = []
    for t in range(1, t_max):
        scores = v[:, :, None] + w[None]                      # [B, D, D]
        best, best_prev = torch.max(scores, dim=1)
        live = (t < length)[:, None]
        v = torch.where(live, best + emission[:, t], v)
        back.append(torch.where(live, best_prev, ident))
    idx = torch.argmax(v + end[None], dim=1)                  # [B]
    path = [idx]
    for bp in reversed(back):
        idx = torch.gather(bp, 1, idx[:, None])[:, 0]
        path.append(idx)
    path = torch.stack(path[::-1], dim=1)                     # [B, T]
    live = torch.arange(t_max, device=dev)[None, :] < length[:, None]
    path = torch.where(live, path, 0)
    lbl = get(env, op.input("Label"))
    if lbl is not None:
        path = (path == lbl.reshape(path.shape).long()) & live
    put(env, op.output("ViterbiPath"), path.to(torch.int32))


def _log_q(sampler, ids, vocab):
    """log q(id) of the sampler: log-uniform (Zipfian) or uniform."""
    if sampler == "log_uniform":
        idf = ids.to(torch.float32)
        return torch.log((torch.log(idf + 2.0) - torch.log(idf + 1.0))
                         / math.log(vocab + 1.0))
    return torch.full(ids.shape, -math.log(float(vocab)), device=ids.device)


def nce_negatives(generator, batch, k, vocab, sampler, device):
    """[B, k] int64 noise classes drawn from ``generator``: uniform over
    [0, V), or log-uniform, floor(exp(u log(V + 1))) - 1 for u uniform in
    [0, 1), clipped into [0, V)."""
    if sampler == "log_uniform":
        u = torch.rand((batch, k), generator=generator, device=device)
        neg = (torch.exp(u * math.log(vocab + 1.0)) - 1.0).long()
        return torch.clamp(neg, 0, vocab - 1)
    return torch.randint(0, vocab, (batch, k), generator=generator,
                         device=device)


def nce_cost(x, label, w, bias, neg, sampler):
    """[B, 1] NCE cost (ref ``nce_op.h``) of inputs x [B, D] with their
    true classes label [B] against the noise classes neg [B, k]: the
    logistic loss of each class's score, shifted by log(k q(class))."""
    k, vocab = neg.shape[1], w.shape[0]

    def score(ids):
        s = torch.sum(w[ids] * x[:, None, :], dim=-1)
        if bias is not None:
            s = s + bias.reshape(-1)[ids]
        return s

    log_k = math.log(float(k))
    s_true = score(label[:, None]) - (log_k + _log_q(sampler, label[:, None],
                                                     vocab))
    s_neg = score(neg) - (log_k + _log_q(sampler, neg, vocab))
    cost = F.softplus(-s_true)[:, 0] + torch.sum(F.softplus(s_neg), dim=1)
    return cost[:, None]


@register("nce")
def _nce(env, op):
    """Noise-contrastive estimation: Input [B, D], Label [B, 1], Weight
    [V, D], Bias [V]; Cost [B, 1]. ``num_neg_samples`` noise classes a
    row from ``sampler`` ('uniform' or 'log_uniform'). ``seed`` 0 draws
    them from the executor's generator each run; any other seed draws them
    once from a CPU generator seeded with it, so every run (and every
    device) takes the same ones, as the reference's fixed key gives the
    same ones every run (other numbers than its threefry draw)."""
    x = get(env, op.input("Input"))
    label = get(env, op.input("Label")).reshape(x.shape[0]).long()
    w = get(env, op.input("Weight"))
    bias = get(env, op.input("Bias"))
    k = op.attr("num_neg_samples")
    sampler = op.attr("sampler", "uniform")
    seed = op.attr("seed", 0)
    shape = (x.shape[0], k, w.shape[0], sampler)
    if seed:
        neg = _op_table(op, ("nce", seed) + shape + (str(x.device),),
                        lambda: nce_negatives(
                            torch.Generator().manual_seed(seed), *shape,
                            device="cpu").to(x.device))
    else:
        neg = rng_draw(env, lambda g: nce_negatives(
            g, *shape, device=env[DEVICE_KEY]))
    put(env, op.output("Cost"), nce_cost(x, label, w, bias, neg, sampler))


@register("hsigmoid")
def _hsigmoid(env, op):
    """Hierarchical sigmoid over a class tree: Input [B, D], Label [B, 1],
    W [nodes, D], Bias [nodes]; Cost [B, 1], the summed sigmoid cross
    entropy of each node on the label's path against its bit. The paths
    come as PathTable / PathCode inputs [B, L] (a custom tree, -1 pads)
    or as the ``path_table`` / ``path_code`` attrs [C, L] of the default
    complete binary tree, looked up by label."""
    x = get(env, op.input("Input"))
    label = get(env, op.input("Label")).reshape(x.shape[0]).long()
    w = get(env, op.input("W"))
    bias = get(env, op.input("Bias"))
    if op.input("PathTable") is not None:
        idx = get(env, op.input("PathTable")).long()
        bits = get(env, op.input("PathCode")).to(torch.float32)
    else:
        dev = str(x.device)
        table = _op_table(op, ("path_table", dev), lambda: torch.tensor(
            op.attr("path_table"), dtype=torch.long, device=x.device))
        codes = _op_table(op, ("path_code", dev), lambda: torch.tensor(
            op.attr("path_code"), dtype=torch.float32, device=x.device))
        idx, bits = table[label], codes[label]
    valid = (idx >= 0).to(x.dtype)
    safe = torch.clamp(idx, min=0)
    pre = torch.sum(w[safe] * x[:, None, :], dim=-1)
    if bias is not None:
        pre = pre + bias.reshape(-1)[safe]
    bit_loss = F.softplus(pre) - bits * pre
    put(env, op.output("Cost"), torch.sum(bit_loss * valid, dim=1)[:, None])
