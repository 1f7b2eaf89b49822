"""The long-tail ops of ``paddle_tpu/core/opimpl/misc_ops.py`` (ref
``paddle/fluid/operators/*_op.cc``): losses and metrics, image and tensor
ops, sequence utilities, two proximal update ops, ``sample_logits``,
``lstm_unit``, ``ctc_align``, and the detection ops ``psroi_pool`` and
``detection_map``. Padded [B, ...] batches with explicit length inputs
where the reference has LoD, as in the JAX package.

None of them reads a value on the host (no ``.item()``, no ``nonzero``,
no boolean-mask indexing), so a captured step may hold any of them. The
loops the reference writes as scans run here over one axis only:
``edit_distance`` computes one DP row per hypothesis position, the
row's insertion chain as a running minimum. ``random_crop`` and
``sample_logits`` draw through ``rng_draw``, as dropout does.
``data_norm`` writes its three sums, and ``proximal_gd`` /
``proximal_adagrad`` their parameter and moment, through Out slots that
alias the state vars, as the optimizer ops do.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..op_registry import get, put, register, rng_draw
from .detection_ops import iou_matrix

# jnp.linspace(0.0, 1.0, 11) in f32 (torch.linspace rounds 0.9 the other
# way): the recall points of the 11-point AP
_ELEVEN = [float(v) for v in np.arange(11, dtype=np.float32)
           * np.float32(0.1)]


# ---------------- losses ----------------

@register("rank_loss")
def _rank_loss(env, op):
    """RankNet's pairwise loss log(1 + e^d) - label * d, d = left - right."""
    label = get(env, op.input("Label"))
    d = get(env, op.input("Left")) - get(env, op.input("Right"))
    put(env, op.output("Out"), torch.log1p(torch.exp(d)) - label * d)


@register("modified_huber_loss")
def _modified_huber(env, op):
    x = get(env, op.input("X"))
    z = x * (get(env, op.input("Y")) * 2.0 - 1.0)  # y in {0,1} -> {-1,1}
    put(env, op.output("Out"), torch.where(
        z < -1.0, -4.0 * z, torch.square(torch.clamp_min(1.0 - z, 0.0))))


@register("squared_l2_distance")
def _squared_l2_distance(env, op):
    sub = get(env, op.input("X")) - get(env, op.input("Y"))
    put(env, op.output("sub_result"), sub)
    put(env, op.output("Out"), torch.square(sub).reshape(
        sub.shape[0], -1).sum(dim=1, keepdim=True))


@register("l1_norm")
def _l1_norm(env, op):
    put(env, op.output("Out"),
        torch.abs(get(env, op.input("X"))).sum().reshape(()))


@register("teacher_student_sigmoid_loss")
def _teacher_student_loss(env, op):
    """CTR distillation: a label in (0, 1) is the teacher's soft label,
    any other a hard one (label > 0)."""
    x = get(env, op.input("X")).reshape(-1)
    label = get(env, op.input("Label")).reshape(-1)
    z = torch.clamp(x, op.attr("soft_max_lower_bound", -15.0),
                    op.attr("soft_max_up_bound", 15.0))
    hard = (label <= 0.0) | (label >= 1.0)
    target = torch.where(hard, (label > 0.0).to(x.dtype), label)
    ce = torch.clamp_min(z, 0) - z * target + torch.log1p(
        torch.exp(-torch.abs(z)))
    put(env, op.output("Y"), ce.reshape(-1, 1))


# ---------------- metrics ----------------

@register("mean_iou")
def _mean_iou(env, op):
    """Mean IoU over classes; on a mismatch both the predicted and the
    label class count a wrong, so correct + wrong is the union. The counts
    are sums of ones, exact in f32 in any order."""
    pred = get(env, op.input("Predictions")).reshape(-1).long()
    label = get(env, op.input("Labels")).reshape(-1).long()
    n = op.attr("num_classes")
    dev = pred.device
    zeros = torch.zeros(n, device=dev)
    ones = torch.ones(pred.shape[0], device=dev)
    inter = zeros.index_add(0, pred, (pred == label).to(torch.float32))
    pred_cnt = zeros.index_add(0, pred, ones)
    lbl_cnt = zeros.index_add(0, label, ones)
    wrong = (pred_cnt - inter) + (lbl_cnt - inter)
    correct = inter
    for v in op.input_list("InWrongs"):
        wrong = wrong + get(env, v).to(torch.float32)
    for v in op.input_list("InCorrects"):
        correct = correct + get(env, v).to(torch.float32)
    union = correct + wrong
    valid = union > 0
    iou = torch.where(valid, correct / torch.clamp_min(union, 1.0), 0.0)
    miou = iou.sum() / torch.clamp_min(valid.to(torch.float32).sum(), 1.0)
    put(env, op.output("OutMeanIou"), miou.reshape(()))
    put(env, op.output("OutWrong"), wrong.to(torch.int32))
    put(env, op.output("OutCorrect"), correct.to(torch.int32))


@register("edit_distance")
def _edit_distance(env, op):
    """Levenshtein distance of padded id sequences with lengths
    (``misc_ops.py:107-146``). The reference scans the reference axis
    inside a scan over the hypothesis; here each hypothesis position
    computes its whole DP row at once, for every sequence:

        cand[0] = prev[0] + 1
        cand[j] = min(prev[j] + 1, prev[j-1] + (h[i] != r[j-1]))
        cur[j]  = min_{k <= j} cand[k] + (j - k)
                = j + cummin(cand[k] - k)

    (the insertion chain cur[j] = min(cand[j], cur[j-1] + 1) unrolled).
    Distances are small integers, exact in f32. A row past the
    hypothesis' length stays as it was."""
    hyp = get(env, op.input("Hyps")).to(torch.int32)  # [B, Th]
    ref = get(env, op.input("Refs")).to(torch.int32)  # [B, Tr]
    hyp_len = get(env, op.input("HypsLength")).reshape(-1).to(torch.int64)
    ref_len = get(env, op.input("RefsLength")).reshape(-1).to(torch.int64)
    b, th = hyp.shape
    tr = ref.shape[1]
    dev = hyp.device
    j = torch.arange(tr + 1, dtype=torch.float32, device=dev)
    row = j.expand(b, tr + 1)
    for i in range(th):
        sub = (hyp[:, i:i + 1] != ref).to(torch.float32)  # [B, Tr]
        cand = torch.cat([row[:, :1] + 1.0, torch.minimum(
            row[:, 1:] + 1.0, row[:, :-1] + sub)], dim=1)
        new = torch.cummin(cand - j, dim=1).values + j
        row = torch.where((i < hyp_len)[:, None], new, row)
    d = row.gather(1, ref_len[:, None])
    if op.attr("normalized", False):
        d = d / torch.clamp_min(ref_len[:, None].to(torch.float32), 1.0)
    put(env, op.output("Out"), d.reshape(b, 1))
    put(env, op.output("SequenceNum"),
        torch.full((), b, dtype=torch.int32, device=dev))


_SCHEME_TAGS = {"plain": 1, "IOB": 2, "IOE": 2, "IOBES": 4}


def _shift(t, by):
    """``t`` [B, T] moved ``by`` (+1: right, -1: left) along T, -1 in the
    vacated column."""
    edge = torch.full_like(t[:, :1], -1)
    if by > 0:
        return torch.cat([edge, t[:, :-1]], dim=1)
    return torch.cat([t[:, 1:], edge], dim=1)


def _chunk_marks(tags, valid, scheme, num_types):
    """Per-position (begin, end, type) of CoNLL-style chunks
    (``misc_ops.py:149-182``; ref ``chunk_eval_op.h`` IsChunkBegin/End)."""
    n_tags = _SCHEME_TAGS[scheme]
    typ = torch.where((tags >= 0) & (tags < num_types * n_tags),
                      torch.div(tags, n_tags, rounding_mode="floor"), -1)
    typ = torch.where(valid, typ, -1)
    role = torch.remainder(tags, n_tags)
    prev_t, next_t = _shift(typ, 1), _shift(typ, -1)
    prev_r, next_r = _shift(role, 1), _shift(role, -1)
    in_chunk = typ >= 0
    if scheme == "plain":
        begin = in_chunk & (prev_t != typ)
        end = in_chunk & (next_t != typ)
    elif scheme == "IOB":  # 0=B, 1=I
        begin = in_chunk & ((role == 0) | (prev_t != typ))
        end = in_chunk & ((next_t != typ) | (next_r == 0))
    elif scheme == "IOE":  # 0=I, 1=E
        begin = in_chunk & ((prev_t != typ) | (prev_r == 1))
        end = in_chunk & ((role == 1) | (next_t != typ))
    else:  # IOBES: 0=B, 1=I, 2=E, 3=S
        begin = in_chunk & ((role == 0) | (role == 3) | (prev_t != typ)
                            | (prev_r == 2) | (prev_r == 3))
        end = in_chunk & ((role == 2) | (role == 3) | (next_t != typ)
                          | (next_r == 0) | (next_r == 3))
    return begin, end, typ


def _next_end_pos(end):
    """The first chunk end at or after each position (T for none): a
    running minimum from the right."""
    t = end.shape[1]
    pos = torch.where(end, torch.arange(t, device=end.device)[None, :], t)
    return torch.cummin(pos.flip(1), dim=1).values.flip(1)


@register("chunk_eval")
def _chunk_eval(env, op):
    """Chunk precision / recall / F1 under plain, IOB, IOE or IOBES, with
    ``excluded_chunk_types``, masked by lengths (``misc_ops.py:194-236``):
    an inferred chunk is correct where the label begins a chunk of the same
    type at the same position and both end at the same position."""
    inf = get(env, op.input("Inference")).to(torch.int64)
    lbl = get(env, op.input("Label")).to(torch.int64)
    length = get(env, op.input("SeqLength")).reshape(-1).to(torch.int64)
    num_types = op.attr("num_chunk_types")
    scheme = op.attr("chunk_scheme", "IOB")
    excluded = tuple(op.attr("excluded_chunk_types", ()) or ())
    if inf.dim() == 1:
        inf, lbl = inf[None, :], lbl[None, :]
    t = inf.shape[1]
    valid = torch.arange(t, device=inf.device)[None, :] < length[:, None]
    ib, ie, ityp = _chunk_marks(inf, valid, scheme, num_types)
    lb, le, ltyp = _chunk_marks(lbl, valid, scheme, num_types)
    for e in excluded:
        ib = ib & (ityp != e)
        lb = lb & (ltyp != e)
    n_inf = ib.to(torch.int32).sum()
    n_lbl = lb.to(torch.int32).sum()
    correct = (ib & lb & (ityp == ltyp)
               & (_next_end_pos(ie) == _next_end_pos(le)))
    n_correct = correct.to(torch.int32).sum()
    p = n_correct / torch.clamp_min(n_inf, 1)
    r = n_correct / torch.clamp_min(n_lbl, 1)
    f1 = 2 * p * r / torch.clamp_min(p + r, 1e-8)
    put(env, op.output("Precision"), p.to(torch.float32).reshape(()))
    put(env, op.output("Recall"), r.to(torch.float32).reshape(()))
    put(env, op.output("F1-Score"), f1.to(torch.float32).reshape(()))
    put(env, op.output("NumInferChunks"), n_inf.to(torch.int32))
    put(env, op.output("NumLabelChunks"), n_lbl.to(torch.int32))
    put(env, op.output("NumCorrectChunks"), n_correct.to(torch.int32))


@register("positive_negative_pair")
def _pos_neg_pair(env, op):
    """Pairs of one query ordered by label: counted by the order of their
    scores (higher, lower, tied)."""
    score = get(env, op.input("Score")).reshape(-1)
    label = get(env, op.input("Label")).reshape(-1)
    qid = get(env, op.input("QueryID")).reshape(-1)
    pair = (qid[:, None] == qid[None, :]) & (label[:, None] > label[None, :])
    s1, s2 = score[:, None], score[None, :]
    for slot, rel in (("PositivePair", s1 > s2), ("NegativePair", s1 < s2),
                      ("NeutralPair", s1 == s2)):
        put(env, op.output(slot),
            (pair & rel).to(torch.float32).sum().reshape(()))


# ---------------- image / feature ops ----------------

@register("affine_channel")
def _affine_channel(env, op):
    x = get(env, op.input("X"))
    scale = get(env, op.input("Scale"))
    bias = get(env, op.input("Bias"))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    out = x
    if scale is not None:
        out = out * scale.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    put(env, op.output("Out"), out)


@register("affine_grid")
def _affine_grid(env, op):
    """theta [N, 2, 3] -> the sampling grid [N, H, W, 2] over
    linspace(-1, 1) in both axes."""
    from .nn_ops import jnp_linspace

    theta = get(env, op.input("Theta"))
    h, w = op.attr("output_shape")[-2:]
    ys = jnp_linspace(-1.0, 1.0, h, theta.device)
    xs = jnp_linspace(-1.0, 1.0, w, theta.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # [H, W, 3]
    put(env, op.output("Output"),
        torch.einsum("hwk,nck->nhwc", base.to(theta.dtype), theta))


@register("space_to_depth")
def _space_to_depth(env, op):
    x = get(env, op.input("X"))  # NCHW
    bs = op.attr("blocksize")
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
    put(env, op.output("Out"), x.reshape(n, c * bs * bs, h // bs, w // bs))


@register("shuffle_channel")
def _shuffle_channel(env, op):
    x = get(env, op.input("X"))
    g = op.attr("group")
    n, c, h, w = x.shape
    put(env, op.output("Out"), x.reshape(n, g, c // g, h, w).transpose(
        1, 2).reshape(n, c, h, w))


@register("crop")
def _crop(env, op):
    x = get(env, op.input("X"))
    sl = tuple(slice(o, o + s) for o, s in zip(op.attr("offsets"),
                                               op.attr("shape")))
    put(env, op.output("Out"), x[sl])


@register("pad_constant_like")
def _pad_constant_like(env, op):
    """Y padded at the high end of every axis to X's shape."""
    x = get(env, op.input("X"))
    y = get(env, op.input("Y"))
    pads = []
    for xd, yd in reversed(list(zip(x.shape, y.shape))):
        pads += [0, xd - yd]
    put(env, op.output("Out"),
        F.pad(y, pads, value=op.attr("pad_value", 0.0)))


def _windows_argmax(x, ks, strides, pads):
    """Max over each window of ``x`` [N, C, *S] (-inf padding) and the
    flat index of its first maximum in the unpadded volume
    (``misc_ops.py:352-377``, ``:409-433``)."""
    nd = len(ks)
    sizes = x.shape[2:]
    if any(pads):
        flat = [v for p in reversed(pads) for v in (p, p)]
        x = F.pad(x, flat, value=float("-inf"))
    outs = [(x.shape[2 + i] - ks[i]) // strides[i] + 1 for i in range(nd)]
    offs = np.ndindex(*ks)
    wins = torch.stack([
        x[(slice(None), slice(None)) + tuple(
            slice(o[i], o[i] + strides[i] * outs[i], strides[i])
            for i in range(nd))] for o in offs], dim=-1)
    out = wins.amax(dim=-1)
    arg = wins.argmax(dim=-1)  # the first maximum, as jnp.argmax
    flat_idx = torch.zeros_like(arg)
    for i in range(nd):
        k_rest = int(np.prod(ks[i + 1:]))
        ki = torch.div(arg, k_rest, rounding_mode="floor") % ks[i]
        shape = [1] * (arg.dim())
        shape[2 + i] = -1
        g = torch.arange(outs[i], device=x.device).reshape(shape) \
            * strides[i] + ki - pads[i]
        flat_idx = flat_idx * sizes[i] + g
    return out, flat_idx.to(torch.int32)


def _adaptive_argmax(x, ks):
    """Equal-bin adaptive max with flat indices (divisible sizes)."""
    n, c = x.shape[:2]
    sizes = x.shape[2:]
    nd = len(ks)
    for s, k in zip(sizes, ks):
        assert s % k == 0, "adaptive pool with index needs divisible dims"
    bins = [s // k for s, k in zip(sizes, ks)]
    shape = [n, c]
    for k, b in zip(ks, bins):
        shape += [k, b]
    perm = [0, 1] + [2 + 2 * i for i in range(nd)] \
        + [3 + 2 * i for i in range(nd)]
    xr = x.reshape(shape).permute(perm).reshape(
        [n, c] + list(ks) + [int(np.prod(bins))])
    out = xr.amax(dim=-1)
    arg = xr.argmax(dim=-1)
    flat_idx = torch.zeros_like(arg)
    for i in range(nd):
        b_rest = int(np.prod(bins[i + 1:]))
        bi = torch.div(arg, b_rest, rounding_mode="floor") % bins[i]
        view = [1] * arg.dim()
        view[2 + i] = -1
        g = torch.arange(ks[i], device=x.device).reshape(view) * bins[i] + bi
        flat_idx = flat_idx * sizes[i] + g
    return out, flat_idx.to(torch.int32)


@register("pool_with_index")
def _pool_with_index(env, op):
    """max_pool2d_with_index: Mask holds flat indices into the UNPADDED
    input, the first maximum of each window."""
    x = get(env, op.input("X"))
    ks = list(op.attr("ksize"))
    if op.attr("adaptive", False):
        out, mask = _adaptive_argmax(x, ks[:2])
    else:
        if op.attr("global_pooling", False):
            ks = list(x.shape[2:])
        out, mask = _windows_argmax(
            x, ks, list(op.attr("strides", ks)),
            list(op.attr("paddings", [0, 0])))
    put(env, op.output("Out"), out)
    put(env, op.output("Mask"), mask)


@register("max_pool3d_with_index")
def _max_pool3d_with_index(env, op):
    x = get(env, op.input("X"))
    ks = list(op.attr("ksize"))
    if op.attr("global_pooling", False):
        ks = list(x.shape[2:])
    if op.attr("adaptive", False):
        out, mask = _adaptive_argmax(x, ks)
    else:
        out, mask = _windows_argmax(
            x, ks, list(op.attr("strides", ks)),
            list(op.attr("paddings", [0, 0, 0])))
    put(env, op.output("Out"), out)
    put(env, op.output("Mask"), mask)


@register("unpool")
def _unpool(env, op):
    """Each pooled value written back at its max index."""
    x = get(env, op.input("X"))
    mask = get(env, op.input("Indices")).long()
    oh, ow = op.attr("unpooled_height"), op.attr("unpooled_width")
    n, c = x.shape[:2]
    out = torch.zeros(n, c, oh * ow, dtype=x.dtype, device=x.device).scatter(
        2, mask.reshape(n, c, -1), x.reshape(n, c, -1))
    put(env, op.output("Out"), out.reshape(n, c, oh, ow))


@register("psroi_pool")
def _psroi_pool(env, op):
    """Position-sensitive RoI average pooling (every RoI reads image 0,
    the reference's convention): bin (i, j) of a RoI averages channel
    group (i * pw + j) over the pixels whose rows and columns fall in the
    bin. The bins' row and column masks make the sum two contractions,
    so no [R, C, H, W] mask is formed; the count is the masks' product."""
    x = get(env, op.input("X"))  # [N, C, H, W], C = out_c * ph * pw
    rois = get(env, op.input("ROIs"))  # [R, 4]
    out_c = op.attr("output_channels")
    ph = op.attr("pooled_height")
    pw = op.attr("pooled_width")
    h, w = x.shape[2], x.shape[3]
    r = rois * op.attr("spatial_scale", 1.0)
    x1, y1, x2, y2 = r[:, 0:1], r[:, 1:2], r[:, 2:3], r[:, 3:4]
    # divided by a device tensor: CUDA takes x / <Python number> as x
    # times its reciprocal, which moves a bin edge by a bit, and a floor
    # or ceil of it by a pixel
    bin_w = torch.clamp_min(x2 - x1, 0.1) / torch.full((), pw, dtype=r.dtype,
                                                      device=r.device)
    bin_h = torch.clamp_min(y2 - y1, 0.1) / torch.full((), ph, dtype=r.dtype,
                                                      device=r.device)
    i = torch.arange(ph, device=x.device)[None]
    j = torch.arange(pw, device=x.device)[None]
    ys = torch.arange(h, device=x.device)
    xs = torch.arange(w, device=x.device)
    my = ((ys >= torch.floor(y1 + i * bin_h)[..., None])
          & (ys < torch.ceil(y1 + (i + 1) * bin_h)[..., None])).to(x.dtype)
    mx = ((xs >= torch.floor(x1 + j * bin_w)[..., None])
          & (xs < torch.ceil(x1 + (j + 1) * bin_w)[..., None])).to(x.dtype)
    xg = x[0].reshape(ph, pw, out_c, h, w)
    cols = torch.einsum("ijchw,rjw->rijch", xg, mx)
    sums = torch.einsum("rijch,rih->rcij", cols, my)
    cnt = torch.clamp_min(my.sum(-1)[:, :, None] * mx.sum(-1)[:, None, :],
                          1.0)
    put(env, op.output("Out"), sums / cnt[:, None])


@register("spp")
def _spp(env, op):
    """Spatial pyramid pooling: level l pools 2^l x 2^l bins."""
    x = get(env, op.input("X"))
    ptype = op.attr("pooling_type", "max")
    h, w = x.shape[2], x.shape[3]
    outs = []
    for lv in range(op.attr("pyramid_height")):
        bins = 2 ** lv
        ys = [int(round(i * h / bins)) for i in range(bins + 1)]
        xs = [int(round(i * w / bins)) for i in range(bins + 1)]
        for i in range(bins):
            for j in range(bins):
                patch = x[:, :, ys[i]:max(ys[i + 1], ys[i] + 1),
                          xs[j]:max(xs[j + 1], xs[j] + 1)]
                outs.append(patch.amax(dim=(2, 3)) if ptype == "max"
                            else patch.mean(dim=(2, 3)))
    put(env, op.output("Out"), torch.cat(outs, dim=1))


@register("similarity_focus")
def _similarity_focus(env, op):
    """1 where a selected channel's value is the maximum of its row or its
    column (``misc_ops.py:508-528``)."""
    x = get(env, op.input("X"))  # [N, d1, d2, d3]
    axis = op.attr("axis")
    if axis not in (1, 2, 3):
        raise ValueError("similarity_focus: axis must be 1, 2 or 3")
    perm = {1: (0, 1, 2, 3), 2: (0, 2, 1, 3), 3: (0, 3, 1, 2)}[axis]
    inv = tuple(perm.index(i) for i in range(4))
    xt = x.permute(perm)
    mask = torch.zeros_like(xt)
    for idx in op.attr("indexes"):
        sel = xt[:, idx]  # [N, A, B]
        m = ((sel.amax(dim=2, keepdim=True) == sel)
             | (sel.amax(dim=1, keepdim=True) == sel)).to(xt.dtype)[:, None]
        mask = torch.maximum(mask, m.expand(mask.shape))
    put(env, op.output("Out"), mask.permute(inv))


@register("spectral_norm")
def _spectral_norm(env, op):
    """weight / sigma, sigma from ``power_iters`` power iterations from
    the persisted u and v. As in the reference's static op, the gradient
    flows through the iteration (u and v are not held constant)."""
    w = get(env, op.input("Weight"))
    u = get(env, op.input("U")).reshape(-1)
    v = get(env, op.input("V")).reshape(-1)
    dim = op.attr("dim", 0)
    eps = op.attr("eps", 1e-12)
    mat = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
    for _ in range(max(op.attr("power_iters", 1), 0)):
        v = mat.T @ u
        v = v / torch.clamp_min(torch.linalg.vector_norm(v), eps)
        u = mat @ v
        u = u / torch.clamp_min(torch.linalg.vector_norm(u), eps)
    sigma = u @ mat @ v
    put(env, op.output("Out"), w / torch.clamp_min(sigma, eps))


@register("random_crop")
def _random_crop(env, op):
    """A crop of the trailing axes at uniform offsets. A fixed ``seed``
    attr gives the same offsets every run (a host generator seeded with
    it, so the slice is static); otherwise the offsets are drawn on the
    device from the executor's generator and the crop is a gather."""
    x = get(env, op.input("X"))
    shape = list(op.attr("shape"))
    seed = op.attr("seed", None)
    lead = x.dim() - len(shape)
    if seed is not None:
        gen = torch.Generator().manual_seed(int(seed))
        for i, sd in enumerate(shape):
            xd = x.shape[lead + i]
            o = int(torch.randint(0, xd - sd + 1, (), generator=gen))
            x = x.narrow(lead + i, o, sd)
        put(env, op.output("Out"), x)
        return
    highs = [x.shape[lead + i] - sd + 1 for i, sd in enumerate(shape)]
    starts = rng_draw(env, lambda gen: torch.stack([
        torch.randint(0, hi, (), generator=gen, device=x.device)
        for hi in highs]))
    for i, sd in enumerate(shape):
        x = x.index_select(lead + i, starts[i] + torch.arange(
            sd, device=x.device))
    put(env, op.output("Out"), x)


# ---------------- misc tensor ops ----------------

@register("multiplex")
def _multiplex(env, op):
    """out[i] = X[ids[i]][i]."""
    ids = get(env, op.input("Ids")).reshape(-1).long()
    stacked = torch.stack([get(env, v) for v in op.input_list("X")])
    put(env, op.output("Out"),
        stacked[ids, torch.arange(ids.shape[0], device=ids.device)])


@register("is_empty")
def _is_empty(env, op):
    x = get(env, op.input("X"))
    put(env, op.output("Out"), torch.full((), x.numel() == 0,
                                          dtype=torch.bool, device=x.device))


@register("minus")
def _minus(env, op):
    put(env, op.output("Out"),
        get(env, op.input("X")) - get(env, op.input("Y")))


@register("selu")
def _selu(env, op):
    x = get(env, op.input("X"))
    scale = op.attr("scale", 1.0507009873554805)
    alpha = op.attr("alpha", 1.6732632423543772)
    put(env, op.output("Out"),
        scale * torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0)))


@register("bilinear_tensor_product")
def _bilinear_tensor_product(env, op):
    """out_k = x W_k y^T + b_k."""
    x = get(env, op.input("X"))  # [B, M]
    y = get(env, op.input("Y"))  # [B, N]
    out = torch.einsum("bm,kmn,bn->bk", x, get(env, op.input("Weight")), y)
    bias = get(env, op.input("Bias"))
    if bias is not None:
        out = out + bias.reshape(1, -1)
    put(env, op.output("Out"), out)


@register("add_position_encoding")
def _add_position_encoding(env, op):
    """alpha * x + beta * [sin | cos](pos / 10000^(k / (D/2 - 1))): the
    reference kernel's exponent k / (half - 1), not 2k / D."""
    x = get(env, op.input("X"))  # [B, T, D]
    t, d = x.shape[1], x.shape[2]
    if d % 2:
        raise ValueError(
            "add_position_encoding requires an even encode size; got %d "
            "(ref enforces enc_size %% 2 == 0)" % d)
    half = d // 2
    # the table in f64, rounded once: f32 sines of angles up to T differ
    # between libraries by an ulp of the angle
    pos = torch.arange(t, dtype=torch.float64, device=x.device)[:, None]
    i = torch.arange(half, dtype=torch.float64, device=x.device)[None, :]
    angle = pos / torch.pow(10000.0, i / float(max(half - 1, 1)))
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], dim=1).to(x.dtype)
    put(env, op.output("Out"), op.attr("alpha", 1.0) * x
        + op.attr("beta", 1.0) * pe[None])


@register("conv_shift")
def _conv_shift(env, op):
    """Circular correlation of x [B, M] with y [B, N], N odd."""
    x = get(env, op.input("X"))
    y = get(env, op.input("Y"))
    m, n = x.shape[1], y.shape[1]
    half = n // 2
    idx = (torch.arange(m, device=x.device)[:, None]
           + torch.arange(-half, half + 1, device=x.device)[None, :]) % m
    put(env, op.output("Out"), torch.einsum("bmn,bn->bm", x[:, idx], y))


@register("hash")
def _hash(env, op):
    """num_hash multiplicative hashes in wrapping uint32, each taken
    modulo ``mod_by`` (``misc_ops.py:648-661``): the product runs in int64
    and keeps its low 32 bits (a wrap above bit 63 leaves them as they
    are), so every id equals the reference's bit for bit."""
    x = get(env, op.input("X")).to(torch.int64) & 0xFFFFFFFF
    mod = op.attr("mod_by", 100000007)
    outs = []
    for i in range(op.attr("num_hash", 1)):
        seed = (0x9E3779B1 + i * 0x85EBCA77) & 0xFFFFFFFF
        h = (x * seed) & 0xFFFFFFFF
        outs.append(torch.remainder(h, mod).to(torch.int32))
    put(env, op.output("Out"), torch.stack(outs, dim=-2))


@register("data_norm")
def _data_norm(env, op):
    """Normalisation by the accumulated batch sums (CTR models); the
    ``*Out`` slots alias the three persistable sums, which the step
    writes like batch_norm's moving statistics."""
    x = get(env, op.input("X"))
    size = get(env, op.input("BatchSize"))
    total = get(env, op.input("BatchSum"))
    sq = get(env, op.input("BatchSquareSum"))
    mean = total / torch.clamp_min(size, 1e-4)
    var = sq / torch.clamp_min(size, 1e-4) - torch.square(mean)
    scale = torch.rsqrt(torch.clamp_min(var, 1e-4))
    put(env, op.output("Y"), (x - mean) * scale)
    put(env, op.output("Means"), mean)
    put(env, op.output("Scales"), scale)
    put(env, op.output("BatchSizeOut"), size + x.shape[0])
    put(env, op.output("BatchSumOut"), total + x.sum(dim=0))
    put(env, op.output("BatchSquareSumOut"),
        sq + torch.square(x).sum(dim=0))


# ---------------- sequence utilities ----------------

@register("sequence_expand_as")
def _sequence_expand_as(env, op):
    """Each row of X repeated to its Y row's length, zero past it."""
    x = get(env, op.input("X"))  # [B, ...]
    y_len = get(env, op.input("YLength")).reshape(-1)
    maxlen = op.attr("maxlen")
    tiled = x[:, None].expand((x.shape[0], maxlen) + tuple(x.shape[1:]))
    mask = torch.arange(maxlen, device=x.device)[None, :] < y_len[:, None]
    put(env, op.output("Out"), tiled * mask.reshape(
        tuple(mask.shape) + (1,) * (x.dim() - 1)).to(x.dtype))


@register("sequence_reshape")
def _sequence_reshape(env, op):
    x = get(env, op.input("X"))  # [B, T, D]
    put(env, op.output("Out"), x.reshape(x.shape[0], -1, op.attr("new_dim")))


@register("sequence_scatter")
def _sequence_scatter(env, op):
    """x[b, ids[b, t]] += updates[b, t] (times Mask); repeated ids add."""
    x = get(env, op.input("X"))  # [B, D]
    ids = get(env, op.input("Ids")).long()  # [B, T]
    upd = get(env, op.input("Updates"))
    mask = get(env, op.input("Mask"))
    if mask is not None:
        upd = upd * mask
    put(env, op.output("Out"), x.scatter_add(1, ids, upd.to(x.dtype)))


# ---------------- optimizer extras ----------------

def _prox(p, step, g, l1, l2):
    prox = p - step * g
    return torch.sign(prox) * torch.clamp_min(
        torch.abs(prox) - step * l1, 0.0) / (1.0 + step * l2)


@register("proximal_gd")
def _proximal_gd(env, op):
    """The proximal step with L1 / L2 (``proximal_gd_op.cc``)."""
    put(env, op.output("ParamOut"), _prox(
        get(env, op.input("Param")),
        get(env, op.input("LearningRate")).reshape(()),
        get(env, op.input("Grad")), op.attr("l1", 0.0), op.attr("l2", 0.0)))


@register("proximal_adagrad")
def _proximal_adagrad(env, op):
    g = get(env, op.input("Grad"))
    m_new = get(env, op.input("Moment")) + g * g
    lr = get(env, op.input("LearningRate")).reshape(())
    put(env, op.output("ParamOut"), _prox(
        get(env, op.input("Param")), lr / torch.sqrt(m_new + 1e-10), g,
        op.attr("l1", 0.0), op.attr("l2", 0.0)))
    put(env, op.output("MomentOut"), m_new)


@register("sample_logits")
def _sample_logits(env, op):
    """The true class's and ``num_samples`` uniformly drawn classes'
    logits, less log q (q = num / C) in every column."""
    logits = get(env, op.input("Logits"))  # [B, C]
    labels = get(env, op.input("Labels"))  # [B, 1]
    num = op.attr("num_samples")
    b, c = logits.shape
    samples = rng_draw(env, lambda gen: torch.randint(
        0, c, (b, num), generator=gen, device=logits.device))
    all_idx = torch.cat([labels.reshape(b, 1).long(), samples], dim=1)
    logq = float(np.log(max(num, 1) / float(c)))
    put(env, op.output("SampledLogits"), logits.gather(1, all_idx) - logq)
    put(env, op.output("Samples"), all_idx.to(torch.int32))
    put(env, op.output("SampledLabels"),
        torch.zeros(b, dtype=torch.int32, device=logits.device))


@register("lstm_unit")
def _lstm_unit(env, op):
    """One LSTM cell step from [B, 4H] pre-activations (i, f, o, j)."""
    x = get(env, op.input("X"))
    c_prev = get(env, op.input("C_prev"))
    i, f, o, j = torch.chunk(x, 4, dim=1)
    c = (c_prev * torch.sigmoid(f + op.attr("forget_bias", 0.0))
         + torch.sigmoid(i) * torch.tanh(j))
    put(env, op.output("C"), c)
    put(env, op.output("H"), torch.tanh(c) * torch.sigmoid(o))


@register("ctc_align")
def _ctc_align(env, op):
    """CTC greedy post-processing: merge repeats, drop blanks, the kept
    ids front-compacted in order (a stable sort) and padded with
    ``padding_value``; OutputLength counts them."""
    x = get(env, op.input("Input")).to(torch.int32)  # [B, T]
    lens = get(env, op.input("InputLength"))
    pad_val = op.attr("padding_value", 0)
    b, t = x.shape
    pos = torch.arange(t, device=x.device)[None, :]
    valid = (torch.ones_like(x, dtype=torch.bool) if lens is None
             else pos < lens.reshape(-1, 1))
    keep = valid & (x != op.attr("blank", 0)) & (
        (pos == 0) | (x != torch.roll(x, 1, dims=1)))
    order = torch.sort(torch.where(keep, pos, t + pos), dim=1,
                       stable=True).indices
    n_keep = keep.to(torch.int32).sum(dim=1, dtype=torch.int32)
    out = torch.where(pos < n_keep[:, None], x.gather(1, order),
                      torch.full_like(x, pad_val))
    put(env, op.output("Output"), out)
    put(env, op.output("OutputLength"), n_keep)


@register("detection_map")
def _detection_map(env, op):
    """Ref ``detection_map_op.cc``: mean average precision over classes.
    Fixed-shape inputs (the reference's redesign of the LoD ones):
    DetectRes [N, D, 6] (label, score, x1, y1, x2, y2; label < 0 pads),
    GtLabel [N, G], GtBox [N, G, 4] (zero-area rows pad); 'integral' or
    '11point' AP.

    The reference walks every detection in score order (a ``lax.scan`` a
    class): a detection matches only its argmax-IoU gt of its class, and
    is a true positive if that gt was not consumed by a higher-scored
    detection. Only a detection that could hit (its overlap reaches the
    threshold) consumes its gt, so the detection that hits a gt is the
    first such detection in score order with that (class, image, gt): the
    walk is one ``scatter_reduce`` of positions, with no loop."""
    det = get(env, op.input("DetectRes"))
    gt_label = get(env, op.input("GtLabel")).to(torch.int64)
    gt_box = get(env, op.input("GtBox"))
    iou_t = op.attr("overlap_threshold", 0.5)
    class_num = int(op.attr("class_num"))
    bg = op.attr("background_label", 0)
    n, d_cnt, _ = det.shape
    g_cnt = gt_box.shape[1]
    dev = det.device
    gt_valid = (gt_box[..., 2] > gt_box[..., 0]) \
        & (gt_box[..., 3] > gt_box[..., 1])
    # every detection with its image, all sorted by score (stable)
    img = torch.arange(n, device=dev).repeat_interleave(d_cnt)
    dl = det[..., 0].reshape(-1).to(torch.int64)
    ds = det[..., 1].reshape(-1)
    db = det[..., 2:].reshape(-1, 4)
    d_valid = dl >= 0
    order = torch.argsort(torch.where(d_valid, -ds, torch.inf), stable=True)
    img, dl, db, d_valid = img[order], dl[order], db[order], d_valid[order]
    ious = iou_matrix(db[:, None], gt_box[img], norm=False)[:, 0]  # [ND, G]
    same = (gt_label[img] == dl[:, None]) & gt_valid[img]
    cand = torch.where(same, ious, -1.0)
    j = cand.argmax(dim=1)
    could_hit = (cand.gather(1, j[:, None])[:, 0] >= iou_t) & d_valid \
        & (dl < class_num) & (dl != bg)
    nd = dl.shape[0]
    pos = torch.arange(nd, device=dev)
    key = torch.where(could_hit, (dl * n + img) * g_cnt + j,
                      class_num * n * g_cnt)
    first = torch.full((class_num * n * g_cnt + 1,), nd, device=dev,
                       dtype=torch.int64).scatter_reduce(
        0, key, torch.where(could_hit, pos, nd), "amin")
    hit = (could_hit & (first[key] == pos)).to(torch.float32)
    # every class at once, [K, ND]; the background class is not evaluated
    cid = torch.arange(class_num, device=dev)
    is_c = d_valid & (dl == cid[:, None])
    n_gt = ((gt_label == cid[:, None, None]) & gt_valid).sum(dim=(1, 2))
    ctp = torch.cumsum(torch.where(is_c, hit, 0.0), dim=1)
    cfp = torch.cumsum(torch.where(is_c, 1.0 - hit, 0.0), dim=1)
    recall = ctp / torch.clamp_min(n_gt, 1)[:, None]
    precision = ctp / torch.clamp_min(ctp + cfp, 1e-9)
    if op.attr("ap_type", "integral") == "11point":
        ap = torch.stack([torch.where(recall >= r, precision, 0.0).amax(1)
                          for r in _ELEVEN], dim=1).mean(dim=1)
    else:  # integral
        d_rec = torch.diff(recall, dim=1,
                           prepend=torch.zeros_like(recall[:, :1]))
        ap = torch.sum(precision * d_rec * is_c, dim=1)
    present = (n_gt > 0) & (cid != bg)
    m_ap = torch.where(present, ap, 0.0).sum() / torch.clamp_min(
        present.to(torch.float32).sum(), 1.0)
    put(env, op.output("MAP"), m_ap.reshape(()))
