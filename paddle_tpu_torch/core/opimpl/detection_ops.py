"""Detection ops (the port's ``paddle_tpu/core/opimpl/detection_ops.py``;
ref ``paddle/fluid/operators/detection/``).

The reference's redesigns of the LoD ops are kept as they are: NMS-style
ops give fixed-shape outputs padded with -1 (or 0) beside a ``Count``,
``mine_hard_examples`` marks kept negatives -1 and dropped ones -2,
``rpn_target_assign`` and ``generate_proposal_labels`` sample by rank
instead of at random, ``generate_mask_labels`` rasterizes polygons by the
even-odd rule. Everything there is ``jnp``/``lax``, so plain PyTorch here,
batched over images (and classes) as the reference ``vmap``s; a
``fori_loop`` becomes a Python loop over the same static trip count. No op
reads a value on the host, so a captured step may hold any of them.

Tie orders follow the reference: ``lax.top_k`` puts the lower index first
(``decode_ops.top_k_stable``), ``jnp.argsort`` is stable and
``jnp.argmax`` takes the first maximum, as ``torch.argmax`` does. The
constant grids (``prior_box``, ``density_prior_box``,
``anchor_generator``) and the anchor tables an op carries in its attrs
are built on the host and copied to the device once per op and device,
in the op's first (interpreted) run.
"""

import numpy as np
import torch

from ..op_registry import get, put, register
from .decode_ops import top_k_stable
from .loss_ops import _op_table

_INF = float("inf")


def exp_once(x):
    """``exp(x)`` taken in f64 and rounded once to x's dtype: the card and
    the host then decode the same boxes bitwise (their f32 ``exp``s differ
    in the last bit), so the NMS that follows takes the same decisions on
    both."""
    return torch.exp(x.to(torch.float64)).to(x.dtype)


def _const(op, key, device, make):
    """``make(cpu)`` (tensors built on the host from the op's attrs and
    static shapes), copied to ``device`` once per (op, ``key``, device),
    outside inference mode so that both a training step and an eval pass
    may read it. Built on the host for every device: CUDA divides by a
    Python number through its reciprocal, the host divides, so a grid
    built on each would differ in the last bit."""
    def build():
        with torch.inference_mode(False), torch.no_grad():
            out = make(torch.device("cpu"))
            if isinstance(out, tuple):
                return tuple(t.to(device) for t in out)
            return out.to(device)

    return _op_table(op, (key, str(device)), build)


def _bcast_const(values, shape, device):
    """[*shape, len(values)] holding ``values`` (Python floats) along the
    last axis, made by fills (no copy from the host)."""
    return torch.stack([torch.full(shape, float(v), dtype=torch.float32,
                                   device=device) for v in values], dim=-1)


@register("iou_similarity")
def _iou_similarity(env, op):
    x = get(env, op.input("X"))  # [N, 4] xmin ymin xmax ymax
    y = get(env, op.input("Y"))  # [M, 4]
    area_x = (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    area_y = (y[:, 2] - y[:, 0]) * (y[:, 3] - y[:, 1])
    lt = torch.maximum(x[:, None, :2], y[None, :, :2])
    rb = torch.minimum(x[:, None, 2:], y[None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_x[:, None] + area_y[None, :] - inter
    put(env, op.output("Out"), inter / torch.clamp_min(union, 1e-10))


@register("box_coder")
def _box_coder(env, op):
    prior = get(env, op.input("PriorBox"))  # [M, 4]
    pvar = get(env, op.input("PriorBoxVar"))
    target = get(env, op.input("TargetBox"))
    code_type = op.attr("code_type", "encode_center_size")
    one = 0.0 if op.attr("box_normalized", True) else 1.0
    pw = prior[:, 2] - prior[:, 0] + one
    ph = prior[:, 3] - prior[:, 1] + one
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    if pvar is None:
        v0 = v1 = v2 = v3 = 1.0
    elif pvar.dim() == 2:
        v0, v1, v2, v3 = pvar[:, 0], pvar[:, 1], pvar[:, 2], pvar[:, 3]
    else:
        v0, v1, v2, v3 = pvar[0], pvar[1], pvar[2], pvar[3]
    if code_type == "encode_center_size":
        tw = target[:, 2] - target[:, 0] + one
        th = target[:, 3] - target[:, 1] + one
        tcx = target[:, 0] + tw * 0.5
        tcy = target[:, 1] + th * 0.5
        ox = (tcx[:, None] - pcx[None, :]) / pw[None, :] / v0
        oy = (tcy[:, None] - pcy[None, :]) / ph[None, :] / v1
        ow = torch.log(tw[:, None] / pw[None, :]) / v2
        oh = torch.log(th[:, None] / ph[None, :]) / v3
        put(env, op.output("OutputBox"),
            torch.stack([ox, oy, ow, oh], dim=-1))
    else:  # decode_center_size; target [N, M, 4]
        ox = v0 * target[..., 0] * pw + pcx
        oy = v1 * target[..., 1] * ph + pcy
        ow = exp_once(v2 * target[..., 2]) * pw
        oh = exp_once(v3 * target[..., 3]) * ph
        put(env, op.output("OutputBox"), torch.stack(
            [ox - ow * 0.5, oy - oh * 0.5, ox + ow * 0.5 - one,
             oy + oh * 0.5 - one], dim=-1))


def _cell_centers(h, w, step_w, step_h, offset, device):
    """[H, W] x and y centers of a feature map's cells, in image units."""
    cx = (torch.arange(w, dtype=torch.float32, device=device) + offset) \
        * step_w
    cy = (torch.arange(h, dtype=torch.float32, device=device) + offset) \
        * step_h
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    return cxg, cyg


@register("prior_box")
def _prior_box(env, op):
    feat = get(env, op.input("Input"))  # NCHW feature map
    img = get(env, op.input("Image"))
    h, w = feat.shape[2], feat.shape[3]
    img_h, img_w = img.shape[2], img.shape[3]

    def make(dev):
        min_sizes = op.attr("min_sizes")
        max_sizes = op.attr("max_sizes", [])
        flip = op.attr("flip", False)
        sw = op.attr("step_w", 0.0) or img_w / w
        sh = op.attr("step_h", 0.0) or img_h / h
        ars = [1.0]
        for r in op.attr("aspect_ratios", [1.0]):
            if all(abs(r - a) > 1e-6 for a in ars):
                ars.append(r)
                if flip:
                    ars.append(1.0 / r)
        boxes = []
        for ms in min_sizes:
            for ar in ars:
                boxes.append((ms * np.sqrt(ar) * 0.5, ms / np.sqrt(ar) * 0.5))
            for mxs in max_sizes or []:
                s = np.sqrt(ms * mxs) * 0.5
                boxes.append((s, s))
        # each half size rounded to f32 first, as a numpy scalar meets a
        # jnp f32 array in the reference
        boxes = [(float(np.float32(bw)), float(np.float32(bh)))
                 for bw, bh in boxes]
        cxg, cyg = _cell_centers(h, w, sw, sh, op.attr("offset", 0.5), dev)
        out = torch.stack([torch.stack(
            [(cxg - bw) / img_w, (cyg - bh) / img_h, (cxg + bw) / img_w,
             (cyg + bh) / img_h], dim=-1) for bw, bh in boxes], dim=2)
        if op.attr("clip", False):
            out = out.clamp(0.0, 1.0)
        var = _bcast_const(op.attr("variances", [0.1, 0.1, 0.2, 0.2]),
                           tuple(out.shape[:-1]), dev)
        return out, var

    out, var = _const(op, ("prior_box", h, w, img_h, img_w), feat.device,
                      make)
    put(env, op.output("Boxes"), out)
    put(env, op.output("Variances"), var)


@register("density_prior_box")
def _density_prior_box(env, op):
    """Ref ``density_prior_box_op.cc``: dense anchor grid from fixed sizes
    x fixed ratios x densities per cell; the density grid steps by the
    average of the two steps (``step_average``)."""
    feat = get(env, op.input("Input"))   # [N, C, H, W]
    image = get(env, op.input("Image"))  # [N, C, IH, IW]
    h, w = feat.shape[2], feat.shape[3]
    ih, iw = image.shape[2], image.shape[3]

    def make(dev):
        sw, sh = op.attr("step_w", 0.0), op.attr("step_h", 0.0)
        step_w = sw if sw > 0 else iw / w
        step_h = sh if sh > 0 else ih / h
        step_avg = 0.5 * (step_w + step_h)
        cells = []
        for size, density in zip(op.attr("fixed_sizes") or [],
                                 op.attr("densities") or []):
            shift = int(step_avg / density)
            for r in op.attr("fixed_ratios") or [1.0]:
                bw, bh = size * np.sqrt(r), size / np.sqrt(r)
                for di in range(density):
                    for dj in range(density):
                        cells.append((shift / 2.0 + dj * shift
                                      - step_avg * 0.5,
                                      shift / 2.0 + di * shift
                                      - step_avg * 0.5, bw, bh))
        # the reference holds the per-cell table as f32 and halves the
        # f32 sizes
        cells = [[float(np.float32(v)) for v in c] for c in cells]
        cx, cy = _cell_centers(h, w, step_w, step_h, op.attr("offset", 0.5),
                               dev)
        boxes = []
        for cx_off, cy_off, bw, bh in cells:
            ccx, ccy = cx + cx_off, cy + cy_off
            hw = float(np.float32(bw) * np.float32(0.5))
            hh = float(np.float32(bh) * np.float32(0.5))
            boxes.append(torch.stack([(ccx - hw) / iw, (ccy - hh) / ih,
                                      (ccx + hw) / iw, (ccy + hh) / ih],
                                     dim=-1))
        out = (torch.stack(boxes, dim=2) if boxes else
               torch.zeros((h, w, 0, 4), device=dev))
        if op.attr("clip", False):
            out = out.clamp(0.0, 1.0)
        var = _bcast_const(op.attr("variances") or [0.1, 0.1, 0.2, 0.2],
                           tuple(out.shape[:-1]), dev)
        return out, var

    out, var = _const(op, ("density_prior_box", h, w, ih, iw), feat.device,
                      make)
    put(env, op.output("Boxes"), out)
    put(env, op.output("Variances"), var)


@register("anchor_generator")
def _anchor_generator(env, op):
    feat = get(env, op.input("Input"))
    h, w = feat.shape[2], feat.shape[3]

    def make(dev):
        stride = op.attr("stride")
        cxg, cyg = _cell_centers(h, w, stride[0], stride[1],
                                 op.attr("offset", 0.5), dev)
        anchors = []
        for r in op.attr("aspect_ratios"):
            for s in op.attr("anchor_sizes"):
                aw = float(np.float32(s * np.sqrt(1.0 / r) * 0.5))
                ah = float(np.float32(s * np.sqrt(r) * 0.5))
                anchors.append(torch.stack(
                    [cxg - aw, cyg - ah, cxg + aw, cyg + ah], dim=-1))
        out = torch.stack(anchors, dim=2)
        var = _bcast_const(op.attr("variances", [0.1, 0.1, 0.2, 0.2]),
                           tuple(out.shape[:-1]), dev)
        return out, var

    out, var = _const(op, ("anchor_generator", h, w), feat.device, make)
    put(env, op.output("Anchors"), out)
    put(env, op.output("Variances"), var)


# ---------------------------------------------------------------------------
# ROI ops. As in the reference, every RoI reads image 0 of X.
# ---------------------------------------------------------------------------

def _bilinear(img, ys, xs):
    """Bilinear samples of ``img`` [C, H, W] at rows ``ys`` [R, P, Q] and
    columns ``xs`` (broadcastable), each clamped into the map as the
    reference clamps its corners: [R, P, Q, C] (channels last, so every
    gather reads whole rows of C)."""
    h, w = img.shape[1], img.shape[2]
    y0 = torch.floor(ys).to(torch.int64).clamp(0, h - 1)
    x0 = torch.floor(xs).to(torch.int64).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]
    flat = img.permute(1, 2, 0).reshape(h * w, -1)

    def g(yy, xx):
        idx = (yy * w + xx).expand(torch.broadcast_shapes(yy.shape,
                                                          xx.shape))
        return flat.index_select(0, idx.reshape(-1)).reshape(
            tuple(idx.shape) + (flat.shape[1],))

    return (g(y0, x0) * (1 - wy) * (1 - wx) + g(y1, x0) * wy * (1 - wx)
            + g(y0, x1) * (1 - wy) * wx + g(y1, x1) * wy * wx)


@register("roi_align")
def _roi_align(env, op):
    x = get(env, op.input("X"))  # [N, C, H, W]
    rois = get(env, op.input("ROIs"))  # [R, 4] in image coords; image 0
    pooled_h = op.attr("pooled_height", 1)
    pooled_w = op.attr("pooled_width", 1)
    r = rois * op.attr("spatial_scale", 1.0)
    x1, y1, x2, y2 = r[:, 0:1], r[:, 1:2], r[:, 2:3], r[:, 3:4]
    rw = torch.clamp_min(x2 - x1, 1.0)
    rh = torch.clamp_min(y2 - y1, 1.0)
    ph = torch.arange(pooled_h, dtype=r.dtype, device=r.device) + 0.5
    pw = torch.arange(pooled_w, dtype=r.dtype, device=r.device) + 0.5
    ys = y1 + ph[None] * rh / pooled_h   # [R, ph]
    xs = x1 + pw[None] * rw / pooled_w   # [R, pw]
    out = _bilinear(x[0], ys[:, :, None], xs[:, None, :])
    put(env, op.output("Out"), out.permute(0, 3, 1, 2))


def _floor_div(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _range_max_table(img):
    """A 2-D sparse table of ``img`` [C, H, W]: [LH, LW, H, W, C] (channels
    last) whose [kh, kw, y, x] holds the max over rows [y, y + 2^kh) and
    columns [x, x + 2^kw) (entries whose window leaves the map repeat its
    edge; a query never reads them)."""
    h, w = img.shape[1], img.shape[2]
    lh, lw = h.bit_length(), w.bit_length()
    col = torch.arange(w, device=img.device)
    row = torch.arange(h, device=img.device)
    levels_w = [img.permute(1, 2, 0)]
    for k in range(1, lw):
        s = 1 << (k - 1)
        prev = levels_w[-1]
        levels_w.append(torch.maximum(
            prev, prev.index_select(1, (col + s).clamp_max(w - 1))))
    levels = []
    for t_w in levels_w:
        levels_h = [t_w]
        for k in range(1, lh):
            s = 1 << (k - 1)
            prev = levels_h[-1]
            levels_h.append(torch.maximum(
                prev, prev.index_select(0, (row + s).clamp_max(h - 1))))
        levels.append(torch.stack(levels_h))
    return torch.stack(levels, dim=1), lh, lw


def _log2_floor(n, levels):
    """floor(log2(n)) of positive int tensors below 2^levels, by
    comparisons (exact)."""
    k = torch.zeros_like(n)
    for t in range(1, levels):
        k = k + (n >= (1 << t)).to(n.dtype)
    return k


@register("roi_pool")
def _roi_pool(env, op):
    """Max over each bin's integer rectangle (the reference's masked max
    per bin). The rectangle's max comes from a 2-D sparse table of the
    map: four overlapping power-of-two windows that cover it exactly, so
    the value is the reference's max, bitwise, and a bin holding no pixel
    of the map gives -inf, as there. The gradient goes to the maximum's
    element (``torch.maximum`` splits a tie of one element with itself
    evenly over its windows)."""
    x = get(env, op.input("X"))
    rois = get(env, op.input("ROIs"))
    pooled_h = op.attr("pooled_height", 1)
    pooled_w = op.attr("pooled_width", 1)
    scale = op.attr("spatial_scale", 1.0)
    c, h, w = x.shape[1], x.shape[2], x.shape[3]
    q = torch.round(rois * scale).to(torch.int64)  # half to even, as jnp
    x1, y1, x2, y2 = q[:, 0:1], q[:, 1:2], q[:, 2:3], q[:, 3:4]
    rh = torch.clamp_min(y2 - y1 + 1, 1)
    rw = torch.clamp_min(x2 - x1 + 1, 1)
    pi = torch.arange(pooled_h, device=x.device)[None]
    pj = torch.arange(pooled_w, device=x.device)[None]
    ys_lo = y1 + _floor_div(pi * rh, pooled_h)
    ys_hi = torch.maximum(y1 + _floor_div((pi + 1) * rh + pooled_h - 1,
                                          pooled_h), ys_lo + 1)
    xs_lo = x1 + _floor_div(pj * rw, pooled_w)
    xs_hi = torch.maximum(x1 + _floor_div((pj + 1) * rw + pooled_w - 1,
                                          pooled_w), xs_lo + 1)
    # the rows and columns of each bin that lie in the map: [a, b) x [c, d)
    a, b = ys_lo.clamp(0, h), ys_hi.clamp(0, h)        # [R, ph]
    cc, d = xs_lo.clamp(0, w), xs_hi.clamp(0, w)       # [R, pw]
    empty = (b <= a)[:, :, None] | (d <= cc)[:, None, :]
    table, lh, lw = _range_max_table(x[0])
    kh = _log2_floor(torch.clamp_min(b - a, 1), lh)
    kw = _log2_floor(torch.clamp_min(d - cc, 1), lw)
    y_lo, y_hi = a.clamp_max(h - 1), torch.clamp_min(b - (1 << kh), 0)
    x_lo, x_hi = cc.clamp_max(w - 1), torch.clamp_min(d - (1 << kw), 0)
    flat = table.reshape(-1, c)
    base = (kh[:, :, None] * lw + kw[:, None, :]) * (h * w)  # [R, ph, pw]

    def q_at(yy, xx):
        idx = base + yy[:, :, None] * w + xx[:, None, :]
        return flat.index_select(0, idx.reshape(-1)).reshape(
            tuple(idx.shape) + (c,))

    out = torch.maximum(torch.maximum(q_at(y_lo, x_lo), q_at(y_hi, x_lo)),
                        torch.maximum(q_at(y_lo, x_hi), q_at(y_hi, x_hi)))
    out = torch.where(empty[..., None], -_INF, out)
    put(env, op.output("Out"), out.permute(0, 3, 1, 2))


@register("roi_perspective_transform")
def _roi_perspective_transform(env, op):
    """Ref ``roi_perspective_transform_op.cc``: warp quadrilateral RoIs to
    a fixed rectangle by the perspective transform (an 8x8 solve a RoI,
    ``linalg.solve_ex``: no host check), bilinear-sampled. The solve and
    the projection run in f64 and the sample points are rounded once to
    f32: the card's and the host's f32 solves of these ill-conditioned
    systems (entries up to the squared coordinates) differ by 1e-4 pixel
    at a 128-pixel map."""
    x = get(env, op.input("X"))          # [N, C, H, W]
    rois = get(env, op.input("ROIs"))    # [R, 8] quad corners
    oh = op.attr("transformed_height")
    ow = op.attr("transformed_width")
    h, w = x.shape[2], x.shape[3]
    dst = (rois.reshape(-1, 4, 2) * op.attr("spatial_scale", 1.0)).to(
        torch.float64)
    src = ((0.0, 0.0), (ow - 1.0, 0.0), (ow - 1.0, oh - 1.0),
           (0.0, oh - 1.0))
    zero = torch.zeros_like(dst[:, 0, 0])
    rows = []
    for i, (sx, sy) in enumerate(src):
        dx, dy = dst[:, i, 0], dst[:, i, 1]
        rows.append(torch.stack([zero + sx, zero + sy, zero + 1, zero, zero,
                                 zero, -dx * sx, -dx * sy], dim=-1))
        rows.append(torch.stack([zero, zero, zero, zero + sx, zero + sy,
                                 zero + 1, -dy * sx, -dy * sy], dim=-1))
    hvec = torch.linalg.solve_ex(torch.stack(rows, dim=1),
                                 dst.reshape(-1, 8))[0]
    hm = torch.cat([hvec, torch.ones_like(hvec[:, :1])], dim=1).reshape(
        -1, 3, 3)
    ys, xs = torch.meshgrid(torch.arange(oh, dtype=dst.dtype,
                                         device=x.device),
                            torch.arange(ow, dtype=dst.dtype,
                                         device=x.device), indexing="ij")
    pts = torch.matmul(torch.stack([xs, ys, torch.ones_like(xs)], dim=-1),
                       hm.transpose(1, 2)[:, None])  # [R, oh, ow, 3]
    den = torch.clamp_min(pts[..., 2], 1e-8)
    px = (pts[..., 0] / den).to(x.dtype)
    py = (pts[..., 1] / den).to(x.dtype)
    out = _bilinear(x[0], py, px)
    inside = (px >= 0) & (px <= w - 1) & (py >= 0) & (py <= h - 1)
    put(env, op.output("Out"),
        (out * inside[..., None].to(out.dtype)).permute(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# NMS family (ref multiclass_nms_op.cc, generate_proposals_op.cc)
# ---------------------------------------------------------------------------

def iou_matrix(a, b, norm=True):
    """[..., M, 4] x [..., N, 4] -> [..., M, N] IoU (the reference's
    ``_iou_matrix``, same arithmetic)."""
    one = 0.0 if norm else 1.0

    def area(t):
        return (t[..., 2] - t[..., 0] + one) * (t[..., 3] - t[..., 1] + one)

    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt + one, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return inter / torch.clamp_min(union, 1e-10)


def _nms_iou(boxes, norm=True):
    """``iou_matrix(boxes, boxes)`` [B, M, M] for the NMS's decisions only
    (no gradient), built in place so that its peak is a few [B, M, M]
    buffers rather than the [B, M, M, 2] corner pairs."""
    one = 0.0 if norm else 1.0
    with torch.no_grad():
        x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
        iw = torch.minimum(x2[..., :, None], x2[..., None, :])
        iw.sub_(torch.maximum(x1[..., :, None], x1[..., None, :]))
        ih = torch.minimum(y2[..., :, None], y2[..., None, :])
        ih.sub_(torch.maximum(y1[..., :, None], y1[..., None, :]))
        if one:
            iw.add_(one)
            ih.add_(one)
        inter = iw.clamp_min_(0.0).mul_(ih.clamp_min_(0.0))
        del ih
        area = (x2 - x1 + one) * (y2 - y1 + one)
        union = area[..., :, None] + area[..., None, :]
        union.sub_(inter).clamp_min_(1e-10)
        return inter.div_(union)


def greedy_nms(iou, scores, iou_thresh, max_keep, score_thresh=-1e30,
               eta=1.0):
    """Greedy NMS with a static output size, batched: ``iou`` [B, M, M]
    (one matrix a batch row, shared by its G groups), ``scores`` [B, G, M]
    -> (keep indices [B, G, max_keep] int64, padded 0; valid bool). One
    Python loop of min(max_keep, M) trips (the reference's ``fori_loop``),
    each picking every group's live argmax and suppressing by IoU (ref
    ``multiclass_nms_op.cc:90``, adaptive eta while the threshold is above
    0.5 and a box was kept)."""
    b, g, m = scores.shape
    dev = scores.device
    alive = torch.ones((b, g, m), dtype=torch.bool, device=dev)
    thresh = torch.full((b, g, 1), float(iou_thresh), dtype=torch.float32,
                        device=dev)
    cols = torch.arange(m, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    floor = max(score_thresh, -1e30)
    neg = torch.full((), -_INF, dtype=scores.dtype, device=dev)
    idxs, valid = [], []
    for _ in range(min(max_keep, m)):
        masked = torch.where(alive, scores, neg)
        j = masked.argmax(dim=-1, keepdim=True)          # [B, G, 1]
        ok = masked.gather(-1, j) > floor
        idxs.append(torch.where(ok, j, 0))
        valid.append(ok)
        alive = alive & (iou[rows, j[..., 0]] <= thresh) & (cols != j) & ok
        if eta < 1.0:
            thresh = torch.where((thresh > 0.5) & ok, thresh * eta, thresh)
    pad = max_keep - len(idxs)
    if pad:
        idxs.append(torch.zeros((b, g, pad), dtype=torch.int64, device=dev))
        valid.append(torch.zeros((b, g, pad), dtype=torch.bool, device=dev))
    return torch.cat(idxs, dim=-1), torch.cat(valid, dim=-1)


@register("multiclass_nms")
def _multiclass_nms(env, op):
    """Ref ``multiclass_nms_op.cc``: per-class NMS then cross-class top-K.
    Fixed-shape re-design of the LoD output: Out [N, keep_top_k, 6]
    (label, score, x1, y1, x2, y2; pad rows -1) + Count [N]. The IoU of an
    image's boxes is made once and shared by its classes (the reference's
    class ``vmap`` makes one matrix a class: the same numbers)."""
    boxes = get(env, op.input("BBoxes"))   # [N, M, 4]
    scores = get(env, op.input("Scores"))  # [N, C, M]
    bg = op.attr("background_label", 0)
    score_thresh = op.attr("score_threshold", 0.0)
    nms_top_k = int(op.attr("nms_top_k", 64))
    keep_top_k = int(op.attr("keep_top_k", 100))
    n, c, m = scores.shape
    top = min(nms_top_k if nms_top_k > 0 else m, m)
    idxs, valid = greedy_nms(
        _nms_iou(boxes, op.attr("normalized", True)), scores,
        op.attr("nms_threshold", 0.3), top, score_thresh,
        op.attr("nms_eta", 1.0))                     # [N, C, top]
    v = valid.to(scores.dtype)
    s = scores.gather(-1, idxs) * v - (1.0 - v) * 1e30
    b = boxes.gather(1, idxs.reshape(n, -1, 1).expand(-1, -1, 4))
    labels = torch.arange(c, device=scores.device).repeat_interleave(top)
    flat_s = torch.where(labels == bg, -1e30, s.reshape(n, -1))
    k = min(keep_top_k if keep_top_k > 0 else c * top, c * top)
    best_s, best_i = top_k_stable(flat_s, k)
    ok = best_s > max(score_thresh, -1e29)
    out = torch.cat([
        torch.where(ok, labels[best_i], -1)[..., None].to(torch.float32),
        torch.where(ok, best_s, -1.0)[..., None],
        torch.where(ok[..., None], b.gather(
            1, best_i[..., None].expand(-1, -1, 4)), -1.0)], dim=-1)
    put(env, op.output("Out"), out)
    if op.output("Count") is not None:
        put(env, op.output("Count"), ok.sum(dim=1, dtype=torch.int32))


def _clip(v, hi):
    """``jnp.clip(v, 0, hi)`` with a tensor ``hi``."""
    return torch.minimum(torch.clamp_min(v, 0), hi)


@register("box_clip")
def _box_clip(env, op):
    """Ref ``box_clip_op.cc``: clip boxes to the image extent of ImInfo
    [N, 3] (h, w, scale)."""
    boxes = get(env, op.input("Input"))   # [N, M, 4]
    im_info = get(env, op.input("ImInfo"))
    exp = (slice(None),) + (None,) * (boxes.dim() - 2)
    h = (im_info[:, 0] / im_info[:, 2])[exp]
    w = (im_info[:, 1] / im_info[:, 2])[exp]
    put(env, op.output("Output"), torch.stack(
        [_clip(boxes[..., 0], w - 1), _clip(boxes[..., 1], h - 1),
         _clip(boxes[..., 2], w - 1), _clip(boxes[..., 3], h - 1)], dim=-1))


@register("generate_proposals")
def _generate_proposals(env, op):
    """Ref ``generate_proposals_op.cc``: decode RPN deltas at anchors,
    clip, drop tiny boxes (masked, not filtered), pre-NMS top-N, NMS,
    post-NMS top-N. RpnRois [N, post_nms_topN, 4] + RpnRoiProbs + Count
    instead of LoD."""
    scores = get(env, op.input("Scores"))       # [N, A, H, W]
    deltas = get(env, op.input("BboxDeltas"))   # [N, 4A, H, W]
    im_info = get(env, op.input("ImInfo"))      # [N, 3]
    anchors = get(env, op.input("Anchors"))     # [H, W, A, 4]
    variances = get(env, op.input("Variances"))
    pre_n = int(op.attr("pre_nms_topN", 6000))
    post_n = int(op.attr("post_nms_topN", 1000))
    n, a, h, w = scores.shape
    total = a * h * w
    anc = anchors.permute(2, 0, 1, 3).reshape(total, 4)
    s = scores.reshape(n, total)
    d = deltas.reshape(n, a, 4, h, w).permute(0, 1, 3, 4, 2).reshape(
        n, total, 4)
    if variances is not None and variances.dim() == 4:
        d = d * variances.permute(2, 0, 1, 3).reshape(total, 4)
    aw = anc[:, 2] - anc[:, 0] + 1.0
    ah = anc[:, 3] - anc[:, 1] + 1.0
    acx = anc[:, 0] + aw * 0.5
    acy = anc[:, 1] + ah * 0.5
    cx = d[..., 0] * aw + acx
    cy = d[..., 1] * ah + acy
    bw = exp_once(torch.clamp_max(d[..., 2], 10.0)) * aw
    bh = exp_once(torch.clamp_max(d[..., 3], 10.0)) * ah
    # clipped to the (scaled) image the boxes live in: only box_clip
    # divides by the scale
    ih, iw = im_info[:, 0:1], im_info[:, 1:2]
    boxes = torch.stack([
        _clip(cx - bw * 0.5, iw - 1), _clip(cy - bh * 0.5, ih - 1),
        _clip(cx + bw * 0.5 - 1, iw - 1), _clip(cy + bh * 0.5 - 1, ih - 1)],
        dim=-1)
    ms = op.attr("min_size", 0.1) * im_info[:, 2:3]
    keep = ((boxes[..., 2] - boxes[..., 0] + 1 >= ms)
            & (boxes[..., 3] - boxes[..., 1] + 1 >= ms))
    s = torch.where(keep, s, -1e30)
    top_s, top_i = top_k_stable(s, min(pre_n, total))
    top_b = boxes.gather(1, top_i[..., None].expand(-1, -1, 4))
    idxs, valid = greedy_nms(_nms_iou(top_b), top_s[:, None],
                             op.attr("nms_thresh", 0.7), post_n,
                             score_thresh=-1e29, eta=op.attr("eta", 1.0))
    idxs, valid = idxs[:, 0], valid[:, 0]
    put(env, op.output("RpnRois"), torch.where(
        valid[..., None], top_b.gather(1, idxs[..., None].expand(-1, -1, 4)),
        0.0))
    put(env, op.output("RpnRoiProbs"),
        torch.where(valid, top_s.gather(1, idxs), 0.0))
    if op.output("Count") is not None:
        put(env, op.output("Count"), valid.sum(dim=1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# matching / target assignment (SSD training path)
# ---------------------------------------------------------------------------

@register("bipartite_match")
def _bipartite_match(env, op):
    """Ref ``bipartite_match_op.cc``: greedy global bipartite matching on a
    [B, M, N] distance matrix (M gt rows, N prior columns), every image at
    once: min(M, N) trips, each taking an image's largest live entry.
    ColToRowMatchIndices [B, N] (-1 unmatched) + ColToRowMatchDist;
    'per_prediction' also matches leftover columns whose best row reaches
    dist_threshold."""
    dist = get(env, op.input("DistMat"))
    b, m, n = dist.shape
    dev = dist.device
    rows = torch.arange(m, device=dev)[None, :, None]
    cols = torch.arange(n, device=dev)[None, None, :]
    live = dist
    col_idx = torch.full((b, n), -1, dtype=torch.int32, device=dev)
    col_dist = torch.zeros((b, n), dtype=torch.float32, device=dev)
    for _ in range(min(m, n)):
        flat = live.reshape(b, -1).argmax(dim=1)
        best = live.reshape(b, -1).gather(1, flat[:, None])
        i, j = (flat // n)[:, None], (flat % n)[:, None]
        ok = best > 0
        hit = ok & (cols[:, 0] == j)
        col_idx = torch.where(hit, i.to(torch.int32), col_idx)
        col_dist = torch.where(hit, best.to(torch.float32), col_dist)
        live = torch.where(ok[..., None] & ((rows == i[..., None])
                                            | (cols == j[..., None])),
                           -1.0, live)
    if op.attr("match_type", "bipartite") == "per_prediction":
        best = dist.amax(dim=1)
        best_row = dist.argmax(dim=1).to(torch.int32)
        extra = (col_idx < 0) & (best >= op.attr("dist_threshold", 0.5))
        col_idx = torch.where(extra, best_row, col_idx)
        col_dist = torch.where(extra, best.to(torch.float32), col_dist)
    put(env, op.output("ColToRowMatchIndices"), col_idx)
    put(env, op.output("ColToRowMatchDist"), col_dist.to(dist.dtype))


def _gather_rows(x, match):
    """``x[b, max(match[b, j], 0)]``: x [B, M, ...], match [B, N]."""
    idx = torch.clamp_min(match, 0).to(torch.int64)
    idx = idx.reshape(tuple(idx.shape) + (1,) * (x.dim() - 2))
    return x.gather(1, idx.expand(tuple(match.shape) + tuple(x.shape[2:])))


@register("target_assign")
def _target_assign(env, op):
    """Ref ``target_assign_op.cc``: out[b, j] = X[b, match[b, j]] where
    matched, else mismatch_value; OutWeight 1/0."""
    x = get(env, op.input("X"))                # [B, M, K]
    match = get(env, op.input("MatchIndices"))  # [B, N]
    gathered = _gather_rows(x, match)
    ok = (match >= 0)[..., None]
    put(env, op.output("Out"), torch.where(
        ok, gathered, torch.full_like(gathered, op.attr("mismatch_value",
                                                          0))))
    put(env, op.output("OutWeight"), ok.to(torch.float32))


def _rank_pos(key):
    """rank_pos[..., i] = position of i in ascending-key order along the
    last axis (a stable sort, as ``jnp.argsort``)."""
    order = torch.argsort(key, dim=-1, stable=True)
    ar = torch.arange(key.shape[-1], device=key.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


@register("mine_hard_examples")
def _mine_hard_examples(env, op):
    """Ref ``mine_hard_examples_op.cc`` (max_negative mining): keep the
    top-(neg_pos_ratio x #pos) negatives by classification loss.
    UpdatedMatchIndices [B, N]: kept negatives stay -1, discarded ones
    become -2 (the reference's redesign of the NegIndices LoD list)."""
    loss = get(env, op.input("ClsLoss"))        # [B, N]
    mi = get(env, op.input("MatchIndices"))     # [B, N]
    n = loss.shape[1]
    pos = mi >= 0
    n_pos = pos.sum(dim=1, keepdim=True, dtype=torch.int32)
    n_neg = torch.clamp_max((n_pos.to(torch.float32)
                             * op.attr("neg_pos_ratio", 3.0)).to(torch.int32),
                            n)
    neg_loss = torch.where(pos, -_INF, loss)
    keep_neg = (~pos) & (_rank_pos(-neg_loss) < n_neg) \
        & torch.isfinite(neg_loss)
    put(env, op.output("UpdatedMatchIndices"), torch.where(
        pos, mi, torch.where(keep_neg, -1, -2)).to(torch.int32))


@register("polygon_box_transform")
def _polygon_box_transform(env, op):
    """Ref ``polygon_box_transform_op.cc``: offsets to absolute quad
    coordinates on the 4x grid."""
    x = get(env, op.input("Input"))  # [N, 8, H, W]
    n, c, h, w = x.shape
    gx = (torch.arange(w, dtype=x.dtype, device=x.device) * 4).expand(h, w)
    gy = (torch.arange(h, dtype=x.dtype, device=x.device) * 4)[:, None] \
        .expand(h, w)
    grid = torch.stack([gx, gy] * (c // 2), dim=0)
    put(env, op.output("Output"), grid[None] - x)


@register("yolov3_loss")
def _yolov3_loss(env, op):
    """Ref ``yolov3_loss_op.cc``: single-scale YOLOv3 loss: sigmoid-CE for
    x/y, objectness and classes, squared error for w/h; each gt matched to
    its best-IoU anchor (by shape) over all anchors, the predictions that
    overlap a gt above ignore_thresh left out of the no-object loss. The
    targets are written with the reference's set semantics: where two gts
    own one cell the later one's targets stand (the reference's scatter
    on the CPU), chosen here before the write, so no write collides."""
    x = get(env, op.input("X"))              # [N, mask*(5+cls), H, W]
    gt_box = get(env, op.input("GTBox"))     # [N, B, 4] (cx cy w h, 0..1)
    gt_label = get(env, op.input("GTLabel"))  # [N, B]
    mask = list(op.attr("anchor_mask"))
    cls_num = int(op.attr("class_num"))
    ignore = op.attr("ignore_thresh", 0.7)
    down = op.attr("downsample_ratio", 32)
    dev = x.device
    n, _, h, w = x.shape
    na = len(mask)
    all_anchors = _const(op, "anchors", dev, lambda cpu: torch.tensor(
        op.attr("anchors"), dtype=torch.float32).reshape(-1, 2))
    mask_arr = _const(op, "mask", dev, lambda cpu: torch.tensor(
        mask, dtype=torch.int64))
    masked_anchors = all_anchors[mask_arr]
    in_h, in_w = h * down, w * down
    x = x.reshape(n, na, 5 + cls_num, h, w)
    px, py, pw, ph, pobj = (x[:, :, i] for i in range(5))
    pcls = x[:, :, 5:]

    def sce(logit, label):
        return (torch.clamp_min(logit, 0) - logit * label
                + torch.log1p(torch.exp(-torch.abs(logit))))

    gi = torch.arange(w, dtype=torch.float32, device=dev)
    gj = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    # the ignore mask is compared, never differentiated; it is taken in
    # f64 so that the card and the host ignore the same cells
    with torch.no_grad():
        d = torch.float64
        bx = (torch.sigmoid(px.to(d)) + gi) / w
        by = (torch.sigmoid(py.to(d)) + gj) / h
        bw = torch.exp(pw.to(d)) * masked_anchors[:, 0, None, None] / in_w
        bh = torch.exp(ph.to(d)) * masked_anchors[:, 1, None, None] / in_h
    nb = gt_box.shape[1]
    valid_gt = (gt_box[..., 2] > 0) & (gt_box[..., 3] > 0)   # [N, B]
    g_w, g_h = gt_box[..., 2], gt_box[..., 3]
    w1, h1 = g_w[..., None] * in_w, g_h[..., None] * in_h
    w2, h2 = all_anchors[:, 0], all_anchors[:, 1]
    inter = torch.minimum(w1, w2) * torch.minimum(h1, h2)
    iou_an = inter / torch.clamp_min(w1 * h1 + w2 * h2 - inter, 1e-10)
    best_anchor = iou_an.argmax(dim=-1)                      # [N, B]
    cell_i = (gt_box[..., 0] * w).to(torch.int64).clamp(0, w - 1)
    cell_j = (gt_box[..., 1] * h).to(torch.int64).clamp(0, h - 1)

    def corners(t):
        return (t[..., 0] - t[..., 2] / 2, t[..., 1] - t[..., 3] / 2,
                t[..., 0] + t[..., 2] / 2, t[..., 1] + t[..., 3] / 2)

    with torch.no_grad():
        p = torch.stack([bx, by, bw, bh], dim=-1)[:, :, :, :, None, :]
        g = gt_box.to(d)[:, None, None, None, :, :]
        px1, py1, px2, py2 = corners(p)
        gx1, gy1, gx2, gy2 = corners(g)
        iw = torch.clamp_min(torch.minimum(px2, gx2) - torch.maximum(px1, gx1),
                             0)
        ihh = torch.clamp_min(torch.minimum(py2, gy2)
                              - torch.maximum(py1, gy1), 0)
        ov = iw * ihh
        ua = p[..., 2] * p[..., 3] + g[..., 2] * g[..., 3] - ov
        ious = torch.where(valid_gt[:, None, None, None, :],
                           ov / torch.clamp_min(ua, 1e-10), 0.0)
        noobj_ok = ious.amax(dim=-1) <= ignore               # [N, na, h, w]

    hit = mask_arr == best_anchor[..., None]                 # [N, B, na]
    local = hit.to(torch.int32).argmax(dim=-1)
    on_scale = hit.any(dim=-1) & valid_gt
    sel_anchor = torch.where(on_scale, local, 0)
    scale = 2.0 - g_w * g_h  # big boxes weigh less (ref loss_weight)
    cells = na * h * w
    fidx = torch.where(on_scale, sel_anchor * (h * w) + cell_j * w + cell_i,
                       cells)
    # the gt that stands in each cell: none later in the image owns it
    later = torch.triu(torch.ones(nb, nb, dtype=torch.bool, device=dev), 1)
    shadowed = ((fidx[:, :, None] == fidx[:, None, :]) & later).any(dim=2)
    tgt = torch.where(shadowed, cells, fidx)

    def upd(v):
        t = torch.zeros((n, cells + 1), dtype=torch.float32, device=dev)
        return t.scatter(1, tgt, v.to(torch.float32))[:, :cells].reshape(
            n, na, h, w)

    obj_t = upd(torch.ones_like(scale))
    tx = upd(gt_box[..., 0] * w - cell_i)
    ty = upd(gt_box[..., 1] * h - cell_j)
    anchor_w = masked_anchors[sel_anchor, 0]
    anchor_h = masked_anchors[sel_anchor, 1]
    tw = upd(torch.log(torch.clamp_min(g_w * in_w, 1e-9) / anchor_w))
    th = upd(torch.log(torch.clamp_min(g_h * in_h, 1e-9) / anchor_h))
    tscale = upd(scale)
    onehot = (gt_label.to(torch.int64)[..., None]
              == torch.arange(cls_num, device=dev)).to(torch.float32)
    tcls = torch.zeros((n, cells + 1, cls_num), dtype=torch.float32,
                       device=dev).scatter(
        1, tgt[..., None].expand(-1, -1, cls_num), onehot)[:, :cells] \
        .reshape(n, na, h, w, cls_num)

    pos = (obj_t > 0).to(torch.float32)
    per = (tscale * (sce(px, tx) + sce(py, ty)) * pos
           + tscale * 0.5 * ((pw - tw) ** 2 + (ph - th) ** 2) * pos)
    obj_loss = sce(pobj, obj_t) * torch.where(
        pos > 0, 1.0, noobj_ok.to(torch.float32))
    cls_loss = torch.sum(sce(pcls, tcls.permute(0, 1, 4, 2, 3)), dim=2) * pos
    put(env, op.output("Loss"),
        torch.sum(per + obj_loss + cls_loss, dim=(1, 2, 3)))


# ---------------------------------------------------------------------------
# ssd_loss helper ops (the layer composes these; ref layers/detection.py
# ssd_loss builds the same steps from reshape/gather primitives over LoD)
# ---------------------------------------------------------------------------

@register("batched_iou_similarity")
def _batched_iou(env, op):
    x = get(env, op.input("X"))  # [N, M, 4]
    y = get(env, op.input("Y"))  # [P, 4]
    put(env, op.output("Out"), iou_matrix(x, y.expand((x.shape[0],)
                                                      + tuple(y.shape))))


@register("ssd_encode_matched")
def _ssd_encode_matched(env, op):
    """Per-prior regression target: the MATCHED gt box encoded against
    each prior (unmatched priors get zeros)."""
    gt = get(env, op.input("GTBox"))           # [N, B, 4] corners
    match = get(env, op.input("MatchIndices"))  # [N, P]
    prior = get(env, op.input("PriorBox"))     # [P, 4]
    pvar = get(env, op.input("PriorBoxVar"))
    g = _gather_rows(gt, match)
    pw = prior[:, 2] - prior[:, 0]
    ph = prior[:, 3] - prior[:, 1]
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    gw = g[..., 2] - g[..., 0]
    gh = g[..., 3] - g[..., 1]
    gcx = g[..., 0] + gw * 0.5
    gcy = g[..., 1] + gh * 0.5
    if pvar is None:
        v = (0.1, 0.1, 0.2, 0.2)
    else:
        v = pvar.reshape(-1, 4) if pvar.dim() == 2 else pvar.reshape(1, 4)
        v = (v[..., 0], v[..., 1], v[..., 2], v[..., 3])
    ex = (gcx - pcx[None]) / pw[None] / v[0]
    ey = (gcy - pcy[None]) / ph[None] / v[1]
    ew = torch.log(torch.clamp_min(gw, 1e-8) / pw[None]) / v[2]
    eh = torch.log(torch.clamp_min(gh, 1e-8) / ph[None]) / v[3]
    enc = torch.stack([ex, ey, ew, eh], dim=-1)
    put(env, op.output("Out"), torch.where((match >= 0)[..., None], enc,
                                           0.0))


@register("ssd_gather_labels")
def _ssd_gather_labels(env, op):
    gt_label = get(env, op.input("GTLabel"))   # [N, B] or [N, B, 1]
    match = get(env, op.input("MatchIndices"))  # [N, P]
    if gt_label.dim() == 3:
        gt_label = gt_label[..., 0]
    g = _gather_rows(gt_label, match)
    put(env, op.output("Out"), torch.where(
        match >= 0, g, op.attr("background_label", 0)).to(torch.int32))


@register("ssd_mining_masks")
def _ssd_mining_masks(env, op):
    mined = get(env, op.input("Mined"))  # [N, P]: gt idx / -1 kept / -2
    put(env, op.output("Selected"), (mined >= -1).to(torch.float32))
    put(env, op.output("Positive"), (mined >= 0).to(torch.float32))


@register("ssd_smooth_l1")
def _ssd_smooth_l1(env, op):
    """Per-prior smooth-L1 over the coordinate axis: [N, P, 4] -> [N, P]."""
    d = torch.abs(get(env, op.input("X")) - get(env, op.input("Y")))
    per = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    put(env, op.output("Out"), torch.sum(per, dim=-1))


# ---------------------------------------------------------------------------
# Faster R-CNN training-path ops
# ---------------------------------------------------------------------------

def _encode_center_size(ref_boxes, matched, one=1.0):
    """Matched gt encoded against reference boxes (pixel +1 convention),
    degenerate matches clamped so the log stays finite in masked lanes."""
    rw = torch.clamp_min(ref_boxes[..., 2] - ref_boxes[..., 0] + one, 1e-6)
    rh = torch.clamp_min(ref_boxes[..., 3] - ref_boxes[..., 1] + one, 1e-6)
    rcx = ref_boxes[..., 0] + rw * 0.5
    rcy = ref_boxes[..., 1] + rh * 0.5
    gw = torch.clamp_min(matched[..., 2] - matched[..., 0] + one, 1e-6)
    gh = torch.clamp_min(matched[..., 3] - matched[..., 1] + one, 1e-6)
    gcx = matched[..., 0] + gw * 0.5
    gcy = matched[..., 1] + gh * 0.5
    return torch.stack([(gcx - rcx) / rw, (gcy - rcy) / rh,
                        torch.log(gw / rw), torch.log(gh / rh)], dim=-1)


def _valid_boxes(boxes):
    return (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])


def _quota(mask, key, limit):
    """``mask`` & rank of ``key`` (ascending, over the masked lanes) below
    ``limit``: the reference's deterministic sampling by rank."""
    return mask & (_rank_pos(torch.where(mask, key, _INF)) < limit)


@register("rpn_target_assign")
def _rpn_target_assign(env, op):
    """Ref ``rpn_target_assign_op.cc``: label anchors fg/bg by IoU and
    emit regression targets. Fixed-shape re-design: per-anchor ScoreLabel
    [N, A] (1 fg / 0 bg / -1 ignore) and LocTarget [N, A, 4]; the quotas
    take the top anchors by IoU (the reference's deterministic stand-in
    for random sampling: same quotas)."""
    anchors = get(env, op.input("Anchor")).reshape(-1, 4)  # [A, 4]
    gt = get(env, op.input("GtBoxes"))                     # [N, G, 4]
    n, a = gt.shape[0], anchors.shape[0]
    batch_per_im = int(op.attr("rpn_batch_size_per_im", 256))
    valid = _valid_boxes(gt)
    iou = iou_matrix(anchors.expand(n, a, 4), gt, norm=False)  # [N, A, G]
    iou = torch.where(valid[:, None, :], iou, 0.0)
    best, best_gt = iou.max(dim=2).values, iou.argmax(dim=2)
    # fg: above threshold, or the argmax anchor of each VALID gt
    forced = torch.zeros((n, a), dtype=torch.int32, device=gt.device) \
        .scatter_reduce(1, iou.argmax(dim=1), valid.to(torch.int32), "amax")
    fg = (best >= op.attr("rpn_positive_overlap", 0.7)) | (forced > 0)
    bg = (best < op.attr("rpn_negative_overlap", 0.3)) & ~fg
    fg_keep = _quota(fg, -best,
                     int(batch_per_im * op.attr("rpn_fg_fraction", 0.5)))
    n_fg = fg_keep.sum(dim=1, keepdim=True)
    bg_keep = _quota(bg, best, batch_per_im - n_fg)
    put(env, op.output("ScoreLabel"), torch.where(
        fg_keep, 1, torch.where(bg_keep, 0, -1)).to(torch.int32))
    tgt = _encode_center_size(anchors, _gather_rows(gt, best_gt))
    put(env, op.output("LocTarget"), torch.where(fg_keep[..., None], tgt,
                                                 0.0))


@register("generate_proposal_labels")
def _generate_proposal_labels(env, op):
    """Ref ``generate_proposal_labels_op.cc``: sample RoIs into fg/bg for
    the second stage with per-class regression targets. Fixed-shape
    re-design: LabelsInt32 [N, R] (class, 0 background, -1 unsampled),
    BboxTargets [N, R, 4], BboxInsideWeights [N, R, 1]; IoU-ranked
    sampling."""
    rois = get(env, op.input("RpnRois"))      # [N, R, 4]
    gt_cls = get(env, op.input("GtClasses")).to(torch.int32)  # [N, G]
    gt_box = get(env, op.input("GtBoxes"))    # [N, G, 4]
    bs_per_im = int(op.attr("batch_size_per_im", 128))
    iou = torch.where(_valid_boxes(gt_box)[:, None, :],
                      iou_matrix(rois, gt_box, norm=False), 0.0)
    best, bidx = iou.max(dim=2).values, iou.argmax(dim=2)
    fg = best >= op.attr("fg_thresh", 0.5)
    bg = (best < op.attr("bg_thresh_hi", 0.5)) \
        & (best >= op.attr("bg_thresh_lo", 0.0))
    fg_keep = _quota(fg, -best, int(bs_per_im * op.attr("fg_fraction",
                                                        0.25)))
    n_fg = fg_keep.sum(dim=1, keepdim=True)
    bg_keep = _quota(bg, best, bs_per_im - n_fg)
    put(env, op.output("LabelsInt32"), torch.where(
        fg_keep, gt_cls.gather(1, bidx),
        torch.where(bg_keep, 0, -1)).to(torch.int32))
    tgt = _encode_center_size(rois, _gather_rows(gt_box, bidx))
    put(env, op.output("BboxTargets"), torch.where(fg_keep[..., None], tgt,
                                                   0.0))
    put(env, op.output("BboxInsideWeights"),
        fg_keep.to(torch.float32)[..., None])


def _point_in_polys(polys, px, py):
    """Even-odd rasterization: ``polys`` [..., P, V, 2] (repeated-point
    padding contributes nothing), sample points ``px``/``py`` [M, M] ->
    bool [..., M, M]: inside the union of the P polygons."""
    v2 = torch.roll(polys, -1, dims=-2)
    x1, y1 = polys[..., 0][..., None, None], polys[..., 1][..., None, None]
    x2, y2 = v2[..., 0][..., None, None], v2[..., 1][..., None, None]
    straddles = (y1 <= py) != (y2 <= py)
    t = (py - y1) / torch.where(y2 == y1, 1.0, y2 - y1)
    cross_x = x1 + t * (x2 - x1)
    crossings = (straddles & (px < cross_x)).sum(dim=-3)  # [..., P, M, M]
    return (crossings % 2 == 1).any(dim=-3)


@register("generate_mask_labels")
def _generate_mask_labels(env, op):
    """Ref ``detection/generate_mask_labels_op.cc`` (+ ``mask_util.cc``
    Polys2MaskWrtBox): each foreground RoI takes the gt mask of highest
    box overlap and rasterizes its polygons into a class-specific
    [resolution, resolution] target. Fixed-shape re-design: GtSegms
    [N, G, P, V, 2] with repeated-point padding; MaskRois [N, R, 4],
    RoiHasMaskInt32 [N, R], MaskInt32 [N, R, C*M*M] (-1 outside each fg
    row's class segment); even-odd point-in-polygon at pixel centers."""
    im_info = get(env, op.input("ImInfo"))                        # [N, 3]
    gt_cls = get(env, op.input("GtClasses")).to(torch.int32)      # [N, G]
    is_crowd = get(env, op.input("IsCrowd")).to(torch.int32)      # [N, G]
    segms = get(env, op.input("GtSegms")).to(torch.float32)   # [N,G,P,V,2]
    rois = get(env, op.input("Rois"))                             # [N, R, 4]
    labels = get(env, op.input("LabelsInt32")).to(torch.int32)    # [N, R]
    num_classes = int(op.attr("num_classes"))
    m = int(op.attr("resolution"))
    n, g = segms.shape[0], segms.shape[1]
    r = rois.shape[1]
    dev = rois.device
    valid_gt = (gt_cls > 0) & (is_crowd == 0)
    pts = segms.reshape(n, g, -1, 2)
    poly_boxes = torch.cat([pts.amin(dim=2), pts.amax(dim=2)],
                           dim=-1)                                # [N, G, 4]
    fg = labels > 0
    rois_im = rois / torch.clamp_min(im_info[:, 2], 1e-8)[:, None, None]
    iou = torch.where(valid_gt[:, None, :],
                      iou_matrix(rois_im, poly_boxes, norm=False), -1.0)
    match = iou.argmax(dim=2)                                     # [N, R]
    polys = segms[torch.arange(n, device=dev)[:, None], match]  # [N,R,P,V,2]
    x1, y1 = rois_im[..., 0], rois_im[..., 1]
    bw = torch.clamp_min(rois_im[..., 2] - x1, 1.0)
    bh = torch.clamp_min(rois_im[..., 3] - y1, 1.0)
    e = (slice(None), slice(None), None, None)
    tp = torch.stack([(polys[..., 0] - x1[e]) * m / bw[e],
                      (polys[..., 1] - y1[e]) * m / bh[e]], dim=-1)
    grid = torch.arange(m, dtype=torch.float32, device=dev) + 0.5
    masks = _point_in_polys(tp, grid[None, :], grid[:, None])   # [N,R,m,m]
    mask_flat = masks.reshape(n, r, m * m).to(torch.int32)
    seg_ids = torch.arange(num_classes * m * m, device=dev) // (m * m)
    put(env, op.output("MaskRois"), torch.where(fg[..., None], rois, 0.0))
    put(env, op.output("RoiHasMaskInt32"), fg.to(torch.int32))
    put(env, op.output("MaskInt32"), torch.where(
        fg[..., None] & (seg_ids == labels[..., None]),
        mask_flat.repeat(1, 1, num_classes), -1))
