"""The detection ops of ``paddle_tpu/core/opimpl/misc_ops.py``:
``psroi_pool`` and ``detection_map`` (ref ``psroi_pool_op.cc``,
``detection_map_op.cc``). The file's other ops are not ported yet.
Neither op reads a value on the host, so a captured step may hold them.
"""

import numpy as np
import torch

from ..op_registry import get, put, register
from .detection_ops import iou_matrix

# jnp.linspace(0.0, 1.0, 11) in f32 (torch.linspace rounds 0.9 the other
# way): the recall points of the 11-point AP
_ELEVEN = [float(v) for v in np.arange(11, dtype=np.float32)
           * np.float32(0.1)]


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
