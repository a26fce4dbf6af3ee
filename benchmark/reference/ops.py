"""Plain box, anchor, NMS, RoIAlign, target and loss functions.

Frozen copies of the plain PyTorch functions that the measured program's
kernels and layers compute (greedy NMS, multilevel RoIAlign with FPN
routing, anchor and RoI targets, mask targets, the losses), written
against plain ``torch`` and ``numpy`` only. Nothing here imports the
program: the benchmark holds the program to these.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

EPS = 1e-8
BBOX_XFORM_CLIP = 4.135166556742356  # ln(1000 / 16)
NEG_INF = -1e10


# ------------------------------------------------------------------ boxes

def box_wh(b):
    return b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]


def box_area(b):
    w, h = box_wh(b)
    return w.clamp_min(0.0) * h.clamp_min(0.0)


def bbox_overlaps(a, q):
    """IoU ``[..., N, K]`` of ``a [..., N, 4]`` against ``q [..., K, 4]``."""
    lt = torch.maximum(a[..., :, None, :2], q[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], q[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(q)[..., None, :] - inter
    return inter / union.clamp_min(EPS)


def encode_boxes(boxes, anchors, weights=(1.0, 1.0, 1.0, 1.0)):
    aw, ah = box_wh(anchors)
    ax, ay = anchors[..., 0] + 0.5 * aw, anchors[..., 1] + 0.5 * ah
    gw, gh = box_wh(boxes)
    gx, gy = boxes[..., 0] + 0.5 * gw, boxes[..., 1] + 0.5 * gh
    aw, ah = aw.clamp_min(EPS), ah.clamp_min(EPS)
    wx, wy, ww, wh_ = weights
    return torch.stack([wx * (gx - ax) / aw, wy * (gy - ay) / ah,
                        ww * torch.log(gw.clamp_min(EPS) / aw),
                        wh_ * torch.log(gh.clamp_min(EPS) / ah)], dim=-1)


def decode_boxes(deltas, anchors, weights=(1.0, 1.0, 1.0, 1.0)):
    """Inverse of :func:`encode_boxes`, with the exp clamp. The deltas'
    steps (the division by the weights, the clamp, the exponential) run in
    the deltas' own dtype, the products with the anchors in float32."""
    aw, ah = box_wh(anchors)
    ax, ay = anchors[..., 0] + 0.5 * aw, anchors[..., 1] + 0.5 * ah

    def scaled(i, w):
        return deltas[..., i] / torch.tensor(w, dtype=deltas.dtype, device=deltas.device)

    wx, wy, ww, wh_ = weights
    cx = scaled(0, wx) * aw + ax
    cy = scaled(1, wy) * ah + ay
    w = torch.exp(scaled(2, ww).clamp_max(BBOX_XFORM_CLIP)) * aw
    h = torch.exp(scaled(3, wh_).clamp_max(BBOX_XFORM_CLIP)) * ah
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def clip_boxes(boxes, height, width):
    hmax = torch.as_tensor(height, dtype=boxes.dtype, device=boxes.device)
    wmax = torch.as_tensor(width, dtype=boxes.dtype, device=boxes.device)
    return torch.stack([torch.minimum(boxes[..., i].clamp_min(0.0), m)
                        for i, m in enumerate((wmax, hmax, wmax, hmax))], dim=-1)


# ---------------------------------------------------------------- anchors

def base_anchors(stride: int, ratios, scale: float) -> np.ndarray:
    """py-faster-rcnn's enumeration at offset 0: one anchor a ratio."""
    size = float(stride) * float(stride)
    c = 0.5 * stride
    out = []
    for ratio in ratios:
        rw = np.sqrt(size / ratio)
        rh = rw * ratio
        sw, sh = rw * scale, rh * scale
        out.append([c - 0.5 * sw, c - 0.5 * sh, c + 0.5 * sw, c + 0.5 * sh])
    return np.asarray(out, np.float32)


def grid_anchors(canvas_hw, strides, ratios, scale: float) -> list[np.ndarray]:
    """Per level ``[Hl * Wl * A, 4]`` in (y, x, anchor) order."""
    h, w = canvas_hw
    out = []
    for stride in strides:
        fh, fw = -(-h // stride), -(-w // stride)
        sx, sy = np.meshgrid(np.arange(fw, dtype=np.float32) * stride,
                             np.arange(fh, dtype=np.float32) * stride)
        shifts = np.stack([sx, sy, sx, sy], axis=-1)
        out.append((shifts[:, :, None, :] + base_anchors(stride, ratios, scale)[None, None])
                   .reshape(-1, 4).astype(np.float32))
    return out


# -------------------------------------------------------------------- NMS

def sort_desc(x):
    return torch.sort(x, dim=-1, descending=True, stable=True)


def greedy_keep(sboxes, svalid, thresh: float, max_keep: int | None = None):
    """Keep mask ``[G, N]`` of score-sorted boxes: box j is suppressed by an
    earlier kept valid box with IoU > thresh; with ``max_keep``, only the
    first ``max_keep`` kept boxes keep their flag."""
    g, n = svalid.shape
    later = torch.ones(n, n, dtype=torch.bool, device=sboxes.device).triu(1)
    sup = (bbox_overlaps(sboxes, sboxes) > thresh) & later
    keep = torch.ones(g, n, dtype=torch.bool, device=sboxes.device)
    for i in range(n):
        alive = keep[:, i] & svalid[:, i]
        keep &= ~(alive[:, None] & sup[:, i])
    keep &= svalid
    if max_keep is not None:
        keep &= keep.cumsum(1) <= max_keep
    return keep


def nms_batched(boxes, scores, valid, thresh: float, max_out: int):
    """``(idx [G, m], ok [G, m])``: kept boxes in descending score order,
    ``m = min(max_out, N)``, invalid slots index 0."""
    g, n = scores.shape
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order_scores, order = sort_desc(masked)
    sboxes = torch.gather(boxes, 1, order[..., None].expand(g, n, 4))
    svalid = order_scores > NEG_INF / 2
    m = min(max_out, n)
    keep = greedy_keep(sboxes, svalid, thresh, max_keep=m)
    rank = keep.cumsum(1) - 1
    slot = torch.where(keep & (rank < m), rank, torch.full_like(rank, m))
    out = torch.zeros((g, m + 1), dtype=order.dtype, device=order.device)
    out.scatter_(1, slot, order)
    ok = torch.arange(m, device=keep.device)[None, :] < keep.sum(1, keepdim=True)
    return torch.where(ok, out[:, :m], torch.zeros_like(out[:, :m])), ok


def class_aware_nms(boxes, scores, classes, thresh: float, max_out: int, valid):
    span = boxes.amax(dim=(1, 2)) - boxes.amin(dim=(1, 2)) + 1.0
    shift = (classes.to(boxes.dtype) * span[:, None])[..., None]
    return nms_batched(boxes + shift, scores, valid, thresh, max_out)


# --------------------------------------------------------------- RoIAlign

def roi_span(top_hw) -> tuple[float, float]:
    """The routing span of the windowed RoIAlign: a window of 32 cells
    raised, 8-aligned, to cover the coarsest pooled level ``top_hw``,
    less 4."""
    th, tw = int(top_hw[0]), int(top_hw[1])
    win_h = max(32, -(-th // 8) * 8)
    win_w = max(32, -(-tw // 8) * 8)
    return float(win_h - 4), float(win_w - 4)


def assign_levels(rois, num_levels: int, min_level: int, max_span):
    w = (rois[..., 2] - rois[..., 0]).clamp_min(0.0)
    h = (rois[..., 3] - rois[..., 1]).clamp_min(0.0)
    k = torch.floor(4 + torch.log2(torch.sqrt(w * h) / 224.0 + 1e-8)).to(torch.int32)
    mh, mw = max_span
    kh = torch.ceil(torch.log2(h.clamp_min(1.0) / mh) - 1e-6)
    kw = torch.ceil(torch.log2(w.clamp_min(1.0) / mw) - 1e-6)
    k = torch.maximum(k, torch.maximum(kh, kw).to(torch.int32))
    return torch.clamp(k - min_level, 0, num_levels - 1).to(torch.int32)


def _sample_coords(lo, size, pool: int, ratio: int):
    steps = torch.arange(pool, dtype=torch.float64, device=lo.device)
    frac = (torch.arange(ratio, dtype=torch.float64, device=lo.device) + 0.5) / ratio
    pos = (steps[:, None] + frac[None, :]).reshape(-1).float()
    return lo[..., None] + pos * (size / pool)[..., None]


def _bilinear_1d(coord, limit):
    inb = (coord >= -1.0) & (coord <= limit)
    c = torch.minimum(coord.clamp_min(0.0), limit - 1.0)
    hi = (limit - 1.0).to(torch.int64)
    i0 = torch.minimum(torch.floor(c).to(torch.int64).clamp_min(0), hi)
    i1 = torch.minimum(i0 + 1, hi)
    frac = c - i0.to(c.dtype)
    return i0, i1, 1.0 - frac, frac, inb


def sample_geometry(level_hw, rois, levels, strides, p: int, s: int):
    """Where every sample of every RoI falls in one image's concatenated
    levels: ``(base, wrow, ys, xs)``, each axis ``(i0, i1, w0, w1, inb)``."""
    dev = rois.device
    hs = torch.tensor([h for h, _ in level_hw], device=dev)
    ws = torch.tensor([w for _, w in level_hw], device=dev)
    offsets = torch.cumsum(hs * ws, 0) - hs * ws
    strides_t = torch.tensor(list(strides), dtype=torch.float32, device=dev)
    lvl = levels.long()
    scale = 1.0 / strides_t[lvl]
    x1, y1, x2, y2 = (rois[..., i] * scale for i in range(4))
    rw = (x2 - x1).clamp_min(1.0)
    rh = (y2 - y1).clamp_min(1.0)
    xs = _bilinear_1d(_sample_coords(x1, rw, p, s), ws[lvl].float()[..., None])
    ys = _bilinear_1d(_sample_coords(y1, rh, p, s), hs[lvl].float()[..., None])
    return offsets[lvl][..., None, None], ws[lvl][..., None, None], ys, xs


def corners(base, wrow, ys, xs):
    y0, y1, wy0, wy1, _ = ys
    x0, x1, wx0, wx1, _ = xs
    for yi, wy in ((y0, wy0), (y1, wy1)):
        for xi, wx in ((x0, wx0), (x1, wx1)):
            yield (base + yi[..., :, None] * wrow + xi[..., None, :],
                   wy[..., :, None] * wx[..., None, :])


def roi_align(features, rois, strides, p: int, s: int, max_span):
    """Multilevel RoIAlign: NHWC levels ``[B, Hl, Wl, C]`` and image-frame
    RoIs ``[B, R, 4]`` -> ``[B, R, P, P, C]`` (float32 sums), routed by
    :func:`assign_levels`. Differentiable with respect to the levels."""
    b, r = rois.shape[:2]
    c = features[0].shape[-1]
    levels = assign_levels(rois, len(features), 2, max_span)
    flat = torch.cat([f.reshape(b, -1, c) for f in features], dim=1)
    base, wrow, ys, xs = sample_geometry([f.shape[1:3] for f in features], rois, levels,
                                         strides, p, s)
    bidx = torch.arange(b, device=rois.device)[:, None, None, None]
    pts = sum(flat[bidx, idx].float() * w[..., None] for idx, w in corners(base, wrow, ys, xs))
    inb = (ys[4][..., :, None] & xs[4][..., None, :])[..., None]
    pts = torch.where(inb, pts, torch.zeros_like(pts))
    return pts.reshape(b, r, p, s, p, s, c).mean(dim=(3, 5))


# ---------------------------------------------------------------- targets

def rank_select(eligible, cap, noise, max_cap: int = 0):
    """Up to ``cap [B]`` of the ``eligible [B, N]`` entries with the largest
    draws under a bounded top-k (``max_cap < N``), else with the smallest
    draws by a full rank; ties in index order."""
    n = eligible.shape[-1]
    cap = cap[..., None]
    if max_cap and max_cap < n:
        score = torch.where(eligible, noise, torch.full_like(noise, -1.0))
        top_v, top_i = sort_desc(score)
        top_v, top_i = top_v[..., :max_cap], top_i[..., :max_cap]
        take = (torch.arange(max_cap, device=noise.device) < cap) & (top_v > -0.5)
        return torch.zeros_like(eligible).scatter(-1, top_i, take)
    score = torch.where(eligible, noise, torch.full_like(noise, 2.0))
    order = torch.sort(score, dim=-1, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(n, device=noise.device).expand_as(order).contiguous())
    return eligible & (rank < cap)


def anchor_targets(anchors, gt_boxes, gt_classes, noise_pos, noise_neg, pos_iou, neg_iou,
                   sample_size, pos_fraction):
    """RPN labels and regression targets with forced best-anchor matches
    and a rank-sampled ``sample_size`` per image."""
    gt_valid = gt_classes > 0
    iou = bbox_overlaps(anchors, gt_boxes)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    max_iou = iou.amax(dim=2)
    matched = iou.argmax(dim=2)
    pos = max_iou >= pos_iou
    neg = max_iou < neg_iou
    per_gt_max = iou.amax(dim=1)
    best = (iou >= per_gt_max[:, None, :] - 1e-6) & gt_valid[:, None, :] & (iou > 0.0)
    forced = best.any(dim=2)
    matched = torch.where(forced & ~pos, best.to(torch.uint8).argmax(dim=2), matched)
    pos = pos | forced
    neg = neg & ~forced
    pos_cap = torch.clamp(pos.sum(1), max=int(sample_size * pos_fraction))
    sel_pos = rank_select(pos, pos_cap, noise_pos, max_cap=sample_size)
    sel_neg = rank_select(neg, sample_size - sel_pos.sum(1), noise_neg, max_cap=sample_size)
    gt_rows = torch.gather(gt_boxes, 1, matched[..., None].expand(*matched.shape, 4))
    targets = encode_boxes(gt_rows, anchors)
    targets = torch.where(pos[..., None], targets, torch.zeros_like(targets))
    return pos, (sel_pos | sel_neg).float(), targets, sel_pos.float()


def sample_rois(rois, roi_valid, gt_boxes, gt_classes, noise_fg, noise_bg, sample_size,
                positive_fraction, positive_iou, negative_iou_hi, negative_iou_lo,
                box_weights):
    """Fast R-CNN's RoI sample: gt appended, fg then bg compacted to the
    front slots. Returns ``(rois, labels, weights, box_targets, box_weights,
    matched_idx)``."""
    gt_valid = gt_classes > 0
    cand = torch.cat([rois, gt_boxes], dim=1)
    cand_valid = torch.cat([roi_valid, gt_valid], dim=1)
    n = cand.shape[1]
    iou = bbox_overlaps(cand, gt_boxes)
    masked = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    max_iou = torch.where(gt_valid[:, None, :], iou, torch.zeros_like(iou)).amax(dim=2)
    matched = masked.argmax(dim=2)
    fg = cand_valid & (max_iou >= positive_iou) & gt_valid.any(dim=1, keepdim=True)
    bg = cand_valid & (max_iou < negative_iou_hi) & (max_iou >= negative_iou_lo)
    fg_cap = torch.clamp(fg.sum(1), max=int(sample_size * positive_fraction))
    sel_fg = rank_select(fg, fg_cap, noise_fg, max_cap=sample_size)
    sel_bg = rank_select(bg, sample_size - sel_fg.sum(1), noise_bg, max_cap=sample_size)
    sel = sel_fg | sel_bg
    group = torch.where(sel_fg, 0, torch.where(sel_bg, 1, 2))
    order = torch.argsort(group * (n * 2) + torch.arange(n, device=cand.device),
                          dim=1)[:, :sample_size]
    sel_s = torch.gather(sel, 1, order)
    rois_s = torch.gather(cand, 1, order[..., None].expand(*order.shape, 4))
    rois_s = torch.where(sel_s[..., None], rois_s, torch.zeros_like(rois_s))
    matched_s = torch.gather(matched, 1, order)
    fg_s = torch.gather(sel_fg, 1, order)
    gt_s = torch.gather(gt_boxes, 1, matched_s[..., None].expand(*matched_s.shape, 4))
    labels = torch.where(fg_s, torch.gather(gt_classes, 1, matched_s),
                         torch.zeros_like(matched_s))
    targets = encode_boxes(gt_s, rois_s, weights=box_weights)
    targets = torch.where(fg_s[..., None], targets, torch.zeros_like(targets))
    matched_s = torch.where(fg_s, matched_s, torch.zeros_like(matched_s))
    return rois_s, labels, sel_s.float(), targets, fg_s.float(), matched_s


def _tent(c, m0: int):
    inb = (c > -1.0) & (c < m0)
    cc = c.clamp(0.0, m0 - 1.0)
    grid = torch.arange(m0, dtype=cc.dtype, device=cc.device)
    w = (1.0 - (grid - cc[..., None]).abs()).clamp_min(0.0)
    return torch.where(inb[..., None], w, torch.zeros_like(w))


def mask_targets(gt_masks, gt_boxes, rois, matched_idx, resolution: int):
    """gt-frame masks resampled bilinearly into each RoI's frame, >= 0.5."""
    b, s = matched_idx.shape
    m0 = gt_masks.shape[-1]
    idx = matched_idx.long()
    g = torch.gather(gt_boxes, 1, idx[..., None].expand(b, s, 4))
    gw = (g[..., 2] - g[..., 0]).clamp_min(1e-4)
    gh = (g[..., 3] - g[..., 1]).clamp_min(1e-4)
    r = resolution
    fx = (torch.arange(r, dtype=rois.dtype, device=rois.device) + 0.5) / r
    x = rois[..., 0:1] + fx * (rois[..., 2:3] - rois[..., 0:1])
    y = rois[..., 1:2] + fx * (rois[..., 3:4] - rois[..., 1:2])
    u = (x - g[..., 0:1]) / gw[..., None] * m0 - 0.5
    v = (y - g[..., 1:2]) / gh[..., None] * m0 - 0.5
    wu = _tent(u, m0).reshape(b * s, r, m0)
    wv = _tent(v, m0).reshape(b * s, r, m0)
    masks = torch.gather(gt_masks, 1, idx[..., None, None].expand(b, s, m0, m0))
    out = torch.bmm(torch.bmm(wv, masks.float().reshape(b * s, m0, m0)), wu.transpose(1, 2))
    return (out >= 0.5).float().reshape(b, s, r, r)


# ----------------------------------------------------------------- losses

def smooth_l1(pred, target, sigma: float):
    s2 = sigma * sigma
    diff = pred - target
    a = diff.abs()
    return torch.where(a < 1.0 / s2, 0.5 * s2 * diff * diff, a - 0.5 / s2)


def sigmoid_ce(logits, labels):
    return logits.clamp_min(0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def softmax_ce(logits, labels, weights, normalizer):
    ce = -torch.gather(F.log_softmax(logits, dim=-1), -1, labels[..., None].long())[..., 0]
    return (ce * weights).sum() / normalizer
