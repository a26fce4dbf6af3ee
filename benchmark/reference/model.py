"""Mask R-CNN with a ResNet-FPN backbone, in plain PyTorch.

The forward passes (inference, and the training loss) of He et al.'s Mask
R-CNN (arXiv:1703.06870) with an FPN (Lin et al., arXiv:1612.03144), as
Detectron's ``e2e_mask_rcnn_R-{50,101}-FPN_1x`` configures them and as
the measured program computes them: torchvision v1.5 bottlenecks under
frozen BatchNorm, FPN P2-P6 (P6 the stride-2 subsample of P5), one RPN
head over the levels, proposals by per-level top-k and greedy NMS then a
cross-level top-k, the 2x1024 FC box head on 7x7 RoIAlign, per-class
decode and class-aware NMS, the 4-conv mask head on 14x14 RoIAlign.

Every function takes the state dict of float32 tensors under the
program's parameter names, and a ``numerics``: ``"fp32"`` (float32 with
TF32 off: the reference) or ``"fp8"`` (the control, one precision below the bf16 the
configurations state). In fp8 every convolution's and linear layer's
input, weight and output, every BatchNorm's output and every residual sum
are rounded to float8 e4m3 under a per-tensor scale: the activations as a
network that computes and keeps them in fp8 holds them. Nothing here
imports the program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.nn import functional as F

from benchmark.reference import ops

STAGE_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
RPN_STRIDES = (4, 8, 16, 32, 64)
ROI_STRIDES = (4, 8, 16, 32)
NUMERICS = ("fp32", "fp8", "int8")
FP8_MAX = 448.0  # largest finite float8 e4m3fn
INT8_MAX = 127.0


def quantize(x: torch.Tensor, numerics: str) -> torch.Tensor:
    """``x`` as ``numerics`` computes with it: itself in fp32, else rounded
    to float8 e4m3 under the scale that maps its largest magnitude to 448.
    The rounding passes gradients straight through."""
    if numerics == "fp32":
        return x
    amax = x.detach().abs().amax().float()
    if numerics == "int8":
        scale = (amax / INT8_MAX).clamp_min(1e-30)
        q = torch.round(x.detach() / scale).clamp(-INT8_MAX, INT8_MAX) * scale
    else:
        scale = (amax / FP8_MAX).clamp_min(1e-30)
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach()) if x.requires_grad else q


class Net:
    """The network's layers over a state dict ``params`` (float32)."""

    def __init__(self, params: dict, mcfg: dict, numerics: str = "fp32"):
        if numerics not in NUMERICS:
            raise ValueError(f"numerics {numerics!r}: want one of {NUMERICS}")
        self.p = params
        self.m = mcfg
        self.numerics = numerics

    def q(self, x):
        return quantize(x, self.numerics)

    def conv(self, name, x, stride=1, padding=0, bias=True):
        w = self.p[name + ".weight"]
        b = self.p[name + ".bias"] if bias else None
        return self.q(F.conv2d(self.q(x), self.q(w), b, stride=stride, padding=padding))

    def linear(self, name, x):
        return self.q(F.linear(self.q(x), self.q(self.p[name + ".weight"]),
                               self.p[name + ".bias"]))

    def bn(self, name, x):
        scale = self.p[name + ".weight"] * torch.rsqrt(self.p[name + ".running_var"] + 1e-5)
        bias = self.p[name + ".bias"] - self.p[name + ".running_mean"] * scale
        return self.q(x * scale[None, :, None, None] + bias[None, :, None, None])

    # ------------------------------------------------------------ backbone

    def bottleneck(self, name, x, stride, downsample):
        out = F.relu(self.bn(name + ".bn1", self.conv(name + ".conv1", x, bias=False)))
        out = F.relu(self.bn(name + ".bn2", self.conv(name + ".conv2", out, stride, 1,
                                                      bias=False)))
        out = self.bn(name + ".bn3", self.conv(name + ".conv3", out, bias=False))
        if downsample:
            x = self.bn(name + ".downsample_bn",
                        self.conv(name + ".downsample_conv", x, stride, bias=False))
        return F.relu(self.q(out + x))

    def backbone(self, x, frozen_stages: int = 1):
        """NCHW images -> C2..C5; the stem and the frozen stages' output is
        detached (they take no gradient)."""
        x = F.relu(self.bn("backbone.bn1", self.conv("backbone.conv1", x, 2, 3, bias=False)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = []
        for stage, blocks in enumerate(STAGE_BLOCKS[self.m["backbone"]]):
            for i in range(blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                x = self.bottleneck(f"backbone.layer{stage + 1}.{i}", x, stride, i == 0)
            if stage + 1 <= frozen_stages:
                x = x.detach()
            feats.append(x)
        return feats

    def fpn(self, feats):
        lateral = [self.conv(f"fpn.lateral{i + 2}", c) for i, c in enumerate(feats)]
        tds = [lateral[-1]]
        for lat in reversed(lateral[:-1]):
            tds.append(lat + F.interpolate(tds[-1], scale_factor=2, mode="nearest"))
        tds = tds[::-1]
        ps = [self.conv(f"fpn.smooth{i + 2}", t, padding=1) for i, t in enumerate(tds)]
        return ps + [ps[-1][:, :, ::2, ::2]]

    def features(self, images, frozen_stages: int = 1):
        """NHWC float32 images -> NHWC levels P2..P6."""
        levels = self.fpn(self.backbone(images.permute(0, 3, 1, 2), frozen_stages))
        return [p.permute(0, 2, 3, 1) for p in levels]

    # --------------------------------------------------------------- heads

    def rpn(self, levels):
        scores, deltas = [], []
        for p in levels:
            x = p.permute(0, 3, 1, 2)
            t = F.relu(self.conv("rpn_head.conv", x, padding=1))
            b = x.shape[0]
            scores.append(self.conv("rpn_head.objectness", t).permute(0, 2, 3, 1).reshape(b, -1))
            deltas.append(self.conv("rpn_head.deltas", t).permute(0, 2, 3, 1).reshape(b, -1, 4))
        return scores, deltas

    def pool(self, levels, rois, size):
        pooled = levels[:len(ROI_STRIDES)]
        return ops.roi_align(pooled, rois, ROI_STRIDES, size, self.m["sampling_ratio"],
                             ops.roi_span(pooled[-1].shape[1:3]))

    def box(self, levels, rois):
        pooled = self.pool(levels, rois, self.m["pool_size"])
        b, r = pooled.shape[:2]
        x = F.relu(self.linear("box_head.fc1", pooled.reshape(b, r, -1)))
        x = F.relu(self.linear("box_head.fc2", x))
        return self.linear("box_head.cls_score", x), self.linear(
            "box_head.bbox_pred", x).reshape(b, r, -1, 4)

    def mask(self, levels, rois):
        pooled = self.pool(levels, rois, self.m["mask_pool_size"])
        b, r, h, w, c = pooled.shape
        x = pooled.reshape(b * r, h, w, c).permute(0, 3, 1, 2)
        for i in range(4):
            x = F.relu(self.conv(f"mask_head.conv{i}", x, padding=1))
        wd = self.p["mask_head.deconv.weight"]
        x = F.relu(self.q(F.conv_transpose2d(self.q(x), self.q(wd),
                                             self.p["mask_head.deconv.bias"], stride=2)))
        x = self.conv("mask_head.mask_logits", x)
        return x.permute(0, 2, 3, 1).reshape(b, r, 2 * h, 2 * w, -1)


class Detections(NamedTuple):
    boxes: torch.Tensor  # [B, D, 4]
    scores: torch.Tensor  # [B, D]
    classes: torch.Tensor  # [B, D], 0 = empty slot
    valid: torch.Tensor  # [B, D]


def anchors(mcfg, canvas_hw, device):
    """Per-level RPN anchors ``[Hl * Wl * A, 4]`` of a padded canvas."""
    return [torch.as_tensor(a, device=device) for a in ops.grid_anchors(
        tuple(canvas_hw), RPN_STRIDES, mcfg["anchor_ratios"], mcfg["rpn_anchor_scale"])]


def proposals(scores_pl, deltas_pl, anchors_pl, image_hw, pre_k: int, post_k: int,
              thresh: float):
    """RPN proposals: ``(boxes [B, post_k, 4], valid [B, post_k])``."""
    b = image_hw.shape[0]
    hgt, wid = image_hw[:, 0, None], image_hw[:, 1, None]
    cb, cs, cv = [], [], []
    for s, d, anc in zip(scores_pl, deltas_pl, anchors_pl):
        k = min(pre_k, s.shape[1])
        top_s, top_i = ops.sort_desc(s.float())
        top_s, top_i = top_s[:, :k], top_i[:, :k]
        top_d = torch.gather(d, 1, top_i[..., None].expand(b, k, 4))
        boxes = ops.clip_boxes(ops.decode_boxes(top_d, anc[top_i]), hgt, wid)
        w, h = ops.box_wh(boxes)
        ok = (w >= 0.0) & (h >= 0.0)
        if pre_k > k:
            pad = pre_k - k
            boxes = torch.cat([boxes, boxes.new_zeros((b, pad, 4))], 1)
            top_s = torch.cat([top_s, top_s.new_full((b, pad), ops.NEG_INF)], 1)
            ok = torch.cat([ok, ok.new_zeros((b, pad))], 1)
        cb.append(boxes)
        cs.append(top_s)
        cv.append(ok)
    nl = len(cb)
    g = b * nl
    boxes = torch.stack(cb, 1).reshape(g, pre_k, 4)
    scores = torch.stack(cs, 1).reshape(g, pre_k)
    idx, keep = ops.nms_batched(boxes, scores, torch.stack(cv, 1).reshape(g, pre_k), thresh,
                                min(post_k, pre_k))
    cap = idx.shape[1]
    kb = torch.gather(boxes, 1, idx[..., None].expand(g, cap, 4))
    ks = torch.where(keep, torch.gather(scores, 1, idx), torch.full_like(keep, ops.NEG_INF,
                                                                         dtype=scores.dtype))
    top_s, top_i = ops.sort_desc(ks.reshape(b, nl * cap))
    top_s, top_i = top_s[:, :post_k], top_i[:, :post_k]
    valid = top_s > -1e9
    out = torch.gather(kb.reshape(b, nl * cap, 4), 1, top_i[..., None].expand(b, post_k, 4))
    return torch.where(valid[..., None], out, torch.zeros_like(out)), valid


def detect(cls_logits, reg, rois, roi_valid, image_hw, mcfg) -> Detections:
    """Softmax, per-class decode, clip, score threshold, the top candidates,
    class-aware NMS to ``detections_per_image`` slots. The softmax and the
    scores keep the logits' dtype, the decode promotes against the float32
    RoIs: on another path's logits this is that path's post-processing."""
    b, r, kp1 = cls_logits.shape
    k = kp1 - 1
    cand_n = min(mcfg["post_nms_topk_test"] * 4, r * k)
    probs = torch.softmax(cls_logits, dim=-1)[..., 1:]
    boxes = ops.decode_boxes(reg[:, :, 1:], rois[:, :, None, :], mcfg["bbox_reg_weights"])
    boxes = ops.clip_boxes(boxes, image_hw[:, 0, None, None], image_hw[:, 1, None, None])
    flat_s = probs.reshape(b, r * k)
    flat_b = boxes.reshape(b, r * k, 4)
    flat_c = torch.arange(1, kp1, dtype=torch.int64, device=rois.device).repeat(r)
    flat_v = roi_valid.repeat_interleave(k, dim=1) & (flat_s > mcfg["score_thresh"])
    top_s, top_i = ops.sort_desc(torch.where(flat_v, flat_s, torch.full_like(flat_s, -1.0)))
    top_s, top_i = top_s[:, :cand_n], top_i[:, :cand_n]
    cand_b = torch.gather(flat_b, 1, top_i[..., None].expand(b, cand_n, 4))
    cand_c = flat_c[top_i]
    d = mcfg["detections_per_image"]
    idx, keep = ops.class_aware_nms(cand_b, top_s, cand_c, mcfg["test_nms_thresh"], d,
                                    top_s > 0.0)
    zero = torch.zeros_like
    out_b = torch.gather(cand_b, 1, idx[..., None].expand(-1, d, 4))
    return Detections(
        boxes=torch.where(keep[..., None], out_b, zero(out_b)),
        scores=torch.where(keep, torch.gather(top_s, 1, idx), zero(top_s[:, :d])),
        classes=torch.where(keep, torch.gather(cand_c, 1, idx), zero(idx)),
        valid=keep)


def own_class_probs(mask_logits, classes):
    k = torch.clamp(classes.long() - 1, 0, mask_logits.shape[-1] - 1)
    return torch.sigmoid(torch.take_along_dim(mask_logits, k[:, :, None, None, None],
                                              dim=-1)[..., 0])


def eval_proposals(mcfg, scores_pl, deltas_pl, image_hw, canvas_hw):
    return proposals(scores_pl, deltas_pl, anchors(mcfg, canvas_hw, image_hw.device), image_hw,
                     mcfg["pre_nms_topk_test"], mcfg["post_nms_topk_test"],
                     mcfg["rpn_nms_thresh"])


@torch.no_grad()
def predict(params, mcfg, images, image_hw, numerics: str = "fp32") -> dict:
    """The inference pass, every stage's outputs: ``rpn`` (objectness and
    deltas a level), ``proposals`` (boxes, valid), ``box`` (class logits,
    box deltas a class), ``dets`` (:class:`Detections`) and ``masks`` (each
    detection's own-class mask probabilities ``[B, D, 28, 28]``)."""
    net = Net(params, mcfg, numerics)
    levels = net.features(images)
    rpn = net.rpn(levels)
    props = eval_proposals(mcfg, *rpn, image_hw, images.shape[1:3])
    box = net.box(levels, props[0])
    dets = detect(*box, *props, image_hw, mcfg)
    masks = own_class_probs(net.mask(levels, dets.boxes), dets.classes)
    return {"rpn": rpn, "proposals": props, "box": box, "dets": dets, "masks": masks}


@torch.no_grad()
def follow(params, mcfg, images, image_hw, side: dict) -> dict:
    """The reference stage by stage on the inputs that another path's
    stages (``side``, as :func:`predict` gives them) handed each other: its
    own RPN on the images; its proposal stage on ``side``'s RPN outputs;
    its box head on ``side``'s proposals; its post-processing on
    ``side``'s box-head outputs and proposals; its mask head on ``side``'s
    detections. The same keys as :func:`predict`'s."""
    net = Net(params, mcfg)
    levels = net.features(images)
    props = side["proposals"]
    dets = side["dets"]
    return {"rpn": net.rpn(levels),
            "proposals": eval_proposals(mcfg, *side["rpn"], image_hw, images.shape[1:3]),
            "box": net.box(levels, props[0]),
            "dets": detect(*side["box"], *props, image_hw, mcfg),
            "masks": own_class_probs(net.mask(levels, dets.boxes), dets.classes)}


class TrainDraws(NamedTuple):
    """Uniform draws of one step: RPN positive and negative samples
    ``[B, anchors]``, RoI foreground and background ``[B, proposals + gt]``."""

    rpn_pos: torch.Tensor
    rpn_neg: torch.Tensor
    roi_fg: torch.Tensor
    roi_bg: torch.Tensor


def loss_norms(mcfg, batch, draws: TrainDraws, proposals):
    """The normalizers of a step's losses, over the whole batch: the RPN's
    sampled anchors, the sampled RoIs, the foreground RoIs of the mask
    loss. They depend on the gt, the draws and the proposals alone, so a
    step computed in blocks of images divides by the batch's."""
    anchors_all = torch.cat(anchors(mcfg, batch["image"].shape[1:3], batch["image"].device), 0)
    _, cls_w, _, _ = ops.anchor_targets(
        anchors_all, batch["gt_boxes"], batch["gt_classes"], draws.rpn_pos, draws.rpn_neg,
        mcfg["rpn_positive_iou"], mcfg["rpn_negative_iou"], mcfg["rpn_batch_per_image"],
        mcfg["rpn_positive_fraction"])
    _, _, weights, _, fg_w, _ = sample(mcfg, batch, draws, proposals)
    cap = max(int(mcfg["roi_batch_per_image"] * mcfg["roi_positive_fraction"]), 1)
    return {"rpn": cls_w.sum().clamp_min(1.0), "roi": weights.sum().clamp_min(1.0),
            "mask": fg_w[:, :cap].sum().clamp_min(1.0)}


def sample(mcfg, batch, draws, proposals):
    return ops.sample_rois(
        proposals[0], proposals[1], batch["gt_boxes"], batch["gt_classes"], draws.roi_fg,
        draws.roi_bg, mcfg["roi_batch_per_image"], mcfg["roi_positive_fraction"],
        mcfg["roi_positive_iou"], mcfg["roi_negative_iou_hi"], mcfg["roi_negative_iou_lo"],
        mcfg["bbox_reg_weights"])


def train_proposals(mcfg, scores_pl, deltas_pl, anchors_pl, image_hw):
    return proposals(scores_pl, deltas_pl, anchors_pl, image_hw, mcfg["pre_nms_topk_train"],
                     mcfg["post_nms_topk_train"], mcfg["rpn_nms_thresh"])


def train_loss(params, mcfg, batch, draws: TrainDraws, numerics: str = "fp32",
               proposals_in=None, norms=None):
    """The training forward's loss dict: RPN objectness and box, Fast R-CNN
    class and box, mask. ``proposals_in``: ``(boxes, valid)`` to sample
    RoIs from in place of this pass's own proposals; ``norms``: the
    normalizers of :func:`loss_norms` (by default this batch's)."""
    net = Net(params, mcfg, numerics)
    images, image_hw = batch["image"], batch["image_hw"]
    gt_boxes, gt_classes, gt_masks = batch["gt_boxes"], batch["gt_classes"], batch["gt_masks"]
    anchors_pl = anchors(mcfg, images.shape[1:3], images.device)
    anchors_all = torch.cat(anchors_pl, 0)
    levels = net.features(images, mcfg["frozen_stages"])
    scores_pl, deltas_pl = net.rpn(levels)
    scores, deltas = torch.cat(scores_pl, 1), torch.cat(deltas_pl, 1)
    pos, cls_w, box_t, box_w = ops.anchor_targets(
        anchors_all, gt_boxes, gt_classes, draws.rpn_pos, draws.rpn_neg, mcfg["rpn_positive_iou"],
        mcfg["rpn_negative_iou"], mcfg["rpn_batch_per_image"], mcfg["rpn_positive_fraction"])
    if proposals_in is None:
        proposals_in = train_proposals(mcfg, [s.detach() for s in scores_pl],
                                       [d.detach() for d in deltas_pl], anchors_pl, image_hw)
    rois, labels, weights, targets, fg_w, matched = sample(mcfg, batch, draws, proposals_in)
    cap = max(int(mcfg["roi_batch_per_image"] * mcfg["roi_positive_fraction"]), 1)
    if norms is None:
        norms = {"rpn": cls_w.sum().clamp_min(1.0), "roi": weights.sum().clamp_min(1.0),
                 "mask": fg_w[:, :cap].sum().clamp_min(1.0)}
    losses = {
        "loss_rpn_cls": (ops.sigmoid_ce(scores, pos.float()) * cls_w).sum() / norms["rpn"],
        "loss_rpn_box": (ops.smooth_l1(deltas, box_t, mcfg["rpn_smooth_l1_sigma"]).sum(-1)
                         * box_w).sum() / norms["rpn"],
    }
    cls_logits, reg = net.box(levels, rois)
    b, s = cls_logits.shape[:2]
    losses["loss_cls"] = ops.softmax_ce(cls_logits.reshape(b * s, -1), labels.reshape(-1),
                                        weights.reshape(-1), norms["roi"])
    k = torch.clamp(labels.long(), 0, reg.shape[2] - 1)
    sel = torch.take_along_dim(reg, k[..., None, None], dim=2)[:, :, 0]
    losses["loss_box"] = (ops.smooth_l1(sel, targets, mcfg["roi_smooth_l1_sigma"]).sum(-1)
                          * fg_w).sum() / norms["roi"]
    rois_m = rois[:, :cap]
    logits = net.mask(levels, rois_m)
    tgt = ops.mask_targets(gt_masks, gt_boxes, rois_m, matched[:, :cap], mcfg["mask_resolution"])
    kk = torch.clamp(labels[:, :cap].long() - 1, 0, logits.shape[-1] - 1)
    own = torch.take_along_dim(logits, kk[..., None, None, None], dim=-1)[..., 0]
    per_roi = ops.sigmoid_ce(own, tgt).mean(dim=(2, 3))
    losses["loss_mask"] = (per_roi * fg_w[:, :cap]).sum() / norms["mask"]
    return losses


def trainable(name: str, frozen_stages: int) -> bool:
    """Whether SGD moves parameter ``name``: not a frozen BatchNorm's
    statistics or affine (buffers), not the stem or a frozen stage."""
    if ".bn" in name or "_bn." in name or name.startswith("backbone.bn1"):
        return False
    if name.startswith("backbone.conv1."):
        return False
    return not any(name.startswith(f"backbone.layer{s}.") for s in range(1, frozen_stages + 1))


def decayed(name: str) -> bool:
    """Weight decay takes the conv, deconv and linear weights."""
    return name.endswith(".weight")


def lr_at(step: int, mcfg) -> float:
    """Linear warmup from ``base_lr * warmup_factor``, then step decay."""
    base = mcfg["base_lr"]
    warm = mcfg["warmup_steps"]
    if step < warm:
        frac = 1.0 - min(max(step, 0), warm) / max(warm, 1)
        return (base * mcfg["warmup_factor"] - base) * frac + base
    lr = base
    for boundary in mcfg["lr_decay_steps"]:
        if step >= boundary:
            lr *= mcfg["lr_decay_factor"]
    return lr


def sgd_steps(params, mcfg, batches, draws, numerics: str = "fp32", on_step=None,
              proposals=None, block: int | None = None):
    """``len(batches)`` SGD steps with momentum and weight decay from
    ``params`` (left untouched). ``proposals``: per step, the ``(boxes,
    valid)`` to sample RoIs from (by default each step's own); ``block``:
    the images a forward and backward hold at once (the gradients of the
    blocks are summed, every loss divided by the whole batch's
    normalizers). ``on_step(i, losses, params, momentum)`` is called after
    each step. Returns the parameters after the last step."""
    names = [n for n in params if trainable(n, mcfg["frozen_stages"])]
    p = {n: v.detach().clone() for n, v in params.items()}
    buf = {}
    for i, (batch, draw) in enumerate(zip(batches, draws)):
        n_img = batch["image"].shape[0]
        step = block or n_img
        props = proposals[i] if proposals is not None else None  # None: its own
        if props is None and step < n_img:
            with torch.no_grad():
                net = Net(p, mcfg, numerics)
                scores_pl, deltas_pl = net.rpn(net.features(batch["image"], mcfg["frozen_stages"]))
                props = train_proposals(mcfg, scores_pl, deltas_pl,
                                        anchors(mcfg, batch["image"].shape[1:3],
                                                batch["image"].device), batch["image_hw"])
                del net, scores_pl, deltas_pl
        norms = loss_norms(mcfg, batch, draw, props) if props is not None else None
        grads = {n: torch.zeros_like(p[n]) for n in names}
        losses = {}
        for s in range(0, n_img, step):
            rows = slice(s, s + step)
            part = {k: v[rows] for k, v in batch.items()}
            leaves = {n: p[n].clone().requires_grad_(n in grads) for n in p}
            block_losses = train_loss(
                leaves, mcfg, part, TrainDraws(*(d[rows] for d in draw)), numerics,
                None if props is None else (props[0][rows], props[1][rows]), norms)
            total = sum(block_losses.values())
            got = torch.autograd.grad(total, [leaves[n] for n in names], allow_unused=True)
            for n, g in zip(names, got):
                if g is not None:
                    grads[n] += g
            for k, v in block_losses.items():
                losses[k] = losses.get(k, 0.0) + float(v.detach())
            del leaves, block_losses, total, got
        lr = lr_at(i, mcfg)
        with torch.no_grad():
            for n in names:
                g = grads[n]
                if decayed(n):
                    g = g + mcfg["weight_decay"] * p[n]
                buf[n] = g.clone() if n not in buf else buf[n].mul_(mcfg["momentum"]).add_(g)
                p[n] -= lr * buf[n]
        if on_step is not None:
            on_step(i, {**losses, "loss_total": sum(losses.values())}, p, buf)
        del grads
    return p
