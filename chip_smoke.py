"""Smoke test of the PyTorch port on one NVIDIA GPU (run: python3 chip_smoke.py).

Phases, in order; any failure exits non-zero before the result line:

1. device: requires CUDA, prints the card's name and power limit, turns
   TF32 off for matmuls and convolutions;
2. build: compiles the hand-written kernels (csrc/*.cu) with nvcc;
3. K1 (greedy NMS) against its plain PyTorch version on the card, at the
   inference (G=10, N=1000; G=2, N=1200) and training (G=10, N=2000)
   shapes: keep masks and (idx, valid) must be equal;
4. K2 (multilevel RoIAlign) against its plain version on the card, at the
   1024x1344 P2-P5 shapes, C=256, inference (R=300, P=7; R=100, P=14) and
   training (R=512, P=7; R=128, P=14) RoI counts: max |diff| <= 1e-5 *
   max |feature|;
5. predict: Mask R-CNN R-50-FPN (configs/mask_rcnn_r50_fpn_coco.yaml) at
   full width, 1024x1344, float32, batch 2, weights from a numpy seed:
   predict_fn three times; both kernels' launch counts must rise on every
   call, detections must be non-empty and mask probabilities in [0, 1];
6. cross-device predict: the same port at 256x256 with small widths on the
   card and on the CPU (plain versions) with the same weights: equal valid
   slots, boxes within 1e-3;
7. K3 (multilevel RoIAlign backward) against its plain version on the
   card at the training shapes (B=2, 1024x1344, P2-P5, C=256; R=512, P=7
   and R=128, P=14): max |diff| <= 1e-5 * max |plain gradient|; two K3
   runs are compared too (fp32 atomics add in a varying order);
8. the autograd Function (K2 forward, K3 backward) on the card: the
   gradient of a weighted sum of its output equals autograd through the
   plain forward within the same bound;
9. train: Mask R-CNN R-101-FPN (configs/mask_rcnn_r101_fpn_coco_train.yaml)
   at full width, 1024x1344, float32, train.batch_size=2,
   train.base_lr=0.0025, seeded synthetic batches: 2 warm-up train_steps,
   then 5; every loss finite on every step, K1, K2 (2) and K3 (2) launched
   on every step, frozen parameters unchanged and every trainable one
   changed; per-step ms, a CUDA-event breakdown, peak memory, a profiler
   pass; then the train driver for 2 steps;
10. cross-device train: one train_step at 256x256 with small widths on the
    card and on the CPU with the same weights and draws: losses within
    1e-4 relative, and each updated tensor's update on the card within
    UPDATE_RTOL of its update on the CPU (relative, in norm; float32
    gradients are summed in other orders by cuDNN and the CPU); as
    controls, the card step with K3's plain version must pass that limit,
    and with a planted K3 fault (P2 zeroed; 10% short) must fail it.

It then prints a JSON line of per-kernel results, the card's name and
power limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"  # where the kernel phases place their tensors
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- phase 1, 2


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = card_line()
    log(f"[device] {line}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return line


def phase_build() -> float:
    from detectron_tpu_torch import _build

    seconds = _build.build()
    log(f"[build] kernels {_build.KERNELS} in {seconds:.1f} s "
        f"(nvcc {_build.nvcc()})")
    for name in _build.KERNELS:
        report = _build.library_path(name).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")
    return seconds


# ----------------------------------------------------------------- phase 3


def nms_problems(rng, g, n, canvas, n_invalid, classes=0):
    """Seeded NMS inputs: clustered boxes (so suppression chains form),
    the last ``n_invalid`` slots padded invalid with score -1e10, and
    exact score ties."""
    h, w = canvas
    centers = rng.uniform([0, 0], [w, h], size=(g, n // 8 + 1, 2))
    pick = rng.randint(0, centers.shape[1], size=(g, n))
    c = np.take_along_axis(centers, pick[..., None].repeat(2, -1), 1)
    c = c + rng.normal(0, 6, size=(g, n, 2))
    cluster_wh = rng.uniform(16, 300, size=(g, centers.shape[1], 2))
    wh = np.take_along_axis(cluster_wh, pick[..., None].repeat(2, -1), 1)
    wh = wh * np.exp(rng.normal(0, 0.1, size=(g, n, 2)))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0, 1, size=(g, n)).astype(np.float32)
    scores[:, 1::7] = scores[:, 0:1]  # exact ties
    valid = np.ones((g, n), bool)
    if n_invalid:
        valid[:, n - n_invalid:] = False
        scores[:, n - n_invalid:] = -1e10
        boxes[:, n - n_invalid:] = 0.0
    cls = rng.randint(1, classes, size=(g, n)) if classes else None
    return boxes, scores, valid, cls


def phase_nms(rng):
    from detectron_tpu_torch.ops import nms

    dev = torch.device(DEVICE)
    cases = [
        # RPN: one problem per (image, level), B=2 x 5 levels
        dict(name="rpn", g=10, n=1000, thresh=0.7, max_out=300, n_invalid=120, classes=0,
             path="predict"),
        # detections: class-shifted candidates, one problem per image
        dict(name="det", g=2, n=1200, thresh=0.5, max_out=100, n_invalid=200, classes=81,
             path="predict"),
        # training RPN: pre_nms_topk_train=2000 per level, post 1000
        dict(name="rpn_train", g=10, n=2000, thresh=0.7, max_out=1000, n_invalid=200,
             classes=0, path="train"),
    ]
    results = []
    for case in cases:
        boxes, scores, valid, cls = nms_problems(
            rng, case["g"], case["n"], (1024, 1344), case["n_invalid"], case["classes"])
        tb, ts, tv = (torch.tensor(x, device=dev) for x in (boxes, scores, valid))
        if cls is not None:
            tc = torch.tensor(cls, device=dev)
            span = tb.amax(dim=(1, 2)) - tb.amin(dim=(1, 2)) + 1.0
            tb = tb + (tc.to(tb.dtype) * span[:, None])[..., None]
        # sorted problems, as the kernel receives them
        masked = torch.where(tv, ts, torch.full_like(ts, nms.NEG_INF))
        order_scores, order = nms.sort_desc(masked)
        sboxes = torch.gather(tb, 1, order[..., None].expand(-1, -1, 4)).contiguous()
        svalid = (order_scores > nms.NEG_INF / 2).contiguous()
        keep_k = nms.greedy_keep_cuda(sboxes, svalid, case["thresh"])
        keep_p = nms.greedy_keep_plain(sboxes, svalid, case["thresh"])
        torch.cuda.synchronize()
        if not torch.equal(keep_k, keep_p):
            raise AssertionError(f"K1 {case['name']}: keep masks differ in "
                                 f"{int((keep_k != keep_p).sum())} slots")
        idx_g, ok_g = nms.nms_padded_batched(tb, ts, tv, case["thresh"], case["max_out"])
        idx_c, ok_c = nms.nms_padded_batched(tb.cpu(), ts.cpu(), tv.cpu(),
                                             case["thresh"], case["max_out"])
        if not (torch.equal(idx_g.cpu(), idx_c) and torch.equal(ok_g.cpu(), ok_c)):
            raise AssertionError(f"K1 {case['name']}: (idx, valid) differ from the "
                                 "CPU plain path")
        ms = cuda_ms(lambda: nms.greedy_keep_cuda(sboxes, svalid, case["thresh"]))
        plain_ms = cuda_ms(lambda: nms.greedy_keep_plain(sboxes, svalid, case["thresh"]),
                           iters=3, warmup=1)
        # work this run's data needs: each kept box against every later valid box
        n_valid = svalid.sum(1, keepdim=True)
        pos = torch.arange(case["n"], device=dev)[None, :]
        pairs = int(torch.where(keep_k, n_valid - 1 - pos, torch.zeros_like(pos)).sum())
        g, n = case["g"], case["n"]
        b_ms, b_by = bound_ms(nbytes=g * n * (16 + 1 + 1), ops=pairs * 16)
        log(f"[K1 {case['name']}] G={g} N={n} t={case['thresh']}: keep masks equal "
            f"({int(keep_k.sum())} kept), (idx, valid) equal to the CPU path; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.6f} ms ({b_by})")
        results.append(dict(case=case["name"], path=case["path"], ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by))
    return results


# ----------------------------------------------------------------- phase 4


def roi_cases(rng, b, r, canvas):
    """Seeded RoIs: random boxes, elongated boxes at the top of a level's
    size band (span promotion), boxes past the image border, sub-cell boxes."""
    h, w = canvas
    xy = rng.uniform([-50, -50], [w, h], size=(b, r, 2))
    wh = np.exp(rng.uniform(np.log(2), np.log(700), size=(b, r, 2)))
    rois = np.concatenate([xy, xy + wh], -1)
    k = r // 8
    # elongated band-top: area near 224*2^j squared, aspect up to 6:1
    side = 224.0 * 2.0 ** rng.randint(-2, 2, size=(b, k)) * 0.98
    aspect = rng.uniform(2.0, 6.0, size=(b, k))
    bw, bh = side * np.sqrt(aspect), side / np.sqrt(aspect)
    flip = rng.rand(b, k) < 0.5
    bw, bh = np.where(flip, bh, bw), np.where(flip, bw, bh)
    x0 = rng.uniform(0, w - 100, size=(b, k))
    y0 = rng.uniform(0, h - 100, size=(b, k))
    rois[:, :k] = np.stack([x0, y0, x0 + bw, y0 + bh], -1)
    # past the border
    rois[:, k:2 * k, :2] -= rng.uniform(50, 400, size=(b, k, 2))
    rois[:, k:2 * k, 2:] += rng.uniform(100, 600, size=(b, k, 2))
    # sub-cell
    rois[:, 2 * k:3 * k, 2:] = rois[:, 2 * k:3 * k, :2] + rng.uniform(0.1, 3.0, size=(b, k, 2))
    return rois.astype(np.float32)


def touched_bytes(features, rois, levels, strides, p, s):
    """Bytes of the distinct feature cells that the samples of these RoIs
    read (each once), at four bytes a value."""
    from detectron_tpu_torch.ops.roi_align import _bilinear_1d, _sample_coords

    dev = rois.device
    c = features[0].shape[-1]
    b = rois.shape[0]
    hs = torch.tensor([f.shape[1] for f in features], device=dev)
    ws = torch.tensor([f.shape[2] for f in features], device=dev)
    sizes = hs * ws
    offs = torch.cumsum(sizes, 0) - sizes
    total = int(sizes.sum())
    lvl = levels.long()
    scale = 1.0 / torch.tensor(strides, dtype=torch.float32, device=dev)[lvl]
    x1, y1 = rois[..., 0] * scale, rois[..., 1] * scale
    rw = (rois[..., 2] * scale - x1).clamp_min(1.0)
    rh = (rois[..., 3] * scale - y1).clamp_min(1.0)
    xi0, xi1, _, _, xin = _bilinear_1d(_sample_coords(x1, rw, p, s), ws[lvl].float()[..., None])
    yi0, yi1, _, _, yin = _bilinear_1d(_sample_coords(y1, rh, p, s), hs[lvl].float()[..., None])
    base = (torch.arange(b, device=dev)[:, None] * total + offs[lvl])[..., None, None]
    cells = []
    inb = yin[..., :, None] & xin[..., None, :]
    for yi in (yi0, yi1):
        for xi in (xi0, xi1):
            flat = base + yi[..., :, None] * ws[lvl][..., None, None] + xi[..., None, :]
            cells.append(flat[inb])
    return int(torch.unique(torch.cat(cells)).numel()) * c * 4


CANVAS = (1024, 1344)
STRIDES = (4, 8, 16, 32)
# (path, P, R): the RoIAlign calls of predict_fn (300 proposals, 100
# detections) and of a training step (512 sampled RoIs, 128 fg slots)
ROI_CASES = (("predict", 7, 300), ("predict", 14, 100), ("train", 7, 512), ("train", 14, 128))


def level_features(rng, b=2, c=256):
    """Seeded NHWC P2-P5 features of the 1024x1344 canvas."""
    return [torch.tensor(rng.randn(b, CANVAS[0] // st, CANVAS[1] // st, c).astype(np.float32),
                         device=DEVICE) for st in STRIDES]


def phase_roi_align(rng, feats):
    from detectron_tpu_torch.ops import roi_align as ra

    dev = torch.device(DEVICE)
    b, c, canvas, strides = 2, 256, CANVAS, STRIDES
    fmax = max(float(f.abs().max()) for f in feats)
    results = []
    for path, p, r in ROI_CASES:
        rois = torch.tensor(roi_cases(rng, b, r, canvas), device=dev)
        worst = 0.0
        # both routing spans; the main path's (28, 44) last, so it is the one timed
        for span in (ra.DEFAULT_MAX_SPAN, (28.0, 44.0)):
            levels = ra.assign_fpn_levels(rois, 4, 2, max_span=span)
            got = ra.multilevel_roi_align_cuda(feats, rois, levels, strides, p, 2)
            want = ra.multilevel_roi_align_plain(feats, rois, levels, strides, p, 2)
            torch.cuda.synchronize()
            diff = float((got - want).abs().max())
            worst = max(worst, diff)
            hist = torch.bincount(levels.flatten().long(), minlength=4).tolist()
            log(f"[K2 P={p} R={r} span={span}] levels {hist}, max |diff| {diff:.3e} "
                f"(limit {1e-5 * fmax:.3e})")
            if not diff <= 1e-5 * fmax:
                raise AssertionError(f"K2 P={p} span={span}: max |diff| {diff} > "
                                     f"{1e-5 * fmax}")
        ms = cuda_ms(lambda: ra.multilevel_roi_align_cuda(feats, rois, levels, strides, p, 2))
        plain_ms = cuda_ms(lambda: ra.multilevel_roi_align_plain(
            feats, rois, levels, strides, p, 2), iters=5, warmup=1)
        out_bytes = b * r * p * p * c * 4
        nbytes = touched_bytes(feats, rois, levels, strides, p, 2) + out_bytes + b * r * (16 + 4)
        b_ms, b_by = bound_ms(nbytes, ops=b * r * p * p * c * (12 * 2 * 2 + 1))
        log(f"[K2 P={p} R={r}] kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB)")
        results.append(dict(case=f"P{p} R{r}", path=path, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, max_abs_err=worst))
    return results


# ----------------------------------------------------------------- phase 5

RAISED_CLASSES = (1, 3, 17, 42, 63)  # cls_score bias raised: detections exist


def slice_inputs(cfg, seed, device, batch=2):
    rng = np.random.RandomState(seed)
    h, w = cfg.data.image_size
    images = rng.randn(batch, h, w, 3).astype(np.float32)
    image_hw = np.array([[h, w], [h - 96, w - 160]][:batch], np.float32)
    return {"image": torch.tensor(images, device=device),
            "image_hw": torch.tensor(image_hw, device=device)}


def raise_class_bias(params, classes, value=6.0):
    """Random-init logits give every class ~1/K, under test.score_thresh:
    raise a few classes so the detection NMS sees candidates."""
    bias = params["box_head.cls_score.bias"].clone()
    bias[list(classes)] = value
    params["box_head.cls_score.bias"] = bias
    return params


def counted_wrappers() -> dict:
    from detectron_tpu_torch.ops import nms, roi_align

    return {"greedy_nms": nms.greedy_keep_cuda,
            "multilevel_roi_align": roi_align.multilevel_roi_align_cuda,
            "multilevel_roi_align_bwd": roi_align.multilevel_roi_align_bwd_cuda}


def reset_counts():
    for fn in counted_wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counted_wrappers().items()}


def phase_slice(seed=0, calls=3):
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models.faster_rcnn import detection_candidates
    from detectron_tpu_torch.models.zoo import build_detector

    cfg = get_config(os.path.join(REPO, "configs", "mask_rcnn_r50_fpn_coco.yaml"))
    det = build_detector(cfg)  # the card, by default
    params = raise_class_bias(det.init(seed), RAISED_CLASSES)
    batch = slice_inputs(cfg, seed, det.device)
    log(f"[slice] {cfg.model.name} {cfg.model.backbone} FPN {cfg.model.fpn_channels} "
        f"classes {cfg.model.num_classes} canvas {tuple(cfg.data.image_size)} "
        f"{cfg.model.dtype} batch {batch['image'].shape[0]}")

    totals = {"greedy_nms": 0, "multilevel_roi_align": 0}
    times = []
    for call in range(calls):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        dets, masks = det.predict_fn(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        log(f"[slice] call {call}: {times[-1]:.1f} ms, launches {counts}")
        if counts.pop("multilevel_roi_align_bwd"):
            raise AssertionError("predict_fn launched the RoIAlign backward")
        for name, n in counts.items():
            if n <= 0:
                raise AssertionError(f"predict_fn call {call} launched {name} no time")
            totals[name] += n

    # the stages one by one, timed; they also show the candidates that
    # entered the detection NMS
    det.module.load_state_dict(params)
    props, cls_logits, reg = stage_breakdown(det, batch, cfg)
    cand_valid = detection_candidates(cls_logits, reg, props.boxes, props.valid,
                                      batch["image_hw"], cfg)[3]
    reset_counts()
    n_cand = int(cand_valid.sum())
    n_props = int(props.valid.sum())
    n_dets = int(dets.valid.sum())
    log(f"[slice] proposals valid {n_props}, detection-NMS candidates valid {n_cand}, "
        f"detections valid {n_dets}, classes {sorted(set(dets.classes[dets.valid].tolist()))}")
    if not (n_props > 0 and n_cand > 0 and n_dets > 0):
        raise AssertionError("the slice produced no proposals, candidates or detections")
    if tuple(dets.boxes.shape) != (2, cfg.test.detections_per_image, 4):
        raise AssertionError(f"detections shape {tuple(dets.boxes.shape)}")
    if masks is None or tuple(masks.shape) != (2, cfg.test.detections_per_image, 28, 28):
        raise AssertionError("mask probabilities missing or of the wrong shape")
    if not (bool(torch.isfinite(dets.boxes).all()) and bool(torch.isfinite(masks).all())
            and float(masks.min()) >= 0.0 and float(masks.max()) <= 1.0):
        raise AssertionError("non-finite boxes or mask probabilities outside [0, 1]")
    log(f"[slice] per-call ms {[round(t, 3) for t in times]}; masks in "
        f"[{float(masks.min()):.4f}, {float(masks.max()):.4f}]; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_call(lambda: det.predict_fn(params, batch), "one predict_fn")
    return totals, times


def stage_breakdown(det, batch, cfg, repeats=3):
    """Device milliseconds of each stage of faster_rcnn_eval_forward, timed
    with CUDA events between the stage calls (median of ``repeats``).
    Returns the last repeat's proposals and box-head outputs."""
    from detectron_tpu_torch.models import faster_rcnn as fr

    m = det.module
    image_hw = batch["image_hw"]
    anchors = m.anchors(batch["image"].shape[1:3], det.device)
    names = ("backbone+fpn", "rpn head", "proposals (K1)", "box: align (K2) + head",
             "detections (K1)", "mask: align (K2) + head + select")
    samples = {n: [] for n in names}
    with torch.no_grad():
        for _ in range(repeats + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
            ev[0].record()
            levels = m.features(batch["image"])
            ev[1].record()
            scores, deltas = m.rpn(levels)
            ev[2].record()
            props = fr.proposals_from_rpn(scores, deltas, anchors, image_hw, cfg)
            ev[3].record()
            cls_logits, reg = m.box(levels, props.boxes)
            ev[4].record()
            dets = fr.fastrcnn_inference(cls_logits, reg, props.boxes, props.valid,
                                         image_hw, cfg)
            ev[5].record()
            mask_logits = m.mask(levels, dets.boxes)
            k = torch.clamp(dets.classes.long() - 1, 0, mask_logits.shape[-1] - 1)
            torch.sigmoid(torch.take_along_dim(mask_logits, k[:, :, None, None, None], -1))
            ev[6].record()
            torch.cuda.synchronize()
            for i, n in enumerate(names):
                samples[n].append(ev[i].elapsed_time(ev[i + 1]))
    parts = {n: float(np.median(v[1:])) for n, v in samples.items()}  # first: warm-up
    total = sum(parts.values())
    log(f"[stages] median of {repeats}, device ms (share of {total:.2f} ms): " + "; ".join(
        f"{n} {t:.3f} ({100 * t / total:.1f}%)" for n, t in parts.items()))
    return props, cls_logits, reg


def profile_call(fn, label, top=8):
    """``fn()`` under torch.profiler: device time by kernel, and the
    device's busy time against the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    reset_counts()
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0.0:
        log("[profile] the profiler recorded no device time: busy share not measured")
        return
    log(f"[profile] {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {len(kernels)} kernel names")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")


# ----------------------------------------------------------------- phase 6


def phase_cross_device(seed=1):
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models.zoo import build_detector

    cfg = get_config(None, [
        "model.name=mask_rcnn", "model.num_classes=5", "model.fpn_channels=32",
        "data.image_size=[256, 256]", "rpn.pre_nms_topk_test=256",
        "rpn.post_nms_topk_test=64", "test.detections_per_image=20"])
    gpu, cpu = build_detector(cfg), build_detector(cfg, device="cpu")
    params = raise_class_bias(cpu.init(seed), (1, 3), value=4.0)
    batch = slice_inputs(cfg, seed, "cpu")
    reset_counts()
    dets_g, masks_g = gpu.predict_fn(params, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    dets_c, masks_c = cpu.predict_fn(params, batch)
    reset_counts()
    valid_g, valid_c = dets_g.valid.cpu(), dets_c.valid
    box_diff = float((dets_g.boxes.cpu() - dets_c.boxes).abs().max())
    mask_diff = float((masks_g.cpu() - masks_c).abs().max())
    log(f"[cross] 256x256 FPN 32: launches on the card {counts}; valid {int(valid_c.sum())} "
        f"on the CPU, equal slots {bool(torch.equal(valid_g, valid_c))}; max |box diff| "
        f"{box_diff:.3e}, max |mask diff| {mask_diff:.3e}")
    if not (counts["greedy_nms"] > 0 and counts["multilevel_roi_align"] > 0
            and int(valid_c.sum()) > 0):
        raise AssertionError("cross-device run: no kernel launch or no detection")
    if not (torch.equal(valid_g, valid_c) and torch.equal(dets_g.classes.cpu(), dets_c.classes)
            and box_diff <= 1e-3):
        raise AssertionError("cross-device run: card and CPU disagree")


# ----------------------------------------------------------------- phase 7


def phase_roi_align_bwd(rng, feats):
    """K3 against its plain version at the training shapes, with the
    main path's routing span."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.ops import roi_align as ra

    dev = torch.device(DEVICE)
    b, c = 2, feats[0].shape[-1]
    level_hw = [tuple(f.shape[1:3]) for f in feats]
    span = ra.roi_max_span(get_config(), level_hw[-1])
    results = []
    for path, p, r in ROI_CASES:
        if path != "train":
            continue
        rois = torch.tensor(roi_cases(rng, b, r, CANVAS), device=dev)
        levels = ra.assign_fpn_levels(rois, len(feats), 2, max_span=span)
        g = torch.tensor(rng.randn(b, r, p, p, c).astype(np.float32), device=dev)
        got = ra.multilevel_roi_align_bwd_cuda(g, level_hw, rois, levels, STRIDES, 2)
        again = ra.multilevel_roi_align_bwd_cuda(g, level_hw, rois, levels, STRIDES, 2)
        want = ra.multilevel_roi_align_bwd_plain(g, level_hw, rois, levels, STRIDES, 2)
        torch.cuda.synchronize()
        gmax = max(float(w.abs().max()) for w in want)
        diff = max(float((x - w).abs().max()) for x, w in zip(got, want))
        rerun = max(float((x - y).abs().max()) for x, y in zip(got, again))
        hist = torch.bincount(levels.flatten().long(), minlength=4).tolist()
        log(f"[K3 P={p} R={r} span={span}] levels {hist}, max |diff| {diff:.3e} (limit "
            f"{1e-5 * gmax:.3e} = 1e-5 x max |plain gradient|), between two K3 runs "
            f"{rerun:.3e}")
        if not diff <= 1e-5 * gmax:
            raise AssertionError(f"K3 P={p}: max |diff| {diff} > {1e-5 * gmax}")
        ms = cuda_ms(lambda: ra.multilevel_roi_align_bwd_cuda(g, level_hw, rois, levels,
                                                              STRIDES, 2))
        plain_ms = cuda_ms(lambda: ra.multilevel_roi_align_bwd_plain(
            g, level_hw, rois, levels, STRIDES, 2), iters=5, warmup=1)
        # what the function must move: g read once, every level's gradient
        # written once, RoIs and routing read once
        out_bytes = sum(b * h * w * c * 4 for h, w in level_hw)
        nbytes = g.numel() * 4 + out_bytes + b * r * (16 + 4)
        # per sample and corner: one weight product, one scaled add
        b_ms, b_by = bound_ms(nbytes, ops=b * r * p * p * c * (4 * 4 * 3 + 1))
        log(f"[K3 P={p} R={r}] kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB: level gradients "
            f"{out_bytes / 1e6:.1f}, g {g.numel() * 4 / 1e6:.1f})")
        results.append(dict(case=f"P{p} R{r}", path="train", ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, max_abs_err=diff,
                            rerun_max_abs_diff=rerun))
    return results


# ----------------------------------------------------------------- phase 8


def phase_function(rng, feats, p=14, r=128):
    """The autograd Function on the card: gradient of a weighted sum of
    multilevel_roi_align against autograd through the plain forward."""
    from detectron_tpu_torch.ops import roi_align as ra

    dev = torch.device(DEVICE)
    span = (28.0, 44.0)
    rois = torch.tensor(roi_cases(rng, 2, r, CANVAS), device=dev)
    weight = torch.tensor(rng.randn(2, r, p, p, feats[0].shape[-1]).astype(np.float32),
                          device=dev)
    leaves = [f.clone().requires_grad_(True) for f in feats]
    reset_counts()
    out = ra.multilevel_roi_align(leaves, rois, STRIDES, p, max_span=span)
    got = torch.autograd.grad((out * weight).sum(), leaves)
    torch.cuda.synchronize()
    counts = read_counts()
    levels = ra.assign_fpn_levels(rois, 4, 2, max_span=span)
    plain = ra.multilevel_roi_align_plain(leaves, rois, levels, STRIDES, p)
    want = torch.autograd.grad((plain * weight).sum(), leaves)
    gmax = max(float(w.abs().max()) for w in want)
    diff = max(float((a - w).abs().max()) for a, w in zip(got, want))
    log(f"[function] P={p} R={r}: launches {counts}; gradient max |diff| {diff:.3e} "
        f"(limit {1e-5 * gmax:.3e})")
    reset_counts()
    if counts["multilevel_roi_align"] != 1 or counts["multilevel_roi_align_bwd"] != 1:
        raise AssertionError(f"the Function did not run K2 and K3 once each: {counts}")
    if not diff <= 1e-5 * gmax:
        raise AssertionError(f"Function gradient: max |diff| {diff} > {1e-5 * gmax}")


# ----------------------------------------------------------------- phase 9

# phase 10's limit on |update on the card - update on the CPU| / |update on
# the CPU| of every updated tensor: 2.6x the sound reading (1.1e-2, the same
# with K1-K3 swapped for their plain versions, so from the convolutions),
# below a K3 whose gradients are all 10% short (1.0e-1) or that zeroes a
# level that gets RoIs (about 1); PERF.md, Findings
UPDATE_RTOL = 3e-2
TRAIN_OVERRIDES = ["train.batch_size=2", "train.base_lr=0.0025", "data.dataset=synthetic"]
TRAIN_OUT = os.path.join(REPO, "build", "train_smoke")  # the driver's output_dir


def calibrate_frozen_bn(module, images):
    """Sets every frozen BatchNorm's statistics to those of its input on
    ``images`` (one forward, in order), as a pretrained backbone's frozen
    statistics normalize its activations. With identity statistics the
    random 101-layer backbone's activations grow at every residual add,
    and SGD overflows to NaN within a few steps."""
    from detectron_tpu_torch.models.resnet import FrozenBatchNorm

    def set_stats(bn, args):
        x = args[0]
        bn.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_stats) for m in module.backbone.modules()
             if isinstance(m, FrozenBatchNorm)]
    try:
        with torch.no_grad():
            module.features(images)
    finally:
        for h in hooks:
            h.remove()


def seeded_train_state(cfg, device, seed):
    """A train state from Detector.init(seed) with the frozen BatchNorm
    statistics calibrated on the first synthetic batch; returns it and the
    batch iterator, past that batch."""
    from detectron_tpu_torch.models.zoo import build_detector
    from detectron_tpu_torch.train.driver import batch_iterator
    from detectron_tpu_torch.train.state import create_train_state

    det = build_detector(cfg, device=device)
    det.module.load_state_dict(det.init(seed))
    data = batch_iterator(cfg)
    calibrate_frozen_bn(det.module, det.batch_to_device(next(data))["image"])
    return create_train_state(cfg, det), data


def phase_train(seed=0, warmup=2, steps=5):
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.train.state import train_step

    config_path = os.path.join(REPO, "configs", "mask_rcnn_r101_fpn_coco_train.yaml")
    cfg = get_config(config_path, TRAIN_OVERRIDES)
    state, data = seeded_train_state(cfg, None, seed)  # the card, by default
    det = state.detector
    log(f"[train] {cfg.model.name} {cfg.model.backbone} FPN {cfg.model.fpn_channels} classes "
        f"{cfg.model.num_classes} canvas {tuple(cfg.data.image_size)} {cfg.model.dtype} batch "
        f"{cfg.train.batch_size} base_lr {cfg.train.base_lr} max_gt {cfg.train.max_gt_boxes}")
    named = dict(det.module.named_parameters())
    trainable = [n for n, q in named.items() if q.requires_grad]
    frozen = [n for n, q in named.items() if not q.requires_grad]
    before = {n: q.detach().clone() for n, q in named.items()}
    batches = [det.batch_to_device(next(data)) for _ in range(warmup + steps)]

    totals = dict.fromkeys(counted_wrappers(), 0)
    times = []
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        metrics = train_step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        losses = {k: float(v) for k, v in metrics.items()}
        tag = "warm-up" if i < warmup else "step"
        log(f"[train] {tag} {i}: {ms:.1f} ms, launches {counts}, "
            + " ".join(f"{k}={v:.4f}" for k, v in sorted(losses.items())))
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"train step {i}: a loss is not finite: {losses}")
        if not (counts["greedy_nms"] >= 1 and counts["multilevel_roi_align"] == 2
                and counts["multilevel_roi_align_bwd"] == 2):
            raise AssertionError(f"train step {i}: launches {counts}, want K1 >= 1, "
                                 "K2 == 2, K3 == 2")
        if i >= warmup:
            times.append(ms)
            for name, n in counts.items():
                totals[name] += n
    peak = torch.cuda.max_memory_allocated() / 2**30
    unchanged = [n for n in trainable if torch.equal(named[n].detach(), before[n])]
    moved = [n for n in frozen if not torch.equal(named[n].detach(), before[n])]
    log(f"[train] {len(trainable)} trainable tensors, {len(unchanged)} unchanged; "
        f"{len(frozen)} frozen (stem, layer1), {len(moved)} changed")
    if unchanged or moved or not frozen:
        raise AssertionError(f"train: trainable unchanged {unchanged[:5]}, frozen moved "
                             f"{moved[:5]}")
    med = float(np.median(times))
    log(f"[train] per-step ms {[round(t, 3) for t in times]}; median {med:.2f} ms = "
        f"{cfg.train.batch_size * 1e3 / med:.2f} img/s; peak device memory {peak:.2f} GiB")
    train_breakdown(state, batches[-1])
    profile_call(lambda: train_step(state, batches[-1]), "one train_step")
    del before
    phase_driver(state, config_path)
    return totals, times


def train_breakdown(state, batch, repeats=3):
    """Device milliseconds of the stages of train_step itself (median of
    ``repeats`` after one warm-up): a CUDA event is recorded at every
    stage boundary that train_step and faster_rcnn_train_forward mark."""
    from detectron_tpu_torch.train.state import train_step

    samples = {}
    for _ in range(repeats + 1):
        events = [("start", torch.cuda.Event(enable_timing=True))]
        events[0][1].record()

        def mark(stage):
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            events.append((stage, event))

        train_step(state, batch, mark=mark)
        torch.cuda.synchronize()
        for (_, a), (stage, b) in zip(events, events[1:]):
            samples.setdefault(stage, []).append(a.elapsed_time(b))
    reset_counts()
    parts = {n: float(np.median(v[1:])) for n, v in samples.items()}
    total = sum(parts.values())
    log(f"[train stages] median of {repeats}, device ms (share of {total:.2f} ms): " + "; ".join(
        f"{n} {t:.3f} ({100 * t / total:.1f}%)" for n, t in parts.items()))
    return parts


def phase_driver(state, config_path):
    """The train driver as a user runs it, resuming (--restore) from a
    checkpoint of ``state`` for 2 more steps on the card."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.train import checkpoint as ckpt
    from detectron_tpu_torch.train import driver

    out = TRAIN_OUT
    shutil.rmtree(out, ignore_errors=True)
    ckpt.save(out, state)
    cfg = get_config(config_path, TRAIN_OVERRIDES + [
        f"train.max_steps={state.step + 2}", "train.log_every=1", f"output_dir={out}"])
    t0 = time.perf_counter()
    last = driver.run(cfg, restore=True)
    log(f"[driver] resumed at step {state.step}, 2 steps in {time.perf_counter() - t0:.1f} s "
        f"(build, init, restore and checkpoint included); checkpoints "
        f"{sorted(os.listdir(out))}")
    if not (last and all(np.isfinite(v) for v in last.values())):
        raise AssertionError("the train driver logged no finite losses")
    shutil.rmtree(out, ignore_errors=True)


# ---------------------------------------------------------------- phase 10


def phase_cross_train(seed=2):
    """One train_step at 256x256 with small widths on the card and on the
    CPU, from the same weights with the same draws. Then, as controls of
    the limit, the same card step with K3's wrapper replaced: by its plain
    version (must pass), and by a K3 that zeroes the P2 gradient or gives
    every gradient 10% short (each must fail). Returns the worst relative
    update difference of each run."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models import faster_rcnn as fr
    from detectron_tpu_torch.models.zoo import build_detector
    from detectron_tpu_torch.ops import roi_align as ra
    from detectron_tpu_torch.train.state import create_train_state, train_step

    cfg = get_config(None, [
        "model.name=mask_rcnn", "model.num_classes=5", "model.fpn_channels=32",
        "data.image_size=[256, 256]", "data.dataset=synthetic", "rpn.pre_nms_topk_train=256",
        "rpn.post_nms_topk_train=64", "roi.batch_per_image=64", "train.max_gt_boxes=8",
        "train.batch_size=2", "train.base_lr=0.0025"])
    cpu_state, data = seeded_train_state(cfg, "cpu", seed)
    params = {k: v.clone() for k, v in cpu_state.params.items()}
    batch = next(data)
    n_anchors = sum(a.shape[0] for a in cpu_state.detector.module.anchors((256, 256), "cpu"))
    draws = fr.make_train_draws(torch.Generator().manual_seed(seed), 2, n_anchors, 64 + 8)
    want = train_step(cpu_state, batch, draws)
    after_c = cpu_state.params
    moved = [k for k in params if not torch.equal(after_c[k], params[k])]
    k3 = ra.multilevel_roi_align_bwd_cuda

    def card_step(bwd):
        """One card step from ``params`` with ``bwd`` as K3's wrapper:
        launches, the worst relative loss difference, and per updated
        tensor |update on the card - update on the CPU| / |update on the CPU|."""
        state = create_train_state(cfg, build_detector(cfg), params)
        ra.multilevel_roi_align_bwd_cuda = bwd
        try:
            reset_counts()
            got = train_step(state, batch, fr.TrainDraws(*(d.to(DEVICE) for d in draws)))
            torch.cuda.synchronize()
            counts = read_counts()
        finally:
            ra.multilevel_roi_align_bwd_cuda = k3
            reset_counts()
        rel = max(abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-12)
                  for k in want)
        after_g = state.params
        rdiff = {k: float(torch.linalg.vector_norm(after_g[k].cpu() - after_c[k])
                          / torch.linalg.vector_norm(after_c[k] - params[k])) for k in moved}
        return counts, rel, rdiff

    def stand_in(fn):
        def bwd(*args):
            return fn(*args)

        bwd.launches = 0  # K3 counts its launches on the name it is bound to
        return bwd

    def zero_p2(grads):
        grads[0].zero_()
        return grads

    runs = {"K3": (k3, True),
            "plain K3": (stand_in(ra.multilevel_roi_align_bwd_plain), True),
            "K3, P2 gradient zeroed": (stand_in(lambda *a: zero_p2(k3(*a))), False),
            "K3, gradients 10% short": (stand_in(lambda *a: [g.mul_(0.9) for g in k3(*a)]),
                                        False)}
    readings = {}
    log(f"[cross train] 256x256 FPN 32: losses on the CPU "
        + " ".join(f"{k}={float(v):.5f}" for k, v in sorted(want.items()))
        + f"; {len(moved)} updated tensors; limit on each one's relative update "
        f"difference {UPDATE_RTOL:.1e}")
    for name, (bwd, sound) in runs.items():
        counts, rel, rdiff = card_step(bwd)
        worst = max(rdiff, key=rdiff.get)
        readings[name] = rdiff[worst]
        log(f"[cross train] {name}: launches {counts}; max relative loss diff {rel:.3e}; "
            f"worst relative update difference {rdiff[worst]:.3e} ({worst})")
        if name == "K3":
            if min(counts.values()) <= 0:
                raise AssertionError(f"cross-device train step: a kernel was not launched: "
                                     f"{counts}")
            if not rel <= 1e-4:
                raise AssertionError(f"cross-device train step: losses differ by {rel:.3e}")
        if sound and not rdiff[worst] <= UPDATE_RTOL:
            raise AssertionError(f"cross-device train step with {name}: card and CPU "
                                 f"updates differ by {rdiff[worst]:.3e} in {worst}")
        if not sound and not rdiff[worst] > UPDATE_RTOL:
            raise AssertionError(f"the limit {UPDATE_RTOL} does not see a faulty K3: {name} "
                                 f"reads {rdiff[worst]:.3e}")
    return readings


# -------------------------------------------------------------------- main

KERNELS = {
    "greedy_nms": dict(source="detectron_tpu_torch/csrc/nms.cu",
                       replaces="detectron_tpu/ops/nms_pallas.py:91"),
    "multilevel_roi_align": dict(source="detectron_tpu_torch/csrc/roi_align.cu",
                                 replaces="detectron_tpu/ops/roi_align_pallas.py:192"),
    "multilevel_roi_align_bwd": dict(source="detectron_tpu_torch/csrc/roi_align.cu",
                                     replaces="detectron_tpu/ops/roi_align_pallas.py:529"),
}


def kernel_entry(name, cases, launches, max_abs_err):
    """One kernel's line entry. ``launches`` are the training slice's (this
    slice's main path), ``launches_by_path`` both paths'; times are summed
    over the training step's cases (one launch of each case per step), the
    inference cases are listed beside them."""
    train = [c for c in cases if c["path"] == "train"]
    return {
        "name": name, "route": "cuda", **KERNELS[name], "launches": launches["train"],
        "launches_by_path": launches, "max_abs_err": max_abs_err,
        "ms": sum(c["ms"] for c in train),
        "plain_ms": sum(c["plain_ms"] for c in train),
        "bound_ms": sum(c["bound_ms"] for c in train),
        "bound_by": train[0]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
        "cases": cases,
    }


def main() -> int:
    card = phase_device()
    phase_build()
    rng = np.random.RandomState(0)
    k1 = phase_nms(rng)
    feats = level_features(rng)
    k2 = phase_roi_align(rng, feats)
    predict_launches, _ = phase_slice()
    phase_cross_device()
    k3 = phase_roi_align_bwd(rng, feats)
    phase_function(rng, feats)
    del feats
    train_launches, _ = phase_train()
    phase_cross_train()

    def launches(name):
        return {"predict": predict_launches.get(name, 0), "train": train_launches[name]}

    kernels = [
        kernel_entry("greedy_nms", k1, launches("greedy_nms"), 0.0),
        kernel_entry("multilevel_roi_align", k2, launches("multilevel_roi_align"),
                     max(c["max_abs_err"] for c in k2)),
        kernel_entry("multilevel_roi_align_bwd", k3, launches("multilevel_roi_align_bwd"),
                     max(c["max_abs_err"] for c in k3)),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
