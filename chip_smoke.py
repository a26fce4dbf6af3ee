"""Smoke test of the PyTorch port on one NVIDIA GPU (run: python3 chip_smoke.py).

Phases, in order; any failure exits non-zero before the result line:

1. device: requires CUDA, prints the card's name and power limit, turns
   TF32 off for matmuls and convolutions;
2. build: compiles the hand-written kernels (csrc/*.cu) with nvcc;
3. K1 (greedy NMS) against its plain PyTorch version on the card, at the
   main path's shapes: keep masks and (idx, valid) must be equal;
4. K2 (multilevel RoIAlign) against its plain version on the card, at the
   1024x1344 P2-P5 shapes, C=256: max |diff| <= 1e-5 * max |feature|;
5. slice: Mask R-CNN R-50-FPN (configs/mask_rcnn_r50_fpn_coco.yaml) at full
   width, 1024x1344, float32, batch 2, weights from a numpy seed:
   predict_fn three times; both kernels' launch counts must rise on every
   call, detections must be non-empty and mask probabilities in [0, 1];
6. cross-device: the same port at 256x256 with small widths on the card and
   on the CPU (plain versions) with the same weights: equal valid slots,
   boxes within 1e-3.

It then prints the card's name and power limit, a JSON line of per-kernel
results, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
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

    dev = torch.device("cuda")
    cases = [
        # RPN: one problem per (image, level), B=2 x 5 levels
        dict(name="rpn", g=10, n=1000, thresh=0.7, max_out=300, n_invalid=120, classes=0),
        # detections: class-shifted candidates, one problem per image
        dict(name="det", g=2, n=1200, thresh=0.5, max_out=100, n_invalid=200, classes=81),
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
        results.append(dict(case=case["name"], ms=ms, plain_ms=plain_ms,
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


def phase_roi_align(rng):
    from detectron_tpu_torch.ops import roi_align as ra

    dev = torch.device("cuda")
    b, c, canvas, strides = 2, 256, (1024, 1344), (4, 8, 16, 32)
    feats = [torch.tensor(rng.randn(b, canvas[0] // st, canvas[1] // st, c).astype(np.float32),
                          device=dev) for st in strides]
    fmax = max(float(f.abs().max()) for f in feats)
    results = []
    for p, r in ((7, 300), (14, 100)):
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
        results.append(dict(case=f"P{p}", ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, max_abs_err=worst))
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


def reset_counts():
    from detectron_tpu_torch.ops import nms, roi_align

    nms.greedy_keep_cuda.launches = 0
    roi_align.multilevel_roi_align_cuda.launches = 0


def read_counts() -> dict:
    from detectron_tpu_torch.ops import nms, roi_align

    return {"greedy_nms": nms.greedy_keep_cuda.launches,
            "multilevel_roi_align": roi_align.multilevel_roi_align_cuda.launches}


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
    profile_call(det, params, batch)
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


def profile_call(det, params, batch, top=8):
    """One predict_fn under torch.profiler: device time by kernel, and the
    device's busy time against the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        det.predict_fn(params, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    reset_counts()
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0.0:
        log("[profile] the profiler recorded no device time: busy share not measured")
        return
    log(f"[profile] one predict_fn: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
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
    if not (min(counts.values()) > 0 and int(valid_c.sum()) > 0):
        raise AssertionError("cross-device run: no kernel launch or no detection")
    if not (torch.equal(valid_g, valid_c) and torch.equal(dets_g.classes.cpu(), dets_c.classes)
            and box_diff <= 1e-3):
        raise AssertionError("cross-device run: card and CPU disagree")


# -------------------------------------------------------------------- main

KERNELS = {
    "greedy_nms": dict(source="detectron_tpu_torch/csrc/nms.cu",
                       replaces="detectron_tpu/ops/nms_pallas.py:91"),
    "multilevel_roi_align": dict(source="detectron_tpu_torch/csrc/roi_align.cu",
                                 replaces="detectron_tpu/ops/roi_align_pallas.py:192"),
}


def kernel_entry(name, cases, launches, max_abs_err):
    """One kernel's line entry: times summed over the main path's cases (one
    launch of each case per predict_fn)."""
    return {
        "name": name, "route": "cuda", **KERNELS[name], "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": sum(c["ms"] for c in cases),
        "plain_ms": sum(c["plain_ms"] for c in cases),
        "bound_ms": sum(c["bound_ms"] for c in cases),
        "bound_by": cases[0]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
        "cases": cases,
    }


def main() -> int:
    card = phase_device()
    phase_build()
    rng = np.random.RandomState(0)
    k1 = phase_nms(rng)
    k2 = phase_roi_align(rng)
    launches, _ = phase_slice()
    phase_cross_device()
    kernels = [
        kernel_entry("greedy_nms", k1, launches["greedy_nms"], 0.0),
        kernel_entry("multilevel_roi_align", k2, launches["multilevel_roi_align"],
                     max(c["max_abs_err"] for c in k2)),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
