"""Smoke test of the PyTorch port on one NVIDIA GPU (run: python3 chip_smoke.py).

Phases, in order; any failure exits non-zero before the result line:

1. device: requires CUDA, prints the card's name and power limit, turns
   TF32 off for matmuls and convolutions;
2. build: compiles the hand-written kernels (csrc/*.cu) with nvcc, and the
   RLE codec (native/rle.cpp) with g++;
3. K1 (greedy NMS) against its plain PyTorch version on the card, at the
   inference (G=10, N=1000; G=2, N=1200) and training (G=10, N=2000)
   shapes, with and without the main path's max_keep = min(max_out, N),
   and at edge cases (N=65, N=4096, odd W, max_keep=1, max_keep above the
   kept count, an all-invalid problem): keep masks and (idx, valid) must
   be equal; the mask and scan launches are timed apart;
4. K2 (multilevel RoIAlign) against its plain version on the card, at the
   1024x1344 P2-P5 shapes, C=256, inference (R=300, P=7; R=100, P=14) and
   training (R=512, P=7; R=128, P=14) RoI counts with both routing spans,
   at K3's stress cases for P=7 and 14, and at sampling ratios 1 and 3
   (the kernel's generic instance; the model's is 2): max |diff| <= 1e-5 *
   max |feature|, and two K2 runs bitwise equal; each case logs, as a count
   from its inputs, the bytes of each RoI's distinct cells (what K2 stages)
   beside the distinct cells over the batch (the bound's);
5. predict: Mask R-CNN R-50-FPN (configs/mask_rcnn_r50_fpn_coco.yaml) at
   full width, 1024x1344, float32, batch 2, weights from a numpy seed:
   predict_fn three times; K1 must launch on every call and K2 twice,
   detections must be non-empty and mask probabilities in [0, 1]; one more
   call under torch.cuda.set_sync_debug_mode must report no synchronising
   call (the eval loop relies on it);
6. cross-device predict: the same port at 256x256 with small widths on the
   card and on the CPU (plain versions) with the same weights: equal valid
   slots, boxes within 1e-3;
7. K3 (multilevel RoIAlign backward) against its plain version on the
   card at the training shapes (B=2, 1024x1344, P2-P5, C=256; R=512, P=7
   and R=128, P=14) and at stress cases (RoIs wider than P*S cells, all
   sub-cell, all identical, P5 RoIs covering the whole level, past the
   border): max |diff| <= 1e-5 * max |plain gradient|; two K3 runs are
   compared too (overlapping RoIs add in a varying order); the zero fill
   and the kernel are timed apart;
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
    and with a planted K3 fault (P2 zeroed; 10% short) must fail it;
11. eval: the eval driver (detectron_tpu_torch.eval.driver.run) over an
    in-memory COCO-format split of 8 uint8 images at COCO sizes with RLE
    segmentations and crowd regions (no cv2): Mask R-CNN R-50-FPN as in
    phase 5 (portrait images on the transposed canvas), batch 2, seeded
    weights (the cls_score bias raised) restored from a checkpoint;
    Loader -> predict_fn -> host paste + RLE -> box and segm COCO metrics. Every image consumed once, K1 and K2 twice
    a predict call, detections and non-empty masks, every metric finite or
    null; an oracle predictor must give box AP and segm AP50 of 1.0; logs
    images/s of the loop, device ms per predict call and the host's ms per
    batch by part (paste + RLE apart from the gt records), for this run
    and for warm runs over 32 images with 8 and with 1 loader threads,
    and, from a profiled run, the device's busy share of the loop;
12. bench: python -m detectron_tpu_torch.bench at its default shapes
    (1024x1024, batch 48 inference, batch 16 training, float32) with
    --iters 3 --train-iters 2: its JSON line, positive finite rates, and
    every kernel's launches as its calls and steps require; then K1 and
    K2 against their plain versions at the bench's inference shapes
    (batch 48: 240 RPN problems of 1000 boxes, 48 of 1200; 14400 and 4800
    RoIs), exactly and within phase 4's bound.

It then prints a JSON line of per-kernel results, the card's name and
power limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import argparse
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


SPIN_CYCLES_PER_S = 2e9  # torch.cuda._sleep counts SM clock cycles (H100: <= 1.98 GHz)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back calls.

    A short kernel runs faster than Python and ctypes can enqueue it, so
    timing calls as they are enqueued measures the host. Here a spin kernel
    first holds the stream for longer than the host takes to enqueue all
    the calls; the events then time the device alone. If the stream was
    free again before the last call was enqueued (the start event had
    already passed), the spin is doubled and the timing repeated."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_s = 2.0 * host_s * iters + 1e-3
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        held = not start.query()  # the device was still spinning when the host was done
        torch.cuda.synchronize()
        if held:
            break
        spin_s *= 2.0
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

    from detectron_tpu_torch import native

    seconds = _build.build()
    log(f"[build] kernels {_build.KERNELS} in {seconds:.1f} s "
        f"(nvcc {_build.nvcc()})")
    t0 = time.perf_counter()
    lib = native.build()
    log(f"[build] RLE codec {os.path.relpath(lib, REPO)} in {time.perf_counter() - t0:.1f} s")
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


# the main path's NMS calls: RPN per (image, level) at inference and in
# training (pre_nms_topk 1000 / 2000, post 300 / 1000), and the class-shifted
# detection candidates per image (1200 candidates, 100 detections)
NMS_CASES = (
    dict(name="rpn", g=10, n=1000, thresh=0.7, max_out=300, n_invalid=120, classes=0,
         path="predict"),
    dict(name="det", g=2, n=1200, thresh=0.5, max_out=100, n_invalid=200, classes=81,
         path="predict"),
    dict(name="rpn_train", g=10, n=2000, thresh=0.7, max_out=1000, n_invalid=200,
         classes=0, path="train"),
)
# edge cases, each held exactly against the plain version; max_keep "above"
# is one more than the largest kept count of the problems
NMS_EDGE_CASES = (
    dict(name="N=65", g=3, n=65, thresh=0.5, n_invalid=5, max_keep=None),
    dict(name="N=4096 (the limit)", g=2, n=4096, thresh=0.7, n_invalid=96, max_keep=None),
    dict(name="N=1200 (odd W)", g=3, n=1200, thresh=0.6, n_invalid=0, max_keep=None),
    dict(name="max_keep=1", g=4, n=700, thresh=0.5, n_invalid=50, max_keep=1),
    dict(name="max_keep above the kept count", g=4, n=700, thresh=0.5, n_invalid=50,
         max_keep="above"),
    dict(name="all invalid", g=2, n=300, thresh=0.5, n_invalid=300, max_keep=None),
)


def sorted_problems(boxes, scores, valid):
    """Score-sorted boxes and valid flags, as nms_padded_batched hands them
    to the kernel."""
    from detectron_tpu_torch.ops import nms

    masked = torch.where(valid, scores, torch.full_like(scores, nms.NEG_INF))
    order_scores, order = nms.sort_desc(masked)
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).contiguous()
    return sboxes, (order_scores > nms.NEG_INF / 2).contiguous()


def check_keep(name, sboxes, svalid, thresh, max_keep):
    """K1 against its plain version, exactly; returns the kernel's mask."""
    from detectron_tpu_torch.ops import nms

    keep_k = nms.greedy_keep_cuda(sboxes, svalid, thresh, max_keep=max_keep)
    keep_p = nms.greedy_keep_plain(sboxes, svalid, thresh, max_keep=max_keep)
    torch.cuda.synchronize()
    if not torch.equal(keep_k, keep_p):
        raise AssertionError(f"K1 {name} max_keep={max_keep}: keep masks differ in "
                             f"{int((keep_k != keep_p).sum())} slots")
    return keep_k


def phase_nms(rng):
    from detectron_tpu_torch.ops import nms

    dev = torch.device(DEVICE)
    results = []
    for case in NMS_CASES:
        boxes, scores, valid, cls = nms_problems(
            rng, case["g"], case["n"], (1024, 1344), case["n_invalid"], case["classes"])
        tb, ts, tv = (torch.tensor(x, device=dev) for x in (boxes, scores, valid))
        if cls is not None:
            tc = torch.tensor(cls, device=dev)
            span = tb.amax(dim=(1, 2)) - tb.amin(dim=(1, 2)) + 1.0
            tb = tb + (tc.to(tb.dtype) * span[:, None])[..., None]
        sboxes, svalid = sorted_problems(tb, ts, tv)
        g, n, thresh = case["g"], case["n"], case["thresh"]
        m = min(case["max_out"], n)  # what nms_padded_batched passes
        full = check_keep(case["name"], sboxes, svalid, thresh, None)
        keep_k = check_keep(case["name"], sboxes, svalid, thresh, m)
        idx_g, ok_g = nms.nms_padded_batched(tb, ts, tv, thresh, case["max_out"])
        idx_c, ok_c = nms.nms_padded_batched(tb.cpu(), ts.cpu(), tv.cpu(), thresh,
                                             case["max_out"])
        if not (torch.equal(idx_g.cpu(), idx_c) and torch.equal(ok_g.cpu(), ok_c)):
            raise AssertionError(f"K1 {case['name']}: (idx, valid) differ from the "
                                 "CPU plain path")
        ms = cuda_ms(lambda: nms.greedy_keep_cuda(sboxes, svalid, thresh, max_keep=m))
        mask = nms.nms_mask_cuda(sboxes, thresh)
        mask_ms = cuda_ms(lambda: nms.nms_mask_cuda(sboxes, thresh))
        scan_ms = cuda_ms(lambda: nms.nms_scan_cuda(mask, svalid, m))
        scan_full_ms = cuda_ms(lambda: nms.nms_scan_cuda(mask, svalid))
        plain_ms = cuda_ms(lambda: nms.greedy_keep_plain(sboxes, svalid, thresh, max_keep=m),
                           iters=3, warmup=1)
        # work this run's data needs: each kept box against every later valid
        # box, up to the m-th kept box where the walk stops
        pos = torch.arange(n, device=dev)[None, :]
        n_valid = svalid.sum(1, keepdim=True)
        last = torch.where(keep_k, pos, torch.full_like(pos, -1)).amax(1, keepdim=True)
        stop = torch.where(keep_k.sum(1, keepdim=True) >= m, last, torch.full_like(last, n - 1))
        upto = torch.minimum(n_valid, stop + 1)
        pairs = int(torch.where(keep_k, upto - 1 - pos, torch.zeros_like(pos)).sum())
        b_ms, b_by = bound_ms(nbytes=g * n * (16 + 1 + 1), ops=pairs * 16)
        log(f"[K1 {case['name']}] G={g} N={n} t={thresh} max_keep={m}: keep masks equal "
            f"with and without max_keep ({int(keep_k.sum())} of {int(full.sum())} kept), "
            f"(idx, valid) equal to the CPU path; kernel {ms:.4f} ms (mask {mask_ms:.4f} + "
            f"scan {scan_ms:.4f}; scan without max_keep {scan_full_ms:.4f}), plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.6f} ms ({b_by})")
        results.append(dict(case=case["name"], path=case["path"], max_keep=m, ms=ms,
                            mask_ms=mask_ms, scan_ms=scan_ms, scan_full_ms=scan_full_ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
    for case in NMS_EDGE_CASES:
        boxes, scores, valid, _ = nms_problems(rng, case["g"], case["n"], (1024, 1344),
                                               case["n_invalid"])
        sboxes, svalid = sorted_problems(*(torch.tensor(x, device=dev)
                                           for x in (boxes, scores, valid)))
        full = check_keep(case["name"], sboxes, svalid, case["thresh"], None)
        max_keep = case["max_keep"]
        if max_keep == "above":
            max_keep = int(full.sum(1).max()) + 1
        if max_keep is not None:
            check_keep(case["name"], sboxes, svalid, case["thresh"], max_keep)
        log(f"[K1 edge] {case['name']}: G={case['g']} N={case['n']} max_keep={max_keep}, "
            f"{int(full.sum())} kept: keep masks equal")
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


def k2_bound(feats, rois, levels, p, s=2):
    """K2's bound at these inputs: the distinct feature cells its samples
    read over the batch, its output, RoIs and routing, at the card's memory
    rate, or its fp32 operations where slower. Returns (ms, by, bytes)."""
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    nbytes = (touched_bytes(feats, rois, levels, STRIDES, p, s) + b * r * p * p * c * 4
              + b * r * (16 + 4))
    # per output value: S^2 samples of four corners, a weight product and a
    # scaled add each, and the division by S^2
    b_ms, b_by = bound_ms(nbytes, ops=b * r * p * p * c * (s * s * 4 * 3 + 1))
    return b_ms, b_by, nbytes


def check_k2(name, feats, rois, levels, p, fmax, s=2):
    """K2 twice and its plain version on the same inputs: max |diff| against
    the plain version must be within 1e-5 x max |feature|, and the two K2
    runs bitwise equal (no atomics). Logs two counts from the inputs: the
    bytes of each RoI's distinct cells, summed over the RoIs (what K2
    stages, once a RoI), and of the distinct cells over the batch (the
    bound's). Returns (max |diff|, per-RoI bytes)."""
    from detectron_tpu_torch.ops import roi_align as ra

    got = ra.multilevel_roi_align_cuda(feats, rois, levels, STRIDES, p, s)
    again = ra.multilevel_roi_align_cuda(feats, rois, levels, STRIDES, p, s)
    want = ra.multilevel_roi_align_plain(feats, rois, levels, STRIDES, p, s)
    torch.cuda.synchronize()
    diff = float((got - want).abs().max())
    same = torch.equal(got, again)
    per_roi, distinct = roi_cell_bytes(feats, rois, levels, p, s)
    hist = torch.bincount(levels.flatten().long(), minlength=4).tolist()
    log(f"[K2 {name}] levels {hist}, max |diff| {diff:.3e} (limit {1e-5 * fmax:.3e}), two "
        f"runs bitwise equal: {same}; per-RoI distinct cells, from the inputs, "
        f"{per_roi / 1e6:.1f} MB; {distinct / 1e6:.1f} MB distinct over the batch")
    if not diff <= 1e-5 * fmax:
        raise AssertionError(f"K2 {name}: max |diff| {diff} > {1e-5 * fmax}")
    if not same:
        raise AssertionError(f"K2 {name}: two runs differ")
    return diff, per_roi


def phase_roi_align(rng, feats):
    """K2 against its plain version at the main path's cases, with both
    routing spans, then at the K3 stress cases and at sampling ratios 1 and
    3 (their own seeded draws, so the later phases' inputs do not move)."""
    from detectron_tpu_torch.ops import roi_align as ra

    dev = torch.device(DEVICE)
    b, c, canvas, strides = 2, feats[0].shape[-1], CANVAS, STRIDES
    fmax = max(float(f.abs().max()) for f in feats)
    results = []
    for path, p, r in ROI_CASES:
        rois = torch.tensor(roi_cases(rng, b, r, canvas), device=dev)
        worst = 0.0
        # both routing spans; the main path's (28, 44) last, so it is the one timed
        for span in (ra.DEFAULT_MAX_SPAN, (28.0, 44.0)):
            levels = ra.assign_fpn_levels(rois, 4, 2, max_span=span)
            diff, per_roi = check_k2(f"P={p} R={r} span={span}", feats, rois, levels, p, fmax)
            worst = max(worst, diff)
        ms = cuda_ms(lambda: ra.multilevel_roi_align_cuda(feats, rois, levels, strides, p, 2))
        plain_ms = cuda_ms(lambda: ra.multilevel_roi_align_plain(
            feats, rois, levels, strides, p, 2), iters=5, warmup=1)
        out_bytes = b * r * p * p * c * 4
        b_ms, b_by, nbytes = k2_bound(feats, rois, levels, p)
        log(f"[K2 P={p} R={r}] kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB); per-RoI distinct cells, "
            f"from the inputs, {per_roi / 1e6:.1f} MB; output {out_bytes / 1e6:.1f} MB")
        results.append(dict(case=f"P{p} R{r}", path=path, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, max_abs_err=worst))
    stress = np.random.RandomState(4)
    for kind in K3_STRESS:
        for p in (7, 14):
            rois, levels = k3_stress_rois(stress, kind, b, 128)
            rois = torch.tensor(rois, device=dev)
            levels = (ra.assign_fpn_levels(rois, len(feats), 2, max_span=(28.0, 44.0))
                      if levels is None else torch.tensor(levels, device=dev))
            check_k2(f"stress: {kind}, P={p} R=128", feats, rois, levels, p, fmax)
    ratios = np.random.RandomState(5)
    for s in (1, 3):
        for p in (7, 14):
            rois = torch.tensor(roi_cases(ratios, b, 128, canvas), device=dev)
            levels = ra.assign_fpn_levels(rois, len(feats), 2, max_span=(28.0, 44.0))
            check_k2(f"S={s}, P={p} R=128", feats, rois, levels, p, fmax, s)
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
        if counts["multilevel_roi_align"] != 2:
            raise AssertionError(f"predict_fn call {call} launched K2 "
                                 f"{counts['multilevel_roi_align']} times, want 2 (box, mask)")

    check_no_host_sync(lambda: det.predict_fn(params, batch), "predict_fn")

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


def check_no_host_sync(fn, label):
    """``fn()`` must not wait for the device (the eval driver issues batch
    k+1's predict call before it consumes batch k): run once under
    ``torch.cuda.set_sync_debug_mode``, no synchronising call may be
    reported. Logs the host's time to issue the call and to its end."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            fn()
            issue_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    done_ms = (time.perf_counter() - t0) * 1e3
    reset_counts()
    syncs = sorted({str(w.message)[:120] for w in caught
                    if "synchroniz" in str(w.message).lower()})
    log(f"[slice] {label} under the sync debug mode: issued in {issue_ms:.2f} ms of host "
        f"time, done after {done_ms:.2f} ms; synchronising calls reported: {len(syncs)}")
    if syncs:
        raise AssertionError(f"{label} synchronises with the host: {syncs}")


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
    # the layout copies around the FPN (NCHW <-> NHWC) are among these
    copies = [e for e in kernels if "copy" in e.key.lower()]
    log(f"[profile]   copy kernels: {sum(e.self_device_time_total for e in copies) / 1e3:.3f} "
        f"ms in {sum(e.count for e in copies)} launches of {len(copies)} kernel names")
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


K3_STRESS = ("wider than P*S cells", "all sub-cell", "all identical", "P5 whole level",
             "past the border")


def k3_stress_rois(rng, kind, b, r):
    """Seeded RoIs [B, R, 4] of a K3 stress case, and their levels [B, R]
    where the case sets them (K3 takes any routing), else None (routed)."""
    h, w = CANVAS
    strides = np.array(STRIDES, np.float64)
    lv = rng.randint(0, len(STRIDES), size=(b, r))
    st = strides[lv]
    if kind == "wider than P*S cells":  # 30-90 cells wide (P5: 30-41), 1-6 tall
        cw = np.minimum(rng.uniform(30, 90, size=(b, r)), w / st - 1)
        ch = rng.uniform(1, 6, size=(b, r))
    elif kind == "all sub-cell":
        cw, ch = rng.uniform(0.05, 0.95, size=(2, b, r))
    elif kind == "P5 whole level":  # the whole canvas, up to half a cell beyond
        lv = np.full((b, r), len(STRIDES) - 1)
        out = rng.uniform(0, 16, size=(b, r, 4))
        rois = np.stack([-out[..., 0], -out[..., 1], w + out[..., 2], h + out[..., 3]], -1)
        return rois.astype(np.float32), lv.astype(np.int32)
    elif kind == "all identical":
        x0, y0 = rng.uniform(0, w - 200), rng.uniform(0, h - 160)
        rois = np.tile(np.array([x0, y0, x0 + 180.0, y0 + 140.0]), (b, r, 1))
        return rois.astype(np.float32), None
    elif kind == "past the border":  # half straddle the border, a quarter lie outside
        rois = roi_cases(rng, b, r, CANVAS).astype(np.float64)
        k = r // 2
        rois[:, :k, :2] = -rng.uniform(10, 300, size=(b, k, 2))
        rois[:, :k, 2:] = rng.uniform(20, 400, size=(b, k, 2))
        q = r // 4
        wh = rois[:, k:k + q, 2:] - rois[:, k:k + q, :2]
        corner = (np.where(rng.rand(b, q, 1) < 0.5, [w + 60.0, 0.0], [0.0, h + 60.0])
                  + rng.uniform(0, 200, size=(b, q, 2)))
        rois[:, k:k + q] = np.concatenate([corner, corner + wh], -1)
        return rois.astype(np.float32), None
    else:
        raise ValueError(kind)
    x0 = rng.uniform(0, 1, size=(b, r)) * (w - cw * st)
    y0 = rng.uniform(0, 1, size=(b, r)) * (h - ch * st)
    rois = np.stack([x0, y0, x0 + cw * st, y0 + ch * st], -1)
    return rois.astype(np.float32), lv.astype(np.int32)


def roi_cell_bytes(feats, rois, levels, p, s):
    """Bytes of each RoI's distinct touched cells (its distinct columns x
    rows, C channels, fp32), summed over the RoIs: what K2 stages and K3's
    atomics add; and the bytes of the distinct cells over all RoIs."""
    from detectron_tpu_torch.ops.roi_align import _sample_geometry

    level_hw = [tuple(f.shape[1:3]) for f in feats]
    _, _, ys, xs = _sample_geometry(level_hw, rois, levels, STRIDES, p, s)
    counts = []
    for i0, i1, w0, w1, inb in (xs, ys):
        size = max(max(hw) for hw in level_hw) + 1
        hit = torch.zeros(*i0.shape[:2], size, dtype=torch.bool, device=i0.device)
        for idx, w in ((i0, w0), (i1, w1)):
            hit.scatter_(2, torch.where(inb & (w > 0), idx, size - 1), True)
        counts.append(hit[..., :-1].sum(-1))
    c = feats[0].shape[-1]
    return int((counts[0] * counts[1]).sum()) * c * 4, touched_bytes(feats, rois, levels,
                                                                       STRIDES, p, s)


def check_k3(name, g, level_hw, rois, levels):
    """K3 twice and its plain version on the same inputs: max |diff| against
    the plain version must be within 1e-5 x max |plain gradient|. Returns
    (max |diff|, max |diff| between the two K3 runs)."""
    from detectron_tpu_torch.ops import roi_align as ra

    got = ra.multilevel_roi_align_bwd_cuda(g, level_hw, rois, levels, STRIDES, 2)
    again = ra.multilevel_roi_align_bwd_cuda(g, level_hw, rois, levels, STRIDES, 2)
    want = ra.multilevel_roi_align_bwd_plain(g, level_hw, rois, levels, STRIDES, 2)
    torch.cuda.synchronize()
    gmax = max(float(w.abs().max()) for w in want)
    diff = max(float((x - w).abs().max()) for x, w in zip(got, want))
    rerun = max(float((x - y).abs().max()) for x, y in zip(got, again))
    hist = torch.bincount(levels.flatten().long(), minlength=4).tolist()
    log(f"[K3 {name}] levels {hist}, max |diff| {diff:.3e} (limit {1e-5 * gmax:.3e} = 1e-5 x "
        f"max |plain gradient|), between two K3 runs {rerun:.3e}")
    if not (gmax > 0.0 and diff <= 1e-5 * gmax):
        raise AssertionError(f"K3 {name}: max |diff| {diff} > {1e-5 * gmax}")
    return diff, rerun


def phase_roi_align_bwd(rng, feats):
    """K3 against its plain version at the training shapes, with the
    main path's routing span, then at the stress cases."""
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
        diff, rerun = check_k3(f"P={p} R={r} span={span}", g, level_hw, rois, levels)
        ms = cuda_ms(lambda: ra.multilevel_roi_align_bwd_cuda(g, level_hw, rois, levels,
                                                              STRIDES, 2))
        fill_ms = cuda_ms(lambda: ra.level_grad_buffers(b, c, level_hw, dev))
        bufs = ra.level_grad_buffers(b, c, level_hw, dev)
        kernel_ms = cuda_ms(lambda: ra.roi_align_bwd_accumulate_cuda(bufs, g, rois, levels,
                                                                     STRIDES, 2))
        plain_ms = cuda_ms(lambda: ra.multilevel_roi_align_bwd_plain(
            g, level_hw, rois, levels, STRIDES, 2), iters=5, warmup=1)
        # what the function must move: g read once, every level's gradient
        # written once, RoIs and routing read once
        out_bytes = sum(b * h * w * c * 4 for h, w in level_hw)
        nbytes = g.numel() * 4 + out_bytes + b * r * (16 + 4)
        # per sample and corner: one weight product, one scaled add
        b_ms, b_by = bound_ms(nbytes, ops=b * r * p * p * c * (4 * 4 * 3 + 1))
        added, distinct = roi_cell_bytes(feats, rois, levels, p, 2)
        log(f"[K3 P={p} R={r}] {ms:.4f} ms (fill {fill_ms:.4f} + kernel {kernel_ms:.4f}), "
            f"plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB: "
            f"level gradients {out_bytes / 1e6:.1f}, g {g.numel() * 4 / 1e6:.1f}); the kernel "
            f"adds {added / 1e6:.1f} MB onto {distinct / 1e6:.1f} MB of distinct cells")
        results.append(dict(case=f"P{p} R{r}", path="train", ms=ms, fill_ms=fill_ms,
                            kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, max_abs_err=diff, rerun_max_abs_diff=rerun))
    for kind in K3_STRESS:
        for p in (7, 14):
            rois, levels = k3_stress_rois(rng, kind, b, 128)
            rois = torch.tensor(rois, device=dev)
            levels = (ra.assign_fpn_levels(rois, len(feats), 2, max_span=span)
                      if levels is None else torch.tensor(levels, device=dev))
            g = torch.tensor(rng.randn(b, 128, p, p, c).astype(np.float32), device=dev)
            check_k3(f"stress: {kind}, P={p} R=128", g, level_hw, rois, levels)
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


def seeded_train_state(cfg, device, seed):
    """A train state from Detector.init(seed) with the frozen BatchNorm
    statistics calibrated on the first synthetic batch (the bench's
    ``calibrate_frozen_bn``: from identity statistics the random backbone's
    activations grow at every residual add, and SGD overflows to NaN within
    a few steps); returns it and the batch iterator, past that batch."""
    from detectron_tpu_torch.bench import calibrate_frozen_bn
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


# ---------------------------------------------------------------- phase 11

# COCO-like image sizes: 5 landscape (or square) and 3 portrait ones. After
# the 800/1333 resize a portrait image is taller than the 1024x1344 canvas,
# so the phase turns orientation buckets on (portrait images on 1344x1024):
# 3 + 2 batches of 2, each bucket's tail padded by repetition
EVAL_SIZES = ((480, 640), (640, 480), (427, 640), (640, 427), (375, 500), (500, 375),
              (480, 640), (612, 612))
EVAL_OUT = os.path.join(REPO, "build", "eval_smoke")  # the eval driver's output_dir
EVAL_WARM_REPEAT = 4  # the warm timing runs' split: EVAL_SIZES this many times


class InMemoryCoco:
    """A COCO-format val split held in memory, with ``CocoDataset``'s
    interface (``__len__``, ``example``, ``index_of``, ``num_classes``,
    ``segmentation_to_rle``) and no ``cv2``: seeded uint8 images at COCO
    sizes, rectangles and ellipses drawn on a textured background, every
    segmentation an RLE dict (compressed strings and count lists in turn),
    crowd regions in every third image. The 28x28 box-frame rasters are the
    full mask sampled at the grid's centres."""

    def __init__(self, seed=0, sizes=EVAL_SIZES, num_classes=81, mask_size=28):
        from detectron_tpu_torch.data.coco import CocoDataset

        self.segmentation_to_rle = CocoDataset.segmentation_to_rle
        self.num_classes = num_classes
        self.mask_size = mask_size
        rng = np.random.RandomState(seed)
        self.examples = [self._example(rng, i, hw) for i, hw in enumerate(sizes)]

    def __len__(self):
        return len(self.examples)

    def index_of(self, image_id) -> int:
        return int(image_id)

    def example(self, index: int) -> dict:
        return dict(self.examples[index])

    @staticmethod
    def _segmentation(mask, compressed):
        from detectron_tpu_torch.native import RLE

        rle = RLE.encode(mask)
        return {"size": list(mask.shape),
                "counts": rle.to_string() if compressed else rle.counts.tolist()}

    def _example(self, rng, index, hw):
        h, w = hw
        coarse = rng.randint(40, 216, (h // 16 + 1, w // 16 + 1, 3)).astype(np.uint8)
        image = np.kron(coarse, np.ones((16, 16, 1), np.uint8))[:h, :w]
        image = np.ascontiguousarray(image + rng.randint(0, 24, (h, w, 3)).astype(np.uint8))
        ys, xs = np.mgrid[0:h, 0:w]
        boxes, classes, areas, masks, segs = [], [], [], [], []
        m = self.mask_size
        for j in range(rng.randint(2, 6)):
            bw, bh = rng.randint(w // 10, w // 2), rng.randint(h // 10, h // 2)
            x, y = rng.randint(0, w - bw), rng.randint(0, h - bh)
            inside = (ys >= y) & (ys < y + bh) & (xs >= x) & (xs < x + bw)
            if j % 2:  # an ellipse inscribed in the box
                cy, cx = y + (bh - 1) / 2, x + (bw - 1) / 2
                inside &= ((ys - cy) / (bh / 2)) ** 2 + ((xs - cx) / (bw / 2)) ** 2 <= 1.0
            image[inside] = rng.randint(0, 256, 3)
            boxes.append([x, y, x + bw, y + bh])
            classes.append(rng.randint(1, self.num_classes))
            areas.append(float(inside.sum()))
            gy = np.clip((y + (np.arange(m) + 0.5) / m * bh).astype(int), 0, h - 1)
            gx = np.clip((x + (np.arange(m) + 0.5) / m * bw).astype(int), 0, w - 1)
            masks.append(inside[gy][:, gx].astype(np.float32))
            segs.append(self._segmentation(inside, compressed=(index + j) % 2 == 0))
        crowd = []
        if index % 3 == 0:  # a crowd region in a corner, class of the first object
            region = (ys >= h - h // 4) & (xs < w // 3)
            crowd.append(([0, h - h // 4, w // 3, h], classes[0], float(region.sum()),
                          self._segmentation(region, compressed=index % 2 == 0)))
        return {
            "image": image,
            "boxes": np.asarray(boxes, np.float32),
            "classes": np.asarray(classes, np.int32),
            "areas": np.asarray(areas, np.float64),
            "crowd_areas": np.asarray([c[2] for c in crowd], np.float64),
            "masks": np.stack(masks),
            "polygons": segs,  # CocoDataset's key for the segmentations
            "crowd_boxes": np.asarray([c[0] for c in crowd], np.float32).reshape(-1, 4),
            "crowd_classes": np.asarray([c[1] for c in crowd], np.int32),
            "crowd_segmentations": [c[3] for c in crowd],
            "image_id": index,
            "orig_hw": hw,
        }


def oracle_predict(params, batch):
    """The ground truth as detections, in resized coordinates as the model
    gives them; masks are the gt box-frame rasters."""
    from detectron_tpu_torch.models.faster_rcnn import Detections

    classes = np.asarray(batch["gt_classes"], np.int32)
    valid = classes > 0
    return Detections(boxes=np.asarray(batch["gt_boxes"], np.float32),
                      scores=np.where(valid, 0.9, 0.0).astype(np.float32),
                      classes=classes, valid=valid), np.asarray(batch["gt_masks"], np.float32)


def log_eval_timing(tag, timing):
    """One line of the eval driver's timing: the loop's images/s, the device
    span of each predict call, the host's milliseconds per batch by part."""
    dev_ms = [round(t, 3) for t in timing["device_ms_per_call"]]
    log(f"[eval {tag}] loop {timing['loop_s']:.3f} s = {timing['img_per_s']:.2f} images/s "
        f"(evaluation {timing['eval_s']:.3f} s after it); device ms per predict call "
        f"{dev_ms}; host ms per batch: waiting for the loader "
        f"{timing['loader_wait_ms_per_batch']:.2f}, inputs to the card "
        f"{timing['to_device_ms_per_batch']:.2f}, issuing predict_fn "
        f"{timing['predict_ms_per_batch']:.2f}, consume {timing['consume_ms_per_batch']:.2f} = "
        f"fetch {timing['fetch_ms_per_batch']:.2f} + paste+RLE "
        f"{timing['paste_rle_ms_per_batch']:.2f} + gt records {timing['gt_ms_per_batch']:.2f}; "
        f"paste+RLE {timing['paste_rle_ms_per_image']:.3f} ms per image, "
        f"{timing['detections'] / timing['images']:.1f} detections per image")


def phase_eval(seed=0):
    """The eval driver as a user runs it, on an in-memory COCO split of 8
    images: Mask R-CNN R-50-FPN at full width, weights from a numpy seed
    (the cls_score bias raised) restored from a checkpoint in its
    output_dir; Loader -> predict_fn (K1, K2) -> paste + RLE -> box and
    segm COCO metrics. Then warm timing runs over 32 images (8 and 1 loader
    threads), the loop with an oracle predictor (box AP and segm AP50 must
    be 1.0), and once under the profiler. Returns the kernels' launches over
    the first run."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.eval import driver
    from detectron_tpu_torch.models.zoo import build_detector
    from detectron_tpu_torch.train import checkpoint as ckpt
    from detectron_tpu_torch.train.state import create_train_state
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config(os.path.join(REPO, "configs", "mask_rcnn_r50_fpn_coco.yaml"),
                     ["train.batch_size=2", "data.orientation_buckets=true",
                      f"output_dir={EVAL_OUT}"])
    ds = InMemoryCoco(seed, num_classes=cfg.model.num_classes)
    shutil.rmtree(EVAL_OUT, ignore_errors=True)
    det = build_detector(cfg)
    ckpt.save(EVAL_OUT, create_train_state(
        cfg, det, raise_class_bias(det.init(seed), RAISED_CLASSES)))
    del det
    log(f"[eval] {cfg.model.name} {cfg.model.backbone} FPN {cfg.model.fpn_channels} classes "
        f"{cfg.model.num_classes} short side {cfg.data.short_side} max {cfg.data.max_size} "
        f"canvas {tuple(cfg.data.image_size)} and its transpose {cfg.model.dtype} batch "
        f"{cfg.train.batch_size}; "
        f"{len(ds)} in-memory images {list(EVAL_SIZES)}, "
        f"{sum(len(e['boxes']) for e in ds.examples)} objects, "
        f"{sum(len(e['crowd_boxes']) for e in ds.examples)} crowd regions")
    records = {}
    real_merge = driver.merge_across_processes

    def capture(gts, dts):
        records["gts"], records["dts"] = gts, dts
        return real_merge(gts, dts)

    driver.merge_across_processes = capture
    try:
        torch.cuda.synchronize()
        reset_counts()
        res = driver.run(cfg, dataset=ds)
        torch.cuda.synchronize()
        counts = read_counts()
        dts = records["dts"]
        timing = res.pop("timing")
        ids = sorted(int(d["image_id"]) for d in dts)
        n_dets = sum(len(d["scores"]) for d in dts)
        n_masks = sum(m.area() > 0 for d in dts for m in d["masks"])
        log(f"[eval] restored from {os.path.relpath(EVAL_OUT, REPO)}; {timing['images']} images "
            f"in {timing['batches']} batches; launches {counts}; {n_dets} detections, "
            f"{n_masks} non-empty mask RLEs")
        if ids != list(range(len(ds))):
            raise AssertionError(f"eval: images consumed {ids}, want each of {len(ds)} once")
        calls = timing["batches"]
        if counts != {"greedy_nms": 2 * calls, "multilevel_roi_align": 2 * calls,
                      "multilevel_roi_align_bwd": 0}:
            raise AssertionError(f"eval: launches {counts} over {calls} predict calls, want "
                                 "K1 and K2 twice a call, K3 never")
        if not (n_dets > 0 and n_masks > 0):
            raise AssertionError("eval: no detection or no non-empty mask")
        with open(os.path.join(EVAL_OUT, "eval_results.json")) as f:
            written = json.load(f)
        bad = {k: v for k, v in written.items() if not (v is None or np.isfinite(v))}
        if bad or "segm_AP" not in written:
            raise AssertionError(f"eval: metrics not finite or null, or no segm: {written}")
        log(f"[eval] metrics (random weights): AP {written['AP']}, AP50 {written['AP50']}, "
            f"segm_AP {written['segm_AP']}; "
            f"{sum(v is None for v in written.values())} of {len(written)} null")
        log_eval_timing("first run", timing)
        # warm (both canvases' convolutions set up), over a longer split of
        # the same kind so that the loop is past its start, with the config's
        # loader threads and with one
        long_ds = InMemoryCoco(seed + 1, EVAL_SIZES * EVAL_WARM_REPEAT, cfg.model.num_classes)
        threads = cfg.data.num_workers
        for workers in (threads, 1):
            cfg.data.num_workers = workers
            log_eval_timing(f"warm, {len(long_ds)} images, loader threads {workers}",
                            driver.run(cfg, dataset=long_ds)["timing"])
        cfg.data.num_workers = threads

        reset_counts()
        res_o = driver.run(cfg, dataset=ds, restore=False, predict=oracle_predict)
        reset_counts()
        log(f"[eval] oracle predictor: AP {res_o['AP']:.6f}, AP50 {res_o['AP50']:.6f}, "
            f"segm_AP50 {res_o['segm_AP50']:.6f}, segm_AP {res_o['segm_AP']:.6f}")
        if not (abs(res_o["AP"] - 1.0) <= 1e-6 and abs(res_o["segm_AP50"] - 1.0) <= 1e-6):
            raise AssertionError("eval: the oracle predictor does not give box AP and segm "
                                 "AP50 of 1.0")

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res_p = driver.run(cfg, dataset=ds)
            torch.cuda.synchronize()
        reset_counts()
    finally:
        driver.merge_across_processes = real_merge
    loop_ms, busy_ms, n_events = device_busy_in(prof, driver.LOOP_SPAN)
    batches = res_p["timing"]["batches"]
    if not n_events:
        log("[eval profile] the profiler recorded no device activity in the loop: busy "
            "share not measured")
    else:
        log(f"[eval profile] under the profiler: loop {loop_ms:.1f} ms (the driver's clock: "
            f"{res_p['timing']['loop_s'] * 1e3:.1f}) for {batches} batches, device busy "
            f"{busy_ms:.1f} ms in it ({100 * busy_ms / loop_ms:.1f}% of the loop; "
            f"{busy_ms / batches:.2f} ms busy and {(loop_ms - busy_ms) / batches:.2f} ms idle "
            f"a batch; {n_events} kernels and copies)")
    shutil.rmtree(EVAL_OUT, ignore_errors=True)
    check_transposed_canvas(cfg)
    return counts


def device_busy_in(prof, span):
    """(ms of the host range ``span`` recorded by ``record_function``, ms
    of it in which the device ran a kernel, copy or fill, number of those):
    the union of the device's activity intervals clipped to the range, so
    that work before it (weights to the card) does not count."""
    events = prof.events()
    host = [e for e in events if e.name == span and e.device_type.name == "CPU"]
    if not host:
        return 0.0, 0.0, 0
    t0, t1 = host[0].time_range.start, host[0].time_range.end
    # the range's own projection onto the device timeline carries its name
    spans = sorted((max(e.time_range.start, t0), min(e.time_range.end, t1)) for e in events
                   if e.device_type.name == "CUDA" and e.name != span
                   and e.time_range.end > t0 and e.time_range.start < t1)
    busy, reached = 0.0, t0
    for a, b in spans:
        a = max(a, reached)
        if b > a:
            busy, reached = busy + (b - a), b
    return (t1 - t0) / 1e3, busy / 1e3, len(spans)


def check_transposed_canvas(cfg, seed=7):
    """K2 against its plain version at the eval loop's portrait shapes:
    batch 2 on the transposed canvas, 300 RoIs at P=7 and 100 at P=14 an
    image, with the routing span of that canvas. (K1's problems do not
    depend on the canvas' orientation: phase 3 holds them.) The launches
    here are not counted."""
    from detectron_tpu_torch.ops import roi_align as ra

    w, h = cfg.data.image_size  # the canvas is (h, w): this is its transpose
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = cfg.train.batch_size
    feats = [torch.randn(b, h // st, w // st, cfg.model.fpn_channels, generator=gen,
                         device=dev) for st in STRIDES]
    fmax = max(float(f.abs().max()) for f in feats)
    span = ra.roi_max_span(cfg, tuple(feats[-1].shape[1:3]))
    for p, r in ((7, cfg.rpn.post_nms_topk_test), (14, cfg.test.detections_per_image)):
        rois = torch.tensor(roi_cases(rng, b, r, (h, w)), device=dev)
        levels = ra.assign_fpn_levels(rois, len(feats), 2, max_span=span)
        check_k2(f"eval B={b} {h}x{w} (transposed canvas) P={p} R={r} span={span}", feats,
                 rois, levels, p, fmax)
    reset_counts()


# ---------------------------------------------------------------- phase 12

BENCH_ARGS = ["--iters", "3", "--train-iters", "2"]  # the defaults otherwise


def phase_bench():
    """``python -m detectron_tpu_torch.bench`` at its default shapes (1024x1024,
    inference batch 48, train batch 16, float32), iterations cut: its JSON
    line (the bench raises if its outputs or losses sum to a non-finite
    value), every kernel's launches over the run, then K1-K3 against their
    plain versions at the bench's shapes. Returns the launches."""
    from detectron_tpu_torch import bench

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = bench.parse_args(BENCH_ARGS)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = bench.run(args)  # prints its JSON line
    torch.cuda.synchronize()
    counts = read_counts()
    reset_counts()
    calls, steps = bench.WARMUP + args.iters, bench.WARMUP + args.train_iters
    want = {"greedy_nms": 2 * calls + steps, "multilevel_roi_align": 2 * calls + 2 * steps,
            "multilevel_roi_align_bwd": 2 * steps}
    log(f"[bench] {time.perf_counter() - t0:.1f} s ({calls} predict calls at batch "
        f"{args.batch}, {steps} train steps at batch {args.train_batch}, warm-ups included); "
        f"launches {counts}; predict outputs and training losses summed finite; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if counts != want:
        raise AssertionError(f"bench: launches {counts}, want {want}")
    for key in ("value", "train_img_s_chip", "train_step_ms"):
        if not (np.isfinite(out[key]) and out[key] > 0):
            raise AssertionError(f"bench: {key} = {out[key]}")
    torch.cuda.empty_cache()
    check_bench_shapes(args)
    return counts


def check_bench_shapes(args, seed=6):
    """K1, K2 and K3 against their plain versions at the shapes that the
    bench's config gives at ``args.size`` x ``args.size``. Inference at
    batch ``args.batch``: the RPN's problems, one an image and level, of
    ``pre_nms_topk_test`` boxes; the detections' one problem an image of
    ``4 x post_nms_topk_test`` candidates; K2 at ``post_nms_topk_test``
    RoIs at P=7 and ``detections_per_image`` at P=14 an image. Training at
    batch ``args.train_batch``: the RPN's problems of ``pre_nms_topk_train``
    boxes, and K2 and K3 at ``batch_per_image`` RoIs at P=7 and its
    foreground share at P=14 an image. The launches here are not counted."""
    from detectron_tpu_torch import bench
    from detectron_tpu_torch.ops import roi_align as ra

    cfg = bench.bench_config(args)
    b, tb, size = args.batch, args.train_batch or args.batch, int(args.size)
    rpn, test = cfg.rpn, cfg.test
    levels_n = len(STRIDES) + 1  # P2-P6 propose
    # detection_candidates: top min(4 x post_nms_topk_test, R x K) of R RoIs and K classes
    cand = rpn.post_nms_topk_test * min(4, cfg.model.num_classes - 1)
    rng = np.random.RandomState(seed)
    dev = torch.device(DEVICE)
    for name, g, n, thresh, m, classes in (
            ("rpn", levels_n * b, rpn.pre_nms_topk_test, rpn.nms_thresh,
             min(rpn.post_nms_topk_test, rpn.pre_nms_topk_test), 0),
            ("det", b, cand, test.nms_thresh, test.detections_per_image,
             cfg.model.num_classes),
            ("rpn_train", levels_n * tb, rpn.pre_nms_topk_train, rpn.nms_thresh,
             min(rpn.post_nms_topk_train, rpn.pre_nms_topk_train), 0)):
        boxes, scores, valid, cls = nms_problems(rng, g, n, (size, size), n // 8, classes)
        tbx, ts, tv = (torch.tensor(x, device=dev) for x in (boxes, scores, valid))
        if cls is not None:  # the class offsets of class_aware_nms
            span = tbx.amax(dim=(1, 2)) - tbx.amin(dim=(1, 2)) + 1.0
            tbx = tbx + (torch.tensor(cls, device=dev).to(tbx.dtype) * span[:, None])[..., None]
        sboxes, svalid = sorted_problems(tbx, ts, tv)
        keep = check_keep(f"bench {name}", sboxes, svalid, thresh, m)
        log(f"[K1 bench {name}] G={g} N={n} t={thresh} max_keep={m}: keep masks equal to the "
            f"plain version ({int(keep.sum())} kept)")
    gen = torch.Generator(device=dev).manual_seed(seed)
    span = ra.roi_max_span(cfg, (size // STRIDES[-1], size // STRIDES[-1]))
    pool, mask_pool = cfg.roi.pool_size, cfg.roi.mask_pool_size
    fg = int(round(cfg.roi.batch_per_image * cfg.roi.positive_fraction))
    for batch, cases, backward in (
            (b, ((pool, rpn.post_nms_topk_test), (mask_pool, test.detections_per_image)), False),
            (tb, ((pool, cfg.roi.batch_per_image), (mask_pool, fg)), True)):
        feats = [torch.randn(batch, size // st, size // st, cfg.model.fpn_channels,
                             generator=gen, device=dev) for st in STRIDES]
        fmax = max(float(f.abs().max()) for f in feats)
        level_hw = [tuple(f.shape[1:3]) for f in feats]
        for p, r in cases:
            rois = torch.tensor(roi_cases(rng, batch, r, (size, size)), device=dev)
            levels = ra.assign_fpn_levels(rois, len(feats), 2, max_span=span)
            tag = f"bench B={batch} {size}x{size} P={p} R={r} span={span}"
            check_k2(tag, feats, rois, levels, p, fmax)
            if backward:
                g = torch.randn(batch, r, p, p, feats[0].shape[-1], generator=gen, device=dev)
                check_k3(tag, g, level_hw, rois, levels)
                del g
        del feats
        torch.cuda.empty_cache()
    reset_counts()


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
    """One kernel's line entry. ``launches_by_path``: its launches on each
    path's run (predict, train, eval, bench); ``launches`` the training
    path's (phase 9's timed steps), the one path that launches all three
    kernels, as in the line since K3 was ported. Times are summed over the
    training step's cases (one launch of each case per step), the inference
    cases are listed beside them."""
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", action="store_true",
                        help="run phases 1-4 and 7 only (the kernels against their plain "
                             "versions, and their times), print their cases and stop; no "
                             "result line")
    args = parser.parse_args(argv)
    card = phase_device()
    phase_build()
    rng = np.random.RandomState(0)
    k1 = phase_nms(rng)
    feats = level_features(rng)
    k2 = phase_roi_align(rng, feats)
    if args.kernels:
        k3 = phase_roi_align_bwd(rng, feats)
        print(json.dumps({"kernel_cases": {"greedy_nms": k1, "multilevel_roi_align": k2,
                                           "multilevel_roi_align_bwd": k3}}), flush=True)
        print(card, flush=True)
        return 0
    predict_launches, _ = phase_slice()
    phase_cross_device()
    k3 = phase_roi_align_bwd(rng, feats)
    phase_function(rng, feats)
    del feats
    train_launches, _ = phase_train()
    phase_cross_train()
    eval_launches = phase_eval()
    bench_launches = phase_bench()

    def launches(name):
        return {"predict": predict_launches.get(name, 0), "train": train_launches[name],
                "eval": eval_launches[name], "bench": bench_launches[name]}

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
