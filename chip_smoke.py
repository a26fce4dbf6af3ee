"""Smoke test of the PyTorch port on one NVIDIA GPU (run: python3 chip_smoke.py).

Phases, in order; any failure exits non-zero before the result line. The
model phases run in float32 (TF32 off) and then in bf16 (``model.dtype=
bfloat16``: float32 parameters, bf16 compute, the kernels' bf16 instances):

1. device: requires CUDA, prints the card's name and power limit, turns
   TF32 off for matmuls and convolutions;
2. build: compiles the hand-written kernels (csrc/*.cu) with nvcc, and the
   RLE codec (native/rle.cpp) with g++;
3. K1 (greedy NMS) against its plain PyTorch version on the card, at the
   inference (G=10, N=1000; G=2, N=1200), training (G=10, N=2000) and
   RetinaNet (G=2, N=5000 and 2000, 81 classes shifted apart) and R-FCN
   (G=2, N=1000 and 2000) shapes, with
   and without the main path's max_keep = min(max_out, N), and at edge
   cases (N=65, N=4096, N=8192 = the limit, odd W below and above 64,
   max_keep=1 at N=700 and 5000, max_keep above the kept count, an
   all-invalid problem): keep masks and (idx, valid) must be equal; N=8193
   must be refused; the mask and scan launches are timed apart;
4. K2 (multilevel RoIAlign) against its plain version on the card, at the
   1024x1344 P2-P5 shapes, C=256, inference (R=300, P=7; R=100, P=14) and
   training (R=512, P=7; R=128, P=14) RoI counts with both routing spans,
   at K3's stress cases for P=7 and 14, and at sampling ratios 1 and 3
   (the kernel's generic instance; the model's is 2): max |diff| <= 1e-5 *
   max |feature|, and two K2 runs bitwise equal; each case logs, as a count
   from its inputs, the bytes of each RoI's distinct cells (what K2 stages)
   beside the distinct cells over the batch (the bound's). The bf16
   instance at the same cases (and at C=32 and 24, its 32- and 8-channel
   slices): within one bf16 step of its bf16 plain version plus the fp32
   limit, within one bf16 step of the fp32 kernel on the upcast features
   cast once, two runs bitwise equal; timed, its bound at 2 bytes a value;
5. predict: Mask R-CNN R-50-FPN (configs/mask_rcnn_r50_fpn_coco.yaml) at
   full width, 1024x1344, batch 2, weights from a numpy seed, float32 then
   bf16: predict_fn three times; K1 (handed float32 boxes) and K2 (handed
   features of the model's dtype) twice a call, detections non-empty, boxes
   float32, scores and mask probabilities in the model's dtype and in
   [0, 1]; one more call under torch.cuda.set_sync_debug_mode must report
   no synchronising call (the eval loop relies on it); the stage
   breakdown; the convolutions NCHW against channels-last on the same
   weights, in turns; a profiled call;
6. cross-device predict: the same port at 256x256 with small widths on the
   card and on the CPU (plain versions) with the same weights: float32,
   equal valid slots, boxes within 1e-3; bf16, the FPN levels, the RPN
   outputs and both heads' outputs on the same RoIs within CROSS_BF16 of
   their magnitude;
7. K3 (multilevel RoIAlign backward) against its plain version on the
   card at the training shapes (B=2, 1024x1344, P2-P5, C=256; R=512, P=7
   and R=128, P=14) and at stress cases (RoIs wider than P*S cells, all
   sub-cell, all identical, P5 RoIs covering the whole level, past the
   border): max |diff| <= 1e-5 * max |plain gradient|; two K3 runs are
   compared too (overlapping RoIs add in a varying order); the zero fill
   and the kernel are timed apart. The bf16 route (a pre-pass of each
   RoI's tap cell range, then one tile kernel that writes each bf16 level
   gradient once, each level rounded to bf16 once) at the same cases:
   within one bf16 step plus the fp32 limit of its bf16 plain version and
   of the fp32 kernel on the upcast gradient cast once, two runs bitwise
   equal, the pre-pass's bounds equal to roi_tap_cell_bounds; one call
   under the profiler runs the pre-pass and the tile kernel and nothing
   else; timed whole, pre-pass and kernel apart, its bound at 2 bytes a
   value, beside the fp32 fill and cast passes of the earlier bf16 route;
   the stress cases timed too (recorded, not gated);
8. the autograd Function (K2 forward, K3 backward) on the card: the
   gradient of a weighted sum of its output equals autograd through the
   plain forward within the same bound;
9. train: Mask R-CNN R-101-FPN (configs/mask_rcnn_r101_fpn_coco_train.yaml)
   at full width, 1024x1344, train.batch_size=2, train.base_lr=0.0025,
   seeded synthetic batches, float32 then bf16: 2 warm-up train_steps,
   then 5; every loss finite on every step, K1 (float32 boxes), K2 (2) and
   K3 (2) launched on every step in the model's dtype, frozen parameters
   unchanged, every trainable one changed, every parameter and gradient
   float32; per-step ms, a CUDA-event breakdown, peak memory, a profiler
   pass, both layouts on the same starting weights; in float32 then the
   train driver for 2 steps;
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
    weights (the cls_score bias raised) restored from a checkpoint, float32
    then bf16; Loader -> predict_fn -> host paste + RLE -> box and segm
    COCO metrics. Every image consumed once, K1 and K2 twice a predict
    call, detections and non-empty masks, scores fetched as float32, every
    metric finite or null; an oracle predictor (in bf16 its outputs bf16
    tensors on the card) must give box AP and segm AP50 of 1.0; logs
    images/s of the loop, device ms per predict call and the host's ms per
    batch by part (paste + RLE apart from the gt records), for this run
    and for warm runs over 32 images with 8 (and in float32 1) loader
    threads, and in float32, from a profiled run, the device's busy share
    of the loop; K2 on the transposed canvas;
12. bench: python -m detectron_tpu_torch.bench at its default shapes
    (1024x1024, batch 48 inference, batch 16 training) with --iters 3
    --train-iters 2, at its default dtype (bf16) and with --dtype float32:
    both JSON lines, positive finite rates, and every kernel's launches as
    its calls and steps require; in bf16 both layouts at the bench's
    batches; then K1, K2 and K3 against their plain versions at the bench's
    shapes (batch 48: 240 RPN problems of 1000 boxes, 48 of 1200; 14400 and
    4800 RoIs; batch 16 for training), K2 and K3 in the run's dtype.

13. RetinaNet predict: R-50-FPN (configs/retinanet_r50_fpn_coco.yaml) at
    full width, 1024x1344, batch 2, 81 classes, seeded weights with the
    cls_score bias raised for five classes (at the prior's bias no logit
    passes the threshold), float32 then bf16: predict_fn three times, K1
    once a call on float32 boxes, N = 5 x retinanet.pre_nms_topk = 5000 a
    problem; detections non-empty, scores in [0, 1]; one call under the
    sync debug mode; the stage breakdown (backbone+FPN, head, per-level
    top-k + decode, NMS); a profiled call;
14. cross-device RetinaNet at 256x256 and 160x224 (odd levels), small
    widths, card against CPU with the same weights: levels and head
    outputs within CROSS_F32 (bf16: CROSS_BF16) of their magnitude; the
    post-process on the same head outputs: equal valid slots and classes,
    boxes within 1e-3; end to end, the detections' match rate logged;
15. RetinaNet train: R-50-FPN, 1024x1344, batch 2, train.grad_clip_norm=1.0
    (without it SGD from random weights reaches NaN at step 2), float32
    then bf16, 2 warm-up steps and 3: losses finite, no kernel launched, frozen
    parameters unchanged, trainable ones changed, parameters and gradients
    float32, ms a step, peak memory, the stage breakdown; in float32 then
    the train driver for 2 steps;
16. RetinaNet eval: phase 11's in-memory COCO split, float32 then bf16:
    every image once, K1 once a predict call, box metrics finite or null
    (no segm), a warm run's images/s, the oracle's box AP 1.0;
17. RetinaNet bench: python -m detectron_tpu_torch.bench --model retinanet
    at 1024x1024, batch 8 for inference and training, --iters 3
    --train-iters 2, --set train.grad_clip_norm=1.0, bf16 then float32:
    the JSON line, K1 once a predict call; then K1 against its plain
    version at the bench's shape (G=8, N=5000), timed;
18. demo: python -m detectron_tpu_torch.demo --no-restore with RetinaNet's
    config writes its two synthetic images.

19. R-FCN predict: configs/rfcn_r50_coco.yaml at full width (trunk 1024, 81
    classes, P=7, 1024x1024), batch 2, seeded weights with frozen BN set
    from the batch and the ps_cls bias of five classes raised in every
    group, float32 then bf16 (the config's): predict_fn three times, K1
    twice a call on float32 boxes (proposals G=2, N=1000; detections G=2,
    N=1200), K2 and K3 never; detections non-empty, scores in [0, 1]; one
    call under the sync debug mode; the stage breakdown (backbone+trunk,
    RPN, proposals, PS maps, PSRoIPool + vote, detections); PSRoIPool
    (plain PyTorch) timed, forward and gradient; a profiled call;
20. cross-device R-FCN at 256x256, trunk 32, dilate_c5 off and on, card
    against CPU with the same weights: the trunk, the RPN outputs and the
    votes on the same RoIs within CROSS_F32 (bf16: CROSS_BF16); PSRoIPool's
    forward and its gradient (autograd) at the full-width shapes within
    1e-5 of their magnitude;
21. R-FCN train: full width, batch 2, base_lr 0.0025 (no gradient clip:
    the calibrated statistics keep its SGD finite), 2 warm-up steps and 3,
    float32 then bf16: losses finite, K1 once a step (G=2, N=2000), K2 and
    K3 never, frozen parameters unchanged, trainable ones changed, float32
    parameters and gradients; ms a step, peak memory, the breakdown,
    PSRoIPool timed at 512 sampled RoIs an image; in float32 the train
    driver for 2 steps;
22. R-FCN eval (phase 11's split, images at most 1024 on a side to fit
    the config's 1024x1024 canvas: every image once, K1 twice a call, box
    metrics, a warm run's images/s, the oracle's box AP 1.0), bench
    (--model rfcn --set model.fpn_channels=1024, batch 8 / 8, bf16 then
    float32: K1 twice a predict call and once a step) and demo;
23. RoIPool: multilevel_roi_pool (plain PyTorch) card against CPU at the
    1024x1344 P2-P5 shapes (C=256; R=512, P=7 and R=128, P=14 an image):
    float32 exactly equal, bf16 within one step, timed; then Faster R-CNN
    R-50-FPN (configs/faster_rcnn_r50_fpn_coco.yaml) with
    roi.pool_type=pool: 3 predict calls and 2 train steps, K1 twice a call
    and once a step, K2 and K3 never;
24. pretrained weights (model.weights): a torchvision-named R-50 backbone
    dict into the train driver on R-FCN for one step (the weights it starts
    from equal the dict), a full Mask R-CNN dict in the lineage's names
    into the eval driver on Mask R-CNN over phase 11's split (the deconv
    as it is, fc1 permuted, the RPN classifier fg - bg, the mask logits
    without channel 0), both written as .pth under build/;
25. GroupNorm: Mask R-CNN R-50-FPN (configs/mask_rcnn_r50_fpn_coco.yaml +
    model.norm=gn) at full width, 1024x1344, batch 2, float32 then bf16: 3
    predict calls (K1 and K2 twice each) and 3 train steps (K1 once, K2 and
    K3 twice each; losses finite; the stem's GroupNorm unchanged, a trainable
    stage's changed), stage breakdowns and peak memory; then phase 6's
    cross-device check with GroupNorm (bf16: within CROSS_BF16_GN, and as
    close to float32 as the CPU's bf16, within CROSS_BF16_AS_GOOD);
26. remat: config 5's model (configs/mask_rcnn_r101_fpn_coco_train.yaml),
    1024x1344, batch 2, float32: train_step without and with model.remat
    from the same weights, batch and draws, in turns: losses equal within
    1e-4, gradients within REMAT_GRAD_RTOL, each step's ms and peak memory;
27. data parallelism on config 5's model: (a) initialize_distributed over
    NCCL at world size 1, the DP step against train_step (loss within 1e-4,
    parameters within 2e-5; the two timed in turns), the train driver for 2
    steps under the group (metrics.jsonl through MetricsWriter), the eval
    driver over phase 11's split; (b) two ranks on the one card over gloo,
    batch 1 each: one DP step against train_step on the batch of 2, within
    the same limits. In phases 25-27 every kernel launch of one call or
    step of each path is also held against its plain version on that
    path's own inputs (``hold_path``).

After each group of phases it logs the host seconds the group took
(``[time]``). It then prints a JSON line of both dtypes' end-to-end numbers, a JSON line
of per-kernel results (float32 at top level; the bf16 cases in ``cases``
with their ``dtype``), the card's name and power limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import argparse
import contextlib
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
# training (pre_nms_topk 1000 / 2000, post 300 / 1000), the class-shifted
# detection candidates per image (1200 candidates, 100 detections),
# RetinaNet's merged candidates per image (5 levels x retinanet.pre_nms_topk
# 1000, and the 2000 that configs/retinanet_fast.yaml keeps; 100 detections),
# and R-FCN's one RPN level per image (its detections are the "det" case)
NMS_CASES = (
    dict(name="rpn", g=10, n=1000, thresh=0.7, max_out=300, n_invalid=120, classes=0,
         path="predict"),
    dict(name="det", g=2, n=1200, thresh=0.5, max_out=100, n_invalid=200, classes=81,
         path="predict"),
    dict(name="rpn_train", g=10, n=2000, thresh=0.7, max_out=1000, n_invalid=200,
         classes=0, path="train"),
    dict(name="retinanet", g=2, n=5000, thresh=0.5, max_out=100, n_invalid=1000,
         classes=81, path="retinanet predict"),
    dict(name="retinanet_fast", g=2, n=2000, thresh=0.5, max_out=100, n_invalid=400,
         classes=81, path="retinanet predict (fast)"),
    dict(name="rfcn_rpn", g=2, n=1000, thresh=0.7, max_out=300, n_invalid=120, classes=0,
         path="rfcn predict"),
    dict(name="rfcn_rpn_train", g=2, n=2000, thresh=0.7, max_out=1000, n_invalid=200,
         classes=0, path="rfcn train"),
)
NMS_LIMIT = 8192  # the most boxes a K1 problem takes (csrc/nms.cu, kMaxWords x 64)
# edge cases, each held exactly against the plain version; max_keep "above"
# is one more than the largest kept count of the problems
NMS_EDGE_CASES = (
    dict(name="N=65", g=3, n=65, thresh=0.5, n_invalid=5, max_keep=None),
    dict(name="N=4096 (W=64)", g=2, n=4096, thresh=0.7, n_invalid=96, max_keep=None),
    dict(name=f"N={NMS_LIMIT} (the limit)", g=2, n=NMS_LIMIT, thresh=0.5, n_invalid=192,
         max_keep=None),
    dict(name="N=1200 (odd W)", g=3, n=1200, thresh=0.6, n_invalid=0, max_keep=None),
    dict(name="N=4500 (odd W above 64)", g=2, n=4500, thresh=0.5, n_invalid=0,
         max_keep=None),
    dict(name="max_keep=1", g=4, n=700, thresh=0.5, n_invalid=50, max_keep=1),
    dict(name="max_keep=1, N=5000", g=2, n=5000, thresh=0.5, n_invalid=1000, max_keep=1),
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
    results = [nms_case(rng, case) for case in NMS_CASES]
    nms_edge_cases(rng)
    check_nms_limit()
    return results


def nms_case(rng, case, size=(1024, 1344)):
    """One of NMS_CASES' shapes on a ``size`` canvas: K1 against its plain
    version with and without max_keep, ``(idx, valid)`` against the CPU
    path, the kernel timed whole and as its two launches, the plain version
    timed, the bound from this run's data. Returns the case's result."""
    from detectron_tpu_torch.ops import nms

    dev = torch.device(DEVICE)
    boxes, scores, valid, cls = nms_problems(
        rng, case["g"], case["n"], size, case["n_invalid"], case["classes"])
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
    return dict(case=case["name"], path=case["path"], dtype="float32", max_keep=m, ms=ms,
                mask_ms=mask_ms, scan_ms=scan_ms, scan_full_ms=scan_full_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def nms_edge_cases(rng):
    """NMS_EDGE_CASES, each exactly against the plain version."""
    dev = torch.device(DEVICE)
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


def check_nms_limit():
    """The kernel's limit is NMS_LIMIT boxes a problem, and one box more is
    refused by the wrapper with a message that names the limit."""
    from detectron_tpu_torch.ops import nms

    limit = nms._nms_lib().nms_max_boxes()
    if limit != NMS_LIMIT:
        raise AssertionError(f"K1 takes {limit} boxes, want {NMS_LIMIT}")
    boxes = torch.zeros(1, limit + 1, 4, device=DEVICE)
    valid = torch.ones(1, limit + 1, dtype=torch.bool, device=DEVICE)
    try:
        nms.greedy_keep_cuda(boxes, valid, 0.5)
    except ValueError as err:
        if str(limit) not in str(err):
            raise AssertionError(f"K1's refusal does not name its limit: {err}") from err
        log(f"[K1 edge] N={limit + 1}: refused ({err})")
        return
    raise AssertionError(f"K1 took N={limit + 1}, past its limit")


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
    read (each once), at the features' bytes a value."""
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
    return int(torch.unique(torch.cat(cells)).numel()) * c * features[0].element_size()


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
    read over the batch, its output (both at the features' bytes a value),
    RoIs and routing, at the card's memory rate, or its fp32 operations
    where slower. Returns (ms, by, bytes)."""
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    nbytes = (touched_bytes(feats, rois, levels, STRIDES, p, s)
              + b * r * p * p * c * feats[0].element_size() + b * r * (16 + 4))
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


# a bf16 value's spacing is at most this share of its magnitude (8 bits of
# significand): two results within it of each other are within one bf16 step
BF16_ULP = 2.0 ** -7


def bf16_steps(a, b) -> int:
    """The largest distance between two bf16 tensors of finite values, in
    bf16 steps (0: bitwise equal; +0 and -0 are one value)."""
    def ordered(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def within_bf16(got, want, floor):
    """(max |got - want|, whether every element is within one bf16 step of
    ``want`` plus ``floor``): the bf16 rounding of two float32 results that
    differ by less than ``floor``."""
    d = (got.float() - want.float()).abs()
    ok = bool((d <= BF16_ULP * want.float().abs() + floor).all())
    return float(d.max()) if d.numel() else 0.0, ok


def check_k2_bf16(name, feats, rois, levels, p, fmax, s=2):
    """K2's bf16 instance twice, its bf16 plain version, and the fp32
    kernel on the upcast features, on the same inputs: within one bf16 step
    of the plain version plus the fp32 limit (1e-5 x max |feature|: the two
    sum in other orders, then round), within one bf16 step of the fp32
    kernel's output cast once (the same sums in the same order: equal,
    unless the compiler orders them otherwise), and the two runs bitwise
    equal. Returns (max |diff| against the plain version, bf16 steps from
    the fp32 kernel)."""
    from detectron_tpu_torch.ops import roi_align as ra

    got = ra.multilevel_roi_align_cuda(feats, rois, levels, STRIDES, p, s)
    again = ra.multilevel_roi_align_cuda(feats, rois, levels, STRIDES, p, s)
    want = ra.multilevel_roi_align_plain(feats, rois, levels, STRIDES, p, s)
    f32 = ra.multilevel_roi_align_cuda([f.float() for f in feats], rois, levels, STRIDES, p,
                                       s).to(torch.bfloat16)
    torch.cuda.synchronize()
    if got.dtype != torch.bfloat16:
        raise AssertionError(f"K2 bf16 {name}: output {got.dtype}")
    diff, ok = within_bf16(got, want, 1e-5 * fmax)
    steps = bf16_steps(got, f32)
    n_off = int((got != f32).sum())
    same = torch.equal(got, again)
    log(f"[K2 bf16 {name}] max |diff| {diff:.3e} from the bf16 plain version (limit: one "
        f"bf16 step + {1e-5 * fmax:.3e}): {ok}; from the fp32 kernel on the upcast features "
        f"cast once: {steps} bf16 steps at most (limit 1), {n_off} of {got.numel()} values "
        f"differ; two runs bitwise equal: {same}")
    if not ok:
        raise AssertionError(f"K2 bf16 {name}: beyond one bf16 step of the plain version")
    if steps > 1:
        raise AssertionError(f"K2 bf16 {name}: {steps} bf16 steps from the fp32 kernel")
    if not same:
        raise AssertionError(f"K2 bf16 {name}: two runs differ")
    return diff, steps


def phase_roi_align(rng, feats):
    """K2 against its plain version at the main path's cases, with both
    routing spans, then at the K3 stress cases and at sampling ratios 1 and
    3 (their own seeded draws, so the later phases' inputs do not move)."""
    from detectron_tpu_torch.ops import roi_align as ra

    dev = torch.device(DEVICE)
    b, c, canvas, strides = 2, feats[0].shape[-1], CANVAS, STRIDES
    fmax = max(float(f.abs().max()) for f in feats)
    feats16 = [f.bfloat16() for f in feats]
    fmax16 = max(float(f.abs().max()) for f in feats16)
    results = []
    for path, p, r in ROI_CASES:
        rois = torch.tensor(roi_cases(rng, b, r, canvas), device=dev)
        worst = worst16 = 0.0
        # both routing spans; the main path's (28, 44) last, so it is the one timed
        for span in (ra.DEFAULT_MAX_SPAN, (28.0, 44.0)):
            levels = ra.assign_fpn_levels(rois, 4, 2, max_span=span)
            diff, per_roi = check_k2(f"P={p} R={r} span={span}", feats, rois, levels, p, fmax)
            worst = max(worst, diff)
            diff16, _ = check_k2_bf16(f"P={p} R={r} span={span}", feats16, rois, levels, p,
                                      fmax16)
            worst16 = max(worst16, diff16)
        for dtype_feats, err in ((feats, worst), (feats16, worst16)):
            ms = cuda_ms(lambda: ra.multilevel_roi_align_cuda(dtype_feats, rois, levels,
                                                              strides, p, 2))
            plain_ms = cuda_ms(lambda: ra.multilevel_roi_align_plain(
                dtype_feats, rois, levels, strides, p, 2), iters=5, warmup=1)
            dtype = str(dtype_feats[0].dtype).replace("torch.", "")
            out_bytes = b * r * p * p * c * dtype_feats[0].element_size()
            b_ms, b_by, nbytes = k2_bound(dtype_feats, rois, levels, p)
            log(f"[K2 P={p} R={r} {dtype}] kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB); per-RoI distinct "
                f"cells, from the inputs, {per_roi / 1e6:.1f} MB at fp32; output "
                f"{out_bytes / 1e6:.1f} MB")
            results.append(dict(case=f"P{p} R{r}", path=path, dtype=dtype, ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                max_abs_err=err))
    stress = np.random.RandomState(4)
    for kind in K3_STRESS:
        for p in (7, 14):
            rois, levels = k3_stress_rois(stress, kind, b, 128)
            rois = torch.tensor(rois, device=dev)
            levels = (ra.assign_fpn_levels(rois, len(feats), 2, max_span=(28.0, 44.0))
                      if levels is None else torch.tensor(levels, device=dev))
            check_k2(f"stress: {kind}, P={p} R=128", feats, rois, levels, p, fmax)
            check_k2_bf16(f"stress: {kind}, P={p} R=128", feats16, rois, levels, p, fmax16)
    ratios = np.random.RandomState(5)
    for s in (1, 3):
        for p in (7, 14):
            rois = torch.tensor(roi_cases(ratios, b, 128, canvas), device=dev)
            levels = ra.assign_fpn_levels(rois, len(feats), 2, max_span=(28.0, 44.0))
            check_k2(f"S={s}, P={p} R=128", feats, rois, levels, p, fmax, s)
            check_k2_bf16(f"S={s}, P={p} R=128", feats16, rois, levels, p, fmax16, s)
    # bf16 at narrow channel counts: the 32- and 8-channel slices
    narrow = np.random.RandomState(8)
    for c_n in (32, 24):
        feats_n = [f[..., :c_n].contiguous() for f in feats16]
        rois = torch.tensor(roi_cases(narrow, b, 64, canvas), device=dev)
        levels = ra.assign_fpn_levels(rois, len(feats), 2, max_span=(28.0, 44.0))
        for p in (7, 14):
            check_k2_bf16(f"C={c_n}, P={p} R=64", feats_n, rois, levels, p,
                          max(float(f.abs().max()) for f in feats_n))
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


@contextlib.contextmanager
def kernel_dtypes(shapes=None):
    """Records the dtypes each kernel wrapper is handed (K1: the boxes; K2:
    the features; K3: the upstream gradient) while the block runs: each
    wrapper is replaced, by name in its module, with a recorder that calls
    it. A wrapper counts its launches on the name it is bound to, so the
    recorder carries the count while the block runs and hands it back.
    Yields ``{name: set of dtypes}``; with ``shapes`` (a dict), K1's box
    shapes are appended to ``shapes["greedy_nms"]`` call by call."""
    from detectron_tpu_torch.ops import nms, roi_align

    seen = {}
    sites = ((nms, "greedy_keep_cuda", "greedy_nms", lambda a: a[0].dtype),
             (roi_align, "multilevel_roi_align_cuda", "multilevel_roi_align",
              lambda a: a[0][0].dtype),
             (roi_align, "multilevel_roi_align_bwd_cuda", "multilevel_roi_align_bwd",
              lambda a: a[0].dtype))
    real = {}
    for module, attr, name, dtype_of in sites:
        fn = real[(module, attr)] = getattr(module, attr)

        def recorder(*args, _fn=fn, _name=name, _dtype_of=dtype_of, **kwargs):
            seen.setdefault(_name, set()).add(str(_dtype_of(args)).replace("torch.", ""))
            if shapes is not None and _name == "greedy_nms":
                shapes.setdefault(_name, []).append(tuple(args[0].shape))
            return _fn(*args, **kwargs)

        recorder.launches = fn.launches
        setattr(module, attr, recorder)
    try:
        yield seen
    finally:
        for (module, attr), fn in real.items():
            fn.launches = getattr(module, attr).launches
            setattr(module, attr, fn)


def _copy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_copy(v) for v in x)
    return x


def hold_path(fn, tag) -> dict:
    """Runs ``fn()`` (one call of a model path) with each kernel wrapper's
    inputs and output copied at every launch, then holds each launch's
    output against its plain version on the same inputs: K1 exactly; K2
    within 1e-5 x max |feature|, K3 within 1e-5 x max |plain gradient|
    (bf16: one bf16 step beyond those). No kernel is launched again for the
    comparison. Returns ``{name: (launches held, worst |diff|)}``."""
    from detectron_tpu_torch.ops import nms, roi_align

    sites = ((nms, "greedy_keep_cuda", "greedy_nms", nms.greedy_keep_plain),
             (roi_align, "multilevel_roi_align_cuda", "multilevel_roi_align",
              roi_align.multilevel_roi_align_plain),
             (roi_align, "multilevel_roi_align_bwd_cuda", "multilevel_roi_align_bwd",
              roi_align.multilevel_roi_align_bwd_plain))
    calls = {name: [] for _, _, name, _ in sites}
    real = {}
    for module, attr, name, _ in sites:
        wrapper = real[(module, attr)] = getattr(module, attr)

        def recorder(*args, _fn=wrapper, _name=name, **kwargs):
            out = _fn(*args, **kwargs)
            calls[_name].append((_copy(args), kwargs, _copy(out)))
            return out

        recorder.launches = wrapper.launches
        setattr(module, attr, recorder)
    try:
        fn()
        if torch.cuda.is_initialized():  # not in a rehearsal's CPU-only rank
            torch.cuda.synchronize()
    finally:
        for (module, attr), wrapper in real.items():
            wrapper.launches = getattr(module, attr).launches
            setattr(module, attr, wrapper)
        reset_counts()
    held = {}
    for _, _, name, plain in sites:
        worst = 0.0
        for args, kwargs, got in calls[name]:
            want = plain(*args, **kwargs)
            if name == "greedy_nms":
                ok = torch.equal(got, want)
                diff = float((got != want).sum())
            else:
                if name == "multilevel_roi_align":
                    got, want = [got], [want]
                    floor = 1e-5 * max(float(f.float().abs().max()) for f in args[0])
                else:
                    floor = 1e-5 * max(float(w.float().abs().max()) for w in want)
                checks = [within_bf16(x, w, floor) if x.dtype == torch.bfloat16
                          else (float((x - w).abs().max()), float((x - w).abs().max()) <= floor)
                          for x, w in zip(got, want)]
                ok = all(c[1] for c in checks)
                diff = max(c[0] for c in checks)
            if not ok:
                raise AssertionError(f"{tag}: {name} disagrees with its plain version on the "
                                     f"path's own inputs (max |diff| {diff:.3e})")
            worst = max(worst, diff)
        held[name] = (len(calls[name]), worst)
    log(f"[{tag}] each launch held against its plain version on the path's inputs: "
        + "; ".join(f"{k} {n} launches, max |diff| {d:.3e}" for k, (n, d) in held.items()))
    return held


MASK_R50 = os.path.join(REPO, "configs", "mask_rcnn_r50_fpn_coco.yaml")


def phase_slice(seed=0, calls=3, dtype="float32"):
    """predict_fn at full width in ``dtype``: ``calls`` calls, each
    launching K1 (on float32 boxes) and K2 (on ``dtype`` features) twice;
    one more under the sync debug mode; the stage breakdown; the two
    layouts timed in turns; a profiled call. Returns (launches over the
    calls, ms a call, a summary of the numbers)."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models.faster_rcnn import detection_candidates
    from detectron_tpu_torch.models.zoo import build_detector

    cfg = get_config(MASK_R50, [f"model.dtype={dtype}"])
    det = build_detector(cfg)  # the card, by default
    params = raise_class_bias(det.init(seed), RAISED_CLASSES)
    batch = slice_inputs(cfg, seed, det.device)
    tag = "slice" if dtype == "float32" else f"slice {dtype}"
    log(f"[{tag}] {cfg.model.name} {cfg.model.backbone} FPN {cfg.model.fpn_channels} "
        f"classes {cfg.model.num_classes} canvas {tuple(cfg.data.image_size)} "
        f"{cfg.model.dtype} batch {batch['image'].shape[0]}, convolutions "
        f"{'channels-last' if det.module.memory_format == torch.channels_last else 'NCHW'}")

    totals = {"greedy_nms": 0, "multilevel_roi_align": 0}
    times = []
    want_dtypes = {"greedy_nms": {"float32"}, "multilevel_roi_align": {dtype}}
    for call in range(calls):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with kernel_dtypes() as seen:
            dets, masks = det.predict_fn(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        log(f"[{tag}] call {call}: {times[-1]:.1f} ms, launches {counts}, kernel input "
            f"dtypes {dict(sorted((k, sorted(v)) for k, v in seen.items()))}")
        if counts.pop("multilevel_roi_align_bwd"):
            raise AssertionError("predict_fn launched the RoIAlign backward")
        for name, n in counts.items():
            if n <= 0:
                raise AssertionError(f"predict_fn call {call} launched {name} no time")
            totals[name] += n
        if counts["multilevel_roi_align"] != 2 or counts["greedy_nms"] != 2:
            raise AssertionError(f"predict_fn call {call} launched K1 {counts['greedy_nms']} "
                                 f"and K2 {counts['multilevel_roi_align']} times, want 2 "
                                 "(proposals, detections; box, mask)")
        if seen != want_dtypes:
            raise AssertionError(f"predict_fn call {call}: kernel input dtypes {seen}, want "
                                 f"{want_dtypes}")

    issue_ms, done_ms = check_no_host_sync(lambda: det.predict_fn(params, batch), "predict_fn",
                                           tag)

    # the stages one by one, timed; they also show the candidates that
    # entered the detection NMS
    det.module.load_state_dict(params)
    parts, (props, cls_logits, reg) = stage_breakdown(det, batch, cfg)
    cand_valid = detection_candidates(cls_logits, reg, props.boxes, props.valid,
                                      batch["image_hw"], cfg)[3]
    reset_counts()
    n_cand = int(cand_valid.sum())
    n_props = int(props.valid.sum())
    n_dets = int(dets.valid.sum())
    log(f"[{tag}] proposals valid {n_props}, detection-NMS candidates valid {n_cand}, "
        f"detections valid {n_dets}, classes {sorted(set(dets.classes[dets.valid].tolist()))}")
    if not (n_props > 0 and n_cand > 0 and n_dets > 0):
        raise AssertionError("the slice produced no proposals, candidates or detections")
    if tuple(dets.boxes.shape) != (2, cfg.test.detections_per_image, 4):
        raise AssertionError(f"detections shape {tuple(dets.boxes.shape)}")
    if masks is None or tuple(masks.shape) != (2, cfg.test.detections_per_image, 28, 28):
        raise AssertionError("mask probabilities missing or of the wrong shape")
    want = {"boxes": torch.float32, "scores": det.dtype, "masks": det.dtype}
    got = {"boxes": dets.boxes.dtype, "scores": dets.scores.dtype, "masks": masks.dtype}
    if got != want:
        raise AssertionError(f"output dtypes {got}, want {want}")
    if not (bool(torch.isfinite(dets.boxes).all()) and bool(torch.isfinite(masks).all())
            and float(masks.min()) >= 0.0 and float(masks.max()) <= 1.0):
        raise AssertionError("non-finite boxes or mask probabilities outside [0, 1]")
    log(f"[{tag}] per-call ms {[round(t, 3) for t in times]}; masks in "
        f"[{float(masks.min()):.4f}, {float(masks.max()):.4f}]; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    layouts = layout_times(det, lambda: det.predict_fn(params, batch), f"predict {dtype}")
    profile_call(lambda: det.predict_fn(params, batch), f"one predict_fn, {dtype}")
    return totals, times, dict(call_ms=times, issue_ms=issue_ms, done_ms=done_ms,
                               stages_ms=parts, **layouts)


def layout_times(det, run, label, calls=8) -> dict:
    """Milliseconds of ``run()`` with the detector's convolutions
    channels-last and NCHW on the same weights: two warm-ups each way
    (cuDNN sets up each layout's kernels), then ``calls`` calls each, the
    layout switched at every call (channels-last, NCHW, NCHW, channels-last,
    ...), each ended by a synchronize; medians and minima. The detector's
    own layout is restored."""
    own = det.module.memory_format == torch.channels_last
    times = {True: [], False: []}
    for on in (True, False, True, False):
        det.module.set_channels_last(on)
        run()
    for i in range(2 * calls):
        on = i % 4 in (0, 3)
        det.module.set_channels_last(on)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times[on].append((time.perf_counter() - t0) * 1e3)
    det.module.set_channels_last(own)
    reset_counts()
    cl, nchw = float(np.median(times[True])), float(np.median(times[False]))
    log(f"[layout {label}] channels-last {cl:.2f} ms (least {min(times[True]):.2f}), NCHW "
        f"{nchw:.2f} ms (least {min(times[False]):.2f}); medians of {calls} calls each, the "
        f"layout switched at every call; the detector runs "
        f"{'channels-last' if own else 'NCHW'}; channels-last / NCHW = {cl / nchw:.3f}")
    return {"channels_last_ms": cl, "nchw_ms": nchw}


def check_no_host_sync(fn, label, tag="slice"):
    """``fn()`` must not wait for the device (the eval driver issues batch
    k+1's predict call before it consumes batch k): run once under
    ``torch.cuda.set_sync_debug_mode``, no synchronising call may be
    reported. Logs and returns the host's time to issue the call and to
    its end."""
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
    log(f"[{tag}] {label} under the sync debug mode: issued in {issue_ms:.2f} ms of host "
        f"time, done after {done_ms:.2f} ms; synchronising calls reported: {len(syncs)}")
    if syncs:
        raise AssertionError(f"{label} synchronises with the host: {syncs}")
    return issue_ms, done_ms


def stage_breakdown(det, batch, cfg, repeats=3):
    """Device milliseconds of each stage of faster_rcnn_eval_forward, timed
    with CUDA events between the stage calls (median of ``repeats``).
    Returns them and the last repeat's proposals and box-head outputs."""
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
    log(f"[stages {cfg.model.dtype}] median of {repeats}, device ms (share of {total:.2f} ms): "
        + "; ".join(f"{n} {t:.3f} ({100 * t / total:.1f}%)" for n, t in parts.items()))
    return parts, (props, cls_logits, reg)


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


# phase 6's limit in bf16, where the card's and the CPU's convolutions each
# round every layer's output to bf16 after summing in their own order: each
# FPN level, each level's RPN outputs, and the box and mask heads' outputs
# on the same RoIs (the CPU's detections) within CROSS_BF16 x max |CPU
# output| (the limit the CPU tests hold the port's bf16 levels to against
# the JAX package's; bf16 against float32 reads 1.3-2.2% at every stage on
# the CPU). The detections themselves are not compared as sets: at random
# weights the raised classes' scores saturate (13 of 20 a bf16 1.0) and
# ties pick among overlapping boxes, so two float32 runs on the CPU that
# differ only in the convolutions' layout share 52.5% of their detections
# (PERF.md); their share is logged.
CROSS_BF16 = 3e-2


def match_rate(dets_a, dets_b, iou=0.5) -> float:
    """The share of ``dets_a``'s valid detections that ``dets_b`` has too:
    a valid detection of the same class, at IoU >= ``iou`` or the same box
    (clipped boxes can have no area), in the same image (1.0 if ``dets_a``
    has none)."""
    from detectron_tpu_torch.ops.boxes import bbox_overlaps

    found = total = 0
    for i in range(dets_a.valid.shape[0]):
        va, vb = dets_a.valid[i].cpu(), dets_b.valid[i].cpu()
        ba, bb = dets_a.boxes[i].cpu()[va], dets_b.boxes[i].cpu()[vb]
        ca, cb = dets_a.classes[i].cpu()[va], dets_b.classes[i].cpu()[vb]
        total += len(ba)
        if len(ba) and len(bb):
            same = (bbox_overlaps(ba.float(), bb.float()) >= iou) | (
                ba[:, None, :] == bb[None, :, :]).all(-1)
            hit = same & (ca[:, None] == cb[None, :])
            found += int(hit.any(1).sum())
    return found / total if total else 1.0


def phase_cross_device(seed=1, dtype="float32", overrides=(), bf16_limit=CROSS_BF16,
                       as_good_as_cpu=False):
    """The port at 256x256 with small widths on the card and on the CPU
    (plain versions) with the same weights (``overrides`` added to the
    config). float32: equal valid slots and classes, boxes within 1e-3.
    bf16: the FPN levels, the RPN outputs and both heads' outputs on the
    same RoIs within ``bf16_limit``; with ``as_good_as_cpu``, besides, each
    no farther from the CPU's float32 output than CROSS_BF16_AS_GOOD x the
    CPU's bf16 one is."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models.zoo import build_detector

    cfg_overrides = [
        "model.name=mask_rcnn", "model.num_classes=5", "model.fpn_channels=32",
        "data.image_size=[256, 256]", "rpn.pre_nms_topk_test=256",
        "rpn.post_nms_topk_test=64", "test.detections_per_image=20",
        f"model.dtype={dtype}", *overrides]
    cfg = get_config(None, cfg_overrides)
    label = " ".join(["cross", *overrides])
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
    if not (counts["greedy_nms"] > 0 and counts["multilevel_roi_align"] > 0
            and int(valid_c.sum()) > 0):
        raise AssertionError("cross-device run: no kernel launch or no detection")
    if dtype == "float32":
        box_diff = float((dets_g.boxes.cpu() - dets_c.boxes).abs().max())
        mask_diff = float((masks_g.cpu() - masks_c).abs().max())
        log(f"[{label}] 256x256 FPN 32: launches on the card {counts}; valid "
            f"{int(valid_c.sum())} on the CPU, equal slots {bool(torch.equal(valid_g, valid_c))}; "
            f"max |box diff| {box_diff:.3e}, max |mask diff| {mask_diff:.3e}")
        if not (torch.equal(valid_g, valid_c)
                and torch.equal(dets_g.classes.cpu(), dets_c.classes) and box_diff <= 1e-3):
            raise AssertionError("cross-device run: card and CPU disagree")
        return
    for det in (gpu, cpu):
        det.module.load_state_dict(params)

    def stages(det, rois):
        """The FPN levels, each level's objectness and deltas, and the box
        and mask heads' outputs on ``rois``."""
        with torch.no_grad():
            levels = det.module.features(batch["image"].to(det.device))
            scores, deltas = det.module.rpn(levels)
            rois = rois.to(det.device)
            return {"levels": levels, "objectness": scores, "deltas": deltas,
                    "box head": det.module.box(levels, rois),
                    "mask logits": [det.module.mask(levels, rois)]}

    on_card, on_cpu = stages(gpu, dets_c.boxes), stages(cpu, dets_c.boxes)
    rel = {k: [float((g.cpu().float() - c.float()).abs().max() / c.float().abs().max())
               for g, c in zip(on_card[k], on_cpu[k])] for k in on_cpu}
    rate, back = match_rate(dets_c, dets_g), match_rate(dets_g, dets_c)
    log(f"[{label} {dtype}] 256x256 FPN 32: launches on the card {counts}; level dtypes "
        f"{on_card['levels'][0].dtype} / {on_cpu['levels'][0].dtype}; max |card - CPU| / "
        f"max |CPU| (limit {bf16_limit:.0e}): "
        + "; ".join(f"{k} {[f'{r:.2e}' for r in v]}" for k, v in rel.items())
        + f"; valid {int(valid_c.sum())} on the CPU, {int(valid_g.sum())} on the card; the "
        f"CPU's detections found on the card {rate:.3f}, the card's on the CPU {back:.3f}")
    worst = max(max(v) for v in rel.values())
    if not (on_card["levels"][0].dtype == getattr(torch, dtype) and worst <= bf16_limit):
        raise AssertionError(f"cross-device {dtype} run: card and CPU differ by {worst:.3e} "
                             f"of an output's magnitude, beyond {bf16_limit}")
    if as_good_as_cpu:
        # each output's distance from the CPU's float32 one, card bf16 against CPU bf16
        f32 = build_detector(get_config(None, [o for o in cfg_overrides
                                               if not o.startswith("model.dtype")]),
                             device="cpu")
        f32.module.load_state_dict(params)
        on_f32 = stages(f32, dets_c.boxes)

        def dist(side):
            return [float((a.cpu().float() - c.float()).abs().max() / c.float().abs().max())
                    for k in on_f32 for a, c in zip(side[k], on_f32[k])]

        ratio = max(c / max(b, 1e-30) for c, b in zip(dist(on_card), dist(on_cpu)))
        log(f"[{label} {dtype}] distance from the CPU's float32 outputs, the card's bf16 "
            f"against the CPU's bf16: at most x{ratio:.3f} (limit x{CROSS_BF16_AS_GOOD})")
        if not ratio <= CROSS_BF16_AS_GOOD:
            raise AssertionError(f"cross-device {dtype} run: the card's bf16 lies x{ratio:.3f} "
                                 "as far from float32 as the CPU's bf16")


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


def tile_visits(bounds, tile) -> int:
    """From the pre-pass's bounds [B, R, 4]: the (RoI, tile) pairs of
    ``tile`` x ``tile`` cells that K3's bf16 kernel contracts (each once a
    channel slice), a count from the inputs. Its tiles are 8 x 8 cells (256
    channels a block) or 16 x 16 (32), as the block's shared memory allows
    (csrc/roi_align.cu, kWideTile and kTile)."""
    first, last = bounds[..., 0::2].long(), bounds[..., 1::2].long()
    tiles = (torch.div(last, tile, rounding_mode="floor")
             - torch.div(first, tile, rounding_mode="floor") + 1).clamp_min(0)
    return int((tiles[..., 0] * tiles[..., 1] * (last >= 0).all(-1)).sum())


def check_k3_bf16(name, g, level_hw, rois, levels):
    """K3 with a bf16 ``g`` (bf16 level gradients) twice, its bf16 plain
    version, the fp32 kernel on the upcast ``g`` cast once, and K3's bf16
    pre-pass alone, on the same inputs: within one bf16 step plus the fp32
    limit of the plain version and of the fp32 kernel (1e-5 x max |plain
    gradient|: other summation orders, then one rounding); the two runs
    bitwise equal (no atomics); the pre-pass's bounds equal to
    ``roi_tap_cell_bounds``. Returns (max |diff| against the plain version,
    bf16 steps from the fp32 kernel)."""
    from detectron_tpu_torch.ops import roi_align as ra

    p = g.shape[2]
    got = ra.multilevel_roi_align_bwd_cuda(g, level_hw, rois, levels, STRIDES, 2)
    again = ra.multilevel_roi_align_bwd_cuda(g, level_hw, rois, levels, STRIDES, 2)
    want = ra.multilevel_roi_align_bwd_plain(g, level_hw, rois, levels, STRIDES, 2)
    f32 = [x.to(torch.bfloat16) for x in ra.multilevel_roi_align_bwd_cuda(
        g.float(), level_hw, rois, levels, STRIDES, 2)]
    bounds = ra.roi_tap_bounds_cuda(level_hw, rois, levels, STRIDES, p, 2)
    want_bounds = ra.roi_tap_cell_bounds(level_hw, rois, levels, STRIDES, p, 2)
    torch.cuda.synchronize()
    if any(x.dtype != torch.bfloat16 for x in got):
        raise AssertionError(f"K3 bf16 {name}: level gradients {[x.dtype for x in got]}")
    floor = 1e-5 * max(float(w.float().abs().max()) for w in want)
    plain = [within_bf16(x, w, floor) for x, w in zip(got, want)]
    fp32 = [within_bf16(x, w, floor) for x, w in zip(got, f32)]
    diff, ok = max(d for d, _ in plain), all(o for _, o in plain)
    ok32 = all(o for _, o in fp32)
    steps = max(bf16_steps(x, w) for x, w in zip(got, f32))
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    off = int((bounds != want_bounds).any(-1).sum())
    log(f"[K3 bf16 {name}] max |diff| {diff:.3e} from the bf16 plain version (limit: one bf16 "
        f"step + {floor:.3e}): {ok}; from the fp32 kernel on the upcast g cast once: max "
        f"|diff| {max(d for d, _ in fp32):.3e}, within the same limit: {ok32} ({steps} bf16 "
        f"steps at most); two runs bitwise equal: {same}; pre-pass bounds equal to "
        f"roi_tap_cell_bounds: {off == 0} ({off} of {bounds.shape[0] * bounds.shape[1]} RoIs "
        f"differ); (RoI, tile) visits {tile_visits(want_bounds, 8)} of 8x8 tiles, "
        f"{tile_visits(want_bounds, 16)} of 16x16")
    if not (floor > 0.0 and ok and ok32):
        raise AssertionError(f"K3 bf16 {name}: beyond its limit")
    if not same:
        raise AssertionError(f"K3 bf16 {name}: two runs differ")
    if off:
        raise AssertionError(f"K3 bf16 {name}: the pre-pass's bounds differ from "
                             f"roi_tap_cell_bounds for {off} RoIs")
    return diff, steps


def device_kernels(fn) -> list:
    """``(name, launches, device ms)`` of every kernel that one call of
    ``fn()`` runs on the card, from torch.profiler: the call is made twice,
    the first as the profiler's warm-up step (a first traced step can miss
    its first kernel), the second recorded."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    # the step's own range is listed with the device time inside it
    return [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type.name == "CUDA" and not e.key.startswith("ProfilerStep")]


# the kernels of one bf16 K3 call: the pre-pass and the tile kernel, nothing
# else (no fill, no cast pass)
K3_BF16_KERNELS = ("roi_tap_bounds_kernel", "roi_align_backward_tiles_kernel")


def check_k3_bf16_launches(fn, name):
    """Lists the kernels of one bf16 K3 call (``fn``) under the profiler:
    each of K3_BF16_KERNELS once, and nothing else."""
    listing = device_kernels(fn)
    for key, count, ms in listing:
        log(f"[K3 bf16 {name}] profiler: {ms:.4f} ms x{count} {key[:100]}")
    found = sorted(next((k for k in K3_BF16_KERNELS if k in key), key) for key, _, _ in listing)
    if found != sorted(K3_BF16_KERNELS) or any(count != 1 for _, count, _ in listing):
        raise AssertionError(f"K3 bf16 {name}: one call ran {listing}, not the pre-pass and "
                             "the tile kernel once each")


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
        fill_ms = cuda_ms(lambda: ra.level_grad_buffer(b, c, level_hw, dev))
        bufs = ra.level_views(ra.level_grad_buffer(b, c, level_hw, dev), b, c, level_hw)
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
        results.append(dict(case=f"P{p} R{r}", path="train", dtype="float32", ms=ms,
                            fill_ms=fill_ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, max_abs_err=diff,
                            rerun_max_abs_diff=rerun))
        # the bf16 route on the same RoIs and gradient, rounded to bf16: the
        # pre-pass and the tile kernel, timed whole and apart
        g16 = g.bfloat16()
        del g, bufs
        label = f"P={p} R={r} span={span}"
        diff16, steps = check_k3_bf16(label, g16, level_hw, rois, levels)
        check_k3_bf16_launches(lambda: ra.multilevel_roi_align_bwd_cuda(
            g16, level_hw, rois, levels, STRIDES, 2), label)
        ms16 = cuda_ms(lambda: ra.multilevel_roi_align_bwd_cuda(g16, level_hw, rois, levels,
                                                                STRIDES, 2))
        prepass_ms = cuda_ms(lambda: ra.roi_tap_bounds_cuda(level_hw, rois, levels, STRIDES,
                                                            p, 2))
        bounds = ra.roi_tap_bounds_cuda(level_hw, rois, levels, STRIDES, p, 2)
        views = ra.level_views(torch.empty(out_bytes // 4, dtype=torch.bfloat16, device=dev),
                               b, c, level_hw)
        kernel16_ms = cuda_ms(lambda: ra.roi_align_bwd_tiles_cuda(views, bounds, g16, rois,
                                                                  levels, STRIDES, 2))
        # the passes of the earlier bf16 route besides its kernel: the fp32
        # fill (timed above) and the cast of every level to bf16
        flat = ra.level_grad_buffer(b, c, level_hw, dev)
        cast_ms = cuda_ms(lambda: flat.to(torch.bfloat16))
        del flat, views
        plain16_ms = cuda_ms(lambda: ra.multilevel_roi_align_bwd_plain(
            g16, level_hw, rois, levels, STRIDES, 2), iters=5, warmup=1)
        # g read once and every level's gradient written once, at 2 bytes a
        # value, RoIs and routing read once
        nbytes16 = g16.numel() * 2 + out_bytes // 2 + b * r * (16 + 4)
        b16_ms, b16_by = bound_ms(nbytes16, ops=b * r * p * p * c * (4 * 4 * 3 + 1))
        log(f"[K3 P={p} R={r} bfloat16] {ms16:.4f} ms (pre-pass {prepass_ms:.4f} + kernel "
            f"{kernel16_ms:.4f}), plain {plain16_ms:.3f} ms, bound {b16_ms:.4f} ms ({b16_by}, "
            f"{nbytes16 / 1e6:.1f} MB: level gradients {out_bytes / 2e6:.1f}, g "
            f"{g16.numel() * 2 / 1e6:.1f}); (RoI, tile) visits {tile_visits(bounds, 8)} of 8x8 "
            f"tiles, {tile_visits(bounds, 16)} of 16x16; "
            f"the earlier route's passes besides its kernel: fp32 fill {fill_ms:.4f} + cast "
            f"to bf16 {cast_ms:.4f} ms")
        results.append(dict(case=f"P{p} R{r}", path="train", dtype="bfloat16", ms=ms16,
                            prepass_ms=prepass_ms, kernel_ms=kernel16_ms, plain_ms=plain16_ms,
                            bound_ms=b16_ms, bound_by=b16_by, max_abs_err=diff16,
                            fp32_kernel_bf16_steps=steps))
        del g16, bounds
    for kind in K3_STRESS:
        for p in (7, 14):
            rois, levels = k3_stress_rois(rng, kind, b, 128)
            rois = torch.tensor(rois, device=dev)
            levels = (ra.assign_fpn_levels(rois, len(feats), 2, max_span=span)
                      if levels is None else torch.tensor(levels, device=dev))
            g = torch.tensor(rng.randn(b, 128, p, p, c).astype(np.float32), device=dev)
            check_k3(f"stress: {kind}, P={p} R=128", g, level_hw, rois, levels)
            g16 = g.bfloat16()
            check_k3_bf16(f"stress: {kind}, P={p} R=128", g16, level_hw, rois, levels)
            # many RoIs on a few tiles: recorded, not gated
            ms16 = cuda_ms(lambda: ra.multilevel_roi_align_bwd_cuda(g16, level_hw, rois,
                                                                    levels, STRIDES, 2))
            log(f"[K3 bf16 stress: {kind}, P={p} R=128] {ms16:.4f} ms")
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


TRAIN_R101 = os.path.join(REPO, "configs", "mask_rcnn_r101_fpn_coco_train.yaml")


def phase_train(seed=0, warmup=2, steps=5, dtype="float32"):
    """R-101 train_step at full width in ``dtype``: ``warmup`` + ``steps``
    steps, each finite and launching K1 once and K2 and K3 twice (K2 on
    ``dtype`` features, K3 on a ``dtype`` gradient); every trainable
    parameter changed and float32, every frozen one unchanged; the stage
    breakdown, both layouts on the same starting weights, a profiled step;
    in float32 then the train driver. Returns (launches over the timed
    steps, ms a step, a summary of the numbers)."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.train.state import create_train_state, train_step

    cfg = get_config(TRAIN_R101, TRAIN_OVERRIDES + [f"model.dtype={dtype}"])
    state, data = seeded_train_state(cfg, None, seed)  # the card, by default
    det = state.detector
    tag = "train" if dtype == "float32" else f"train {dtype}"
    log(f"[{tag}] {cfg.model.name} {cfg.model.backbone} FPN {cfg.model.fpn_channels} classes "
        f"{cfg.model.num_classes} canvas {tuple(cfg.data.image_size)} {cfg.model.dtype} batch "
        f"{cfg.train.batch_size} base_lr {cfg.train.base_lr} max_gt {cfg.train.max_gt_boxes}, "
        f"convolutions "
        f"{'channels-last' if det.module.memory_format == torch.channels_last else 'NCHW'}")
    named = dict(det.module.named_parameters())
    trainable = [n for n, q in named.items() if q.requires_grad]
    frozen = [n for n, q in named.items() if not q.requires_grad]
    before = {n: q.detach().clone() for n, q in named.items()}
    start = {k: v.clone() for k, v in det.module.state_dict().items()}
    batches = [det.batch_to_device(next(data)) for _ in range(warmup + steps)]

    totals = dict.fromkeys(counted_wrappers(), 0)
    want_dtypes = {"greedy_nms": {"float32"}, "multilevel_roi_align": {dtype},
                   "multilevel_roi_align_bwd": {dtype}}
    times = []
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with kernel_dtypes() as seen:
            metrics = train_step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        losses = {k: float(v) for k, v in metrics.items()}
        step_tag = "warm-up" if i < warmup else "step"
        log(f"[{tag}] {step_tag} {i}: {ms:.1f} ms, launches {counts}, "
            + " ".join(f"{k}={v:.4f}" for k, v in sorted(losses.items())))
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"train step {i}: a loss is not finite: {losses}")
        if not (counts["greedy_nms"] >= 1 and counts["multilevel_roi_align"] == 2
                and counts["multilevel_roi_align_bwd"] == 2):
            raise AssertionError(f"train step {i}: launches {counts}, want K1 >= 1, "
                                 "K2 == 2, K3 == 2")
        if seen != want_dtypes:
            raise AssertionError(f"train step {i}: kernel input dtypes {seen}, want "
                                 f"{want_dtypes}")
        if i >= warmup:
            times.append(ms)
            for name, n in counts.items():
                totals[name] += n
    peak = torch.cuda.max_memory_allocated() / 2**30
    unchanged = [n for n in trainable if torch.equal(named[n].detach(), before[n])]
    moved = [n for n in frozen if not torch.equal(named[n].detach(), before[n])]
    not_fp32 = [n for n, q in named.items()
                if q.dtype != torch.float32 or (q.grad is not None and q.grad.dtype != q.dtype)]
    log(f"[{tag}] {len(trainable)} trainable tensors, {len(unchanged)} unchanged; "
        f"{len(frozen)} frozen (stem, layer1), {len(moved)} changed; parameters or gradients "
        f"not float32: {len(not_fp32)}")
    if unchanged or moved or not frozen or not_fp32:
        raise AssertionError(f"train: trainable unchanged {unchanged[:5]}, frozen moved "
                             f"{moved[:5]}, not float32 {not_fp32[:5]}")
    med = float(np.median(times))
    log(f"[{tag}] per-step ms {[round(t, 3) for t in times]}; median {med:.2f} ms = "
        f"{cfg.train.batch_size * 1e3 / med:.2f} img/s; peak device memory {peak:.2f} GiB")
    parts = train_breakdown(state, batches[-1], tag=tag)
    profile_call(lambda: train_step(state, batches[-1]), f"one train_step, {dtype}")
    del before
    if dtype == "float32":
        phase_driver(state, TRAIN_R101)
    # both layouts from the same starting weights
    det.module.load_state_dict(start)
    fresh = create_train_state(cfg, det)
    layouts = layout_times(det, lambda: train_step(fresh, batches[-1]), f"train {dtype}",
                           calls=6)
    return totals, times, dict(step_ms=times, median_ms=med, peak_gib=peak, stages_ms=parts,
                               **layouts)


def train_breakdown(state, batch, repeats=3, tag="train"):
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
    log(f"[{tag} stages] median of {repeats}, device ms (share of {total:.2f} ms): " + "; ".join(
        f"{n} {t:.3f} ({100 * t / total:.1f}%)" for n, t in parts.items()))
    return parts


def phase_driver(state, config_path, overrides=TRAIN_OVERRIDES):
    """The train driver as a user runs it, resuming (--restore) from a
    checkpoint of ``state`` for 2 more steps on the card, with the config
    at ``config_path`` and ``overrides``."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.train import checkpoint as ckpt
    from detectron_tpu_torch.train import driver

    out = TRAIN_OUT
    shutil.rmtree(out, ignore_errors=True)
    ckpt.save(out, state)
    cfg = get_config(config_path, overrides + [
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


def oracle_predict_on_card(dtype):
    """:func:`oracle_predict` as the model's outputs lie: tensors on the
    card, the scores and mask probabilities in ``dtype`` (both exact in
    bf16: 0.9 rounds to one bf16 value for every detection, the rasters are
    0 or 1), so the driver's fetch of ``dtype`` outputs is what the oracle's
    AP holds."""
    def predict(params, batch):
        dets, masks = oracle_predict(params, batch)
        dev = torch.device(DEVICE)
        return type(dets)(
            boxes=torch.tensor(dets.boxes, device=dev),
            scores=torch.tensor(dets.scores, device=dev).to(dtype),
            classes=torch.tensor(dets.classes, device=dev),
            valid=torch.tensor(dets.valid, device=dev)), torch.tensor(masks, device=dev).to(dtype)

    return predict


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


def phase_eval(seed=0, dtype="float32"):
    """The eval driver as a user runs it, on an in-memory COCO split of 8
    images: Mask R-CNN R-50-FPN at full width in ``dtype``, weights from a
    numpy seed (the cls_score bias raised) restored from a checkpoint in
    its output_dir; Loader -> predict_fn (K1, K2) -> paste + RLE -> box and
    segm COCO metrics. Then a warm timing run over 32 images (8 loader
    threads; in float32 also 1), the loop with an oracle predictor (box AP
    and segm AP50 must be 1.0; its outputs on the card in ``dtype``), in
    float32 once under the profiler, and K2 on the transposed canvas.
    Returns the kernels' launches over the first run and the warm run's
    images/s."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.eval import driver
    from detectron_tpu_torch.models.zoo import build_detector
    from detectron_tpu_torch.train import checkpoint as ckpt
    from detectron_tpu_torch.train.state import create_train_state
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config(MASK_R50, ["train.batch_size=2", "data.orientation_buckets=true",
                                f"output_dir={EVAL_OUT}", f"model.dtype={dtype}"])
    full = dtype == "float32"
    tag = "eval" if full else f"eval {dtype}"
    ds = InMemoryCoco(seed, num_classes=cfg.model.num_classes)
    shutil.rmtree(EVAL_OUT, ignore_errors=True)
    det = build_detector(cfg)
    ckpt.save(EVAL_OUT, create_train_state(
        cfg, det, raise_class_bias(det.init(seed), RAISED_CLASSES)))
    del det
    log(f"[{tag}] {cfg.model.name} {cfg.model.backbone} FPN {cfg.model.fpn_channels} classes "
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
        log(f"[{tag}] restored from {os.path.relpath(EVAL_OUT, REPO)}; {timing['images']} "
            f"images in {timing['batches']} batches; launches {counts}; {n_dets} detections, "
            f"{n_masks} non-empty mask RLEs; scores fetched as "
            f"{sorted({str(d['scores'].dtype) for d in dts})}")
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
        log(f"[{tag}] metrics (random weights): AP {written['AP']}, AP50 {written['AP50']}, "
            f"segm_AP {written['segm_AP']}; "
            f"{sum(v is None for v in written.values())} of {len(written)} null")
        log_eval_timing(f"{dtype} first run" if not full else "first run", timing)
        # warm (both canvases' convolutions set up), over a longer split of
        # the same kind so that the loop is past its start, with the config's
        # loader threads and (float32) with one
        long_ds = InMemoryCoco(seed + 1, EVAL_SIZES * EVAL_WARM_REPEAT, cfg.model.num_classes)
        threads = cfg.data.num_workers
        warm = {}
        for workers in ((threads, 1) if full else (threads,)):
            cfg.data.num_workers = workers
            warm[workers] = driver.run(cfg, dataset=long_ds)["timing"]
            log_eval_timing(f"{'' if full else dtype + ' '}warm, {len(long_ds)} images, loader "
                            f"threads {workers}", warm[workers])
        cfg.data.num_workers = threads

        reset_counts()
        res_o = driver.run(cfg, dataset=ds, restore=False,
                           predict=oracle_predict if full else oracle_predict_on_card(
                               getattr(torch, dtype)))
        reset_counts()
        log(f"[{tag}] oracle predictor: AP {res_o['AP']:.6f}, AP50 {res_o['AP50']:.6f}, "
            f"segm_AP50 {res_o['segm_AP50']:.6f}, segm_AP {res_o['segm_AP']:.6f}")
        if not (abs(res_o["AP"] - 1.0) <= 1e-6 and abs(res_o["segm_AP50"] - 1.0) <= 1e-6):
            raise AssertionError("eval: the oracle predictor does not give box AP and segm "
                                 "AP50 of 1.0")
        if full:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                res_p = driver.run(cfg, dataset=ds)
                torch.cuda.synchronize()
            reset_counts()
    finally:
        driver.merge_across_processes = real_merge
    if full:
        loop_ms, busy_ms, n_events = device_busy_in(prof, driver.LOOP_SPAN)
        batches = res_p["timing"]["batches"]
        if not n_events:
            log("[eval profile] the profiler recorded no device activity in the loop: busy "
                "share not measured")
        else:
            log(f"[eval profile] under the profiler: loop {loop_ms:.1f} ms (the driver's clock: "
                f"{res_p['timing']['loop_s'] * 1e3:.1f}) for {batches} batches, device busy "
                f"{busy_ms:.1f} ms in it ({100 * busy_ms / loop_ms:.1f}% of the loop; "
                f"{busy_ms / batches:.2f} ms busy and {(loop_ms - busy_ms) / batches:.2f} ms "
                f"idle a batch; {n_events} kernels and copies)")
    shutil.rmtree(EVAL_OUT, ignore_errors=True)
    check_transposed_canvas(cfg)
    return counts, warm[threads]["img_per_s"]


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
    check = check_k2
    if cfg.model.dtype != "float32":
        feats, check = [f.to(getattr(torch, cfg.model.dtype)) for f in feats], check_k2_bf16
    fmax = max(float(f.abs().max()) for f in feats)
    span = ra.roi_max_span(cfg, tuple(feats[-1].shape[1:3]))
    for p, r in ((7, cfg.rpn.post_nms_topk_test), (14, cfg.test.detections_per_image)):
        rois = torch.tensor(roi_cases(rng, b, r, (h, w)), device=dev)
        levels = ra.assign_fpn_levels(rois, len(feats), 2, max_span=span)
        check(f"eval B={b} {h}x{w} (transposed canvas) P={p} R={r} span={span}", feats,
              rois, levels, p, fmax)
    reset_counts()


# ---------------------------------------------------------------- phase 12

BENCH_ARGS = ["--iters", "3", "--train-iters", "2"]  # the defaults otherwise


def phase_bench(dtype=None):
    """``python -m detectron_tpu_torch.bench`` at its default shapes (1024x1024,
    inference batch 48, train batch 16), iterations cut, at its default
    dtype (bf16; ``dtype=None``) or ``--dtype dtype``: its JSON line (the
    bench raises if its outputs or losses sum to a non-finite value), every
    kernel's launches over the run, then K1-K3 against their plain versions
    at the bench's shapes, K2 and K3 in the run's dtype. Returns the
    launches and the line."""
    from detectron_tpu_torch import bench

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = bench.parse_args(BENCH_ARGS + ([] if dtype is None else ["--dtype", dtype]))
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
    log(f"[bench {args.dtype}] {time.perf_counter() - t0:.1f} s ({calls} predict calls at "
        f"batch {args.batch}, {steps} train steps at batch {args.train_batch}, warm-ups "
        f"included); launches {counts}; predict outputs and training losses summed finite; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if counts != want:
        raise AssertionError(f"bench: launches {counts}, want {want}")
    if f", {args.dtype}, " not in out["metric"]:
        raise AssertionError(f"bench: the line does not name {args.dtype}: {out['metric']}")
    for key in ("value", "train_img_s_chip", "train_step_ms"):
        if not (np.isfinite(out[key]) and out[key] > 0):
            raise AssertionError(f"bench: {key} = {out[key]}")
    torch.cuda.empty_cache()
    if args.dtype != "float32":
        out = dict(out, **bench_layouts(args))
    check_bench_shapes(args)
    return counts, out


def bench_layouts(args, calls=4) -> dict:
    """Both layouts at the bench's batches, where the device, not the host,
    sets the pace: predict_fn at ``args.batch`` and train_step at
    ``args.train_batch``, on the bench's weights and synthetic batch (its
    ``make_batch`` and ``calibrate_frozen_bn``)."""
    from detectron_tpu_torch import bench
    from detectron_tpu_torch.data.synthetic import make_batch
    from detectron_tpu_torch.models.zoo import build_detector
    from detectron_tpu_torch.train.state import create_train_state, train_step

    cfg = bench.bench_config(args)
    size = int(args.size)
    det = build_detector(cfg)
    det.module.load_state_dict(det.init(0))
    full = make_batch(np.random.RandomState(0), args.batch, (size, size),
                      cfg.model.num_classes)
    tb = args.train_batch or args.batch
    bench.calibrate_frozen_bn(det.module, det.batch_to_device(
        {"image": full["image"][:tb]})["image"])
    params = det.module.state_dict()
    infer = det.batch_to_device({k: full[k] for k in ("image", "image_hw")})
    out = {f"predict_b{args.batch}_{k}": v for k, v in layout_times(
        det, lambda: det.predict_fn(params, infer), f"bench predict {args.dtype} batch "
        f"{args.batch}", calls=calls).items()}
    state = create_train_state(cfg, det, params)
    train = det.batch_to_device({k: v[:tb] for k, v in full.items()})
    out.update({f"train_b{tb}_{k}": v for k, v in layout_times(
        det, lambda: train_step(state, train), f"bench train {args.dtype} batch {tb}",
        calls=calls).items()})
    del det, state, infer, train
    torch.cuda.empty_cache()
    return out


def check_bench_shapes(args, seed=6):
    """K1, K2 and K3 against their plain versions at the shapes that the
    bench's config gives at ``args.size`` x ``args.size``. Inference at
    batch ``args.batch``: the RPN's problems, one an image and level, of
    ``pre_nms_topk_test`` boxes; the detections' one problem an image of
    ``4 x post_nms_topk_test`` candidates; K2 at ``post_nms_topk_test``
    RoIs at P=7 and ``detections_per_image`` at P=14 an image. Training at
    batch ``args.train_batch``: the RPN's problems of ``pre_nms_topk_train``
    boxes, and K2 and K3 at ``batch_per_image`` RoIs at P=7 and its
    foreground share at P=14 an image; K2 and K3 in the bench's dtype. The
    launches here are not counted."""
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
    dtype = getattr(torch, args.dtype)
    k2, k3 = (check_k2, check_k3) if dtype == torch.float32 else (check_k2_bf16, check_k3_bf16)
    span = ra.roi_max_span(cfg, (size // STRIDES[-1], size // STRIDES[-1]))
    pool, mask_pool = cfg.roi.pool_size, cfg.roi.mask_pool_size
    fg = int(round(cfg.roi.batch_per_image * cfg.roi.positive_fraction))
    for batch, cases, backward in (
            (b, ((pool, rpn.post_nms_topk_test), (mask_pool, test.detections_per_image)), False),
            (tb, ((pool, cfg.roi.batch_per_image), (mask_pool, fg)), True)):
        feats = [torch.randn(batch, size // st, size // st, cfg.model.fpn_channels,
                             generator=gen, device=dev).to(dtype) for st in STRIDES]
        fmax = max(float(f.abs().max()) for f in feats)
        level_hw = [tuple(f.shape[1:3]) for f in feats]
        for p, r in cases:
            rois = torch.tensor(roi_cases(rng, batch, r, (size, size)), device=dev)
            levels = ra.assign_fpn_levels(rois, len(feats), 2, max_span=span)
            tag = f"bench B={batch} {size}x{size} P={p} R={r} span={span}"
            k2(tag, feats, rois, levels, p, fmax)
            if backward:
                g = torch.randn(batch, r, p, p, feats[0].shape[-1], generator=gen,
                                device=dev).to(dtype)
                k3(tag, g, level_hw, rois, levels)
                del g
        del feats
        torch.cuda.empty_cache()
    reset_counts()


# ---------------------------------------------------------- phases 13-18: RetinaNet

RETINA_R50 = os.path.join(REPO, "configs", "retinanet_r50_fpn_coco.yaml")
RETINA_RAISED_BIAS = 0.0  # sigmoid 0.5: every raised class's top logits pass the threshold


def raise_retina_bias(params, classes, value=RETINA_RAISED_BIAS):
    """At the prior's bias (-4.6) no logit reaches retinanet.score_thresh:
    raise ``classes`` (1-based) at every anchor, so that the merged NMS
    sees thousands of valid candidates."""
    bias = params["head.cls_score.bias"].clone()
    k = bias.shape[0] // 9
    view = bias.view(-1, k)
    view[:, [c - 1 for c in classes]] = value
    params["head.cls_score.bias"] = bias
    return params


def retina_params(det, images, seed, classes=RAISED_CLASSES):
    """RetinaNet weights from ``Detector.init(seed)``, the frozen BatchNorm
    statistics set from ``images`` (the bench's ``calibrate_frozen_bn``:
    from identity statistics the random backbone's activations grow at
    every residual add, the logits saturate every score at 1.0 and a box
    coordinate's float32 rounding alone exceeds 1e-3), and ``classes``'
    bias raised. A state dict of copies, on the detector's device."""
    from detectron_tpu_torch.bench import calibrate_frozen_bn

    det.module.load_state_dict(det.init(seed))
    calibrate_frozen_bn(det.module, torch.as_tensor(images, device=det.device))
    params = {k: v.clone() for k, v in det.module.state_dict().items()}
    return raise_retina_bias(params, classes)


def retina_stage_breakdown(det, batch, cfg, repeats=3):
    """Device milliseconds of each stage of retinanet_eval_forward (median
    of ``repeats`` after one warm-up), CUDA events between the stage calls;
    returns them and the last repeat's candidates' validity."""
    from detectron_tpu_torch.models import retinanet as rn

    m = det.module
    image_hw = batch["image_hw"]
    anchors = m.anchors(batch["image"].shape[1:3], det.device)
    names = ("backbone+fpn", "head", "per-level top-k + decode", "NMS (K1) + gather")
    samples = {n: [] for n in names}
    with torch.no_grad():
        for _ in range(repeats + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
            ev[0].record()
            levels = m.features(batch["image"])
            ev[1].record()
            outputs = m.head_outputs(levels)
            ev[2].record()
            boxes, logits, classes = rn.retinanet_candidates(outputs, anchors, image_hw, cfg)
            ev[3].record()
            rn.retinanet_detections(boxes, logits, classes, cfg)
            ev[4].record()
            torch.cuda.synchronize()
            for i, n in enumerate(names):
                samples[n].append(ev[i].elapsed_time(ev[i + 1]))
    reset_counts()
    parts = {n: float(np.median(v[1:])) for n, v in samples.items()}
    total = sum(parts.values())
    t = cfg.retinanet.score_thresh
    n_valid = int((logits > float(np.log(t / (1.0 - t)))).sum())
    log(f"[retinanet stages {cfg.model.dtype}] median of {repeats}, device ms (share of "
        f"{total:.2f} ms): " + "; ".join(f"{n} {v:.3f} ({100 * v / total:.1f}%)"
                                         for n, v in parts.items()))
    return parts, n_valid, tuple(logits.shape)


def phase_retinanet(seed=0, calls=3, dtype="float32"):
    """RetinaNet R-50-FPN predict_fn at full width in ``dtype``, on
    :func:`retina_params` weights: ``calls`` calls, each launching K1 once
    on float32 boxes, N = 5 x
    retinanet.pre_nms_topk a problem, one problem an image; detections
    non-empty, scores in [0, 1]; one more call under the sync debug mode;
    the stage breakdown; a profiled call. Returns (launches over the
    calls, ms a call, a summary)."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models.zoo import build_detector

    cfg = get_config(RETINA_R50, [f"model.dtype={dtype}"])
    det = build_detector(cfg)
    batch = slice_inputs(cfg, seed, det.device)
    params = retina_params(det, batch["image"], seed)
    b = batch["image"].shape[0]
    n_want = 5 * cfg.retinanet.pre_nms_topk
    tag = f"retinanet {dtype}"
    log(f"[{tag}] {cfg.model.name} {cfg.model.backbone} FPN {cfg.model.fpn_channels} classes "
        f"{cfg.model.num_classes} canvas {tuple(cfg.data.image_size)} batch {b}, "
        f"pre_nms_topk {cfg.retinanet.pre_nms_topk} a level, frozen BN calibrated, raised "
        f"classes {RAISED_CLASSES} (cls_score bias {RETINA_RAISED_BIAS}), convolutions "
        f"{'channels-last' if det.module.memory_format == torch.channels_last else 'NCHW'}")
    totals = dict.fromkeys(counted_wrappers(), 0)
    times = []
    for call in range(calls):
        torch.cuda.synchronize()
        reset_counts()
        shapes = {}
        t0 = time.perf_counter()
        with kernel_dtypes(shapes) as seen:
            dets, masks = det.predict_fn(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        log(f"[{tag}] call {call}: {times[-1]:.1f} ms, launches {counts}, K1 boxes "
            f"{shapes.get('greedy_nms')} {sorted(seen.get('greedy_nms', ()))}")
        if counts != {"greedy_nms": 1, "multilevel_roi_align": 0,
                      "multilevel_roi_align_bwd": 0}:
            raise AssertionError(f"RetinaNet predict_fn call {call}: launches {counts}, want "
                                 "K1 once, K2 and K3 never")
        if shapes != {"greedy_nms": [(b, n_want, 4)]} or seen != {"greedy_nms": {"float32"}}:
            raise AssertionError(f"RetinaNet predict_fn call {call}: K1 handed {shapes} "
                                 f"{seen}, want float32 boxes ({b}, {n_want}, 4)")
        for name, n in counts.items():
            totals[name] += n
    issue_ms, done_ms = check_no_host_sync(lambda: det.predict_fn(params, batch),
                                           "RetinaNet predict_fn", tag)
    det.module.load_state_dict(params)
    parts, n_valid, cand_shape = retina_stage_breakdown(det, batch, cfg)
    n_dets = int(dets.valid.sum())
    log(f"[{tag}] merged candidates {cand_shape}, {n_valid} above the score threshold; "
        f"detections valid {n_dets}, classes {sorted(set(dets.classes[dets.valid].tolist()))}")
    if masks is not None or not (n_valid > 0 and n_dets > 0):
        raise AssertionError("RetinaNet: masks returned, or no candidate or detection")
    if tuple(dets.boxes.shape) != (b, cfg.test.detections_per_image, 4):
        raise AssertionError(f"RetinaNet detections shape {tuple(dets.boxes.shape)}")
    if (dets.boxes.dtype, dets.scores.dtype) != (torch.float32, det.dtype):
        raise AssertionError(f"RetinaNet output dtypes {dets.boxes.dtype} {dets.scores.dtype}")
    scores = dets.scores[dets.valid].float()
    if not (bool(torch.isfinite(dets.boxes).all()) and float(scores.min()) >= 0.0
            and float(scores.max()) <= 1.0):
        raise AssertionError("RetinaNet: non-finite boxes or scores outside [0, 1]")
    log(f"[{tag}] per-call ms {[round(t, 3) for t in times]}; scores in "
        f"[{float(scores.min()):.4f}, {float(scores.max()):.4f}]; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_call(lambda: det.predict_fn(params, batch), f"one RetinaNet predict_fn, {dtype}")
    return totals, times, dict(call_ms=times, issue_ms=issue_ms, done_ms=done_ms,
                               stages_ms=parts, candidates_valid=n_valid)


# the canvases of phase 14: every level even, and odd levels (C5 5x7, P6 3x4)
RETINA_CROSS_CANVASES = ((256, 256), (160, 224))
# phase 14's limit on the float32 levels and head outputs, card against CPU,
# as a share of the output's magnitude: 30x under the bf16 limit, and room
# for cuDNN's float32 engines (FFT, Winograd), which sum otherwise than the
# CPU's direct convolution
CROSS_F32 = 1e-3


def phase_cross_retinanet(seed=3, dtype="float32"):
    """RetinaNet at small widths on the card and on the CPU (K1's plain
    version) with the same weights, at each of RETINA_CROSS_CANVASES: the
    FPN levels and head outputs within CROSS_F32 (bf16: CROSS_BF16) of
    their magnitude; the post-process on the same head outputs (the
    card's) on both devices: equal valid slots and classes, boxes within
    1e-3; predict_fn end to end on both, K1 launched once on the card, the
    share of the CPU's detections found on the card logged. (End to end the
    detections are not compared slot for slot: the raised classes' scores
    crowd into a narrow band, 0.82-0.87 at full width, and the card's and
    the CPU's float32 sums reorder near-ties there.) The frozen BatchNorm
    keeps the identity statistics of ``Detector.init``, as in phase 6: set
    from the batch (:func:`retina_params`), it subtracts means much larger
    than the spread, and bf16 against float32 on the CPU alone then reads
    40-70% of a level's magnitude, against 1.4-1.8% with identity
    statistics."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models import retinanet as rn
    from detectron_tpu_torch.models.zoo import build_detector

    limit = CROSS_F32 if dtype == "float32" else CROSS_BF16
    tag = "cross retinanet" if dtype == "float32" else f"cross retinanet {dtype}"
    for canvas in RETINA_CROSS_CANVASES:
        cfg = get_config(None, [
            "model.name=retinanet", "model.num_classes=5", "model.fpn_channels=32",
            f"data.image_size=[{canvas[0]}, {canvas[1]}]", "retinanet.pre_nms_topk=200",
            "test.detections_per_image=20", f"model.dtype={dtype}"])
        gpu, cpu = build_detector(cfg), build_detector(cfg, device="cpu")
        batch = slice_inputs(cfg, seed, "cpu")
        params = raise_retina_bias(cpu.init(seed), (1, 3))
        reset_counts()
        dets_g, _ = gpu.predict_fn(params, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        dets_c, _ = cpu.predict_fn(params, batch)
        reset_counts()
        if counts["greedy_nms"] != 1 or int(dets_c.valid.sum()) == 0:
            raise AssertionError(f"cross-device RetinaNet {canvas}: launches {counts}, "
                                 f"{int(dets_c.valid.sum())} detections on the CPU")
        outs = {}
        for name, det in (("cpu", cpu), ("card", gpu)):  # the card pools the CPU's RoIs
            det.module.load_state_dict(params)
            with torch.no_grad():
                levels = det.module.features(batch["image"].to(det.device))
                heads = det.module.head_outputs(levels)
            outs[name] = {"levels": levels, "class logits": [h[0] for h in heads],
                          "deltas": [h[1] for h in heads]}
        rel = {k: [float((g.cpu().float() - c.float()).abs().max() / c.float().abs().max())
                   for g, c in zip(outs["card"][k], outs["cpu"][k])] for k in outs["cpu"]}
        worst = max(max(v) for v in rel.values())
        # the post-process on the card's head outputs, on the card and on the CPU
        heads_g = list(zip(outs["card"]["class logits"], outs["card"]["deltas"]))
        with torch.no_grad():
            reset_counts()
            post_g = rn.retinanet_inference(heads_g, gpu.module.anchors(canvas, gpu.device),
                                            batch["image_hw"].to(gpu.device), cfg)
            torch.cuda.synchronize()
            post_counts = read_counts()
            post_c = rn.retinanet_inference([(c.cpu(), b.cpu()) for c, b in heads_g],
                                            cpu.module.anchors(canvas, "cpu"),
                                            batch["image_hw"], cfg)
        reset_counts()
        same_slots = (torch.equal(post_g.valid.cpu(), post_c.valid)
                      and torch.equal(post_g.classes.cpu(), post_c.classes))
        box_diff = float((post_g.boxes.cpu() - post_c.boxes).abs().max())
        log(f"[{tag}] {canvas[0]}x{canvas[1]} FPN 32: launches on the card {counts}; max "
            f"|card - CPU| / max |CPU| (limit {limit:.0e}): "
            + "; ".join(f"{k} {[f'{r:.2e}' for r in v]}" for k, v in rel.items())
            + f"; post-process on the same head outputs (K1 launches {post_counts}): valid "
            f"{int(post_c.valid.sum())}, equal slots and classes {same_slots}, max |box diff| "
            f"{box_diff:.3e}; end to end the CPU's detections found on the card "
            f"{match_rate(dets_c, dets_g):.3f}, the card's on the CPU "
            f"{match_rate(dets_g, dets_c):.3f}")
        if not (outs["card"]["levels"][0].dtype == getattr(torch, dtype) and worst <= limit):
            raise AssertionError(f"cross-device RetinaNet {dtype} {canvas}: card and CPU "
                                 f"differ by {worst:.3e} of an output's magnitude")
        if not (same_slots and box_diff <= 1e-3 and post_counts["greedy_nms"] == 1
                and int(post_c.valid.sum()) > 0):
            raise AssertionError(f"cross-device RetinaNet {dtype} {canvas}: the post-process "
                                 "on the same head outputs disagrees between card and CPU")


# From random weights (frozen BN calibrated) RetinaNet's focal loss over every
# anchor and class drives SGD at train.base_lr=0.0025 to NaN: at step 2 at
# 1024x1344 on the card, at step 5 at 512x672 on the CPU (and at step 5 with
# the linearly scaled 0.00125). optax's global-norm clip at 1.0 (the JAX
# config's train.grad_clip_norm) keeps those steps finite.
RETINA_TRAIN_OVERRIDES = TRAIN_OVERRIDES + ["train.grad_clip_norm=1.0"]


def phase_retinanet_train(seed=0, warmup=2, steps=3, dtype="float32"):
    """RetinaNet R-50-FPN train_step at full width in ``dtype`` (1024x1344,
    batch 2): ``warmup`` + ``steps`` steps, each finite and launching no
    kernel (RetinaNet's training pools no RoIs and runs no NMS); every
    trainable parameter changed and float32, every frozen one unchanged;
    the stage breakdown; in float32 then the train driver. Returns
    (launches over the timed steps, ms a step, a summary)."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.train.state import train_step

    cfg = get_config(RETINA_R50, RETINA_TRAIN_OVERRIDES + [f"model.dtype={dtype}"])
    state, data = seeded_train_state(cfg, None, seed)
    det = state.detector
    tag = f"retinanet train {dtype}"
    log(f"[{tag}] {cfg.model.name} {cfg.model.backbone} FPN {cfg.model.fpn_channels} classes "
        f"{cfg.model.num_classes} canvas {tuple(cfg.data.image_size)} batch "
        f"{cfg.train.batch_size} base_lr {cfg.train.base_lr} grad_clip_norm "
        f"{cfg.train.grad_clip_norm}")
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
        log(f"[{tag}] {'warm-up' if i < warmup else 'step'} {i}: {ms:.1f} ms, launches "
            f"{counts}, " + " ".join(f"{k}={v:.4f}" for k, v in sorted(losses.items())))
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"RetinaNet train step {i}: a loss is not finite: {losses}")
        if any(counts.values()):
            raise AssertionError(f"RetinaNet train step {i}: launches {counts}, want none")
        if i >= warmup:
            times.append(ms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    unchanged = [n for n in trainable if torch.equal(named[n].detach(), before[n])]
    moved = [n for n in frozen if not torch.equal(named[n].detach(), before[n])]
    not_fp32 = [n for n, q in named.items()
                if q.dtype != torch.float32 or (q.grad is not None and q.grad.dtype != q.dtype)]
    log(f"[{tag}] {len(trainable)} trainable tensors, {len(unchanged)} unchanged; "
        f"{len(frozen)} frozen, {len(moved)} changed; parameters or gradients not float32: "
        f"{len(not_fp32)}")
    if unchanged or moved or not frozen or not_fp32:
        raise AssertionError(f"RetinaNet train: trainable unchanged {unchanged[:5]}, frozen "
                             f"moved {moved[:5]}, not float32 {not_fp32[:5]}")
    del before
    med = float(np.median(times))
    log(f"[{tag}] per-step ms {[round(t, 3) for t in times]}; median {med:.2f} ms = "
        f"{cfg.train.batch_size * 1e3 / med:.2f} img/s; peak device memory {peak:.2f} GiB")
    parts = train_breakdown(state, batches[-1], tag=tag)
    if dtype == "float32":
        phase_driver(state, RETINA_R50, RETINA_TRAIN_OVERRIDES)
    return totals, times, dict(step_ms=times, median_ms=med, peak_gib=peak, stages_ms=parts)


def retina_oracle(params, batch):
    """:func:`oracle_predict`'s detections, without masks (RetinaNet's)."""
    return oracle_predict(params, batch)[0], None


def phase_retinanet_eval(seed=0, dtype="float32"):
    """Phase 16: :func:`box_eval` with RetinaNet R-50-FPN, K1 once a call."""
    return box_eval("retinanet", "RetinaNet", RETINA_R50, retina_params, 1, seed, dtype)


def box_eval(name, label, config, make_params, k1_per_call, seed=0, dtype="float32"):
    """The eval driver with the box-only model of ``config`` in ``dtype``
    over phase 11's in-memory COCO split (orientation buckets, batch 2,
    ``make_params``' raised-bias weights restored from a checkpoint; the
    long side capped at the canvas', which R-FCN's 1024x1024 canvas needs:
    the default 800/1333 resize makes a 4:3 image 800x1067): every image
    consumed once, K1 ``k1_per_call`` times a predict call, box metrics
    only, finite or null; then a warm run (images/s) and the oracle
    predictor (box AP 1.0). Returns the launches over the first run and the
    warm run's images/s."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.eval import driver
    from detectron_tpu_torch.models.zoo import build_detector
    from detectron_tpu_torch.train import checkpoint as ckpt
    from detectron_tpu_torch.train.state import create_train_state

    cfg = get_config(config, ["train.batch_size=2", "data.orientation_buckets=true",
                              f"output_dir={EVAL_OUT}", f"model.dtype={dtype}"])
    cfg.data.max_size = min(cfg.data.max_size, max(cfg.data.image_size))
    tag = f"{name} eval {dtype}"
    ds = InMemoryCoco(seed, num_classes=cfg.model.num_classes)
    shutil.rmtree(EVAL_OUT, ignore_errors=True)
    det = build_detector(cfg)
    images = slice_inputs(cfg, seed, det.device)["image"]  # noise on the canvas
    ckpt.save(EVAL_OUT, create_train_state(cfg, det, make_params(det, images, seed)))
    del det
    torch.cuda.synchronize()
    reset_counts()
    res = driver.run(cfg, dataset=ds)
    torch.cuda.synchronize()
    counts = read_counts()
    timing = res.pop("timing")
    log(f"[{tag}] {timing['images']} images in {timing['batches']} batches; launches "
        f"{counts}; {timing['detections']} detections")
    calls = timing["batches"]
    if timing["images"] != len(ds):
        raise AssertionError(f"{label} eval: {timing['images']} images, want {len(ds)}")
    if counts != {"greedy_nms": k1_per_call * calls, "multilevel_roi_align": 0,
                  "multilevel_roi_align_bwd": 0}:
        raise AssertionError(f"{label} eval: launches {counts} over {calls} predict calls, "
                             f"want K1 {k1_per_call} times a call, K2 and K3 never")
    with open(os.path.join(EVAL_OUT, "eval_results.json")) as f:
        written = json.load(f)
    bad = {k: v for k, v in written.items() if not (v is None or np.isfinite(v))}
    if bad or "segm_AP" in written or not timing["detections"]:
        raise AssertionError(f"{label} eval: metrics not finite or null, segm present, or "
                             f"no detection: {written}")
    log(f"[{tag}] metrics (random weights): AP {written['AP']}, AP50 {written['AP50']}; "
        f"{sum(v is None for v in written.values())} of {len(written)} null")
    log_eval_timing(f"{name} {dtype} first run", timing)
    warm = driver.run(cfg, dataset=ds)["timing"]
    log_eval_timing(f"{name} {dtype} warm, {len(ds)} images", warm)
    reset_counts()
    res_o = driver.run(cfg, dataset=ds, restore=False, predict=retina_oracle)
    reset_counts()
    log(f"[{tag}] oracle predictor: AP {res_o['AP']:.6f}, AP50 {res_o['AP50']:.6f}")
    if not abs(res_o["AP"] - 1.0) <= 1e-6 or "segm_AP" in res_o:
        raise AssertionError(f"{label} eval: the oracle predictor does not give box AP 1.0")
    shutil.rmtree(EVAL_OUT, ignore_errors=True)
    return counts, warm["img_per_s"]


# batch 8 for both halves (the bench's defaults, 48 and 16, are Mask R-CNN's);
# the gradient clip of phase 15, without which SGD from random weights
# reaches NaN within the bench's steps
RETINA_BENCH_ARGS = ["--model", "retinanet", "--batch", "8", "--train-batch", "8",
                     "--iters", "3", "--train-iters", "2", "--set", "train.grad_clip_norm=1.0"]


def box_bench(name, label, base_args, k1_per_call, k1_per_step, dtype=None):
    """``python -m detectron_tpu_torch.bench`` with ``base_args`` at the
    bench's default dtype (bf16) or ``--dtype dtype``: its JSON line, K1
    launched ``k1_per_call`` times a predict call and ``k1_per_step`` times
    a train step, K2 and K3 never. Returns the launches, the line and the
    parsed arguments."""
    from detectron_tpu_torch import bench

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = bench.parse_args(base_args + ([] if dtype is None else ["--dtype", dtype]))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = bench.run(args)
    torch.cuda.synchronize()
    counts = read_counts()
    reset_counts()
    calls, steps = bench.WARMUP + args.iters, bench.WARMUP + args.train_iters
    want = k1_per_call * calls + k1_per_step * steps
    log(f"[{name} bench {args.dtype}] {time.perf_counter() - t0:.1f} s ({calls} predict "
        f"calls at batch {args.batch}, {steps} train steps at batch {args.train_batch}); "
        f"launches {counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if counts != {"greedy_nms": want, "multilevel_roi_align": 0,
                  "multilevel_roi_align_bwd": 0}:
        raise AssertionError(f"{label} bench: launches {counts}, want K1 {want} times")
    if not out["metric"].startswith(f"{name} ") or f", {args.dtype}, " not in out["metric"]:
        raise AssertionError(f"{label} bench: the line does not name the run: {out['metric']}")
    for key in ("value", "train_img_s_chip", "train_step_ms"):
        if not (np.isfinite(out[key]) and out[key] > 0):
            raise AssertionError(f"{label} bench: {key} = {out[key]}")
    torch.cuda.empty_cache()
    return counts, out, args


def phase_retinanet_bench(dtype=None):
    """Phase 17: :func:`box_bench` with ``--model retinanet`` (K1 once a
    predict call, never in training), then K1 against its plain version
    (and timed) at the bench's shape: G = batch problems of 5 x
    pre_nms_topk class-shifted boxes. Returns the launches, the line and
    K1's case."""
    from detectron_tpu_torch import bench

    counts, out, args = box_bench("retinanet", "RetinaNet", RETINA_BENCH_ARGS, 1, 0, dtype)
    cfg = bench.bench_config(args)
    case = nms_case(np.random.RandomState(8), dict(
        name=f"retinanet bench {args.dtype}", g=args.batch, n=5 * cfg.retinanet.pre_nms_topk,
        thresh=cfg.retinanet.nms_thresh, max_out=cfg.test.detections_per_image,
        n_invalid=cfg.retinanet.pre_nms_topk, classes=cfg.model.num_classes,
        path="retinanet bench"), size=(int(args.size), int(args.size)))
    return counts, out, case


DEMO_OUT = os.path.join(REPO, "build", "demo_smoke")
DEMO_ARGS = ["--no-restore", "--config", RETINA_R50, "--cfg", f"output_dir={DEMO_OUT}"]


def phase_demo(args=None):
    """``python -m detectron_tpu_torch.demo --no-restore`` with ``args``
    (RetinaNet's config by default; R-FCN's in phase 22), as a user runs
    it, on the card: it writes its two synthetic images (PNG)."""
    shutil.rmtree(DEMO_OUT, ignore_errors=True)
    cmd = [sys.executable, "-m", "detectron_tpu_torch.demo", "--out", DEMO_OUT,
           *(DEMO_ARGS if args is None else args)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    files = sorted(os.listdir(DEMO_OUT)) if os.path.isdir(DEMO_OUT) else []
    log(f"[demo] {' '.join(os.path.relpath(c, REPO) if c.startswith(REPO) else c for c in cmd[1:])}"
        f": exit {res.returncode} in {time.perf_counter() - t0:.1f} s; wrote {files}; "
        + " | ".join(res.stdout.strip().splitlines()[-2:]))
    if res.returncode != 0:
        raise AssertionError(f"the demo failed: {res.stderr[-2000:]}")
    want = ["synthetic_0.png", "synthetic_1.png"]
    if files != want:
        raise AssertionError(f"the demo wrote {files}; want {want}")
    for name in files:
        with open(os.path.join(DEMO_OUT, name), "rb") as f:
            head = f.read(24)
        w, h = int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")
        log(f"[demo] {name}: PNG {w}x{h}")
        if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR" or not (w and h):
            raise AssertionError(f"the demo's {name} is not a PNG image: {head!r}")
    shutil.rmtree(DEMO_OUT, ignore_errors=True)


# --------------------------------------------------------- phases 19-22: R-FCN

RFCN_R50 = os.path.join(REPO, "configs", "rfcn_r50_coco.yaml")
RFCN_RAISED_BIAS = 6.0  # ps_cls bias of RAISED_CLASSES in every group


def raise_rfcn_bias(params, classes, num_classes, value=RFCN_RAISED_BIAS):
    """Random-init votes give every class ~1/K, under test.score_thresh:
    raise ``classes`` in each of the P*P groups of ``num_classes`` channels
    of ``ps_cls``, so that the vote, their mean, is raised by ``value``."""
    bias = params["ps_cls.bias"].clone()
    bias.view(-1, num_classes)[:, list(classes)] = value
    params["ps_cls.bias"] = bias
    return params


def rfcn_params(det, images, seed, classes=RAISED_CLASSES):
    """R-FCN weights from ``Detector.init(seed)``, the frozen BatchNorm
    statistics set from ``images`` (:func:`retina_params`' reason: with
    identity statistics the random backbone's activations grow at every
    residual add), and ``classes``' ``ps_cls`` bias raised. A state dict of
    copies, on the detector's device."""
    from detectron_tpu_torch.bench import calibrate_frozen_bn

    det.module.load_state_dict(det.init(seed))
    calibrate_frozen_bn(det.module, torch.as_tensor(images, device=det.device))
    params = {k: v.clone() for k, v in det.module.state_dict().items()}
    return raise_rfcn_bias(params, classes, det.cfg.model.num_classes)


def rfcn_stage_breakdown(det, batch, cfg, repeats=3):
    """Device milliseconds of each stage of rfcn_eval_forward (median of
    ``repeats`` after one warm-up), CUDA events between the stage calls;
    returns them and the last repeat's proposals."""
    from detectron_tpu_torch.models import faster_rcnn as fr

    m = det.module
    image_hw = batch["image_hw"]
    anchors = m.anchors(batch["image"].shape[1:3], det.device)
    names = ("backbone+trunk", "rpn head", "proposals (K1)", "ps maps", "psroipool + vote",
             "detections (K1)")
    samples = {n: [] for n in names}
    with torch.no_grad():
        for _ in range(repeats + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
            ev[0].record()
            feat = m.features(batch["image"])
            ev[1].record()
            scores, deltas = m.rpn(feat)
            ev[2].record()
            props = fr.proposals_from_rpn(scores, deltas, anchors, image_hw, cfg)
            ev[3].record()
            table = m.ps_maps(feat)
            ev[4].record()
            cls_logits, reg = m.vote(table, props.boxes)
            ev[5].record()
            fr.fastrcnn_inference(cls_logits, reg, props.boxes, props.valid, image_hw, cfg)
            ev[6].record()
            torch.cuda.synchronize()
            for i, n in enumerate(names):
                samples[n].append(ev[i].elapsed_time(ev[i + 1]))
    reset_counts()
    parts = {n: float(np.median(v[1:])) for n, v in samples.items()}
    total = sum(parts.values())
    log(f"[rfcn stages {cfg.model.dtype}] median of {repeats}, device ms (share of "
        f"{total:.2f} ms): " + "; ".join(f"{n} {v:.3f} ({100 * v / total:.1f}%)"
                                         for n, v in parts.items()))
    return parts, props, tuple(table.shape)


def time_ps_roi_pool(table, rois, cfg, tag):
    """PSRoIPool (plain PyTorch) on the card at the main path's shapes: the
    forward, and the forward with its gradient (autograd), device ms."""
    from detectron_tpu_torch.models.rfcn import RFCN_STRIDE
    from detectron_tpu_torch.ops.ps_roi_pool import ps_roi_pool

    p, s = cfg.roi.pool_size, cfg.roi.sampling_ratio
    table = table.detach()
    fwd = cuda_ms(lambda: ps_roi_pool(table, rois, RFCN_STRIDE, p, s), iters=10)
    leaf = table.clone().requires_grad_(True)
    g = torch.ones(rois.shape[:2] + (p, p, table.shape[-1] // (p * p)), device=table.device)

    def fwd_bwd():
        ps_roi_pool(leaf, rois, RFCN_STRIDE, p, s).backward(g)
        leaf.grad = None

    both = cuda_ms(fwd_bwd, iters=10)
    log(f"[{tag} psroipool] table {tuple(table.shape)} float32, RoIs {tuple(rois.shape)}, "
        f"P={p} S={s}: forward {fwd:.4f} ms, forward + gradient {both:.4f} ms (plain PyTorch, "
        f"no kernel)")
    return {"fwd_ms": fwd, "fwd_bwd_ms": both, "table": list(table.shape),
            "rois": list(rois.shape)}


def phase_rfcn(seed=0, calls=3, dtype="float32"):
    """R-FCN R-50 predict_fn at full width (configs/rfcn_r50_coco.yaml:
    trunk 1024, 81 classes, P=7, 1024x1024, batch 2) in ``dtype``, on
    :func:`rfcn_params` weights: ``calls`` calls, each launching K1 twice on
    float32 boxes (proposals: G=2, N=rpn.pre_nms_topk_test; detections:
    G=2, N=4 x rpn.post_nms_topk_test) and K2, K3 never; detections
    non-empty, scores in [0, 1]; one more call under the sync debug mode;
    the stage breakdown; PSRoIPool timed; a profiled call. Returns
    (launches over the calls, ms a call, a summary)."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models.zoo import build_detector

    cfg = get_config(RFCN_R50, [f"model.dtype={dtype}"])
    torch.cuda.reset_peak_memory_stats()
    det = build_detector(cfg)
    batch = slice_inputs(cfg, seed, det.device)
    params = rfcn_params(det, batch["image"], seed)
    b = batch["image"].shape[0]
    want_shapes = [(b, cfg.rpn.pre_nms_topk_test, 4), (b, 4 * cfg.rpn.post_nms_topk_test, 4)]
    tag = f"rfcn {dtype}"
    log(f"[{tag}] {cfg.model.name} {cfg.model.backbone} trunk {cfg.model.fpn_channels} "
        f"(dilate_c5 {cfg.model.dilate_c5}) classes {cfg.model.num_classes} P "
        f"{cfg.roi.pool_size} canvas {tuple(cfg.data.image_size)} batch {b}, frozen BN "
        f"calibrated, raised classes {RAISED_CLASSES} (ps_cls bias {RFCN_RAISED_BIAS}), "
        f"convolutions "
        f"{'channels-last' if det.module.memory_format == torch.channels_last else 'NCHW'}")
    totals = dict.fromkeys(counted_wrappers(), 0)
    times = []
    for call in range(calls):
        torch.cuda.synchronize()
        reset_counts()
        shapes = {}
        t0 = time.perf_counter()
        with kernel_dtypes(shapes) as seen:
            dets, masks = det.predict_fn(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        log(f"[{tag}] call {call}: {times[-1]:.1f} ms, launches {counts}, K1 boxes "
            f"{shapes.get('greedy_nms')} {sorted(seen.get('greedy_nms', ()))}")
        if counts != {"greedy_nms": 2, "multilevel_roi_align": 0,
                      "multilevel_roi_align_bwd": 0}:
            raise AssertionError(f"R-FCN predict_fn call {call}: launches {counts}, want K1 "
                                 "twice, K2 and K3 never")
        if shapes != {"greedy_nms": want_shapes} or seen != {"greedy_nms": {"float32"}}:
            raise AssertionError(f"R-FCN predict_fn call {call}: K1 handed {shapes} {seen}, "
                                 f"want float32 boxes {want_shapes}")
        for name, n in counts.items():
            totals[name] += n
    issue_ms, done_ms = check_no_host_sync(lambda: det.predict_fn(params, batch),
                                           "R-FCN predict_fn", tag)
    det.module.load_state_dict(params)
    parts, props, table_shape = rfcn_stage_breakdown(det, batch, cfg)
    with torch.no_grad():
        table = det.module.ps_maps(det.module.features(batch["image"]))
    pool_ms = time_ps_roi_pool(table, props.boxes.contiguous(), cfg, tag)
    del table
    n_props, n_dets = int(props.valid.sum()), int(dets.valid.sum())
    log(f"[{tag}] PS table {table_shape}; proposals valid {n_props}; detections valid "
        f"{n_dets}, classes {sorted(set(dets.classes[dets.valid].tolist()))}")
    if masks is not None or not (n_props > 0 and n_dets > 0):
        raise AssertionError("R-FCN: masks returned, or no proposal or detection")
    if tuple(dets.boxes.shape) != (b, cfg.test.detections_per_image, 4):
        raise AssertionError(f"R-FCN detections shape {tuple(dets.boxes.shape)}")
    if (dets.boxes.dtype, dets.scores.dtype) != (torch.float32, torch.float32):
        raise AssertionError(f"R-FCN output dtypes {dets.boxes.dtype} {dets.scores.dtype}: "
                             "the vote is float32 in both dtypes")
    scores = dets.scores[dets.valid]
    if not (bool(torch.isfinite(dets.boxes).all()) and float(scores.min()) >= 0.0
            and float(scores.max()) <= 1.0):
        raise AssertionError("R-FCN: non-finite boxes or scores outside [0, 1]")
    log(f"[{tag}] per-call ms {[round(t, 3) for t in times]}; scores in "
        f"[{float(scores.min()):.4f}, {float(scores.max()):.4f}]; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_call(lambda: det.predict_fn(params, batch), f"one R-FCN predict_fn, {dtype}")
    return totals, times, dict(call_ms=times, issue_ms=issue_ms, done_ms=done_ms,
                               stages_ms=parts, psroipool=pool_ms)


RFCN_CROSS_CANVAS = (256, 256)
# PSRoIPool's full-width shapes in phase 20: R-FCN's table at 1024x1024
# (stride 16, P*P x (81 + 4) channels) and rpn.post_nms_topk_test RoIs
PS_TABLE = (2, 64, 64, 7 * 7 * 85)
PS_ROIS = 300


def phase_cross_rfcn(seed=4, dtype="float32"):
    """R-FCN at 256x256 with small widths (trunk 32, 5 classes) on the card
    and on the CPU (K1's plain version) with the same weights, with the C4
    trunk and with ``model.dilate_c5``: the trunk, the RPN outputs and the
    votes on the same RoIs (the CPU's proposals) within CROSS_F32 (bf16:
    CROSS_BF16) of their magnitude; predict_fn on the card launches K1
    twice. In float32 also PSRoIPool alone at R-FCN's full-width shapes
    (PS_TABLE, PS_ROIS RoIs an image): its forward and its
    gradient through autograd, card against CPU, within 1e-5 of their
    magnitude. Identity frozen BatchNorm, as in phases 6 and 14."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models import faster_rcnn as fr
    from detectron_tpu_torch.models.rfcn import RFCN_STRIDE
    from detectron_tpu_torch.models.zoo import build_detector
    from detectron_tpu_torch.ops.ps_roi_pool import ps_roi_pool

    limit = CROSS_F32 if dtype == "float32" else CROSS_BF16
    tag = "cross rfcn" if dtype == "float32" else f"cross rfcn {dtype}"
    for dilate in (False, True):
        cfg = get_config(None, [
            "model.name=rfcn", "model.num_classes=5", "model.fpn_channels=32",
            f"data.image_size=[{RFCN_CROSS_CANVAS[0]}, {RFCN_CROSS_CANVAS[1]}]",
            "rpn.pre_nms_topk_test=300", "rpn.post_nms_topk_test=100",
            "test.detections_per_image=20", f"model.dilate_c5={str(dilate).lower()}",
            f"model.dtype={dtype}"])
        gpu, cpu = build_detector(cfg), build_detector(cfg, device="cpu")
        batch = slice_inputs(cfg, seed, "cpu")
        params = raise_rfcn_bias(cpu.init(seed), (1, 3), cfg.model.num_classes, value=1.0)
        reset_counts()
        gpu.predict_fn(params, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        reset_counts()
        outs = {}
        for name, det in (("cpu", cpu), ("card", gpu)):  # the card pools the CPU's RoIs
            det.module.load_state_dict(params)
            with torch.no_grad():
                feat = det.module.features(batch["image"].to(det.device))
                scores, deltas = det.module.rpn(feat)
                if name == "cpu":
                    rois = fr.proposals_from_rpn(
                        scores, deltas, cpu.module.anchors(RFCN_CROSS_CANVAS, "cpu"),
                        batch["image_hw"], cfg).boxes
                cls_logits, reg = det.module.box(feat, rois.to(det.device))
            outs[name] = {"trunk": feat, "objectness": scores[0], "deltas": deltas[0],
                          "class votes": cls_logits, "box votes": reg}
        reset_counts()
        rel = {k: float((outs["card"][k].cpu().float() - v.float()).abs().max()
                        / v.float().abs().max()) for k, v in outs["cpu"].items()}
        worst = max(rel.values())
        log(f"[{tag}] {RFCN_CROSS_CANVAS[0]}x{RFCN_CROSS_CANVAS[1]} trunk 32 dilate_c5 "
            f"{dilate}: launches on the card {counts}; max |card - CPU| / max |CPU| (limit "
            f"{limit:.0e}): " + "; ".join(f"{k} {v:.2e}" for k, v in rel.items()))
        if counts != {"greedy_nms": 2, "multilevel_roi_align": 0,
                      "multilevel_roi_align_bwd": 0} or not worst <= limit:
            raise AssertionError(f"cross-device R-FCN {dtype} dilate_c5={dilate}: launches "
                                 f"{counts}, card and CPU differ by {worst:.3e}")
    if dtype != "float32":
        return
    # PSRoIPool alone at the full-width shapes, forward and gradient
    rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    b, h, w, c = PS_TABLE
    table = torch.randn(*PS_TABLE, generator=gen)
    rois = torch.tensor(roi_cases(rng, b, PS_ROIS, (h * RFCN_STRIDE, w * RFCN_STRIDE)),
                        dtype=torch.float32)
    g = torch.randn(b, PS_ROIS, 7, 7, c // 49, generator=gen)
    res = {}
    for name, dev in (("card", DEVICE), ("cpu", "cpu")):
        leaf = table.to(dev).requires_grad_(True)
        out = ps_roi_pool(leaf, rois.to(dev), RFCN_STRIDE, 7, 2)
        out.backward(g.to(dev))
        res[name] = (out.detach().cpu(), leaf.grad.cpu())
    fwd = float((res["card"][0] - res["cpu"][0]).abs().max() / res["cpu"][0].abs().max())
    bwd = float((res["card"][1] - res["cpu"][1]).abs().max() / res["cpu"][1].abs().max())
    log(f"[{tag}] PSRoIPool table {PS_TABLE}, {PS_ROIS} RoIs an image: card against CPU, "
        f"forward {fwd:.2e}, gradient {bwd:.2e} of their magnitude (limit 1e-05)")
    if not (fwd <= 1e-5 and bwd <= 1e-5):
        raise AssertionError(f"PSRoIPool card against CPU: forward {fwd:.3e}, gradient "
                             f"{bwd:.3e}")


def phase_rfcn_train(seed=0, warmup=2, steps=3, dtype="float32"):
    """R-FCN R-50 train_step at full width in ``dtype`` (1024x1024, batch
    2): ``warmup`` + ``steps`` steps, each finite and launching K1 once
    (the proposals, G=2, N=rpn.pre_nms_topk_train) and K2, K3 never; every
    trainable parameter changed (res5 too, which the C4 trunk does not run:
    weight decay and momentum move it) and float32, every frozen one
    unchanged; ms a step, peak memory, the stage breakdown, PSRoIPool's
    forward and gradient timed at the sampled RoIs; in float32 then the
    train driver. Returns (launches over the timed steps, ms a step, a
    summary)."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.train.state import train_step

    cfg = get_config(RFCN_R50, TRAIN_OVERRIDES + [f"model.dtype={dtype}"])
    state, data = seeded_train_state(cfg, None, seed)
    det = state.detector
    tag = f"rfcn train {dtype}"
    log(f"[{tag}] {cfg.model.name} {cfg.model.backbone} trunk {cfg.model.fpn_channels} "
        f"classes {cfg.model.num_classes} canvas {tuple(cfg.data.image_size)} batch "
        f"{cfg.train.batch_size} base_lr {cfg.train.base_lr} grad_clip_norm "
        f"{cfg.train.grad_clip_norm}")
    named = dict(det.module.named_parameters())
    trainable = [n for n, q in named.items() if q.requires_grad]
    frozen = [n for n, q in named.items() if not q.requires_grad]
    before = {n: q.detach().clone() for n, q in named.items()}
    batches = [det.batch_to_device(next(data)) for _ in range(warmup + steps)]
    totals = dict.fromkeys(counted_wrappers(), 0)
    want_shapes = [(cfg.train.batch_size, cfg.rpn.pre_nms_topk_train, 4)]
    times = []
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        reset_counts()
        shapes = {}
        t0 = time.perf_counter()
        with kernel_dtypes(shapes) as seen:
            metrics = train_step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        losses = {k: float(v) for k, v in metrics.items()}
        log(f"[{tag}] {'warm-up' if i < warmup else 'step'} {i}: {ms:.1f} ms, launches "
            f"{counts}, " + " ".join(f"{k}={v:.4f}" for k, v in sorted(losses.items())))
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"R-FCN train step {i}: a loss is not finite: {losses}")
        if counts != {"greedy_nms": 1, "multilevel_roi_align": 0,
                      "multilevel_roi_align_bwd": 0}:
            raise AssertionError(f"R-FCN train step {i}: launches {counts}, want K1 once, K2 "
                                 "and K3 never")
        if shapes != {"greedy_nms": want_shapes} or seen != {"greedy_nms": {"float32"}}:
            raise AssertionError(f"R-FCN train step {i}: K1 handed {shapes} {seen}")
        if i >= warmup:
            times.append(ms)
            for name, n in counts.items():
                totals[name] += n
    peak = torch.cuda.max_memory_allocated() / 2**30
    unchanged = [n for n in trainable if torch.equal(named[n].detach(), before[n])]
    moved = [n for n in frozen if not torch.equal(named[n].detach(), before[n])]
    not_fp32 = [n for n, q in named.items()
                if q.dtype != torch.float32 or (q.grad is not None and q.grad.dtype != q.dtype)]
    log(f"[{tag}] {len(trainable)} trainable tensors, {len(unchanged)} unchanged; "
        f"{len(frozen)} frozen, {len(moved)} changed; parameters or gradients not float32: "
        f"{len(not_fp32)}")
    if unchanged or moved or not frozen or not_fp32:
        raise AssertionError(f"R-FCN train: trainable unchanged {unchanged[:5]}, frozen moved "
                             f"{moved[:5]}, not float32 {not_fp32[:5]}")
    del before
    med = float(np.median(times))
    log(f"[{tag}] per-step ms {[round(t, 3) for t in times]}; median {med:.2f} ms = "
        f"{cfg.train.batch_size * 1e3 / med:.2f} img/s; peak device memory {peak:.2f} GiB")
    parts = train_breakdown(state, batches[-1], tag=tag)
    # PSRoIPool at the training shapes: the sampled RoIs of a step
    with torch.no_grad():
        table = det.module.ps_maps(det.module.features(batches[-1]["image"]))
    r = cfg.roi.batch_per_image
    rois = torch.tensor(roi_cases(np.random.RandomState(seed), cfg.train.batch_size, r,
                                  cfg.data.image_size), dtype=torch.float32, device=det.device)
    pool_ms = time_ps_roi_pool(table, rois, cfg, tag)
    del table
    if dtype == "float32":
        phase_driver(state, RFCN_R50)
    return totals, times, dict(step_ms=times, median_ms=med, peak_gib=peak, stages_ms=parts,
                               psroipool=pool_ms)


def phase_rfcn_eval(seed=0, dtype="float32"):
    """Phase 22's eval: :func:`box_eval` with R-FCN R-50, K1 twice a call."""
    return box_eval("rfcn", "R-FCN", RFCN_R50, rfcn_params, 2, seed, dtype)


# batch 8 for both halves, R-FCN's trunk of 1024 channels (the zoo config's)
RFCN_BENCH_ARGS = ["--model", "rfcn", "--batch", "8", "--train-batch", "8", "--iters", "3",
                   "--train-iters", "2", "--set", "model.fpn_channels=1024"]


def phase_rfcn_bench(dtype=None):
    """Phase 22's bench: :func:`box_bench` with ``--model rfcn --set
    model.fpn_channels=1024`` at batch 8 / 8, K1 twice a predict call and
    once a train step. Returns the launches and the line."""
    counts, out, _ = box_bench("rfcn", "R-FCN", RFCN_BENCH_ARGS, 2, 1, dtype)
    return counts, out


RFCN_DEMO_ARGS = ["--no-restore", "--config", RFCN_R50, "--cfg", f"output_dir={DEMO_OUT}"]


def rfcn_phases(k1) -> dict:
    """Phases 19-22, each path in both dtypes (the config's bf16 and
    float32). Returns ``{path: (launches, summary)}``."""
    rfcn = {}
    for dtype, sfx in (("float32", ""), ("bfloat16", "_bf16")):
        counts, _, summary = phase_rfcn(dtype=dtype)
        rfcn["rfcn_predict" + sfx] = (counts, summary)
    phase_cross_rfcn()
    phase_cross_rfcn(dtype="bfloat16")
    for dtype, sfx in (("float32", ""), ("bfloat16", "_bf16")):
        counts, _, summary = phase_rfcn_train(dtype=dtype)
        rfcn["rfcn_train" + sfx] = (counts, summary)
        counts, img_s = phase_rfcn_eval(dtype=dtype)
        rfcn["rfcn_eval" + sfx] = (counts, img_s)
    for dtype, sfx in ((None, "_bf16"), ("float32", "")):
        counts, line = phase_rfcn_bench(dtype)
        rfcn["rfcn_bench" + sfx] = (counts, line)
    phase_demo(RFCN_DEMO_ARGS)
    return rfcn


# ------------------------------------------------------------ phase 23: RoIPool

FASTER_R50 = os.path.join(REPO, "configs", "faster_rcnn_r50_fpn_coco.yaml")
POOL_OVERRIDES = ["roi.pool_type=pool"]


def check_roi_pool(name, feats, rois, p):
    """multilevel_roi_pool on the card against the CPU, on the same float32
    inputs: bit for bit (a max is exact); then on the features rounded to
    bf16, within one bf16 step of the CPU's float32 result rounded to bf16
    (rounding is monotone, so it commutes with a max: the two are equal).
    Each timed on the card, forward and forward with its gradient. Returns
    the two cases."""
    from detectron_tpu_torch.ops import roi_align as ra

    want = ra.multilevel_roi_pool([f.cpu() for f in feats], rois.cpu(), STRIDES, p)
    empty = int((want == 0).all(-1).sum())
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        levels = [f.to(dtype) for f in feats]
        ref = want.to(dtype)
        got = ra.multilevel_roi_pool(levels, rois, STRIDES, p).cpu()
        steps = bf16_steps(got, ref) if dtype == torch.bfloat16 else 0
        equal = torch.equal(got, ref)
        ms = cuda_ms(lambda: ra.multilevel_roi_pool(levels, rois, STRIDES, p), iters=10)
        leaves = [f.detach().clone().requires_grad_(True) for f in levels]
        g = torch.ones(got.shape, dtype=dtype, device=rois.device)

        def fwd_bwd():
            ra.multilevel_roi_pool(leaves, rois, STRIDES, p).backward(g)
            for leaf in leaves:
                leaf.grad = None

        both = cuda_ms(fwd_bwd, iters=5)
        tag = name if dtype == torch.float32 else f"{name} bf16"
        log(f"[RoIPool {tag}] card against CPU: max |diff| "
            f"{float((got.float() - ref.float()).abs().max()):.3e}"
            f"{f', {steps} bf16 steps' if dtype == torch.bfloat16 else ''} "
            f"({'equal' if equal else 'not equal'}; {empty} empty bins); forward {ms:.4f} ms, "
            f"forward + gradient {both:.4f} ms (plain PyTorch, no kernel)")
        if not (equal if dtype == torch.float32 else steps <= 1):
            raise AssertionError(f"RoIPool {tag}: the card differs from the CPU")
        cases.append({"case": tag, "dtype": str(dtype).replace("torch.", ""), "ms": ms,
                      "fwd_bwd_ms": both})
    return cases


def phase_roi_pool(seed=0, calls=3, steps=2):
    """RoIPool: multilevel_roi_pool card against CPU at the 1024x1344 P2-P5
    shapes (C=256; R=512, P=7 and R=128, P=14 an image, batch 2), in float32
    and bf16; then Faster R-CNN R-50-FPN (configs/faster_rcnn_r50_fpn_coco
    .yaml) with roi.pool_type=pool in float32: ``calls`` predict calls (K1
    twice each) and ``steps`` train steps (K1 once each), K2 and K3 never.
    Returns {path: launches} and the pool's timings."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models.zoo import build_detector
    from detectron_tpu_torch.train.state import train_step

    rng = np.random.RandomState(seed)
    feats = level_features(rng)
    cases = []
    for p, r in ((7, 512), (14, 128)):
        rois = torch.tensor(roi_cases(rng, 2, r, CANVAS), device=DEVICE)
        cases += check_roi_pool(f"P={p} R={r}", feats, rois, p)
    del feats
    cfg = get_config(FASTER_R50, POOL_OVERRIDES)
    det = build_detector(cfg)
    params = raise_class_bias(det.init(seed), RAISED_CLASSES)
    batch = slice_inputs(cfg, seed, det.device)
    log(f"[roi_pool] {cfg.model.name} {cfg.model.backbone} FPN {cfg.model.fpn_channels} "
        f"roi.pool_type={cfg.roi.pool_type} canvas {tuple(cfg.data.image_size)} batch 2")
    launches = {"roi_pool_predict": dict.fromkeys(counted_wrappers(), 0),
                "roi_pool_train": dict.fromkeys(counted_wrappers(), 0)}
    times = []
    for call in range(calls):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        dets, _ = det.predict_fn(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        if counts != {"greedy_nms": 2, "multilevel_roi_align": 0,
                      "multilevel_roi_align_bwd": 0} or not int(dets.valid.sum()):
            raise AssertionError(f"RoIPool predict call {call}: launches {counts}, "
                                 f"{int(dets.valid.sum())} detections")
        for name, n in counts.items():
            launches["roi_pool_predict"][name] += n
    log(f"[roi_pool] predict ms {[round(t, 3) for t in times]}; detections valid "
        f"{int(dets.valid.sum())}; launches {launches['roi_pool_predict']}")
    tcfg = get_config(FASTER_R50, POOL_OVERRIDES + TRAIN_OVERRIDES)
    state, data = seeded_train_state(tcfg, None, seed)
    step_ms = []
    for i in range(steps):
        batch = state.detector.batch_to_device(next(data))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        metrics = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        losses = {k: float(v) for k, v in metrics.items()}
        log(f"[roi_pool train] step {i}: {step_ms[-1]:.1f} ms, launches {counts}, "
            + " ".join(f"{k}={v:.4f}" for k, v in sorted(losses.items())))
        if counts != {"greedy_nms": 1, "multilevel_roi_align": 0,
                      "multilevel_roi_align_bwd": 0} or not all(
                          np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"RoIPool train step {i}: launches {counts}, losses {losses}")
        for name, n in counts.items():
            launches["roi_pool_train"][name] += n
    reset_counts()
    return launches, dict(pool=cases, predict_ms=times, step_ms=step_ms)


# --------------------------------------------------- phase 24: pretrained weights

WEIGHTS_DIR = os.path.join(REPO, "build", "weights_smoke")


def torchvision_backbone(seed, depth="resnet50"):
    """A torchvision-named ResNet state dict with seeded values (frozen BN
    statistics near the identity, fc and num_batches_tracked included)."""
    from detectron_tpu_torch.models.resnet import ResNet

    rng = np.random.RandomState(seed)
    out = {}
    for key, value in ResNet(depth).state_dict().items():
        name = key.replace("downsample_conv", "downsample.0").replace("downsample_bn",
                                                                      "downsample.1")
        arr = rng.randn(*value.shape).astype(np.float32) * 0.02
        if key.endswith(("running_var", "bn1.weight", "bn2.weight", "bn3.weight",
                         "downsample_bn.weight")):
            arr = 1.0 + np.abs(arr)
        out[name] = torch.tensor(arr)
        if key.endswith("running_var"):
            out[name.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
    out["fc.weight"] = torch.zeros(1000, 2048)
    out["fc.bias"] = torch.zeros(1000)
    return out


def lineage_detector(cfg, seed):
    """A full Mask R-CNN state dict for ``cfg``'s widths in the lineage's
    names: the backbone under ``resnet.``, ``fpn_inner``/``fpn_output``,
    ``rpn_conv`` with a 2A softmax ``rpn_cls_score``, ``fc6``/``fc7``,
    ``mask_fcn1..4``, ``conv5_mask`` (ConvTranspose2d) and K+1
    ``mask_fcn_logits``."""
    rng = np.random.RandomState(seed)
    c, k = cfg.model.fpn_channels, cfg.model.num_classes
    a = len(cfg.anchors.ratios) * len(cfg.anchors.rpn_scales)
    p = cfg.roi.pool_size

    def w(*shape):
        return torch.tensor(rng.randn(*shape).astype(np.float32) * 0.01)

    out = {f"resnet.{n}": v for n, v in torchvision_backbone(seed).items()}
    for lvl, cin in zip(range(2, 6), (256, 512, 1024, 2048)):
        out.update({f"fpn_inner{lvl}.weight": w(c, cin, 1, 1), f"fpn_inner{lvl}.bias": w(c),
                    f"fpn_output{lvl}.weight": w(c, c, 3, 3), f"fpn_output{lvl}.bias": w(c)})
    out.update({"rpn_conv.weight": w(c, c, 3, 3), "rpn_conv.bias": w(c),
                "rpn_cls_score.weight": w(2 * a, c, 1, 1), "rpn_cls_score.bias": w(2 * a),
                "rpn_bbox_pred.weight": w(4 * a, c, 1, 1), "rpn_bbox_pred.bias": w(4 * a),
                "fc6.weight": w(1024, c * p * p), "fc6.bias": w(1024),
                "fc7.weight": w(1024, 1024), "fc7.bias": w(1024),
                "cls_score.weight": w(k, 1024), "cls_score.bias": w(k),
                "bbox_pred.weight": w(4 * k, 1024), "bbox_pred.bias": w(4 * k),
                "conv5_mask.weight": w(256, 256, 2, 2), "conv5_mask.bias": w(256),
                "mask_fcn_logits.weight": w(k, 256, 1, 1), "mask_fcn_logits.bias": w(k)})
    for i in range(1, 5):
        out.update({f"mask_fcn{i}.weight": w(256, c if i == 1 else 256, 3, 3),
                    f"mask_fcn{i}.bias": w(256)})
    return out


def phase_weights(seed=0):
    """model.weights through both drivers on the card: a torchvision-named
    R-50 backbone dict (``.pth``, ``module.``-prefixed, wrapped in
    ``state_dict``) into the train driver on R-FCN for one step, the
    weights it starts from equal to the dict under the layout maps; a full
    Mask R-CNN dict in the lineage's names into the eval driver on Mask
    R-CNN over phase 11's split: the weights it predicts with equal to the
    dict (the deconv as it is, fc1 permuted CHW -> HWC, the RPN classifier
    fg - bg, the mask logits without channel 0), K1 and K2 twice a call,
    every image once."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.eval import driver as eval_driver
    from detectron_tpu_torch.models.zoo import build_detector
    from detectron_tpu_torch.train import driver as train_driver
    from detectron_tpu_torch.utils.torch_weights import torch_key_to_port_key

    shutil.rmtree(WEIGHTS_DIR, ignore_errors=True)
    os.makedirs(WEIGHTS_DIR)
    backbone_path = os.path.join(WEIGHTS_DIR, "r50_torchvision.pth")
    src = torchvision_backbone(seed)
    torch.save({"state_dict": {f"module.{k}": v for k, v in src.items()}}, backbone_path)
    seen = {}
    real = train_driver.create_train_state

    def spy(cfg, det, params=None):
        seen["params"] = {k: v.detach().cpu().clone() for k, v in params.items()}
        return real(cfg, det, params)

    out = os.path.join(WEIGHTS_DIR, "train")
    cfg = get_config(RFCN_R50, TRAIN_OVERRIDES + [
        "model.dtype=float32", "train.max_steps=1", "train.log_every=1", f"output_dir={out}",
        f"model.weights={backbone_path}"])
    train_driver.create_train_state = spy
    try:
        reset_counts()
        last = train_driver.run(cfg)
        counts = read_counts()
    finally:
        train_driver.create_train_state = real
    mismatched = [k for k, v in src.items() if torch_key_to_port_key(k) is not None
                  and not torch.equal(seen["params"][f"backbone.{torch_key_to_port_key(k)}"],
                                      v)]
    n_loaded = sum(torch_key_to_port_key(k) is not None for k in src)
    log(f"[weights] train driver, R-FCN, model.weights={os.path.relpath(backbone_path, REPO)}: "
        f"{n_loaded} backbone tensors loaded, {len(mismatched)} differ from the dict; 1 step, "
        f"losses {({k: round(v, 4) for k, v in last.items()})}, launches {counts}")
    if mismatched or not last or not all(np.isfinite(v) for v in last.values()) or (
            counts["greedy_nms"] != 1):
        raise AssertionError(f"weights: train driver loaded {mismatched[:5]} wrong, or its step "
                             f"failed: {last} {counts}")

    cfg = get_config(MASK_R50, ["train.batch_size=2", "data.orientation_buckets=true",
                                f"output_dir={os.path.join(WEIGHTS_DIR, 'eval')}"])
    full = lineage_detector(cfg, seed + 1)
    full_path = os.path.join(WEIGHTS_DIR, "mask_rcnn_lineage.pth")
    torch.save({"model": {f"module.{k}": v for k, v in full.items()}}, full_path)
    cfg.model.weights = full_path
    ds = InMemoryCoco(seed, num_classes=cfg.model.num_classes)
    det = build_detector(cfg)
    used = {}

    def predict(params, batch):
        used.setdefault("params", params)
        return det.predict_fn(params, batch)

    reset_counts()
    res = eval_driver.run(cfg, dataset=ds, restore=False, predict=predict)
    counts = read_counts()
    got = {k: v.cpu() for k, v in used["params"].items()}
    p, c = cfg.roi.pool_size, cfg.model.fpn_channels
    bg, fg = full["rpn_cls_score.weight"].chunk(2)
    checks = {
        "deconv as it is": torch.equal(got["mask_head.deconv.weight"],
                                       full["conv5_mask.weight"]),
        "fc1 CHW -> HWC": torch.equal(got["box_head.fc1.weight"], full["fc6.weight"].reshape(
            1024, c, p, p).permute(0, 2, 3, 1).reshape(1024, -1)),
        "rpn fg - bg": torch.equal(got["rpn_head.objectness.weight"], fg - bg),
        "mask logits from channel 1": torch.equal(got["mask_head.mask_logits.weight"],
                                                  full["mask_fcn_logits.weight"][1:]),
        "fpn_output3 -> smooth3": torch.equal(got["fpn.smooth3.weight"],
                                              full["fpn_output3.weight"]),
        "backbone": torch.equal(got["backbone.layer4.2.conv3.weight"],
                                full["resnet.layer4.2.conv3.weight"]),
    }
    calls = res["timing"]["batches"]
    log(f"[weights] eval driver, Mask R-CNN, model.weights={os.path.relpath(full_path, REPO)}: "
        f"{checks}; {res['timing']['images']} images, launches {counts}; AP {res['AP']}")
    if not all(checks.values()) or res["timing"]["images"] != len(ds) or counts != {
            "greedy_nms": 2 * calls, "multilevel_roi_align": 2 * calls,
            "multilevel_roi_align_bwd": 0}:
        raise AssertionError(f"weights: eval driver {checks}, launches {counts}")
    shutil.rmtree(WEIGHTS_DIR, ignore_errors=True)
    reset_counts()


# ------------------------------------------ phases 25-27: GroupNorm, remat, data parallelism

GN_OVERRIDES = ["model.norm=gn"]
# phase 25's bf16 check, card against CPU. GroupNorm rescales each group of
# the bf16 convolutions' rounding: on the CPU the port's bf16 GN levels lie
# 2.2-4.1% from the JAX package's bf16 ones, which lie 3.3-6.7% from JAX's
# float32 ones (tests/test_torch_gn.py; frozen BN: 0.9-1.4%). So each bf16
# output must lie within CROSS_BF16_GN of the CPU's and no farther than
# CROSS_BF16_AS_GOOD x the CPU's bf16 output from the CPU's float32 one
# (the criterion tests/test_torch_gn.py holds the port to against JAX)
CROSS_BF16_GN = 1e-1
CROSS_BF16_AS_GOOD = 1.5


def predict_calls(det, params, batch, calls, tag, want):
    """``calls`` predict_fn calls, each launching the kernels ``want`` times
    (``{name: n}``); returns (launches over the calls, ms a call, the last
    detections)."""
    totals = dict.fromkeys(counted_wrappers(), 0)
    times = []
    for call in range(calls):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        dets, masks = det.predict_fn(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        log(f"[{tag}] call {call}: {times[-1]:.1f} ms, launches {counts}, detections "
            f"{int(dets.valid.sum())}")
        if counts != want or not int(dets.valid.sum()) or not (
                bool(torch.isfinite(dets.boxes).all()) and float(masks.min()) >= 0.0
                and float(masks.max()) <= 1.0):
            raise AssertionError(f"{tag} call {call}: launches {counts} (want {want}), "
                                 f"{int(dets.valid.sum())} detections, or outputs out of range")
        for name, n in counts.items():
            totals[name] += n
    reset_counts()
    return totals, times, dets


def train_steps(state, batches, tag, want):
    """``train_step`` on each batch, each finite and launching the kernels
    ``want`` times; returns (launches, ms a step, peak GiB over the steps)."""
    from detectron_tpu_torch.train.state import train_step

    totals = dict.fromkeys(counted_wrappers(), 0)
    times = []
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        metrics = train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        losses = {k: float(v) for k, v in metrics.items()}
        log(f"[{tag}] step {i}: {times[-1]:.1f} ms, launches {counts}, "
            + " ".join(f"{k}={v:.4f}" for k, v in sorted(losses.items())))
        if counts != want or not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"{tag} step {i}: launches {counts} (want {want}), losses "
                                 f"{losses}")
        for name, n in counts.items():
            totals[name] += n
    reset_counts()
    return totals, times, torch.cuda.max_memory_allocated() / 2**30


def phase_gn(seed=0, calls=3, steps=3, dtype="float32"):
    """Mask R-CNN R-50-FPN with GroupNorm-32 (configs/mask_rcnn_r50_fpn_coco
    .yaml + model.norm=gn) at full width, 1024x1344, batch 2, in ``dtype``:
    ``calls`` predict calls (K1 and K2 twice each), the stage breakdown, peak
    memory; ``steps`` train steps from the same weights (K1 once, K2 and K3
    twice each, every loss finite), the stem's GroupNorm unchanged and the
    trainable stages' changed, the step's stage breakdown and peak memory;
    one call and one step with every kernel launch held against its plain
    version (``hold_path``); then the same steps with frozen BatchNorm
    (calibrated) for the time ratio. Returns ({path: launches}, a summary
    of the numbers)."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models.zoo import build_detector
    from detectron_tpu_torch.train.driver import batch_iterator
    from detectron_tpu_torch.train.state import create_train_state, train_step

    cfg = get_config(MASK_R50, GN_OVERRIDES + TRAIN_OVERRIDES + [f"model.dtype={dtype}"])
    sfx = "" if dtype == "float32" else "_bf16"
    tag = "gn" if dtype == "float32" else f"gn {dtype}"
    det = build_detector(cfg)
    params = raise_class_bias(det.init(seed), RAISED_CLASSES)
    batch = slice_inputs(cfg, seed, det.device)
    log(f"[{tag}] {cfg.model.name} {cfg.model.backbone} norm={cfg.model.norm} FPN "
        f"{cfg.model.fpn_channels} classes {cfg.model.num_classes} canvas "
        f"{tuple(cfg.data.image_size)} {cfg.model.dtype} batch 2")
    torch.cuda.reset_peak_memory_stats()
    predict, call_ms, _ = predict_calls(det, params, batch, calls, tag, {
        "greedy_nms": 2, "multilevel_roi_align": 2, "multilevel_roi_align_bwd": 0})
    predict_peak = torch.cuda.max_memory_allocated() / 2**30
    held = {"predict": hold_path(lambda: det.predict_fn(params, batch), f"{tag} predict")}
    det.module.load_state_dict(params)
    stages, _ = stage_breakdown(det, batch, cfg)
    reset_counts()
    log(f"[{tag}] predict ms {[round(t, 3) for t in call_ms]}; peak device memory "
        f"{predict_peak:.2f} GiB")
    state = create_train_state(cfg, det)
    named = dict(det.module.named_parameters())
    before = {n: named[n].detach().clone() for n in ("backbone.gn1.weight", "backbone.gn1.bias",
                                                     "backbone.layer2.0.gn1.weight")}
    data = batch_iterator(cfg)
    batches = [det.batch_to_device(next(data)) for _ in range(steps)]
    train, step_ms, train_peak = train_steps(state, batches, f"{tag} train", {
        "greedy_nms": 1, "multilevel_roi_align": 2, "multilevel_roi_align_bwd": 2})
    moved = {n: not torch.equal(named[n].detach(), v) for n, v in before.items()}
    log(f"[{tag} train] per-step ms {[round(t, 3) for t in step_ms]}; peak device memory "
        f"{train_peak:.2f} GiB; changed by the steps: {moved}")
    if moved != {"backbone.gn1.weight": False, "backbone.gn1.bias": False,
                 "backbone.layer2.0.gn1.weight": True}:
        raise AssertionError(f"{tag} train: the stem GroupNorm moved or a trainable one did "
                             f"not: {moved}")
    held["train"] = hold_path(lambda: train_step(state, batches[-1]), f"{tag} train")
    train_stages = train_breakdown(state, batches[-1], tag=f"{tag} train")
    del state, det
    # the same steps with frozen BatchNorm (calibrated), for the ratio
    ref_cfg = get_config(MASK_R50, TRAIN_OVERRIDES + [f"model.dtype={dtype}"])
    ref_state, ref_data = seeded_train_state(ref_cfg, None, seed)
    ref_batches = [ref_state.detector.batch_to_device(next(ref_data)) for _ in range(steps)]
    _, ref_ms, ref_peak = train_steps(ref_state, ref_batches, f"{tag} frozen-BN reference", {
        "greedy_nms": 1, "multilevel_roi_align": 2, "multilevel_roi_align_bwd": 2})
    ratio = float(np.median(step_ms[1:]) / np.median(ref_ms[1:]))
    log(f"[{tag} train] GroupNorm / frozen-BN step time, steps after the first: x{ratio:.3f} "
        f"({[round(t, 1) for t in step_ms[1:]]} against {[round(t, 1) for t in ref_ms[1:]]} "
        f"ms); peak {train_peak:.2f} against {ref_peak:.2f} GiB")
    return ({"gn_predict" + sfx: predict, "gn_train" + sfx: train},
            dict(call_ms=call_ms, predict_peak_gib=predict_peak, stages_ms=stages,
                 step_ms=step_ms, train_peak_gib=train_peak, train_stages_ms=train_stages,
                 frozen_bn_step_ms=ref_ms, frozen_bn_peak_gib=ref_peak, held=held))


# phase 26's limit on each gradient with remat against without, in relative
# norm: cuDNN's backward convolutions and K3 add in a varying order, so two
# float32 steps without remat differ too (logged beside it)
REMAT_GRAD_RTOL = 1e-3


def phase_remat(seed=0):
    """model.remat on config 5's model (Mask R-CNN R-101-FPN, 1024x1344,
    batch 2, float32): one train_step without remat and one with, from the
    same (calibrated) weights with the same batch and draws, in turns after
    a warm-up of each: losses within 1e-4 relative, every gradient within
    REMAT_GRAD_RTOL of the step without remat (relative norm), the state
    dict unchanged; each step's ms and torch.cuda.max_memory_allocated;
    one more remat step with every kernel launch held against its plain
    version. Returns ({path: launches}, a summary)."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models import faster_rcnn as fr
    from detectron_tpu_torch.train.state import create_train_state, step_generator, train_step

    cfg = get_config(TRAIN_R101, TRAIN_OVERRIDES)
    state, data = seeded_train_state(cfg, None, seed)
    det = state.detector
    start = {k: v.clone() for k, v in det.module.state_dict().items()}
    batch = det.batch_to_device(next(data))
    n_anchors = sum(a.shape[0] for a in det.module.anchors(tuple(cfg.data.image_size),
                                                           det.device))
    draws = fr.make_train_draws(step_generator(cfg, 0, det.device), 2, n_anchors,
                                cfg.rpn.post_nms_topk_train + cfg.train.max_gt_boxes)
    runs = {}
    launches = dict.fromkeys(counted_wrappers(), 0)
    for i, remat in enumerate((False, True, False, True, False)):
        det.module.backbone.remat = remat
        state = create_train_state(cfg, det, start)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        metrics = train_step(state, batch, draws)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts = read_counts()
        losses = {k: float(v) for k, v in metrics.items()}
        log(f"[remat] {'remat' if remat else 'plain'} step ({'warm-up' if i < 2 else 'timed'})"
            f": {ms:.1f} ms, peak device memory {peak:.2f} GiB, launches {counts}, loss_total "
            f"{losses['loss_total']:.5f}")
        if counts != {"greedy_nms": 1, "multilevel_roi_align": 2,
                      "multilevel_roi_align_bwd": 2}:
            raise AssertionError(f"remat step: launches {counts}")
        if i >= 2:
            if remat:
                for name in counts:
                    launches[name] += counts[name]
            grads = {n: p.grad.detach().to("cpu") for n, p in det.module.named_parameters()
                     if p.requires_grad}
            runs.setdefault(remat, []).append(dict(ms=ms, peak=peak, losses=losses,
                                                   grads=grads))
    held = hold_path(lambda: train_step(create_train_state(cfg, det, start), batch, draws),
                     "remat")
    det.module.backbone.remat = False
    reset_counts()

    def worst(a, b):
        rel = {n: float(torch.linalg.vector_norm(a[n] - b[n]) / torch.linalg.vector_norm(b[n]))
               for n in b}
        n = max(rel, key=rel.get)
        return rel[n], n

    plain, rem = runs[False][0], runs[True][0]
    loss_rel = max(abs(rem["losses"][k] - v) / max(abs(v), 1e-12)
                   for k, v in plain["losses"].items())
    grad_rel, grad_name = worst(rem["grads"], plain["grads"])
    noise, noise_name = worst(runs[False][1]["grads"], plain["grads"])
    log(f"[remat] R-101 1024x1344 batch 2 float32: plain {plain['ms']:.1f} / "
        f"{runs[False][1]['ms']:.1f} ms, peak {plain['peak']:.2f} GiB; remat {rem['ms']:.1f} ms, "
        f"peak {rem['peak']:.2f} GiB (x{rem['peak'] / plain['peak']:.3f} memory, "
        f"x{rem['ms'] / plain['ms']:.3f} time); max relative loss diff {loss_rel:.2e}; worst "
        f"gradient relative diff {grad_rel:.2e} ({grad_name}; limit {REMAT_GRAD_RTOL:.0e}), two "
        f"plain steps {noise:.2e} ({noise_name})")
    if not (loss_rel <= 1e-4 and grad_rel <= REMAT_GRAD_RTOL
            and set(det.module.state_dict()) == set(start)):
        raise AssertionError(f"remat: losses differ by {loss_rel:.3e}, gradients by "
                             f"{grad_rel:.3e} in {grad_name}")
    return {"remat_train": launches}, dict(
        plain_ms=plain["ms"], plain_peak_gib=plain["peak"], remat_ms=rem["ms"],
        remat_peak_gib=rem["peak"], loss_rel=loss_rel, grad_rel=grad_rel, plain_noise=noise,
        held=held)


DP_OUT = os.path.join(REPO, "build", "dp_smoke")  # phase 27's files: weights, batch, results
DP_LOSS_ATOL, DP_PARAM_ATOL = 1e-4, 2e-5  # tests/test_parallel.py's criterion
DP_TIMED_PAIRS = 4  # phase 27 (a): train_step and the DP step timed in turns


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def get_dp_config(overrides=()):
    """Config 5's (configs/mask_rcnn_r101_fpn_coco_train.yaml) with phase 9's
    overrides and ``overrides``."""
    from detectron_tpu_torch.config import get_config

    return get_config(TRAIN_R101, TRAIN_OVERRIDES + list(overrides))


def dp_inputs(seed):
    """Config 5's model with calibrated weights, a global batch of 2 and the
    step's draws, on the card."""
    from detectron_tpu_torch.models import faster_rcnn as fr
    from detectron_tpu_torch.train.state import step_generator

    cfg = get_dp_config()
    state, data = seeded_train_state(cfg, None, seed)
    det = state.detector
    batch = det.batch_to_device(next(data))
    n_anchors = sum(a.shape[0] for a in det.module.anchors(tuple(cfg.data.image_size),
                                                           det.device))
    draws = fr.make_train_draws(step_generator(cfg, 0, det.device), 2, n_anchors,
                                cfg.rpn.post_nms_topk_train + cfg.train.max_gt_boxes)
    return cfg, state, batch, draws


def dp_worker(rank: int, port: int, device: str, out_dir: str):
    """One of phase 27 (b)'s two ranks: gloo, both on the one card, batch 1
    each: the data-parallel step from the config, weights, batch and draws
    in ``out_dir``, every kernel launch held against its plain version (on the
    card each kernel of the path must launch); rank 0 saves its losses,
    parameters and launches there."""
    from detectron_tpu_torch.models import faster_rcnn as fr
    from detectron_tpu_torch.models.zoo import build_detector
    from detectron_tpu_torch.parallel import (broadcast_state, initialize_distributed,
                                              make_mesh, make_train_step, shard_batch)
    from detectron_tpu_torch.train.state import create_train_state

    torch.backends.cuda.matmul.allow_tf32 = False  # as phase 1 sets it
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(f"127.0.0.1:{port}", 2, rank, device=device, backend="gloo")
    try:
        mesh = make_mesh(device)
        inputs = torch.load(os.path.join(out_dir, "inputs.pt"), map_location=mesh.device,
                            weights_only=False)
        cfg = inputs["cfg"]
        det = build_detector(cfg, device=mesh.device)
        state = create_train_state(cfg, det, inputs["params"])
        broadcast_state(det.module, mesh)
        step = make_train_step(det, mesh)
        out = {}

        def run():
            out["metrics"] = step(state, shard_batch(inputs["batch"], mesh),
                                  fr.TrainDraws(*inputs["draws"]))

        held = hold_path(run, f"dp (b) rank {rank}")
        counts = {name: n for name, (n, _) in held.items()}
        if mesh.device.type == "cuda" and min(counts.values()) == 0:
            raise AssertionError(f"dp (b) rank {rank}: a kernel was not launched: {counts}")
        if rank == 0:
            torch.save({"losses": {k: float(v) for k, v in out["metrics"].items()},
                        "params": {k: v.cpu() for k, v in state.params.items()},
                        "launches": counts, "held": held,
                        "backend": torch.distributed.get_backend()},
                       os.path.join(out_dir, "rank0.pt"))
    finally:
        torch.distributed.destroy_process_group()


def phase_dp(seed=0):
    """Data parallelism on config 5's model (Mask R-CNN R-101-FPN, 1024x1344).
    (a) initialize_distributed over NCCL at world size 1: the DP step at
    batch 2 against train_step on the same state, batch and draws (loss
    within 1e-4, parameters within 2e-5, as tests/test_parallel.py), the
    two timed in turns, and one DP step with every kernel launch held
    against its plain version; the train driver for 2 steps under the group
    (metrics.jsonl through MetricsWriter); the eval driver over phase 11's
    in-memory split.
    (b) two ranks on the one card over gloo (NCCL refuses two ranks on one
    device), batch 1 each: one DP step against one process's train_step on
    the batch of 2, within the same limits. Returns ({path: launches}, a
    summary)."""
    import subprocess

    from detectron_tpu_torch.eval import driver as eval_driver
    from detectron_tpu_torch.models import faster_rcnn as fr
    from detectron_tpu_torch.parallel import initialize_distributed, make_mesh, make_train_step
    from detectron_tpu_torch.train import checkpoint as ckpt
    from detectron_tpu_torch.train import driver as train_driver
    from detectron_tpu_torch.train.state import create_train_state, train_step

    cfg, state, batch, draws = dp_inputs(seed)
    det = state.detector
    start = {k: v.clone() for k, v in det.module.state_dict().items()}

    def reference():
        """train_step on the batch of 2 from ``start``: losses, parameters, ms."""
        ref = create_train_state(cfg, det, start)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = train_step(ref, batch, draws)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return ({k: float(v) for k, v in metrics.items()},
                {k: v.clone() for k, v in ref.params.items()}, ms)

    def compare(tag, got_losses, got_params, want_losses, want_params):
        loss_diff = abs(got_losses["loss_total"] - want_losses["loss_total"])
        diffs = {k: float((got_params[k].to(v.device) - v).abs().max())
                 for k, v in want_params.items()}
        worst = max(diffs, key=diffs.get)
        param_diff = diffs[worst]
        log(f"[{tag}] |loss_total diff| {loss_diff:.3e} (limit {DP_LOSS_ATOL:.0e}), max "
            f"|parameter diff| {param_diff:.3e} ({worst}; limit {DP_PARAM_ATOL:.0e}); losses "
            + " ".join(f"{k}={v:.5f}" for k, v in sorted(got_losses.items())))
        if not (loss_diff <= DP_LOSS_ATOL and param_diff <= DP_PARAM_ATOL):
            raise AssertionError(f"{tag}: the data-parallel step differs from train_step")
        return loss_diff, param_diff

    launches = {}
    summary = {}
    reference()  # warm-up
    want_losses, want_params, ref_ms = reference()
    rank, world = initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=DEVICE)
    try:
        mesh = make_mesh(DEVICE)
        backend = "nccl" if mesh.device.type == "cuda" else "gloo"
        log(f"[dp] (a) process group: backend {torch.distributed.get_backend()}, rank {rank} "
            f"of {world}, device {mesh.device}")
        if torch.distributed.get_backend() != backend or (rank, world) != (0, 1):
            raise AssertionError(f"phase 27 (a) wants {backend} at world size 1")
        step = make_train_step(det, mesh)
        step(create_train_state(cfg, det, start), batch, draws)  # warm-up
        dp_state = create_train_state(cfg, det, start)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        metrics = step(dp_state, batch, draws)
        torch.cuda.synchronize()
        dp_times = [(time.perf_counter() - t0) * 1e3]
        launches["dp_train"] = read_counts()
        summary["a"] = dict(diffs=compare(
            "dp (a)", {k: float(v) for k, v in metrics.items()}, dp_state.params,
            want_losses, want_params))
        ref_times = [ref_ms]
        for _ in range(DP_TIMED_PAIRS - 1):  # the two steps in turns
            ref_times.append(reference()[2])
            dp_state = create_train_state(cfg, det, start)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(dp_state, batch, draws)
            torch.cuda.synchronize()
            dp_times.append((time.perf_counter() - t0) * 1e3)
        reset_counts()
        dp_ms, ref_ms = float(np.median(dp_times)), float(np.median(ref_times))
        log(f"[dp] (a) DP step {[round(t, 1) for t in dp_times]} ms against train_step "
            f"{[round(t, 1) for t in ref_times]} ms in turns, medians x{dp_ms / ref_ms:.3f}; "
            f"launches {launches['dp_train']}")
        summary["a"].update(dp_ms=dp_times, train_step_ms=ref_times)
        if launches["dp_train"] != {"greedy_nms": 1, "multilevel_roi_align": 2,
                                    "multilevel_roi_align_bwd": 2}:
            raise AssertionError(f"dp (a) step: launches {launches['dp_train']}")
        summary["a"]["held"] = hold_path(
            lambda: step(create_train_state(cfg, det, start), batch, draws), "dp (a)")
        # the train driver under the group, resuming from a checkpoint
        shutil.rmtree(TRAIN_OUT, ignore_errors=True)
        ckpt.save(TRAIN_OUT, create_train_state(cfg, det, start))
        dcfg = get_dp_config(["train.max_steps=2", "train.log_every=1",
                              f"output_dir={TRAIN_OUT}"])
        reset_counts()
        last = train_driver.run(dcfg, restore=True)
        launches["dp_driver"] = read_counts()
        with open(os.path.join(TRAIN_OUT, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        log(f"[dp] (a) train driver under the group: metrics.jsonl records "
            f"{[r['step'] for r in records]}, keys {sorted(records[-1])}; launches "
            f"{launches['dp_driver']}")
        if not ([r["step"] for r in records] == [1, 2] and all(
                np.isfinite(v) for v in last.values()) and launches["dp_driver"][
                    "multilevel_roi_align_bwd"] == 4):
            raise AssertionError(f"dp (a) driver: records {records}, last {last}")
        shutil.rmtree(TRAIN_OUT, ignore_errors=True)
        ecfg = get_dp_config(["data.orientation_buckets=true", f"output_dir={EVAL_OUT}"])
        ds = InMemoryCoco(seed, num_classes=ecfg.model.num_classes)
        reset_counts()
        res = eval_driver.run(ecfg, dataset=ds, restore=False)
        launches["dp_eval"] = read_counts()
        calls = res["timing"]["batches"]
        log(f"[dp] (a) eval driver under the group: {res['timing']['images']} images in "
            f"{calls} batches, launches {launches['dp_eval']}, AP {res['AP']}")
        if res["timing"]["images"] != len(ds) or launches["dp_eval"] != {
                "greedy_nms": 2 * calls, "multilevel_roi_align": 2 * calls,
                "multilevel_roi_align_bwd": 0}:
            raise AssertionError(f"dp (a) eval: {res['timing']}, {launches['dp_eval']}")
    finally:
        torch.distributed.destroy_process_group()
    reset_counts()

    # (b) two ranks on the one card over gloo
    shutil.rmtree(DP_OUT, ignore_errors=True)
    os.makedirs(DP_OUT)
    torch.save({"cfg": cfg, "params": {k: v.cpu() for k, v in start.items()},
                "batch": {k: v.cpu() for k, v in batch.items()},
                "draws": [d.cpu() for d in draws]}, os.path.join(DP_OUT, "inputs.pt"))
    port = free_port()
    code = ("import sys, chip_smoke; "
            "chip_smoke.dp_worker(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])")
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port), DEVICE, DP_OUT],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    outs = []
    for proc in procs:
        try:
            outs.append(proc.communicate(timeout=300)[0])
        finally:
            proc.kill()
    worker_s = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        raise AssertionError("dp (b) rank failed:\n" + "\n".join(o[-3000:] for o in outs))
    for line in "\n".join(outs).splitlines():
        if line.startswith("[dp (b)"):
            log(line)
    got = torch.load(os.path.join(DP_OUT, "rank0.pt"), weights_only=False)
    log(f"[dp] (b) two ranks on one card over {got['backend']} (NCCL refuses two ranks on one "
        f"device), batch 1 each, {worker_s:.1f} s with start-up; rank 0 launches "
        f"{got['launches']}")
    if got["backend"] != "gloo":
        raise AssertionError(f"dp (b) ran over {got['backend']}")
    summary["b"] = dict(diffs=compare("dp (b)", got["losses"], got["params"], want_losses,
                                      want_params), worker_s=worker_s)
    shutil.rmtree(DP_OUT, ignore_errors=True)
    return launches, summary


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
    path's run (predict, train, eval, bench, and RetinaNet's, R-FCN's and
    the RoIPool Faster R-CNN's: K1 alone); ``launches`` the training
    path's (phase 9's timed float32 steps), the one path that launches all
    three kernels, as in the line since K3 was ported. Times are summed
    over the float32 training step's cases (one launch of each case per
    step); the inference and the bf16 cases (``dtype``) are listed beside
    them."""
    train = [c for c in cases if c["path"] == "train" and c.get("dtype", "float32") == "float32"]
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


def retinanet_phases(k1) -> dict:
    """Phases 13-18, each path in both dtypes; K1's bench cases are added
    to ``k1``. Returns ``{path: (launches, summary)}``."""
    retina = {}
    for dtype, sfx in (("float32", ""), ("bfloat16", "_bf16")):
        counts, _, summary = phase_retinanet(dtype=dtype)
        retina["retinanet_predict" + sfx] = (counts, summary)
    phase_cross_retinanet()
    phase_cross_retinanet(dtype="bfloat16")
    for dtype, sfx in (("float32", ""), ("bfloat16", "_bf16")):
        counts, _, summary = phase_retinanet_train(dtype=dtype)
        retina["retinanet_train" + sfx] = (counts, summary)
        counts, img_s = phase_retinanet_eval(dtype=dtype)
        retina["retinanet_eval" + sfx] = (counts, img_s)
    for dtype, sfx in ((None, "_bf16"), ("float32", "")):
        counts, line, case = phase_retinanet_bench(dtype)
        retina["retinanet_bench" + sfx] = (counts, line)
        k1.append(case)
    phase_demo()
    return retina


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", action="store_true",
                        help="run phases 1-4 and 7 only (the kernels against their plain "
                             "versions, and their times), print their cases and stop; no "
                             "result line")
    args = parser.parse_args(argv)
    start = last = time.perf_counter()

    def lap(phases):
        """Logs the host seconds that ``phases`` took, and the total."""
        nonlocal last
        now = time.perf_counter()
        log(f"[time] {phases}: {now - last:.1f} s (total {now - start:.1f} s)")
        last = now

    card = phase_device()
    phase_build()
    lap("phases 1-2")
    rng = np.random.RandomState(0)
    k1 = phase_nms(rng)
    feats = level_features(rng)
    k2 = phase_roi_align(rng, feats)
    lap("phases 3-4")
    if args.kernels:
        k3 = phase_roi_align_bwd(rng, feats)
        print(json.dumps({"kernel_cases": {"greedy_nms": k1, "multilevel_roi_align": k2,
                                           "multilevel_roi_align_bwd": k3}}), flush=True)
        print(card, flush=True)
        return 0
    predict_launches, _, predict32 = phase_slice()
    predict16_launches, _, predict16 = phase_slice(dtype="bfloat16")
    phase_cross_device()
    phase_cross_device(dtype="bfloat16")
    lap("phases 5-6")
    k3 = phase_roi_align_bwd(rng, feats)
    phase_function(rng, feats)
    del feats
    lap("phases 7-8")
    train_launches, _, train32 = phase_train()
    train16_launches, _, train16 = phase_train(dtype="bfloat16")
    phase_cross_train()
    lap("phases 9-10")
    eval_launches, eval32 = phase_eval()
    eval16_launches, eval16 = phase_eval(dtype="bfloat16")
    lap("phase 11")
    bench16_launches, bench16 = phase_bench()  # the bench's default, bf16
    bench_launches, bench32 = phase_bench("float32")
    lap("phase 12")
    retina = retinanet_phases(k1)
    lap("phases 13-18")
    rfcn = rfcn_phases(k1)
    lap("phases 19-22")
    pool_launches, pool_summary = phase_roi_pool()
    lap("phase 23")
    phase_weights()
    lap("phase 24")
    gn_launches, gn_summary = {}, {}
    for dtype in ("float32", "bfloat16"):
        counts, gn_summary[dtype] = phase_gn(dtype=dtype)
        gn_launches.update(counts)
    phase_cross_device(overrides=GN_OVERRIDES)
    phase_cross_device(dtype="bfloat16", overrides=GN_OVERRIDES, bf16_limit=CROSS_BF16_GN,
                       as_good_as_cpu=True)
    lap("phase 25")
    remat_launches, remat_summary = phase_remat()
    lap("phase 26")
    dp_launches, dp_summary = phase_dp()
    lap("phase 27")

    def launches(name):
        return {"predict": predict_launches.get(name, 0), "train": train_launches[name],
                "eval": eval_launches[name], "bench": bench_launches[name],
                "predict_bf16": predict16_launches.get(name, 0),
                "train_bf16": train16_launches[name], "eval_bf16": eval16_launches[name],
                "bench_bf16": bench16_launches[name],
                **{path: counts[name] for path, (counts, _) in retina.items()},
                **{path: counts[name] for path, (counts, _) in rfcn.items()},
                **{path: counts[name] for path, counts in pool_launches.items()},
                **{path: counts[name] for path, counts in gn_launches.items()},
                **{path: counts[name] for path, counts in remat_launches.items()},
                **{path: counts[name] for path, counts in dp_launches.items()}}

    kernels = [
        kernel_entry("greedy_nms", k1, launches("greedy_nms"), 0.0),
        kernel_entry("multilevel_roi_align", k2, launches("multilevel_roi_align"),
                     max(c["max_abs_err"] for c in k2 if c["dtype"] == "float32")),
        kernel_entry("multilevel_roi_align_bwd", k3, launches("multilevel_roi_align_bwd"),
                     max(c["max_abs_err"] for c in k3 if c["dtype"] == "float32")),
    ]
    # the end-to-end numbers of both dtypes, side by side
    print(json.dumps({"dtypes": {
        "predict": {"float32": predict32, "bfloat16": predict16},
        "train": {"float32": train32, "bfloat16": train16},
        "eval_img_s": {"float32": eval32, "bfloat16": eval16},
        "bench": {"float32": bench32, "bfloat16": bench16},
        "retinanet": {path: summary for path, (_, summary) in retina.items()},
        "rfcn": {path: summary for path, (_, summary) in rfcn.items()},
        "roi_pool": pool_summary, "gn": gn_summary, "remat": remat_summary,
        "dp": dp_summary}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
