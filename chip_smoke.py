"""Smoke test of the PyTorch port on one NVIDIA GPU (run: python3 chip_smoke.py).

It checks the port on the card and times its kernels; whole calls and
steps are the benchmark's to time (``benchmark/run.py``). Phases, in
order; any failure exits non-zero before the result line. The model
phases run in float32 (TF32 off) and then in bf16 (``model.dtype=
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
   cases (N=65, N=4096, N=8192 = the widest register instance, odd W below
   and above 64, max_keep=1 at N=700 and 5000, max_keep above the kept
   count, an all-invalid problem): keep masks and (idx, valid) must be
   equal; the mask and scan launches are timed apart; then the wide scan
   (past 8192 boxes: N=8193, one box in word 128; G=2, N=10000, RetinaNet
   at retinanet.pre_nms_topk=2000; N=16384, its last word full; N=20000, a
   fifth invalid), keep masks exactly equal with and without max_keep,
   timed as the main cases;
4. K2 (multilevel RoIAlign) against its plain version on the card, at the
   1024x1344 P2-P5 shapes, C=256, inference (R=300, P=7; R=100, P=14) and
   training (R=512, P=7; R=128, P=14) RoI counts with both routing spans,
   at K3's stress cases for P=7 and 14, and at sampling ratios 1 and 3
   (the kernel's generic instance; the model's is 2): max |diff| <= 1e-5 *
   max |feature|, and two K2 runs bitwise equal; each case logs, as a count
   from its inputs, the bytes of each RoI's distinct cells (what K2 stages)
   beside the distinct cells over the batch (the bound's). The bf16
   kernel (persistent and warp-specialised) at the same cases (and at C=32
   and 24, its 32- and 8-channel slices), each logging the variant it ran
   (slice, S instance, ring, stages): within one bf16 step of its bf16
   plain version plus the fp32 limit, within one bf16 step of the fp32
   kernel on the upcast features cast once, two runs bitwise equal; timed,
   its bound at 2 bytes a value; one call at each training case under the
   profiler runs the bf16 kernel and nothing else;
5. predict: Mask R-CNN R-50-FPN (configs/mask_rcnn_r50_fpn_coco.yaml) at
   full width, 1024x1344, batch 2, weights from a numpy seed, float32 then
   bf16: predict_fn three times; K1 (handed float32 boxes) and K2 (handed
   features of the model's dtype) twice a call, detections non-empty, boxes
   float32, scores and mask probabilities in the model's dtype and in
   [0, 1]; one more call under torch.cuda.set_sync_debug_mode must report
   no synchronising call (the eval loop relies on it); the stages once
   more, untimed, for the candidates of the detection NMS; one more call
   with every kernel launch held against its plain version
   (``hold_path``);
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
   seeded synthetic batches, float32 then bf16: 5 train_steps; every loss
   finite on every step, K1 (float32 boxes), K2 (2) and K3 (2) launched on
   every step in the model's dtype, frozen parameters unchanged, every
   trainable one changed, every parameter and gradient float32; peak
   memory; in float32 then the train driver for 2 steps; one more step
   with every kernel launch held against its plain version;
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
    tensors on the card) must give box AP and segm AP50 of 1.0; K2 on the
    transposed canvas;
12. bench: python -m detectron_tpu_torch.bench at its default shapes
    (1024x1024, batch 48 inference, batch 16 training) with --iters 3
    --train-iters 2, at its default dtype (bf16) and with --dtype float32:
    both JSON lines, positive finite rates, and every kernel's launches as
    its calls and steps require; then K1, K2 and K3 against their plain
    versions at the bench's shapes (batch 48: 240 RPN problems of 1000
    boxes, 48 of 1200; 14400 and 4800 RoIs; batch 16 for training), K2 and
    K3 in the run's dtype; one predict call and one train step of the
    bench's detector with every kernel launch held against its plain
    version (``hold_path``).

13. RetinaNet predict: R-50-FPN (configs/retinanet_r50_fpn_coco.yaml) at
    full width, 1024x1344, batch 2, 81 classes, seeded weights with the
    cls_score bias raised for five classes (at the prior's bias no logit
    passes the threshold), float32 then bf16: predict_fn three times, K1
    once a call on float32 boxes, N = 5 x retinanet.pre_nms_topk = 5000 a
    problem; detections non-empty, scores in [0, 1]; one call under the
    sync debug mode; the stages once more, untimed: candidates above the
    score threshold;
14. cross-device RetinaNet at 256x256 and 160x224 (odd levels), small
    widths, card against CPU with the same weights: levels and head
    outputs within CROSS_F32 (bf16: CROSS_BF16) of their magnitude; the
    post-process on the same head outputs: equal valid slots and classes,
    boxes within 1e-3; end to end, the detections' match rate logged;
15. RetinaNet train: R-50-FPN, 1024x1344, batch 2, train.grad_clip_norm=1.0
    (without it SGD from random weights reaches NaN at step 2), float32
    then bf16, 3 steps: losses finite, no K1-K3 launched, frozen
    parameters unchanged, trainable ones changed, parameters and gradients
    float32, peak memory; in float32 then the train driver for 2 steps; one
    more step with every launch held against its plain version;
16. RetinaNet eval: phase 11's in-memory COCO split, float32 then bf16:
    every image once, K1 once a predict call, box metrics finite or null
    (no segm), the oracle's box AP 1.0;
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
    call under the sync debug mode; the stages up to the PS maps once
    more, untimed: PSRoIPool (plain PyTorch) on their proposals and table
    timed, forward and gradient;
20. cross-device R-FCN at 256x256, trunk 32, dilate_c5 off and on, card
    against CPU with the same weights: the trunk, the RPN outputs and the
    votes on the same RoIs within CROSS_F32 (bf16: CROSS_BF16); PSRoIPool's
    forward and its gradient (autograd) at the full-width shapes within
    1e-5 of their magnitude;
21. R-FCN train: full width, batch 2, base_lr 0.0025 (no gradient clip:
    the calibrated statistics keep its SGD finite), 3 steps,
    float32 then bf16: losses finite, K1 once a step (G=2, N=2000), K2 and
    K3 never, frozen parameters unchanged, trainable ones changed, float32
    parameters and gradients; peak memory, PSRoIPool timed at 512 sampled
    RoIs an image; in float32 the train driver for 2 steps;
22. R-FCN eval (phase 11's split, images at most 1024 on a side to fit
    the config's 1024x1024 canvas: every image once, K1 twice a call, box
    metrics, the oracle's box AP 1.0), bench
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
    stage's changed), peak memory; then phase 6's
    cross-device check with GroupNorm (bf16: within CROSS_BF16_GN, and as
    close to float32 as the CPU's bf16, within CROSS_BF16_AS_GOOD);
26. remat: config 5's model (configs/mask_rcnn_r101_fpn_coco_train.yaml),
    1024x1344, batch 2, float32: train_step without and with model.remat
    from the same weights, batch and draws, in turns: losses equal within
    1e-4, gradients within REMAT_GRAD_RTOL, each step's peak memory;
27. data parallelism on config 5's model: (a) initialize_distributed over
    NCCL at world size 1, the DP step against train_step (loss within 1e-4,
    parameters within 2e-5), the train driver for 2
    steps under the group (metrics.jsonl through MetricsWriter), the eval
    driver over phase 11's split; (b) two ranks on the one card over gloo,
    batch 1 each: one DP step against train_step on the batch of 2, within
    the same limits. In phases 25-27 every kernel launch of one call or
    step of each path is also held against its plain version on that
    path's own inputs (``hold_path``);
28. NMS past 8192 boxes on the main path, float32: one RetinaNet R-50-FPN
    predict call at retinanet.pre_nms_topk=2000 (K1 once, G=2, N=10000)
    and one Mask R-CNN R-50-FPN predict call at rpn.post_nms_topk_test=3000
    (K1 twice: proposals, and the detections' G=2, N=12000), both at full
    width, 1024x1344, batch 2: launches counted, K1's box shapes recorded,
    detections non-empty; then one call of each with every launch held
    against its plain version (``hold_path``);
29. the op-level API (``phase_op_api``): ops/boxes.py's pairwise_iou on
    the card against float64 on the host (1e-6); ops/nms_wrapper.py's nms,
    impl="pallas" (K1) against impl="jnp" on the same CUDA tensors,
    exactly, one problem of each phase-3 shape (N = 1000 to 20000); the
    single-level ops/roi_align.py::roi_align on P3 of the 1024x1344 canvas
    (stride 8, C=256, batch 2; R=512 at P=7, 128 at P=14), float32 and
    bf16, aligned false and true: forward and gradient (K2, K3) against
    their plain versions at phases 4 and 7's limits, the launches of these
    calls counted; with aligned=True the same inputs and four stress kinds
    (zero extent, all sub-cell, shifted past the border, the whole level)
    through phases 4 and 7's checks (bitwise reruns, bf16 against the fp32
    kernel, K3 bf16's pre-pass against roi_tap_cell_bounds), zero-extent
    axes folded onto one or two cells; both values of aligned timed; C=6,
    C=12 in bf16 and P x S = 65, once refused at the call, taken and held;
30. the kernels' contracts (``phase_contracts``): K1's bf16 instance
    through nms_wrapper.nms(impl="pallas") against impl="jnp" on one bf16
    problem of each phase-3 shape (N up to 10000) and through
    class_aware_nms on bf16 boxes (launches counted), then against its
    plain walk exactly at every case's problems with and without max_keep
    and at IoUs exactly at the bf16 thresholds 0.7 and 0.3, timed whole and
    as its two launches; K2 and K3 in both dtypes on P3-P5 of the canvas
    (batch 2; R=512 at P=7, 128 at P=14): C=30 float32 and C=36 bf16
    (padded), a misaligned view of each level (copied), P x S = 112
    (mask_pool_size=28, sampling_ratio=4), pool_size=33 and 10 levels (the
    wide route), forward and gradient through multilevel_roi_align counted
    and held within phases 4 and 7's limits, each timed with the copy it
    costs (the wide cases at C=64, then timed alone at C=256); then Mask
    R-CNN R-50-FPN at 1024x1344, batch 2, bf16 with model.fpn_channels=36:
    built on the card, one predict call counted and one held
    (``hold_path``);
31. frozen BatchNorm, its ReLU and the residual add in one pass
    (``phase_frozen_bn``, csrc/frozen_bn.cu): at each distinct pass of a
    ResNet-50 forward at batch 16, 1024x1344 (the bulk cell's), in each
    form (affine; identity residual; downsample residual with its own
    norm), dtype and layout: the kernel against its plain twin bit for bit,
    forward and backward, each timed beside its bytes bound and the eager
    chain it replaced, summed over one forward (and the backward of
    layer2-4); then its launches over one bf16 Mask R-CNN R-50-FPN predict
    call (49) and one R-101 training step (100 forward, 90 backward).
32. the RPN's anchor matching (``phase_anchor_match``,
    csrc/anchor_match.cu): at the training cell's shapes (16 images, the
    343,728 anchors of 1024x1344, 100 gt slots, 1-50 objects an image
    scattered among padding rows) and at stress shapes (every gt of an
    image identical; gt equal to anchors; every image without gt; 300 gt
    slots; IoUs exactly at 0.7 and 0.3; the legacy offset 1; no force
    match): matched, pos and neg equal to the plain twin's, each timed
    beside its bound and the plain twin, with the peak device bytes of
    each. Phases 9 and 15 count its two launches a Mask R-CNN and a
    RetinaNet training step, and hold each against the twin
    (``hold_path``).

After each group of phases it logs the host seconds the group took
(``[time]``). It then prints a JSON line of per-kernel results (float32 at
top level; the bf16 cases in ``cases`` with their ``dtype``), the card's
name and power limit, and as the last line
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
NMS_REGISTER_LIMIT = 8192  # the widest register scan (csrc/nms.cu, kMaxWords x 64)
# edge cases, each held exactly against the plain version; max_keep "above"
# is one more than the largest kept count of the problems
NMS_EDGE_CASES = (
    dict(name="N=65", g=3, n=65, thresh=0.5, n_invalid=5, max_keep=None),
    dict(name="N=4096 (W=64)", g=2, n=4096, thresh=0.7, n_invalid=96, max_keep=None),
    dict(name=f"N={NMS_REGISTER_LIMIT} (the widest register scan)", g=2, n=NMS_REGISTER_LIMIT,
         thresh=0.5, n_invalid=192, max_keep=None),
    dict(name="N=1200 (odd W)", g=3, n=1200, thresh=0.6, n_invalid=0, max_keep=None),
    dict(name="N=4500 (odd W above 64)", g=2, n=4500, thresh=0.5, n_invalid=0,
         max_keep=None),
    dict(name="max_keep=1", g=4, n=700, thresh=0.5, n_invalid=50, max_keep=1),
    dict(name="max_keep=1, N=5000", g=2, n=5000, thresh=0.5, n_invalid=1000, max_keep=1),
    dict(name="max_keep above the kept count", g=4, n=700, thresh=0.5, n_invalid=50,
         max_keep="above"),
    dict(name="all invalid", g=2, n=300, thresh=0.5, n_invalid=300, max_keep=None),
)
# the wide scan (W > 128 words a row), each as NMS_CASES' cases
NMS_WIDE_CASES = (
    dict(name="N=8193 (one box in word 128)", g=1, n=NMS_REGISTER_LIMIT + 1, thresh=0.5,
         max_out=100, n_invalid=0, classes=0, path="wide"),
    dict(name="retinanet pre_nms_topk=2000", g=2, n=10000, thresh=0.5, max_out=100,
         n_invalid=2000, classes=81, path="wide"),
    dict(name="N=16384 (last word full)", g=1, n=16384, thresh=0.7, max_out=1000, n_invalid=0,
         classes=0, path="wide"),
    dict(name="N=20000, a fifth invalid", g=1, n=20000, thresh=0.7, max_out=2000,
         n_invalid=4000, classes=0, path="wide"),
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
    wide = np.random.RandomState(11)  # its own draws: the later phases' inputs do not move
    results += [nms_case(wide, case, against_cpu=False) for case in NMS_WIDE_CASES]
    return results


def nms_case(rng, case, size=(1024, 1344), against_cpu=True):
    """One of NMS_CASES' shapes on a ``size`` canvas: K1 against its plain
    version with and without max_keep, ``(idx, valid)`` against the CPU
    path (unless not ``against_cpu``: the wide cases, whose plain CPU walk
    takes seconds), the kernel timed whole and as its two launches, the
    plain version timed, the bound from this run's data. Returns the
    case's result."""
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
    if against_cpu:
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
                       iters=3, warmup=1) if against_cpu else cuda_ms(
        lambda: nms.greedy_keep_plain(sboxes, svalid, thresh, max_keep=m), iters=1, warmup=0)
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
        f"{'(idx, valid) equal to the CPU path' if against_cpu else 'scan words ' + str(-(-n // 64))}"
        f"; kernel {ms:.4f} ms (mask {mask_ms:.4f} + "
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


def touched_bytes(features, rois, levels, strides, p, s, aligned=False):
    """Bytes of the distinct feature cells that the samples of these RoIs
    read (each once), at the features' bytes a value."""
    from detectron_tpu_torch.ops.roi_align import _corners, _sample_geometry

    c = features[0].shape[-1]
    b = rois.shape[0]
    level_hw = [tuple(f.shape[1:3]) for f in features]
    total = sum(h * w for h, w in level_hw)
    base, wrow, ys, xs = _sample_geometry(level_hw, rois, levels, strides, p, s, aligned)
    inb = ys[4][..., :, None] & xs[4][..., None, :]
    image = torch.arange(b, device=rois.device)[:, None, None, None] * total
    cells = [(image + idx)[inb] for idx, _ in _corners(base, wrow, ys, xs)]
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


def k2_bound(feats, rois, levels, p, s=2, strides=STRIDES, aligned=False):
    """K2's bound at these inputs: the distinct feature cells its samples
    read over the batch, its output (both at the features' bytes a value),
    RoIs and routing, at the card's memory rate, or its fp32 operations
    where slower. Returns (ms, by, bytes)."""
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    nbytes = (touched_bytes(feats, rois, levels, strides, p, s, aligned)
              + b * r * p * p * c * feats[0].element_size() + b * r * (16 + 4))
    # per output value: S^2 samples of four corners, a weight product and a
    # scaled add each, and the division by S^2
    b_ms, b_by = bound_ms(nbytes, ops=b * r * p * p * c * (s * s * 4 * 3 + 1))
    return b_ms, b_by, nbytes


def k3_bound(g, level_hw, s=2):
    """K3's bound at these inputs: what the function must move, g read
    once and every level's gradient written once (both at g's bytes a
    value), RoIs and routing read once, at the card's memory rate, or its
    fp32 operations (per sample and corner, a weight product and a scaled
    add) where slower. Returns (ms, by, bytes)."""
    b, r, p, _, c = g.shape
    nbytes = (g.numel() * g.element_size()
              + sum(b * h * w * c for h, w in level_hw) * g.element_size() + b * r * (16 + 4))
    b_ms, b_by = bound_ms(nbytes, ops=b * r * p * p * c * (s * s * 4 * 3 + 1))
    return b_ms, b_by, nbytes


def check_k2(name, feats, rois, levels, p, fmax, s=2, strides=STRIDES, aligned=False):
    """K2 twice and its plain version on the same inputs: max |diff| against
    the plain version must be within 1e-5 x max |feature|, and the two K2
    runs bitwise equal (no atomics). Logs two counts from the inputs: the
    bytes of each RoI's distinct cells, summed over the RoIs (what K2
    stages, once a RoI), and of the distinct cells over the batch (the
    bound's). Returns (max |diff|, per-RoI bytes)."""
    from detectron_tpu_torch.ops import roi_align as ra

    args = (feats, rois, levels, strides, p, s, aligned)
    got = ra.multilevel_roi_align_cuda(*args)
    again = ra.multilevel_roi_align_cuda(*args)
    want = ra.multilevel_roi_align_plain(*args)
    torch.cuda.synchronize()
    diff = float((got - want).abs().max())
    same = torch.equal(got, again)
    per_roi, distinct = roi_cell_bytes(feats, rois, levels, p, s, strides, aligned)
    hist = torch.bincount(levels.flatten().long(), minlength=len(feats)).tolist()
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


def check_k2_bf16(name, feats, rois, levels, p, fmax, s=2, strides=STRIDES, aligned=False):
    """K2's bf16 instance twice, its bf16 plain version, and the fp32
    kernel on the upcast features, on the same inputs: within one bf16 step
    of the plain version plus the fp32 limit (1e-5 x max |feature|: the two
    sum in other orders, then round), within one bf16 step of the fp32
    kernel's output cast once (the same sums in the same order: equal,
    unless the compiler orders them otherwise), and the two runs bitwise
    equal. Returns (max |diff| against the plain version, bf16 steps from
    the fp32 kernel)."""
    from detectron_tpu_torch.ops import roi_align as ra

    args = (rois, levels, strides, p, s, aligned)
    got = ra.multilevel_roi_align_cuda(feats, *args)
    again = ra.multilevel_roi_align_cuda(feats, *args)
    want = ra.multilevel_roi_align_plain(feats, *args)
    f32 = ra.multilevel_roi_align_cuda([f.float() for f in feats], *args).to(torch.bfloat16)
    torch.cuda.synchronize()
    if got.dtype != torch.bfloat16:
        raise AssertionError(f"K2 bf16 {name}: output {got.dtype}")
    diff, ok = within_bf16(got, want, 1e-5 * fmax)
    steps = bf16_steps(got, f32)
    n_off = int((got != f32).sum())
    same = torch.equal(got, again)
    cp = ra.padded_channels(feats[0].shape[-1], torch.bfloat16)
    if ra.narrow_takes(ra.K2_BF16, cp, p, s, len(feats)):
        plan = ra.k2_bf16_plan(cp, p, s)
        log(f"[K2 bf16 {name}] variant: {plan['slice']}-channel slices, the "
            f"{'S=2' if s == 2 else 'generic S'} instance, ring {plan['ring_rows']} rows, "
            f"stages of {plan['stage_cells']} cells, {plan['smem_bytes']} B dynamic shared "
            f"memory, {plan['threads']} threads, {plan['blocks_per_sm']} blocks an SM")
    else:
        log(f"[K2 bf16 {name}] variant: the wide route (C={cp}, P*S={p * s}, "
            f"{len(feats)} levels)")
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


# the kernels of one bf16 K2 call: the persistent kernel, nothing else
K2_BF16_KERNELS = ("roi_align_forward_bf16_kernel",)


def check_k2_bf16_launches(fn, name):
    """Lists the kernels of one bf16 K2 call (``fn``) under the profiler:
    the bf16 kernel once, and nothing else."""
    listing = device_kernels(fn)
    for key, count, ms in listing:
        log(f"[K2 bf16 {name}] profiler: {ms:.4f} ms x{count} {key[:100]}")
    found = [next((k for k in K2_BF16_KERNELS if k in key), key) for key, _, _ in listing]
    if found != list(K2_BF16_KERNELS) or any(count != 1 for _, count, _ in listing):
        raise AssertionError(f"K2 bf16 {name}: one call ran {listing}, not the bf16 kernel "
                             "once")


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
            if path == "train" and dtype == "bfloat16":
                check_k2_bf16_launches(lambda: ra.multilevel_roi_align_cuda(
                    dtype_feats, rois, levels, strides, p, 2), f"P={p} R={r}")
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
    from detectron_tpu_torch.ops import anchor_match, nms, roi_align

    return {"greedy_nms": nms.greedy_keep_cuda,
            "multilevel_roi_align": roi_align.multilevel_roi_align_cuda,
            "multilevel_roi_align_bwd": roi_align.multilevel_roi_align_bwd_cuda,
            "anchor_match": anchor_match.anchor_match_cuda}


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
    comparison. The anchor matching's launches are held exactly (matched,
    pos and neg). Returns ``{name: (launches held, worst |diff|)}``."""
    from detectron_tpu_torch.ops import anchor_match, nms, roi_align

    sites = ((nms, "greedy_keep_cuda", "greedy_nms", nms.greedy_keep_plain),
             (roi_align, "multilevel_roi_align_cuda", "multilevel_roi_align",
              roi_align.multilevel_roi_align_plain),
             (roi_align, "multilevel_roi_align_bwd_cuda", "multilevel_roi_align_bwd",
              roi_align.multilevel_roi_align_bwd_plain),
             (anchor_match, "anchor_match_cuda", "anchor_match",
              anchor_match.anchor_match_plain))
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
            elif name == "anchor_match":
                ok = all(torch.equal(x, w) for x, w in zip(got, want))
                diff = float(sum((x != w).sum() for x, w in zip(got, want)))
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
    one more under the sync debug mode; the stages once more, untimed, for
    the detection NMS's candidates; one more call held
    (``hold_path``). Returns (launches over the calls, what was held)."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models import faster_rcnn as fr
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
    want_dtypes = {"greedy_nms": {"float32"}, "multilevel_roi_align": {dtype}}
    for call in range(calls):
        reset_counts()
        with kernel_dtypes() as seen:
            dets, masks = det.predict_fn(params, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"[{tag}] call {call}: launches {counts}, kernel input dtypes "
            f"{dict(sorted((k, sorted(v)) for k, v in seen.items()))}")
        if counts.pop("multilevel_roi_align_bwd") or counts.pop("anchor_match"):
            raise AssertionError("predict_fn launched the RoIAlign backward or the anchor "
                                 "matching")
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

    check_no_host_sync(lambda: det.predict_fn(params, batch), "predict_fn", tag)

    # the stages once more, untimed: the candidates that entered the detection NMS
    m = det.module
    m.load_state_dict(params)
    anchors = m.anchors(batch["image"].shape[1:3], det.device)
    with torch.no_grad():
        levels = m.features(batch["image"])
        props = fr.proposals_from_rpn(*m.rpn(levels), anchors, batch["image_hw"], cfg)
        cand_valid = fr.detection_candidates(*m.box(levels, props.boxes), props.boxes,
                                             props.valid, batch["image_hw"], cfg)[3]
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
    log(f"[{tag}] masks in [{float(masks.min()):.4f}, {float(masks.max()):.4f}]; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return totals, hold_path(lambda: det.predict_fn(params, batch), tag)


def check_no_host_sync(fn, label, tag="slice"):
    """``fn()`` must not wait for the device (the eval driver issues batch
    k+1's predict call before it consumes batch k): run once under
    ``torch.cuda.set_sync_debug_mode``, no synchronising call may be
    reported."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    reset_counts()
    syncs = sorted({str(w.message)[:120] for w in caught
                    if "synchroniz" in str(w.message).lower()})
    log(f"[{tag}] {label} under the sync debug mode: synchronising calls reported: "
        f"{len(syncs)}")
    if syncs:
        raise AssertionError(f"{label} synchronises with the host: {syncs}")


def device_work(events, name=lambda e: e.name) -> list:
    """The device's own work among the profiler's ``events`` (kernels,
    copies, fills; ``name(e)`` gives an event's name): the card's profiler
    also lists each host range (``record_function``, the program's
    ``detectron/`` spans) as a device event over the work inside it, which
    is no work of its own."""
    from detectron_tpu_torch.utils import spans

    return [e for e in events if e.device_type.name == "CUDA"
            and not getattr(e, "is_user_annotation", False)
            and not name(e).startswith(spans.PREFIX)]


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


# phase 29's stress kinds for aligned=True on one level, where the half-cell
# shift and the dropped minimum extent change what the samples touch
ALIGNED_STRESS = ("zero extent", "all sub-cell", "shifted past the border", "whole level")


def aligned_stress_rois(rng, kind, b, r, level_hw, stride):
    """Seeded image-coordinate RoIs [B, R, 4] of one of ALIGNED_STRESS on a
    level of ``level_hw`` cells at ``stride``: boxes of zero width, height
    or both (x1 == x2; a third of them on a cell's edge after the shift, so
    that their samples touch one cell, not two); boxes narrower and shorter
    than a cell; boxes within half a cell of the top-left border, whose
    shift puts samples in [-1, 0), half of them mirrored to the bottom-right
    border; boxes over the whole level, up to half a cell beyond."""
    h, w = level_hw[0] * stride, level_hw[1] * stride
    if kind == "whole level":
        out = rng.uniform(0, stride / 2, size=(b, r, 4))
        rois = np.stack([-out[..., 0], -out[..., 1], w + out[..., 2], h + out[..., 3]], -1)
        return rois.astype(np.float32)
    x0 = rng.uniform(0, w - 4 * stride, size=(b, r))
    y0 = rng.uniform(0, h - 4 * stride, size=(b, r))
    if kind == "zero extent":
        ew, eh = rng.uniform(0, 3 * stride, size=(2, b, r))
        which = rng.randint(0, 3, size=(b, r))  # 0: zero width, 1: zero height, 2: both
        ew = np.where(which == 1, ew, 0.0)
        eh = np.where(which == 0, eh, 0.0)
        edge = rng.rand(b, r) < 1 / 3  # x * scale - 0.5 a whole number of cells
        x0 = np.where(edge, (np.floor(x0 / stride) + 0.5) * stride, x0)
        y0 = np.where(edge, (np.floor(y0 / stride) + 0.5) * stride, y0)
    elif kind == "all sub-cell":
        ew, eh = rng.uniform(0.02, 0.98, size=(2, b, r)) * stride
    elif kind == "shifted past the border":
        x0, y0 = rng.uniform(0, stride / 2, size=(2, b, r))
        ew, eh = rng.uniform(0, 3 * stride, size=(2, b, r))
        rois = np.stack([x0, y0, x0 + ew, y0 + eh], -1)
        k = r // 2
        rois[:, k:] = np.stack([w - rois[:, k:, 2], h - rois[:, k:, 3], w - rois[:, k:, 0],
                                h - rois[:, k:, 1]], -1)
        return rois.astype(np.float32)
    else:
        raise ValueError(kind)
    return np.stack([x0, y0, x0 + ew, y0 + eh], -1).astype(np.float32)


def roi_cell_bytes(feats, rois, levels, p, s, strides=STRIDES, aligned=False):
    """Bytes of each RoI's distinct touched cells (its distinct columns x
    rows, C channels, fp32), summed over the RoIs: what K2 stages and K3's
    atomics add; and the bytes of the distinct cells over all RoIs."""
    from detectron_tpu_torch.ops.roi_align import _sample_geometry

    level_hw = [tuple(f.shape[1:3]) for f in feats]
    _, _, ys, xs = _sample_geometry(level_hw, rois, levels, strides, p, s, aligned)
    counts = []
    for i0, i1, w0, w1, inb in (xs, ys):
        size = max(max(hw) for hw in level_hw) + 1
        hit = torch.zeros(*i0.shape[:2], size, dtype=torch.bool, device=i0.device)
        for idx, w in ((i0, w0), (i1, w1)):
            hit.scatter_(2, torch.where(inb & (w > 0), idx, size - 1), True)
        counts.append(hit[..., :-1].sum(-1))
    c = feats[0].shape[-1]
    return int((counts[0] * counts[1]).sum()) * c * 4, touched_bytes(feats, rois, levels,
                                                                       strides, p, s, aligned)


def check_k3(name, g, level_hw, rois, levels, strides=STRIDES, aligned=False, s=2):
    """K3 twice and its plain version on the same inputs: max |diff| against
    the plain version must be within 1e-5 x max |plain gradient|. Returns
    (max |diff|, max |diff| between the two K3 runs)."""
    from detectron_tpu_torch.ops import roi_align as ra

    args = (g, level_hw, rois, levels, strides, s, aligned)
    got = ra.multilevel_roi_align_bwd_cuda(*args)
    again = ra.multilevel_roi_align_bwd_cuda(*args)
    want = ra.multilevel_roi_align_bwd_plain(*args)
    torch.cuda.synchronize()
    gmax = max(float(w.abs().max()) for w in want)
    diff = max(float((x - w).abs().max()) for x, w in zip(got, want))
    rerun = max(float((x - y).abs().max()) for x, y in zip(got, again))
    hist = torch.bincount(levels.flatten().long(), minlength=len(level_hw)).tolist()
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


def check_k3_bf16(name, g, level_hw, rois, levels, strides=STRIDES, aligned=False, s=2):
    """K3 with a bf16 ``g`` (bf16 level gradients) twice, its bf16 plain
    version, the fp32 kernel on the upcast ``g`` cast once, and K3's bf16
    pre-pass alone, on the same inputs: within one bf16 step plus the fp32
    limit of the plain version and of the fp32 kernel (1e-5 x max |plain
    gradient|: other summation orders, then one rounding); the two runs
    bitwise equal where the narrow route ran (its tile kernel has no
    atomics; the wide route adds by atomics, as the fp32 route does, and
    its reruns are logged); the pre-pass's bounds equal to
    ``roi_tap_cell_bounds``. Returns (max |diff| against the plain version,
    bf16 steps from the fp32 kernel)."""
    from detectron_tpu_torch.ops import roi_align as ra

    p = g.shape[2]
    args = (level_hw, rois, levels, strides, s, aligned)
    narrow = ra.narrow_takes(ra.K3_BF16, ra.padded_channels(g.shape[4], g.dtype), p, s,
                             len(level_hw))
    got = ra.multilevel_roi_align_bwd_cuda(g, *args)
    again = ra.multilevel_roi_align_bwd_cuda(g, *args)
    want = ra.multilevel_roi_align_bwd_plain(g, *args)
    f32 = [x.to(torch.bfloat16) for x in ra.multilevel_roi_align_bwd_cuda(g.float(), *args)]
    bounds = ra.roi_tap_bounds_cuda(level_hw, rois, levels, strides, p, s, aligned)
    want_bounds = ra.roi_tap_cell_bounds(level_hw, rois, levels, strides, p, s, aligned)
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
        f"{tile_visits(want_bounds, 16)} of 16x16; the {'narrow' if narrow else 'wide'} route")
    if not (floor > 0.0 and ok and ok32):
        raise AssertionError(f"K3 bf16 {name}: beyond its limit")
    if narrow and not same:
        raise AssertionError(f"K3 bf16 {name}: two runs differ")
    if off:
        raise AssertionError(f"K3 bf16 {name}: the pre-pass's bounds differ from "
                             f"roi_tap_cell_bounds for {off} RoIs")
    return diff, steps


def device_kernels(fn, attempts=3) -> list:
    """``(name, launches, device ms)`` of every kernel that one call of
    ``fn()`` runs on the card, from torch.profiler: the call is made twice,
    the first as the profiler's warm-up step (a first traced step can miss
    its first kernel), the second recorded. A recorded step now and then
    comes back with no device events at all (seen once in four runs on an
    NVIDIA H100 80GB HBM3): then the call is traced again, up to
    ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        # the step's own range is listed with the device time inside it
        listing = [(e.key, e.count, e.self_device_time_total / 1e3)
                   for e in device_work(prof.key_averages(), lambda e: e.key)
                   if not e.key.startswith("ProfilerStep")]
        if listing:
            return listing
    return []


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
        out_bytes = sum(b * h * w * c * 4 for h, w in level_hw)
        b_ms, b_by, nbytes = k3_bound(g, level_hw)
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
        b16_ms, b16_by, nbytes16 = k3_bound(g16, level_hw)
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
ANCHOR_MATCH_LAUNCHES = 2  # a training step's: each gt's best IoU, then the match


def phase_train(seed=0, steps=5, dtype="float32"):
    """R-101 train_step at full width in ``dtype``: ``steps`` steps, each
    finite and launching K1 once and K2 and K3 twice (K2 on ``dtype``
    features, K3 on a ``dtype`` gradient) and the anchor matching's two
    kernels (``ANCHOR_MATCH_LAUNCHES``); every trainable parameter changed
    and float32, every frozen one unchanged; in float32 then the train
    driver; one more step held (``hold_path``). Returns (launches over the
    steps, what was held)."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.train.state import train_step

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
    batches = [det.batch_to_device(next(data)) for _ in range(steps)]

    totals = dict.fromkeys(counted_wrappers(), 0)
    want_dtypes = {"greedy_nms": {"float32"}, "multilevel_roi_align": {dtype},
                   "multilevel_roi_align_bwd": {dtype}}
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate(batches):
        reset_counts()
        with kernel_dtypes() as seen:
            metrics = train_step(state, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        losses = {k: float(v) for k, v in metrics.items()}
        log(f"[{tag}] step {i}: launches {counts}, "
            + " ".join(f"{k}={v:.4f}" for k, v in sorted(losses.items())))
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"train step {i}: a loss is not finite: {losses}")
        if not (counts["greedy_nms"] >= 1 and counts["multilevel_roi_align"] == 2
                and counts["multilevel_roi_align_bwd"] == 2
                and counts["anchor_match"] == ANCHOR_MATCH_LAUNCHES):
            raise AssertionError(f"train step {i}: launches {counts}, want K1 >= 1, "
                                 f"K2 == 2, K3 == 2, anchor matching {ANCHOR_MATCH_LAUNCHES}")
        if seen != want_dtypes:
            raise AssertionError(f"train step {i}: kernel input dtypes {seen}, want "
                                 f"{want_dtypes}")
        for name, n in counts.items():
            totals[name] += n
    peak = torch.cuda.max_memory_allocated() / 2**30
    unchanged = [n for n in trainable if torch.equal(named[n].detach(), before[n])]
    moved = [n for n in frozen if not torch.equal(named[n].detach(), before[n])]
    not_fp32 = [n for n, q in named.items()
                if q.dtype != torch.float32 or (q.grad is not None and q.grad.dtype != q.dtype)]
    log(f"[{tag}] {len(trainable)} trainable tensors, {len(unchanged)} unchanged; "
        f"{len(frozen)} frozen (stem, layer1), {len(moved)} changed; parameters or gradients "
        f"not float32: {len(not_fp32)}; peak device memory {peak:.2f} GiB")
    if unchanged or moved or not frozen or not_fp32:
        raise AssertionError(f"train: trainable unchanged {unchanged[:5]}, frozen moved "
                             f"{moved[:5]}, not float32 {not_fp32[:5]}")
    del before
    if dtype == "float32":
        phase_driver(state, TRAIN_R101)
    return totals, hold_path(lambda: train_step(state, batches[-1]), tag)


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


def phase_eval(seed=0, dtype="float32"):
    """The eval driver as a user runs it, on an in-memory COCO split of 8
    images: Mask R-CNN R-50-FPN at full width in ``dtype``, weights from a
    numpy seed (the cls_score bias raised) restored from a checkpoint in
    its output_dir; Loader -> predict_fn (K1, K2) -> paste + RLE -> box and
    segm COCO metrics. Then the loop with an oracle predictor (box AP and
    segm AP50 must be 1.0; its outputs on the card in ``dtype``), and K2
    on the transposed canvas. Returns the kernels' launches over the first
    run."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.eval import driver
    from detectron_tpu_torch.models.zoo import build_detector
    from detectron_tpu_torch.train import checkpoint as ckpt
    from detectron_tpu_torch.train.state import create_train_state

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
                      "multilevel_roi_align_bwd": 0, "anchor_match": 0}:
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
    finally:
        driver.merge_across_processes = real_merge
    shutil.rmtree(EVAL_OUT, ignore_errors=True)
    check_transposed_canvas(cfg)
    return counts


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
            "multilevel_roi_align_bwd": 2 * steps, "anchor_match": ANCHOR_MATCH_LAUNCHES * steps}
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
    check_bench_shapes(args)
    return counts, dict(out, held=hold_bench_path(args))


def hold_bench_path(args) -> dict:
    """One predict call and one train step of the bench's detector (its
    config, shapes and calibrated weights, as ``bench.run`` builds them),
    each kernel launch held against its plain version (``hold_path``)."""
    from detectron_tpu_torch import bench
    from detectron_tpu_torch.models.zoo import build_detector
    from detectron_tpu_torch.train.state import create_train_state, train_step

    torch.cuda.empty_cache()
    cfg = bench.bench_config(args)
    det = build_detector(cfg)
    det.module.load_state_dict(det.init(0))
    size = int(args.size)
    train_batch = args.train_batch or args.batch
    full = bench.make_batch(np.random.RandomState(0), max(args.batch, train_batch),
                            (size, size), cfg.model.num_classes)
    bench.calibrate_frozen_bn(det.module, det.batch_to_device(
        {"image": full["image"][:train_batch]})["image"])
    params = det.module.state_dict()
    batch = det.batch_to_device({k: v[:args.batch] for k, v in full.items()
                                 if k in ("image", "image_hw")})
    held = {"predict": hold_path(lambda: det.predict_fn(params, batch),
                                 f"bench {args.dtype} predict")}
    del batch
    state = create_train_state(cfg, det, params)
    tbatch = det.batch_to_device({k: v[:train_batch] for k, v in full.items()})
    held["train"] = hold_path(lambda: train_step(state, tbatch), f"bench {args.dtype} train")
    del state, det
    torch.cuda.empty_cache()
    return held


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


def phase_retinanet(seed=0, calls=3, dtype="float32"):
    """RetinaNet R-50-FPN predict_fn at full width in ``dtype``, on
    :func:`retina_params` weights: ``calls`` calls, each launching K1 once
    on float32 boxes, N = 5 x
    retinanet.pre_nms_topk a problem, one problem an image; detections
    non-empty, scores in [0, 1]; one more call under the sync debug mode;
    the stages once more, untimed, for the merged candidates. Returns the
    launches over the calls."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models import retinanet as rn
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
    for call in range(calls):
        reset_counts()
        shapes = {}
        with kernel_dtypes(shapes) as seen:
            dets, masks = det.predict_fn(params, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"[{tag}] call {call}: launches {counts}, K1 boxes "
            f"{shapes.get('greedy_nms')} {sorted(seen.get('greedy_nms', ()))}")
        if counts != {"greedy_nms": 1, "multilevel_roi_align": 0,
                      "multilevel_roi_align_bwd": 0, "anchor_match": 0}:
            raise AssertionError(f"RetinaNet predict_fn call {call}: launches {counts}, want "
                                 "K1 once, K2 and K3 never")
        if shapes != {"greedy_nms": [(b, n_want, 4)]} or seen != {"greedy_nms": {"float32"}}:
            raise AssertionError(f"RetinaNet predict_fn call {call}: K1 handed {shapes} "
                                 f"{seen}, want float32 boxes ({b}, {n_want}, 4)")
        for name, n in counts.items():
            totals[name] += n
    check_no_host_sync(lambda: det.predict_fn(params, batch), "RetinaNet predict_fn", tag)
    # the stages once more, untimed: the merged candidates above the threshold
    m = det.module
    m.load_state_dict(params)
    anchors = m.anchors(batch["image"].shape[1:3], det.device)
    with torch.no_grad():
        outputs = m.head_outputs(m.features(batch["image"]))
        logits = rn.retinanet_candidates(outputs, anchors, batch["image_hw"], cfg)[1]
    t = cfg.retinanet.score_thresh
    n_valid = int((logits > float(np.log(t / (1.0 - t)))).sum())
    n_dets = int(dets.valid.sum())
    log(f"[{tag}] merged candidates {tuple(logits.shape)}, {n_valid} above the score "
        f"threshold; detections valid {n_dets}, classes "
        f"{sorted(set(dets.classes[dets.valid].tolist()))}")
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
    log(f"[{tag}] scores in [{float(scores.min()):.4f}, {float(scores.max()):.4f}]; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return totals


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


def phase_retinanet_train(seed=0, steps=3, dtype="float32"):
    """RetinaNet R-50-FPN train_step at full width in ``dtype`` (1024x1344,
    batch 2): ``steps`` steps, each finite and launching no K1, K2 or K3
    (RetinaNet's training pools no RoIs and runs no NMS) and the anchor
    matching's two kernels; every trainable parameter changed and float32,
    every frozen one unchanged; in float32 then the train driver; one more
    step with the anchor matching held against its plain twin
    (``hold_path``). Returns (launches over the steps, what was held)."""
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
    batches = [det.batch_to_device(next(data)) for _ in range(steps)]
    totals = dict.fromkeys(counted_wrappers(), 0)
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate(batches):
        reset_counts()
        metrics = train_step(state, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        losses = {k: float(v) for k, v in metrics.items()}
        log(f"[{tag}] step {i}: launches {counts}, "
            + " ".join(f"{k}={v:.4f}" for k, v in sorted(losses.items())))
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"RetinaNet train step {i}: a loss is not finite: {losses}")
        if counts != {"greedy_nms": 0, "multilevel_roi_align": 0, "multilevel_roi_align_bwd": 0,
                      "anchor_match": ANCHOR_MATCH_LAUNCHES}:
            raise AssertionError(f"RetinaNet train step {i}: launches {counts}; want K1-K3 "
                                 f"none, the anchor matching {ANCHOR_MATCH_LAUNCHES}")
        for name, n in counts.items():
            totals[name] += n
    peak = torch.cuda.max_memory_allocated() / 2**30
    unchanged = [n for n in trainable if torch.equal(named[n].detach(), before[n])]
    moved = [n for n in frozen if not torch.equal(named[n].detach(), before[n])]
    not_fp32 = [n for n, q in named.items()
                if q.dtype != torch.float32 or (q.grad is not None and q.grad.dtype != q.dtype)]
    log(f"[{tag}] {len(trainable)} trainable tensors, {len(unchanged)} unchanged; "
        f"{len(frozen)} frozen, {len(moved)} changed; parameters or gradients not float32: "
        f"{len(not_fp32)}; peak device memory {peak:.2f} GiB")
    if unchanged or moved or not frozen or not_fp32:
        raise AssertionError(f"RetinaNet train: trainable unchanged {unchanged[:5]}, frozen "
                             f"moved {moved[:5]}, not float32 {not_fp32[:5]}")
    del before
    if dtype == "float32":
        phase_driver(state, RETINA_R50, RETINA_TRAIN_OVERRIDES)
    return totals, hold_path(lambda: train_step(state, batches[-1]), tag)


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
    only, finite or null; then the oracle predictor (box AP 1.0). Returns
    the launches over the first run."""
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
                  "multilevel_roi_align_bwd": 0, "anchor_match": 0}:
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
    reset_counts()
    res_o = driver.run(cfg, dataset=ds, restore=False, predict=retina_oracle)
    reset_counts()
    log(f"[{tag}] oracle predictor: AP {res_o['AP']:.6f}, AP50 {res_o['AP50']:.6f}")
    if not abs(res_o["AP"] - 1.0) <= 1e-6 or "segm_AP" in res_o:
        raise AssertionError(f"{label} eval: the oracle predictor does not give box AP 1.0")
    shutil.rmtree(EVAL_OUT, ignore_errors=True)
    return counts


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
                  "multilevel_roi_align_bwd": 0, "anchor_match": ANCHOR_MATCH_LAUNCHES * steps}:
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
    the stages up to the PS maps once more, untimed, and PSRoIPool timed on
    their proposals and table. Returns (launches over the calls,
    PSRoIPool's times)."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models import faster_rcnn as fr
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
    for call in range(calls):
        reset_counts()
        shapes = {}
        with kernel_dtypes(shapes) as seen:
            dets, masks = det.predict_fn(params, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"[{tag}] call {call}: launches {counts}, K1 boxes "
            f"{shapes.get('greedy_nms')} {sorted(seen.get('greedy_nms', ()))}")
        if counts != {"greedy_nms": 2, "multilevel_roi_align": 0,
                      "multilevel_roi_align_bwd": 0, "anchor_match": 0}:
            raise AssertionError(f"R-FCN predict_fn call {call}: launches {counts}, want K1 "
                                 "twice, K2 and K3 never")
        if shapes != {"greedy_nms": want_shapes} or seen != {"greedy_nms": {"float32"}}:
            raise AssertionError(f"R-FCN predict_fn call {call}: K1 handed {shapes} {seen}, "
                                 f"want float32 boxes {want_shapes}")
        for name, n in counts.items():
            totals[name] += n
    check_no_host_sync(lambda: det.predict_fn(params, batch), "R-FCN predict_fn", tag)
    # the stages up to the PS maps once more, untimed: PSRoIPool's inputs
    m = det.module
    m.load_state_dict(params)
    anchors = m.anchors(batch["image"].shape[1:3], det.device)
    with torch.no_grad():
        feat = m.features(batch["image"])
        props = fr.proposals_from_rpn(*m.rpn(feat), anchors, batch["image_hw"], cfg)
        table = m.ps_maps(feat)
    reset_counts()
    pool_ms = time_ps_roi_pool(table, props.boxes.contiguous(), cfg, tag)
    n_props, n_dets = int(props.valid.sum()), int(dets.valid.sum())
    log(f"[{tag}] PS table {tuple(table.shape)}; proposals valid {n_props}; detections valid "
        f"{n_dets}, classes {sorted(set(dets.classes[dets.valid].tolist()))}")
    del table, feat
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
    log(f"[{tag}] scores in [{float(scores.min()):.4f}, {float(scores.max()):.4f}]; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return totals, pool_ms


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
                      "multilevel_roi_align_bwd": 0, "anchor_match": 0} or not worst <= limit:
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


def phase_rfcn_train(seed=0, steps=3, dtype="float32"):
    """R-FCN R-50 train_step at full width in ``dtype`` (1024x1024, batch
    2): ``steps`` steps, each finite and launching K1 once (the proposals,
    G=2, N=rpn.pre_nms_topk_train) and K2, K3 never; every trainable
    parameter changed (res5 too, which the C4 trunk does not run: weight
    decay and momentum move it) and float32, every frozen one unchanged;
    peak memory, PSRoIPool's forward and gradient timed at the sampled
    RoIs; in float32 then the train driver. Returns (launches over the
    steps, PSRoIPool's times)."""
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
    batches = [det.batch_to_device(next(data)) for _ in range(steps)]
    totals = dict.fromkeys(counted_wrappers(), 0)
    want_shapes = [(cfg.train.batch_size, cfg.rpn.pre_nms_topk_train, 4)]
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate(batches):
        reset_counts()
        shapes = {}
        with kernel_dtypes(shapes) as seen:
            metrics = train_step(state, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        losses = {k: float(v) for k, v in metrics.items()}
        log(f"[{tag}] step {i}: launches {counts}, "
            + " ".join(f"{k}={v:.4f}" for k, v in sorted(losses.items())))
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"R-FCN train step {i}: a loss is not finite: {losses}")
        if counts != {"greedy_nms": 1, "multilevel_roi_align": 0,
                      "multilevel_roi_align_bwd": 0, "anchor_match": ANCHOR_MATCH_LAUNCHES}:
            raise AssertionError(f"R-FCN train step {i}: launches {counts}, want K1 once, K2 "
                                 "and K3 never")
        if shapes != {"greedy_nms": want_shapes} or seen != {"greedy_nms": {"float32"}}:
            raise AssertionError(f"R-FCN train step {i}: K1 handed {shapes} {seen}")
        for name, n in counts.items():
            totals[name] += n
    peak = torch.cuda.max_memory_allocated() / 2**30
    unchanged = [n for n in trainable if torch.equal(named[n].detach(), before[n])]
    moved = [n for n in frozen if not torch.equal(named[n].detach(), before[n])]
    not_fp32 = [n for n, q in named.items()
                if q.dtype != torch.float32 or (q.grad is not None and q.grad.dtype != q.dtype)]
    log(f"[{tag}] {len(trainable)} trainable tensors, {len(unchanged)} unchanged; "
        f"{len(frozen)} frozen, {len(moved)} changed; parameters or gradients not float32: "
        f"{len(not_fp32)}; peak device memory {peak:.2f} GiB")
    if unchanged or moved or not frozen or not_fp32:
        raise AssertionError(f"R-FCN train: trainable unchanged {unchanged[:5]}, frozen moved "
                             f"{moved[:5]}, not float32 {not_fp32[:5]}")
    del before
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
    return totals, pool_ms


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
    float32). Returns ``{path: launches}``."""
    rfcn = {}
    for dtype, sfx in (("float32", ""), ("bfloat16", "_bf16")):
        rfcn["rfcn_predict" + sfx] = phase_rfcn(dtype=dtype)[0]
    phase_cross_rfcn()
    phase_cross_rfcn(dtype="bfloat16")
    for dtype, sfx in (("float32", ""), ("bfloat16", "_bf16")):
        rfcn["rfcn_train" + sfx] = phase_rfcn_train(dtype=dtype)[0]
        rfcn["rfcn_eval" + sfx] = phase_rfcn_eval(dtype=dtype)
    for dtype, sfx in ((None, "_bf16"), ("float32", "")):
        rfcn["rfcn_bench" + sfx] = phase_rfcn_bench(dtype)[0]
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
    Returns {path: launches} and the pool's cases."""
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
    for call in range(calls):
        reset_counts()
        dets, _ = det.predict_fn(params, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != {"greedy_nms": 2, "multilevel_roi_align": 0, "multilevel_roi_align_bwd": 0,
                      "anchor_match": 0} or not int(dets.valid.sum()):
            raise AssertionError(f"RoIPool predict call {call}: launches {counts}, "
                                 f"{int(dets.valid.sum())} detections")
        for name, n in counts.items():
            launches["roi_pool_predict"][name] += n
    log(f"[roi_pool] predict: detections valid {int(dets.valid.sum())}; launches "
        f"{launches['roi_pool_predict']}")
    tcfg = get_config(FASTER_R50, POOL_OVERRIDES + TRAIN_OVERRIDES)
    state, data = seeded_train_state(tcfg, None, seed)
    for i in range(steps):
        batch = state.detector.batch_to_device(next(data))
        reset_counts()
        metrics = train_step(state, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        losses = {k: float(v) for k, v in metrics.items()}
        log(f"[roi_pool train] step {i}: launches {counts}, "
            + " ".join(f"{k}={v:.4f}" for k, v in sorted(losses.items())))
        if counts != {"greedy_nms": 1, "multilevel_roi_align": 0, "multilevel_roi_align_bwd": 0,
                      "anchor_match": ANCHOR_MATCH_LAUNCHES} or not all(
                          np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"RoIPool train step {i}: launches {counts}, losses {losses}")
        for name, n in counts.items():
            launches["roi_pool_train"][name] += n
    reset_counts()
    return launches, cases


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
            "multilevel_roi_align_bwd": 0, "anchor_match": 0}:
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
    (``{name: n}``); returns the launches over the calls."""
    totals = dict.fromkeys(counted_wrappers(), 0)
    for call in range(calls):
        reset_counts()
        dets, masks = det.predict_fn(params, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"[{tag}] call {call}: launches {counts}, detections {int(dets.valid.sum())}")
        if counts != want or not int(dets.valid.sum()) or not (
                bool(torch.isfinite(dets.boxes).all()) and float(masks.min()) >= 0.0
                and float(masks.max()) <= 1.0):
            raise AssertionError(f"{tag} call {call}: launches {counts} (want {want}), "
                                 f"{int(dets.valid.sum())} detections, or outputs out of range")
        for name, n in counts.items():
            totals[name] += n
    reset_counts()
    return totals


def train_steps(state, batches, tag, want):
    """``train_step`` on each batch, each finite and launching the kernels
    ``want`` times; returns (launches, peak GiB over the steps)."""
    from detectron_tpu_torch.train.state import train_step

    totals = dict.fromkeys(counted_wrappers(), 0)
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate(batches):
        reset_counts()
        metrics = train_step(state, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        losses = {k: float(v) for k, v in metrics.items()}
        log(f"[{tag}] step {i}: launches {counts}, "
            + " ".join(f"{k}={v:.4f}" for k, v in sorted(losses.items())))
        if counts != want or not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"{tag} step {i}: launches {counts} (want {want}), losses "
                                 f"{losses}")
        for name, n in counts.items():
            totals[name] += n
    reset_counts()
    return totals, torch.cuda.max_memory_allocated() / 2**30


def phase_gn(seed=0, calls=3, steps=3, dtype="float32"):
    """Mask R-CNN R-50-FPN with GroupNorm-32 (configs/mask_rcnn_r50_fpn_coco
    .yaml + model.norm=gn) at full width, 1024x1344, batch 2, in ``dtype``:
    ``calls`` predict calls (K1 and K2 twice each), peak memory; ``steps``
    train steps from the same weights (K1 once, K2 and K3 twice each, every
    loss finite), the stem's GroupNorm unchanged and the trainable stages'
    changed, peak memory; one call and one step with every kernel launch
    held against its plain version (``hold_path``). Returns ({path:
    launches}, what was held)."""
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
    predict = predict_calls(det, params, batch, calls, tag, {
        "greedy_nms": 2, "multilevel_roi_align": 2, "multilevel_roi_align_bwd": 0,
        "anchor_match": 0})
    log(f"[{tag}] predict: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    held = {"predict": hold_path(lambda: det.predict_fn(params, batch), f"{tag} predict")}
    det.module.load_state_dict(params)
    state = create_train_state(cfg, det)
    named = dict(det.module.named_parameters())
    before = {n: named[n].detach().clone() for n in ("backbone.gn1.weight", "backbone.gn1.bias",
                                                     "backbone.layer2.0.gn1.weight")}
    data = batch_iterator(cfg)
    batches = [det.batch_to_device(next(data)) for _ in range(steps)]
    train, train_peak = train_steps(state, batches, f"{tag} train", {
        "greedy_nms": 1, "multilevel_roi_align": 2, "multilevel_roi_align_bwd": 2,
        "anchor_match": ANCHOR_MATCH_LAUNCHES})
    moved = {n: not torch.equal(named[n].detach(), v) for n, v in before.items()}
    log(f"[{tag} train] peak device memory {train_peak:.2f} GiB; changed by the steps: {moved}")
    if moved != {"backbone.gn1.weight": False, "backbone.gn1.bias": False,
                 "backbone.layer2.0.gn1.weight": True}:
        raise AssertionError(f"{tag} train: the stem GroupNorm moved or a trainable one did "
                             f"not: {moved}")
    held["train"] = hold_path(lambda: train_step(state, batches[-1]), f"{tag} train")
    return {"gn_predict" + sfx: predict, "gn_train" + sfx: train}, held


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
    dict unchanged; each step's torch.cuda.max_memory_allocated; one more
    remat step with every kernel launch held against its plain version.
    Returns ({path: launches}, a summary)."""
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
        metrics = train_step(state, batch, draws)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts = read_counts()
        losses = {k: float(v) for k, v in metrics.items()}
        stage = "warm-up" if i < 2 else "compared"
        log(f"[remat] {'remat' if remat else 'plain'} step ({stage}): peak device memory "
            f"{peak:.2f} GiB, launches {counts}, loss_total {losses['loss_total']:.5f}")
        if counts != {"greedy_nms": 1, "multilevel_roi_align": 2,
                      "multilevel_roi_align_bwd": 2, "anchor_match": ANCHOR_MATCH_LAUNCHES}:
            raise AssertionError(f"remat step: launches {counts}")
        if i >= 2:
            if remat:
                for name in counts:
                    launches[name] += counts[name]
            grads = {n: p.grad.detach().to("cpu") for n, p in det.module.named_parameters()
                     if p.requires_grad}
            runs.setdefault(remat, []).append(dict(peak=peak, losses=losses, grads=grads))
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
    log(f"[remat] R-101 1024x1344 batch 2 float32: peak {plain['peak']:.2f} GiB plain, "
        f"{rem['peak']:.2f} GiB remat (x{rem['peak'] / plain['peak']:.3f}); max relative loss "
        f"diff {loss_rel:.2e}; worst "
        f"gradient relative diff {grad_rel:.2e} ({grad_name}; limit {REMAT_GRAD_RTOL:.0e}), two "
        f"plain steps {noise:.2e} ({noise_name})")
    if not (loss_rel <= 1e-4 and grad_rel <= REMAT_GRAD_RTOL
            and set(det.module.state_dict()) == set(start)):
        raise AssertionError(f"remat: losses differ by {loss_rel:.3e}, gradients by "
                             f"{grad_rel:.3e} in {grad_name}")
    return {"remat_train": launches}, dict(
        plain_peak_gib=plain["peak"], remat_peak_gib=rem["peak"], loss_rel=loss_rel,
        grad_rel=grad_rel, plain_noise=noise, held=held)


DP_OUT = os.path.join(REPO, "build", "dp_smoke")  # phase 27's files: weights, batch, results
DP_LOSS_ATOL, DP_PARAM_ATOL = 1e-4, 2e-5  # tests/test_parallel.py's criterion


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
    within 1e-4, parameters within 2e-5, as tests/test_parallel.py), and
    one DP step with every kernel launch held
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
        """train_step on the batch of 2 from ``start``: losses, parameters."""
        ref = create_train_state(cfg, det, start)
        metrics = train_step(ref, batch, draws)
        return ({k: float(v) for k, v in metrics.items()},
                {k: v.clone() for k, v in ref.params.items()})

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
    want_losses, want_params = reference()
    rank, world = initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=DEVICE)
    try:
        mesh = make_mesh(DEVICE)
        backend = "nccl" if mesh.device.type == "cuda" else "gloo"
        log(f"[dp] (a) process group: backend {torch.distributed.get_backend()}, rank {rank} "
            f"of {world}, device {mesh.device}")
        if torch.distributed.get_backend() != backend or (rank, world) != (0, 1):
            raise AssertionError(f"phase 27 (a) wants {backend} at world size 1")
        step = make_train_step(det, mesh)
        dp_state = create_train_state(cfg, det, start)
        reset_counts()
        metrics = step(dp_state, batch, draws)
        torch.cuda.synchronize()
        launches["dp_train"] = read_counts()
        reset_counts()
        summary["a"] = dict(diffs=compare(
            "dp (a)", {k: float(v) for k, v in metrics.items()}, dp_state.params,
            want_losses, want_params))
        log(f"[dp] (a) DP step launches {launches['dp_train']}")
        if launches["dp_train"] != {"greedy_nms": 1, "multilevel_roi_align": 2,
                                    "multilevel_roi_align_bwd": 2,
                                    "anchor_match": ANCHOR_MATCH_LAUNCHES}:
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
                "multilevel_roi_align_bwd": 0, "anchor_match": 0}:
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


# ---------------------------------------------------------------- phase 28

# (config, overrides, path name, K1's box shapes a call): the main path's
# NMS past the register scans' 8192 boxes
WIDE_NMS_PATHS = (
    ("retinanet", ["retinanet.pre_nms_topk=2000"], "retinanet_predict_wide", [(2, 10000, 4)]),
    ("mask_rcnn", ["rpn.post_nms_topk_test=3000"], "predict_wide",
     [(10, 1000, 4), (2, 12000, 4)]),
)


def phase_wide_nms(seed=0):
    """WIDE_NMS_PATHS at full width, float32, batch 2: one predict call of
    each with its launches counted (K1 once or twice, K2 as its model
    runs it), K1's box shapes recorded and detections non-empty; then one
    call each with every launch held against its plain version
    (``hold_path``). Returns ({path: launches}, {path: held})."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models.zoo import build_detector

    launches, held = {}, {}
    for model, overrides, path, want_shapes in WIDE_NMS_PATHS:
        config = RETINA_R50 if model == "retinanet" else MASK_R50
        cfg = get_config(config, overrides)
        det = build_detector(cfg)
        batch = slice_inputs(cfg, seed, det.device)
        if model == "retinanet":
            params = retina_params(det, batch["image"], seed)
        else:
            params = raise_class_bias(det.init(seed), RAISED_CLASSES)
        tag = f"wide nms {path}"
        reset_counts()
        shapes = {}
        with kernel_dtypes(shapes):
            dets, _ = det.predict_fn(params, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        reset_counts()
        got_shapes = shapes.get("greedy_nms", [])
        n_dets = int(dets.valid.sum())
        log(f"[{tag}] {model} {' '.join(overrides)}: launches {counts}, K1 boxes "
            f"{got_shapes}, detections {n_dets}")
        if got_shapes != want_shapes or counts["greedy_nms"] != len(want_shapes):
            raise AssertionError(f"{tag}: K1 ran on {got_shapes} ({counts}), want {want_shapes}")
        if not n_dets or not bool(torch.isfinite(dets.boxes).all()):
            raise AssertionError(f"{tag}: {n_dets} detections, or non-finite boxes")
        launches[path] = counts
        held[path] = hold_path(lambda: det.predict_fn(params, batch), tag)
        if held[path]["greedy_nms"][0] != len(want_shapes):
            raise AssertionError(f"{tag}: held {held[path]}")
        del det, params
    return launches, held


# ----------------------------------------------------------------- phase 29

OP_STRIDE = 8  # roi_align's level: P3 of the canvas
OP_ROI_CASES = ((7, 512), (14, 128))  # (P, RoIs an image): a training step's
OP_STRESS_ROIS = 128  # RoIs an image of each ALIGNED_STRESS case


def iou_float64(a, b):
    """pairwise_iou's reference: the same formula in float64, on the host."""
    def area(x):
        return (np.clip(x[..., 2] - x[..., 0], 0, None)
                * np.clip(x[..., 3] - x[..., 1], 0, None))

    wh = np.clip(np.minimum(a[..., 2:], b[..., 2:]) - np.maximum(a[..., :2], b[..., :2]), 0,
                 None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area(a) + area(b) - inter, 1e-8)


def phase_op_api(seed=29, c=256):
    """The op-level API on the card, at full width: pairwise_iou against a
    float64 host reference; ``nms_wrapper.nms(impl="pallas")`` (K1) against
    ``impl="jnp"`` on the same CUDA tensors, exactly, one problem of each
    NMS_CASES and NMS_WIDE_CASES shape; single-level ``roi_align`` (K2
    forward, K3 backward) on P3 of the canvas (stride 8, C=``c``, batch 2)
    at OP_ROI_CASES, float32 and bf16, ``aligned`` false and true, forward
    and gradient against their plain versions at phase 4's and 7's limits.
    The launches of those calls are counted (the counts set to 0 just
    before, read just after). Then, with ``aligned=True``, K2 and K3 at
    the same inputs and at ALIGNED_STRESS through check_k2, check_k2_bf16,
    check_k3 and check_k3_bf16 (K3 bf16's pre-pass against
    roi_tap_cell_bounds), zero-extent boxes folded onto one or two cells,
    both values of ``aligned`` timed, and what the narrow kernels once
    refused at the call, taken (``check_former_refusals``). Returns ({name: launches}, K2 cases, K3
    cases)."""
    from detectron_tpu_torch.ops import boxes as box_ops
    from detectron_tpu_torch.ops import nms_wrapper
    from detectron_tpu_torch.ops import roi_align as ra

    dev = torch.device(DEVICE)
    rng = np.random.RandomState(seed)
    tag = "[op api]"

    # pairwise_iou, [2, 1000] pairs: clustered boxes against shuffled ones,
    # exact matches and disjoint pairs among them
    a = nms_problems(rng, 2, 1000, CANVAS, 0)[0].astype(np.float32)
    b = a[:, rng.permutation(1000)]
    b[:, :100] = a[:, :100]
    b[:, 100:200] += 5000.0
    iou = box_ops.pairwise_iou(torch.tensor(a, device=dev), torch.tensor(b, device=dev))
    diff = float(np.abs(iou.cpu().double().numpy() - iou_float64(a.astype(np.float64),
                                                                b.astype(np.float64))).max())
    # IoU <= 1 after a few float32 roundings (2^-24 each, relative)
    log(f"{tag} pairwise_iou [2, 1000] on the card: max |diff| {diff:.3e} from float64 "
        f"(limit 1e-6)")
    if iou.shape != (2, 1000) or not diff <= 1e-6:
        raise AssertionError(f"pairwise_iou: shape {tuple(iou.shape)}, max |diff| {diff}")

    problems = []
    for case in NMS_CASES + NMS_WIDE_CASES:
        bx, sc, va, _ = nms_problems(rng, 1, case["n"], CANVAS, case["n_invalid"])
        problems.append((case["name"], *(torch.tensor(x[0], device=dev) for x in (bx, sc, va)),
                         case["thresh"], case["max_out"]))
    h, w = CANVAS[0] // OP_STRIDE, CANVAS[1] // OP_STRIDE
    feat = torch.tensor(rng.randn(2, h, w, c).astype(np.float32), device=dev)
    rois = {p: torch.tensor(roi_cases(rng, 2, r, CANVAS), device=dev) for p, r in OP_ROI_CASES}
    g = {p: torch.tensor(rng.randn(2, r, p, p, c).astype(np.float32), device=dev)
         for p, r in OP_ROI_CASES}
    combos = [(dtype, p, aligned) for dtype in (torch.float32, torch.bfloat16)
              for p, _ in OP_ROI_CASES for aligned in (False, True)]

    # the path: every call through the public functions, launches counted
    torch.cuda.synchronize()
    reset_counts()
    kept = [nms_wrapper.nms(boxes, scores, thresh, max_out, valid=valid, impl="pallas")
            for _, boxes, scores, valid, thresh, max_out in problems]
    pooled = {}
    for dtype, p, aligned in combos:
        leaf = feat.to(dtype, copy=True).requires_grad_(True)
        out = ra.roi_align(leaf, rois[p], OP_STRIDE, p, 2, aligned)
        (grad,) = torch.autograd.grad(out, leaf, grad_outputs=g[p].to(dtype))
        pooled[(dtype, p, aligned)] = (out.detach(), grad)
    torch.cuda.synchronize()
    counts = read_counts()
    reset_counts()
    want_counts = {"greedy_nms": len(problems), "multilevel_roi_align": len(combos),
                   "multilevel_roi_align_bwd": len(combos), "anchor_match": 0}
    log(f"{tag} launches {counts} (want {want_counts})")
    if counts != want_counts:
        raise AssertionError(f"op api: launches {counts}, want {want_counts}")

    for (name, boxes, scores, valid, thresh, max_out), (idx, ok) in zip(problems, kept):
        want_idx, want_ok = nms_wrapper.nms(boxes, scores, thresh, max_out, valid=valid,
                                            impl="jnp")
        torch.cuda.synchronize()
        same = torch.equal(idx, want_idx) and torch.equal(ok, want_ok)
        log(f"{tag} nms {name}: N={boxes.shape[0]} max_out={max_out}, {int(ok.sum())} kept; "
            f"impl='pallas' equal to impl='jnp': {same}")
        if not same or idx.dtype != torch.int32 or ok.shape != (max_out,):
            raise AssertionError(f"op api nms {name}: impl='pallas' differs from impl='jnp'")

    level_hw = [(h, w)]
    strides = (OP_STRIDE,)
    k2_cases, k3_cases = [], []
    for dtype, p, aligned in combos:
        label = f"roi_align {str(dtype)[6:]} P={p} R={rois[p].shape[1]} aligned={aligned}"
        out, grad = pooled[(dtype, p, aligned)]
        f = feat.to(dtype)
        levels = torch.zeros(rois[p].shape[:2], dtype=torch.int32, device=dev)
        want = ra.multilevel_roi_align_plain([f], rois[p], levels, strides, p, 2, aligned)
        gd = g[p].to(dtype)
        (want_grad,) = ra.multilevel_roi_align_bwd_plain(gd, level_hw, rois[p], levels, strides,
                                                         2, aligned)
        torch.cuda.synchronize()
        fmax = float(f.float().abs().max())
        floor = 1e-5 * fmax
        gfloor = 1e-5 * float(want_grad.float().abs().max())
        if dtype == torch.bfloat16:
            diff, ok = within_bf16(out, want, floor)
            gdiff, gok = within_bf16(grad, want_grad, gfloor)
        else:
            diff = float((out - want).abs().max())
            gdiff = float((grad - want_grad).abs().max())
            ok, gok = diff <= floor, gdiff <= gfloor
        log(f"{tag} {label}: forward max |diff| {diff:.3e} from its plain version (limit "
            f"{'one bf16 step + ' if dtype == torch.bfloat16 else ''}{floor:.3e}), gradient "
            f"{gdiff:.3e} ({gfloor:.3e})")
        if not (ok and gok and out.dtype == dtype and grad.dtype == dtype):
            raise AssertionError(f"op api {label}: beyond its limit")
        if aligned:
            name = f"op api aligned, P={p} R={rois[p].shape[1]}"
            if dtype == torch.float32:
                check_k2(name, [f], rois[p], levels, p, fmax, strides=strides, aligned=True)
                check_k3(name, gd, level_hw, rois[p], levels, strides=strides, aligned=True)
            else:
                check_k2_bf16(name, [f], rois[p], levels, p, fmax, strides=strides,
                              aligned=True)
                check_k3_bf16(name, gd, level_hw, rois[p], levels, strides=strides,
                              aligned=True)
        fwd_ms = cuda_ms(lambda: ra.multilevel_roi_align_cuda([f], rois[p], levels, strides, p,
                                                              2, aligned))
        fwd_plain = cuda_ms(lambda: ra.multilevel_roi_align_plain(
            [f], rois[p], levels, strides, p, 2, aligned), iters=5, warmup=1)
        b_ms, b_by, _ = k2_bound([f], rois[p], levels, p, strides=strides, aligned=aligned)
        bwd_ms = cuda_ms(lambda: ra.multilevel_roi_align_bwd_cuda(gd, level_hw, rois[p], levels,
                                                                  strides, 2, aligned))
        bwd_plain = cuda_ms(lambda: ra.multilevel_roi_align_bwd_plain(
            gd, level_hw, rois[p], levels, strides, 2, aligned), iters=5, warmup=1)
        k3_ms, k3_by, _ = k3_bound(gd, level_hw)
        log(f"{tag} {label}: K2 {fwd_ms:.4f} ms (plain {fwd_plain:.3f}, bound {b_ms:.4f}, "
            f"{b_by}), K3 {bwd_ms:.4f} ms (plain {bwd_plain:.3f}, bound {k3_ms:.4f}, {k3_by})")
        case = dict(case=f"P{p} R{rois[p].shape[1]} one level aligned={aligned}", path="op_api",
                    dtype=str(dtype)[6:])
        k2_cases.append(dict(case, ms=fwd_ms, plain_ms=fwd_plain, bound_ms=b_ms, bound_by=b_by,
                             max_abs_err=diff))
        k3_cases.append(dict(case, ms=bwd_ms, plain_ms=bwd_plain, bound_ms=k3_ms,
                             bound_by=k3_by, max_abs_err=gdiff))

    stress = np.random.RandomState(seed + 1)
    f16 = feat.bfloat16()
    for kind in ALIGNED_STRESS:
        for p in (7, 14):
            r = OP_STRESS_ROIS
            rs = torch.tensor(aligned_stress_rois(stress, kind, 2, r, (h, w), OP_STRIDE),
                              device=dev)
            levels = torch.zeros((2, r), dtype=torch.int32, device=dev)
            gs = torch.tensor(stress.randn(2, r, p, p, c).astype(np.float32), device=dev)
            name = f"op api aligned stress: {kind}, P={p} R={r}"
            fmax = float(feat.abs().max())
            check_k2(name, [feat], rs, levels, p, fmax, strides=strides, aligned=True)
            check_k2_bf16(name, [f16], rs, levels, p, float(f16.float().abs().max()),
                          strides=strides, aligned=True)
            check_k3(name, gs, level_hw, rs, levels, strides=strides, aligned=True)
            check_k3_bf16(name, gs.bfloat16(), level_hw, rs, levels, strides=strides,
                          aligned=True)
            if kind == "zero extent":
                # the pre-pass's cell range of each zero-extent axis: one or two cells
                bounds = ra.roi_tap_bounds_cuda(level_hw, rs, levels, strides, p, 2, True)
                for axis, (lo, hi) in enumerate(((0, 1), (2, 3))):
                    flat = rs[..., 2 + axis] == rs[..., axis]
                    span = (bounds[..., hi] - bounds[..., lo])[flat]
                    log(f"{tag} zero extent along {'xy'[axis]}: {int(flat.sum())} RoIs, cells "
                        f"{sorted(set((span + 1).tolist()))}")
                    if not bool(((span >= 0) & (span <= 1)).all()):
                        raise AssertionError(f"op api: a zero-extent RoI folds onto more than "
                                             f"two cells along {'xy'[axis]}")

    check_former_refusals()
    reset_counts()
    return counts, k2_cases, k3_cases


def check_former_refusals():
    """Single-level roi_align on the card takes what the narrow kernels
    once refused at the call, float32 C=6, bf16 C=12 and P x S = 65 samples
    an axis: forward and gradient against the plain versions within phases
    4 and 7's limits."""
    from detectron_tpu_torch.ops import roi_align as ra

    dev = torch.device(DEVICE)
    rng = np.random.RandomState(291)
    box = torch.tensor([[[0.0, 0.0, 32.0, 32.0], [3.5, 1.0, 60.0, 40.0]]], device=dev)
    level = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    for c, dtype, p, s in ((6, torch.float32, 7, 2), (12, torch.bfloat16, 7, 2),
                           (4, torch.float32, 13, 5)):
        feat = torch.tensor(rng.randn(1, 8, 8, c).astype(np.float32), device=dev).to(dtype)
        leaf = feat.clone().requires_grad_(True)
        out = ra.roi_align(leaf, box, 8, output_size=p, sampling_ratio=s)
        g = torch.tensor(rng.randn(*out.shape).astype(np.float32), device=dev).to(dtype)
        (grad,) = torch.autograd.grad(out, leaf, grad_outputs=g)
        want = ra.multilevel_roi_align_plain([feat], box, level, (8,), p, s)
        (want_grad,) = ra.multilevel_roi_align_bwd_plain(g, [(8, 8)], box, level, (8,), s)
        torch.cuda.synchronize()
        floor = 1e-5 * float(feat.float().abs().max())
        gfloor = 1e-5 * float(want_grad.float().abs().max())
        if dtype == torch.bfloat16:
            (diff, ok), (gdiff, gok) = within_bf16(out, want, floor), within_bf16(
                grad, want_grad, gfloor)
        else:
            diff, gdiff = float((out - want).abs().max()), float((grad - want_grad).abs().max())
            ok, gok = diff <= floor, gdiff <= gfloor
        log(f"[op api] taken at the call: {str(dtype)[6:]} C={c} P={p} S={s}: forward max "
            f"|diff| {diff:.3e}, gradient {gdiff:.3e}")
        if not (ok and gok and out.shape == want.shape):
            raise AssertionError(f"op api: roi_align {dtype} C={c} P x S={p * s} beyond its "
                                 "limits")


# ----------------------------------------------------------------- phase 30

# K1 bf16 at phase 3's shapes: every NMS_CASES shape and the first two wide
# ones (N = 8193 and 10000)
CONTRACT_NMS_CASES = NMS_CASES + NMS_WIDE_CASES[:2]
# the class-aware cases (81 classes shifted apart): detections, RetinaNet
CONTRACT_CLASS_AWARE = ("det", "retinanet")
# pairs whose IoU after the bf16 steps is exactly the bf16 threshold: inter
# 70 of union 100 (bf16(0.7) = 0.69921875, rounded down) and 30 of 100
# (bf16(0.3) = 0.30078125, rounded up: above 0.3 itself); apart from each
# other and from nms_problems' clusters
EXACT_PAIRS = (([0.0, 0.0, 10.0, 10.0], [0.0, 0.0, 10.0, 7.0]),
               ([-64.0, 0.0, -54.0, 10.0], [-64.0, 0.0, -54.0, 3.0]))
CONTRACT_LEVELS = (8, 16, 32)  # P3-P5 of the canvas
TEN_LEVELS = tuple(2 ** i for i in range(1, 11))  # strides 2..1024: 512x672 down to 1x1
# (name, C, dtypes, P, S, R an image, strides, misaligned): the inputs the
# narrow instances did not take, each through padding, a copy or the wide
# route (C=64 where the plain versions' [B, R, PS, PS, C] samples would
# otherwise hold phase 30 past its 30 s)
CONTRACT_ROI_CASES = (
    ("C=30", 30, ("float32",), 7, 2, 512, CONTRACT_LEVELS, False),
    ("C=30", 30, ("float32",), 14, 2, 128, CONTRACT_LEVELS, False),
    ("C=36", 36, ("bfloat16",), 7, 2, 512, CONTRACT_LEVELS, False),
    ("C=36", 36, ("bfloat16",), 14, 2, 128, CONTRACT_LEVELS, False),
    ("misaligned view", 256, ("float32", "bfloat16"), 7, 2, 512, CONTRACT_LEVELS, True),
    ("P*S=112", 64, ("float32", "bfloat16"), 28, 4, 128, CONTRACT_LEVELS, False),
    ("pool_size=33", 64, ("float32", "bfloat16"), 33, 2, 512, CONTRACT_LEVELS, False),
    ("10 levels", 64, ("float32", "bfloat16"), 7, 2, 512, TEN_LEVELS, False),
)
# (name, P, S, R an image, C): the wide cases again at the main path's
# width, timed only
CONTRACT_WIDE_TIMED = (("P*S=112", 28, 4, 128, 256), ("pool_size=33", 33, 2, 512, 256))
CONTRACT_MODEL = ["model.dtype=bfloat16", "model.fpn_channels=36"]


def contract_levels(rng, c, strides, misaligned, b=2):
    """Seeded NHWC levels of the canvas at ``strides``, float32; with
    ``misaligned`` each the view ``[..., 1:]`` of a C + 1 tensor."""
    out = []
    for st in strides:
        h, w = max(CANVAS[0] // st, 1), max(CANVAS[1] // st, 1)
        x = torch.tensor(rng.randn(b, h, w, c + int(misaligned)).astype(np.float32),
                         device=DEVICE)
        out.append(x[..., 1:] if misaligned else x)
    return out


def exact_pair_problems(g=2, n=300, seed=31):
    """bf16 problems whose first two pairs sit exactly at the bf16
    thresholds of EXACT_PAIRS, top-scored; the rest clustered."""
    rng = np.random.RandomState(seed)
    boxes, scores, valid, _ = nms_problems(rng, g, n, (512, 512), 20)
    for k, (a, b) in enumerate(EXACT_PAIRS):
        boxes[:, 2 * k], boxes[:, 2 * k + 1] = a, b
    scores[:, :4] = [2.0, 1.9, 1.8, 1.7]
    return [torch.tensor(x, device=DEVICE) for x in (boxes, scores, valid)]


def phase_contracts(seed=30):
    """Phase 30: what the card takes beyond the narrow instances.

    K1 bf16: a path run (counts set to 0 just before, read just after) of
    ``nms_wrapper.nms(impl="pallas")`` on one bf16 problem of each
    CONTRACT_NMS_CASES shape and ``class_aware_nms`` on bf16 boxes at
    CONTRACT_CLASS_AWARE's shapes, each against the plain walk exactly
    (``impl="jnp"``); then the kernel against its plain walk exactly at
    every case's G problems, with and without max_keep, and at IoUs exactly
    at the bf16 thresholds 0.7 and 0.3, offsets 0 and 1; timed whole and as
    its two launches. K2 and K3: a path run of CONTRACT_ROI_CASES through
    ``multilevel_roi_align`` forward and gradient, each held against the
    plain versions within phases 4 and 7's limits; K2 rerun bitwise and, in
    bf16, within one step of the fp32 kernel; K3 bf16's pre-pass against
    roi_tap_cell_bounds; each timed, the copy that padding or realigning
    costs timed alone, and CONTRACT_WIDE_TIMED timed at C=256. Then Mask R-CNN R-50-FPN at CONTRACT_MODEL (phase
    5's config, bf16, 36 FPN channels): built on the card, one predict call
    counted and one held (``hold_path``). Returns (K1 bf16's entry cases,
    its launches, K2 cases, K3 cases, {path: launches})."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models.zoo import build_detector
    from detectron_tpu_torch.ops import nms, nms_wrapper
    from detectron_tpu_torch.ops import roi_align as ra

    dev = torch.device(DEVICE)
    rng = np.random.RandomState(seed)
    tag = "[contracts]"
    t_phase = time.perf_counter()

    # K1 bf16: the problems, bf16 boxes (class shifts applied in bf16, as
    # class_aware_nms applies them)
    problems = []
    for case in CONTRACT_NMS_CASES:
        boxes, scores, valid, cls = nms_problems(rng, case["g"], case["n"], CANVAS,
                                                 case["n_invalid"], case["classes"])
        tb, ts, tv = (torch.tensor(x, device=dev) for x in (boxes, scores, valid))
        tc = None if cls is None else torch.tensor(cls, device=dev)
        problems.append((case, tb.bfloat16(), ts, tv, tc))

    # the path: every call through the public functions, launches counted
    torch.cuda.synchronize()
    reset_counts()
    singles = [nms_wrapper.nms(tb[0], ts[0], case["thresh"], case["max_out"], valid=tv[0],
                               impl="pallas") for case, tb, ts, tv, _ in problems]
    aware = [nms.class_aware_nms(tb, ts, tc, case["thresh"], case["max_out"], valid=tv)
             for case, tb, ts, tv, tc in problems if case["name"] in CONTRACT_CLASS_AWARE]
    torch.cuda.synchronize()
    counts = read_counts()
    reset_counts()
    want = {"greedy_nms": len(singles) + len(aware), "multilevel_roi_align": 0,
            "multilevel_roi_align_bwd": 0, "anchor_match": 0}
    log(f"{tag} K1 bf16 path: launches {counts} (want {want})")
    if counts != want:
        raise AssertionError(f"contracts: K1 bf16 launches {counts}, want {want}")
    k1_launches = counts["greedy_nms"]
    for (case, tb, ts, tv, _), (idx, ok) in zip(problems, singles):
        want_idx, want_ok = nms_wrapper.nms(tb[0], ts[0], case["thresh"], case["max_out"],
                                            valid=tv[0], impl="jnp")
        same = torch.equal(idx, want_idx) and torch.equal(ok, want_ok)
        log(f"{tag} nms bf16 {case['name']}: N={case['n']}, {int(ok.sum())} kept; "
            f"impl='pallas' equal to impl='jnp': {same}")
        if not same:
            raise AssertionError(f"contracts: nms bf16 {case['name']}: pallas != jnp")
    aware_cases = [p for p in problems if p[0]["name"] in CONTRACT_CLASS_AWARE]
    for (case, tb, ts, tv, tc), (idx, ok) in zip(aware_cases, aware):
        span = tb.amax(dim=(1, 2)) - tb.amin(dim=(1, 2)) + 1.0
        shifted = tb + (tc.to(tb.dtype) * span[:, None])[..., None]
        want_idx, want_ok = nms.nms_padded_batched(shifted, ts, tv, case["thresh"],
                                                   case["max_out"],
                                                   keep_fn=nms.greedy_keep_plain)
        same = torch.equal(idx, want_idx) and torch.equal(ok, want_ok)
        log(f"{tag} class_aware_nms bf16 {case['name']}: G={case['g']} N={case['n']}, "
            f"{int(ok.sum())} kept; equal to the plain walk: {same}")
        if not same or shifted.dtype != torch.bfloat16:
            raise AssertionError(f"contracts: class_aware_nms bf16 {case['name']} differs")

    # the kernel against its plain walk at every case's G problems
    k1_cases = []
    for case, tb, ts, tv, tc in problems:
        if tc is not None:
            span = tb.amax(dim=(1, 2)) - tb.amin(dim=(1, 2)) + 1.0
            tb = tb + (tc.to(tb.dtype) * span[:, None])[..., None]
        sboxes, svalid = sorted_problems(tb, ts, tv)
        g, n, thresh = case["g"], case["n"], case["thresh"]
        m = min(case["max_out"], n)
        full = nms.greedy_keep_cuda(sboxes, svalid, thresh)
        keep = nms.greedy_keep_cuda(sboxes, svalid, thresh, max_keep=m)
        plain = nms.greedy_keep_plain(sboxes, svalid, thresh)
        torch.cuda.synchronize()
        same = torch.equal(full, plain) and torch.equal(keep, plain & (plain.cumsum(1) <= m))
        ms = cuda_ms(lambda: nms.greedy_keep_cuda(sboxes, svalid, thresh, max_keep=m), iters=10)
        mask = nms.nms_mask_cuda(sboxes, thresh)
        mask_ms = cuda_ms(lambda: nms.nms_mask_cuda(sboxes, thresh), iters=10)
        scan_ms = cuda_ms(lambda: nms.nms_scan_cuda(mask, svalid, m), iters=10)
        timed_plain = case["path"] == "train"
        plain_ms = cuda_ms(lambda: nms.greedy_keep_plain(sboxes, svalid, thresh, max_keep=m),
                           iters=1, warmup=0) if timed_plain else None
        pos = torch.arange(n, device=dev)[None, :]
        n_valid = svalid.sum(1, keepdim=True)
        last = torch.where(keep, pos, torch.full_like(pos, -1)).amax(1, keepdim=True)
        stop = torch.where(keep.sum(1, keepdim=True) >= m, last, torch.full_like(last, n - 1))
        upto = torch.minimum(n_valid, stop + 1)
        pairs = int(torch.where(keep, upto - 1 - pos, torch.zeros_like(pos)).sum())
        # 8 bytes a bf16 box; per pair ~24 operations with the bf16 roundings
        b_ms, b_by = bound_ms(nbytes=g * n * (8 + 1 + 1), ops=pairs * 24)
        log(f"{tag} K1 bf16 {case['name']}: G={g} N={n} t={thresh} "
            f"(bf16 {nms.threshold_in(thresh, torch.bfloat16)}) max_keep={m}: keep masks equal "
            f"to the plain walk with and without max_keep: {same} ({int(keep.sum())} of "
            f"{int(full.sum())} kept); kernel {ms:.4f} ms (mask {mask_ms:.4f} + scan "
            f"{scan_ms:.4f})" + (f", plain {plain_ms:.3f} ms" if timed_plain else "")
            + f", bound {b_ms:.6f} ms ({b_by})")
        if not same:
            raise AssertionError(f"contracts: K1 bf16 {case['name']} differs from its plain walk")
        k1_cases.append(dict(case=case["name"], path=case["path"], dtype="bfloat16",
                             max_keep=m, ms=ms, mask_ms=mask_ms, scan_ms=scan_ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
        del mask
    for thresh in (0.7, 0.3):
        for offset in (0.0, 1.0):
            tb, ts, tv = exact_pair_problems()
            sboxes, svalid = sorted_problems(tb.bfloat16(), ts, tv)
            got = nms.greedy_keep_cuda(sboxes, svalid, thresh, offset)
            want_keep = nms.greedy_keep_plain(sboxes, svalid, thresh, offset)
            torch.cuda.synchronize()
            pairs_kept = got[:, :4].tolist()
            log(f"{tag} K1 bf16 exact thresholds: t={thresh} offset={offset}: keep masks equal "
                f"{torch.equal(got, want_keep)}; the pairs' flags {pairs_kept[0]}")
            if not torch.equal(got, want_keep):
                raise AssertionError(f"contracts: K1 bf16 at the exact threshold {thresh}")
    log(f"{tag} K1 bf16 part: {time.perf_counter() - t_phase:.1f} s")

    # K2 and K3: the path, counted
    t_roi = time.perf_counter()
    inputs = []
    for name, c, dtypes, p, s, r, strides, misaligned in CONTRACT_ROI_CASES:
        feats = contract_levels(rng, c, strides, misaligned)
        rois = torch.tensor(roi_cases(rng, 2, r, CANVAS), device=dev)
        g = torch.tensor(rng.randn(2, r, p, p, c).astype(np.float32), device=dev)
        for dtype in dtypes:
            inputs.append((name, getattr(torch, dtype), p, s, strides, feats, rois, g))
    torch.cuda.synchronize()
    reset_counts()
    outs = []
    for name, dtype, p, s, strides, feats, rois, g in inputs:
        leaves = [f.detach().to(dtype) for f in feats]
        if name == "misaligned view" and dtype != torch.float32:  # the views of the cast, as misaligned as the float32 ones
            leaves = [torch.cat([torch.zeros_like(x[..., :1]), x], -1)[..., 1:] for x in leaves]
        leaves = [x.requires_grad_(True) for x in leaves]
        out = ra.multilevel_roi_align(leaves, rois, strides, p, s,
                                      min_level=int(np.log2(strides[0])),
                                      max_span=(28.0, 44.0))
        grads = torch.autograd.grad(out, leaves, grad_outputs=g.to(dtype))
        outs.append(([x.detach() for x in leaves], out.detach(), grads))
    torch.cuda.synchronize()
    counts = read_counts()
    reset_counts()
    want = {"greedy_nms": 0, "multilevel_roi_align": len(inputs),
            "multilevel_roi_align_bwd": len(inputs), "anchor_match": 0}
    log(f"{tag} K2/K3 path: launches {counts} (want {want})")
    if counts != want:
        raise AssertionError(f"contracts: K2/K3 launches {counts}, want {want}")
    roi_launches = counts
    k2_cases, k3_cases = [], []
    for (name, dtype, p, s, strides, _, rois, g), (feats, out, grads) in zip(inputs, outs):
        dname = str(dtype)[6:]
        label = f"{name} {dname} P={p} S={s} R={rois.shape[1]} C={feats[0].shape[-1]}"
        level_hw = [tuple(f.shape[1:3]) for f in feats]
        levels = ra.assign_fpn_levels(rois, len(feats), int(np.log2(strides[0])),
                                      max_span=(28.0, 44.0))
        gd = g.to(dtype)
        want = ra.multilevel_roi_align_plain(feats, rois, levels, strides, p, s)
        want_grads = ra.multilevel_roi_align_bwd_plain(gd, level_hw, rois, levels, strides, s)
        again = ra.multilevel_roi_align_cuda(feats, rois, levels, strides, p, s)
        torch.cuda.synchronize()
        floor = 1e-5 * max(float(f.float().abs().max()) for f in feats)
        gfloor = 1e-5 * max(float(w.float().abs().max()) for w in want_grads)
        if dtype == torch.bfloat16:
            diff, ok = within_bf16(out, want, floor)
            checks = [within_bf16(x, w, gfloor) for x, w in zip(grads, want_grads)]
            f32 = ra.multilevel_roi_align_cuda([f.float() for f in feats], rois, levels,
                                               strides, p, s).to(torch.bfloat16)
            steps = bf16_steps(out, f32)
        else:
            diff = float((out - want).abs().max())
            ok = diff <= floor
            checks = [(float((x - w).abs().max()), float((x - w).abs().max()) <= gfloor)
                      for x, w in zip(grads, want_grads)]
            steps = 0
        gdiff, gok = max(x[0] for x in checks), all(x[1] for x in checks)
        same = torch.equal(out, again)
        cp = ra.padded_channels(feats[0].shape[-1], dtype)
        routes = ["narrow" if ra.narrow_takes(kind, cp, p, s, len(feats)) else "wide"
                  for kind in ((ra.K2_BF16, ra.K3_BF16) if dtype == torch.bfloat16
                               else (ra.K2_F32, ra.K3_F32))]
        bounds_off = 0
        if dtype == torch.bfloat16:
            bounds = ra.roi_tap_bounds_cuda(level_hw, rois, levels, strides, p, s)
            bounds_off = int((bounds != ra.roi_tap_cell_bounds(level_hw, rois, levels, strides,
                                                               p, s)).any(-1).sum())
        log(f"{tag} {label}: K2 {routes[0]}, K3 {routes[1]} route; forward max |diff| "
            f"{diff:.3e} (limit {'one bf16 step + ' if dtype == torch.bfloat16 else ''}"
            f"{floor:.3e}), rerun bitwise equal {same}"
            + (f", {steps} bf16 steps from the fp32 kernel" if dtype == torch.bfloat16 else "")
            + f"; gradient {gdiff:.3e} ({gfloor:.3e})"
            + (f"; pre-pass bounds off for {bounds_off} RoIs" if dtype == torch.bfloat16
               else ""))
        if not (ok and gok and same and steps <= 1 and bounds_off == 0
                and out.dtype == dtype and all(x.dtype == dtype for x in grads)):
            raise AssertionError(f"contracts: {label} beyond its limits")
        del want, want_grads, again
        # times: the whole call, and the copy that padding or realigning costs
        fwd_ms = cuda_ms(lambda: ra.multilevel_roi_align_cuda(feats, rois, levels, strides, p,
                                                              s), iters=5, warmup=1)
        bwd_ms = cuda_ms(lambda: ra.multilevel_roi_align_bwd_cuda(gd, level_hw, rois, levels,
                                                                  strides, s), iters=5,
                         warmup=1)
        copy_ms = 0.0
        if cp != feats[0].shape[-1] or not feats[0].is_contiguous():
            copy_ms = cuda_ms(lambda: [ra.kernel_ready(f, cp) for f in feats], iters=5)
        k2_ms, k2_by, _ = k2_bound(feats, rois, levels, p, s, strides)
        k3_ms, k3_by, _ = k3_bound(gd, level_hw, s)
        log(f"{tag} {label}: K2 {fwd_ms:.4f} ms (bound {k2_ms:.4f}, {k2_by}), K3 "
            f"{bwd_ms:.4f} ms (bound {k3_ms:.4f}, {k3_by}); the levels' copy "
            f"{copy_ms:.4f} ms of it")
        case = dict(case=label, path="contracts", dtype=dname, route=routes[0])
        k2_cases.append(dict(case, ms=fwd_ms, copy_ms=copy_ms, plain_ms=None, bound_ms=k2_ms,
                             bound_by=k2_by, max_abs_err=diff))
        k3_cases.append(dict(case, route=routes[1], ms=bwd_ms, plain_ms=None, bound_ms=k3_ms,
                             bound_by=k3_by, max_abs_err=gdiff))
    del inputs, outs
    # the wide route at the main path's width, C=256: timed only (its
    # kernels are held above at C=64)
    for name, p, s, r, c in CONTRACT_WIDE_TIMED:
        feats = contract_levels(rng, c, CONTRACT_LEVELS, False)
        rois = torch.tensor(roi_cases(rng, 2, r, CANVAS), device=dev)
        levels = ra.assign_fpn_levels(rois, len(feats), 3, max_span=(28.0, 44.0))
        level_hw = [tuple(f.shape[1:3]) for f in feats]
        # made on the card: a host draw of this g (2 x 512 x 33 x 33 x 256)
        # would take seconds
        g = torch.randn((2, r, p, p, c), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(seed))
        for dtype in (torch.float32, torch.bfloat16):
            fs, gd = [f.to(dtype) for f in feats], g.to(dtype)
            fwd_ms = cuda_ms(lambda: ra.multilevel_roi_align_cuda(
                fs, rois, levels, CONTRACT_LEVELS, p, s), iters=5, warmup=1)
            bwd_ms = cuda_ms(lambda: ra.multilevel_roi_align_bwd_cuda(
                gd, level_hw, rois, levels, CONTRACT_LEVELS, s), iters=5, warmup=1)
            k2_ms, k2_by, _ = k2_bound(fs, rois, levels, p, s, CONTRACT_LEVELS)
            k3_ms, k3_by, _ = k3_bound(gd, level_hw, s)
            log(f"{tag} {name} {str(dtype)[6:]} P={p} S={s} R={r} C={c}, timed only: K2 "
                f"{fwd_ms:.4f} ms (bound {k2_ms:.4f}, {k2_by}), K3 {bwd_ms:.4f} ms (bound "
                f"{k3_ms:.4f}, {k3_by})")
        del feats, g, fs, gd
    # the padding's copy at phase 5's levels (P2-P5), C=30
    p2p5 = contract_levels(rng, 30, STRIDES, False)
    pad_ms = cuda_ms(lambda: [ra.kernel_ready(f, 32) for f in p2p5])
    log(f"{tag} padding C=30 to 32 at P2-P5 of the canvas, batch 2: {pad_ms:.4f} ms")
    del p2p5
    log(f"{tag} K2/K3 part: {time.perf_counter() - t_roi:.1f} s")

    # Mask R-CNN at 36 FPN channels in bf16: builds, predicts, every launch held
    t_model = time.perf_counter()
    cfg = get_config(MASK_R50, CONTRACT_MODEL)
    det = build_detector(cfg)  # the card: no refusal when built
    params = raise_class_bias(det.init(seed), RAISED_CLASSES)
    batch = slice_inputs(cfg, seed, det.device)
    torch.cuda.synchronize()
    reset_counts()
    with kernel_dtypes() as seen:
        dets, masks = det.predict_fn(params, batch)
    torch.cuda.synchronize()
    model_counts = read_counts()
    reset_counts()
    n_dets = int(dets.valid.sum())
    log(f"{tag} mask_rcnn {' '.join(CONTRACT_MODEL)} at {tuple(cfg.data.image_size)}, batch "
        f"{batch['image'].shape[0]}: launches {model_counts}, kernel input dtypes "
        f"{dict(sorted((k, sorted(v)) for k, v in seen.items()))}, detections {n_dets}")
    if (model_counts["greedy_nms"] != 2 or model_counts["multilevel_roi_align"] != 2
            or seen.get("multilevel_roi_align") != {"bfloat16"}):
        raise AssertionError(f"contracts: the 36-channel model launched {model_counts} on {seen}")
    if not (n_dets and bool(torch.isfinite(dets.boxes).all())
            and bool(torch.isfinite(masks.float()).all())):
        raise AssertionError(f"contracts: {n_dets} detections, or non-finite outputs")
    held = hold_path(lambda: det.predict_fn(params, batch), "contracts fpn_channels=36 bf16")
    if held["multilevel_roi_align"][0] != 2 or held["greedy_nms"][0] != 2:
        raise AssertionError(f"contracts: held {held}")
    del det, params
    log(f"{tag} model part: {time.perf_counter() - t_model:.1f} s; phase 30 "
        f"{time.perf_counter() - t_phase:.1f} s")
    return k1_cases, k1_launches, k2_cases, k3_cases, dict(
        contracts=roi_launches, predict_fpn36_bf16=model_counts)



# ---------------------------------------------------------------- phase 31

FROZEN_BN_BATCH = 16  # the bulk cell's batch, at CANVAS
FROZEN_BN_LAYOUTS = (("bfloat16", "channels_last"), ("float32", "nchw"),
                     ("bfloat16", "nchw"), ("float32", "channels_last"))


def frozen_bn_passes(depth="resnet50") -> list:
    """Each frozen-norm pass of one ResNet forward at CANVAS, in order:
    ``(name, form, C, H, W)`` (the downsample norm rides in its block's
    ``bn3`` pass)."""
    from detectron_tpu_torch.models.resnet import STAGE_BLOCKS

    h, w = (CANVAS[0] + 1) // 2, (CANVAS[1] + 1) // 2  # the 7x7/2 stem
    out = [("stem", "affine", 64, h, w)]
    h, w = (h + 1) // 2, (w + 1) // 2  # the 3x3/2 max-pool
    features = 64
    for stage, blocks in enumerate(STAGE_BLOCKS[depth]):
        for i in range(blocks):
            name = f"layer{stage + 1}.{i}"
            out.append((f"{name}.bn1", "affine", features, h, w))
            if stage > 0 and i == 0:
                h, w = (h + 1) // 2, (w + 1) // 2  # the 3x3's stride
            out.append((f"{name}.bn2", "affine", features, h, w))
            out.append((f"{name}.bn3", "downsample" if i == 0 else "identity",
                        4 * features, h, w))
        features *= 2
    return out


def frozen_bn_bytes(form, n, elem, backward=False) -> float:
    """What one pass must move: the affine reads x and writes y; a residual
    form also reads r or d; the backward reads g and y and writes gx, and
    gr in a residual form."""
    tensors = (3 + (form != "affine")) if backward else (2 + (form != "affine"))
    return tensors * n * elem


def frozen_bn_case(rng, form, c, h, w, dtype, layout, batch):
    """The kernel against its plain twin, bit for bit, forward and backward,
    at one shape; each timed, beside its bytes bound and the eager chain
    (the scale and bias from the four buffers, then the plain twin)."""
    from detectron_tpu_torch.ops import frozen_bn as fb

    dev = torch.device(DEVICE)
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
    shape = (batch, c, h, w)

    def tensor():
        return torch.randn(shape, device=dev, dtype=dt).contiguous(memory_format=fmt)

    def buffers():
        return [torch.tensor(v.astype(np.float32), device=dev)
                for v in (1 + 0.3 * rng.randn(c), 0.3 * rng.randn(c), 0.5 * rng.randn(c),
                          0.5 + rng.rand(c))]

    def scale_bias(weight, bias, mean, var):
        scale = weight * torch.rsqrt(var + 1e-5)
        return scale.to(dt), (bias - mean * scale).to(dt)

    x, g, r = tensor(), tensor(), tensor() if form != "affine" else None
    norms = [buffers()] + ([buffers()] if form == "downsample" else [])

    def call_args():  # the scale and bias worked out anew, as the eager chain did
        sb = [scale_bias(*nb) for nb in norms] + [(None, None)]
        return (x, *sb[0], r, *sb[1])

    args = call_args()
    code = fb.FORMS.index(form)
    y = fb.frozen_bn_act_cuda(*args)
    want = fb.frozen_bn_act_plain(*args)
    gx, gr = fb.frozen_bn_act_backward_cuda(g, y, args[1], args[4], code)
    wx, wr = fb.frozen_bn_act_backward_plain(g, want, args[1], args[4], code)
    torch.cuda.synchronize()
    bits = torch.int16 if dt == torch.bfloat16 else torch.int32

    def same(a, b):
        return a is None and b is None or torch.equal(a.contiguous().view(bits),
                                                      b.contiguous().view(bits))

    n, elem = x.numel(), x.element_size()
    return dict(form=form, c=c, h=h, w=w, batch=batch, dtype=dtype, layout=layout,
                bitwise=bool(same(y, want) and same(gx, wx) and same(gr, wr)
                             and y.is_contiguous(memory_format=fmt)),
                ms=cuda_ms(lambda: fb.frozen_bn_act_cuda(*args)),
                plain_ms=cuda_ms(lambda: fb.frozen_bn_act_plain(*call_args())),
                bound_ms=bound_ms(frozen_bn_bytes(form, n, elem), 0.0)[0],
                bwd_ms=cuda_ms(lambda: fb.frozen_bn_act_backward_cuda(g, y, args[1], args[4],
                                                                      code)),
                bwd_plain_ms=cuda_ms(lambda: fb.frozen_bn_act_backward_plain(
                    g, y, args[1], args[4], code)),
                bwd_bound_ms=bound_ms(frozen_bn_bytes(form, n, elem, True), 0.0)[0],
                bound_by="bytes")


def phase_frozen_bn(seed=31):
    """Phase 31: frozen BatchNorm, its ReLU and the residual add in one pass
    (``csrc/frozen_bn.cu``). At every distinct pass of a ResNet-50 forward
    at batch FROZEN_BN_BATCH and CANVAS, in each form, dtype and layout
    (FROZEN_BN_LAYOUTS): the kernel against its plain twin bit for bit,
    forward and backward (gx, and gr in the residual forms); each timed
    beside its bytes bound and the eager chain it replaced; summed over one
    forward. Then the launches of one Mask R-CNN R-50-FPN predict call and
    one R-101 training step in bf16 at batch 2 (a pass a norm but the
    downsamples': 49 and 100 forward; 90 backward, the norms of layer2-4).
    Returns (the cases, {path: launches}, {"dtype layout": totals})."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models.resnet import STAGE_BLOCKS
    from detectron_tpu_torch.models.zoo import build_detector
    from detectron_tpu_torch.ops import frozen_bn as fb
    from detectron_tpu_torch.train.state import train_step

    rng = np.random.RandomState(seed)
    passes = frozen_bn_passes()
    distinct = {}  # shape -> [passes a forward, of them in layer2-4 (a backward's)]
    for name, form, c, h, w in passes:
        count = distinct.setdefault((form, c, h, w), [0, 0])
        count[0] += 1
        count[1] += name.startswith(("layer2", "layer3", "layer4"))
    cases, summary = [], {}
    for dtype, layout in FROZEN_BN_LAYOUTS:
        tag = f"frozen_bn {dtype} {layout}"
        rows = []
        for (form, c, h, w), (count, trainable) in distinct.items():
            case = frozen_bn_case(rng, form, c, h, w, dtype, layout, FROZEN_BN_BATCH)
            case.update(count=count, trainable=trainable)
            rows.append(case)
            log(f"[{tag}] {form} C={c} {h}x{w} x{count}: bitwise {case['bitwise']}; "
                f"{case['ms']:.4f} ms (bound {case['bound_ms']:.4f}, eager "
                f"{case['plain_ms']:.4f}); backward {case['bwd_ms']:.4f} ms (bound "
                f"{case['bwd_bound_ms']:.4f}, eager {case['bwd_plain_ms']:.4f})")
            torch.cuda.empty_cache()
        cases += rows
        total = {k: sum(r[k] * r["count"] for r in rows) for k in ("ms", "plain_ms", "bound_ms")}
        total.update({k: sum(r[k] * r["trainable"] for r in rows)
                      for k in ("bwd_ms", "bwd_plain_ms", "bwd_bound_ms")})
        total["bound_share"] = total["bound_ms"] / total["ms"]
        summary[f"{dtype} {layout}"] = total
        log(f"[{tag}] one ResNet-50 forward at batch {FROZEN_BN_BATCH}, "
            f"{CANVAS[0]}x{CANVAS[1]} ({len(passes)} passes): {total['ms']:.3f} ms, bound "
            f"{total['bound_ms']:.3f} ({100 * total['bound_share']:.1f}% of it), eager chain "
            f"{total['plain_ms']:.3f} ms; the backward of layer2-4's passes "
            f"{total['bwd_ms']:.3f} ms (bound {total['bwd_bound_ms']:.3f}, eager "
            f"{total['bwd_plain_ms']:.3f})")
    wrong = [c for c in cases if not c["bitwise"]]
    if wrong:
        raise AssertionError(f"frozen_bn: the kernel differs from its plain twin in {wrong}")

    launches = {}
    cfg = get_config(MASK_R50, ["model.dtype=bfloat16"])
    det = build_detector(cfg)  # the card, by default
    batch = slice_inputs(cfg, seed, det.device)
    det.module.load_state_dict(det.init(seed))
    fb.frozen_bn_act_cuda.launches = fb.frozen_bn_act_backward_cuda.launches = 0
    det.predict_fn(None, batch)
    torch.cuda.synchronize()
    launches["predict_r50"] = fb.frozen_bn_act_cuda.launches
    del det
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_R101, TRAIN_OVERRIDES + ["model.dtype=bfloat16"])
    state, data = seeded_train_state(cfg, None, seed)
    fb.frozen_bn_act_cuda.launches = fb.frozen_bn_act_backward_cuda.launches = 0
    out = train_step(state, next(data))
    torch.cuda.synchronize()
    launches["forward_r101"] = fb.frozen_bn_act_cuda.launches
    launches["backward_r101"] = fb.frozen_bn_act_backward_cuda.launches
    del state, data, out
    torch.cuda.empty_cache()
    log(f"[frozen_bn] launches: {launches}")
    r50 = STAGE_BLOCKS[get_config(MASK_R50).model.backbone]
    r101 = STAGE_BLOCKS[cfg.model.backbone][cfg.model.frozen_stages:]
    want = {"predict_r50": 1 + 3 * sum(r50),
            "forward_r101": 1 + 3 * sum(STAGE_BLOCKS[cfg.model.backbone]),
            "backward_r101": 3 * sum(r101)}
    if launches != want:
        raise AssertionError(f"frozen_bn launches {launches}, want {want}")
    fb.frozen_bn_act_cuda.launches = fb.frozen_bn_act_backward_cuda.launches = 0
    return cases, launches, summary


# ---------------------------------------------------------------- phase 32

MATCH_BATCH, MATCH_SLOTS = 16, 100  # the training cell's images and gt slots
MATCH_OPS_A_PAIR = 11  # an IoU's FP32 operations where the boxes do not overlap


def match_gt(rng, b, g, canvas, objects=(1, 50)):
    """COCO-like gt for ``b`` images of ``canvas``: 1-50 boxes an image (log-
    uniform sides of 8 to 800 pixels, aspect 1:3 to 3:1, inside the canvas)
    in random slots of ``g``, the others padding. Returns numpy boxes
    ``[b, g, 4]`` float32 and classes ``[b, g]`` int64."""
    h, w = canvas
    boxes = np.zeros((b, g, 4), np.float32)
    classes = np.zeros((b, g), np.int64)
    for i in range(b):
        count = rng.randint(objects[0], min(objects[1], g) + 1)
        slots = rng.choice(g, count, replace=False)
        side = np.exp(rng.uniform(np.log(8), np.log(800), count))
        aspect = np.exp(rng.uniform(np.log(1 / 3), np.log(3), count))
        bw, bh = np.minimum(side * np.sqrt(aspect), w), np.minimum(side / np.sqrt(aspect), h)
        x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
        boxes[i, slots] = np.stack([x1, y1, x1 + bw, y1 + bh], 1)
        classes[i, slots] = rng.randint(1, 81, count)
    return boxes, classes


def match_cases(rng, anchors):
    """Phase 32's cases: ``(name, anchors, gt_boxes, gt_classes, kwargs)``,
    numpy, at the anchors of CANVAS."""
    rpn = dict(pos_iou=0.7, neg_iou=0.3, force_match=True, offset=0.0)
    cell = match_gt(rng, MATCH_BATCH, MATCH_SLOTS, CANVAS)
    same = match_gt(rng, MATCH_BATCH, MATCH_SLOTS, CANVAS)
    first = same[1].argmax(1)  # each image's first valid slot
    same[0][:] = same[0][np.arange(MATCH_BATCH), first][:, None]  # every slot its box
    picked = anchors[rng.randint(0, len(anchors), (MATCH_BATCH, MATCH_SLOTS))]
    wide = match_gt(rng, 4, 300, CANVAS, objects=(150, 250))
    at = [[1e4, 1e4, 1e4 + 10, 1e4 + 10], [1e4, 1e4, 1e4 + 10, 1e4 + 7],
          [2e4, 2e4, 2e4 + 10, 2e4 + 10], [2e4, 2e4, 2e4 + 10, 2e4 + 3]]
    at_anchors = np.concatenate([anchors, np.array(at, np.float32)], 0)
    at_gt, at_cls = match_gt(rng, 2, MATCH_SLOTS, CANVAS)
    at_gt[:, -2:], at_cls[:, -2:] = np.array(at, np.float32)[[1, 3]], 1  # IoU 0.7f and 0.3f
    # with offset 1 a box at (0, 0) overlaps the origin pixel: a 3x3 gt and a
    # one-pixel gt in every image, whose best anchors' IoUs are small (N is
    # no multiple of the kernels' 512-anchor tile)
    origin_gt, origin_cls = cell[0].copy(), cell[1].copy()
    origin_gt[:, :2] = np.array([[0, 0, 2, 2], [0, 0, 0, 0]], np.float32)
    origin_cls[:, :2] = 1
    return [
        ("cell", anchors, *cell, rpn),
        ("identical gt", anchors, *same, rpn),
        ("gt equal to anchors", anchors, picked, np.ones(picked.shape[:2], np.int32), rpn),
        ("no gt", anchors, cell[0], np.zeros_like(cell[1]), rpn),
        ("G=300", anchors, *wide, rpn),
        ("IoU at the thresholds", at_anchors, at_gt, at_cls.astype(np.int32), rpn),
        ("offset 1", anchors, *cell, dict(rpn, offset=1.0)),
        ("gt at the origin, offset 1", anchors, origin_gt, origin_cls, dict(rpn, offset=1.0)),
        ("no force match", anchors, *cell, dict(rpn, force_match=False)),
    ]


def peak_bytes(fn) -> int:
    """Device bytes that one call of ``fn`` holds at its peak, above what was
    allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - base


def phase_anchor_match(seed=32):
    """Phase 32: the RPN's anchor matching (``csrc/anchor_match.cu``) against
    its plain twin at ``match_cases``: matched, pos and neg exactly equal;
    each timed beside its bound (the IoUs' FP32 operations at
    MATCH_OPS_A_PAIR a pair and pass, or the anchors, gt and outputs'
    bytes) and the plain twin, with the peak device bytes of each. Returns
    the cases."""
    from detectron_tpu_torch.config import get_config
    from detectron_tpu_torch.models.faster_rcnn import rpn_anchor_generator
    from detectron_tpu_torch.ops import anchor_match as am

    rng = np.random.RandomState(seed)
    dev = torch.device(DEVICE)
    cfg = get_config(TRAIN_R101)
    anchors = rpn_anchor_generator(cfg).all_anchors(CANVAS).astype(np.float32)
    cases = []
    for name, anc, gt, cls, kwargs in match_cases(rng, anchors):
        args = [torch.tensor(x, device=dev) for x in (anc, gt, cls)]
        got = am.anchor_match_cuda(*args, **kwargs)
        want = am.anchor_match_plain(*args, **kwargs)
        torch.cuda.synchronize()
        equal = all(torch.equal(x, w) for x, w in zip(got, want))
        wrong = int(sum((x != w).sum() for x, w in zip(got, want)))
        b, n = got[0].shape
        pairs = n * int((cls > 0).sum()) * (2 if kwargs["force_match"] else 1)
        nbytes = anc.nbytes + gt.nbytes + cls.nbytes + b * n * (8 + 1 + 1)
        bound, by = bound_ms(nbytes, pairs * MATCH_OPS_A_PAIR)
        case = dict(case=name, batch=b, anchors=n, slots=gt.shape[1],
                    valid=int((cls > 0).sum()), **kwargs, equal=equal, wrong=wrong,
                    positives=int(got[1].sum()), negatives=int(got[2].sum()),
                    ms=cuda_ms(lambda: am.anchor_match_cuda(*args, **kwargs)),
                    plain_ms=cuda_ms(lambda: am.anchor_match_plain(*args, **kwargs), iters=3,
                                     warmup=1),
                    bound_ms=bound, bound_by=by,
                    peak_bytes=peak_bytes(lambda: am.anchor_match_cuda(*args, **kwargs)),
                    plain_peak_bytes=peak_bytes(lambda: am.anchor_match_plain(*args, **kwargs)))
        cases.append(case)
        log(f"[anchor_match] {name}: B={b} N={n} G={gt.shape[1]} ({case['valid']} valid) "
            f"offset {kwargs['offset']} force {kwargs['force_match']}: equal {equal} "
            f"({wrong} wrong), {case['positives']} pos, {case['negatives']} neg; "
            f"{case['ms']:.4f} ms (bound {bound:.4f} by {by}), plain {case['plain_ms']:.3f} ms; "
            f"peak {case['peak_bytes']:.4e} B, plain {case['plain_peak_bytes']:.4e} B")
        del args, got, want
        torch.cuda.empty_cache()
    wrong = [c["case"] for c in cases if not c["equal"]]
    if wrong:
        raise AssertionError(f"anchor_match: the kernel differs from its plain twin in {wrong}")
    return cases


# -------------------------------------------------------------------- main

KERNELS = {
    "greedy_nms": dict(source="detectron_tpu_torch/csrc/nms.cu",
                       replaces="detectron_tpu/ops/nms_pallas.py:91"),
    "multilevel_roi_align": dict(source="detectron_tpu_torch/csrc/roi_align.cu",
                                 replaces="detectron_tpu/ops/roi_align_pallas.py:192"),
    "multilevel_roi_align_bwd": dict(source="detectron_tpu_torch/csrc/roi_align.cu",
                                     replaces="detectron_tpu/ops/roi_align_pallas.py:529"),
    "frozen_bn_act": dict(source="detectron_tpu_torch/csrc/frozen_bn.cu",
                          replaces="none: the XLA-fused affine of detectron_tpu/models/resnet.py"),
    "anchor_match": dict(source="detectron_tpu_torch/csrc/anchor_match.cu",
                         replaces="none: the XLA-fused IoU and reductions of "
                                  "detectron_tpu/layers/anchor_target.py"),
}


def kernel_entry(name, cases, launches, max_abs_err):
    """One kernel's line entry. ``launches_by_path``: its launches on each
    path's run (predict, train, eval, bench, and RetinaNet's, R-FCN's and
    the RoIPool Faster R-CNN's: K1 alone); ``launches`` the training
    path's (phase 9's float32 steps), the one path that launches all
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


def k1_bf16_entry(cases, launches):
    """K1's bf16 instance, an entry of its own: ``launches`` from phase 30's
    path run (no model path hands K1 bf16 boxes: decode promotes them), the
    times of its training-shape case (G=10, N=2000; phase 9's K1 shape),
    its other cases listed beside."""
    train = [c for c in cases if c["path"] == "train"]
    return {
        "name": "greedy_nms_bf16", "route": "cuda", **KERNELS["greedy_nms"],
        "launches": launches, "launches_by_path": {"contracts": launches},
        "max_abs_err": 0.0,
        "ms": sum(c["ms"] for c in train), "plain_ms": sum(c["plain_ms"] for c in train),
        "bound_ms": sum(c["bound_ms"] for c in train), "bound_by": train[0]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
        "cases": cases,
    }


def frozen_bn_entry(cases, launches, summary):
    """Phase 31's kernel: times summed over one ResNet-50 forward's passes at
    the bulk cell's shapes in bf16 channels-last (the cells' layout), the
    other dtypes and layouts in ``summary``; ``launches`` a predict call's."""
    main = summary["bfloat16 channels_last"]
    return {
        "name": "frozen_bn_act", "route": "cuda", **KERNELS["frozen_bn_act"],
        "launches": launches["predict_r50"], "launches_by_path": launches, "max_abs_err": 0.0,
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call computes this function
        "summary": summary, "cases": cases,
    }


def anchor_match_entry(cases, launches):
    """Phase 32's kernel: the times of the training cell's case, the others
    in ``cases``; ``launches`` its counts on phase 9's steps by path
    (``train``: float32, the line's ``launches``, as K1-K3's)."""
    cell = cases[0]
    return {
        "name": "anchor_match", "route": "cuda", **KERNELS["anchor_match"],
        "launches": launches["train"], "launches_by_path": launches,
        "max_abs_err": 0.0, "ms": cell["ms"], "plain_ms": cell["plain_ms"],
        "bound_ms": cell["bound_ms"], "bound_by": cell["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
        "cases": cases,
    }


def retinanet_phases(k1) -> dict:
    """Phases 13-18, each path in both dtypes; K1's bench cases are added
    to ``k1``. Returns ``{path: launches}``."""
    retina = {}
    for dtype, sfx in (("float32", ""), ("bfloat16", "_bf16")):
        retina["retinanet_predict" + sfx] = phase_retinanet(dtype=dtype)
    phase_cross_retinanet()
    phase_cross_retinanet(dtype="bfloat16")
    for dtype, sfx in (("float32", ""), ("bfloat16", "_bf16")):
        retina["retinanet_train" + sfx] = phase_retinanet_train(dtype=dtype)[0]
        retina["retinanet_eval" + sfx] = phase_retinanet_eval(dtype=dtype)
    for dtype, sfx in ((None, "_bf16"), ("float32", "")):
        counts, _, case = phase_retinanet_bench(dtype)
        retina["retinanet_bench" + sfx] = counts
        k1.append(case)
    phase_demo()
    return retina


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", action="store_true",
                        help="run phases 1-4, 7 and 29-32 only (the kernels against their plain "
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
        del feats
        _, op_k2, op_k3 = phase_op_api()
        k1_bf16, _, c_k2, c_k3, _ = phase_contracts()
        fbn, _, fbn_summary = phase_frozen_bn()
        matching = phase_anchor_match()
        print(json.dumps({"kernel_cases": {"greedy_nms": k1, "greedy_nms_bf16": k1_bf16,
                                           "multilevel_roi_align": k2 + op_k2 + c_k2,
                                           "multilevel_roi_align_bwd": k3 + op_k3 + c_k3,
                                           "frozen_bn_act": fbn, "anchor_match": matching},
                          "frozen_bn_act": fbn_summary}), flush=True)
        print(card, flush=True)
        return 0
    predict_launches, _ = phase_slice()
    predict16_launches, _ = phase_slice(dtype="bfloat16")
    phase_cross_device()
    phase_cross_device(dtype="bfloat16")
    lap("phases 5-6")
    k3 = phase_roi_align_bwd(rng, feats)
    phase_function(rng, feats)
    del feats
    lap("phases 7-8")
    train_launches, _ = phase_train()
    train16_launches, _ = phase_train(dtype="bfloat16")
    phase_cross_train()
    lap("phases 9-10")
    eval_launches = phase_eval()
    eval16_launches = phase_eval(dtype="bfloat16")
    lap("phase 11")
    bench16_launches, _ = phase_bench()  # the bench's default, bf16
    bench_launches, _ = phase_bench("float32")
    lap("phase 12")
    retina = retinanet_phases(k1)
    lap("phases 13-18")
    rfcn = rfcn_phases(k1)
    lap("phases 19-22")
    pool_launches, _ = phase_roi_pool()
    lap("phase 23")
    phase_weights()
    lap("phase 24")
    gn_launches = {}
    for dtype in ("float32", "bfloat16"):
        gn_launches.update(phase_gn(dtype=dtype)[0])
    phase_cross_device(overrides=GN_OVERRIDES)
    phase_cross_device(dtype="bfloat16", overrides=GN_OVERRIDES, bf16_limit=CROSS_BF16_GN,
                       as_good_as_cpu=True)
    lap("phase 25")
    remat_launches, _ = phase_remat()
    lap("phase 26")
    dp_launches, _ = phase_dp()
    lap("phase 27")
    wide_launches, _ = phase_wide_nms()
    lap("phase 28")
    op_launches, op_k2, op_k3 = phase_op_api()
    k2 += op_k2
    k3 += op_k3
    lap("phase 29")
    k1_bf16, k1_bf16_launches, c_k2, c_k3, contract_launches = phase_contracts()
    k2 += c_k2
    k3 += c_k3
    lap("phase 30")
    fbn, fbn_launches, fbn_summary = phase_frozen_bn()
    lap("phase 31")
    matching = phase_anchor_match()
    lap("phase 32")

    def launches(name):
        return {"predict": predict_launches.get(name, 0), "train": train_launches[name],
                "eval": eval_launches[name], "bench": bench_launches[name],
                "predict_bf16": predict16_launches.get(name, 0),
                "train_bf16": train16_launches[name], "eval_bf16": eval16_launches[name],
                "bench_bf16": bench16_launches[name],
                **{path: counts[name] for path, counts in retina.items()},
                **{path: counts[name] for path, counts in rfcn.items()},
                **{path: counts[name] for path, counts in pool_launches.items()},
                **{path: counts[name] for path, counts in gn_launches.items()},
                **{path: counts[name] for path, counts in remat_launches.items()},
                **{path: counts[name] for path, counts in dp_launches.items()},
                **{path: counts[name] for path, counts in wide_launches.items()},
                "op_api": op_launches[name],
                **{path: counts[name] for path, counts in contract_launches.items()}}

    kernels = [
        kernel_entry("greedy_nms", k1, launches("greedy_nms"), 0.0),
        kernel_entry("multilevel_roi_align", k2, launches("multilevel_roi_align"),
                     max(c["max_abs_err"] for c in k2 if c["dtype"] == "float32")),
        kernel_entry("multilevel_roi_align_bwd", k3, launches("multilevel_roi_align_bwd"),
                     max(c["max_abs_err"] for c in k3 if c["dtype"] == "float32")),
        k1_bf16_entry(k1_bf16, k1_bf16_launches),
        frozen_bn_entry(fbn, fbn_launches, fbn_summary),
        anchor_match_entry(matching, {"train": train_launches["anchor_match"],
                                      "train_bf16": train16_launches["anchor_match"]}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
