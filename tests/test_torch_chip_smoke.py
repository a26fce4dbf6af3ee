"""A rehearsal of chip_smoke.py's kernel, training, eval and bench phases on
the CPU, so that the script's own code (phase logic, cases, checks, driver
resume, the in-memory COCO split and its oracle) is exercised before a card
runs it.

The card-only pieces are replaced: the kernels' plain versions stand in
for the CUDA wrappers (and count launches as the wrappers do), the kernel
dispatch takes them for CPU tensors, ``cuda_ms`` calls its function once
and reads 0 ms, ``torch.cuda`` synchronisation and memory calls are
stubbed, and the configs are cut to 64x128 with FPN 32, an
R-50 backbone, 256 / 64 / 64 RPN candidates, proposals and RoIs, images
resized to a short side of 48 and 20 detections an image; the NMS cases
are cut to a few hundred boxes, the bench to 128x128, batch 2, one call
and one step after its warm-ups. What the card alone can show (that a
kernel builds, agrees with its plain version, and how long it takes)
stays with chip_smoke.py.
"""

import json
import re

import numpy as np
import pytest
import torch

import chip_smoke as cs
import detectron_tpu_torch.config
from detectron_tpu_torch.models import zoo
from detectron_tpu_torch.ops import anchor_match as am
from detectron_tpu_torch.ops import conv_epilogue as ce
from detectron_tpu_torch.ops import nms
from detectron_tpu_torch.ops import roi_align as ra


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The suite runs several workers on the machine's cores; PyTorch's
    default of one intra-op thread per core in each of them only makes
    the workers contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _once(fn, iters=20, warmup=3):
    """``cuda_ms`` on the CPU: the card's time cannot be read here, so
    ``fn`` runs once (its code is rehearsed) and the time reads 0 ms."""
    fn()
    return 0.0


def _counting(module, name, plain):
    """A stand-in for ``module.name`` that counts its launches as the
    wrappers do: on the name it is bound to in its module."""
    def wrapper(*args, **kwargs):
        getattr(module, name).launches += 1
        return plain(*args, **kwargs)

    wrapper.launches = 0
    return wrapper


def _counting_match(anchors, gt_boxes, gt_classes, pos_iou, neg_iou, force_match=True,
                    offset=0.0):
    """A stand-in for ``anchor_match_cuda``: the plain twin, counting two
    kernel launches with the force match and one without, as the wrapper."""
    am.anchor_match_cuda.launches += 2 if force_match else 1
    return am.anchor_match_plain(anchors, gt_boxes, gt_classes, pos_iou, neg_iou, force_match,
                                 offset)


class _PlainFunction(ra.RoIAlignFunction):
    """RoIAlignFunction with the (counting) stand-ins on CPU tensors."""

    @staticmethod
    def forward(ctx, rois, levels, strides, output_size, sampling_ratio, aligned, *features):
        ctx.save_for_backward(rois, levels)
        ctx.strides, ctx.sampling_ratio, ctx.aligned = tuple(strides), sampling_ratio, aligned
        ctx.level_hw = [tuple(f.shape[1:3]) for f in features]
        return ra.multilevel_roi_align_cuda(features, rois, levels, strides, output_size,
                                            sampling_ratio, aligned)

    @staticmethod
    def backward(ctx, grad):
        rois, levels = ctx.saved_tensors
        grads = ra.multilevel_roi_align_bwd_cuda(grad.contiguous(), ctx.level_hw, rois,
                                                 levels, ctx.strides, ctx.sampling_ratio,
                                                 ctx.aligned)
        return (None,) * 6 + tuple(g if need else None
                                   for g, need in zip(grads, ctx.needs_input_grad[6:]))


def _listing(fn):
    """What the profiler lists on the card for one call of ``fn``: the bf16
    K2 kernel if it ran K2, else K3's two bf16 kernels."""
    before = ra.multilevel_roi_align_cuda.launches
    fn()
    kernels = (cs.K2_BF16_KERNELS if ra.multilevel_roi_align_cuda.launches > before
               else cs.K3_BF16_KERNELS)
    return [(f"void {k}<32>(...)", 1, 0.0) for k in kernels]


def _plain_accumulate(grads, grad, rois, levels, strides, sampling_ratio=2, aligned=False):
    level_hw = [tuple(t.shape[1:3]) for t in grads]
    for acc, add in zip(grads, ra.multilevel_roi_align_bwd_plain(
            grad, level_hw, rois, levels, strides, sampling_ratio, aligned)):
        acc.add_(add)


def _plain_tiles(grads, bounds, grad, rois, levels, strides, sampling_ratio=2,
                 aligned=False):
    level_hw = [tuple(t.shape[1:3]) for t in grads]
    for out, level in zip(grads, ra.multilevel_roi_align_bwd_plain(
            grad, level_hw, rois, levels, strides, sampling_ratio, aligned)):
        out.copy_(level)


@pytest.fixture
def rehearsal(monkeypatch, tmp_path):
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "CANVAS", (128, 160))
    monkeypatch.setattr(cs, "TRAIN_OUT", str(tmp_path / "train_smoke"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(cs, "cuda_ms", _once)
    monkeypatch.setattr(zoo, "resolve_device", lambda device=None: torch.device("cpu"))
    for mod, name, plain in ((nms, "greedy_keep_cuda", nms.greedy_keep_plain),
                             (ra, "multilevel_roi_align_cuda", ra.multilevel_roi_align_plain),
                             (ra, "multilevel_roi_align_bwd_cuda",
                              ra.multilevel_roi_align_bwd_plain)):
        monkeypatch.setattr(mod, name, _counting(mod, name, plain))
    monkeypatch.setattr(nms, "greedy_keep", lambda *a, **k: nms.greedy_keep_cuda(*a, **k))
    _counting_match.launches = 0
    monkeypatch.setattr(am, "anchor_match_cuda", _counting_match)
    monkeypatch.setattr(am, "anchor_match", lambda *a, **k: am.anchor_match_cuda(*a, **k))
    monkeypatch.setattr(ce, "conv_epilogue_cuda",
                        _counting(ce, "conv_epilogue_cuda", ce.conv_epilogue_plain))
    monkeypatch.setattr(ce, "conv_epilogue", lambda *a, **k: ce.conv_epilogue_cuda(*a, **k))
    # the launches that chip_smoke times apart: called here, never compared
    monkeypatch.setattr(nms, "nms_mask_cuda", lambda sboxes, thresh, offset=0.0: sboxes)
    monkeypatch.setattr(nms, "nms_scan_cuda", lambda mask, svalid, max_keep=None: svalid)
    monkeypatch.setattr(ra, "roi_align_bwd_accumulate_cuda", _plain_accumulate)
    monkeypatch.setattr(ra, "roi_align_bwd_tiles_cuda", _plain_tiles)
    monkeypatch.setattr(ra, "roi_tap_bounds_cuda", ra.roi_tap_cell_bounds)
    # the profiler sees no card here: the listing a bf16 K2 or K3 call gives there
    monkeypatch.setattr(cs, "device_kernels", _listing)
    # the routes and the bf16 K2 kernel's plan are the library's, which needs
    # the card: the narrow instances' rule on levels and samples stands in
    monkeypatch.setattr(ra, "narrow_takes", lambda kind, c, p, s, n: n <= ra.MAX_LEVELS
                        and p * s <= ra.MAX_SAMPLES)
    monkeypatch.setattr(ra, "k2_bf16_plan", lambda c, p, s: dict(
        slice=64 if c % 64 == 0 else 32 if c % 32 == 0 else 8, ring_rows=16, stage_cells=128,
        smem_bytes=94208, threads=448, blocks_per_sm=2))
    monkeypatch.setattr(cs, "NMS_CASES", tuple(
        dict(case, g=3, n=case["n"] // 5, n_invalid=case["n_invalid"] // 5,
             max_out=case["max_out"] // 5) for case in cs.NMS_CASES))
    monkeypatch.setattr(cs, "NMS_EDGE_CASES", tuple(
        dict(case, n=min(case["n"], 300), n_invalid=min(case["n_invalid"], case["n"], 300))
        for case in cs.NMS_EDGE_CASES))
    monkeypatch.setattr(cs, "NMS_WIDE_CASES", tuple(
        dict(case, n=case["n"] // 40, n_invalid=case["n_invalid"] // 40)
        for case in cs.NMS_WIDE_CASES))
    monkeypatch.setattr(ra, "RoIAlignFunction", _PlainFunction)
    get_config = detectron_tpu_torch.config.get_config

    def small_config(path=None, overrides=()):
        overrides = list(overrides)
        for small in ("model.fpn_channels=32", "model.backbone=resnet50",
                      "retinanet.pre_nms_topk=50",
                      "data.image_size=[64, 128]", "rpn.pre_nms_topk_train=256",
                      "rpn.post_nms_topk_train=64", "roi.batch_per_image=64",
                      "data.short_side=48", "data.max_size=96",
                      "rpn.pre_nms_topk_test=256", "rpn.post_nms_topk_test=64",
                      "test.detections_per_image=20"):
            if not any(o.split("=")[0] == small.split("=")[0] for o in overrides):
                overrides.append(small)
        return get_config(path, overrides)

    monkeypatch.setattr(detectron_tpu_torch.config, "get_config", small_config)
    torch.manual_seed(0)
    return np.random.RandomState(0)


def test_kernel_phases_k3_and_function(rehearsal, capsys):
    feats = cs.level_features(rehearsal, c=16)
    k3 = cs.phase_roi_align_bwd(rehearsal, feats)
    assert [(c["case"], c["dtype"]) for c in k3] == [
        ("P7 R512", "float32"), ("P7 R512", "bfloat16"), ("P14 R128", "float32"),
        ("P14 R128", "bfloat16")]
    assert all(c["max_abs_err"] == 0.0 and c["bound_ms"] > 0.0 for c in k3)
    assert all(c["bound_by"] == "bytes" for c in k3[::2])  # fp32
    assert all(c["fill_ms"] >= 0.0 and c["kernel_ms"] >= 0.0 for c in k3[::2])
    bf16 = [c for c in k3 if c["dtype"] == "bfloat16"]
    assert all(c["prepass_ms"] >= 0.0 and c["kernel_ms"] >= 0.0 for c in bf16)
    assert all(c["fp32_kernel_bf16_steps"] == 0 and "fill_ms" not in c for c in bf16)
    out = capsys.readouterr().out
    for kind in cs.K3_STRESS:
        for p in (7, 14):
            assert f"[K3 stress: {kind}, P={p} R=128] levels" in out
            assert f"[K3 bf16 stress: {kind}, P={p} R=128] max |diff| 0.000e+00" in out
            assert re.search(re.escape(f"[K3 bf16 stress: {kind}, P={p} R=128] ") + r"[0-9.]+ ms\n",
                             out)
    # every bf16 check: two runs bitwise equal, the pre-pass's bounds those
    # of roi_tap_cell_bounds
    checks = 2 + 2 * len(cs.K3_STRESS)
    assert out.count("two runs bitwise equal: True; pre-pass bounds equal to "
                     "roi_tap_cell_bounds: True (0 of ") == checks
    for _, p, r in cs.ROI_CASES[2:]:
        line = next(x for x in out.splitlines() if x.startswith(f"[K3 P={p} R={r} bfloat16]"))
        assert " ms (pre-pass " in line and " + kernel " in line and "(RoI, tile) visits" in line
        assert "fp32 fill " in line and " + cast to bf16 " in line
    # one profiled call a training case: the pre-pass and the tile kernel
    assert out.count("] profiler: ") == 2 * 2
    cs.phase_function(rehearsal, feats)
    assert "[function]" in capsys.readouterr().out


def test_kernel_phase_k2_cases_stress_and_rerun(rehearsal, capsys):
    feats = cs.level_features(rehearsal, c=16)
    before = ra.multilevel_roi_align_cuda.launches
    k2 = cs.phase_roi_align(rehearsal, feats)
    assert [c["case"] for c in k2[::2]] == ["P7 R300", "P14 R100", "P7 R512", "P14 R128"]
    assert [c["path"] for c in k2[::2]] == ["predict", "predict", "train", "train"]
    assert [c["case"] for c in k2[1::2]] == [c["case"] for c in k2[::2]]
    assert {c["dtype"] for c in k2[::2]} == {"float32"}
    assert {c["dtype"] for c in k2[1::2]} == {"bfloat16"}
    for c in k2:
        # at these small shapes the bf16 bytes fall below the operations
        assert c["max_abs_err"] == 0.0 and c["bound_by"] in ("bytes", "operations")
        assert c["bound_by"] == "bytes" or c["dtype"] == "bfloat16"
        assert c["ms"] >= 0.0 and c["plain_ms"] >= 0.0
        assert "cells_read_mb" not in c  # a count from the inputs: logged, not reported
    out = capsys.readouterr().out
    for _, p, r in cs.ROI_CASES:
        for span in ((28.0, 36.0), (28.0, 44.0)):
            assert f"[K2 P={p} R={r} span={span}] levels" in out
    for kind in cs.K3_STRESS:
        for p in (7, 14):
            assert f"[K2 stress: {kind}, P={p} R=128] levels" in out
    for s in (1, 3):
        for p in (7, 14):
            assert f"[K2 S={s}, P={p} R=128] levels" in out
    # every check of the fp32 and of the bf16 instance, and the bf16 ones at
    # the 32- and 8-channel slices
    checks = 4 * 2 + len(cs.K3_STRESS) * 2 + 4
    assert out.count("two runs bitwise equal: True") == 2 * checks + 4
    for _, p, r in cs.ROI_CASES:
        for span in ((28.0, 36.0), (28.0, 44.0)):
            assert (f"[K2 bf16 P={p} R={r} span={span}] max |diff| 0.000e+00 from the bf16 "
                    "plain version") in out
    for c_n in (32, 24):
        for p in (7, 14):
            assert f"[K2 bf16 C={c_n}, P={p} R=64]" in out
    assert out.count("0 bf16 steps at most (limit 1), 0 of") == checks + 4
    assert "per-RoI distinct cells, from the inputs" in out
    assert "distinct over the batch" in out
    # each check runs the kernel twice (bf16: three times, with the fp32
    # kernel on the upcast features); the timing adds its own calls
    assert ra.multilevel_roi_align_cuda.launches - before >= 2 * checks + 3 * (checks + 4)


def test_kernel_phase_k1_cases_and_split(rehearsal, capsys):
    k1 = cs.phase_nms(rehearsal)
    wide = [c["name"] for c in cs.NMS_WIDE_CASES]
    assert [c["case"] for c in k1] == ["rpn", "det", "rpn_train", "retinanet",
                                       "retinanet_fast", "rfcn_rpn", "rfcn_rpn_train", *wide]
    # min(max_out, n), cut by 5; the wide cases' cut by 40
    assert [c["max_keep"] for c in k1] == [60, 20, 200, 20, 20, 60, 200, 100, 100, 409, 500]
    assert {c["path"] for c in k1[7:]} == {"wide"}
    assert [c["path"] for c in k1][3:7] == ["retinanet predict", "retinanet predict (fast)",
                                           "rfcn predict", "rfcn train"]
    for c in k1:
        assert {"ms", "mask_ms", "scan_ms", "scan_full_ms", "plain_ms", "bound_ms"} <= set(c)
    out = capsys.readouterr().out
    for case in cs.NMS_EDGE_CASES:
        assert f"[K1 edge] {case['name']}: " in out
    assert "max_keep=1," in out and "max_keep=None, 0 kept" in out  # all invalid
    for name in wide:  # the wide cases, held exactly but not against the CPU path
        line = next(x for x in out.splitlines() if x.startswith(f"[K1 {name}]"))
        assert "keep masks equal with and without max_keep" in line and "scan words" in line


@pytest.mark.parametrize("kind", cs.K3_STRESS)
def test_k3_stress_rois_have_their_shape(kind):
    """Each stress case gives what its name says, at the full canvas."""
    rois, levels = cs.k3_stress_rois(np.random.RandomState(0), kind, 2, 128)
    assert rois.shape == (2, 128, 4) and rois.dtype == np.float32
    w = rois[..., 2] - rois[..., 0]
    h = rois[..., 3] - rois[..., 1]
    assert (w > 0).all() and (h > 0).all()
    if levels is not None:
        cells = w / np.array(cs.STRIDES)[levels]
    if kind == "wider than P*S cells":
        assert (cells > 28).all()  # P * S at P=14, S=2
    elif kind == "all sub-cell":
        assert (cells < 1).all() and (h / np.array(cs.STRIDES)[levels] < 1).all()
    elif kind == "P5 whole level":
        assert (levels == 3).all() and (rois[..., :2] <= 0).all()
        assert (rois[..., 2] >= cs.CANVAS[1]).all() and (rois[..., 3] >= cs.CANVAS[0]).all()
    elif kind == "all identical":
        assert levels is None and (rois == rois[0, 0]).all()
    else:
        outside = (rois[..., 0] > cs.CANVAS[1]) | (rois[..., 1] > cs.CANVAS[0])
        straddle = (rois[..., 0] < 0) | (rois[..., 1] < 0)
        assert outside.sum() == 2 * 32 and straddle.sum() >= 2 * 64


def test_train_phase_counts_launches_and_resumes_the_driver(rehearsal, capsys):
    totals, held = cs.phase_train(steps=3)
    assert totals == {"greedy_nms": 3, "multilevel_roi_align": 6,
                      "multilevel_roi_align_bwd": 6, "anchor_match": 6,
                      "conv_epilogue": 0}
    out = capsys.readouterr().out
    assert "0 unchanged" in out and "0 changed" in out and "not float32: 0" in out
    assert out.count("'anchor_match': 2, 'conv_epilogue': 0}, ") == 3  # the three steps
    assert "restored checkpoint at step" in out and "[driver] resumed" in out
    # one more step, each launch held against its plain version
    assert held["multilevel_roi_align_bwd"] == (2, 0.0)


def test_train_phase_in_bf16(rehearsal, capsys):
    """The bf16 step: K2 and K3 handed bf16, K1 float32 boxes, every
    parameter and gradient float32; no driver run."""
    totals, held = cs.phase_train(steps=2, dtype="bfloat16")
    assert totals == {"greedy_nms": 2, "multilevel_roi_align": 4,
                      "multilevel_roi_align_bwd": 4, "anchor_match": 4,
                      "conv_epilogue": 0}
    out = capsys.readouterr().out
    assert "[train bfloat16]" in out and "bfloat16 batch 2" in out
    assert "convolutions channels-last" in out and "not float32: 0" in out
    assert "[driver]" not in out
    # one more step, each launch held against its plain version
    assert held == {"greedy_nms": (1, 0.0), "multilevel_roi_align": (2, 0.0),
                    "multilevel_roi_align_bwd": (2, 0.0), "anchor_match": (1, 0.0),
                    "conv_epilogue": (0, 0.0)}


def test_slice_phase_in_both_dtypes(rehearsal, monkeypatch, capsys):
    """phase 5's checks and numbers, at float32 and bf16 (the sync debug
    mode stubbed: the card's)."""
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    for dtype in ("float32", "bfloat16"):
        totals, held = cs.phase_slice(calls=2, dtype=dtype)
        assert totals == {"greedy_nms": 4, "multilevel_roi_align": 4, "conv_epilogue": 2 * 29}
        # one more call, each launch held against its plain version
        assert held == {"greedy_nms": (2, 0.0), "multilevel_roi_align": (2, 0.0),
                        "multilevel_roi_align_bwd": (0, 0.0), "anchor_match": (0, 0.0),
                        "conv_epilogue": (29, 0.0)}
    out = capsys.readouterr().out
    assert "kernel input dtypes {'greedy_nms': ['float32'], 'multilevel_roi_align': " \
           "['float32']}" in out
    assert "kernel input dtypes {'greedy_nms': ['float32'], 'multilevel_roi_align': " \
           "['bfloat16']}" in out
    assert "[slice bfloat16]" in out
    assert out.count("under the sync debug mode: synchronising calls reported: 0") == 2
    assert re.search(r"detection-NMS candidates valid [1-9]", out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_device_phase(rehearsal, capsys, dtype):
    """Both sides run on the CPU here: equal, within every limit."""
    cs.phase_cross_device(dtype=dtype)
    out = capsys.readouterr().out
    if dtype == "float32":
        assert "equal slots True; max |box diff| 0.000e+00" in out
    else:
        assert "the CPU's detections found on the card 1.000, the card's on the CPU 1.000" \
            in out
        for stage in ("levels", "objectness", "deltas", "box head", "mask logits"):
            assert f"{stage} ['0.00e+00'" in out


def test_cross_train_phase(rehearsal, capsys):
    """Both sides run the plain versions here: the sound runs read 0 and
    the planted K3 faults read above the limit."""
    readings = cs.phase_cross_train()
    assert "K3: launches {'greedy_nms': 1, 'multilevel_roi_align': 2, " \
           "'multilevel_roi_align_bwd': 2, 'anchor_match': 2, 'conv_epilogue': 0}; max " \
           "relative loss diff " \
           "0.000e+00" \
           in capsys.readouterr().out
    assert readings["K3"] == 0.0 and readings["plain K3"] == 0.0
    assert readings["K3, P2 gradient zeroed"] > cs.UPDATE_RTOL
    assert readings["K3, gradients 10% short"] > cs.UPDATE_RTOL


def test_kernel_entry_reports_the_training_path():
    cases = [dict(case="a", path="predict", ms=1.0, plain_ms=2.0, bound_ms=0.5,
                  bound_by="bytes"),
             dict(case="b", path="train", ms=3.0, plain_ms=4.0, bound_ms=1.5,
                  bound_by="bytes")]
    entry = cs.kernel_entry("multilevel_roi_align_bwd", cases,
                            {"predict": 0, "train": 10, "eval": 0, "bench": 8}, 1e-5)
    assert entry["launches"] == 10 and entry["ms"] == 3.0 and entry["bound_ms"] == 1.5
    assert entry["launches_by_path"]["bench"] == 8
    assert entry["replaces"] == "detectron_tpu/ops/roi_align_pallas.py:529"
    assert entry["library_ms"] is None and entry["route"] == "cuda"


def test_in_memory_coco_split_has_cocos_interface():
    ds = cs.InMemoryCoco(0)
    assert len(ds) == len(cs.EVAL_SIZES) and ds.index_of(3) == 3
    crowd = 0
    for i, hw in enumerate(cs.EVAL_SIZES):
        ex = ds.example(i)
        assert ex["image"].shape == hw + (3,) and ex["image"].dtype == np.uint8
        n = len(ex["boxes"])
        assert ex["masks"].shape == (n, 28, 28) and len(ex["polygons"]) == n
        assert ex["classes"].min() >= 1 and ex["classes"].max() < 81
        for seg, area, box in zip(ex["polygons"], ex["areas"], ex["boxes"]):
            rle = ds.segmentation_to_rle(seg, hw)
            mask = rle.decode()
            assert rle.area() == area > 0
            ys, xs = np.nonzero(mask)  # the box is the mask's extent
            np.testing.assert_array_equal([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1], box)
        for seg, area in zip(ex["crowd_segmentations"], ex["crowd_areas"]):
            assert ds.segmentation_to_rle(seg, hw).area() == area
        crowd += len(ex["crowd_boxes"])
        assert isinstance(ex["polygons"][0]["counts"], str if i % 2 == 0 else list)
    assert crowd == 3


def test_eval_phase_runs_the_driver_and_its_oracle(rehearsal, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(cs, "EVAL_OUT", str(tmp_path / "eval_smoke"))
    counts = cs.phase_eval()
    # 5 landscape and 3 portrait images, batch 2: 3 + 2 predict calls
    assert counts == {"greedy_nms": 10, "multilevel_roi_align": 10,
                      "multilevel_roi_align_bwd": 0, "anchor_match": 0,
                      "conv_epilogue": 5 * 29}
    out = capsys.readouterr().out
    assert "8 images in 5 batches" in out
    assert "[eval] oracle predictor: AP 1.000000, AP50 1.000000, segm_AP50 1.000000" in out
    assert "[K2 eval B=2 128x64 (transposed canvas) P=7 R=64" in out
    assert "[K2 eval B=2 128x64 (transposed canvas) P=14 R=20" in out
    assert not (tmp_path / "eval_smoke").exists()


def test_eval_phase_in_bf16(rehearsal, monkeypatch, tmp_path, capsys):
    """The bf16 eval loop: K1 and K2 twice a call, scores fetched as
    float32, and the oracle's bf16 outputs (on the card there) at AP 1.0."""
    monkeypatch.setattr(cs, "EVAL_OUT", str(tmp_path / "eval_smoke"))
    counts = cs.phase_eval(dtype="bfloat16")
    assert counts == {"greedy_nms": 10, "multilevel_roi_align": 10,
                      "multilevel_roi_align_bwd": 0, "anchor_match": 0,
                      "conv_epilogue": 5 * 29}
    out = capsys.readouterr().out
    assert "scores fetched as ['float32']" in out
    assert "[eval bfloat16] oracle predictor: AP 1.000000, AP50 1.000000, " \
           "segm_AP50 1.000000" in out
    assert "[K2 bf16 eval B=2 128x64 (transposed canvas) P=14 R=20" in out


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _ProfiledEvent:
    def __init__(self, name, device, start, end, is_user_annotation=False):
        self.name, self.time_range = name, _Range(start, end)
        self.device_type = type("Device", (), {"name": device})
        self.is_user_annotation = is_user_annotation


class _Profile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_device_work_skips_the_shadows_of_host_ranges():
    """The device-side shadows of the program's spans and of any other
    host range are not work: only the kernels inside them count in a
    profiled call's kernel listing."""
    prof = _Profile([
        _ProfiledEvent("eval_loop", "CPU", 1000.0, 3000.0),
        _ProfiledEvent("detectron/predict", "CPU", 1100.0, 2900.0),
        _ProfiledEvent("detectron/predict", "CUDA", 1100.0, 2900.0),  # a span's shadow
        _ProfiledEvent("detectron/backbone+fpn", "CUDA", 1100.0, 2000.0, True),
        _ProfiledEvent("fetch", "CUDA", 2500.0, 2900.0, True),  # another range's
        _ProfiledEvent("conv", "CUDA", 1500.0, 1700.0),
    ])
    assert [e.name for e in cs.device_work(prof.events())] == ["conv"]


def test_bench_phase_counts_every_launch(rehearsal, monkeypatch, capsys):
    from detectron_tpu_torch import bench

    monkeypatch.setattr(bench, "resolve_device", lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(cs, "BENCH_ARGS", [
        "--size", "128", "--batch", "2", "--train-batch", "2", "--iters", "1",
        "--train-iters", "1", "--set", "model.num_classes=5", "model.fpn_channels=32",
        "rpn.pre_nms_topk_test=256", "rpn.post_nms_topk_test=64",
        "rpn.pre_nms_topk_train=192", "rpn.post_nms_topk_train=48",
        "roi.batch_per_image=64", "test.detections_per_image=20"])
    counts, line16 = cs.phase_bench()  # the default: bf16
    # 3 predict calls (K1, K2 twice each), 3 train steps (K1 once, K2, K3 and
    # the anchor matching twice): two warm-ups and one timed each
    assert counts == {"greedy_nms": 9, "multilevel_roi_align": 12,
                      "multilevel_roi_align_bwd": 6, "anchor_match": 6,
                      "conv_epilogue": 3 * 29 + 8}
    # then one call and one step of the bench's detector, each launch held
    assert line16["held"]["predict"]["multilevel_roi_align"] == (2, 0.0)
    assert line16["held"]["train"]["multilevel_roi_align_bwd"] == (2, 0.0)
    assert ", bfloat16, cpu)" in line16["metric"]
    out16 = capsys.readouterr().out
    assert "[K2 bf16 bench B=2 128x128 P=7 R=64" in out16
    assert "[K3 bf16 bench B=2 128x128 P=14 R=16" in out16
    counts, _ = cs.phase_bench("float32")
    assert counts == {"greedy_nms": 9, "multilevel_roi_align": 12,
                      "multilevel_roi_align_bwd": 6, "anchor_match": 6,
                      "conv_epilogue": 3 * 29 + 8}
    out = capsys.readouterr().out
    line = next(json.loads(x) for x in out.splitlines() if x.startswith('{"metric"'))
    assert line["value"] > 0 and line["train_img_s_chip"] > 0
    assert ", float32, cpu)" in line["metric"]
    # the shapes of the bench's config: 4 x 64 detection candidates, 64 / 20
    # RoIs at inference, 64 sampled RoIs of which 16 foreground in training
    assert "[K1 bench rpn] G=10 N=256 t=0.7 max_keep=64" in out
    assert "[K1 bench det] G=2 N=256 t=0.5 max_keep=20" in out
    assert "[K2 bench B=2 128x128 P=7 R=64" in out and "[K2 bench B=2 128x128 P=14 R=20" in out
    assert "[K1 bench rpn_train] G=10 N=192 t=0.7 max_keep=48" in out
    for p, r in ((7, 64), (14, 16)):
        assert f"[K2 bench B=2 128x128 P={p} R={r}" in out
        assert f"[K3 bench B=2 128x128 P={p} R={r}" in out
    assert "summed finite" in out


def test_k1_limit_cases_and_refusal_name_the_limit():
    """K1 has no 8192-box limit any more: the NMS tables hold the widest
    register scan (N = 8192) among the edge cases and, past it, the wide
    scan's cases (one box in word 128; RetinaNet's G=2 N=10000 at
    retinanet.pre_nms_topk=2000; a last word full; a fifth invalid), and
    phase 28 drives the main path past it. What K1 still refuses (past
    NMS_MAX_BOXES) is refused when a detector is built, naming the key and
    the limit."""
    names = [c["name"] for c in cs.NMS_EDGE_CASES]
    assert f"N={cs.NMS_REGISTER_LIMIT} (the widest register scan)" in names
    assert cs.NMS_REGISTER_LIMIT == 8192
    assert any(c["n"] > 4096 and c["n"] % 64 and (c["n"] // 64) % 2 == 0
               for c in cs.NMS_EDGE_CASES)  # W = 71: odd, above 64
    assert any(c["max_keep"] == 1 and c["n"] == 5000 for c in cs.NMS_EDGE_CASES)
    retina = [c for c in cs.NMS_CASES if c["name"] == "retinanet"][0]
    assert (retina["g"], retina["n"], retina["classes"]) == (2, 5000, 81)
    wide = {c["n"]: c for c in cs.NMS_WIDE_CASES}
    assert sorted(wide) == [8193, 10000, 16384, 20000]
    assert all(n > cs.NMS_REGISTER_LIMIT and c["path"] == "wide" for n, c in wide.items())
    assert (wide[10000]["g"], wide[10000]["classes"]) == (2, 81)  # 5 x pre_nms_topk 2000
    assert 16384 % 64 == 0 and wide[16384]["n_invalid"] == 0  # the last word full
    assert wide[20000]["n_invalid"] == 20000 // 5
    paths = {path: (overrides, shapes) for _, overrides, path, shapes in cs.WIDE_NMS_PATHS}
    assert paths["retinanet_predict_wide"] == (["retinanet.pre_nms_topk=2000"], [(2, 10000, 4)])
    assert paths["predict_wide"][1][-1] == (2, 4 * 3000, 4)
    cfg = detectron_tpu_torch.config.get_config(None, ["model.name=retinanet",
                                                       "retinanet.pre_nms_topk=300000"])
    with pytest.raises(ValueError, match=r"retinanet\.pre_nms_topk: NMS problems of 1500000 "
                                         r"boxes; kernel K1 takes at most 1280000"):
        nms.check_nms_contract(cfg)


def test_retinanet_predict_phase_launches_k1_once_a_call(rehearsal, monkeypatch, capsys):
    """One K1 call a predict call, on float32 boxes, N = 5 x pre_nms_topk
    (50 here) in each of the batch's 2 problems, in both dtypes."""
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    for dtype in ("float32", "bfloat16"):
        totals = cs.phase_retinanet(calls=2, dtype=dtype)
        assert totals == {"greedy_nms": 2, "multilevel_roi_align": 0,
                          "multilevel_roi_align_bwd": 0, "anchor_match": 0,
                          "conv_epilogue": 2 * 6}
    out = capsys.readouterr().out
    assert out.count("K1 boxes [(2, 250, 4)] ['float32']") == 4
    # the merged candidates, some above the score threshold, in both dtypes
    assert len(re.findall(r"merged candidates \(2, 250\), [1-9][0-9]* above", out)) == 2
    assert "[retinanet bfloat16] scores in" in out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_retinanet_phase(rehearsal, capsys, dtype):
    cs.phase_cross_retinanet(dtype=dtype)
    out = capsys.readouterr().out
    for h, w in cs.RETINA_CROSS_CANVASES:
        if dtype == "float32":
            assert f"[cross retinanet] {h}x{w} FPN 32" in out
        else:
            assert f"[cross retinanet bfloat16] {h}x{w} FPN 32" in out
    assert out.count("equal slots and classes True, max |box diff| 0.000e+00") == 2
    assert out.count("levels ['0.00e+00'") == 2 and "class logits ['0.00e+00'" in out
    assert out.count("the CPU's detections found on the card 1.000") == 2


def test_retinanet_train_phase_launches_nothing_and_resumes_the_driver(rehearsal, capsys):
    totals, held = cs.phase_retinanet_train(steps=2)
    assert totals == {"greedy_nms": 0, "multilevel_roi_align": 0,
                      "multilevel_roi_align_bwd": 0, "anchor_match": 4,
                      "conv_epilogue": 0}
    # no K1-K3; the anchor matching's two kernels a step, held against the twin
    assert held["anchor_match"] == (1, 0.0)
    out = capsys.readouterr().out
    assert "0 unchanged" in out and "0 changed" in out and "not float32: 0" in out
    assert out.count("'anchor_match': 2, 'conv_epilogue': 0}, ") == 2
    assert "model=retinanet" in out and "[driver] resumed" in out
    cs.phase_retinanet_train(steps=2, dtype="bfloat16")
    assert "[driver]" not in capsys.readouterr().out


def test_anchor_match_phase_holds_every_case(rehearsal, monkeypatch, capsys):
    """Phase 32 at the rehearsal's canvas: every case equal, timed, its bound
    and peak bytes reported."""
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    cases = cs.phase_anchor_match()
    assert [c["case"] for c in cases] == [
        "cell", "identical gt", "gt equal to anchors", "no gt", "G=300",
        "IoU at the thresholds", "offset 1", "gt at the origin, offset 1", "no force match"]
    assert all(c["equal"] and c["wrong"] == 0 and c["ms"] >= 0 for c in cases)
    assert cases[0]["batch"] == 16 and cases[0]["slots"] == 100
    assert 16 <= cases[0]["valid"] <= 16 * 50 and cases[4]["slots"] == 300
    assert cases[3]["positives"] == 0 and cases[3]["negatives"] == 16 * cases[3]["anchors"]
    assert cases[2]["positives"] >= 16 * 100 // 2  # every picked anchor its gt's best
    assert all(c["bound_by"] in ("bytes", "operations") for c in cases)
    entry = cs.anchor_match_entry(cases, {"train": 10, "train_bf16": 10})
    assert entry["launches"] == 10 and entry["ms"] == cases[0]["ms"]
    assert entry["launches_by_path"] == {"train": 10, "train_bf16": 10}
    assert capsys.readouterr().out.count("[anchor_match]") == len(cases)


def _biased_as_on_the_card(self, x):
    """A convolution with its bias as aten runs it on the card: cuDNN
    without the bias, then ``output.add_(bias)`` (a CPU convolution adds the
    bias inside its sum, and in bf16 rounds once where the card rounds
    twice)."""
    y, bias = self.forward_unbiased(x)
    return y if bias is None else y.add_(bias.reshape(1, -1, 1, 1))


def test_conv_epilogue_phase_holds_every_pass(rehearsal, monkeypatch, capsys):
    """Phase 33 at the rehearsal's canvas and widths: every pass of a predict
    call and each form in the other dtypes and layouts bit for bit and
    timed; the FPN and the heads equal to the parent's chain (the same
    modules recording a gradient, their biased convolutions as the card
    runs them); the launches of the three predict paths held, and none in
    a training step."""
    from detectron_tpu_torch.models import precision

    monkeypatch.setattr(cs, "EPILOGUE_BATCH", 2)
    monkeypatch.setattr(cs, "EPILOGUE_ROIS", 6)
    # the summary divides by the summed times: 1 ms a call here
    monkeypatch.setattr(cs, "cuda_ms", lambda fn, iters=20, warmup=3: _once(fn) + 1.0)
    monkeypatch.setattr(precision.Conv2d, "forward", _biased_as_on_the_card)
    monkeypatch.setattr(precision.ConvTranspose2d, "forward", _biased_as_on_the_card)
    cases, launches, summary = cs.phase_conv_epilogue()
    passes = [c for c in cases if "count" in c]
    assert sum(c["count"] for c in passes) == summary["passes"] == 29
    assert [c["form"] for c in passes].count("coarse") == 3
    assert [(c["n"], c["h"]) for c in passes[-3:]] == [(6, 14), (6, 28), (6, 28)]
    assert all(c["bitwise"] for c in cases) and len(cases) == len(passes) + 9
    assert all(c["bound_by"] == "bytes" and c["bound_ms"] > 0 for c in passes)
    assert launches == {"predict_mask_rcnn": 29, "predict_faster_rcnn": 23,
                        "predict_retinanet": 6, "train_r101": 0}
    entry = cs.conv_epilogue_entry(cases, launches, summary)
    assert entry["launches"] == 29 and entry["bound_ms"] == summary["bound_ms"]
    out = capsys.readouterr().out
    assert ("against the parent's chain: differing values {'fpn': [0, 0, 0, 0], 'rpn': "
            "[0, 0, 0, 0, 0, 0, 0, 0], 'mask': [0]}") in out
    assert out.count("conv_epilogue 29 launches, max |diff| 0.000e+00") == 1
    assert out.count("conv_epilogue 0 launches") == 1  # the training step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_retinanet_eval_phase(rehearsal, monkeypatch, tmp_path, capsys, dtype):
    monkeypatch.setattr(cs, "EVAL_OUT", str(tmp_path / "eval_smoke"))
    counts = cs.phase_retinanet_eval(dtype=dtype)
    # 5 landscape and 3 portrait images, batch 2: 3 + 2 predict calls
    assert counts == {"greedy_nms": 5, "multilevel_roi_align": 0,
                      "multilevel_roi_align_bwd": 0, "anchor_match": 0,
                      "conv_epilogue": 5 * 6}
    out = capsys.readouterr().out
    assert f"[retinanet eval {dtype}] 8 images in 5 batches" in out
    assert f"[retinanet eval {dtype}] oracle predictor: AP 1.000000, AP50 1.000000" in out
    assert not (tmp_path / "eval_smoke").exists()


def test_retinanet_bench_phase(rehearsal, monkeypatch, capsys):
    from detectron_tpu_torch import bench

    monkeypatch.setattr(bench, "resolve_device", lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(cs, "RETINA_BENCH_ARGS", [
        "--model", "retinanet", "--size", "128", "--batch", "2", "--train-batch", "2",
        "--iters", "1", "--train-iters", "1", "--set", "model.num_classes=5",
        "model.fpn_channels=32", "retinanet.pre_nms_topk=50", "test.detections_per_image=20"])
    for dtype in (None, "float32"):
        counts, line, case = cs.phase_retinanet_bench(dtype)
        # 3 predict calls (two warm-ups), K1 once each; 3 train steps, no K1-K3 and
        # the anchor matching twice each
        assert counts == {"greedy_nms": 3, "multilevel_roi_align": 0,
                          "multilevel_roi_align_bwd": 0, "anchor_match": 6,
                          "conv_epilogue": 3 * 6 + 6}
        assert line["metric"].startswith("retinanet R-50-FPN inference")
        assert case["path"] == "retinanet bench" and case["max_keep"] == 20
    out = capsys.readouterr().out
    assert "[K1 retinanet bench bfloat16] G=2 N=250 t=0.5 max_keep=20" in out
    assert "[K1 retinanet bench float32] G=2 N=250" in out


def test_demo_phase_writes_two_images(rehearsal, monkeypatch, tmp_path, capsys):
    out_dir = str(tmp_path / "demo")
    monkeypatch.setattr(cs, "DEMO_OUT", out_dir)
    monkeypatch.setattr(cs, "DEMO_ARGS", [
        "--no-restore", "--device", "cpu", "--cfg", "model.name=retinanet",
        "model.num_classes=4", "model.fpn_channels=32", "data.image_size=[128,128]",
        "data.short_side=100", "data.max_size=128", "retinanet.pre_nms_topk=50",
        f"output_dir={out_dir}"])
    cs.phase_demo()
    out = capsys.readouterr().out
    assert "wrote ['synthetic_0.png', 'synthetic_1.png']" in out
    assert not (tmp_path / "demo").exists()


def test_rfcn_predict_phase_launches_k1_twice_a_call(rehearsal, monkeypatch, capsys):
    """K1 twice a predict call on float32 boxes (proposals: 2 x
    rpn.pre_nms_topk_test; detections: 2 x 4 x rpn.post_nms_topk_test,
    256 each here), K2 and K3 never, in both dtypes."""
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    for dtype in ("float32", "bfloat16"):
        totals, pool = cs.phase_rfcn(calls=2, dtype=dtype)
        assert totals == {"greedy_nms": 4, "multilevel_roi_align": 0,
                          "multilevel_roi_align_bwd": 0, "anchor_match": 0,
                          "conv_epilogue": 2 * 3}
        assert pool["fwd_ms"] >= 0 and pool["rois"] == [2, 64, 4]  # the proposals
    out = capsys.readouterr().out
    assert out.count("K1 boxes [(2, 256, 4), (2, 256, 4)] ['float32']") == 4
    assert "[rfcn bfloat16 psroipool] table (2, 4, 8, 4165)" in out
    assert "[rfcn bfloat16] PS table (2, 4, 8, 4165)" in out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_rfcn_phase(rehearsal, monkeypatch, capsys, dtype):
    monkeypatch.setattr(cs, "PS_TABLE", (2, 8, 10, 7 * 7 * 6))
    monkeypatch.setattr(cs, "PS_ROIS", 40)
    cs.phase_cross_rfcn(dtype=dtype)
    out = capsys.readouterr().out
    tag = "cross rfcn" if dtype == "float32" else f"cross rfcn {dtype}"
    for dilate in (False, True):
        assert f"[{tag}] 256x256 trunk 32 dilate_c5 {dilate}: launches on the card " \
               "{'greedy_nms': 2, 'multilevel_roi_align': 0" in out
    assert out.count("trunk 0.00e+00; objectness 0.00e+00") == 2
    assert ("PSRoIPool table (2, 8, 10, 294), 40 RoIs an image: card against CPU, forward "
            "0.00e+00, gradient 0.00e+00" in out) == (dtype == "float32")


def test_rfcn_train_phase_launches_k1_once_and_resumes_the_driver(rehearsal, monkeypatch,
                                                                  capsys):
    totals, pool = cs.phase_rfcn_train(steps=2)
    assert totals == {"greedy_nms": 2, "multilevel_roi_align": 0,
                      "multilevel_roi_align_bwd": 0, "anchor_match": 4,
                      "conv_epilogue": 0}
    assert pool["rois"] == [2, 64, 4]
    out = capsys.readouterr().out
    assert "0 unchanged" in out and "0 changed" in out and "not float32: 0" in out
    assert "model=rfcn" in out and "[driver] resumed" in out
    cs.phase_rfcn_train(steps=2, dtype="bfloat16")
    assert "[driver]" not in capsys.readouterr().out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rfcn_eval_phase(rehearsal, monkeypatch, tmp_path, capsys, dtype):
    monkeypatch.setattr(cs, "EVAL_OUT", str(tmp_path / "eval_smoke"))
    counts = cs.phase_rfcn_eval(dtype=dtype)
    # 5 landscape and 3 portrait images, batch 2: 3 + 2 predict calls, K1 twice each
    assert counts == {"greedy_nms": 10, "multilevel_roi_align": 0,
                      "multilevel_roi_align_bwd": 0, "anchor_match": 0,
                      "conv_epilogue": 5 * 3}
    out = capsys.readouterr().out
    assert f"[rfcn eval {dtype}] 8 images in 5 batches" in out
    assert f"[rfcn eval {dtype}] oracle predictor: AP 1.000000, AP50 1.000000" in out


def test_rfcn_bench_and_demo_phases(rehearsal, monkeypatch, tmp_path, capsys):
    from detectron_tpu_torch import bench

    monkeypatch.setattr(bench, "resolve_device", lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(cs, "RFCN_BENCH_ARGS", [
        "--model", "rfcn", "--size", "128", "--batch", "2", "--train-batch", "2",
        "--iters", "1", "--train-iters", "1", "--set", "model.num_classes=5",
        "model.fpn_channels=32", "rpn.pre_nms_topk_test=128", "rpn.post_nms_topk_test=32"])
    for dtype in (None, "float32"):
        counts, line = cs.phase_rfcn_bench(dtype)
        # 3 predict calls (two warm-ups), K1 twice each; 3 train steps, K1 once and
        # the anchor matching twice each
        assert counts == {"greedy_nms": 9, "multilevel_roi_align": 0,
                          "multilevel_roi_align_bwd": 0, "anchor_match": 6,
                          "conv_epilogue": 3 * 3}
        assert line["metric"].startswith("rfcn R-50-FPN inference")
    out_dir = str(tmp_path / "demo")
    monkeypatch.setattr(cs, "DEMO_OUT", out_dir)
    cs.phase_demo(["--no-restore", "--device", "cpu", "--cfg", "model.name=rfcn",
                   "model.num_classes=4", "model.fpn_channels=32", "data.image_size=[128,128]",
                   "data.short_side=100", "data.max_size=128", "rpn.pre_nms_topk_test=128",
                   "rpn.post_nms_topk_test=32", f"output_dir={out_dir}"])
    out = capsys.readouterr().out
    assert "wrote ['synthetic_0.png', 'synthetic_1.png']" in out


def test_roi_pool_phase(rehearsal, monkeypatch, capsys):
    launches, cases = cs.phase_roi_pool(calls=2, steps=1)
    assert launches == {
        "roi_pool_predict": {"greedy_nms": 4, "multilevel_roi_align": 0,
                             "multilevel_roi_align_bwd": 0, "anchor_match": 0,
                             "conv_epilogue": 2 * 23},
        "roi_pool_train": {"greedy_nms": 1, "multilevel_roi_align": 0,
                           "multilevel_roi_align_bwd": 0, "anchor_match": 2,
                           "conv_epilogue": 0}}
    assert [c["case"] for c in cases] == ["P=7 R=512", "P=7 R=512 bf16",
                                                    "P=14 R=128", "P=14 R=128 bf16"]
    out = capsys.readouterr().out
    assert out.count("card against CPU: max |diff| 0.000e+00") == 4
    assert "roi.pool_type=pool" in out


def test_weights_phase(rehearsal, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(cs, "WEIGHTS_DIR", str(tmp_path / "weights"))
    cs.phase_weights()
    out = capsys.readouterr().out
    assert "[weights] train driver, R-FCN" in out and "0 differ from the dict" in out
    assert "initialized from" in out
    line = out.split("[weights] eval driver, Mask R-CNN")[1].splitlines()[0]
    assert "False" not in line and "8 images" in line
    assert not (tmp_path / "weights").exists()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gn_phase(rehearsal, capsys, dtype):
    """Phase 25: GroupNorm predict calls and train steps, each kernel launch
    held against its plain version, the stem's GroupNorm fixed; then phase
    6's check with GroupNorm (both sides on the CPU here: equal)."""
    launches, held = cs.phase_gn(calls=2, steps=2, dtype=dtype)
    sfx = "" if dtype == "float32" else "_bf16"
    assert launches == {
        "gn_predict" + sfx: {"greedy_nms": 4, "multilevel_roi_align": 4,
                             "multilevel_roi_align_bwd": 0, "anchor_match": 0,
                             "conv_epilogue": 2 * 29},
        "gn_train" + sfx: {"greedy_nms": 2, "multilevel_roi_align": 4,
                           "multilevel_roi_align_bwd": 4, "anchor_match": 4,
                           "conv_epilogue": 0}}
    assert held["predict"] == {"greedy_nms": (2, 0.0), "multilevel_roi_align": (2, 0.0),
                               "multilevel_roi_align_bwd": (0, 0.0), "anchor_match": (0, 0.0),
                               "conv_epilogue": (29, 0.0)}
    assert held["train"] == {"greedy_nms": (1, 0.0), "multilevel_roi_align": (2, 0.0),
                             "multilevel_roi_align_bwd": (2, 0.0), "anchor_match": (1, 0.0),
                             "conv_epilogue": (0, 0.0)}
    cs.phase_cross_device(dtype=dtype, overrides=cs.GN_OVERRIDES, bf16_limit=cs.CROSS_BF16_GN,
                          as_good_as_cpu=dtype == "bfloat16")
    out = capsys.readouterr().out
    assert "norm=gn" in out and "'backbone.gn1.weight': False" in out
    assert "[cross model.norm=gn" in out
    if dtype == "bfloat16":
        assert "the card's bf16 against the CPU's bf16: at most x1.000" in out


def test_remat_phase(rehearsal, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 2**30)
    launches, summary = cs.phase_remat()
    assert launches == {"remat_train": {"greedy_nms": 1, "multilevel_roi_align": 2,
                                        "multilevel_roi_align_bwd": 2, "anchor_match": 2,
                                        "conv_epilogue": 0}}
    assert summary["loss_rel"] == 0.0 and summary["grad_rel"] <= cs.REMAT_GRAD_RTOL
    assert summary["held"]["multilevel_roi_align_bwd"] == (2, 0.0)
    assert "[remat] remat step (compared)" in capsys.readouterr().out


def test_dp_phase(rehearsal, monkeypatch, tmp_path, capsys):
    """Phase 27 on the CPU: (a) over gloo at world size 1 (NCCL on the card),
    the train and eval drivers under the group; (b) two gloo processes."""
    monkeypatch.setattr(cs, "EVAL_OUT", str(tmp_path / "eval"))
    monkeypatch.setattr(cs, "DP_OUT", str(tmp_path / "dp"))
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    launches, summary = cs.phase_dp()
    assert not torch.distributed.is_initialized()
    assert launches["dp_train"] == {"greedy_nms": 1, "multilevel_roi_align": 2,
                                    "multilevel_roi_align_bwd": 2, "anchor_match": 2,
                                    "conv_epilogue": 0}
    assert launches["dp_driver"]["multilevel_roi_align_bwd"] == 4
    assert launches["dp_eval"]["multilevel_roi_align"] > 0
    assert summary["a"]["diffs"][0] <= cs.DP_LOSS_ATOL and summary["b"]["diffs"][1] <= (
        cs.DP_PARAM_ATOL)
    out = capsys.readouterr().out
    assert "backend gloo, rank 0 of 1" in out and "metrics.jsonl records [1, 2]" in out
    assert "two ranks on one card over gloo" in out and "[dp (b) rank 0]" in out


def test_wide_nms_phase_holds_k1_on_the_main_path(rehearsal, monkeypatch, capsys):
    """Phase 28 at the rehearsal's sizes: RetinaNet's merged NMS (5 levels
    x pre_nms_topk) and Mask R-CNN's proposals and detections, each call's
    K1 shapes as its config gives them, every launch held."""
    monkeypatch.setattr(cs, "WIDE_NMS_PATHS", (
        ("retinanet", ["retinanet.pre_nms_topk=100"], "retinanet_predict_wide",
         [(2, 500, 4)]),
        ("mask_rcnn", ["rpn.post_nms_topk_test=100"], "predict_wide",
         [(10, 256, 4), (2, 400, 4)])))
    launches, held = cs.phase_wide_nms()
    assert launches["retinanet_predict_wide"] == {"greedy_nms": 1, "multilevel_roi_align": 0,
                                                  "multilevel_roi_align_bwd": 0, "anchor_match": 0,
                                                  "conv_epilogue": 6}
    assert launches["predict_wide"] == {"greedy_nms": 2, "multilevel_roi_align": 2,
                                        "multilevel_roi_align_bwd": 0, "anchor_match": 0,
                                        "conv_epilogue": 29}
    assert held["retinanet_predict_wide"]["greedy_nms"] == (1, 0.0)
    assert held["predict_wide"]["greedy_nms"] == (2, 0.0)
    out = capsys.readouterr().out
    assert "[wide nms predict_wide] mask_rcnn rpn.post_nms_topk_test=100" in out
    assert "K1 boxes [(2, 500, 4)]" in out


def test_op_api_phase_counts_its_launches_and_holds_each_call(rehearsal, monkeypatch, capsys):
    """Phase 29 at the rehearsal's sizes: nms_wrapper.nms(impl="pallas")
    once a problem (CPU tensors here: the sort and compaction of
    ``nms_padded_batched`` around the counting stand-in of K1, since the
    real dispatch raises on CPU tensors; ``tests/test_torch_nms_wrapper.py``
    holds the dispatch), roi_align forward and gradient once each in both
    dtypes, both P and both values of aligned, all counted and held; the
    aligned stress kinds through phases 4 and 7's checks. The former
    refusals need the card's wrappers and are only recorded as called."""
    from detectron_tpu_torch.ops import nms_wrapper

    real_nms = nms_wrapper.nms

    def card_nms(boxes, scores, thresh, max_out, valid=None, offset=0.0, impl="jnp"):
        if impl != "pallas":
            return real_nms(boxes, scores, thresh, max_out, valid=valid, offset=offset,
                            impl=impl)
        idx, ok = nms.nms_padded_batched(boxes[None], scores[None], valid[None], thresh,
                                         max_out, offset, keep_fn=nms.greedy_keep_cuda)
        return idx[0], ok[0]

    monkeypatch.setattr(nms_wrapper, "nms", card_nms)
    refusals = []
    monkeypatch.setattr(cs, "check_former_refusals", lambda: refusals.append(True))
    monkeypatch.setattr(cs, "OP_ROI_CASES", ((7, 24), (14, 8)))
    monkeypatch.setattr(cs, "OP_STRESS_ROIS", 8)
    counts, k2, k3 = cs.phase_op_api(c=16)
    problems = len(cs.NMS_CASES) + len(cs.NMS_WIDE_CASES)
    assert counts == {"greedy_nms": problems, "multilevel_roi_align": 8,
                      "multilevel_roi_align_bwd": 8, "anchor_match": 0,
                      "conv_epilogue": 0}
    assert refusals == [True]
    for cases in (k2, k3):
        assert [(c["dtype"], c["case"]) for c in cases] == [
            (dtype, f"P{p} R{r} one level aligned={aligned}")
            for dtype in ("float32", "bfloat16") for p, r in cs.OP_ROI_CASES
            for aligned in (False, True)]
        assert {c["path"] for c in cases} == {"op_api"}
        for c in cases:
            assert c["max_abs_err"] == 0.0 and c["bound_by"] in ("bytes", "operations")
    out = capsys.readouterr().out
    assert "[op api] pairwise_iou [2, 1000] on the card: max |diff|" in out
    assert out.count("impl='pallas' equal to impl='jnp': True") == problems
    for kind in cs.ALIGNED_STRESS:
        for p in (7, 14):
            name = f"op api aligned stress: {kind}, P={p} R=8"
            assert f"[K2 {name}] levels" in out and f"[K3 bf16 {name}] max |diff|" in out
    # K3 bf16's pre-pass against roi_tap_cell_bounds, aligned: the main
    # cases and the stress kinds
    assert out.count("pre-pass bounds equal to roi_tap_cell_bounds: True") == 2 + 8
    assert "[op api] zero extent along x:" in out and "[op api] zero extent along y:" in out


@pytest.mark.parametrize("kind", cs.ALIGNED_STRESS)
def test_aligned_stress_rois_have_their_shape(kind):
    """Each of phase 29's stress kinds gives what its name says on P3 of
    the full canvas (128 x 168 cells at stride 8)."""
    stride, hw = 8, (128, 168)
    rois = cs.aligned_stress_rois(np.random.RandomState(0), kind, 2, 128, hw, stride)
    assert rois.shape == (2, 128, 4) and rois.dtype == np.float32
    w = (rois[..., 2] - rois[..., 0]) / stride
    h = (rois[..., 3] - rois[..., 1]) / stride
    assert (w >= 0).all() and (h >= 0).all()
    if kind == "zero extent":
        assert ((w == 0) | (h == 0)).all() and ((w == 0) & (h == 0)).any()
        on_edge = (rois[..., 0] / stride - 0.5) == np.floor(rois[..., 0] / stride - 0.5)
        assert on_edge.any() and not on_edge.all()
    elif kind == "all sub-cell":
        assert (w < 1).all() and (h < 1).all()
    elif kind == "shifted past the border":
        # the shift puts the top-left corner in [-0.5, 0) cells, or the
        # bottom-right one within half a cell of the far edge
        x1 = rois[..., 0] / stride - 0.5
        x2 = rois[..., 2] / stride - 0.5
        assert ((x1 >= -0.5) & (x1 < 0)).sum() == 2 * 64
        assert ((x2 > hw[1] - 1) & (x2 <= hw[1] - 0.5)).sum() == 2 * 64
    else:
        assert (rois[..., :2] <= 0).all() and (rois[..., 2] >= hw[1] * stride).all()
        assert (rois[..., 3] >= hw[0] * stride).all()


def test_contracts_phase_counts_its_launches_and_holds_each_call(rehearsal, monkeypatch,
                                                                 capsys):
    """Phase 30 at the rehearsal's sizes: K1 on bf16 boxes through
    nms_wrapper.nms(impl="pallas") once a shape and class_aware_nms at the
    class-aware shapes, counted, then against the plain walk at every case;
    K2 and K3 through multilevel_roi_align forward and gradient once a case
    and dtype, counted and held, the routes named; the 36-channel bf16
    model built, counted and held. The kernels are the plain versions here
    (counting stand-ins): what is rehearsed is the phase's control flow,
    its counts and its checks."""
    from detectron_tpu_torch.ops import nms_wrapper

    real_nms = nms_wrapper.nms

    def card_nms(boxes, scores, thresh, max_out, valid=None, offset=0.0, impl="jnp"):
        if impl != "pallas":
            return real_nms(boxes, scores, thresh, max_out, valid=valid, offset=offset,
                            impl=impl)
        idx, ok = nms.nms_padded_batched(boxes[None], scores[None], valid[None], thresh,
                                         max_out, offset, keep_fn=nms.greedy_keep_cuda)
        return idx[0], ok[0]

    monkeypatch.setattr(nms_wrapper, "nms", card_nms)
    monkeypatch.setattr(cs, "CONTRACT_NMS_CASES", tuple(
        dict(case, g=2, n=max(case["n"] // 40, 70), n_invalid=case["n_invalid"] // 40,
             max_out=case["max_out"] // 10) for case in cs.CONTRACT_NMS_CASES))
    monkeypatch.setattr(cs, "CONTRACT_ROI_CASES", tuple(
        (name, 12 if c >= 64 else c, dtypes, p, s, 8, strides, mis)
        for name, c, dtypes, p, s, r, strides, mis in cs.CONTRACT_ROI_CASES))
    monkeypatch.setattr(cs, "CONTRACT_WIDE_TIMED", (("P*S=112", 28, 4, 4, 12),))
    k1, k1_launches, k2, k3, launches = cs.phase_contracts()
    assert k1_launches == len(cs.CONTRACT_NMS_CASES) + len(cs.CONTRACT_CLASS_AWARE)
    assert [c["case"] for c in k1] == [c["name"] for c in cs.CONTRACT_NMS_CASES]
    assert {c["dtype"] for c in k1} == {"bfloat16"}
    assert [c["plain_ms"] is not None for c in k1] == [
        c["path"] == "train" for c in cs.CONTRACT_NMS_CASES]
    n_roi = sum(len(case[2]) for case in cs.CONTRACT_ROI_CASES)
    assert launches["contracts"] == {"greedy_nms": 0, "multilevel_roi_align": n_roi,
                                     "multilevel_roi_align_bwd": n_roi, "anchor_match": 0,
                                     "conv_epilogue": 0}
    assert launches["predict_fpn36_bf16"]["multilevel_roi_align"] == 2
    assert len(k2) == len(k3) == n_roi
    assert {c["path"] for c in k2 + k3} == {"contracts"}
    routes = {c["case"].split(" P=")[0]: c["route"] for c in k2}
    assert routes["10 levels float32"] == "wide" and routes["C=30 float32"] == "narrow"
    assert routes["P*S=112 bfloat16"] == "wide"
    entry = cs.k1_bf16_entry(k1, k1_launches)
    assert entry["name"] == "greedy_nms_bf16" and entry["launches"] == k1_launches
    assert entry["ms"] >= 0 and entry["plain_ms"] >= 0 and entry["bound_by"] in (
        "bytes", "operations")
    out = capsys.readouterr().out
    assert out.count("impl='pallas' equal to impl='jnp': True") == len(cs.CONTRACT_NMS_CASES)
    assert out.count("equal to the plain walk: True") == len(cs.CONTRACT_CLASS_AWARE)
    assert out.count("keep masks equal to the plain walk with and without max_keep: True") \
        == len(cs.CONTRACT_NMS_CASES)
    assert out.count("K1 bf16 exact thresholds") == 4
    assert "[contracts] mask_rcnn model.dtype=bfloat16 model.fpn_channels=36" in out
    assert out.count("R=4 C=12, timed only: K2") == 2
    assert "[contracts fpn_channels=36 bf16] each launch held" in out


def test_frozen_bn_phase_holds_every_form_and_counts_its_launches(rehearsal, monkeypatch,
                                                                 capsys):
    from detectron_tpu_torch.ops import frozen_bn as fb

    plain, plain_bwd = fb.frozen_bn_act_plain, fb.frozen_bn_act_backward_plain
    monkeypatch.setattr(fb, "frozen_bn_act_cuda", _counting(fb, "frozen_bn_act_cuda", plain))
    monkeypatch.setattr(fb, "frozen_bn_act_backward_cuda",
                        _counting(fb, "frozen_bn_act_backward_cuda", plain_bwd))

    def counted_as(name, fn):
        """On the CPU the model runs the plain passes: counted as the kernel's."""
        def run(*args, **kwargs):
            getattr(fb, name).launches += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(fb, "frozen_bn_act_plain", counted_as("frozen_bn_act_cuda", plain))
    monkeypatch.setattr(fb, "frozen_bn_act_backward_plain",
                        counted_as("frozen_bn_act_backward_cuda", plain_bwd))
    monkeypatch.setattr(cs, "FROZEN_BN_BATCH", 1)
    # the summary divides by the summed times: 1 ms a call here
    monkeypatch.setattr(cs, "cuda_ms", lambda fn, iters=20, warmup=3: _once(fn) + 1.0)
    cases, launches, summary = cs.phase_frozen_bn()
    # 16 distinct passes of a ResNet-50 forward, in each dtype and layout
    assert len(cases) == 16 * len(cs.FROZEN_BN_LAYOUTS)
    assert all(c["bitwise"] and c["bound_by"] == "bytes" for c in cases)
    assert {c["form"] for c in cases} == set(fb.FORMS)
    assert sum(c["count"] for c in cases) == 49 * len(cs.FROZEN_BN_LAYOUTS)
    assert sum(c["trainable"] for c in cases) == 39 * len(cs.FROZEN_BN_LAYOUTS)
    assert set(summary) == {f"{d} {l}" for d, l in cs.FROZEN_BN_LAYOUTS}
    # the rehearsal's training config is an R-50
    assert launches == {"predict_r50": 49, "forward_r101": 49, "backward_r101": 39}
    entry = cs.frozen_bn_entry(cases, launches, summary)
    assert entry["launches"] == 49 and entry["ms"] == summary["bfloat16 channels_last"]["ms"]
    out = capsys.readouterr().out
    assert out.count("one ResNet-50 forward at batch 1") == len(cs.FROZEN_BN_LAYOUTS)
