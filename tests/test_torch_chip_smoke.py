"""A rehearsal of chip_smoke.py's kernel and training phases on the CPU, so
that the script's own code (phase logic, cases, checks, breakdown, driver
resume) is exercised before a card runs it.

The card-only pieces are replaced: the kernels' plain versions stand in
for the CUDA wrappers (and count launches as the wrappers do), the kernel
dispatch takes them for CPU tensors, ``torch.cuda`` timing and memory
calls are stubbed, and the configs are cut to 64x128 with FPN 32, an
R-50 backbone and 256 / 64 / 64 RPN candidates, proposals and RoIs; the
NMS cases are cut to a few hundred boxes. What the card alone can show
(that a kernel builds, agrees with its plain version, and how long it
takes) stays with chip_smoke.py.
"""

import time

import numpy as np
import pytest
import torch

import chip_smoke as cs
import detectron_tpu_torch.config
from detectron_tpu_torch.models import zoo
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


class _Event:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def query(self):
        return False  # as on the card while the spin kernel holds the stream

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _counting(plain):
    def wrapper(*args, **kwargs):
        wrapper.launches += 1
        return plain(*args, **kwargs)

    wrapper.launches = 0
    return wrapper


class _PlainFunction(ra.RoIAlignFunction):
    """RoIAlignFunction with the (counting) stand-ins on CPU tensors."""

    @staticmethod
    def forward(ctx, rois, levels, strides, output_size, sampling_ratio, *features):
        ctx.save_for_backward(rois, levels)
        ctx.strides, ctx.sampling_ratio = tuple(strides), sampling_ratio
        ctx.level_hw = [tuple(f.shape[1:3]) for f in features]
        return ra.multilevel_roi_align_cuda(features, rois, levels, strides, output_size,
                                            sampling_ratio)

    @staticmethod
    def backward(ctx, grad):
        rois, levels = ctx.saved_tensors
        grads = ra.multilevel_roi_align_bwd_cuda(grad.contiguous(), ctx.level_hw, rois,
                                                 levels, ctx.strides, ctx.sampling_ratio)
        return (None,) * 5 + tuple(g if need else None
                                   for g, need in zip(grads, ctx.needs_input_grad[5:]))


def _plain_accumulate(grads, grad, rois, levels, strides, sampling_ratio=2):
    level_hw = [tuple(t.shape[1:3]) for t in grads]
    for acc, add in zip(grads, ra.multilevel_roi_align_bwd_plain(
            grad, level_hw, rois, levels, strides, sampling_ratio)):
        acc.add_(add)


@pytest.fixture
def rehearsal(monkeypatch, tmp_path):
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "CANVAS", (128, 160))
    monkeypatch.setattr(cs, "TRAIN_OUT", str(tmp_path / "train_smoke"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(zoo, "resolve_device", lambda device=None: torch.device("cpu"))
    for mod, name, plain in ((nms, "greedy_keep_cuda", nms.greedy_keep_plain),
                             (ra, "multilevel_roi_align_cuda", ra.multilevel_roi_align_plain),
                             (ra, "multilevel_roi_align_bwd_cuda",
                              ra.multilevel_roi_align_bwd_plain)):
        monkeypatch.setattr(mod, name, _counting(plain))
    monkeypatch.setattr(nms, "greedy_keep", lambda *a, **k: nms.greedy_keep_cuda(*a, **k))
    # the launches that chip_smoke times apart: timed here, never compared
    monkeypatch.setattr(nms, "nms_mask_cuda", lambda sboxes, thresh, offset=0.0: sboxes)
    monkeypatch.setattr(nms, "nms_scan_cuda", lambda mask, svalid, max_keep=None: svalid)
    monkeypatch.setattr(ra, "roi_align_bwd_accumulate_cuda", _plain_accumulate)
    monkeypatch.setattr(cs, "NMS_CASES", tuple(
        dict(case, g=3, n=case["n"] // 5, n_invalid=case["n_invalid"] // 5,
             max_out=case["max_out"] // 5) for case in cs.NMS_CASES))
    monkeypatch.setattr(cs, "NMS_EDGE_CASES", tuple(
        dict(case, n=min(case["n"], 300), n_invalid=min(case["n_invalid"], case["n"], 300))
        for case in cs.NMS_EDGE_CASES))
    monkeypatch.setattr(ra, "RoIAlignFunction", _PlainFunction)
    get_config = detectron_tpu_torch.config.get_config

    def small_config(path=None, overrides=()):
        overrides = list(overrides)
        for small in ("model.fpn_channels=32", "model.backbone=resnet50",
                      "data.image_size=[64, 128]", "rpn.pre_nms_topk_train=256",
                      "rpn.post_nms_topk_train=64", "roi.batch_per_image=64"):
            if not any(o.split("=")[0] == small.split("=")[0] for o in overrides):
                overrides.append(small)
        return get_config(path, overrides)

    monkeypatch.setattr(detectron_tpu_torch.config, "get_config", small_config)
    torch.manual_seed(0)
    return np.random.RandomState(0)


def test_kernel_phases_k3_and_function(rehearsal, capsys):
    feats = cs.level_features(rehearsal, c=16)
    k3 = cs.phase_roi_align_bwd(rehearsal, feats)
    assert [c["case"] for c in k3] == ["P7 R512", "P14 R128"]
    assert all(c["max_abs_err"] == 0.0 and c["bound_by"] == "bytes" for c in k3)
    assert all(c["fill_ms"] >= 0.0 and c["kernel_ms"] >= 0.0 for c in k3)
    out = capsys.readouterr().out
    for kind in cs.K3_STRESS:
        for p in (7, 14):
            assert f"[K3 stress: {kind}, P={p} R=128] levels" in out
    assert "(fill " in out and " + kernel " in out
    cs.phase_function(rehearsal, feats)
    assert "[function]" in capsys.readouterr().out


def test_kernel_phase_k2_cases_stress_and_rerun(rehearsal, capsys):
    feats = cs.level_features(rehearsal, c=16)
    before = ra.multilevel_roi_align_cuda.launches
    k2 = cs.phase_roi_align(rehearsal, feats)
    assert [c["case"] for c in k2] == ["P7 R300", "P14 R100", "P7 R512", "P14 R128"]
    assert [c["path"] for c in k2] == ["predict", "predict", "train", "train"]
    for c in k2:
        assert c["max_abs_err"] == 0.0 and c["bound_by"] == "bytes"
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
    assert out.count("two runs bitwise equal: True") == 4 * 2 + len(cs.K3_STRESS) * 2 + 4
    assert "per-RoI distinct cells, from the inputs" in out
    assert "distinct over the batch" in out
    # each check runs the kernel twice; the timing adds its own calls
    assert ra.multilevel_roi_align_cuda.launches - before >= 2 * (4 * 2 + 10 + 4)


def test_kernel_phase_k1_cases_and_split(rehearsal, capsys):
    k1 = cs.phase_nms(rehearsal)
    assert [c["case"] for c in k1] == ["rpn", "det", "rpn_train"]
    assert [c["max_keep"] for c in k1] == [60, 20, 200]  # min(max_out, n), cut by 5
    for c in k1:
        assert {"ms", "mask_ms", "scan_ms", "scan_full_ms", "plain_ms", "bound_ms"} <= set(c)
    out = capsys.readouterr().out
    for case in cs.NMS_EDGE_CASES:
        assert f"[K1 edge] {case['name']}: " in out
    assert "max_keep=1," in out and "max_keep=None, 0 kept" in out  # all invalid


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
    totals, times = cs.phase_train(warmup=1, steps=2)
    assert totals == {"greedy_nms": 2, "multilevel_roi_align": 4,
                      "multilevel_roi_align_bwd": 4}
    assert len(times) == 2
    out = capsys.readouterr().out
    assert "0 unchanged" in out and "0 changed" in out
    stages = out.split("[train stages]")[1].splitlines()[0]
    for stage in ("anchors+draws", "backbone+fpn", "proposals (K1)", "mask: targets",
                  "backward", "optimizer"):
        assert stage in stages
    assert "restored checkpoint at step" in out and "[driver] resumed" in out


def test_cross_train_phase(rehearsal, capsys):
    """Both sides run the plain versions here: the sound runs read 0 and
    the planted K3 faults read above the limit."""
    readings = cs.phase_cross_train()
    assert "K3: launches {'greedy_nms': 1, 'multilevel_roi_align': 2, " \
           "'multilevel_roi_align_bwd': 2}; max relative loss diff 0.000e+00" \
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
                            {"predict": 0, "train": 10}, 1e-5)
    assert entry["launches"] == 10 and entry["ms"] == 3.0 and entry["bound_ms"] == 1.5
    assert entry["replaces"] == "detectron_tpu/ops/roi_align_pallas.py:529"
    assert entry["library_ms"] is None and entry["route"] == "cuda"
