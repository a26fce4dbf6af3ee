"""A rehearsal of chip_smoke.py's training phases on the CPU, so that the
script's own code (phase logic, checks, breakdown, driver resume) is
exercised before a card runs it.

The card-only pieces are replaced: the kernels' plain versions stand in
for the CUDA wrappers (and count launches as the wrappers do), the kernel
dispatch takes them for CPU tensors, ``torch.cuda`` timing and memory
calls are stubbed, and the configs are cut to 64x128 with FPN 32, an
R-50 backbone and 256 / 64 / 64 RPN candidates, proposals and RoIs. What the card alone can show (that a kernel builds, agrees
with its plain version, and how long it takes) stays with chip_smoke.py.
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


@pytest.fixture
def rehearsal(monkeypatch, tmp_path):
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "CANVAS", (128, 160))
    monkeypatch.setattr(cs, "TRAIN_OUT", str(tmp_path / "train_smoke"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(zoo, "resolve_device", lambda device=None: torch.device("cpu"))
    for mod, name, plain in ((nms, "greedy_keep_cuda", nms.greedy_keep_plain),
                             (ra, "multilevel_roi_align_cuda", ra.multilevel_roi_align_plain),
                             (ra, "multilevel_roi_align_bwd_cuda",
                              ra.multilevel_roi_align_bwd_plain)):
        monkeypatch.setattr(mod, name, _counting(plain))
    monkeypatch.setattr(nms, "greedy_keep", lambda *a, **k: nms.greedy_keep_cuda(*a, **k))
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
    cs.phase_function(rehearsal, feats)
    assert "[function]" in capsys.readouterr().out


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
