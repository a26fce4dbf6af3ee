"""ResNeXt trunks (``models/resnet.py::TRUNKS``) against the benchmark's plain
reference (``benchmark/reference/resnext.py``: plain PyTorch in float32,
nothing of the port), on the CPU with seeded random weights.

* The table: ``resnext101_64x4d`` at its published widths (64 groups of 4
  channels at res2, inner widths 256-2048, the stride on the grouped 3x3,
  outputs 256-2048) keeps torchvision's and the JAX package's module
  names: the state dict has R-101's keys, its grouped weights
  ``[inner, inner / 64, 3, 3]``.
* A reduced trunk (blocks (1, 1, 2, 1), 8 groups of 4, ``fpn_channels=32``,
  a 128x128 canvas), float32: C2-C5 within 1e-4 x max |C| of the reference
  (both sides sum every convolution in float32, in the orders their
  convolution algorithms choose, and frozen BN's scale and bias are
  worked out the same way), and the whole Mask R-CNN
  inference held stage by stage as the benchmark holds it
  (``harness/compare.py``: the reference follows the port's own hand-offs),
  the exact stages exact (measured: equal C2-C5, ``rpn_gap`` 4e-6). bf16
  within the repo's bf16 limit (``tests/test_torch_bf16.py``: every level
  within 3e-2 x max |level|; measured 0.7-1.4% on the port's initial
  weights, as that test's, and 2.2-3.0% on the calibrated ones, whose
  normalized activations put each layer's rounding nearer their largest).
* The published trunk on a 64x64 canvas: C2-C5 against the reference.
* ``predict_fn`` and ``train_step`` of the reduced Mask R-CNN in float32
  and bf16: finite, the grouped convolutions trained.
* R-50 and R-101 are the trunk with one group of 64: their state dicts'
  keys and shapes as before, their C2-C5 equal to
  ``benchmark/reference/model.py``'s plain bottleneck's.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import common, compare, weights  # noqa: E402
from benchmark.reference import model as plain_ref  # noqa: E402
from benchmark.reference import resnext as ref  # noqa: E402
from detectron_tpu_torch.config import get_config  # noqa: E402
from detectron_tpu_torch.models import resnet, zoo  # noqa: E402
from detectron_tpu_torch.models.zoo import build_detector  # noqa: E402
from detectron_tpu_torch.train import state as tstate  # noqa: E402

TINY = "resnext_tiny"
OVERRIDES = [f"model.backbone={TINY}", "model.name=mask_rcnn", "model.num_classes=4",
             "model.fpn_channels=32", "data.image_size=[128, 128]",
             "rpn.pre_nms_topk_test=128", "rpn.post_nms_topk_test=32",
             "test.detections_per_image=10", "rpn.pre_nms_topk_train=128",
             "rpn.post_nms_topk_train=32", "roi.batch_per_image=32",
             "train.batch_size=2", "train.max_gt_boxes=8"]
# the reference's settings of the reduced model (benchmark/reference/model.py's keys)
SETTINGS = {"backbone": TINY, "num_classes": 4, "fpn_channels": 32, "frozen_stages": 1,
            "anchor_ratios": [0.5, 1.0, 2.0], "rpn_anchor_scale": 8.0,
            "pre_nms_topk_test": 128, "post_nms_topk_test": 32, "rpn_nms_thresh": 0.7,
            "pool_size": 7, "mask_pool_size": 14, "sampling_ratio": 2,
            "bbox_reg_weights": [10.0, 10.0, 5.0, 5.0], "score_thresh": 0.05,
            "test_nms_thresh": 0.5, "detections_per_image": 10}
LEVEL_LIMIT = 3e-2  # tests/test_torch_bf16.py's


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def tiny_trunk(monkeypatch):
    """A reduced ResNeXt in both tables, under one name."""
    monkeypatch.setitem(resnet.TRUNKS, TINY, resnet.Trunk((1, 1, 2, 1), groups=8,
                                                          width_per_group=4))
    monkeypatch.setitem(ref.TRUNKS, TINY, ((1, 1, 2, 1), 8, 4))


def images(n, hw, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, *hw, 3), generator=g)


def calibrated(shapes: dict, settings: dict, calib: torch.Tensor, seed=3) -> dict:
    """The benchmark's weights: drawn from a seed, each bottleneck's last BN
    scale 0.2, the frozen statistics set by the reference on ``calib``."""
    params = weights.random_params(shapes, seed, "cpu", 0.2)
    ref.calibrate_frozen_bn(params, settings, calib)
    return params


def trunk_params(module: torch.nn.Module, backbone: str, calib) -> dict:
    """Calibrated weights for a bare trunk, under the detector's names."""
    shapes = {f"backbone.{k}": tuple(v.shape) for k, v in module.state_dict().items()}
    params = calibrated(shapes, {"backbone": backbone}, calib)
    module.load_state_dict({k[len("backbone."):]: v for k, v in params.items()})
    return params


def max_rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def test_published_trunk_keeps_the_layout_and_groups_its_3x3s():
    x101 = resnet.ResNet("resnext101_64x4d").state_dict()
    r101 = resnet.ResNet("resnet101").state_dict()
    assert list(x101) == list(r101)  # the same names, in the same order
    cin = 64
    for stage, blocks in enumerate((3, 4, 23, 3)):
        inner, out = 256 * 2 ** stage, 256 * 2 ** stage
        for i in range(blocks):
            tag = f"layer{stage + 1}.{i}"
            assert x101[f"{tag}.conv1.weight"].shape == (inner, cin, 1, 1)
            assert x101[f"{tag}.conv2.weight"].shape == (inner, inner // 64, 3, 3)
            assert x101[f"{tag}.bn2.running_var"].shape == (inner,)
            assert x101[f"{tag}.conv3.weight"].shape == (out, inner, 1, 1)
            cin = out
    module = resnet.ResNet("resnext101_64x4d")
    assert module.layer1[0].conv2.groups == 64 and module.layer4[2].conv2.stride == (1, 1)
    assert module.layer2[0].conv2.stride == (2, 2) and module.layer2[0].conv1.stride == (1, 1)
    assert module.out_channels == [256, 512, 1024, 2048]
    with pytest.raises(ValueError, match="resnext101_64x4d"):
        resnet.ResNet("resnext50_32x4d")


def test_he_fan_out_init_holds_for_a_grouped_weight():
    """``Detector.init`` draws a grouped weight ``[cout, cin / g, 3, 3]`` with
    He fan-out over ``cout * 9``, as torch's ``kaiming_normal_(mode=
    "fan_out")`` counts a grouped weight's fan-out (torchvision's ResNeXt
    init), and as ``harness/weights.py`` draws it."""
    shape = (256, 4, 3, 3)
    std = math.sqrt(2.0 / (256 * 9))
    fan_out = torch.nn.init._calculate_fan_in_and_fan_out(torch.empty(shape))[1]
    assert fan_out == 256 * 9
    assert zoo._init_std("backbone.layer1.0.conv2.weight", shape) == pytest.approx(std)
    assert weights.init_std("backbone.layer1.0.conv2.weight", shape) == pytest.approx(std)
    det = build_detector(get_config(None, OVERRIDES), device="cpu")
    drawn = det.init(0)["backbone.layer4.0.conv2.weight"]  # [256, 32, 3, 3]
    assert drawn.shape == (256, 32, 3, 3)
    assert float(drawn.std()) == pytest.approx(math.sqrt(2.0 / (256 * 9)), rel=0.02)


@pytest.fixture(scope="module")
def reduced_model():
    """The reduced Mask R-CNN (float32) and its calibrated weights."""
    mp = pytest.MonkeyPatch()
    mp.setitem(resnet.TRUNKS, TINY, resnet.Trunk((1, 1, 2, 1), groups=8, width_per_group=4))
    mp.setitem(ref.TRUNKS, TINY, ((1, 1, 2, 1), 8, 4))
    try:
        det = build_detector(get_config(None, OVERRIDES), device="cpu")
        shapes = {k: tuple(v.shape) for k, v in det.module.state_dict().items()}
        params = calibrated(shapes, SETTINGS, images(2, (128, 128), seed=1))
        yield det, params
    finally:
        mp.undo()


def test_reduced_trunk_matches_the_reference_in_float32(reduced_model):
    det, params = reduced_model
    det.module.load_state_dict(params)
    x = images(2, (128, 128))
    with torch.no_grad():
        got = det.module.backbone(x.permute(0, 3, 1, 2))
        want = ref.Net(params, SETTINGS).backbone(x.permute(0, 3, 1, 2))
    trunk = det.module.backbone
    for i, w in enumerate(want):
        layer = getattr(trunk, f"layer{i + 1}")
        assert layer[0].conv2.weight.shape == (32 * 2 ** i, 4 * 2 ** i, 3, 3)  # 8 groups
        c = got[f"c{i + 2}"]
        assert c.shape == w.shape and c.shape[1] == 256 * 2 ** i
        assert max_rel(c, w) <= 1e-4, i


def test_reduced_mask_rcnn_inference_follows_the_reference_stage_by_stage(reduced_model):
    det, params = reduced_model
    det.module.load_state_dict(params)
    feed = {"image": images(2, (128, 128), seed=2),
            "image_hw": torch.tensor([[128.0, 128.0], [96.0, 120.0]])}
    feed["image"][1, 96:] = 0.0
    feed["image"][1, :, 120:] = 0.0
    slot = {}
    with common.captured_stages(slot):
        dets, masks = det.predict_fn(None, feed)
    side = {"rpn": slot["rpn"], "proposals": slot["proposals"], "box": slot["box"],
            "dets": plain_ref.Detections(dets.boxes, dets.scores, dets.classes,
                                         dets.valid.bool()),
            "masks": masks}
    want = ref.follow(params, SETTINGS, feed["image"], feed["image_hw"], side)
    got = compare.inference_numbers(side, want, SETTINGS["bbox_reg_weights"])
    assert int(dets.valid.sum()) > 0
    assert got["proposal_mismatch"] == 0 and got["detection_mismatch"] == 0, got
    assert got["rpn_gap"] <= 1e-3, got  # over the logits' spread
    assert got["score_gap"] <= 1e-4 and got["box_gap"] <= 1e-4, got
    assert got["mask_gap"] <= 1e-4, got


def test_reduced_trunk_in_bf16_is_within_the_bf16_limit():
    """On the port's own initial weights (He fan-out, identity frozen BN), as
    ``tests/test_torch_bf16.py`` holds R-50 on JAX's of the same scales."""
    cfg = get_config(None, OVERRIDES + ["model.dtype=bfloat16"])
    det = build_detector(cfg, device="cpu")
    params = det.init(0)
    det.module.load_state_dict(params)
    x = images(2, (128, 128))
    with torch.no_grad():
        levels = det.module.features(x)
        want = ref.Net(params, SETTINGS).features(x)
    for lvl, (a, b) in enumerate(zip(levels, want)):
        assert a.dtype == torch.bfloat16
        assert 0 < max_rel(a.float(), b) <= LEVEL_LIMIT, lvl


def test_published_trunk_at_64px_matches_the_reference():
    module = resnet.ResNet("resnext101_64x4d")
    x = images(1, (64, 64), seed=4)
    params = trunk_params(module, "resnext101_64x4d", images(1, (64, 64), seed=5))
    with torch.no_grad():
        got = module(x.permute(0, 3, 1, 2))
        want = ref.Net(params, {"backbone": "resnext101_64x4d"}).backbone(x.permute(0, 3, 1, 2))
    for i, w in enumerate(want):
        c = got[f"c{i + 2}"]
        assert c.shape == (1, 256 * 2 ** i, 64 // 2 ** (i + 2), 64 // 2 ** (i + 2))
        assert c.shape == w.shape
        assert max_rel(c, w) <= 1e-4, i


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_mask_rcnn_predicts_and_trains(reduced_model, dtype):
    from detectron_tpu_torch.data.synthetic import make_batch

    _, params = reduced_model
    cfg = get_config(None, OVERRIDES + [f"model.dtype={dtype}"])
    det = build_detector(cfg, device="cpu")
    batch = make_batch(np.random.RandomState(0), 2, (128, 128), 4, max_gt=8)
    dets, masks = det.predict_fn(params, {k: torch.as_tensor(batch[k])
                                          for k in ("image", "image_hw")})
    assert masks.shape == (2, 10, 28, 28) and bool(torch.isfinite(dets.scores).all())
    state = tstate.create_train_state(cfg, det, params)
    before = det.module.backbone.layer3[0].conv2.weight.detach().clone()
    metrics = tstate.train_step(state, det.batch_to_device(batch))
    assert bool(torch.isfinite(metrics["loss_total"]))
    after = det.module.backbone.layer3[0].conv2.weight.detach()
    assert after.shape == (128, 16, 3, 3)
    assert bool(torch.isfinite(after).all()) and not torch.equal(before, after)


@pytest.mark.parametrize("depth", ["resnet50", "resnet101"])
def test_resnet_is_the_trunk_of_one_group_and_unchanged(depth):
    module = resnet.ResNet(depth)
    sd = module.state_dict()
    cin = 64
    for stage, blocks in enumerate(resnet.STAGE_BLOCKS[depth]):
        feats = 64 * 2 ** stage
        for i in range(blocks):
            tag = f"layer{stage + 1}.{i}"
            assert sd[f"{tag}.conv1.weight"].shape == (feats, cin, 1, 1)
            assert sd[f"{tag}.conv2.weight"].shape == (feats, feats, 3, 3)
            assert sd[f"{tag}.conv3.weight"].shape == (4 * feats, feats, 1, 1)
            assert (f"{tag}.downsample_conv.weight" in sd) == (i == 0)
            assert module.get_submodule(tag).groups == 1
            cin = 4 * feats
    x = images(1, (64, 64), seed=6)
    params = trunk_params(module, depth, images(1, (64, 64), seed=7))
    with torch.no_grad():
        got = module(x.permute(0, 3, 1, 2))
        want = plain_ref.Net(params, {"backbone": depth}).backbone(x.permute(0, 3, 1, 2))
        plain = ref.Net(params, {"backbone": depth}).backbone(x.permute(0, 3, 1, 2))
    for i, w in enumerate(want):
        assert torch.equal(plain[i], w)  # the reference's one group is the plain bottleneck
        assert max_rel(got[f"c{i + 2}"], w) <= 1e-4, i
