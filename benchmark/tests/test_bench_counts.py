"""The yardstick's counts: model FLOPs against hand counts, and the
kernels' bounds against hand counts and PERF.md's figures."""

import math

import pytest
import torch

from benchmark.harness import flops, roofline

LEVELS_1024x1344 = [(256, 336), (128, 168), (64, 84), (32, 42)]


def test_conv_flops_hand_count_of_a_small_net():
    # conv 3x3 3->8 at 8x8 (padding 1), then 1x1 8->4: 2 FLOPs a multiply-add
    hand = 2 * (3 * 8 * 9 * 64) + 2 * (8 * 4 * 64)
    h = flops.conv_out(8, 3, 1, 1)
    assert h == 8
    assert flops.conv_flops(3, 8, 3, h, h) + flops.conv_flops(8, 4, 1, h, h) == hand


def test_resnet50_at_224_is_its_published_4_1_gmacs():
    layers, outs = flops.backbone_layers("resnet50", (224, 224))
    gmacs = sum(x.flops for x in layers) / 2e9
    assert gmacs == pytest.approx(4.09, rel=0.02)
    assert outs[-1] == (2048, 7, 7)


def test_training_counts_no_backward_through_frozen_layers():
    layers, _ = flops.backbone_layers("resnet50", (224, 224), frozen_stages=1)
    stem = layers[0]
    assert stem.train_flops() == stem.flops
    first = next(x for x in layers if x.name == "layer2.0.conv1")
    assert first.train_flops() == 2 * first.flops  # weight gradient only
    inner = next(x for x in layers if x.name == "layer2.0.conv2")
    assert inner.train_flops() == 3 * inner.flops


def test_k3_bound_is_perf_md_figure():
    # PERF.md's kernel table: K3 0.0852 ms at the training step's shapes
    # (B=2, 512 RoIs at P=7, C=256, float32), K3 bf16 0.0426 ms
    f32 = roofline.k3_bound_s(2, 512, 7, 256, LEVELS_1024x1344, 2, 4)
    bf16 = roofline.k3_bound_s(2, 512, 7, 256, LEVELS_1024x1344, 2, 2)
    assert f32 * 1e3 == pytest.approx(0.0852, abs=5e-5)
    assert bf16 * 1e3 == pytest.approx(0.0426, abs=5e-5)


def test_k1_bound_counts_pairs_up_to_the_walk():
    # box 0 suppresses box 1; box 2 stands apart: kept {0, 2}; pairs tested:
    # box 0 against boxes 1 and 2, box 2 against none
    boxes = torch.tensor([[[0.0, 0, 10, 10], [1.0, 1, 10, 10], [50.0, 50, 60, 60]]])
    valid = torch.ones(1, 3, dtype=torch.bool)
    assert roofline.k1_pairs(boxes, valid, 0.5, None) == 2
    assert roofline.k1_bound_s(boxes, valid, 0.5, None) == max(
        3 * 18 / roofline.PEAK_HBM_BYTES, 32 / roofline.PEAK_FP32_FLOPS)
    # with max_keep=1 the walk stops at its first kept box, before any pair
    assert roofline.k1_pairs(boxes, valid, 0.5, 1) == 0


def test_k2_bound_counts_distinct_cells_once():
    # one RoI inside one level, P=1, S=1: one sample, four distinct corners
    c = 8
    feats = [torch.zeros(1, 16, 16, c)]
    rois = torch.tensor([[[4.5, 4.5, 6.5, 6.5]]])
    bound = roofline.k2_bound_s(feats, rois, (1,), 1, 1, (1e9, 1e9))
    nbytes = 4 * c * 4 + 1 * c * 4 + 20
    assert bound == max(nbytes / roofline.PEAK_HBM_BYTES,
                        c * (4 * 3 + 1) / roofline.PEAK_FP32_FLOPS)
    assert math.isfinite(bound)
