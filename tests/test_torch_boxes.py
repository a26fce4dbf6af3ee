"""The port's anchors and box math against the JAX package on seeded inputs.

Anchors are numpy in both packages and must be equal; the box functions
are float32 and must agree within 1e-6 (absolute on IoUs and validity
masks exactly; relative on coordinates, whose exp/log may differ by an
ulp between the two libraries)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.models.faster_rcnn import rpn_anchor_generator as j_rpn_anchors
from detectron_tpu.ops import anchors as janchors
from detectron_tpu.ops import boxes as jboxes
from detectron_tpu_torch.config import base_config
from detectron_tpu_torch.models.faster_rcnn import rpn_anchor_generator as t_rpn_anchors
from detectron_tpu_torch.ops import anchors as tanchors
from detectron_tpu_torch.ops import boxes as tboxes

TOL = 1e-6


def random_boxes(rng, n, span=500.0, min_wh=0.5, max_wh=200.0):
    xy = rng.uniform(-20, span, size=(n, 2))
    wh = rng.uniform(min_wh, max_wh, size=(n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("image_hw", [(128, 128), (1024, 1344), (640, 1024)])
def test_rpn_anchor_tables_equal(image_hw):
    cfg = base_config()
    want = j_rpn_anchors(cfg).grid_anchors(image_hw)
    got = t_rpn_anchors(cfg).grid_anchors(image_hw)
    assert len(want) == len(got) == 5
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and np.array_equal(w, g)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_base_anchors_equal(offset):
    kw = dict(base_size=16, ratios=(0.5, 1.0, 2.0), scales=(8, 16, 32), offset=offset)
    assert np.array_equal(janchors.generate_base_anchors(**kw),
                          tanchors.generate_base_anchors(**kw))


def test_retinanet_style_generator_equal():
    kw = dict(strides=(8, 16, 32, 64, 128), octave_scales=(1.0, 2 ** (1 / 3), 2 ** (2 / 3)),
              base_scale=4.0)
    want = janchors.AnchorGenerator(**kw).all_anchors((256, 384))
    got = tanchors.AnchorGenerator(**kw).all_anchors((256, 384))
    assert np.array_equal(want, got)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_bbox_overlaps(offset):
    rng = np.random.RandomState(0)
    a, b = random_boxes(rng, 64), random_boxes(rng, 48)
    b[:8] = a[:8]  # exact matches
    want = np.asarray(jboxes.bbox_overlaps(jnp.asarray(a), jnp.asarray(b), offset))
    got = tboxes.bbox_overlaps(torch.tensor(a), torch.tensor(b), offset).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_pairwise_iou(offset):
    """Elementwise IoU of aligned ``[2, 3, 40, 4]`` arrays (any leading
    shape): exact matches, disjoint pairs, degenerate and inverted boxes
    (the EPS floor on the union), within TOL of JAX's."""
    rng = np.random.RandomState(5)
    a = random_boxes(rng, 240, min_wh=-2.0).reshape(2, 3, 40, 4)
    b = random_boxes(rng, 240, min_wh=-2.0).reshape(2, 3, 40, 4)
    b[:, :, :6] = a[:, :, :6]  # exact matches
    b[:, :, 6:10] = a[:, :, 6:10] + 2000.0  # disjoint
    a[:, :, 10:12, 2:] = a[:, :, 10:12, :2]  # zero area on both sides
    b[:, :, 10:12] = a[:, :, 10:12]
    want = np.asarray(jboxes.pairwise_iou(jnp.asarray(a), jnp.asarray(b), offset))
    got = tboxes.pairwise_iou(torch.tensor(a), torch.tensor(b), offset)
    assert got.shape == (2, 3, 40) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_decode_with_clamp_and_clip(offset):
    rng = np.random.RandomState(1)
    anchors = random_boxes(rng, 256)
    deltas = rng.normal(0, 1.5, size=(256, 4)).astype(np.float32)
    deltas[:16, 2:] = 9.0  # beyond BBOX_XFORM_CLIP
    weights = (10.0, 10.0, 5.0, 5.0)
    want = jboxes.decode_boxes(jnp.asarray(deltas), jnp.asarray(anchors), weights, offset)
    got = tboxes.decode_boxes(torch.tensor(deltas), torch.tensor(anchors), weights, offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    want_c = np.asarray(jboxes.clip_boxes(want, 300.0, 400.0, offset))
    got_c = tboxes.clip_boxes(got, 300.0, 400.0, offset).numpy()
    np.testing.assert_allclose(got_c, want_c, rtol=TOL, atol=TOL)


def test_clip_boxes_per_image_sizes():
    rng = np.random.RandomState(2)
    boxes = random_boxes(rng, 2 * 50, span=700).reshape(2, 50, 4)
    hw = np.array([[480.0, 640.0], [600.0, 300.0]], np.float32)
    want = np.stack([np.asarray(jboxes.clip_boxes(jnp.asarray(boxes[i]), hw[i, 0], hw[i, 1]))
                     for i in range(2)])
    t_hw = torch.tensor(hw)
    got = tboxes.clip_boxes(torch.tensor(boxes), t_hw[:, 0, None], t_hw[:, 1, None]).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("min_size", [0.0, 2.0])
def test_valid_box_mask(min_size):
    rng = np.random.RandomState(3)
    boxes = random_boxes(rng, 200, min_wh=-3.0, max_wh=6.0)
    want = np.asarray(jboxes.valid_box_mask(jnp.asarray(boxes), min_size))
    got = tboxes.valid_box_mask(torch.tensor(boxes), min_size).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_encode_round_trips_like_jax(offset):
    rng = np.random.RandomState(4)
    anchors, gt = random_boxes(rng, 128, min_wh=4.0), random_boxes(rng, 128, min_wh=4.0)
    weights = (10.0, 10.0, 5.0, 5.0)
    want = np.asarray(jboxes.encode_boxes(jnp.asarray(gt), jnp.asarray(anchors), weights, offset))
    got = tboxes.encode_boxes(torch.tensor(gt), torch.tensor(anchors), weights, offset)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=TOL)
    back = tboxes.decode_boxes(got, torch.tensor(anchors), weights, offset).numpy()
    np.testing.assert_allclose(back, gt, rtol=1e-5, atol=1e-3)
