"""The port's training losses and target layers against the JAX package.

Losses: the same float32 inputs give the same values within 1e-6
relative (one float32 formula in two libraries). Targets: the same
anchors, proposals, ground truth and uniform draws give equal labels,
weights, matched indices, sampled RoIs and mask targets; encoded box
targets agree within 1e-5 (float32 divisions and logs in two libraries).
The draws are made from JAX keys exactly as the JAX functions split them
(``split(key, B)``, then ``split`` into the positive and the negative, or
the fg and the bg, draw), so both sides sample the same entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.config import get_config as jax_get_config
from detectron_tpu.data.synthetic import make_batch
from detectron_tpu.layers.anchor_target import _rank_select as j_rank_select
from detectron_tpu.layers.anchor_target import anchor_target as j_anchor_target
from detectron_tpu.layers.mask_target import crop_gt_masks_batched as j_crop
from detectron_tpu.layers.proposal_target import sample_rois as j_sample_rois
from detectron_tpu.models import faster_rcnn as jfrcnn
from detectron_tpu.models import losses as jl
from detectron_tpu_torch.layers import anchor_target as tat
from detectron_tpu_torch.layers.mask_target import crop_gt_masks_batched
from detectron_tpu_torch.layers.proposal_target import sample_rois
from detectron_tpu_torch.models import losses as tl


def t(x):
    return torch.tensor(np.asarray(x))


def jax_pair_draws(key, b, n):
    """The two uniform draws ``[B, n]`` that a batched JAX sampler makes
    from ``key``: ``split(key, B)``, then ``split`` per image."""
    first, second = [], []
    for k in jax.random.split(key, b):
        k1, k2 = jax.random.split(k)
        first.append(np.asarray(jax.random.uniform(k1, (n,))))
        second.append(np.asarray(jax.random.uniform(k2, (n,))))
    return torch.tensor(np.stack(first)), torch.tensor(np.stack(second))


# ------------------------------------------------------------------ losses

RNG = np.random.RandomState(0)
PRED = RNG.randn(64, 4).astype(np.float32) * 0.5
TARGET = RNG.randn(64, 4).astype(np.float32) * 0.5
LOGITS = RNG.randn(48, 6).astype(np.float32) * 3.0
LABELS = RNG.randint(0, 6, size=48).astype(np.int32)
WEIGHTS = (RNG.rand(48) > 0.3).astype(np.float32)
ONEHOT = np.eye(6, dtype=np.float32)[LABELS]
MASK_LOGITS = RNG.randn(10, 8, 8, 5).astype(np.float32) * 2.0
MASK_TARGETS = (RNG.rand(10, 8, 8) > 0.5).astype(np.float32)
MASK_CLASSES = RNG.randint(0, 6, size=10).astype(np.int32)
MASK_WEIGHTS = (RNG.rand(10) > 0.4).astype(np.float32)

LOSS_CASES = {
    "smooth_l1_sigma1": (lambda m, a: m.smooth_l1(a(PRED), a(TARGET), sigma=1.0)),
    "smooth_l1_sigma3": (lambda m, a: m.smooth_l1(a(PRED), a(TARGET), sigma=3.0)),
    "smooth_l1_beta_1/9": (lambda m, a: m.smooth_l1_beta(a(PRED), a(TARGET), 1.0 / 9.0)),
    "smooth_l1_beta_0": (lambda m, a: m.smooth_l1_beta(a(PRED), a(TARGET), 0.0)),
    "softmax_ce": (lambda m, a: m.softmax_cross_entropy(a(LOGITS), a(LABELS))),
    "softmax_ce_weighted": (lambda m, a: m.softmax_cross_entropy(
        a(LOGITS), a(LABELS), weights=a(WEIGHTS), normalizer=7.0)),
    "sigmoid_ce": (lambda m, a: m.optax_sigmoid_ce(a(LOGITS), a(ONEHOT))),
    "focal": (lambda m, a: m.sigmoid_focal_loss(a(LOGITS), a(ONEHOT))),
    "focal_weighted": (lambda m, a: m.sigmoid_focal_loss(
        a(LOGITS), a(ONEHOT), alpha=0.3, gamma=1.5, weights=a(WEIGHTS), normalizer=5.0)),
    "mask_bce": (lambda m, a: m.mask_bce_loss(a(MASK_LOGITS), a(MASK_TARGETS),
                                              a(MASK_CLASSES), a(MASK_WEIGHTS))),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_matches_jax(name):
    fn = LOSS_CASES[name]
    want = np.asarray(fn(jl, jnp.asarray))
    got = fn(tl, t).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------- anchor targets

CFG = jax_get_config(None, ["model.name=mask_rcnn", "model.num_classes=4",
                            "data.image_size=[128, 128]"])


def small_batch(seed=0, b=2, max_gt=8):
    return make_batch(np.random.RandomState(seed), b, (128, 128), 4, max_gt=max_gt)


def rpn_anchors():
    gen = jfrcnn.rpn_anchor_generator(CFG)
    return np.concatenate(gen.grid_anchors((128, 128)), 0).astype(np.float32)


@pytest.mark.parametrize("n,cap,max_cap", [(300, 40, 256), (300, 40, 0), (200, 256, 256),
                                           (300, 0, 256)])
def test_rank_select_both_branches(n, cap, max_cap):
    """max_cap < n takes the bounded top_k + scatter branch, otherwise the
    argsort rank; cap 0 selects nothing."""
    rng = np.random.RandomState(n + cap)
    eligible = rng.rand(2, n) < 0.4
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    want = np.stack([np.asarray(j_rank_select(jnp.asarray(e), cap, k, max_cap=max_cap))
                     for e, k in zip(eligible, keys)])
    noise = torch.tensor(np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys]))
    got = tat.rank_select(torch.tensor(eligible), torch.full((2,), cap), noise,
                          max_cap=max_cap)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum(1).max()) == min(cap, int(eligible.sum(1).max()))


ANCHOR_CASES = {
    # the RPN sample at the 128x128 canvas: 256 of 4092 anchors (top_k branch)
    "rpn_topk": dict(anchor_slice=None, sample_size=256),
    # fewer anchors than the sample: the argsort branch
    "argsort": dict(anchor_slice=slice(None, None, 20), sample_size=256),
    # no sampling (RetinaNet's use)
    "no_sample": dict(anchor_slice=None, sample_size=0),
    # duplicated anchors: the force match keeps every tied best anchor
    "ties": dict(anchor_slice="dup", sample_size=256),
}


@pytest.mark.parametrize("case", sorted(ANCHOR_CASES))
def test_anchor_target_matches_jax(case):
    spec = ANCHOR_CASES[case]
    anchors = rpn_anchors()
    if spec["anchor_slice"] == "dup":
        anchors = np.concatenate([anchors[:1500], anchors[:1500]], 0)
    elif spec["anchor_slice"] is not None:
        anchors = anchors[spec["anchor_slice"]]
    batch = small_batch(seed=3)
    batch["gt_classes"][1] = 0  # an image with no valid gt
    key = jax.random.PRNGKey(11)
    kwargs = dict(pos_iou=0.7, neg_iou=0.3, force_match=True,
                  sample_size=spec["sample_size"], pos_fraction=0.5)
    want = j_anchor_target(jnp.asarray(anchors), jnp.asarray(batch["gt_boxes"]),
                             jnp.asarray(batch["gt_classes"]), key, **kwargs)
    pos_noise, neg_noise = jax_pair_draws(key, 2, anchors.shape[0])
    got = tat.anchor_target(t(anchors), t(batch["gt_boxes"]), t(batch["gt_classes"]),
                            pos_noise, neg_noise, **kwargs)
    for name in ("labels", "matched_idx", "cls_weights", "box_weights", "num_pos"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.box_targets.numpy(), np.asarray(want.box_targets),
                               rtol=1e-5, atol=1e-5)
    assert got.labels.dtype == torch.int32 and int((got.labels[0] > 0).sum()) > 0
    if spec["sample_size"]:
        assert int(got.cls_weights.sum(1).max()) <= spec["sample_size"]


# --------------------------------------------------------- proposal targets


def proposals(rng, b, p, valid_frac=0.8):
    xy = rng.uniform(0, 100, size=(b, p, 2))
    wh = rng.uniform(4, 60, size=(b, p, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = rng.rand(b, p) < valid_frac
    return np.where(valid[..., None], boxes, 0.0).astype(np.float32), valid


@pytest.mark.parametrize("p,sample_size,no_gt_image", [
    (64, 32, False),  # P + G > sample size
    (16, 32, False),  # P + G < sample size: min(S, P + G) rows
    (64, 32, True),  # an image with no valid gt: background only
])
def test_sample_rois_matches_jax(p, sample_size, no_gt_image):
    rng = np.random.RandomState(p + sample_size)
    batch = small_batch(seed=5)
    if no_gt_image:
        batch["gt_classes"][1] = 0
    rois, valid = proposals(rng, 2, p)
    # some proposals on the gt, so that foreground exists
    rois[:, :3] = batch["gt_boxes"][:, :3] + rng.uniform(-3, 3, size=(2, 3, 4))
    valid[:, :3] = True
    key = jax.random.PRNGKey(13)
    kwargs = dict(sample_size=sample_size, positive_fraction=0.25, positive_iou=0.5,
                  negative_iou_hi=0.5, negative_iou_lo=0.0,
                  box_weights=(10.0, 10.0, 5.0, 5.0))
    want = j_sample_rois(jnp.asarray(rois), jnp.asarray(valid),
                         jnp.asarray(batch["gt_boxes"]), jnp.asarray(batch["gt_classes"]),
                         key, **kwargs)
    fg_noise, bg_noise = jax_pair_draws(key, 2, p + batch["gt_boxes"].shape[1])
    got = sample_rois(t(rois), t(valid), t(batch["gt_boxes"]), t(batch["gt_classes"]),
                      fg_noise, bg_noise, **kwargs)
    assert got.rois.shape == (2, min(sample_size, p + 8), 4)
    for name in ("rois", "labels", "weights", "box_weights", "matched_idx", "num_fg"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.box_targets.numpy(), np.asarray(want.box_targets),
                               rtol=1e-5, atol=1e-5)
    assert int(got.num_fg[0]) > 0
    if no_gt_image:
        assert int(got.num_fg[1]) == 0 and int(got.weights[1].sum()) > 0


# ------------------------------------------------------------ mask targets


@pytest.mark.parametrize("resolution", [28, 14])
def test_crop_gt_masks_matches_jax(resolution):
    rng = np.random.RandomState(resolution)
    batch = small_batch(seed=7)
    s = 12
    matched = rng.randint(0, 3, size=(2, s)).astype(np.int32)
    gt = np.take_along_axis(batch["gt_boxes"], matched[..., None].repeat(4, -1), 1)
    # RoIs around their gt box, some past it, one degenerate
    rois = (gt + rng.uniform(-12, 12, size=gt.shape)).astype(np.float32)
    rois[:, 0, 2:] = rois[:, 0, :2]
    want = j_crop(jnp.asarray(batch["gt_masks"]), jnp.asarray(batch["gt_boxes"]),
                  jnp.asarray(rois), jnp.asarray(matched), resolution=resolution)
    got = crop_gt_masks_batched(t(batch["gt_masks"]), t(batch["gt_boxes"]), t(rois),
                                t(matched), resolution=resolution)
    assert got.shape == (2, s, resolution, resolution)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.0 < float(got.mean()) < 1.0
