"""The port's RoIAlign (plain path, as it runs on CPU tensors) against the
JAX package: level routing must be exactly equal; pooled features must
agree within 1e-5 (float32: the two gather the same samples and differ
only in summation order). The CUDA kernel is held against the same plain
path on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.config import get_config as jax_get_config
from detectron_tpu.ops import roi_align as jra
from detectron_tpu.ops.roi_align_pallas import (
    multilevel_roi_align_pallas,
    roi_align_window_trainable,
)
from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.ops import roi_align as tra

STRIDES = (4, 8, 16, 32)
TOL = 1e-5


def make_features(c, base=(128, 160), b=2, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, base[0] >> i, base[1] >> i, c).astype(np.float32) for i in range(4)]


def make_rois(b=2, r=48, canvas=(512, 640), seed=1):
    """Random boxes plus elongated boxes at the top of a level's size band
    (span promotion), boxes past the image border and sub-cell boxes."""
    rng = np.random.RandomState(seed)
    h, w = canvas
    xy = rng.uniform([-30, -30], [w, h], size=(b, r, 2))
    wh = np.exp(rng.uniform(np.log(2), np.log(500), size=(b, r, 2)))
    rois = np.concatenate([xy, xy + wh], -1)
    k = r // 6
    side = 224.0 * 2.0 ** rng.randint(-2, 1, size=(b, k)) * 0.98
    aspect = rng.uniform(2.0, 6.0, size=(b, k))
    bw, bh = side * np.sqrt(aspect), side / np.sqrt(aspect)
    x0, y0 = rng.uniform(0, w / 2, size=(b, k)), rng.uniform(0, h / 2, size=(b, k))
    rois[:, :k] = np.stack([x0, y0, x0 + bw, y0 + bh], -1)
    rois[:, k:k + 2] = np.stack([x0[:, :2], y0[:, :2], x0[:, :2] + bh[:, :2],
                                 y0[:, :2] + bw[:, :2]], -1)  # tall ones
    rois[:, 2 * k:3 * k, :2] -= 150.0  # past the top-left border
    rois[:, 2 * k:3 * k, 2:] += 300.0  # and the bottom-right one
    rois[:, 3 * k:4 * k, 2:] = rois[:, 3 * k:4 * k, :2] + rng.uniform(0.1, 3.0, (b, k, 2))
    return rois.astype(np.float32)


@pytest.mark.parametrize("max_span", [None, (28.0, 44.0), (28.0, 36.0), (8.0, 16.0)])
def test_assign_fpn_levels_equal(max_span):
    rois = make_rois(r=400, seed=2)
    want = np.asarray(jra.assign_fpn_levels(jnp.asarray(rois), 4, 2, max_span=max_span))
    got = tra.assign_fpn_levels(torch.tensor(rois), 4, 2, max_span=max_span)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pool", [7, 14])
@pytest.mark.parametrize("max_span", [(28.0, 44.0), (28.0, 36.0)])
def test_plain_matches_jax_gather(pool, max_span):
    feats = make_features(16)
    rois = make_rois()
    want = jra.multilevel_roi_align([jnp.asarray(f) for f in feats], jnp.asarray(rois),
                                    STRIDES, output_size=pool, max_span=max_span)
    got = tra.multilevel_roi_align([torch.tensor(f) for f in feats], torch.tensor(rois),
                                   STRIDES, output_size=pool, max_span=max_span)
    assert got.shape == (2, rois.shape[1], pool, pool, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("pool", [7, 14])
def test_plain_matches_jax_windowed_and_pallas(pool):
    """The TPU schedules of the same function: the windowed XLA path (the
    JAX default) and the Pallas kernel in interpret mode, at C=128 (the
    Pallas path engages only at C % 128 == 0)."""
    feats = make_features(128, base=(64, 64), b=1, seed=3)
    rois = make_rois(b=1, r=16, canvas=(256, 256), seed=4)
    jf = [jnp.asarray(f) for f in feats]
    win_h, win_w = jra.resolve_window(-1, 0, 8, 8)
    span = tra.roi_max_span(get_config(), (8, 8))
    assert span == (float(win_h - 4), float(win_w - 4))
    windowed = jra.multilevel_roi_align_windowed(jf, jnp.asarray(rois), STRIDES,
                                                 output_size=pool, window=-1)
    pallas = multilevel_roi_align_pallas(jf, jnp.asarray(rois), STRIDES, output_size=pool,
                                         interpret=True)
    tf = [torch.tensor(f) for f in feats]
    got_w = tra.multilevel_roi_align(tf, torch.tensor(rois), STRIDES, pool, max_span=span)
    got_p = tra.multilevel_roi_align(tf, torch.tensor(rois), STRIDES, pool,
                                     max_span=tra.DEFAULT_MAX_SPAN)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(windowed), rtol=0, atol=TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(pallas), rtol=0, atol=TOL)


# (overrides, top level (H, W)) -> the JAX model's pooling path on that cfg
SPAN_CASES = [
    ([], (32, 42)),  # the 1024x1344 canvas: window 32x48 -> span (28, 44)
    ([], (32, 32)),  # 1024^2: (28, 28)
    (["roi.window=12"], (8, 8)),  # explicit window 12 x (12 + 8)
    (["roi.window=12", "roi.window_w=16"], (8, 10)),
    (["roi.align_impl=gather"], (32, 42)),
    (["model.fused_roi_align=on"], (32, 42)),
    (["model.fused_roi_align=auto"], (32, 42)),
]


@pytest.mark.parametrize("overrides,top", SPAN_CASES, ids=lambda x: str(x))
def test_roi_max_span_matches_jax_cfg(overrides, top):
    jcfg = jax_get_config(None, overrides)
    if jcfg.model.fused_roi_align == "on" or jcfg.roi.align_impl == "gather":
        want = jra.DEFAULT_MAX_SPAN
    else:
        win_h, win_w = jra.resolve_window(jcfg.roi.window, jcfg.roi.window_w, *top)
        want = (float(win_h - 4), float(win_w - 4))
    assert tra.roi_max_span(get_config(None, overrides), top) == want


@pytest.mark.parametrize("overrides", [["roi.window=12"], []])
def test_model_pooling_path_matches_jax(overrides):
    """What the JAX model's default pooling computes for a cfg (the windowed
    trainable path) equals the port's pooling with roi_max_span of that
    cfg: the routing spans agree, including an explicit small window."""
    cfg = get_config(None, overrides)
    feats = make_features(8, base=(32, 32), b=2, seed=5)
    rois = make_rois(b=2, r=40, canvas=(128, 128), seed=6)
    jcfg = jax_get_config(None, overrides)
    want = roi_align_window_trainable(
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois), STRIDES, 7, 2,
        jcfg.roi.window, 0, jcfg.roi.window_w)
    span = tra.roi_max_span(cfg, feats[-1].shape[1:3])
    got = tra.multilevel_roi_align([torch.tensor(f) for f in feats], torch.tensor(rois),
                                   STRIDES, 7, max_span=span)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_roi_pool_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tra.roi_max_span(get_config(None, ["roi.pool_type=pool"]), (32, 32))
