"""K3's bf16 route, on the CPU: what its tile kernel relies on, held
against the plain gradient.

On the card a bf16 upstream gradient goes through a pre-pass that gives
each RoI the cell range of its nonzero taps along x and y
(``roi_tap_cell_bounds`` is its plain twin), then through one kernel in
which a block owns a square tile of one level of one image and sums, in
float32 and ascending RoI order, the windows of the RoIs whose ranges meet
the tile, then rounds once to bf16. Here:

* the bounds contain the support of each RoI's own plain gradient and are
  tight, at the five stress geometries of ``chip_smoke.py`` (phase 7) on a
  256x256 canvas: so the range comes from the taps, border clamps
  included, not from the box;
* a model of the tile order (per tile of 8 x 8 or 16 x 16 cells, the
  kernel's two shapes, the float32 sum over the RoIs whose bounds meet it,
  ascending, rounded once) equals the float32 sum over every RoI exactly,
  and the plain bf16 gradient within one bf16 step: the tile split loses no
  contribution;
* the CUDA wrappers of the route refuse CPU tensors.

chip_smoke.py holds the kernel itself against the plain version on the
card, its two runs bitwise, and the pre-pass against
``roi_tap_cell_bounds`` exactly.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from detectron_tpu_torch.ops import roi_align as tra

STRIDES = cs.STRIDES
CANVAS = (256, 256)
# the two tile shapes of the kernel: 8 x 8 cells (wide blocks, P=7 at
# C=256) and 16 x 16 (narrow blocks)
TILES = (8, 16)
C = 16
LEVEL_HW = [(CANVAS[0] // s, CANVAS[1] // s) for s in STRIDES]


def stress_case(kind, b=2, r=12, seed=0):
    """Seeded RoIs and routing of one of chip_smoke's K3 stress kinds on
    the small canvas."""
    saved = cs.CANVAS
    cs.CANVAS = CANVAS
    try:
        rois, levels = cs.k3_stress_rois(np.random.RandomState(seed), kind, b, r)
    finally:
        cs.CANVAS = saved
    rois = torch.tensor(rois)
    if levels is None:
        levels = tra.assign_fpn_levels(rois, len(STRIDES), 2, max_span=(28.0, 44.0))
    else:
        levels = torch.tensor(levels)
    return rois, levels


def roi_windows(g, rois, levels):
    """Each RoI's own float32 gradient: ``[R][B]`` lists of per-level
    tensors, RoI n of image i alone in ``windows[n][i]``."""
    b, r = rois.shape[:2]
    out = []
    for n in range(r):
        per_image = []
        for i in range(b):
            per_image.append(tra.multilevel_roi_align_bwd_plain(
                g[i:i + 1, n:n + 1], LEVEL_HW, rois[i:i + 1, n:n + 1],
                levels[i:i + 1, n:n + 1], STRIDES))
        out.append(per_image)
    return out


@pytest.mark.parametrize("pool", [7, 14])
@pytest.mark.parametrize("kind", cs.K3_STRESS)
def test_bounds_contain_each_rois_support_and_are_tight(kind, pool):
    rois, levels = stress_case(kind)
    g = torch.tensor(np.random.RandomState(1).randn(*rois.shape[:2], pool, pool, C)
                     .astype(np.float32))
    bounds = tra.roi_tap_cell_bounds(LEVEL_HW, rois, levels, STRIDES, pool)
    assert bounds.dtype == torch.int32 and bounds.shape == (*rois.shape[:2], 4)
    windows = roi_windows(g, rois, levels)
    supported = 0
    for n in range(rois.shape[1]):
        for i in range(rois.shape[0]):
            x0, x1, y0, y1 = bounds[i, n].tolist()
            lv = int(levels[i, n])
            h, w = LEVEL_HW[lv]
            for axis_first, axis_last, size in ((x0, x1, w), (y0, y1, h)):
                # an axis is empty as (0, -1), else a range inside the level
                assert (axis_first, axis_last) == (0, -1) or 0 <= axis_first <= axis_last < size
            for other, grad in enumerate(windows[n][i]):
                if other != lv:
                    assert not grad.any()  # a RoI touches its own level only
            nz = windows[n][i][lv][0].abs().sum(-1) > 0  # [H, W]
            if not nz.any():
                # no cell gets a contribution: one axis has no nonzero tap
                assert x1 < 0 or y1 < 0
                continue
            supported += 1
            ys, xs = torch.nonzero(nz, as_tuple=True)
            assert (int(xs.min()), int(xs.max()), int(ys.min()), int(ys.max())) == (x0, x1, y0, y1)
    assert supported > 0


def tile_model(windows, bounds, levels, b, c, size):
    """The tile kernel's order of summation, in float32: per level, image
    and tile of ``size`` x ``size`` cells, the windows of the RoIs routed
    there whose bounds meet the tile, added in ascending order."""
    out = [torch.zeros(b, h, w, c) for h, w in LEVEL_HW]
    for lv, (h, w) in enumerate(LEVEL_HW):
        for i in range(b):
            for ty in range(0, h, size):
                for tx in range(0, w, size):
                    tile = out[lv][i, ty:ty + size, tx:tx + size]
                    for n in range(len(windows)):
                        x0, x1, y0, y1 = bounds[i, n].tolist()
                        if (int(levels[i, n]) == lv and x0 <= tx + size - 1 and x1 >= tx
                                and y0 <= ty + size - 1 and y1 >= ty):
                            tile += windows[n][i][lv][0, ty:ty + size, tx:tx + size]
    return out


def all_rois_in_order(windows, b):
    """The same float32 sum over every RoI of each image, none left out."""
    out = [torch.zeros(b, h, w, C) for h, w in LEVEL_HW]
    for n in range(len(windows)):
        for i in range(b):
            for lv in range(len(LEVEL_HW)):
                out[lv][i] += windows[n][i][lv][0]
    return out


@pytest.mark.parametrize("size", TILES)
@pytest.mark.parametrize("pool", [7, 14])
@pytest.mark.parametrize("kind", ["training", "past the border", "P5 whole level"])
def test_tile_order_loses_no_contribution(kind, pool, size):
    if kind == "training":
        rois = torch.tensor(cs.roi_cases(np.random.RandomState(3), 2, 16, CANVAS))
        levels = tra.assign_fpn_levels(rois, len(STRIDES), 2, max_span=(28.0, 44.0))
    else:
        rois, levels = stress_case(kind, r=16, seed=3)
    b, r = rois.shape[:2]
    g16 = torch.tensor(np.random.RandomState(4).randn(b, r, pool, pool, C)
                       .astype(np.float32)).bfloat16()
    bounds = tra.roi_tap_cell_bounds(LEVEL_HW, rois, levels, STRIDES, pool)
    windows = roi_windows(g16.float(), rois, levels)
    model = tile_model(windows, bounds, levels, b, C, size)
    # the tiles' lists drop only RoIs that add exact zeros there
    for got, want in zip(model, all_rois_in_order(windows, b)):
        assert torch.equal(got, want)
    plain = tra.multilevel_roi_align_bwd_plain(g16, LEVEL_HW, rois, levels, STRIDES)
    floor = 1e-5 * max(float(p.float().abs().max()) for p in plain)
    for got, want in zip(model, plain):
        assert want.dtype == torch.bfloat16
        diff, ok = cs.within_bf16(got.to(torch.bfloat16), want, floor)
        assert ok, diff
    # the tiles cover every RoI that has a window: some tile lists each
    with_window = (bounds[..., 1] >= 0) & (bounds[..., 3] >= 0)
    assert cs.tile_visits(bounds, size) >= int(with_window.sum())


def test_bf16_route_wrappers_refuse_cpu_tensors():
    rois, levels = stress_case("all sub-cell", b=1, r=2)
    g16 = torch.zeros(1, 2, 7, 7, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tra.roi_tap_bounds_cuda(LEVEL_HW, rois, levels, STRIDES, 7)
    views = tra.level_views(torch.zeros(8 * sum(h * w for h, w in LEVEL_HW),
                                        dtype=torch.bfloat16), 1, 8, LEVEL_HW)
    bounds = tra.roi_tap_cell_bounds(LEVEL_HW, rois, levels, STRIDES, 7)
    with pytest.raises(ValueError, match="CUDA"):
        tra.roi_align_bwd_tiles_cuda(views, bounds, g16, rois, levels, STRIDES)
    with pytest.raises(ValueError, match="CUDA"):
        tra.multilevel_roi_align_bwd_cuda(g16, LEVEL_HW, rois, levels, STRIDES)
    # the float32 route's launch refuses a bf16 gradient, naming the route
    with pytest.raises(ValueError, match="multilevel_roi_align_bwd_cuda"):
        tra.roi_align_bwd_accumulate_cuda(views, g16, rois, levels, STRIDES)
