"""Anchor generation (a copy of the JAX package's numpy-only module).

Base anchors are enumerated ratio-then-scale around a cell center, then
shifted over each FPN level's feature grid. Anchors depend only on static
config (strides, padded image size), so they are computed once with NumPy
and moved to the device by the caller.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def generate_base_anchors(
    base_size: float,
    ratios: Sequence[float] = (0.5, 1.0, 2.0),
    scales: Sequence[float] = (8.0,),
    offset: float = 0.0,
) -> np.ndarray:
    """Base anchor set ``[len(ratios)*len(scales), 4]`` centered on a cell.

    Matches the canonical py-faster-rcnn enumeration: for each aspect ratio,
    round the ratio-adjusted width/height preserving area, then scale
    (reference: libs/boxes/anchor.py::generate_anchors). With
    ``base_size=16, ratios=(0.5,1,2), scales=(8,16,32), offset=1`` this
    reproduces the canonical 9-anchor golden table.
    """
    base = np.array(
        [0, 0, base_size - offset, base_size - offset], dtype=np.float64
    )
    w = base[2] - base[0] + offset
    h = base[3] - base[1] + offset
    cx = base[0] + 0.5 * (w - offset)
    cy = base[1] + 0.5 * (h - offset)

    anchors = []
    for ratio in ratios:
        size = w * h
        size_ratio = size / ratio
        if offset:  # legacy: round to integer sizes like the reference
            rw = np.round(np.sqrt(size_ratio))
            rh = np.round(rw * ratio)
        else:
            rw = np.sqrt(size_ratio)
            rh = rw * ratio
        for scale in scales:
            sw, sh = rw * scale, rh * scale
            anchors.append(
                [
                    cx - 0.5 * (sw - offset),
                    cy - 0.5 * (sh - offset),
                    cx + 0.5 * (sw - offset),
                    cy + 0.5 * (sh - offset),
                ]
            )
    return np.asarray(anchors, dtype=np.float32)


def shift_anchors(base_anchors: np.ndarray, stride: int, height: int, width: int):
    """Tile base anchors over an ``height x width`` feature grid.

    Returns ``[height*width*A, 4]`` in row-major (y, x, anchor) order —
    matching the ``[H, W, A, ...]`` layout that the dense heads' outputs are
    reshaped to, so anchors and predictions align element-for-element.
    """
    shift_x = (np.arange(width, dtype=np.float32)) * stride
    shift_y = (np.arange(height, dtype=np.float32)) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx, sy, sx, sy], axis=-1)  # [H, W, 4]
    out = shifts[:, :, None, :] + base_anchors[None, None, :, :]
    return out.reshape(-1, 4).astype(np.float32)


class AnchorGenerator:
    """Per-FPN-level anchor grids for a fixed padded image size.

    Two-stage (RPN) flavor: one scale per level = ``rpn_scale * stride``
    (levels P2..P6, strides 4..64).
    RetinaNet flavor: 3 octave scales x ratios at ``base_scale * stride``
    (levels P3..P7, strides 8..128) — 9 anchors/cell (SURVEY.md §2.2).
    """

    def __init__(
        self,
        strides: Sequence[int],
        ratios: Sequence[float] = (0.5, 1.0, 2.0),
        octave_scales: Sequence[float] = (1.0,),
        base_scale: float = 8.0,
        offset: float = 0.0,
    ):
        self.strides = tuple(strides)
        self.ratios = tuple(ratios)
        self.octave_scales = tuple(octave_scales)
        self.base_scale = float(base_scale)
        self.offset = float(offset)

    def base_anchors_for_level(self, stride: int) -> np.ndarray:
        scales = tuple(self.base_scale * s for s in self.octave_scales)
        return generate_base_anchors(
            base_size=stride, ratios=self.ratios, scales=scales, offset=self.offset
        )

    @property
    def num_anchors_per_cell(self) -> int:
        return len(self.ratios) * len(self.octave_scales)

    def grid_anchors(self, image_hw: tuple[int, int]) -> list[np.ndarray]:
        """List (per level) of ``[Hl*Wl*A, 4]`` anchor arrays for a padded
        image of shape ``image_hw``. Feature sizes are ceil(H/stride)."""
        h, w = image_hw
        out = []
        for stride in self.strides:
            fh = -(-h // stride)
            fw = -(-w // stride)
            out.append(
                shift_anchors(self.base_anchors_for_level(stride), stride, fh, fw)
            )
        return out

    def all_anchors(self, image_hw: tuple[int, int]) -> np.ndarray:
        """Concatenated ``[sum_l Hl*Wl*A, 4]`` anchors across levels."""
        return np.concatenate(self.grid_anchors(image_hw), axis=0)
