"""``aligned`` RoIAlign and the single-level ``roi_align`` of the port,
against the JAX package on the same seeded inputs (CPU: the plain versions
of kernels K2 and K3, which share the kernels' frame and fold):

* ``roi_align`` against ``detectron_tpu/ops/roi_align.py::roi_align``, and
  ``multilevel_roi_align(aligned=..., canonical_level=5,
  canonical_scale=160)`` against the JAX function with the same arguments:
  forward within TOL = 1e-5 (as ``test_torch_roi_align.py``: the same
  samples, summed in another order), the gradient against ``jax.grad``
  within ATOL = 1e-4 (as ``test_torch_roi_align_grad.py``) times the
  largest gradient where that exceeds 1: the stress kinds pile the samples
  of many RoIs onto a few border cells, whose float32 sums of O(10) values
  then differ by a few ulps with the order of the terms;
* bf16: the bf16 result is the float32 result on the upcast input rounded
  once, bit for bit (forward and gradient), and within one bf16 step plus
  TOL of JAX's float32 result rounded once;
* with ``aligned=True``, the stress kinds of ``chip_smoke.py``'s phase 29
  (zero extent, all sub-cell, shifted past the border, the whole level);
* ``roi_tap_cell_bounds(aligned=True)`` (K3 bf16's pre-pass) against the
  support of each RoI's own gradient;
* the numpy model of K2 (``test_torch_roi_align.k2_model``) with
  ``aligned=True``, against the plain version and JAX.

The kernels' aligned instances are held against the same plain versions
on the card by chip_smoke.py (phase 29).
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from detectron_tpu.ops import roi_align as jra
from detectron_tpu_torch.ops import roi_align as tra
from test_torch_roi_align import k2_kernel_sizes, k2_model

TOL = 1e-5
ATOL = 1e-4
STRIDE = 8
HW = (32, 40)  # one level of a 256x320 canvas at stride 8
C = 16


def feature(seed=0, b=2, c=C):
    return np.random.RandomState(seed).randn(b, *HW, c).astype(np.float32)


@functools.lru_cache(maxsize=None)
def case_rois(kind, r=24, seed=1):
    """Seeded RoIs [2, R, 4]: chip_smoke's main-path mix (random, band-top
    elongated, past the border, sub-cell) at the small canvas, or one of
    its aligned stress kinds on the level."""
    rng = np.random.RandomState(seed)
    if kind == "main":
        return cs.roi_cases(rng, 2, r, (HW[0] * STRIDE, HW[1] * STRIDE))
    return cs.aligned_stress_rois(rng, kind, 2, r, HW, STRIDE)


KINDS = ("main",) + cs.ALIGNED_STRESS


def jax_roi_align(f, rois, pool, aligned):
    return np.asarray(jra.roi_align(jnp.asarray(f), jnp.asarray(rois), STRIDE,
                                    output_size=pool, aligned=aligned))


def jax_grad(f, rois, pool, aligned, weight):
    def loss(x):
        out = jra.roi_align(x, jnp.asarray(rois), STRIDE, output_size=pool, aligned=aligned)
        return jnp.sum(out * jnp.asarray(weight))

    return np.asarray(jax.grad(loss)(jnp.asarray(f)))


def port_grad(f, rois, pool, aligned, weight):
    leaf = f.clone().requires_grad_(True)
    out = tra.roi_align(leaf, rois, STRIDE, pool, 2, aligned)
    (grad,) = torch.autograd.grad(out, leaf, grad_outputs=weight)
    return out.detach(), grad


@pytest.mark.parametrize("pool", [7, 14])
@pytest.mark.parametrize("kind,aligned", [("main", False)] + [(k, True) for k in KINDS])
def test_roi_align_forward_and_gradient_match_jax(kind, aligned, pool):
    f = feature()
    rois = case_rois(kind)
    weight = np.random.RandomState(2).randn(*rois.shape[:2], pool, pool, C).astype(np.float32)
    out, grad = port_grad(torch.tensor(f), torch.tensor(rois), pool, aligned,
                          torch.tensor(weight))
    assert out.shape == (2, rois.shape[1], pool, pool, C) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), jax_roi_align(f, rois, pool, aligned), rtol=0,
                               atol=TOL)
    want = jax_grad(f, rois, pool, aligned, weight)
    np.testing.assert_allclose(grad.numpy(), want, rtol=0,
                               atol=ATOL * max(1.0, float(np.abs(want).max())))
    if kind == "shifted past the border":
        assert grad[:, 0, :, :].abs().sum() > 0  # samples in [-1, 0) reach cell 0


def test_aligned_moves_the_result():
    """The two frames differ: on the main-path RoIs, aligned=True is not
    the unshifted result."""
    f, rois = torch.tensor(feature()), torch.tensor(case_rois("main"))
    assert not torch.allclose(tra.roi_align(f, rois, STRIDE, aligned=True),
                              tra.roi_align(f, rois, STRIDE))


@pytest.mark.parametrize("aligned", [False, True])
def test_multilevel_canonical_arguments_match_jax(aligned):
    """canonical_level and canonical_scale reach the routing: level 5 at
    160 px routes the RoIs otherwise than the defaults (4 at 224), and the
    port follows JAX there, forward and gradient."""
    rng = np.random.RandomState(3)
    strides = (4, 8, 16, 32)
    feats = [rng.randn(2, 64 >> i, 80 >> i, C).astype(np.float32) for i in range(4)]
    rois = cs.roi_cases(rng, 2, 24, (256, 320))
    kw = dict(output_size=7, canonical_level=5, canonical_scale=160.0, aligned=aligned)
    want = jra.multilevel_roi_align([jnp.asarray(f) for f in feats], jnp.asarray(rois),
                                    strides, **kw)
    leaves = [torch.tensor(f).requires_grad_(True) for f in feats]
    got = tra.multilevel_roi_align(leaves, torch.tensor(rois), strides, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=TOL)
    default = tra.assign_fpn_levels(torch.tensor(rois), 4, 2, max_span=tra.DEFAULT_MAX_SPAN)
    moved = tra.assign_fpn_levels(torch.tensor(rois), 4, 2, 5, 160.0,
                                  max_span=tra.DEFAULT_MAX_SPAN)
    assert (default != moved).any()
    weight = rng.randn(*got.shape).astype(np.float32)
    grads = torch.autograd.grad(got, leaves, grad_outputs=torch.tensor(weight))

    def loss(fs):
        out = jra.multilevel_roi_align(list(fs), jnp.asarray(rois), strides, **kw)
        return jnp.sum(out * jnp.asarray(weight))

    want_grads = jax.grad(loss)(tuple(jnp.asarray(f) for f in feats))
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("pool", [7, 14])
def test_bf16_is_the_float32_result_rounded_once(pool, aligned):
    f = torch.tensor(feature(4)).bfloat16()
    rois = torch.tensor(case_rois("main", seed=5))
    weight = torch.tensor(np.random.RandomState(6).randn(*rois.shape[:2], pool, pool, C)
                          .astype(np.float32)).bfloat16()
    out, grad = port_grad(f, rois, pool, aligned, weight)
    out32, grad32 = port_grad(f.float(), rois, pool, aligned, weight.float())
    assert out.dtype == grad.dtype == torch.bfloat16
    assert torch.equal(out, out32.bfloat16()) and torch.equal(grad, grad32.bfloat16())
    want = torch.tensor(jax_roi_align(f.float().numpy(), rois.numpy(), pool, aligned))
    diff, ok = cs.within_bf16(out, want.bfloat16(), TOL)
    assert ok, diff


def own_gradient_support(rois, pool, aligned):
    """Per RoI, the (x first, x last, y first, y last) cells of its own
    plain gradient, (0, -1, 0, -1) where it has none."""
    b, r = rois.shape[:2]
    out = torch.zeros(b, r, 4, dtype=torch.int32)
    levels = torch.zeros(1, 1, dtype=torch.int32)
    for i in range(b):
        for n in range(r):
            g = torch.ones(1, 1, pool, pool, 1)
            (grad,) = tra.multilevel_roi_align_bwd_plain(g, [HW], rois[i:i + 1, n:n + 1],
                                                         levels, (STRIDE,), 2, aligned)
            nz = grad[0, ..., 0] != 0
            if not nz.any():
                out[i, n] = torch.tensor([0, -1, 0, -1])
                continue
            ys, xs = torch.nonzero(nz, as_tuple=True)
            out[i, n] = torch.tensor([xs.min(), xs.max(), ys.min(), ys.max()])
    return out


@pytest.mark.parametrize("pool", [7, 14])
@pytest.mark.parametrize("kind", KINDS)
def test_tap_bounds_aligned_are_each_rois_gradient_support(kind, pool):
    """K3 bf16's pre-pass twin with aligned=True gives exactly the cells
    each RoI's gradient touches: the shifted samples' taps, the border
    clamps included (an all-ones g makes every tap's contribution
    nonzero)."""
    rois = torch.tensor(case_rois(kind, r=12))
    levels = torch.zeros(rois.shape[:2], dtype=torch.int32)
    bounds = tra.roi_tap_cell_bounds([HW], rois, levels, (STRIDE,), pool, 2, aligned=True)
    want = own_gradient_support(rois, pool, True)
    # a supported axis pairs with a supported other axis; an RoI without
    # a window gives (0, -1) on some axis in the bounds
    has = (want[..., 1] >= 0)
    assert torch.equal(bounds[has], want[has])
    assert ((bounds[~has][:, 1] < 0) | (bounds[~has][:, 3] < 0)).all()
    if kind == "zero extent":
        for axis, (lo, hi) in enumerate(((0, 1), (2, 3))):
            flat = rois[..., 2 + axis] == rois[..., axis]
            span = (bounds[..., hi] - bounds[..., lo])[flat]
            assert flat.any() and ((span >= 0) & (span <= 1)).all()


@pytest.mark.parametrize("stage", ["kernel", "one row"])
@pytest.mark.parametrize("pool", [7, 14])
@pytest.mark.parametrize("kind", KINDS)
def test_k2_model_aligned_matches_plain_and_jax(kind, pool, stage):
    """K2's algorithm (fold, staged chunks, ring, passes) with the aligned
    frame gives the plain version's and JAX's output at the stress kinds,
    with the kernel's staging and with one row a chunk."""
    f = feature(7, c=8)
    rois = case_rois(kind, r=6, seed=8)
    levels = np.zeros(rois.shape[:2], np.int32)
    cells, rows = k2_kernel_sizes(pool, 2)
    if stage == "one row":
        cells = 2 * pool * 2
    got = k2_model([f], rois, levels, (STRIDE,), pool, 2, cells, rows, aligned=True)
    plain = tra.multilevel_roi_align_plain([torch.tensor(f)], torch.tensor(rois),
                                           torch.tensor(levels), (STRIDE,), pool, 2, True)
    limit = 1e-5 * float(np.abs(f).max())
    np.testing.assert_allclose(got, plain.numpy(), rtol=0, atol=limit)
    np.testing.assert_allclose(got, jax_roi_align(f, rois, pool, True), rtol=0, atol=limit)


def test_unaligned_frame_is_unchanged():
    """aligned=False keeps the frame it had: the corners times the scale,
    the extent clamped to one cell (a sub-cell box samples one cell wide)."""
    rois = torch.tensor([[[8.0, 8.0, 9.0, 9.0], [16.0, 16.0, 80.0, 48.0]]])
    levels = torch.zeros(1, 2, dtype=torch.int32)
    _, _, ys, xs = tra._sample_geometry([HW], rois, levels, (STRIDE,), 1, 1)
    # the sample of one bin sits at x1 + extent / 2: 1 + 1/2 (clamped), 2 + 8/2
    assert torch.equal(xs[0][0, :, 0], torch.tensor([1, 6]))
    assert torch.equal(xs[3][0, :, 0], torch.tensor([0.5, 0.0]))
    _, _, ys, xs = tra._sample_geometry([HW], rois, levels, (STRIDE,), 1, 1, aligned=True)
    # shifted by half a cell, no clamp: 0.5 + 0.125 / 2, 1.5 + 8 / 2
    assert torch.equal(xs[0][0, :, 0], torch.tensor([0, 5]))
    assert torch.equal(xs[3][0, :, 0], torch.tensor([0.5625, 0.5]))


def test_k2_ablation_edits_apply_to_the_kernel_source():
    """scripts/k2_ablation.py edits csrc/roi_align.cu by anchor text; every
    variant's anchors still occur as often as it says, with ``aligned``
    a template parameter of every kernel."""
    sys.path.insert(0, str(cs.REPO) + "/scripts")
    try:
        import k2_ablation
    finally:
        sys.path.pop(0)
    for variants in (k2_ablation.VARIANTS, k2_ablation.BF16_VARIANTS):
        for _, edits in variants.values():
            k2_ablation.variant_source(edits)
