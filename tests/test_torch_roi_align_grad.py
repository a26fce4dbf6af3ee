"""The RoIAlign backward: the plain version of kernel K3 against the JAX
package, and the autograd Function around K2 and K3 as it runs on CPU
tensors.

* ``multilevel_roi_align_bwd_plain`` against ``jax.vjp`` of the JAX gather
  ``multilevel_roi_align`` with the same routing span, and against the
  Pallas TPU kernel ``multilevel_roi_align_pallas_bwd`` in interpret mode
  (C=128, which engages its kernel path) with the ``window=-1`` and
  ``window=16`` routing. atol 1e-4, the JAX package's own bound for its
  kernel: the sums run in another order.
* ``RoIAlignFunction``'s gradient equals autograd through the plain
  forward within 1e-5 x max |gradient|, the bound chip_smoke.py holds K3
  to: the same float32 products, summed in another order (a cell that
  hundreds of samples touch is about 2e-6 x max |gradient| from a
  float64 sum either way).

The CUDA kernel K3 is held against the same plain version on the card by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.ops import roi_align as jra
from detectron_tpu.ops.roi_align_pallas import multilevel_roi_align_pallas_bwd
from detectron_tpu_torch.ops import roi_align as tra

STRIDES = (4, 8, 16, 32)
ATOL = 1e-4


def make_features(c, base=(64, 80), b=2, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, base[0] >> i, base[1] >> i, c).astype(np.float32) for i in range(4)]


def make_rois(b=2, r=24, canvas=(256, 320), seed=1):
    """Random boxes, overlapping boxes (shared cells), band-top elongated
    boxes, boxes past the border and sub-cell boxes."""
    rng = np.random.RandomState(seed)
    h, w = canvas
    xy = rng.uniform([-20, -20], [w, h], size=(b, r, 2))
    wh = np.exp(rng.uniform(np.log(2), np.log(250), size=(b, r, 2)))
    rois = np.concatenate([xy, xy + wh], -1)
    k = r // 6
    rois[:, k:2 * k] = rois[:, :k] + rng.uniform(-4, 4, size=(b, k, 4))  # overlaps
    side = 112.0 * rng.uniform(0.9, 1.0, size=(b, k))
    aspect = rng.uniform(3.0, 6.0, size=(b, k))
    x0, y0 = rng.uniform(0, w / 2, size=(b, k)), rng.uniform(0, h / 2, size=(b, k))
    rois[:, 2 * k:3 * k] = np.stack([x0, y0, x0 + side * np.sqrt(aspect),
                                     y0 + side / np.sqrt(aspect)], -1)
    rois[:, 3 * k:4 * k, :2] -= 60.0
    rois[:, 3 * k:4 * k, 2:] += 120.0
    rois[:, 4 * k:5 * k, 2:] = rois[:, 4 * k:5 * k, :2] + rng.uniform(0.1, 3.0, (b, k, 2))
    return rois.astype(np.float32)


def plain_grad(g, feats, rois, span, pool):
    t_rois = torch.tensor(rois)
    levels = tra.assign_fpn_levels(t_rois, 4, 2, max_span=span)
    return tra.multilevel_roi_align_bwd_plain(
        torch.tensor(g), [f.shape[1:3] for f in feats], t_rois, levels, STRIDES,
        sampling_ratio=2)


@pytest.mark.parametrize("pool", [7, 14])
@pytest.mark.parametrize("span", [(28.0, 44.0), (28.0, 36.0), (8.0, 16.0)])
def test_plain_bwd_matches_jax_vjp(pool, span):
    feats = make_features(16)
    rois = make_rois()
    g = np.random.RandomState(2).randn(2, rois.shape[1], pool, pool, 16).astype(np.float32)
    _, vjp = jax.vjp(
        lambda f: jra.multilevel_roi_align(list(f), jnp.asarray(rois), STRIDES,
                                           output_size=pool, max_span=span),
        tuple(jnp.asarray(f) for f in feats))
    want = vjp(jnp.asarray(g))[0]
    got = plain_grad(g, feats, rois, span, pool)
    assert len(got) == 4
    for a, w, f in zip(got, want, feats):
        assert a.shape == f.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    assert all(float(a.abs().max()) > 0 for a in got[:3])


@pytest.mark.parametrize("pool", [7, 14])
@pytest.mark.parametrize("window", [-1, 16])
def test_plain_bwd_matches_pallas_interpret(pool, window):
    feats = make_features(128, base=(64, 64), b=1, seed=3)
    rois = make_rois(b=1, r=12, canvas=(256, 256), seed=4)
    g = np.random.RandomState(5).randn(1, 12, pool, pool, 128).astype(np.float32)
    want = multilevel_roi_align_pallas_bwd(
        jnp.asarray(g), [jnp.asarray(f) for f in feats], jnp.asarray(rois),
        strides=STRIDES, output_size=pool, interpret=True, window=window)
    win_h, win_w = tra.resolve_window(window, 0, 8, 8)
    got = plain_grad(g, feats, rois, (float(win_h - 4), float(win_w - 4)), pool)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0, atol=ATOL)


@pytest.mark.parametrize("pool", [7, 14])
def test_function_gradient_equals_autograd_of_plain(pool):
    feats = [torch.tensor(f, requires_grad=True) for f in make_features(8, seed=6)]
    rois = torch.tensor(make_rois(seed=7))
    weight = torch.randn(2, rois.shape[1], pool, pool, 8,
                         generator=torch.Generator().manual_seed(8))
    out = tra.multilevel_roi_align(feats, rois, STRIDES, pool, max_span=(28.0, 44.0))
    assert out.requires_grad
    got = torch.autograd.grad((out * weight).sum(), feats)

    levels = tra.assign_fpn_levels(rois, 4, 2, max_span=(28.0, 44.0))
    plain = tra.multilevel_roi_align_plain(feats, rois, levels, STRIDES, pool)
    want = torch.autograd.grad((plain * weight).sum(), feats)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-5 * float(w.abs().max()))


def test_function_gives_only_the_features_a_gradient():
    """The RoIs get no gradient (the JAX VJPs give them zeros); a level
    that does not require grad gets none either."""
    feats = [torch.tensor(f) for f in make_features(4, seed=9)]
    feats[0].requires_grad_(True)
    feats[2].requires_grad_(True)
    rois = torch.tensor(make_rois(seed=10), requires_grad=True)
    out = tra.multilevel_roi_align(feats, rois, STRIDES, 7)
    out.sum().backward()
    assert rois.grad is None
    assert feats[1].grad is None and feats[3].grad is None
    assert float(feats[0].grad.abs().sum()) > 0 and float(feats[2].grad.abs().sum()) > 0


def test_bwd_wrappers_take_plain_path_on_cpu_and_refuse_cpu_tensors():
    tra.multilevel_roi_align_bwd_cuda.launches = 0
    tra.multilevel_roi_align_cuda.launches = 0
    feats = [torch.randn(1, 16 >> i, 16 >> i, 8, requires_grad=True) for i in range(4)]
    rois = torch.tensor([[[0.0, 0.0, 40.0, 30.0], [10.0, 5.0, 60.0, 64.0]]])
    tra.multilevel_roi_align(feats, rois, STRIDES, 7).sum().backward()
    assert tra.multilevel_roi_align_bwd_cuda.launches == 0
    assert tra.multilevel_roi_align_cuda.launches == 0
    levels = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        tra.multilevel_roi_align_bwd_cuda(torch.zeros(1, 2, 7, 7, 8),
                                          [f.shape[1:3] for f in feats], rois, levels,
                                          STRIDES)
    # a bf16 gradient is taken (K3's bf16 instance), and refused here for
    # lying on the CPU, not for its dtype
    with pytest.raises(ValueError, match="CUDA"):
        tra.multilevel_roi_align_bwd_cuda(torch.zeros(1, 2, 7, 7, 8, dtype=torch.bfloat16),
                                          [f.shape[1:3] for f in feats], rois, levels,
                                          STRIDES)


# ---------------------------------------------------------------------------
# bf16: the plain version K3's bf16 instance is held to on the card.

@pytest.mark.parametrize("pool", [7, 14])
def test_bf16_plain_bwd_is_the_fp32_plain_rounded_once(pool):
    """A bf16 upstream gradient: summed in float32 from the upcast values
    (``index_add_`` into a float32 buffer), each level rounded to bf16 once,
    so bit for bit the float32 version on the upcast gradient cast to
    bf16."""
    feats = make_features(16)
    rois = make_rois()
    g = torch.tensor(np.random.RandomState(2).randn(2, rois.shape[1], pool, pool, 16)
                     .astype(np.float32)).to(torch.bfloat16)
    levels = tra.assign_fpn_levels(torch.tensor(rois), 4, 2, max_span=(28.0, 44.0))
    level_hw = [f.shape[1:3] for f in feats]
    got = tra.multilevel_roi_align_bwd_plain(g, level_hw, torch.tensor(rois), levels, STRIDES)
    want = tra.multilevel_roi_align_bwd_plain(g.float(), level_hw, torch.tensor(rois), levels,
                                              STRIDES)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, w.to(torch.bfloat16))


@pytest.mark.parametrize("pool", [7, 14])
def test_bf16_plain_bwd_against_pallas_in_bf16(pool):
    """Against ``multilevel_roi_align_pallas_bwd`` in interpret mode on the
    same bf16 gradient and features (C=128), which adds each RoI's window
    in float32 but rounds the level gradient to bf16 after every window:
    each level within 1e-2 x max |Pallas level| (measured 1.3e-3 to 5.7e-3
    at these inputs; 99.2-99.99% of the values equal; P5 gets no RoI). The
    port rounds once, after every RoI, so it is no further than the Pallas
    kernel from the float32 gradient (measured 0.056 against 0.101 at P=14,
    level P2): a stated divergence, the more accurate one."""
    feats = make_features(128, base=(64, 64), b=1, seed=3)
    rois = make_rois(b=1, r=12, canvas=(256, 256), seed=4)
    g = torch.tensor(np.random.RandomState(5).randn(1, 12, pool, pool, 128)
                     .astype(np.float32)).to(torch.bfloat16)
    want = multilevel_roi_align_pallas_bwd(
        jnp.asarray(g.float().numpy()).astype(jnp.bfloat16),
        [jnp.asarray(f).astype(jnp.bfloat16) for f in feats], jnp.asarray(rois),
        strides=STRIDES, output_size=pool, interpret=True, window=-1)
    win_h, win_w = tra.resolve_window(-1, 0, 8, 8)
    levels = tra.assign_fpn_levels(torch.tensor(rois), 4, 2,
                                   max_span=(float(win_h - 4), float(win_w - 4)))
    level_hw = [f.shape[1:3] for f in feats]
    got = tra.multilevel_roi_align_bwd_plain(g, level_hw, torch.tensor(rois), levels, STRIDES)
    exact = tra.multilevel_roi_align_bwd_plain(g.float(), level_hw, torch.tensor(rois), levels,
                                               STRIDES)
    for a, w, x in zip(got, want, exact):
        assert w.dtype == jnp.bfloat16 and a.dtype == torch.bfloat16
        w = torch.tensor(np.asarray(w).astype(np.float32))
        assert float((a.float() - w).abs().max()) <= 1e-2 * float(w.abs().max())
        assert float((a.float() - x).abs().max()) <= float((w - x).abs().max())
