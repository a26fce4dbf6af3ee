"""The port's RoIAlign (plain path, as it runs on CPU tensors) against the
JAX package: level routing must be exactly equal; pooled features must
agree within 1e-5 (float32: the two gather the same samples and differ
only in summation order). The CUDA kernel is held against the same plain
path on the card by chip_smoke.py."""

import functools
import os

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


def test_roi_pool_routes_with_its_window():
    """RoIPool routes with ``(window - 4, window + 4)`` of the window 32 that
    the JAX model always gives it, whatever ``roi.window`` says."""
    for extra in ([], ["roi.align_impl=window", "roi.window=16"]):
        cfg = get_config(None, ["roi.pool_type=pool", *extra])
        assert tra.roi_max_span(cfg, (32, 32)) == (28.0, 36.0)


# ---------------------------------------------------------------------------
# A numpy model of kernel K2's arithmetic (csrc/roi_align.cu,
# roi_align_forward_kernel), held against the plain version and the JAX
# package: what the card alone cannot show on the CPU is the algorithm, so
# it is checked here before the kernel runs.

# Stagings the model runs, each as (stage cells, ring rows): the kernel's at
# C = 256, of its fp32 kernel and of its bf16 kernel (the persistent one:
# bf16 cells are staged as they are, so its 16 KB stages hold twice the
# cells, and its fp32 ring takes up to 32 KB); one row of the widest fold
# (2*P*S cells) a chunk, so that every RoI taller than a row streams; and a
# stage so large that the ring alone limits a chunk (ring rows - 2*S + 1),
# so that bins straddle many chunks. The bf16 kernel's arithmetic is the
# fp32 one's on the upcast features, so one model holds both.
K2_STAGES = ("kernel", "kernel bf16", "one row", "ring-bound")


def k2_kernel_sizes(pool, ratio, channels=256):
    """(stage cells, ring rows) of the fp32 kernel at C = ``channels``: the
    slice pick_slice takes of 64, 32, then 4, and fwd_stage_cells,
    fwd_ring_rows and fwd_smem_bytes (within kFwdSmemLimit) of
    csrc/roi_align.cu."""
    elem = 4
    for width in (64, 32, 4):
        rows = 1
        while rows < 4 * ratio:
            rows *= 2
        while 2 * rows * pool * width * 4 <= 16 * 1024:
            rows *= 2
        cells = max(2 * pool * ratio, 16 * 1024 // (width * elem))
        if channels % width == 0 and (rows * pool * 4 + 2 * cells * elem) * width <= 64 * 1024:
            return cells, rows
    raise AssertionError("no slice fits")


def k2_bf16_sizes(pool, ratio, channels=256):
    """(stage cells, ring rows) of the bf16 kernel at C = ``channels``:
    bf16_slice, bf16_stage_cells and bf16_ring_rows of csrc/roi_align.cu
    (tests/test_torch_k2_bf16.py's model of them)."""
    from test_torch_k2_bf16 import bf16_plan

    _, rows, cells, _ = bf16_plan(channels, pool, ratio)
    return cells, rows


def k2_staging(stage, pool, ratio):
    if stage == "kernel bf16":
        return k2_bf16_sizes(pool, ratio)
    cells, rows = k2_kernel_sizes(pool, ratio)
    return {"kernel": cells, "one row": 2 * pool * ratio, "ring-bound": 4096}[stage], rows


def test_k2_kernel_sizes_at_the_model_ratio():
    """At S = 2, C = 256 the kernel stages 64 cells of a 64-channel slice
    (16 KB) and keeps a ring of 8 rows, at P = 7 and 14; its bf16 kernel
    128 cells (16 KB of bf16) a stage, with a ring of 16 rows at P = 7
    and 8 at P = 14 (32 KB at most)."""
    assert k2_kernel_sizes(7, 2) == (64, 8) and k2_kernel_sizes(14, 2) == (64, 8)
    assert k2_kernel_sizes(14, 3) == (128, 16)  # 32-channel slices: 64 would not fit
    assert k2_bf16_sizes(7, 2) == (128, 16)
    assert k2_bf16_sizes(14, 2) == (128, 8)
    assert k2_bf16_sizes(14, 3) == (256, 16)  # 32-channel slices
    assert k2_bf16_sizes(14, 2, channels=24) == (1024, 64)  # 8-channel slices


def fold_axis_model(i0, i1, w0, w1, ratio):
    """fold_axis of one axis of one RoI: the sorted distinct cells that the
    nonzero taps touch, and the taps ``(cell, bin, weight)`` in the kernel's
    merged order (by cell; on one cell the i0 taps in sample order, then
    the i1 taps)."""
    taps = [(int(i0[k]), k // ratio, w0[k]) for k in range(len(i0)) if w0[k] != 0]
    taps += [(int(i1[k]), k // ratio, w1[k]) for k in range(len(i1)) if w1[k] != 0]
    taps.sort(key=lambda tap: tap[0])  # stable: the i0 taps first on a tie
    return np.array(sorted({tap[0] for tap in taps}), np.int64), taps


def sample_slots(cells, taps, i0, i1, w0, w1, ratio):
    """K2's per-sample view of the fold: the slot of each tap's cell, -1 for
    a zero weight. It must hold exactly the fold's taps."""
    s0 = np.where(w0 != 0, np.searchsorted(cells, i0), -1)
    s1 = np.where(w1 != 0, np.searchsorted(cells, i1), -1)
    per_sample = sorted((int(s), k // ratio, float(w)) for slots, ws in ((s0, w0), (s1, w1))
                        for k, (s, w) in enumerate(zip(slots, ws)) if s >= 0)
    assert per_sample == sorted((int(np.searchsorted(cells, c)), p, float(w))
                                for c, p, w in taps)
    return s0, s1


def contract(values, slots, weights, ratio):
    """sum over the ratio samples of each bin and their two taps of w * v,
    in the kernel's order: values [..., slots, C] -> [..., bins, C]."""
    acc = np.zeros(values.shape[:-2] + (len(slots[0]) // ratio, values.shape[-1]), np.float32)
    for j in range(ratio):
        for s, w in zip(slots, weights):
            s, w = s[j::ratio], w[j::ratio].astype(np.float32)
            acc += np.where(s >= 0, w, 0.0)[:, None] * values[..., np.maximum(s, 0), :]
    return acc


def k2_model(feats, rois, levels, strides, pool, ratio, stage_cells, ring_rows,
             aligned=False):
    """K2 in numpy, float32: per RoI the fold of each axis, the distinct
    cells staged ``chunk`` y rows at a time, pass x of each chunk into a ring
    of ``ring_rows`` rows, pass y of every output row whose taps have all
    arrived (and a check that each row it reads is still in the ring), and
    the division by S^2. ``aligned`` is the frame's (the kernels'
    aligned instances run the same algorithm)."""
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    level_hw = [f.shape[1:3] for f in feats]
    _, _, ys, xs = tra._sample_geometry(level_hw, torch.tensor(rois), torch.tensor(levels),
                                        strides, pool, ratio, aligned)
    axes = []
    for i0, i1, w0, w1, inb in (xs, ys):  # the border rule folded into the weights
        axes.append((i0.numpy(), i1.numpy(), torch.where(inb, w0, 0.0).numpy(),
                     torch.where(inb, w1, 0.0).numpy()))
    out = np.zeros((b, r, pool, pool, c), np.float32)
    for n in range(b * r):
        bi, ri = divmod(n, r)
        folds = []
        for i0, i1, w0, w1 in axes:
            args = (i0[bi, ri], i1[bi, ri], w0[bi, ri], w1[bi, ri])
            cells, taps = fold_axis_model(*args, ratio)
            assert len(cells) <= 2 * pool * ratio
            folds.append((cells, sample_slots(cells, taps, *args, ratio), args[2:]))
        (xcells, xslots, xw), (ycells, yslots, yw) = folds
        nx, ny = len(xcells), len(ycells)
        if nx == 0 or ny == 0:
            continue  # every sample outside the level: zeros
        last_row = np.maximum(yslots[0], yslots[1]).reshape(pool, ratio).max(1)
        feat = feats[levels[bi, ri]][bi]
        chunk = min(stage_cells // nx, ring_rows - 2 * ratio + 1)
        ring = np.zeros((ring_rows, pool, c), np.float32)
        held = np.full(ring_rows, -1)  # the row each ring slot holds
        done = 0
        for r0 in range(0, ny, chunk):
            rows = np.arange(r0, min(r0 + chunk, ny))
            staged = feat[ycells[rows]][:, xcells]  # [rows, nx, C]
            ring[rows % ring_rows] = contract(staged, xslots, xw, ratio)
            held[rows % ring_rows] = rows
            end = done
            while end < pool and last_row[end] < rows[-1] + 1:
                end += 1
            for p in range(done, end):
                need = [s for s in np.concatenate([sl[p * ratio:(p + 1) * ratio]
                                                   for sl in yslots]) if s >= 0]
                assert all(held[s % ring_rows] == s for s in need), "a row left the ring"
            bins = [sl[done * ratio:end * ratio] for sl in yslots]
            wts = [w[done * ratio:end * ratio] for w in yw]
            # pass y reads ring slot (row % ring_rows); -1 (no tap) weighs 0
            rows_of = [np.where(s >= 0, s % ring_rows, -1) for s in bins]
            acc = contract(np.moveaxis(ring, 0, 1), rows_of, wts, ratio)  # [P(q), bins, C]
            out[bi, ri, done:end] = np.moveaxis(acc, 0, 1) / np.float32(ratio * ratio)
            done = end
        assert done == pool
    return out


@functools.lru_cache(maxsize=None)
def k2_case(kind, pool, ratio=2):
    """Inputs of one case at a 256x1024 canvas (so that P5 is 32 cells
    wide and 'wider than P*S cells' holds at P=14), C=8: the RoIs and
    levels of chip_smoke's K3 stress kind (routed with the main path's
    span where the kind sets no levels), or chip_smoke's main-path RoIs;
    the plain version's and the JAX package's outputs at sampling ratio
    ``ratio``."""
    import chip_smoke as cs

    canvas, b, r = (256, 1024), 2, 24
    rng = np.random.RandomState(7 + pool)
    feats = [rng.randn(b, canvas[0] // st, canvas[1] // st, 8).astype(np.float32)
             for st in STRIDES]
    saved, cs.CANVAS = cs.CANVAS, canvas
    try:
        if kind == "main path":
            rois, levels = cs.roi_cases(rng, b, r, canvas), None
        else:
            rois, levels = cs.k3_stress_rois(rng, kind, b, r)
    finally:
        cs.CANVAS = saved
    if levels is None:
        levels = tra.assign_fpn_levels(torch.tensor(rois), 4, 2, max_span=(28.0, 44.0)).numpy()
    plain = tra.multilevel_roi_align_plain([torch.tensor(f) for f in feats], torch.tensor(rois),
                                           torch.tensor(levels), STRIDES, pool, ratio).numpy()
    # the JAX package, one level at a time (a single level routes every RoI to it)
    jax_out = np.zeros_like(plain)
    for lv, (f, st) in enumerate(zip(feats, STRIDES)):
        got = np.asarray(jra.multilevel_roi_align([jnp.asarray(f)], jnp.asarray(rois), (st,),
                                                  output_size=pool, sampling_ratio=ratio,
                                                  min_level=int(np.log2(st))))
        jax_out[levels == lv] = got[levels == lv]
    return feats, rois, levels, plain, jax_out


K2_KINDS = ("main path", "wider than P*S cells", "all sub-cell", "all identical",
            "P5 whole level", "past the border")


def check_k2_model(kind, pool, stage, ratio):
    feats, rois, levels, plain, jax_out = k2_case(kind, pool, ratio)
    got = k2_model(feats, rois, levels, STRIDES, pool, ratio, *k2_staging(stage, pool, ratio))
    limit = 1e-5 * max(float(np.abs(f).max()) for f in feats)
    np.testing.assert_allclose(got, plain, rtol=0, atol=limit)
    np.testing.assert_allclose(got, jax_out, rtol=0, atol=limit)
    if kind == "wider than P*S cells":
        cells = (rois[..., 2] - rois[..., 0]) / np.array(STRIDES)[levels]
        assert (cells > 2 * pool).all()  # P * S cells at the model's S = 2
    if kind == "past the border":
        assert (got == 0).all(axis=(2, 3, 4)).any()  # RoIs wholly outside give zeros


@pytest.mark.parametrize("stage", K2_STAGES)
@pytest.mark.parametrize("pool", [7, 14])
@pytest.mark.parametrize("kind", K2_KINDS)
def test_k2_model_matches_plain_and_jax(kind, pool, stage):
    """The kernel's algorithm (fold, staged chunks, x pass into the ring,
    y pass, / S^2) gives the plain version's and the JAX package's output
    within 1e-5 x max |feature| at the stress kinds chip_smoke holds the
    card to, with the kernel's staging and with one row a chunk, at the
    model's sampling ratio S = 2 (the kernel's S = 2 instance)."""
    check_k2_model(kind, pool, stage, 2)


@pytest.mark.parametrize("stage", K2_STAGES)
@pytest.mark.parametrize("pool", [7, 14])
@pytest.mark.parametrize("kind", K2_KINDS)
@pytest.mark.parametrize("ratio", [1, 3])
def test_k2_model_matches_plain_and_jax_at_other_ratios(ratio, kind, pool, stage):
    """The same at S = 1 and 3, which take the kernel's generic instance
    (S at run time, taps read from shared memory): its stage and ring
    sizes follow S."""
    check_k2_model(kind, pool, stage, ratio)


# ---------------------------------------------------------------------------
# bf16: the plain version K2's bf16 instance is held to on the card, against
# the JAX package's Pallas kernel on the same bf16 features.

def bf16_steps(a, b):
    """Elementwise distance between two bf16 tensors in bf16 steps."""
    def ordered(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (ordered(a) - ordered(b)).abs()


@pytest.mark.parametrize("pool", [7, 14])
@pytest.mark.parametrize("max_span", [(28.0, 44.0), (28.0, 36.0)])
def test_bf16_plain_is_the_fp32_plain_rounded_once(pool, max_span):
    """bf16 features: gathered as they are, summed in float32, the output
    rounded to bf16 once, so bit for bit the float32 version on the upcast
    features cast to bf16."""
    feats = [torch.tensor(f).to(torch.bfloat16) for f in make_features(16)]
    rois = torch.tensor(make_rois())
    levels = tra.assign_fpn_levels(rois, 4, 2, max_span=max_span)
    got = tra.multilevel_roi_align_plain(feats, rois, levels, STRIDES, pool)
    want = tra.multilevel_roi_align_plain([f.float() for f in feats], rois, levels, STRIDES,
                                          pool).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("pool", [7, 14])
def test_bf16_plain_matches_pallas_in_bf16(pool):
    """Against ``multilevel_roi_align_pallas`` in interpret mode on the same
    bf16 features (C=128 takes its kernel path; it reads bf16, sums in
    float32 and writes bf16): every value within one bf16 step of the
    Pallas output (at most 2^-7 x |value|) plus the float32 tolerance
    (TOL): the two float32 sums differ in their order, and where they fall
    on either side of a rounding boundary the bf16 values are one step
    apart (measured: 37 of 100352 values at P=7, 147 of 401408 at P=14;
    more steps only near zero, within 4e-6). Half a step (2^-8 x |value|)
    would not hold at those boundaries. At least 99.9% bitwise equal."""
    feats = [torch.tensor(f).to(torch.bfloat16)
             for f in make_features(128, base=(64, 64), b=1, seed=3)]
    rois = make_rois(b=1, r=16, canvas=(256, 256), seed=4)
    want = multilevel_roi_align_pallas(
        [jnp.asarray(f.float().numpy()).astype(jnp.bfloat16) for f in feats],
        jnp.asarray(rois), STRIDES, output_size=pool, interpret=True)
    assert want.dtype == jnp.bfloat16
    want = torch.tensor(np.asarray(want).astype(np.float32)).to(torch.bfloat16)
    levels = tra.assign_fpn_levels(torch.tensor(rois), 4, 2, max_span=tra.DEFAULT_MAX_SPAN)
    got = tra.multilevel_roi_align_plain(feats, torch.tensor(rois), levels, STRIDES, pool)
    d = (got.float() - want.float()).abs()
    assert bool((d <= 2.0 ** -7 * want.float().abs() + TOL).all()), float(d.max())
    assert float((got == want).float().mean()) >= 0.999
    assert int(bf16_steps(got, want)[d > TOL].max()) <= 1


# ---------------------------------------------------------------------------
# What the kernels take, checked when a detector is built on the card.

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


@pytest.mark.parametrize("override,dtype,key", [
    ("model.fpn_channels=30", torch.float32, "model.fpn_channels=30"),
    ("model.fpn_channels=36", torch.bfloat16, "model.fpn_channels=36"),
    ("roi.pool_size=33", torch.float32, "roi.pool_size=33"),
    ("roi.mask_pool_size=40", torch.bfloat16, "roi.mask_pool_size=40"),
    ("roi.sampling_ratio=5", torch.float32, "roi.mask_pool_size=14 x roi.sampling_ratio=5"),
])
def test_contract_check_names_the_limit_and_key(override, dtype, key, monkeypatch):
    """The configs the narrow kernels once refused (C not a multiple of 4 or
    8, P x S past 64) now pass the check and build a detector for the card
    (faked: no card is asked for anything else); the kernels take them by
    padding or by the wide route."""
    from detectron_tpu_torch.models import zoo

    cfg = get_config(None, ["model.name=mask_rcnn", override, f"model.dtype={str(dtype)[6:]}"])
    tra.check_roi_align_contract(cfg, dtype)
    monkeypatch.setattr(zoo, "resolve_device", lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(torch.nn.Module, "to", lambda self, *a, **k: self)
    det = zoo.build_detector(cfg)
    assert det.device.type == "cuda" and det.dtype == dtype
    # the keys the refusal named hold the refused values in the built config
    for part in key.split(" x "):
        name, value = part.split("=")
        section, leaf = name.split(".")
        assert str(cfg[section][leaf]) == value


def test_contract_check_passes_what_the_kernels_take():
    """Any channel count, pool size and level count passes; what is refused
    is a dtype without an instance (model.dtype) and a size below 1, named
    by its key."""
    cfg = get_config(None, ["model.name=mask_rcnn", "model.fpn_channels=36"])
    tra.check_roi_align_contract(cfg, torch.float32)
    faster = get_config(None, ["model.name=faster_rcnn", "roi.mask_pool_size=40"])
    tra.check_roi_align_contract(faster, torch.bfloat16)
    big = get_config(None, ["model.name=mask_rcnn", "roi.mask_pool_size=56",
                            "roi.sampling_ratio=8", "model.fpn_channels=3"])
    tra.check_roi_align_contract(big, torch.bfloat16)
    with pytest.raises(ValueError, match="model.dtype"):
        tra.check_roi_align_contract(cfg, torch.float16)
    zero = get_config(None, ["model.name=mask_rcnn", "roi.sampling_ratio=0"])
    with pytest.raises(ValueError, match="roi.sampling_ratio=0"):
        tra.check_roi_align_contract(zero, torch.float32)


@pytest.mark.parametrize("name", sorted(os.listdir(CONFIGS)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_contract_holds_for_every_config_the_port_builds(name, dtype):
    """Every config whose model pools RoIs with RoIAlign (Faster and Mask
    R-CNN) passes the check in both dtypes; RetinaNet pools none and R-FCN
    pools with PSRoIPool: both build and are not checked."""
    from detectron_tpu_torch.models import zoo

    cfg = get_config(os.path.join(CONFIGS, name), [f"model.dtype={dtype}"])
    if cfg.model.name in ("retinanet", "rfcn"):
        det = zoo.build_detector(cfg, device="cpu")
        assert not det.is_two_stage and not hasattr(det.module, "box_head")
        assert det.is_rfcn == (cfg.model.name == "rfcn")
        return
    assert cfg.model.name in ("faster_rcnn", "mask_rcnn")
    tra.check_roi_align_contract(cfg, getattr(torch, dtype))


def test_detector_on_the_card_checks_the_contract(monkeypatch):
    """A CUDA detector runs the check when it is built (here faked: no card
    is asked for anything else): a width the narrow kernels do not divide
    builds, and the check is called with the model's dtype."""
    from detectron_tpu_torch.models import zoo

    monkeypatch.setattr(zoo, "resolve_device", lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(torch.nn.Module, "to", lambda self, *a, **k: self)
    checked = []
    real = zoo.check_roi_align_contract
    monkeypatch.setattr(zoo, "check_roi_align_contract",
                        lambda *a: checked.append(a) or real(*a))
    cfg = get_config(None, ["model.name=mask_rcnn", "model.dtype=bfloat16",
                            "model.fpn_channels=36"])
    det = zoo.build_detector(cfg)
    assert det.device.type == "cuda" and [a[1] for a in checked] == [torch.bfloat16]


def test_retinanet_on_the_card_needs_no_contract(monkeypatch):
    """RetinaNet pools no RoIs: built for the card (faked, the check runs
    before the module is moved), a width the RoIAlign kernels refuse does
    not stop it."""
    from detectron_tpu_torch.models import zoo

    monkeypatch.setattr(zoo, "resolve_device", lambda device=None: torch.device("cuda"))
    checked = []
    monkeypatch.setattr(zoo, "check_roi_align_contract", lambda *a: checked.append(a))
    monkeypatch.setattr(torch.nn.Module, "to", lambda self, *a, **k: self)
    cfg = get_config(None, ["model.name=retinanet", "model.dtype=bfloat16",
                            "model.fpn_channels=36"])
    det = zoo.build_detector(cfg)
    assert det.device.type == "cuda" and checked == []


@pytest.mark.parametrize("overrides", [["model.name=rfcn"],
                                       ["model.name=mask_rcnn", "roi.pool_type=pool"]],
                         ids=["rfcn", "roi_pool"])
def test_no_roi_align_no_contract_on_the_card(monkeypatch, overrides):
    """R-FCN (PSRoIPool) and ``roi.pool_type=pool`` (RoIPool) launch no
    RoIAlign kernel: built for the card (faked), they are not checked."""
    from detectron_tpu_torch.models import zoo

    monkeypatch.setattr(zoo, "resolve_device", lambda device=None: torch.device("cuda"))
    checked = []
    monkeypatch.setattr(zoo, "check_roi_align_contract", lambda *a: checked.append(a))
    monkeypatch.setattr(torch.nn.Module, "to", lambda self, *a, **k: self)
    det = zoo.build_detector(get_config(None, overrides + ["model.fpn_channels=36"]))
    assert det.device.type == "cuda" and checked == []
