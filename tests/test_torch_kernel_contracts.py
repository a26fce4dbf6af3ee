"""What the card takes: every input the JAX kernels' functions take.

* K1 on bf16 boxes. A model of the bf16 mask kernel's IoU (``csrc/nms.cu``:
  every step of ``bbox_overlaps`` computed in float32 and rounded to bf16,
  the threshold rounded to bf16) is held bit for bit against the JAX
  package's ``_iou_block`` and ``bbox_overlaps`` in bf16, and its greedy
  walk against JAX ``nms_pallas(interpret=True)``, JAX ``nms_padded`` and
  the port's plain walk (``greedy_keep_plain``), with IoUs exactly at the
  rounded threshold, ``offset=1`` and ``class_aware_nms``.
* K2 and K3 at any channel count, layout, sample count and level count:
  the plain twins (what the kernels are held to on the card) against JAX's
  ``multilevel_roi_align`` / ``roi_align`` and their gradients at C=3, 30
  and 36, a misaligned view, P x S = 112 and 10 levels.
* The wrappers' padding, realignment and routing to the narrow instances
  or the wide route, with the CUDA launches replaced by the plain twins:
  the kernels see whole channel multiples in fresh aligned tensors, and the
  caller gets the unpadded result.

The kernels themselves run on the card (``chip_smoke.py`` phase 30).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.ops import boxes as jboxes
from detectron_tpu.ops import nms as jnms
from detectron_tpu.ops import roi_align as jra
from detectron_tpu.ops.nms_pallas import _iou_block, nms_pallas
from detectron_tpu_torch.ops import nms as tnms
from detectron_tpu_torch.ops import roi_align as tra

# ------------------------------------------------------------- K1, bf16


def _r(x: torch.Tensor) -> torch.Tensor:
    """A float32 result rounded to bf16 (nearest even), back in float32."""
    return x.bfloat16().float()


def iou_model(a: torch.Tensor, b: torch.Tensor, offset: float = 0.0) -> torch.Tensor:
    """The bf16 mask kernel's IoU of rows ``a [N, 4]`` against ``b [K, 4]``
    (bf16), step by step as ``iou<uint2>`` computes it: each step in
    float32, rounded to bf16; maxima, minima and the clamps at 0 exact; the
    ``inter == 0`` shortcut."""
    a, b = a.float(), b.float()

    def area(x):
        w = _r(_r(x[:, 2] - x[:, 0]) + offset).clamp_min(0.0)
        h = _r(_r(x[:, 3] - x[:, 1]) + offset).clamp_min(0.0)
        return _r(w * h)

    ix1 = torch.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = torch.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = torch.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = torch.minimum(a[:, None, 3], b[None, :, 3])
    iw = _r(_r(ix2 - ix1) + offset).clamp_min(0.0)
    ih = _r(_r(iy2 - iy1) + offset).clamp_min(0.0)
    inter = _r(iw * ih)
    union = _r(_r(area(a)[:, None] + area(b)[None, :]) - inter)
    iou = _r(inter / torch.maximum(union, _r(torch.tensor(1e-8))))
    return torch.where(inter == 0, torch.zeros_like(iou), iou)


def model_keep(sboxes, svalid, thresh, offset=0.0, max_keep=None):
    """The greedy walk over :func:`iou_model`'s bits against the threshold
    rounded to bf16, called as ``greedy_keep`` is."""
    g, n = svalid.shape
    thresh = tnms.threshold_in(thresh, torch.bfloat16)
    keep = torch.ones(g, n, dtype=torch.bool)
    for k in range(g):
        sup = (iou_model(sboxes[k], sboxes[k], offset) > thresh) & torch.ones(
            n, n, dtype=torch.bool).triu(1)
        for i in range(n):
            if keep[k, i] and svalid[k, i]:
                keep[k] &= ~sup[i]
    keep &= svalid
    if max_keep is not None:
        keep &= keep.cumsum(1) <= max_keep
    return keep


def bf16_boxes(rng, n, canvas=300.0, pairs=()):
    """``n`` clustered bf16 boxes (chains of suppression), with ``pairs``
    (each two exact boxes) first."""
    centers = rng.uniform(0, canvas, size=(n // 6 + 1, 2))
    c = centers[rng.randint(0, len(centers), n)] + rng.normal(0, 4, (n, 2))
    wh = rng.uniform(4, 60, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    for i, (x, y) in enumerate(pairs):
        boxes[2 * i], boxes[2 * i + 1] = x, y
    return torch.tensor(boxes.astype(np.float32)).bfloat16()


def test_threshold_rounds_as_the_frameworks_round_it():
    """0.7 rounds down to 0.69921875 and 0.3 up to 0.30078125; a bf16 IoU
    equal to the rounded threshold is not above it, in PyTorch, in JAX and
    in the model (the strict > of both)."""
    assert tnms.threshold_in(0.7, torch.bfloat16) == 0.69921875
    assert tnms.threshold_in(0.3, torch.bfloat16) == 0.30078125
    assert tnms.threshold_in(0.7, torch.float32) == 0.7
    for thresh, value in ((0.7, 0.69921875), (0.3, 0.30078125)):
        t = torch.tensor([value], dtype=torch.bfloat16)
        j = jnp.asarray([value], dtype=jnp.bfloat16)
        assert not bool((t > thresh)[0]) and not bool((j > thresh)[0])
        assert not value > tnms.threshold_in(thresh, torch.bfloat16)


# (row box, column box, IoU after the bf16 steps): inter 70 of union 100
# rounds to bf16(0.7); inter 30 of 100 to bf16(0.3), which is above 0.3.
# The two pairs lie apart from each other and from bf16_boxes' clusters.
EXACT_PAIRS = (([0.0, 0.0, 10.0, 10.0], [0.0, 0.0, 10.0, 7.0], 0.69921875),
               ([-64.0, 0.0, -54.0, 10.0], [-64.0, 0.0, -54.0, 3.0], 0.30078125))


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_iou_model_equals_jax_bf16_bit_for_bit(offset):
    boxes = bf16_boxes(np.random.RandomState(0), 400)
    got = iou_model(boxes, boxes, offset)
    jb = jnp.asarray(boxes.float().numpy()).astype(jnp.bfloat16)
    for want in (_iou_block(jb, jb, offset), jboxes.bbox_overlaps(jb, jb, offset),
                 jax.jit(lambda x: _iou_block(x, x, offset))(jb)):
        assert want.dtype == jnp.bfloat16
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.astype(jnp.float32)))
    # and the port's own bf16 bbox_overlaps, which the plain walk compares
    port = tnms.bbox_overlaps(boxes, boxes, offset)
    np.testing.assert_array_equal(got.numpy(), port.float().numpy())
    if offset == 0.0:
        for a, b, iou in EXACT_PAIRS:
            pair = torch.tensor([a, b]).bfloat16()
            assert float(iou_model(pair[:1], pair[1:])[0, 0]) == iou


@pytest.mark.parametrize("thresh,offset", [(0.7, 0.0), (0.5, 1.0), (0.3, 0.0)])
def test_model_walk_equals_jax_nms_and_the_plain_walk(thresh, offset):
    """(idx, valid) of the model's walk, the port's plain walk on bf16
    boxes, JAX nms_pallas in interpret mode and JAX nms_padded: all equal,
    on problems whose first pairs sit exactly at the rounded thresholds
    (scores keep each pair's row box first)."""
    rng = np.random.RandomState(int(thresh * 10) + int(offset))
    n, max_out = 300, 100
    for trial in range(2):
        boxes = bf16_boxes(rng, n, pairs=[(a, b) for a, b, _ in EXACT_PAIRS])
        scores = rng.uniform(0, 1, n).astype(np.float32)
        scores[:4] = [0.999, 0.998, 0.997, 0.996]
        scores[10::9] = scores[5]  # exact ties
        valid = rng.uniform(size=n) > 0.1
        valid[:4] = True
        tb, ts, tv = torch.tensor(boxes.float().numpy()).bfloat16(), torch.tensor(scores), \
            torch.tensor(valid)
        plain = tnms.nms_padded_batched(tb[None], ts[None], tv[None], thresh, max_out, offset)
        model = tnms.nms_padded_batched(tb[None], ts[None], tv[None], thresh, max_out, offset,
                                        keep_fn=model_keep)
        jb = jnp.asarray(boxes.float().numpy()).astype(jnp.bfloat16)
        pallas = nms_pallas(jb, jnp.asarray(scores), thresh, max_out, valid=jnp.asarray(valid),
                            offset=offset, interpret=True)
        padded = jnms.nms_padded(jb, jnp.asarray(scores), thresh, max_out,
                                 valid=jnp.asarray(valid), offset=offset)
        for idx, ok in (plain, model):
            for want_idx, want_ok in (pallas, padded):
                np.testing.assert_array_equal(idx[0].numpy(), np.asarray(want_idx))
                np.testing.assert_array_equal(ok[0].numpy(), np.asarray(want_ok))
        # each pair's row box keeps; its column box keeps exactly where its
        # IoU is not above the rounded threshold
        kept = set(plain[0][0][plain[1][0]].tolist())
        assert 0 in kept and 2 in kept
        for k, (a, b, _) in enumerate(EXACT_PAIRS):
            pair = torch.tensor([a, b]).bfloat16()
            iou = float(iou_model(pair[:1], pair[1:], offset)[0, 0])
            assert (2 * k + 1 in kept) == (iou <= tnms.threshold_in(thresh, torch.bfloat16))


def test_class_aware_nms_bf16_equals_jax_and_the_model():
    """The class-offset trick on bf16 boxes (the shift rounded to bf16 on
    both sides): the port's class_aware_nms equals JAX's, by nms_padded and
    by nms_pallas in interpret mode, and the model's walk on the same
    shifted boxes."""
    rng = np.random.RandomState(3)
    n, max_out = 240, 80
    tb = bf16_boxes(rng, n)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    classes = rng.randint(1, 5, n).astype(np.int32)
    idx, ok = tnms.class_aware_nms(tb, torch.tensor(scores), torch.tensor(classes), 0.5,
                                   max_out)
    jb = jnp.asarray(tb.float().numpy()).astype(jnp.bfloat16)
    shift = ((jnp.asarray(classes).astype(jnp.bfloat16) * (jnp.max(jb) - jnp.min(jb) + 1.0))
             [:, None])
    for want_idx, want_ok in (
            jnms.class_aware_nms(jb, jnp.asarray(scores), jnp.asarray(classes), 0.5, max_out),
            nms_pallas(jb + shift, jnp.asarray(scores), 0.5, max_out, interpret=True)):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    span = tb.amax() - tb.amin() + 1.0
    shifted = tb + (torch.tensor(classes).to(tb.dtype) * span)[:, None]
    m_idx, m_ok = tnms.nms_padded_batched(shifted[None], torch.tensor(scores)[None], None, 0.5,
                                          max_out, keep_fn=model_keep)
    assert torch.equal(m_idx[0], idx) and torch.equal(m_ok[0], ok)
    assert int(ok.sum()) > 10


def test_greedy_keep_cuda_names_the_dtypes_it_takes():
    """float32 and bf16 have instances; another dtype is refused, named,
    before the device is looked at."""
    assert tnms.BOX_DTYPES == (torch.float32, torch.bfloat16)
    valid = torch.ones(1, 4, dtype=torch.bool)
    with pytest.raises(TypeError, match="torch.float16"):
        tnms.greedy_keep_cuda(torch.zeros(1, 4, 4, dtype=torch.float16), valid, 0.5)
    for dtype in tnms.BOX_DTYPES:  # taken, and refused here for lying on the CPU
        with pytest.raises(ValueError, match="CUDA"):
            tnms.greedy_keep_cuda(torch.zeros(1, 4, 4, dtype=dtype), valid, 0.5)


# ---------------------------------------------------------- K2 and K3


def features(c, levels=4, base=(64, 80), b=2, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, max(base[0] >> i, 1), max(base[1] >> i, 1), c).astype(np.float32)
            for i in range(levels)]


def rois_for(canvas, b=2, r=12, seed=1):
    rng = np.random.RandomState(seed)
    h, w = canvas
    xy = rng.uniform([-10, -10], [w * 0.8, h * 0.8], size=(b, r, 2))
    wh = np.exp(rng.uniform(np.log(2), np.log(min(h, w)), size=(b, r, 2)))
    rois = np.concatenate([xy, xy + wh], -1)
    rois[:, -2:, 2:] = rois[:, -2:, :2] + rng.uniform(0.2, 2.0, (b, 2, 2))  # sub-cell
    return rois.astype(np.float32)


# (name, C, levels, strides, P, S, misaligned): the channel counts K2/K3's
# instances do not divide, a level that is a view of a wider tensor,
# P x S = 112 (mask_pool_size=28, sampling_ratio=4), pool_size=33, 10 levels
PLAIN_CASES = (
    ("C=3", 3, 4, (4, 8, 16, 32), 7, 2, False),
    ("C=30", 30, 4, (4, 8, 16, 32), 7, 2, False),
    ("C=36 misaligned view", 36, 4, (4, 8, 16, 32), 14, 2, True),
    ("P*S=112", 3, 4, (4, 8, 16, 32), 28, 4, False),
    ("pool_size=33", 5, 4, (4, 8, 16, 32), 33, 2, False),
    ("10 levels", 3, 10, tuple(2 ** i for i in range(10)), 7, 2, False),
)


@pytest.mark.parametrize("name,c,n_levels,strides,p,s,misaligned", PLAIN_CASES,
                         ids=[c[0] for c in PLAIN_CASES])
def test_plain_twins_match_jax_at_every_shape(name, c, n_levels, strides, p, s, misaligned):
    """Forward within 1e-5 (float32, the sums in another order) and the
    gradient (autograd through the port's Function, the plain K3) within
    the JAX package's own 1e-4 of ``jax.vjp``."""
    base = (64, 80) if n_levels == 4 else (256, 256)
    feats = features(c, n_levels, base)
    canvas = (base[0] * strides[0], base[1] * strides[0])
    rois = rois_for(canvas)
    g = np.random.RandomState(2).randn(2, rois.shape[1], p, p, c).astype(np.float32)
    jf = tuple(jnp.asarray(f) for f in feats)
    want, vjp = jax.vjp(lambda f: jra.multilevel_roi_align(
        list(f), jnp.asarray(rois), strides, output_size=p, sampling_ratio=s), jf)
    (want_grad,) = vjp(jnp.asarray(g))
    if misaligned:  # each level a view [..., 1:] of a C+1 tensor
        leaves = [torch.tensor(np.concatenate([np.zeros(f.shape[:3] + (1,), np.float32), f],
                                              -1), requires_grad=True) for f in feats]
        tf = [x[..., 1:] for x in leaves]
        assert not tf[0].is_contiguous()
    else:
        leaves = tf = [torch.tensor(f, requires_grad=True) for f in feats]
    got = tra.multilevel_roi_align(tf, torch.tensor(rois), strides, output_size=p,
                                   sampling_ratio=s)
    got.backward(torch.tensor(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    for leaf, w in zip(leaves, want_grad):
        grad = leaf.grad[..., 1:] if misaligned else leaf.grad
        np.testing.assert_allclose(grad.numpy(), np.asarray(w), rtol=0, atol=1e-4)


def test_single_level_roi_align_matches_jax_at_c36_and_ps112():
    feat = features(36, 1, (32, 24))[0]
    rois = rois_for((32 * 8, 24 * 8), r=4)
    for p, s in ((14, 2), (28, 4)):
        want = jra.roi_align(jnp.asarray(feat), jnp.asarray(rois), 8, p, s)
        got = tra.roi_align(torch.tensor(feat), torch.tensor(rois), 8, p, s)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.fixture
def launches(monkeypatch):
    """The CUDA launches replaced by the plain twins, on CPU tensors: each
    records what it was handed, after checking that it is what a kernel
    reads (contiguous, 16-byte aligned, C a whole channel multiple). The
    narrow instances are taken where the parent's rules take them (at most
    8 levels and 64 samples an axis)."""
    calls = []

    def ready(t, what):
        assert t.is_contiguous() and t.data_ptr() % 16 == 0, what
        assert t.shape[-1] % tra.CHANNEL_MULTIPLE[t.dtype] == 0, what

    def fwd(narrow, feats, rois, levels, strides, p, s, aligned):
        for f in feats:
            ready(f, "K2 level")
        ready(rois, "rois")
        calls.append(("K2", "narrow" if narrow else "wide", feats[0].dtype, feats[0].shape[-1]))
        return tra.multilevel_roi_align_plain(feats, rois, levels, strides, p, s, aligned)

    def add(route):
        def launch(grads, grad, rois, levels, strides, s=2, aligned=False):
            ready(grad, "g")
            calls.append(("K3", route, grad.dtype, grad.shape[-1]))
            level_hw = [tuple(t.shape[1:3]) for t in grads]
            for acc, part in zip(grads, tra.multilevel_roi_align_bwd_plain(
                    grad.float(), level_hw, rois, levels, strides, s, aligned)):
                acc.add_(part)
        return launch

    def tiles(grads, bounds, grad, rois, levels, strides, s=2, aligned=False):
        ready(grad, "g")
        calls.append(("K3", "narrow", grad.dtype, grad.shape[-1]))
        level_hw = [tuple(t.shape[1:3]) for t in grads]
        for out, part in zip(grads, tra.multilevel_roi_align_bwd_plain(
                grad, level_hw, rois, levels, strides, s, aligned)):
            out.copy_(part)

    def cast(src, dst):
        calls.append(("cast", src.dtype, dst.dtype))
        dst.copy_(src.to(torch.bfloat16))

    monkeypatch.setattr(tra, "roi_align_fwd_launch", fwd)
    monkeypatch.setattr(tra, "roi_align_bwd_accumulate_cuda", add("narrow"))
    monkeypatch.setattr(tra, "roi_align_bwd_wide_cuda", add("wide"))
    monkeypatch.setattr(tra, "roi_align_bwd_tiles_cuda", tiles)
    monkeypatch.setattr(tra, "roi_tap_bounds_cuda", tra.roi_tap_cell_bounds)
    monkeypatch.setattr(tra, "cast_bf16_cuda", cast)
    monkeypatch.setattr(tra, "_roi_align_lib", lambda: type("Lib", (), dict(
        roi_align_narrow=staticmethod(lambda kind, c, p, s, n: 1)))())
    return calls


# (C, dtype, levels, P, S, misaligned, the padded C, the route)
ROUTE_CASES = (
    (30, torch.float32, 4, 7, 2, False, 32, "narrow"),
    (36, torch.bfloat16, 4, 14, 2, False, 40, "narrow"),
    (16, torch.float32, 4, 7, 2, True, 16, "narrow"),
    (8, torch.bfloat16, 4, 28, 4, False, 8, "wide"),
    (6, torch.float32, 4, 33, 2, True, 8, "wide"),
    (3, torch.bfloat16, 10, 7, 2, False, 8, "wide"),
)


@pytest.mark.parametrize("c,dtype,n_levels,p,s,misaligned,padded,route", ROUTE_CASES)
def test_wrappers_pad_realign_and_route(launches, c, dtype, n_levels, p, s, misaligned,
                                        padded, route):
    """K2 and K3 through the wrappers' padding, realignment and routing, the
    launches replaced by the plain twins: the kernels are handed C padded to
    the multiple in fresh aligned tensors, the route is the narrow instance
    up to 8 levels and 64 samples an axis and the wide route past them (a
    bf16 gradient then cast once), and the caller gets what the plain
    versions give on the unpadded inputs."""
    base = (32, 40) if n_levels == 4 else (128, 128)
    strides = tuple(2 ** (i + 2) for i in range(n_levels)) if n_levels == 4 else tuple(
        2 ** i for i in range(n_levels))
    feats = [torch.tensor(f).to(dtype) for f in features(c, n_levels, base)]
    if misaligned:  # a contiguous view 4 bytes into its storage
        feats = [torch.cat([torch.zeros(1, dtype=dtype), f.flatten()])[1:].view(f.shape)
                 for f in feats]
        assert feats[0].is_contiguous() and feats[0].data_ptr() % 16
    rois = torch.tensor(rois_for((base[0] * strides[0], base[1] * strides[0])))
    levels = tra.assign_fpn_levels(rois, n_levels, int(np.log2(strides[0])))
    out = tra.roi_align_forward_padded(feats, rois, levels, strides, p, s, False)
    want = tra.multilevel_roi_align_plain(feats, rois, levels, strides, p, s)
    assert out.shape == want.shape and out.dtype == dtype
    assert torch.equal(out, want)
    g = torch.tensor(np.random.RandomState(4).randn(*out.shape).astype(np.float32)).to(dtype)
    level_hw = [tuple(f.shape[1:3]) for f in feats]
    grads, launched = tra.roi_align_backward_padded(g, level_hw, rois, levels, strides, s,
                                                    False)
    want_grads = tra.multilevel_roi_align_bwd_plain(g, level_hw, rois, levels, strides, s)
    assert launched
    for got, w in zip(grads, want_grads):
        assert got.shape == w.shape and got.dtype == dtype
        if dtype == torch.float32 or route == "narrow":
            assert torch.equal(got, w)
        else:  # the wide route sums in float32, then the cast rounds once
            assert torch.equal(got, w.float().to(torch.bfloat16))
    k2 = [x for x in launches if x[0] == "K2"]
    k3 = [x for x in launches if x[0] == "K3"]
    assert k2 == [("K2", route, dtype, padded)] and k3 == [("K3", route, dtype, padded)]
    casts = [x for x in launches if x[0] == "cast"]
    assert casts == ([("cast", torch.float32, torch.bfloat16)]
                     if route == "wide" and dtype == torch.bfloat16 else [])


@pytest.mark.parametrize("p,s,route", [(7, 2, "narrow"), (28, 4, "wide")])
def test_bf16_gradient_without_rois_is_zeros(launches, p, s, route):
    """No RoIs: the bf16 level gradients are written whole, zeros, by the
    tile kernel (narrow) or by the cast of the zero fill (wide); no RoI's
    launch is made."""
    level_hw = [(8, 10), (4, 5)]
    rois = torch.zeros((2, 0, 4))
    levels = torch.zeros((2, 0), dtype=torch.int32)
    g = torch.zeros((2, 0, p, p, 12), dtype=torch.bfloat16)
    grads, launched = tra.roi_align_backward_padded(g, level_hw, rois, levels, (4, 8), s,
                                                    False)
    assert launched and [tuple(x.shape) for x in grads] == [(2, 8, 10, 12), (2, 4, 5, 12)]
    assert all(x.dtype == torch.bfloat16 and not x.any() for x in grads)
    assert [x[:2] for x in launches] == ([("K3", "narrow")] if route == "narrow"
                                         else [("cast", torch.float32)])


def test_narrow_takes_only_what_the_parent_instances_take(monkeypatch):
    """Past 8 levels or 64 samples an axis the wide route is taken without
    asking the library; within them, the library's answer (its shared
    memory) decides."""
    asked = []
    monkeypatch.setattr(tra, "_roi_align_lib", lambda: type("Lib", (), dict(
        roi_align_narrow=staticmethod(lambda *a: asked.append(a) or 0)))())
    assert not tra.narrow_takes(tra.K2_F32, 256, 7, 2, 9)
    assert not tra.narrow_takes(tra.K3_BF16, 256, 13, 5, 4)
    assert asked == []
    assert not tra.narrow_takes(tra.K3_F32, 256, 32, 2, 4)
    assert asked == [(tra.K3_F32, 256, 32, 2, 4)]


def test_kernel_ready_copies_only_what_a_kernel_cannot_read():
    x = torch.randn(2, 5, 6, 8)
    assert tra.kernel_ready(x) is x
    view = x[..., 1:]
    got = tra.kernel_ready(view)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0 and torch.equal(got, view)
    shifted = torch.cat([torch.zeros(1), x.flatten()])[1:].view(x.shape)
    assert shifted.data_ptr() % 16
    got = tra.kernel_ready(shifted)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, x)
    padded = tra.kernel_ready(view, 8)
    assert padded.shape[-1] == 8 and torch.equal(padded[..., :7], view)
    assert not padded[..., 7:].any()
    assert [tra.padded_channels(c, torch.float32) for c in (3, 4, 30)] == [4, 4, 32]
    assert [tra.padded_channels(c, torch.bfloat16) for c in (3, 8, 36)] == [8, 8, 40]
