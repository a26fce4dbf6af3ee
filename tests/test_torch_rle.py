"""The port's RLE codec (``detectron_tpu_torch/native``) and mask paste
(``models/mask_rcnn.py``) against the JAX package's, on the same seeded
numpy inputs.

* The codec's encode, decode, area, IoU with the crowd rule, merge and the
  COCO string form give exactly what ``detectron_tpu.native`` gives, and
  what the port's numpy twins (``*_plain``) give.
* ``paste_masks_rle`` gives RLE counts equal bit for bit to the JAX
  ``paste_masks_rle`` and to ``RLE.encode`` of the port's dense paste, for
  float32 boxes, with boxes poking past every edge and sub-pixel slivers.
* ``paste_masks_device`` equals the JAX ``paste_masks_device``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu import native as jnative
from detectron_tpu.models import mask_rcnn as jmask
from detectron_tpu_torch import native
from detectron_tpu_torch.models import mask_rcnn as tmask


def random_masks(rng, n, hw):
    """Blobby masks (runs of many lengths) and a few all-empty / all-full."""
    h, w = hw
    out = []
    for i in range(n):
        if i == 0:
            out.append(np.zeros(hw, bool))
        elif i == 1:
            out.append(np.ones(hw, bool))
        else:
            coarse = rng.rand(-(-h // 8), -(-w // 8)) > 0.5
            out.append(np.kron(coarse, np.ones((8, 8), bool))[:h, :w]
                       ^ (rng.rand(h, w) > 0.97))
    return out


@pytest.mark.parametrize("hw", [(37, 53), (120, 160), (1, 9)])
def test_codec_matches_jax_and_plain(hw):
    rng = np.random.RandomState(hw[0] * 1000 + hw[1])
    masks = random_masks(rng, 6, hw)
    for m in masks:
        got = native.RLE.encode(m)
        want = jnative.RLE.encode(m)
        np.testing.assert_array_equal(got.counts, want.counts)
        np.testing.assert_array_equal(native.RLE.encode_plain(m).counts, got.counts)
        np.testing.assert_array_equal(got.decode(), m)
        np.testing.assert_array_equal(got.decode_plain(), m)
        assert got.area() == want.area() == got.area_plain() == int(m.sum())
        s = got.to_string()
        assert s == want.to_string()
        back = native.RLE.from_string(s, *hw)
        np.testing.assert_array_equal(back.counts, got.counts)
        assert got.to_coco() == {"size": list(hw), "counts": s}


def test_iou_with_crowd_matches_jax_and_plain():
    rng = np.random.RandomState(3)
    hw = (64, 48)
    a = [native.RLE.encode(m) for m in random_masks(rng, 5, hw)]
    b = [native.RLE.encode(m) for m in random_masks(rng, 4, hw)]
    ja = [jnative.RLE(x.h, x.w, x.counts) for x in a]
    jb = [jnative.RLE(x.h, x.w, x.counts) for x in b]
    crowd = np.array([False, True, False, True])
    for iscrowd in (None, crowd):
        got = native.rle_iou(a, b, iscrowd=iscrowd)
        np.testing.assert_array_equal(got, jnative.rle_iou(ja, jb, iscrowd=iscrowd))
        np.testing.assert_allclose(native.rle_iou_plain(a, b, iscrowd), got, rtol=1e-15)
    # the crowd rule: intersection over the detection's area
    m = np.zeros(hw, bool)
    m[:10] = True
    half = np.zeros(hw, bool)
    half[:5] = True
    iou = native.rle_iou([native.RLE.encode(half)], [native.RLE.encode(m)], [True])
    assert iou[0, 0] == 1.0
    assert native.rle_iou([], b).shape == (0, 4)


@pytest.mark.parametrize("intersect", [False, True])
def test_merge_matches_jax_and_plain(intersect):
    rng = np.random.RandomState(5)
    ma, mb = random_masks(rng, 4, (33, 41))[2:]
    a, b = native.RLE.encode(ma), native.RLE.encode(mb)
    got = native.rle_merge(a, b, intersect=intersect)
    want = jnative.rle_merge(jnative.RLE.encode(ma), jnative.RLE.encode(mb),
                             intersect=intersect)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(native.rle_merge_plain(a, b, intersect).counts, got.counts)
    np.testing.assert_array_equal(got.decode(), (ma & mb) if intersect else (ma | mb))


def paste_case(rng, d, hw, extreme):
    h, w = hw
    masks = rng.rand(d, 28, 28).astype(np.float32)
    if extreme:  # boxes past every edge, and sub-pixel slivers
        x1, y1 = rng.uniform(-50, w - 1, d), rng.uniform(-50, h - 1, d)
        bw, bh = rng.uniform(0.01, w, d), rng.uniform(0.01, h, d)
    else:
        x1, y1 = rng.uniform(0, w - 40, d), rng.uniform(0, h - 40, d)
        bw, bh = rng.uniform(4, 200, d), rng.uniform(4, 200, d)
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)
    valid = rng.rand(d) > 0.2
    return masks, boxes, valid


@pytest.mark.parametrize("hw,extreme", [((480, 640), False), ((427, 640), True),
                                        ((123, 77), True)])
def test_paste_masks_rle_bit_exact(hw, extreme):
    rng = np.random.RandomState(hw[0] + int(extreme))
    masks, boxes, valid = paste_case(rng, 24, hw, extreme)
    got = tmask.paste_masks_rle(masks, boxes, valid, hw)
    want = jmask.paste_masks_rle(masks, boxes, valid, hw)
    dense = tmask.paste_masks_numpy(masks, boxes, valid, hw)
    np.testing.assert_array_equal(dense, jmask.paste_masks_numpy(masks, boxes, valid, hw))
    for i in range(len(masks)):
        assert (got[i].h, got[i].w) == hw
        np.testing.assert_array_equal(got[i].counts, want[i].counts, err_msg=f"det {i}")
        np.testing.assert_array_equal(got[i].counts, native.RLE.encode(dense[i]).counts,
                                      err_msg=f"det {i} box {boxes[i]}")
    assert list(got[int(np.argmin(valid))].counts) == [hw[0] * hw[1]]


def test_paste_float64_boxes_as_the_eval_driver_divides_them():
    """The eval driver maps boxes back by ``boxes / scale`` in float64 (numpy's
    promotion of a float32 array by a float64 scalar); the paste casts them to
    float32 as the JAX paste does, so the counts stay equal."""
    rng = np.random.RandomState(11)
    masks, boxes, valid = paste_case(rng, 8, (480, 640), False)
    scale = np.float32(800) / np.int64(480)
    b = boxes * scale / max(scale, 1e-9)
    got = tmask.paste_masks_rle(masks, b, valid, (480, 640))
    want = jmask.paste_masks_rle(masks, b, valid, (480, 640))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.counts, w.counts)


def test_paste_threshold_honoured():
    masks = np.full((1, 28, 28), 0.4, np.float32)
    boxes = np.asarray([[10, 10, 60, 60]], np.float32)
    assert tmask.paste_masks_rle(masks, boxes, [True], (100, 100), 0.5)[0].area() == 0
    assert tmask.paste_masks_rle(masks, boxes, [True], (100, 100), 0.3)[0].area() == 2500


def test_paste_masks_device_matches_jax():
    rng = np.random.RandomState(7)
    masks, boxes, valid = paste_case(rng, 6, (90, 70), True)
    got = tmask.paste_masks_device(torch.tensor(masks), torch.tensor(boxes),
                                   torch.tensor(valid), (90, 70))
    want = jmask.paste_masks_device(jnp.asarray(masks), jnp.asarray(boxes),
                                    jnp.asarray(valid), (90, 70))
    assert got.dtype == torch.bool and got.shape == (6, 90, 70)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "rle.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="RLE codec build failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))
    assert native.library_path().parent == tmp_path / "build"
