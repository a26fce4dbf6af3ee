"""The port's data path (``detectron_tpu_torch/data``) against the JAX
package's, on the same seeded inputs and the repo's fixtures.

* ``resize_shortest_side``: the same output size and scale as the JAX one
  (``cv2.resize``, INTER_LINEAR); pixels within 1 grey level for a uint8
  image (``cv2`` rounds with 11-bit fixed-point weights, the port rounds
  its float result; the limit is that rounding, not a loosened check) and
  within 0.05 for a float image (``cv2``'s float weights).
* ``preprocess_example``, with the JAX resize injected into the port:
  every array equal, with and without the flip.
* ``CocoDataset`` / ``VocDataset`` on ``tests/fixture_coco.py`` /
  ``fixture_voc.py``: the same examples, the same RLEs from
  ``segmentation_to_rle`` (polygons and both crowd RLE forms).
* ``Loader``: the same examples in eval mode (tail padded by repetition),
  with and without orientation buckets; the same seeded train batches;
  disjoint process shards.
"""

import numpy as np
import pytest

from detectron_tpu.config import get_config as jax_get_config
from detectron_tpu.data import coco as jcoco
from detectron_tpu.data import loader as jloader
from detectron_tpu.data import transforms as jT
from detectron_tpu.data import voc as jvoc
from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.data import coco as tcoco
from detectron_tpu_torch.data import loader as tloader
from detectron_tpu_torch.data import transforms as tT
from detectron_tpu_torch.data import voc as tvoc
from tests import fixture_coco, fixture_voc

SMALL = ["data.short_side=96", "data.max_size=128", "data.image_size=[128, 128]",
         "train.batch_size=4", "train.max_gt_boxes=8", "model.name=mask_rcnn"]


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return fixture_coco.make_fixture(str(tmp_path_factory.mktemp("coco")))


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    return fixture_voc.make_fixture(str(tmp_path_factory.mktemp("voc")))


@pytest.mark.parametrize("hw", [(120, 160), (160, 120), (375, 500), (427, 640), (97, 33)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_resize_matches_cv2(hw, dtype):
    rng = np.random.RandomState(hw[0])
    img = (rng.rand(*hw, 3) * 255).astype(dtype)
    for short, cap in ((800, 1333), (96, 128)):
        got, s_got = tT.resize_shortest_side(img, short, cap)
        want, s_want = jT.resize_shortest_side(img, short, cap)
        assert got.shape == want.shape and got.dtype == want.dtype == np.float32
        assert s_got == s_want
        diff = np.abs(got - want).max()
        if dtype == np.uint8:
            assert diff <= 1.0
            np.testing.assert_array_equal(got, np.round(got))  # whole grey levels
        else:
            assert diff <= 0.05


def test_resize_keeps_a_constant_image_exact():
    img = np.full((100, 150, 3), 77, np.uint8)
    got, scale = tT.resize_shortest_side(img, 200, 250)
    assert got.shape == (167, 250, 3) and scale == 250 / 150
    assert (got == 77).all()


@pytest.mark.parametrize("train", [False, True])
def test_preprocess_example_matches_jax(monkeypatch, train):
    monkeypatch.setattr(tT, "resize_shortest_side", jT.resize_shortest_side)
    rng = np.random.RandomState(1)
    img = (rng.rand(100, 150, 3) * 255).astype(np.uint8)
    boxes = np.array([[10.0, 10.0, 50.0, 60.0], [0.0, 5.0, 149.0, 99.0]], np.float32)
    classes = np.array([3, 1])
    masks = rng.rand(2, 28, 28).astype(np.float32)
    overrides = SMALL + ["data.hflip_prob=1.0", "data.train_scales=[64, 96]"]
    got = tT.preprocess_example(img, boxes, classes, get_config(None, overrides),
                                rng=np.random.RandomState(2), train=train,
                                gt_masks=masks, canvas_hw=(128, 160))
    want = jT.preprocess_example(img, boxes, classes, jax_get_config(None, overrides),
                                 rng=np.random.RandomState(2), train=train,
                                 gt_masks=masks, canvas_hw=(128, 160))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def assert_examples_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def test_coco_dataset_matches_jax(coco_root):
    got = tcoco.CocoDataset(coco_root, "val", with_masks=True)
    want = jcoco.CocoDataset(coco_root, "val", with_masks=True)
    assert len(got) == len(want) == len(fixture_coco.IMAGE_SIZES)
    assert got.num_classes == want.num_classes == 4
    assert got.coco.cat_id_to_contiguous == {1: 1, 3: 2, 7: 3}
    assert got.coco.class_names == want.coco.class_names
    for i in range(len(want)):
        g, w = got.example(i), want.example(i)
        assert_examples_equal(g, w)
        assert got.index_of(w["image_id"]) == i
        hw = w["orig_hw"]
        for seg in w["polygons"] + w["crowd_segmentations"]:
            r_got = got.segmentation_to_rle(seg, hw)
            r_want = want.segmentation_to_rle(seg, hw)
            assert (r_got.h, r_got.w) == (r_want.h, r_want.w)
            np.testing.assert_array_equal(r_got.counts, r_want.counts)
    # crowd regions in both RLE forms: compressed string and count list
    ex0, ex1 = got.example(0), got.example(1)
    assert isinstance(ex0["crowd_segmentations"][0]["counts"], str)
    assert isinstance(ex1["crowd_segmentations"][0]["counts"], list)
    for ex, (h, w) in zip((ex0, ex1), fixture_coco.IMAGE_SIZES[:2]):
        rle = got.segmentation_to_rle(ex["crowd_segmentations"][0], (h, w))
        assert rle.area() == (h // 4) * (w // 3)


def test_polygon_rasters_match_jax():
    poly = [[2.0, 3.0, 20.5, 3.0, 17.0, 15.2, 2.0, 11.0]]
    np.testing.assert_array_equal(
        tcoco.polygons_to_boxframe_mask(poly, [2.0, 3.0, 20.5, 15.2], 28),
        jcoco.polygons_to_boxframe_mask(poly, [2.0, 3.0, 20.5, 15.2], 28))
    np.testing.assert_array_equal(tcoco.CocoDataset.rasterize_full(poly, (30, 25)),
                                  jcoco.CocoDataset.rasterize_full(poly, (30, 25)))
    rle_seg = {"size": [4, 3], "counts": [1, 2, 9]}
    assert tcoco.CocoDataset.segmentation_to_rle(rle_seg, (4, 3)).area() == 2


def test_missing_cv2_raises_and_rle_needs_none(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError, match="polygon rasterization needs OpenCV"):
        tcoco.CocoDataset.rasterize_full([[0, 0, 5, 0, 5, 5]], (8, 8))
    rle = tcoco.CocoDataset.segmentation_to_rle({"size": [4, 3], "counts": "12"}, (4, 3))
    assert rle.counts.tolist() == [1, 2]


def test_voc_dataset_matches_jax(voc_root):
    got, want = tvoc.VocDataset(voc_root, "test"), jvoc.VocDataset(voc_root, "test")
    assert len(got) == len(want) and got.class_names == want.class_names
    for i in range(len(want)):
        assert_examples_equal(got.example(i), want.example(i))
        assert got.index_of(want.example(i)["image_id"]) == i
    assert got.example(1)["all_difficult"].any()


def examples(loader):
    """image id -> example, and the number of batch slots: the workers'
    arrival order decides which images share a batch."""
    out, slots = {}, 0
    for b in loader:
        for i, image_id in enumerate(b["_image_id"]):
            out[int(image_id)] = {k: v[i] for k, v in b.items()}
            slots += 1
    return out, slots


@pytest.mark.parametrize("extra", [[], ["data.orientation_buckets=true",
                                          "data.image_size=[128, 160]"]])
def test_eval_loader_matches_jax(monkeypatch, coco_root, extra):
    monkeypatch.setattr(tT, "resize_shortest_side", jT.resize_shortest_side)
    overrides = SMALL + extra
    tcfg, jcfg = get_config(None, overrides), jax_get_config(None, overrides)
    got, slots = examples(tloader.Loader(
        tcoco.CocoDataset(coco_root, "val", with_masks=True), tcfg, train=False,
        num_workers=3))
    want, want_slots = examples(jloader.Loader(
        jcoco.CocoDataset(coco_root, "val", with_masks=True), jcfg, train=False,
        num_workers=3))
    assert set(got) == set(want) == set(range(len(fixture_coco.IMAGE_SIZES)))
    for image_id, w in want.items():
        assert_examples_equal(got[image_id], w)
    # 6 images, batch 4: the tail repeats its last example (with buckets: 4
    # landscape images, and 2 portrait ones padded to a batch)
    assert slots == want_slots == 8
    if extra:
        assert {w["image"].shape[:2] for w in got.values()} == {(128, 160), (160, 128)}


def test_train_loader_is_seeded_and_shards_are_disjoint(monkeypatch, coco_root):
    monkeypatch.setattr(tT, "resize_shortest_side", jT.resize_shortest_side)
    cfg = get_config(None, SMALL + ["train.batch_size=2"])
    jcfg = jax_get_config(None, SMALL + ["train.batch_size=2"])
    ds = tcoco.CocoDataset(coco_root, "val", with_masks=True)
    # one worker: the order is the seeded permutation's, as in JAX
    it = iter(tloader.Loader(ds, cfg, train=True, seed=3, num_workers=1))
    jit = iter(jloader.Loader(jcoco.CocoDataset(coco_root, "val", with_masks=True),
                              jcfg, train=True, seed=3, num_workers=1))
    for _ in range(4):  # past one epoch
        assert_examples_equal(next(it), next(jit))
    it.close()
    shards = [{int(i) for b in tloader.Loader(ds, cfg, train=False, num_workers=2,
                                              process_shard=(p, 2)) for i in b["_image_id"]}
              for p in (0, 1)]
    assert not shards[0] & shards[1]
    assert shards[0] | shards[1] == set(range(len(ds)))
    with pytest.raises(ValueError, match="does not divide"):
        tloader.Loader(ds, get_config(None, SMALL + ["train.batch_size=3"]),
                       process_shard=(0, 2))


def test_get_dataset(coco_root, voc_root):
    cfg = get_config(None, [f"data.root={coco_root}", "model.name=mask_rcnn"])
    ds = tloader.get_dataset(cfg, "val", train=False)
    assert isinstance(ds, tcoco.CocoDataset) and ds.with_masks
    cfg = get_config(None, [f"data.root={voc_root}", "data.dataset=voc"])
    assert isinstance(tloader.get_dataset(cfg, "test", train=False), tvoc.VocDataset)
    assert tloader.get_dataset(get_config(None, ["data.dataset=synthetic"]), "x", True) is None
    with pytest.raises(ValueError, match="unknown dataset"):
        tloader.get_dataset(get_config(None, ["data.dataset=kitti"]), "x", True)
