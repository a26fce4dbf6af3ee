"""The port's R-FCN (``detectron_tpu_torch/models/rfcn.py``) and PSRoIPool
(``ops/ps_roi_pool.py``) against the JAX package's, on the same inputs.

* ``ps_roi_pool`` for P in {3, 7} and S in {1, 2}, on seeded features and
  RoIs that are random, past the border, sub-cell and the whole map:
  within 1e-5 x max |JAX| (float32 sums in another order); its gradient
  (autograd: the gather's scatter) against ``jax.grad`` within the same.
* ResNet-50 with ``dilate_c5`` (every res5 3x3 dilated by 2, block 0's too,
  stride 16): c2..c5 within 1e-4 x max |JAX|.
* R-FCN R-50, fpn_channels=32, num_classes=5, 128x128, on JAX-initialised
  weights with every bias and frozen-BN statistic drawn at random, carried
  over by ``from_jax_params``, with the C4 trunk and with the a-trous C5:
  the trunk, the RPN outputs and ``box`` on the same RoIs within 1e-4 x
  their magnitude; ``predict_fn`` against ``rfcn_eval_forward``: equal
  valid slots and classes, boxes within 1e-3, scores within 1e-5.
* bf16 (JAX at ``rpn.exact_topk=true``): the trunk within 3e-2 of its
  magnitude (``tests/test_torch_bf16.py``'s level limit), the float32 vote
  on the same RoIs within the same, and at least 60% of JAX's detections
  found in the port's (same class, IoU >= 0.5).
* The merged table equals two separate pools (``tests/test_rfcn.py``'s
  check); both configs' builds of ``configs/rfcn_r50_coco.yaml``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.config import get_config as jax_get_config
from detectron_tpu.models import rfcn as jrfcn
from detectron_tpu.models.resnet import ResNet as JaxResNet
from detectron_tpu.models.zoo import build_detector as jax_build_detector
from detectron_tpu.ops.ps_roi_pool import ps_roi_pool as jax_ps_roi_pool
from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.models import rfcn as trfcn
from detectron_tpu_torch.models.resnet import ResNet
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.ops.boxes import bbox_overlaps
from detectron_tpu_torch.ops.ps_roi_pool import ps_roi_pool
from detectron_tpu_torch.utils.weights import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["model.name=rfcn", "model.num_classes=5", "model.fpn_channels=32",
        "data.image_size=[128, 128]", "rpn.pre_nms_topk_test=200",
        "rpn.post_nms_topk_test=50", "test.detections_per_image=20"]
CANVAS = (128, 128)
LEVEL_LIMIT = 3e-2  # tests/test_torch_bf16.py's


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def assert_close_to(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def perturbed(variables, seed):
    """JAX variables as numpy, with every bias, BN affine and statistic
    drawn at random."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            v = np.asarray(v, np.float32)
            if k == "running_var":
                v = 1.0 + 0.2 * rng.rand(*v.shape)
            elif k in ("running_mean", "bias"):
                v = v + 0.1 * rng.randn(*v.shape)
            elif k == "weight":
                v = 1.0 + 0.1 * rng.randn(*v.shape)
            out[k] = v.astype(np.float32)
        return out

    return walk(jax.tree_util.tree_map(np.asarray, variables))


def pool_rois(rng, b, r, hw, stride):
    """Random RoIs, then past the border, sub-cell and the whole map."""
    h, w = hw[0] * stride, hw[1] * stride
    xy = rng.uniform([-20, -20], [w, h], size=(b, r, 2))
    wh = np.exp(rng.uniform(np.log(2), np.log(max(h, w)), size=(b, r, 2)))
    rois = np.concatenate([xy, xy + wh], -1)
    rois[:, 0] = [-40.0, -30.0, w + 25.0, h + 40.0]  # past every border
    rois[:, 1] = [w - 40.0, h - 44.0, w + 30.0, h + 36.0]  # half outside
    rois[:, 2] = [17.3, 21.1, 19.0, 23.4]  # sub-cell
    rois[:, 3] = [0.0, 0.0, float(w), float(h)]  # the whole map
    return rois.astype(np.float32)


@pytest.mark.parametrize("p,s", [(3, 1), (3, 2), (7, 1), (7, 2)])
def test_ps_roi_pool_matches_jax(p, s):
    rng = np.random.RandomState(p * 10 + s)
    k, hw, stride = 3, (12, 14), 16
    feat = rng.randn(2, *hw, p * p * k).astype(np.float32)
    rois = pool_rois(rng, 2, 24, hw, stride)
    want = np.asarray(jax_ps_roi_pool(jnp.asarray(feat), jnp.asarray(rois), stride, p, s))
    got = ps_roi_pool(torch.tensor(feat), torch.tensor(rois), stride, p, s)
    assert got.shape == (2, 24, p, p, k) and got.dtype == torch.float32
    assert_close_to(got.numpy(), want, 1e-5)
    # the RoI half past the border reads the map where its samples are in
    assert np.abs(want[:, 1]).max() > 0


@pytest.mark.parametrize("p,s", [(3, 2), (7, 2)])
def test_ps_roi_pool_gradient_matches_jax(p, s):
    rng = np.random.RandomState(p + s)
    k, hw, stride = 4, (10, 13), 16
    feat = rng.randn(2, *hw, p * p * k).astype(np.float32)
    rois = pool_rois(rng, 2, 20, hw, stride)
    g = rng.randn(2, 20, p, p, k).astype(np.float32)
    want = jax.grad(lambda f: jnp.sum(
        jax_ps_roi_pool(f, jnp.asarray(rois), stride, p, s) * g))(jnp.asarray(feat))
    tf = torch.tensor(feat, requires_grad=True)
    (ps_roi_pool(tf, torch.tensor(rois), stride, p, s) * torch.tensor(g)).sum().backward()
    assert_close_to(tf.grad.numpy(), want, 1e-5)


def test_ps_roi_pool_refuses_channels_not_a_multiple_of_p2():
    with pytest.raises(ValueError, match="P\\*P"):
        ps_roi_pool(torch.zeros(1, 4, 4, 10), torch.zeros(1, 1, 4), 16, 3)


def test_dilated_resnet_c5_matches_jax():
    jnet = JaxResNet(depth="resnet50", dilate_c5=True)
    images = np.random.RandomState(3).randn(1, 64, 96, 3).astype(np.float32)
    variables = perturbed(jnet.init(jax.random.PRNGKey(0), jnp.asarray(images)), 4)
    want = jnet.apply(variables, jnp.asarray(images))
    net = ResNet("resnet50", dilate_c5=True)
    sd = from_jax_params({"backbone": variables["params"]})
    net.load_state_dict({k.removeprefix("backbone."): v for k, v in sd.items()})
    with torch.no_grad():
        got = net(torch.tensor(images).permute(0, 3, 1, 2))
    assert np.asarray(want["c5"]).shape == (1, 4, 6, 2048)  # stride 16
    for name in ("c2", "c3", "c4", "c5"):
        assert_close_to(got[name].permute(0, 2, 3, 1).numpy(), want[name], 1e-4)


@pytest.fixture(scope="module", params=[False, True], ids=["c4", "dilated_c5"])
def rfcn(request):
    overrides = BASE + [f"model.dilate_c5={str(request.param).lower()}"]
    jcfg = jax_get_config(None, overrides)
    jdet = jax_build_detector(jcfg)
    variables = perturbed(jdet.init(jax.random.PRNGKey(0), CANVAS), 1)
    tdet = build_detector(get_config(None, overrides), device="cpu")
    params = from_jax_params(variables, tdet.module)
    tdet.module.load_state_dict(params)
    rng = np.random.RandomState(2)
    batch = {"image": rng.randn(2, *CANVAS, 3).astype(np.float32),
             "image_hw": np.array([[128, 128], [112, 96]], np.float32)}
    rois = pool_rois(rng, 2, 16, (8, 8), 16)
    m = jdet.module
    images = jnp.asarray(batch["image"])
    feat = m.apply(variables, images, method=m.features)
    scores, deltas = m.apply(variables, feat, method=m.rpn)
    cls_logits, reg = m.apply(variables, feat, jnp.asarray(rois), method=m.box)
    j_dets, j_masks = jax.jit(jdet.predict_fn)(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        t_feat = tdet.module.features(torch.tensor(batch["image"]))
        t_scores, t_deltas = tdet.module.rpn(t_feat)
        t_cls, t_reg = tdet.module.box(t_feat, torch.tensor(rois))
    return dict(tdet=tdet, params=params, batch=batch, rois=rois, feat=feat, scores=scores,
                deltas=deltas, cls_logits=cls_logits, reg=reg, j_dets=j_dets,
                j_masks=j_masks, t_feat=t_feat, t_scores=t_scores, t_deltas=t_deltas,
                t_cls=t_cls, t_reg=t_reg, dilate=request.param)


def test_trunk_rpn_and_box_match_jax(rfcn):
    assert rfcn["t_feat"].shape == (2, 32, 8, 8)  # stride 16 either way
    assert_close_to(rfcn["t_feat"].permute(0, 2, 3, 1).numpy(), rfcn["feat"], 1e-4)
    assert len(rfcn["t_scores"]) == len(rfcn["scores"]) == 1
    assert rfcn["t_scores"][0].shape == (2, 8 * 8 * 9)
    assert_close_to(rfcn["t_scores"][0].numpy(), rfcn["scores"][0], 1e-4)
    assert_close_to(rfcn["t_deltas"][0].numpy(), rfcn["deltas"][0], 1e-4)
    assert rfcn["t_cls"].shape == (2, 16, 5) and rfcn["t_reg"].shape == (2, 16, 1, 4)
    assert rfcn["t_cls"].dtype == rfcn["t_reg"].dtype == torch.float32
    assert_close_to(rfcn["t_cls"].numpy(), rfcn["cls_logits"], 1e-4)
    assert_close_to(rfcn["t_reg"].numpy(), rfcn["reg"], 1e-4)


def test_predict_fn_matches_rfcn_eval_forward(rfcn):
    dets, masks = rfcn["tdet"].predict_fn(rfcn["params"], rfcn["batch"])
    want = rfcn["j_dets"]
    assert masks is None and rfcn["j_masks"] is None
    assert dets.boxes.shape == (2, 20, 4) and int(dets.valid.sum()) > 0
    np.testing.assert_array_equal(dets.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(dets.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(dets.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-3)
    np.testing.assert_allclose(dets.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-5)


def test_merged_table_equals_two_pools(rfcn):
    """One pool over the group-major merged table equals pooling the class
    map and the box map apart (pooling is per channel)."""
    m, feat = rfcn["tdet"].module, rfcn["t_feat"]
    rois = torch.tensor(rfcn["rois"])
    p, s = m.pool, m.cfg.roi.sampling_ratio
    with torch.no_grad():
        cls_map = m.ps_cls(feat).float().permute(0, 2, 3, 1).contiguous()
        box_map = m.ps_box(feat).float().permute(0, 2, 3, 1).contiguous()
        ref_cls = ps_roi_pool(cls_map, rois, trfcn.RFCN_STRIDE, p, s).mean(dim=(2, 3))
        ref_reg = ps_roi_pool(box_map, rois, trfcn.RFCN_STRIDE, p, s).mean(dim=(2, 3))
    torch.testing.assert_close(rfcn["t_cls"], ref_cls, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(rfcn["t_reg"][:, :, 0], ref_reg, rtol=1e-6, atol=1e-6)


def test_anchors_are_one_level_of_jax_anchors():
    cfg = get_config(None, BASE)
    got = trfcn.rfcn_anchor_generator(cfg).grid_anchors(CANVAS)
    want = jrfcn.rfcn_anchor_generator(jax_get_config(None, BASE)).grid_anchors(CANVAS)
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))


def det_match_rate(want, got) -> float:
    """The share of ``want``'s valid detections that ``got`` has: same image
    and class, IoU >= 0.5."""
    found = total = 0
    for i in range(want.valid.shape[0]):
        wv, gv = np.asarray(want.valid[i]), got.valid[i].numpy()
        wb, gb = torch.tensor(np.asarray(want.boxes[i])[wv]), got.boxes[i][gv]
        wc, gc = np.asarray(want.classes[i])[wv], got.classes[i].numpy()[gv]
        total += len(wb)
        for j in range(len(wb)):
            same = (bbox_overlaps(wb[j:j + 1], gb)[0] >= 0.5).numpy() if len(gb) else []
            found += bool(np.any(np.asarray(same) & (gc == wc[j])))
    return found / total


def test_bf16_predict_matches_jax_as_sets():
    overrides = BASE + ["model.dtype=bfloat16"]
    jdet = jax_build_detector(jax_get_config(None, overrides + ["rpn.exact_topk=true"]))
    variables = jax.tree_util.tree_map(np.asarray, jdet.init(jax.random.PRNGKey(0), CANVAS))
    tdet = build_detector(get_config(None, overrides), device="cpu")
    params = from_jax_params(variables, tdet.module)
    tdet.module.load_state_dict(params)
    assert all(v.dtype == torch.float32 for v in params.values())
    rng = np.random.RandomState(5)
    batch = {"image": rng.randn(2, *CANVAS, 3).astype(np.float32),
             "image_hw": np.array([[128, 128], [112, 96]], np.float32)}
    rois = pool_rois(rng, 2, 16, (8, 8), 16)
    m = jdet.module
    feat = m.apply(variables, jnp.asarray(batch["image"]), method=m.features)
    cls_logits, reg = m.apply(variables, feat, jnp.asarray(rois), method=m.box)
    want, _ = jax.jit(jdet.predict_fn)(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        t_feat = tdet.module.features(torch.tensor(batch["image"]))
        t_cls, t_reg = tdet.module.box(t_feat, torch.tensor(rois))
    assert t_feat.dtype == torch.bfloat16 and t_cls.dtype == torch.float32
    assert_close_to(t_feat.float().permute(0, 2, 3, 1).numpy(), np.asarray(feat, np.float32),
                    LEVEL_LIMIT)
    assert_close_to(t_cls.numpy(), cls_logits, LEVEL_LIMIT)
    assert_close_to(t_reg.numpy(), reg, LEVEL_LIMIT)
    dets, masks = tdet.predict_fn(params, batch)
    assert masks is None and dets.boxes.dtype == torch.float32
    assert int(np.asarray(want.valid).sum()) > 0 and int(dets.valid.sum()) > 0
    assert det_match_rate(want, dets) >= 0.6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rfcn_config_builds(dtype):
    cfg = get_config(os.path.join(REPO, "configs", "rfcn_r50_coco.yaml"),
                     [f"model.dtype={dtype}"])
    det = build_detector(cfg, device="cpu")
    m = det.module
    assert isinstance(m, trfcn.RFCN) and det.dtype == getattr(torch, dtype)
    assert m.trunk.out_channels == 1024 and m.trunk.in_channels == 1024
    assert m.ps_cls.out_channels == 7 * 7 * 81 and m.ps_box.out_channels == 7 * 7 * 4
    assert m.rpn_head.objectness.out_channels == 9
    assert all(p.dtype == torch.float32 for p in m.parameters())
