"""The port's RetinaNet (``detectron_tpu_torch/models/retinanet.py``) against
the JAX package's, module by module, in float32.

RetinaNet R-50, fpn_channels=32, num_classes=5, weights made by the JAX
``Detector.init`` with every bias and frozen-BN statistic drawn at random
(JAX initialises them to zero / the identity), carried over by
``from_jax_params``.

* FPN P3-P7, the shared head and the whole forward, per level, on a
  128x128 canvas (every level even: flax's stride-2 ``"SAME"`` pads
  ``(0, 1)``) and on 160x224 (C5 5x7 and P6 3x4: the odd sides padded
  ``(1, 1)``): max |diff| <= 1e-5 x max |JAX level| (float32 convolutions
  summed in another order).
* ``retinanet_loss`` on the same head outputs: each loss within 1e-5
  relative, on a batch with padding gt rows and on a batch with no gt at
  all (``total_pos`` clamped to 1).
* ``retinanet_inference`` on the same planted head outputs (confident
  logits for a few anchors and classes among low ones): valid slots and
  classes equal, boxes within 1e-4, scores within 1e-6; with the default
  configuration, with ``merged_pre_nms_topk``, with exactly tied logits
  (the lower index first, as ``jax.lax.top_k``), and with no logit above
  the threshold (no detection).
* The port's p2p6 FPN and ``from_jax_params``' rules for RetinaNet's
  parameter tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.config import get_config as jax_get_config
from detectron_tpu.models import retinanet as jretina
from detectron_tpu.models.zoo import build_detector as jax_build_detector
from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.models import retinanet as tretina
from detectron_tpu_torch.models.fpn import FPN, pad_same_stride2
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.utils.weights import from_jax_params

BASE = ["model.name=retinanet", "model.num_classes=5", "model.fpn_channels=32",
        "retinanet.pre_nms_topk=100", "test.detections_per_image=20"]
CANVASES = ((128, 128), (160, 224))
REL = 1e-5
K = 4  # foreground classes
A = 9  # anchors a cell


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def overrides(canvas, extra=()):
    return BASE + [f"data.image_size=[{canvas[0]}, {canvas[1]}]", *extra]


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


@pytest.fixture(scope="module", params=CANVASES, ids=lambda c: f"{c[0]}x{c[1]}")
def forward(request):
    canvas = request.param
    jdet = jax_build_detector(jax_get_config(None, overrides(canvas)))
    variables = perturbed(jdet.init(jax.random.PRNGKey(0), canvas), 1)
    tdet = build_detector(get_config(None, overrides(canvas)), device="cpu")
    tdet.module.load_state_dict(from_jax_params(variables, tdet.module))
    images = np.random.RandomState(2).randn(2, *canvas, 3).astype(np.float32)
    outs, state = jdet.module.apply(variables, jnp.asarray(images),
                                    capture_intermediates=True, mutable=["intermediates"])
    levels = state["intermediates"]["fpn"]["__call__"][0]
    with torch.no_grad():
        t_levels = tdet.module.features(torch.tensor(images))
        t_outs = tdet.module.head_outputs(t_levels)
    return dict(canvas=canvas, levels=levels, outs=outs, t_levels=t_levels, t_outs=t_outs,
                tdet=tdet)


def assert_close_to(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def test_fpn_p3p7_levels(forward):
    h, w = forward["canvas"]
    sizes = [(-(-h // s), -(-w // s)) for s in tretina.RETINA_STRIDES]
    assert [tuple(np.asarray(lv).shape[1:3]) for lv in forward["levels"]] == sizes
    for want, got in zip(forward["levels"], forward["t_levels"]):
        assert_close_to(got.permute(0, 2, 3, 1).numpy(), want)


def test_head_outputs_per_level(forward):
    for (jc, jb), (tc, tb) in zip(forward["outs"], forward["t_outs"]):
        assert tc.shape[-1] == A * K and tb.shape[-1] == A * 4
        assert_close_to(tc.numpy(), jc)
        assert_close_to(tb.numpy(), jb)


def test_head_on_jax_levels_alone(forward):
    """The head by itself, on JAX's own levels (no backbone difference)."""
    with torch.no_grad():
        got = [forward["tdet"].module.head(torch.tensor(np.asarray(lv)).permute(0, 3, 1, 2))
               for lv in forward["levels"]]
    for (jc, jb), (tc, tb) in zip(forward["outs"], got):
        assert_close_to(tc.numpy(), jc)
        assert_close_to(tb.numpy(), jb)


@pytest.mark.parametrize("hw", [(4, 6), (5, 7), (3, 4), (2, 2), (1, 1)])
def test_stride2_padding_is_flax_same(hw):
    """A 3x3/2 conv after ``pad_same_stride2`` equals flax's ``"SAME"`` one."""
    import flax.linen as nn

    rng = np.random.RandomState(3)
    x = rng.randn(1, *hw, 3).astype(np.float32)
    conv = nn.Conv(2, (3, 3), strides=(2, 2), padding="SAME")
    params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(params, jnp.asarray(x)))
    kernel = torch.tensor(np.asarray(params["params"]["kernel"]).transpose(3, 2, 0, 1))
    got = torch.nn.functional.conv2d(pad_same_stride2(torch.tensor(x).permute(0, 3, 1, 2)),
                                     kernel, torch.tensor(np.asarray(params["params"]["bias"])),
                                     stride=2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-6)


def test_p2p6_fpn_keeps_its_parameters():
    """The two-stage FPN is unchanged: lateral2-5 and smooth2-5, no p6/p7."""
    fpn = FPN([256, 512, 1024, 2048], 32)
    assert sorted({k.split(".")[0] for k in fpn.state_dict()}) == [
        "lateral2", "lateral3", "lateral4", "lateral5", "smooth2", "smooth3", "smooth4",
        "smooth5"]
    retina = FPN([256, 512, 1024, 2048], 32, levels="p3p7")
    assert sorted({k.split(".")[0] for k in retina.state_dict()}) == [
        "lateral3", "lateral4", "lateral5", "p6", "p7", "smooth3", "smooth4", "smooth5"]
    with pytest.raises(ValueError, match="p4p8"):
        FPN([256, 512, 1024, 2048], 32, levels="p4p8")


def test_weights_drop_only_the_unread_p2_convs():
    jdet = jax_build_detector(jax_get_config(None, overrides((128, 128))))
    variables = jax.tree_util.tree_map(np.asarray, jdet.init(jax.random.PRNGKey(0),
                                                             (128, 128)))
    fpn = variables["params"]["fpn"]
    assert {"lateral2", "smooth2", "p6", "p7"} <= set(fpn)
    tdet = build_detector(get_config(None, overrides((128, 128))), device="cpu")
    params = from_jax_params(variables, tdet.module)
    assert not any(k.startswith(("fpn.lateral2", "fpn.smooth2")) for k in params)
    assert {"head.cls_score.weight", "head.box_pred.bias", "fpn.p6.weight",
            "fpn.p7.bias", "head.cls3.weight"} <= set(params)
    np.testing.assert_array_equal(params["head.cls0.weight"].numpy(),
                                  variables["params"]["head"]["cls0"]["kernel"]
                                  .transpose(3, 2, 0, 1))
    # a leftover key still raises
    extra = jax.tree_util.tree_map(lambda a: a, variables)
    extra["params"]["head"]["cls4"] = extra["params"]["head"]["cls3"]
    with pytest.raises(KeyError, match="leftover"):
        from_jax_params(extra, tdet.module)


def test_init_gives_the_prior_bias_and_small_prediction_weights():
    cfg = get_config(None, overrides((128, 128)))
    det = build_detector(cfg, device="cpu")
    params = det.init(0)
    prior = -np.log((1 - cfg.retinanet.prior_prob) / cfg.retinanet.prior_prob)
    np.testing.assert_allclose(params["head.cls_score.bias"].numpy(), prior, rtol=1e-6)
    assert float(params["head.box_pred.bias"].abs().max()) == 0.0
    for name in ("head.cls_score.weight", "head.box_pred.weight"):
        assert abs(float(params[name].std()) - 0.01) < 0.002, name
    # LeCun fan-in for the head convs and P6 (on C5: 2048 x 9 inputs)
    assert abs(float(params["fpn.p6.weight"].std()) - (1 / (2048 * 9)) ** 0.5) < 1e-3


# ----------------------------------------------------------- loss


def head_outputs(canvas, seed, b=2):
    rng = np.random.RandomState(seed)
    outs = []
    for s in tretina.RETINA_STRIDES:
        h, w = -(-canvas[0] // s), -(-canvas[1] // s)
        outs.append((rng.randn(b, h, w, A * K).astype(np.float32) - 2.0,
                     0.3 * rng.randn(b, h, w, A * 4).astype(np.float32)))
    return outs


def gt_batch(kind):
    boxes = np.zeros((2, 6, 4), np.float32)
    classes = np.zeros((2, 6), np.int32)
    if kind == "padded":
        boxes[0, :3] = [[10, 12, 60, 70], [64, 5, 120, 40], [30, 80, 50, 126]]
        classes[0, :3] = [1, 4, 2]
        boxes[1, :2] = [[0, 0, 128, 128], [40, 40, 47, 49]]
        classes[1, :2] = [3, 3]
    return boxes, classes


@pytest.mark.parametrize("kind", ["padded", "no gt"])
def test_retinanet_loss_equals_jax(kind):
    canvas = (128, 128)
    jcfg, tcfg = jax_get_config(None, overrides(canvas)), get_config(None, overrides(canvas))
    outs = head_outputs(canvas, 4)
    boxes, classes = gt_batch(kind)
    anchors = jretina.retinanet_anchor_generator(jcfg).all_anchors(canvas)
    want = jretina.retinanet_loss([(jnp.asarray(c), jnp.asarray(d)) for c, d in outs],
                                  anchors, jnp.asarray(boxes), jnp.asarray(classes),
                                  jax.random.PRNGKey(0), jcfg)
    got = tretina.retinanet_loss([(torch.tensor(c), torch.tensor(d)) for c, d in outs],
                                 torch.tensor(anchors), torch.tensor(boxes),
                                 torch.tensor(classes), tcfg)
    assert set(got) == set(want) == {"loss_cls", "loss_box"}
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5,
                                   err_msg=name)
    if kind == "no gt":
        assert float(got["loss_box"]) == 0.0 and float(got["loss_cls"]) > 0.0


# ------------------------------------------------------ inference


def planted_outputs(canvas, seed, kind):
    """Head outputs with low logits everywhere and confident ones planted
    at random (anchor, class) entries of every level; ``"ties"`` plants
    the same logit many times, ``"empty"`` plants none."""
    rng = np.random.RandomState(seed)
    outs = []
    for li, s in enumerate(tretina.RETINA_STRIDES):
        h, w = -(-canvas[0] // s), -(-canvas[1] // s)
        cls = (0.5 * rng.randn(2, h, w, A * K) - 6.0).astype(np.float32)
        if kind != "empty":
            n = max(cls[0].size // 40, 3)
            for i in range(2):
                flat = cls[i].reshape(-1)
                pick = rng.choice(flat.size, n, replace=False)
                flat[pick] = 3.0 if kind == "ties" else rng.uniform(-2.5, 4.0, n)
        box = (0.2 * rng.randn(2, h, w, A * 4)).astype(np.float32)
        outs.append((cls, box))
    return outs


@pytest.mark.parametrize("kind,extra", [
    ("default", ()),
    ("merged cap", ("retinanet.merged_pre_nms_topk=120",)),
    ("ties", ()),
    ("empty", ()),
    ("odd canvas", ()),
])
def test_retinanet_inference_equals_jax(kind, extra):
    canvas = (160, 224) if kind == "odd canvas" else (128, 128)
    jcfg = jax_get_config(None, overrides(canvas, extra))
    tcfg = get_config(None, overrides(canvas, extra))
    outs = planted_outputs(canvas, 5, kind)
    image_hw = np.array([canvas, (canvas[0] - 20, canvas[1] - 36)], np.float32)
    anchors = jretina.retinanet_anchor_generator(jcfg).grid_anchors(canvas)
    want = jretina.retinanet_inference([(jnp.asarray(c), jnp.asarray(d)) for c, d in outs],
                                       anchors, jnp.asarray(image_hw), jcfg)
    got = tretina.retinanet_inference([(torch.tensor(c), torch.tensor(d)) for c, d in outs],
                                      [torch.tensor(a) for a in anchors],
                                      torch.tensor(image_hw), tcfg)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-6)
    if kind == "empty":
        assert not valid.any()
    else:
        assert valid.sum() >= 10
    if kind == "ties":
        assert (got.scores[got.valid] == got.scores[got.valid][0]).all()


def test_candidates_count_and_merged_cap():
    """N = 5 x pre_nms_topk candidates an image (P7 holds fewer entries than
    the cut here, so it gives all it has), or the merged cap."""
    canvas = (128, 128)
    outs = [(torch.tensor(c), torch.tensor(d)) for c, d in planted_outputs(canvas, 6, "default")]
    image_hw = torch.tensor([canvas, canvas], dtype=torch.float32)
    for extra, want in (((), 4 * 100 + 36), (("retinanet.merged_pre_nms_topk=120",), 120)):
        cfg = get_config(None, overrides(canvas, extra))
        anchors = [torch.tensor(a) for a in
                   tretina.retinanet_anchor_generator(cfg).grid_anchors(canvas)]
        boxes, logits, classes = tretina.retinanet_candidates(outs, anchors, image_hw, cfg)
        assert boxes.shape == (2, want, 4) and boxes.dtype == torch.float32
        assert logits.shape == classes.shape == (2, want)
        assert int(classes.min()) >= 1 and int(classes.max()) <= K
