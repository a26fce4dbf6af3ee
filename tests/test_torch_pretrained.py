"""The port's pretrained-weights import (``utils/torch_weights.py``,
``model.weights``) against the JAX package's ``utils/torch_weights.py``.

Nothing is downloaded: the tests write, from a numpy seed, a
torchvision-named ResNet-50 backbone state dict (``fc.*`` and
``num_batches_tracked`` included, as torchvision's has them) and a full
Mask R-CNN state dict in the lineage's names (``module.`` prefixes,
``fpn_inner``/``fpn_output``, ``rpn_conv`` and a ``2A``-channel softmax
``rpn_cls_score``, ``fc6``/``fc7``, ``mask_fcn1..4``, a ``ConvTranspose2d``
``conv5_mask`` and ``K+1``-channel ``mask_fcn_logits``), saved as ``.pth``
(``torch.save``, wrapped in ``{"state_dict": ...}``) and as ``.npz``.

* ``maybe_load_pretrained`` of the port equals ``from_jax_params`` of the
  JAX package's, bit for bit, for the backbone dict on Mask R-CNN, R-FCN
  and RetinaNet, and for the full dict on Mask R-CNN, from both files.
* The layouts: the deconv weight goes in as it is (the JAX import's flip
  and ``from_jax_params``' flip cancel), fc1 is the CHW -> HWC permute,
  the RPN classifier ``fg - bg``, the mask logits without channel 0.
* Unknown keys, a full R-FCN dict (its trunk and PS maps have no rule), a
  key the model lacks and a shape that does not fit raise as in JAX.
* Both drivers read ``model.weights``.
"""

import copy

import numpy as np
import pytest
import torch

import jax
from detectron_tpu.config import get_config as jax_get_config
from detectron_tpu.models.zoo import build_detector as jax_build_detector
from detectron_tpu.utils import torch_weights as jtw
from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.eval import driver as eval_driver
from detectron_tpu_torch.models.resnet import ResNet
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.train import driver as train_driver
from detectron_tpu_torch.utils import torch_weights as ttw
from detectron_tpu_torch.utils.weights import from_jax_params
from tests import fixture_coco

SMALL = ["model.num_classes=4", "model.fpn_channels=32", "data.image_size=[128, 128]"]
MODELS = {"mask_rcnn": [], "rfcn": [], "retinanet": []}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def torchvision_name(key: str) -> str:
    return (key.replace("downsample_conv", "downsample.0")
            .replace("downsample_bn", "downsample.1"))


def backbone_dict(seed=0) -> dict:
    """A torchvision-named ResNet-50 state dict with seeded values."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, value in ResNet("resnet50").state_dict().items():
        out[torchvision_name(key)] = torch.tensor(
            rng.randn(*value.shape).astype(np.float32) * 0.05 + (1.0 if key.endswith(
                "running_var") else 0.0))
        if key.endswith("running_var"):
            out[torchvision_name(key).replace("running_var", "num_batches_tracked")] = (
                torch.tensor(7))
    out["fc.weight"] = torch.zeros(1000, 2048)
    out["fc.bias"] = torch.zeros(1000)
    return out


def detector_dict(seed=1, k=4, c=32, a=3) -> dict:
    """A full Mask R-CNN state dict in the lineage's names, for ``k``
    classes (background included) and FPN width ``c``."""
    rng = np.random.RandomState(seed)

    def w(*shape):
        return torch.tensor(rng.randn(*shape).astype(np.float32) * 0.05)

    out = {f"backbone.{n}": v for n, v in backbone_dict(seed).items()}
    for lvl, cin in zip(range(2, 6), (256, 512, 1024, 2048)):
        out.update({f"fpn.fpn_inner{lvl}.weight": w(c, cin, 1, 1), f"fpn.fpn_inner{lvl}.bias": w(c),
                    f"fpn.fpn_output{lvl}.weight": w(c, c, 3, 3), f"fpn.fpn_output{lvl}.bias": w(c)})
    out.update({"rpn_conv.weight": w(c, c, 3, 3), "rpn_conv.bias": w(c),
                "rpn_cls_score.weight": w(2 * a, c, 1, 1), "rpn_cls_score.bias": w(2 * a),
                "rpn_bbox_pred.weight": w(4 * a, c, 1, 1), "rpn_bbox_pred.bias": w(4 * a),
                "fc6.weight": w(1024, c * 7 * 7), "fc6.bias": w(1024),
                "fc7.weight": w(1024, 1024), "fc7.bias": w(1024),
                "cls_score.weight": w(k, 1024), "cls_score.bias": w(k),
                "bbox_pred.weight": w(4 * k, 1024), "bbox_pred.bias": w(4 * k),
                "conv5_mask.weight": w(256, 256, 2, 2), "conv5_mask.bias": w(256),
                "mask_fcn_logits.weight": w(k, 256, 1, 1), "mask_fcn_logits.bias": w(k)})
    for i in range(1, 5):
        out.update({f"mask_fcn{i}.weight": w(256, c if i == 1 else 256, 3, 3),
                    f"mask_fcn{i}.bias": w(256)})
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("weights")
    paths = {}
    for name, sd in (("backbone", backbone_dict()), ("detector", detector_dict())):
        paths[f"{name}.pth"] = str(root / f"{name}.pth")
        torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
                   paths[f"{name}.pth"])
        paths[f"{name}.npz"] = str(root / f"{name}.npz")
        np.savez(paths[f"{name}.npz"], **{k: v.numpy() for k, v in sd.items()})
    return paths


@pytest.fixture(scope="module")
def models():
    """Per model: the JAX config, JAX params, the port's config and params."""
    out = {}
    for name in MODELS:
        overrides = SMALL + [f"model.name={name}"]
        jcfg = jax_get_config(None, overrides)
        jparams = jax.tree_util.tree_map(
            np.asarray, jax_build_detector(jcfg).init(jax.random.PRNGKey(0), (128, 128)))
        tdet = build_detector(get_config(None, overrides), device="cpu")
        out[name] = (jcfg, jparams, tdet, from_jax_params(jparams, tdet.module))
    return out


def with_weights(cfg, path):
    cfg = copy.deepcopy(cfg)
    cfg.model.weights = path
    return cfg


def assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == torch.float32, key
        assert torch.equal(got[key], value), key


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("ext", ["pth", "npz"])
def test_backbone_dict_loads_as_jax_does(models, files, name, ext):
    jcfg, jparams, tdet, tparams = models[name]
    path = files[f"backbone.{ext}"]
    want = from_jax_params(jtw.maybe_load_pretrained(with_weights(jcfg, path), jparams),
                           tdet.module)
    got = ttw.maybe_load_pretrained(with_weights(tdet.cfg, path), tparams)
    assert_same(got, want)
    src = backbone_dict()
    assert torch.equal(got["backbone.layer4.0.downsample_conv.weight"],
                       src["layer4.0.downsample.0.weight"])
    assert torch.equal(got["backbone.bn1.running_var"], src["bn1.running_var"])
    # the rest is the model's own
    head = "head.cls_score.weight" if name == "retinanet" else "rpn_head.conv.weight"
    assert torch.equal(got[head], tparams[head])


@pytest.mark.parametrize("ext", ["pth", "npz"])
def test_detector_dict_loads_as_jax_does(models, files, ext):
    jcfg, jparams, tdet, tparams = models["mask_rcnn"]
    path = files[f"detector.{ext}"]
    want = from_jax_params(jtw.maybe_load_pretrained(with_weights(jcfg, path), jparams),
                           tdet.module)
    got = ttw.maybe_load_pretrained(with_weights(tdet.cfg, path), tparams)
    assert_same(got, want)
    src = detector_dict()
    # a torch ConvTranspose2d weight goes in as it is: the JAX import's
    # flip and from_jax_params' flip cancel
    assert torch.equal(got["mask_head.deconv.weight"], src["conv5_mask.weight"])
    assert torch.equal(got["mask_head.mask_logits.weight"], src["mask_fcn_logits.weight"][1:])
    bg, fg = src["rpn_cls_score.weight"].chunk(2)
    assert torch.equal(got["rpn_head.objectness.weight"], fg - bg)
    fc6 = src["fc6.weight"].reshape(1024, 32, 7, 7).permute(0, 2, 3, 1).reshape(1024, -1)
    assert torch.equal(got["box_head.fc1.weight"], fc6)
    assert torch.equal(got["fpn.smooth3.bias"], src["fpn.fpn_output3.bias"])


def test_no_weights_leaves_params_alone(models):
    _, _, tdet, tparams = models["rfcn"]
    assert ttw.maybe_load_pretrained(tdet.cfg, tparams) is tparams


def test_load_pth_unwraps_and_strips_module(files):
    sd = ttw.load_pth(files["backbone.pth"])
    assert "conv1.weight" in sd and not any(k.startswith("module.") for k in sd)
    assert set(sd) == set(jtw.load_pth(files["backbone.pth"]))


def bad_dicts(models):
    """(name, model, state dict) cases that both packages refuse."""
    rfcn_full = dict(backbone_dict())
    rfcn_full.update({"rpn_conv.weight": torch.zeros(32, 1024, 3, 3),
                      "trunk.weight": torch.zeros(32, 1024, 3, 3)})
    unknown = dict(backbone_dict(), **{"layer1.0.relu.weight": torch.zeros(1)})
    wrong_shape = dict(backbone_dict(), **{"conv1.weight": torch.zeros(64, 3, 5, 5)})
    rpn_shape = dict(detector_dict(), **{"rpn_cls_score.weight": torch.zeros(5, 32, 1, 1)})
    return [("rfcn", rfcn_full, KeyError), ("mask_rcnn", unknown, KeyError),
            ("mask_rcnn", wrong_shape, ValueError), ("retinanet", detector_dict(), KeyError),
            ("mask_rcnn", rpn_shape, ValueError)]


@pytest.mark.parametrize("case", range(5))
def test_refusals_match_jax(models, tmp_path, case):
    name, sd, error = bad_dicts(models)[case]
    jcfg, jparams, tdet, tparams = models[name]
    path = str(tmp_path / "bad.pth")
    torch.save(sd, path)
    with pytest.raises(error) as want:
        jtw.maybe_load_pretrained(with_weights(jcfg, path), jparams)
    with pytest.raises(error) as got:
        ttw.maybe_load_pretrained(with_weights(tdet.cfg, path), tparams)
    # the same message, but for the key's spelling (a flax path, a port key)
    # and the layout of a shape (HWIO there)
    got_msg, want_msg = got.value.args[0], want.value.args[0]
    assert got_msg.split(" ")[0] == want_msg.split(" ")[0]
    assert got_msg.endswith("not found in model") == want_msg.endswith("not found in model")


def test_train_driver_reads_model_weights(files, tmp_path, monkeypatch, capsys):
    seen = {}
    real = train_driver.create_train_state

    def spy(cfg, det, params=None):
        seen["params"] = {k: v.clone() for k, v in params.items()}
        return real(cfg, det, params)

    monkeypatch.setattr(train_driver, "create_train_state", spy)
    cfg = get_config(None, SMALL + ["model.name=rfcn", "data.dataset=synthetic",
                                    "train.batch_size=2", "train.max_steps=1",
                                    "train.log_every=1", f"output_dir={tmp_path}",
                                    f"model.weights={files['backbone.pth']}"])
    last = train_driver.run(cfg, device="cpu")
    assert np.isfinite(last["loss_total"])
    assert f"initialized from {files['backbone.pth']}" in capsys.readouterr().out
    src = backbone_dict()
    for key, value in src.items():
        port_key = ttw.torch_key_to_port_key(key)
        if port_key is not None:
            assert torch.equal(seen["params"][f"backbone.{port_key}"], value), key


def test_eval_driver_reads_model_weights(files, tmp_path_factory, tmp_path, capsys):
    coco_root = fixture_coco.make_fixture(str(tmp_path_factory.mktemp("coco")))
    cfg = get_config(None, SMALL + [
        "model.name=mask_rcnn", "data.dataset=coco", "data.val_split=val",
        f"data.root={coco_root}", "data.short_side=96", "data.max_size=128",
        "train.batch_size=2", "rpn.pre_nms_topk_test=128", "rpn.post_nms_topk_test=32",
        "test.detections_per_image=10", "data.num_workers=2", f"output_dir={tmp_path}",
        f"model.weights={files['detector.npz']}"])
    seen = {}
    det = build_detector(cfg, device="cpu")

    def predict(params, batch):
        seen.setdefault("params", params)
        return det.predict_fn(params, batch)

    res = eval_driver.run(cfg, restore=False, device="cpu", predict=predict)
    assert np.isfinite(res["AP"]) or res["AP"] is None
    assert f"initialized from {files['detector.npz']}" in capsys.readouterr().out
    src = detector_dict()
    assert torch.equal(seen["params"]["mask_head.deconv.weight"], src["conv5_mask.weight"])
    assert torch.equal(seen["params"]["backbone.conv1.weight"], src["backbone.conv1.weight"])
