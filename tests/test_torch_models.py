"""The port's backbone, FPN and heads against the JAX modules, on JAX-initialised
weights carried over by ``from_jax_params`` (with frozen-BN statistics and
biases made non-trivial so that their layouts are checked too).

Mask R-CNN R-50 at 128x128, fpn_channels=32. Tolerance: max |diff| <=
1e-4 * max |reference| + 1e-6, i.e. about 1e-4 relative: the two
frameworks sum convolutions in different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.config import get_config as jax_get_config
from detectron_tpu.models.zoo import build_detector as jax_build_detector
from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.utils.weights import from_jax_params

OVERRIDES = ["model.name=mask_rcnn", "model.num_classes=4", "model.fpn_channels=32",
             "data.image_size=[128, 128]"]
REL = 1e-4


def perturbed_variables(variables, seed):
    """JAX variables as numpy, with BN statistics/affines and all biases
    drawn at random (JAX initialises them to the identity / zero)."""
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
                v = 0.1 * rng.randn(*v.shape)
            elif k == "weight":
                v = 1.0 + 0.1 * rng.randn(*v.shape)
            out[k] = v.astype(np.float32)
        return out

    return walk(jax.tree_util.tree_map(np.asarray, variables))


@pytest.fixture(scope="module")
def models():
    jdet = jax_build_detector(jax_get_config(None, OVERRIDES))
    variables = perturbed_variables(jdet.init(jax.random.PRNGKey(0), (128, 128)), 1)
    tdet = build_detector(get_config(None, OVERRIDES), device="cpu")
    tdet.module.load_state_dict(from_jax_params(variables, tdet.module))
    images = np.random.RandomState(2).randn(2, 128, 128, 3).astype(np.float32)
    m = jdet.module
    levels = m.apply(variables, jnp.asarray(images), method=m.features)
    with torch.no_grad():
        t_levels = tdet.module.features(torch.tensor(images))
    return dict(jdet=jdet, variables=variables, tdet=tdet, images=images,
                levels=levels, t_levels=t_levels)


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max() + 1e-6, (err, np.abs(want).max())


def test_backbone_c2_c5(models):
    m = models["jdet"].module
    want = m.apply(models["variables"], jnp.asarray(models["images"]),
                   method=lambda mod, x: mod.body(x))
    with torch.no_grad():
        got = models["tdet"].module.backbone(
            torch.tensor(models["images"]).permute(0, 3, 1, 2))
    for name in ("c2", "c3", "c4", "c5"):
        assert_close(got[name].permute(0, 2, 3, 1).numpy(), want[name])


@pytest.mark.parametrize("level", range(5))
def test_fpn_p2_p6(models, level):
    assert_close(models["t_levels"][level].numpy(), models["levels"][level])


def test_rpn_logits_and_deltas(models):
    """(h, w, anchor) flatten order of the RPN outputs."""
    m = models["jdet"].module
    want_s, want_d = m.apply(models["variables"], models["levels"], method=m.rpn)
    with torch.no_grad():
        got_s, got_d = models["tdet"].module.rpn(models["t_levels"])
    for g, w in zip(got_s + got_d, want_s + want_d):
        assert_close(g.numpy(), w)


ROIS = np.array([[[10, 10, 60, 50], [0, 0, 120, 100], [30, 40, 90, 128],
                  [5, 70, 127, 90]]] * 2, np.float32)


def test_box_head_cls_and_reg(models):
    """HWC flatten of the pooled features into fc1."""
    m = models["jdet"].module
    want_c, want_r = m.apply(models["variables"], models["levels"], jnp.asarray(ROIS),
                             method=m.box)
    with torch.no_grad():
        got_c, got_r = models["tdet"].module.box(models["t_levels"], torch.tensor(ROIS))
    assert_close(got_c.numpy(), want_c)
    assert_close(got_r.numpy(), want_r)


def test_mask_logits(models):
    """The flipped 2x2 deconv kernel and the [B, R, 28, 28, K-1] layout."""
    m = models["jdet"].module
    want = m.apply(models["variables"], models["levels"], jnp.asarray(ROIS), method=m.mask)
    with torch.no_grad():
        got = models["tdet"].module.mask(models["t_levels"], torch.tensor(ROIS))
    assert got.shape == (2, 4, 28, 28, 3)
    assert_close(got.numpy(), want)


def test_from_jax_params_rejects_leftover_and_missing(models):
    variables = models["variables"]
    extra = {"params": dict(variables["params"])}
    extra["params"]["box_head"] = dict(extra["params"]["box_head"],
                                       extra_fc={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError):
        from_jax_params(extra, models["tdet"].module)
    missing = {"params": {k: v for k, v in variables["params"].items() if k != "fpn"}}
    with pytest.raises(KeyError):
        from_jax_params(missing, models["tdet"].module)
    with pytest.raises(KeyError):
        from_jax_params({"params": {"nope": {"kernel": np.zeros((1, 1), np.float32)}}})
