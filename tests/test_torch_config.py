"""The port's config (detectron_tpu_torch.config) against the JAX package's:
defaults, the YAML reader and the override rules must agree exactly."""

import glob
import os

import pytest
import yaml

from detectron_tpu import config as jcfg
from detectron_tpu_torch import config as tcfg
from detectron_tpu_torch.config import yaml_lite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def test_defaults_equal_jax():
    assert tcfg.base_config().to_dict() == jcfg.base_config().to_dict()


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_reader_equals_safe_load(path):
    with open(path) as f:
        text = f.read()
    assert yaml_lite.loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_cfg_from_file_equals_jax(path):
    assert tcfg.get_config(path).to_dict() == jcfg.get_config(path).to_dict()


YAML_CASES = [
    "a: 1\nb: -2\nc: 0x10\nd: 0o17\ne: 1_000\n",
    "f: 1.5\ng: .5\nh: 1e-3\ni: 1.0e-3\nj: -.inf\nk: 2.\n",
    "l: on\nm: Off\nn: yes\no: NO\np: true\nq: null\nr: ~\ns:\n",
    "t: 'quoted # not a comment'\nu: \"x\\ty\"\nv: plain text  # comment\n",
    "w: [1, 2.5, [3, 4], 'a,b', on]\nx: []\n",
    "# only comments\n\ntop:\n  mid:\n    leaf: 3\n  other: [1]\nnext: 2\n",
    "",
]


@pytest.mark.parametrize("text", YAML_CASES)
def test_yaml_reader_scalars_and_nesting(text):
    assert yaml_lite.loads(text) == yaml.safe_load(text)


OVERRIDES = [
    ["train.base_lr=1"],  # int into a float field
    ["model.num_classes=5", "data.image_size=[128, 256]"],
    ["model.fused_nms=on", "model.fused_roi_align=off"],  # strings stay text
    ["model.weights=123", "model.name=null"],
    ["model.remat=yes", "roi.window=0x10", "test.score_thresh=.5"],
    ["train.lr_decay_steps=[1, 2, 3]", "data.pixel_mean=[1.0, 2.0, 3.0]"],
]


@pytest.mark.parametrize("pairs", OVERRIDES, ids=lambda p: p[0])
def test_overrides_equal_jax(pairs):
    want = jcfg.cfg_from_list(pairs, jcfg.base_config()).to_dict()
    got = tcfg.cfg_from_list(pairs, tcfg.base_config()).to_dict()
    assert got == want
    assert _types(got) == _types(want)


def _types(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_types(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = type(v)
    return out


BAD_OVERRIDES = [
    (["train.base_lr=1e-3"], TypeError),  # YAML 1.1 reads it as a string
    (["model.num_classes=2.5"], TypeError),
    (["model.remat=1"], TypeError),
    (["model.nope=1"], KeyError),
    (["nope.x=1"], KeyError),
    (["model.name"], ValueError),
]


@pytest.mark.parametrize("pairs,exc", BAD_OVERRIDES, ids=lambda p: str(p))
def test_bad_overrides_raise_like_jax(pairs, exc):
    with pytest.raises(exc):
        jcfg.cfg_from_list(pairs, jcfg.base_config())
    with pytest.raises(exc):
        tcfg.cfg_from_list(pairs, tcfg.base_config())


def test_unknown_file_key_raises(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("model:\n  nope: 1\n")
    with pytest.raises(KeyError):
        tcfg.cfg_from_file(str(path))


def test_attrdict_access():
    cfg = tcfg.base_config()
    assert cfg.model.get("stem") == "conv" and cfg.get("nope", 3) == 3
    assert cfg["roi"]["pool_size"] == cfg.roi.pool_size == 7
    with pytest.raises(AttributeError):
        cfg.model.nope
