"""The GroupNorm-32 backbone (``model.norm=gn``) of the port against the JAX
package's, on the same (JAX-initialised) weights, inputs and draws.

* ResNet-50 ``norm="gn"`` at 64x64, GroupNorm scale and bias drawn at
  random: float32 levels within 1e-4 x max |level| of JAX's (measured
  5e-6) and every trainable parameter's gradient of a fixed random
  weighting of the levels within 1e-4 x its max |gradient| (measured
  1.1e-5). bf16 is held as an approximation of float32 as good as JAX's:
  the levels within 5e-2 x max |level| of JAX's bf16 ones (measured
  1.8-4.1%), and each no farther from JAX's float32 level than 1.5x JAX's
  own bf16 level is (measured 0.97-1.34x). The bf16 gradients of this
  random loss are ill-conditioned in both packages (JAX's lie 29% from its
  float32 ones, the port's 33%, median relative norms): each tensor's
  within 0.6 of JAX's bf16 one in relative norm (measured at most 0.47),
  and the port's median distance to the float32 gradients at most 1.25x
  JAX's (measured 1.12x).
* The stem's ``gn1`` is trainable under JAX's rule (it freezes "bn" names)
  and gets a zero gradient from the ``stop_gradient`` after the frozen
  stages; the port detaches there, and ``gn1`` stays put through a step.
* Mask R-CNN ``model.norm=gn`` (128x128, FPN 32): predict_fn as
  ``test_torch_detector.py`` holds the frozen-BN model (valid slots and
  classes equal, boxes within 1e-3, masks within 1e-4); one train_step as
  ``test_torch_train.py`` (losses within 1e-4 relative, parameters within
  1e-6 after the step). In bf16 the FPN levels as the backbone's above
  (measured 2.2-3.4% from JAX's bf16 levels, which lie 3.3-6.7% from
  JAX's float32 ones: GroupNorm rescales each group's bf16 rounding); at
  least 60% of
  JAX's detections found (``test_torch_bf16.py``) and the step's losses
  within 3e-2 relative (``test_torch_bf16_train.py``).
* The trainable set and the weight-decay set equal JAX's
  ``trainable_mask`` and ``weight_decay_mask`` (GroupNorm's scale is not
  decayed); for every config in ``configs/`` the decay set is what it was
  before GroupNorm: every trainable ``.weight``.
* ``from_jax_params`` maps GroupNorm's ``scale`` to ``weight``; a
  torchvision backbone (frozen-BN names) into a GroupNorm detector fails
  in both packages with the same error.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.config import get_config as jax_get_config
from detectron_tpu.data.synthetic import make_batch
from detectron_tpu.models.resnet import ResNet as JaxResNet
from detectron_tpu.models.zoo import build_detector as jax_build_detector
from detectron_tpu.train import state as jax_state
from detectron_tpu.utils import torch_weights as jax_torch_weights
from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.models.resnet import GroupNorm, ResNet
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.train import state as tstate
from detectron_tpu_torch.utils import torch_weights
from detectron_tpu_torch.utils.weights import from_jax_params
from tests.test_torch_bf16 import det_match_rate
from tests.test_torch_train import OVERRIDES as TRAIN_OVERRIDES
from tests.test_torch_train import jax_draws, numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GN = ["model.norm=gn"]
PREDICT = ["model.name=mask_rcnn", "model.num_classes=4", "model.fpn_channels=32",
           "data.image_size=[128, 128]", "rpn.pre_nms_topk_test=128",
           "rpn.post_nms_topk_test=32", "test.detections_per_image=10"] + GN
F32_REL = 1e-4
BF16_LEVELS = 5e-2
BF16_AS_GOOD = 1.5  # the port's bf16 error from float32 against JAX's
BF16_GRAD = 0.6
BF16_GRAD_AS_GOOD = 1.25


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def gn_perturbed(tree, rng):
    """GroupNorm scale and bias (and every other bias) drawn at random: JAX
    initialises them to 1 and 0."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = gn_perturbed(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k == "scale":
            v = 1.0 + 0.1 * rng.randn(*v.shape)
        elif k == "bias":
            v = 0.1 * rng.randn(*v.shape)
        out[k] = v.astype(np.float32)
    return out


def backbone_state(params):
    """A JAX ResNet's params -> the port's ResNet state dict."""
    sd = from_jax_params({"params": {"backbone": params}})
    return {k[len("backbone."):]: v for k, v in sd.items()}


def backbone_run(dtype: str):
    """Levels and gradients of ResNet-50 GN in both packages, for a fixed
    random weighting of the levels."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    jm = JaxResNet(norm="gn", frozen_stages=1, dtype=jdt)
    params = gn_perturbed(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]),
        np.random.RandomState(1))
    rng = np.random.RandomState(2)
    weights = {f"c{i}": rng.randn(2, 64 >> i, 64 >> i, 64 << i).astype(np.float32)
               for i in range(2, 6)}

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x))
        return sum(jnp.sum(out[k].astype(jnp.float32) * weights[k]) for k in out), out

    (_, feats), j_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    j_grads = backbone_state(numpy_tree(j_grads))
    tm = ResNet(norm="gn", frozen_stages=1, dtype=tdt)
    tm.load_state_dict(backbone_state(params))
    out = tm(torch.tensor(x).permute(0, 3, 1, 2))
    sum((out[k].float().permute(0, 2, 3, 1) * torch.tensor(weights[k])).sum()
        for k in out).backward()
    levels = {k: (out[k].detach().float().permute(0, 2, 3, 1).numpy(),
                  np.asarray(feats[k].astype(jnp.float32))) for k in out}
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad, j_grads[n])
             for n, p in tm.named_parameters() if p.requires_grad}
    return dict(module=tm, levels=levels, grads=grads, j_grads=j_grads,
                out_dtype={v.dtype for v in out.values()})


@pytest.fixture(scope="module")
def backbone():
    return {dtype: backbone_run(dtype) for dtype in ("float32", "bfloat16")}


def rel_norm(a, b, ref) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(ref))


def test_gn_module_follows_flax(backbone):
    m = backbone["float32"]["module"]
    assert isinstance(m.gn1, GroupNorm) and m.gn1.eps == 1e-6 and m.gn1.num_groups == 32
    names = {n.rsplit(".", 1)[0] for n, _ in m.named_parameters()}
    assert {"gn1", "layer1.0.gn1", "layer1.0.gn3", "layer1.0.downsample_gn"} <= names
    assert not any("bn" in n for n in names)
    assert not list(m.buffers())  # no running statistics
    assert backbone["bfloat16"]["out_dtype"] == {torch.bfloat16}
    assert {p.dtype for p in backbone["bfloat16"]["module"].parameters()} == {torch.float32}


def assert_bf16_levels(got, want, want32, name):
    """bf16 ``got`` against JAX's bf16 ``want`` and float32 ``want32``."""
    scale = np.abs(want32).max()
    assert np.abs(got - want).max() <= BF16_LEVELS * scale, name
    assert np.abs(got - want32).max() <= BF16_AS_GOOD * np.abs(want - want32).max(), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gn_backbone_levels_match_jax(backbone, dtype):
    for name, (got, want) in backbone[dtype]["levels"].items():
        assert got.shape == want.shape
        if dtype == "float32":
            assert np.abs(got - want).max() <= F32_REL * np.abs(want).max(), name
        else:
            assert_bf16_levels(got, want, backbone["float32"]["levels"][name][1], name)


def test_gn_backbone_gradients_match_jax_float32(backbone):
    grads = backbone["float32"]["grads"]
    assert len(grads) > 100
    for name, (got, want) in grads.items():
        scale = float(want.abs().max())
        if scale == 0.0:
            assert float(got.abs().max()) == 0.0, name
        else:
            assert float((got - want).abs().max()) <= F32_REL * scale, name


def test_gn_backbone_gradients_match_jax_bf16(backbone):
    f32, b16 = backbone["float32"]["grads"], backbone["bfloat16"]["grads"]
    ours, theirs = [], []
    for name, (got, want) in b16.items():
        ref = f32[name][1]
        if float(ref.abs().max()) == 0.0:
            assert float(got.abs().max()) == 0.0 == float(want.abs().max()), name
            continue
        assert rel_norm(got, want, ref) <= BF16_GRAD, name
        ours.append(rel_norm(got, ref, ref))
        theirs.append(rel_norm(want, ref, ref))
    assert np.median(ours) <= BF16_GRAD_AS_GOOD * np.median(theirs)


def test_stem_gn_is_trainable_and_gets_a_zero_gradient(backbone):
    m, j_grads = backbone["float32"]["module"], backbone["float32"]["j_grads"]
    assert m.gn1.weight.requires_grad and m.gn1.weight.grad is None
    assert float(j_grads["gn1.weight"].abs().max()) == 0.0
    assert float(j_grads["gn1.bias"].abs().max()) == 0.0
    assert not m.layer1[0].gn1.weight.requires_grad  # the frozen stage
    assert m.layer2[0].gn1.weight.grad is not None


def raised_variables(jdet, seed=0):
    variables = jax.tree_util.tree_map(np.asarray, jdet.init(jax.random.PRNGKey(seed),
                                                              (128, 128)))
    variables = {"params": gn_perturbed(variables["params"], np.random.RandomState(5))}
    bias = np.array(variables["params"]["box_head"]["cls_score"]["bias"])
    bias[[1, 3]] = 3.0
    variables["params"]["box_head"]["cls_score"]["bias"] = bias
    return variables


@pytest.fixture(scope="module")
def predict_run():
    rng = np.random.RandomState(0)
    batch = {"image": rng.randn(2, 128, 128, 3).astype(np.float32),
             "image_hw": np.array([[128, 128], [112, 96]], np.float32)}
    out = {}
    for dtype in ("float32", "bfloat16"):
        overrides = PREDICT + [f"model.dtype={dtype}"]
        jdet = jax_build_detector(jax_get_config(None, overrides))
        variables = raised_variables(jdet)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        j_dets, j_masks = jax.jit(jdet.predict_fn)(variables, jb)
        m = jdet.module
        levels = m.apply(variables, jb["image"], method=m.features)
        tdet = build_detector(get_config(None, overrides), device="cpu")
        params = from_jax_params(variables, tdet.module)
        t_dets, t_masks = tdet.predict_fn(params, batch)
        tdet.module.load_state_dict(params)
        with torch.no_grad():
            t_levels = tdet.module.features(torch.tensor(batch["image"]))
        out[dtype] = dict(j_dets=j_dets, j_masks=j_masks, t_dets=t_dets, t_masks=t_masks,
                          levels=[(a.float().numpy(), np.asarray(b.astype(jnp.float32)))
                                  for a, b in zip(t_levels, levels)])
    return out


def test_gn_predict_fn_matches_jax_float32(predict_run):
    r = predict_run["float32"]
    want, got = r["j_dets"], r["t_dets"]
    valid = np.asarray(want.valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-3)
    np.testing.assert_allclose(r["t_masks"].numpy(), np.asarray(r["j_masks"]), rtol=0,
                               atol=1e-4)
    for got_l, want_l in r["levels"]:
        assert np.abs(got_l - want_l).max() <= F32_REL * np.abs(want_l).max()


def test_gn_predict_fn_matches_jax_bf16(predict_run):
    r = predict_run["bfloat16"]
    for i, ((got_l, want_l), (_, want32)) in enumerate(zip(r["levels"],
                                                          predict_run["float32"]["levels"])):
        assert_bf16_levels(got_l, want_l, want32, f"P{i + 2}")
    dets, masks = r["t_dets"], r["t_masks"]
    assert dets.scores.dtype == masks.dtype == torch.bfloat16
    assert int(dets.valid.sum()) > 0
    assert float(masks.min()) >= 0.0 and float(masks.max()) <= 1.0
    assert det_match_rate(r["j_dets"], dets, score_step=False) >= 0.6


def gn_step(dtype: str):
    """One train step of GN Mask R-CNN in both packages from the same
    (perturbed) JAX weights, batch and draws."""
    overrides = TRAIN_OVERRIDES + GN + [f"model.dtype={dtype}"]
    jcfg = jax_get_config(None, overrides + (["rpn.exact_topk=true"]
                                             if dtype == "bfloat16" else []))
    jdet = jax_build_detector(jcfg)
    variables = {"params": gn_perturbed(numpy_tree(
        jdet.init(jax.random.PRNGKey(0), (128, 128))["params"]), np.random.RandomState(3))}
    batch = make_batch(np.random.RandomState(0), 2, (128, 128), 4, max_gt=8)
    jstate, tx, _ = jax_state.create_train_state(jcfg, variables)
    key0 = jax.random.PRNGKey(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def step(state):
        key = jax.random.fold_in(key0, state.step)
        (_, ld), grads = jax.value_and_grad(
            lambda p: jdet.loss_fn(p, jbatch, key), has_aux=True)(state.params)
        return jax_state.apply_gradients(state, grads, tx), ld

    jstate, j_losses = jax.jit(step)(jstate)
    tcfg = get_config(None, overrides)
    tdet = build_detector(tcfg, device="cpu")
    params0 = from_jax_params(variables, tdet.module)
    state = tstate.create_train_state(tcfg, tdet, params0)
    num_anchors = sum(a.shape[0] for a in tdet.module.anchors((128, 128), "cpu"))
    draws = jax_draws(key0, 0, num_anchors, tcfg.rpn.post_nms_topk_train + 8)
    t_losses = tstate.train_step(state, batch, draws)
    return dict(state=state, params0=params0, j_params=from_jax_params(
        numpy_tree(jstate.params)), jparams=variables["params"],
        j_losses={k: float(v) for k, v in j_losses.items()},
        t_losses={k: float(v) for k, v in t_losses.items()})


@pytest.fixture(scope="module")
def step_run():
    return gn_step("float32")


def test_gn_train_step_matches_jax_float32(step_run):
    want, got = step_run["j_losses"], step_run["t_losses"]
    assert set(want) == {"loss_rpn_cls", "loss_rpn_box", "loss_cls", "loss_box", "loss_mask"}
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=1e-4, err_msg=name)
    after = step_run["state"].params
    for name, value in step_run["j_params"].items():
        torch.testing.assert_close(after[name], value, rtol=0, atol=1e-6, msg=name)


def test_gn_train_step_matches_jax_bf16():
    r = gn_step("bfloat16")
    for name, value in r["j_losses"].items():
        assert np.isfinite(r["t_losses"][name])
        np.testing.assert_allclose(r["t_losses"][name], value, rtol=3e-2, err_msg=name)


def test_stem_gn_does_not_move_and_trainable_gn_does(step_run):
    after, before = step_run["state"].params, step_run["params0"]
    for key in ("backbone.gn1.weight", "backbone.gn1.bias"):
        assert torch.equal(after[key], before[key]), key
        assert torch.equal(step_run["j_params"][key], before[key]), key
    assert not torch.equal(after["backbone.layer2.0.gn1.weight"],
                           before["backbone.layer2.0.gn1.weight"])


def port_key_masks(jparams, mask_tree):
    """JAX leaf masks keyed by the port's state-dict names."""
    flat = {}

    def walk(p, m, path):
        for k in p:
            if isinstance(p[k], dict):
                walk(p[k], m[k], path + (k,))
            else:
                flat[path + (k,)] = bool(m[k])

    walk(jparams, mask_tree, ())
    keyed = {}
    for path, value in flat.items():
        tree = node = {}
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.zeros(np.asarray(_leaf(jparams, path)).shape, np.float32)
        keyed[next(iter(from_jax_params(tree)))] = value
    return keyed


def _leaf(tree, path):
    for part in path:
        tree = tree[part]
    return tree


def test_trainable_and_decay_sets_equal_the_jax_masks(step_run):
    jcfg = jax_get_config(None, TRAIN_OVERRIDES + GN)
    jparams = step_run["jparams"]
    trainable = port_key_masks(jparams, jax_state.trainable_mask(jparams,
                                                                  jcfg.model.frozen_stages))
    kernel = port_key_masks(jparams, jax_state.weight_decay_mask(jparams))
    module = step_run["state"].detector.module
    names = {id(p): n for n, p in module.named_parameters()}
    groups = step_run["state"].optimizer.param_groups
    decay = {names[id(p)] for p in groups[0]["params"]}
    no_decay = {names[id(p)] for p in groups[1]["params"]}
    assert {n for n, p in module.named_parameters() if p.requires_grad} == {
        k for k, t in trainable.items() if t}
    assert decay == {k for k in trainable if trainable[k] and kernel[k]}
    assert no_decay == {k for k in trainable if trainable[k] and not kernel[k]}
    assert "backbone.gn1.weight" in no_decay and "backbone.layer2.0.gn2.weight" in no_decay


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))),
                         ids=os.path.basename)
def test_decay_set_is_unchanged_for_every_config(path):
    """Before GroupNorm the port decayed every trainable ``.weight``; the
    conv / deconv / linear rule gives the same set for every shipped config."""
    module = build_detector(get_config(path), device="cpu").module
    trainable = {n for n, p in module.named_parameters() if p.requires_grad}
    assert trainable
    assert tstate.decayed_parameters(module) & trainable == {
        n for n in trainable if n.endswith(".weight")}


def test_from_jax_params_maps_a_gn_tree(step_run):
    jparams = step_run["jparams"]
    got = from_jax_params({"params": jparams}, step_run["state"].detector.module)
    blk = jparams["backbone"]["layer2_0"]
    np.testing.assert_array_equal(got["backbone.layer2.0.gn2.weight"].numpy(),
                                  blk["gn2"]["scale"])
    np.testing.assert_array_equal(got["backbone.layer2.0.downsample_gn.bias"].numpy(),
                                  blk["downsample_gn"]["bias"])
    np.testing.assert_array_equal(got["backbone.gn1.weight"].numpy(),
                                  jparams["backbone"]["gn1"]["scale"])


def test_torchvision_backbone_into_gn_fails_alike(step_run):
    """A torchvision ResNet (frozen-BN names) has no GroupNorm to fill: both
    packages raise ``KeyError`` naming the missing parameter."""
    sd = {"conv1.weight": np.zeros((64, 3, 7, 7), np.float32),
          "bn1.weight": np.ones(64, np.float32)}
    with pytest.raises(KeyError, match="not found in model") as j_err:
        jax_torch_weights.load_resnet_backbone(
            {"params": step_run["jparams"]}, {k: torch.tensor(v) for k, v in sd.items()})
    params = {k: v.clone() for k, v in step_run["params0"].items()}
    with pytest.raises(KeyError, match="not found in model") as t_err:
        torch_weights.load_resnet_backbone(params, {k: torch.tensor(v) for k, v in sd.items()})
    assert "bn1" in str(j_err.value) and "bn1" in str(t_err.value)
