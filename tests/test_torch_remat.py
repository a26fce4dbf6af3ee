"""``model.remat``: each bottleneck above the frozen stages runs under
``torch.utils.checkpoint`` (non-reentrant) while grad is enabled, as
``nn.remat`` wraps them in the JAX package.

As ``tests/test_models.py::test_resnet_remat_same_params_outputs_grads``
holds the JAX ResNet: the same state-dict keys, a bit-identical forward,
and gradients within 1e-4 x max |gradient| (the same arithmetic run
again in the backward pass; measured bit-identical). Against the JAX
package's own remat gradients (of a fixed random weighting of the levels,
where JAX's test takes their sum of squares), each tensor within 2e-3 in
relative norm: measured at most 7.3e-4, in stage 2, whose gradient crosses
the 13 later blocks with identity frozen BatchNorm (median 2e-6). A remat
``train_step`` of Mask R-CNN equals one without (losses and parameters
within 1e-6), and with ``frozen_stages=1`` the
first trainable block (``layer2.0``), whose input is the detached output
of the frozen stage, gets its gradient: the reentrant checkpoint would
give it none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from detectron_tpu.models.resnet import ResNet as JaxResNet
from detectron_tpu.data.synthetic import make_batch
from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.models import resnet as tresnet
from detectron_tpu_torch.models.resnet import ResNet
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.train import state as tstate
from tests.test_torch_gn import backbone_state
from tests.test_torch_train import OVERRIDES, numpy_tree

REL = 1e-4
JAX_REL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def backbones():
    """The JAX ResNet-50's weights in the port's ResNet with and without
    remat; each one's levels and gradients of a fixed random weighting of
    the levels (linear in them, so that the two packages' float32 sums
    differ by rounding alone), and JAX's remat gradients of the same."""
    x = np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32)
    rng = np.random.RandomState(1)
    weights = {f"c{i}": rng.randn(1, 64 >> i, 64 >> i, 64 << i).astype(np.float32)
               for i in range(2, 6)}
    jm = JaxResNet(depth="resnet50", remat=True)
    params = jm.init(jax.random.key(0), jnp.asarray(x))

    def loss(p):
        return sum(jnp.sum(f * weights[k]) for k, f in jm.apply(p, jnp.asarray(x)).items())

    j_grads = backbone_state(numpy_tree(jax.jit(jax.grad(loss))(params)["params"]))
    out = {"j_grads": j_grads}
    for remat in (False, True):
        m = ResNet("resnet50", frozen_stages=1, remat=remat)
        m.load_state_dict(backbone_state(numpy_tree(params["params"])))
        feats = m(torch.tensor(x).permute(0, 3, 1, 2))
        sum((f.permute(0, 2, 3, 1) * torch.tensor(weights[k])).sum()
            for k, f in feats.items()).backward()
        out[remat] = dict(module=m, feats=feats, grads={
            n: p.grad for n, p in m.named_parameters() if p.requires_grad})
    return out


def test_remat_keeps_the_state_dict(backbones):
    a, b = backbones[False]["module"].state_dict(), backbones[True]["module"].state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape for k in a)


def test_remat_forward_is_bit_identical(backbones):
    for name, got in backbones[True]["feats"].items():
        assert torch.equal(got, backbones[False]["feats"][name]), name


@pytest.mark.parametrize("against", ["port without remat", "jax remat"])
def test_remat_gradients_match(backbones, against):
    got = backbones[True]["grads"]
    want = (backbones[False]["grads"] if against == "port without remat"
            else {n: backbones["j_grads"][n] for n in got})
    assert set(got) == set(want) and len(got) == 3 * (4 + 6 + 3) + 3  # the convs of 2-4
    for name, g in got.items():
        assert g is not None, name
        if against == "port without remat":
            scale = float(want[name].abs().max())
            assert float((g - want[name]).abs().max()) <= REL * scale, name
        else:
            rel = torch.linalg.vector_norm(g - want[name]) / torch.linalg.vector_norm(want[name])
            assert float(rel) <= JAX_REL, name


def test_remat_wraps_the_trainable_stages_only(backbones, monkeypatch):
    """Stage 1 (frozen) runs plainly; every block of stages 2-4 runs under
    one non-reentrant checkpoint; nothing is wrapped under ``no_grad``."""
    calls = []

    def spy(fn, *args, **kwargs):
        calls.append((fn, kwargs.get("use_reentrant")))
        return checkpoint(fn, *args, **kwargs)

    monkeypatch.setattr(tresnet, "checkpoint", spy)
    m = backbones[True]["module"]
    x = torch.zeros(1, 3, 64, 64)
    m(x)
    blocks = [b for s in (2, 3, 4) for b in getattr(m, f"layer{s}")]
    assert [c[0] for c in calls] == blocks and {c[1] for c in calls} == {False}
    calls.clear()
    with torch.no_grad():
        m(x)
    assert not calls


def test_first_trainable_block_gets_its_gradient(backbones):
    grads = backbones[True]["grads"]
    for name in ("layer2.0.conv1.weight", "layer2.0.downsample_conv.weight"):
        assert grads[name] is not None and float(grads[name].abs().max()) > 0, name
    assert all(not p.requires_grad for p in backbones[True]["module"].layer1.parameters())
    # JAX's remat backbone: zero for the frozen stage (its stop_gradient)
    assert float(backbones["j_grads"]["layer1.0.conv2.weight"].abs().max()) == 0.0


def test_remat_train_step_equals_one_without():
    cfg = get_config(None, OVERRIDES)
    batch = make_batch(np.random.RandomState(0), 2, (128, 128), 4, max_gt=8)
    runs = {}
    for remat in (False, True):
        cfg.model.remat = remat
        det = build_detector(cfg, device="cpu")
        state = tstate.create_train_state(cfg, det, det.init(0))
        losses = tstate.train_step(state, batch)
        runs[remat] = ({k: float(v) for k, v in losses.items()}, state.params)
    (l0, p0), (l1, p1) = runs[False], runs[True]
    assert l0.keys() == l1.keys()
    for k in l0:
        np.testing.assert_allclose(l1[k], l0[k], rtol=1e-6, err_msg=k)
    for k in p0:
        torch.testing.assert_close(p1[k], p0[k], rtol=0, atol=1e-6, msg=k)
