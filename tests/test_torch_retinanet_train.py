"""The port's RetinaNet training step against the JAX package's, on the same
(JAX-initialised) weights and batch.

Config: retinanet R-50, 128x128, num_classes=5, fpn_channels=32,
train.max_gt_boxes=8, train.grad_clip_norm=1.0 (optax's clip exercised),
batch 2 of ``make_batch``. RetinaNet samples nothing, so no draws pass
between the two.

* The JAX side is ``jax.value_and_grad(det.loss_fn)`` + ``apply_gradients``
  under one ``jit``. Per step both losses agree within 1e-4 relative.
* Each updated tensor's update (after - before) on the port within
  ``UPDATE_RTOL`` (3e-2, chip_smoke.py's phase 10 limit) of JAX's,
  relative in norm. JAX's FPN also holds ``lateral2`` / ``smooth2``,
  which only its unused P2 reads (their gradient is zero, weight decay
  shrinks them); the port has neither and they are not compared.
* Frozen parameters (stem, layer1) unchanged; every trainable one changed.
* The loss falls over four steps on one batch; in bf16 the parameters
  and gradients stay float32 and the stage marks come in order; the train
  driver runs two synthetic steps and writes a checkpoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import UPDATE_RTOL
from detectron_tpu.config import get_config as jax_get_config
from detectron_tpu.data.synthetic import make_batch
from detectron_tpu.models.zoo import build_detector as jax_build_detector
from detectron_tpu.train import state as jax_state
from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.train import checkpoint as ckpt
from detectron_tpu_torch.train import driver
from detectron_tpu_torch.train import state as tstate
from detectron_tpu_torch.utils.weights import from_jax_params

OVERRIDES = ["model.name=retinanet", "model.num_classes=5", "model.fpn_channels=32",
             "data.image_size=[128, 128]", "retinanet.pre_nms_topk=100",
             "train.batch_size=2", "train.max_gt_boxes=8", "train.grad_clip_norm=1.0"]
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def train_run():
    jcfg, tcfg = jax_get_config(None, OVERRIDES), get_config(None, OVERRIDES)
    jdet = jax_build_detector(jcfg)
    variables = jdet.init(jax.random.PRNGKey(0), (128, 128))
    batch = make_batch(np.random.RandomState(0), 2, (128, 128), 5, max_gt=8)
    jstate, tx, _ = jax_state.create_train_state(jcfg, variables)
    key0 = jax.random.PRNGKey(1)

    def step(state, jbatch):
        key = jax.random.fold_in(key0, state.step)
        (_, ld), grads = jax.value_and_grad(
            lambda p: jdet.loss_fn(p, jbatch, key), has_aux=True)(state.params)
        return jax_state.apply_gradients(state, grads, tx), ld

    jstep = jax.jit(step)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tdet = build_detector(tcfg, device="cpu")
    params0 = from_jax_params(numpy_tree(variables), tdet.module)
    tst = tstate.create_train_state(tcfg, tdet, {k: v.clone() for k, v in params0.items()})
    j_losses, t_losses = [], []
    for _ in range(STEPS):
        jstate, ld = jstep(jstate, jbatch)
        j_losses.append({k: float(v) for k, v in ld.items()})
        t_losses.append({k: float(v) for k, v in tstate.train_step(tst, batch).items()})
    return dict(params0=params0, j_losses=j_losses, t_losses=t_losses,
                j_params=from_jax_params(numpy_tree(jstate.params)), t_state=tst)


@pytest.mark.parametrize("step", range(STEPS))
def test_losses_match_jax(train_run, step):
    want, got = train_run["j_losses"][step], train_run["t_losses"][step]
    assert set(want) == {"loss_cls", "loss_box"}
    assert set(got) == set(want) | {"loss_total"}
    for name, value in want.items():
        assert np.isfinite(got[name])
        np.testing.assert_allclose(got[name], value, rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(got["loss_total"], sum(want.values()), rtol=1e-4)


def test_updates_match_jax(train_run):
    got, want, before = (train_run["t_state"].params, train_run["j_params"],
                         train_run["params0"])
    assert train_run["t_state"].step == STEPS
    assert set(want) - set(got) == set()  # the unread P2 convs are dropped on import
    worst = {}
    for name, value in got.items():
        upd_j = want[name] - before[name]
        if not float(upd_j.abs().max()):
            assert torch.equal(value, before[name]), name
            continue
        worst[name] = float(torch.linalg.vector_norm((value - before[name]) - upd_j)
                            / torch.linalg.vector_norm(upd_j))
    assert len(worst) > 50
    name = max(worst, key=worst.get)
    assert worst[name] <= UPDATE_RTOL, (name, worst[name])


def test_frozen_params_unchanged_and_trainable_changed(train_run):
    got, before = train_run["t_state"].params, train_run["params0"]
    module = train_run["t_state"].detector.module
    trainable = [n for n, p in module.named_parameters() if p.requires_grad]
    frozen = [n for n, p in module.named_parameters() if not p.requires_grad]
    assert frozen and all(n.startswith(("backbone.conv1.", "backbone.layer1.")) for n in frozen)
    assert any(n.startswith("head.") for n in trainable)
    assert any(n.startswith("fpn.p7.") for n in trainable)
    for name in frozen:
        assert torch.equal(got[name], before[name]), name
    for name in trainable:
        assert not torch.equal(got[name], before[name]), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_falls_and_stays_float32(dtype):
    cfg = get_config(None, OVERRIDES + [f"model.dtype={dtype}", "train.base_lr=0.005",
                                        "train.warmup_steps=0"])
    det = build_detector(cfg, device="cpu")
    state = tstate.create_train_state(cfg, det, det.init(0))
    batch = make_batch(np.random.RandomState(1), 2, (128, 128), 5, max_gt=8)
    marks, totals = [], []
    for _ in range(4):
        totals.append(float(tstate.train_step(state, batch, mark=marks.append)["loss_total"]))
    assert all(np.isfinite(totals)) and totals[-1] < totals[0], totals
    assert marks[:5] == ["backbone+fpn", "head", "anchor targets+loss", "backward",
                         "optimizer"]
    for name, p in det.module.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is None or p.grad.dtype == torch.float32, name


def test_train_driver_runs_two_synthetic_steps(tmp_path, capsys):
    cfg = get_config(None, OVERRIDES + ["data.dataset=synthetic", "train.max_steps=2",
                                        "train.log_every=1", f"output_dir={tmp_path}"])
    last = driver.run(cfg, device="cpu")
    assert set(last) == {"loss_cls", "loss_box", "loss_total"}
    assert all(np.isfinite(v) for v in last.values())
    assert ckpt.latest_step(str(tmp_path)) == 2
    out = capsys.readouterr().out
    assert "model=retinanet" in out and "step 2/2" in out
