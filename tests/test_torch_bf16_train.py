"""bf16 training (``model.dtype=bfloat16``, float32 master parameters): the
port's train step against the JAX package's, and the train driver.

* One step on the same (JAX-initialised) weights, batch and draws as
  ``test_torch_train.py`` (R-50, 128x128, FPN 32), with ``rpn.exact_topk``
  on the JAX side so that both order the bf16 objectness ties alike (JAX's
  default ``approx_max_k`` orders bf16 ties otherwise on the CPU): every
  loss within 3e-2 relative of JAX's (measured 6.6e-5 and 9.3e-5 for the
  RPN's, 6.3e-3 classification, 1.2e-2 box, 1.1e-3 mask: the bf16
  convolutions round in another order, and the RoI heads see the bf16
  proposals' samples).
* After the step every parameter and every gradient is float32 and finite
  (``tests/test_train.py:116-139`` holds the JAX package to the same).
* A short run on one batch decreases its loss, as ``tests/test_train.py``
  asserts for JAX's bf16 step: the mean of the last three losses under 0.9
  x the first three's, over 20 steps of its small config.
* ``python -m detectron_tpu_torch.train.driver --cfg model.dtype=bfloat16``
  runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.config import get_config as jax_get_config
from detectron_tpu.data.synthetic import make_batch
from detectron_tpu.models.zoo import build_detector as jax_build_detector
from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.train import checkpoint as ckpt
from detectron_tpu_torch.train import driver
from detectron_tpu_torch.train import state as tstate
from detectron_tpu_torch.utils.weights import from_jax_params
from tests.test_torch_train import OVERRIDES, jax_draws, numpy_tree

BF16 = OVERRIDES + ["model.dtype=bfloat16"]
LOSS_RTOL = 3e-2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def step_run():
    jcfg = jax_get_config(None, BF16 + ["rpn.exact_topk=true"])
    jdet = jax_build_detector(jcfg)
    variables = jdet.init(jax.random.PRNGKey(0), (128, 128))
    batch = make_batch(np.random.RandomState(0), 2, (128, 128), 4, max_gt=8)
    key0 = jax.random.PRNGKey(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, j_losses = jax.jit(
        lambda p: jdet.loss_fn(p, jbatch, jax.random.fold_in(key0, 0)))(variables)
    tcfg = get_config(None, BF16)
    tdet = build_detector(tcfg, device="cpu")
    state = tstate.create_train_state(tcfg, tdet,
                                      from_jax_params(numpy_tree(variables), tdet.module))
    num_anchors = sum(a.shape[0] for a in tdet.module.anchors((128, 128), "cpu"))
    draws = jax_draws(key0, 0, num_anchors, tcfg.rpn.post_nms_topk_train + 8)
    t_losses = tstate.train_step(state, batch, draws)
    return dict(state=state, j_losses={k: float(v) for k, v in j_losses.items()},
                t_losses={k: float(v) for k, v in t_losses.items()},
                dtypes=({str(v.dtype) for v in j_losses.values()},
                        {v.dtype for v in t_losses.values()}))


def test_bf16_step_losses_match_jax(step_run):
    """Each loss is float32 on both sides (a bf16 elementwise loss times
    float32 weights sums in float32), and within ``LOSS_RTOL`` of JAX's."""
    assert step_run["dtypes"] == ({"float32"}, {torch.float32})
    want, got = step_run["j_losses"], step_run["t_losses"]
    assert set(want) == {"loss_rpn_cls", "loss_rpn_box", "loss_cls", "loss_box", "loss_mask"}
    for name, value in want.items():
        assert np.isfinite(got[name])
        np.testing.assert_allclose(got[name], value, rtol=LOSS_RTOL, err_msg=name)


def test_bf16_step_keeps_float32_parameters_and_gradients(step_run):
    module = step_run["state"].detector.module
    assert step_run["state"].detector.dtype == torch.bfloat16
    trained = 0
    for name, param in module.named_parameters():
        assert param.dtype == torch.float32 and bool(torch.isfinite(param).all()), name
        if param.requires_grad:
            assert param.grad.dtype == torch.float32, name
            assert bool(torch.isfinite(param.grad).all()), name
            trained += 1
    assert trained > 0
    assert all(v.dtype == torch.float32 for v in module.state_dict().values())


def test_short_bf16_run_decreases_the_loss():
    cfg = get_config(None, [
        "model.name=mask_rcnn", "model.num_classes=4", "model.fpn_channels=32",
        "model.frozen_stages=0", "data.image_size=[128, 128]", "train.base_lr=0.005",
        "train.grad_clip_norm=1.0", "train.warmup_steps=10", "train.warmup_factor=0.1",
        "train.lr_decay_steps=[1000]", "train.weight_decay=0.0001",
        "rpn.pre_nms_topk_train=64", "rpn.post_nms_topk_train=32", "roi.batch_per_image=16",
        "train.batch_size=2", "model.dtype=bfloat16"])
    det = build_detector(cfg, device="cpu")
    state = tstate.create_train_state(cfg, det, det.init(0))
    batch = make_batch(np.random.RandomState(3), 2, (128, 128), 4)
    losses = [float(tstate.train_step(state, batch)["loss_total"]) for _ in range(20)]
    assert np.isfinite(losses).all(), losses
    assert np.mean(losses[-3:]) < 0.9 * np.mean(losses[:3]), losses


def test_train_driver_runs_in_bf16(tmp_path, capsys):
    args = driver.parse_args(["--cfg", *OVERRIDES, "model.dtype=bfloat16",
                              "data.dataset=synthetic", "train.max_steps=2",
                              "train.log_every=1", f"output_dir={tmp_path}"])
    cfg = get_config(args.config, args.cfg)
    assert cfg.model.dtype == "bfloat16"
    last = driver.run(cfg, device="cpu")
    assert "step 2/2 lr=" in capsys.readouterr().out
    assert np.isfinite(last["loss_total"])
    assert ckpt.latest_step(str(tmp_path)) == 2
    params, _ = ckpt.restore_params(str(tmp_path), build_detector(cfg, device="cpu").init(0))
    assert {v.dtype for v in params.values()} == {torch.float32}
