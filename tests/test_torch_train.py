"""The training slice as a whole: the port's Mask R-CNN train step against
the JAX package's, on the same (JAX-initialised) weights, batches and draws.

Config: mask_rcnn R-50, 128x128, num_classes=4, fpn_channels=32,
rpn.pre_nms_topk_train=128, post_nms_topk_train=32, roi.batch_per_image=32,
train.max_gt_boxes=8, train.grad_clip_norm=1.0 (so optax's clip is
exercised), batch 2 of ``make_batch``.

* The JAX side is ``jax.value_and_grad(det.loss_fn)`` + ``apply_gradients``
  under one ``jit``, its key folded with the step as ``make_train_step``
  does; the port gets the uniform draws that this key tree gives.
* Per step, every loss agrees within 1e-4 relative: the same proposals and
  samples, float32 convolutions summed in another order.
* After two steps every parameter agrees within 1e-6 absolute (the
  updates are lr * clipped gradients, about 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.config import get_config as jax_get_config
from detectron_tpu.data.synthetic import make_batch
from detectron_tpu.models.zoo import build_detector as jax_build_detector
from detectron_tpu.train import state as jax_state
from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.models import faster_rcnn as tfrcnn
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.train import checkpoint as ckpt
from detectron_tpu_torch.train import driver
from detectron_tpu_torch.train import state as tstate
from detectron_tpu_torch.utils.weights import from_jax_params

OVERRIDES = ["model.name=mask_rcnn", "model.num_classes=4", "model.fpn_channels=32",
             "data.image_size=[128, 128]", "rpn.pre_nms_topk_train=128",
             "rpn.post_nms_topk_train=32", "roi.batch_per_image=32", "train.batch_size=2",
             "train.max_gt_boxes=8", "train.grad_clip_norm=1.0"]
STEPS = 2
SEED = 0


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The suite runs several workers on the machine's cores; PyTorch's
    default of one intra-op thread per core in each of them only makes
    the workers contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def jax_draws(key0, step, num_anchors, num_candidates, b=2):
    """The uniform draws of JAX's train forward at ``step``: ``fold_in``,
    ``split`` into the anchor and the RoI key, ``split(., B)``, then
    ``split`` into the two draws of each image."""
    k_tgt, k_smp = jax.random.split(jax.random.fold_in(key0, step))
    out = []
    for key, n in ((k_tgt, num_anchors), (k_smp, num_candidates)):
        first, second = [], []
        for k in jax.random.split(key, b):
            k1, k2 = jax.random.split(k)
            first.append(np.asarray(jax.random.uniform(k1, (n,))))
            second.append(np.asarray(jax.random.uniform(k2, (n,))))
        out += [torch.tensor(np.stack(first)), torch.tensor(np.stack(second))]
    return tfrcnn.TrainDraws(*out)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def train_run():
    jcfg, tcfg = jax_get_config(None, OVERRIDES), get_config(None, OVERRIDES)
    jdet = jax_build_detector(jcfg)
    variables = jdet.init(jax.random.PRNGKey(SEED), (128, 128))
    batch = make_batch(np.random.RandomState(SEED), 2, (128, 128), 4, max_gt=8)
    jstate, tx, _ = jax_state.create_train_state(jcfg, variables)
    key0 = jax.random.PRNGKey(SEED + 1)

    def step(state, jbatch):
        key = jax.random.fold_in(key0, state.step)
        (_, ld), grads = jax.value_and_grad(
            lambda p: jdet.loss_fn(p, jbatch, key), has_aux=True)(state.params)
        return jax_state.apply_gradients(state, grads, tx), ld

    jstep = jax.jit(step)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    tdet = build_detector(tcfg, device="cpu")
    params0 = from_jax_params(numpy_tree(variables), tdet.module)
    tst = tstate.create_train_state(tcfg, tdet, params0)
    num_anchors = sum(a.shape[0] for a in tdet.module.anchors((128, 128), "cpu"))
    j_losses, t_losses = [], []
    for s in range(STEPS):
        jstate, ld = jstep(jstate, jbatch)
        j_losses.append({k: float(v) for k, v in ld.items()})
        draws = jax_draws(key0, s, num_anchors, tcfg.rpn.post_nms_topk_train + 8)
        t_losses.append({k: float(v) for k, v in tstate.train_step(tst, batch, draws).items()})
    return dict(tcfg=tcfg, batch=batch, params0=params0, j_losses=j_losses,
                t_losses=t_losses, j_params=from_jax_params(numpy_tree(jstate.params)),
                t_state=tst)


@pytest.mark.parametrize("step", range(STEPS))
def test_losses_match_jax(train_run, step):
    want, got = train_run["j_losses"][step], train_run["t_losses"][step]
    assert set(got) == set(want) | {"loss_total"}
    assert set(want) == {"loss_rpn_cls", "loss_rpn_box", "loss_cls", "loss_box", "loss_mask"}
    for name, value in want.items():
        assert np.isfinite(got[name])
        np.testing.assert_allclose(got[name], value, rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(got["loss_total"], sum(want.values()), rtol=1e-4)


def test_params_after_two_steps_match_jax(train_run):
    got, want = train_run["t_state"].params, train_run["j_params"]
    assert set(got) == set(want)
    assert train_run["t_state"].step == STEPS
    for name, value in want.items():
        torch.testing.assert_close(got[name], value, rtol=0, atol=1e-6, msg=name)


def test_frozen_params_unchanged_and_trainable_changed(train_run):
    got, before = train_run["t_state"].params, train_run["params0"]
    frozen = [k for k in before if k.startswith(("backbone.conv1.", "backbone.layer1."))]
    assert frozen
    for name in frozen:
        assert torch.equal(got[name], before[name]), name
    module = train_run["t_state"].detector.module
    trainable = [n for n, p in module.named_parameters() if p.requires_grad]
    assert len(trainable) > 50
    assert not any(n.startswith(("backbone.conv1.", "backbone.layer1.")) for n in trainable)
    for name in trainable:
        assert not torch.equal(got[name], before[name]), name
    # frozen BatchNorm stays buffers, untouched
    bn = [k for k in before if ".bn" in k or "downsample_bn" in k]
    assert bn and all(torch.equal(got[k], before[k]) for k in bn)


def test_optimizer_groups_follow_the_jax_masks(train_run):
    """Weight decay on the flax ``kernel`` leaves only (conv, deconv,
    linear weights), no decay on biases, frozen parameters outside the
    optimizer: the group sizes equal the counts of JAX's masks."""
    jcfg = jax_get_config(None, OVERRIDES)
    params = jax_build_detector(jcfg).init(jax.random.PRNGKey(SEED), (128, 128))["params"]
    trainable = jax.tree_util.tree_leaves(
        jax_state.trainable_mask(params, jcfg.model.frozen_stages))
    kernel = jax.tree_util.tree_leaves(jax_state.weight_decay_mask(params))
    module = train_run["t_state"].detector.module
    names = {id(p): n for n, p in module.named_parameters()}
    groups = train_run["t_state"].optimizer.param_groups
    decay = {names[id(p)] for p in groups[0]["params"]}
    no_decay = {names[id(p)] for p in groups[1]["params"]}
    assert groups[0]["weight_decay"] == 1e-4 and groups[1]["weight_decay"] == 0.0
    assert all(n.endswith(".weight") for n in decay)
    assert all(n.endswith(".bias") for n in no_decay)
    assert "mask_head.deconv.weight" in decay
    assert len(decay) == sum(t and k for t, k in zip(trainable, kernel))
    assert len(no_decay) == sum(t and not k for t, k in zip(trainable, kernel))


def test_schedule_matches_jax():
    overrides = ["train.base_lr=0.02", "train.warmup_steps=100", "train.warmup_factor=0.25",
                 "train.lr_decay_steps=[150, 300]", "train.lr_decay_factor=0.1"]
    want = jax_state.warmup_step_decay_schedule(jax_get_config(None, overrides))
    got = tstate.warmup_step_decay_schedule(get_config(None, overrides))
    for step in (0, 1, 37, 99, 100, 101, 149, 150, 151, 299, 300, 1000):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, err_msg=step)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    import optax

    rng = np.random.RandomState(4)
    grads = [rng.randn(3, 4).astype(np.float32), rng.randn(7).astype(np.float32)]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = [torch.tensor(g) for g in grads]
    norm = tstate.clip_by_global_norm(got, max_norm)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(want if max_norm > 10
                                                                     else grads)), rtol=1e-6)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_heads_give_the_fpn_levels_a_gradient():
    """The box and the mask losses alone (no RPN loss) reach every pooled
    FPN level and the backbone: RoIAlign's output is never detached."""
    cfg = get_config(None, OVERRIDES)
    det = build_detector(cfg, device="cpu")
    det.module.load_state_dict(det.init(seed=2))
    batch = det.batch_to_device(make_batch(np.random.RandomState(3), 2, (128, 128), 4,
                                           max_gt=8))
    m = det.module
    levels = m.features(batch["image"])
    for lvl in levels:
        lvl.retain_grad()
    # RoIs from 24 to 1000 pixels: every pooled level gets some
    sizes = torch.tensor([24.0, 96.0, 192.0, 384.0, 768.0, 1000.0, 50.0, 300.0])
    xy = torch.tensor([[4.0, 6.0], [20.0, 10.0]])[:, None, :].expand(2, 8, 2)
    rois = torch.cat([xy, xy + sizes[None, :, None]], -1).contiguous()
    cls_logits, _ = m.box(levels, rois)
    mask_logits = m.mask(levels, rois)
    (cls_logits.square().mean() + mask_logits.square().mean()).backward()
    for i, lvl in enumerate(levels[:4]):
        assert lvl.grad is not None and float(lvl.grad.abs().sum()) > 0, f"P{i + 2}"
    assert levels[4].grad is None or float(levels[4].grad.abs().sum()) == 0  # P6 is not pooled
    assert float(m.backbone.layer4[0].conv1.weight.grad.abs().sum()) > 0
    assert m.backbone.layer1[0].conv1.weight.grad is None  # frozen


def test_loss_fn_with_params_equals_module_weights(train_run):
    """loss_fn(params, ...) runs a state dict through the module, as
    loss_fn(None, ...) runs its own weights."""
    cfg = train_run["tcfg"]
    det = build_detector(cfg, device="cpu")
    params = det.init(seed=5)
    det.module.load_state_dict(params)
    draws = tfrcnn.make_train_draws(torch.Generator().manual_seed(0), 2, 4092, 40)
    a, da = det.loss_fn(None, train_run["batch"], draws)
    b, db = det.loss_fn(params, train_run["batch"], draws)
    assert a.item() == b.item() and set(da) == set(db)


def test_train_step_with_generator_is_seeded(train_run):
    """Without injected draws a step samples from a generator seeded by
    train.seed and the step: two runs from the same state agree."""
    cfg = train_run["tcfg"]
    out = []
    for _ in range(2):
        det = build_detector(cfg, device="cpu")
        st = tstate.create_train_state(cfg, det, train_run["params0"])
        out.append(tstate.train_step(st, train_run["batch"]))
    for name in out[0]:
        assert torch.equal(out[0][name], out[1][name]), name


def test_train_step_marks_its_stages_in_order(train_run):
    """train_step calls ``mark`` at each stage boundary, in order; a
    marked step computes what an unmarked one does."""
    cfg = train_run["tcfg"]
    out, stages = [], []
    for mark in (None, stages.append):
        det = build_detector(cfg, device="cpu")
        st = tstate.create_train_state(cfg, det, train_run["params0"])
        out.append(tstate.train_step(st, train_run["batch"], mark=mark))
    assert stages == ["anchors+draws", "backbone+fpn", "rpn head", "rpn targets+loss",
                      "proposals (K1)", "roi sampling", "box: align (K2) + head + loss",
                      "mask: targets + align (K2) + head + loss", "backward", "optimizer"]
    for name in out[0]:
        assert torch.equal(out[0][name], out[1][name]), name


def test_checkpoint_round_trip(train_run, tmp_path):
    cfg = train_run["tcfg"]
    src = train_run["t_state"]
    ckpt.save(str(tmp_path), src)
    det = build_detector(cfg, device="cpu")
    dst = tstate.create_train_state(cfg, det, det.init(seed=9))
    assert ckpt.restore(str(tmp_path / "none"), dst) is dst and dst.step == 0
    ckpt.restore(str(tmp_path), dst)
    assert dst.step == src.step
    for name, value in src.params.items():
        assert torch.equal(dst.params[name], value), name
    bufs_src = [s["momentum_buffer"] for s in src.optimizer.state_dict()["state"].values()]
    bufs_dst = [s["momentum_buffer"] for s in dst.optimizer.state_dict()["state"].values()]
    assert len(bufs_src) == len(bufs_dst) > 0
    assert all(torch.equal(a, b) for a, b in zip(bufs_src, bufs_dst))


def test_checkpoints_keep_the_newest(train_run, tmp_path):
    st = train_run["t_state"]
    step = st.step
    try:
        for s in range(7):
            st.step = s
            ckpt.save(str(tmp_path), st, max_to_keep=3)
    finally:
        st.step = step
    assert ckpt._steps(str(tmp_path)) == [4, 5, 6]


def test_driver_runs_two_steps_on_cpu_and_resumes(tmp_path, capsys):
    cfg = get_config(None, OVERRIDES + [
        "data.dataset=synthetic", "train.max_steps=2", "train.log_every=1",
        "train.checkpoint_every=1", f"output_dir={tmp_path}"])
    last = driver.run(cfg, device="cpu")
    out = capsys.readouterr().out
    assert "step 1/2 lr=" in out and "step 2/2 lr=" in out and "img/s" in out
    assert set(last) >= {"loss_total", "loss_mask"} and np.isfinite(last["loss_total"])
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2
    assert ckpt.latest_step(str(tmp_path)) == 2
    cfg.train.max_steps = 3
    driver.run(cfg, restore=True, device="cpu")
    out = capsys.readouterr().out
    assert "restored checkpoint at step 2" in out and "step 3/3" in out
    assert ckpt.latest_step(str(tmp_path)) == 3


@pytest.mark.parametrize("debug_nans", [False, True])
def test_driver_debug_nans_stops_at_a_non_finite_loss(tmp_path, monkeypatch, debug_nans):
    """train.debug_nans (jax_debug_nans in train.py) raises at the first
    step whose loss is not finite; without it the run logs the NaN."""
    real_step = driver.train_step

    def nan_step(state, batch):
        metrics = real_step(state, batch)
        if state.step >= 2:
            metrics["loss_mask"] = torch.tensor(float("nan"))
        return metrics

    monkeypatch.setattr(driver, "train_step", nan_step)
    cfg = get_config(None, OVERRIDES + [
        "data.dataset=synthetic", "train.max_steps=3", "train.log_every=1",
        f"train.debug_nans={str(debug_nans).lower()}", f"output_dir={tmp_path}"])
    if debug_nans:
        with pytest.raises(FloatingPointError, match=r"step 2: losses \['loss_mask'\]"):
            driver.run(cfg, device="cpu")
    else:
        assert np.isnan(driver.run(cfg, device="cpu")["loss_mask"])


def test_driver_flags_and_profile_window(tmp_path):
    """train.py's flags; --profile writes a trace of steps 10-15."""
    args = driver.parse_args(["--config", "c.yaml", "--cfg", "a=1", "b=2", "--restore",
                              "--profile"])
    assert (args.config, args.cfg, args.restore, args.profile) == (
        "c.yaml", ["a=1", "b=2"], True, True)
    cfg = get_config(None, OVERRIDES + [
        "data.dataset=synthetic", "train.max_steps=15", "train.log_every=15",
        "train.checkpoint_every=100", f"output_dir={tmp_path}"])
    driver.run(cfg, profile=True, device="cpu")
    assert (tmp_path / "profile.json").stat().st_size > 0
    assert ckpt.latest_step(str(tmp_path)) == 15


def test_driver_refuses_unported_data():
    cfg = get_config(None, ["model.name=mask_rcnn", "data.dataset=coco"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        next(driver.batch_iterator(cfg))
