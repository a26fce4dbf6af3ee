"""The port's bf16 RetinaNet (``model.dtype=bfloat16``) against the JAX
package's bf16 RetinaNet, on the same (JAX-initialised, float32) weights.

Config: retinanet R-50, 128x128, num_classes=5, fpn_channels=32,
retinanet.pre_nms_topk=100, 20 detections an image, ``cls_score``'s bias
raised for classes 1 and 3 (at the prior's bias no logit passes the
threshold), and on the JAX side ``retinanet.exact_topk=true``: JAX's
default ``approx_max_k`` orders bf16 ties otherwise on the CPU (the
conventions of ``test_torch_bf16.py``).

* Parameters float32 on both sides; every FPN level and every head output
  bf16, within 3e-2 x max |JAX output| (both frameworks round each layer
  to bf16 after summing in their own order).
* ``retinanet_inference`` on JAX's own bf16 head outputs: boxes float32,
  scores bf16; detections matched as sets (same class, the same box, the
  score within one bf16 step: JAX's and PyTorch's bf16 sigmoids may round
  apart by a step and reorder the class-aware NMS), at least 90%.
* ``predict_fn`` end to end: K1 handed float32 boxes (5 x 100 - 64
  candidates: P7 holds 36 entries), at least 60% of JAX's detections in
  the port's (same class, IoU >= 0.5), scores in [0, 1]; channels-last
  computes what NCHW computes, within the level limit.
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
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.ops import nms as tnms
from detectron_tpu_torch.ops.boxes import bbox_overlaps
from detectron_tpu_torch.utils.weights import from_jax_params

F32 = ["model.name=retinanet", "model.num_classes=5", "model.fpn_channels=32",
       "data.image_size=[128, 128]", "retinanet.pre_nms_topk=100",
       "test.detections_per_image=20"]
BF16 = F32 + ["model.dtype=bfloat16"]
RAISED = (1, 3)
BF16_STEP = 2.0 ** -7
LEVEL_LIMIT = 3e-2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def as_f32(x) -> np.ndarray:
    return np.asarray(x).astype(np.float32)


def to_torch(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def raise_classes(variables, classes, value=0.5, k=4):
    """The ``cls_score`` bias of ``classes`` (1-based) raised at every anchor."""
    bias = np.array(variables["params"]["head"]["cls_score"]["bias"]).reshape(-1, k)
    bias[:, [c - 1 for c in classes]] = value
    variables["params"]["head"]["cls_score"]["bias"] = bias.reshape(-1)
    return variables


@pytest.fixture(scope="module")
def run():
    jcfg = jax_get_config(None, BF16 + ["retinanet.exact_topk=true"])
    jdet = jax_build_detector(jcfg)
    variables = raise_classes(jax.tree_util.tree_map(
        np.asarray, jdet.init(jax.random.PRNGKey(0), (128, 128))), RAISED)
    rng = np.random.RandomState(0)
    batch = {"image": rng.randn(2, 128, 128, 3).astype(np.float32),
             "image_hw": np.array([[128, 128], [112, 96]], np.float32)}
    outs, state = jdet.module.apply(variables, jnp.asarray(batch["image"]),
                                    capture_intermediates=True, mutable=["intermediates"])
    levels = state["intermediates"]["fpn"]["__call__"][0]
    anchors_pl = jretina.retinanet_anchor_generator(jcfg).grid_anchors((128, 128))
    j_inf = jretina.retinanet_inference(outs, anchors_pl, jnp.asarray(batch["image_hw"]),
                                        jcfg)
    j_dets, _ = jax.jit(jdet.predict_fn)(variables,
                                         {k: jnp.asarray(v) for k, v in batch.items()})
    tdet = build_detector(get_config(None, BF16), device="cpu")
    params = from_jax_params(variables, tdet.module)
    tdet.module.load_state_dict(params)
    with torch.no_grad():
        t_levels = tdet.module.features(torch.tensor(batch["image"]))
        t_outs = tdet.module.head_outputs(t_levels)
    return dict(tdet=tdet, params=params, batch=batch, levels=levels, outs=outs,
                t_levels=t_levels, t_outs=t_outs, anchors_pl=anchors_pl, j_inf=j_inf,
                j_dets=j_dets, variables=variables)


def within_limit(got, want):
    got, want = got.float().numpy(), as_f32(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() <= LEVEL_LIMIT * np.abs(want).max()


def test_params_float32_and_outputs_bf16(run):
    assert run["tdet"].dtype == torch.bfloat16
    assert {p.dtype for p in run["tdet"].module.parameters()} == {torch.float32}
    assert {leaf.dtype for leaf in jax.tree_util.tree_leaves(run["variables"])} == {
        np.dtype("float32")}
    for got, (cls, box) in zip(run["t_levels"], run["t_outs"]):
        assert got.dtype == cls.dtype == box.dtype == torch.bfloat16


def test_levels_and_head_outputs_within_the_bf16_limit(run):
    for lvl, (got, want) in enumerate(zip(run["t_levels"], run["levels"])):
        assert want.dtype == jnp.bfloat16
        assert within_limit(got.permute(0, 2, 3, 1), want), lvl
    for lvl, ((tc, tb), (jc, jb)) in enumerate(zip(run["t_outs"], run["outs"])):
        assert within_limit(tc, jc) and within_limit(tb, jb), lvl


def matched(want, got, exact_box: bool) -> float:
    """The share of ``want``'s valid detections that ``got`` has: the same
    class and image, the same box (``exact_box``; else IoU >= 0.5) and,
    for the same box, the score within one bf16 step."""
    found = total = 0
    for i in range(got.valid.shape[0]):
        vw = np.asarray(want.valid[i])
        wb, ws, wc = (np.asarray(x[i])[vw] for x in (want.boxes, want.scores, want.classes))
        vg = got.valid[i]
        gb, gs, gc = got.boxes[i][vg], got.scores[i][vg].float(), got.classes[i][vg]
        total += len(wb)
        for b, s, c in zip(wb, as_f32(ws), wc):
            same_cls = gc.numpy() == c
            if exact_box:
                hit = (gb.numpy() == b).all(1) & same_cls & (
                    np.abs(gs.numpy() - s) <= BF16_STEP * abs(s))
            else:
                iou = bbox_overlaps(torch.tensor(b[None]), gb.float())[0].numpy()
                hit = (iou >= 0.5) & same_cls
            found += bool(hit.any())
    return found / max(total, 1)


def test_inference_on_jax_bf16_head_outputs(run):
    outs = [(to_torch(c), to_torch(b)) for c, b in run["outs"]]
    cfg = get_config(None, BF16)
    got = tretina.retinanet_inference(outs, [torch.tensor(a) for a in run["anchors_pl"]],
                                      torch.tensor(run["batch"]["image_hw"]), cfg)
    assert got.boxes.dtype == torch.float32 and got.scores.dtype == torch.bfloat16
    assert int(got.valid.sum()) == int(np.asarray(run["j_inf"].valid).sum()) > 0
    assert matched(run["j_inf"], got, exact_box=True) >= 0.9


def test_predict_fn_end_to_end(run, monkeypatch):
    seen = []
    real = tnms.greedy_keep

    def k1(sboxes, *args, **kwargs):
        seen.append((sboxes.dtype, tuple(sboxes.shape)))
        return real(sboxes, *args, **kwargs)

    monkeypatch.setattr(tnms, "greedy_keep", k1)
    dets, masks = run["tdet"].predict_fn(run["params"], run["batch"])
    assert masks is None
    assert seen == [(torch.float32, (2, 4 * 100 + 36, 4))]
    assert dets.boxes.dtype == torch.float32 and dets.scores.dtype == torch.bfloat16
    assert float(dets.scores.min()) >= 0.0 and float(dets.scores.max()) <= 1.0
    assert int(dets.valid.sum()) > 0
    assert matched(run["j_dets"], dets, exact_box=False) >= 0.6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channels_last_computes_what_nchw_computes(run, dtype):
    det = build_detector(get_config(None, F32 + [f"model.dtype={dtype}"]), device="cpu")
    det.module.load_state_dict(run["params"])
    images = torch.tensor(run["batch"]["image"])
    with torch.no_grad():
        det.module.set_channels_last(False)
        nchw = det.module.head_outputs(det.module.features(images))
        det.module.set_channels_last(True)
        assert det.module.head.cls0.memory_format == torch.channels_last
        last = det.module.head_outputs(det.module.features(images))
    for (a, _), (b, _) in zip(last, nchw):
        assert a.dtype == b.dtype == getattr(torch, dtype)
        assert float((a.float() - b.float()).abs().max()) <= LEVEL_LIMIT * float(b.abs().max())
