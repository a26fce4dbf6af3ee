"""Data parallelism of the port (``parallel/mesh.py``) over ``torch.distributed``.

Two gloo processes on the CPU (spawned as ``test_torch_eval.py`` spawns
its merge workers) hold the criterion of the JAX package's
``tests/test_parallel.py``: a data-parallel step equals one process's step
on the concatenated batch, loss within 1e-4 and every parameter within
2e-5, for the JAX test's RetinaNet ``small_cfg`` and for a small Mask
R-CNN (with optax's gradient clip, which must see the global norm). For
RetinaNet, whose two images have different positive counts, a DDP-style
step (each rank dividing by its own normalizers, the gradients averaged)
misses that criterion. (Mask R-CNN's images here fill their RPN and RoI
samples alike, so their normalizers are equal and the two agree.) The
processes also run ``make_predict_step`` on their rows of a global batch
and the train driver under the ``parallel.*`` keys.

In one process: the rank draws are rows of the global draws, ``shard_batch``
and the driver's ``Loader`` shards cover the global batch without overlap,
and ``initialize_distributed`` returns ``(0, 1)`` and starts no group
without an address or torchrun's environment.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.data.synthetic import make_batch
from detectron_tpu_torch.models import faster_rcnn as frcnn
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.parallel import mesh as pmesh
from detectron_tpu_torch.train import driver
from detectron_tpu_torch.train import state as tstate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_parallel.py::small_cfg, and a Mask R-CNN as tests/test_torch_train.py's
CASES = {
    "retinanet": ["model.name=retinanet", "model.num_classes=4", "model.fpn_channels=32",
                  "model.frozen_stages=0", "data.image_size=[128, 128]",
                  "retinanet.pre_nms_topk=100", "test.detections_per_image=10"],
    "mask_rcnn": ["model.name=mask_rcnn", "model.num_classes=4", "model.fpn_channels=32",
                  "data.image_size=[128, 128]", "rpn.pre_nms_topk_train=128",
                  "rpn.post_nms_topk_train=32", "roi.batch_per_image=32",
                  "train.max_gt_boxes=8", "train.grad_clip_norm=1.0",
                  "rpn.pre_nms_topk_test=128", "rpn.post_nms_topk_test=32",
                  "test.detections_per_image=10"],
}
GLOBAL_BATCH = 2
LOSS_ATOL = 1e-4
PARAM_ATOL = 2e-5


def case_inputs(name):
    """A case's config, its global batch and (Mask R-CNN) its global draws."""
    cfg = get_config(None, CASES[name] + ["train.base_lr=0.01", "train.warmup_steps=0"])
    batch = make_batch(np.random.RandomState(1), GLOBAL_BATCH, (128, 128), 4, max_gt=8)
    draws = None
    if name == "mask_rcnn":
        det = build_detector(cfg, device="cpu")
        n_anchors = sum(a.shape[0] for a in det.module.anchors((128, 128), "cpu"))
        draws = frcnn.make_train_draws(tstate.step_generator(cfg, 0, "cpu"), GLOBAL_BATCH,
                                       n_anchors, cfg.rpn.post_nms_topk_train + 8)
    return cfg, batch, draws


def fresh_state(cfg):
    det = build_detector(cfg, device="cpu")
    return tstate.create_train_state(cfg, det, det.init(0))


def worker(rank: int, port: int, driver_port: int, out_dir: str):
    """One of the two ranks: for each case the data-parallel step, a
    DDP-style step (local normalizers, gradients averaged), then the
    predict step; then, in a new group, the train driver under the
    ``parallel.*`` keys."""
    torch.set_num_threads(2)
    assert pmesh.initialize_distributed(f"127.0.0.1:{port}", 2, rank, device="cpu") == (rank, 2)
    mesh = pmesh.make_mesh("cpu")
    assert (mesh.rank, mesh.world, mesh.device.type) == (rank, 2, "cpu")

    def ddp_average(grads):
        pmesh.all_reduce_sum(grads, mesh)
        for g in grads:
            g.div_(2)

    results = {}
    for name in CASES:
        cfg, batch, draws = case_inputs(name)
        local = pmesh.shard_batch(batch, mesh)
        state = fresh_state(cfg)
        with torch.no_grad():  # rank 0's weights on every rank
            for p in state.detector.module.parameters():
                p.add_(rank)
        pmesh.broadcast_state(state.detector.module, mesh)
        dp = pmesh.make_train_step(state.detector, mesh)(state, local, draws)
        naive = fresh_state(cfg)
        rows = pmesh.shard_rows(GLOBAL_BATCH, mesh)
        ddp = tstate.train_step(
            naive, local, None if draws is None else frcnn.TrainDraws(*(d[rows] for d in draws)),
            reduce_grads=ddp_average)
        ddp_loss = ddp["loss_total"].clone()
        torch.distributed.all_reduce(ddp_loss)
        dets, _ = pmesh.make_predict_step(fresh_state(cfg).detector, mesh)(None, batch)
        results[name] = dict(
            loss=float(dp["loss_total"]), ddp_loss=float(ddp_loss) / 2, params=state.params,
            ddp_params=naive.params, boxes=dets.boxes, valid=dets.valid)
    torch.distributed.destroy_process_group()
    cfg = get_config(None, CASES["mask_rcnn"] + [
        "data.dataset=synthetic", "train.batch_size=2", "train.max_steps=2",
        "train.log_every=1", f"output_dir={out_dir}/driver",
        f"parallel.coordinator_address=127.0.0.1:{driver_port}", "parallel.num_processes=2",
        f"parallel.process_id={rank}"])
    last = driver.run(cfg, device="cpu")
    assert torch.distributed.get_world_size() == 2
    results["driver"] = dict(last=last, files=sorted(os.listdir(f"{out_dir}/driver"))
                             if rank == 0 else None)
    torch.save(results, f"{out_dir}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(str(s.getsockname()[1]))
    env = dict(os.environ, PYTHONPATH=REPO)
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    code = "import sys; from tests.test_torch_parallel import worker; " \
           "worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(rank), *ports, str(out)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
    logs = []
    for proc in procs:
        try:
            stdout, stderr = proc.communicate(timeout=300)
        finally:
            proc.kill()
        logs.append(stdout)
        assert proc.returncode == 0, stderr[-3000:]
    ranks = [torch.load(out / f"rank{rank}.pt") for rank in (0, 1)]
    return dict(ranks=ranks, logs=logs)


@pytest.fixture(scope="module")
def single():
    """One process's step and predict call on each case's global batch."""
    torch.set_num_threads(2)
    out = {}
    for name in CASES:
        cfg, batch, draws = case_inputs(name)
        state = fresh_state(cfg)
        metrics = tstate.train_step(state, batch, draws)
        dets, _ = fresh_state(cfg).detector.predict_fn(None, batch)
        out[name] = dict(loss=float(metrics["loss_total"]), params=state.params, dets=dets)
    return out


def max_param_diff(got: dict, want: dict) -> float:
    return max(float((got[k] - v).abs().max()) for k, v in want.items())


@pytest.mark.parametrize("name", list(CASES))
def test_dp_step_equals_one_process_step(two_ranks, single, name):
    want = single[name]
    for rank in two_ranks["ranks"]:
        got = rank[name]
        assert abs(got["loss"] - want["loss"]) < LOSS_ATOL
        assert max_param_diff(got["params"], want["params"]) <= PARAM_ATOL
    p0, p1 = (r[name]["params"] for r in two_ranks["ranks"])
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_local_normalizers_would_miss(two_ranks, single):
    """DDP's average of per-rank losses, each over its own normalizers."""
    want, got = single["retinanet"], two_ranks["ranks"][0]["retinanet"]
    assert (abs(got["ddp_loss"] - want["loss"]) >= LOSS_ATOL
            or max_param_diff(got["ddp_params"], want["params"]) > PARAM_ATOL)


def test_retinanet_images_differ_in_positives():
    """Why the RetinaNet case can tell the two apart."""
    from detectron_tpu_torch.layers.anchor_target import anchor_target

    cfg, batch, _ = case_inputs("retinanet")
    det = build_detector(cfg, device="cpu")
    anchors = torch.cat(det.module.anchors((128, 128), "cpu"))
    b = det.batch_to_device(batch)
    tgt = anchor_target(anchors, b["gt_boxes"], b["gt_classes"], None, None,
                        pos_iou=cfg.retinanet.positive_iou, neg_iou=cfg.retinanet.negative_iou,
                        force_match=True, sample_size=0)
    pos = tgt.num_pos.tolist()
    assert pos[0] != pos[1] and min(pos) > 0


@pytest.mark.parametrize("name", list(CASES))
def test_predict_step_gives_the_ranks_rows(two_ranks, single, name):
    want = single[name]["dets"]
    for rank, got in enumerate(two_ranks["ranks"]):
        rows = slice(rank, rank + 1)
        assert torch.equal(got[name]["valid"], want.valid[rows])
        torch.testing.assert_close(got[name]["boxes"], want.boxes[rows], rtol=0, atol=1e-4)


def test_driver_under_the_parallel_keys(two_ranks):
    """Both ranks log the global batch's losses; rank 0 alone writes the
    metrics and the checkpoints."""
    r0, r1 = (r["driver"] for r in two_ranks["ranks"])
    assert r0["last"] == r1["last"] and np.isfinite(r0["last"]["loss_total"])
    assert "metrics.jsonl" in r0["files"] and any(f.startswith("ckpt") for f in r0["files"])
    assert "process=0/2" in two_ranks["logs"][0] and "process=1/2" in two_ranks["logs"][1]
    assert "step 2/2" in two_ranks["logs"][0] and "step 2/2" not in two_ranks["logs"][1]


def test_rank_draws_are_rows_of_the_global_draws():
    gen = tstate.step_generator(get_config(None, []), 3, "cpu")
    want = frcnn.make_train_draws(gen, 4, 50, 20)
    for rank in range(2):
        with pmesh.data_parallel(pmesh.Mesh(rank, 2, torch.device("cpu"))):
            got = frcnn.make_train_draws(tstate.step_generator(get_config(None, []), 3, "cpu"),
                                         2, 50, 20)
            x = torch.tensor([3.0])
            assert pmesh.global_sum(x) is x  # no group: nothing to sum over
        for g, w in zip(got, want):
            assert torch.equal(g, w[2 * rank:2 * rank + 2])


@pytest.mark.parametrize("world", [1, 2, 4])
def test_shard_batch_covers_the_global_batch(world):
    batch = make_batch(np.random.RandomState(0), 4, (64, 64), 4)
    parts = [pmesh.shard_batch(batch, pmesh.Mesh(r, world, torch.device("cpu")))
             for r in range(world)]
    for key, value in batch.items():
        assert all(len(p[key]) == 4 // world for p in parts)
        np.testing.assert_array_equal(np.concatenate([p[key] for p in parts]), value)
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.shard_batch(make_batch(np.random.RandomState(0), 3, (64, 64), 4),
                          pmesh.Mesh(0, 2, torch.device("cpu")))


def test_driver_shards_cover_the_global_batch(tmp_path):
    """The driver's per-rank batches: synthetic, ``batch_size / world`` images
    seeded apart (rank 0's the single process's stream at world 1); over a
    dataset the ranks' ``Loader`` shards are disjoint and cover an epoch."""
    from detectron_tpu_torch.data.loader import Loader, get_dataset
    from tests import fixture_coco

    cfg = get_config(None, CASES["mask_rcnn"] + ["data.dataset=synthetic",
                                                 "train.batch_size=4"])
    per_rank = [next(driver.batch_iterator(cfg, (r, 2))) for r in range(2)]
    assert all(len(b["image"]) == 2 for b in per_rank)
    assert not np.array_equal(per_rank[0]["image"], per_rank[1]["image"])
    alone = next(driver.batch_iterator(cfg))
    np.testing.assert_array_equal(alone["image"], next(driver.batch_iterator(cfg, (0, 1)))[
        "image"])
    root = fixture_coco.make_fixture(str(tmp_path / "coco"))
    cfg = get_config(None, CASES["mask_rcnn"] + [
        "data.dataset=coco", f"data.root={root}", "data.train_split=val", "train.batch_size=2",
        "data.short_side=96", "data.max_size=128", "data.num_workers=1"])
    ds = get_dataset(cfg, "val", train=True)
    seen = []
    for r in range(2):
        it = iter(Loader(ds, cfg, train=True, seed=0, process_shard=(r, 2)))
        seen.append([int(next(it)["_image_id"][0]) for _ in range(len(ds) // 2)])
        it.close()
    assert not set(seen[0]) & set(seen[1])
    assert sorted(seen[0] + seen[1]) == sorted(ds.example(i)["image_id"] for i in range(len(ds)))


def test_initialize_distributed_without_a_group(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert pmesh.initialize_distributed() == (0, 1)
    assert pmesh.join_group(get_config(None, [])) == (0, 1)
    assert not torch.distributed.is_initialized()
    mesh = pmesh.make_mesh("cpu")
    assert mesh == pmesh.Mesh(0, 1, torch.device("cpu"), None)
    with pytest.raises(ValueError, match="num_processes"):
        pmesh.initialize_distributed("127.0.0.1:1", None, 0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.make_mesh()
