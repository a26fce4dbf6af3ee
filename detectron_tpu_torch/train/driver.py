"""Training driver of the port, with the flags and log line of ``train.py``.

    python -m detectron_tpu_torch.train.driver \\
        --config configs/mask_rcnn_r101_fpn_coco_train.yaml \\
        --cfg data.dataset=synthetic train.batch_size=2 train.max_steps=20 \\
        output_dir=build/run [--restore] [--profile]

config -> the process group, if any -> batches (seeded synthetic ones, or
the threaded ``Loader`` over ``data.dataset=coco|voc|citypersons``) ->
detector on the card -> SGD with warmup and step decay -> the
data-parallel step loop with logging (``MetricsWriter``: ``metrics.jsonl``
and TensorBoard scalars) and ``torch.save`` checkpoints in ``output_dir``.
``model.weights`` (a torchvision backbone or a full-detector ``.pth`` /
``.npz``) initializes the weights before ``--restore``. It runs on the
card; the CPU is for tests (``run(cfg, device="cpu")``).
``train.debug_nans=true`` (``jax_debug_nans`` in ``train.py``) stops the
run with ``FloatingPointError`` at the first step whose loss is not finite.

Data parallelism, as in ``train.py``: one process a card, started by
torchrun (``torchrun --nproc_per_node=N -m detectron_tpu_torch.train.driver
...``) or one by one with ``parallel.coordinator_address=host:port
parallel.num_processes=N parallel.process_id=i``. Each rank takes
``train.batch_size / N`` images a step (its synthetic batches seeded
``train.seed * 1000 + rank``, or its ``Loader`` shard), every rank restores
the checkpoint and starts from rank 0's weights, the step is
``parallel.make_train_step``'s (equal to one process's step on the global
batch), and rank 0 alone logs and writes checkpoints.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.data.loader import Loader, get_dataset
from detectron_tpu_torch.data.synthetic import make_batch
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.parallel import broadcast_state, join_group, make_mesh, make_train_step
from detectron_tpu_torch.train import checkpoint as ckpt
from detectron_tpu_torch.train.state import create_train_state
from detectron_tpu_torch.utils import spans
from detectron_tpu_torch.utils.metrics import MetricsWriter
from detectron_tpu_torch.utils.timer import Timer
from detectron_tpu_torch.utils.torch_weights import maybe_load_pretrained


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, help="YAML config file")
    ap.add_argument("--cfg", nargs="*", default=[], help="key=value overrides")
    ap.add_argument("--restore", action="store_true",
                    help="resume from the latest checkpoint in output_dir")
    ap.add_argument("--profile", action="store_true",
                    help="write a torch.profiler trace of steps 10-15 and print "
                         "each stage's mean device and host ms over them")
    return ap.parse_args(argv)


def batch_iterator(cfg, process_shard=(0, 1)):
    """Endless fixed-shape numpy batch dicts of this process's
    ``train.batch_size / count`` images, ``process_shard=(index, count)``:
    synthetic ones seeded ``train.seed * 1000 + index``, or the shuffled,
    augmented ``Loader`` shard of the train split of ``data.dataset`` (its
    ``_image_id`` / ``_orig_hw`` keys dropped)."""
    index, count = process_shard
    ds = get_dataset(cfg, cfg.data.train_split, train=True)
    if ds is None:
        if cfg.train.batch_size % count:
            raise ValueError(f"global batch {cfg.train.batch_size} does not divide across "
                             f"{count} processes")
        rng = np.random.RandomState(cfg.train.seed * 1000 + index)
        while True:
            yield make_batch(rng, cfg.train.batch_size // count, cfg.data.image_size,
                             cfg.model.num_classes, max_gt=cfg.train.max_gt_boxes)
    for batch in Loader(ds, cfg, train=True, seed=cfg.train.seed, process_shard=process_shard):
        yield {k: v for k, v in batch.items() if not k.startswith("_")}


def print_stage_means(records) -> None:
    """Each span's mean device and host milliseconds over the profiled
    steps (``utils/spans.py``), in the steps' order; device ms are "not
    measured" off the card."""
    by_name = {}
    for r in records:
        by_name.setdefault(r.name, []).append(r)
    for name, recs in by_name.items():
        dev = [r.device_ms for r in recs if r.device_ms is not None]
        device = f"{np.mean(dev):.3f} ms" if len(dev) == len(recs) else "not measured"
        print(f"stage {name}: device {device}, host {np.mean([r.host_ms for r in recs]):.3f} "
              f"ms, mean of {len(recs)}", flush=True)


def run(cfg, restore: bool = False, profile: bool = False, device=None) -> dict:
    """Trains ``cfg.train.max_steps`` steps (from the latest checkpoint
    with ``restore``), data-parallel under a process group; returns the
    last logged metrics (the global batch's losses, on every rank)."""
    join_group(cfg, device)
    mesh = make_mesh(device)
    lead = mesh.rank == 0
    det = build_detector(cfg, device=mesh.device)
    print(f"model={cfg.model.name} backbone={cfg.model.backbone} "
          f"dataset={cfg.data.dataset} device={det.device} "
          f"process={mesh.rank}/{mesh.world}", flush=True)
    params = maybe_load_pretrained(cfg, det.init(cfg.train.seed))
    if cfg.model.weights and lead:
        print(f"initialized from {cfg.model.weights}", flush=True)
    state = create_train_state(cfg, det, params)
    if restore:
        state = ckpt.restore(cfg.output_dir, state)
        if lead:
            print(f"restored checkpoint at step {state.step}", flush=True)
    broadcast_state(det.module, mesh)
    step_fn = make_train_step(det, mesh)

    timer = Timer()
    writer = MetricsWriter(cfg.output_dir) if lead else None
    data_iter = batch_iterator(cfg, process_shard=(mesh.rank, mesh.world))
    prof = None
    last = {}
    start = state.step
    t_log = time.perf_counter()
    try:
        for step in range(start, cfg.train.max_steps):
            if profile and lead and step == start + 10:
                spans.take()  # what ran before the profile
                prof = torch.profiler.profile()
                prof.__enter__()
            timer.tic("data")
            batch = det.batch_to_device(next(data_iter))
            timer.toc("data")
            timer.tic("issue")  # host time to issue the step: no synchronise
            metrics = step_fn(state, batch)
            timer.toc("issue")
            if cfg.train.debug_nans:
                bad = sorted(k for k, v in metrics.items() if not bool(torch.isfinite(v).all()))
                if bad:
                    raise FloatingPointError(
                        f"step {step + 1}: losses {bad} are not finite (train.debug_nans)")
            if prof is not None and step == start + 14:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(cfg.output_dir, "profile.json"))
                print(f"profiler trace written to {cfg.output_dir}/profile.json")
                print_stage_means(spans.take())
                prof = None
            if (step + 1) % cfg.train.log_every == 0:
                last = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t_log
                ips = cfg.train.log_every * cfg.train.batch_size / dt
                t_log = time.perf_counter()
                lr = state.schedule(step)
                if lead:
                    loss_str = " ".join(f"{k}={v:.4f}" for k, v in sorted(last.items()))
                    print(f"step {step + 1}/{cfg.train.max_steps} lr={lr:.5f} "
                          f"{loss_str} ({ips:.1f} img/s) [{timer.summary()}]", flush=True)
                    writer.write(step + 1, {**last, "lr": lr, "img_per_sec": ips})
            if lead and (step + 1) % cfg.train.checkpoint_every == 0:
                ckpt.save(cfg.output_dir, state)
    finally:
        if writer is not None:
            writer.close()
    if lead:
        ckpt.save(cfg.output_dir, state)
        print(f"done: {state.step} steps, checkpoints in {cfg.output_dir}", flush=True)
    return last


def main(argv=None):
    args = parse_args(argv)
    try:
        run(get_config(args.config, args.cfg), restore=args.restore, profile=args.profile)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
