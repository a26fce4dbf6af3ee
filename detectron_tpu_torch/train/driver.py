"""Training driver of the port, with the flags and log line of ``train.py``.

    python -m detectron_tpu_torch.train.driver \\
        --config configs/mask_rcnn_r101_fpn_coco_train.yaml \\
        --cfg data.dataset=synthetic train.batch_size=2 train.max_steps=20 \\
        output_dir=build/run [--restore] [--profile]

config -> batches (seeded synthetic ones, or the threaded ``Loader`` over
``data.dataset=coco|voc|citypersons``) -> detector on the card -> SGD with
warmup and step decay -> step loop with logging (``metrics.jsonl``) and
``torch.save`` checkpoints in ``output_dir``. ``model.weights`` (a
torchvision backbone or a full-detector ``.pth`` / ``.npz``) initializes
the weights before ``--restore``. It runs on the card; the CPU is for tests
(``run(cfg, device="cpu")``).
``train.debug_nans=true`` (``jax_debug_nans`` in ``train.py``) stops the
run with ``FloatingPointError`` at the first step whose loss is not finite.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch

from detectron_tpu_torch.config import get_config
from detectron_tpu_torch.data.loader import Loader, get_dataset
from detectron_tpu_torch.data.synthetic import make_batch
from detectron_tpu_torch.models.zoo import build_detector
from detectron_tpu_torch.train import checkpoint as ckpt
from detectron_tpu_torch.train.state import create_train_state, train_step
from detectron_tpu_torch.utils.torch_weights import maybe_load_pretrained


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, help="YAML config file")
    ap.add_argument("--cfg", nargs="*", default=[], help="key=value overrides")
    ap.add_argument("--restore", action="store_true",
                    help="resume from the latest checkpoint in output_dir")
    ap.add_argument("--profile", action="store_true",
                    help="write a torch.profiler trace of steps 10-15")
    return ap.parse_args(argv)


def batch_iterator(cfg):
    """Endless fixed-shape numpy batch dicts, seeded from ``train.seed``:
    synthetic ones, or the shuffled, augmented ``Loader`` over the train
    split of ``data.dataset`` (its ``_image_id`` / ``_orig_hw`` keys
    dropped)."""
    ds = get_dataset(cfg, cfg.data.train_split, train=True)
    if ds is None:
        rng = np.random.RandomState(cfg.train.seed * 1000)
        while True:
            yield make_batch(rng, cfg.train.batch_size, cfg.data.image_size,
                             cfg.model.num_classes, max_gt=cfg.train.max_gt_boxes)
    for batch in Loader(ds, cfg, train=True, seed=cfg.train.seed):
        yield {k: v for k, v in batch.items() if not k.startswith("_")}


class Timer:
    """Mean host milliseconds per named section."""

    def __init__(self):
        self.total = defaultdict(float)
        self.calls = defaultdict(int)
        self._start = {}

    def tic(self, name: str):
        self._start[name] = time.perf_counter()

    def toc(self, name: str):
        self.total[name] += time.perf_counter() - self._start[name]
        self.calls[name] += 1

    def summary(self) -> str:
        return " | ".join(f"{k}: {self.total[k] / self.calls[k] * 1000:.1f}ms"
                          for k in sorted(self.total))


def run(cfg, restore: bool = False, profile: bool = False, device=None) -> dict:
    """Trains ``cfg.train.max_steps`` steps (from the latest checkpoint
    with ``restore``); returns the last logged metrics."""
    det = build_detector(cfg, device=device)
    print(f"model={cfg.model.name} backbone={cfg.model.backbone} "
          f"dataset={cfg.data.dataset} device={det.device}", flush=True)
    params = maybe_load_pretrained(cfg, det.init(cfg.train.seed))
    if cfg.model.weights:
        print(f"initialized from {cfg.model.weights}", flush=True)
    state = create_train_state(cfg, det, params)
    if restore:
        state = ckpt.restore(cfg.output_dir, state)
        print(f"restored checkpoint at step {state.step}", flush=True)

    timer = Timer()
    os.makedirs(cfg.output_dir, exist_ok=True)
    metrics_log = open(os.path.join(cfg.output_dir, "metrics.jsonl"), "a")
    data_iter = batch_iterator(cfg)
    prof = None
    last = {}
    start = state.step
    t_log = time.perf_counter()
    try:
        for step in range(start, cfg.train.max_steps):
            if profile and step == start + 10:
                prof = torch.profiler.profile()
                prof.__enter__()
            timer.tic("data")
            batch = det.batch_to_device(next(data_iter))
            timer.toc("data")
            timer.tic("step")
            metrics = train_step(state, batch)
            timer.toc("step")
            if cfg.train.debug_nans:
                bad = sorted(k for k, v in metrics.items() if not bool(torch.isfinite(v).all()))
                if bad:
                    raise FloatingPointError(
                        f"step {step + 1}: losses {bad} are not finite (train.debug_nans)")
            if prof is not None and step == start + 14:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(cfg.output_dir, "profile.json"))
                print(f"profiler trace written to {cfg.output_dir}/profile.json")
                prof = None
            if (step + 1) % cfg.train.log_every == 0:
                last = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t_log
                ips = cfg.train.log_every * cfg.train.batch_size / dt
                t_log = time.perf_counter()
                lr = state.schedule(step)
                loss_str = " ".join(f"{k}={v:.4f}" for k, v in sorted(last.items()))
                print(f"step {step + 1}/{cfg.train.max_steps} lr={lr:.5f} "
                      f"{loss_str} ({ips:.1f} img/s) [{timer.summary()}]", flush=True)
                metrics_log.write(json.dumps({"step": step + 1, "time": time.time(), **last,
                                              "lr": lr, "img_per_sec": ips}) + "\n")
                metrics_log.flush()
            if (step + 1) % cfg.train.checkpoint_every == 0:
                ckpt.save(cfg.output_dir, state)
    finally:
        metrics_log.close()
    ckpt.save(cfg.output_dir, state)
    print(f"done: {state.step} steps, checkpoints in {cfg.output_dir}", flush=True)
    return last


def main(argv=None):
    args = parse_args(argv)
    run(get_config(args.config, args.cfg), restore=args.restore, profile=args.profile)


if __name__ == "__main__":
    main()
