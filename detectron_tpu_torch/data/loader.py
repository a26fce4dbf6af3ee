"""Host input pipeline: a threaded, prefetching loader of fixed-shape batches.

The port of ``detectron_tpu/data/loader.py``: worker threads read, resize
and augment examples (the resize, in ``torch`` and numpy, releases the
interpreter lock for its heavy work), and a bounded queue keeps batches
ahead of the device. Every batch of one canvas has one static shape. The
threads leave ``torch.set_num_threads`` as the caller set it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from detectron_tpu_torch.data.transforms import canvas_for_image, preprocess_example


def get_dataset(cfg, split: str, train: bool):
    """The dataset that ``cfg.data.dataset`` names; None for ``synthetic``
    (its batches are generated directly, ``data.synthetic.make_batch``)."""
    name = cfg.data.dataset
    if name == "coco":
        from detectron_tpu_torch.data.coco import CocoDataset

        return CocoDataset(
            cfg.data.root, split, with_masks=cfg.model.name == "mask_rcnn"
        )
    if name == "voc":
        from detectron_tpu_torch.data.voc import VocDataset

        return VocDataset(cfg.data.root, split)
    if name == "citypersons":
        from detectron_tpu_torch.data.citypersons import CityPersonsDataset

        return CityPersonsDataset(cfg.data.root, split)
    if name == "synthetic":
        return None
    raise ValueError(f"unknown dataset {name!r}")


class Loader:
    """Iterates fixed-shape batch dicts; infinite (shuffled) when train."""

    def __init__(self, dataset, cfg, train: bool = True, seed: int = 0,
                 num_workers: int | None = None, queue_size: int = 4,
                 process_shard: tuple[int, int] | None = None):
        """process_shard=(index, count) gives each process a disjoint slice
        of the dataset and of the global batch; None = one process (all
        data, full batch)."""
        self.dataset = dataset
        self.cfg = cfg
        self.train = train
        self.seed = seed
        self.num_workers = num_workers or cfg.data.num_workers
        self.queue_size = queue_size
        idx, count = process_shard or (0, 1)
        self.shard_index, self.shard_count = idx, count
        if cfg.train.batch_size % count:
            raise ValueError(f"global batch {cfg.train.batch_size} does not divide "
                             f"across {count} processes")
        self.batch_size = cfg.train.batch_size // count

    def _example(self, index: int, rng) -> dict:
        ex = self.dataset.example(index)
        canvas = canvas_for_image(ex["image"].shape[:2], self.cfg)
        out = preprocess_example(
            ex["image"], ex["boxes"], ex["classes"], self.cfg,
            rng=rng, train=self.train, gt_masks=ex.get("masks"),
            canvas_hw=canvas,
        )
        out["_image_id"] = ex.get("image_id", index)
        out["_orig_hw"] = np.asarray(ex.get("orig_hw", out["image"].shape[:2]))
        return out

    def _collate(self, examples: list) -> dict:
        keys = examples[0].keys()
        return {k: np.stack([e[k] for e in examples]) for k in keys}

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        rng = np.random.RandomState(self.seed)
        if not self.train:
            order = list(range(self.shard_index, n, self.shard_count))
            # pad the tail to a full batch by repeating the last example
            while len(order) % self.batch_size:
                order.append(order[-1])
            indices_iter = iter(order)
        else:
            def infinite():
                while True:
                    # identical permutation in every process (seeded), each
                    # takes its own stride -> a disjoint global batch
                    perm = rng.permutation(n)
                    yield from perm[self.shard_index :: self.shard_count]

            indices_iter = infinite()

        q: queue.Queue = queue.Queue(maxsize=self.queue_size * self.batch_size)
        stop = threading.Event()
        lock = threading.Lock()

        def put(item) -> bool:
            """Queues ``item`` unless the consumer has stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker(wid: int):
            wrng = np.random.RandomState(self.seed * 1000 + wid)
            while not stop.is_set():
                with lock:
                    try:
                        idx = next(indices_iter)
                    except StopIteration:
                        put(None)
                        return
                try:
                    item = self._example(int(idx), wrng)
                except Exception as e:  # surfaced in the consumer
                    put(e)
                    return
                if not put(item):
                    return

        threads = [
            threading.Thread(target=worker, args=(i,), daemon=True)
            for i in range(self.num_workers)
        ]
        for t in threads:
            t.start()
        try:
            # one partial batch per canvas shape (orientation buckets)
            buckets: dict = {}
            finished_workers = 0
            while True:
                item = q.get()
                if item is None:
                    finished_workers += 1
                    if finished_workers == self.num_workers:
                        break
                    continue
                if isinstance(item, Exception):
                    raise item
                key = item["image"].shape[:2]
                buckets.setdefault(key, []).append(item)
                if len(buckets[key]) == self.batch_size:
                    yield self._collate(buckets.pop(key))
            if not self.train:  # flush partial buckets (pad by repetition)
                for batch in buckets.values():
                    while len(batch) % self.batch_size:
                        batch.append(batch[-1])
                    yield self._collate(batch)
        finally:
            stop.set()  # a worker blocked on the full queue sees it within 0.1 s
            for t in threads:
                t.join()
