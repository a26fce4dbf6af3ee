"""Scalar metrics logging: the port of ``detectron_tpu/utils/metrics.py``.

``MetricsWriter`` appends one JSON record a call to ``metrics.jsonl`` in
its directory (``step``, ``time``, then the scalars as floats, the JAX
writer's records) and, when ``torch.utils.tensorboard`` can be imported,
the same scalars as TensorBoard summaries under ``tb/`` (the JAX writer
uses TensorFlow's).
"""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # no tensorboard package: JSONL only
                SummaryWriter = None
            if SummaryWriter is not None:
                self.tb = SummaryWriter(os.path.join(log_dir, "tb"))

    def write(self, step: int, scalars: dict):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), global_step=int(step))
            self.tb.flush()

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
