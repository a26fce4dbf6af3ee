"""Wall-clock stage timing: the port of ``detectron_tpu/utils/timer.py``.

PyTorch on the card returns before the device is done, so a ``toc`` meant
to time the device's work must follow ``torch.cuda.synchronize()``;
without it the timer reads the host's time to issue the work.
"""

from __future__ import annotations

import time
from collections import defaultdict


class Timer:
    """Mean host seconds per named section, over its ``tic`` / ``toc`` pairs."""

    def __init__(self):
        self.total = defaultdict(float)
        self.calls = defaultdict(int)
        self._start = {}

    def tic(self, name: str = "default"):
        self._start[name] = time.perf_counter()

    def toc(self, name: str = "default") -> float:
        dt = time.perf_counter() - self._start[name]
        self.total[name] += dt
        self.calls[name] += 1
        return dt

    def average(self, name: str = "default") -> float:
        return self.total[name] / max(self.calls[name], 1)

    def summary(self) -> str:
        return " | ".join(
            f"{k}: {self.average(k) * 1000:.1f}ms" for k in sorted(self.total)
        )
