"""backward_ms.train: device milliseconds of a step's backward, between
CUDA events recorded at ``train_step``'s own ``mark`` callbacks (the
forward's last stage, then ``"backward"``); the mean over the window's
steps."""

import statistics


def read(run):
    samples = run.stats.get("backward_ms")
    return statistics.fmean(samples) if samples else None
