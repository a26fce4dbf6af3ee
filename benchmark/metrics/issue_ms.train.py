"""issue_ms.train: host milliseconds from calling ``train_step`` to its
return, with no synchronise; the mean over the window's steps."""

from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "issue_s")
