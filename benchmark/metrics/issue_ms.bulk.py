"""issue_ms.bulk: host milliseconds from calling ``Detector.predict_fn`` to
its return, before any synchronise; the mean over the window's calls."""

from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "issue_s")
