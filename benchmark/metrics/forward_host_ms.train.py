"""forward_host_ms.train: host milliseconds of the training forward's
spans (``anchors+draws`` to the mask stage) summed a step: the host's time
to issue the forward; the mean over the traced slice's steps. Read under
the profiler, so high by its cost per operation: the unperturbed host
time of a whole step is ``issue_ms.train``."""

from benchmark.harness import stages


def read(run):
    return stages.mean_ms(run, stages.TRAIN, stages.TRAIN_FORWARD, kind="host")
