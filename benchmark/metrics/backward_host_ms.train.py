"""backward_host_ms.train: host milliseconds of ``train_step``'s
``backward`` span: autograd's time to issue the backward; the mean over
the traced slice's steps. Read under the profiler, so high by its cost per
operation: the unperturbed host time of a whole step is
``issue_ms.train``."""

from benchmark.harness import stages


def read(run):
    return stages.mean_ms(run, stages.TRAIN, ("backward",), kind="host")
