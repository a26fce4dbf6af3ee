"""optimizer_ms.train: device milliseconds of ``train_step``'s
``optimizer`` span (the global-norm clip and SGD's update); the mean over
the traced slice's steps."""

from benchmark.harness import stages


def read(run):
    return stages.mean_ms(run, stages.TRAIN, ("optimizer",))
