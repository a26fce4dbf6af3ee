"""forward_ms.train: device milliseconds of the training forward, its
spans from ``anchors+draws`` to ``mask: targets + align (K2) + head +
loss`` summed a step (``faster_rcnn_train_forward``); the mean over the
traced slice's steps."""

from benchmark.harness import stages


def read(run):
    return stages.mean_ms(run, stages.TRAIN, stages.TRAIN_FORWARD)
