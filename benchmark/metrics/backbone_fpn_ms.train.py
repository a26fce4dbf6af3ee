"""backbone_fpn_ms.train: device milliseconds of the training forward's
``backbone+fpn`` span (``faster_rcnn_train_forward``), from the stream
reaching the span's entry event to its exit event; the mean over the
traced slice's steps."""

from benchmark.harness import stages


def read(run):
    return stages.mean_ms(run, stages.TRAIN, ("backbone+fpn",))
