"""backbone_fpn_ms.bulk: device milliseconds of the ``backbone+fpn`` span
of ``predict_fn`` (``faster_rcnn_eval_forward``: the ResNet trunk with its
frozen BatchNorm, and the FPN), from the stream reaching the span's entry
event to its exit event; the mean over the traced slice's calls."""

from benchmark.harness import stages


def read(run):
    return stages.mean_ms(run, stages.PREDICT, ("backbone+fpn",))
