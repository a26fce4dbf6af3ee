"""trunk_ms.x101bulk: device milliseconds of the trunk's stage spans
``res2`` to ``res5`` (``models/resnet.py``, inside ``predict_fn``'s
``backbone+fpn``), summed a call; the mean over the traced slice's
calls."""

from benchmark.harness import stages


def read(run):
    return stages.mean_ms(run, stages.PREDICT, ("res2", "res3", "res4", "res5"))
