"""box_ms.bulk: device milliseconds of the ``box: align (K2) + head`` and
``detections (K1)`` spans of ``predict_fn`` (K2 on the proposals, the
2-FC box head, then the candidates' decode and the class-aware K1),
summed a call; the mean over the traced slice's calls."""

from benchmark.harness import stages


def read(run):
    return stages.mean_ms(run, stages.PREDICT, ("box: align (K2) + head", "detections (K1)"))
