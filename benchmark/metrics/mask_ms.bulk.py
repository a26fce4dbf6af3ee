"""mask_ms.bulk: device milliseconds of the ``mask: align (K2) + head +
select`` span of ``predict_fn`` (K2 on the detections, the mask head, the
own class's sigmoid); the mean over the traced slice's calls."""

from benchmark.harness import stages


def read(run):
    return stages.mean_ms(run, stages.PREDICT, ("mask: align (K2) + head + select",))
