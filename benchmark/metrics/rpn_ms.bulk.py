"""rpn_ms.bulk: device milliseconds of the ``rpn head`` and ``proposals
(K1)`` spans of ``predict_fn`` (the RPN's convolutions, then top-k,
decode and K1 on each image's proposals), summed a call; the mean over
the traced slice's calls."""

from benchmark.harness import stages


def read(run):
    return stages.mean_ms(run, stages.PREDICT, ("rpn head", "proposals (K1)"))
