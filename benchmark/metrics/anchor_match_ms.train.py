"""anchor_match_ms.train: device milliseconds of the RPN's ``anchor match``
span (``layers/anchor_target.py``, inside ``rpn targets+loss``: each
anchor's best gt, its labels and the force match), summed a step; the mean
over the traced slice's steps. None for a program without the span."""

from benchmark.harness import stages


def read(run):
    return stages.mean_ms(run, stages.TRAIN, ("anchor match",))
