"""backbone_fpn_host_ms.bulk: host milliseconds between the entry and the
exit of ``predict_fn``'s ``backbone+fpn`` span: the host's time to issue
the trunk and the FPN; the mean over the traced slice's calls. Read under
the profiler, so high by its cost per operation: the unperturbed host
time of a whole call is ``issue_ms.bulk``."""

from benchmark.harness import stages


def read(run):
    return stages.mean_ms(run, stages.PREDICT, ("backbone+fpn",), kind="host")
