"""grouped_conv_ms.x101bulk: device milliseconds of the ``grouped 3x3``
spans (each bottleneck's grouped conv2, ``models/resnet.py``), summed a
call; the mean over the traced slice's calls."""

from benchmark.harness import stages


def read(run):
    return stages.mean_ms(run, stages.PREDICT, ("grouped 3x3",))
