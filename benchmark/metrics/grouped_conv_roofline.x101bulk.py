"""grouped_conv_roofline.x101bulk: the grouped 3x3s at their roofline: the
summed bound of one call's grouped convolutions (each the larger of its
FLOPs over 989 TFLOP/s and its input, weight and output bytes over
3.35 TB/s, bf16; ``harness/resnext.py``) over ``grouped_conv_ms.x101bulk``,
in percent."""

from benchmark.harness import stages


def read(run):
    bound = run.stats.get("grouped_conv_bound_s")
    ms = stages.mean_ms(run, stages.PREDICT, ("grouped 3x3",))
    if not bound or not ms:
        return None
    return 100.0 * bound * 1e3 / ms
