"""mfu.bulk: model FLOPs of the window's predict calls (``harness/flops.py``,
from the configuration's layer shapes) over the window's seconds and the
card's bf16 dense peak (989 TFLOP/s), in percent."""

from benchmark.harness.readers import mfu_pct


def read(run):
    return mfu_pct(run)
