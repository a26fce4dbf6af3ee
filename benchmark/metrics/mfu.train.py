"""mfu.train: model FLOPs of the window's training steps (forward and the
backward the trainable weights and their inputs need, no recompute;
``harness/flops.py``) over the window's seconds and the card's bf16 dense
peak (989 TFLOP/s), in percent."""

from benchmark.harness.readers import mfu_pct


def read(run):
    return mfu_pct(run)
