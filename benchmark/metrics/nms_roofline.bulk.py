"""nms_roofline.bulk: K1 (``ops/nms.py``, the greedy NMS walk) at its
roofline: the bound of one predict call's K1 inputs, captured in an
untimed call after the window (``harness/roofline.py``), over K1's device
time a call in the traced slice (its kernels by name), in percent."""

from benchmark.harness.readers import roofline_pct
from benchmark.harness.roofline import K1_KERNELS


def read(run):
    return roofline_pct(run, K1_KERNELS, "k1_bound_s")
