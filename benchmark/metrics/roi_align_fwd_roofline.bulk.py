"""roi_align_fwd_roofline.bulk: K2 (``ops/roi_align.py``'s forward) at its
roofline: the bound of one predict call's RoIAlign inputs (7x7 on the
proposals, 14x14 on the detections), captured in an untimed call after
the window, over K2's device time a call in the traced slice, in
percent."""

from benchmark.harness.readers import roofline_pct
from benchmark.harness.roofline import K2_KERNELS


def read(run):
    return roofline_pct(run, K2_KERNELS, "k2_bound_s")
