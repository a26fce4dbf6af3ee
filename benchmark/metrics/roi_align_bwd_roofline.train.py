"""roi_align_bwd_roofline.train: K3 (``ops/roi_align.py``'s backward) at
its roofline: the bound of a step's two RoIAlign gradients (7x7 on the
sampled RoIs, 14x14 on the foreground slots; g and the level gradients
from the shapes) over K3's device time a step in the traced slice, in
percent."""

from benchmark.harness.readers import roofline_pct
from benchmark.harness.roofline import K3_KERNELS


def read(run):
    return roofline_pct(run, K3_KERNELS, "k3_bound_s")
