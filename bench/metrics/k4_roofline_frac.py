"""K4's share of its roofline: the least time the traced calls could take
(bench/yardstick.py, the work the steps need) over the device time of
csrc/stencil3d.cu's kernels in the profiler's trace."""
from bench.harness import roofline_share

UNIT = "%"
KERNEL = "stencil3d_kernel"


def read(r):
    return roofline_share(r, KERNEL)
