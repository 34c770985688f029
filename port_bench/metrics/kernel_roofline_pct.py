"""The fused kernel's share of its roofline: launches x the
configuration's least bytes a launch (``roofline.py``) at the card's
peak bandwidth, over the kernels' device time. A launch's share: with
more steps a launch at the same time a step it reads lower (the program
chains two steps a launch; ``kernel_us_per_step`` is the step's time)."""

from port_bench import roofline
from port_bench.metrics import fused_kernels


def read(ctx):
    k = fused_kernels(ctx["profile"])
    if not k:
        return None
    least = len(k) * roofline.least_seconds_per_launch(ctx["wet_cells"],
                                                       ctx["n_tracers"])
    return 100.0 * least / sum(s for _, s in k)
