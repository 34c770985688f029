"""Device microseconds of the kernels named ``fused_sw_*`` over the
profiled sub-window's model steps."""

from port_bench.metrics import fused_kernels


def read(ctx):
    p = ctx["profile"]
    k = fused_kernels(p)
    if not k:
        return None
    return sum(s for _, s in k) / p["steps"] * 1e6
