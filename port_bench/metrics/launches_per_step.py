"""Device kernels launched in the profiled sub-window, over its model
steps."""


def read(ctx):
    p = ctx["profile"]
    if not p or not p["kernels"]:
        return None
    return len(p["kernels"]) / p["steps"]
