"""Host microseconds a call of ``fused_sw_step`` (one launch of the fused
step) over the measured window, as ``model/fused.py::run_steps`` calls
it: the benchmark's span around the name."""


def read(ctx):
    n = ctx["spans"]["calls"].get("enqueue", 0)
    if not n:
        return None
    return ctx["spans"]["seconds"]["enqueue"] / n * 1e6
