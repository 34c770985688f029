"""The share of the measured window in which no operation ran on the
card: the profiled window's device busy time a model step, times the
measured window's steps, over the measured window's wall time. The
measured window runs without the profiler, whose host cost a launch would
lengthen the idle time; the spans a traced run installs there cost the
host about a microsecond a launch."""


def read(ctx):
    p, w = ctx["profile"], ctx["window"]
    if not p or not p["steps"] or not w["steps"] or not w["seconds"] > 0:
        return None
    busy = p["busy_s"] / p["steps"] * w["steps"]
    return 100.0 * (1.0 - busy / w["seconds"])
