"""Per-layer metrics, one reader a file: ``<name>.py`` defines
``read(ctx)``, which returns the metric's value from what the traced run
recorded, or None when it finds nothing to read (the harness then leaves
the metric out). ``ctx`` holds:

- ``timers``: the program's phase timers (``OceanModel.timers.acc``),
  seconds by phase;
- ``spans``: the benchmark's host spans over the measured window,
  ``{"seconds": {name: s}, "calls": {name: n}}`` (``trace.Spans``);
- ``profile``: the profiled sub-window (``trace.reduce``) with ``steps``,
  its model steps, or None;
- ``window``: the measured window, ``{"seconds": wall s, "steps": model
  steps}``;
- ``wet_cells``, ``n_tracers``: of the configuration.
"""


def fused_kernels(profile) -> list:
    """(name, seconds) of the profiled kernels of the fused step."""
    if not profile:
        return []
    return [k for k in profile["kernels"] if "fused_sw_" in k[0]]
