"""The card's peaks and the least work of a step, from the configuration
alone.

The least bytes of a launch of the fused step are its carried fields read
once and written once over the basin's wet cells: the six shallow-water
fields (ssh, sshp, u, up, v, vp) and two levels (ff, ffp) of each tracer,
float32. A chained launch of two steps carries them once as well. Static
planes, tiles and layout padding are the implementation's choice and are
left out, so the count reads the same work whatever implements it.

The share is a launch's: it counts the bytes that the launch's steps
need together, so it never passes 100 % whatever a launch chains. It
follows the steps a launch takes: at the same time a step, two steps a
launch read twice the share of four, and half that of one.
``kernel_us_per_step`` is the time a step.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, bytes/s (at a 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
F32_BYTES = 4


def carried_fields(n_tracers: int) -> int:
    return 6 + 2 * n_tracers


def least_bytes_per_launch(wet_cells: int, n_tracers: int) -> int:
    """Bytes a launch must move at least: each carried field read and
    written once over the wet cells."""
    return carried_fields(n_tracers) * 2 * F32_BYTES * int(wet_cells)


def least_seconds_per_launch(wet_cells: int, n_tracers: int) -> float:
    return least_bytes_per_launch(wet_cells, n_tracers) / PEAK_BYTES_PER_S
