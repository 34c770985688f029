"""Host helpers of the fused step: the array layout and the static inputs.

Counterparts of the numpy/host helpers inside
``ocean_model_arch_tpu/ops/pallas/fused_step.py`` (``margin_for`` :88,
``make_layout`` :124, ``embed``/``extract`` :151-163, ``plane_names``
:173, the guard's wet flags :1691-1705, ``staggered_wet_masks`` :1719,
``metrics_profile_from_grid`` :1771, ``static_planes`` :1809,
``fast2d_met_rows`` :1855, ``metrics_full_from_grid`` :1870), re-homed
here because that file imports ``jax.experimental.pallas``.

The layout is the port's own, not the TPU's: a physical (nx, ny) field
sits inside a land margin of ``MARGIN`` cells on every side of an
(Xs, Ys) float32 array, with Ys rounded up to a multiple of 32 floats so
every row starts on a 128-byte boundary. The margin is wider than the
fused step's stencil reach (``STEP_REACH``), so every neighbour read of
an interior cell is a real array cell, and all margin cells stay
exactly 0. The TPU layout's 8-row x margin, 128-lane rounding and tile-multiple
row count were Mosaic constraints and do not carry over.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

STEP_REACH = 3      # cells one fused step reads beyond its outputs
TRACER_REACH = 4    # the same with the tracer pass (sshn at halo 2)
ROW_ALIGN = 32      # Ys is a multiple of this many floats (128 bytes)
N_PROF = 24         # profile rows (9 metrics + 7 reciprocals + 6 derived)
N_FULL = 22         # the rows of them that carry a meaning (0-21)
N_GENERAL = 16      # the rows the general form reads: 0-8 and 9-15
METRIC_NAMES = ("dx", "dy", "dxt", "dyt", "dxh", "dyh", "dxb", "dyb",
                "rlh_s")


def margin_for(steps_per_launch: int, n_tracers: int = 0) -> int:
    """Land margin for a kernel that chains ``steps_per_launch`` steps:
    their total reach, and at least 4 cells."""
    reach = TRACER_REACH if n_tracers else STEP_REACH
    return max(4, reach * int(steps_per_launch))


MARGIN = margin_for(1)   # one step per launch, with or without tracers
assert MARGIN == margin_for(1, n_tracers=1)


class FusedLayout(NamedTuple):
    nx: int          # physical extents
    ny: int
    Xs: int          # stored rows = nx + 2 * margin
    Ys: int          # stored columns >= ny + 2 * margin, ROW_ALIGN multiple
    margin: int = MARGIN


def make_layout(nx: int, ny: int) -> FusedLayout:
    Ys = -(-(ny + 2 * MARGIN) // ROW_ALIGN) * ROW_ALIGN
    return FusedLayout(nx, ny, nx + 2 * MARGIN, Ys, MARGIN)


def embed(lay: FusedLayout, a: torch.Tensor) -> torch.Tensor:
    """Place an (nx, ny) field into the fused layout, float32, zeros
    (land) elsewhere, on ``a``'s device."""
    out = torch.zeros((lay.Xs, lay.Ys), dtype=torch.float32, device=a.device)
    m = lay.margin
    out[m:m + lay.nx, m:m + lay.ny] = a
    return out


def extract(lay: FusedLayout, a: torch.Tensor) -> torch.Tensor:
    """Crop back to the physical (nx, ny) extents (a view)."""
    m = lay.margin
    return a[m:m + lay.nx, m:m + lay.ny]


def plane_names(ffs: int, ksw: int, mu_const: float,
                hr_const: float | None = None, metrics_2d: bool = False,
                fast2d: bool = False) -> tuple:
    """The static planes a configuration needs:

    - ``rslu_u/v/h``: reciprocal wet-neighbour counts of the depth
      interpolations, premultiplied by 1/dxt, 1/dyt and 1/(dxb*dyb);
    - ``ludxdy`` = lu*dx*dy, the weighted depth column's static factor
      (``ludxdy > 0.5`` doubles as the wet mask);
    - ``hrludxdy`` = hhq_rest*lu*dx*dy, unless the bathymetry is flat and
      folds into the scalar ``hr_const``;
    - ``wlu``: the TPU kernel's viscosity branch multiplies by it. The
      CUDA kernel takes every mask from ``ludxdy > 0.5`` and never loads
      it: ``fused_step.kernel_planes`` names what that kernel reads.

    On metric planes (``metrics_2d``) without ``fast2d`` the step is the
    general form, which reads only the three reciprocal counts, without
    the metric factors (JAX ``plane_names`` :197-198).
    """
    if metrics_2d and not fast2d:
        return ("rslu_u", "rslu_v", "rslu_h")
    names = ["rslu_u", "rslu_v", "rslu_h", "ludxdy"]
    if not (hr_const is not None and ffs):
        names.append("hrludxdy")
    if ksw and mu_const != 0.0:
        names.append("wlu")
    return tuple(names)


def tile_wet(lu_s, lay: FusedLayout, tx: int, ty: int) -> np.ndarray:
    """The tile guard's flags: an int32 (x tiles, y tiles) array, 1 where
    the ``tx`` x ``ty`` output tile of the kernel's grid (tiles start at
    the array's corner and the last ones overhang it) holds a wet cell
    of the embedded mask ``lu_s``, else 0."""
    wet = np.asarray(lu_s) > 0.5
    ntx, nty = -(-lay.Xs // tx), -(-lay.Ys // ty)
    full = np.zeros((ntx * tx, nty * ty), bool)
    full[:lay.Xs, :lay.Ys] = wet
    return full.reshape(ntx, tx, nty, ty).any(axis=(1, 3)).astype(np.int32)


def staggered_wet_masks(lu) -> tuple:
    """(wlcu, wlcv, wlu) float32 0/1 masks from a T-point wet mask in any
    layout: the wet sets of the u, v and T points (grid_kernels.f90:
    40-92 lcu/lcv/lu)."""
    lu_b = np.asarray(lu) > 0.5
    x1 = np.zeros_like(lu_b)
    x1[:-1] = lu_b[1:]
    y1 = np.zeros_like(lu_b)
    y1[:, :-1] = lu_b[:, 1:]
    return ((lu_b & x1).astype(np.float32),
            (lu_b & y1).astype(np.float32),
            lu_b.astype(np.float32))


def _extend(a: np.ndarray, m: int, size: int, wrap: bool,
            axis: int) -> np.ndarray:
    """``a`` with ``m`` cells put before it and ``size - n - m`` after it
    along ``axis``: copies of its edge values, or, with ``wrap``, its far
    edge's cells in the ``m`` cells on either side (a periodic axis) and
    copies of the edge beyond them."""
    n = a.shape[axis]
    pad = [(0, 0)] * a.ndim
    if wrap:
        pad[axis] = (m, m)
        a = np.pad(a, pad, mode="wrap")
        pad[axis] = (0, size - n - 2 * m)
    else:
        pad[axis] = (m, size - n - m)
    return np.pad(a, pad, mode="edge")


def metrics_profile_from_grid(grid, lay: FusedLayout,
                              periodic_y: bool = False) -> np.ndarray:
    """The (N_PROF, Ys) latitude profiles of an x-uniform grid; raises
    ValueError if a metric varies along x. Row meanings:

    0-8 dx, dy, dxt, dyt, dxh, dyh, dxb, dyb, rlh_s; 9 1/(dx*dy);
    10-15 1/dxt, 1/dyt, 1/dxh, 1/dyh, 1/dxb, 1/dyb; 16 (dyt-dyb)/4;
    17 (dxt(n+1)-dxb)/4; 18 (dxt-dxb)/4; 19 dy/dx; 20 dx/dy;
    21 rlh_s*dxb*dyb/4.

    The grid's metrics are extended into the y margins, so reciprocals
    stay finite: by their edge values, or, on a periodic y axis
    (``periodic_y``, which needs ``lay.Ys == lay.ny + 2 * lay.margin``),
    by the values across the seam, where row 17's n + 1 wraps too.
    """
    rows = np.zeros((N_PROF, lay.Ys), np.float32)
    for k, name in enumerate(METRIC_NAMES):
        f = getattr(grid, name).cpu().numpy()
        if not np.array_equal(f, np.broadcast_to(f[:1, :], f.shape)):
            raise ValueError(f"metric {name} is not x-uniform")
        rows[k] = _extend(f[0, :], lay.margin, lay.Ys, periodic_y, 0)
    _derive_metric_rows(rows, periodic_y)
    return rows


def _derive_metric_rows(rows: np.ndarray, wrap_y: bool = False) -> None:
    """Fill rows 9-21 of a (>= 22, ..., Ys) metric stack from its rows
    0-8, pointwise in float32; the last axis is y, and dxt(n+1) wraps
    along it with ``wrap_y``. What is not finite (a zero metric) becomes
    0."""
    with np.errstate(divide="ignore", invalid="ignore"):
        rows[9] = np.float32(1.0) / (rows[0] * rows[1])
        for k, src in ((10, 2), (11, 3), (12, 4), (13, 5), (14, 6),
                       (15, 7)):
            rows[k] = np.float32(1.0) / rows[src]
        rows[16] = (rows[3] - rows[7]) * np.float32(0.25)
        dxt_n1 = (np.roll(rows[2], -1, axis=-1) if wrap_y else
                  np.concatenate([rows[2][..., 1:], rows[2][..., -1:]],
                                 axis=-1))
        rows[17] = (dxt_n1 - rows[6]) * np.float32(0.25)
        rows[18] = (rows[2] - rows[6]) * np.float32(0.25)
        rows[19] = rows[1] / rows[0]
        rows[20] = rows[0] / rows[1]
        rows[21] = rows[8] * rows[6] * rows[7] * np.float32(0.25)
    rows[9:][~np.isfinite(rows[9:])] = 0.0


def metrics_full_from_grid(grid, lay: FusedLayout, periodic_x: bool = False,
                           periodic_y: bool = False,
                           derived: bool = True) -> np.ndarray:
    """The (N_FULL, Xs, Ys) metric planes of a grid whose metrics vary
    along x and y (bipolar / curvilinear): the rows of
    :func:`metrics_profile_from_grid`, computed pointwise in the same
    order of float32 operations. The 9 grid metrics are edge-replicated
    through the whole margin (y first, then the x rows, which covers the
    corners), or wrapped across the seam of a periodic axis, before rows
    9-21 are derived, so no reciprocal is infinite; row 17 takes dxt at
    n + 1 after that. ``derived=False``: the (N_GENERAL, Xs, Ys) planes of
    rows 0-15, what the general form of the step reads (the JAX
    function's default)."""
    planes = np.zeros((N_FULL, lay.Xs, lay.Ys), np.float32)
    m = lay.margin
    for k, name in enumerate(METRIC_NAMES):
        f = getattr(grid, name).cpu().numpy().astype(np.float32)
        planes[k] = _extend(_extend(f, m, lay.Ys, periodic_y, 1), m, lay.Xs,
                            periodic_x, 0)
    _derive_metric_rows(planes, periodic_y)
    return planes if derived else planes[:N_GENERAL].copy()


def fast2d_met_rows(n_tracers: int, visc: bool = False,
                    trans: int = 1) -> tuple:
    """The metric rows the fused step reads (row meanings of
    :func:`metrics_profile_from_grid`); the 2D-metrics path streams only
    these planes. The masks come from ``ludxdy > 0.5``, so the rows 14
    and 15 that the TPU kernel's thresholds need are among them only
    with viscosity, whose shear stress reads them; the vorticity rows
    16-18 only with momentum advection (``trans``)."""
    rows = {9, 10, 11, 21}
    if trans:
        rows |= {16, 17, 18}
    if visc:
        rows |= {0, 1, 6, 7, 12, 13, 14, 15, 19, 20}
    if n_tracers:
        rows |= {0, 1}
    return tuple(sorted(rows))


def static_planes(lu_s: np.ndarray, hr_s: np.ndarray, dxdy: np.ndarray,
                  names: tuple, interp_recips=None) -> np.ndarray:
    """(len(names), Xs, Ys) float32 static planes, pure functions of the
    land mask, bathymetry and metrics (see :func:`plane_names`; ``hr``
    is the embedded rest bathymetry ``hr_s`` itself).
    ``dxdy``: (Xs, Ys) plane or (1, Ys) profile row. ``interp_recips``:
    (1/dxt, 1/dyt, 1/(dxb*dyb)), as (1, Ys) rows or (Xs, Ys) planes,
    folded into the rslu planes."""
    lu = np.asarray(lu_s, np.float32)
    x1 = np.zeros_like(lu)
    x1[:-1, :] = lu[1:, :]          # lu[i+1, j]
    y1 = np.zeros_like(lu)
    y1[:, :-1] = lu[:, 1:]          # lu[i, j+1]
    xy1 = np.zeros_like(lu)
    xy1[:-1, :-1] = lu[1:, 1:]      # lu[i+1, j+1]

    def recip(s):
        return np.float32(1.0) / np.maximum(s, 1.0)

    if interp_recips is not None:
        r_u, r_v, r_h = (np.asarray(r, np.float32) for r in interp_recips)
    else:
        r_u = r_v = r_h = np.float32(1.0)

    ludxdy = (lu * np.asarray(dxdy, np.float32)).astype(np.float32)
    if "ludxdy" in names:
        wet = ludxdy[lu > 0.5]
        if wet.size and wet.min() <= 0.5:
            raise ValueError("dx*dy too small for ludxdy to double as the "
                             "wet mask")
    build = {
        "rslu_u": lambda: recip(lu + x1) * r_u,
        "rslu_v": lambda: recip(lu + y1) * r_v,
        "rslu_h": lambda: recip(lu + x1 + y1 + xy1) * r_h,
        "wlu": lambda: lu,
        "lu": lambda: lu,
        "hr": lambda: np.asarray(hr_s, np.float32),
        "ludxdy": lambda: ludxdy,
        "hrludxdy": lambda: (np.asarray(hr_s, np.float32)
                             * ludxdy).astype(np.float32),
    }
    return np.stack([build[n]() for n in names]).astype(np.float32)
