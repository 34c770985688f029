"""Static grid data as a dataclass of tensors (counterpart of
``ocean_model_arch_tpu/core/grid.py::Grid, build_grid``).

The masks and metrics come from the port's numpy host modules; this
module only places them on a device (the current CUDA device unless the
caller names one). Fields are unpadded ``(nx, ny)`` tensors with
0-based ``[x, y]`` indexing. The
geographic coordinates, areas and vertical levels of the JAX Grid are
output-side data; they join when the ``OceanModel`` driver and I/O are
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..host import (BasinConfig, Precision, default_device, masks,
                    metrics)

# Tensor fields, in the order of the JAX Grid
MASK_FIELDS = ("lu", "luu", "luh", "lcu", "lcv", "llu", "llv")
METRIC_FIELDS = ("dx", "dy", "dxt", "dyt", "dxh", "dyh", "dxb", "dyb",
                 "rlh_s")
GRID_FIELDS = MASK_FIELDS + METRIC_FIELDS + ("hhq_rest",)


@dataclasses.dataclass
class Grid:
    # Arakawa-C masks (grid.f90:23-38), float32
    lu: torch.Tensor
    luu: torch.Tensor
    luh: torch.Tensor
    lcu: torch.Tensor
    lcv: torch.Tensor
    llu: torch.Tensor
    llv: torch.Tensor
    # Metric steps [m] (grid.f90:56-63) and Coriolis (grid.f90:52), float32
    dx: torch.Tensor
    dy: torch.Tensor
    dxt: torch.Tensor
    dyt: torch.Tensor
    dxh: torch.Tensor
    dyh: torch.Tensor
    dxb: torch.Tensor
    dyb: torch.Tensor
    rlh_s: torch.Tensor
    # Rest-state bathymetry on T-points (grid.f90:44), state dtype
    hhq_rest: torch.Tensor
    nx: int
    ny: int
    periodic_x: bool = False
    periodic_y: bool = False


def grid_from_numpy(d: dict, device=None, periodic_x: bool = False,
                    periodic_y: bool = False) -> Grid:
    """A Grid from numpy arrays named as the JAX Grid's fields (e.g.
    ``{n: np.asarray(getattr(jax_grid, n)) for n in GRID_FIELDS}``); each
    array keeps its dtype, so both packages start from identical bits.
    ``device``: None -> the current CUDA device (raises without one)."""
    if device is None:
        device = default_device()
    t = {n: torch.tensor(np.asarray(d[n]), device=device) for n in GRID_FIELDS}
    nx, ny = t["lu"].shape
    return Grid(**t, nx=int(nx), ny=int(ny), periodic_x=bool(periodic_x),
                periodic_y=bool(periodic_y))


def build_grid(basin: BasinConfig, int_mask: np.ndarray,
               hhq_rest: Optional[np.ndarray] = None,
               precision: Precision = Precision.f64(),
               device=None) -> Grid:
    """Grid from config + integer land mask (0 = water, 1 = land), as the
    JAX ``build_grid`` builds it. ``hhq_rest``: rest bathymetry [m] on
    T-points; None -> flat 100 m (init_data.f90:113-114). ``device``: None
    -> the current CUDA device (raises without one); tests pass "cpu"."""
    nx, ny = basin.nx, basin.ny
    if int_mask.shape != (nx, ny):
        raise ValueError(f"mask shape {int_mask.shape} != {(nx, ny)}")
    px, py = bool(basin.periodicity_x), bool(basin.periodicity_y)
    lu = masks.lu_from_int_mask(int_mask, precision.mask_dtype)
    luh, luu, llu, llv, lcu, lcv = masks.derive_staggered_masks(
        lu, periodic_x=px, periodic_y=py)
    _, _, _, _, geo = metrics.build_geo_metrics(basin)
    if hhq_rest is None:
        hr = np.full((nx, ny), 100.0, dtype=precision.state_dtype)
    else:
        hr = np.asarray(hhq_rest, dtype=precision.state_dtype)
    d = dict(lu=lu, luu=luu, luh=luh, lcu=lcu, lcv=lcv, llu=llu, llv=llv,
             hhq_rest=hr)
    d.update({n: getattr(geo, n) for n in METRIC_FIELDS})
    return grid_from_numpy(d, device, px, py)
