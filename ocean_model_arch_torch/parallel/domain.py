"""Shard-divisible domain padding (counterpart of
``ocean_model_arch_tpu/parallel/domain.py``).

The reference pads any nx*ny grid into its block decomposition via the
mmm/nnn frame convention (configs/basinpar.f90:86-89). On a px x py mesh
the analog is: pad the global extents up to multiples of the mesh dims
with LAND cells (mask 0 -> the physics never touches them; metrics and
the rest depth edge-replicated, so no zero-divisions appear), run
sharded, and crop on output.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..core.grid import Grid, MASK_FIELDS
from ..core.state import SWState


def padded_extents(nx: int, ny: int, px: int, py: int):
    def up(a, b):
        return -(-a // b) * b
    return up(nx, px), up(ny, py)


def _pad_zero(a: torch.Tensor, tx: int, ty: int) -> torch.Tensor:
    return F.pad(a, (0, ty - a.shape[-1], 0, tx - a.shape[-2]))


def _pad_edge(a: torch.Tensor, tx: int, ty: int) -> torch.Tensor:
    """Pad the last two axes to (tx, ty) with copies of the last row and
    column."""
    ix = torch.arange(tx, device=a.device).clamp_(max=a.shape[-2] - 1)
    iy = torch.arange(ty, device=a.device).clamp_(max=a.shape[-1] - 1)
    return a.index_select(-2, ix).index_select(-1, iy)


def pad_grid(grid: Grid, px: int, py: int) -> Grid:
    """Pad every 2D grid field to mesh-divisible extents: masks with land
    (zeros), metrics, Coriolis and the rest depth edge-replicated
    (positive, finite). The port's Grid has no 1D coordinates yet."""
    tx, ty = padded_extents(grid.nx, grid.ny, px, py)
    if (tx, ty) == (grid.nx, grid.ny):
        return grid
    upd = {}
    for f in dataclasses.fields(grid):
        v = getattr(grid, f.name)
        if not isinstance(v, torch.Tensor) or v.ndim < 2:
            continue
        upd[f.name] = (_pad_zero(v, tx, ty) if f.name in MASK_FIELDS
                       else _pad_edge(v, tx, ty))
    return dataclasses.replace(grid, nx=tx, ny=ty, **upd)


def pad_state(state: SWState, px: int, py: int) -> SWState:
    """Pad every state field with zeros (land values)."""
    nx, ny = state.ssh.shape[-2:]
    tx, ty = padded_extents(nx, ny, px, py)
    if (tx, ty) == (nx, ny):
        return state
    return dataclasses.replace(state, **{
        f.name: _pad_zero(v, tx, ty) for f in dataclasses.fields(state)
        if isinstance(v := getattr(state, f.name), torch.Tensor)
        and v.ndim >= 2})


def crop_state(state: SWState, nx: int, ny: int) -> SWState:
    """Crop a padded state back to the physical extents."""
    return dataclasses.replace(state, **{
        f.name: v[..., :nx, :ny] for f in dataclasses.fields(state)
        if isinstance(v := getattr(state, f.name), torch.Tensor)
        and v.ndim >= 2})
