"""Arakawa-C land/sea mask construction (the port's own copy of
``ocean_model_arch_tpu/core/masks.py``).

Mirrors kernel/service/grid_kernels.f90:18-92: from the integer land mask
(0 = water!, 1 = land — tools/io.f90 reads it that way) derive the real-
valued T-grid mask ``lu`` and the six staggered masks:

  luh  — H-point, any of the 4 surrounding T-points wet
  luu  — H-point, all 4 surrounding T-points wet
  llu  — U-point, either adjacent T-point wet
  llv  — V-point, either adjacent T-point wet
  lcu  — U-point, both adjacent T-points wet (velocity lives here)
  lcv  — V-point, both adjacent T-points wet

Pure numpy — runs once at setup on host.
"""

from __future__ import annotations

import numpy as np


def lu_from_int_mask(mask: np.ndarray, dtype=np.float32) -> np.ndarray:
    """T-grid wet mask: 1.0 where mask == 0 (lu_init_kernel, :28-34)."""
    return (mask == 0).astype(dtype)


def derive_staggered_masks(lu: np.ndarray, periodic_x: bool = False,
                           periodic_y: bool = False):
    """All six staggered masks (lu_lv_init_kernel, :56-90).

    The reference runs the mask kernel on the halo-SYNCED lu (the sync
    carries the wrap on periodic axes), so on a periodic axis the m+1/n+1
    neighbours wrap around the seam — otherwise the derived masks would
    put a phantom wall at the last U/V column. On non-periodic axes the
    reference leaves the last row/column at its zero initialization
    (loops stop at bnd-1); shifting in zeros reproduces that, and the
    mandatory 2-cell land frame makes those points land anyway.
    """
    dtype = lu.dtype
    if periodic_x:
        lu_px = np.roll(lu, -1, axis=0)         # lu(m+1, n), wrapped
    else:
        lu_px = np.zeros_like(lu)
        lu_px[:-1, :] = lu[1:, :]               # lu(m+1, n)
    if periodic_y:
        lu_py = np.roll(lu, -1, axis=1)         # lu(m, n+1), wrapped
    else:
        lu_py = np.zeros_like(lu)
        lu_py[:, :-1] = lu[:, 1:]               # lu(m, n+1)
    lu_pxy = np.roll(lu_py, -1, axis=0) if periodic_x \
        else np.concatenate([lu_py[1:], np.zeros_like(lu_py[:1])], axis=0)

    luh = ((lu + lu_px + lu_py + lu_pxy) > 0.5).astype(dtype)
    luu = ((lu * lu_px * lu_py * lu_pxy) > 0.5).astype(dtype)
    llu = ((lu + lu_px) > 0.5).astype(dtype)
    llv = ((lu + lu_py) > 0.5).astype(dtype)
    lcu = ((lu * lu_px) > 0.5).astype(dtype)
    lcv = ((lu * lu_py) > 0.5).astype(dtype)
    return luh, luu, llu, llv, lcu, lcv


def frame_of_land_mask(nx: int, ny: int) -> np.ndarray:
    """The 'none' mask: all-water interior inside a 2-cell land frame
    (tools/io.f90:49-59). 1-based land condition m<3 | m>nx-2 | n<3 | n>ny-2
    becomes 0-based indices {0,1,nx-2,nx-1} x {0,1,ny-2,ny-1}."""
    mask = np.zeros((nx, ny), dtype=np.int32)
    mask[:2, :] = 1
    mask[-2:, :] = 1
    mask[:, :2] = 1
    mask[:, -2:] = 1
    return mask
