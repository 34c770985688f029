"""ASCII land/sea mask IO (tools/io.f90:36-82 format) (the port's own copy of
``ocean_model_arch_tpu/io/mask_io.py``).

File layout: one header comment line, then ny rows of nx digits (0 water,
1 land), stored top row (n=ny) first — the reference reads
``do n = ny, 1, -1``.
"""

from __future__ import annotations

import numpy as np

from ..core.masks import frame_of_land_mask


def read_mask(path: str, nx: int, ny: int) -> np.ndarray:
    """Read a mask file into an (nx, ny) int array, [m, n] 0-based.

    Uses the native C++ parser (io/native.py) when available."""
    from . import native
    out = native.read_mask(path, nx, ny)
    if out is not None:
        return out
    with open(path, "r") as f:
        lines = f.read().splitlines()
    rows = [ln for ln in lines[1:] if ln.strip()]
    if len(rows) < ny:
        raise ValueError(f"mask {path}: {len(rows)} rows < ny={ny}")
    mask = np.zeros((nx, ny), dtype=np.int32)
    for i in range(ny):
        n = ny - 1 - i          # first data row is the top (n = ny)
        row = rows[i]
        if len(row) < nx:
            raise ValueError(f"mask {path}: row {i} has {len(row)} < nx={nx}")
        mask[:, n] = np.frombuffer(row[:nx].encode(), dtype=np.uint8) - ord("0")
    return mask


def load_mask(mask_file_name: str, nx: int, ny: int,
              base_dir: str = ".") -> np.ndarray:
    """'none' -> frame-of-land mask (io.f90:49-59), else read the file."""
    if mask_file_name == "none":
        return frame_of_land_mask(nx, ny)
    import os
    return read_mask(os.path.join(base_dir, mask_file_name), nx, ny)


def write_mask(path: str, mask: np.ndarray, header: str = "mask") -> None:
    """Write in the same format (round-trip capable)."""
    nx, ny = mask.shape
    with open(path, "w") as f:
        f.write(header + "\n")
        for n in range(ny - 1, -1, -1):
            f.write("".join(str(int(v)) for v in mask[:, n]) + "\n")
