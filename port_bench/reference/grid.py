"""The grid of a run directory in numpy: the land mask, the Arakawa-C
masks, the metric steps and the Coriolis factor (the reference model's
grid_kernels.f90 and grid_parameters.f90), for regular cartesian and
spherical grids without rotation of the pole and closed basins: what the
benchmark's configurations run. Anything else raises.

Metric steps are float32 as the reference stores them (wp4); the degree
trigonometry is float64 on the reference's double-precision pi.
"""

from __future__ import annotations

import os

import numpy as np

DPI = 3.14159265358979
DPIP180 = DPI / 180.0
PIP180_F32 = np.float32(np.float32(3.1415926) / np.float32(180.0))
RAD_EARTH = np.float32(6371000.0)
EARTH_ANG_VEL = np.float32(7.2921159e-5)
LAT_EXTR = 89.99999
REST_DEPTH_M = 100.0        # flat bathymetry where the run names none
MASK_NAMES = ("lu", "luu", "luh", "lcu", "lcv", "llu", "llv")
METRIC_NAMES = ("dx", "dy", "dxt", "dyt", "dxh", "dyh", "dxb", "dyb",
                "rlh_s")


def read_mask(path: str, nx: int, ny: int) -> np.ndarray:
    """The ASCII land mask (a header line, then ny rows of nx digits, 1
    land, 0 water, the top row first) as an (nx, ny) int array."""
    with open(path, "rb") as f:
        rows = [r for r in f.read().split(b"\n")[1:] if r.strip()]
    if len(rows) < ny:
        raise ValueError(f"mask {path}: {len(rows)} rows < ny={ny}")
    top_first = np.stack([np.frombuffer(r[:nx], np.uint8) for r in rows[:ny]])
    return (top_first[::-1].T - ord("0")).astype(np.int32)


def frame_mask(nx: int, ny: int) -> np.ndarray:
    """The mask ``none``: water inside a two-cell frame of land."""
    m = np.zeros((nx, ny), np.int32)
    m[:2], m[-2:], m[:, :2], m[:, -2:] = 1, 1, 1, 1
    return m


def masks(int_mask: np.ndarray) -> dict:
    """lu (T points wet) and the six staggered masks, closed basin: the
    neighbour past the last row or column is land."""
    lu = (int_mask == 0).astype(np.float32)
    px = np.zeros_like(lu)
    px[:-1] = lu[1:]                 # lu(m+1, n)
    py = np.zeros_like(lu)
    py[:, :-1] = lu[:, 1:]           # lu(m, n+1)
    pxy = np.zeros_like(lu)
    pxy[:-1] = py[1:]                # lu(m+1, n+1)
    f = np.float32
    return dict(lu=lu,
                luh=((lu + px + py + pxy) > 0.5).astype(f),
                luu=((lu * px * py * pxy) > 0.5).astype(f),
                llu=((lu + px) > 0.5).astype(f),
                llv=((lu + py) > 0.5).astype(f),
                lcu=((lu * px) > 0.5).astype(f),
                lcv=((lu * py) > 0.5).astype(f))


def _cosd(x):
    return np.cos(np.asarray(x, np.float64) * DPIP180)


def _sind(x):
    return np.sin(np.asarray(x, np.float64) * DPIP180)


def _coords(b: dict):
    xt = b["rlon"] + (np.arange(b["nx"], dtype=np.float64) - 2) * b["dxst"]
    yt = b["rlat"] + (np.arange(b["ny"], dtype=np.float64) - 2) * b["dyst"]
    xu = np.append((xt[:-1] + xt[1:]) / 2.0, xt[-1] + (xt[-1] - xt[-2]) / 2)
    yv = np.append((yt[:-1] + yt[1:]) / 2.0, yt[-1] + (yt[-1] - yt[-2]) / 2)
    return xt, yt, xu, yv


def metrics(b: dict) -> dict:
    """Metric steps in metres and the Coriolis factor rlh_s on the H
    points, (nx, ny) float32 each. T points (xt, yt): dx, dy; U (xu, yt):
    dxt, dyh; V (xt, yv): dxh, dyt; H (xu, yv): dxb, dyb, rlh_s."""
    if b["xgr_type"] or b["ygr_type"]:
        raise ValueError("the reference runs regular grids only")
    if b["curve_grid"] not in (0, 1) or b["rotation_on_lon"] \
            or b["rotation_on_lat"]:
        raise ValueError("the reference runs cartesian and unrotated "
                         "spherical grids only")
    nx, ny = b["nx"], b["ny"]
    scale = PIP180_F32 * RAD_EARTH
    sx = np.float32(b["dxst"]) * scale
    sy = np.float32(b["dyst"]) * scale
    xt, yt, xu, yv = _coords(b)
    one = np.ones((nx, ny), np.float32)

    def factors(y):
        """The x step's factor on a grid of latitudes y, and sin(lat)."""
        if b["curve_grid"] == 0:
            return one, np.full((nx, ny), np.float32(1.0)
                                / np.sqrt(np.float32(2.0)), np.float32)
        lat = np.broadcast_to(np.asarray(y)[None, :], (nx, ny))
        mx = _cosd(np.clip(lat, -LAT_EXTR, LAT_EXTR)).astype(np.float32)
        sin_lat = np.clip(_sind(lat), -_sind(LAT_EXTR), _sind(LAT_EXTR))
        return mx, sin_lat.astype(np.float32)

    m_t, _ = factors(yt)            # T and U points share yt
    m_v, sin_h = factors(yv)        # V and H points share yv
    ones_x = np.full((nx, ny), sx, np.float32)
    ones_y = np.full((nx, ny), sy, np.float32)
    return dict(dx=ones_x * m_t, dy=ones_y * one, dxt=ones_x * m_t,
                dyh=ones_y * one, dxh=ones_x * m_v, dyt=ones_y * one,
                dxb=ones_x * m_v, dyb=ones_y * one,
                rlh_s=np.full((nx, ny), np.float32(2.0) * EARTH_ANG_VEL,
                              np.float32) * sin_h)


def build(settings: dict, run_dir: str) -> dict:
    """Every static field the step reads, (nx, ny) numpy arrays: the
    masks, the metrics and the rest depth ``hr`` (float32)."""
    b = settings["basin"]
    if b["periodic_x"] or b["periodic_y"]:
        raise ValueError("the reference runs closed basins only")
    if b["topo"] != "none":
        raise ValueError("the reference runs flat bathymetry only")
    nx, ny = b["nx"], b["ny"]
    im = (frame_mask(nx, ny) if b["mask"] == "none"
          else read_mask(os.path.join(run_dir, b["mask"]), nx, ny))
    g = masks(im)
    g.update(metrics(b))
    g["hr"] = np.full((nx, ny), REST_DEPTH_M, np.float32)
    return g


def read_record(path: str, nx: int, ny: int) -> np.ndarray:
    """The first GrADS record of a file: the (nx - 4) x (ny - 4)
    interior as float32 in Fortran order, -1e32 (land) read as 0; the
    two-cell frame 0."""
    inner = np.fromfile(path, np.float32, (nx - 4) * (ny - 4))
    inner = inner.reshape((nx - 4, ny - 4), order="F")
    out = np.zeros((nx, ny), np.float32)
    out[2:-2, 2:-2] = np.where(inner <= np.float32(-0.5e32), 0.0, inner)
    return out
