"""Grid coordinates, metric steps, Coriolis and geo-transform construction (the port's own copy of
``ocean_model_arch_tpu/core/metrics.py``).

Mirrors kernel/service/grid_kernels.f90 (grid_base_init_kernel,
grid_geo_init_kernel) + kernel/service/grid_parameters.f90 (cartesian /
rotated-spherical / bipolar-curvilinear metric math). Pure numpy, runs once
at setup: metric fields are float32 (reference wp4), geo coordinates and
rotation coefficients float64, with degree-trig built on the reference's
double-precision pi constant (math_tools.f90 shims) so f64-mode validation
matches the Fortran bit-for-bit scale.

Grid staggering of the metric pairs (grid_geo_init_kernel call sites):
  T-grid (xt, yt): dx, dy     U-grid (xu, yt): dxt, dyh
  V-grid (xt, yv): dxh, dyt   H-grid (xu, yv): dxb, dyb
Rotation coefficients are computed on the T-grid only; Coriolis factors on
the H-grid only.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config.basinpar import BasinConfig
from .constants import (DPIP180, EARTH_ANG_VEL, LAT_EXTR, PIP180_F32,
                        RAD_EARTH)


# --- degree trig on the reference's pi (math_tools.f90:12-63) -------------

def _sind(x):
    return np.sin(np.asarray(x, np.float64) * DPIP180)


def _cosd(x):
    return np.cos(np.asarray(x, np.float64) * DPIP180)


def _tand(x):
    return np.tan(np.asarray(x, np.float64) * DPIP180)


def _asind(x):
    return np.arcsin(x) / DPIP180


def _acosd(x):
    return np.arccos(x) / DPIP180


# --------------------------------------------------------------------------

def build_coords(basin: BasinConfig):
    """Model coordinates xt/yt (T) and xu/yv (U/V midpoints) in degrees
    (grid_base_init_kernel, grid_kernels.f90:114-148)."""
    nx, ny = basin.nx, basin.ny
    if basin.xgr_type == 0:
        # xt(m) = rlon + (m - mmm)*dxst, 1-based m -> 0-based i = m-1
        xt = basin.rlon + (np.arange(nx, dtype=np.float64) - (basin.mmm - 1)) * basin.dxst
    else:
        xt = np.asarray(basin.x_levels, np.float64)
    if basin.ygr_type == 0:
        yt = basin.rlat + (np.arange(ny, dtype=np.float64) - (basin.nnn - 1)) * basin.dyst
    else:
        yt = np.asarray(basin.y_levels, np.float64)

    xu = np.empty_like(xt)
    xu[:-1] = (xt[:-1] + xt[1:]) / 2.0
    xu[-1] = xt[-1] + (xt[-1] - xt[-2]) / 2.0  # unconsumed extrapolation
    yv = np.empty_like(yt)
    yv[:-1] = (yt[:-1] + yt[1:]) / 2.0
    yv[-1] = yt[-1] + (yt[-1] - yt[-2]) / 2.0
    return xt, yt, xu, yv


def build_base_metrics(basin: BasinConfig, xt, yt, xu, yv):
    """Metric steps in metres, float32 (grid_base_init_kernel,
    grid_kernels.f90:150-198), before the geo-transform factors."""
    nx, ny = basin.nx, basin.ny
    scale = PIP180_F32 * RAD_EARTH  # f32, as sngl(step)*pip180*RadEarth

    if basin.xgr_type > 0:
        dxt_1d = np.zeros(nx, np.float32)
        dxt_1d[:-1] = (xt[1:] - xt[:-1]).astype(np.float32) * scale
        dxt_1d[-1] = dxt_1d[-2]
        dx_1d = np.zeros(nx, np.float32)
        dx_1d[1:] = (xu[1:] - xu[:-1]).astype(np.float32) * scale
        dx_1d[0] = dx_1d[1]
        dxt = np.repeat(dxt_1d[:, None], ny, axis=1)
        dxb = dxt.copy()
        dx = np.repeat(dx_1d[:, None], ny, axis=1)
        dxh = dx.copy()
    else:
        v = np.float32(basin.dxst) * scale
        dxt = np.full((nx, ny), v, np.float32)
        dxb = np.full((nx, ny), v, np.float32)
        dx = np.full((nx, ny), v, np.float32)
        dxh = np.full((nx, ny), v, np.float32)

    if basin.ygr_type > 0:
        dyt_1d = np.zeros(ny, np.float32)
        dyt_1d[:-1] = (yt[1:] - yt[:-1]).astype(np.float32) * scale
        dyt_1d[-1] = dyt_1d[-2]
        dy_1d = np.zeros(ny, np.float32)
        dy_1d[1:] = (yv[1:] - yv[:-1]).astype(np.float32) * scale
        dy_1d[0] = dy_1d[1]
        dyt = np.repeat(dyt_1d[None, :], nx, axis=0)
        dyb = dyt.copy()
        dy = np.repeat(dy_1d[None, :], nx, axis=0)
        dyh = dy.copy()
    else:
        v = np.float32(basin.dyst) * scale
        dyt = np.full((nx, ny), v, np.float32)
        dyb = np.full((nx, ny), v, np.float32)
        dy = np.full((nx, ny), v, np.float32)
        dyh = np.full((nx, ny), v, np.float32)

    rlh_s = np.full((nx, ny), np.float32(2.0) * EARTH_ANG_VEL, np.float32)
    rlh_c = np.full((nx, ny), np.float32(-2.0) * EARTH_ANG_VEL, np.float32)
    return dict(dx=dx, dy=dy, dxt=dxt, dyt=dyt, dxh=dxh, dyh=dyh,
                dxb=dxb, dyb=dyb, rlh_s=rlh_s, rlh_c=rlh_c)


# --------------------------------------------------------------------------
# Per-grid geo transforms. Each returns (geo_lon, geo_lat, mx_factor,
# my_factor, rot_coef | None, sin_lat, cos_lat); factors multiply the f32
# metric arrays, sin/cos_lat multiply the Coriolis fields on the H-grid.
# --------------------------------------------------------------------------

def geo_cartesian(x_mod, y_mod, key_rot: bool):
    """Identity transform (grid_parameters_carthesian, :16-78).

    Coriolis factor: the reference divides rlh by sqrt(2) on the H-grid
    (':72-74', an f/sqrt(2) f-plane convention)."""
    nx, ny = len(x_mod), len(y_mod)
    geo_lon = np.broadcast_to(x_mod[:, None], (nx, ny)).astype(np.float64)
    geo_lat = np.broadcast_to(y_mod[None, :], (nx, ny)).astype(np.float64)
    mx = np.ones((nx, ny), np.float32)
    my = np.ones((nx, ny), np.float32)
    rot = None
    if key_rot:
        rot = np.zeros((nx, ny, 4), np.float64)
        rot[..., 0] = 1.0
        rot[..., 3] = 1.0
    inv_sqrt2 = np.float32(1.0) / np.sqrt(np.float32(2.0))
    sin_lat = np.full((nx, ny), inv_sqrt2, np.float32)
    cos_lat = np.full((nx, ny), inv_sqrt2, np.float32)
    return geo_lon, geo_lat, mx, my, rot, sin_lat, cos_lat


def geo_spherical(x_mod, y_mod, rot_lon: float, rot_lat: float,
                  key_rot: bool):
    """Rotated-sphere transform (grid_parameters_spherical, :80-181)."""
    nx, ny = len(x_mod), len(y_mod)
    X = np.broadcast_to(x_mod[:, None], (nx, ny))
    Y = np.broadcast_to(y_mod[None, :], (nx, ny))
    lat_mod = np.clip(Y, -LAT_EXTR, LAT_EXTR)
    sinlat_extr = _sind(LAT_EXTR)

    sin_lat = _sind(Y) * _cosd(rot_lat) + _cosd(X) * _cosd(Y) * _sind(rot_lat)
    sin_lat = np.clip(sin_lat, -sinlat_extr, sinlat_extr)
    cos_lat = np.sqrt(1.0 - sin_lat ** 2)
    geo_lat = _asind(sin_lat)

    ft_cos = (_cosd(X) * _cosd(Y) * _cosd(rot_lat)
              - _sind(Y) * _sind(rot_lat)) / cos_lat
    ft_sin = (_sind(X) * _cosd(Y)) / cos_lat
    cos_lon = ft_cos * _cosd(rot_lon) - ft_sin * _sind(rot_lon)
    sin_lon = ft_sin * _cosd(rot_lon) + ft_cos * _sind(rot_lon)
    norm = np.maximum(np.sqrt(cos_lon ** 2 + sin_lon ** 2), 1e-10)
    cos_lon = cos_lon / norm
    sin_lon = sin_lon / norm
    geo_lon = np.sign(sin_lon) * np.abs(_acosd(cos_lon))
    geo_lon = np.where(sin_lon == 0.0, np.abs(_acosd(cos_lon)), geo_lon)

    mx = _cosd(lat_mod).astype(np.float32)
    my = np.ones((nx, ny), np.float32)

    rot = None
    if key_rot:
        cos_latm = _cosd(lat_mod)
        r1 = (cos_lat * _cosd(rot_lat) + sin_lat * _sind(rot_lat)
              * (cos_lon * _cosd(rot_lon) + sin_lon * _sind(rot_lon))) / cos_latm
        r2 = (-_sind(rot_lat)
              * (sin_lon * _cosd(rot_lon) - cos_lon * _sind(rot_lon))) / cos_latm
        rot = np.stack([r1, r2, -r2, r1], axis=-1)
        det = np.maximum(np.sqrt(rot[..., 0] * rot[..., 3]
                                 - rot[..., 1] * rot[..., 2]), 1e-10)
        rot = rot / det[..., None]

    return (geo_lon, geo_lat, mx, my, rot,
            sin_lat.astype(np.float32), cos_lat.astype(np.float32))


def geo_curvilinear(x_mod, y_mod, x_pole, y_pole, p_pole, q_pole,
                    key_rot: bool):
    """Bipolar (distorted spherical) transform via the conformal map
    (grid_parameters_curvilinear, :183-416)."""
    nx, ny = len(x_mod), len(y_mod)
    y_pole1 = np.clip(y_pole, -LAT_EXTR, LAT_EXTR)
    q_pole1 = np.clip(q_pole, -LAT_EXTR, LAT_EXTR)
    sinlat_extr = _sind(LAT_EXTR)

    # Midpoint of the two displaced poles on the unit sphere -> (lm, phm)
    xn = _cosd(x_pole) * _cosd(y_pole)
    yn = _sind(x_pole) * _cosd(y_pole)
    zn = _sind(y_pole)
    xs = _cosd(p_pole) * _cosd(q_pole)
    ys = _sind(p_pole) * _cosd(q_pole)
    zs = _sind(q_pole)
    xm, ym, zm = (xn + xs) / 2.0, (yn + ys) / 2.0, (zn + zs) / 2.0
    r3d = max(np.sqrt(xm * xm + ym * ym + zm * zm), 1e-10)
    r2d = max(np.sqrt(xm * xm + ym * ym), 1e-10)
    sinphm = np.clip(zm / r3d, -sinlat_extr, sinlat_extr)
    phm = _asind(sinphm)
    coslm, sinlm = xm / r2d, ym / r2d
    nrm = max(np.sqrt(coslm ** 2 + sinlm ** 2), 1e-10)
    coslm, sinlm = coslm / nrm, sinlm / nrm
    lm = np.sign(sinlm) * _acosd(coslm) if sinlm != 0 else _acosd(coslm)

    # Stereographic images of the poles and the alpha normalization
    s0 = 2.0 * _tand(45.0 + y_pole1 / 2.0) * _cosd(x_pole)
    t0 = 2.0 * _tand(45.0 + y_pole1 / 2.0) * _sind(x_pole)
    a0 = 2.0 * _tand(45.0 + q_pole1 / 2.0) * _cosd(p_pole)
    b0 = 2.0 * _tand(45.0 + q_pole1 / 2.0) * _sind(p_pole)

    def map_ab(S, T, alpha):
        num1 = (S - alpha * a0) * (S - alpha * s0) + (T - alpha * b0) * (T - alpha * t0)
        num2 = (T - alpha * b0) * (S - alpha * s0) - (S - alpha * a0) * (T - alpha * t0)
        numa = s0 * num1 - t0 * num2
        numb = s0 * num2 + t0 * num1
        denom = (S - alpha * s0) ** 2 + (T - alpha * t0) ** 2
        return numa / denom, numb / denom, denom, numa, numb

    phm1 = np.clip(phm, -LAT_EXTR, LAT_EXTR)
    Sm = 2.0 * _tand(45.0 + phm1 / 2.0) * _cosd(lm)
    Tm = 2.0 * _tand(45.0 + phm1 / 2.0) * _sind(lm)
    am, bm, _, _, _ = map_ab(Sm, Tm, 1.0)
    alpha = 2.0 / np.sqrt(am * am + bm * bm)

    X = np.broadcast_to(x_mod[:, None], (nx, ny))
    Y = np.broadcast_to(y_mod[None, :], (nx, ny))
    lat_mod = np.clip(Y, -LAT_EXTR, LAT_EXTR)

    S = 2.0 * _tand(45.0 + lat_mod / 2.0) * _cosd(X)
    T = 2.0 * _tand(45.0 + lat_mod / 2.0) * _sind(X)
    a, b, denom1, numa, numb = map_ab(S, T, alpha)

    ab2 = a * a + b * b
    sin_lat = np.clip((ab2 - 4.0) / (ab2 + 4.0), -sinlat_extr, sinlat_extr)
    cos_lat = np.sqrt(1.0 - sin_lat ** 2)
    geo_lat = _asind(sin_lat)

    cos_lon = a / np.sqrt(ab2)
    sin_lon = b / np.sqrt(ab2)
    nrm = np.maximum(np.sqrt(cos_lon ** 2 + sin_lon ** 2), 1e-10)
    cos_lon, sin_lon = cos_lon / nrm, sin_lon / nrm
    geo_lon = np.sign(sin_lon) * np.abs(_acosd(cos_lon))

    # Differential of the transform (':339-393')
    dx_da = -b / ab2
    dx_db = a / ab2
    dy_da = a / (np.sqrt(ab2) * (1.0 + ab2 / 4.0))
    dy_db = b / (np.sqrt(ab2) * (1.0 + ab2 / 4.0))

    numd1 = S - alpha * s0 + S - alpha * a0
    numd2 = T - alpha * t0 + T - alpha * b0
    numd3 = alpha * (t0 - b0)
    numd4 = alpha * (a0 - s0)
    numas = s0 * numd1 - t0 * numd3
    numat = s0 * numd2 - t0 * numd4
    numbs = t0 * numd1 + s0 * numd3
    numbt = t0 * numd2 + s0 * numd4
    da_ds = numas / denom1 - numa * 2.0 * (S - alpha * s0) / (denom1 * denom1)
    da_dt = numat / denom1 - numa * 2.0 * (T - alpha * t0) / (denom1 * denom1)
    db_ds = numbs / denom1 - numb * 2.0 * (S - alpha * s0) / (denom1 * denom1)
    db_dt = numbt / denom1 - numb * 2.0 * (T - alpha * t0) / (denom1 * denom1)

    ds_dp = -2.0 * _tand(45.0 + lat_mod / 2.0) * _sind(X)
    ds_dq = _cosd(X) / (_cosd(45.0 + lat_mod / 2.0)) ** 2
    dt_dp = 2.0 * _tand(45.0 + lat_mod / 2.0) * _cosd(X)
    dt_dq = _sind(X) / (_cosd(45.0 + lat_mod / 2.0)) ** 2

    da_dp = da_ds * ds_dp + da_dt * dt_dp
    da_dq = da_ds * ds_dq + da_dt * dt_dq
    db_dp = db_ds * ds_dp + db_dt * dt_dp
    db_dq = db_ds * ds_dq + db_dt * dt_dq

    dx_dp = dx_da * da_dp + dx_db * db_dp
    dx_dq = dx_da * da_dq + dx_db * db_dq
    dy_dp = dy_da * da_dp + dy_db * db_dp
    dy_dq = dy_da * da_dq + dy_db * db_dq

    det = dy_dq * dx_dp - dx_dq * dy_dp
    f11 = dy_dq / det
    f12 = -dx_dq / det
    f21 = -dy_dp / det
    f22 = dx_dp / det

    hp_r = np.sqrt((dx_dp * cos_lat) ** 2 + dy_dp ** 2)
    hq_r = np.sqrt((dx_dq * cos_lat) ** 2 + dy_dq ** 2)
    mx = hp_r.astype(np.float32)
    my = hq_r.astype(np.float32)

    rot = None
    if key_rot:
        rot = np.stack([f11 * hp_r / cos_lat, f12 * hp_r,
                        f21 * hq_r / cos_lat, f22 * hq_r], axis=-1)
        det_r = np.maximum(np.sqrt(rot[..., 0] * rot[..., 3]
                                   - rot[..., 1] * rot[..., 2]), 1e-10)
        rot = rot / det_r[..., None]

    return (geo_lon, geo_lat, mx, my, rot,
            sin_lat.astype(np.float32), cos_lat.astype(np.float32))


@dataclasses.dataclass
class GeoMetrics:
    """Everything grid_geo_init_kernel produces."""
    dx: np.ndarray
    dy: np.ndarray
    dxt: np.ndarray
    dyt: np.ndarray
    dxh: np.ndarray
    dyh: np.ndarray
    dxb: np.ndarray
    dyb: np.ndarray
    rlh_s: np.ndarray
    rlh_c: np.ndarray
    rotvec_coeff: np.ndarray
    geo_lon_t: np.ndarray
    geo_lat_t: np.ndarray
    geo_lon_u: np.ndarray
    geo_lat_u: np.ndarray
    geo_lon_v: np.ndarray
    geo_lat_v: np.ndarray
    geo_lon_h: np.ndarray
    geo_lat_h: np.ndarray
    sqt: np.ndarray
    squ: np.ndarray
    sqv: np.ndarray
    sqh: np.ndarray
    rlh_sqh: np.ndarray


def build_geo_metrics(basin: BasinConfig) -> "tuple":
    """Full metric construction: base + per-grid geo transform + areas
    (grid_geo_init_kernel, grid_kernels.f90:206-538). Returns
    (xt, yt, xu, yv, GeoMetrics)."""
    xt, yt, xu, yv = build_coords(basin)
    base = build_base_metrics(basin, xt, yt, xu, yv)

    def transform(x, y, key_rot, key_cor):
        if basin.curve_grid == 0:
            return geo_cartesian(x, y, key_rot)
        elif basin.curve_grid == 1:
            return geo_spherical(x, y, basin.rotation_on_lon,
                                 basin.rotation_on_lat, key_rot)
        elif basin.curve_grid == 2:
            return geo_curvilinear(x, y, basin.x_pole, basin.y_pole,
                                   basin.p_pole, basin.q_pole, key_rot)
        raise ValueError(f"unknown curve_grid={basin.curve_grid}")

    # T-grid: metr (dx, dy), rotation coefficients
    lon_t, lat_t, mx, my, rot, _, _ = transform(xt, yt, key_rot=True,
                                                key_cor=False)
    dx = base["dx"] * mx
    dy = base["dy"] * my
    # U-grid: (dxt, dyh)
    lon_u, lat_u, mx, my, _, _, _ = transform(xu, yt, False, False)
    dxt = base["dxt"] * mx
    dyh = base["dyh"] * my
    # V-grid: (dxh, dyt)
    lon_v, lat_v, mx, my, _, _, _ = transform(xt, yv, False, False)
    dxh = base["dxh"] * mx
    dyt = base["dyt"] * my
    # H-grid: (dxb, dyb) + Coriolis
    lon_h, lat_h, mx, my, _, sin_l, cos_l = transform(xu, yv, False, True)
    dxb = base["dxb"] * mx
    dyb = base["dyb"] * my
    if basin.curve_grid == 0:
        # cartesian f-plane convention: rlh / sqrt(2)
        rlh_s = base["rlh_s"] * sin_l
        rlh_c = base["rlh_c"] * cos_l
    else:
        rlh_s = base["rlh_s"] * sin_l
        rlh_c = base["rlh_c"] * cos_l

    sqt = dx * dy
    squ = dxt * dyh
    sqv = dxh * dyt
    sqh = dxb * dyb
    rlh_sqh = rlh_s * sqh

    geo = GeoMetrics(
        dx=dx, dy=dy, dxt=dxt, dyt=dyt, dxh=dxh, dyh=dyh, dxb=dxb, dyb=dyb,
        rlh_s=rlh_s, rlh_c=rlh_c, rotvec_coeff=rot,
        geo_lon_t=lon_t, geo_lat_t=lat_t, geo_lon_u=lon_u, geo_lat_u=lat_u,
        geo_lon_v=lon_v, geo_lat_v=lat_v, geo_lon_h=lon_h, geo_lat_h=lat_h,
        sqt=sqt, squ=squ, sqv=sqv, sqh=sqh, rlh_sqh=rlh_sqh)
    return xt, yt, xu, yv, geo
