"""Shallow-water physics kernels in eager PyTorch (counterpart of
``ocean_model_arch_tpu/ops/sw_kernels.py``).

Each function is one stencil kernel of the reference's kernel layer
(kernel/shallow_water/{vel_ssh,mixing}.f90) as a function of
HALO-padded 2D tensors (see ops/stencil.py); the reference's
``if (mask > 0.5)`` guards become ``torch.where`` selects that keep the
previous value at land points.

Precision contract, as in the JAX package: state tensors are f64 in
validation mode and metric/mask tensors f32; mixed products promote to
f64 the way Fortran's implicit promotion does. Formulas keep the JAX
package's operation order so the f64 results agree to round-off.
"""

from __future__ import annotations

import math

import torch

from ..host import DPI, FREE_FALL_ACC
from .stencil import C, sh, wet

G = float(FREE_FALL_ACC)        # the reference's f32 9.8, as a Python float
SSH_ERR_BOUND = 1.0e4           # |ssh| abort threshold (vel_ssh.f90:52)


def gaussian_bump(lu, ssh, sigma: float, nx0: int, ny0: int):
    """Gaussian initial SSH (gaussian_elimination_kernel, vel_ssh.f90:15-38).

    ``nx0``/``ny0`` are 1-based Fortran indices of the bump center. All
    args padded; returns the unpadded updated ssh.
    """
    nx = lu.shape[0] - 4
    ny = lu.shape[1] - 4
    kw = dict(dtype=ssh.dtype, device=ssh.device)
    m = torch.arange(1, nx + 1, **kw)[:, None]        # Fortran m index
    n = torch.arange(1, ny + 1, **kw)[None, :]
    dx = (m - nx0) / (nx0 * 0.25)
    dy = (n - ny0) / (ny0 * 0.25)
    bump = (1.0 / (math.sqrt(2.0 * DPI) * sigma)) * torch.exp(
        -(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    return torch.where(wet(C(lu)), bump, C(ssh))


def check_ssh_ok(lu, ssh):
    """Per-step stability guard (check_ssh_err_kernel, vel_ssh.f90:40-67):
    a 0-dim bool tensor, True iff every wet ssh is finite and |ssh| < 1e4
    (NaN compares False, so it is caught too)."""
    s = C(ssh)
    ok = (s < SSH_ERR_BOUND) & (s > -SSH_ERR_BOUND)
    return torch.where(wet(C(lu)), ok, True).all()


def update_ssh(tau, lu, dx, dy, dxh, dyh, hhu, hhv, sshn, sshp, ubrtr, vbrtr):
    """Continuity (sw_update_ssh_kernel, vel_ssh.f90:69-106):
    sshn = sshp - 2*tau*div(u*h, v*h) on T-points (mask lu)."""
    uflux = ubrtr * hhu * dyh
    vflux = vbrtr * hhv * dxh
    div = (C(uflux) - sh(uflux, -1, 0)
           + C(vflux) - sh(vflux, 0, -1)) / (C(dx) * C(dy))
    new = C(sshp) + 2.0 * tau * (-div)
    return torch.where(wet(C(lu)), new, C(sshn))


def update_uv(tau, lcu, lcv, dxt, dyt, dxh, dyh, dxb, dyb,
              hhu, hhun, hhup, hhv, hhvn, hhvp, hhh, ssh,
              ubrtr, ubrtrn, ubrtrp, vbrtr, vbrtrn, vbrtrp,
              rdis, rlh_s, rhsx, rhsy, rhsx_adv, rhsy_adv,
              rhsx_dif, rhsy_dif):
    """Semi-implicit momentum update on C-grid u/v points (sw_update_uv,
    vel_ssh.f90:108-195): pressure gradient, 4-point Coriolis, Rayleigh
    dissipation, divided by the new-level water-column inertia bp."""
    wu = wet(C(lcu))
    wv = wet(C(lcv))
    g = G

    corio = rlh_s * hhh * dxb * dyb    # padded H-point Coriolis product

    # --- zonal (lcu) ---
    bp = C(hhun) * C(dxt) * C(dyh) / 2.0 / tau
    bp0 = C(hhup) * C(dxt) * C(dyh) / 2.0 / tau
    slx = -g * (sh(ssh, 1, 0) - C(ssh)) * C(dyh) * C(hhu)
    grx = (C(rhsx) + slx + C(rhsx_dif) + C(rhsx_adv)
           - (C(rdis) + sh(rdis, 1, 0)) / 2.0
           * C(ubrtrp) * C(dxt) * C(dyh) * C(hhu)
           + (C(corio) * (sh(vbrtr, 1, 0) + C(vbrtr))
              + sh(corio, 0, -1) * (sh(vbrtr, 1, -1) + sh(vbrtr, 0, -1))
              ) / 4.0)
    u_new = (C(ubrtrp) * bp0 + grx) / torch.where(wu, bp, 1.0)
    u_out = torch.where(wu, u_new, C(ubrtrn))

    # --- meridional (lcv) ---
    bpv = C(hhvn) * C(dyt) * C(dxh) / 2.0 / tau
    bpv0 = C(hhvp) * C(dyt) * C(dxh) / 2.0 / tau
    sly = -g * (sh(ssh, 0, 1) - C(ssh)) * C(dxh) * C(hhv)
    gry = (C(rhsy) + sly + C(rhsy_dif) + C(rhsy_adv)
           - (C(rdis) + sh(rdis, 0, 1)) / 2.0
           * C(vbrtrp) * C(dxh) * C(dyt) * C(hhv)
           - (C(corio) * (sh(ubrtr, 0, 1) + C(ubrtr))
              + sh(corio, -1, 0) * (sh(ubrtr, -1, 1) + sh(ubrtr, -1, 0))
              ) / 4.0)
    v_new = (C(vbrtrp) * bpv0 + gry) / torch.where(wv, bpv, 1.0)
    v_out = torch.where(wv, v_new, C(vbrtrn))

    return u_out, v_out


def _asselin(cur, new, prev, w, ts):
    filt = cur + ts * (new - 2.0 * cur + prev) / 2.0
    return torch.where(w, filt, prev), torch.where(w, new, cur)


def next_step(time_smooth, lu, lcu, lcv,
              ssh, sshn, sshp, ubrtr, ubrtrn, ubrtrp, vbrtr, vbrtrn, vbrtrp):
    """Time-level rotation (prev, cur) <- (filtered cur, new) with the
    Robert-Asselin filter (sw_next_step, vel_ssh.f90:197-245)."""
    ts = time_smooth
    sshp2, ssh2 = _asselin(C(ssh), C(sshn), C(sshp), wet(C(lu)), ts)
    up2, u2 = _asselin(C(ubrtr), C(ubrtrn), C(ubrtrp), wet(C(lcu)), ts)
    vp2, v2 = _asselin(C(vbrtr), C(vbrtrn), C(vbrtrp), wet(C(lcv)), ts)
    return ssh2, sshp2, u2, up2, v2, vp2


def uv_trans_vort(luu, dxt, dyt, dxb, dyb, u, v, vort):
    """Circulation-based relative vorticity on H-points (mask luu)
    (uv_trans_vort_kernel, vel_ssh.f90:247-281)."""
    vd = v * dyt
    ud = u * dxt
    circ = ((sh(vd, 1, 0) - C(vd)) - (sh(ud, 0, 1) - C(ud))
            - ((sh(v, 1, 0) - C(v)) * C(dyb) - (sh(u, 0, 1) - C(u)) * C(dxb)))
    return torch.where(wet(C(luu)), circ, C(vort))


def uv_trans(lcu, lcv, luu, dxh, dyh, u, v, vort, hq, hu, hv, hh,
             rhsx_adv, rhsy_adv):
    """Flux-form momentum advection (uv_trans_kernel, vel_ssh.f90:283-373):
    edge fluxes of momentum plus the vorticity term."""
    ud = u * dyh * hu        # zonal mass flux on U-points (padded)
    vd = v * dxh * hv        # meridional mass flux on V-points
    vorth = vort * hh

    # --- zonal momentum (lcu) ---
    fx_p = (C(ud) + sh(ud, 1, 0)) / 2.0 * (C(u) + sh(u, 1, 0)) / 2.0
    fx_m = (C(ud) + sh(ud, -1, 0)) / 2.0 * (C(u) + sh(u, -1, 0)) / 2.0
    fy_p = ((C(vd) + sh(vd, 1, 0)) / 2.0
            * (sh(u, 0, 1) + C(u)) / 2.0 * C(luu))
    fy_m = ((sh(vd, 0, -1) + sh(vd, 1, -1)) / 2.0
            * (sh(u, 0, -1) + C(u)) / 2.0 * sh(luu, 0, -1))
    adv_x = (-(fx_p - fx_m + fy_p - fy_m)
             + (C(vorth) * (sh(v, 1, 0) + C(v))
                + sh(vorth, 0, -1) * (sh(v, 1, -1) + sh(v, 0, -1))) / 4.0)
    rx = torch.where(wet(C(lcu)), adv_x, C(rhsx_adv))

    # --- meridional momentum (lcv) ---
    gy_p = (C(vd) + sh(vd, 0, 1)) / 2.0 * (C(v) + sh(v, 0, 1)) / 2.0
    gy_m = (C(vd) + sh(vd, 0, -1)) / 2.0 * (C(v) + sh(v, 0, -1)) / 2.0
    gx_p = (C(ud) + sh(ud, 0, 1)) / 2.0 * (sh(v, 1, 0) + C(v)) / 2.0
    gx_m = ((sh(ud, -1, 0) + sh(ud, -1, 1)) / 2.0
            * (sh(v, -1, 0) + C(v)) / 2.0)
    adv_y = (-(gx_p - gx_m + gy_p - gy_m)
             - (C(vorth) * (sh(u, 0, 1) + C(u))
                + sh(vorth, -1, 0) * (sh(u, -1, 1) + sh(u, -1, 0))) / 4.0)
    ry = torch.where(wet(C(lcv)), adv_y, C(rhsy_adv))

    return rx, ry


def stress_components(lu, luu, dx, dy, dxt, dyt, dxh, dyh, dxb, dyb,
                      u, v, str_t, str_s):
    """Tension str_t on T-points (lu), shear str_s on H-points (luu)
    (stress_components_kernel, mixing.f90:14-58)."""
    q = u / dyh
    r = v / dxh
    t_new = (C(dy) / C(dx) * (C(q) - sh(q, -1, 0))
             - C(dx) / C(dy) * (C(r) - sh(r, 0, -1)))
    s1 = u / dxt
    s2 = v / dyt
    s_new = (C(dxb) / C(dyb) * (sh(s1, 0, 1) - C(s1))
             + C(dyb) / C(dxb) * (sh(s2, 1, 0) - C(s2)))
    return (torch.where(wet(C(lu)), t_new, C(str_t)),
            torch.where(wet(C(luu)), s_new, C(str_s)))


def uv_diff2(lcu, lcv, dx, dy, dxt, dyt, dxh, dyh, dxb, dyb,
             mu, str_t, str_s, hq, hu, hv, hh, rhsx_dif, rhsy_dif):
    """Laplacian viscosity from the stress divergence (uv_diff2_kernel,
    vel_ssh.f90:375-452)."""
    a = (dy * dy) * mu * hq * str_t       # padded T-point tension flux
    b = (dx * dx) * mu * hq * str_t

    muh_p = (C(mu) + sh(mu, 1, 0) + sh(mu, 0, 1) + sh(mu, 1, 1)) / 4.0

    # --- zonal (lcu) ---
    muh_mx = (C(mu) + sh(mu, 1, 0) + sh(mu, 0, -1) + sh(mu, 1, -1)) / 4.0
    dif_x = ((sh(a, 1, 0) - C(a)) / C(dyh)
             + (C(dxb) * C(dxb) * muh_p * C(hh) * C(str_s)
                - sh(dxb, 0, -1) * sh(dxb, 0, -1) * muh_mx
                * sh(hh, 0, -1) * sh(str_s, 0, -1)) / C(dxt))
    rx = torch.where(wet(C(lcu)), dif_x, C(rhsx_dif))

    # --- meridional (lcv) ---
    muh_my = (C(mu) + sh(mu, -1, 0) + sh(mu, 0, 1) + sh(mu, -1, 1)) / 4.0
    dif_y = (-(sh(b, 0, 1) - C(b)) / C(dxh)
             + (C(dyb) * C(dyb) * muh_p * C(hh) * C(str_s)
                - sh(dyb, -1, 0) * sh(dyb, -1, 0) * muh_my
                * sh(hh, -1, 0) * sh(str_s, -1, 0)) / C(dyt))
    ry = torch.where(wet(C(lcv)), dif_y, C(rhsy_dif))

    return rx, ry
