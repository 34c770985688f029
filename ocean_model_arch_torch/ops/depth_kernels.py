"""Water-column depth kernels in eager PyTorch (counterpart of
``ocean_model_arch_tpu/ops/depth_kernels.py``, kernel/shallow_water/
depth.f90).

The T-grid depth hq = rest bathymetry + ssh (when full_free_surface),
area-weighted onto the u/v/h grids, in three time levels {current,
p = previous, n = new}. All tensor args HALO-padded; outputs unpadded.
"""

from __future__ import annotations

import torch

from .stencil import C, sh, wet


def _interp_u(q, lu, dx, dy, dxt, dyh, w):
    """T->U area-weighted depth interpolation (depth.f90:57-66)."""
    aq = q * dx * dy * lu
    slu = C(lu) + sh(lu, 1, 0)
    num = C(aq) + sh(aq, 1, 0)
    return num / torch.where(w, slu, 1.0) / C(dxt) / C(dyh)


def _interp_v(q, lu, dx, dy, dxh, dyt, w):
    """T->V area-weighted depth interpolation (depth.f90:68-77)."""
    aq = q * dx * dy * lu
    slu = C(lu) + sh(lu, 0, 1)
    num = C(aq) + sh(aq, 0, 1)
    return num / torch.where(w, slu, 1.0) / C(dxh) / C(dyt)


def _interp_h(q, lu, dx, dy, dxb, dyb, w):
    """T->H 4-point area-weighted depth interpolation (depth.f90:79-94)."""
    aq = q * dx * dy * lu
    slu = C(lu) + sh(lu, 1, 0) + sh(lu, 0, 1) + sh(lu, 1, 1)
    num = C(aq) + sh(aq, 1, 0) + sh(aq, 0, 1) + sh(aq, 1, 1)
    return num / torch.where(w, slu, 1.0) / C(dxb) / C(dyb)


def hh_init(full_free_surface, lu, llu, llv, luh,
            dx, dy, dxt, dyt, dxh, dyh, dxb, dyb,
            ssh, sshp, h_r,
            hu, hup, hun, hv, hvp, hvn, hh, hhp, hhn):
    """All depth families from (ssh, sshp, bathymetry) (hh_init_kernel,
    depth.f90:14-99). Returns the 12 depth fields."""
    ffs = float(full_free_surface)
    hq_h = h_r + ssh * ffs
    hqp_h = h_r + sshp * ffs
    hqn_h = h_r

    wu = wet(C(llu))
    wv = wet(C(llv))
    wh = wet(C(luh))

    def u_of(q):
        return _interp_u(q, lu, dx, dy, dxt, dyh, wu)

    def v_of(q):
        return _interp_v(q, lu, dx, dy, dxh, dyt, wv)

    def h_of(q):
        return _interp_h(q, lu, dx, dy, dxb, dyb, wh)

    return (C(hq_h), C(hqp_h), C(hqn_h),
            torch.where(wu, u_of(hq_h), C(hu)),
            torch.where(wu, u_of(hqp_h), C(hup)),
            torch.where(wu, u_of(hqn_h), C(hun)),
            torch.where(wv, v_of(hq_h), C(hv)),
            torch.where(wv, v_of(hqp_h), C(hvp)),
            torch.where(wv, v_of(hqn_h), C(hvn)),
            torch.where(wh, h_of(hq_h), C(hh)),
            torch.where(wh, h_of(hqp_h), C(hhp)),
            torch.where(wh, h_of(hqn_h), C(hhn)))


def hh_update(lu, llu, llv, luh,
              dx, dy, dxt, dyt, dxh, dyh, dxb, dyb,
              ssh, h_r, hun, hvn, hhn):
    """New-level depths from the current ssh (hh_update_kernel,
    depth.f90:101-162). As in the reference, it takes the *current* ssh
    and no full_free_surface factor."""
    hqn_h = h_r + ssh
    wu = wet(C(llu))
    wv = wet(C(llv))
    wh = wet(C(luh))
    out_hun = torch.where(wu, _interp_u(hqn_h, lu, dx, dy, dxt, dyh, wu),
                          C(hun))
    out_hvn = torch.where(wv, _interp_v(hqn_h, lu, dx, dy, dxh, dyt, wv),
                          C(hvn))
    out_hhn = torch.where(wh, _interp_h(hqn_h, lu, dx, dy, dxb, dyb, wh),
                          C(hhn))
    return C(hqn_h), out_hun, out_hvn, out_hhn


def _asselin(cur, new, prev, w, ts):
    filt = cur + ts * (new - 2.0 * cur + prev) / 2.0
    return torch.where(w, filt, prev), torch.where(w, new, cur)


def hh_shift(time_smooth, lu, llu, llv, luh,
             hq, hqp, hqn, hu, hup, hun, hv, hvp, hvn, hh, hhp, hhn):
    """Robert-Asselin filter on all four depth families (hh_shift_kernel,
    depth.f90:164-211)."""
    ts = time_smooth
    hup2, hu2 = _asselin(C(hu), C(hun), C(hup), wet(C(llu)), ts)
    hvp2, hv2 = _asselin(C(hv), C(hvn), C(hvp), wet(C(llv)), ts)
    hqp2, hq2 = _asselin(C(hq), C(hqn), C(hqp), wet(C(lu)), ts)
    hhp2, hh2 = _asselin(C(hh), C(hhn), C(hhp), wet(C(luh)), ts)
    return hq2, hqp2, hu2, hup2, hv2, hvp2, hh2, hhp2
