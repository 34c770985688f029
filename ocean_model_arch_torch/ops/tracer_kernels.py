"""Passive tracer advection-diffusion kernels in eager PyTorch
(counterpart of ``ocean_model_arch_tpu/ops/tracer_kernels.py``,
kernel/tracer/leapfrog_tracer.f90): leapfrog in time with Robert-Asselin
filtering, flux form in space on the C-grid.

All array args HALO-padded; outputs unpadded. Formulas keep the JAX
package's operation order so the f64 results agree to round-off.
"""

from __future__ import annotations

import torch

from .stencil import C, sh, wet


def tran_diff_fluxes(lcu, lcv, dxt, dyt, dxh, dyh, hhu, hhv,
                     ff, ffp, uu, vv, mu, factor_mu, flux_x, flux_y):
    """Edge fluxes: advective (centred) + diffusive
    (tran_diff_fluxes_kernel, leapfrog_tracer.f90:13-98).

    ``tracer_step`` binds uu/vv to the current barotropic velocities and
    factor_mu=1 (tracer_interface.f90:44-47); ``ffp`` is accepted for
    signature parity though the flux uses the current ``ff``
    (leapfrog_tracer.f90:63 'Try ff instead of ffp'). Land edges keep
    ``flux_x``/``flux_y``.
    """
    del ffp  # the reference computes from ff (see docstring)

    # --- x-direction (lcu) ---
    dfdx = sh(ff, 1, 0) - C(ff)
    mu_x = (C(mu) + sh(mu, 1, 0)) / 2.0 * factor_mu * C(dyh) / C(dxt)
    diff_x = mu_x * C(hhu) * dfdx
    adv_x = -C(uu) * C(hhu) * C(dyh) * (C(ff) + sh(ff, 1, 0)) / 2.0
    fx = torch.where(wet(C(lcu)), adv_x + diff_x, C(flux_x))

    # --- y-direction (lcv) ---
    dfdy = sh(ff, 0, 1) - C(ff)
    mu_y = (C(mu) + sh(mu, 0, 1)) / 2.0 * factor_mu * C(dxh) / C(dyt)
    diff_y = mu_y * C(hhv) * dfdy
    adv_y = -C(vv) * C(hhv) * C(dxh) * (C(ff) + sh(ff, 0, 1)) / 2.0
    fy = torch.where(wet(C(lcv)), adv_y + diff_y, C(flux_y))

    return fx, fy


def tran_diff_tracer(tau, lu, dx, dy, hhqn, hhqp, flux_x, flux_y, ffp, ffn):
    """Leapfrog tracer update from the flux divergence
    (tran_diff_tracer_kernel, leapfrog_tracer.f90:100-141)."""
    w = wet(C(lu))
    bp = C(hhqn) * C(dx) * C(dy) / tau / 2.0
    bp0 = C(hhqp) * C(dx) * C(dy) / tau / 2.0
    rhs = C(flux_x) - sh(flux_x, -1, 0) + C(flux_y) - sh(flux_y, 0, -1)
    eta = bp0 * C(ffp) + rhs
    new = eta / torch.where(w, bp, 1.0)
    return torch.where(w, new, C(ffn))


def tracer_next_step(time_smooth, lu, ffn, ffp, ff):
    """Robert-Asselin filter + time rotation for the tracer
    (tracer_next_step_kernel, leapfrog_tracer.f90:143-170).
    Returns (ff_new, ffp_new)."""
    w = wet(C(lu))
    filt = C(ff) + time_smooth * (C(ffn) - 2.0 * C(ff) + C(ffp)) / 2.0
    return (torch.where(w, C(ffn), C(ff)),
            torch.where(w, filt, C(ffp)))
