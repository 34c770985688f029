"""Model step composition in eager PyTorch (counterpart of
``ocean_model_arch_tpu/model/step.py``, control/shallow_water/
shallow_water.f90 expl_shallow_water).

One barotropic step is the ordered application of the ops/ kernels
against a *halo provider*: ``hp.ex(f)`` gives f with a ghost frame whose
cells are valid (stencil-read arguments), ``hp.zp(f)`` with an arbitrary
one (pointwise-read arguments). This composition is the port's own
oracle for its fused CUDA kernel, as the jnp composition is for the
Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..core.grid import Grid
from ..core.state import SWState
from ..host import ModelConfig
from ..ops import depth_kernels as dk
from ..ops import sw_kernels as swk
from ..ops import tracer_kernels as trk
from ..ops.stencil import pad


class GlobalHalo:
    """Single-device halo provider: the ghost frame lies outside the
    global domain -- zeros for closed boundaries, wrap for periodic."""

    def __init__(self, periodic_x: bool = False, periodic_y: bool = False):
        self.periodic_x = periodic_x
        self.periodic_y = periodic_y

    def ex(self, f):
        return pad(f, self.periodic_x, self.periodic_y)

    def ex_batch(self, fields) -> None:
        """No-op: the global pad needs no communication (a sharded
        provider batches its strip exchange here)."""

    def zp(self, f):
        return pad(f)


def sw_step(state: SWState, grid: Grid, cfg: ModelConfig, tau, hp) -> SWState:
    """One barotropic step (expl_shallow_water, shallow_water.f90:22-94)."""
    sw = cfg.sw
    ts = sw.time_smooth
    ex, zp = hp.ex, hp.zp

    lu, lcu, lcv, luu, luh = (ex(grid.lu), zp(grid.lcu), zp(grid.lcv),
                              ex(grid.luu), zp(grid.luh))
    llu, llv = zp(grid.llu), zp(grid.llv)
    dx, dy = ex(grid.dx), ex(grid.dy)
    dxt, dyt = ex(grid.dxt), ex(grid.dyt)
    dxh, dyh = ex(grid.dxh), ex(grid.dyh)
    dxb, dyb = ex(grid.dxb), ex(grid.dyb)
    rlh_s = ex(grid.rlh_s)
    h_r = ex(grid.hhq_rest)

    s = state
    batch = [s.hhu, s.hhv, s.hhh, s.ssh, s.ubrtr, s.vbrtr, s.r_diss]
    if sw.ksw_lat > 0:
        batch += [s.ubrtrp, s.vbrtrp, s.mu]
    hp.ex_batch(batch)

    # 1. continuity -> sshn
    sshn = swk.update_ssh(tau, lu, dx, dy, dxh, dyh,
                          ex(s.hhu), ex(s.hhv), zp(s.sshn), zp(s.sshp),
                          ex(s.ubrtr), ex(s.vbrtr))

    # 2. new-level depths from the current ssh
    if sw.full_free_surface > 0:
        hhq_n, hhu_n, hhv_n, hhh_n = dk.hh_update(
            lu, llu, llv, luh, dx, dy, dxt, dyt, dxh, dyh, dxb, dyb,
            ex(s.ssh), h_r, zp(s.hhu_n), zp(s.hhv_n), zp(s.hhh_n))
    else:
        hhq_n, hhu_n, hhv_n, hhh_n = s.hhq_n, s.hhu_n, s.hhv_n, s.hhh_n

    # 3-4. momentum advection
    if sw.trans_terms > 0:
        vort = swk.uv_trans_vort(luu, dxt, dyt, dxb, dyb,
                                 ex(s.ubrtr), ex(s.vbrtr), zp(s.vort))
        rhsx_adv, rhsy_adv = swk.uv_trans(
            lcu, lcv, luu, dxh, dyh,
            ex(s.ubrtr), ex(s.vbrtr), ex(vort),
            zp(s.hhq), ex(s.hhu), ex(s.hhv), ex(s.hhh),
            zp(s.rhsx_adv), zp(s.rhsy_adv))
    else:
        vort = s.vort
        rhsx_adv, rhsy_adv = s.rhsx_adv, s.rhsy_adv

    # 5-6. lateral viscosity
    if sw.ksw_lat > 0:
        str_t, str_s = swk.stress_components(
            lu, luu, dx, dy, dxt, dyt, dxh, dyh, dxb, dyb,
            ex(s.ubrtrp), ex(s.vbrtrp), zp(s.str_t), zp(s.str_s))
        hp.ex_batch([str_t, str_s])
        rhsx_dif, rhsy_dif = swk.uv_diff2(
            lcu, lcv, dx, dy, dxt, dyt, dxh, dyh, dxb, dyb,
            ex(s.mu), ex(str_t), ex(str_s),
            ex(s.hhq), zp(s.hhu), zp(s.hhv), ex(s.hhh),
            zp(s.rhsx_dif), zp(s.rhsy_dif))
    else:
        str_t, str_s = s.str_t, s.str_s
        rhsx_dif, rhsy_dif = s.rhsx_dif, s.rhsy_dif

    # 7. momentum update
    ubrtrn, vbrtrn = swk.update_uv(
        tau, lcu, lcv, dxt, dyt, dxh, dyh, dxb, dyb,
        zp(s.hhu), zp(hhu_n), zp(s.hhu_p),
        zp(s.hhv), zp(hhv_n), zp(s.hhv_p),
        ex(s.hhh), ex(s.ssh),
        ex(s.ubrtr), zp(s.ubrtrn), zp(s.ubrtrp),
        ex(s.vbrtr), zp(s.vbrtrn), zp(s.vbrtrp),
        ex(s.r_diss), rlh_s,
        zp(s.rhsx), zp(s.rhsy), zp(rhsx_adv), zp(rhsy_adv),
        zp(rhsx_dif), zp(rhsy_dif))

    # 8. leapfrog rotation + Robert-Asselin filter
    ssh2, sshp2, u2, up2, v2, vp2 = swk.next_step(
        ts, lu, zp(grid.lcu), zp(grid.lcv),
        zp(s.ssh), ex(sshn), zp(s.sshp),
        zp(s.ubrtr), zp(ubrtrn), zp(s.ubrtrp),
        zp(s.vbrtr), zp(vbrtrn), zp(s.vbrtrp))

    if sw.full_free_surface > 0:
        # 9. The reference filters the depth families here (hh_shift) and
        # then overwrites every one of them with hh_init below
        # (shallow_water.f90:76-87). Eager torch has no dead-code
        # elimination, so the dead hh_shift call is left out.
        # 10. re-init all depth families from the rotated (ssh, sshp)
        hp.ex_batch([ssh2, sshp2])
        (hhq3, hhq_p3, hhq_n3, hhu3, hhu_p3, hhu_n3,
         hhv3, hhv_p3, hhv_n3, hhh3, hhh_p3, hhh_n3) = dk.hh_init(
            sw.full_free_surface, lu, llu, llv, luh,
            dx, dy, dxt, dyt, dxh, dyh, dxb, dyb,
            ex(ssh2), ex(sshp2), h_r,
            zp(s.hhu), zp(s.hhu_p), zp(hhu_n),
            zp(s.hhv), zp(s.hhv_p), zp(hhv_n),
            zp(s.hhh), zp(s.hhh_p), zp(hhh_n))
    else:
        hhq3, hhq_p3, hhq_n3 = s.hhq, s.hhq_p, hhq_n
        hhu3, hhu_p3, hhu_n3 = s.hhu, s.hhu_p, hhu_n
        hhv3, hhv_p3, hhv_n3 = s.hhv, s.hhv_p, hhv_n
        hhh3, hhh_p3, hhh_n3 = s.hhh, s.hhh_p, hhh_n

    return dataclasses.replace(
        s, ssh=ssh2, sshn=sshn, sshp=sshp2,
        ubrtr=u2, ubrtrn=ubrtrn, ubrtrp=up2,
        vbrtr=v2, vbrtrn=vbrtrn, vbrtrp=vp2,
        rhsx_adv=rhsx_adv, rhsy_adv=rhsy_adv,
        rhsx_dif=rhsx_dif, rhsy_dif=rhsy_dif,
        str_t=str_t, str_s=str_s, vort=vort,
        hhq=hhq3, hhq_p=hhq_p3, hhq_n=hhq_n3,
        hhu=hhu3, hhu_p=hhu_p3, hhu_n=hhu_n3,
        hhv=hhv3, hhv_p=hhv_p3, hhv_n=hhv_n3,
        hhh=hhh3, hhh_p=hhh_p3, hhh_n=hhh_n3)


def tracer_step(state: SWState, grid: Grid, cfg: ModelConfig, tau,
                hp) -> SWState:
    """One tracer step for all tracers (expl_tracer, tracer.f90:33-62),
    after :func:`sw_step`: the depths are the post-step ones (the
    end-of-step hh_init), the velocities the rotated current level, and
    ``flux_x``/``flux_y`` carry from tracer k to k+1 (land edges keep
    them), as tracer_interface.f90 binds them."""
    sw = cfg.sw
    if sw.use_tracers <= 0 or state.ff is None:
        return state
    ex, zp = hp.ex, hp.zp
    ts = sw.time_smooth

    lu = zp(grid.lu)
    lcu, lcv = zp(grid.lcu), zp(grid.lcv)
    dx, dy = zp(grid.dx), zp(grid.dy)
    dxt, dyt = zp(grid.dxt), zp(grid.dyt)
    dxh, dyh = ex(grid.dxh), ex(grid.dyh)

    ff, ffp, ffn = state.ff.clone(), state.ffp.clone(), state.ffn.clone()
    flux_x, flux_y = state.flux_x, state.flux_y

    for k in range(sw.tracer_num):
        fx, fy = trk.tran_diff_fluxes(
            lcu, lcv, dxt, dyt, dxh, dyh, zp(state.hhu), zp(state.hhv),
            ex(ff[k]), zp(ffp[k]), zp(state.ubrtr), zp(state.vbrtr),
            ex(state.mu), 1.0, zp(flux_x), zp(flux_y))
        hp.ex_batch([fx, fy])
        new_ffn = trk.tran_diff_tracer(
            tau, lu, dx, dy, zp(state.hhq_n), zp(state.hhq_p),
            ex(fx), ex(fy), zp(ffp[k]), zp(ffn[k]))
        new_ff, new_ffp = trk.tracer_next_step(
            ts, lu, zp(new_ffn), zp(ffp[k]), zp(ff[k]))
        ff[k], ffp[k], ffn[k] = new_ff, new_ffp, new_ffn
        flux_x, flux_y = fx, fy

    return dataclasses.replace(state, ff=ff, ffp=ffp, ffn=ffn,
                               flux_x=flux_x, flux_y=flux_y)


def reinit_depth_families(state: SWState, grid: Grid,
                          cfg: ModelConfig) -> SWState:
    """Regenerate every depth family from (ssh, sshp) as the end-of-step
    hh_init does (shallow_water.f90:82-87): runners that carry only the
    prognostic fields (the fused path) rebuild a full SWState with it."""
    hp = GlobalHalo(grid.periodic_x, grid.periodic_y)
    ex, zp = hp.ex, hp.zp
    g = grid
    st = state
    (hq, hqp, hqn, hu, hup, hun, hv, hvp, hvn, hh, hhp, hhn) = dk.hh_init(
        cfg.sw.full_free_surface, ex(g.lu), zp(g.llu), zp(g.llv),
        zp(g.luh), ex(g.dx), ex(g.dy), zp(g.dxt), zp(g.dyt),
        zp(g.dxh), zp(g.dyh), zp(g.dxb), zp(g.dyb),
        ex(st.ssh), ex(st.sshp), ex(g.hhq_rest),
        zp(st.hhu), zp(st.hhu_p), zp(st.hhu_n),
        zp(st.hhv), zp(st.hhv_p), zp(st.hhv_n),
        zp(st.hhh), zp(st.hhh_p), zp(st.hhh_n))
    return dataclasses.replace(
        st, hhq=hq, hhq_p=hqp, hhq_n=hqn, hhu=hu, hhu_p=hup, hhu_n=hun,
        hhv=hv, hhv_p=hvp, hhv_n=hvn, hhh=hh, hhh_p=hhp, hhh_n=hhn)


def make_step(grid: Grid, cfg: ModelConfig, hp=None) -> Callable:
    """The full model step ``step(state, tau) -> (state, ok)``; ``ok`` is
    the per-step stability flag (check_ssh_err, vel_ssh.f90:40-67) as a
    0-dim bool tensor on the state's device."""
    if hp is None:
        hp = GlobalHalo(grid.periodic_x, grid.periodic_y)

    def step(state: SWState, tau):
        state = sw_step(state, grid, cfg, tau, hp)
        state = tracer_step(state, grid, cfg, tau, hp)
        ok = swk.check_ssh_ok(hp.zp(grid.lu), hp.zp(state.ssh))
        return state, ok

    return step


def run_steps(step_fn, state: SWState, tau, n_steps: int):
    """Run ``n_steps`` steps; returns ``(final_state, all_ok)``. The
    per-step flags are AND-ed on the device and read on the host once,
    at the end of the window: no per-step host sync."""
    okacc = torch.ones((), dtype=torch.bool, device=state.ssh.device)
    for _ in range(n_steps):
        state, ok = step_fn(state, tau)
        okacc = okacc & ok
    return state, bool(okacc)
