"""Initial conditions (counterpart of ``ocean_model_arch_tpu/model/init.py``,
control/init_data.f90 init_ocean_data)."""

from __future__ import annotations

import dataclasses

import torch

from ..core.grid import Grid
from ..core.state import SWState, zero_state
from ..host import ModelConfig
from ..ops import depth_kernels as dk
from ..ops import sw_kernels as swk
from .step import GlobalHalo


def init_ocean_state(grid: Grid, cfg: ModelConfig,
                     ssh0=None, hp=None) -> SWState:
    """The initial state (init_ocean_data, init_data.f90:29-94):

    - ssh from ``ssh0`` if given, else a Gaussian bump at the domain
      center (sigma=1, center nx/2, ny/2); sshn = sshp = ssh; velocities 0;
    - depth families via hh_init;
    - mu filled with lvisc_2 and then overwritten with 0.0, as the
      reference does (init_data.f90:76-77): its effective lateral
      viscosity is zero;
    - tracers as Gaussian bumps (sigma=0.5), zero fluxes.
    """
    if hp is None:
        hp = GlobalHalo(grid.periodic_x, grid.periodic_y)
    ex, zp = hp.ex, hp.zp
    sw = cfg.sw
    state = zero_state(grid.nx, grid.ny,
                       sw.tracer_num if sw.use_tracers > 0 else 0,
                       cfg.precision, device=grid.lu.device)

    lu = ex(grid.lu)
    if ssh0 is None:
        ssh = swk.gaussian_bump(lu, zp(state.ssh), 1.0,
                                grid.nx // 2, grid.ny // 2)
    else:
        ssh = torch.as_tensor(ssh0, dtype=state.ssh.dtype,
                              device=state.ssh.device)
    state = dataclasses.replace(state, ssh=ssh, sshn=ssh, sshp=ssh)

    (hhq, hhq_p, hhq_n, hhu, hhu_p, hhu_n,
     hhv, hhv_p, hhv_n, hhh, hhh_p, hhh_n) = dk.hh_init(
        sw.full_free_surface, lu, zp(grid.llu), zp(grid.llv), zp(grid.luh),
        ex(grid.dx), ex(grid.dy), zp(grid.dxt), zp(grid.dyt),
        zp(grid.dxh), zp(grid.dyh), zp(grid.dxb), zp(grid.dyb),
        ex(state.ssh), ex(state.sshp), ex(grid.hhq_rest),
        zp(state.hhu), zp(state.hhu_p), zp(state.hhu_n),
        zp(state.hhv), zp(state.hhv_p), zp(state.hhv_n),
        zp(state.hhh), zp(state.hhh_p), zp(state.hhh_n))
    state = dataclasses.replace(
        state, hhq=hhq, hhq_p=hhq_p, hhq_n=hhq_n,
        hhu=hhu, hhu_p=hhu_p, hhu_n=hhu_n,
        hhv=hhv, hhv_p=hhv_p, hhv_n=hhv_n,
        hhh=hhh, hhh_p=hhh_p, hhh_n=hhh_n)

    # mu quirk (init_data.f90:76-77): fill(lvisc_2) then fill(0.0)
    mu = torch.full_like(state.mu, sw.lvisc_2)
    mu = torch.zeros_like(mu)
    state = dataclasses.replace(state, mu=mu)

    if sw.use_tracers > 0 and state.ff is not None:
        bump = swk.gaussian_bump(lu, zp(torch.zeros_like(state.ssh)), 0.5,
                                 grid.nx // 2, grid.ny // 2)
        ff = torch.stack([bump] * sw.tracer_num)
        state = dataclasses.replace(state, ff=ff, ffp=ff, ffn=ff)

    return state
