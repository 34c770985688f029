"""The fused shallow-water step: CUDA kernel wrapper and its plain version.

Counterpart of ``ocean_model_arch_tpu/ops/pallas/fused_step.py::
build_fused_sw_step`` / ``_make_kernel`` (fast branch, x-uniform
profile metrics, full free surface, momentum advection, mu = 0, no
tracers). One call advances the 6 carried fields by one model step on
the layout of ops/fused_layout.py:

    (ssh, sshp, u, up, v, vp), met (24, Ys), planes (4, Xs, Ys)
        -> (6 new fields, max |ssh_new| over interior cells)

The depths are recomputed from (ssh, sshp) every step instead of being
carried, as the TPU kernel does: the step ends with hh_init, so every
depth is a function of (ssh, sshp, bathymetry). The static planes are
``PLANES`` (built without the TPU kernel's q4 quarter fold); the
staggered wet masks are derived from the ``ludxdy`` plane.

:func:`fused_sw_step` takes CPU tensors to :func:`fused_sw_step_reference`
and CUDA tensors to the hand-written kernel (``csrc/fused_step.cu``),
which it builds on first use; a kernel that does not build or launch
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..host import FREE_FALL_ACC
from ._build import load
from .fused_layout import N_PROF, FusedLayout

PLANES = ("rslu_u", "rslu_v", "rslu_h", "ludxdy")
N_FIELDS = 6


def _scalars(tau: float, time_smooth: float):
    """The step's scalar constants, rounded once, as both versions use
    them: (-g, 2 tau, -2 tau, 1 - ts, ts / 2)."""
    ts = float(time_smooth)
    return (-float(FREE_FALL_ACC), 2.0 * float(tau), -2.0 * float(tau),
            1.0 - ts, 0.5 * ts)


def _sh(a: torch.Tensor, dm: int, dn: int) -> torch.Tensor:
    """result[m, n] = a[m + dm, n + dn], zero outside the array."""
    out = torch.zeros_like(a)
    X, Y = a.shape
    out[max(-dm, 0):X - max(dm, 0), max(-dn, 0):Y - max(dn, 0)] = \
        a[max(dm, 0):X - max(-dm, 0), max(dn, 0):Y - max(-dn, 0)]
    return out


def fused_sw_step_reference(fields, met, planes, lay: FusedLayout,
                            tau: float, time_smooth: float,
                            hr_const: float):
    """One fused step in plain PyTorch on whole arrays, with the kernel's
    formulas in the kernel's order (see csrc/fused_step.cu)."""
    ssh, sshp, u, up, v, vp = fields
    rslu_u, rslu_v, rslu_h, ld = planes
    neg_g, two_tau, neg_two_tau, ts1, ts2 = _scalars(tau, time_smooth)

    def row(k):
        return met[k][None, :]

    def xp(a):
        return _sh(a, 1, 0)

    def yp(a):
        return _sh(a, 0, 1)

    # depths from (ssh, sshp): hu = hhu*dyh, hv = hhv*dxh, hh = hhh
    aq = (ssh + hr_const) * ld
    hu = (aq + xp(aq)) * rslu_u
    hv = (aq + yp(aq)) * rslu_v
    su = aq + xp(aq)
    hh = (su + yp(su)) * rslu_h
    aqp = (sshp + hr_const) * ld
    hup = (aqp + xp(aqp)) * rslu_u
    hvp = (aqp + yp(aqp)) * rslu_v
    ud = u * hu
    vd = v * hv

    wlu = ld > 0.5
    wlcu = wlu & xp(wlu)
    wlcv = wlu & yp(wlu)
    wluu = wlcu & yp(wlcu)

    # vorticity/4, edge fluxes, vorticity + Coriolis (the 1/4s folded)
    ux, uy, vx, vy = xp(u), yp(u), xp(v), yp(v)
    vort = torch.where(wluu, (vx - v) * row(16) - uy * row(17)
                       + u * row(18), 0.0)
    s2u = uy + u
    s2v = vx + v
    F = (ud + xp(ud)) * ((u + ux) * 0.25)
    G = ((vd + xp(vd)) * 0.25) * torch.where(wluu, s2u, 0.0)
    K = (vd + yp(vd)) * ((v + vy) * 0.25)
    L = ((ud + yp(ud)) * 0.25) * s2v
    vc = (vort + row(21)) * hh
    Px = vc * s2v
    Ty = vc * s2u
    acx = (((Px - F) - G) + _sh(Px + G, 0, -1)) + _sh(F, -1, 0)
    acy = (((-Ty - L) - K) + _sh(L - Ty, -1, 0)) + _sh(K, 0, -1)

    # continuity and momentum
    div = ((ud - _sh(ud, -1, 0)) + vd) - _sh(vd, 0, -1)
    sshn = sshp + div * (neg_two_tau * row(9))
    slx = (xp(ssh) - ssh) * hu * neg_g
    sly = (yp(ssh) - ssh) * hv * neg_g
    un = torch.where(wlcu, (up * hup + (slx + acx) * (two_tau * row(10)))
                     / torch.where(wlcu, hu, 1.0), 0.0)
    vn = torch.where(wlcv, (vp * hvp + (sly + acy) * (two_tau * row(11)))
                     / torch.where(wlcv, hv, 1.0), 0.0)

    # leapfrog rotation + Robert-Asselin filter
    ssh_new = torch.where(wlu, sshn, ssh)
    out = (ssh_new,
           torch.where(wlu, ts1 * ssh + ts2 * (sshn + sshp), sshp),
           torch.where(wlcu, un, u),
           torch.where(wlcu, ts1 * u + ts2 * (un + up), up),
           torch.where(wlcv, vn, v),
           torch.where(wlcv, ts1 * v + ts2 * (vn + vp), vp))
    m = lay.margin
    mx = torch.amax(ssh_new[m:m + lay.nx, m:m + lay.ny].abs())
    return out, mx


def _check_inputs(fields, met, planes, lay: FusedLayout) -> None:
    if len(fields) != N_FIELDS:
        raise ValueError(f"expected {N_FIELDS} fields, got {len(fields)}")
    want = {"field": (lay.Xs, lay.Ys), "met": (N_PROF, lay.Ys),
            "planes": (len(PLANES), lay.Xs, lay.Ys)}
    dev = fields[0].device
    for kind, ts in (("field", fields), ("met", [met]),
                     ("planes", [planes])):
        for t in ts:
            if (dev.type != "cuda" or t.device != dev
                    or t.dtype != torch.float32):
                raise ValueError(f"{kind}: need float32 CUDA tensors on "
                                 f"{dev}, got {t.dtype} on {t.device}")
            if tuple(t.shape) != want[kind] or not t.is_contiguous():
                raise ValueError(f"{kind}: need a contiguous "
                                 f"{want[kind]} tensor, got "
                                 f"{tuple(t.shape)}")


def fused_sw_step(fields, met, planes, lay: FusedLayout, tau: float,
                  time_smooth: float, hr_const: float):
    """One fused step: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (counted in ``fused_sw_step.launches``). Returns
    ``(6 new fields, 0-dim max |ssh_new| over interior cells)``; the max
    propagates NaN."""
    if fields[0].device.type == "cpu":
        return fused_sw_step_reference(fields, met, planes, lay, tau,
                                       time_smooth, hr_const)
    _check_inputs(fields, met, planes, lay)
    lib = _library()
    outs = tuple(torch.empty_like(f) for f in fields)
    blockmax = torch.empty(lib.fused_sw_step_blocks(lay.Xs, lay.Ys),
                           dtype=torch.float32, device=fields[0].device)
    neg_g, two_tau, neg_two_tau, ts1, ts2 = _scalars(tau, time_smooth)
    ptr = [t.data_ptr() for t in (*fields, met, planes, *outs, blockmax)]
    with torch.cuda.device(fields[0].device):   # launch on the tensors' card
        rc = lib.fused_sw_step_launch(
            *ptr, lay.Xs, lay.Ys, lay.nx, lay.ny, lay.margin,
            float(hr_const), neg_g, two_tau, neg_two_tau, ts1, ts2,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("fused_sw_step kernel launch failed: "
                           + lib.fused_sw_step_error_string(rc).decode())
    fused_sw_step.launches += 1
    return outs, torch.amax(blockmax)


fused_sw_step.launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/fused_step.cu, built on first use, with its C signatures."""
    lib = load("fused_step")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_sw_step_blocks.argtypes = [i, i]
    lib.fused_sw_step_blocks.restype = i
    lib.fused_sw_step_error_string.argtypes = [i]
    lib.fused_sw_step_error_string.restype = ctypes.c_char_p
    lib.fused_sw_step_launch.argtypes = ([p] * 15 + [i] * 5 + [f] * 6
                                         + [p])
    lib.fused_sw_step_launch.restype = i
    return lib
