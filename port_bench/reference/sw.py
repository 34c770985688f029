"""The shallow-water step in plain PyTorch.

One step is the reference model's expl_shallow_water and expl_tracer
(shallow_water.f90, tracer.f90): continuity, the new depths, the
momentum advection with the vorticity term, the momentum update with the
pressure gradient and Coriolis, the leapfrog rotation with the
Robert-Asselin filter, the depths again from the rotated levels, and then
each passive tracer's centred fluxes, leapfrog update and filter. The
carried state is the six fields (ssh, sshp, u, up, v, vp) and the two
levels (ff, ffp) of each tracer; every other field of the model is
either worked out again each step (the depths) or stays zero.

Fields are contiguous (nx, ny) tensors whose outer ring of cells is land
in every mask. A cell's new value is computed from its neighbours within
one cell, over the flat run of cells from (1, 1) to (nx - 2, ny - 2): a
shift by (dm, dn) is then an offset of dm * ny + dn in that run, and
every operand a contiguous slice. The run also holds the ring's cells of
columns 0 and ny - 1, whose neighbours wrap to the next row; they are
land in every mask, so every result there is the land value 0, and the
ring stays zero.

The viscosity and the tracers' diffusion are left out: the model's
initialisation zeroes the viscosity mu (init_data.f90:76-77), so both
add exact zeros.
"""

from __future__ import annotations

import math

import numpy as np
import torch

G = float(np.float32(9.8))       # the reference's single-precision g
SSH_BOUND = 1.0e4                # the stability guard's |ssh| limit
CARRIED = ("ssh", "sshp", "u", "up", "v", "vp")


def gaussian_bump(nx: int, ny: int, sigma: float, dtype, device):
    """The model's initial tracer bump (gaussian_elimination_kernel,
    vel_ssh.f90:15-38) centred at the 1-based cell (nx // 2, ny // 2), in
    the state's precision."""
    m0, n0 = nx // 2, ny // 2
    m = torch.arange(1, nx + 1, dtype=dtype, device=device)[:, None]
    n = torch.arange(1, ny + 1, dtype=dtype, device=device)[None, :]
    dx = (m - m0) / (m0 * 0.25)
    dy = (n - n0) / (n0 * 0.25)
    amp = 1.0 / (math.sqrt(2.0 * 3.14159265358979) * sigma)
    return amp * torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))


class Reference:
    """The step on ``device`` in ``dtype`` (the run's float32, or a lower
    precision for the benchmark's control)."""

    def __init__(self, grid: dict, settings: dict, device, dtype):
        sw = settings["sw"]
        self.tau = float(settings["run"]["tau"])
        self.ts = float(sw["time_smooth"])
        self.ffs = float(sw["full_free_surface"])
        self.trans = sw["trans_terms"] > 0
        self.nt = sw["tracer_num"] if sw["use_tracers"] > 0 else 0
        self.device = torch.device(device)
        self.dtype = dtype
        self.nx, self.ny = grid["lu"].shape

        def t(a):
            return torch.as_tensor(np.asarray(a), device=self.device
                                   ).to(dtype)

        ring = np.ones(grid["lu"].shape, bool)
        ring[1:-1, 1:-1] = False
        if any((np.asarray(grid[k])[ring] > 0.5).any()
               for k in ("lu", "luu", "luh", "lcu", "lcv", "llu", "llv")):
            raise ValueError("the reference needs the outer ring of cells "
                             "to be land in every mask")
        g = {k: t(v).contiguous() for k, v in grid.items()}
        self.g = g
        self.n_run = self.nx * self.ny - 2 * (self.ny + 1)
        i = self.i
        # wet sets on the interior, as the kernels' (mask > 0.5)
        self.w = {k: i(g[k]) > 0.5 for k in ("lu", "luu", "luh", "lcu",
                                             "lcv", "llu", "llv")}
        self.area_lu = g["dx"] * g["dy"] * g["lu"]
        self.slu_u = torch.where(self.w["llu"],
                                 i(g["lu"]) + i(g["lu"], 1, 0), 1.0)
        self.slu_v = torch.where(self.w["llv"],
                                 i(g["lu"]) + i(g["lu"], 0, 1), 1.0)
        self.slu_h = torch.where(self.w["luh"],
                                 i(g["lu"]) + i(g["lu"], 1, 0)
                                 + i(g["lu"], 0, 1) + i(g["lu"], 1, 1), 1.0)
        # a product of two metric steps is single precision, as in the
        # reference (wp4 * wp4) whatever the state's precision
        self.dxdy = i(t(np.asarray(grid["dx"], np.float32)
                        * np.asarray(grid["dy"], np.float32)))
        self.graph = None

    # -- helpers --------------------------------------------------------
    def i(self, f, dm: int = 0, dn: int = 0):
        """f[m + dm, n + dn] over the run of cells m, n (a contiguous
        slice of the flat field)."""
        o = self.ny + 1 + dm * self.ny + dn
        return f.reshape(-1)[o:o + self.n_run]

    def full(self, a):
        """A result over the run as an (nx, ny) field, the ring 0."""
        return torch.nn.functional.pad(a, (self.ny + 1, self.ny + 1)
                                       ).view(self.nx, self.ny)

    def depths(self, s):
        """hu, hv, hh of the level s (hh_init, depth.f90:14-99), on the
        interior; land 0."""
        g, i, w = self.g, self.i, self.w
        aq = (g["hr"] + s * self.ffs) * self.area_lu
        hu = (i(aq) + i(aq, 1, 0)) / self.slu_u / i(g["dxt"]) / i(g["dyh"])
        hv = (i(aq) + i(aq, 0, 1)) / self.slu_v / i(g["dxh"]) / i(g["dyt"])
        hh = ((i(aq) + i(aq, 1, 0) + i(aq, 0, 1) + i(aq, 1, 1)) / self.slu_h
              / i(g["dxb"]) / i(g["dyb"]))
        return (torch.where(w["llu"], hu, 0.0), torch.where(w["llv"], hv, 0.0),
                torch.where(w["luh"], hh, 0.0))

    # -- the state --------------------------------------------------------
    def initial_state(self, ssh0: np.ndarray) -> dict:
        """The cold start (init_data.f90:29-94): ssh = sshp = ssh0 (land 0),
        velocities 0, every tracer level the model's bump (sigma 0.5) on
        the wet cells."""
        lu = self.g["lu"] > 0.5
        ssh = torch.where(lu, torch.as_tensor(ssh0, device=self.device
                                              ).to(self.dtype), 0.0)
        z = torch.zeros_like(ssh)
        st = dict(ssh=ssh, sshp=ssh.clone(), u=z, up=z.clone(),
                  v=z.clone(), vp=z.clone())
        if self.nt:
            bump = gaussian_bump(self.nx, self.ny, 0.5, self.dtype,
                                 self.device)
            ff = torch.where(lu, bump, 0.0)
            st["ff"] = torch.stack([ff] * self.nt)
            st["ffp"] = st["ff"].clone()
        return st

    def step(self, st: dict):
        """One model step: (the new carried state, the guard's flag)."""
        g, i, w, full = self.g, self.i, self.w, self.full
        tau, ts = self.tau, self.ts
        ssh, sshp, u, up, v, vp = (st[k] for k in CARRIED)
        hu, hv, hh = (full(a) for a in self.depths(ssh))
        hup, hvp, _ = self.depths(sshp)
        # 1. continuity (vel_ssh.f90:69-106)
        uflux = u * hu * g["dyh"]
        vflux = v * hv * g["dxh"]
        div = (i(uflux) - i(uflux, -1, 0) + i(vflux) - i(vflux, 0, -1)
               ) / self.dxdy
        sshn = torch.where(w["lu"], i(sshp) + 2.0 * tau * (-div), 0.0)
        # 3-4. momentum advection (vel_ssh.f90:247-373)
        if self.trans:
            vd = v * g["dyt"]
            ud = u * g["dxt"]
            circ = ((i(vd, 1, 0) - i(vd)) - (i(ud, 0, 1) - i(ud))
                    - ((i(v, 1, 0) - i(v)) * i(g["dyb"])
                       - (i(u, 0, 1) - i(u)) * i(g["dxb"])))
            vort = full(torch.where(w["luu"], circ, 0.0))
            ud = u * g["dyh"] * hu
            vd = v * g["dxh"] * hv
            vh = vort * hh
            fx_p = (i(ud) + i(ud, 1, 0)) / 2.0 * (i(u) + i(u, 1, 0)) / 2.0
            fx_m = (i(ud) + i(ud, -1, 0)) / 2.0 * (i(u) + i(u, -1, 0)) / 2.0
            fy_p = ((i(vd) + i(vd, 1, 0)) / 2.0
                    * (i(u, 0, 1) + i(u)) / 2.0 * i(g["luu"]))
            fy_m = ((i(vd, 0, -1) + i(vd, 1, -1)) / 2.0
                    * (i(u, 0, -1) + i(u)) / 2.0 * i(g["luu"], 0, -1))
            adv_x = (-(fx_p - fx_m + fy_p - fy_m)
                     + (i(vh) * (i(v, 1, 0) + i(v))
                        + i(vh, 0, -1) * (i(v, 1, -1) + i(v, 0, -1))) / 4.0)
            gy_p = (i(vd) + i(vd, 0, 1)) / 2.0 * (i(v) + i(v, 0, 1)) / 2.0
            gy_m = (i(vd) + i(vd, 0, -1)) / 2.0 * (i(v) + i(v, 0, -1)) / 2.0
            gx_p = (i(ud) + i(ud, 0, 1)) / 2.0 * (i(v, 1, 0) + i(v)) / 2.0
            gx_m = ((i(ud, -1, 0) + i(ud, -1, 1)) / 2.0
                    * (i(v, -1, 0) + i(v)) / 2.0)
            adv_y = (-(gx_p - gx_m + gy_p - gy_m)
                     - (i(vh) * (i(u, 0, 1) + i(u))
                        + i(vh, -1, 0) * (i(u, -1, 1) + i(u, -1, 0))) / 4.0)
            rx = torch.where(w["lcu"], adv_x, 0.0)
            ry = torch.where(w["lcv"], adv_y, 0.0)
        else:
            rx = ry = 0.0
        # 7. momentum update (vel_ssh.f90:108-195); the new-level depths
        # (hh_update) are the current ones, hu, hv
        cor = g["rlh_s"] * hh * g["dxb"] * g["dyb"]
        ihu, ihv = i(hu), i(hv)
        bp = ihu * i(g["dxt"]) * i(g["dyh"]) / 2.0 / tau
        bp0 = hup * i(g["dxt"]) * i(g["dyh"]) / 2.0 / tau
        slx = -G * (i(ssh, 1, 0) - i(ssh)) * i(g["dyh"]) * ihu
        grx = (slx + rx
               + (i(cor) * (i(v, 1, 0) + i(v))
                  + i(cor, 0, -1) * (i(v, 1, -1) + i(v, 0, -1))) / 4.0)
        un = torch.where(w["lcu"],
                         (i(up) * bp0 + grx) / torch.where(w["lcu"], bp, 1.0),
                         0.0)
        bpv = ihv * i(g["dyt"]) * i(g["dxh"]) / 2.0 / tau
        bpv0 = hvp * i(g["dyt"]) * i(g["dxh"]) / 2.0 / tau
        sly = -G * (i(ssh, 0, 1) - i(ssh)) * i(g["dxh"]) * ihv
        gry = (sly + ry
               - (i(cor) * (i(u, 0, 1) + i(u))
                  + i(cor, -1, 0) * (i(u, -1, 1) + i(u, -1, 0))) / 4.0)
        vn = torch.where(w["lcv"],
                         (i(vp) * bpv0 + gry) / torch.where(w["lcv"], bpv, 1.0),
                         0.0)
        # 8. leapfrog rotation + Robert-Asselin (vel_ssh.f90:197-245)
        out = {}
        for (cur, prev, new, mask, a, b) in (
                (ssh, sshp, sshn, "lu", "ssh", "sshp"),
                (u, up, un, "lcu", "u", "up"),
                (v, vp, vn, "lcv", "v", "vp")):
            c = i(cur)
            filt = c + ts * (new - 2.0 * c + i(prev)) / 2.0
            out[b] = full(torch.where(w[mask], filt, i(prev)))
            out[a] = full(torch.where(w[mask], new, c))
        if self.nt:
            out["ff"], out["ffp"] = self.tracers(st, out)
        ok = torch.where(w["lu"], (i(out["ssh"]) < SSH_BOUND)
                         & (i(out["ssh"]) > -SSH_BOUND), True).all()
        return out, ok

    def tracers(self, st: dict, new: dict):
        """Each tracer's step after the shallow-water step (tracer.f90:
        33-62; leapfrog_tracer.f90): the depths of the rotated levels,
        the rotated velocities; hhq_n is the rest depth, as the
        end-of-step hh_init leaves it."""
        g, i, w, full = self.g, self.i, self.w, self.full
        tau, ts = self.tau, self.ts
        hu, hv, _ = self.depths(new["ssh"])
        u, v = i(new["u"]), i(new["v"])
        bp = i(g["hr"]) * i(g["dx"]) * i(g["dy"]) / tau / 2.0
        bp0 = (i(g["hr"] + new["sshp"] * self.ffs) * i(g["dx"]) * i(g["dy"])
               / tau / 2.0)
        ffs, ffps = [], []
        for k in range(self.nt):
            ff, ffp = st["ff"][k], st["ffp"][k]
            fx = full(torch.where(w["lcu"], -u * hu * i(g["dyh"])
                                  * (i(ff) + i(ff, 1, 0)) / 2.0, 0.0))
            fy = full(torch.where(w["lcv"], -v * hv * i(g["dxh"])
                                  * (i(ff) + i(ff, 0, 1)) / 2.0, 0.0))
            rhs = i(fx) - i(fx, -1, 0) + i(fy) - i(fy, 0, -1)
            ffn = torch.where(w["lu"], (bp0 * i(ffp) + rhs)
                              / torch.where(w["lu"], bp, 1.0), 0.0)
            c = i(ff)
            filt = c + ts * (ffn - 2.0 * c + i(ffp)) / 2.0
            ffs.append(full(torch.where(w["lu"], ffn, c)))
            ffps.append(full(torch.where(w["lu"], filt, i(ffp))))
        return torch.stack(ffs), torch.stack(ffps)

    # -- many steps -------------------------------------------------------
    def run(self, st: dict, n: int):
        """``n`` steps from ``st``: (the state, all steps' guard flags
        and-ed). On a card the step is captured once in a CUDA graph and
        replayed, which takes the host's launches out of the reference's
        time; the kernels are the same."""
        st = {k: v.clone(memory_format=torch.contiguous_format)
              for k, v in st.items()}
        if self.device.type != "cuda":
            ok = torch.ones((), dtype=torch.bool)
            for _ in range(n):
                st, f = self.step(st)
                ok &= f
            return st, bool(ok)
        if self.graph is None:
            self._capture(st)
        for k, v in st.items():
            self.static[k].copy_(v)
        self.ok.fill_(True)
        for _ in range(n):
            self.graph.replay()
        torch.cuda.synchronize(self.device)
        return {k: v.clone() for k, v in self.static.items()}, \
            bool(self.ok)

    def _capture(self, st: dict) -> None:
        self.static = {k: v.clone() for k, v in st.items()}
        self.ok = torch.ones((), dtype=torch.bool, device=self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):       # warm the allocator first
            self.step({k: v.clone() for k, v in st.items()})
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            out, f = self.step(self.static)
            for k, v in out.items():
                self.static[k].copy_(v)
            self.ok.logical_and_(f)
