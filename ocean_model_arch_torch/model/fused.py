"""The fused step on a single block (counterpart of
``ocean_model_arch_tpu/model/fused.py::FusedSWModel, fused_available``).

Carries only the 6 prognostic fields (ssh, sshp, u, up, v, vp) and the
two carried levels (ff, ffp) of each tracer in the fused layout; depths
and staggered masks are recomputed inside the step. ``pack``/``unpack``
take and return physical (nx, ny) states, as the JAX ``FusedSWModel``
does. The kernel covers the envelope of :func:`unsupported` only; anything else
raises ValueError naming what is unsupported, never a silent change of
path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.grid import Grid
from ..core.state import SWState
from ..host import ModelConfig
from ..ops import fused_layout as fl
from ..ops import sw_kernels as swk
from ..ops.fused_step import (GENERAL_MAP, Folds, fused_sw_persistent,
                              fused_sw_step, kernel_planes, tile_shape)
from .step import reinit_depth_families

CARRIED = ("ssh", "sshp", "ubrtr", "ubrtrp", "vbrtr", "vbrtrp")


def unsupported(grid: Grid, cfg: ModelConfig, mu_const: float = 0.0,
                sharded: bool = False) -> list:
    """What keeps a configuration off the fused kernel (empty: supported).
    The kernel has the TPU kernel's fast form (profile metrics on
    x-uniform grids, its fast2d form with metric planes on the others)
    and its general form (``static_rslu=False``, or metric planes
    without ``fast2d``), each with or without momentum advection, with a
    full or a linear free surface, any constant ``mu_const``, flat or
    varying bathymetry, any number of tracers. The single block has land
    margins, so closed boundaries only; ``sharded``: on the margined
    shards of ``FusedSharded2DModel``, whose margin exchange wraps,
    periodic ones too."""
    out = []
    if (grid.periodic_x or grid.periodic_y) and not sharded:
        out.append("periodic boundaries (model/fused_sharded2d.py::"
                   "FusedSharded2DModel runs them, on a 1 x 1 mesh too)")
    return out


def fused_available(grid: Grid, cfg: ModelConfig, sharded: bool = False,
                    px: int = 1, py: int = 1) -> bool:
    """Whether the fused kernel supports this configuration: on the
    single block (closed boundaries only) or, with ``sharded``, on the
    px x py margined shards of ``FusedSharded2DModel``, where periodic
    boundaries run too (a 1 x 1 mesh wraps locally). The TPU package also
    asks that a periodic axis divide into the mesh's tiles; the port's
    uniform cuts always end at the basin's edge, so no mesh is refused
    for that."""
    del px, py
    return not unsupported(grid, cfg, sharded=sharded)


def flat_bathymetry(grid: Grid) -> float | None:
    """The rest bathymetry if it is one value everywhere (it then folds
    into a scalar of the step), else None."""
    hr = grid.hhq_rest.to(torch.float32)
    first = hr.reshape(-1)[0]
    return float(first) if bool((hr == first).all()) else None


def state_from_fields(fields, template: SWState, grid: Grid,
                      cfg: ModelConfig, n_tracers: int) -> SWState:
    """6 + 2 T physical (nx, ny) fields (the order of ``pack``) -> a full
    SWState in ``template``'s dtype; the depth families are regenerated
    as the end-of-step hh_init does, and ffn = ff (what the rotation
    leaves at wet cells)."""
    dt = template.ssh.dtype
    st = dataclasses.replace(template, **{
        n: a.to(dt) for n, a in zip(CARRIED, fields)})
    if n_tracers:
        ff = torch.stack([fields[6 + 2 * t].to(dt) for t in range(n_tracers)])
        ffp = torch.stack([fields[7 + 2 * t].to(dt)
                           for t in range(n_tracers)])
        st = dataclasses.replace(st, ff=ff, ffp=ffp, ffn=ff)
    return reinit_depth_families(st, grid, cfg)


def fold_flags(fast: bool, auto: bool, steps_per_call: int, elide_sel,
               q4, share_prev, refusal: str = "elide_sel/q4/share_prev "
               "require fast mode (static_rslu=True, x-uniform metrics or "
               "fast2d)") -> Folds:
    """The drivers' fold arguments resolved as the JAX drivers resolve
    them: None is ``auto`` (on wherever the fast form runs, off in
    persistent mode), ``share_prev`` only for chained steps; a fold on
    where the fast form does not run raises ValueError(``refusal``)."""
    folds = Folds(auto if elide_sel is None else bool(elide_sel),
                  auto if q4 is None else bool(q4),
                  (auto if share_prev is None else bool(share_prev))
                  and steps_per_call > 1)
    if any(folds) and not fast:
        raise ValueError(refusal)
    return folds


def quarter(recips, q4: bool) -> tuple:
    """The fast form's interpolation reciprocals (u, v, h) with q4's 1/4
    folded into the u and v ones (a power of two: exact)."""
    q = np.float32(0.25 if q4 else 1.0)
    return recips[0] * q, recips[1] * q, recips[2]


def mask_carriers(carry, wet) -> list:
    """elide_sel's masking at ``pack``: the carried velocities (u, up, v,
    vp) times the u and v wet masks and every tracer level times the T
    one, ``wet`` being (wlcu, wlcv, wlu) on the carriers' grid; ssh and
    sshp as they are."""
    wlcu, wlcv, wlu = (m.to(carry[0].device) for m in wet)
    masks = (None, None, wlcu, wlcu, wlcv, wlcv) + (wlu,) * (len(carry) - 6)
    return [c if m is None else c * m for c, m in zip(carry, masks)]


def general_inputs(lu_s, hr_s, metrics_2d: bool, static_rslu: bool):
    """The general form's static planes and metric map for embedded lu
    and hr: (planes, met_map). The static reciprocal counts ride only on
    metric planes, as in the TPU kernel (on profiles ``static_rslu`` is
    the fast form); none of the planes takes a metric factor."""
    static = bool(static_rslu and metrics_2d)
    planes = fl.static_planes(lu_s, hr_s, np.float32(1.0), kernel_planes(
        general=True, static_rslu=static))
    return planes, (GENERAL_MAP if metrics_2d else None)


class FusedSWModel:
    """Shallow-water core, with the tracers of ``cfg.sw``, on the fused
    CUDA kernel (the plain PyTorch version on CPU tensors), on the
    grid's device. ``steps_per_call`` model steps run per kernel launch:
    1, or 2 for the chained form (two whole steps in one launch, the
    first one's state in the kernel's shared memory, as the JAX
    ``FusedSWModel(steps_per_call=2)`` runs them); ``run_steps`` windows
    must be multiples of it. ``tile_guard``: skip the kernel's all-land output
    tiles (they get exact zeros); None turns it on when the mask leaves
    some tile without a wet cell. ``metrics_2d`` / ``fast2d`` say which
    metric form runs: latitude profiles on an x-uniform grid, else the
    pointwise metric planes of ``fused_layout.fast2d_met_rows``.
    ``static_rslu`` and ``fast2d`` pick the kernel's form as the JAX
    model's do: the fast form needs ``static_rslu`` and, on metric
    planes, ``fast2d`` (None: ``static_rslu``); otherwise the step runs
    the general form (``general``), the JAX default, on the 16 metric
    rows 0-15 and the planes ``lu``, ``hr`` (and on metric planes with
    ``static_rslu`` the three reciprocal counts).
    ``mu_const`` is the state's constant ``mu``: with ``cfg.sw.ksw_lat``
    it runs the lateral viscosity (``visc``), and with or without it the
    tracers' diffusive fluxes. ``hr_const`` is None when the bathymetry
    varies; it then rides on static planes. ``trans`` and ``ffs`` are
    ``cfg.sw.trans_terms`` and ``cfg.sw.full_free_surface`` as the
    kernel's switches (0 or 1).

    ``elide_sel``, ``q4``, ``share_prev``: the fast form's arithmetic
    folds (``ops/fused_step.py::Folds``), as in the JAX model: None turns
    ``elide_sel`` and ``q4`` on wherever the fast form runs and
    ``share_prev`` too at two steps a launch; all three off in persistent
    mode, where any of them raises ValueError, as it does where the fast
    form does not run. With ``q4`` the static planes carry the 1/4;
    with ``elide_sel`` ``pack`` masks the carried velocities and tracer
    levels with their staggered wet masks. The kernel has every
    combination, elide_sel or q4 alone too.

    ``persistent``: the JAX model's persistent mode (its
    ``build_persistent_sw_step``): ``run_steps`` runs a whole window of
    any length in ONE launch of the persistent kernel
    (``fused_sw_persistent``), fast or general form as above, ignoring
    ``steps_per_call``; x-uniform (profile) metrics only, as in JAX,
    which refuses metric planes (ValueError). It runs every tile, as the
    TPU builder does (``tile_guard=False`` there): the tile guard does not
    apply, and its all-land tiles' zeros are what every step computes
    there anyway. On the card the window steps between ``s6`` and a second
    buffer set the model keeps, so ``s6``'s tensors are overwritten and may
    be the result; the model then keeps the other set. Pass each window
    the state the last one returned (a clone of a state to keep)."""

    def __init__(self, grid: Grid, cfg: ModelConfig, tau: float,
                 mu_const: float = 0.0, static_rslu: bool = False,
                 steps_per_call: int = 1,
                 tile_guard: bool | None = None,
                 fast2d: bool | None = None, persistent: bool = False,
                 elide_sel: bool | None = None, q4: bool | None = None,
                 share_prev: bool | None = None):
        bad = unsupported(grid, cfg, mu_const)
        if bad:
            raise ValueError("fused path unsupported: " + "; ".join(bad))
        if steps_per_call not in (1, 2):
            raise ValueError(f"steps_per_call={steps_per_call}: the kernel "
                             "runs 1 or 2 steps a launch")
        self.grid = grid
        self.cfg = cfg
        self.tau = float(tau)
        self.mu_const = float(mu_const)
        self.steps_per_call = int(steps_per_call)
        self.n_tracers = (cfg.sw.tracer_num if cfg.sw.use_tracers > 0
                          else 0)
        self.lay = lay = fl.make_layout(grid.nx, grid.ny)
        dev = grid.lu.device
        self.visc = bool(cfg.sw.ksw_lat and self.mu_const != 0.0)
        self.trans = int(cfg.sw.trans_terms > 0)
        self.ffs = int(cfg.sw.full_free_surface > 0)
        self.hr_const = flat_bathymetry(grid)
        self.static_rslu = bool(static_rslu)
        lu_s = np.asarray(fl.embed(lay, grid.lu.cpu()))
        hr_s = np.asarray(fl.embed(lay, grid.hhq_rest.cpu()))
        # x-uniform metrics ride as latitude profiles; other grids
        # (bipolar) stream metric planes
        try:
            met = fl.metrics_profile_from_grid(grid, lay)
            self.metrics_2d = self.fast2d = False
        except ValueError:
            met = None
            self.metrics_2d = True
            self.fast2d = (self.static_rslu if fast2d is None
                           else bool(fast2d))
            if self.fast2d and not self.static_rslu:
                raise ValueError("fast2d requires static_rslu=True")
        self.general = not (self.static_rslu
                            and (not self.metrics_2d or self.fast2d))
        self.persistent = bool(persistent)
        self.folds = fold_flags(not self.general,
                                not self.general and not self.persistent,
                                self.steps_per_call, elide_sel, q4,
                                share_prev)
        self.elide_sel, self.q4, self.share_prev = self.folds
        if self.persistent and any(self.folds):
            raise ValueError("persistent probe mode predates the round-5 "
                             "reductions; pass elide_sel=q4=False")
        if self.persistent and self.metrics_2d:
            raise ValueError("persistent mode: x-uniform metrics, per-field "
                             "windows, x-strip tiling only")
        self._spare = None      # the persistent window's second buffer set
        if self.general:
            met16 = (fl.metrics_full_from_grid(grid, lay, derived=False)
                     if self.metrics_2d else None)
            planes, self.met_map = general_inputs(
                lu_s, hr_s, self.metrics_2d, self.static_rslu)
            self.met = torch.from_numpy(
                met16 if self.metrics_2d else met).to(dev)
            self.planes = torch.from_numpy(planes).to(dev)
        else:
            self._fast_inputs(grid, cfg, lay, lu_s, hr_s, met)
        # the guard's per-block wet flags, with the kernel's own tile (the
        # chained form's, for two steps a launch)
        self.tile = tile_shape(dev, self.steps_per_call)
        wet = fl.tile_wet(lu_s, lay, *self.tile)
        self.n_tiles = (int(wet.sum()), int(wet.size - wet.sum()))
        if tile_guard is None:
            tile_guard = not wet.all()      # some tile is all land
        self.tile_guard = bool(tile_guard)
        self.tile_wet = (torch.from_numpy(wet).to(dev) if self.tile_guard
                         else None)
        # elide_sel: the wet masks of the u, v and T points, which pack
        # puts on the carried fields
        self._wet = (tuple(torch.from_numpy(m).to(dev)
                           for m in fl.staggered_wet_masks(lu_s))
                     if self.elide_sel else None)

    def _fast_inputs(self, grid: Grid, cfg: ModelConfig, lay, lu_s, hr_s,
                     met) -> None:
        """The fast form's metric rows or planes and static planes."""
        dev = grid.lu.device
        names = kernel_planes(self.n_tracers, self.visc,
                              self.hr_const is None)
        # what the TPU kernel streams, less the wlu plane (the masks come
        # from ludxdy) and, with a linear free surface on flat bathymetry,
        # less hrludxdy, which the TPU kernel streams there and this
        # kernel folds into hr_const * ludxdy
        theirs = set(fl.plane_names(cfg.sw.full_free_surface,
                                    cfg.sw.ksw_lat, self.mu_const,
                                    self.hr_const)) - {"wlu"}
        if self.hr_const is not None:
            theirs -= {"hrludxdy"}
        assert set(names) - {"hr"} == theirs, names
        if not self.metrics_2d:
            self.met_map = None
            dxdy = (met[0] * met[1])[None, :]
            recips = quarter((met[10:11], met[11:12],
                              (met[14] * met[15])[None]), self.q4)
        else:
            met22 = fl.metrics_full_from_grid(grid, lay)
            rows = fl.fast2d_met_rows(self.n_tracers, self.visc, self.trans)
            self.met_map = {r: i for i, r in enumerate(rows)}
            met = met22[list(rows)]
            dxdy = met22[0] * met22[1]
            recips = quarter((met22[10], met22[11], met22[14] * met22[15]),
                             self.q4)
            # met22 (155 MB at 1525 x 1115) lives only in this constructor
        planes = fl.static_planes(lu_s, hr_s, dxdy, names,
                                  interp_recips=recips)
        self.met = torch.from_numpy(met).to(dev)
        self.planes = torch.from_numpy(planes).to(dev)

    def pack(self, state: SWState) -> tuple:
        """SWState -> the 6 + 2 T carried fields in the fused layout
        (float32): the 6 SW fields, then ff_0, ffp_0, ff_1, ... The
        kernel's viscosity is the constant ``mu_const``, so a state
        whose mu is not that everywhere is refused. With ``elide_sel``
        the velocities are masked with the u and v wet masks and the
        tracer levels with the T one, as the JAX model packs them (land
        is 0 in every state the model makes)."""
        if not bool((state.mu == self.mu_const).all()):
            raise ValueError("fused path requires state.mu == mu_const "
                             f"({self.mu_const}) everywhere")
        carry = [fl.embed(self.lay, getattr(state, n)) for n in CARRIED]
        for t in range(self.n_tracers):
            carry.append(fl.embed(self.lay, state.ff[t]))
            carry.append(fl.embed(self.lay, state.ffp[t]))
        if self._wet is not None:
            carry = mask_carriers(carry, self._wet)
        return tuple(carry)

    def unpack(self, s6, template: SWState) -> SWState:
        """6 + 2 T carried fields -> a full SWState in ``template``'s
        dtype; the depth families are regenerated as the end-of-step
        hh_init does, and ffn = ff (what the rotation leaves at wet
        cells)."""
        return state_from_fields([fl.extract(self.lay, a) for a in s6],
                                 template, self.grid, self.cfg,
                                 self.n_tracers)

    def run_steps(self, s6, n_steps: int):
        """Advance ``n_steps`` steps in ``n_steps / steps_per_call``
        launches (persistent: any ``n_steps`` in one); returns ``(s6',
        ok)``. The max |ssh| of every step (a launch's covers each of its
        steps) accumulates on the device (``torch.maximum``, which
        propagates NaN) and is read once at the end of the window, so a
        transient blow-up at any step trips ``ok``."""
        if self.persistent:
            return self._run_persistent(s6, n_steps)
        spc = self.steps_per_call
        if n_steps % spc:
            raise ValueError(f"n_steps={n_steps} not a multiple of "
                             f"steps_per_call={spc}")
        mx = torch.zeros((), dtype=torch.float32, device=s6[0].device)
        sw = self.cfg.sw
        for _ in range(n_steps // spc):
            s6, m = fused_sw_step(s6, self.met, self.planes, self.lay,
                                  self.tau, sw.time_smooth, self.hr_const,
                                  self.tile_wet, self.tile, self.met_map,
                                  self.mu_const, self.visc, self.trans,
                                  self.ffs, spc, self.general, self.folds)
            mx = torch.maximum(mx, m)
        return s6, bool(mx < swk.SSH_ERR_BOUND)   # NaN compares False

    def _run_persistent(self, s6, n_steps: int):
        """``run_steps`` in persistent mode: one launch for the window."""
        spare = None
        if s6[0].device.type != "cpu":
            spare = self._spare
            if spare is None or spare[0].device != s6[0].device:
                spare = tuple(torch.zeros_like(f) for f in s6)
            elif {t.data_ptr() for t in spare} & {t.data_ptr() for t in s6}:
                raise ValueError("persistent window: s6 is this model's "
                                 "second buffer set (a state handed to an "
                                 "earlier window); pass the state the last "
                                 "window returned")
        sw = self.cfg.sw
        out, mx = fused_sw_persistent(
            s6, self.met, self.planes, self.lay, self.tau, sw.time_smooth,
            self.hr_const, self.mu_const, self.visc, self.trans, self.ffs,
            n_steps, self.general, spare)
        if spare is not None:
            self._spare = tuple(s6) if out[0] is spare[0] else spare
        return out, bool(mx < swk.SSH_ERR_BOUND)   # NaN compares False
