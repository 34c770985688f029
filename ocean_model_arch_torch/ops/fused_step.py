"""The fused shallow-water step: CUDA kernel wrapper and its plain version.

Counterpart of ``ocean_model_arch_tpu/ops/pallas/fused_step.py::
build_fused_sw_step`` / ``_make_kernel`` (fast branch), with or
without momentum advection (``trans``) and with a full or a linear free
surface (``ffs``), with its lateral viscosity (constant ``mu_const``),
its tracer pass (advective fluxes, and diffusive ones when ``mu_const !=
0``), flat or varying rest bathymetry and its land-tile guard, on
x-uniform profile metrics or on pointwise metric planes (the TPU
kernel's fast2d form, for bipolar grids). One call
advances the 6 carried fields and the 2 carried levels of each of T
tracers by one model step (or two, chained) on the layout of
ops/fused_layout.py:

    (ssh, sshp, u, up, v, vp, ff_0, ffp_0, ff_1, ...), met,
    planes (4 to 6, Xs, Ys) [, tile_wet (x tiles, y tiles) int32]
        -> (6 + 2 T new fields, max |ssh_new| over interior cells)

``met`` is the (24, Ys) latitude profile of
``fused_layout.metrics_profile_from_grid``, or, with ``met_map``, a
stack of (Xs, Ys) planes: ``met_map[r]`` is the plane that holds row
``r`` (``fused_layout.fast2d_met_rows`` names the rows a step reads).
Both forms run the same formulas in the same order, each metric read at
the cell's own index.

The depths are recomputed from (ssh, sshp) every step instead of being
carried, as the TPU kernel does: the step ends with hh_init, so every
depth is a function of (ssh, sshp, bathymetry). The static planes are
those of :func:`kernel_planes`; the staggered wet masks are derived from
the ``ludxdy`` plane. Flat bathymetry rides as the scalar ``hr_const``; with
``hr_const=None`` the depth column is ``ssh * ludxdy + hrludxdy`` (the
TPU kernel's grouping) and the viscosity and the tracers read the ``hr``
plane. ``visc`` switches the stress stages on (the caller passes
``ksw_lat and mu_const != 0``); the tracers' diffusive fluxes follow
``mu_const != 0`` alone, as in the TPU kernel. ``trans=0`` drops the
vorticity and the advective edge fluxes and keeps the Coriolis pair;
``ffs=0`` makes every depth column the static rest depth (``hr_const *
ludxdy`` or ``hrludxdy``), as ``hq = hr + ssh * ffs`` does in the TPU
kernel.

With ``tile_wet`` the step is guarded: an output tile whose flag is 0
(no wet cell) is not computed and gets exact zeros, which is what its
land cells hold anyway.

``general=True`` is the general form of the step, the TPU kernel's
non-fast branch (``_make_kernel`` with ``fast = False``, :241 there: its
``static_rslu=False`` default, or metric planes without ``fast2d``): the
same step with the staggered masks, the reciprocal wet counts of the
depth interpolations and the depth columns ``aq = (hr + ssh * ffs) *
(dx * dy) * lu`` formed in the step from the land mask ``lu`` and the
rest bathymetry ``hr``, and every metric factor applied unfolded, in
the order of the JAX formulas. Its ``planes`` are those of
``kernel_planes(general=True)``: ``lu`` and ``hr``, and with
``static_rslu`` the three reciprocal-count planes in place of the
selects (the same values, so the same bits); ``met`` is the (24, Ys)
profile, of which it reads rows 0-15, or the (16, Xs, Ys) planes of
``fused_layout.metrics_full_from_grid(derived=False)`` with the identity
``met_map``. ``hr_const`` is not read.

The raw form (:func:`fused_sw_step_raw`, counterpart of ``step_raw``,
:1652-1673 of the TPU file) runs the same step on one shard of a
mesh: the array is the shard's valid box ``[M, M + lay.nx) x [M, M +
lay.ny)`` inside a margin that holds the neighbouring shards' cells, and
pad beyond. The outputs are the caller's own tensors, other ones than the
inputs, and only their box is written: margin and pad keep what they
held, and the max is over the box. The statics are the caller's per-shard
tensors, as in every form of the port.

Any number of tracers T: the kernel has instantiations of its own for
0, 1 and 2, and one family for every count from 3 up, which takes T at
run time and runs the tracer pass in groups of two (the TPU kernel
loops over its ``n_tracers``, :937-1039 there).

``steps = 2`` is the chained form, the TPU kernel's ``steps_per_call =
2`` (:1061-1084 there): two whole model steps in one launch, the first
one's state kept in the kernel's shared memory, so a launch moves the
bytes of one step for two. Its plain version is the single step twice,
the guard applied to the second step's outputs only (the kernel computes
the first step in each wet tile's window, whatever the flags of the
tiles it covers), the max over both steps. The single block needs no
wider margin (its margin is land, which every step keeps at its input
0); a shard's margin must be ``fused_layout.margin_for(2, T)`` wide.

:func:`fused_sw_persistent` is the persistent form, the TPU's
``build_persistent_sw_step`` (:1170 there): ``n_steps`` whole steps in
one cooperative launch, each the unguarded one-step form with profile
metrics, fast or general, walked over every tile by a grid that the card
holds at once, between the caller's fields and a second buffer set, a
grid barrier between the steps; its max covers every step. Its plain
version is :func:`fused_sw_step_reference` ``n_steps`` times.

``folds`` (:class:`Folds`) are the fast form's arithmetic folds, the
TPU kernel's ``elide_sel``, ``q4`` and ``share_prev`` (:41-58 there),
which its drivers turn on wherever the fast form runs: ``elide_sel``
drops the selects of the velocities' and the tracers' filter (the caller
keeps the carried velocities and tracer levels 0 off their wet sets);
``q4`` expects ``rslu_u`` and ``rslu_v`` scaled by 1/4 and drops the
advection's four 1/4 multiplies, its constants shifted by exact powers
of two (-4 g, tau / 2, -8 tau, the tracers' -2 and 4 mu); ``share_prev``
has step B of a chained launch take its previous-level depths from step
A's through the leapfrog filter. The kernel runs each reached
combination as an instantiation of its own (:func:`fold_targets`), the
plain version any.

:func:`fused_sw_step`, :func:`fused_sw_step_raw` and
:func:`fused_sw_persistent` take CPU tensors to the plain version and
CUDA tensors to the hand-written kernel (``csrc/fused_step.cu``), which
they build on first use; a kernel that does not build or launch (a
cooperative launch the card refuses among them) raises.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import typing

import torch

from ..host import FREE_FALL_ACC
from ._build import load
from .fused_layout import N_GENERAL, N_PROF, FusedLayout, fast2d_met_rows

N_FIELDS = 6            # carried SW fields; each tracer adds 2
# the kernel's instantiations (csrc/fused_step.cu): 0, 1 and 2 tracers
# each, and from LOOP_TRACERS up one family with the count at run time,
# whose tracer pass runs in groups of MAX_TRACERS
MAX_TRACERS = 2
LOOP_TRACERS = MAX_TRACERS + 1
# the kernel's (trans, ffs) forms, each in libraries of its own: the full
# step first, then without advection, with a linear free surface, both
FORMS = ((1, 1), (0, 1), (1, 0), (0, 0))
CPU_TILE = (16, 32)     # the guard's tile where no kernel defines one
# the metric rows whose slots the kernel's launcher takes, in its order
KERNEL_MET_ROWS = fast2d_met_rows(n_tracers=1, visc=True)
# and the general form's: rows 0-15, at their own index
GENERAL_MET_ROWS = tuple(range(N_GENERAL))
GENERAL_MAP = {r: r for r in GENERAL_MET_ROWS}   # its (16, Xs, Ys) planes
STATIC_RSLU = ("rslu_u", "rslu_v", "rslu_h")
THIRD = 1.0 / 3.0       # f32(1/3), one of the wet-count reciprocals


def kernel_planes(n_tracers: int = 0, visc: bool = False,
                  hr_varies: bool = False, general: bool = False,
                  static_rslu: bool = False) -> tuple:
    """The static planes one form of the step reads, in the order of its
    ``planes`` argument (``fused_layout.static_planes`` builds them):
    varying bathymetry adds ``hrludxdy`` and, for the viscosity's depth
    and the tracers' column, ``hr`` itself. No ``wlu`` plane: every mask
    comes from ``ludxdy > 0.5``. The general form reads the land mask and
    the bathymetry, and with ``static_rslu`` the three reciprocal counts
    of the depth interpolations, whatever the rest of the form."""
    if general:
        return ("lu", "hr") + (STATIC_RSLU if static_rslu else ())
    names = ("rslu_u", "rslu_v", "rslu_h", "ludxdy")
    if hr_varies:
        names += ("hrludxdy",)
        if visc or n_tracers:
            names += ("hr",)
    return names


def mu_mode(n_tracers: int, mu_const: float, visc: bool) -> int:
    """Which viscosity instantiation a step is: 0 none, 1 the tracers'
    diffusive fluxes alone, 2 the stress stages (with the diffusive
    fluxes when there are tracers)."""
    if visc:
        return 2
    return 1 if n_tracers and mu_const != 0.0 else 0


class Folds(typing.NamedTuple):
    """The fast form's arithmetic folds (the TPU kernel's round-5
    reductions, which its drivers turn on wherever the fast form runs):
    ``elide_sel`` drops the filter's selects of the carried velocities
    and tracer levels (the caller keeps them 0 off their wet sets);
    ``q4`` takes the advection's 1/4 from ``rslu_u`` and ``rslu_v``, which
    the caller has scaled by it; ``share_prev`` (chained, full free
    surface) has step B take its previous-level depths from step A's."""
    elide_sel: bool = False
    q4: bool = False
    share_prev: bool = False


NO_FOLDS = Folds()


def _scalars(tau: float, time_smooth: float, q4: bool = False):
    """The step's scalar constants, rounded once, as both versions use
    them: (-g, 2 tau, -2 tau, 1 / (2 tau), 1 - ts, ts / 2); with ``q4``
    the first three shifted by the exact powers of two that meet the
    quartered depths: (-4 g, tau / 2, -8 tau, ...)."""
    ts = float(time_smooth)
    s = 4.0 if q4 else 1.0
    return (-s * float(FREE_FALL_ACC), 2.0 / s * float(tau),
            -2.0 * s * float(tau), 1.0 / (2.0 * float(tau)), 1.0 - ts,
            0.5 * ts)


def _sh(a: torch.Tensor, dm: int, dn: int) -> torch.Tensor:
    """result[m, n] = a[m + dm, n + dn], zero outside the array."""
    out = torch.zeros_like(a)
    X, Y = a.shape
    out[max(-dm, 0):X - max(dm, 0), max(-dn, 0):Y - max(dn, 0)] = \
        a[max(dm, 0):X - max(-dm, 0), max(dn, 0):Y - max(-dn, 0)]
    return out


def n_tracers_of(fields) -> int:
    """T of a (6 + 2 T)-tuple of carried fields."""
    extra = len(fields) - N_FIELDS
    if extra < 0 or extra % 2:
        raise ValueError(f"expected {N_FIELDS} + 2 T fields, got "
                         f"{len(fields)}")
    return extra // 2


def chain_smem(n_tracers: int, visc: bool = False) -> tuple:
    """(dynamic shared memory bytes of a block, step A's tracer levels it
    keeps) of the chained form with ``n_tracers`` tracers on the current
    CUDA device (the library is built if needed): every level up to 8
    tracers, 7 viscous; past that the others live in device scratch."""
    lib = _library(n_tracers, steps=2)
    levels = ctypes.c_int(0)
    nbytes = lib.fused_sw_step_smem_bytes(n_tracers, int(visc),
                                          ctypes.byref(levels))
    return int(nbytes), levels.value


def tile_shape(device, steps: int = 1, chain_tile=None) -> tuple:
    """The (rows, columns) of the output tile the guard's flags refer to:
    the kernel's own tile constants for a CUDA device (the library of the
    forms that run ``steps`` model steps a launch, built if needed; a
    chained form has a tile of its own), ``CPU_TILE`` for the plain
    version on the CPU. ``chain_tile``: see :func:`library_target`."""
    if torch.device(device).type == "cpu":
        return CPU_TILE
    lib = _library(steps=steps, chain_tile=chain_tile)
    return lib.fused_sw_step_tile_x(), lib.fused_sw_step_tile_y()


class Geometry(typing.NamedTuple):
    """A form's window on the card (csrc/fused_tile.cuh's Form, and Plan
    for the fast body or GenPlan for the general one): its output ``tile``
    (rows, columns), window ``halo``, rows and columns (``rows`` x
    ``cols``, the box of every TMA load), floats a shared plane
    (``plane``), the loader's planes of their own (``extra``), the
    ``blocks`` an SM its shared memory leaves, the dynamic shared memory of
    a block (``smem`` bytes; a chained run-time tracer form's levels not
    counted), the TMA ``boxes`` of a launch, whether the body loads by TMA
    (``tma``; else by its threads, with no boxes) and the carveout its
    blocks take (``carveout``, KB of the SM's shared memory)."""
    tile: tuple
    halo: int
    rows: int
    cols: int
    plane: int
    extra: int
    blocks: int
    smem: int
    boxes: int
    tma: bool = True
    carveout: int = 0


# the H100's shared memory as csrc/fused_tile.cuh budgets it: an SM's
# bytes, those reserved a block, and a block's static arrays with the
# planes' alignment; the one-step and chained tiles' (rows, columns,
# threads, launch bound in blocks an SM); the working planes
SM_SMEM, BLOCK_RESERVED, STATIC_SMEM = 233472, 1024, 256
BLOCK_SMEM_MAX = 232448     # what one block may take (227 KB)
TILES = {1: (16, 32, 512, 3), 2: (16, 32, 512, 2)}
N_SMEM_PLANES, N_CHAIN_PLANES, N_VISC_PLANES = 16, 4, 4
TMA_BOX_MAX = 256       # cells a side of a TMA box
TMA_ALIGN = 16          # bytes: addresses, rows and a box's row
# the SM's shared-memory carveouts (KB; the rest of its 256 KB is L1), and
# the static shared memory the general body's kernels and the persistent
# walk are budgeted for
CARVEOUTS_KB = (0, 8, 16, 32, 64, 100, 132, 164, 196, 228)
GEN_STATIC = 384


def carveout_kb(nbytes: int) -> int:
    """The smallest carveout (KB) that holds ``nbytes`` of an SM's shared
    memory, -1 for none: the one the driver takes for a kernel's blocks."""
    return next((k for k in CARVEOUTS_KB if nbytes <= k * 1024), -1)


def _window(n_tracers: int, steps: int, tma: bool) -> tuple:
    """(halo, rows, columns, floats a plane) of csrc/fused_tile.cuh's
    Form: by TMA the box begins R columns before the window on 16 bytes,
    the columns rounded up to 4 and each plane to 128 bytes."""
    tx, ty = TILES[steps][:2]
    halo = steps * (3 + (1 if n_tracers else 0))
    rows = tx + 2 * halo
    if not tma:
        cols = ty + 2 * halo
        return halo, rows, cols, rows * cols
    shift = -halo % 4            # the box's columns before the window
    cols = -(-(ty + 2 * halo + shift) // 4) * 4
    return halo, rows, cols, -(-(rows * cols + shift) // 32) * 32


def _visc_plane(n_tracers: int, steps: int) -> int:
    """Floats of one of a viscous form's four stress planes."""
    tx, ty = TILES[steps][:2]
    vhw = (steps - 1) * (3 + (1 if n_tracers else 0)) + 1 + (
        1 if n_tracers else 0)
    return (tx + 2 * vhw) * (ty + 2 * vhw)


def _n_planes(n_tracers: int, steps: int) -> int:
    """The working planes of Form: 16, a chained form's 4 and, chained
    with a fixed tracer count, each tracer's 2 levels."""
    nt = n_tracers if n_tracers <= MAX_TRACERS else -1   # TLOOP
    chain = steps > 1
    return N_SMEM_PLANES + (N_CHAIN_PLANES if chain else 0) + (
        2 * n_tracers if chain and nt > 0 else 0)


@functools.lru_cache(maxsize=None)
def window_geometry(n_tracers: int, steps: int = 1, visc: bool = False,
                    hrp: bool = False, ffs: bool = True,
                    persistent: bool = False) -> Geometry:
    """The :class:`Geometry` of the fast form with ``n_tracers`` tracers
    and ``steps`` model steps a launch, viscous or not, on bathymetry
    planes (``hrp``) or not, with a full free surface (``ffs``) or not:
    what ``csrc/fused_step.cu``'s ``fused_sw_step_geometry`` reports,
    computed here from the same rules (chip_smoke.py holds the two
    together on the card). ``persistent``: the persistent walk's (one step
    a tile), whose larger static shared memory enters its carveout."""
    tx, ty, _, min_blocks = TILES[steps]
    nt = n_tracers if n_tracers <= MAX_TRACERS else -1   # TLOOP
    halo, rows, cols, plane = _window(n_tracers, steps, True)
    chain = steps > 1
    n_planes = _n_planes(n_tracers, steps)
    vplane = _visc_plane(n_tracers, steps)
    base = 4 * (n_planes * plane + (N_VISC_PLANES * vplane if visc else 0))
    fits = SM_SMEM // (base + BLOCK_RESERVED + STATIC_SMEM)
    blocks = max(1, fits) if fits < min_blocks else min_blocks
    budget = SM_SMEM // blocks - BLOCK_RESERVED - STATIC_SMEM
    room = 0 if (nt < 0 and chain) or budget < base \
        else (budget - base) // (4 * plane)
    ruv = room >= 2
    r = room - 2 * ruv
    sshp = not chain and r >= 1
    r -= sshp
    uvp = not chain and r >= 2
    r -= 2 * uvp
    rh = r >= 1
    r -= rh
    tr = not chain and nt > 0 and r >= 2 * nt
    n_extra = room - r + (2 * nt if tr else 0)
    boxes = ((4 + hrp) + (2 + 2 * visc + (chain or sshp or ffs)) + 1
             + 2 * (not visc and (chain or uvp))
             + (2 * nt if nt > 0 and (chain or tr) else 0))
    smem = base + 4 * n_extra * plane + 128
    static = GEN_STATIC if persistent else STATIC_SMEM
    return Geometry((tx, ty), halo, rows, cols, plane, n_extra, blocks,
                    smem, boxes, True,
                    carveout_kb(blocks * (smem + static + BLOCK_RESERVED)))


@functools.lru_cache(maxsize=None)
def general_geometry(n_tracers: int, steps: int = 1,
                     visc: bool = False) -> Geometry:
    """The :class:`Geometry` of the general form (csrc/fused_tile.cuh's
    GenPlan, what a general or a persistent general library's
    ``fused_sw_step_geometry`` reports): its threads' twin's blocks an SM
    and carveout; the form loads by TMA only where its blocks keep that
    carveout with the TMA window (without tracers 15 working planes: it
    has no use for S_AQP), and then gives hr a plane of its own
    (``extra``) where the carveout leaves room. A chained run-time tracer
    form takes one block and keeps the threads' loader; its carveout here
    is the most it needs (its launcher takes the step of the tracer levels
    its block holds at run time)."""
    tx, ty, _, min_blocks = TILES[steps]
    loop_chain = n_tracers > MAX_TRACERS and steps > 1
    vbytes = (4 * N_VISC_PLANES * _visc_plane(n_tracers, steps) if visc
              else 0)
    halo, rows, cols, plane = _window(n_tracers, steps, False)
    th_base = 4 * _n_planes(n_tracers, steps) * plane + vbytes
    th_block = th_base + GEN_STATIC + BLOCK_RESERVED
    fits = SM_SMEM // th_block
    blocks = (1 if loop_chain else max(1, fits) if fits < min_blocks
              else min_blocks)
    th_carve = CARVEOUTS_KB[-1] if loop_chain else carveout_kb(
        blocks * th_block)
    _, _, t_cols, t_plane = _window(n_tracers, steps, True)
    n_work = _n_planes(n_tracers, steps) - (n_tracers == 0)
    base = 4 * n_work * t_plane + vbytes + 128
    limit = th_carve * 1024
    on = not loop_chain and blocks * (
        base + GEN_STATIC + BLOCK_RESERVED) <= limit
    hr = on and blocks * (
        base + 4 * t_plane + GEN_STATIC + BLOCK_RESERVED) <= limit
    if not on:
        return Geometry((tx, ty), halo, rows, cols, plane, 0, blocks,
                        th_base, 0, False, th_carve)
    smem = base + 4 * t_plane * hr
    return Geometry((tx, ty), halo, rows, t_cols, t_plane, int(hr), blocks,
                    smem, 5 + 2 * visc, True, carveout_kb(
                        blocks * (smem + GEN_STATIC + BLOCK_RESERVED)))


def persistent_rounds(lay: FusedLayout, grid: int) -> tuple:
    """How the persistent walk's ``grid`` blocks cover the single block's
    tiles of ``lay``: (tiles, rounds a step, the last round's share of the
    grid that has a tile)."""
    tx, ty = TILES[1][:2]
    tiles = -(-lay.Xs // tx) * -(-lay.Ys // ty)
    rounds = -(-tiles // grid)
    return tiles, rounds, (tiles - (rounds - 1) * grid) / grid


def tma_refusal(lay: FusedLayout, tensors, steps: int = 1,
                n_tracers: int = 0, general: bool = False,
                visc: bool = False) -> str | None:
    """Why TMA cannot load the windows of ``tensors`` (each (..., Xs,
    Ys) of ``lay``, contiguous float32) for the forms of ``steps`` model
    steps a launch with ``n_tracers`` tracers (the general form's with
    ``general``, viscous or not), or None: each address and row 16-byte
    aligned, the box's row a multiple of 16 bytes, at most 256 cells a
    side (csrc/tma.cuh). A general form that loads by its threads
    (:func:`general_geometry`) has nothing to refuse."""
    g = (general_geometry(n_tracers, steps, visc) if general
         else window_geometry(n_tracers, steps))
    if not g.tma:
        return None
    if (lay.Ys * 4) % TMA_ALIGN:
        return f"rows of {lay.Ys} floats are not a multiple of 16 bytes"
    if (g.cols * 4) % TMA_ALIGN or max(g.rows, g.cols) > TMA_BOX_MAX:
        return f"a {g.rows} x {g.cols} box"
    for t in tensors:
        if t.data_ptr() % TMA_ALIGN:
            return f"an input at {t.data_ptr():#x}, not 16-byte aligned"
    return None


def _wet_cells(tile_wet: torch.Tensor, tile, lay: FusedLayout):
    """The per-tile flags expanded to a bool (Xs, Ys) cell mask."""
    tx, ty = tile
    want = (-(-lay.Xs // tx), -(-lay.Ys // ty))
    if tuple(tile_wet.shape) != want:
        raise ValueError(f"tile_wet: need shape {want} for {tx} x {ty} "
                         f"tiles, got {tuple(tile_wet.shape)}")
    cells = tile_wet.repeat_interleave(tx, 0).repeat_interleave(ty, 1)
    return cells[:lay.Xs, :lay.Ys] > 0


def _one_step(fields, met, planes, lay: FusedLayout, tau: float,
              time_smooth: float, hr_const: float | None, tile_wet, tile,
              met_map, mu_const: float, visc: bool, trans: int, ffs: int,
              outs, folds: Folds = NO_FOLDS, prev=None) -> tuple:
    """One step of :func:`fused_sw_step_reference`: (the 6 + 2 T new
    fields (``outs``, their box written, with ``outs``), what step B of
    ``share_prev`` takes from this step). ``prev``: that of the step
    before, with ``folds.share_prev``."""
    n_tr = n_tracers_of(fields)
    ssh, sshp, u, up, v, vp = fields[:N_FIELDS]
    rslu_u, rslu_v, rslu_h, ld = planes[:4]
    neg_g, two_tau, neg_two_tau, inv_two_tau, ts1, ts2 = _scalars(
        tau, time_smooth, folds.q4)
    mu = float(mu_const)
    if hr_const is None:
        hrld = planes[4]
        hr = planes[5] if (visc or n_tr) else None

        def column(s):      # the TPU kernel's grouping, not (s + hr) * ld
            return s * ld + hrld if ffs else hrld
    else:
        hr = hr_const

        def column(s):
            return (s + hr_const) * ld if ffs else hr_const * ld

    def row(k):
        return met[k][None, :] if met_map is None else met[met_map[k]]

    def xp(a):
        return _sh(a, 1, 0)

    def yp(a):
        return _sh(a, 0, 1)

    # depths from (ssh, sshp): hu = hhu*dyh, hv = hhv*dxh, hh = hhh
    aq = column(ssh)
    hu = (aq + xp(aq)) * rslu_u
    hv = (aq + yp(aq)) * rslu_v
    su = aq + xp(aq)
    hh = (su + yp(su)) * rslu_h
    if prev is not None and ffs:
        # share_prev: the filter through the interpolation, from step A's
        # ts1 hu_A + ts2 hup_A (the kernel's grouping)
        hup = prev[0] + ts2 * hu
        hvp = prev[1] + ts2 * hv
    else:
        aqp = column(sshp)
        hup = (aqp + xp(aqp)) * rslu_u
        hvp = (aqp + yp(aqp)) * rslu_v
    ud = u * hu
    vd = v * hv

    wlu = ld > 0.5
    wlcu = wlu & xp(wlu)
    wlcv = wlu & yp(wlu)
    wluu = wlcu & yp(wlcu)

    ux, uy, vx, vy = xp(u), yp(u), xp(v), yp(v)
    if trans:
        # vorticity/4, edge fluxes, vorticity + Coriolis (the 1/4s folded)
        vort = torch.where(wluu, (vx - v) * row(16) - uy * row(17)
                           + u * row(18), 0.0)
        s2u = uy + u
        s2v = vx + v
        if folds.q4:        # ud, vd arrive quartered
            F = (ud + xp(ud)) * (u + ux)
            G = (vd + xp(vd)) * torch.where(wluu, s2u, 0.0)
            K = (vd + yp(vd)) * (v + vy)
            L = (ud + yp(ud)) * s2v
        else:
            F = (ud + xp(ud)) * ((u + ux) * 0.25)
            G = ((vd + xp(vd)) * 0.25) * torch.where(wluu, s2u, 0.0)
            K = (vd + yp(vd)) * ((v + vy) * 0.25)
            L = ((ud + yp(ud)) * 0.25) * s2v
        vc = (vort + row(21)) * hh
        Px = vc * s2v
        Ty = vc * s2u
        acx = (((Px - F) - G) + _sh(Px + G, 0, -1)) + _sh(F, -1, 0)
        acy = (((-Ty - L) - K) + _sh(L - Ty, -1, 0)) + _sh(K, 0, -1)
    else:
        # the Coriolis pair alone: cpair_x, and -cpair_y
        vc = row(21) * hh
        Px = vc * (vx + v)
        nTy = -(vc * (uy + u))
        acx = Px + _sh(Px, 0, -1)
        acy = nTy + _sh(nTy, -1, 0)

    # continuity and momentum
    div = ((ud - _sh(ud, -1, 0)) + vd) - _sh(vd, 0, -1)
    sshn = sshp + div * (neg_two_tau * row(9))
    slx = (xp(ssh) - ssh) * hu * neg_g
    sly = (yp(ssh) - ssh) * hv * neg_g
    if visc:
        # stress components and uv_diff2 with a constant mu: tension at
        # T points, shear at H points, their products with mu, the depth
        # and the squared metrics, differenced beside the pressure term
        q, r, s1, s2 = up * row(13), vp * row(12), up * row(10), vp * row(11)
        str_t = torch.where(wlu, row(19) * (q - _sh(q, -1, 0))
                            - row(20) * (r - _sh(r, 0, -1)), 0.0)
        str_s = torch.where(wluu, (row(6) * row(15)) * (yp(s1) - s1)
                            + (row(7) * row(14)) * (xp(s2) - s2), 0.0)
        t2 = ((hr + ssh) if ffs else hr) * str_t
        a2 = (row(1) * row(1) * mu) * t2
        b2 = (row(0) * row(0) * mu) * t2
        hs2 = hh * str_s
        d2 = (row(6) * row(6) * mu) * hs2
        e2 = (row(7) * row(7) * mu) * hs2
        slx = slx + ((xp(a2) - a2) * row(13)
                     + (d2 - _sh(d2, 0, -1)) * row(10))
        sly = sly + (-(yp(b2) - b2) * row(12)
                     + (e2 - _sh(e2, -1, 0)) * row(11))
    un = torch.where(wlcu, (up * hup + (slx + acx) * (two_tau * row(10)))
                     / torch.where(wlcu, hu, 1.0), 0.0)
    vn = torch.where(wlcv, (vp * hvp + (sly + acy) * (two_tau * row(11)))
                     / torch.where(wlcv, hv, 1.0), 0.0)

    # leapfrog rotation + Robert-Asselin filter (elide_sel: the velocity
    # selects are the identity, un and vn being 0 off their wet sets)
    ssh_new = torch.where(wlu, sshn, ssh)
    sshp_new = torch.where(wlu, ts1 * ssh + ts2 * (sshn + sshp), sshp)
    up_f, vp_f = ts1 * u + ts2 * (un + up), ts1 * v + ts2 * (vn + vp)
    if folds.elide_sel:
        out = [ssh_new, sshp_new, un, up_f, vn, vp_f]
    else:
        out = [ssh_new, sshp_new,
               torch.where(wlcu, un, u), torch.where(wlcu, up_f, up),
               torch.where(wlcv, vn, v), torch.where(wlcv, vp_f, vp)]
    # what step B of share_prev takes from this step
    dep = (ts1 * hu + ts2 * hup, ts1 * hv + ts2 * hvp)

    if n_tr:
        # tracer pass: post-step depths and transports (sshn, not
        # ssh_new: ld kills land), centred advective edge fluxes plus
        # the diffusive ones mu / dxt * hun * dff/dx when mu != 0,
        # leapfrog update with hhq_n = hr, hhq_p = hr + sshp_new (hr with
        # a linear free surface)
        aqn = column(sshn)
        hun = (aqn + xp(aqn)) * rslu_u
        hvn = (aqn + yp(aqn)) * rslu_v
        uh = torch.where(wlcu, un * hun, 0.0)
        vh = torch.where(wlcv, vn * hvn, 0.0)
        area = (row(0) * row(1)) * inv_two_tau
        bp = hr * area
        bp0 = (hr + sshp_new) * area if ffs else bp
        if mu != 0.0:
            # with q4 hun, hvn arrive quartered: 4 mu
            mu_t = 4.0 * mu if folds.q4 else mu
            kx = (mu_t * row(10)) * torch.where(wlcu, hun, 0.0)
            ky = (mu_t * row(11)) * torch.where(wlcv, hvn, 0.0)
        adv = -2.0 if folds.q4 else -0.5
    for t in range(n_tr):
        ff, ffp = fields[N_FIELDS + 2 * t], fields[N_FIELDS + 2 * t + 1]
        fx = uh * ((ff + xp(ff)) * adv)
        fy = vh * ((ff + yp(ff)) * adv)
        if mu != 0.0:
            fx = fx + kx * (xp(ff) - ff)
            fy = fy + ky * (yp(ff) - ff)
        rhs = ((fx - _sh(fx, -1, 0)) + fy) - _sh(fy, 0, -1)
        ffn = torch.where(wlu, (bp0 * ffp + rhs)
                          / torch.where(wlu, bp, 1.0), 0.0)
        ffp_f = ts1 * ff + ts2 * (ffn + ffp)
        if folds.elide_sel:
            out += [ffn, ffp_f]
        else:
            out += [torch.where(wlu, ffn, ff), torch.where(wlu, ffp_f, ffp)]
    return _finish(out, tile_wet, tile, lay, outs), dep


def _one_step_general(fields, met, planes, lay: FusedLayout, tau: float,
                      time_smooth: float, tile_wet, tile, met_map,
                      mu_const: float, visc: bool, trans: int, ffs: int,
                      outs) -> tuple:
    """One step of the general form (the TPU kernel's non-fast branch,
    :381-1039 there), formula by formula in its order: the 6 + 2 T new
    fields (``outs``, their box written, with ``outs``)."""
    n_tr = n_tracers_of(fields)
    ssh, sshp, u, up, v, vp = fields[:N_FIELDS]
    lu, hr = planes[0], planes[1]
    neg_g, two_tau, _, inv_two_tau, ts1, ts2 = _scalars(tau, time_smooth)
    mu, f = float(mu_const), float(ffs)

    def row(k):
        return met[k][None, :] if met_map is None else met[met_map[k]]

    def xp(a):
        return _sh(a, 1, 0)

    def yp(a):
        return _sh(a, 0, 1)

    # the staggered wet masks, and the reciprocal wet counts of the depth
    # interpolations: selects on the wet-neighbour sums, or their planes
    lux, luy, luxy = xp(lu), yp(lu), _sh(lu, 1, 1)
    wlu = lu > 0.5
    wlcu = (lu * lux) > 0.5
    wlcv = (lu * luy) > 0.5
    wluu = (((lu * lux) * luy) * luxy) > 0.5
    if len(planes) > 2:
        rslu_u, rslu_v, rslu_h = planes[2:5]
    else:
        rslu_u = torch.where(lu + lux > 1.5, 0.5, 1.0)
        rslu_v = torch.where(lu + luy > 1.5, 0.5, 1.0)
        slu = ((lu + lux) + luy) + luxy
        rslu_h = torch.where(slu > 3.5, 0.25, torch.where(
            slu > 2.5, THIRD, torch.where(slu > 1.5, 0.5, 1.0)))
    u_mt = row(10) * row(13)             # 1/dxt * 1/dyh
    v_mt = row(12) * row(11)             # 1/dxh * 1/dyt
    h_mt = row(14) * row(15)             # 1/dxb * 1/dyb
    dxdy = row(0) * row(1)

    def column(s):                       # aq = hq * dx*dy * lu
        return ((hr + s * f) * dxdy) * lu

    def interp_u(a):
        return ((a + xp(a)) * rslu_u) * u_mt

    def interp_v(a):
        return ((a + yp(a)) * rslu_v) * v_mt

    aq = column(ssh)
    hu, hv = interp_u(aq), interp_v(aq)
    hh = ((((aq + xp(aq)) + yp(aq)) + _sh(aq, 1, 1)) * rslu_h) * h_mt
    aqp = column(sshp)
    hup, hvp = interp_u(aqp), interp_v(aqp)

    # continuity
    ud = (u * hu) * row(5)
    vd = (v * hv) * row(4)
    div = ((ud - _sh(ud, -1, 0)) + vd) - _sh(vd, 0, -1)
    sshn = torch.where(wlu, sshp - two_tau * (div * row(9)), 0.0)

    s2v = xp(v) + v
    s2u = yp(u) + u
    gx = (xp(ssh) - ssh) * hu * (row(5) * neg_g)
    gy = (yp(ssh) - ssh) * hv * (row(4) * neg_g)
    if visc:
        # stress components and uv_diff2 with a constant mu
        q, r = up * row(13), vp * row(12)
        str_t = torch.where(wlu, (row(1) / row(0)) * (q - _sh(q, -1, 0))
                            - (row(0) / row(1)) * (r - _sh(r, 0, -1)), 0.0)
        s1, s2 = up * row(10), vp * row(11)
        str_s = torch.where(wluu, (row(6) * row(15)) * (yp(s1) - s1)
                            + (row(7) * row(14)) * (xp(s2) - s2), 0.0)
        t2 = (hr + ssh * f) * str_t
        a2 = (row(1) * row(1) * mu) * t2
        b2 = (row(0) * row(0) * mu) * t2
        hs2 = hh * str_s
        d2 = (row(6) * row(6) * mu) * hs2
        e2 = (row(7) * row(7) * mu) * hs2
        gx = gx + torch.where(wlcu, (xp(a2) - a2) * row(13)
                              + (d2 - _sh(d2, 0, -1)) * row(10), 0.0)
        gy = gy + torch.where(wlcv, -(yp(b2) - b2) * row(12)
                              + (e2 - _sh(e2, -1, 0)) * row(11), 0.0)
    if trans:
        # vorticity, the telescoped edge fluxes F, G, K, L and the
        # vorticity double terms
        vd_t, ud_t = v * row(3), u * row(2)
        vort = torch.where(wluu, (xp(vd_t) - vd_t) - (yp(ud_t) - ud_t)
                           - ((xp(v) - v) * row(7) - (yp(u) - u) * row(6)),
                           0.0)
        vorth = vort * hh
        luu = torch.where(wluu, 1.0, 0.0)
        F = (ud + xp(ud)) * (u + xp(u)) * 0.25
        G = (vd + xp(vd)) * s2u * (luu * 0.25)
        K = (vd + yp(vd)) * (v + yp(v)) * 0.25
        L = (ud + yp(ud)) * s2v * 0.25
        H2, M2 = vorth * s2v, vorth * s2u
        gx = gx + torch.where(wlcu, -(F - _sh(F, -1, 0) + G - _sh(G, 0, -1))
                              + (H2 + _sh(H2, 0, -1)) * 0.25, 0.0)
        gy = gy + torch.where(wlcv, -(L - _sh(L, -1, 0) + K - _sh(K, 0, -1))
                              - (M2 + _sh(M2, -1, 0)) * 0.25, 0.0)
    # Coriolis
    corio = (row(8) * row(6) * row(7)) * hh
    C2v, C2u = corio * s2v, corio * s2u
    gx = gx + (C2v + _sh(C2v, 0, -1)) * 0.25
    gy = gy - (C2u + _sh(C2u, -1, 0)) * 0.25

    # momentum: (up*bp0 + gr) / bp
    bpm_u = row(2) * row(5) * inv_two_tau
    bpm_v = row(3) * row(4) * inv_two_tau
    un = torch.where(wlcu, (up * (hup * bpm_u) + gx)
                     / torch.where(wlcu, hu * bpm_u, 1.0), 0.0)
    vn = torch.where(wlcv, (vp * (hvp * bpm_v) + gy)
                     / torch.where(wlcv, hv * bpm_v, 1.0), 0.0)

    # leapfrog rotation + Robert-Asselin filter
    ssh_new = torch.where(wlu, sshn, ssh)
    sshp_new = torch.where(wlu, ts1 * ssh + ts2 * (sshn + sshp), sshp)
    out = [ssh_new, sshp_new,
           torch.where(wlcu, un, u),
           torch.where(wlcu, ts1 * u + ts2 * (un + up), up),
           torch.where(wlcv, vn, v),
           torch.where(wlcv, ts1 * v + ts2 * (vn + vp), vp)]

    if n_tr:
        # the post-step depths from the new ssh, the transports and the
        # flux factors every tracer shares
        aqn = column(ssh_new)
        hun, hvn = interp_u(aqn), interp_v(aqn)
        uh, vh = out[2] * hun, out[4] * hvn
        mu_x = mu * (row(5) * row(10))
        mu_y = mu * (row(4) * row(11))
        area = row(0) * row(1) * inv_two_tau
        bp = hr * area
        bp0 = (hr + sshp_new * f) * area
    for t in range(n_tr):
        ff, ffp = fields[N_FIELDS + 2 * t], fields[N_FIELDS + 2 * t + 1]
        fx = uh * (ff + xp(ff)) * (row(5) * -0.5)
        fy = vh * (ff + yp(ff)) * (row(4) * -0.5)
        if mu != 0.0:
            fx = fx + mu_x * hun * (xp(ff) - ff)
            fy = fy + mu_y * hvn * (yp(ff) - ff)
        fx = torch.where(wlcu, fx, 0.0)
        fy = torch.where(wlcv, fy, 0.0)
        rhs = ((fx - _sh(fx, -1, 0)) + fy) - _sh(fy, 0, -1)
        ffn = torch.where(wlu, (bp0 * ffp + rhs)
                          / torch.where(wlu, bp, 1.0), 0.0)
        out.append(torch.where(wlu, ffn, ff))
        out.append(torch.where(wlu, ts1 * ff + ts2 * (ffn + ffp), ffp))
    return _finish(out, tile_wet, tile, lay, outs)


def _finish(out, tile_wet, tile, lay: FusedLayout, outs) -> tuple:
    """A step's new fields: the guard's zeros in the tiles flagged
    all-land, and with ``outs`` their box written into those."""
    if tile_wet is not None:
        cells = _wet_cells(tile_wet, tile, lay)
        out = [torch.where(cells, o, 0.0) for o in out]
    if outs is not None:
        box = _box(lay)
        for o, new in zip(outs, out):
            o[box] = new[box]
        out = outs
    return tuple(out)


def _box(lay: FusedLayout) -> tuple:
    """The valid box ``[M, M + lay.nx) x [M, M + lay.ny)``: the interior,
    or a shard's own cells in the raw form."""
    m = lay.margin
    return slice(m, m + lay.nx), slice(m, m + lay.ny)


def _chain(fields, met, planes, lay: FusedLayout, tau: float,
           time_smooth: float, hr_const: float | None, tile_wet, tile,
           met_map, mu_const: float, visc: bool, trans: int, ffs: int,
           steps: int, outs, general: bool = False,
           folds: Folds = NO_FOLDS):
    """``steps`` plain steps as one launch of the kernel runs them: the
    earlier ones on whole arrays without the guard (the kernel computes
    them in each wet tile's own window, whatever the flags of the tiles
    that window covers; in the raw form a dry-flagged tile's margin cells
    may be wet and read), the last with the guard and into ``outs``; with
    ``folds.share_prev`` each later step takes its previous-level depths
    from the step before. Returns (the last step's fields, each step's
    |ssh| as the block max reads it: zero in the tiles flagged
    all-land)."""
    if steps not in (1, 2):
        raise ValueError(f"steps={steps}: the kernel runs 1 or 2 steps a "
                         "launch")
    folds = _check_folds(folds, general)
    seen, dep = [], None
    for s in range(steps):
        last = s == steps - 1
        guard, into = (tile_wet, outs) if last else (None, None)
        if general:
            fields = _one_step_general(fields, met, planes, lay, tau,
                                       time_smooth, guard, tile, met_map,
                                       mu_const, visc, trans, ffs, into)
        else:
            fields, dep = _one_step(
                fields, met, planes, lay, tau, time_smooth, hr_const, guard,
                tile, met_map, mu_const, visc, trans, ffs, into, folds,
                dep if folds.share_prev else None)
        ssh = fields[0]
        if tile_wet is not None and not last:
            ssh = torch.where(_wet_cells(tile_wet, tile, lay), ssh, 0.0)
        seen.append(ssh.abs())
    return fields, seen


def fused_sw_step_reference(fields, met, planes, lay: FusedLayout,
                            tau: float, time_smooth: float,
                            hr_const: float | None, tile_wet=None,
                            tile=None, met_map=None, mu_const: float = 0.0,
                            visc: bool = False, trans: int = 1, ffs: int = 1,
                            steps: int = 1, general: bool = False,
                            folds: Folds = NO_FOLDS, outs=None):
    """One launch of the fused step in plain PyTorch on whole arrays,
    with the kernel's formulas in the kernel's order (see
    csrc/fused_step.cu). ``tile_wet`` (with its ``tile`` shape) reproduces
    the guard: zeros, and a max of 0, in every tile flagged all-land.
    ``met_map``: None for profile metrics, else the row -> plane map of a
    (n, Xs, Ys) ``met``. ``hr_const=None``: varying bathymetry on the
    planes of :func:`kernel_planes`. ``trans``, ``ffs``: the advection and
    free-surface switches. ``steps``: model steps a launch; 2 is the
    chained form, this function's single step twice, the guard on the
    second only, the max over both. ``general``: the general form (see
    the module's docstring). ``folds``: the fast form's :class:`Folds`.
    ``outs``: the raw form -- the box
    ``[M, M + lay.nx) x [M, M + lay.ny)`` of these 6 + 2 T tensors is
    written and they are returned, everything else in them untouched (a
    chained raw launch runs its first step on the whole margined
    block)."""
    out, seen = _chain(fields, met, planes, lay, tau, time_smooth, hr_const,
                       tile_wet, tile, met_map, mu_const, visc, trans, ffs,
                       steps, outs, general, folds)
    box = _box(lay)
    mx = torch.amax(seen[0][box])
    for a in seen[1:]:
        mx = torch.maximum(mx, torch.amax(a[box]))
    return out, mx


def _check_folds(folds, general: bool) -> Folds:
    """``folds`` as :class:`Folds`; the general form has none."""
    folds = Folds(*map(bool, folds))
    if general and any(folds):
        raise ValueError("elide_sel/q4/share_prev are folds of the fast "
                         "form, not of the general form")
    return folds


def kernel_folds(folds, steps: int, ffs: int) -> Folds:
    """The folds of the kernel instantiation a launch runs: share_prev
    only where there is a step B whose previous-level depths are not the
    static ones (two steps a launch, a full free surface)."""
    folds = Folds(*map(bool, folds))
    return folds._replace(share_prev=folds.share_prev and steps > 1
                          and bool(ffs))


def fold_code(folds) -> int:
    """The kernel's FOLD template argument of ``folds``: 1 elide_sel, 2
    q4, 4 share_prev, or'ed (``csrc/fused_step.cu``)."""
    return int(folds[0]) | 2 * int(folds[1]) | 4 * int(folds[2])


def _check_inputs(fields, met, planes, lay: FusedLayout, tile_wet,
                  tile, met_map, hr_const, visc, trans, outs=None,
                  steps: int = 1, chain_tile=None,
                  general: bool = False) -> None:
    n_tr = n_tracers_of(fields)
    if met_map is None:
        met_shape = (N_PROF, lay.Ys)
    elif general:
        if dict(met_map) != GENERAL_MAP:
            raise ValueError("met_map: the general form reads metric planes "
                             "0-15 at their own index (GENERAL_MAP)")
        met_shape = (N_GENERAL, lay.Xs, lay.Ys)
    else:
        missing = [r for r in fast2d_met_rows(n_tr, visc, trans) if not
                   0 <= met_map.get(r, -1) < met.shape[0]]
        if missing:
            raise ValueError(f"met_map: no plane of met for the metric "
                             f"rows {missing}")
        met_shape = (met.shape[0], lay.Xs, lay.Ys)
    if general:
        names = kernel_planes(general=True,
                              static_rslu=planes.shape[0] > 2)
    else:
        names = kernel_planes(n_tr, visc, hr_const is None)
    want = {"field": (lay.Xs, lay.Ys), "met": met_shape,
            "planes " + ", ".join(names): (len(names), lay.Xs, lay.Ys),
            "output": (lay.Xs, lay.Ys)}
    dev = fields[0].device
    for (kind, shape), ts in zip(want.items(), (fields, [met], [planes],
                                                outs or ())):
        for t in ts:
            if (dev.type != "cuda" or t.device != dev
                    or t.dtype != torch.float32):
                raise ValueError(f"{kind}: need float32 CUDA tensors on "
                                 f"{dev}, got {t.dtype} on {t.device}")
            if tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"{kind}: need a contiguous {shape} "
                                 f"tensor, got {tuple(t.shape)}")
    if steps not in (1, 2):
        raise ValueError(f"steps={steps}: the kernel runs 1 or 2 steps a "
                         "launch")
    why = tma_refusal(lay, (*fields, planes), steps, n_tr, general, visc)
    if why:
        raise ValueError(f"the {'general' if general else 'fast'} form's "
                         f"TMA loader cannot take {why}")
    if tile_wet is None:
        return
    want = tile_shape(dev, steps, chain_tile)
    if tuple(tile) != want:
        raise ValueError(f"tile_wet was built for {tuple(tile)} tiles, the "
                         f"kernel's are {want}")
    if (tile_wet.device != dev or tile_wet.dtype != torch.int32
            or not tile_wet.is_contiguous()
            or tuple(tile_wet.shape) != (-(-lay.Xs // tile[0]),
                                         -(-lay.Ys // tile[1]))):
        raise ValueError("tile_wet: need a contiguous int32 tensor on "
                         f"{dev} with one flag per block, got "
                         f"{tile_wet.dtype} {tuple(tile_wet.shape)} on "
                         f"{tile_wet.device}")


def fused_sw_step_blockmax(fields, met, planes, lay: FusedLayout,
                           tau: float, time_smooth: float,
                           hr_const: float | None, tile_wet=None, tile=None,
                           met_map=None, mu_const: float = 0.0,
                           visc: bool = False, trans: int = 1, ffs: int = 1,
                           steps: int = 1, general: bool = False,
                           folds: Folds = NO_FOLDS, outs=None,
                           blockmax=None, chain_tile=None):
    """Launch the CUDA kernel once on CUDA tensors (counted in
    ``fused_sw_step.launches``, and per kernel instantiation ``(T,
    guarded, 2D metrics, mu mode, bathymetry planes, raw, trans, ffs,
    steps, general, folds)`` in ``fused_sw_step.form_launches``;
    :func:`mu_mode` names the modes; the general form's bathymetry is
    always a plane, and counts as not; folds: :func:`fold_code` of
    :func:`kernel_folds`). ``steps = 2`` launches the chained form: two
    model steps in the one launch, counted once. Returns ``(6 + 2 T new
    fields, the (x tiles, y tiles) per-block max |ssh_new| over interior
    cells)``; raises if the kernel does not build or launch. With ``outs`` (and
    ``blockmax``, a contiguous float32 (x tiles, y tiles) tensor) it
    launches the raw form into them and allocates nothing.
    ``chain_tile``: see :func:`library_target`. ``folds``: the fast
    form's :class:`Folds`, any combination (the libraries of the ones
    :func:`fold_targets` leaves out build at their first launch)."""
    visc, trans, ffs = bool(visc), int(bool(trans)), int(bool(ffs))
    general = bool(general)
    raw = outs is not None
    folds = kernel_folds(_check_folds(folds, general), steps, ffs)
    _check_inputs(fields, met, planes, lay, tile_wet, tile, met_map,
                  hr_const, visc, trans, outs, steps, chain_tile, general)
    n_tr = n_tracers_of(fields)
    lib = _library(n_tr, raw, trans, ffs, steps, chain_tile, general,
                   fold_code(folds))
    # where each metric row the kernel reads sits in met (-1: not there)
    rows = GENERAL_MET_ROWS if general else KERNEL_MET_ROWS
    where = {r: r for r in rows} if met_map is None else met_map
    slots = (ctypes.c_int * len(rows))(*(where.get(r, -1) for r in rows))
    tx, ty = tile_shape(fields[0].device, steps, chain_tile)
    n_blocks = (-(-lay.Xs // tx), -(-lay.Ys // ty))
    if raw:
        if (blockmax is None or blockmax.device != fields[0].device
                or blockmax.dtype != torch.float32
                or tuple(blockmax.shape) != n_blocks
                or not blockmax.is_contiguous()):
            raise ValueError("blockmax: the raw form needs a contiguous "
                             f"float32 {n_blocks} tensor on "
                             f"{fields[0].device}")
    else:
        outs = tuple(torch.empty_like(f) for f in fields)
        blockmax = torch.empty(n_blocks, dtype=torch.float32,
                               device=fields[0].device)
    ptr = [t.data_ptr() for t in (*fields[:N_FIELDS], met, planes,
                                  *outs[:N_FIELDS], blockmax)]
    tr_in = (ctypes.c_void_p * (2 * n_tr))(
        *(t.data_ptr() for t in fields[N_FIELDS:]))
    tr_out = (ctypes.c_void_p * (2 * n_tr))(
        *(t.data_ptr() for t in outs[N_FIELDS:]))
    table = scratch = None
    if n_tr >= LOOP_TRACERS:
        # the pointer table the launcher fills in stream order, and the
        # chained form's tracer levels that shared memory does not hold;
        # both go when this returns, and the caching allocator hands
        # their memory out again only in this stream's order, after the
        # launch has read it
        dev = fields[0].device
        table = torch.empty(4 * n_tr, dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            n_scratch = lib.fused_sw_step_scratch_floats(
                n_tr, int(visc), lay.Xs, lay.Ys)
        if n_scratch:
            scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    with torch.cuda.device(fields[0].device):   # launch on the tensors' card
        rc = lib.fused_sw_step_launch(
            *ptr, tr_in, tr_out,
            None if table is None else table.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            None if tile_wet is None else tile_wet.data_ptr(), slots,
            int(met_map is not None), n_tr, planes.shape[0], int(visc),
            int(raw), trans, ffs, steps, lay.Xs, lay.Ys, lay.nx, lay.ny,
            lay.margin,
            0.0 if hr_const is None else float(hr_const), float(mu_const),
            *_scalars(tau, time_smooth, folds.q4),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("fused_sw_step kernel launch failed: "
                           + lib.fused_sw_step_error_string(rc).decode())
    fused_sw_step.launches += 1
    fused_sw_step.form_launches[
        n_tr, tile_wet is not None, met_map is not None,
        mu_mode(n_tr, mu_const, visc), hr_const is None and not general,
        raw, trans, ffs, steps, general, fold_code(folds)] += 1
    return outs, blockmax


def fused_sw_step(fields, met, planes, lay: FusedLayout, tau: float,
                  time_smooth: float, hr_const: float | None, tile_wet=None,
                  tile=None, met_map=None, mu_const: float = 0.0,
                  visc: bool = False, trans: int = 1, ffs: int = 1,
                  steps: int = 1, general: bool = False,
                  folds: Folds = NO_FOLDS):
    """One launch of the fused step: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (:func:`fused_sw_step_blockmax`);
    ``steps`` model steps (1, or 2 chained in the one launch). Returns
    ``(6 + 2 T new fields, 0-dim max |ssh_new| over interior cells)``;
    the max propagates NaN. ``tile_wet``/``tile``: the guard's flags
    (``fused_layout.tile_wet``) and the tile they were built for
    (:func:`tile_shape`); None runs unguarded. ``met_map``: None for the
    (24, Ys) profile ``met``, else the row -> plane map of the
    (n, Xs, Ys) metric planes. ``hr_const``: the flat rest bathymetry, or
    None when ``planes`` carries it (:func:`kernel_planes`).
    ``mu_const``, ``visc``: the constant viscosity and whether the stress
    stages run; tracers diffuse whenever ``mu_const != 0``. ``trans``,
    ``ffs``: the configuration's ``trans_terms`` and
    ``full_free_surface`` (0 or 1). ``general``: the general form, with
    the planes and metrics of the module's docstring. ``folds``: the fast
    form's :class:`Folds` (``q4`` with ``rslu_u``, ``rslu_v`` scaled by
    1/4, ``elide_sel`` with the carried velocities and tracer levels 0
    off their wet sets). The max covers every step of the launch."""
    if fields[0].device.type == "cpu":
        return fused_sw_step_reference(fields, met, planes, lay, tau,
                                       time_smooth, hr_const, tile_wet,
                                       tile, met_map, mu_const, visc, trans,
                                       ffs, steps, general, folds)
    outs, blockmax = fused_sw_step_blockmax(
        fields, met, planes, lay, tau, time_smooth, hr_const, tile_wet, tile,
        met_map, mu_const, visc, trans, ffs, steps, general, folds)
    return outs, torch.amax(blockmax)


def fused_sw_step_raw(fields, outs, blockmax, met, planes, lay: FusedLayout,
                      tau: float, time_smooth: float,
                      hr_const: float | None, tile_wet=None, tile=None,
                      met_map=None, mu_const: float = 0.0,
                      visc: bool = False, trans: int = 1, ffs: int = 1,
                      steps: int = 1, general: bool = False,
                      folds: Folds = NO_FOLDS) -> None:
    """One launch of the fused step on a shard's margined block, into the
    caller's tensors: the box ``[M, M + lay.nx) x [M, M + lay.ny)`` of
    ``outs`` (6 + 2 T tensors, none of them an input) gets the new fields
    (of the second step, chained: ``steps = 2`` runs the first on the
    whole margined block, which needs a margin of
    ``fused_layout.margin_for(2, T)``), every other cell of them stays what
    it was, and ``blockmax`` ((x tiles, y tiles) of ``tile``, float32)
    gets each tile's max |ssh_new| over the box at every step,
    NaN-propagating. The plain version for CPU tensors, the CUDA kernel's
    raw form for CUDA tensors. The other arguments are those of
    :func:`fused_sw_step`."""
    if len(outs) != len(fields) or any(o is f for o in outs for f in fields):
        raise ValueError(f"outs: need {len(fields)} tensors, none of them "
                         "an input (the step cannot run in place)")
    if fields[0].device.type != "cpu":
        fused_sw_step_blockmax(fields, met, planes, lay, tau, time_smooth,
                               hr_const, tile_wet, tile, met_map, mu_const,
                               visc, trans, ffs, steps, general, folds, outs,
                               blockmax)
        return
    _, seen = _chain(fields, met, planes, lay, tau, time_smooth, hr_const,
                     tile_wet, tile, met_map, mu_const, visc, trans, ffs,
                     steps, outs, general, folds)
    tx, ty = tile
    nbx, nby = blockmax.shape
    box = _box(lay)
    mx = None
    for s in seen:
        a = torch.zeros((nbx * tx, nby * ty), dtype=torch.float32)
        a[box] = s[box]
        a = a.reshape(nbx, tx, nby, ty).amax(dim=(1, 3))
        mx = a if mx is None else torch.maximum(mx, a)
    blockmax.copy_(mx)


def fused_sw_persistent_reference(fields, met, planes, lay: FusedLayout,
                                  tau: float, time_smooth: float,
                                  hr_const: float | None,
                                  mu_const: float = 0.0, visc: bool = False,
                                  trans: int = 1, ffs: int = 1,
                                  n_steps: int = 1, general: bool = False):
    """The plain version of :func:`fused_sw_persistent`: ``n_steps``
    unguarded single steps of :func:`fused_sw_step_reference` on profile
    metrics, the max over every step (``torch.maximum``, which keeps
    NaN). Returns (new fields, 0-dim max); zero steps return the fields
    and 0."""
    mx = torch.zeros((), dtype=torch.float32, device=fields[0].device)
    for _ in range(n_steps):
        fields, m = fused_sw_step_reference(
            fields, met, planes, lay, tau, time_smooth, hr_const, None, None,
            None, mu_const, visc, trans, ffs, 1, general)
        mx = torch.maximum(mx, m)
    return tuple(fields), mx


def persistent_grid(n_tracers: int, hr_const: float | None, mu_const: float,
                    visc: bool, trans: int, ffs: int,
                    general: bool = False) -> int:
    """The co-resident grid of the persistent form on the current CUDA
    device (blocks an SM x SMs, for its registers and shared memory): the
    most blocks one launch takes. Raises if the card cannot hold one block
    an SM."""
    return _persist_grid(min(n_tracers, LOOP_TRACERS), hr_const is None,
                         mu_mode(n_tracers, mu_const, visc), int(bool(trans)),
                         int(bool(ffs)), bool(general),
                         torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _persist_grid(n_tr: int, hr_planes: bool, mode: int, trans: int, ffs: int,
                  general: bool, device: int) -> int:
    del device                    # a key: the grid is the current card's
    lib = _persist_library(n_tr, general)
    grid = ctypes.c_int(0)
    planes = (5 if general else 4 + hr_planes + (hr_planes and
                                                   (mode == 2 or n_tr > 0)))
    slots = (ctypes.c_int * lib.fused_sw_step_n_met())(
        *range(lib.fused_sw_step_n_met()))
    rc = lib.fused_sw_persist_launch(
        None, None, None, None, None, None, slots, n_tr, planes,
        int(mode == 2), trans, ffs, 1, ctypes.byref(grid), 1, 1, 1, 1, 0,
        0.0, 1.0 if mode else 0.0, *([0.0] * 6), None)
    if rc != 0:
        raise RuntimeError("fused_sw_persistent occupancy query failed: "
                           + lib.fused_sw_step_error_string(rc).decode())
    return grid.value


def fused_sw_persistent(fields, met, planes, lay: FusedLayout, tau: float,
                        time_smooth: float, hr_const: float | None,
                        mu_const: float = 0.0, visc: bool = False,
                        trans: int = 1, ffs: int = 1, n_steps: int = 1,
                        general: bool = False, spare=None):
    """``n_steps`` model steps of the unguarded step on profile metrics
    (``met`` the (24, Ys) profile; the fast form's planes, or with
    ``general`` the general form's) in ONE launch. Returns ``(6 + 2 T
    fields after the last step, 0-dim max |ssh| over every step's interior
    cells)``, NaN-keeping. CPU tensors: the plain version,
    :func:`fused_sw_persistent_reference`. CUDA tensors: the persistent
    kernel (counted once a launch in ``fused_sw_persistent.launches`` and,
    per instantiation ``(T, mu mode, bathymetry planes, trans, ffs,
    general)``, in ``.form_launches``), which steps between ``fields`` and
    ``spare`` (6 + 2 T contiguous tensors of the layout, none of them a
    field) and returns whichever set holds step ``n_steps``: ``spare``
    for odd ``n_steps``, ``fields`` itself for even ones; the other set is
    overwritten. Every cell of the layout is written each step (land
    margins keep their input's zeros). Raises if the kernel does not build
    or the card refuses the cooperative launch."""
    if n_steps < 0:
        raise ValueError(f"n_steps={n_steps}")
    if fields[0].device.type == "cpu":
        return fused_sw_persistent_reference(
            fields, met, planes, lay, tau, time_smooth, hr_const, mu_const,
            visc, trans, ffs, n_steps, general)
    visc, trans, ffs = bool(visc), int(bool(trans)), int(bool(ffs))
    general = bool(general)
    if spare is None or len(spare) != len(fields) or (
            {t.data_ptr() for t in spare} & {t.data_ptr() for t in fields}):
        raise ValueError(f"spare: need {len(fields)} tensors, none of them a "
                         "field (the steps run between the two sets)")
    _check_inputs(fields, met, planes, lay, None, None, None, hr_const, visc,
                  trans, spare, 1, None, general)
    if n_steps == 0:
        return tuple(fields), torch.zeros((), dtype=torch.float32,
                                          device=fields[0].device)
    n_tr = n_tracers_of(fields)
    lib = _persist_library(n_tr, general)
    rows = GENERAL_MET_ROWS if general else KERNEL_MET_ROWS
    slots = (ctypes.c_int * len(rows))(*rows)
    dev = fields[0].device
    with torch.cuda.device(dev):
        tiles = (-(-lay.Xs // lib.fused_sw_step_tile_x())
                 * -(-lay.Ys // lib.fused_sw_step_tile_y()))
        grid = ctypes.c_int(min(tiles, persistent_grid(
            n_tr, hr_const, mu_const, visc, trans, ffs, general)))
        # the blocks' maxima and the run-time family's pointer tables (the
        # launcher fills them in stream order): both go when this returns,
        # and the caching allocator hands their memory out again only in
        # this stream's order, after the launch
        blockmax = torch.empty(grid.value, dtype=torch.float32, device=dev)
        table = (torch.empty(8 * n_tr, dtype=torch.int64, device=dev)
                 if n_tr >= LOOP_TRACERS else None)
        sets = [(ctypes.c_void_p * len(fields))(*(t.data_ptr() for t in s))
                for s in (fields, spare)]
        rc = lib.fused_sw_persist_launch(
            sets[0], sets[1], met.data_ptr(), planes.data_ptr(),
            blockmax.data_ptr(), None if table is None else table.data_ptr(),
            slots, n_tr, planes.shape[0], int(visc), trans, ffs, n_steps,
            ctypes.byref(grid), lay.Xs, lay.Ys, lay.nx, lay.ny, lay.margin,
            0.0 if hr_const is None else float(hr_const), float(mu_const),
            *_scalars(tau, time_smooth),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("fused_sw_persistent kernel launch failed: "
                           + lib.fused_sw_step_error_string(rc).decode())
    fused_sw_persistent.launches += 1
    fused_sw_persistent.form_launches[
        n_tr, mu_mode(n_tr, mu_const, visc), hr_const is None and not general,
        trans, ffs, general] += 1
    out = spare if n_steps % 2 else fields
    return tuple(out), torch.amax(blockmax)


def reset_launch_counts() -> None:
    """Zero ``fused_sw_step.launches`` and ``.form_launches``, and those
    of ``fused_sw_persistent``."""
    for fn in (fused_sw_step, fused_sw_persistent):
        fn.launches = 0
        fn.form_launches = collections.Counter()


reset_launch_counts()


def library_target(n_tracers: int, raw: bool = False, trans: int = 1,
                   ffs: int = 1, steps: int = 1, chain_tile=None,
                   general: bool = False, folds: int = 0) -> str:
    """The build target of csrc/fused_step.cu that holds the forms with
    ``n_tracers`` tracers (raw or not) of one (trans, ffs, steps) form:
    macros ``FUSED_NT`` or ``FUSED_RAW_NT`` (``LOOP_TRACERS`` for every
    count from it up), then ``FUSED_TRANS=0``, ``FUSED_FFS=0`` and
    ``FUSED_STEPS=2`` where the form has them.
    ``chain_tile``: (rows, columns, threads, blocks an SM) of a chained
    form's tile in place of csrc/fused_tile.cuh's (a tile sweep's
    libraries); None for the header's own. ``general``: the library of
    the general forms, ``FUSED_GEN=1``, which holds every (trans, ffs)
    form of its tracer count, raw or not, and steps a launch. ``folds``:
    the :func:`fold_code` of a fast library's folds, ``FUSED_FOLD``
    (one combination a library; 0, none, has no macro)."""
    target = (f"fused_step@{'FUSED_RAW_NT' if raw else 'FUSED_NT'}="
              f"{min(n_tracers, LOOP_TRACERS)}"
              + ("@FUSED_GEN=1" if general else
                 ("" if trans else "@FUSED_TRANS=0")
                 + ("" if ffs else "@FUSED_FFS=0"))
              + ("" if steps == 1 else f"@FUSED_STEPS={steps}")
              + (f"@FUSED_FOLD={folds}" if folds else ""))
    if chain_tile is not None:
        target += "".join(f"@FUSED_CHAIN_{k}={v}" for k, v in zip(
            ("TX", "TY", "THREADS", "MIN_BLOCKS"), chain_tile))
    return target


def persist_target(n_tracers: int, general: bool = False) -> str:
    """The build target of csrc/fused_step.cu that holds the persistent
    forms with ``n_tracers`` tracers (``LOOP_TRACERS`` for every count from
    it up), fast or ``general``: every (mu mode, bathymetry, trans, ffs)
    of them."""
    return (f"fused_step@FUSED_NT={min(n_tracers, LOOP_TRACERS)}"
            + ("@FUSED_GEN=1" if general else "") + "@FUSED_PERSIST=1")


def persist_targets() -> tuple:
    """The persistent forms' 8 build targets: fast, then general, at 0, 1,
    2 tracers and from ``LOOP_TRACERS`` up."""
    return tuple(persist_target(n, general) for general in (False, True)
                 for n in range(LOOP_TRACERS + 1))


def library_targets(general: bool = False) -> tuple:
    """The build targets of csrc/fused_step.cu (``_build.build_all``
    takes them): for one step a launch, then for two chained, for each
    (trans, ffs) of ``FORMS`` one library per tracer count 0, 1, 2 and
    one for the counts from ``LOOP_TRACERS`` up, then the same for the
    raw forms, so they build at once. ``general``: the general forms'
    16 libraries instead, in the same order without the (trans, ffs)
    split."""
    if general:
        return tuple(library_target(n, raw, steps=steps, general=True)
                     for steps in (1, 2) for raw in (False, True)
                     for n in range(LOOP_TRACERS + 1))
    return tuple(library_target(n, raw, trans, ffs, steps)
                 for steps in (1, 2) for trans, ffs in FORMS
                 for raw in (False, True) for n in range(LOOP_TRACERS + 1))


# the folds the drivers reach by default (fold_code): elide_sel with q4,
# and in the chained forms with a full free surface the same with
# share_prev, and share_prev alone. elide_sel or q4 alone (1, 2; 5, 6 with
# share_prev) are JAX arguments too: their libraries build at first use
FOLD_COMBOS = {1: (3,), 2: (3, 7, 4)}


def fold_targets() -> tuple:
    """The build targets of the fast forms' folded instantiations, one
    fold combination a library beside each unfolded library of
    :func:`library_targets`: elide_sel + q4 for one step a launch; for
    two chained, that with and without share_prev and share_prev alone
    (a linear free surface has nothing to share: elide_sel + q4 only)."""
    return tuple(library_target(n, raw, trans, ffs, steps, folds=f)
                 for steps in (1, 2) for trans, ffs in FORMS
                 for f in FOLD_COMBOS[steps] if ffs or not f & 4
                 for raw in (False, True) for n in range(LOOP_TRACERS + 1))


@functools.lru_cache(maxsize=None)
def _library(n_tracers: int = 0, raw: bool = False, trans: int = 1,
             ffs: int = 1, steps: int = 1, chain_tile=None,
             general: bool = False, folds: int = 0) -> ctypes.CDLL:
    """csrc/fused_step.cu's forms (its raw forms with ``raw``) with
    ``n_tracers`` tracers (every count from ``LOOP_TRACERS`` up shares one
    library), the advection and free-surface form ``trans``, ``ffs`` and
    ``steps`` model steps a launch, built on first use, with their C
    signatures; ``general``: its general forms, every (trans, ffs) in
    one library; ``folds``: the fast forms with those folds
    (:func:`fold_code`)."""
    n_tracers = min(n_tracers, LOOP_TRACERS)
    lib = load(library_target(n_tracers, raw, trans, ffs, steps,
                              chain_tile, general, folds))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.fused_sw_step_tile_x, lib.fused_sw_step_tile_y,
               lib.fused_sw_step_threads, lib.fused_sw_step_min_blocks,
               lib.fused_sw_step_n_met, lib.fused_sw_step_built_for,
               lib.fused_sw_step_built_raw, lib.fused_sw_step_built_trans,
               lib.fused_sw_step_built_ffs, lib.fused_sw_step_built_steps,
               lib.fused_sw_step_built_general,
               lib.fused_sw_step_built_folds):
        fn.argtypes = []
        fn.restype = i
    rows = GENERAL_MET_ROWS if general else KERNEL_MET_ROWS
    if lib.fused_sw_step_n_met() != len(rows):
        raise RuntimeError("csrc/fused_step.cu reads "
                           f"{lib.fused_sw_step_n_met()} metric rows, the "
                           f"wrapper passes {len(rows)}")
    built = (lib.fused_sw_step_built_for(), lib.fused_sw_step_built_raw(),
             lib.fused_sw_step_built_trans(), lib.fused_sw_step_built_ffs(),
             lib.fused_sw_step_built_steps(),
             lib.fused_sw_step_built_general(),
             lib.fused_sw_step_built_folds())
    # a general library holds every (trans, ffs) form: -1 for both
    want = (n_tracers, int(bool(raw)),
            -1 if general else int(bool(trans)),
            -1 if general else int(bool(ffs)), steps, int(bool(general)),
            folds)
    if built != want:
        raise RuntimeError("the fused step's library was built for "
                           "(tracers, raw, trans, ffs, steps, general, "
                           f"folds) = {built}, not {want}")
    lib.fused_sw_step_error_string.argtypes = [i]
    lib.fused_sw_step_error_string.restype = ctypes.c_char_p
    lib.fused_sw_step_smem_bytes.argtypes = [i, i, ctypes.POINTER(i)]
    lib.fused_sw_step_smem_bytes.restype = ctypes.c_longlong
    lib.fused_sw_step_scratch_floats.argtypes = [i, i, i, i]
    lib.fused_sw_step_scratch_floats.restype = ctypes.c_longlong
    lib.fused_sw_step_geometry.argtypes = [i, i, i, i,
                                           ctypes.POINTER(ctypes.c_longlong)]
    lib.fused_sw_step_geometry.restype = i
    lib.fused_sw_step_launch.argtypes = ([p] * 21 + [i] * 13 + [f] * 8
                                         + [p])
    lib.fused_sw_step_launch.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _persist_library(n_tracers: int = 0, general: bool = False) -> ctypes.CDLL:
    """csrc/fused_step.cu's persistent forms with ``n_tracers`` tracers
    (every count from ``LOOP_TRACERS`` up shares one library), fast or
    ``general``, built on first use, with their C signatures."""
    n_tracers = min(n_tracers, LOOP_TRACERS)
    lib = load(persist_target(n_tracers, general))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.fused_sw_step_tile_x, lib.fused_sw_step_tile_y,
               lib.fused_sw_step_n_met, lib.fused_sw_step_built_for,
               lib.fused_sw_step_built_general,
               lib.fused_sw_step_built_persist):
        fn.argtypes = []
        fn.restype = i
    built = (lib.fused_sw_step_built_for(), lib.fused_sw_step_built_general(),
             lib.fused_sw_step_built_persist(), lib.fused_sw_step_n_met())
    want = (n_tracers, int(bool(general)), 1,
            len(GENERAL_MET_ROWS if general else KERNEL_MET_ROWS))
    if built != want:
        raise RuntimeError("the persistent step's library was built for "
                           "(tracers, general, persistent, metric rows) = "
                           f"{built}, not {want}")
    lib.fused_sw_step_error_string.argtypes = [i]
    lib.fused_sw_step_error_string.restype = ctypes.c_char_p
    lib.fused_sw_step_geometry.argtypes = [i, i, i, i,
                                           ctypes.POINTER(ctypes.c_longlong)]
    lib.fused_sw_step_geometry.restype = i
    lib.fused_sw_persist_launch.argtypes = ([p] * 7 + [i] * 6
                                            + [ctypes.POINTER(i)] + [i] * 5
                                            + [f] * 8 + [p])
    lib.fused_sw_persist_launch.restype = i
    return lib
