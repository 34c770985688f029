"""The TMA loader's geometry on the CPU (ops/fused_step.py::window_geometry
and general_geometry, the mirrors of csrc/fused_tile.cuh's Form, Plan and
GenPlan; tma_refusal, the wrapper's check of what TMA takes): every fast
form's window and planes fit the blocks an SM the plan promises, every
general form that loads by TMA keeps the carveout of its threads' twin,
the persistent walk's forms keep three blocks an SM, every box keeps TMA's
limits, and every layout the drivers build (frame, coastline, bipolar 289
x 163, 2 x 2 uniform and weighted shards, a periodic channel) and every
array they pack is one TMA takes. chip_smoke.py holds the mirrors against
the CUDA libraries' own getter on the card."""

import dataclasses
import itertools
import os

import numpy as np
import pytest
import torch

from ocean_model_arch_torch.config import (ModelConfig, Precision, SWConfig,
                                           basinpar_as250m_test,
                                           basinpar_flat)
from ocean_model_arch_torch.core.grid import build_grid
from ocean_model_arch_torch.core.masks import frame_of_land_mask
from ocean_model_arch_torch.io.mask_io import read_mask
from ocean_model_arch_torch.model.fused import FusedSWModel
from ocean_model_arch_torch.model.fused_sharded2d import FusedSharded2DModel
from ocean_model_arch_torch.model.init import init_ocean_state
from ocean_model_arch_torch.ops import fused_layout as fl
from ocean_model_arch_torch.ops import fused_step as fstep

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (tracers, steps a launch, viscous, bathymetry planes, full free surface)
FORMS = list(itertools.product((0, 1, 2, 3, 9), (1, 2), (False, True),
                               (False, True), (False, True)))


def _name(form):
    t, steps, visc, hrp, ffs = form
    return (f"T{t}-{steps}step" + "-visc" * visc + "-hrp" * hrp
            + "-linear" * (not ffs))


@pytest.mark.parametrize("form", FORMS, ids=_name)
def test_window_keeps_tma_limits(form):
    """A box is the whole window: its row a multiple of 16 bytes, at most
    256 cells a side; a plane starts on 128 bytes and holds the window and
    the columns the box begins before it (the tile's first column is a
    multiple of 4, so the box's is too); the block fits the card."""
    t, steps, visc, hrp, ffs = form
    g = fstep.window_geometry(t, steps, visc, hrp, ffs)
    assert g.tile == fstep.tile_of(steps, t, visc)[:2]
    assert g.halo == steps * (3 + (t > 0))
    shift = -g.halo % 4
    assert (g.tile[1] - g.halo - shift) % 4 == 0      # the box's column
    assert (4 * g.cols) % fstep.TMA_ALIGN == 0
    assert g.cols >= g.tile[1] + 2 * g.halo + shift
    assert g.rows == g.tile[0] + 2 * g.halo
    assert max(g.rows, g.cols) <= fstep.TMA_BOX_MAX
    assert g.plane % 32 == 0 and g.plane >= g.rows * g.cols + shift
    assert g.smem + fstep.STATIC_SMEM <= fstep.BLOCK_SMEM_MAX
    # every form loads at least stage 0's four fields and the static planes
    assert g.boxes >= 4 + 3


# the chained forms' plan, by (tracers, viscous): (tile, blocks an SM,
# dynamic shared memory of a block in bytes; a run-time tracer count's
# levels on top). Without tracers 16 x 32, 20 planes of 28 x 48: two
# blocks (one viscous, with its stress planes); with tracers 32 x 32 and
# 20 + 2 T planes of 48 x 48 (viscous: 32 x 24, planes of 48 x 40, which
# leave room for the stress planes): one block of 1024 (768) threads.
CHAIN_PLAN = {(0, False): ((16, 32), 2, 110208),
              (0, True): ((16, 32), 1, 142080),
              (1, False): ((32, 32), 1, 230528),
              (1, True): ((32, 24), 1, 217472),
              (2, False): ((32, 32), 1, 230528),
              (2, True): ((32, 24), 1, 225152),
              (3, False): ((32, 32), 1, 184448),
              (3, True): ((32, 24), 1, 179072),
              (9, False): ((32, 32), 1, 184448),
              (9, True): ((32, 24), 1, 179072)}


@pytest.mark.parametrize("form", FORMS, ids=_name)
def test_blocks_an_sm(form):
    """Three blocks an SM for every one-step form and two for the chained
    form without tracers (the viscous one takes one: its 48-column
    window); a chained form with tracers one block of its larger tile
    (CHAIN_PLAN, whatever its bathymetry and free surface); the blocks fit
    the SM's shared memory with their reserve."""
    t, steps, visc, hrp, ffs = form
    g = fstep.window_geometry(t, steps, visc, hrp, ffs)
    want = 3 if steps == 1 else 1 if t or visc else 2
    assert g.blocks == want
    if steps == 2:
        assert (g.tile, g.blocks, g.smem) == CHAIN_PLAN[t, visc]
    per_block = g.smem + fstep.STATIC_SMEM + fstep.BLOCK_RESERVED
    assert g.blocks * per_block <= fstep.SM_SMEM


def test_plans_of_the_main_forms():
    """The planes of their own the plan gives the forms users run: one step
    without tracers rslu_u, rslu_v, sshp, up, vp (5); with tracers rslu_u,
    rslu_v, sshp (3); viscous without tracers rslu_u, rslu_v (2); viscous
    with tracers none; chained without tracers none; chained with 2
    tracers rslu_h (1: its 32 x 32 block leaves one plane), viscous over
    bathymetry planes rslu_u, rslu_v (2: its 32 x 24 block leaves two; the
    bathymetry planes have none); the run-time tracer family chained
    none."""
    want = {(0, 1, False, False): 5, (2, 1, False, False): 3,
            (0, 1, True, False): 2, (2, 1, True, False): 0,
            (0, 2, False, False): 0, (2, 2, False, False): 1,
            (2, 2, True, True): 2, (9, 2, False, False): 0,
            (9, 1, False, False): 3, (0, 1, False, True): 5}
    for (t, steps, visc, hrp), n in want.items():
        g = fstep.window_geometry(t, steps, visc, hrp, True)
        assert g.extra == n, (t, steps, visc, hrp, g)


def _refusal(fm, fields):
    return fstep.tma_refusal(fm.lay, (*fields, fm.planes), fm.steps_per_call,
                             fm.n_tracers)


def _basin(name):
    """(basin, land mask) of a layout the drivers build, cut to a size the
    CPU builds quickly where the full one is large: the layout's rules (Ys a
    multiple of 32, the margins) do not depend on the extents."""
    full = basinpar_as250m_test()
    if name == "bipolar":
        b = dataclasses.replace(full, nx=289, ny=163, dxst=0.05, dyst=0.04,
                                rlon=27.525, rlat=40.94, curve_grid=2)
        return b, frame_of_land_mask(289, 163)
    mask = read_mask(os.path.join(REPO, "data", "AS", "maskAzovCor.txt"),
                     full.nx, full.ny)[512:700, 357:517].copy()
    mask[:2] = mask[-2:] = 1
    mask[:, :2] = mask[:, -2:] = 1
    return dataclasses.replace(full, nx=188, ny=160), mask


@pytest.mark.parametrize("name", ["frame", "coastline"])
def test_full_size_layouts_take_tma(name):
    """The layouts of the Azov 250 m extents (frame and coastline share
    them), one step and chained, with and without tracers: rows a multiple
    of 16 bytes, so every plane of a stacked tensor starts on 16 bytes."""
    full = basinpar_as250m_test()
    for steps, t in itertools.product((1, 2), (0, 2)):
        lay = fl.make_layout(full.nx, full.ny)
        assert (4 * lay.Ys) % fstep.TMA_ALIGN == 0
        planes = torch.zeros((6, lay.Xs, lay.Ys))
        assert fstep.tma_refusal(lay, planes.unbind(0), steps, t) is None


@pytest.mark.parametrize("spc", [1, 2])
@pytest.mark.parametrize("name", ["coastline", "bipolar"])
def test_block_drivers_pack_what_tma_takes(name, spc):
    """``FusedSWModel``'s packed fields and static planes (2 tracers, the
    fast form) are arrays TMA takes."""
    basin, mask = _basin(name)
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=1, tracer_num=2),
                      precision=Precision.f32())
    grid = build_grid(basin, mask, precision=Precision.f32(), device="cpu")
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True, steps_per_call=spc)
    assert _refusal(fm, fm.pack(init_ocean_state(grid, cfg))) is None


@pytest.mark.parametrize("weighted", [False, True], ids=["uniform",
                                                         "weighted"])
def test_shard_layouts_take_tma(weighted):
    """The raw form's arrays: each shard's fields and planes of a 2 x 2
    split, uniform and weighted cuts, one step and chained."""
    basin, mask = _basin("coastline")
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=1, tracer_num=2),
                      precision=Precision.f32())
    grid = build_grid(basin, mask, precision=Precision.f32(), device="cpu")
    state = init_ocean_state(grid, cfg)
    for spc in (1, 2):
        fs = FusedSharded2DModel(grid, cfg, 1.0, 2, 2, weighted=weighted,
                                 steps_per_call=spc)
        carry = fs.pack(state)
        for i, j in itertools.product(range(2), range(2)):
            fields = carry[2 * i + j].unbind(0)
            assert fstep.tma_refusal(fs.shard_lay[i][j],
                                     (*fields, fs.plane_shards[i][j]),
                                     spc, 2) is None


def test_periodic_channel_takes_tma():
    """The periodic channel through the raw form at 1 x 1 (``channel``)."""
    basin = dataclasses.replace(
        basinpar_flat(96, 48, curve_grid=1, rlon=27.5, rlat=41.0),
        periodicity_x=1)
    mask = np.zeros((96, 48), np.int32)
    mask[:, :2] = mask[:, -2:] = 1
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=1, tracer_num=2),
                      precision=Precision.f32())
    grid = build_grid(basin, mask, precision=Precision.f32(), device="cpu")
    fs = FusedSharded2DModel(grid, cfg, 1.0, 1, 1)
    fields = fs.pack(init_ocean_state(grid, cfg))[0].unbind(0)
    assert fstep.tma_refusal(fs.shard_lay[0][0],
                             (*fields, fs.plane_shards[0][0]), 1, 2) is None


def test_refusals():
    """What TMA does not take is refused, with the reason: a row that is
    not a multiple of 16 bytes, an input not on 16 bytes."""
    lay = fl.FusedLayout(10, 10, 18, 18, 4)
    assert "rows" in fstep.tma_refusal(lay, (torch.zeros((18, 18)),))
    lay = fl.make_layout(40, 40)
    base = torch.zeros(lay.Xs * lay.Ys + 1)
    shifted = base[1:].view(lay.Xs, lay.Ys)
    assert "aligned" in fstep.tma_refusal(lay, (shifted,))
    assert fstep.tma_refusal(lay, (base[:-1].view(lay.Xs, lay.Ys),)) is None


# the general form's (tracers, steps a launch, viscous, metric planes)
GEN_FORMS = list(itertools.product((0, 1, 2, 3, 9), (1, 2), (False, True),
                                   (False, True)))


def _gen_name(form):
    t, steps, visc, met2d = form
    return f"T{t}-{steps}step" + "-visc" * visc + "-planes" * met2d


def _twin_carveout(t, steps, visc):
    """(blocks an SM, carveout KB) of the general form's threads' twin,
    worked out here from its window on its tile (tile_of: 16 x 32 one step
    and chained without tracers, 32 x 32 chained with, 32 x 24 viscous):
    (TX + 2 H) x (TY + 2 H) cells a plane, 16 planes (20 + 2 T chained at
    a fixed count), a viscous form's four stress planes of the region 1 +
    EXTRA cells (plus a chained step's H) around the tile."""
    tx, ty, _, bound = fstep.tile_of(steps, t, visc, True)
    halo = steps * (3 + (t > 0))
    plane = (tx + 2 * halo) * (ty + 2 * halo)
    n = 16 + (4 + (2 * t if 0 < t <= 2 else 0) if steps == 2 else 0)
    vh = (steps - 1) * (3 + (t > 0)) + 1 + (t > 0)
    nbytes = 4 * (n * plane + (4 * (tx + 2 * vh) * (ty + 2 * vh)
                               if visc else 0))
    if t > 2 and steps == 2:          # its tracer levels fill one block
        return 1, 228
    block = nbytes + fstep.GEN_STATIC + fstep.BLOCK_RESERVED
    blocks = min(bound, fstep.SM_SMEM // block)
    return blocks, fstep.carveout_kb(blocks * block)


@pytest.mark.parametrize("form", GEN_FORMS, ids=_gen_name)
def test_general_window_keeps_tma_limits(form):
    """A general form by TMA: the box is the whole window, its columns a
    multiple of 16 bytes from a column that is one, at most 256 cells a
    side, each plane on 128 bytes; five boxes (ssh, u, v, lu, hr) and a
    viscous form's up, vp. Every form loads by TMA but the chained ones
    without tracers that are viscous (their two blocks of the TMA window
    pass the SM) or on metric planes (their twin's carveout): they keep
    the threads' loader, no boxes; each on its own tile."""
    t, steps, visc, met2d = form
    g = fstep.general_geometry(t, steps, visc, met2d)
    assert g.tma == (steps == 1 or t > 0 or not (visc or met2d))
    assert g.tile == fstep.tile_of(steps, t, visc, True)[:2]
    assert g.halo == steps * (3 + (t > 0))
    if not g.tma:
        assert g.boxes == 0 and g.extra == 0
        assert g.cols == g.tile[1] + 2 * g.halo
        return
    shift = -g.halo % 4
    assert (g.tile[1] - g.halo - shift) % 4 == 0
    assert (4 * g.cols) % fstep.TMA_ALIGN == 0
    assert g.cols >= g.tile[1] + 2 * g.halo + shift
    assert max(g.rows, g.cols) <= fstep.TMA_BOX_MAX
    assert g.plane % 32 == 0 and g.plane >= g.rows * g.cols + shift
    assert g.boxes == 5 + 2 * visc
    assert g.smem + fstep.STATIC_SMEM <= fstep.BLOCK_SMEM_MAX


@pytest.mark.parametrize("form", GEN_FORMS, ids=_gen_name)
def test_general_keeps_its_twins_carveout(form):
    """No one-step general form's blocks an SM times its shared memory
    (with the static arrays and the block's reserve) pass the carveout
    step its threads' twin sits in: that body reads its metric rows or
    planes through L1, which a larger carveout shrinks. A chained form on
    profile metrics holds its rows a column, and its budget is the SM
    (228 KB). The blocks an SM are the twin's: three one step, two
    chained without tracers, one chained with."""
    t, steps, visc, met2d = form
    g = fstep.general_geometry(t, steps, visc, met2d)
    blocks, carve = _twin_carveout(t, steps, visc)
    assert g.blocks == blocks
    budget = carve if steps == 1 or met2d else 228
    assert g.carveout <= budget
    if not (t > 2 and steps == 2):
        assert g.blocks * (g.smem + fstep.GEN_STATIC
                           + fstep.BLOCK_RESERVED) <= budget * 1024
    # hr gets a plane of its own where the budget leaves one (one step:
    # with tracers, not viscous), never in the chained run-time tracer
    # family, whose levels follow the working planes
    room = g.blocks * (g.smem + 4 * g.plane * (1 - g.extra)
                       + fstep.GEN_STATIC + fstep.BLOCK_RESERVED) \
        <= budget * 1024
    assert g.extra == (g.tma and room and not (t > 2 and steps == 2))
    if steps == 1:
        assert g.extra == (g.tma and t > 0 and not visc)


# the persistent walk's forms: (tracers, viscous, bathymetry planes, full
# free surface, general)
WALK_FORMS = [f for f in itertools.product((0, 1, 2, 3), (False, True),
                                           (False, True), (False, True),
                                           (False, True))
              if not (f[4] and f[2])]


def _walk_name(form):
    t, visc, hrp, ffs, gen = form
    return (f"T{t}" + "-visc" * visc + "-hrp" * hrp + "-linear" * (not ffs)
            + "-general" * gen)


@pytest.mark.parametrize("form", WALK_FORMS, ids=_walk_name)
def test_walk_keeps_three_blocks(form):
    """K2's walk loads every tile by TMA with the one-step plan of its
    body (the fast one's Plan, the general one's GenPlan): three blocks an
    SM with the walk's larger static shared memory, boxes within TMA's
    limits; a general form at its twin's carveout."""
    t, visc, hrp, ffs, gen = form
    g = (fstep.general_geometry(t, 1, visc) if gen else
         fstep.window_geometry(t, 1, visc, hrp, ffs, persistent=True))
    assert g.tma and g.blocks == 3
    assert 3 * (g.smem + fstep.GEN_STATIC + fstep.BLOCK_RESERVED) \
        <= fstep.SM_SMEM
    assert (4 * g.cols) % fstep.TMA_ALIGN == 0 and g.plane % 32 == 0
    assert max(g.rows, g.cols) <= fstep.TMA_BOX_MAX
    if gen:
        assert g.carveout <= _twin_carveout(t, 1, visc)[1]
    else:
        assert g.carveout == fstep.carveout_kb(
            3 * (g.smem + fstep.GEN_STATIC + fstep.BLOCK_RESERVED))


def test_general_refusals():
    """A general form by TMA refuses what TMA does not take, as the fast
    forms do; the chained general forms without tracers that are viscous
    or on metric planes (the threads' loader) have nothing to refuse."""
    lay = fl.make_layout(40, 40)
    base = torch.zeros(lay.Xs * lay.Ys + 1)
    shifted = base[1:].view(lay.Xs, lay.Ys)
    for t, visc in itertools.product((0, 2), (False, True)):
        assert "aligned" in fstep.tma_refusal(lay, (shifted,), 1, t, True,
                                              visc)
    assert fstep.tma_refusal(lay, (shifted,), 2, 0, True, True) is None
    assert fstep.tma_refusal(lay, (shifted,), 2, 0, True, False,
                             True) is None
    for t in (0, 2, 3):
        assert "aligned" in fstep.tma_refusal(lay, (shifted,), 2, t, True)


def test_carveouts():
    """The carveout steps: the smallest that holds the bytes."""
    assert fstep.carveout_kb(0) == 0
    assert fstep.carveout_kb(164 * 1024) == 164
    assert fstep.carveout_kb(164 * 1024 + 1) == 196
    assert fstep.carveout_kb(228 * 1024 + 1) == -1
