"""The tile is a property of the form (csrc/fused_tile.cuh's shape_of,
ops/fused_step.py::tile_of): the chained forms with tracers, fast or
general, run 32 x 32 tiles of 1024 threads, the viscous ones 32 x 24 of
768, every other form 16 x 32. ``tile_shape`` asks the library that
launches the form, and the guard's per-block flags (``FusedSWModel``,
``FusedSharded2DModel``), the copy step's check and the dynamic load
balance's wet-tile counts are built at that tile. On the CPU the wrappers' plain versions run at
``CPU_TILE``; a fake library object stands in for the card's, which the
wrapper would build with nvcc, and ``tile_shape`` is sent to it as for a
CUDA device."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ocean_model_arch_torch.config import (ModelConfig, ParallelConfig,
                                           Precision, SWConfig,
                                           basinpar_flat)
from ocean_model_arch_torch.core.grid import build_grid
from ocean_model_arch_torch.io.mask_io import read_mask
from ocean_model_arch_torch.model import fused as fused_mod
from ocean_model_arch_torch.model import fused_sharded2d as sharded_mod
from ocean_model_arch_torch.model.fused import FusedSWModel
from ocean_model_arch_torch.model.fused_sharded2d import FusedSharded2DModel
from ocean_model_arch_torch.model.init import init_ocean_state
from ocean_model_arch_torch.model.model import OceanModel
from ocean_model_arch_torch.ops import copy_step as cstep
from ocean_model_arch_torch.ops import fused_layout as fl
from ocean_model_arch_torch.ops import fused_step as fstep
from ocean_model_arch_torch.utils.timers import PhaseTimers

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MU = 1.0e3

# (steps, tracers, viscous, general) -> (rows, columns, threads, blocks an
# SM the launch bound keeps registers for)
TILES = {(1, 0, False, False): (16, 32, 512, 3),
         (1, 2, True, False): (16, 32, 512, 3),
         (1, 2, False, True): (16, 32, 512, 3),
         (2, 0, False, False): (16, 32, 512, 2),
         (2, 0, True, False): (16, 32, 512, 2),
         (2, 1, False, False): (32, 32, 1024, 1),
         (2, 2, False, False): (32, 32, 1024, 1),
         (2, 4, False, False): (32, 32, 1024, 1),
         (2, 2, True, False): (32, 24, 768, 1),
         (2, 4, True, False): (32, 24, 768, 1),
         (2, 0, False, True): (16, 32, 512, 2),
         (2, 0, True, True): (16, 32, 512, 2),
         (2, 1, False, True): (32, 32, 1024, 1),
         (2, 2, False, True): (32, 32, 1024, 1),
         (2, 4, False, True): (32, 32, 1024, 1),
         (2, 1, True, True): (32, 24, 768, 1),
         (2, 2, True, True): (32, 24, 768, 1),
         (2, 4, True, True): (32, 24, 768, 1)}


@pytest.mark.parametrize("form,tile", TILES.items(), ids=str)
def test_tile_of_each_form(form, tile):
    """The mirror's tile of each form, and the registers its launch bound
    leaves: 42 one step a launch (three blocks of 512), 64 chained at two
    blocks of 512 or one of 1024, 85 at one of 768."""
    assert fstep.tile_of(*form) == tile
    assert fstep.reg_limit(tile) == {3: 42, 2: 64, 1: 64 if tile[2] == 1024
                                     else 85}[tile[3]]
    g = (fstep.general_geometry(form[1], form[0], form[2]) if form[3]
         else fstep.window_geometry(form[1], form[0], form[2]))
    assert g.tile == tile[:2]


class FakeLibrary:
    """The tile getters of the library of (tracers, steps, general) as
    csrc/fused_step.cu answers them (its shape_of, by viscosity)."""

    def __init__(self, n_tracers, steps, general):
        self.form = (n_tracers, steps, general)

    def _tile(self, visc):
        n, steps, general = self.form
        return fstep.tile_of(steps, n, bool(visc), general)

    def fused_sw_step_tile_x(self, visc):
        return self._tile(visc)[0]

    def fused_sw_step_tile_y(self, visc):
        return self._tile(visc)[1]


@pytest.fixture
def card(monkeypatch):
    """``tile_shape`` answered by a fake library, as on a CUDA device,
    also where the models call it with their CPU device; returns the
    libraries it was asked for."""
    asked = []

    def library(n_tracers=0, raw=False, trans=1, ffs=1, steps=1,
                chain_tile=None, general=False, folds=0):
        asked.append((min(n_tracers, fstep.LOOP_TRACERS), steps, general))
        return FakeLibrary(n_tracers, steps, general)

    real = fstep.tile_shape
    monkeypatch.setattr(fstep, "_library", library)

    def on_card(device, *args, **kw):
        return real("cuda", *args, **kw)

    monkeypatch.setattr(fused_mod, "tile_shape", on_card)
    monkeypatch.setattr(sharded_mod, "tile_shape", on_card)
    return asked


def test_tile_shape_asks_the_library_that_launches(card):
    """On a CUDA device the tile of a form is its own library's answer for
    its viscosity: the library of its tracer count (the run-time family
    from 3 up), its steps a launch and its body; on the CPU it is
    CPU_TILE whatever the form."""
    for (steps, n, visc, general), tile in TILES.items():
        card.clear()
        got = fstep.tile_shape("cuda", steps, n_tracers=n, visc=visc,
                               general=general)
        assert got == tile[:2]
        assert card == [(min(n, fstep.LOOP_TRACERS), steps, general)]
        assert fstep.tile_shape("cpu", steps, n_tracers=n, visc=visc,
                                general=general) == fstep.CPU_TILE


def _coastline(n_tracers, mu=0.0):
    """A 190 x 140 cut of the Azov coastline (every 8th cell, a 2-cell
    land frame): (grid, config, initial state)."""
    m = np.asarray(read_mask(os.path.join(REPO, "data/AS/maskAzovCor.txt"),
                             1525, 1115))[::8, ::8].copy()
    m[:2] = m[-2:] = 1
    m[:, :2] = m[:, -2:] = 1
    basin = basinpar_flat(*m.shape, curve_grid=1, rlon=34.75, rlat=44.8,
                          dxst=0.025, dyst=0.018)
    cfg = ModelConfig(basin=basin, sw=SWConfig(
        use_tracers=int(n_tracers > 0), tracer_num=max(n_tracers, 1)),
        precision=Precision.f32())
    grid = build_grid(basin, m, precision=cfg.precision, device="cpu")
    state = init_ocean_state(grid, cfg)
    return grid, cfg, dataclasses.replace(state,
                                          mu=torch.full_like(state.mu, mu))


# (tracers, mu, static_rslu): the main path's T = 0 form, the tracer form,
# its viscous twin, and the general forms: without tracers, with 2 (its own
# tile since it was redesigned), viscous, and the run-time tracer family
FORMS = [(0, 0.0, True), (2, 0.0, True), (2, MU, True), (2, 0.0, False),
         (0, 0.0, False), (2, MU, False), (3, 0.0, False)]


@pytest.mark.parametrize("form", FORMS, ids=lambda f: f"T{f[0]}-mu{f[1]:g}"
                         f"-{'fast' if f[2] else 'general'}")
def test_guard_flags_at_the_form_tile(card, form):
    """FusedSWModel at two steps a launch builds its guard's flags at the
    tile of the library that launches its form; the guard is exact, so 4
    steps on those flags give the fields of the run at CPU_TILE bit for
    bit."""
    n_tr, mu, fast = form
    grid, cfg, state = _coastline(n_tr, mu)
    fm = FusedSWModel(grid, cfg, 1.0, mu_const=mu, tile_guard=True,
                      static_rslu=fast, steps_per_call=2)
    want = fstep.tile_of(2, n_tr, fm.visc, fm.general)[:2]
    assert fm.tile == want and fm.visc == (mu != 0.0)
    lu_s = np.asarray(fl.embed(fm.lay, grid.lu.cpu()))
    wet = fl.tile_wet(lu_s, fm.lay, *want)
    assert np.array_equal(fm.tile_wet.numpy(), wet)
    assert fm.n_tiles == (int(wet.sum()), int(wet.size - wet.sum()))
    out, ok = fm.run_steps(fm.pack(state), 4)
    card.clear()
    fm.tile, fm.tile_wet = fstep.CPU_TILE, torch.from_numpy(
        fl.tile_wet(lu_s, fm.lay, *fstep.CPU_TILE))
    ref, ok_ref = fm.run_steps(fm.pack(state), 4)
    assert ok and ok_ref
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("n_tr,fast", [(0, True), (2, True), (0, False),
                                       (2, False)])
def test_shard_flags_and_the_dlb_at_the_form_tile(card, n_tr, fast):
    """FusedSharded2DModel builds each shard's flags at its form's tile
    (fast, or general: ``static_rslu=False``), and the dynamic load
    balance counts its wet tiles there: the ratio of the round it
    installs is that of the installed model's flags."""
    grid, cfg, state = _coastline(n_tr)
    want = fstep.tile_of(2, n_tr, False, not fast)[:2]
    fs = FusedSharded2DModel(grid, cfg, 1.0, 2, 2, steps_per_call=2,
                             static_rslu=fast)
    assert fs.tile == want and fs.general != fast
    for i in range(2):
        for j in range(2):
            assert tuple(fs.tile_wet[i][j].shape) == (
                -(-fs.lay.Xs // want[0]), -(-fs.lay.Ys // want[1]))
    om = OceanModel.__new__(OceanModel)
    om.cfg = dataclasses.replace(cfg, parallel=ParallelConfig(
        mesh_x=2, mesh_y=2, mod_decomposition=1, dlb_balance_steps=2,
        dlb_model_steps=2))
    om.timers = PhaseTimers()
    om.grid, om.state = grid, state
    hist = om.dynamic_load_balance(verbose=False)
    fs = om._fused_sh
    assert fs.tile == want
    tiles = np.array([[float(fs.tile_wet[i][j].sum()) for j in range(2)]
                      for i in range(2)])
    assert abs(tiles.max() / tiles.mean() - min(r for r, _ in hist)) < 1e-9


@pytest.mark.parametrize("steps,n_tr,visc", [(1, 0, False), (2, 0, False),
                                             (2, 2, False), (2, 2, True)])
def test_copy_step_takes_the_form_tile(monkeypatch, steps, n_tr, visc):
    """The copy step of a form asks its library for that fused form's tile
    (by steps, tracers and viscosity): the chained tracer forms' own, the
    one the fused model's flags are built at; CPU_TILE on the CPU."""

    class CopyLib:
        def copy_step_tile_x(self, tracers, v, s):
            return fstep.tile_of(s, tracers, bool(v))[0]

        def copy_step_tile_y(self, tracers, v, s):
            return fstep.tile_of(s, tracers, bool(v))[1]

    monkeypatch.setattr(cstep, "_library", lambda: CopyLib())
    want = fstep.tile_of(steps, n_tr, visc)[:2]
    assert cstep.tile_shape("cuda", steps, n_tr > 0, visc) == want
    assert cstep.tile_shape("cpu", steps, n_tr > 0, visc) == fstep.CPU_TILE
