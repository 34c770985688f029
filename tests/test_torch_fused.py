"""The port's fused driver (model/fused.py) and fused step on the CPU, where
``fused_sw_step`` runs its plain PyTorch version: held against the JAX
``FusedSWModel`` in interpret mode, the JAX f32 ``make_step``, the
committed Black Sea golden digests, and the envelope checks, without
and with tracers and the tile guard. The CUDA kernel itself is compared
with the plain version on the card by chip_smoke.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ocean_model_arch_tpu.config import Precision
from ocean_model_arch_tpu.core.grid import build_grid as jax_build_grid
from ocean_model_arch_tpu.model.fused import FusedSWModel as JaxFused
from ocean_model_arch_tpu.model.init import init_ocean_state as jax_init
from ocean_model_arch_tpu.model.step import make_step as jax_make_step
from ocean_model_arch_tpu.model.step import run_steps as jax_run_steps
from ocean_model_arch_tpu.ops.pallas import fused_step as jfsk

from ocean_model_arch_torch.core.grid import build_grid
from ocean_model_arch_torch.model.fused import (CARRIED, FusedSWModel,
                                                fused_available)
from ocean_model_arch_torch.model.init import init_ocean_state
from ocean_model_arch_torch.ops import _build
from ocean_model_arch_torch.ops import fused_layout as fl
from ocean_model_arch_torch.ops import fused_step as fstep
from ocean_model_arch_torch.ops.fused_step import fused_sw_step

from test_torch_step import GOLDEN, _bs_case, _case, check_golden, to_torch

torch.set_num_threads(1)

FIELDS = ("ssh", "sshp", "ubrtr", "ubrtrp", "vbrtr", "vbrtrp")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _jax_f32_case(with_islands, tracers=0):
    basin, cfg, mask = _case(Precision.f32(), with_islands, tracers=tracers)
    jgrid = jax_build_grid(basin, mask, precision=cfg.precision)
    return jgrid, cfg, jax_init(jgrid, cfg)


@pytest.mark.parametrize("with_islands", [False, True])
def test_fused_matches_jax_fused(with_islands):
    """30 f32 steps against JAX FusedSWModel (fast kernel, interpret mode,
    2 steps per call): < 1e-5 relative per field, the tolerance of
    tests/test_fused.py (the two differ in f32 operation order)."""
    jgrid, cfg, jstate = _jax_f32_case(with_islands)
    jf = JaxFused(jgrid, cfg, 1.0, tx=8, interpret=True, static_rslu=True,
                  steps_per_call=2)
    j6, jok = jax.jit(lambda s: jf.run_steps(s, 30))(jf.pack(jstate))
    want = jf.unpack(j6, jstate)
    grid, state = to_torch(jgrid, jstate, torch.float32)
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True, steps_per_call=2)
    s6, ok = fm.run_steps(fm.pack(state), 30)
    got = fm.unpack(s6, state)
    assert ok and bool(jok)
    for n in FIELDS + ("hhu", "hhv", "hhh", "hhq"):
        rel = _rel(getattr(got, n).numpy(), getattr(want, n))
        assert rel < 1e-5, (n, rel)


@pytest.mark.parametrize("with_islands", [False, True])
def test_fused_matches_jax_make_step_f32(with_islands):
    jgrid, cfg, jstate = _jax_f32_case(with_islands)
    want, jok = jax_run_steps(jax.jit(jax_make_step(jgrid, cfg)), jstate,
                              np.float32(1.0), 30)
    grid, state = to_torch(jgrid, jstate, torch.float32)
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True, steps_per_call=2)
    s6, ok = fm.run_steps(fm.pack(state), 30)
    got = fm.unpack(s6, state)
    assert ok and bool(jok)
    for n in FIELDS:
        rel = _rel(getattr(got, n).numpy(), getattr(want, n))
        assert rel < 1e-5, (n, rel)


def test_golden_bs100_f32_fused():
    """The fused path (f32) tracks the committed f64 golden digests within
    f32 accumulation error, as tests/test_golden.py holds the JAX kernel."""
    grid, cfg, state = _bs_case(Precision.f32())
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True, steps_per_call=2)
    s6 = fm.pack(state)
    done = 0
    for s in sorted(GOLDEN["steps"], key=int):
        s6, ok = fm.run_steps(s6, int(s) - done)
        done = int(s)
        assert ok
        check_golden(fm.unpack(s6, state), s, rtol=3e-4, pt_atol=5e-6)


def test_land_stays_exactly_zero():
    """Every land cell of all six carried fields, margins included, stays
    exactly 0 (ssh/sshp off the T-point wet set, u/up off the u-point set,
    v/vp off the v-point set)."""
    basin, cfg, mask = _case(Precision.f32(), with_islands=True)
    grid = build_grid(basin, mask, precision=cfg.precision, device="cpu")
    fm = FusedSWModel(grid, cfg, 1.0, steps_per_call=2, static_rslu=True)
    s6, ok = fm.run_steps(fm.pack(init_ocean_state(grid, cfg)), 30)
    assert ok
    wlcu, wlcv, wlu = fl.staggered_wet_masks(fl.embed(fm.lay, grid.lu))
    for f, w in zip(s6, (wlu, wlu, wlcu, wlcu, wlcv, wlcv)):
        land = torch.from_numpy(w) < 0.5
        assert bool((f[land] == 0).all())
        assert bool((f[~land] != 0).any())


def test_guard_catches_mid_window_transient():
    """An sshp spike drives |ssh| past 1e4 in the first steps, and the
    filter and gravity waves damp it below 1e4 by the end of the window:
    the per-step max accumulated on the device must still trip ``ok``."""
    basin, cfg, mask = _case(Precision.f32(), with_islands=False)
    grid = build_grid(basin, mask, precision=cfg.precision, device="cpu")
    state = init_ocean_state(grid, cfg)
    sshp = state.sshp.clone()
    sshp[30, 30] = 1.2e4
    bad = dataclasses.replace(state, sshp=sshp)
    fm = FusedSWModel(grid, cfg, 1.0, steps_per_call=2, static_rslu=True)
    s6, ok = fm.run_steps(fm.pack(bad), 30)
    final = float(fm.unpack(s6, state).ssh.abs().max())
    assert final < 1.0e4, "not a transient: final state still blown up"
    assert not ok, "per-step guard missed the mid-window transient"
    _, ok_nan = fm.run_steps(
        fm.pack(dataclasses.replace(state, ssh=torch.where(
            grid.lu > 0.5, torch.nan, state.ssh))), 2)
    assert not ok_nan


def _unsupported_cases():
    def periodic(basin, cfg, mask):
        return dict(grid_kw=dict(periodic_x=True))

    def bipolar_slow_form(basin, cfg, mask):
        return dict(basin=dataclasses.replace(basin, curve_grid=2),
                    model_kw=dict(static_rslu=False, fast2d=True))

    return {f.__name__: f for f in (periodic, bipolar_slow_form)}


UNSUPPORTED = _unsupported_cases()
MESSAGES = {"periodic": "periodic",
            "bipolar_slow_form": "fast2d requires static_rslu=True"}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_config_raises(name):
    """Outside the kernel's envelope FusedSWModel raises ValueError naming
    what is unsupported; it never takes another path silently."""
    basin, cfg, mask = _case(Precision.f32(), with_islands=False,
                             nx=24, ny=20)
    kw = UNSUPPORTED[name](basin, cfg, mask)
    basin = kw.get("basin", basin)
    cfg = dataclasses.replace(kw.get("cfg", cfg), basin=basin)
    grid = build_grid(basin, mask, precision=cfg.precision, device="cpu")
    grid = dataclasses.replace(grid, **kw.get("grid_kw", {}))
    with pytest.raises(ValueError, match=MESSAGES[name]):
        FusedSWModel(grid, cfg, 1.0, **kw.get("model_kw", {}))
    if "model_kw" not in kw:
        assert not fused_available(grid, cfg)


def test_cpu_tensors_do_not_launch():
    """On CPU tensors the wrapper takes the plain version: the launch
    count stays 0 and nothing is built."""
    basin, cfg, mask = _case(Precision.f32(), with_islands=False,
                             nx=24, ny=20)
    grid = build_grid(basin, mask, precision=cfg.precision, device="cpu")
    fm = FusedSWModel(grid, cfg, 1.0, steps_per_call=2, static_rslu=True)
    before = fused_sw_step.launches
    _, ok = fm.run_steps(fm.pack(init_ocean_state(grid, cfg)), 4)
    assert ok and fused_sw_step.launches == before == 0
    assert not any(t.startswith("fused_step") for t in _build.BUILDS)


def test_non_cpu_tensors_never_take_the_plain_version():
    """Tensors off the CPU go to the kernel or raise: here (meta tensors)
    the input check raises before any build or launch."""
    lay = fl.make_layout(24, 20)
    f = torch.empty((lay.Xs, lay.Ys), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_sw_step((f,) * 6, torch.empty((fl.N_PROF, lay.Ys),
                                            device="meta"),
                      torch.empty((4, lay.Xs, lay.Ys), device="meta"),
                      lay, 1.0, 0.5, 100.0)
    assert fused_sw_step.launches == 0


def test_build_raises_without_nvcc(monkeypatch):
    """A missing toolchain is an error, not a fallback."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    for target in fstep.library_targets() + ("fused_step",):
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build(target)


def test_pack_refuses_nonzero_mu():
    """A state whose mu is not the model's ``mu_const`` would be silently
    stepped with another viscosity: refused, whichever of the two is 0."""
    basin, cfg, mask = _case(Precision.f32(), with_islands=False,
                             nx=24, ny=20)
    grid = build_grid(basin, mask, precision=cfg.precision, device="cpu")
    state = init_ocean_state(grid, cfg)
    viscous = dataclasses.replace(state, mu=torch.full_like(state.mu, 1e3))
    with pytest.raises(ValueError, match="mu"):
        FusedSWModel(grid, cfg, 1.0, static_rslu=True).pack(viscous)
    with pytest.raises(ValueError, match="mu"):
        FusedSWModel(grid, cfg, 1.0, mu_const=1e3,
                     static_rslu=True).pack(state)
    assert len(FusedSWModel(grid, cfg, 1.0, mu_const=1e3,
                            static_rslu=True).pack(viscous)) == 6


def test_pack_unpack_round_trip():
    basin, cfg, mask = _case(Precision.f32(), with_islands=True)
    grid = build_grid(basin, mask, precision=cfg.precision, device="cpu")
    state = init_ocean_state(grid, cfg)
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True)
    s6 = fm.pack(state)
    lay = fm.lay
    assert lay.Ys % fl.ROW_ALIGN == 0 and lay.margin == fl.margin_for(1) == 4
    assert fl.margin_for(2) == 2 * fl.STEP_REACH
    assert fl.margin_for(1, n_tracers=2) == fl.TRACER_REACH == lay.margin
    assert fl.margin_for(2, n_tracers=1) == 2 * fl.TRACER_REACH
    for a in s6:
        assert a.shape == (lay.Xs, lay.Ys) and a.dtype == torch.float32
        inner = fl.extract(lay, a)
        assert float(a.abs().sum()) == float(inner.abs().sum())
    back = fm.unpack(s6, state)
    for n in CARRIED + ("hhu", "hhv", "hhh", "hhq", "hhu_p"):
        assert torch.equal(getattr(back, n), getattr(state, n)), n


def test_layout_helpers_match_jax():
    """The re-homed host helpers against their originals in the JAX
    kernel module: the metric profile on the physical columns, the
    static planes and wet masks on one mask, and the plane sets."""
    jgrid, cfg, _ = _jax_f32_case(with_islands=True)
    grid, _ = to_torch(jgrid, jax_init(jgrid, cfg), torch.float32)
    lay = fl.make_layout(grid.nx, grid.ny)
    jlay = jfsk.make_layout(grid.nx, grid.ny, 8)
    mine = fl.metrics_profile_from_grid(grid, lay)
    theirs = jfsk.metrics_profile_from_grid(jgrid, jlay)
    np.testing.assert_array_equal(
        mine[:, lay.margin:lay.margin + grid.ny],
        theirs[:, jlay.ypad:jlay.ypad + grid.ny])
    lu_s = fl.embed(lay, grid.lu).numpy()
    hr_s = fl.embed(lay, grid.hhq_rest).numpy()
    names = ("rslu_u", "rslu_v", "rslu_h", "wlu", "ludxdy", "hrludxdy")
    recips = (mine[10:11], mine[11:12], (mine[14] * mine[15])[None])
    np.testing.assert_array_equal(
        fl.static_planes(lu_s, hr_s, (mine[0] * mine[1])[None], names,
                         recips),
        jfsk.static_planes(lu_s, hr_s, (mine[0] * mine[1])[None], names,
                           recips))
    for a, b in zip(fl.staggered_wet_masks(lu_s),
                    jfsk.staggered_wet_masks(lu_s)):
        np.testing.assert_array_equal(a, b)
    for ffs, ksw, mu, hrc in ((1, 1, 0.0, 100.0), (1, 1, 5.0, None),
                              (0, 0, 0.0, 100.0)):
        assert fl.plane_names(ffs, ksw, mu, hrc) == jfsk.plane_names(
            ffs, ksw, mu, False, hr_const=hrc)


# ---- tracers and the tile guard ------------------------------------------

TRACER_FIELDS = FIELDS + ("ff", "ffp", "ffn")


@pytest.mark.parametrize("with_islands", [False, True])
def test_fused_tracers_match_jax_fused(with_islands):
    """30 f32 steps with 2 tracers against the JAX fused kernel in
    interpret mode (fast branch without the q4 / elide_sel folds, whose
    formula order the port follows): < 1e-5 relative per field."""
    jgrid, cfg, jstate = _jax_f32_case(with_islands, tracers=2)
    jf = JaxFused(jgrid, cfg, 1.0, tx=8, interpret=True, static_rslu=True,
                  elide_sel=False, q4=False)
    assert jf.n_tracers == 2
    j10, jok = jax.jit(lambda s: jf.run_steps(s, 30))(jf.pack(jstate))
    want = jf.unpack(j10, jstate)
    grid, state = to_torch(jgrid, jstate, torch.float32)
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True, steps_per_call=2)
    assert fm.n_tracers == 2
    s10, ok = fm.run_steps(fm.pack(state), 30)
    assert len(s10) == len(j10) == 10
    got = fm.unpack(s10, state)
    assert ok and bool(jok)
    for n in TRACER_FIELDS:
        rel = _rel(getattr(got, n).numpy(), getattr(want, n))
        assert rel < 1e-5, (n, rel)
    assert float(got.ff.abs().max()) > 0


@pytest.mark.parametrize("with_islands", [False, True])
def test_fused_tracers_match_jax_make_step_f32(with_islands):
    """... and against the JAX composition (sw_step + tracer_step) at the
    tolerance of tests/test_fused.py::test_fused_tracers_match_jnp (the
    fused flux reassociates)."""
    jgrid, cfg, jstate = _jax_f32_case(with_islands, tracers=2)
    want, jok = jax_run_steps(jax.jit(jax_make_step(jgrid, cfg)), jstate,
                              np.float32(1.0), 30)
    grid, state = to_torch(jgrid, jstate, torch.float32)
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True, steps_per_call=2)
    s10, ok = fm.run_steps(fm.pack(state), 30)
    got = fm.unpack(s10, state)
    assert ok and bool(jok)
    for n in FIELDS + ("ff", "ffp"):
        rel = _rel(getattr(got, n).numpy(), getattr(want, n))
        assert rel < 1e-5, (n, rel)


def _strip_case(tracers, nx=70, ny=52):
    """tests/test_fused.py's guard mask: an all-land x-strip (rows 40-63)
    leaves whole tiles without a wet cell."""
    basin, cfg, mask = _case(Precision.f32(), with_islands=True, nx=nx,
                             ny=ny, tracers=tracers)
    mask[40:64, :] = 1
    grid = build_grid(basin, mask, precision=cfg.precision, device="cpu")
    return grid, cfg, init_ocean_state(grid, cfg)


@pytest.mark.parametrize("tracers", [0, 2])
def test_guard_on_and_off_are_bit_identical(tracers):
    grid, cfg, state = _strip_case(tracers)
    on = FusedSWModel(grid, cfg, 1.0, steps_per_call=2, tile_guard=True,
                      static_rslu=True)
    off = FusedSWModel(grid, cfg, 1.0, steps_per_call=2, tile_guard=False,
                       static_rslu=True)
    assert on.tile_wet is not None and off.tile_wet is None
    assert on.n_tiles == off.n_tiles and on.n_tiles[1] > 0
    a, ok1 = on.run_steps(on.pack(state), 30)
    b, ok2 = off.run_steps(off.pack(state), 30)
    assert ok1 and ok2 and len(a) == len(b) == 6 + 2 * tracers
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), i
    assert float(a[0].abs().max()) > 0


def test_tile_guard_auto_rule():
    """None -> on exactly when some tile of the kernel's grid holds no wet
    cell (the JAX ``FusedSWModel``'s rule, model/fused.py:197-204); an
    explicit value wins."""
    grid, cfg, _ = _strip_case(0)
    assert FusedSWModel(grid, cfg, 1.0, static_rslu=True).tile_guard is True
    assert FusedSWModel(grid, cfg, 1.0, tile_guard=False,
                        static_rslu=True).tile_guard is False
    # 56 + 8 = 64 columns and 72 + 8 = 80 rows: every 16 x 32 tile is wet
    basin, cfg2, mask = _case(Precision.f32(), with_islands=False, nx=72,
                              ny=56)
    wet_grid = build_grid(basin, mask, precision=cfg2.precision,
                          device="cpu")
    fm = FusedSWModel(wet_grid, cfg2, 1.0, static_rslu=True)
    assert fm.n_tiles == (10, 0) and fm.tile_guard is False
    assert fm.tile_wet is None
    forced = FusedSWModel(wet_grid, cfg2, 1.0, tile_guard=True,
                          static_rslu=True)
    assert forced.tile_guard and int(forced.tile_wet.sum()) == 10


def _jax_flags(jgrid, cfg, tx, ty):
    """(the per-tile wet flags a JAX ``FusedSWModel`` with tx x ty tiles
    holds, its embedded mask cut to its tile grid)."""
    jf = JaxFused(jgrid, cfg, 1.0, tx=tx, ty=ty, my=128, interpret=True,
                  static_rslu=True)
    m = jf.lay.margin
    n_tx = jf.lay.X // tx
    n_ty = (jf.lay.Ys - 2 * 128) // ty
    region = np.asarray(jf._lu_s)[m:m + n_tx * tx, 128:128 + n_ty * ty]
    return jf._tile_wet2d, region


@pytest.mark.parametrize("tile", [(8, 128), (16, 128), (24, 256)])
def test_tile_wet_matches_jax_flags(tile):
    """``fused_layout.tile_wet`` against the flags the JAX model builds
    (model/fused.py:190-193, the construction of ops/pallas/
    fused_step.py:1691-1705) for the same tile shape, on a mask of sparse
    water made from a seed."""
    tx, ty = tile
    basin, cfg, mask = _case(Precision.f32(), with_islands=False, nx=70,
                             ny=300)
    rng = np.random.RandomState(7)
    mask[:] = 1
    mask[30:55, 20:150] = rng.rand(25, 130) >= 0.02     # sparse water
    mask[8:12, 270:297] = 0
    jgrid = jax_build_grid(basin, mask, precision=cfg.precision)
    want, region = _jax_flags(jgrid, cfg, tx, ty)
    lay = fl.FusedLayout(0, 0, region.shape[0], region.shape[1], 0)
    got = fl.tile_wet(region, lay, tx, ty)
    assert got.shape == (region.shape[0] // tx, region.shape[1] // ty)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.reshape(-1), want)
    assert 0 < got.sum() < got.size


def test_tile_wet_matches_jax_model_flags():
    """The same on the guard tests' mask (an all-land x-strip), with
    islands."""
    jgrid, cfg, _ = _jax_f32_case(with_islands=True)
    lu = np.asarray(jgrid.lu).copy()
    lu[40:64, :] = 0.0
    jgrid = dataclasses.replace(jgrid, lu=jax.numpy.asarray(lu))
    want, region = _jax_flags(jgrid, cfg, 8, 128)
    lay = fl.FusedLayout(0, 0, region.shape[0], region.shape[1], 0)
    got = fl.tile_wet(region, lay, 8, 128)
    np.testing.assert_array_equal(got.reshape(-1), want)
    assert 0 < got.sum() < got.size


def test_reference_guard_zeroes_all_land_tiles():
    """The plain version reproduces the guard's zero writes: a NaN on a
    land cell of an all-land tile is seen without the guard and is not
    with it; the max of such a tile is 0."""
    grid, cfg, state = _strip_case(2)
    fm = FusedSWModel(grid, cfg, 1.0, tile_guard=True, static_rslu=True)
    s0 = fm.pack(state)
    tx, ty = fm.tile
    i, j = (int(v) for v in (fm.tile_wet == 0).nonzero()[0])
    cell = (i * tx + 3, j * ty + 5)
    m = fm.lay.margin
    assert m <= cell[0] < m + grid.nx and m <= cell[1] < m + grid.ny
    bad = tuple(f.clone() for f in s0)
    bad[0][cell] = float("nan")
    args = (fm.met, fm.planes, fm.lay, fm.tau, cfg.sw.time_smooth,
            fm.hr_const)
    out_g, mx_g = fstep.fused_sw_step_reference(bad, *args, fm.tile_wet,
                                                fm.tile)
    out_u, mx_u = fstep.fused_sw_step_reference(bad, *args)
    assert float(out_g[0][cell]) == 0.0 and bool(torch.isfinite(mx_g))
    assert bool(torch.isnan(out_u[0][cell])) and bool(torch.isnan(mx_u))
    with pytest.raises(ValueError, match="tile_wet"):
        fstep.fused_sw_step_reference(s0, *args, fm.tile_wet, (8, 8))


def test_land_stays_exactly_zero_with_tracers():
    """Every land cell of all 6 + 2 T carried fields stays exactly 0,
    from ``pack`` on (the guard's zero writes rely on it)."""
    grid, cfg, state = _strip_case(2)
    fm = FusedSWModel(grid, cfg, 1.0, steps_per_call=2, static_rslu=True)
    s0 = fm.pack(state)
    s10, ok = fm.run_steps(s0, 30)
    assert ok and len(s10) == 10
    wlcu, wlcv, wlu = fl.staggered_wet_masks(fl.embed(fm.lay, grid.lu))
    for fields in (s0, s10):
        for f, w in zip(fields, (wlu, wlu, wlcu, wlcu, wlcv, wlcv)
                        + (wlu,) * 4):
            land = torch.from_numpy(w) < 0.5
            assert bool((f[land] == 0).all())
    for f in s10[6:]:
        assert bool((f != 0).any())


def test_pack_unpack_round_trip_with_tracers():
    basin, cfg, mask = _case(Precision.f32(), with_islands=True, tracers=2)
    grid = build_grid(basin, mask, precision=cfg.precision, device="cpu")
    state = init_ocean_state(grid, cfg)
    # distinct levels, so that the order ff_0, ffp_0, ff_1, ffp_1 shows
    state = dataclasses.replace(
        state, ff=state.ff * torch.tensor([1.0, 2.0])[:, None, None],
        ffp=state.ffp * torch.tensor([3.0, 4.0])[:, None, None])
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True)
    s10 = fm.pack(state)
    assert len(s10) == 10
    for k, (name, t) in enumerate((("ff", 0), ("ffp", 0), ("ff", 1),
                                   ("ffp", 1))):
        a = s10[6 + k]
        assert a.shape == (fm.lay.Xs, fm.lay.Ys) and a.dtype == torch.float32
        assert torch.equal(fl.extract(fm.lay, a), getattr(state, name)[t])
    back = fm.unpack(s10, state)
    for n in CARRIED + ("ff", "ffp", "hhu", "hhq"):
        assert torch.equal(getattr(back, n), getattr(state, n)), n
    assert torch.equal(back.ffn, state.ff)         # ffn = ff after a step
    assert fstep.n_tracers_of(s10) == 2
    with pytest.raises(ValueError, match="fields"):
        fstep.n_tracers_of(s10[:7])


def test_cpu_tensors_do_not_launch_with_tracers_and_guard():
    """No launch is counted, for any kernel form, and nothing is built."""
    grid, cfg, state = _strip_case(2)
    fm = FusedSWModel(grid, cfg, 1.0, steps_per_call=2, static_rslu=True)
    assert fm.tile == fstep.CPU_TILE and fm.tile_guard
    _, ok = fm.run_steps(fm.pack(state), 4)
    assert ok and fused_sw_step.launches == 0
    assert not fused_sw_step.form_launches
    assert not any(t.startswith("fused_step") for t in _build.BUILDS)


def test_non_cpu_tensors_with_tracers_never_take_the_plain_version():
    """Meta tensors with tracers and flags: the input check raises before
    any build or launch, at 3 tracers too (for the device, not for the
    count: every count has a kernel)."""
    lay = fl.make_layout(24, 20)
    f = torch.empty((lay.Xs, lay.Ys), device="meta")
    met = torch.empty((fl.N_PROF, lay.Ys), device="meta")
    planes = torch.empty((4, lay.Xs, lay.Ys), device="meta")
    flags = torch.empty((2, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_sw_step((f,) * 10, met, planes, lay, 1.0, 0.5, 100.0, flags,
                      (16, 32))
    with pytest.raises(ValueError, match="CUDA"):
        fused_sw_step((f,) * 12, met, planes, lay, 1.0, 0.5, 100.0)
    assert fused_sw_step.launches == 0
