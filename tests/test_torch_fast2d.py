"""The port on grids whose metrics vary along x (bipolar, curve_grid=2):
the 2D-metrics host helpers, the eager composition and the fused path
with pointwise metric planes (the JAX kernel's fast2d form), on the CPU,
where ``fused_sw_step`` runs its plain PyTorch version. Held against the
JAX helpers, the JAX ``make_step`` and the JAX ``FusedSWModel`` in
interpret mode (which picks fast2d by itself on such a grid). The CUDA
kernel's plane-metric instantiations are compared with the plain version
on the card by chip_smoke.py."""

import functools

import jax
import numpy as np
import pytest
import torch

from ocean_model_arch_tpu.config import (ModelConfig, Precision, SWConfig,
                                         basinpar_flat)
from ocean_model_arch_tpu.core.grid import build_grid as jax_build_grid
from ocean_model_arch_tpu.core.masks import frame_of_land_mask
from ocean_model_arch_tpu.model.fused import FusedSWModel as JaxFused
from ocean_model_arch_tpu.model.init import init_ocean_state as jax_init
from ocean_model_arch_tpu.model.step import make_step as jax_make_step
from ocean_model_arch_tpu.model.step import run_steps as jax_run_steps
from ocean_model_arch_tpu.ops.pallas import fused_step as jfsk

from ocean_model_arch_torch.model.fused import FusedSWModel, fused_available
from ocean_model_arch_torch.model.step import make_step, run_steps
from ocean_model_arch_torch.ops import _build
from ocean_model_arch_torch.ops import fused_layout as fl
from ocean_model_arch_torch.ops import fused_step as fstep
from ocean_model_arch_torch.ops.fused_step import fused_sw_step

from test_torch_step import TIGHT, TRACER_STATE, to_torch

torch.set_num_threads(1)

NX, NY = 70, 52
FIELDS = ("ssh", "sshp", "ubrtr", "ubrtrp", "vbrtr", "vbrtrp")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@functools.lru_cache(maxsize=None)
def _bipolar(precision_name, mask_kind, tracers=0, curve_grid=2):
    """tests/test_fused.py::test_fused_fast2d_matches_jnp's basin (the
    bipolar flat basin at 70 x 52) as (JAX grid, cfg, JAX state). Masks:
    ``frame``; ``islands`` (random islands from a seed); ``strip``
    (islands and an all-land x-strip, so whole tiles hold no wet cell)."""
    prec = getattr(Precision, precision_name)()
    basin = basinpar_flat(NX, NY, curve_grid=curve_grid, rlon=27.5,
                          rlat=41.0)
    cfg = ModelConfig(basin=basin,
                      sw=SWConfig(use_tracers=int(tracers > 0),
                                  tracer_num=max(tracers, 1)),
                      precision=prec)
    mask = frame_of_land_mask(NX, NY)
    if mask_kind != "frame":
        rng = np.random.RandomState(3)
        mask[2:-2, 2:-2] |= (rng.rand(NX - 4, NY - 4) < 0.15).astype(
            np.int32)
    if mask_kind == "strip":
        mask[40:64, :] = 1
    jgrid = jax_build_grid(basin, mask, precision=prec)
    return jgrid, cfg, jax_init(jgrid, cfg)


def _port_case(mask_kind, tracers=0, curve_grid=2):
    jgrid, cfg, jstate = _bipolar("f32", mask_kind, tracers, curve_grid)
    grid, state = to_torch(jgrid, jstate, torch.float32)
    return grid, cfg, state


# ---- host helpers -----------------------------------------------------------

def test_bipolar_metrics_vary_along_x():
    """The case is what it claims: metrics_profile_from_grid refuses it."""
    grid, _, _ = _port_case("frame")
    lay = fl.make_layout(grid.nx, grid.ny)
    with pytest.raises(ValueError, match="x-uniform"):
        fl.metrics_profile_from_grid(grid, lay)


def test_metrics_full_from_grid_matches_jax():
    """All 22 planes bit for bit on the physical interior (the two
    layouts differ in their margins), finite everywhere, the 9 grid
    metrics edge-replicated through the whole margin and overhang."""
    jgrid, _, _ = _bipolar("f32", "frame")
    grid, _, _ = _port_case("frame")
    lay = fl.make_layout(grid.nx, grid.ny)
    jlay = jfsk.make_layout(grid.nx, grid.ny, 8)
    mine = fl.metrics_full_from_grid(grid, lay)
    theirs = jfsk.metrics_full_from_grid(jgrid, jlay, derived=True)
    assert mine.shape == (fl.N_FULL, lay.Xs, lay.Ys) == (22, 78, 64)
    assert mine.dtype == np.float32
    m, jm, yp = lay.margin, jlay.margin, jlay.ypad
    np.testing.assert_array_equal(
        mine[:, m:m + NX, m:m + NY], theirs[:, jm:jm + NX, yp:yp + NY])
    assert np.isfinite(mine).all() and (mine[:8] > 0).all()
    dx = mine[0]
    np.testing.assert_array_equal(dx[0], dx[m])
    np.testing.assert_array_equal(dx[-1], dx[m + NX - 1])
    np.testing.assert_array_equal(dx[:, 0], dx[:, m])
    np.testing.assert_array_equal(dx[:, -1], dx[:, m + NY - 1])
    # row 17 holds dxt at n + 1, taken after the y-replication
    dxt_n1 = np.concatenate([mine[2][:, 1:], mine[2][:, -1:]], axis=1)
    np.testing.assert_array_equal(
        mine[17], (dxt_n1 - mine[6]) * np.float32(0.25))


def test_metrics_full_of_x_uniform_grid_is_the_broadcast_profile():
    """On an x-uniform grid the planes are the profile rows repeated
    along x, bit for bit: the two functions share their arithmetic."""
    grid, _, _ = _port_case("frame", curve_grid=1)
    lay = fl.make_layout(grid.nx, grid.ny)
    prof = fl.metrics_profile_from_grid(grid, lay)
    full = fl.metrics_full_from_grid(grid, lay)
    np.testing.assert_array_equal(
        full, np.broadcast_to(prof[:fl.N_FULL, None, :], full.shape))


@pytest.mark.parametrize("tracers", [0, 2])
def test_fast2d_met_rows_match_jax_without_the_thresholds(tracers):
    """The JAX kernel's rows for the same configuration, less rows 14
    and 15 (its rslu mask thresholds; the port's masks come from
    ``ludxdy > 0.5``); the model's slot map follows their order."""
    want = set(jfsk.fast2d_met_rows(1, False, tracers)) - {14, 15}
    got = fl.fast2d_met_rows(tracers)
    assert set(got) == want and list(got) == sorted(got)
    assert set(got) <= set(fstep.KERNEL_MET_ROWS)
    grid, cfg, _ = _port_case("frame", tracers)
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True)
    assert fm.met_map == {r: i for i, r in enumerate(got)}
    assert tuple(fm.met.shape) == (len(got), fm.lay.Xs, fm.lay.Ys)


@pytest.mark.parametrize("mask_kind", ["frame", "islands"])
def test_static_planes_2d_match_jax(mask_kind):
    """The static planes from full metric planes: equal to the JAX
    function on the same numpy inputs everywhere, and on the physical
    interior to what the JAX function gives in its own layout."""
    jgrid, _, _ = _bipolar("f32", mask_kind)
    grid, cfg, _ = _port_case(mask_kind)
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True, q4=False)
    lay = fm.lay
    names = fstep.kernel_planes()
    m22 = fl.metrics_full_from_grid(grid, lay)
    lu_s = fl.embed(lay, grid.lu).numpy()
    args = (m22[0] * m22[1], names,
            (m22[10], m22[11], m22[14] * m22[15]))
    mine = fl.static_planes(lu_s, None, *args)
    np.testing.assert_array_equal(mine, fm.planes.numpy())
    np.testing.assert_array_equal(mine,
                                  jfsk.static_planes(lu_s, None, *args))
    jlay = jfsk.make_layout(NX, NY, 8)
    j22 = jfsk.metrics_full_from_grid(jgrid, jlay, derived=True)
    jm, yp, m = jlay.margin, jlay.ypad, lay.margin
    jlu = np.zeros((jlay.Xs, jlay.Ys), np.float32)
    jlu[jm:jm + NX, yp:yp + NY] = np.asarray(jgrid.lu)
    theirs = jfsk.static_planes(jlu, None, j22[0] * j22[1], names,
                                (j22[10], j22[11], j22[14] * j22[15]))
    np.testing.assert_array_equal(mine[:, m:m + NX, m:m + NY],
                                  theirs[:, jm:jm + NX, yp:yp + NY])


def test_model_reports_its_metric_form():
    grid, cfg, _ = _port_case("frame")
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True)
    assert fm.metrics_2d and fm.fast2d and fm.met_map is not None
    assert fused_available(grid, cfg)
    assert not hasattr(fm, "met22") and not hasattr(fm, "_met22")
    ugrid, ucfg, _ = _port_case("frame", curve_grid=1)
    um = FusedSWModel(ugrid, ucfg, 1.0, static_rslu=True)
    assert not um.metrics_2d and not um.fast2d and um.met_map is None
    assert tuple(um.met.shape) == (fl.N_PROF, um.lay.Ys)


# ---- the eager composition --------------------------------------------------

@pytest.mark.parametrize("mask_kind,tracers", [("frame", 0),
                                               ("islands", 2)])
def test_make_step_bipolar_matches_jax_f64(mask_kind, tracers):
    """30 f64 steps of the port's eager composition on the bipolar grid
    against the JAX ``make_step``: 1e-12 (1e-6 for str_t / str_s, whose
    f32 metric ratios XLA rounds differently, as test_torch_step.py)."""
    jgrid, cfg, jstate = _bipolar("f64", mask_kind, tracers)
    grid, state = to_torch(jgrid, jstate, torch.float64)
    want, jok = jax_run_steps(jax.jit(jax_make_step(jgrid, cfg)), jstate,
                              1.0, 30)
    got, ok = run_steps(make_step(grid, cfg), state, 1.0, 30)
    assert ok and bool(jok)
    names = TIGHT + ("str_t", "str_s") + (TRACER_STATE if tracers else ())
    for n in names:
        a = np.asarray(getattr(want, n))
        b = getattr(got, n).numpy()
        rel = np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)
        assert rel < (1e-6 if n in ("str_t", "str_s") else 1e-12), (n, rel)
    assert float(got.ubrtr.abs().max()) > 0


# ---- the fused path ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_fast2d_run(tracers):
    """30 f32 steps of the JAX fused model on the ``strip`` mask."""
    jgrid, cfg, jstate = _bipolar("f32", "strip", tracers)
    jf = JaxFused(jgrid, cfg, 1.0, tx=8, interpret=True, static_rslu=True,
                  steps_per_call=2)
    assert jf.fast2d and jf.metrics_2d
    j6, jok = jax.jit(lambda s: jf.run_steps(s, 30))(jf.pack(jstate))
    assert bool(jok)
    return jf.unpack(j6, jstate)


def _names(tracers):
    return FIELDS + (("ff", "ffp") if tracers else ())


@pytest.mark.parametrize("guard", [False, True])
@pytest.mark.parametrize("tracers", [0, 2])
def test_fused_bipolar_matches_jax_fast2d(tracers, guard):
    """30 f32 steps on the bipolar grid, guard off and on, against the
    JAX fast2d kernel in interpret mode at rel < 2e-5, the tolerance of
    tests/test_fused.py::test_fused_fast2d_matches_jnp (the two differ in
    f32 operation order: q4 / elide_sel folds, chained steps)."""
    want = _jax_fast2d_run(tracers)
    grid, cfg, state = _port_case("strip", tracers)
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True, steps_per_call=2,
                      tile_guard=guard)
    assert fm.fast2d and fm.n_tiles[1] > 0
    assert (fm.tile_wet is not None) == guard
    s, ok = fm.run_steps(fm.pack(state), 30)
    got = fm.unpack(s, state)
    assert ok and len(s) == 6 + 2 * tracers
    for n in _names(tracers):
        rel = _rel(getattr(got, n).numpy(), getattr(want, n))
        assert rel < 2e-5, (n, rel)
    assert float(got.ubrtr.abs().max()) > 0


@pytest.mark.parametrize("tracers", [0, 2])
def test_fused_bipolar_matches_port_eager(tracers):
    """... and against the port's own eager composition in f32, at the
    same tolerance."""
    grid, cfg, state = _port_case("strip", tracers)
    want, eok = run_steps(make_step(grid, cfg), state, 1.0, 30)
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True, steps_per_call=2)
    s, ok = fm.run_steps(fm.pack(state), 30)
    got = fm.unpack(s, state)
    assert ok and eok
    for n in _names(tracers):
        rel = _rel(getattr(got, n).numpy(), getattr(want, n).numpy())
        assert rel < 2e-5, (n, rel)


@pytest.mark.parametrize("tracers", [0, 2])
def test_broadcast_profile_planes_equal_the_profile_form(tracers):
    """Fed an x-uniform grid's profile rows repeated along x as planes,
    the plane-metric form gives the profile form's outputs bit for bit,
    over 10 carried steps: same f32 operations in the same order."""
    grid, cfg, state = _port_case("strip", tracers, curve_grid=1)
    fm = FusedSWModel(grid, cfg, 1.0, tile_guard=True, static_rslu=True)
    assert not fm.metrics_2d
    rows = fl.fast2d_met_rows(tracers)
    planes = fm.met[list(rows)][:, None, :].expand(
        len(rows), fm.lay.Xs, fm.lay.Ys).contiguous()
    met_map = {r: i for i, r in enumerate(rows)}
    args = (fm.planes, fm.lay, fm.tau, cfg.sw.time_smooth, fm.hr_const,
            fm.tile_wet, fm.tile)
    a = b = fm.pack(state)
    for _ in range(10):
        a, ma = fused_sw_step(a, fm.met, *args)
        b, mb = fused_sw_step(b, planes, *args, met_map=met_map)
        assert torch.equal(ma, mb)
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), i
    assert float(a[2].abs().max()) > 0


@pytest.mark.parametrize("tracers", [0, 2])
def test_guard_on_and_off_are_bit_identical_on_2d_metrics(tracers):
    """... and every land cell of all 6 + 2 T fields stays exactly 0."""
    grid, cfg, state = _port_case("strip", tracers)
    on = FusedSWModel(grid, cfg, 1.0, steps_per_call=2, tile_guard=True,
                      static_rslu=True)
    off = FusedSWModel(grid, cfg, 1.0, steps_per_call=2, tile_guard=False,
                       static_rslu=True)
    a, ok1 = on.run_steps(on.pack(state), 30)
    b, ok2 = off.run_steps(off.pack(state), 30)
    assert ok1 and ok2 and len(a) == len(b) == 6 + 2 * tracers
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), i
    wlcu, wlcv, wlu = fl.staggered_wet_masks(fl.embed(on.lay, grid.lu))
    for f, w in zip(a, (wlu, wlu, wlcu, wlcu, wlcv, wlcv)
                    + (wlu,) * (2 * tracers)):
        land = torch.from_numpy(w) < 0.5
        assert bool((f[land] == 0).all())
        assert bool((f[~land] != 0).any())


def test_cpu_tensors_do_not_launch_on_2d_metrics():
    grid, cfg, state = _port_case("strip", 2)
    fm = FusedSWModel(grid, cfg, 1.0, steps_per_call=2, static_rslu=True)
    _, ok = fm.run_steps(fm.pack(state), 4)
    assert ok and fused_sw_step.launches == 0
    assert not fused_sw_step.form_launches
    assert not any(t.startswith("fused_step") for t in _build.BUILDS)


def test_plane_metrics_input_checks():
    """Meta tensors with metric planes: the input check raises before any
    build or launch; a slot map that lacks a row the step reads, or
    points past the planes, raises too."""
    lay = fl.make_layout(24, 20)
    f = torch.empty((lay.Xs, lay.Ys), device="meta")
    planes = torch.empty((4, lay.Xs, lay.Ys), device="meta")
    rows = fl.fast2d_met_rows(0)
    met = torch.empty((len(rows), lay.Xs, lay.Ys), device="meta")
    met_map = {r: i for i, r in enumerate(rows)}
    with pytest.raises(ValueError, match="CUDA"):
        fused_sw_step((f,) * 6, met, planes, lay, 1.0, 0.5, 100.0,
                      met_map=met_map)
    with pytest.raises(ValueError, match=r"met_map.*\[0, 1\]"):
        fused_sw_step((f,) * 10, met, planes, lay, 1.0, 0.5, 100.0,
                      met_map=met_map)
    with pytest.raises(ValueError, match=r"met_map.*\[21\]"):
        fused_sw_step((f,) * 6, met, planes, lay, 1.0, 0.5, 100.0,
                      met_map={**met_map, 21: len(rows)})
    assert fused_sw_step.launches == 0
    assert not any(t.startswith("fused_step") for t in _build.BUILDS)
