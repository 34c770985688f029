"""The port's viscous and varying-bathymetry forms on the CPU: lateral
viscosity (constant mu), the tracers' diffusive fluxes and the
``hrludxdy`` / ``hr`` planes, in the eager composition (model/step.py,
f64) and in the fused step's plain version (ops/fused_step.py, f32),
held against the JAX ``make_step`` and the JAX fused kernel in interpret
mode on the same numpy inputs. The CUDA kernel itself is compared with
the plain version on the card by chip_smoke.py."""

import dataclasses
import functools
import hashlib
import itertools

import jax
import jax.numpy as jnp
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

from ocean_model_arch_torch.core.grid import GRID_FIELDS
from ocean_model_arch_torch.core.state import STATE_FIELDS
from ocean_model_arch_torch.model.fused import (FusedSWModel,
                                                flat_bathymetry, unsupported)
from ocean_model_arch_torch.model.step import make_step, run_steps
from ocean_model_arch_torch.ops import fused_layout as fl
from ocean_model_arch_torch.ops import fused_step as fstep

from test_torch_step import TIGHT, TRACER_STATE, to_torch

torch.set_num_threads(1)

NX, NY, STEPS = 70, 52, 30
MU = 1000.0
SW = ("ssh", "sshp", "ubrtr", "vbrtr", "ubrtrp", "vbrtrp")


def bathymetry(nx=NX, ny=NY):
    """15-100 m, deepest mid-basin, float32, made with numpy."""
    i = np.arange(nx, dtype=np.float64)[:, None]
    j = np.arange(ny, dtype=np.float64)[None, :]
    return (15.0 + 85.0 * np.sin(np.pi * i / (nx - 1))
            * np.sin(np.pi * j / (ny - 1))).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@functools.lru_cache(maxsize=None)
def jax_case(precision, curve_grid, tracers, mu, vary, ksw=1, islands=True,
             seed_hr=None, land_rows=0):
    """(jgrid, cfg, jstate): the 70 x 52 test basin of tests/test_fused.py
    with ``state.mu`` filled with ``mu`` (the init quirk zeroes it) and,
    with ``vary``, the bathymetry above (``seed_hr``: the random one of
    tests/test_fused.py:281-283 instead; ``land_rows``: that many
    leading rows are land, enough to hold all-land tiles)."""
    prec = getattr(Precision, precision)()
    basin = basinpar_flat(NX, NY, curve_grid=curve_grid, rlon=27.5,
                          rlat=41.0)
    cfg = ModelConfig(basin=basin, sw=SWConfig(
        use_tracers=int(tracers > 0), tracer_num=max(tracers, 1),
        ksw_lat=ksw), precision=prec)
    mask = frame_of_land_mask(NX, NY)
    if islands:
        rng = np.random.RandomState(3)
        mask[2:-2, 2:-2] |= (rng.rand(NX - 4, NY - 4) < 0.15).astype(np.int32)
    mask[:land_rows] = 1
    hr = None
    if seed_hr is not None:
        hr = 100.0 + 40.0 * np.random.RandomState(seed_hr).rand(
            NX, NY).astype(np.float32)
    elif vary:
        hr = bathymetry()
    jgrid = jax_build_grid(basin, mask, hhq_rest=hr, precision=prec)
    jstate = jax_init(jgrid, cfg)
    jstate = dataclasses.replace(jstate, mu=jnp.full_like(jstate.mu, mu))
    return jgrid, cfg, jstate


def port_fused(case, mu, steps=STEPS, **kw):
    """The port's fused path on a JAX case's own numpy inputs."""
    jgrid, cfg, jstate = case
    grid, state = to_torch(jgrid, jstate, torch.float32)
    fm = FusedSWModel(grid, cfg, 1.0, mu_const=mu, static_rslu=True,
                      steps_per_call=2, **kw)
    s, ok = fm.run_steps(fm.pack(state), steps)
    assert ok
    return fm, s, fm.unpack(s, state)


# ---- the eager composition (this slice's oracle), f64 --------------------

@pytest.mark.parametrize("tracers", [0, 2])
@pytest.mark.parametrize("mu,vary", [(MU, False), (0.0, True), (MU, True)],
                         ids=["mu", "hr", "mu_hr"])
def test_eager_matches_jax_f64(tracers, mu, vary):
    """30 f64 steps with ksw_lat = 1, mu = 1000 and / or varying hr. Held
    at 1e-12 against the un-jitted JAX step (the two agree bit for bit
    there), and at 1e-6 against the jitted one: XLA's fused whole step
    rounds the f32 metric ratios dy/dx, dxb/dyb of the stresses
    differently from an op-by-op evaluation (4e-8 in str_t, str_s), and
    with mu != 0 that enters u, v and ssh."""
    jgrid, cfg, jstate = jax_case("f64", 1, tracers, mu, vary)
    grid, state = to_torch(jgrid, jstate, torch.float64)
    got, ok = run_steps(make_step(grid, cfg), state, 1.0, STEPS)
    jitted, jok = jax_run_steps(jax.jit(jax_make_step(jgrid, cfg)), jstate,
                                1.0, STEPS)
    with jax.disable_jit():
        plain, pok = jax_run_steps(jax_make_step(jgrid, cfg), jstate, 1.0,
                                   STEPS)
    assert ok and bool(jok) and bool(pok)
    names = TIGHT + ("str_t", "str_s") + (TRACER_STATE if tracers else ())
    for n in names:
        b = getattr(got, n).numpy()
        assert _rel(b, getattr(plain, n)) < 1e-12, n
        tol = 1e-12 if mu == 0.0 and n in TIGHT + TRACER_STATE else 1e-6
        assert _rel(b, getattr(jitted, n)) < tol, n
    if mu:
        assert float(got.rhsx_dif.abs().max()) > 0


def test_grid_and_state_cross_bit_for_bit():
    """hhq_rest and mu cross from the JAX grid and state unchanged."""
    jgrid, cfg, jstate = jax_case("f32", 1, 2, MU, True)
    grid, state = to_torch(jgrid, jstate, torch.float32)
    assert "hhq_rest" in GRID_FIELDS and "mu" in STATE_FIELDS
    np.testing.assert_array_equal(grid.hhq_rest.numpy(),
                                  np.asarray(jgrid.hhq_rest))
    np.testing.assert_array_equal(grid.hhq_rest.numpy(), bathymetry())
    np.testing.assert_array_equal(state.mu.numpy(), np.asarray(jstate.mu))
    assert float(state.mu.min()) == float(state.mu.max()) == MU


# ---- the fused step's plain version, f32 ---------------------------------

# (curve_grid, tracers, mu, vary, ksw, random-hr seed): the cases of
# tests/test_fused.py :94 (viscosity), :137 (bipolar, mu = 500, 2 tracers)
# and :270 (varying bathymetry, 1 tracer), then everything at once on the
# x-uniform and the bipolar grid
FUSED_CASES = {
    "viscosity": (1, 0, MU, False, 1, None),
    "bipolar_mu500_2tracers": (2, 2, 500.0, False, 1, None),
    "bathymetry_1tracer": (1, 1, 0.0, True, 1, 11),
    "all_xuniform": (1, 2, MU, True, 1, None),
    "all_bipolar": (2, 2, MU, True, 1, None),
}


def _fused_case(name, land_rows=0):
    cg, tracers, mu, vary, ksw, seed = FUSED_CASES[name]
    islands = name != "bathymetry_1tracer"     # :270 uses the frame mask
    return jax_case("f32", cg, tracers, mu, vary, ksw, islands, seed,
                    land_rows), mu


@pytest.mark.parametrize("name", sorted(FUSED_CASES))
def test_fused_matches_jax_kernel(name):
    """30 f32 steps against the JAX fused kernel in interpret mode (fast
    form, tx = 8) < 2e-5 relative per field, the tolerance of
    tests/test_fused.py's viscosity test (measured: 5e-7)."""
    case, mu = _fused_case(name)
    jgrid, cfg, jstate = case
    jf = JaxFused(jgrid, cfg, 1.0, tx=8, interpret=True, mu_const=mu,
                  static_rslu=True)
    j, jok = jax.jit(lambda s: jf.run_steps(s, STEPS))(jf.pack(jstate))
    want = jf.unpack(j, jstate)
    fm, _, got = port_fused(case, mu)
    assert bool(jok)
    assert fm.visc == bool(mu) and (fm.hr_const is None) == (
        jf.hr_const is None) and fm.metrics_2d == jf.metrics_2d
    for n in SW + (("ff", "ffp") if fm.n_tracers else ()):
        assert _rel(getattr(got, n).numpy(), getattr(want, n)) < 2e-5, n


@pytest.mark.parametrize("name", ["viscosity", "all_xuniform",
                                  "all_bipolar"])
def test_fused_matches_jax_make_step(name):
    """The same 30 steps against the jitted JAX f32 composition < 2e-5
    (measured: 5e-6)."""
    case, mu = _fused_case(name)
    jgrid, cfg, jstate = case
    want, jok = jax_run_steps(jax.jit(jax_make_step(jgrid, cfg)), jstate,
                              np.float32(1.0), STEPS)
    fm, _, got = port_fused(case, mu)
    assert bool(jok)
    for n in SW + (("ff", "ffp") if fm.n_tracers else ()):
        assert _rel(getattr(got, n).numpy(), getattr(want, n)) < 2e-5, n


@pytest.mark.parametrize("name", ["all_xuniform", "all_bipolar"])
def test_fused_matches_port_eager(name):
    """The fused plain version against the port's own eager composition
    in f32 < 2e-5, and the viscosity did something: u differs from the
    mu = 0 run by far more than that."""
    case, mu = _fused_case(name)
    jgrid, cfg, jstate = case
    grid, state = to_torch(jgrid, jstate, torch.float32)
    want, ok = run_steps(make_step(grid, cfg), state, 1.0, STEPS)
    fm, _, got = port_fused(case, mu)
    assert ok
    for n in SW + ("ff", "ffp"):
        assert _rel(getattr(got, n).numpy(), getattr(want, n).numpy()) \
            < 2e-5, n
    cg, tracers, _, vary, ksw, seed = FUSED_CASES[name]
    _, _, calm = port_fused(jax_case("f32", cg, tracers, 0.0, vary, ksw,
                                     True, seed), 0.0)
    assert _rel(got.ubrtr.numpy(), calm.ubrtr.numpy()) > 1e-3
    assert _rel(got.ff.numpy(), calm.ff.numpy()) > 1e-4


@pytest.mark.parametrize("name", ["viscosity", "all_xuniform",
                                  "all_bipolar"])
def test_guarded_equals_unguarded_and_land_stays_zero(name):
    """With the tile guard the outputs are bit-identical, and every land
    cell of every carried field is exactly 0 (a viscous land tile must
    produce exact zeros for the guard to be exact)."""
    case, mu = _fused_case(name, land_rows=40)
    lu = np.array(case[0].lu)
    fm_on, on, _ = port_fused(case, mu, tile_guard=True)
    fm_off, off, _ = port_fused(case, mu, tile_guard=False)
    assert fm_on.n_tiles[1] > 0 and fm_on.tile_wet is not None
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    wlcu, wlcv, wlu = fl.staggered_wet_masks(
        fl.embed(fm_on.lay, torch.from_numpy(lu)))
    sets = (wlu, wlu, wlcu, wlcu, wlcv, wlcv) + (wlu,) * (len(on) - 6)
    for f, w in zip(on, sets):
        land = torch.from_numpy(w) < 0.5
        assert bool((f[land] == 0).all())
        assert bool((f[~land] != 0).any())


@pytest.mark.parametrize("name", ["viscosity", "all_xuniform"])
def test_repeated_profile_rows_equal_profile_form(name):
    """On an x-uniform grid the plane-metric form, fed the profile rows
    repeated along x, makes the same f32 operations as the profile form:
    bit-identical after 10 carried steps, viscous rows included."""
    case, mu = _fused_case(name)
    jgrid, cfg, jstate = case
    grid, state = to_torch(jgrid, jstate, torch.float32)
    fm = FusedSWModel(grid, cfg, 1.0, mu_const=mu, static_rslu=True)
    rows = fl.fast2d_met_rows(fm.n_tracers, fm.visc)
    assert len(rows) == 17
    planes = fm.met[list(rows)][:, None, :].expand(
        len(rows), fm.lay.Xs, fm.lay.Ys).contiguous()
    met_map = {r: i for i, r in enumerate(rows)}
    a = b = fm.pack(state)
    for _ in range(10):
        a, ma = fstep.fused_sw_step(a, fm.met, fm.planes, fm.lay, 1.0, 0.5,
                                    fm.hr_const, None, None, None, mu, True)
        b, mb = fstep.fused_sw_step(b, planes, fm.planes, fm.lay, 1.0, 0.5,
                                    fm.hr_const, None, None, met_map, mu,
                                    True)
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and ma == mb


def test_ksw_lat_zero_keeps_the_diffusive_tracer_fluxes():
    """ksw_lat = 0 with mu != 0: no viscosity, but the tracers still
    diffuse (the JAX kernel keys the stresses on ``ksw and mu`` and the
    diffusive fluxes on ``mu`` alone). The SW fields equal the mu = 0
    run bit for bit, the tracers differ from it and agree with the JAX
    kernel."""
    case = jax_case("f32", 1, 2, MU, False, 0)
    jgrid, cfg, jstate = case
    assert cfg.sw.ksw_lat == 0
    fm, s, got = port_fused(case, MU)
    assert not fm.visc and fm.mu_const == MU
    assert fstep.mu_mode(2, MU, fm.visc) == 1
    _, calm, _ = port_fused(jax_case("f32", 1, 2, 0.0, False, 0), 0.0)
    for a, b in zip(s[:6], calm[:6]):
        assert torch.equal(a, b)
    assert not torch.equal(s[6], calm[6])
    jf = JaxFused(jgrid, cfg, 1.0, tx=8, interpret=True, mu_const=MU,
                  static_rslu=True)
    j, jok = jax.jit(lambda c: jf.run_steps(c, STEPS))(jf.pack(jstate))
    want = jf.unpack(j, jstate)
    assert bool(jok)
    for n in SW + ("ff", "ffp"):
        assert _rel(getattr(got, n).numpy(), getattr(want, n)) < 2e-5, n


def test_viscous_stages_with_mu_zero_add_exact_zeros():
    """``visc=True`` with mu = 0 gives the inviscid outputs bit for bit."""
    case = jax_case("f32", 1, 2, 0.0, False)
    grid, state = to_torch(case[0], case[2], torch.float32)
    fm = FusedSWModel(grid, case[1], 1.0, static_rslu=True)
    a = b = fm.pack(state)
    for _ in range(5):
        a, _ = fstep.fused_sw_step(a, fm.met, fm.planes, fm.lay, 1.0, 0.5,
                                   fm.hr_const)
        b, _ = fstep.fused_sw_step(b, fm.met, fm.planes, fm.lay, 1.0, 0.5,
                                   fm.hr_const, mu_const=0.0, visc=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# sha256 (first 32 hex digits) of the 6 + 2 T outputs of three carried
# steps of the plain version on ``seeded_step_inputs``, as the port gave
# them before it had a viscous or a bathymetry-plane form
OLD_OUTPUTS = {(0, False): "d3cf2fea23f1d307a6867f57f8713586",
               (0, True): "5f3a551d0b082c3cbfacff4cb1cab89e",
               (2, False): "a13828f42b13e7129ac00b2c3e513265",
               (2, True): "2ce3ffea29ef88a26359cd3d1ee8fc20"}


def seeded_step_inputs(n_tr, met2d):
    """Reproducible inputs of one fused step on a 30 x 40 basin with
    islands, random metrics and fields (numpy RandomState(17))."""
    rng = np.random.RandomState(17)
    nx, ny = 30, 40
    lay = fl.make_layout(nx, ny)
    lu = np.ones((nx, ny), np.float32)
    lu[:2] = lu[-2:] = 0
    lu[:, :2] = lu[:, -2:] = 0
    lu[2:-2, 2:-2] = (rng.rand(nx - 4, ny - 4) >= 0.15)
    lu_s = fl.embed(lay, torch.from_numpy(lu)).numpy()
    shape = (fl.N_FULL, lay.Xs, lay.Ys) if met2d else (fl.N_PROF, lay.Ys)
    met = np.zeros(shape, np.float32)
    met[:8] = (1000.0 + 100.0 * rng.rand(*met[:8].shape)).astype(np.float32)
    met[8] = (1e-4 * rng.randn(*met[8].shape)).astype(np.float32)
    fl._derive_metric_rows(met)
    dxdy = met[0] * met[1] if met2d else (met[0] * met[1])[None]
    recips = ((met[10], met[11], met[14] * met[15]) if met2d else
              (met[10:11], met[11:12], (met[14] * met[15])[None]))
    planes = fl.static_planes(lu_s, None, dxdy, fstep.kernel_planes(),
                              recips)
    wlcu, wlcv, wlu = fl.staggered_wet_masks(lu_s)
    fields = []
    for k, w in enumerate((wlu, wlu, wlcu, wlcu, wlcv, wlcv)
                          + (wlu,) * (2 * n_tr)):
        scale = 0.1 if k < 6 else 1.0
        fields.append(torch.from_numpy(
            (scale * rng.randn(lay.Xs, lay.Ys)).astype(np.float32) * w))
    met_map = None
    if met2d:
        rows = fl.fast2d_met_rows(n_tr)
        met_map = {r: i for i, r in enumerate(rows)}
        met = met[list(rows)]
    return (tuple(fields), torch.from_numpy(np.ascontiguousarray(met)),
            torch.from_numpy(planes), lay, met_map)


@pytest.mark.parametrize("n_tr,met2d", sorted(OLD_OUTPUTS))
def test_mu_zero_flat_bathymetry_gives_the_old_outputs(n_tr, met2d):
    """With ``mu_const = 0`` and flat bathymetry the step is bit for bit
    what it was before the new forms existed."""
    f, met, planes, lay, met_map = seeded_step_inputs(n_tr, met2d)
    h = hashlib.sha256()
    for _ in range(3):
        f, mx = fstep.fused_sw_step(f, met, planes, lay, 1.0, 0.5, 100.0,
                                    None, None, met_map, 0.0, False)
        for a in f:
            h.update(a.numpy().tobytes())
    assert bool(torch.isfinite(mx)) and float(mx) > 0
    assert h.hexdigest()[:32] == OLD_OUTPUTS[n_tr, met2d]


def test_flat_bathymetry_on_planes_agrees_with_the_scalar():
    """The same flat 100 m through the ``hrludxdy`` / ``hr`` planes
    (``hr_const=None``) and through the scalar: the two groupings of the
    depth column, ssh * ld + hr * ld and (ssh + hr) * ld, agree to f32
    round-off (1e-6 after 3 steps), not bit for bit."""
    f, met, planes, lay, _ = seeded_step_inputs(2, False)
    hr = np.full((lay.Xs, lay.Ys), 100.0, np.float32)
    ld = planes[3].numpy()
    more = torch.from_numpy(np.stack([hr * ld, hr]))
    a = b = f
    for _ in range(3):
        a, _ = fstep.fused_sw_step(a, met, planes, lay, 1.0, 0.5, 100.0)
        b, _ = fstep.fused_sw_step(b, met, torch.cat([planes, more]), lay,
                                   1.0, 0.5, None)
    for x, y in zip(a, b):
        assert _rel(y.numpy(), x.numpy()) < 1e-6
    assert not all(torch.equal(x, y) for x, y in zip(a, b))


# ---- layout helpers against the JAX ones ---------------------------------

@pytest.mark.parametrize("ffs,ksw,mu,hrc", list(itertools.product(
    (1, 0), (1, 0), (0.0, MU), (100.0, None))))
def test_plane_names_match_jax(ffs, ksw, mu, hrc):
    """``plane_names`` for every combination the JAX one gives (profile
    metrics and fast2d share the set); the CUDA kernel's own set is the
    same without ``wlu`` (its masks come from ``ludxdy``) and with the
    embedded ``hr`` the TPU kernel takes as a separate argument."""
    mine = fl.plane_names(ffs, ksw, mu, hrc)
    assert mine == jfsk.plane_names(ffs, ksw, mu, False, hr_const=hrc)
    assert mine == jfsk.plane_names(ffs, ksw, mu, True, hr_const=hrc,
                                    fast2d=True)
    if ffs:
        visc = bool(ksw and mu != 0.0)
        for n_tr in (0, 2):
            kernel = fstep.kernel_planes(n_tr, visc, hrc is None)
            assert set(kernel) - {"hr"} == set(mine) - {"wlu"}
            # has_hr of build_fused_sw_step, where the bathymetry varies
            assert ("hr" in kernel) == (hrc is None and (visc or n_tr > 0))


@pytest.mark.parametrize("n_tracers,visc", [(0, False), (2, False),
                                            (0, True), (2, True)])
def test_fast2d_met_rows_match_jax(n_tracers, visc):
    """The JAX rows (trans_terms = 1) less 14 and 15, which only the TPU
    kernel's mask thresholds read when there is no viscosity."""
    theirs = set(jfsk.fast2d_met_rows(1, visc, n_tracers))
    mine = set(fl.fast2d_met_rows(n_tracers, visc))
    assert mine == (theirs if visc else theirs - {14, 15})
    assert set(fl.fast2d_met_rows(n_tracers, visc)) <= set(
        fstep.KERNEL_MET_ROWS)
    assert fstep.KERNEL_MET_ROWS == (0, 1, 6, 7) + tuple(range(9, 22))


@pytest.mark.parametrize("curve_grid", [1, 2])
def test_static_planes_and_metric_rows_match_jax(curve_grid):
    """The ``hrludxdy`` plane, the embedded ``hr`` and the viscous metric
    rows equal the JAX ones bit for bit on the physical cells (the two
    layouts differ in their margins)."""
    jgrid, cfg, jstate = jax_case("f32", curve_grid, 2, MU, True)
    grid, state = to_torch(jgrid, jstate, torch.float32)
    fm = FusedSWModel(grid, cfg, 1.0, mu_const=MU, static_rslu=True)
    jf = JaxFused(jgrid, cfg, 1.0, tx=8, interpret=True, mu_const=MU,
                  static_rslu=True)
    lay, jlay = fm.lay, jf.lay

    def mine(a):
        return np.asarray(fl.extract(lay, torch.as_tensor(a)))

    def theirs(a):
        m, yp = jlay.margin, jlay.ypad
        return np.asarray(a)[..., m:m + NX, yp:yp + NY]

    names = fstep.kernel_planes(2, True, True)
    assert names[4:] == ("hrludxdy", "hr") and fm.planes.shape[0] == 6
    lu_j = np.zeros((jlay.Xs, jlay.Ys), np.float32)
    lu_j[jlay.margin:jlay.margin + NX, jlay.ypad:jlay.ypad + NY] = \
        np.asarray(jgrid.lu)
    hr_j = np.zeros_like(lu_j)
    hr_j[jlay.margin:jlay.margin + NX, jlay.ypad:jlay.ypad + NY] = \
        np.asarray(jgrid.hhq_rest)
    if curve_grid == 1:
        jmet = jfsk.metrics_profile_from_grid(jgrid, jlay)
        dxdy = (jmet[0] * jmet[1])[None, :]
        np.testing.assert_array_equal(
            fm.met.numpy()[:22, lay.margin:lay.margin + NY],
            jmet[:22, jlay.ypad:jlay.ypad + NY])
    else:
        jmet = jfsk.metrics_full_from_grid(jgrid, jlay, derived=True)
        dxdy = jmet[0] * jmet[1]
        rows = fl.fast2d_met_rows(2, True)
        assert fm.met.shape[0] == len(rows) == 17
        for r in rows:
            np.testing.assert_array_equal(mine(fm.met[fm.met_map[r]]),
                                          theirs(jmet[r]), err_msg=str(r))
    want = jfsk.static_planes(lu_j, hr_j, dxdy, ("ludxdy", "hrludxdy"))
    np.testing.assert_array_equal(mine(fm.planes[3]), theirs(want[0]))
    np.testing.assert_array_equal(mine(fm.planes[4]), theirs(want[1]))
    np.testing.assert_array_equal(mine(fm.planes[5]), theirs(hr_j))
    np.testing.assert_array_equal(mine(fm.planes[5]), bathymetry())


# ---- the envelope of FusedSWModel ---------------------------------------

def test_unsupported_no_longer_names_viscosity_or_bathymetry():
    """Neither viscosity nor varying bathymetry keeps a configuration off
    the kernel, with a linear free surface either."""
    jgrid, cfg, jstate = jax_case("f32", 1, 2, MU, True)
    grid, _ = to_torch(jgrid, jstate, torch.float32)
    assert unsupported(grid, cfg, mu_const=MU) == []
    assert flat_bathymetry(grid) is None
    fm = FusedSWModel(grid, cfg, 1.0, mu_const=MU, static_rslu=True)
    assert fm.visc and fm.hr_const is None and fm.n_tracers == 2
    flat, _ = to_torch(jax_case("f32", 1, 0, MU, False)[0], jstate,
                       torch.float32)
    assert flat_bathymetry(flat) == 100.0
    assert FusedSWModel(flat, cfg, 1.0, mu_const=MU,
                        static_rslu=True).hr_const == 100.0
    bad = dataclasses.replace(cfg, sw=dataclasses.replace(
        cfg.sw, full_free_surface=0))
    assert unsupported(grid, bad, mu_const=MU) == []


def test_pack_refuses_a_state_whose_mu_is_not_mu_const():
    jgrid, cfg, jstate = jax_case("f32", 1, 0, MU, False)
    grid, state = to_torch(jgrid, jstate, torch.float32)
    FusedSWModel(grid, cfg, 1.0, mu_const=MU, static_rslu=True).pack(state)
    with pytest.raises(ValueError, match="mu"):
        FusedSWModel(grid, cfg, 1.0, mu_const=500.0,
                     static_rslu=True).pack(state)
    with pytest.raises(ValueError, match="mu"):
        FusedSWModel(grid, cfg, 1.0, static_rslu=True).pack(state)


def test_kernel_inputs_are_checked_per_form():
    """A viscous step without its metric planes, or a varying-bathymetry
    step without its ``hr`` plane, is refused before any launch (meta
    tensors stand in for CUDA ones)."""
    lay = fl.make_layout(24, 20)
    f = torch.empty((lay.Xs, lay.Ys), device="meta")
    met = torch.empty((7, lay.Xs, lay.Ys), device="meta")
    met_map = {r: i for i, r in enumerate(fl.fast2d_met_rows(0))}
    planes = torch.empty((4, lay.Xs, lay.Ys), device="meta")
    with pytest.raises(ValueError, match="metric rows"):
        fstep.fused_sw_step((f,) * 6, met, planes, lay, 1.0, 0.5, 100.0,
                            met_map=met_map, mu_const=MU, visc=True)
    assert fstep.fused_sw_step.launches == 0


def test_viscosity_lowers_max_u_alike_in_both_packages():
    """The Azov run of chip_smoke.py phase 8 (coastline, 15-100 m
    bathymetry, mu = 1000 against mu = 0) at 64 x 48 cells of the Azov
    250 m grid cut from its coastline, 200 f64 steps: max |u| with and
    without mu, in the port's eager composition and in the un-jitted JAX
    ``make_step`` (the two agree bit for bit with mu != 0; the mu = 0 run
    of JAX is jitted, which agrees at 1e-12 there). Both packages lower
    max |u| by the same fraction, several percent here: the drop the card
    shows at full size is the viscosity's, not the port's (grid-scale
    diffusion number mu tau / dx^2 = 0.016 a step, 3.2 over 200 steps)."""
    from ocean_model_arch_tpu.config import basinpar_as250m_test
    from ocean_model_arch_tpu.io.mask_io import read_mask

    nx, ny, steps = 64, 48, 200
    full = read_mask("data/AS/maskAzovCor.txt", 1525, 1115)
    mask = np.ascontiguousarray(full[700:700 + nx, 500:500 + ny])
    mask[:2] = mask[-2:] = 1
    mask[:, :2] = mask[:, -2:] = 1
    assert 0.5 < 1 - mask.mean() < 0.95            # coast and water
    basin = dataclasses.replace(basinpar_as250m_test(), nx=nx, ny=ny)
    prec = Precision.f64()
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=0, ksw_lat=1),
                      precision=prec)
    jgrid = jax_build_grid(basin, mask, hhq_rest=bathymetry(nx, ny),
                           precision=prec)
    umax = {}
    for mu in (MU, 0.0):
        jstate = jax_init(jgrid, cfg)
        jstate = dataclasses.replace(jstate, mu=jnp.full_like(jstate.mu, mu))
        grid, state = to_torch(jgrid, jstate, torch.float64)
        got, ok = run_steps(make_step(grid, cfg), state, 1.0, steps)
        if mu:
            with jax.disable_jit():
                want, jok = jax_run_steps(jax_make_step(jgrid, cfg), jstate,
                                          1.0, steps)
        else:
            want, jok = jax_run_steps(jax.jit(jax_make_step(jgrid, cfg)),
                                      jstate, 1.0, steps)
        assert ok and bool(jok)
        umax[mu] = (float(got.ubrtr.abs().max()),
                    float(np.abs(np.asarray(want.ubrtr)).max()))
    assert umax[MU][0] == umax[MU][1]
    assert abs(umax[0.0][0] - umax[0.0][1]) <= 1e-12 * umax[0.0][1]
    port, jax_ = (umax[MU][k] / umax[0.0][k] - 1.0 for k in (0, 1))
    assert abs(port - jax_) < 1e-10
    assert -0.1 < port < -0.01
