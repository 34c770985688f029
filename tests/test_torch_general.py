"""The general form of the fused step (the TPU kernel's non-fast branch:
``FusedSWModel(static_rslu=False)``, the JAX default, and metric planes
without ``fast2d``) on the CPU, where ``fused_sw_step`` runs its plain
PyTorch version: the port's ``FusedSWModel`` against the JAX
``FusedSWModel`` with the same arguments (Pallas kernel in interpret
mode), the static reciprocal planes against the selects bit for bit, the
chained form, ``FusedSharded2DModel(static_rslu=False)`` against the JAX
sharded model and the port's single block, the guard, the fast form, and
the drivers' signatures against the JAX ones. The CUDA kernel itself is
compared with the plain version on the card by chip_smoke.py (phase
13)."""

import dataclasses
import functools
import inspect

import jax
import numpy as np
import pytest
import torch

from ocean_model_arch_tpu.config import (ModelConfig, Precision, SWConfig,
                                         basinpar_flat)
from ocean_model_arch_tpu.core.grid import build_grid as jax_build_grid
from ocean_model_arch_tpu.core.masks import frame_of_land_mask
from ocean_model_arch_tpu.model.fused import FusedSWModel as JaxFused
from ocean_model_arch_tpu.model.fused_sharded2d import \
    FusedSharded2DModel as JaxSharded
from ocean_model_arch_tpu.model.init import init_ocean_state as jax_init
from ocean_model_arch_tpu.ops.pallas import fused_step as jfsk

from ocean_model_arch_torch.model.fused import FusedSWModel, unsupported
from ocean_model_arch_torch.model.fused_sharded2d import FusedSharded2DModel
from ocean_model_arch_torch.model.step import make_step, run_steps
from ocean_model_arch_torch.ops import fused_layout as fl
from ocean_model_arch_torch.ops import fused_step as fstep

from test_torch_step import to_torch

torch.set_num_threads(1)

NX, NY, STEPS = 70, 52, 30
MU = 1000.0
# the port's plain version against the JAX kernel in interpret mode, f32:
# the same formulas in the same order, apart from XLA's contractions
TOL, TOL_ONE = 1e-5, 1e-6
SW = ("ssh", "sshp", "ubrtr", "ubrtrp", "vbrtr", "vbrtrp")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@functools.lru_cache(maxsize=None)
def _case(curve_grid=1, islands=True, tracers=0, mu=0.0, trans=1, ffs=1):
    """The basin of tests/test_fused.py (70 x 52, land frame, random
    islands from a numpy seed) with the form's switches, in both
    packages' types: (jgrid, cfg, jstate, grid, state)."""
    prec = Precision.f32()
    basin = basinpar_flat(NX, NY, curve_grid=curve_grid, rlon=27.5,
                          rlat=41.0)
    cfg = ModelConfig(basin=basin, sw=SWConfig(
        use_tracers=int(tracers > 0), tracer_num=max(tracers, 1),
        trans_terms=trans, full_free_surface=ffs), precision=prec)
    mask = frame_of_land_mask(NX, NY)
    if islands:
        rng = np.random.RandomState(3)
        mask[2:-2, 2:-2] |= (rng.rand(NX - 4, NY - 4) < 0.15).astype(
            np.int32)
    jgrid = jax_build_grid(basin, mask, precision=prec)
    jstate = jax_init(jgrid, cfg)
    if mu:
        jstate = dataclasses.replace(
            jstate, mu=jax.numpy.full_like(jstate.mu, mu))
    grid, state = to_torch(jgrid, jstate, torch.float32)
    return jgrid, cfg, jstate, grid, state


def _names(tracers):
    return SW + (("ff", "ffp") if tracers else ())


# (curve_grid, islands, tracers, mu, trans_terms, full_free_surface)
CASES = {
    "profile": (1, True, 0, 0.0, 1, 1),
    "profile_frame": (1, False, 0, 0.0, 1, 1),
    "planes": (2, True, 0, 0.0, 1, 1),
    "planes_frame": (2, False, 0, 0.0, 1, 1),
    "profile_T2": (1, True, 2, 0.0, 1, 1),
    "planes_T2": (2, True, 2, 0.0, 1, 1),
    "profile_T3": (1, True, 3, 0.0, 1, 1),
    "profile_mu": (1, True, 0, MU, 1, 1),
    "planes_T2_mu": (2, True, 2, MU, 1, 1),
    "profile_T3_mu": (1, True, 3, MU, 1, 1),
    "notrans_T2": (1, True, 2, 0.0, 0, 1),
    "linear_T2": (1, True, 2, 0.0, 1, 0),
    "planes_notrans_linear_mu": (2, True, 0, MU, 0, 0),
}


@functools.lru_cache(maxsize=None)
def _jax_run(name, steps, spc=1):
    jgrid, cfg, jstate, _, _ = _case(*CASES[name])
    jf = JaxFused(jgrid, cfg, 1.0, tx=8, interpret=True,
                  mu_const=CASES[name][3], steps_per_call=spc)
    j, ok = jax.jit(lambda s: jf.run_steps(s, steps))(jf.pack(jstate))
    assert bool(ok)
    return jf.unpack(j, jstate)


def _port_run(name, steps, spc=1, **kw):
    _, cfg, _, grid, state = _case(*CASES[name])
    fm = FusedSWModel(grid, cfg, 1.0, mu_const=CASES[name][3],
                      steps_per_call=spc, **kw)
    s, ok = fm.run_steps(fm.pack(state), steps)
    assert ok
    return fm, s, fm.unpack(s, state)


@pytest.mark.parametrize("name", sorted(CASES))
def test_general_matches_jax_kernel(name):
    """``FusedSWModel(grid, cfg, tau)`` with JAX's defaults runs the
    general form in both packages: 30 f32 steps within 1e-5 relative per
    field, and one step within 1e-6."""
    tracers = CASES[name][2]
    for steps, tol in ((1, TOL_ONE), (STEPS, TOL)):
        want = _jax_run(name, steps)
        fm, _, got = _port_run(name, steps)
        assert fm.general and not fm.fast2d and fm.met_map == (
            fstep.GENERAL_MAP if fm.metrics_2d else None)
        assert fm.planes.shape[0] == 2
        for n in _names(tracers):
            err = _rel(getattr(got, n).numpy(), getattr(want, n))
            assert err < tol, (n, steps, err)


def test_static_reciprocals_bit_identical_to_selects():
    """On the bipolar grid ``static_rslu=True, fast2d=False`` replaces the
    wet-count selects by their planes: the same values, so the same bits
    (the port's counterpart of tests/test_fused.py:119), on the single
    block and on 2 x 2 shards, with viscosity and 2 tracers."""
    _, cfg, _, grid, state = _case(*CASES["planes_T2_mu"])
    runs = []
    for kw in ({}, {"static_rslu": True, "fast2d": False}):
        fm = FusedSWModel(grid, cfg, 1.0, mu_const=MU, **kw)
        assert fm.general and fm.planes.shape[0] == 2 + 3 * bool(kw)
        s, ok = fm.run_steps(fm.pack(state), 20)
        assert ok
        runs.append(s)
        fs = FusedSharded2DModel(grid, cfg, 1.0, 2, 2, mu_const=MU,
                                 static_rslu=bool(kw), fast2d=False)
        assert fs.general
        c, ok = fs.make_runner(20)(fs.pack(state))
        assert ok
        runs.append(fs.extract(c))
    for a, b in zip(runs[0], runs[2]):
        assert torch.equal(a, b)
    for a, b in zip(runs[1], runs[3]):
        assert torch.equal(a, b)
    # and the planes hold the selects' values
    planes = FusedSWModel(grid, cfg, 1.0, static_rslu=True,
                          fast2d=False).planes
    lu = planes[0]
    want = torch.where(lu + fstep._sh(lu, 1, 0) > 1.5, 0.5, 1.0)
    assert torch.equal(planes[2], want)


@pytest.mark.parametrize("name", ["profile", "planes_T2_mu", "profile_T3"])
def test_chained_general_form(name):
    """Two steps a launch (``steps_per_call=2``): against the JAX chained
    general kernel (1e-5 after 30 steps) and against 30 single steps of
    the port (rtol 1e-6; the counterpart of tests/test_fused.py:406)."""
    want = _jax_run(name, STEPS, spc=2)
    fm2, s2, got = _port_run(name, STEPS, spc=2)
    _, s1, _ = _port_run(name, STEPS)
    assert fm2.general and fm2.steps_per_call == 2
    for n in _names(CASES[name][2]):
        assert _rel(getattr(got, n).numpy(), getattr(want, n)) < TOL, n
    for a, b in zip(s2, s1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-12)


@pytest.mark.parametrize("curve_grid", [1, 2])
def test_general_form_against_the_fast_form(curve_grid):
    """The general and the fast form compute the same step in another
    f32 operation order: 30 steps within 1e-5 relative, with viscosity
    and 2 tracers."""
    _, cfg, _, grid, state = _case(curve_grid, True, 2, MU)
    out = []
    for rslu in (False, True):
        fm = FusedSWModel(grid, cfg, 1.0, mu_const=MU, static_rslu=rslu)
        assert fm.general != rslu
        s, ok = fm.run_steps(fm.pack(state), STEPS)
        assert ok
        out.append(fm.unpack(s, state))
    for n in _names(2):
        assert _rel(getattr(out[0], n).numpy(),
                    getattr(out[1], n).numpy()) < TOL, n


def test_general_form_against_the_eager_composition():
    """30 steps of the general form against the port's f32 eager
    composition (1e-5, 2e-5 with the tracers' reassociated fluxes)."""
    _, cfg, _, grid, state = _case(*CASES["profile_T2"])
    fm, _, got = _port_run("profile_T2", STEPS)
    want, ok = run_steps(make_step(grid, cfg), state, 1.0, STEPS)
    assert ok
    for n in _names(2):
        tol = 2e-5 if n.startswith("ff") else TOL
        assert _rel(getattr(got, n).numpy(),
                    getattr(want, n).numpy()) < tol, n


@pytest.mark.parametrize("weighted", [False, True])
def test_sharded_general_form(weighted):
    """``FusedSharded2DModel(2, 2, static_rslu=False)`` (uniform and
    weighted cuts, viscosity, 2 tracers, plane metrics) against the JAX
    sharded model with the same arguments (1e-5, 30 steps) and bit for
    bit against the single general block; at two steps a launch too."""
    jgrid, cfg, jstate, grid, state = _case(*CASES["planes_T2_mu"])
    jm = JaxSharded(jgrid, cfg, 1.0, 2, 2, tx=8, interpret=True,
                    mu_const=MU, static_rslu=False, weighted=weighted)
    jc, jok = jm.make_runner(STEPS)(jm.pack(jstate))
    assert bool(jok)
    want = [np.asarray(a) for a in jm.extract(jc)]
    for spc in (1, 2):
        fs = FusedSharded2DModel(grid, cfg, 1.0, 2, 2, mu_const=MU,
                                 static_rslu=False, weighted=weighted,
                                 steps_per_call=spc)
        assert fs.general and fs.metrics_2d and fs.met_map == \
            fstep.GENERAL_MAP
        c, ok = fs.make_runner(STEPS)(fs.pack(state))
        assert ok
        got = fs.extract(c)
        for a, b in zip(got, want):
            assert _rel(a.numpy(), b) < TOL
        fm = FusedSWModel(grid, cfg, 1.0, mu_const=MU, steps_per_call=spc)
        s, ok = fm.run_steps(fm.pack(state), STEPS)
        assert ok
        for a, b in zip(got, s):
            assert torch.equal(a, fl.extract(fm.lay, b))


def test_sharded_general_periodic_channel():
    """The general form on a periodic 1 x 1 channel (the margin exchange
    wraps; profile metrics) against the port's eager composition."""
    prec = Precision.f32()
    nx, ny = 64, 48
    basin = dataclasses.replace(
        basinpar_flat(nx, ny, curve_grid=1, rlon=27.5, rlat=41.0),
        periodicity_x=1)
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=1, tracer_num=1),
                      precision=prec)
    mask = np.zeros((nx, ny), np.int32)
    mask[:, :2] = mask[:, -2:] = 1
    jgrid = jax_build_grid(basin, mask, precision=prec)
    jstate = jax_init(jgrid, cfg)
    lu = np.asarray(jgrid.lu)
    jstate = jax_init(jgrid, cfg,
                      np.roll(np.asarray(jstate.ssh), nx // 2 - 4, 0) * lu)
    grid, state = to_torch(jgrid, jstate, torch.float32)
    fs = FusedSharded2DModel(grid, cfg, 1.0, 1, 1, static_rslu=False)
    assert fs.general and fs.periodic_x
    c, ok = fs.make_runner(STEPS)(fs.pack(state))
    assert ok
    got = fs.unpack(c, state)
    want, eok = run_steps(make_step(grid, cfg), state, 1.0, STEPS)
    assert eok
    for n in ("ssh", "ubrtr", "vbrtr", "ff"):
        tol = 2e-5 if n == "ff" else TOL
        assert _rel(getattr(got, n).numpy(),
                    getattr(want, n).numpy()) < tol, n


@pytest.mark.parametrize("spc", [1, 2])
def test_guard_trips_on_the_general_form(spc):
    """``ok`` turns False on a NaN ssh and on an sshp spike at a wet cell,
    and stays True on the healthy state."""
    _, cfg, _, grid, state = _case(*CASES["profile_T2"])
    fm = FusedSWModel(grid, cfg, 1.0, steps_per_call=spc)
    assert fm.general
    s0 = fm.pack(state)
    cell = (fm.lay.margin + 30, fm.lay.margin + 30)
    assert bool(grid.lu[30, 30] > 0.5)
    for field, val in ((0, float("nan")), (1, 2.0e4)):
        bad = tuple(f.clone() for f in s0)
        bad[field][cell] = val
        _, ok = fm.run_steps(bad, 2)
        assert not ok
    _, ok = fm.run_steps(s0, 2)
    assert ok


def test_drivers_share_the_jax_defaults():
    """Every parameter the port's and JAX's ``FusedSWModel`` /
    ``FusedSharded2DModel`` share has the same default; ``fast2d=True``
    without ``static_rslu`` raises in both drivers (``FusedSWModel`` on
    metric planes, where JAX's does)."""
    for mine, theirs in ((FusedSWModel, JaxFused),
                         (FusedSharded2DModel, JaxSharded)):
        a = inspect.signature(mine).parameters
        b = inspect.signature(theirs).parameters
        shared = set(a) & set(b)
        assert {"static_rslu", "fast2d", "steps_per_call", "mu_const",
                "tile_guard"} <= shared
        for n in shared:
            assert a[n].default == b[n].default, (mine.__name__, n)
    assert inspect.signature(FusedSWModel).parameters[
        "static_rslu"].default is False
    _, cfg, _, grid, _ = _case(*CASES["planes_frame"])
    with pytest.raises(ValueError, match="static_rslu"):
        FusedSWModel(grid, cfg, 1.0, static_rslu=False, fast2d=True)
    with pytest.raises(ValueError, match="static_rslu"):
        FusedSharded2DModel(grid, cfg, 1.0, 2, 2, static_rslu=False,
                            fast2d=True)
    _, cfg1, _, grid1, _ = _case(*CASES["profile_frame"])
    with pytest.raises(ValueError, match="2D metrics"):
        FusedSharded2DModel(grid1, cfg1, 1.0, 2, 2, fast2d=True)
    # the form each combination runs, as in the JAX drivers
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True)
    assert fm.fast2d and not fm.general
    assert FusedSWModel(grid, cfg, 1.0, static_rslu=True,
                        fast2d=False).general
    assert FusedSWModel(grid1, cfg1, 1.0, fast2d=True).general
    assert not FusedSWModel(grid1, cfg1, 1.0, static_rslu=True).general
    assert "static_rslu" not in inspect.signature(unsupported).parameters


def test_general_inputs_match_jax():
    """The general form's inputs: the 16 metric planes of
    ``metrics_full_from_grid(derived=False)`` and the three reciprocal
    planes of ``plane_names(metrics_2d=True)`` equal the JAX builders'
    bit for bit (on the JAX layout's cells)."""
    jgrid, cfg, _, grid, _ = _case(*CASES["planes"])
    lay = fl.make_layout(NX, NY)
    jlay = jfsk.make_layout(NX, NY, 8)
    mine = fl.metrics_full_from_grid(grid, lay, derived=False)
    theirs = jfsk.metrics_full_from_grid(jgrid, jlay)
    assert mine.shape[0] == theirs.shape[0] == fl.N_GENERAL
    m, jm_, jy = lay.margin, jlay.margin, jlay.ypad
    np.testing.assert_array_equal(
        mine[:, m:m + NX, m:m + NY],
        theirs[:, jm_:jm_ + NX, jy:jy + NY])
    names = fl.plane_names(1, 1, MU, None, metrics_2d=True)
    assert names == jfsk.plane_names(1, 1, MU, True) == fstep.STATIC_RSLU
    assert fl.plane_names(1, 1, MU, None, metrics_2d=True, fast2d=True) \
        == jfsk.plane_names(1, 1, MU, True, fast2d=True)
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True, fast2d=False)
    jf = JaxFused(jgrid, cfg, 1.0, tx=8, interpret=True, static_rslu=True,
                  fast2d=False)
    assert not jf.fast2d and fm.met.shape[0] == fl.N_GENERAL
    lu_j = np.zeros((jlay.Xs, jlay.Ys), np.float32)
    lu_j[jm_:jm_ + NX, jy:jy + NY] = np.asarray(jgrid.lu)
    jplanes = jfsk.static_planes(lu_j, lu_j, np.float32(1.0), names)
    np.testing.assert_array_equal(
        fm.planes[2:, m:m + NX, m:m + NY].numpy(),
        jplanes[:, jm_:jm_ + NX, jy:jy + NY])


def test_general_wrapper_contract():
    """The general form's planes, metric rows and libraries: ``lu``, ``hr``
    (+ the three reciprocal planes), rows 0-15, one ``FUSED_GEN=1``
    library per (tracers, raw, steps) holding every (trans, ffs) form;
    on CPU tensors no launch is counted."""
    assert fstep.kernel_planes(2, True, True, general=True) == ("lu", "hr")
    assert fstep.kernel_planes(general=True, static_rslu=True) == (
        "lu", "hr", "rslu_u", "rslu_v", "rslu_h")
    assert fstep.GENERAL_MET_ROWS == tuple(range(16))
    targets = fstep.library_targets(general=True)
    assert len(targets) == len(set(targets)) == 16
    assert all("@FUSED_GEN=1" in t and "TRANS" not in t and "FFS" not in t
               for t in targets)
    assert fstep.library_target(5, True, 0, 0, 2, general=True) == \
        "fused_step@FUSED_RAW_NT=3@FUSED_GEN=1@FUSED_STEPS=2"
    assert not set(targets) & set(fstep.library_targets())
    fstep.reset_launch_counts()
    _port_run("profile", 2)
    assert fstep.fused_sw_step.launches == 0
    assert not fstep.fused_sw_step.form_launches
