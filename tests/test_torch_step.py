"""The port's eager step composition (model/step.py) against the JAX
package: 30 f64 steps against JAX ``make_step`` at 1e-12, without and
with 2 tracers, the committed Black Sea golden digests at rtol 1e-9,
and the stability guard."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from ocean_model_arch_tpu.config import (ModelConfig, Precision, SWConfig,
                                         basinpar_bs4km, basinpar_flat)
from ocean_model_arch_tpu.core.grid import build_grid as jax_build_grid
from ocean_model_arch_tpu.core.masks import frame_of_land_mask
from ocean_model_arch_tpu.io.mask_io import read_mask
from ocean_model_arch_tpu.model.init import init_ocean_state as jax_init
from ocean_model_arch_tpu.model.step import make_step as jax_make_step
from ocean_model_arch_tpu.model.step import run_steps as jax_run_steps

from ocean_model_arch_torch.core.grid import (GRID_FIELDS, build_grid,
                                              grid_from_numpy)
from ocean_model_arch_torch.core.state import STATE_FIELDS, state_from_numpy
from ocean_model_arch_torch.model.init import init_ocean_state
from ocean_model_arch_torch.model.step import (GlobalHalo, make_step,
                                               reinit_depth_families,
                                               run_steps, tracer_step)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "tests", "golden_bs100.json")) as f:
    GOLDEN = json.load(f)
POINTS = [tuple(p) for p in GOLDEN["points"]]


def _case(precision, with_islands=True, nx=70, ny=52, tracers=0):
    """tests/test_fused.py::_case (curve_grid=1) at a chosen precision."""
    basin = basinpar_flat(nx, ny, curve_grid=1, rlon=27.5, rlat=41.0)
    cfg = ModelConfig(basin=basin,
                      sw=SWConfig(use_tracers=int(tracers > 0),
                                  tracer_num=max(tracers, 1)),
                      precision=precision)
    mask = frame_of_land_mask(nx, ny)
    if with_islands:
        rng = np.random.RandomState(3)
        mask[2:-2, 2:-2] |= (rng.rand(nx - 4, ny - 4) < 0.15).astype(np.int32)
    return basin, cfg, mask


def to_torch(jgrid, jstate, dtype):
    """The JAX grid and state as the port's, bit-identical."""
    grid = grid_from_numpy({n: np.asarray(getattr(jgrid, n))
                            for n in GRID_FIELDS}, "cpu",
                           jgrid.periodic_x, jgrid.periodic_y)
    state = state_from_numpy({n: (None if getattr(jstate, n) is None
                                  else np.asarray(getattr(jstate, n)))
                              for n in STATE_FIELDS}, "cpu", dtype)
    return grid, state


def test_build_grid_and_init_match_jax():
    basin, cfg, mask = _case(Precision.f64())
    jgrid = jax_build_grid(basin, mask, precision=cfg.precision)
    jstate = jax_init(jgrid, cfg)
    grid = build_grid(basin, mask, precision=cfg.precision, device="cpu")
    for n in GRID_FIELDS:
        a, b = np.asarray(getattr(jgrid, n)), getattr(grid, n).numpy()
        assert a.dtype == b.dtype, n
        np.testing.assert_array_equal(b, a, err_msg=n)
    state = init_ocean_state(grid, cfg)
    for n in STATE_FIELDS:
        a = getattr(jstate, n)
        if a is None:
            assert getattr(state, n) is None, n
            continue
        a = np.asarray(a)
        b = getattr(state, n).numpy()
        assert a.dtype == b.dtype, n
        # exp() of two libraries: last-bit differences in the bump
        np.testing.assert_allclose(b, a, rtol=1e-14, atol=1e-16, err_msg=n)


# the prognostic fields, the depth families and the advection terms.
# str_t/str_s multiply velocity differences by f32 metric ratios (dy/dx,
# dxb/dyb, ...), which XLA's jitted whole step and eager torch round
# differently: they agree at f32 epsilon, so they are held at 1e-6 (they
# feed only the viscosity terms, which mu = 0 zeroes)
TIGHT = ("ssh", "sshn", "sshp", "ubrtr", "ubrtrn", "ubrtrp", "vbrtr",
         "vbrtrn", "vbrtrp", "rhsx_adv", "rhsy_adv", "rhsx_dif", "rhsy_dif",
         "vort", "hhq", "hhq_p", "hhq_n", "hhu", "hhu_p", "hhu_n", "hhv",
         "hhv_p", "hhv_n", "hhh", "hhh_p", "hhh_n")


@pytest.mark.parametrize("with_islands", [False, True])
def test_make_step_matches_jax_f64(with_islands):
    basin, cfg, mask = _case(Precision.f64(), with_islands)
    jgrid = jax_build_grid(basin, mask, precision=cfg.precision)
    jstate = jax_init(jgrid, cfg)
    grid, state = to_torch(jgrid, jstate, torch.float64)
    want, jok = jax_run_steps(jax.jit(jax_make_step(jgrid, cfg)), jstate,
                              1.0, 30)
    got, ok = run_steps(make_step(grid, cfg), state, 1.0, 30)
    assert ok and bool(jok)
    for n in TIGHT + ("str_t", "str_s"):
        a = np.asarray(getattr(want, n))
        b = getattr(got, n).numpy()
        rel = np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)
        assert rel < (1e-12 if n in TIGHT else 1e-6), (n, rel)


def _bs_case(precision):
    """The Black Sea case of tests/test_golden.py, one tracer included."""
    basin = basinpar_bs4km()
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=1, tracer_num=1),
                      precision=precision)
    mask = read_mask(os.path.join(REPO, basin.mask_file_name),
                     basin.nx, basin.ny)
    grid = build_grid(basin, mask, precision=precision, device="cpu")
    return grid, cfg, init_ocean_state(grid, cfg)


def check_golden(state, step_key, rtol, pt_atol):
    """ssh, u, v and the tracer against the committed digests
    (tests/test_golden.py)."""
    want = GOLDEN["steps"][step_key]
    for fld, a in (("ssh", state.ssh), ("u", state.ubrtr),
                   ("v", state.vbrtr), ("tracer", state.ff[0])):
        a = a.double().numpy()
        got = {"sum": a.sum(), "l2": np.sqrt((a * a).sum()),
               "absmax": np.abs(a).max()}
        for k in ("sum", "l2", "absmax"):
            np.testing.assert_allclose(got[k], want[fld][k], rtol=rtol,
                                       err_msg=f"{step_key} {fld}.{k}")
        np.testing.assert_allclose(
            [a[i, j] for (i, j) in POINTS], want[fld]["points"], rtol=rtol,
            atol=pt_atol, err_msg=f"{step_key} {fld}.points")


def test_golden_bs100_f64_eager():
    grid, cfg, state = _bs_case(Precision.f64())
    step = make_step(grid, cfg)
    done = 0
    for s in sorted(GOLDEN["steps"], key=int):
        state, ok = run_steps(step, state, 1.0, int(s) - done)
        done = int(s)
        assert ok
        check_golden(state, s, rtol=1e-9, pt_atol=1e-12)


@pytest.mark.parametrize("field,value", [("ssh", np.nan), ("sshp", 2.0e4),
                                         ("sshp", -2.0e4)])
def test_guard_trips(field, value):
    """A NaN or an |ssh| > 1e4 at a wet cell makes ``ok`` False."""
    basin, cfg, mask = _case(Precision.f64(), with_islands=False)
    grid = build_grid(basin, mask, precision=cfg.precision, device="cpu")
    state = init_ocean_state(grid, cfg)
    bad = getattr(state, field).clone()
    bad[30, 30] = value
    state = dataclasses.replace(state, **{field: bad})
    _, ok = run_steps(make_step(grid, cfg), state, 1.0, 2)
    assert ok is False


TRACER_STATE = ("ff", "ffp", "ffn", "flux_x", "flux_y")


@pytest.mark.parametrize("with_islands", [False, True])
def test_make_step_with_tracers_matches_jax_f64(with_islands):
    """30 f64 steps of sw_step + tracer_step with 2 tracers against the
    JAX ``make_step`` at 1e-12, the tracer levels and the carried edge
    fluxes included."""
    basin, cfg, mask = _case(Precision.f64(), with_islands, tracers=2)
    jgrid = jax_build_grid(basin, mask, precision=cfg.precision)
    jstate = jax_init(jgrid, cfg)
    grid, state = to_torch(jgrid, jstate, torch.float64)
    assert state.ff.shape == (2, 70, 52) and state.flux_x.shape == (70, 52)
    want, jok = jax_run_steps(jax.jit(jax_make_step(jgrid, cfg)), jstate,
                              1.0, 30)
    got, ok = run_steps(make_step(grid, cfg), state, 1.0, 30)
    assert ok and bool(jok)
    for n in TIGHT + TRACER_STATE:
        a = np.asarray(getattr(want, n))
        b = getattr(got, n).numpy()
        assert a.shape == b.shape, n
        rel = np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)
        assert rel < 1e-12, (n, rel)
    assert float(got.ff.abs().max()) > 0 and float(got.flux_x.abs().max()) > 0
    # the input state is not modified in place
    for n in TRACER_STATE:
        np.testing.assert_array_equal(getattr(state, n).numpy(),
                                      np.asarray(getattr(jstate, n)))


def test_init_with_tracers_matches_jax():
    """The tracer bumps of init_ocean_state: equal to the JAX ones to the
    last bits of exp(), exactly 0 on land."""
    basin, cfg, mask = _case(Precision.f64(), tracers=2)
    jstate = jax_init(jax_build_grid(basin, mask, precision=cfg.precision),
                      cfg)
    grid = build_grid(basin, mask, precision=cfg.precision, device="cpu")
    state = init_ocean_state(grid, cfg)
    for n in TRACER_STATE:
        a, b = np.asarray(getattr(jstate, n)), getattr(state, n).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, n
        np.testing.assert_allclose(b, a, rtol=1e-14, atol=1e-16, err_msg=n)
    land = grid.lu < 0.5
    assert bool((state.ff[:, land] == 0).all())


def test_tracer_step_without_tracers_is_the_identity():
    basin, cfg, mask = _case(Precision.f64())
    grid = build_grid(basin, mask, precision=cfg.precision, device="cpu")
    state = init_ocean_state(grid, cfg)
    assert state.ff is None
    assert tracer_step(state, grid, cfg, 1.0, GlobalHalo()) is state


def test_reinit_depth_families_is_idempotent_after_init():
    """init already ends with hh_init, so regenerating the depth families
    from (ssh, sshp) reproduces them exactly."""
    basin, cfg, mask = _case(Precision.f64())
    grid = build_grid(basin, mask, precision=cfg.precision, device="cpu")
    state = init_ocean_state(grid, cfg)
    again = reinit_depth_families(state, grid, cfg)
    for n in ("hhq", "hhq_p", "hhq_n", "hhu", "hhu_p", "hhu_n", "hhv",
              "hhv_p", "hhv_n", "hhh", "hhh_p", "hhh_n"):
        assert torch.equal(getattr(again, n), getattr(state, n)), n
