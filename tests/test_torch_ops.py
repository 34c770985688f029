"""The port's eager kernels against their JAX twins, f64, random inputs.

Every function of ``ocean_model_arch_torch/ops/{stencil,sw_kernels,
depth_kernels,tracer_kernels}.py`` gets the same numpy inputs as its
counterpart in ``ocean_model_arch_tpu`` and must agree to 1e-12 relative (in practice
bit-for-bit: the formulas keep the JAX operation order). Also the
numpy -> torch carriers ``grid_from_numpy`` / ``state_from_numpy``.
"""

import numpy as np
import pytest
import torch

from ocean_model_arch_tpu.config import ModelConfig, Precision, SWConfig
from ocean_model_arch_tpu.config import basinpar_flat
from ocean_model_arch_tpu.core import masks as mk
from ocean_model_arch_tpu.core.grid import build_grid as jax_build_grid
from ocean_model_arch_tpu.model.init import init_ocean_state as jax_init
from ocean_model_arch_tpu.ops import depth_kernels as jdk
from ocean_model_arch_tpu.ops import stencil as jst
from ocean_model_arch_tpu.ops import sw_kernels as jswk
from ocean_model_arch_tpu.ops import tracer_kernels as jtrk

from ocean_model_arch_torch.core.grid import GRID_FIELDS, grid_from_numpy
from ocean_model_arch_torch.core.state import STATE_FIELDS, state_from_numpy
from ocean_model_arch_torch.ops import depth_kernels as tdk
from ocean_model_arch_torch.ops import stencil as tst
from ocean_model_arch_torch.ops import sw_kernels as tswk
from ocean_model_arch_torch.ops import tracer_kernels as ttrk

import oracle

torch.set_num_threads(1)

NX, NY = 23, 17
RTOL = 1e-12


@pytest.fixture(scope="module")
def d():
    """Random masked basin (inside the 2-cell land frame), random f32
    metrics and masks, random f64 fields and positive f64 depths."""
    rng = np.random.RandomState(11)
    int_mask = mk.frame_of_land_mask(NX, NY)
    int_mask[2:-2, 2:-2] = (rng.rand(NX - 4, NY - 4) >= 0.8).astype(np.int32)
    lu = mk.lu_from_int_mask(int_mask)
    luh, luu, llu, llv, lcu, lcv = mk.derive_staggered_masks(lu)
    out = dict(lu=lu, luh=luh, luu=luu, llu=llu, llv=llv, lcu=lcu, lcv=lcv)
    for k in ("dx", "dy", "dxt", "dyt", "dxh", "dyh", "dxb", "dyb"):
        out[k] = (1000.0 + 100.0 * rng.rand(NX, NY)).astype(np.float32)
    out["rlh_s"] = (1e-4 * rng.randn(NX, NY)).astype(np.float32)
    out["rdis"] = np.abs(1e-5 * rng.randn(NX, NY)).astype(np.float32)
    for k in ("ssh", "sshn", "sshp", "u", "un", "up", "v", "vn", "vp",
              "vort", "str_t", "str_s", "rhsx", "rhsy", "rhsx_adv",
              "rhsy_adv", "rhsx_dif", "rhsy_dif"):
        out[k] = rng.randn(NX, NY)
    out["mu"] = np.abs(rng.randn(NX, NY)) * 100.0
    for k in ("hu", "hun", "hup", "hv", "hvn", "hvp", "hh", "hhn", "hhp",
              "hq", "hqn", "hqp", "h_r"):
        out[k] = 50.0 + 10.0 * rng.rand(NX, NY)
    for k in ("ff", "ffp", "ffn", "flux_x", "flux_y"):
        out[k] = rng.randn(NX, NY)
    return out


def _jax(x):
    return jst.pad(np.asarray(x))


def _torch(x):
    return tst.pad(torch.from_numpy(np.asarray(x)))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), _np(w)
        assert g.dtype == w.dtype, (i, g.dtype, w.dtype)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        scale = np.abs(w[np.isfinite(w)]).max(initial=0.0)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * scale,
                                   err_msg=f"output {i}")


# name -> f(module, pad, d): each call sees the JAX module with the JAX
# pad, or the port's module with the port's pad
SW_CASES = {
    "gaussian_bump": lambda m, P, d: m.gaussian_bump(
        P(d["lu"]), P(d["ssh"]), 1.0, NX // 2, NY // 2),
    "update_ssh": lambda m, P, d: m.update_ssh(
        1.0, P(d["lu"]), P(d["dx"]), P(d["dy"]), P(d["dxh"]), P(d["dyh"]),
        P(d["hu"]), P(d["hv"]), P(d["sshn"]), P(d["sshp"]), P(d["u"]),
        P(d["v"])),
    "update_uv": lambda m, P, d: m.update_uv(
        1.0, P(d["lcu"]), P(d["lcv"]), P(d["dxt"]), P(d["dyt"]),
        P(d["dxh"]), P(d["dyh"]), P(d["dxb"]), P(d["dyb"]),
        P(d["hu"]), P(d["hun"]), P(d["hup"]), P(d["hv"]), P(d["hvn"]),
        P(d["hvp"]), P(d["hh"]), P(d["ssh"]),
        P(d["u"]), P(d["un"]), P(d["up"]), P(d["v"]), P(d["vn"]),
        P(d["vp"]), P(d["rdis"]), P(d["rlh_s"]),
        P(d["rhsx"]), P(d["rhsy"]), P(d["rhsx_adv"]), P(d["rhsy_adv"]),
        P(d["rhsx_dif"]), P(d["rhsy_dif"])),
    "next_step": lambda m, P, d: m.next_step(
        0.5, P(d["lu"]), P(d["lcu"]), P(d["lcv"]),
        P(d["ssh"]), P(d["sshn"]), P(d["sshp"]), P(d["u"]), P(d["un"]),
        P(d["up"]), P(d["v"]), P(d["vn"]), P(d["vp"])),
    "uv_trans_vort": lambda m, P, d: m.uv_trans_vort(
        P(d["luu"]), P(d["dxt"]), P(d["dyt"]), P(d["dxb"]), P(d["dyb"]),
        P(d["u"]), P(d["v"]), P(d["vort"])),
    "uv_trans": lambda m, P, d: m.uv_trans(
        P(d["lcu"]), P(d["lcv"]), P(d["luu"]), P(d["dxh"]), P(d["dyh"]),
        P(d["u"]), P(d["v"]), P(d["vort"]), P(d["hq"]), P(d["hu"]),
        P(d["hv"]), P(d["hh"]), P(d["rhsx_adv"]), P(d["rhsy_adv"])),
    "stress_components": lambda m, P, d: m.stress_components(
        P(d["lu"]), P(d["luu"]), P(d["dx"]), P(d["dy"]), P(d["dxt"]),
        P(d["dyt"]), P(d["dxh"]), P(d["dyh"]), P(d["dxb"]), P(d["dyb"]),
        P(d["up"]), P(d["vp"]), P(d["str_t"]), P(d["str_s"])),
    "uv_diff2": lambda m, P, d: m.uv_diff2(
        P(d["lcu"]), P(d["lcv"]), P(d["dx"]), P(d["dy"]), P(d["dxt"]),
        P(d["dyt"]), P(d["dxh"]), P(d["dyh"]), P(d["dxb"]), P(d["dyb"]),
        P(d["mu"]), P(d["str_t"]), P(d["str_s"]), P(d["hq"]), P(d["hu"]),
        P(d["hv"]), P(d["hh"]), P(d["rhsx_dif"]), P(d["rhsy_dif"])),
}

DEPTH_CASES = {
    "hh_init_ffs1": lambda m, P, d: m.hh_init(
        1, P(d["lu"]), P(d["llu"]), P(d["llv"]), P(d["luh"]),
        *[P(d[k]) for k in ("dx", "dy", "dxt", "dyt", "dxh", "dyh", "dxb",
                            "dyb")],
        P(d["ssh"]), P(d["sshp"]), P(d["h_r"]),
        *[P(d[k]) for k in ("hu", "hup", "hun", "hv", "hvp", "hvn", "hh",
                            "hhp", "hhn")]),
    "hh_init_ffs0": lambda m, P, d: m.hh_init(
        0, P(d["lu"]), P(d["llu"]), P(d["llv"]), P(d["luh"]),
        *[P(d[k]) for k in ("dx", "dy", "dxt", "dyt", "dxh", "dyh", "dxb",
                            "dyb")],
        P(d["ssh"]), P(d["sshp"]), P(d["h_r"]),
        *[P(d[k]) for k in ("hu", "hup", "hun", "hv", "hvp", "hvn", "hh",
                            "hhp", "hhn")]),
    "hh_update": lambda m, P, d: m.hh_update(
        P(d["lu"]), P(d["llu"]), P(d["llv"]), P(d["luh"]),
        *[P(d[k]) for k in ("dx", "dy", "dxt", "dyt", "dxh", "dyh", "dxb",
                            "dyb")],
        P(d["ssh"]), P(d["h_r"]), P(d["hun"]), P(d["hvn"]), P(d["hhn"])),
    "hh_shift": lambda m, P, d: m.hh_shift(
        0.5, P(d["lu"]), P(d["llu"]), P(d["llv"]), P(d["luh"]),
        *[P(d[k]) for k in ("hq", "hqp", "hqn", "hu", "hup", "hun", "hv",
                            "hvp", "hvn", "hh", "hhp", "hhn")]),
}


TRACER_CASES = {
    "tran_diff_fluxes": lambda m, P, d: m.tran_diff_fluxes(
        P(d["lcu"]), P(d["lcv"]), P(d["dxt"]), P(d["dyt"]), P(d["dxh"]),
        P(d["dyh"]), P(d["hu"]), P(d["hv"]), P(d["ff"]), P(d["ffp"]),
        P(d["u"]), P(d["v"]), P(d["mu"]), 1.0, P(d["flux_x"]),
        P(d["flux_y"])),
    "tran_diff_fluxes_mu0": lambda m, P, d: m.tran_diff_fluxes(
        P(d["lcu"]), P(d["lcv"]), P(d["dxt"]), P(d["dyt"]), P(d["dxh"]),
        P(d["dyh"]), P(d["hu"]), P(d["hv"]), P(d["ff"]), P(d["ffp"]),
        P(d["u"]), P(d["v"]), P(0.0 * d["mu"]), 1.0, P(d["flux_x"]),
        P(d["flux_y"])),
    "tran_diff_tracer": lambda m, P, d: m.tran_diff_tracer(
        1.0, P(d["lu"]), P(d["dx"]), P(d["dy"]), P(d["hqn"]), P(d["hqp"]),
        P(d["flux_x"]), P(d["flux_y"]), P(d["ffp"]), P(d["ffn"])),
    "tracer_next_step": lambda m, P, d: m.tracer_next_step(
        0.5, P(d["lu"]), P(d["ffn"]), P(d["ffp"]), P(d["ff"])),
}


@pytest.mark.parametrize("name", sorted(TRACER_CASES))
def test_tracer_kernel_matches_jax(d, name):
    """The quirks included: the flux uses ff (ffp is ignored), land edges
    keep flux_x / flux_y, land cells keep ffn, ff and ffp."""
    case = TRACER_CASES[name]
    got, want = case(ttrk, _torch, d), case(jtrk, _jax, d)
    _assert_same(got, want)
    if name.startswith("tran_diff_fluxes"):
        land_u = d["lcu"] < 0.5
        assert land_u.any()
        np.testing.assert_array_equal(_np(got[0])[land_u],
                                      d["flux_x"][land_u])
        changed = dict(d, ffp=d["ffp"] + 1.0)
        _assert_same(case(ttrk, _torch, changed), got)


@pytest.mark.parametrize("name", sorted(SW_CASES))
def test_sw_kernel_matches_jax(d, name):
    case = SW_CASES[name]
    _assert_same(case(tswk, _torch, d), case(jswk, _jax, d))


def _oracle_stress(d):
    return oracle.o_stress(*[d[k] for k in (
        "lu", "luu", "dx", "dy", "dxt", "dyt", "dxh", "dyh", "dxb", "dyb",
        "up", "vp", "str_t", "str_s")])


def _oracle_uv_diff2(d):
    return oracle.o_uv_diff2(*[d[k] for k in (
        "lcu", "lcv", "dx", "dy", "dxt", "dyt", "dxh", "dyh", "dxb", "dyb",
        "mu", "str_t", "str_s", "hq", "hu", "hv", "hh", "rhsx_dif",
        "rhsy_dif")])


def _oracle_tracer_fluxes(d):
    return oracle.o_tracer_fluxes(*[d[k] for k in (
        "lcu", "lcv", "dxt", "dyt", "dxh", "dyh", "hu", "hv", "ff", "u", "v",
        "mu")], 1.0, d["flux_x"], d["flux_y"])


# the viscosity's kernels and the diffusive tracer flux with mu != 0
# against the loop oracle (per-point numpy loops, tests/oracle.py)
ORACLE_CASES = {
    "stress_components": (tswk, SW_CASES, _oracle_stress),
    "uv_diff2": (tswk, SW_CASES, _oracle_uv_diff2),
    "tran_diff_fluxes": (ttrk, TRACER_CASES, _oracle_tracer_fluxes),
}


@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_viscous_kernel_matches_loop_oracle(d, name):
    """mu != 0 (random, positive, varying in space): the eager kernels
    against an implementation that shares no code with them."""
    module, cases, loops = ORACLE_CASES[name]
    assert float(np.abs(d["mu"]).min()) > 0
    got = cases[name](module, _torch, d)
    want = loops(d)
    _assert_same(got, want)
    assert all(np.abs(w).max() > 0 for w in want)


@pytest.mark.parametrize("name", sorted(DEPTH_CASES))
def test_depth_kernel_matches_jax(d, name):
    case = DEPTH_CASES[name]
    _assert_same(case(tdk, _torch, d), case(jdk, _jax, d))


@pytest.mark.parametrize("where,value,ok", [
    (None, 0.0, True), ((5, 7), np.nan, False), ((5, 7), 2.0e4, False),
    ((5, 7), -2.0e4, False), ((0, 0), np.nan, True)])
def test_check_ssh_ok_matches_jax(d, where, value, ok):
    """Finite |ssh| < 1e4 at every wet cell; land cells ((0, 0) is in the
    frame) are not checked."""
    ssh = d["ssh"].copy()
    if where is not None:
        ssh[where] = value
    got = tswk.check_ssh_ok(_torch(d["lu"]), _torch(ssh))
    want = jswk.check_ssh_ok(_jax(d["lu"]), _jax(ssh))
    assert got.dtype == torch.bool and got.shape == ()
    assert bool(got) == bool(want) == ok


@pytest.mark.parametrize("px,py", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_pad_and_shift_match_jax(px, py):
    rng = np.random.RandomState(1)
    f = rng.randn(3, 9, 7)                   # a leading (nlev) axis
    got = tst.pad(torch.from_numpy(f), px, py)
    want = np.asarray(jst.pad(f, px, py))
    np.testing.assert_array_equal(got.numpy(), want)
    for dm in (-2, -1, 0, 1, 2):
        for dn in (-2, 0, 1):
            np.testing.assert_array_equal(
                tst.sh(got, dm, dn).numpy(),
                np.asarray(jst.sh(want, dm, dn)))
    np.testing.assert_array_equal(tst.C(got).numpy(), f)
    np.testing.assert_array_equal(tst.wet(torch.from_numpy(f)).numpy(),
                                  np.asarray(jst.wet(f)))


def _jax_case(precision):
    nx, ny = 30, 24
    basin = basinpar_flat(nx, ny, curve_grid=1, rlon=27.5, rlat=41.0)
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=1, tracer_num=2),
                      precision=precision)
    mask = mk.frame_of_land_mask(nx, ny)
    mask[10:13, 8:11] = 1
    grid = jax_build_grid(basin, mask, precision=precision)
    return grid, jax_init(grid, cfg)


def test_grid_from_numpy_round_trip():
    grid, _ = _jax_case(Precision.f64())
    d = {n: np.asarray(getattr(grid, n)) for n in GRID_FIELDS}
    tg = grid_from_numpy(d, "cpu", grid.periodic_x, grid.periodic_y)
    assert (tg.nx, tg.ny) == (grid.nx, grid.ny)
    for n in GRID_FIELDS:
        back = getattr(tg, n).numpy()
        assert back.dtype == d[n].dtype, n
        np.testing.assert_array_equal(back, d[n], err_msg=n)


@pytest.mark.parametrize("precision,dtype", [
    (Precision.f64(), torch.float64), (Precision.f32(), torch.float32)])
def test_state_from_numpy_round_trip(precision, dtype):
    _, state = _jax_case(precision)
    d = {n: (None if getattr(state, n) is None
             else np.asarray(getattr(state, n))) for n in STATE_FIELDS}
    ts = state_from_numpy(d, "cpu", dtype)
    for n in STATE_FIELDS:
        if d[n] is None:
            assert getattr(ts, n) is None, n
            continue
        back = getattr(ts, n).numpy()
        assert back.dtype == d[n].dtype, (n, back.dtype, d[n].dtype)
        np.testing.assert_array_equal(back, d[n], err_msg=n)
