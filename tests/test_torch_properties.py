"""The JAX package's property tests held on the port: the physics of
``tests/test_physics.py`` on the port's eager step (f64; its fused path
where the JAX test uses one), the whole composition against the loop
oracle ``tests/oracle.py::o_model_step`` with the mutation check of
``tests/test_model_oracle.py``, and every kernel of
``tests/test_kernels_vs_oracle.py`` against its per-point loop, at the
JAX tests' sizes and tolerances. The oracle imports no JAX; nothing here
runs the JAX package."""

import dataclasses

import numpy as np
import pytest
import torch

from ocean_model_arch_torch.config import (ModelConfig, Precision, SWConfig,
                                           basinpar_flat)
from ocean_model_arch_torch.core import masks as mk
from ocean_model_arch_torch.core.grid import build_grid
from ocean_model_arch_torch.model.fused import FusedSWModel
from ocean_model_arch_torch.model.init import init_ocean_state
from ocean_model_arch_torch.model.model import OceanModel
from ocean_model_arch_torch.model.step import make_step, run_steps
from ocean_model_arch_torch.ops import depth_kernels as dk
from ocean_model_arch_torch.ops import sw_kernels as swk
from ocean_model_arch_torch.ops import tracer_kernels as trk
from ocean_model_arch_torch.ops.stencil import pad

import oracle as orc

torch.set_num_threads(1)


# ---- tests/test_physics.py: the 66 x 66 flat basin, f64, one tracer -----

@pytest.fixture(scope="module")
def flat_model():
    basin = basinpar_flat(66, 66)
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=1, tracer_num=1),
                      precision=Precision.f64())
    grid = build_grid(basin, mk.frame_of_land_mask(basin.nx, basin.ny),
                      device="cpu")
    state = init_ocean_state(grid, cfg)
    return grid, cfg, state, make_step(grid, cfg)


@pytest.fixture(scope="module")
def after_100(flat_model):
    grid, cfg, state, step = flat_model
    st, ok = run_steps(step, state, 1.0, 100)
    assert ok
    return st


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def wet_sum(field, grid, mask):
    w = _np(mask) > 0.5
    area = _np(grid.dx).astype(np.float64) * _np(grid.dy).astype(np.float64)
    return float(np.sum(_np(field) * area * w))


def test_ssh_volume_conserved(flat_model, after_100):
    grid, _, state, _ = flat_model
    v0 = wet_sum(state.ssh, grid, grid.lu)
    v1 = wet_sum(after_100.ssh, grid, grid.lu)
    assert abs(v1 - v0) < 1e-6 * max(1.0, abs(v0))


def test_tracer_content_conserved(flat_model, after_100):
    """The flux-form leapfrog update conserves the water column's tracer
    content: sum(hhq_n * area * ffn) after a step equals sum(hhq_p * area
    * ffp_old) with the depths of the same step."""
    grid, _, _, step = flat_model
    st_a = after_100
    st_b, _ = step(st_a, 1.0)
    c_new = wet_sum(_np(st_b.hhq_n) * _np(st_b.ffn[0]), grid, grid.lu)
    c_prev = wet_sum(_np(st_b.hhq_p) * _np(st_a.ffp[0]), grid, grid.lu)
    assert abs(c_new - c_prev) < 1e-6 * max(1.0, abs(c_prev))
    assert abs(c_new) > 0


def test_bump_symmetry(flat_model):
    """50 steps: the field is mirror-symmetric about the bump's centre in
    x and in y (not under x <-> y: the f-plane Coriolis term)."""
    _, _, state, step = flat_model
    st, _ = run_steps(step, state, 1.0, 50)
    s = _np(st.ssh)
    c = 2 * (66 // 2 - 1)
    inner = slice(10, 55)
    np.testing.assert_allclose(s[inner, inner], s[c - 10:c - 55:-1, inner],
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(s[inner, inner], s[inner, c - 10:c - 55:-1],
                               rtol=0, atol=1e-10)


def test_gravity_wave_speed(flat_model):
    """400 steps: the bump radiates (the peak falls) and the field stays
    bounded and positive at its peak."""
    _, _, state, step = flat_model
    st, ok = run_steps(step, state, 1.0, 400)
    assert ok
    s0, s1 = _np(state.ssh), _np(st.ssh)
    assert s1.max() < s0.max()
    assert s1.max() > 0.0


def test_check_ssh_guard(flat_model):
    """A spike in sshp is inherited by the new ssh and trips the guard."""
    _, _, state, step = flat_model
    sshp = state.sshp.clone()
    sshp[30, 30] = 2.0e4
    _, ok = step(dataclasses.replace(state, sshp=sshp), 1.0)
    assert not bool(ok)


def test_land_points_untouched(flat_model):
    grid, _, state, step = flat_model
    st, _ = run_steps(step, state, 1.0, 20)
    land = _np(grid.lu) < 0.5
    np.testing.assert_array_equal(_np(st.ssh)[land], 0.0)
    np.testing.assert_array_equal(
        _np(st.ubrtr)[land & (_np(grid.lcu) < 0.5)], 0.0)


def test_f32_drift_vs_f64():
    """300 steps of the gravity-wave test on 66 x 50: the f32 trajectory
    tracks the f64 one within 1e-4 of the field's scale."""
    basin = basinpar_flat(66, 50)
    mask = mk.frame_of_land_mask(66, 50)
    outs = {}
    for prec in (Precision.f64(), Precision.f32()):
        cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=0),
                          precision=prec)
        grid = build_grid(basin, mask, precision=prec, device="cpu")
        state = init_ocean_state(grid, cfg)
        st, ok = run_steps(make_step(grid, cfg), state, 1.0, 300)
        assert ok
        outs[str(prec.state_dtype)] = _np(st.ssh).astype(np.float64)
    drift = np.abs(outs["float32"] - outs["float64"]).max()
    scale = np.abs(outs["float64"]).max()
    assert drift / scale < 1e-4, drift / scale


def test_state_mu_const_detection():
    """``OceanModel.state_mu_const``: a constant mu (the zeroed init, or
    any uniform viscosity) gives its value, a varying one None; the fused
    model refuses a state whose mu is not its ``mu_const`` (the JAX
    model's ``validate_state``; the port's ``pack``)."""
    basin = basinpar_flat(24, 20)
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=0),
                      precision=Precision.f32())
    grid = build_grid(basin, mk.frame_of_land_mask(24, 20),
                      precision=Precision.f32(), device="cpu")
    state = init_ocean_state(grid, cfg)

    m = OceanModel.__new__(OceanModel)
    m.state = state
    assert m.state_mu_const() == 0.0
    m.state = dataclasses.replace(
        state, mu=torch.full((24, 20), 7.5, dtype=torch.float32))
    assert m.state_mu_const() == 7.5
    varying = torch.zeros((24, 20), dtype=torch.float32)
    varying[5, 5] = 1.0
    m.state = dataclasses.replace(state, mu=varying)
    assert m.state_mu_const() is None

    fm = FusedSWModel(grid, cfg, 1.0, mu_const=0.0)
    fm.pack(state)
    bad = dataclasses.replace(
        state, mu=torch.full((24, 20), 3.0, dtype=torch.float32))
    with pytest.raises(ValueError, match="mu"):
        fm.pack(bad)


# ---- tests/test_model_oracle.py: the composition vs the loop oracle -----

NX_O, NY_O = 20, 16
N_STEPS_O = 40
TAU_O = 10.0


@pytest.fixture(scope="module")
def oracle_setup():
    """A random masked 20 x 16 basin, f64, 2 tracers, a constant mu of 40
    and a random small f32 r_diss (the paths the init zeroes)."""
    rng = np.random.RandomState(3)
    int_mask = mk.frame_of_land_mask(NX_O, NY_O)
    interior = rng.rand(NX_O - 4, NY_O - 4) < 0.75
    int_mask[2:-2, 2:-2] = (~interior).astype(np.int32)
    basin = basinpar_flat(NX_O, NY_O)
    prec = Precision.f64()
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=1, tracer_num=2),
                      precision=prec)
    grid = build_grid(basin, int_mask, precision=prec, device="cpu")
    state = init_ocean_state(grid, cfg)
    rng = np.random.RandomState(11)
    state = dataclasses.replace(
        state, mu=torch.full((NX_O, NY_O), 40.0, dtype=torch.float64),
        r_diss=torch.from_numpy(
            np.abs(1e-6 * rng.randn(NX_O, NY_O)).astype(np.float32)))
    return grid, cfg, state


def _oracle_state(state, n_tracers):
    names = {"ssh": "ssh", "sshn": "sshn", "sshp": "sshp", "u": "ubrtr",
             "un": "ubrtrn", "up": "ubrtrp", "v": "vbrtr", "vn": "vbrtrn",
             "vp": "vbrtrp"}
    st = {k: _np(getattr(state, v)) for k, v in names.items()}
    for f in ("rhsx", "rhsy", "rhsx_adv", "rhsy_adv", "rhsx_dif",
              "rhsy_dif", "mu", "str_t", "str_s", "vort", "r_diss",
              "hhq", "hhq_p", "hhq_n", "hhu", "hhu_p", "hhu_n",
              "hhv", "hhv_p", "hhv_n", "hhh", "hhh_p", "hhh_n",
              "flux_x", "flux_y"):
        st[f] = _np(getattr(state, f))
    for f in ("ff", "ffp", "ffn"):
        st[f] = [_np(getattr(state, f)[k]) for k in range(n_tracers)]
    return st


def _oracle_grid(grid):
    masks = {k: _np(getattr(grid, k))
             for k in ("lu", "luu", "luh", "llu", "llv", "lcu", "lcv")}
    mets = {k: _np(getattr(grid, k))
            for k in ("dx", "dy", "dxt", "dyt", "dxh", "dyh",
                      "dxb", "dyb", "rlh_s")}
    return masks, mets


def _oracle_cfg(cfg):
    return {"ffs": cfg.sw.full_free_surface, "trans": cfg.sw.trans_terms,
            "ksw": cfg.sw.ksw_lat, "ts": cfg.sw.time_smooth,
            "tracer_num": cfg.sw.tracer_num}


def _run_both(grid, cfg, state, n):
    step = make_step(grid, cfg)
    masks, mets = _oracle_grid(grid)
    ost = _oracle_state(state, cfg.sw.tracer_num)
    ocfg = _oracle_cfg(cfg)
    h_r = _np(grid.hhq_rest)
    st, ok = state, True
    for _ in range(n):
        st, ok_k = step(st, TAU_O)
        ok = ok and bool(ok_k)
        ost = orc.o_model_step(ost, masks, mets, h_r, ocfg, TAU_O)
    return st, ok, ost


def test_whole_model_composition(oracle_setup):
    """40 steps of the port's eager step == 40 of the oracle's literal
    loops at the JAX test's rtol 3e-9, atol 1e-9 (per kernel 1e-12; the
    growth over coupled steps), on 15 fields; waves really move."""
    grid, cfg, state = oracle_setup
    st, ok, ost = _run_both(grid, cfg, state, N_STEPS_O)
    assert ok
    checks = [
        ("ssh", st.ssh, ost["ssh"]), ("sshp", st.sshp, ost["sshp"]),
        ("u", st.ubrtr, ost["u"]), ("up", st.ubrtrp, ost["up"]),
        ("v", st.vbrtr, ost["v"]), ("vp", st.vbrtrp, ost["vp"]),
        ("hhu", st.hhu, ost["hhu"]), ("hhv_p", st.hhv_p, ost["hhv_p"]),
        ("hhh", st.hhh, ost["hhh"]), ("vort", st.vort, ost["vort"]),
        ("str_t", st.str_t, ost["str_t"]),
        ("ff0", st.ff[0], ost["ff"][0]), ("ff1", st.ff[1], ost["ff"][1]),
        ("ffp1", st.ffp[1], ost["ffp"][1]),
        ("flux_x", st.flux_x, ost["flux_x"]),
    ]
    for name, got, want in checks:
        np.testing.assert_allclose(_np(got), want, rtol=3e-9, atol=1e-9,
                                   err_msg=f"field {name} diverged")
    assert np.abs(_np(st.ubrtr)).max() > 1e-6


def test_composition_mutation_is_caught(oracle_setup, monkeypatch):
    """The oracle is strong enough: dropping its stage 2 (hh_update) makes
    the two diverge above the pass tolerance within 8 steps."""
    grid, cfg, state = oracle_setup
    monkeypatch.setattr(orc, "o_hh_update", lambda *a: a[-4:])
    st, _, ost = _run_both(grid, cfg, state, 8)
    err = np.abs(_np(st.ubrtr) - ost["u"]).max()
    assert err > 1e-8, f"mutation not detected (err={err})"


# ---- tests/test_kernels_vs_oracle.py: each kernel vs its loop ----------

NX_K, NY_K = 23, 17


@pytest.fixture(scope="module")
def basin_fields():
    """The JAX test's random basin and fields (seed 7), as numpy."""
    rng = np.random.RandomState(7)
    int_mask = mk.frame_of_land_mask(NX_K, NY_K)
    interior = rng.rand(NX_K - 4, NY_K - 4) < 0.8
    int_mask[2:-2, 2:-2] = (~interior).astype(np.int32)
    lu = mk.lu_from_int_mask(int_mask)
    luh, luu, llu, llv, lcu, lcv = mk.derive_staggered_masks(lu)

    def metric():
        return (1000.0 + 100.0 * rng.rand(NX_K, NY_K)).astype(np.float32)

    def field():
        return rng.randn(NX_K, NY_K).astype(np.float64)

    def posfield():
        return (50.0 + 10.0 * rng.rand(NX_K, NY_K)).astype(np.float64)

    m = {k: metric() for k in
         ("dx", "dy", "dxt", "dyt", "dxh", "dyh", "dxb", "dyb")}
    m["rlh_s"] = (1e-4 * rng.randn(NX_K, NY_K)).astype(np.float32)
    m["rdis"] = np.abs(1e-5 * rng.randn(NX_K, NY_K)).astype(np.float32)
    f = {k: field() for k in
         ("ssh", "sshn", "sshp", "u", "un", "up", "v", "vn", "vp",
          "vort", "str_t", "str_s", "rhsx", "rhsy", "rhsx_adv", "rhsy_adv",
          "rhsx_dif", "rhsy_dif", "ff", "ffp", "ffn", "flux_x", "flux_y")}
    f["mu"] = np.abs(field()) * 100.0
    h = {k: posfield() for k in
         ("hhu", "hhun", "hhup", "hhv", "hhvn", "hhvp", "hhh", "hq", "h_r",
          "hhqn", "hhqp")}
    masks = dict(lu=lu, luh=luh, luu=luu, llu=llu, llv=llv, lcu=lcu,
                 lcv=lcv)
    return masks, m, f, h


def P(x):
    return pad(torch.from_numpy(np.asarray(x)))


def _update_ssh(masks, m, f, h, port):
    if port:
        return swk.update_ssh(1.0, P(masks["lu"]), P(m["dx"]), P(m["dy"]),
                              P(m["dxh"]), P(m["dyh"]), P(h["hhu"]),
                              P(h["hhv"]), P(f["sshn"]), P(f["sshp"]),
                              P(f["u"]), P(f["v"]))
    return orc.o_update_ssh(1.0, masks["lu"], m["dx"], m["dy"], m["dxh"],
                            m["dyh"], h["hhu"], h["hhv"], f["sshn"],
                            f["sshp"], f["u"], f["v"])


def _update_uv(masks, m, f, h, port):
    names = (("lcu", "lcv"), ("dxt", "dyt", "dxh", "dyh", "dxb", "dyb"),
             ("hhu", "hhun", "hhup", "hhv", "hhvn", "hhvp", "hhh"),
             ("ssh", "u", "un", "up", "v", "vn", "vp"), ("rdis", "rlh_s"),
             ("rhsx", "rhsy", "rhsx_adv", "rhsy_adv", "rhsx_dif",
              "rhsy_dif"))
    src = (masks, m, h, f, m, f)
    args = [d[k] for d, ks in zip(src, names) for k in ks]
    if port:
        return swk.update_uv(1.0, *[P(a) for a in args])
    return orc.o_update_uv(1.0, *args)


def _next_step(masks, m, f, h, port):
    args = [masks[k] for k in ("lu", "lcu", "lcv")] + [
        f[k] for k in ("ssh", "sshn", "sshp", "u", "un", "up", "v", "vn",
                       "vp")]
    if port:
        return swk.next_step(0.5, *[P(a) for a in args])
    return orc.o_next_step(0.5, *args)


def _vort(masks, m, f, h, port):
    args = [masks["luu"]] + [m[k] for k in ("dxt", "dyt", "dxb", "dyb")] \
        + [f[k] for k in ("u", "v", "vort")]
    if port:
        return swk.uv_trans_vort(*[P(a) for a in args])
    return orc.o_vort(*args)


def _uv_trans(masks, m, f, h, port):
    args = [masks[k] for k in ("lcu", "lcv", "luu")] \
        + [m["dxh"], m["dyh"], f["u"], f["v"], f["vort"], h["hq"],
           h["hhu"], h["hhv"], h["hhh"], f["rhsx_adv"], f["rhsy_adv"]]
    if port:
        return swk.uv_trans(*[P(a) for a in args])
    return orc.o_uv_trans(*args)


def _stress(masks, m, f, h, port):
    args = [masks["lu"], masks["luu"]] + [
        m[k] for k in ("dx", "dy", "dxt", "dyt", "dxh", "dyh", "dxb",
                       "dyb")] + [f[k] for k in ("up", "vp", "str_t",
                                                 "str_s")]
    if port:
        return swk.stress_components(*[P(a) for a in args])
    return orc.o_stress(*args)


def _uv_diff2(masks, m, f, h, port):
    args = [masks["lcu"], masks["lcv"]] + [
        m[k] for k in ("dx", "dy", "dxt", "dyt", "dxh", "dyh", "dxb",
                       "dyb")] + [f["mu"], f["str_t"], f["str_s"], h["hq"],
                                  h["hhu"], h["hhv"], h["hhh"],
                                  f["rhsx_dif"], f["rhsy_dif"]]
    if port:
        return swk.uv_diff2(*[P(a) for a in args])
    return orc.o_uv_diff2(*args)


def _hh_init(masks, m, f, h, port):
    args = [masks[k] for k in ("lu", "llu", "llv", "luh")] + [
        m[k] for k in ("dx", "dy", "dxt", "dyt", "dxh", "dyh", "dxb",
                       "dyb")] + [f["ssh"], f["sshp"], h["h_r"]]
    if port:
        return dk.hh_init(1, *[P(a) for a in args],
                          *[P(np.zeros((NX_K, NY_K))) for _ in range(9)])
    return orc.o_hh_init(1, *args)


def _tracer_fluxes(masks, m, f, h, port):
    if port:
        return trk.tran_diff_fluxes(
            P(masks["lcu"]), P(masks["lcv"]), P(m["dxt"]), P(m["dyt"]),
            P(m["dxh"]), P(m["dyh"]), P(h["hhu"]), P(h["hhv"]),
            P(f["ff"]), P(f["ffp"]), P(f["u"]), P(f["v"]), P(f["mu"]), 1.0,
            P(f["flux_x"]), P(f["flux_y"]))
    return orc.o_tracer_fluxes(masks["lcu"], masks["lcv"], m["dxt"],
                               m["dyt"], m["dxh"], m["dyh"], h["hhu"],
                               h["hhv"], f["ff"], f["u"], f["v"], f["mu"],
                               1.0, f["flux_x"], f["flux_y"])


def _tracer_update(masks, m, f, h, port):
    args = [masks["lu"], m["dx"], m["dy"], h["hhqn"], h["hhqp"],
            f["flux_x"], f["flux_y"], f["ffp"], f["ffn"]]
    if port:
        return trk.tran_diff_tracer(1.0, *[P(a) for a in args])
    return orc.o_tracer_update(1.0, *args)


# name -> (both sides, rtol, atol): the JAX test's tolerance for each
KERNELS = {
    "update_ssh": (_update_ssh, 1e-13, 1e-13),
    "update_uv": (_update_uv, 1e-12, 1e-12),
    "next_step": (_next_step, 1e-14, 0.0),
    "vort": (_vort, 1e-12, 1e-12),
    "uv_trans": (_uv_trans, 1e-12, 1e-12),
    "stress": (_stress, 1e-12, 1e-12),
    "uv_diff2": (_uv_diff2, 1e-11, 1e-11),
    "hh_init": (_hh_init, 1e-12, 1e-12),
    "tracer_fluxes": (_tracer_fluxes, 1e-12, 1e-12),
    "tracer_update": (_tracer_update, 1e-12, 1e-12),
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_matches_loop_oracle(basin_fields, name):
    """The port's eager kernel against the per-point loops of
    tests/oracle.py, f64, on the JAX test's random basin and fields."""
    both, rtol, atol = KERNELS[name]
    got = both(*basin_fields, port=True)
    want = both(*basin_fields, port=False)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(_np(g), w, rtol=rtol, atol=atol,
                                   err_msg=f"{name} output {i}")
    assert any(np.abs(w).max() > 0 for w in want)
