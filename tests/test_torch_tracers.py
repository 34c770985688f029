"""The fused step at any tracer count (three and more) on the CPU, where
``fused_sw_step`` runs its plain PyTorch version: ``FusedSWModel`` at T =
3 and 4 against the JAX fused kernel in interpret mode at one step and
two chained steps a call, the eager composition against the un-jitted
JAX step, ``FusedSharded2DModel`` against the JAX sharded model and the
single block, ``OceanModel``'s route and result against JAX
``OceanModel``, the order of the tracers, and the stacked copy step. The
CUDA kernels (the run-time tracer family of csrc/fused_step.cu, the
stacked copy step) are held against these plain versions on the card by
chip_smoke.py (phase 12)."""

import dataclasses
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
from ocean_model_arch_tpu.model.fused_sharded2d import \
    FusedSharded2DModel as JaxSharded
from ocean_model_arch_tpu.model.init import init_ocean_state as jax_init
from ocean_model_arch_tpu.model.model import OceanModel as JaxOceanModel
from ocean_model_arch_tpu.model.model import \
    load_config_dir as jax_load_config_dir
from ocean_model_arch_tpu.model.step import make_step as jax_make_step
from ocean_model_arch_tpu.model.step import run_steps as jax_run_steps

from ocean_model_arch_torch.config import Precision as PortPrecision
from ocean_model_arch_torch.model.fused import (FusedSWModel,
                                                fused_available,
                                                unsupported)
from ocean_model_arch_torch.model.fused_sharded2d import FusedSharded2DModel
from ocean_model_arch_torch.model.model import OceanModel, load_config_dir
from ocean_model_arch_torch.model.step import make_step, run_steps
from ocean_model_arch_torch.ops import copy_step as cstep
from ocean_model_arch_torch.ops import fused_layout as fl
from ocean_model_arch_torch.ops import fused_step as fstep

from test_torch_chain import _bathymetry, _rel
from test_torch_model import _run_dir
from test_torch_step import TIGHT, TRACER_STATE, to_torch

torch.set_num_threads(1)

NX, NY, STEPS = 70, 52, 30
MU = 1000.0
SW = ("ssh", "sshp", "ubrtr", "ubrtrp", "vbrtr", "vbrtrp")
# name -> (tracers, curve_grid, mu, varying bathymetry, trans, ffs); every
# form runs on the island mask with an all-land strip, guarded
FORMS = {"T3": (3, 1, 0.0, False, 1, 1),
         "T3_fast2d": (3, 2, 0.0, False, 1, 1),
         "T3_visc_bathy": (3, 1, MU, True, 1, 1),
         "T3_notrans": (3, 1, 0.0, False, 0, 1),
         "T4_linear": (4, 1, 0.0, False, 1, 0)}
# < 2e-5 relative per field after 30 steps, as tests/test_torch_chain.py
# allows the tracer forms: the TPU kernel's fused tracer flux
# reassociates against the plain version's order
TOL_KERNEL = 2e-5


@functools.lru_cache(maxsize=None)
def _case(form, prec="f32"):
    """(jgrid, cfg, jstate, grid, state) of one form at 70 x 52: the
    island mask of tests/test_torch_chain.py with rows 40-63 all land, so
    whole tiles hold no wet cell; each tracer a bump of its own height,
    so that no two are alike."""
    tracers, curve, mu, hr_varies, trans, ffs = FORMS[form]
    precision = Precision.f32() if prec == "f32" else Precision.f64()
    basin = basinpar_flat(NX, NY, curve_grid=curve, rlon=27.5, rlat=41.0)
    cfg = ModelConfig(basin=basin, sw=SWConfig(
        use_tracers=1, tracer_num=tracers, trans_terms=trans,
        full_free_surface=ffs), precision=precision)
    mask = frame_of_land_mask(NX, NY)
    rng = np.random.RandomState(3)
    mask[2:-2, 2:-2] |= (rng.rand(NX - 4, NY - 4) < 0.15).astype(np.int32)
    mask[40:64, :] = 1
    jgrid = jax_build_grid(basin, mask,
                           hhq_rest=_bathymetry() if hr_varies else None,
                           precision=precision)
    jstate = jax_init(jgrid, cfg)
    scale = jax.numpy.asarray(1.0 + 0.25 * np.arange(tracers),
                              jstate.ff.dtype)[:, None, None]
    ff = jstate.ff * scale
    jstate = dataclasses.replace(jstate, ff=ff, ffp=ff, ffn=ff)
    if mu:
        jstate = dataclasses.replace(
            jstate, mu=jax.numpy.full_like(jstate.mu, mu))
    grid, state = to_torch(jgrid, jstate,
                           torch.float32 if prec == "f32" else torch.float64)
    return jgrid, cfg, jstate, grid, state


def _names(form):
    return SW + ("ff", "ffp")


@functools.lru_cache(maxsize=None)
def _jax_fused(form, spc):
    """30 f32 steps of the JAX kernel in interpret mode at ``spc`` steps a
    call (fast form, tx = 8, without the q4 / elide_sel / share_prev
    folds)."""
    jgrid, cfg, jstate, _, _ = _case(form)
    jf = JaxFused(jgrid, cfg, 1.0, tx=8, interpret=True, static_rslu=True,
                  mu_const=FORMS[form][2], steps_per_call=spc,
                  elide_sel=False, q4=False, share_prev=False)
    j, jok = jax.jit(lambda s: jf.run_steps(s, STEPS))(jf.pack(jstate))
    assert bool(jok)
    return jf.unpack(j, jstate)


@functools.lru_cache(maxsize=None)
def _port_fused(form, spc):
    """The port's ``FusedSWModel`` (guard on, the fast form without its
    folds, which tests/test_torch_folds.py holds) on the same inputs, 30
    steps: (model, carried fields, unpacked state)."""
    _, cfg, _, grid, state = _case(form)
    fm = FusedSWModel(grid, cfg, 1.0, mu_const=FORMS[form][2],
                      static_rslu=True, steps_per_call=spc, tile_guard=True,
                      elide_sel=False, q4=False, share_prev=False)
    assert fm.n_tiles[1] > 0 and fm.n_tracers == FORMS[form][0]
    s, ok = fm.run_steps(fm.pack(state), STEPS)
    assert ok and len(s) == 6 + 2 * fm.n_tracers
    return fm, s, fm.unpack(s, state)


def _args(fm):
    return (fm.met, fm.planes, fm.lay, 1.0, fm.cfg.sw.time_smooth,
            fm.hr_const, fm.tile_wet, fm.tile, fm.met_map, fm.mu_const,
            fm.visc, fm.trans, fm.ffs)


# ---- the plain version against the JAX kernel ------------------------------

@pytest.mark.parametrize("spc", [1, 2], ids=["one_step", "chained"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_fused_matches_jax_kernel(form, spc):
    """``FusedSWModel`` at T = 3 and 4, 30 steps at one step a call and at
    two chained, against the JAX kernel in interpret mode at the same
    steps a call: < 2e-5 relative per field (``TOL_KERNEL``), every
    tracer level included."""
    want = _jax_fused(form, spc)
    _, _, got = _port_fused(form, spc)
    for n in _names(form):
        a, b = getattr(got, n).numpy(), np.asarray(getattr(want, n))
        assert a.shape == b.shape, n
        assert _rel(a, b) < TOL_KERNEL, n
    # the tracers moved, and no two are alike
    assert not torch.equal(got.ff, _case(form)[4].ff)
    assert all(not torch.equal(got.ff[t], got.ff[0])
               for t in range(1, FORMS[form][0]))


@pytest.mark.parametrize("form", sorted(FORMS))
def test_chained_equals_two_single_launches(form):
    """At T >= 3 too, the chained plain version is the single step twice:
    15 chained launches == 30 single ones, bit for bit."""
    _, s2, _ = _port_fused(form, 2)
    _, s1, _ = _port_fused(form, 1)
    assert all(torch.equal(a, b) for a, b in zip(s2, s1))


def test_land_stays_exactly_zero_in_every_tracer():
    """Every land cell of all 6 + 2 T carried fields, margins included, is
    exactly 0 after 15 chained launches at T = 4."""
    fm, s, _ = _port_fused("T4_linear", 2)
    wlcu, wlcv, wlu = fl.staggered_wet_masks(fl.embed(fm.lay, fm.grid.lu))
    masks = (wlu, wlu, wlcu, wlcu, wlcv, wlcv) + (wlu,) * 8
    assert len(s) == len(masks) == 14
    for f, w in zip(s, masks):
        land = torch.from_numpy(w) < 0.5
        assert bool((f[land] == 0).all())
        assert bool((f[~land] != 0).any())


# ---- the eager composition -------------------------------------------------

@pytest.mark.parametrize("form", ["T3", "T3_visc_bathy"])
def test_eager_matches_jax_f64(form):
    """30 f64 steps of the port's ``make_step`` with 3 tracers against the
    un-jitted JAX ``make_step``: < 1e-12 relative, tracers included."""
    jgrid, cfg, jstate, grid, state = _case(form, "f64")
    got, ok = run_steps(make_step(grid, cfg), state, 1.0, STEPS)
    with jax.disable_jit():
        want, jok = jax_run_steps(jax_make_step(jgrid, cfg), jstate, 1.0,
                                  STEPS)
    assert ok and bool(jok)
    assert got.ff.shape == (3, NX, NY)
    for n in TIGHT + TRACER_STATE:
        assert _rel(getattr(got, n).numpy(), getattr(want, n)) < 1e-12, n


@pytest.mark.parametrize("spc", [1, 2], ids=["one_step", "chained"])
@pytest.mark.parametrize("form", ["T3", "T3_visc_bathy", "T4_linear"])
def test_fused_matches_port_eager(form, spc):
    """The port's fused path against its own eager composition in f32,
    30 steps: < 3e-4 relative (the golden f32 tolerance)."""
    _, cfg, _, grid, state = _case(form)
    want, ok = run_steps(make_step(grid, cfg), state, 1.0, STEPS)
    _, _, got = _port_fused(form, spc)
    assert ok
    for n in ("ssh", "ubrtr", "vbrtr", "ff", "ffp"):
        assert _rel(getattr(got, n).numpy(), getattr(want, n).numpy()) \
            < 3e-4, n


# ---- the tracers' order ----------------------------------------------------

@pytest.mark.parametrize("spc", [1, 2], ids=["one_step", "chained"])
def test_permuted_tracers_permute_the_outputs(spc):
    """The tracers of a launch are independent: feeding them in another
    order gives the same outputs in that order, bit for bit (a tracer
    group that read another's levels or planes would show here)."""
    fm, _, _ = _port_fused("T4_linear", spc)
    _, _, _, _, state = _case("T4_linear")
    s0 = fm.pack(state)
    perm = [2, 0, 3, 1]

    def permuted(fields):
        return tuple(fields[:6]) + tuple(
            f for t in perm for f in fields[6 + 2 * t:8 + 2 * t])

    a, ma = fstep.fused_sw_step(s0, *_args(fm), steps=spc)
    b, mb = fstep.fused_sw_step(permuted(s0), *_args(fm), steps=spc)
    assert all(torch.equal(x, y) for x, y in zip(permuted(a), b))
    assert float(ma) == float(mb)
    # and each tracer as the only one is the same tracer
    one = dataclasses.replace(fm.cfg, sw=dataclasses.replace(
        fm.cfg.sw, tracer_num=1))
    f1 = FusedSWModel(fm.grid, one, 1.0, steps_per_call=spc,
                      tile_guard=True, static_rslu=True, elide_sel=False,
                      q4=False, share_prev=False)
    for t in range(4):
        c, _ = fstep.fused_sw_step(s0[:6] + s0[6 + 2 * t:8 + 2 * t],
                                   *_args(f1), steps=spc)
        assert torch.equal(c[6], a[6 + 2 * t])
        assert torch.equal(c[7], a[7 + 2 * t])


# ---- the sharded model -----------------------------------------------------

@pytest.mark.parametrize("spc", [1, 2], ids=["one_step", "chained"])
def test_sharded_matches_jax_and_the_block(spc):
    """``FusedSharded2DModel(2, 2)`` at T = 3, 30 steps at one and at two
    steps an exchange (margins 4 and 8), against the JAX sharded model in
    interpret mode at the same steps a call (< 2e-5) and equal to the
    port's single block bit for bit."""
    jgrid, cfg, jstate, grid, state = _case("T3")
    jm = JaxSharded(jgrid, cfg, 1.0, 2, 2, tx=8, interpret=True,
                    steps_per_call=spc)
    jc, jok = jm.make_runner(STEPS)(jm.pack(jstate))
    # the folds of the block it equals (none; JAX's are its defaults)
    fs = FusedSharded2DModel(grid, cfg, 1.0, 2, 2, steps_per_call=spc,
                             elide_sel=False, q4=False, share_prev=False)
    assert fs.M == fl.margin_for(spc, 3) == 4 * spc
    assert fs.n_tracers == 3
    c, ok = fs.make_runner(STEPS)(fs.pack(state))
    assert ok and bool(jok)
    got = fs.extract(c)
    assert len(got) == 12
    for n, a, b in zip(_names("T3"), got, jm.extract(jc)):
        assert _rel(a.numpy(), np.asarray(b)) < TOL_KERNEL, n
    fm, s, _ = _port_fused("T3", spc)
    for n, a, b in zip(_names("T3"), got, s):
        assert torch.equal(a, fl.extract(fm.lay, b)), n


# ---- OceanModel ------------------------------------------------------------

def _tracer_run(tmp_path, name, mesh=(1, 1), n_total=10, n_out=4):
    """A 40 x 30 run directory (tests/test_torch_model.py's) with
    ``use_tracers = 1, tracer_num = 3``, f32, ``n_total`` steps in windows
    of ``n_out``: (port config, JAX config, directory)."""
    d = _run_dir(tmp_path / name, "none", 40, 30)
    sw = tmp_path / name / "sw.par"
    sw.write_text(sw.read_text().replace("1 : tracers\n1 :",
                                         "1 : tracers\n3 :"))
    cfg, jcfg = load_config_dir(d), jax_load_config_dir(d)
    assert cfg.sw.use_tracers == 1 and cfg.sw.tracer_num == 3
    assert jcfg.sw.tracer_num == 3
    run = dict(run_duration_days=n_total / 86400.0,
               loc_data_wr_period_min=n_out / 60.0)
    cfg = dataclasses.replace(
        cfg, precision=PortPrecision.f32(),
        run=dataclasses.replace(cfg.run, **run),
        parallel=dataclasses.replace(cfg.parallel, mesh_x=mesh[0],
                                     mesh_y=mesh[1]))
    jcfg = dataclasses.replace(
        jcfg, precision=Precision.f32(),
        run=dataclasses.replace(jcfg.run, **run))
    return cfg, jcfg, d


@pytest.mark.parametrize("mesh,path", [
    ((1, 1), "fused CUDA kernel"),
    ((2, 2), "fused CUDA kernel, sharded")], ids=["block", "mesh_2x2"])
def test_ocean_model_takes_the_kernel_with_three_tracers(tmp_path,
                                                         monkeypatch, mesh,
                                                         path):
    """With 3 tracers ``OceanModel`` takes the fused kernel, as JAX's
    does (on a 2 x 2 mesh its sharded form), chains its even windows (4,
    4, 2 of a 10-step run at two steps a launch), and its final state
    equals JAX ``OceanModel.run`` (its composition on the CPU) within
    3e-4."""
    cfg, jcfg, d = _tracer_run(tmp_path, "run", mesh)
    seen = []
    if mesh == (1, 1):
        run_steps_ = FusedSWModel.run_steps

        def spy(self, s6, n_steps):
            seen.append((n_steps, self.steps_per_call, self.n_tracers))
            return run_steps_(self, s6, n_steps)
        monkeypatch.setattr(FusedSWModel, "run_steps", spy)
    model = OceanModel(cfg, base_dir=d, device="cpu")
    assert model.compute_path() == path
    assert unsupported(model.grid, cfg) == []
    assert fused_available(model.grid, cfg)
    got = model.run(verbose=False)
    if mesh == (1, 1):
        assert seen == [(4, 2, 3), (4, 2, 3), (2, 2, 3)]
    else:
        assert model._fused_sh.steps_per_call == 2
        assert model._fused_sh.n_tracers == 3
    assert got.ff.shape == (3, 40, 30)
    want = JaxOceanModel(jcfg, base_dir=d).run(verbose=False)
    for n in ("ssh", "ubrtr", "vbrtr", "ff", "ffp"):
        assert _rel(getattr(got, n).numpy(), getattr(want, n)) < 3e-4, n


def test_mesh_equals_the_block_with_three_tracers(tmp_path):
    """The 2 x 2 mesh's run with 3 tracers equals the single block's bit
    for bit (13 steps: chained windows of 4, then one of 1)."""
    cfg, _, d = _tracer_run(tmp_path, "mesh", (2, 2), 13, 4)
    got = OceanModel(cfg, base_dir=d, device="cpu").run(verbose=False)
    one = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, mesh_x=1, mesh_y=1))
    want = OceanModel(one, base_dir=d, device="cpu").run(verbose=False)
    for n in SW + ("ff", "ffp"):
        assert torch.equal(getattr(got, n), getattr(want, n)), n


# ---- the kernel's family and the wrapper -----------------------------------

def test_every_count_from_three_shares_one_library():
    """Counts 0, 1, 2 keep their libraries; every count from 3 up is one
    family (``FUSED_NT=3``), raw or not, in each form."""
    assert fstep.LOOP_TRACERS == 3 == fstep.MAX_TRACERS + 1
    for n in (3, 4, 9, 40):
        assert fstep.library_target(n) == "fused_step@FUSED_NT=3"
        assert fstep.library_target(n, True, 0, 0, 2) == \
            "fused_step@FUSED_RAW_NT=3@FUSED_TRANS=0@FUSED_FFS=0@FUSED_STEPS=2"
    assert fstep.library_target(2) == "fused_step@FUSED_NT=2"
    targets = fstep.library_targets()
    assert len(targets) == len(set(targets)) == 64
    assert sum("NT=3" in t for t in targets) == 16


def test_cuda_tensors_with_many_tracers_go_to_the_kernel_or_raise():
    """Off the CPU a 4-tracer step is not refused for its count: the
    input checks (here on meta tensors, before any build or launch) raise
    for the device only."""
    _, cfg, _, grid, state = _case("T4_linear")
    fm = FusedSWModel(grid, cfg, 1.0, tile_guard=False, static_rslu=True)
    f = tuple(torch.empty((fm.lay.Xs, fm.lay.Ys), device="meta")
              for _ in range(14))
    with pytest.raises(ValueError, match="CUDA") as err:
        fstep.fused_sw_step(f, *_args(fm))
    assert "tracers" not in str(err.value)


# ---- K4, the stacked copy step ---------------------------------------------

@pytest.mark.parametrize("n_in,n_out,met2d", [(8, 6, False), (10, 6, False),
                                              (14, 10, True), (18, 14, False)])
def test_stacked_copy_step_equals_the_separate_one(n_in, n_out, met2d):
    """The stacked copy step's plain version: output o of one (n_in, Xs,
    Ys) input equals the separate copy step's on its planes exactly, at
    JAX's default 8 -> 6 and at the stream counts of the T = 0, 2, 4
    forms, guarded too."""
    lay = fl.make_layout(70, 52)
    rng = np.random.RandomState(n_in)
    stack = torch.from_numpy(rng.randn(n_in, lay.Xs, lay.Ys)
                             .astype(np.float32))
    met = torch.from_numpy(rng.randn(*((7, lay.Xs, lay.Ys) if met2d
                                       else (16, lay.Ys))).astype(np.float32))
    lu = np.ones((70, 52), np.float32)
    lu[40:64, :] = 0.0
    tile = cstep.tile_shape("cpu")
    flags = torch.from_numpy(fl.tile_wet(fl.embed(
        lay, torch.from_numpy(lu)).numpy(), lay, *tile))
    for tw in (None, flags):
        got = cstep.copy_step_stacked(stack, met, n_out, lay, tile_wet=tw,
                                      tile=tile)
        want = cstep.copy_step(tuple(stack.unbind(0)), met, n_out, lay,
                               tile_wet=tw, tile=tile)
        assert got.shape == (n_out, lay.Xs, lay.Ys)
        assert all(torch.equal(a, b) for a, b in zip(got.unbind(0), want))
    assert cstep.copy_step_stacked.launches == 0
    with pytest.raises(ValueError, match="stack"):
        cstep.copy_step_stacked(stack[:, :-1], met, n_out, lay)


def test_stacked_copy_step_matches_jax_interpret():
    """Against ``scripts/roofline_probe.py::build_copy_step_stacked`` in
    interpret mode (8 -> 6, tx = 8): the rows [M, M + X) it writes equal
    the port's stacked copy step on the same cells exactly (the JAX kernel
    adds its metric row times 0, the port none)."""
    import importlib.util
    import os
    from jax.experimental import pallas as pl
    from ocean_model_arch_tpu.ops.pallas import fused_step as jfsk
    spec = importlib.util.spec_from_file_location(
        "roofline_probe", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "scripts", "roofline_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    jlay = jfsk.make_layout(40, 30, 8)
    orig = pl.pallas_call
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        call = probe.build_copy_step_stacked(jlay, 8)
    finally:
        pl.pallas_call = orig
    rng = np.random.RandomState(4)
    s = rng.randn(8, jlay.Xs, jlay.Ys).astype(np.float32)
    met = np.ones((16, jlay.Ys), np.float32)
    (want,) = call(s, met)
    # the port's layout of the same basin is smaller (no 128-lane
    # padding): it takes the JAX arrays' leading part, cell for cell
    lay = fl.make_layout(40, 30)
    assert lay.Xs <= jlay.Xs and lay.Ys <= jlay.Ys
    got = cstep.copy_step_stacked(torch.from_numpy(np.ascontiguousarray(
        s[:, :lay.Xs, :lay.Ys])), None, 6, lay)
    M = jfsk.MARGIN
    rows = slice(M, min(M + jlay.X, lay.Xs))
    np.testing.assert_array_equal(got.numpy()[:, rows],
                                  np.asarray(want)[:, rows, :lay.Ys])
