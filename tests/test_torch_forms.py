"""The fused step's forms without momentum advection (``trans_terms = 0``)
and with a linear free surface (``full_free_surface = 0``) on the CPU,
where ``fused_sw_step`` runs its plain PyTorch version: through
``FusedSWModel`` against the JAX fused kernel in interpret mode and the
JAX ``make_step``, the port's f64 eager composition against the JAX one,
the bipolar grid's plane-metric form, the raw form on a 2 x 2 split
against the single block, and the shipped run directories that use these
forms through ``main``. The CUDA kernel itself is compared with the plain
version on the card by chip_smoke.py."""

import dataclasses
import functools
import os
import shutil

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

from ocean_model_arch_torch.__main__ import main
from ocean_model_arch_torch.model.fused import FusedSWModel, unsupported
from ocean_model_arch_torch.model.fused_sharded2d import FusedSharded2DModel
from ocean_model_arch_torch.model.step import make_step, run_steps
from ocean_model_arch_torch.ops import fused_layout as fl
from ocean_model_arch_torch.ops import fused_step as fstep

from test_torch_step import TIGHT, TRACER_STATE, to_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX, NY, STEPS = 70, 52, 30
SW = ("ssh", "sshp", "ubrtr", "ubrtrp", "vbrtr", "vbrtrp")
# (trans_terms, full_free_surface): the forms this file holds
FORMS = [(0, 1), (1, 0), (0, 0)]
FORM_IDS = ["notrans", "linear", "notrans_linear"]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@functools.lru_cache(maxsize=None)
def _case(precision, trans, ffs, tracers, curve_grid=1, strip=False):
    """(jgrid, cfg, jstate): the island basin of tests/test_fused.py at
    70 x 52 with the form's switches; ``strip``: rows 40-63 land as well,
    so whole tiles hold no wet cell."""
    prec = getattr(Precision, precision)()
    basin = basinpar_flat(NX, NY, curve_grid=curve_grid, rlon=27.5,
                          rlat=41.0)
    cfg = ModelConfig(basin=basin, sw=SWConfig(
        full_free_surface=ffs, trans_terms=trans,
        use_tracers=int(tracers > 0), tracer_num=max(tracers, 1)),
        precision=prec)
    mask = frame_of_land_mask(NX, NY)
    rng = np.random.RandomState(3)
    mask[2:-2, 2:-2] |= (rng.rand(NX - 4, NY - 4) < 0.15).astype(np.int32)
    if strip:
        mask[40:64, :] = 1
    jgrid = jax_build_grid(basin, mask, precision=prec)
    return jgrid, cfg, jax_init(jgrid, cfg)


def _names(tracers):
    return SW + (("ff", "ffp") if tracers else ())


@functools.lru_cache(maxsize=None)
def _jax_fused(trans, ffs, tracers, curve_grid=1, strip=False):
    """30 f32 steps of the JAX fused kernel in interpret mode."""
    jgrid, cfg, jstate = _case("f32", trans, ffs, tracers, curve_grid, strip)
    jf = JaxFused(jgrid, cfg, 1.0, tx=8, interpret=True, static_rslu=True,
                  steps_per_call=2, elide_sel=False, q4=False)
    assert jf.fast2d == (curve_grid == 2)
    j, jok = jax.jit(lambda s: jf.run_steps(s, STEPS))(jf.pack(jstate))
    assert bool(jok)
    return jf.unpack(j, jstate)


def _port_fused(trans, ffs, tracers, curve_grid=1, strip=False, **kw):
    """The port's FusedSWModel on the same inputs, 30 steps: (model, the
    carried fields, the unpacked state)."""
    jgrid, cfg, jstate = _case("f32", trans, ffs, tracers, curve_grid, strip)
    grid, state = to_torch(jgrid, jstate, torch.float32)
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True, steps_per_call=2,
                      **kw)
    assert (fm.trans, fm.ffs) == (trans, ffs)
    s, ok = fm.run_steps(fm.pack(state), STEPS)
    assert ok
    return fm, s, fm.unpack(s, state)


@pytest.mark.parametrize("tracers", [0, 2])
@pytest.mark.parametrize("trans,ffs", FORMS, ids=FORM_IDS)
def test_fused_matches_jax_kernel(trans, ffs, tracers):
    """30 f32 steps against the JAX fused kernel in interpret mode (fast
    form, tx = 8, without the q4 / elide_sel folds): < 1e-5 relative per
    field, < 2e-5 with tracers. With tracers the case holds an all-land
    strip and the port runs guarded."""
    strip = tracers > 0
    want = _jax_fused(trans, ffs, tracers, strip=strip)
    fm, _, got = _port_fused(trans, ffs, tracers, strip=strip,
                             tile_guard=strip)
    assert fm.tile_guard == strip and (fm.n_tiles[1] > 0) == strip
    tol = 2e-5 if tracers else 1e-5
    for n in _names(tracers):
        assert _rel(getattr(got, n).numpy(), getattr(want, n)) < tol, n
    if not ffs:
        # a linear free surface: the depths stay what init made them
        start = _case("f32", trans, ffs, tracers, strip=strip)[2]
        for n in ("hhq", "hhu", "hhv", "hhh"):
            np.testing.assert_array_equal(getattr(got, n).numpy(),
                                          np.asarray(getattr(start, n)))


@pytest.mark.parametrize("tracers", [0, 2])
@pytest.mark.parametrize("trans,ffs", FORMS, ids=FORM_IDS)
def test_fused_matches_jax_make_step_f32(trans, ffs, tracers):
    """The same 30 steps against the jitted JAX f32 composition (< 1e-5,
    < 2e-5 with tracers: the fused flux reassociates)."""
    jgrid, cfg, jstate = _case("f32", trans, ffs, tracers)
    want, jok = jax_run_steps(jax.jit(jax_make_step(jgrid, cfg)), jstate,
                              np.float32(1.0), STEPS)
    _, _, got = _port_fused(trans, ffs, tracers)
    assert bool(jok)
    tol = 2e-5 if tracers else 1e-5
    for n in _names(tracers):
        assert _rel(getattr(got, n).numpy(), getattr(want, n)) < tol, n


@pytest.mark.parametrize("tracers", [0, 2])
@pytest.mark.parametrize("trans,ffs", FORMS, ids=FORM_IDS)
def test_eager_matches_jax_f64(trans, ffs, tracers):
    """The port's f64 eager composition, 30 steps, against the JAX
    ``make_step`` at 1e-12 (the advection terms and the depth families
    included)."""
    jgrid, cfg, jstate = _case("f64", trans, ffs, tracers)
    grid, state = to_torch(jgrid, jstate, torch.float64)
    want, jok = jax_run_steps(jax.jit(jax_make_step(jgrid, cfg)), jstate,
                              1.0, STEPS)
    got, ok = run_steps(make_step(grid, cfg), state, 1.0, STEPS)
    assert ok and bool(jok)
    for n in TIGHT + (TRACER_STATE if tracers else ()):
        assert _rel(getattr(got, n).numpy(), getattr(want, n)) < 1e-12, n
    assert float(got.ubrtr.abs().max()) > 0


@pytest.mark.parametrize("trans,ffs", [(0, 1), (0, 0)],
                         ids=["notrans", "notrans_linear"])
def test_fast2d_notrans_matches_jax_fast2d(trans, ffs):
    """The bipolar grid without advection (the form of
    examples/06_bipolar): the plane-metric plain version streams 4 metric
    planes, and after 30 f32 steps it agrees with the JAX fast2d kernel
    in interpret mode at < 2e-5, guarded."""
    want = _jax_fused(trans, ffs, 0, curve_grid=2, strip=True)
    fm, _, got = _port_fused(trans, ffs, 0, curve_grid=2, strip=True,
                             tile_guard=True)
    assert fm.fast2d and fm.met_map == {9: 0, 10: 1, 11: 2, 21: 3}
    assert fm.met.shape[0] == 4
    for n in SW:
        assert _rel(getattr(got, n).numpy(), getattr(want, n)) < 2e-5, n


@pytest.mark.parametrize("trans", [0, 1])
@pytest.mark.parametrize("visc", [False, True])
@pytest.mark.parametrize("n_tracers", [0, 2])
def test_fast2d_met_rows_match_jax(trans, visc, n_tracers):
    """The JAX rows of ``fast2d_met_rows(trans, visc, n_tracers)`` less 14
    and 15 where only the TPU kernel's mask thresholds read them (no
    viscosity); without advection rows 16-18 go too."""
    theirs = set(jfsk.fast2d_met_rows(trans, visc, n_tracers))
    mine = fl.fast2d_met_rows(n_tracers, visc, trans)
    assert set(mine) == (theirs if visc else theirs - {14, 15})
    assert ({16, 17, 18} <= set(mine)) == bool(trans)
    assert set(mine) <= set(fstep.KERNEL_MET_ROWS)


@pytest.mark.parametrize("trans,ffs", FORMS, ids=FORM_IDS)
def test_raw_split_equals_single_block(trans, ffs):
    """The raw form's plain version on 2 x 2 shards, 2 tracers, 30 steps:
    all 10 fields equal the single block's bit for bit."""
    jgrid, cfg, jstate = _case("f32", trans, ffs, 2)
    grid, state = to_torch(jgrid, jstate, torch.float32)
    fs = FusedSharded2DModel(grid, cfg, 1.0, 2, 2)
    assert (fs.trans, fs.ffs) == (trans, ffs)
    carry, ok = fs.make_runner(STEPS)(fs.pack(state))
    assert ok
    # the block at the shards' folds (elide_sel and q4; share_prev regroups
    # the chained block's second step)
    _, block, _ = _port_fused(trans, ffs, 2, share_prev=False)
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True)
    for a, b in zip(fs.extract(carry), block):
        assert torch.equal(a, fl.extract(fm.lay, b))


@pytest.mark.parametrize("trans,ffs", FORMS, ids=FORM_IDS)
def test_land_stays_exactly_zero(trans, ffs):
    """Every land cell of the 6 + 2 T carried fields, margins included,
    is exactly 0 after 30 steps, and every field moved somewhere."""
    fm, s, _ = _port_fused(trans, ffs, 2, strip=True)
    wlcu, wlcv, wlu = fl.staggered_wet_masks(fl.embed(fm.lay, fm.grid.lu))
    for f, w in zip(s, (wlu, wlu, wlcu, wlcu, wlcv, wlcv) + (wlu,) * 4):
        land = torch.from_numpy(w) < 0.5
        assert bool((f[land] == 0).all())
        assert bool((f[~land] != 0).any())


def test_unsupported_no_longer_names_the_forms():
    """Neither switch keeps a configuration off the kernel, and neither
    does a count of tracers."""
    jgrid, cfg, jstate = _case("f32", 0, 0, 0)
    grid, _ = to_torch(jgrid, jstate, torch.float32)
    assert unsupported(grid, cfg) == []
    three = dataclasses.replace(cfg, sw=dataclasses.replace(
        cfg.sw, use_tracers=1, tracer_num=3))
    assert unsupported(grid, three) == []


@pytest.mark.parametrize("example,nx,ny", [("01_flat_basin", 258, 258),
                                           ("06_bipolar", 130, 120)])
def test_shipped_examples_take_the_kernel(tmp_path, capsys, example, nx,
                                          ny):
    """``main([dir, "--device", "cpu", "--f32"])`` on a copy of each
    shipped run directory with ``trans_terms = 0`` (cut to 12 steps):
    the route is the fused kernel, as under JAX, and its GrADS records
    are finite."""
    from ocean_model_arch_torch.io import grads
    d = str(tmp_path / example)
    shutil.copytree(os.path.join(REPO, "examples", example), d)
    par = os.path.join(d, "ocean_run.par")
    text = open(par).read()
    assert "0.007   : duration days" in text
    open(par, "w").write(text.replace("0.007   : duration days",
                                      "0.000139 : duration days"))
    assert "0       : trans terms" in open(os.path.join(d, "sw.par")).read()
    assert main([d, "--device", "cpu", "--f32"]) == 0
    out = capsys.readouterr().out
    assert "MODEL: compute path: fused CUDA kernel\n" in out
    ssh = grads.read_record(os.path.join(d, "RESULTS", "ssh.dat"), 2,
                            nx - 4, ny - 4)
    assert np.isfinite(ssh).all() and 0 < np.abs(ssh).max() < 1.0
