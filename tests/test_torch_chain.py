"""The chained form of the fused step (two whole model steps a launch,
``steps_per_call = 2``, as the JAX ``OceanModel`` runs its windows) on
the CPU, where ``fused_sw_step`` runs its plain PyTorch version: through
``FusedSWModel`` against the JAX fused kernel in interpret mode, chained
against two single-step launches, ``FusedSharded2DModel`` against the
JAX sharded model and the single block (a dry-flagged shard tile whose
margin the next tile reads included), the exchange count, and
``OceanModel``'s choice of steps a launch per window against JAX
``OceanModel``. The CUDA kernel itself is compared with the plain
version on the card by chip_smoke.py (phase 11)."""

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

from ocean_model_arch_torch.config import Precision as PortPrecision
from ocean_model_arch_torch.io.mask_io import write_mask
from ocean_model_arch_torch.model import fused_sharded2d as fsd
from ocean_model_arch_torch.model.fused import FusedSWModel
from ocean_model_arch_torch.model.fused_sharded2d import FusedSharded2DModel
from ocean_model_arch_torch.model.model import OceanModel, load_config_dir
from ocean_model_arch_torch.ops import fused_layout as fl
from ocean_model_arch_torch.ops import fused_step as fstep
from ocean_model_arch_torch.ops import sw_kernels as swk

from test_torch_model import _run_dir
from test_torch_step import to_torch

torch.set_num_threads(1)

NX, NY, STEPS = 70, 52, 30
MU = 1000.0
SW = ("ssh", "sshp", "ubrtr", "ubrtrp", "vbrtr", "vbrtrp")
# name -> (tracers, curve_grid, mu, varying bathymetry, trans, ffs); every
# form runs on the island mask with an all-land strip, guarded
FORMS = {"T0": (0, 1, 0.0, False, 1, 1),
         "T2": (2, 1, 0.0, False, 1, 1),
         "fast2d": (0, 2, 0.0, False, 1, 1),
         "visc_bathy": (2, 1, MU, True, 1, 1),
         "notrans": (0, 1, 0.0, False, 0, 1),
         "linear": (2, 1, 0.0, False, 1, 0)}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _bathymetry():
    i = np.arange(NX, dtype=np.float64)[:, None]
    j = np.arange(NY, dtype=np.float64)[None, :]
    return (15.0 + 85.0 * np.sin(np.pi * i / (NX - 1))
            * np.sin(np.pi * j / (NY - 1))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(form, corner=False):
    """(jgrid, cfg, jstate, grid, state) of one form: the island basin of
    tests/test_torch_forms.py at 70 x 52 with rows 40-63 all land, so
    whole tiles hold no wet cell. ``corner``: the mask of
    :func:`test_dry_tile_margin_read_by_its_wet_neighbour` instead."""
    tracers, curve, mu, hr_varies, trans, ffs = FORMS[form]
    prec = Precision.f32()
    basin = basinpar_flat(NX, NY, curve_grid=curve, rlon=27.5, rlat=41.0)
    cfg = ModelConfig(basin=basin, sw=SWConfig(
        use_tracers=int(tracers > 0), tracer_num=max(tracers, 1),
        trans_terms=trans, full_free_surface=ffs), precision=prec)
    mask = frame_of_land_mask(NX, NY)
    rng = np.random.RandomState(3)
    mask[2:-2, 2:-2] |= (rng.rand(NX - 4, NY - 4) < 0.15).astype(np.int32)
    if corner:
        mask[35:43, :24] = 1         # shard (1, 0)'s first tile: all land
        mask[27:35, 18:28] = 0       # wet in its margin, beside
        mask[35:43, 24:28] = 0       # the wet first cells of the next tile
    else:
        mask[40:64, :] = 1
    jgrid = jax_build_grid(basin, mask,
                           hhq_rest=_bathymetry() if hr_varies else None,
                           precision=prec)
    jstate = jax_init(jgrid, cfg)
    if mu:
        jstate = dataclasses.replace(
            jstate, mu=jax.numpy.full_like(jstate.mu, mu))
    grid, state = to_torch(jgrid, jstate, torch.float32)
    return jgrid, cfg, jstate, grid, state


def _names(form):
    return SW + (("ff", "ffp") if FORMS[form][0] else ())


@functools.lru_cache(maxsize=None)
def _jax_fused(form, share_prev):
    """30 f32 steps of the JAX chained kernel in interpret mode (fast
    form, tx = 8, without the q4 / elide_sel folds)."""
    jgrid, cfg, jstate, _, _ = _case(form)
    jf = JaxFused(jgrid, cfg, 1.0, tx=8, interpret=True, static_rslu=True,
                  mu_const=FORMS[form][2], steps_per_call=2,
                  elide_sel=False, q4=False, share_prev=share_prev)
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
    assert fm.n_tiles[1] > 0 and fm.steps_per_call == spc
    s, ok = fm.run_steps(fm.pack(state), STEPS)
    assert ok
    return fm, s, fm.unpack(s, state)


@pytest.mark.parametrize("share_prev", [False, None],
                         ids=["share_prev_off", "share_prev_default"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_chained_matches_jax_kernel(form, share_prev):
    """``FusedSWModel(steps_per_call=2)``, 30 steps in 15 chained plain
    launches, against the JAX chained kernel in interpret mode, with and
    without its ``share_prev`` fold: < 1e-5 relative per field, < 2e-5
    with tracers (the fused flux reassociates)."""
    want = _jax_fused(form, share_prev)
    _, _, got = _port_fused(form, 2)
    tol = 2e-5 if FORMS[form][0] else 1e-5
    for n in _names(form):
        assert _rel(getattr(got, n).numpy(), getattr(want, n)) < tol, n


@pytest.mark.parametrize("form", sorted(FORMS))
def test_chained_equals_two_single_launches(form):
    """On the single block the chained plain version is the single step
    twice: 15 chained launches == 30 single ones, bit for bit, and one
    chained launch's max is the larger of the two steps' maxima."""
    fm2, s2, _ = _port_fused(form, 2)
    fm1, s1, _ = _port_fused(form, 1)
    assert all(torch.equal(a, b) for a, b in zip(s2, s1))
    assert fm2.tile == fm1.tile == fstep.CPU_TILE
    args = (fm1.met, fm1.planes, fm1.lay, 1.0, fm1.cfg.sw.time_smooth,
            fm1.hr_const, fm1.tile_wet, fm1.tile, fm1.met_map, fm1.mu_const,
            fm1.visc, fm1.trans, fm1.ffs)
    a, ma = fstep.fused_sw_step_reference(s1, *args)
    b, mb = fstep.fused_sw_step_reference(a, *args)
    c, mc = fstep.fused_sw_step_reference(s1, *args, steps=2)
    assert all(torch.equal(x, y) for x, y in zip(b, c))
    assert float(mc) == max(float(ma), float(mb))


def test_chained_land_stays_exactly_zero():
    """Every land cell of the 10 carried fields, margins included, is
    exactly 0 after 15 chained launches; the 4-cell margin of the single
    block suffices for two steps (land keeps its input, 0)."""
    fm, s, _ = _port_fused("visc_bathy", 2)
    assert fm.lay.margin == fl.MARGIN == 4
    wlcu, wlcv, wlu = fl.staggered_wet_masks(fl.embed(fm.lay, fm.grid.lu))
    for f, w in zip(s, (wlu, wlu, wlcu, wlcu, wlcv, wlcv) + (wlu,) * 4):
        land = torch.from_numpy(w) < 0.5
        assert bool((f[land] == 0).all())
        assert bool((f[~land] != 0).any())


@pytest.mark.parametrize("form", ["T2", "fast2d"])
def test_sharded_chain_matches_jax_and_the_block(form):
    """``FusedSharded2DModel(2, 2, steps_per_call=2)``: margins of 6 (8
    with tracers), 30 steps in 15 exchanges; against the JAX sharded
    model at the same steps a call (interpret mode, < 1e-5, 2e-5 with
    tracers) and equal to the port's chained single block bit for
    bit."""
    jgrid, cfg, jstate, grid, state = _case(form)
    jm = JaxSharded(jgrid, cfg, 1.0, 2, 2, tx=8, interpret=True,
                    steps_per_call=2)
    jc, jok = jm.make_runner(STEPS)(jm.pack(jstate))
    # the folds of the block it equals (none; JAX's are its defaults)
    fs = FusedSharded2DModel(grid, cfg, 1.0, 2, 2, steps_per_call=2,
                             elide_sel=False, q4=False, share_prev=False)
    assert fs.M == fl.margin_for(2, FORMS[form][0]) == (8 if FORMS[form][0]
                                                        else 6)
    c, ok = fs.make_runner(STEPS)(fs.pack(state))
    assert ok and bool(jok)
    got = fs.extract(c)
    tol = 2e-5 if FORMS[form][0] else 1e-5
    for n, a, b in zip(_names(form), got, jm.extract(jc)):
        assert _rel(a.numpy(), np.asarray(b)) < tol, n
    fm, s, _ = _port_fused(form, 2)
    for n, a, b in zip(_names(form), got, s):
        assert torch.equal(a, fl.extract(fm.lay, b)), n


def test_dry_tile_margin_read_by_its_wet_neighbour():
    """The corner where a chained raw launch must not apply the guard to
    its first step: shard (1, 0) of a 2 x 2 split at x 35, y 40 (2
    tracers, margin 8) has its first tile flagged dry (its box cells are
    land) while that tile's margin rows hold the neighbour shard's wet
    cells; the next tile's box cell (M, 32) reads the first step at
    (M - 1, 31) there (the tracer pass's transport at (M - 1, 32) takes
    the Coriolis term of (M - 1, 31)). The shards equal the single block
    bit for bit; zeroing the first step's dry-flagged tiles, as a guard
    on both steps would, gives another result."""
    _, cfg, _, grid, state = _case("T2", corner=True)
    fs = FusedSharded2DModel(grid, cfg, 1.0, 2, 2, steps_per_call=2,
                             x_edges=[0, 35, 70], y_edges=[0, 40, 52])
    M, (tx, ty) = fs.M, fs.tile
    assert (M, tx, ty) == (8, 16, 32)
    flags = fs.tile_wet[1][0]
    assert int(flags[0, 0]) == 0 and int(flags[0, 1]) == 1
    lu = fs.lu_shards[1][0]
    assert lu[:M, :ty].any() and lu[M:tx, M:ty].sum() == 0
    assert lu[M - 1, ty - 1] > 0.5 and lu[M, ty] > 0.5
    c, ok = fs.make_runner(STEPS)(fs.pack(state))
    fm = FusedSWModel(grid, cfg, 1.0, steps_per_call=2, static_rslu=True)
    s, ok1 = fm.run_steps(fm.pack(state), STEPS)
    assert ok and ok1
    for a, b in zip(fs.extract(c), s):
        assert torch.equal(a, fl.extract(fm.lay, b))
    # from step 10: the first step's state in that margin is wet and not
    # zero (a guard on the first step would zero it), and the second
    # step's box reads it: more v there moves the tracer at (M, 32)
    carry, _ = fs.make_runner(10)(fs.pack(state))
    carry = list(carry)
    fs.exchange(carry)
    args = (fs.met_shards[1][0], fs.plane_shards[1][0], fs.shard_lay[1][0],
            1.0, cfg.sw.time_smooth, fs.hr_const, flags, fs.tile,
            fs.met_map, 0.0, False, 1, 1)
    f = carry[2].unbind(0)
    chained = tuple(torch.zeros_like(a) for a in f)
    fstep.fused_sw_step_raw(f, chained, torch.zeros(flags.shape), *args, 2)
    first, _ = fstep.fused_sw_step_reference(f, *args[:6], None, *args[7:])
    guarded, _ = fstep.fused_sw_step_reference(f, *args)
    assert float(first[0][M - 1, ty - 1]) != 0.0
    assert float(guarded[0][M - 1, ty - 1]) == 0.0

    def second(a):
        out = tuple(torch.zeros_like(x) for x in a)
        fstep.fused_sw_step_raw(a, out, torch.zeros(flags.shape), *args)
        return out
    assert all(torch.equal(a, b) for a, b in zip(second(first), chained))
    more = [a.clone() for a in first]
    more[4][M - 1, ty - 1] += 1.0e3
    assert float(second(more)[6][M, ty]) != float(chained[6][M, ty])


def test_exchanges_halve_when_chained():
    """One margin exchange a launch: per model step, 2 x 2 shards make 8
    strip copies at one step a launch and 4 at two, as the JAX sharded
    model's collectives halve (tests/test_fused_sharded2d.py::
    test_fused_sharded_collective_schedule)."""
    _, cfg, _, grid, state = _case("T0")
    per_step = {}
    for spc in (1, 2):
        fs = FusedSharded2DModel(grid, cfg, 1.0, 2, 2, steps_per_call=spc)
        assert len(fs._plan) == 8
        fs.make_runner(8)(fs.pack(state))
        per_step[spc] = fs.strip_copies / 8
    assert per_step == {1: 8.0, 2: 4.0}
    with pytest.raises(ValueError, match="multiple"):
        FusedSharded2DModel(grid, cfg, 1.0, 2, 2, steps_per_call=2) \
            .make_runner(7)
    with pytest.raises(ValueError, match="1 or 2"):
        FusedSWModel(grid, cfg, 1.0, steps_per_call=3, static_rslu=True)


def test_guard_sees_the_first_step_of_a_launch():
    """``ok`` covers both steps of a chained launch: an sshp spike of 1.5e4
    at a wet cell puts |ssh| above the 1e4 bound after the first step
    and below it after the second (the filter halves it), and the
    chained ``run_steps`` trips; so does a NaN there."""
    _, cfg, _, grid, state = _case("T2")
    fm2 = FusedSWModel(grid, cfg, 1.0, steps_per_call=2, static_rslu=True)
    fm1 = FusedSWModel(grid, cfg, 1.0, steps_per_call=1, static_rslu=True)
    wet = torch.nonzero(grid.lu > 0.5)[100]
    cell = (fl.MARGIN + int(wet[0]), fl.MARGIN + int(wet[1]))
    for val in (1.5e4, float("nan")):
        bad = [f.clone() for f in fm2.pack(state)]
        bad[1][cell] = val
        a, ok_a = fm1.run_steps(tuple(bad), 1)
        _, ok_b = fm1.run_steps(a, 1)
        if val == val:
            assert not ok_a and ok_b
            assert float(a[0].abs().max()) > swk.SSH_ERR_BOUND
        _, ok = fm2.run_steps(tuple(bad), 2)
        assert not ok


def _windows(tmp_path, name, n_total, n_out, mesh=(1, 1), mod=0):
    """A 40 x 30 basin with a tracer (the run directory of
    tests/test_torch_model.py; with ``mod`` = 1, weighted cuts, land in
    its low corner), f32, ``n_total`` steps in windows of ``n_out``:
    (port config, JAX config, directory)."""
    mask = "none"
    if mod:
        land = frame_of_land_mask(40, 30)
        land[:16, :12] = 1
        mask = str(tmp_path / "corner.txt")
        write_mask(mask, land, "land in the low corner")
    d = _run_dir(tmp_path / name, mask, 40, 30, mod_decomposition=mod)
    cfg, jcfg = load_config_dir(d), jax_load_config_dir(d)
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
    assert cfg.run.num_step_max == n_total
    assert cfg.run.output_every_steps == n_out
    return cfg, jcfg, d


@pytest.mark.parametrize("n_total,n_out,spcs",
                         [(10, 4, [2, 2, 2]), (13, 5, [1, 1, 1])])
def test_ocean_model_chains_even_windows(tmp_path, monkeypatch, n_total,
                                         n_out, spcs):
    """``OceanModel`` runs an even window at two steps a launch and an odd
    one at one, as JAX ``OceanModel`` does (windows 4, 4, 2 of a 10-step
    run; 5, 5, 3 of 13), and its final state equals JAX ``OceanModel.run``
    (on the CPU the JAX package runs its composition) within 3e-4."""
    cfg, jcfg, d = _windows(tmp_path, "run", n_total, n_out)
    seen = []
    run_steps = FusedSWModel.run_steps

    def spy(self, s6, n_steps):
        seen.append((n_steps, self.steps_per_call))
        return run_steps(self, s6, n_steps)
    monkeypatch.setattr(FusedSWModel, "run_steps", spy)
    model = OceanModel(cfg, base_dir=d, device="cpu")
    assert model.compute_path() == "fused CUDA kernel"
    got = model.run(verbose=False)
    n_last = n_total - n_out * (len(spcs) - 1)
    assert seen == list(zip([n_out] * (len(spcs) - 1) + [n_last], spcs))
    want = JaxOceanModel(jcfg, base_dir=d).run(verbose=False)
    for n in ("ssh", "ubrtr", "vbrtr", "ff"):
        assert _rel(getattr(got, n).numpy(), getattr(want, n)) < 3e-4, n


def test_sharded_rebuild_keeps_the_cut_lines(tmp_path, monkeypatch):
    """On a 2 x 2 mesh with weighted cuts, windows of 4, 4, 4 and 1 (13
    steps, a tracer): three chained windows on margins of 8, then a
    rebuild at one step a launch (margin 4) on the same cut lines; the
    result equals the single block's run of the same windows bit for
    bit."""
    cfg, _, d = _windows(tmp_path, "mesh", 13, 4, mesh=(2, 2), mod=1)
    built = []
    orig = fsd.FusedSharded2DModel.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        built.append((self.steps_per_call, self.M, self.x_edges.tolist(),
                      self.y_edges.tolist()))
    monkeypatch.setattr(fsd.FusedSharded2DModel, "__init__", spy)
    model = OceanModel(cfg, base_dir=d, device="cpu")
    assert model.compute_path() == "fused CUDA kernel, sharded"
    got = model.run(verbose=False)
    assert [b[:2] for b in built] == [(2, 8), (1, 4)]
    assert built[0][2:] == built[1][2:]
    assert built[0][2] != [0, 20, 40]          # weighted, not uniform
    one = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, mesh_x=1, mesh_y=1))
    want = OceanModel(one, base_dir=d, device="cpu").run(verbose=False)
    for n in SW + ("ff",):
        assert torch.equal(getattr(got, n), getattr(want, n)), n
