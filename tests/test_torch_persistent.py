"""The persistent step (``FusedSWModel(persistent=True)``, one launch a
window) and its mechanism probe, the persistent walk, on the CPU, where
``fused_sw_persistent`` and ``persistent_walk`` run their plain PyTorch
versions: the port's persistent model against the JAX ``FusedSWModel(
persistent=True)`` (``build_persistent_sw_step`` in interpret mode) in
the fast and the general form, against the port's own one-step windows
bit for bit, the guard on a blow-up inside the window, the metric planes
JAX refuses too; the walk's plain version against the JAX probe's
``build`` and ``build_fori`` in interpret mode bit for bit, its byte
count and build targets. The CUDA kernels themselves are held against
the plain versions on the card by chip_smoke.py (phase 14)."""

import dataclasses
import functools
import importlib.util
import os

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

from ocean_model_arch_torch.model.fused import FusedSWModel
from ocean_model_arch_torch.ops import fused_step as fstep
from ocean_model_arch_torch.ops import persistent_probe as pp

from test_torch_step import to_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX, NY, STEPS = 70, 52, 20
# the JAX test's own tolerance for the persistent kernel (tests/
# test_fused.py::test_persistent_megakernel_matches): f32 round-off of
# XLA's contractions against the port's plain formulas
TOL = 1e-5
FIELDS = ("ssh", "sshp", "ubrtr", "ubrtrp", "vbrtr", "vbrtrp")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@functools.lru_cache(maxsize=None)
def _case(tracers=0, curve_grid=1):
    """The basin of tests/test_fused.py::test_persistent_megakernel_matches
    (70 x 52, land frame, random islands from a numpy seed) with
    ``tracers`` tracers, in both packages' types: (jgrid, cfg, jstate,
    grid, state)."""
    prec = Precision.f32()
    basin = basinpar_flat(NX, NY, curve_grid=curve_grid, rlon=27.5,
                          rlat=41.0)
    cfg = ModelConfig(basin=basin, sw=SWConfig(
        use_tracers=int(tracers > 0), tracer_num=max(tracers, 1)),
        precision=prec)
    mask = frame_of_land_mask(NX, NY)
    rng = np.random.RandomState(3)
    mask[2:-2, 2:-2] |= (rng.rand(NX - 4, NY - 4) < 0.15).astype(np.int32)
    jgrid = jax_build_grid(basin, mask, precision=prec)
    jstate = jax_init(jgrid, cfg)
    grid, state = to_torch(jgrid, jstate, torch.float32)
    return jgrid, cfg, jstate, grid, state


def _names(tracers):
    return FIELDS + (("ff", "ffp") if tracers else ())


@pytest.mark.parametrize("static_rslu", [True, False])
@pytest.mark.parametrize("tracers", [0, 1, 3])
def test_persistent_matches_jax(tracers, static_rslu):
    """20 steps in one persistent window against the JAX persistent model
    (K2 in interpret mode, tx = 8): rel < 1e-5 per field, tracers
    included, in the fast (static_rslu) and the general form."""
    jgrid, cfg, jstate, grid, state = _case(tracers)
    jf = JaxFused(jgrid, cfg, 1.0, tx=8, interpret=True,
                  static_rslu=static_rslu, persistent=True)
    j, jok = jf.run_steps(jf.pack(jstate), STEPS)
    assert bool(jok)
    want = jf.unpack(j, jstate)
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=static_rslu,
                      persistent=True)
    assert fm.persistent and fm.general == (not static_rslu)
    fstep.reset_launch_counts()
    s, ok = fm.run_steps(fm.pack(state), STEPS)
    assert ok
    assert fstep.fused_sw_step.launches == 0
    assert fstep.fused_sw_persistent.launches == 0     # the plain version
    got = fm.unpack(s, state)
    for n in _names(tracers):
        rel = _rel(getattr(got, n), getattr(want, n))
        assert rel < TOL, (n, rel)


@pytest.mark.parametrize("static_rslu", [True, False])
@pytest.mark.parametrize("n_steps", [7, 8])
def test_persistent_equals_one_step_windows(n_steps, static_rslu):
    """The persistent route == ``run_steps`` at one step a launch, bit for
    bit on whole arrays (margins included), at odd and even window
    lengths; ``steps_per_call`` does not bind it."""
    _, cfg, _, grid, state = _case(2)
    one = FusedSWModel(grid, cfg, 1.0, static_rslu=static_rslu)
    per = FusedSWModel(grid, cfg, 1.0, static_rslu=static_rslu,
                       steps_per_call=2, persistent=True)
    s0 = one.pack(state)
    want, wok = one.run_steps(s0, n_steps)
    got, ok = per.run_steps(s0, n_steps)
    assert ok and wok and len(got) == len(want) == 10
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the wrapper itself: zero steps give the fields and a max of 0
    args = (per.met, per.planes, per.lay, per.tau, cfg.sw.time_smooth,
            per.hr_const, per.mu_const, per.visc, per.trans, per.ffs)
    f0, m0 = fstep.fused_sw_persistent(s0, *args, n_steps=0,
                                       general=per.general)
    assert all(a is b for a, b in zip(f0, s0)) and float(m0) == 0.0


@pytest.mark.parametrize("step", [0, 3, 6])
def test_guard_trips_inside_the_window(step, monkeypatch):
    """A NaN max at any one step of a 7-step window trips ``ok``, though
    the steps after it see sound fields: the max covers every step."""
    _, cfg, _, grid, state = _case(1)
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True, persistent=True)
    plain = fstep.fused_sw_step_reference
    calls = []

    def spiked(*a, **kw):
        out, mx = plain(*a, **kw)
        calls.append(1)
        return out, (torch.full_like(mx, float("nan"))
                     if len(calls) == step + 1 else mx)

    monkeypatch.setattr(fstep, "fused_sw_step_reference", spiked)
    _, ok = fm.run_steps(fm.pack(state), 7)
    assert len(calls) == 7 and not ok


def test_guard_trips_on_a_nan_state():
    """A NaN ssh at a wet cell, and an sshp spike past the bound, trip the
    persistent window's ``ok``."""
    _, cfg, _, grid, state = _case(0)
    fm = FusedSWModel(grid, cfg, 1.0, persistent=True)
    m = fm.lay.margin
    i, j = (int(v) for v in torch.nonzero(grid.lu > 0.5)[0])
    for field, val in ((0, float("nan")), (1, 2.0e4)):
        bad = list(fm.pack(state))
        bad[field] = bad[field].clone()
        bad[field][m + i, m + j] = val
        _, ok = fm.run_steps(tuple(bad), 3)
        assert not ok


def test_metric_planes_refused_as_in_jax():
    """Persistent mode takes x-uniform (profile) metrics only: on the
    bipolar grid both packages raise ValueError."""
    jgrid, cfg, _, grid, _ = _case(0, curve_grid=2)
    with pytest.raises(ValueError, match="persistent"):
        JaxFused(jgrid, cfg, 1.0, tx=8, interpret=True, static_rslu=True,
                 persistent=True)
    for static in (True, False):
        with pytest.raises(ValueError, match="persistent"):
            FusedSWModel(grid, cfg, 1.0, static_rslu=static, persistent=True)
    assert FusedSWModel(grid, cfg, 1.0).metrics_2d


def test_persistent_targets():
    """8 libraries of the persistent forms, fast and general at 0, 1, 2 and
    3+ tracers, apart from the one-step and chained ones."""
    targets = fstep.persist_targets()
    assert len(set(targets)) == 8
    assert all(t.endswith("@FUSED_PERSIST=1") for t in targets)
    assert not set(targets) & set(fstep.library_targets()
                                  + fstep.library_targets(general=True))
    assert fstep.persist_target(7, True) == \
        "fused_step@FUSED_NT=3@FUSED_GEN=1@FUSED_PERSIST=1"


# ---- the persistent walk (K5) ------------------------------------------

def _jax_probe(nx=64, ys=128, tx=16, m=8):
    """scripts/persistent_probe.py as a module, its extents set to a small
    case (its module globals; nothing of the JAX package changes)."""
    spec = importlib.util.spec_from_file_location(
        "persistent_probe", os.path.join(REPO, "scripts",
                                         "persistent_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.X, mod.YS, mod.TX, mod.M = nx, ys, tx, m
    mod.XS, mod.NT = nx + 2 * m, nx // tx
    return mod


def _seeded(rows, ys, seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(rows, ys) + 0.5).astype(np.float32)
            for _ in range(pp.N_FIELDS)]


@pytest.mark.parametrize("n_steps", [1, 5])
def test_walk_matches_jax_build_fori(n_steps):
    """The plain version == ``build_fori`` in interpret mode bit for bit:
    (XS, YS) in and out, the margins carried."""
    probe = _jax_probe()
    ins = _seeded(probe.XS, probe.YS, 5)
    want = probe.build_fori(n_steps, interpret=True)(*ins)
    got = pp.persistent_walk_reference(
        tuple(torch.from_numpy(a) for a in ins), n_steps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n_steps", [1, 5])
def test_walk_matches_jax_build(n_steps):
    """The plain version on zero margins == ``build`` in interpret mode
    (interior rows in and out) bit for bit."""
    probe = _jax_probe()
    ins = _seeded(probe.X, probe.YS, 6)
    want = probe.build(n_steps, interpret=True)(*ins)
    m = pp.MARGIN
    padded = tuple(torch.from_numpy(np.pad(a, ((m, m), (0, 0))))
                   for a in ins)
    got = pp.persistent_walk(padded, n_steps)      # CPU: the plain version
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[m:-m], np.asarray(w))
        assert not g[:m].any() and not g[-m:].any()


def test_walk_forms_on_the_cpu_and_bytes():
    """Every form of the wrapper takes CPU tensors to the plain version
    and launches nothing; the inputs stay as they were. A step moves
    85.4 MB at the TPU probe's extents (25.5 us at 3.35 TB/s)."""
    ins = tuple(torch.from_numpy(a) for a in _seeded(32 + 16, 40, 7))
    keep = tuple(f.clone() for f in ins)
    want = pp.persistent_walk_reference(ins, 3)
    pp.reset_launch_counts()
    for form in pp.FORMS:
        got = pp.persistent_walk(ins, 3, form)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert pp.persistent_walk.launches == 0
    assert not pp.persistent_walk.form_launches
    assert all(torch.equal(a, b) for a, b in zip(ins, keep))
    with pytest.raises(ValueError, match="form"):
        pp.persistent_walk(ins, 3, "inplace2")
    nbytes = pp.step_bytes(1536, 1152)
    assert nbytes == 6 * (1552 + 1536) * 1152 * 4
    assert round(nbytes / 1e6, 1) == 85.4
    assert round(nbytes / 3.35e12 * 1e6, 1) == 25.5
    assert pp.stash_floats(1536, 1152) == 2 * 6 * 24 * 8 * 1152


def test_walk_one_step_by_hand():
    """One step of the plain version by hand in float64: row r gets
    fma(old[r], 1.000001, 0.000001 * old[r - M]) rounded once; the margin
    rows keep their values."""
    m = pp.MARGIN
    ins = tuple(torch.from_numpy(a) for a in _seeded(24 + 2 * m, 16, 8))
    got = pp.persistent_walk_reference(ins, 1)
    a = np.float64(np.float32(1.000001))
    b = np.float32(0.000001)
    for g, f in zip(got, ins):
        x = f.numpy()
        want = (x[m:-m].astype(np.float64) * a
                + (b * x[:-2 * m]).astype(np.float64)).astype(np.float32)
        np.testing.assert_array_equal(g.numpy()[m:-m], want)
        np.testing.assert_array_equal(g.numpy()[:m], x[:m])
        np.testing.assert_array_equal(g.numpy()[-m:], x[-m:])


def test_non_cpu_tensors_never_take_the_plain_versions():
    """Tensors off the CPU go to the kernels or raise: here (meta tensors)
    the input checks raise before any build or launch, for the persistent
    step and for every form of the walk."""
    from ocean_model_arch_torch.ops import _build
    _, cfg, _, grid, state = _case(0)
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True, persistent=True)
    meta = tuple(torch.empty_like(f, device="meta") for f in fm.pack(state))
    args = (fm.met.to("meta"), fm.planes.to("meta"), fm.lay, fm.tau,
            cfg.sw.time_smooth, fm.hr_const, fm.mu_const, fm.visc, fm.trans,
            fm.ffs)
    fstep.reset_launch_counts()
    pp.reset_launch_counts()
    for spare in (None, tuple(torch.empty_like(f) for f in meta)):
        with pytest.raises(ValueError):
            fstep.fused_sw_persistent(meta, *args, n_steps=3, spare=spare)
    walk = tuple(torch.empty((2 * pp.TILE_ROWS + 2 * pp.MARGIN, 40),
                             device="meta") for _ in range(pp.N_FIELDS))
    for form in pp.FORMS:
        with pytest.raises(ValueError, match="CUDA"):
            pp.persistent_walk(walk, 3, form)
    assert fstep.fused_sw_persistent.launches == 0
    assert pp.persistent_walk.launches == 0
    assert not any(t.startswith("persistent_probe") or "PERSIST" in t
                   for t in _build.BUILDS)


@pytest.mark.parametrize("size,want", [((1525, 1115), (3456, 9, 0.7273)),
                                       ((400, 300), (260, 1, 0.6566))],
                         ids=["azov250m", "cut400x300"])
def test_walk_rounds(size, want):
    """The walk's grid over the single block's tiles, as chip_smoke.py
    prints it: three blocks an SM on 132 SMs (396 blocks) walk the 96 x 36
    tiles of the 1533 x 1152 layout in 9 rounds a step, the last 73 %
    full, and the 26 x 10 of the 408 x 320 cut in one. Block b runs tiles
    b, b + grid, ...: every tile once a step."""
    from ocean_model_arch_torch.ops import fused_layout as fl
    lay = fl.make_layout(*size)
    grid = 3 * 132
    tiles, rounds, fill = fstep.persistent_rounds(lay, grid)
    assert (tiles, rounds) == want[:2] and abs(fill - want[2]) < 1e-4
    walked = sorted(t for b in range(grid) for t in range(b, tiles, grid))
    assert walked == list(range(tiles))
    assert max(len(range(b, tiles, grid)) for b in range(grid)) == rounds
