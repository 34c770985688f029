"""The fast form's arithmetic folds (``elide_sel``, ``q4``, ``share_prev``:
the JAX kernel's round-5 reductions, on by default wherever its drivers
run the fast form) on the CPU, where ``fused_sw_step`` runs its plain
PyTorch version: the drivers' defaults and refusals against JAX's, the
folded plain version against the JAX fused kernel in interpret mode with
the same folds, folded against unfolded (``tests/test_fused.py::
_assert_ulp_close``'s limits; bit for bit without ``share_prev`` here,
where nothing contracts), land exactly 0, ``pack``'s masking, the shards
against the block, the wrapper's refusals and the build targets. The CUDA
instantiations are held against the plain version on the card by
chip_smoke.py."""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

from ocean_model_arch_tpu.config import (ModelConfig, Precision, SWConfig,
                                         basinpar_as250m_test, basinpar_flat)
from ocean_model_arch_tpu.core.grid import build_grid as jax_build_grid
from ocean_model_arch_tpu.core.masks import frame_of_land_mask
from ocean_model_arch_tpu.io.mask_io import read_mask
from ocean_model_arch_tpu.model.fused import FusedSWModel as JaxFused
from ocean_model_arch_tpu.model.fused_sharded2d import \
    FusedSharded2DModel as JaxSharded
from ocean_model_arch_tpu.model.init import init_ocean_state as jax_init

from ocean_model_arch_torch.model.fused import FusedSWModel
from ocean_model_arch_torch.model.fused_sharded2d import FusedSharded2DModel
from ocean_model_arch_torch.ops import fused_layout as fl
from ocean_model_arch_torch.ops import fused_step as fstep

from test_torch_step import to_torch

torch.set_num_threads(1)

NX, NY, STEPS = 70, 52, 30
SW = ("ssh", "sshp", "ubrtr", "ubrtrp", "vbrtr", "vbrtrp")
# name -> (tracers, curve_grid, mu, ksw_lat, trans, ffs) on the island
# basin of tests/test_fused.py; visc_T2 is the tracer + viscosity case of
# test_round5_reductions_bitexact_tracers_visc; T4 the run-time tracer
# count (the tracer loop), as OceanModel runs tracer_num = 4
FORMS = {"T0": (0, 1, 0.0, 1, 1, 1),
         "T2": (2, 1, 0.0, 1, 1, 1),
         "T4": (4, 1, 0.0, 1, 1, 1),
         "fast2d": (0, 2, 0.0, 1, 1, 1),
         "visc_T2": (2, 1, 500.0, 1, 1, 1),
         "notrans": (0, 1, 0.0, 1, 0, 1),
         "linear_T3": (3, 1, 0.0, 1, 1, 0)}
UNFOLDED = dict(elide_sel=False, q4=False, share_prev=False)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@functools.lru_cache(maxsize=None)
def _case(form):
    """(jgrid, cfg, jstate, grid, state) of one form."""
    tracers, curve, mu, ksw, trans, ffs = FORMS[form]
    prec = Precision.f32()
    basin = basinpar_flat(NX, NY, curve_grid=curve, rlon=27.5, rlat=41.0)
    cfg = ModelConfig(basin=basin, sw=SWConfig(
        use_tracers=int(tracers > 0), tracer_num=max(tracers, 1),
        ksw_lat=ksw, trans_terms=trans, full_free_surface=ffs),
        precision=prec)
    mask = frame_of_land_mask(NX, NY)
    rng = np.random.RandomState(3)
    mask[2:-2, 2:-2] |= (rng.rand(NX - 4, NY - 4) < 0.15).astype(np.int32)
    jgrid = jax_build_grid(basin, mask, precision=prec)
    jstate = jax_init(jgrid, cfg)
    if mu:
        jstate = dataclasses.replace(
            jstate, mu=jax.numpy.full_like(jstate.mu, mu))
    grid, state = to_torch(jgrid, jstate, torch.float32)
    return jgrid, cfg, jstate, grid, state


def _names(form):
    return SW + ("ff", "ffp") * bool(FORMS[form][0])


@functools.lru_cache(maxsize=None)
def _jax(form, spc):
    """30 steps of the JAX fused kernel in interpret mode (tx = 8) with its
    default folds."""
    jgrid, cfg, jstate, _, _ = _case(form)
    jf = JaxFused(jgrid, cfg, 1.0, tx=8, interpret=True, static_rslu=True,
                  mu_const=FORMS[form][2], steps_per_call=spc)
    assert jf.elide_sel and jf.q4 and jf.share_prev == (spc > 1)
    j, ok = jax.jit(lambda s: jf.run_steps(s, STEPS))(jf.pack(jstate))
    assert bool(ok)
    return jf.unpack(j, jstate)


@functools.lru_cache(maxsize=None)
def _port(form, spc, folded=True):
    """The port's ``FusedSWModel`` on the same inputs, 30 steps, with its
    default folds or none: (model, carried fields, unpacked state)."""
    _, cfg, _, grid, state = _case(form)
    fm = FusedSWModel(grid, cfg, 1.0, mu_const=FORMS[form][2],
                      static_rslu=True, steps_per_call=spc,
                      **({} if folded else UNFOLDED))
    s, ok = fm.run_steps(fm.pack(state), STEPS)
    assert ok
    return fm, s, fm.unpack(s, state)


# ---- the drivers' defaults and refusals ------------------------------------

# (form, FusedSWModel arguments) -> the JAX model's resolution, compared
DRIVER_CASES = {
    "fast": ("T0", dict(static_rslu=True)),
    "fast_chained": ("T0", dict(static_rslu=True, steps_per_call=2)),
    "fast2d": ("fast2d", dict(static_rslu=True)),
    "fast2d_chained": ("fast2d", dict(static_rslu=True, steps_per_call=2)),
    "general": ("T0", dict()),
    "general_chained": ("T0", dict(steps_per_call=2)),
    "planes_not_fast2d": ("fast2d", dict(static_rslu=True, fast2d=False)),
    "persistent": ("T0", dict(static_rslu=True, persistent=True)),
    "share_prev_one_step": ("T0", dict(static_rslu=True, share_prev=True)),
    "share_prev_alone": ("T2", dict(static_rslu=True, steps_per_call=2,
                                    elide_sel=False, q4=False)),
    "elide_sel_alone": ("T0", dict(static_rslu=True, q4=False)),
    "fold_on_general": ("T0", dict(q4=True)),
    "fold_on_planes_general": ("fast2d", dict(static_rslu=True, fast2d=False,
                                              elide_sel=True)),
    "fold_on_persistent": ("T0", dict(static_rslu=True, persistent=True,
                                      elide_sel=True)),
    "share_on_persistent": ("T0", dict(static_rslu=True, persistent=True,
                                       steps_per_call=2, share_prev=True)),
}


def _resolve(make):
    """(elide_sel, q4, share_prev) of a model ``make()`` builds, or the
    ValueError's message."""
    try:
        m = make()
    except ValueError as e:
        return str(e)
    return (m.elide_sel, m.q4, m.share_prev)


@pytest.mark.parametrize("case", sorted(DRIVER_CASES))
def test_fused_driver_defaults_match_jax(case):
    """``FusedSWModel``'s elide_sel / q4 / share_prev, and its
    ValueErrors, equal the JAX model's for the same arguments."""
    form, kw = DRIVER_CASES[case]
    jgrid, cfg, _, grid, _ = _case(form)
    theirs = _resolve(lambda: JaxFused(jgrid, cfg, 1.0, tx=8,
                                       interpret=True, **kw))
    mine = _resolve(lambda: FusedSWModel(grid, cfg, 1.0, **kw))
    assert mine == theirs
    if isinstance(mine, tuple):
        m = FusedSWModel(grid, cfg, 1.0, **kw)
        assert m.folds == fstep.Folds(*mine)


SHARDED_CASES = {
    "default": dict(),
    "chained": dict(steps_per_call=2),
    "general": dict(static_rslu=False),
    "fold_on_general": dict(static_rslu=False, q4=True),
    "share_prev_alone": dict(steps_per_call=2, elide_sel=False, q4=False),
    "share_prev_one_step": dict(share_prev=True),
}


@pytest.mark.parametrize("case", sorted(SHARDED_CASES))
def test_sharded_driver_defaults_match_jax(case):
    """``FusedSharded2DModel`` (2 x 2 shards): the same against the JAX
    sharded model."""
    kw = SHARDED_CASES[case]
    jgrid, cfg, _, grid, _ = _case("T2")
    theirs = _resolve(lambda: JaxSharded(jgrid, cfg, 1.0, 2, 2, tx=8,
                                         interpret=True, **kw))
    mine = _resolve(lambda: FusedSharded2DModel(grid, cfg, 1.0, 2, 2, **kw))
    assert mine == theirs


# ---- the folded plain version against the JAX kernel -----------------------

@pytest.mark.parametrize("spc", [1, 2], ids=["one_step", "chained"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_folded_matches_jax_kernel(form, spc):
    """30 f32 steps of the port's ``FusedSWModel`` with its default folds
    against the JAX fused kernel in interpret mode with its own (the same):
    < 1e-5 relative per field, < 2e-5 with tracers (as
    tests/test_torch_chain.py: the fused flux reassociates)."""
    want = _jax(form, spc)
    fm, _, got = _port(form, spc)
    assert fm.folds == (True, True, spc > 1)
    tol = 2e-5 if FORMS[form][0] else 1e-5
    for n in _names(form):
        a, b = getattr(got, n), getattr(want, n)
        if n in ("ff", "ffp"):
            for t in range(FORMS[form][0]):
                assert _rel(a[t].numpy(), b[t]) < tol, (n, t)
        else:
            assert _rel(a.numpy(), b) < tol, n


@pytest.mark.parametrize("spc", [1, 2], ids=["one_step", "chained"])
@pytest.mark.parametrize("fold", ["elide_sel", "q4"])
@pytest.mark.parametrize("form", ["T0", "T2", "visc_T2"])
def test_one_fold_alone_matches_jax_kernel(form, fold, spc):
    """elide_sel without q4 and q4 without elide_sel (fold codes 1 and 2;
    5 and 6 chained, where share_prev stays on by default): 30 f32 steps
    of the port's ``FusedSWModel`` through the wrapper against the JAX
    fused kernel in interpret mode with the same arguments, < 1e-5
    relative per field (2e-5 with tracers, as
    :func:`test_folded_matches_jax_kernel`); land exactly 0 in the
    velocity carriers under elide_sel; the libraries of these codes build
    at first use, not among ``fold_targets()``."""
    jgrid, cfg, jstate, grid, state = _case(form)
    kw = dict(static_rslu=True, mu_const=FORMS[form][2], steps_per_call=spc,
              elide_sel=fold == "elide_sel", q4=fold == "q4")
    jf = JaxFused(jgrid, cfg, 1.0, tx=8, interpret=True, **kw)
    j, ok = jax.jit(lambda s: jf.run_steps(s, STEPS))(jf.pack(jstate))
    assert bool(ok)
    want = jf.unpack(j, jstate)
    fm = FusedSWModel(grid, cfg, 1.0, **kw)
    assert fm.folds == (jf.elide_sel, jf.q4, jf.share_prev)
    code = fstep.fold_code(fstep.kernel_folds(fm.folds, spc, fm.ffs))
    assert code == (1 if fold == "elide_sel" else 2) + 4 * (spc > 1)
    assert fstep.library_target(FORMS[form][0], steps=spc, folds=code) \
        not in fstep.fold_targets()
    s, ok = fm.run_steps(fm.pack(state), STEPS)
    assert ok
    got = fm.unpack(s, state)
    tol = 2e-5 if FORMS[form][0] else 1e-5
    for n in _names(form):
        a, b = getattr(got, n), getattr(want, n)
        if n in ("ff", "ffp"):
            for t in range(FORMS[form][0]):
                assert _rel(a[t].numpy(), b[t]) < tol, (n, t)
        else:
            assert _rel(a.numpy(), b) < tol, n
    if fm.elide_sel:
        wlcu, wlcv, _ = fl.staggered_wet_masks(fl.embed(fm.lay, fm.grid.lu))
        for f, w in zip(s[2:6], (wlcu, wlcu, wlcv, wlcv)):
            assert bool((f[torch.from_numpy(w) < 0.5] == 0).all())


@pytest.mark.parametrize("spc", [1, 2], ids=["one_step", "chained"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_folded_land_stays_exactly_zero(form, spc):
    """After 30 folded steps land is exactly 0 in the four velocity
    carriers and in ff / ffp of every tracer (the invariant the elided
    selects rely on), margins included; every field moved."""
    fm, s, _ = _port(form, spc)
    wlcu, wlcv, wlu = fl.staggered_wet_masks(fl.embed(fm.lay, fm.grid.lu))
    masks = (wlcu, wlcu, wlcv, wlcv) + (wlu,) * (2 * fm.n_tracers)
    for f, w in zip(s[2:], masks):
        land = torch.from_numpy(w) < 0.5
        assert bool((f[land] == 0).all())
        assert bool((f[~land] != 0).any())


@pytest.mark.parametrize("spc", [1, 2], ids=["one_step", "chained"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_folded_against_unfolded(form, spc):
    """Folded against unfolded after 30 steps, within
    ``_assert_ulp_close``'s limits: 1e-6 relative for elide_sel / q4 (here
    bit for bit: the plain version contracts nothing, and q4's scalings
    are powers of two), 1e-5 with share_prev (a regrouping)."""
    _, a, _ = _port(form, spc, folded=False)
    fm, b, _ = _port(form, spc)
    share = fm.share_prev and fm.ffs
    for x, y in zip(a, b):
        if share:
            assert _rel(y.numpy(), x.numpy()) < 1e-5
        else:
            assert torch.equal(x, y)


def test_share_prev_on_the_coastline_matches_jax():
    """share_prev where its regrouping has room to drift: a 500 x 400 cut of
    the Azov coastline (190834 wet points) around the initial bump, 30
    steps at two a launch. The port's grouping, (ts1 hu_A + ts2 hup_A) +
    ts2 hu, and JAX's, ts1 hu_A + ts2 (hu + hup_A): the port's plain
    version with its default folds against the JAX kernel in interpret
    mode with its own < 1e-5 relative per field, as the unfolded pair;
    and each folded run against its unfolded twin < 1e-5
    (``_assert_ulp_close``'s share_prev limit)."""
    prec = Precision.f32()
    full = basinpar_as250m_test()
    mask = read_mask(os.path.join(os.path.dirname(__file__), "..", "data",
                                  "AS", "maskAzovCor.txt"),
                     full.nx, full.ny)[512:1012, 357:757].copy()
    mask[:2] = mask[-2:] = 1
    mask[:, :2] = mask[:, -2:] = 1
    basin = dataclasses.replace(full, nx=500, ny=400)
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=0),
                      precision=prec)
    jgrid = jax_build_grid(basin, mask, precision=prec)
    jstate = jax_init(jgrid, cfg)
    grid, state = to_torch(jgrid, jstate, torch.float32)
    runs = {}
    for name, kw in (("folded", {}), ("unfolded", UNFOLDED)):
        jf = JaxFused(jgrid, cfg, 1.0, tx=8, interpret=True,
                      static_rslu=True, steps_per_call=2, **kw)
        j, ok = jax.jit(lambda s: jf.run_steps(s, STEPS))(jf.pack(jstate))
        assert bool(ok) and jf.share_prev == (name == "folded")
        runs["jax", name] = jf.unpack(j, jstate)
        fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True, steps_per_call=2,
                          **kw)
        s, ok = fm.run_steps(fm.pack(state), STEPS)
        assert ok and fm.share_prev == (name == "folded")
        runs["port", name] = fm.unpack(s, state)
    for a, b in ((("port", "folded"), ("jax", "folded")),
                 (("port", "unfolded"), ("jax", "unfolded")),
                 (("jax", "folded"), ("jax", "unfolded")),
                 (("port", "folded"), ("port", "unfolded"))):
        for n in SW:
            got, want = getattr(runs[a], n), getattr(runs[b], n)
            assert _rel(np.asarray(got), np.asarray(want)) < 1e-5, (a, b, n)


def test_folds_alone_and_share_prev_regrouping():
    """Each fold alone in the plain version: elide_sel and q4 bit for bit
    against none, share_prev alone within 1e-5 and not bit for bit (it
    regroups), 30 chained steps of the 2-tracer viscous form."""
    _, cfg, _, grid, state = _case("visc_T2")
    runs = {}
    for name, kw in (("none", UNFOLDED),
                     ("elide", dict(UNFOLDED, elide_sel=True)),
                     ("q4", dict(UNFOLDED, q4=True)),
                     ("share", dict(UNFOLDED, share_prev=True))):
        fm = FusedSWModel(grid, cfg, 1.0, mu_const=500.0, static_rslu=True,
                          steps_per_call=2, **kw)
        runs[name], ok = fm.run_steps(fm.pack(state), STEPS)
        assert ok
    for name in ("elide", "q4"):
        assert all(torch.equal(a, b) for a, b in zip(runs[name],
                                                     runs["none"]))
    assert not all(torch.equal(a, b) for a, b in zip(runs["share"],
                                                     runs["none"]))
    for a, b in zip(runs["share"], runs["none"]):
        assert _rel(a.numpy(), b.numpy()) < 1e-5


# ---- pack, the planes, the shards ------------------------------------------

def test_pack_masks_the_carriers():
    """With elide_sel ``pack`` multiplies the velocities by their staggered
    wet masks and the tracer levels by the T one (land velocities of a
    state become 0, wet ones stay), as the JAX model packs; without it the
    state goes in as it is."""
    jgrid, cfg, jstate, grid, state = _case("T2")
    ones = {n: torch.ones_like(getattr(state, n)) for n in SW[2:]}
    st = dataclasses.replace(state, ff=torch.ones_like(state.ff),
                             ffp=torch.ones_like(state.ffp), **ones)
    jst = dataclasses.replace(
        jstate, ff=jax.numpy.ones_like(jstate.ff),
        ffp=jax.numpy.ones_like(jstate.ffp),
        **{n: jax.numpy.ones_like(getattr(jstate, n)) for n in SW[2:]})
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True)
    jf = JaxFused(jgrid, cfg, 1.0, tx=8, interpret=True, static_rslu=True)
    assert fm.elide_sel and jf.elide_sel
    mine = [fl.extract(fm.lay, a).numpy() for a in fm.pack(st)]
    theirs = [np.asarray(a)[jf.lay.margin:jf.lay.margin + NX,
                            jf.lay.ypad:jf.lay.ypad + NY]
              for a in jf.pack(jst)]
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    wlcu, wlcv, wlu = fl.staggered_wet_masks(grid.lu.numpy())
    for a, w in zip(mine[2:], (wlcu, wlcu, wlcv, wlcv, wlu, wlu, wlu, wlu)):
        np.testing.assert_array_equal(a, w)
    plain = FusedSWModel(grid, cfg, 1.0, static_rslu=True, **UNFOLDED)
    assert all(bool((fl.extract(plain.lay, a) == 1).all())
               for a in plain.pack(st)[2:])


def test_sharded_pack_masks_across_a_periodic_seam():
    """The sharded driver's pack masks on the physical grid, with the
    neighbour across a periodic seam: a wet u point at the last row of a
    channel periodic in x keeps its velocity."""
    prec = Precision.f32()
    basin = dataclasses.replace(
        basinpar_flat(64, 48, curve_grid=1, rlon=27.5, rlat=41.0),
        periodicity_x=1)
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=0),
                      precision=prec)
    mask = np.zeros((64, 48), np.int32)
    mask[:, :2] = mask[:, -2:] = 1
    jgrid = jax_build_grid(basin, mask, precision=prec)
    grid, state = to_torch(jgrid, jax_init(jgrid, cfg), torch.float32)
    st = dataclasses.replace(state, ubrtr=torch.ones_like(state.ubrtr))
    fs = FusedSharded2DModel(grid, cfg, 1.0, 2, 1)
    assert fs.elide_sel
    u = fs.extract(fs.pack(st))[2]
    assert bool((u[:, 2:-2] == 1).all()) and bool((u[:, :2] == 0).all())


def test_q4_quarters_the_u_and_v_planes():
    """q4: rslu_u and rslu_v are the unfolded planes times 1/4, exactly;
    rslu_h and ludxdy unchanged (profile and plane metrics, block and
    shards)."""
    for form in ("T0", "fast2d"):
        _, cfg, _, grid, _ = _case(form)
        a = FusedSWModel(grid, cfg, 1.0, static_rslu=True, q4=False).planes
        b = FusedSWModel(grid, cfg, 1.0, static_rslu=True).planes
        assert torch.equal(b[:2], a[:2] * 0.25) and torch.equal(b[2:], a[2:])
        a = FusedSharded2DModel(grid, cfg, 1.0, 2, 1, q4=False).plane_shards
        b = FusedSharded2DModel(grid, cfg, 1.0, 2, 1).plane_shards
        assert torch.equal(b[1][0][:2], a[1][0][:2] * 0.25)
        assert torch.equal(b[1][0][2:], a[1][0][2:])


@pytest.mark.parametrize("spc", [1, 2], ids=["one_step", "chained"])
def test_sharded_folded_equals_the_block(spc):
    """``FusedSharded2DModel(2, 2)`` with its default folds (the raw form's
    plain version; share_prev chained) == ``FusedSWModel`` with the same
    folds, bit for bit, 30 steps, 2 tracers."""
    _, cfg, _, grid, state = _case("T2")
    fs = FusedSharded2DModel(grid, cfg, 1.0, 2, 2, steps_per_call=spc)
    assert fs.folds == (True, True, spc > 1)
    c, ok = fs.make_runner(STEPS)(fs.pack(state))
    fm, s, _ = _port("T2", spc)
    assert ok and fm.folds == fs.folds
    for a, b in zip(fs.extract(c), s):
        assert torch.equal(a, fl.extract(fm.lay, b))


# ---- the wrapper ---------------------------------------------------------

def test_wrapper_refuses_what_the_kernel_lacks():
    """The kernel has every fold combination: elide_sel without q4 and q4
    without elide_sel (with share_prev too) reach the wrapper's input
    checks, which refuse CPU tensors (ValueError), and no
    NotImplementedError; on the CPU the plain version runs them. The
    general form has no folds (ValueError)."""
    fm, s, _ = _port("T0", 1)
    args = (fm.met, fm.planes, fm.lay, 1.0, fm.cfg.sw.time_smooth,
            fm.hr_const, None, None, None, 0.0, False, 1, 1, 1, False)
    for folds in ((True, False, False), (False, True, True)):
        with pytest.raises(ValueError, match="CUDA"):
            fstep.fused_sw_step_blockmax(s, *args, folds)
        fstep.fused_sw_step(s, *args, folds)          # the plain version
    gm = FusedSWModel(fm.grid, fm.cfg, 1.0)
    with pytest.raises(ValueError, match="general form"):
        fstep.fused_sw_step_reference(
            s, gm.met, gm.planes, gm.lay, 1.0, fm.cfg.sw.time_smooth, None,
            general=True, folds=fstep.Folds(True, True, False))


def test_kernel_folds_and_targets():
    """share_prev is an instantiation of its own only chained with a full
    free surface; the 96 fold libraries hold elide_sel + q4 beside every
    unfolded library, and chained with a full free surface also that with
    share_prev and share_prev alone; none is an unfolded library."""
    kf = fstep.kernel_folds
    assert kf((True, True, True), 1, 1) == (True, True, False)
    assert kf((False, False, True), 2, 0) == (False, False, False)
    assert kf((False, False, True), 2, 1) == (False, False, True)
    assert [fstep.fold_code(f) for f in ((1, 1, 0), (1, 1, 1), (0, 0, 1))] \
        == [3, 7, 4]
    targets = fstep.fold_targets()
    assert len(targets) == len(set(targets)) == 96
    assert not set(targets) & set(fstep.library_targets())
    for t in targets:
        code = int(t.split("@FUSED_FOLD=")[1])
        assert code in (3, 7, 4)
        assert code == 3 or ("FUSED_STEPS=2" in t and "FUSED_FFS=0" not in t)
        base = t.split("@FUSED_FOLD=")[0]
        assert base in fstep.library_targets()
    assert fstep.library_target(2, True, 1, 1, 2, folds=7) == \
        "fused_step@FUSED_RAW_NT=2@FUSED_STEPS=2@FUSED_FOLD=7"
