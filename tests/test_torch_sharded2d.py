"""The port's ``FusedSharded2DModel`` and the raw form of the fused step on
the CPU (where the raw wrapper runs its plain PyTorch version), held
against the JAX ``FusedSharded2DModel`` (Pallas kernel in interpret mode
on the 8 virtual CPU devices), the port's single-block ``FusedSWModel``
(bit for bit on closed basins) and the port's eager composition
(periodic basins). The CUDA kernel's raw form is compared with the plain
version on the card by chip_smoke.py."""

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
from ocean_model_arch_tpu.model.fused_sharded2d import \
    FusedSharded2DModel as JaxSharded
from ocean_model_arch_tpu.model.init import init_ocean_state as jax_init

from ocean_model_arch_torch.model.fused import FusedSWModel
from ocean_model_arch_torch.model.fused_sharded2d import FusedSharded2DModel
from ocean_model_arch_torch.model.step import make_step, run_steps
from ocean_model_arch_torch.ops import _build
from ocean_model_arch_torch.ops import fused_layout as fl
from ocean_model_arch_torch.ops import fused_step as fstep

from test_torch_step import to_torch

torch.set_num_threads(1)

N_STEPS = 30
# JAX kernel vs port, f32, 30 steps: the tolerance of
# tests/test_fused_sharded2d.py (the two differ in f32 operation order)
TOL = 1e-5
NAMES = ("ssh", "sshp", "u", "up", "v", "vp", "ff", "ffp")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@functools.lru_cache(maxsize=None)
def _case(curve_grid=1, lopsided=False, mu=0.0, periodic=""):
    """The basin of tests/test_fused_sharded2d.py (70 x 52, random land,
    1 tracer), or its 64 x 48 channel open along ``periodic`` with the
    bump moved onto the seam; inputs from a numpy seed, in both
    packages' types: (jgrid, cfg, jstate, grid, state)."""
    prec = Precision.f32()
    sw = SWConfig(use_tracers=1, tracer_num=1)
    if periodic:
        nx, ny = 64, 48
        basin = dataclasses.replace(
            basinpar_flat(nx, ny, curve_grid=curve_grid, rlon=27.5,
                          rlat=41.0), **{"periodicity_" + periodic: 1})
        mask = np.zeros((nx, ny), np.int32)
        if periodic == "x":
            mask[:, :2] = mask[:, -2:] = 1     # walls in y only
        else:
            mask[:2, :] = mask[-2:, :] = 1
    else:
        nx, ny = 70, 52
        basin = basinpar_flat(nx, ny, curve_grid=curve_grid, rlon=27.5,
                              rlat=41.0)
        mask = frame_of_land_mask(nx, ny)
        rng = np.random.RandomState(3)
        land = rng.rand(nx - 4, ny - 4)
        if lopsided:      # most of the land in the low corner
            land[:30, :20] *= 0.3
        mask[2:-2, 2:-2] |= (land < 0.15).astype(np.int32)
    cfg = ModelConfig(basin=basin, sw=sw, precision=prec)
    jgrid = jax_build_grid(basin, mask, precision=prec)
    jstate = jax_init(jgrid, cfg)
    if periodic:
        axis, by = (0, nx // 2 - 4) if periodic == "x" else (1, ny // 2 - 2)
        lu = np.asarray(jgrid.lu)
        jstate = jax_init(jgrid, cfg,
                          np.roll(np.asarray(jstate.ssh), by, axis) * lu)
        ff = np.roll(np.asarray(jstate.ff), by, axis + 1) * lu
        jstate = dataclasses.replace(jstate, ff=jax.numpy.asarray(ff),
                                     ffp=jax.numpy.asarray(ff),
                                     ffn=jax.numpy.asarray(ff))
    if mu:
        jstate = dataclasses.replace(
            jstate, mu=jax.numpy.full_like(jstate.mu, mu))
    grid, state = to_torch(jgrid, jstate, torch.float32)
    return jgrid, cfg, jstate, grid, state


def _jax_fields(jgrid, cfg, jstate, px, py, **kw):
    fm = JaxSharded(jgrid, cfg, 1.0, px, py, tx=8, interpret=True, **kw)
    c, ok = fm.make_runner(N_STEPS)(fm.pack(jstate))
    assert bool(ok)
    return fm, [np.asarray(a) for a in fm.extract(c)]


def _port_fields(grid, cfg, state, px, py, **kw):
    fs = FusedSharded2DModel(grid, cfg, 1.0, px, py, **kw)
    c, ok = fs.make_runner(N_STEPS)(fs.pack(state))
    assert ok
    return fs, fs.extract(c)


def _single_block(grid, cfg, state, mu=0.0):
    fm = FusedSWModel(grid, cfg, 1.0, mu_const=mu, static_rslu=True)
    s, ok = fm.run_steps(fm.pack(state), N_STEPS)
    assert ok
    return [fl.extract(fm.lay, a) for a in s]


def _check(case, px, py, tol=TOL, jax_kw=None, **kw):
    """The port on px x py shards against the JAX sharded model (< tol on
    all 8 fields) and against the port's single block (bit for bit)."""
    jgrid, cfg, jstate, grid, state = case
    mu = kw.get("mu_const", 0.0)
    jm, want = _jax_fields(jgrid, cfg, jstate, px, py,
                           **{**kw, **(jax_kw or {})})
    fs, got = _port_fields(grid, cfg, state, px, py, **kw)
    for n, a, b in zip(NAMES, got, want):
        assert _rel(a.numpy(), b) < tol, (n, _rel(a.numpy(), b))
    for n, a, b in zip(NAMES, got, _single_block(grid, cfg, state, mu)):
        assert torch.equal(a, b), n
    return jm, fs


@pytest.mark.parametrize("px,py", [(1, 2), (2, 2), (2, 4), (4, 2), (8, 1)])
def test_meshes_match_jax_and_the_single_block(px, py):
    jm, fs = _check(_case(), px, py)
    nx, ny = fs.grid.nx, fs.grid.ny
    # the uniform y cuts are JAX's, cut off at the basin's edge; JAX's x
    # cuts are multiples of its row tile, the port's are ceil(nx / px)
    np.testing.assert_array_equal(
        fs.y_edges, np.minimum(np.asarray(jm.y_edges), ny))
    np.testing.assert_array_equal(
        fs.x_edges, np.minimum(np.arange(px + 1) * -(-nx // px), nx))
    assert fs.x_edges[-1] == nx and fs.y_edges[-1] == ny
    assert fs.lay.Ys % fl.ROW_ALIGN == 0 and fs.M == 4


def test_weighted_cuts_match_jax():
    jm, fs = _check(_case(lopsided=True), 2, 2, weighted=True)
    np.testing.assert_array_equal(fs.x_edges, np.asarray(jm.x_edges))
    np.testing.assert_array_equal(fs.y_edges, np.asarray(jm.y_edges))
    _, cfg, _, grid, _ = _case(lopsided=True)
    uniform = FusedSharded2DModel(grid, cfg, 1.0, 2, 2)
    assert (list(fs.x_edges) != list(uniform.x_edges)
            or list(fs.y_edges) != list(uniform.y_edges))
    assert len(set(fs.lx)) > 1 or len(set(fs.ly)) > 1    # unequal shards


def test_compute_powers_move_the_cuts():
    _, cfg, _, grid, _ = _case(lopsided=True)
    even = FusedSharded2DModel(grid, cfg, 1.0, 2, 1, weighted=True)
    skew = FusedSharded2DModel(grid, cfg, 1.0, 2, 1, weighted=True,
                               compute_powers_x=[3.0, 1.0])
    assert skew.x_edges[1] > even.x_edges[1]


def test_file_cuts_match_jax():
    xe, ye = np.array([0, 24, 40, 70]), np.array([0, 30, 52])
    jm, fs = _check(_case(), 3, 2, x_edges=xe, y_edges=ye)
    np.testing.assert_array_equal(fs.x_edges, np.asarray(jm.x_edges))
    np.testing.assert_array_equal(fs.y_edges, np.asarray(jm.y_edges))
    assert fs.lx == [24, 16, 30] and fs.ly == [30, 22]
    assert (fs.Xpad, fs.Ymax) == (30, 30)


def test_statics_match_jax_on_the_valid_boxes():
    """JAX's per-shard statics (``lu_shards``, ``hr_shards``, the metric
    profile ``met_shards``), as numpy, against the port's on every
    shard's valid box and 4-cell margin (JAX's margin is 8 cells)."""
    jgrid, cfg, _, grid, _ = _case()
    xe, ye = np.array([0, 24, 40, 70]), np.array([0, 30, 52])
    jm = JaxSharded(jgrid, cfg, 1.0, 3, 2, tx=8, interpret=True,
                    x_edges=xe, y_edges=ye)
    fs = FusedSharded2DModel(grid, cfg, 1.0, 3, 2, x_edges=xe, y_edges=ye)
    d = jm.M - fs.M
    jlu, jhr = np.asarray(jm.lu_shards), np.asarray(jm.hr_shards)
    jmet = np.asarray(jm.met_shards)
    for i in range(3):
        for j in range(2):
            w, h = fs.lx[i] + 2 * fs.M, fs.ly[j] + 2 * fs.M
            np.testing.assert_array_equal(
                fs.lu_shards[i][j][:w, :h], jlu[i, j, d:d + w, d:d + h])
            np.testing.assert_array_equal(
                fs.hr_shards[i][j][:w, :h], jhr[i, j, d:d + w, d:d + h])
            # beyond the box and its margin: land
            assert not fs.lu_shards[i][j][w:].any()
            assert not fs.lu_shards[i][j][:, h:].any()
            got = fs.met_shards[i][j].numpy()[:22, :h]
            want = jmet[j, :22, d:d + h]
            # row 17, dxt(n + 1) - dxb, beyond the basin's closed edge:
            # JAX repeats the edge's value, the port derives it from the
            # repeated metrics; no wet cell is there
            inside = np.ones((22, h), bool)
            if j == 0:
                inside[17, :fs.M] = False
            if j == 1:
                inside[17, h - fs.M:] = False
            np.testing.assert_array_equal(got[inside], want[inside])
            assert np.isfinite(fs.met_shards[i][j].numpy()).all()


def test_viscosity_matches_jax():
    _check(_case(mu=1000.0), 2, 2, mu_const=1000.0)


def test_bipolar_grid_matches_jax():
    jm, fs = _check(_case(curve_grid=2), 2, 2)
    assert jm.fast2d and fs.metrics_2d and fs.met_map is not None


@pytest.mark.parametrize("periodic,px,py", [("x", 2, 2), ("x", 1, 2),
                                            ("x", 1, 1), ("y", 1, 1),
                                            ("y", 2, 2)])
def test_periodic_matches_jax_and_eager(periodic, px, py):
    """The channel of tests/test_fused_sharded2d.py with the bump on the
    seam: against the JAX sharded model and against the port's eager
    composition (which wraps through ``pad``), both < 1e-5."""
    jgrid, cfg, jstate, grid, state = _case(periodic=periodic)
    seam = state.ssh[:3] if periodic == "x" else state.ssh[:, :3]
    assert float(seam.abs().max()) > 0.1          # the bump is on the seam
    _, want = _jax_fields(jgrid, cfg, jstate, px, py)
    fs, got = _port_fields(grid, cfg, state, px, py)
    for n, a, b in zip(NAMES, got, want):
        assert _rel(a.numpy(), b) < TOL, (n, _rel(a.numpy(), b))
    ref, ok = run_steps(make_step(grid, cfg), state, 1.0, N_STEPS)
    assert ok
    for n, a, b in zip(NAMES, got, (ref.ssh, ref.sshp, ref.ubrtr,
                                    ref.ubrtrp, ref.vbrtr, ref.vbrtrp,
                                    ref.ff[0], ref.ffp[0])):
        assert _rel(a.numpy(), b.numpy()) < TOL, (n, periodic, px, py)
    # a closed, unsharded axis needs no margin work
    want_copies = (2 * (px if periodic == "x" else px - 1) * py
                   + 2 * (py if periodic == "y" else py - 1) * px)
    assert fs.strip_copies == want_copies * N_STEPS


def test_signal_crosses_the_seam_only_when_periodic():
    """A bump beside the x seam reaches the far side of the basin through
    the wrapped margin, and stays away from it in the closed basin."""
    far = {}
    for periodic in ("x", ""):
        _, cfg, _, grid, state = _case(periodic="x")
        if not periodic:
            grid = dataclasses.replace(grid, periodic_x=False)
        lu = grid.lu
        ssh = torch.zeros_like(state.ssh)
        ssh[2:5, 20:28] = 0.5
        st = dataclasses.replace(state, ssh=ssh * lu, sshp=ssh * lu)
        fs = FusedSharded2DModel(grid, cfg, 1.0, 1, 1)
        c, ok = fs.make_runner(4)(fs.pack(st))
        assert ok
        far[periodic] = float(fs.extract(c)[0][-6:].abs().max())
    assert far["x"] > 0.0 and far[""] == 0.0, far


def test_narrow_shards_rejected():
    _, cfg, _, grid, _ = _case()
    with pytest.raises(ValueError, match="margin"):
        FusedSharded2DModel(grid, cfg, 1.0, 1, 8)


def test_cuts_must_span_the_basin():
    """The port's rule for cut lines, periodic axes included: they end
    exactly at the basin's edge."""
    _, cfg, _, grid, _ = _case(periodic="x")
    with pytest.raises(ValueError, match="span"):
        FusedSharded2DModel(grid, cfg, 1.0, 2, 1, x_edges=[0, 30, 60])
    with pytest.raises(ValueError, match="entries"):
        FusedSharded2DModel(grid, cfg, 1.0, 2, 1, x_edges=[0, 64])
    FusedSharded2DModel(grid, cfg, 1.0, 2, 1, x_edges=[0, 30, 64])


def test_constructor_refusals():
    _, cfg, _, grid, _ = _case()
    with pytest.raises(ValueError, match="static_rslu"):
        FusedSharded2DModel(grid, cfg, 1.0, 2, 2, static_rslu=False,
                            fast2d=True)
    with pytest.raises(ValueError, match="devices"):
        FusedSharded2DModel(grid, cfg, 1.0, 2, 2, devices=["cpu"] * 3)
    with pytest.raises(NotImplementedError, match="devices"):
        FusedSharded2DModel(grid, cfg, 1.0, 2, 2, devices=["meta"] * 4)
    fs = FusedSharded2DModel(grid, cfg, 1.0, 2, 2, devices=["cpu"] * 4,
                             steps_per_call=2)
    with pytest.raises(ValueError, match="multiple"):
        fs.make_runner(3)


def test_guard_sees_a_shard_interior_and_not_its_pad():
    _, cfg, _, grid, state = _case()
    fs = FusedSharded2DModel(grid, cfg, 1.0, 3, 2,
                             x_edges=[0, 24, 40, 70], y_edges=[0, 30, 52])
    run = fs.make_runner(2)
    wet = torch.nonzero(grid.lu[40:70, 30:52] > 0.5)[0]
    for k in range(6):
        carry = fs.pack(state)
        carry[k][0, -1, -1] = float("nan")          # a pad cell
        _, ok = run(carry)
        assert ok, k
    carry = fs.pack(state)
    carry[5][0, fs.M + int(wet[0]), fs.M + int(wet[1])] = float("nan")
    _, ok = run(carry)
    assert not ok


def test_pack_extract_round_trip_and_mu():
    _, cfg, _, grid, state = _case()
    fs = FusedSharded2DModel(grid, cfg, 1.0, 2, 4)
    carry = fs.pack(state)
    assert len(carry) == 8
    assert all(tuple(c.shape) == (8, fs.lay.Xs, fs.lay.Ys) for c in carry)
    out = fs.extract(carry)
    for a, b in zip(out, (state.ssh, state.sshp, state.ubrtr, state.ubrtrp,
                          state.vbrtr, state.vbrtrp, state.ff[0],
                          state.ffp[0])):
        assert torch.equal(a, b)
    back = fs.unpack(carry, state)
    assert torch.equal(back.ssh, state.ssh)
    assert torch.equal(back.hhq, state.hhq)
    with pytest.raises(ValueError, match="mu"):
        fs.pack(dataclasses.replace(state, mu=state.mu + 1.0))


# ---- the raw form of the step ---------------------------------------------

def _evolved(case, n=10):
    """The carried fields ``n`` steps in, as physical numpy arrays."""
    _, cfg, _, grid, state = case
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True)
    s, ok = fm.run_steps(fm.pack(state), n)
    assert ok
    return [fl.extract(fm.lay, a).numpy() for a in s]


def test_raw_reference_matches_jax_step_raw():
    """One step of the plain version's raw form on one margined shard
    whose margins hold the neighbour's wet cells, against the JAX
    ``step_raw`` (Pallas, interpret mode) on the same shard in its own
    layout, on the shard's valid box: < 1e-6 relative in f32 (the
    tolerance of test_torch_fused.py's one-step comparison)."""
    case = _case()
    jgrid, cfg, _, grid, _ = case
    fields = _evolved(case)
    jm = JaxSharded(jgrid, cfg, 1.0, 1, 2, tx=8, interpret=True)
    fs = FusedSharded2DModel(grid, cfg, 1.0, 1, 2)
    i, j = 0, 1
    lx, ly = fs.lx[i], fs.ly[j]
    y0 = int(fs.y_edges[j])
    assert int(jm.y_edges[j]) == y0 and int(jm.x_edges[0]) == 0

    def block(f, M, Xs, Ys):
        """Shard (0, 1) of a physical field with an M-cell margin that
        holds the neighbouring cells, land outside the basin."""
        gp = np.pad(f, M)
        out = np.zeros((Xs, Ys), np.float32)
        w, h = min(Xs, gp.shape[0]), ly + 2 * M
        out[:w, :h] = gp[:w, y0:y0 + h]
        return out

    Mj = jm.M
    jf = [jax.numpy.asarray(block(f, Mj, jm.lay.Xs, jm.lay.Ys))
          for f in fields]
    assert float(np.abs(np.asarray(jf[0])[:, :Mj]).max()) > 0  # wet margin
    outs, _ = jm.step_raw(jm.lu_shards[i, j], jm.hr_shards[i, j],
                          jm.met_shards[j], jm.plane_shards[i, j], *jf,
                          tile_wet=jm.tile_wet[i, j])
    want = [np.asarray(o)[Mj:Mj + lx, Mj:Mj + ly] for o in outs]

    M = fs.M
    pf = tuple(torch.from_numpy(block(f, M, fs.lay.Xs, fs.lay.Ys))
               for f in fields)
    pouts = tuple(torch.full_like(f, 7.0) for f in pf)
    tx, ty = fs.tile
    bmax = torch.empty((-(-fs.lay.Xs // tx), -(-fs.lay.Ys // ty)))
    fstep.fused_sw_step_raw(
        pf, pouts, bmax, fs.met_shards[i][j], fs.plane_shards[i][j],
        fs.shard_lay[i][j], 1.0, cfg.sw.time_smooth, fs.hr_const,
        fs.tile_wet[i][j], fs.tile, fs.met_map, 0.0, False,
        folds=fs.folds)     # both drivers' default folds: elide_sel, q4
    assert fs.folds == (jm.elide_sel, jm.q4, jm.share_prev) == (
        True, True, False)
    for n, o, b in zip(NAMES, pouts, want):
        got = o[M:M + lx, M:M + ly].numpy()
        assert _rel(got, b) < 1e-6, (n, _rel(got, b))
        # margins and pad of the output buffer: untouched, bit for bit
        outside = torch.ones_like(o, dtype=torch.bool)
        outside[M:M + lx, M:M + ly] = False
        assert bool((o[outside] == 7.0).all()), n
    # the block max is the max over the box
    assert float(bmax.max()) == float(pouts[0][M:M + lx, M:M + ly]
                                      .abs().max())


def test_raw_form_equals_the_single_block_on_the_box():
    """With land margins the raw form writes what the single-block form
    computes, on the box only, and returns its max."""
    _, cfg, _, grid, state = _case()
    fm = FusedSWModel(grid, cfg, 1.0, tile_guard=True, static_rslu=True)
    s0 = fm.pack(state)
    args = (fm.met, fm.planes, fm.lay, 1.0, cfg.sw.time_smooth, fm.hr_const,
            fm.tile_wet, fm.tile, fm.met_map, 0.0, False)
    want, mx = fstep.fused_sw_step(s0, *args)
    outs = tuple(torch.zeros_like(f) for f in s0)
    tx, ty = fm.tile
    bmax = torch.empty((-(-fm.lay.Xs // tx), -(-fm.lay.Ys // ty)))
    fstep.fused_sw_step_raw(s0, outs, bmax, *args)
    for a, b in zip(outs, want):
        assert torch.equal(a, b)          # the margin is land: zeros
    assert float(bmax.max()) == float(mx)
    assert fstep.fused_sw_step.launches == 0      # CPU: the plain version


def test_raw_wrapper_never_takes_the_plain_version_off_the_cpu(monkeypatch):
    """Tensors off the CPU go to the kernel or raise (meta tensors: the
    input check raises before any build); a missing toolchain is an
    error, for the raw libraries too."""
    lay = fl.make_layout(24, 20)
    f = tuple(torch.empty((lay.Xs, lay.Ys), device="meta") for _ in range(6))
    o = tuple(torch.empty((lay.Xs, lay.Ys), device="meta") for _ in range(6))
    with pytest.raises(ValueError, match="CUDA"):
        fstep.fused_sw_step_raw(
            f, o, torch.empty((2, 2), device="meta"),
            torch.empty((fl.N_PROF, lay.Ys), device="meta"),
            torch.empty((4, lay.Xs, lay.Ys), device="meta"), lay, 1.0, 0.5,
            100.0, tile=(16, 32))
    assert len(fstep.library_targets()) == 64
    assert sum("RAW" in t for t in fstep.library_targets()) == 32
    assert sum("FUSED_STEPS=2" in t for t in fstep.library_targets()) == 32
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    for n in range(fstep.LOOP_TRACERS + 1):
        for steps in (1, 2):
            with pytest.raises(RuntimeError, match="nvcc"):
                fstep._library.__wrapped__(n, True, steps=steps)


def test_raw_form_refuses_to_run_in_place():
    lay = fl.make_layout(24, 20)
    f = tuple(torch.zeros((lay.Xs, lay.Ys)) for _ in range(6))
    for outs in (f, f[:5]):
        with pytest.raises(ValueError, match="outs"):
            fstep.fused_sw_step_raw(f, outs, None, None, None, lay, 1.0,
                                    0.5, 100.0)
