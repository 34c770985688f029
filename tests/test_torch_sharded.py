"""The port's eager sharded step on the CPU (``parallel/{mesh,domain,halo}.py``,
``model/sharded.py``, and ``OceanModel`` on a mesh off the fused path)
against its own single block and the JAX package: the analytic i*j halo
exchange on every mesh shape (the reference's sync_test), the nlev
field, the halo self-test, decomposition invariance on the flat and the
island basins (f64, 40 steps), the JAX sharded step from the same numpy
inputs at 1e-12, the padding helpers against JAX's, the hoisted static
exchanges, and the model's routes, output and refusals on the mesh."""

import contextlib
import dataclasses
import io
import os
import re

import jax
import numpy as np
import pytest
import torch

from ocean_model_arch_tpu.config import (ModelConfig, Precision, SWConfig,
                                         basinpar_flat)
from ocean_model_arch_tpu.core.grid import build_grid as jax_build_grid
from ocean_model_arch_tpu.core.masks import frame_of_land_mask
from ocean_model_arch_tpu.model.init import init_ocean_state as jax_init
from ocean_model_arch_tpu.model.model import OceanModel as JaxOceanModel
from ocean_model_arch_tpu.model.model import \
    load_config_dir as jax_load_config_dir
from ocean_model_arch_tpu.model.sharded import \
    make_sharded_step as jax_make_sharded_step
from ocean_model_arch_tpu.model.sharded import prepare as jax_prepare
from ocean_model_arch_tpu.parallel import domain as jdomain
from ocean_model_arch_tpu.parallel import mesh as jmesh

from ocean_model_arch_torch.__main__ import main
from ocean_model_arch_torch.core.grid import GRID_FIELDS, grid_from_numpy
from ocean_model_arch_torch.core.state import STATE_FIELDS, state_from_numpy
from ocean_model_arch_torch.model.model import OceanModel, load_config_dir
from ocean_model_arch_torch.model.sharded import make_sharded_step, prepare
from ocean_model_arch_torch.model.step import make_step, run_steps
from ocean_model_arch_torch.parallel import halo as halo_mod
from ocean_model_arch_torch.parallel.domain import (crop_state, pad_grid,
                                                    pad_state,
                                                    padded_extents)
from ocean_model_arch_torch.parallel.halo import ShardHalo, halo_self_test
from ocean_model_arch_torch.parallel.mesh import (auto_dims, make_mesh,
                                                  shard_field, shard_tree,
                                                  unshard_field,
                                                  unshard_tree)

torch.set_num_threads(1)

MESHES = [(2, 1), (1, 2), (2, 2), (4, 2), (2, 4), (8, 1)]
COMPARED = ("ssh", "sshp", "ubrtr", "vbrtr", "hhq", "hhu", "ff")
H = 2


def _want_ij(nx, ny, gm, gn, periodic_x, periodic_y):
    """The analytic (i+1)(j+1) at global cells (gm, gn), zero outside a
    closed domain, wrapped on a periodic axis."""
    if periodic_x:
        gm = gm % nx
    if periodic_y:
        gn = gn % ny
    inside = ((gm[:, None] >= 0) & (gm[:, None] < nx)
              & (gn[None, :] >= 0) & (gn[None, :] < ny))
    return np.where(inside, (gm[:, None] + 1.0) * (gn[None, :] + 1.0), 0.0)


@pytest.mark.parametrize("px,py", MESHES)
@pytest.mark.parametrize("periodic", [False, True])
def test_halo_exchange_ij(px, py, periodic):
    """Every cell of every shard's exchanged block equals the analytic
    global i*j (zero or wrapped outside the domain), corners included
    (tests/test_parallel.py::test_halo_exchange_ij)."""
    nx, ny = 16 * px, 8 * py
    i = np.arange(1, nx + 1)[:, None]
    j = np.arange(1, ny + 1)[None, :]
    mesh = make_mesh(px, py, "cpu")
    f = shard_field(torch.from_numpy((i * j).astype(np.float64)), mesh)
    assert f.shape == (px, py, nx // px, ny // py)
    out = ShardHalo(px, py, periodic, periodic).ex(f).numpy()
    lx, ly = nx // px, ny // py
    for bi in range(px):
        for bj in range(py):
            want = _want_ij(nx, ny, bi * lx + np.arange(-H, lx + H),
                            bj * ly + np.arange(-H, ly + H),
                            periodic, periodic)
            np.testing.assert_array_equal(out[bi, bj], want,
                                          err_msg=str((bi, bj)))


@pytest.mark.parametrize("periodic", [False, True])
def test_3d_halo_exchange(periodic):
    """A (nlev, nx, ny) stack: level k holds (k+1)*i*j and exchanges as
    the 2D field does (tests/test_3d.py::test_3d_halo_exchange)."""
    px, py, nx, ny, nlev = 2, 2, 16, 8, 3
    i = np.arange(1, nx + 1)[:, None]
    j = np.arange(1, ny + 1)[None, :]
    f = np.stack([(k + 1) * i * j for k in range(nlev)]).astype(np.float64)
    mesh = make_mesh(px, py, "cpu")
    fs = shard_field(torch.from_numpy(f), mesh)
    assert fs.shape == (nlev, px, py, nx // px, ny // py)
    out = ShardHalo(px, py, periodic, periodic).ex(fs).numpy()
    lx, ly = nx // px, ny // py
    for k in range(nlev):
        for bi in range(px):
            for bj in range(py):
                want = (k + 1) * _want_ij(
                    nx, ny, bi * lx + np.arange(-H, lx + H),
                    bj * ly + np.arange(-H, ly + H), periodic, periodic)
                np.testing.assert_array_equal(out[k, bi, bj], want)


def test_3d_kernel_equals_per_level():
    """The kernels take leading axes, which the stacked shards ride on:
    ``uv_trans_vort`` on (nlev, nx, ny) fields == each level alone, bit
    for bit, and == JAX's at 1e-12 (tests/test_3d.py::
    test_3d_kernel_equals_per_level)."""
    from ocean_model_arch_tpu.core import masks as jmk
    from ocean_model_arch_tpu.ops import stencil as jst
    from ocean_model_arch_tpu.ops import sw_kernels as jswk

    from ocean_model_arch_torch.ops import sw_kernels as swk
    from ocean_model_arch_torch.ops.stencil import pad
    nx, ny, nlev = 20, 16, 3
    rng = np.random.RandomState(11)
    int_mask = jmk.frame_of_land_mask(nx, ny)
    int_mask[2:-2, 2:-2] = (rng.rand(nx - 4, ny - 4) > 0.8).astype(np.int32)
    luu = jmk.derive_staggered_masks(jmk.lu_from_int_mask(int_mask))[1]
    m = [(1000.0 + 100.0 * rng.rand(nx, ny)).astype(np.float32)
         for _ in range(4)]
    u3, v3, vort3 = (rng.randn(nlev, nx, ny) for _ in range(3))
    args = [luu] + m

    def port(*fields):
        return swk.uv_trans_vort(*(pad(torch.from_numpy(np.asarray(a)))
                                   for a in args + list(fields)))
    got3 = port(u3, v3, vort3)
    assert got3.shape == (nlev, nx, ny)
    for k in range(nlev):
        assert torch.equal(got3[k], port(u3[k], v3[k], vort3[k]))
    want = jswk.uv_trans_vort(*(jst.pad(a) for a in args + [u3, v3, vort3]))
    np.testing.assert_allclose(got3.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("px,py", MESHES)
def test_halo_self_test_passes(px, py):
    for periodic in (False, True):
        halo_self_test(make_mesh(px, py, "cpu"), 8 * px, 6 * py,
                       periodic, not periodic)


def test_halo_self_test_names_the_shard_and_cell(monkeypatch):
    """A broken exchange (the y pass pads zeros, as if every shard's y
    edges were closed) is caught, with the shard and the cell."""
    good = halo_mod._exchange_axis

    def broken(f, axis, n, periodic, h=H):
        if axis % f.ndim == f.ndim - 1:
            return halo_mod.F.pad(f, (h, h))
        return good(f, axis, n, periodic, h)
    monkeypatch.setattr(halo_mod, "_exchange_axis", broken)
    with pytest.raises(AssertionError,
                       match=r"shard \(0,0\) cell \(2, 8\): got 0.0, "
                             r"want 7.0"):
        halo_self_test(make_mesh(2, 2, "cpu"), 12, 12)
    with pytest.raises(ValueError, match="divide"):
        halo_self_test(make_mesh(2, 2, "cpu"), 13, 12)


# ---- decomposition invariance and JAX's sharded step ------------------
def _case(kind):
    """tests/test_parallel.py's flat_case (66 x 50, all wet inside the
    frame) and island_case (64 x 48, random islands: shard seams cross
    coastlines), f64, one tracer: the JAX grid and state and the port's,
    bit-identical."""
    nx, ny = (66, 50) if kind == "flat" else (64, 48)
    basin = basinpar_flat(nx, ny)
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=1, tracer_num=1),
                      precision=Precision.f64())
    mask = frame_of_land_mask(nx, ny)
    if kind == "island":
        rng = np.random.RandomState(7)
        mask[2:-2, 2:-2] |= (rng.rand(nx - 4, ny - 4) < 0.15).astype(
            np.int32)
    jgrid = jax_build_grid(basin, mask, precision=cfg.precision)
    jstate = jax_init(jgrid, cfg)
    grid = grid_from_numpy({n: np.asarray(getattr(jgrid, n))
                            for n in GRID_FIELDS}, "cpu")
    state = state_from_numpy({n: (None if getattr(jstate, n) is None
                                  else np.asarray(getattr(jstate, n)))
                              for n in STATE_FIELDS}, "cpu")
    return cfg, jgrid, jstate, grid, state


CASES = {}


def _cached(kind):
    """The case and the port's single block after 40 steps."""
    if kind not in CASES:
        cfg, jgrid, jstate, grid, state = _case(kind)
        ref, ok = run_steps(make_step(grid, cfg), state, 1.0, 40)
        assert ok
        CASES[kind] = (cfg, jgrid, jstate, grid, state, ref)
    return CASES[kind]


def _sharded_run(cfg, grid, state, px, py, n=40):
    mesh = make_mesh(px, py, "cpu")
    gs, ss = prepare(grid, state, mesh)
    step = make_sharded_step(gs, cfg, mesh, n_inner=n)
    out, ok = step(ss, 1.0)
    assert ok is True
    return crop_state(unshard_tree(out), grid.nx, grid.ny), step


@pytest.mark.parametrize("px,py", MESHES)
@pytest.mark.parametrize("kind", ["flat", "island"])
def test_step_decomposition_invariance(kind, px, py):
    """1 x 1 vs any mesh, 40 f64 steps: the shards advance in lockstep
    through the same element-wise ops, so they end where the single
    block does (1e-12, and bit for bit on the CPU)
    (tests/test_parallel.py:83, :120)."""
    cfg, _, _, grid, state, ref = _cached(kind)
    out, _ = _sharded_run(cfg, grid, state, px, py)
    for name in COMPARED:
        a, b = getattr(out, name), getattr(ref, name)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-12, err_msg=name)
        assert torch.equal(a, b), name


@pytest.mark.parametrize("px,py", [(2, 2), (4, 2)])
@pytest.mark.parametrize("kind", ["flat", "island"])
def test_matches_jax_sharded_step(kind, px, py):
    """The port's sharded step against JAX ``make_sharded_step`` on the
    same mesh (8 virtual CPU devices), 40 f64 steps from the same numpy
    inputs, every state field at 1e-12."""
    cfg, jgrid, jstate, grid, state, _ = _cached(kind)
    mesh = jmesh.make_mesh(px, py)
    gs, ss = jax_prepare(jgrid, jstate, mesh)
    jout, jok = jax_make_sharded_step(gs, cfg, mesh, n_inner=40)(ss, 1.0)
    assert bool(jok)
    jout = jdomain.crop_state(jout, grid.nx, grid.ny)
    out, _ = _sharded_run(cfg, grid, state, px, py)
    for name in STATE_FIELDS:
        a, b = getattr(out, name), getattr(jout, name)
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12, err_msg=name)


def test_static_exchanges_hoisted():
    """The grid's exchanges are made once, when the runner is built, and
    none of them inside a step (their memo entries are hit); each step
    makes the same few exchanges, deduped and batched by field -- the
    analog of the reference's once-per-step sync lists
    (tests/test_parallel.py:138)."""
    cfg, _, _, grid, state, _ = _cached("flat")
    mesh = make_mesh(2, 2, "cpu")
    gs, ss = prepare(grid, state, mesh)
    step = make_sharded_step(gs, cfg, mesh, n_inner=1)
    hp = step.halo
    n_grid = sum(isinstance(getattr(gs, f.name), torch.Tensor)
                 for f in dataclasses.fields(gs))
    assert hp.exchanges == n_grid == len(GRID_FIELDS)
    seen = []
    orig = hp._ex

    def spy(f):
        seen.append(f)
        return orig(f)
    hp._ex = spy
    st, per_step = ss, []
    for _ in range(3):
        before = len(seen)
        st, ok = step(st, 1.0)
        assert ok
        per_step.append(len(seen) - before)
    grid_ids = {id(getattr(gs, n)) for n in GRID_FIELDS}
    assert not any(id(f) in grid_ids for f in seen)
    # the same schedule each step: 9 exchanges (the state batch of 9 f64
    # fields and r_diss, vort, sshn, the stresses, the rotated ssh pair,
    # the tracer level and its two fluxes), far fewer than the 30 fields
    assert per_step == [per_step[0]] * 3 and per_step[0] == 9
    # the memo keeps only the statics between steps
    assert len(hp._memo) == n_grid


def test_ex_batch_matches_per_field():
    """``ex_batch`` (one stacked exchange per dtype) gives bitwise the
    per-field ``ex`` results, f32 and f64 fields mixed
    (tests/test_parallel.py:179)."""
    rng = np.random.RandomState(7)
    mesh = make_mesh(2, 2, "cpu")
    fields = [shard_field(torch.from_numpy(rng.randn(16, 24).astype(dt)),
                          mesh)
              for dt in (np.float32, np.float64, np.float32, np.float64)]
    hb = ShardHalo(2, 2, periodic_x=True)
    hb.ex_batch(fields)
    assert hb.exchanges == 2                 # one a dtype
    got = [hb.ex(f) for f in fields]         # memo hits
    assert hb.exchanges == 2
    hs = ShardHalo(2, 2, periodic_x=True)
    for a, f in zip(got, fields):
        b = hs.ex(f)
        assert a.dtype == b.dtype == f.dtype
        assert torch.equal(a, b)


# ---- layout and padding helpers ------------------------------------------
def test_shard_layout_roundtrip_and_auto_dims():
    a = torch.arange(3 * 12 * 10, dtype=torch.float64).reshape(3, 12, 10)
    mesh = make_mesh(4, 2, "cpu")
    s = shard_field(a, mesh)
    assert s.shape == (3, 4, 2, 3, 5)
    assert torch.equal(s[1, 2, 1], a[1, 6:9, 5:10])
    assert torch.equal(unshard_field(s), a)
    for n in range(1, 17):
        assert auto_dims(n) == jmesh.auto_dims(n)
    with pytest.raises(ValueError, match="pad it first"):
        shard_field(a[:, :11], mesh)


@pytest.mark.parametrize("px,py", [(4, 2), (4, 3), (8, 7)])
def test_pad_grid_and_state_match_jax(px, py):
    """``pad_grid`` field by field against JAX's (masks land, metrics and
    the rest depth edge-replicated), ``pad_state`` zeros, and
    ``crop_state(pad_state(s)) == s``."""
    cfg, jgrid, jstate, grid, state, _ = _cached("island")
    assert padded_extents(64, 48, px, py) == jdomain.padded_extents(
        64, 48, px, py)
    jg = jdomain.pad_grid(jgrid, px, py)
    g = pad_grid(grid, px, py)
    assert (g.nx, g.ny) == (jg.nx, jg.ny) == padded_extents(64, 48, px, py)
    for n in GRID_FIELDS:
        a, b = getattr(g, n), np.asarray(getattr(jg, n))
        assert a.numpy().dtype == b.dtype, n
        np.testing.assert_array_equal(a.numpy(), b, err_msg=n)
    js = jdomain.pad_state(jstate, px, py)
    s = pad_state(state, px, py)
    for n in STATE_FIELDS:
        a, b = getattr(s, n), getattr(js, n)
        if b is None:
            continue
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=n)
        back = getattr(crop_state(s, 64, 48), n)
        assert torch.equal(back, getattr(state, n)), n
    # sharded and back: the padded state exactly
    mesh = make_mesh(px, py, "cpu")
    gs, ss = prepare(grid, state, mesh)
    assert gs.lu.shape == (px, py, g.nx // px, g.ny // py)
    assert ss.ff.shape == (1, px, py, g.nx // px, g.ny // py)
    round_trip = crop_state(unshard_tree(ss), 64, 48)
    for n in STATE_FIELDS:
        a = getattr(round_trip, n)
        assert a is None or torch.equal(a, getattr(state, n)), n


# ---- OceanModel on a mesh off the fused path ----------------------------
def _run_dir(path, nx=40, ny=30, steps_min=0.5, duration_days=60 / 86400,
             mod_decomposition=0, parallel_dbg=0, decomposition_file="none"):
    """The frame-basin run directory of the JAX package's OceanModel tests
    (tests/test_io_driver.py::_run_dir, 1 tracer, mu = 0 after init); the
    mesh comes from the command line's overrides (``_with``)."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "basin.par").write_text(
        f"{nx} : nx\n{ny} : ny\n1 : nz\n0 :\n0 :\n0.05d0 :\n"
        "0.04d0 :\n27.525d0 :\n40.940d0 :\n0 :\n0 :\n1 : curve\n0.0d0 :\n"
        "0.0d0 :\n90.0d0 :\n60.0d0 :\n90.0d0 :\n-90.0d0 :\n"
        "none : mask\nnone : topo\n")
    (path / "sw.par").write_text(
        "1 :\n1 :\n1 :\n0.5d0 :\n1.0d+03 :\n1 : tracers\n1 :\nnone :\n")
    (path / "parallel.par").write_text(
        f"{mod_decomposition} :\n{decomposition_file} :\n1 :\n1 :\n"
        f"{parallel_dbg} :\n0 :\nnone :\n0 :\n0 :\n")
    (path / "ocean_run.par").write_text(
        f"0 :\n1.0d0 : tau\n{duration_days} : days\n0 :\n2012 :\n"
        f"{steps_min} : out min\n-1.0 :\n0 :\n0 :\nnone :\n")
    return str(path)


def _with(cfg, **parallel):
    return dataclasses.replace(
        cfg, parallel=dataclasses.replace(cfg.parallel, **parallel))


def _verbose_run(model, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = model.run(verbose=True, **kw)
    return state, buf.getvalue()


def test_model_on_a_mesh_matches_one_block_and_jax(tmp_path):
    """``OceanModel`` 2 x 2 in f64 (the eager sharded step) == its 1 x 1
    run, and == the JAX ``OceanModel`` on the same mesh at 1e-12
    (tests/test_io_driver.py:233); the result is the plain global state
    at the basin's extents, and the GrADS records agree."""
    d = _run_dir(tmp_path)
    cfg = load_config_dir(d)
    ref = OceanModel(cfg, base_dir=d, device="cpu").run(verbose=False)
    dm = _run_dir(tmp_path / "mesh")
    model = OceanModel(_with(load_config_dir(dm), mesh_x=2, mesh_y=2),
                       base_dir=dm, device="cpu")
    assert model.compute_path() == "eager composition, sharded"
    out, text = _verbose_run(model)
    assert "MODEL: compute path: eager composition, sharded" in text
    assert "DD INFO: mesh 2x2" in text
    for f in dataclasses.fields(out):
        a, b = getattr(out, f.name), getattr(ref, f.name)
        assert a.shape == b.shape and torch.equal(a, b), f.name
    jcfg = jax_load_config_dir(dm)
    jcfg = dataclasses.replace(jcfg, parallel=dataclasses.replace(
        jcfg.parallel, mesh_x=2, mesh_y=2))
    jout = JaxOceanModel(jcfg, base_dir=str(tmp_path / "jax")).run(
        verbose=False)
    for n in ("ssh", "ubrtr", "vbrtr", "ff"):
        np.testing.assert_allclose(getattr(out, n).numpy(),
                                   np.asarray(getattr(jout, n)), rtol=0,
                                   atol=1e-12, err_msg=n)
    a = (tmp_path / "RESULTS" / "ssh.dat").read_bytes()
    assert a == (tmp_path / "mesh" / "RESULTS" / "ssh.dat").read_bytes()


ROUTES = {
    # (parallel.par overrides, f32, mu varying, nx x ny)
    "f64 4x2 padded": (dict(mesh_x=4, mesh_y=2), False, False, (42, 31)),
    "f32 varying mu 2x2": (dict(mesh_x=2, mesh_y=2), True, True, (40, 30)),
    "f32 narrow shards 8x1": (dict(mesh_x=8, mesh_y=1), True, False,
                              (40, 30)),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_routes_off_the_fused_path(tmp_path, name):
    """f64, a spatially varying mu and shards narrower than 8 cells take
    the eager sharded step (named by the 'compute path' line) and end
    where the eager composition on one block does, bit for bit (a padded
    mesh too: 42 x 31 on 4 x 2 runs 44 x 32)."""
    parallel, f32, vary, (nx, ny) = ROUTES[name]
    d = _run_dir(tmp_path, nx, ny)
    cfg = load_config_dir(d)
    if f32:
        cfg = dataclasses.replace(cfg, precision=Precision.f32())
    one, mesh = (OceanModel(c, base_dir=d, device="cpu")
                 for c in (cfg, _with(cfg, **parallel)))
    for m in (one, mesh) if vary else (one,):
        mu = m.state.mu.clone()
        mu[0, 0] = 1.0              # a land corner: changes nothing else
        m.state = dataclasses.replace(m.state, mu=mu)
    assert one.compute_path() == "eager composition"
    assert mesh.compute_path() == "eager composition, sharded"
    a, b = one.run(verbose=False), mesh.run(verbose=False)
    for n in ("ssh", "ubrtr", "vbrtr", "ff", "hhq"):
        assert torch.equal(getattr(a, n), getattr(b, n)), n
    assert b.ssh.shape == (nx, ny)


def test_halo_self_test_at_debug2(tmp_path):
    """parallel_dbg >= 2 on a mesh runs the halo self-test on the padded
    extents before the loop (tests/test_io_driver.py:338); at 3 it also
    writes the decomposition the eager mesh runs."""
    d = _run_dir(tmp_path, 42, 40, steps_min=-1.0,
                 duration_days=4 / 86400, parallel_dbg=3)
    model = OceanModel(_with(load_config_dir(d), mesh_x=4, mesh_y=3),
                       base_dir=d, device="cpu")
    _, text = _verbose_run(model)
    assert "SYNC INFO: halo self-test passed (4x3 mesh)" in text
    assert "MODEL: compute path: eager composition, sharded" in text
    dump = (tmp_path / "RESULTS" / "decomposition.txt").read_text()
    assert "DD INFO: Print decomposition in file" in text
    from ocean_model_arch_torch.parallel.decomposition import \
        read_decomposition
    dec = read_decomposition(str(tmp_path / "RESULTS" / "decomposition.txt"),
                             nx=42, ny=40)
    assert list(dec.x_edges) == [0, 11, 22, 33, 42], dump
    assert list(dec.y_edges) == [0, 14, 28, 40], dump


def test_a_broken_exchange_fails_the_run_at_debug2(tmp_path, monkeypatch):
    """The self-test's failure is not caught: the run stops before its
    first step."""
    d = _run_dir(tmp_path, steps_min=-1.0, parallel_dbg=2)
    model = OceanModel(_with(load_config_dir(d), mesh_x=2, mesh_y=2),
                       base_dir=d, device="cpu")
    monkeypatch.setattr(halo_mod, "_exchange_axis",
                        lambda f, axis, n, periodic, h=H:
                        halo_mod.F.pad(f, (0, 0) * (f.ndim - 1 - axis % f.ndim)
                                       + (h, h)))
    with pytest.raises(AssertionError, match="halo self-test failed at "
                                             r"shard \(0,0\)"):
        model.run(verbose=False)
    assert model.num_step == 0


def test_mod_decomposition_on_the_eager_mesh(tmp_path, capsys):
    """mod_decomposition = 1 off the fused path prints JAX's fallback line
    and runs uniform cuts; = 2 (cuts from a file) is refused at
    construction with the blocker named (tests/test_io_driver.py:412)."""
    d = _run_dir(tmp_path, mod_decomposition=1)
    model = OceanModel(_with(load_config_dir(d), mesh_x=2, mesh_y=2),
                       base_dir=d, device="cpu")
    out = capsys.readouterr().out
    assert re.search(r"MODEL: mod_decomposition=1 \(weighted cuts\) needs the "
                     r"fused-sharded path, which this config cannot select "
                     r"\(f64 precision\); falling back to uniform cuts on "
                     r"the eager sharded path", out), out
    assert model.compute_path() == "eager composition, sharded"
    d2 = _run_dir(tmp_path / "file", mod_decomposition=2,
                  decomposition_file="cuts.txt")
    from ocean_model_arch_torch.parallel import decomposition as dd
    intm = (model.grid.lu.numpy() < 0.5).astype(np.int32)
    dd.dump_decomposition(dd.assign_uniform(dd.block_weights(intm, 2, 2),
                                            2, 2),
                          str(tmp_path / "file" / "cuts.txt"))
    with pytest.raises(ValueError, match=r"mod_decomposition=2 .*f64 "
                                         r"precision"):
        OceanModel(_with(load_config_dir(d2), mesh_x=2, mesh_y=2),
                   base_dir=d2, device="cpu")


def test_blowup_on_the_eager_mesh_names_the_cell(tmp_path):
    """A NaN at a wet cell trips the guard on the mesh; the message names
    that cell of the cropped global state and the step, as the single
    block's does."""
    d = _run_dir(tmp_path, steps_min=-1.0, duration_days=6 / 86400)
    msgs = []
    for mesh in ((1, 1), (2, 2)):
        model = OceanModel(_with(load_config_dir(d), mesh_x=mesh[0],
                                 mesh_y=mesh[1]), base_dir=d, device="cpu")
        ssh = model.state.ssh.clone()
        ssh[27, 11] = float("nan")
        model.state = dataclasses.replace(model.state, ssh=ssh)
        with pytest.raises(FloatingPointError) as e:
            model.run(verbose=False)
        msgs.append(str(e.value))
    # the NaN's neighbour m=26 (the first bad cell in row order) after
    # step 1, in the basin's own indices
    assert "in the point m=26 n=11 ssh=nan at step 1" in msgs[1], msgs[1]
    assert msgs[0] == msgs[1]


def test_main_runs_a_mesh_in_f64(tmp_path, capsys):
    """``python -m ocean_model_arch_torch DIR --mesh 2x2`` without
    ``--f32`` (the CLI's default f64 validation) runs the eager sharded
    step."""
    d = _run_dir(tmp_path)
    ck = str(tmp_path / "ck.npz")
    assert main([d, "--device", "cpu", "--mesh", "2x2",
                 "--checkpoint", ck]) == 0
    out = capsys.readouterr().out
    assert "MODEL: compute path: eager composition, sharded" in out
    assert "MODEL: step 60/60" in out
    from ocean_model_arch_torch.io.checkpoint import load_checkpoint
    st, step = load_checkpoint(ck, device="cpu")
    assert step == 60 and st.ssh.shape == (40, 30)
