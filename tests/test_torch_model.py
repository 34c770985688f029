"""The port's entry point on the CPU: ``OceanModel`` and ``python -m
ocean_model_arch_torch`` on the run directories of the JAX package's own
``OceanModel`` tests (the Black Sea 289 x 163 mask, small frame basins), against the JAX
``OceanModel`` (final state, GrADS output, checkpoints read across the two
packages), with the route each configuration selects and the routes this
port leaves out."""

import contextlib
import dataclasses
import io
import os
import re
import shutil

import numpy as np
import pytest
import torch

from ocean_model_arch_tpu.io import grads as jgrads
from ocean_model_arch_tpu.io.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from ocean_model_arch_tpu.io.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from ocean_model_arch_tpu.model.model import OceanModel as JaxOceanModel
from ocean_model_arch_tpu.model.model import \
    load_config_dir as jax_load_config_dir
from ocean_model_arch_tpu.parallel import decomposition as jdd

from ocean_model_arch_torch.__main__ import main
from ocean_model_arch_torch.config import ParallelConfig, Precision
from ocean_model_arch_torch.core.state import STATE_FIELDS
from ocean_model_arch_torch.io import grads
from ocean_model_arch_torch.io.checkpoint import (load_checkpoint,
                                                  load_checkpoint_sharded,
                                                  save_checkpoint)
from ocean_model_arch_torch.model.model import OceanModel, load_config_dir
from ocean_model_arch_torch.parallel import decomposition as dd

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS_MASK = os.path.join(REPO, "data/BS/mask_bs4km.txt")


def _run_dir(path, mask_path, nx, ny, steps_min=1.0, duration_days=0.0007,
             tau=1.0, mod_decomposition=0, decomposition_file="none",
             parallel_dbg=0, periodic_x=0):
    """The run directory the JAX package's ``OceanModel`` tests write."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "basin.par").write_text(
        f"{nx} : nx\n{ny} : ny\n1 : nz\n{periodic_x} :\n0 :\n0.05d0 :\n"
        "0.04d0 :\n27.525d0 :\n40.940d0 :\n0 :\n0 :\n1 : curve\n0.0d0 :\n"
        "0.0d0 :\n90.0d0 :\n60.0d0 :\n90.0d0 :\n-90.0d0 :\n"
        f"{mask_path} : mask\nnone : topo\n")
    (path / "sw.par").write_text(
        "1 :\n1 :\n1 :\n0.5d0 :\n1.0d+03 :\n1 : tracers\n1 :\nnone :\n")
    (path / "parallel.par").write_text(
        f"{mod_decomposition} :\n{decomposition_file} :\n1 :\n1 :\n"
        f"{parallel_dbg} :\n0 :\nnone :\n0 :\n0 :\n")
    (path / "ocean_run.par").write_text(
        f"0 :\n{tau}d0 : tau\n{duration_days} : days\n0 :\n2012 :\n"
        f"{steps_min} : out min\n-1.0 :\n0 :\n0 :\nnone :\n")
    return str(path)


def _small(path, **kw):
    """40 x 30 frame basin, 60 steps in windows of 30."""
    return _run_dir(path, "none", 40, 30, steps_min=0.5,
                    duration_days=60.0 / 86400.0, **kw)


def _f32(cfg, **parallel):
    return dataclasses.replace(
        cfg, precision=Precision.f32(),
        parallel=dataclasses.replace(cfg.parallel, **parallel))


def _run(cfg, d, **kw):
    return OceanModel(cfg, base_dir=d, device="cpu").run(verbose=False, **kw)


def _compute_path(model, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        model.run(verbose=True, **kw)
    return re.search(r"MODEL: compute path: (.*)", buf.getvalue()).group(1)


def test_black_sea_f64_matches_jax(tmp_path):
    """60 f64 steps on the Black Sea mask with a tracer: the final state
    against JAX ``OceanModel.run`` < 1e-12 (ssh, u, v, ff; the eager
    kernels' tolerance), the .ctl files equal as text, the .dat records
    < 1e-6 (they are real4)."""
    dj = _run_dir(tmp_path / "jax", BS_MASK, 289, 163)
    dt = _run_dir(tmp_path / "torch", BS_MASK, 289, 163)
    want = JaxOceanModel(jax_load_config_dir(dj), base_dir=dj).run(
        verbose=False)
    cfg = load_config_dir(dt)
    assert cfg.run.num_step_max == 60
    model = OceanModel(cfg, base_dir=dt, device="cpu")
    ck = str(tmp_path / "ck.npz")
    assert _compute_path(model, checkpoint_path=ck) == "eager composition"
    got = model.state
    for n in ("ssh", "ubrtr", "vbrtr", "ff"):
        a, b = getattr(got, n).numpy(), np.asarray(getattr(want, n))
        assert a.dtype == np.float64
        assert np.abs(a - b).max() <= 1e-12 * max(np.abs(b).max(), 1.0), n
    for name, nrec in (("ssh", 2), ("hhq", 1), ("ff1", 2)):
        pj = os.path.join(dj, "RESULTS", name)
        pt = os.path.join(dt, "RESULTS", name)
        assert open(pt + ".ctl").read() == open(pj + ".ctl").read(), name
        for r in range(1, nrec + 1):
            a = grads.read_record(pt + ".dat", r, 289, 163)
            b = jgrads.read_record(pj + ".dat", r, 289, 163)
            assert np.abs(a - b).max() < 1e-6 * max(np.abs(b).max(), 1.0)
        assert os.path.getsize(pt + ".dat") == os.path.getsize(pj + ".dat")
    # the checkpoint round-trips bit-exactly
    st, step = load_checkpoint(ck, device="cpu")
    assert step == 60 and torch.equal(st.ssh, got.ssh)


def test_blowup_names_step_and_wet_cell(tmp_path):
    """An unstable run (tau far beyond the gravity-wave CFL) aborts naming
    the offending step and a wet cell, as the JAX model does."""
    d = _run_dir(tmp_path, BS_MASK, 289, 163, steps_min=-1.0,
                 duration_days=0.5, tau=1000.0)
    model = OceanModel(load_config_dir(d), base_dir=d, device="cpu")
    with pytest.raises(FloatingPointError) as ei:
        model.run(verbose=False)
    msg = str(ei.value)
    assert "in the point m=" in msg and "at step" in msg, msg
    m = int(re.search(r"m=(\d+)", msg).group(1))
    n = int(re.search(r"n=(\d+)", msg).group(1))
    assert model.grid.lu[m, n] > 0.5


@pytest.mark.parametrize("mesh", [(1, 1), (2, 2)])
def test_blowup_on_a_fused_route_names_the_kernels_tile(tmp_path, mesh):
    d = _run_dir(tmp_path, "none", 40, 30, steps_min=-1.0,
                 duration_days=0.5, tau=1000.0)
    cfg = _f32(load_config_dir(d), mesh_x=mesh[0], mesh_y=mesh[1])
    model = OceanModel(cfg, base_dir=d, device="cpu")
    with pytest.raises(FloatingPointError) as ei:
        model.run(verbose=False)
    msg = str(ei.value)
    assert "in the point m=" in msg and "tile (" in msg, msg
    assert ("shard (" in msg) == (mesh != (1, 1)), msg


def test_checkpoints_cross_the_packages(tmp_path):
    """A checkpoint written by the port is read by the JAX package and
    the reverse: the same fields, dtypes, values and step."""
    d = _small(tmp_path)
    cfg = load_config_dir(d)
    model = OceanModel(cfg, base_dir=d, device="cpu")
    ours = str(tmp_path / "torch.npz")
    save_checkpoint(ours, model.state, 17)
    jst, step = jax_load_checkpoint(ours)
    assert step == 17
    for n in STATE_FIELDS:
        a, b = getattr(model.state, n), getattr(jst, n)
        assert (a is None) == (b is None), n
        if a is not None:
            assert a.numpy().dtype == np.asarray(b).dtype, n
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), n)
    theirs = str(tmp_path / "jax.npz")
    jmodel = JaxOceanModel(jax_load_config_dir(d), base_dir=d)
    jax_save_checkpoint(theirs, jmodel.state, 23)
    st, step = load_checkpoint(theirs, device="cpu")
    assert step == 23
    for n in STATE_FIELDS:
        a, b = getattr(st, n), getattr(jmodel.state, n)
        assert (a is None) == (b is None), n
        if a is not None:
            assert a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), n)
    # the two files hold the same entries
    with np.load(ours) as za, np.load(theirs) as zb:
        assert sorted(za.files) == sorted(zb.files)


@pytest.mark.parametrize("route", ["f64 eager", "f32 fused", "f32 2x2",
                                   "f32 periodic", "f64 2x2"])
def test_resume_equals_the_straight_run(tmp_path, route):
    """Running 2 N steps straight == running N, checkpointing, resuming N,
    bit for bit, on every route (f64 2x2: the eager sharded step, which
    lays the resumed state out on the mesh)."""
    d = _small(tmp_path, periodic_x=int(route == "f32 periodic"))
    cfg = load_config_dir(d)
    if route == "f64 2x2":
        cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, mesh_x=2, mesh_y=2))
    elif route != "f64 eager":
        cfg = _f32(cfg, **({"mesh_x": 2, "mesh_y": 2} if route == "f32 2x2"
                           else {}))
    full = _run(cfg, d)
    half = dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, run_duration_days=30.0 / 86400.0))
    ck = str(tmp_path / "half.npz")
    _run(half, d, checkpoint_path=ck)
    resumed = dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, start_type=1))
    final = _run(resumed, d, checkpoint_path=ck)
    for n in ("ssh", "sshp", "ubrtr", "vbrtr", "ff", "hhq"):
        assert torch.equal(getattr(final, n), getattr(full, n)), n


def test_restart_points_during_the_run(tmp_path):
    """``checkpoint_every`` writes restart points DURING the run; resuming
    from the mid-run one reproduces the straight run exactly."""
    d = _small(tmp_path)
    cfg = load_config_dir(d)
    full = _run(cfg, d)
    ck = str(tmp_path / "restart.npz")
    m = OceanModel(cfg, base_dir=d, device="cpu")
    orig_out = m._output

    def crash_in_the_second_window(state, nrec):
        orig_out(state, nrec)
        if nrec >= 3:
            assert os.path.exists(ck)
            raise KeyboardInterrupt
    m._output = crash_in_the_second_window
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(KeyboardInterrupt):
        m.run(checkpoint_path=ck, verbose=True, checkpoint_every=30)
    assert "restart point at step 30" in buf.getvalue()
    assert load_checkpoint(ck, device="cpu")[1] == 30
    resumed = dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, start_type=1))
    final = _run(resumed, d, checkpoint_path=ck)
    assert torch.equal(final.ssh, full.ssh)


def test_reads_binary_bathymetry(tmp_path):
    """bottom_topography_file_name != none: real4 record ingestion, from
    a record the port's own ``io/grads.py`` wrote."""
    nx, ny = 40, 30
    d = _run_dir(tmp_path, "none", nx, ny, steps_min=0.5,
                 duration_days=30.0 / 86400.0)
    depth = np.zeros((nx, ny))
    depth[2:-2, 2:-2] = 50.0 + np.linspace(0, 100, nx - 4)[:, None]
    lu = np.zeros((nx, ny), np.float32)
    lu[2:-2, 2:-2] = 1.0
    grads.write_record(str(tmp_path / "topo.dat"), 1, depth, lu)
    bp = (tmp_path / "basin.par").read_text().replace(
        "none : topo", "topo.dat : topo")
    (tmp_path / "basin.par").write_text(bp)
    for cfg in (load_config_dir(d), _f32(load_config_dir(d))):
        m = OceanModel(cfg, base_dir=d, device="cpu")
        np.testing.assert_allclose(m.grid.hhq_rest.numpy()[2:-2, 2:-2],
                                   depth[2:-2, 2:-2].astype(np.float32))
        assert bool(torch.isfinite(m.run(verbose=False).ssh).all())
    assert m._fused.hr_const is None        # the f32 run: bathymetry planes


def test_decomposition_config_tail(tmp_path):
    """parallel.par's decomposition tail: parallel_dbg >= 3 writes
    decomposition.txt, unknown modes abort, and mod_decomposition=2 reads
    cut lines back from a decomposition.txt-format file."""
    d = _run_dir(tmp_path / "a", BS_MASK, 289, 163, steps_min=-1.0,
                 duration_days=0.00002, parallel_dbg=3)
    cfg = load_config_dir(d)
    assert cfg.parallel.debug_level == 3
    model = OceanModel(cfg, base_dir=d, device="cpu")
    model.run(verbose=False)
    p = os.path.join(d, "RESULTS", "decomposition.txt")
    back = dd.read_decomposition(p)
    assert (back.bnx, back.bny) == (1, 1)
    wet = int((model.grid.lu > 0.5).sum())
    assert int(back.weights.sum()) == wet
    # the JAX package reads the port's dump as its own
    assert int(jdd.read_decomposition(p).weights.sum()) == wet

    d2 = _run_dir(tmp_path / "bad", BS_MASK, 289, 163, mod_decomposition=7)
    with pytest.raises(ValueError, match="Unknown decomposition mode"):
        OceanModel(load_config_dir(d2), base_dir=d2, device="cpu")

    intm = (model.grid.lu.numpy() < 0.5).astype(np.int32)
    dec = dd.assign_uniform(dd.block_weights(intm, 2, 2), 1, 1)
    dd.dump_decomposition(dec, str(tmp_path / "cuts.txt"))
    d3 = _run_dir(tmp_path / "m2", BS_MASK, 289, 163, mod_decomposition=2,
                  decomposition_file=str(tmp_path / "cuts.txt"))
    m3 = OceanModel(load_config_dir(d3), base_dir=d3, device="cpu")
    xe, ye = m3._file_cuts
    assert xe[0] == 0 and xe[-1] == 289 and len(xe) == 2   # mesh 1x1
    assert ye[0] == 0 and ye[-1] == 163


def test_cut_line_policy_decided_at_init(tmp_path):
    """Non-uniform cut lines are a construction-time decision. Where the
    fused-sharded path cannot be selected (f64 here; the JAX test uses
    its CPU backend) mod_decomposition=2 raises at ``OceanModel()`` with
    the blocker named; where it can, the file's cuts are the shards'."""
    d = _run_dir(tmp_path, BS_MASK, 289, 163, duration_days=4.0 / 86400.0,
                 steps_min=-1.0)
    cfg = load_config_dir(d)
    intm = (OceanModel(cfg, base_dir=d, device="cpu").grid.lu.numpy()
            < 0.5).astype(np.int32)
    dec = dd.assign_uniform(dd.block_weights(intm, 2, 2), 2, 1)
    cuts = str(tmp_path / "cuts2.txt")
    dd.dump_decomposition(dec, cuts)
    par = ParallelConfig(mod_decomposition=2, file_decomposition=cuts,
                         mesh_x=2, mesh_y=1)
    with pytest.raises(ValueError, match="f64 precision"):
        OceanModel(dataclasses.replace(cfg, parallel=par), base_dir=d,
                   device="cpu")
    om = OceanModel(dataclasses.replace(cfg, parallel=par,
                                        precision=Precision.f32()),
                    base_dir=d, device="cpu")
    assert _compute_path(om) == "fused CUDA kernel, sharded"
    xe, ye = jdd.cuts_from_decomposition(jdd.read_decomposition(
        cuts, nx=289, ny=163), 2, 1)
    assert list(om._fused_sh.x_edges) == [0, int(xe[1]), 289]
    assert list(om._fused_sh.y_edges) == [0, 163]
    # weighted cuts (mod_decomposition=1) on the same mesh
    ow = OceanModel(dataclasses.replace(
        cfg, precision=Precision.f32(), parallel=ParallelConfig(
            mod_decomposition=1, mesh_x=2, mesh_y=1)), base_dir=d,
        device="cpu")
    ow.run(verbose=False)
    np.testing.assert_array_equal(ow._fused_sh.x_edges,
                                  jdd.weighted_x_edges(intm, 2, min_width=4))


ROUTES = {
    "f32 closed": ({}, 0, "fused CUDA kernel"),
    "f32 periodic": ({}, 1, "fused CUDA kernel, periodic (1x1 wrap)"),
    "f32 mesh 2x2": ({"mesh_x": 2, "mesh_y": 2}, 0,
                     "fused CUDA kernel, sharded"),
    "f32 periodic mesh 2x1": ({"mesh_x": 2}, 1,
                              "fused CUDA kernel, sharded"),
    "f64": (None, 0, "eager composition"),
    "f64 periodic": (None, 1, "eager composition"),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_selection(tmp_path, name):
    """The route follows from the configuration, not from the platform,
    and the 'compute path' line names it; every f32 route ends where the
    f32 eager composition does (< 1e-5, and the closed 2x2 mesh exactly
    where the single block does)."""
    parallel, periodic, want = ROUTES[name]
    d = _small(tmp_path, periodic_x=periodic)
    cfg = load_config_dir(d)
    if parallel is not None:
        cfg = _f32(cfg, **parallel)
    model = OceanModel(cfg, base_dir=d, device="cpu")
    assert _compute_path(model) == want
    assert model.compute_path() == want
    if parallel is None:
        return
    # the same run on the eager composition: mu varying by one cell
    eager = OceanModel(_f32(load_config_dir(d)), base_dir=d, device="cpu")
    mu = eager.state.mu.clone()
    mu[0, 0] = 1.0                       # a land corner: changes nothing
    eager.state = dataclasses.replace(eager.state, mu=mu)
    assert _compute_path(eager) == "eager composition"
    for n in ("ssh", "ubrtr", "vbrtr", "ff"):
        a, b = getattr(model.state, n), getattr(eager.state, n)
        assert float((a - b).abs().max()) < 1e-5 * float(b.abs().max()), n
    if name == "f32 mesh 2x2":
        single = _run(_f32(load_config_dir(d)), d)
        assert torch.equal(model.state.ssh, single.ssh)
        assert torch.equal(model.state.ff, single.ff)


LEFT_OUT = {
    "orbax format": ({}, {"checkpoint_format": "orbax"}, "f32 2x2"),
    "checkpoint directory": ({}, {"checkpoint_path": "."}, "f64 2x2"),
}


@pytest.mark.parametrize("name", sorted(LEFT_OUT))
def test_routes_left_out_raise(tmp_path, name):
    """The routes that raised until the sharded checkpoint was ported --
    ``checkpoint_format="orbax"`` and a checkpoint directory -- write the
    port's per-shard directory (its own format, not orbax; the fused
    route on a 2 x 2 mesh in f32, the eager one in f64): it reads back as
    the final state bit for bit, and a run resumed from it half way
    equals the straight run bit for bit."""
    dir_kw, run_kw, route = LEFT_OUT[name]
    d = _small(tmp_path / "run", **dir_kw)
    cfg = load_config_dir(d)
    cfg = (_f32(cfg, mesh_x=2, mesh_y=2) if route == "f32 2x2" else
           dataclasses.replace(cfg, parallel=dataclasses.replace(
               cfg.parallel, mesh_x=2, mesh_y=2)))
    ck = str(tmp_path / "ck")
    run_kw = {"checkpoint_path": ck, **run_kw}
    if run_kw["checkpoint_path"] == ".":
        os.makedirs(ck)
        run_kw["checkpoint_path"] = ck
    model = OceanModel(cfg, base_dir=d, device="cpu")
    full = model.run(verbose=False, **run_kw)
    assert model.num_step == 60
    assert os.path.isfile(os.path.join(ck, "index.json"))
    back, step = load_checkpoint_sharded(ck, device="cpu")
    assert step == 60
    for n in STATE_FIELDS:
        a, b = getattr(full, n), getattr(back, n)
        assert (a is None) == (b is None), n
        assert a is None or torch.equal(a, b), n
    half = dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, run_duration_days=cfg.run.run_duration_days / 2))
    OceanModel(half, base_dir=d, device="cpu").run(verbose=False, **run_kw)
    assert load_checkpoint_sharded(ck, device="cpu")[1] == 30
    resumed = dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, start_type=1))
    final = OceanModel(resumed, base_dir=d, device="cpu").run(
        verbose=False, **run_kw)
    for n in ("ssh", "sshp", "ubrtr", "vbrtr", "ff", "hhq"):
        assert torch.equal(getattr(final, n), getattr(full, n)), n


def test_entry_points_raise_without_a_card(tmp_path):
    """``OceanModel``, ``main`` and ``load_checkpoint`` run on the card
    unless asked for the CPU: without one they raise, they do not fall
    back."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    d = _small(tmp_path)
    cfg = load_config_dir(d)
    with pytest.raises(RuntimeError, match="CUDA"):
        OceanModel(cfg, base_dir=d)
    with pytest.raises(RuntimeError, match="CUDA"):
        main([d, "--f32", "--quiet"])
    assert not os.path.exists(os.path.join(d, "RESULTS"))
    ck = str(tmp_path / "ck.npz")
    save_checkpoint(ck, OceanModel(cfg, base_dir=d, device="cpu").state, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_checkpoint(ck)
    assert load_checkpoint(ck, device="cpu")[1] == 0


def test_main_runs_the_flat_basin_example_on_the_cpu(tmp_path, capsys):
    """``main([dir, "--device", "cpu"])`` on examples/01_flat_basin (a
    copy, its 604 steps cut to 120: two output windows)."""
    d = str(tmp_path / "01_flat_basin")
    shutil.copytree(os.path.join(REPO, "examples", "01_flat_basin"), d)
    par = os.path.join(d, "ocean_run.par")
    text = open(par).read()
    assert "0.007   : duration days" in text
    open(par, "w").write(text.replace("0.007   : duration days",
                                      "0.00139 : duration days"))
    ck = os.path.join(d, "CHECKPOINTS", "ck.npz")
    assert main([d, "--device", "cpu", "--f32", "--mesh", "auto",
                 "--checkpoint", ck]) == 0
    out = capsys.readouterr().out
    assert "MODEL: auto mesh 1x1" in out
    # trans_terms = 0 in this example: the kernel's form without advection
    assert "MODEL: compute path: fused CUDA kernel" in out
    assert "MODEL: step 120/120" in out and "TIMER REPORT" in out
    assert "wet_points_per_sec" in out
    assert load_checkpoint(ck, device="cpu")[1] == 120
    ssh = grads.read_record(os.path.join(d, "RESULTS", "ssh.dat"), 3, 258,
                            258)
    assert np.isfinite(ssh).all() and 0 < np.abs(ssh).max() < 1.0
    meta = grads.read_ctl(os.path.join(d, "RESULTS", "ssh.ctl"))
    assert (meta["nx"], meta["ny"], meta["nt"]) == (254, 254, 3)


def test_main_mesh_option_reaches_the_sharded_route(tmp_path, capsys):
    d = _small(tmp_path)
    assert main([d, "--device", "cpu", "--f32", "--mesh", "2x2"]) == 0
    out = capsys.readouterr().out
    assert "DD INFO: mesh 2x2" in out
    assert "MODEL: compute path: fused CUDA kernel, sharded" in out


def test_startup_report_matches_jax(tmp_path):
    """The DD INFO lines (mesh, wet fraction, balance, weighted x cuts)
    are the JAX model's; the memory lines are the port's own."""
    d = _run_dir(tmp_path, BS_MASK, 289, 163)
    cfg = _f32(load_config_dir(d), mesh_x=2)
    jcfg = jax_load_config_dir(d)
    jcfg = dataclasses.replace(
        jcfg, precision=type(jcfg.precision).f32(),
        parallel=dataclasses.replace(jcfg.parallel, mesh_x=2))
    got = OceanModel(cfg, base_dir=d, device="cpu").startup_report()
    want = JaxOceanModel(jcfg, base_dir=d).startup_report()

    def dd_lines(text):
        return [ln for ln in text.splitlines() if ln.startswith("DD INFO")]
    assert len(dd_lines(got)) == 2 and dd_lines(got) == dd_lines(want)
    assert "MEMORY REPORT" in got and "-- state:" in got and "TOTAL" in got
