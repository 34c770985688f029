"""The port across OS processes (counterpart of tests/test_multiprocess.py).

N processes of ``scripts/multiprocess_worker_torch.py``, wired by
``torch.distributed`` over Gloo on the CPU (``parallel/multihost.py``;
a ``file://`` store under the test's own directory, no TCP port), run
one model over a mesh whose shards they share, and must equal the
port's one-process run bit for bit:

- the eager sharded step on 2 x 1 over 2 processes, with the halo
  self-test across them, a sharded checkpoint written and read back
  across the process boundary mid-run, and the timer table reduced over
  the ranks;
- ``FusedSharded2DModel`` on 2 x 2 over 4 processes, both axes and the
  corners crossing processes, on the spherical and the bipolar grid;
- ``python -m ocean_model_arch_torch`` over 2 processes, eager (f64) and
  fused (f32), with a sharded checkpoint.

The one-process run is held against the JAX package's single-process
``make_sharded_step`` / ``FusedSharded2DModel(interpret=True)`` on the
same numpy inputs, at the tolerances of tests/test_torch_sharded.py (f64,
1e-12) and tests/test_torch_sharded2d.py (f32, 1e-5). Also the mesh's
owners and the process group's one-process defaults.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocean_model_arch_tpu.config import (ModelConfig as JModelConfig,
                                         Precision as JPrecision,
                                         SWConfig as JSWConfig,
                                         basinpar_flat as jbasinpar_flat)
from ocean_model_arch_tpu.core.grid import build_grid as jax_build_grid
from ocean_model_arch_tpu.core.masks import frame_of_land_mask
from ocean_model_arch_tpu.core.state import SWState as JState
from ocean_model_arch_tpu.model.fused_sharded2d import \
    FusedSharded2DModel as JaxSharded
from ocean_model_arch_tpu.model.sharded import \
    make_sharded_step as jax_make_sharded_step
from ocean_model_arch_tpu.model.sharded import prepare as jax_prepare
from ocean_model_arch_tpu.parallel import domain as jdomain
from ocean_model_arch_tpu.parallel import mesh as jmesh

from ocean_model_arch_torch.core.state import STATE_FIELDS
from ocean_model_arch_torch.io.checkpoint import load_checkpoint_sharded
from ocean_model_arch_torch.model.fused_sharded2d import FusedSharded2DModel
from ocean_model_arch_torch.model.model import OceanModel, load_config_dir
from ocean_model_arch_torch.model.sharded import make_sharded_step, prepare
from ocean_model_arch_torch.model.step import make_step, run_steps
from ocean_model_arch_torch.parallel import multihost
from ocean_model_arch_torch.parallel.domain import crop_state
from ocean_model_arch_torch.parallel.mesh import (Mesh, make_mesh,
                                                  process_grid, unshard_tree)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "multiprocess_worker_torch.py")
sys.path.insert(0, os.path.join(REPO, "scripts"))
import multiprocess_worker_torch as mw  # noqa: E402

WORKER_TIMEOUT = 300        # seconds: a hung rendezvous fails the test
TOL_F32 = 1e-5              # tests/test_torch_sharded2d.py's TOL


def _spawn(cmds, cwd=REPO):
    """Start every command, wait for all (killing all past the timeout),
    and return their outputs; fails on a non-zero exit."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(c, cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0].decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a process did not end within {WORKER_TIMEOUT} s")
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"process {i} failed:\n{outs[i][-3000:]}"
    return outs


def _workers(tmp_path, nproc, mode):
    store = f"file://{tmp_path}/store"
    return _spawn([[sys.executable, WORKER, str(r), str(nproc), store,
                    str(tmp_path), mode, "--device", "cpu"]
                   for r in range(nproc)])


def _jax_inputs(nproc, curve_grid=1, f64=False):
    """The worker's workload in the JAX package's types: its grid (JAX's
    build_grid equals the port's bit for bit) and the port's initial
    state as numpy."""
    nx, ny = 8 * max(nproc, 2), 24
    basin = jbasinpar_flat(nx, ny, curve_grid=curve_grid, rlon=27.5,
                           rlat=41.0)
    prec = JPrecision.f64() if f64 else JPrecision.f32()
    cfg = JModelConfig(basin=basin, sw=JSWConfig(use_tracers=1,
                                                 tracer_num=1),
                       precision=prec)
    jgrid = jax_build_grid(basin, frame_of_land_mask(nx, ny), precision=prec)
    _, _, state = mw.build_workload(nproc, curve_grid, f64=f64)
    jstate = JState(**{n: (None if getattr(state, n) is None
                           else jnp.asarray(getattr(state, n).numpy()))
                       for n in STATE_FIELDS})
    return jgrid, cfg, jstate


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("nproc", [2])
def test_multiprocess_matches_single_process(nproc, tmp_path):
    """The eager sharded step on (2, 1) over 2 processes == the same mesh
    in one process bit for bit, before and after a sharded checkpoint
    written and read back into place across the process boundary; the
    reduced timer table names the processes and gives max/min over them
    (a phase one rank alone ran appears); a NaN in one rank's block trips
    every rank's guard (the workers assert it). The one-process run ==
    the 1 x 1 eager step bit for bit, and == JAX ``make_sharded_step`` on
    2 virtual devices at 1e-12 (f64)."""
    _workers(tmp_path, nproc, "eager")
    assert (tmp_path / "ok").exists()
    timers = (tmp_path / "timers.txt").read_text()
    assert f"{nproc} processes" in timers and "max/min" in timers
    assert "only_rank0" in timers and f"only_rank{nproc - 1}" in timers
    cols = [ln for ln in timers.splitlines()
            if ln.startswith("model_step")][0].split()
    assert float(cols[1]) == 1.0 + (nproc - 1) and float(cols[2]) == 1.0
    index = (tmp_path / "ckpt" / "index.json").read_text()
    assert '"world": 2' in index and "not orbax" in index

    grid, cfg, state = mw.build_workload(nproc, f64=True)
    mesh = make_mesh(nproc, 1, "cpu")
    gs, ss = prepare(grid, state, mesh)
    mid, ok = make_sharded_step(gs, cfg, mesh, n_inner=mw.N1)(ss, 1.0)
    assert ok
    end, ok = make_sharded_step(gs, cfg, mesh, n_inner=mw.N2)(mid, 1.0)
    assert ok
    mid = crop_state(unshard_tree(mid), grid.nx, grid.ny)
    end = crop_state(unshard_tree(end), grid.nx, grid.ny)
    got_mid = np.load(tmp_path / "mid.npz")
    got_end = np.load(tmp_path / "end.npz")
    for name, got, want in (
            ("mid ssh", got_mid["ssh"], mid.ssh),
            ("mid u", got_mid["u"], mid.ubrtr),
            ("mid tracer", got_mid["tr"], mid.ff[0]),
            ("end ssh", got_end["ssh"], end.ssh),
            ("end u", got_end["u"], end.ubrtr),
            ("end v", got_end["v"], end.vbrtr),
            ("end tracer", got_end["tr"], end.ff[0])):
        np.testing.assert_array_equal(
            got, want.numpy(), err_msg=f"{name}: the processes' run "
            "diverged from the one-process run")
    assert np.abs(got_end["u"]).max() > 0

    block, ok = run_steps(make_step(grid, cfg), state, 1.0, mw.N1 + mw.N2)
    assert ok
    for n in ("ssh", "ubrtr", "vbrtr", "ff"):
        assert torch.equal(getattr(end, n), getattr(block, n)), n

    jgrid, jcfg, jstate = _jax_inputs(nproc, f64=True)
    jm = jmesh.make_mesh(nproc, 1, jax.devices()[:nproc])
    jgs, jss = jax_prepare(jgrid, jstate, jm)
    jmid, jok = jax_make_sharded_step(jgs, jcfg, jm, n_inner=mw.N1)(
        jss, 1.0)
    jend, jok2 = jax_make_sharded_step(jgs, jcfg, jm, n_inner=mw.N2)(
        jmid, 1.0)
    assert bool(jok) and bool(jok2)
    jend = jdomain.crop_state(jend, grid.nx, grid.ny)
    for n in STATE_FIELDS:
        a, b = getattr(end, n), getattr(jend, n)
        if b is None:
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12, err_msg=n)


def _fused_case(tmp_path, curve_grid):
    mode = "fused2d_bipolar" if curve_grid == 2 else "fused2d"
    _workers(tmp_path, 4, mode)
    assert (tmp_path / "ok").exists()
    grid, cfg, state = mw.build_workload(4, curve_grid)
    fm = FusedSharded2DModel(grid, cfg, 1.0, 2, 2, steps_per_call=2)
    c, ok = fm.make_runner(mw.N1)(fm.pack(state))
    assert ok
    c, ok = fm.make_runner(mw.N2)(c)
    assert ok
    fields = fm.extract(c)
    got = np.load(tmp_path / "fused2d.npz")
    for name, k in (("ssh", 0), ("u", 2), ("v", 4), ("tr", 6)):
        np.testing.assert_array_equal(
            got[name], fields[k].numpy(), err_msg=f"{name}: the processes' "
            "run diverged from the one-process run")

    jgrid, jcfg, jstate = _jax_inputs(4, curve_grid)
    jm = JaxSharded(jgrid, jcfg, 1.0, 2, 2, tx=8, interpret=True,
                    devices=jax.devices()[:4], steps_per_call=2)
    jc, jok = jm.make_runner(mw.N1)(jm.pack(jstate))
    jc, jok2 = jm.make_runner(mw.N2)(jc)
    assert bool(jok) and bool(jok2)
    jf = jm.extract(jc)
    for name, k in (("ssh", 0), ("u", 2), ("v", 4), ("tr", 6)):
        assert _rel(fields[k].numpy(), jf[k]) < TOL_F32, name
    return fm


def test_multiprocess_fused2d_2x2(tmp_path):
    """``FusedSharded2DModel`` on 2 x 2 over 4 processes, two chained
    steps a launch: every strip crosses a process (corners through the
    orthogonal neighbour), == the one-process 2 x 2 run bit for bit,
    which is within 1e-5 of the JAX model in interpret mode; a NaN in
    one rank's shard trips every rank's guard (the workers assert it)."""
    _fused_case(tmp_path, 1)


def test_multiprocess_fused2d_bipolar_2x2(tmp_path):
    """The same on the bipolar grid: the fast2d form's metric planes."""
    fm = _fused_case(tmp_path, 2)
    assert fm.fast2d


def _run_dir(path, f64):
    """tests/test_torch_model.py's 40 x 30 frame basin, 60 steps in
    windows of 30, one tracer."""
    path.mkdir(parents=True)
    (path / "basin.par").write_text(
        "40 : nx\n30 : ny\n1 : nz\n0 :\n0 :\n0.05d0 :\n0.04d0 :\n"
        "27.525d0 :\n40.940d0 :\n0 :\n0 :\n1 : curve\n0.0d0 :\n0.0d0 :\n"
        "90.0d0 :\n60.0d0 :\n90.0d0 :\n-90.0d0 :\nnone : mask\n"
        "none : topo\n")
    (path / "sw.par").write_text(
        "1 :\n1 :\n1 :\n0.5d0 :\n1.0d+03 :\n1 : tracers\n1 :\nnone :\n")
    (path / "parallel.par").write_text(
        "0 :\n none :\n2 :\n1 :\n0 :\n0 :\nnone :\n0 :\n0 :\n")
    (path / "ocean_run.par").write_text(
        f"0 :\n1.0d0 : tau\n{60.0 / 86400.0!r} : days\n0 :\n2012 :\n"
        "0.5 : out min\n-1.0 :\n0 :\n0 :\nnone :\n")
    return str(path)


@pytest.mark.parametrize("route", ["f64 eager", "f32 fused"])
def test_main_over_two_processes(tmp_path, route):
    """``python -m ocean_model_arch_torch --mesh 2x1`` as two processes
    (``--rank``, ``--world-size``, ``--init-method``, ``--backend gloo``):
    the compute path names the transport, rank 0 prints the timer table
    reduced over both, the sharded checkpoint each writes reads back as
    the one-process run's final state bit for bit, and rank 0's GrADS
    records equal the one-process run's."""
    f64 = route == "f64 eager"
    d = _run_dir(tmp_path / "run", f64)
    ck = str(tmp_path / "ck")
    store = f"file://{tmp_path}/store"
    args = [d, "--mesh", "2x1", "--device", "cpu", "--checkpoint", ck,
            "--ckpt-format", "orbax", "--world-size", "2", "--init-method",
            store, "--backend", "gloo"] + ([] if f64 else ["--f32"])
    outs = _spawn([[sys.executable, "-m", "ocean_model_arch_torch", *args,
                    "--rank", str(r)] for r in range(2)])
    path = ("eager composition, sharded" if f64
            else "fused CUDA kernel, sharded")
    for out in outs:
        assert f"MODEL: compute path: {path} (2 processes, gloo)" in out
    assert "TIMER REPORT (2 processes, max/min over ranks)" in outs[0]
    assert "TIMER REPORT" not in outs[1]
    got, step = load_checkpoint_sharded(ck, device="cpu")
    assert step == 60

    cfg = load_config_dir(d)
    cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, mesh_x=2, mesh_y=1))
    if not f64:
        from ocean_model_arch_torch.config import Precision
        cfg = dataclasses.replace(cfg, precision=Precision.f32())
    one = OceanModel(cfg, base_dir=d, results_dir=str(tmp_path / "one"),
                     device="cpu")
    want = one.run(verbose=False)
    for n in STATE_FIELDS:
        a, b = getattr(got, n), getattr(want, n)
        assert (a is None) == (b is None), n
        assert a is None or torch.equal(a, b), n
    for rec in ("ssh.dat", "ff1.dat"):
        with open(os.path.join(d, "RESULTS", rec), "rb") as f1, \
                open(str(tmp_path / "one" / rec), "rb") as f2:
            assert f1.read() == f2.read(), rec


# ---- one process: the defaults, the mesh's owners -----------------------

def test_one_process_defaults():
    """Without a process group: one process, rank 0, no transport; the
    collectives give this process's values; a mesh holds every shard."""
    assert multihost.process_count() == 1
    assert multihost.process_index() == 0
    assert multihost.backend() is None
    assert multihost.transport() == "one process"
    t = torch.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(multihost.gather_to_host(t), t.numpy())
    assert multihost.any_rank(torch.tensor(True))
    assert not multihost.any_rank(torch.tensor(False))
    assert multihost.all_objects({"a": 1}) == [{"a": 1}]
    mesh = make_mesh(2, 3, "cpu")
    assert (mesh.rank, mesh.world, mesh.block) == (0, 1, (2, 3))
    assert set(mesh.owners) == {0}
    assert mesh.shard_devices() == [torch.device("cpu")] * 6
    with pytest.raises(ValueError, match="processes"):
        multihost.pod_mesh(2, 1)
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize("file:///nowhere", 1, 0, backend="mpi")


@pytest.mark.parametrize("px,py,world,grid", [
    (2, 1, 2, (2, 1)), (2, 2, 4, (2, 2)), (4, 2, 2, (2, 1)),
    (4, 2, 8, (4, 2)), (1, 4, 2, (1, 2)), (3, 2, 2, (1, 2))])
def test_process_grid_and_owners(px, py, world, grid):
    """The ranks' grid over a mesh, and each shard's owner: rank ``i * py
    + j`` with a shard a process, an equal block of shards a rank
    otherwise; the blocks tile the mesh and their origins match their
    owners."""
    assert process_grid(px, py, world) == grid
    rx, ry = grid
    meshes = [Mesh(px, py, torch.device("cpu"), r, world, rx, ry)
              for r in range(world)]
    owners = meshes[0].owners
    if px * py == world:
        assert owners == tuple(range(world))
    seen = set()
    for m in meshes:
        (i0, j0), (bx, by) = m.origin(), m.block
        block = {(i0 + a, j0 + b) for a in range(bx) for b in range(by)}
        assert all(owners[i * py + j] == m.rank for i, j in block)
        seen |= block
    assert len(seen) == px * py
    with pytest.raises(ValueError, match="equal blocks"):
        process_grid(3, 1, 2)
