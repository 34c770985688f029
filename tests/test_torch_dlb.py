"""The port's dynamic load balance (``OceanModel.dynamic_load_balance``,
after tests/test_dlb.py): probe steps run on ``FusedSharded2DModel``
(the kernel's plain version on the CPU), each shard's work is MEASURED
as the wet tiles the guard runs at the port's own tile (``CPU_TILE`` here,
so the cut lines are the port's, not JAX's at its tx = 64), the compute
powers feed back into the weighted cuts in x and in y, and the best
decomposition is installed. ``run`` calls it where JAX does: on the
fused-sharded route only."""

import contextlib
import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from ocean_model_arch_torch.config import (ModelConfig, ParallelConfig,
                                           Precision, SWConfig,
                                           basinpar_flat)
from ocean_model_arch_torch.core.grid import build_grid
from ocean_model_arch_torch.io.mask_io import read_mask
from ocean_model_arch_torch.model.init import init_ocean_state
from ocean_model_arch_torch.model.model import OceanModel, load_config_dir
from ocean_model_arch_torch.model.step import make_step, run_steps
from ocean_model_arch_torch.ops.fused_step import CPU_TILE
from ocean_model_arch_torch.parallel.decomposition import (weighted_x_edges,
                                                           weighted_y_edges)
from ocean_model_arch_torch.utils.timers import PhaseTimers

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _azov_model(px, py, rounds, probe_steps):
    """tests/test_dlb.py::_azov_model: the Azov coastline cut to 191 x
    140 (every 8th cell, a 2-cell land frame), f32, no tracers, weighted
    cuts, on the CPU."""
    m = np.asarray(read_mask(
        os.path.join(REPO, "data/AS/maskAzovCor.txt"), 1525, 1115))
    m = m[::8, ::8].copy()
    m[:2] = 1
    m[-2:] = 1
    m[:, :2] = 1
    m[:, -2:] = 1
    nx, ny = m.shape
    basin = basinpar_flat(nx, ny, curve_grid=1, rlon=34.75, rlat=44.8,
                          dxst=0.025, dyst=0.018)
    cfg = ModelConfig(
        basin=basin, sw=SWConfig(use_tracers=0),
        precision=Precision.f32(),
        parallel=ParallelConfig(mesh_x=px, mesh_y=py,
                                mod_decomposition=1,
                                dlb_balance_steps=rounds,
                                dlb_model_steps=probe_steps))
    om = OceanModel.__new__(OceanModel)
    om.cfg = cfg
    om.timers = PhaseTimers()
    om.grid = build_grid(basin, m, precision=cfg.precision, device="cpu")
    om.state = init_ocean_state(om.grid, cfg)
    return om


def _tiles(fs):
    return np.array([[float(fs.tile_wet[i][j].sum()) for j in range(fs.py)]
                     for i in range(fs.px)])


def _matches_eager(om, n=10):
    """The installed model's ssh after ``n`` steps against the eager f32
    composition on the single block (relative, 1e-5)."""
    fs = om._fused_sh
    carry, ok = fs.make_runner(n)(fs.pack(om.state))
    assert ok
    ssh = fs.extract(carry)[0]
    ref, okr = run_steps(make_step(om.grid, om.cfg), om.state, 1.0, n)
    assert okr
    rel = float((ssh - ref.ssh).abs().max() / ref.ssh.abs().max())
    assert rel < 1e-5, rel


@pytest.mark.parametrize("px,py", [(4, 2), (2, 4)])
def test_dlb_improves_work_balance_on_azov(px, py):
    """Three rounds of two probe steps: the measured-work feedback improves
    the balance over round 0's equal-wet cuts (4 x 2: by more than 0.05,
    as in JAX's test), every probe ran, and the model installed is the
    round with the best ratio. On 2 x 4 the y feedback acts: the y cuts
    move off round 0's."""
    om = _azov_model(px, py, rounds=3, probe_steps=2)
    hist = om.dynamic_load_balance(verbose=False)
    assert len(hist) == 3
    ratios = [r for r, _ in hist]
    assert min(ratios[1:]) < ratios[0] - (0.05 if px == 4 else 1e-9), ratios
    assert all(t > 0 for _, t in hist)
    fs = om._fused_sh
    assert fs.tile == CPU_TILE and fs.steps_per_call == 2
    tiles = _tiles(fs)
    assert abs(float(tiles.max() / tiles.mean()) - min(ratios)) < 1e-9
    im = (om.grid.lu.numpy() < 0.5).astype(np.int32)
    if py > 1:
        ye0 = weighted_y_edges(im, py, min_width=fs.M)
        assert not np.array_equal(np.asarray(fs.y_edges), ye0)
    else:
        xe0 = weighted_x_edges(im, px, min_width=fs.M)
        assert not np.array_equal(np.asarray(fs.x_edges), xe0)


@pytest.mark.parametrize("px,py", [(4, 2), (2, 4)])
def test_dlb_trajectory_matches_the_block(px, py):
    """The selected decomposition does not change the physics: 10 steps
    on it end within 1e-5 of the eager f32 composition on one block."""
    om = _azov_model(px, py, rounds=2, probe_steps=2)
    om.dynamic_load_balance(verbose=False)
    _matches_eager(om)


@pytest.mark.parametrize("knob", [{"interpret": True}, {"tx": 8}])
def test_tpu_knobs_are_refused(knob):
    """JAX's ``interpret`` and ``tx`` set the TPU's interpreter and tile:
    not taken, as FusedSWModel's TPU knobs are not."""
    om = _azov_model(4, 2, rounds=1, probe_steps=2)
    with pytest.raises(TypeError):
        om.dynamic_load_balance(verbose=False, **knob)
    assert not hasattr(om, "_fused_sh")


def _run_dir(path, dlb):
    """A 48 x 40 frame basin (tests/test_torch_model.py::_run_dir), 20
    steps in windows of 10, ``dlb`` balance rounds of ``dlb`` probe
    steps."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "basin.par").write_text(
        "48 : nx\n40 : ny\n1 : nz\n0 :\n0 :\n0.05d0 :\n"
        "0.04d0 :\n27.525d0 :\n40.940d0 :\n0 :\n0 :\n1 : curve\n0.0d0 :\n"
        "0.0d0 :\n90.0d0 :\n60.0d0 :\n90.0d0 :\n-90.0d0 :\n"
        "none : mask\nnone : topo\n")
    (path / "sw.par").write_text(
        "1 :\n1 :\n1 :\n0.5d0 :\n1.0d+03 :\n1 : tracers\n1 :\nnone :\n")
    (path / "parallel.par").write_text(
        f"1 :\nnone :\n1 :\n1 :\n0 :\n0 :\nnone :\n{dlb} :\n{dlb} :\n")
    (path / "ocean_run.par").write_text(
        "0 :\n1.0d0 : tau\n0.0002315 : days\n0 :\n2012 :\n"
        "0.16666667 : out min\n-1.0 :\n0 :\n0 :\nnone :\n")
    return str(path)


@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_run_balances_where_jax_does(tmp_path, precision):
    """``run`` with ``dlb_balance_steps > 0`` balances on the
    fused-sharded route (f32: the rounds and "PREP: DLB selected cuts"
    print, the installed cuts run the loop, the result within 1e-5 of the
    block's eager composition) and skips it silently on the eager mesh
    (f64), as the JAX model does."""
    d = _run_dir(tmp_path, dlb=2)
    cfg = load_config_dir(d)
    cfg = dataclasses.replace(
        cfg, precision=getattr(Precision, precision)(),
        parallel=dataclasses.replace(cfg.parallel, mesh_x=2, mesh_y=2))
    assert cfg.run.num_step_max == 20 and cfg.parallel.dlb_model_steps == 2
    model = OceanModel(cfg, base_dir=d, device="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = model.run(verbose=True)
    text = buf.getvalue()
    block = OceanModel(dataclasses.replace(
        cfg, parallel=dataclasses.replace(cfg.parallel, mesh_x=1,
                                          mesh_y=1)),
        base_dir=str(tmp_path / "block"), device="cpu")
    if precision == "f64":
        assert "PREP: DLB" not in text
        assert model.compute_path() == "eager composition, sharded"
        ref = block.run(verbose=False)
        assert torch.equal(out.ssh, ref.ssh)
        return
    assert "PREP: DLB round 0: work balance ratio" in text
    assert "PREP: DLB round 1: work balance ratio" in text
    assert "PREP: DLB selected cuts [0, " in text
    assert model.compute_path() == "fused CUDA kernel, sharded"
    fs = model._fused_sh
    cuts = text.split("PREP: DLB selected cuts ")[1].split(" (")[0]
    assert cuts == str(list(map(int, fs.x_edges)))
    ref, ok = run_steps(make_step(block.grid, cfg), block.state,
                        cfg.run.tau, 20)
    assert ok
    for n in ("ssh", "ubrtr", "vbrtr", "ff"):
        a, b = getattr(out, n), getattr(ref, n)
        assert float((a - b).abs().max()) < 1e-5 * float(b.abs().max()), n
