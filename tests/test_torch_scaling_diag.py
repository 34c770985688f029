"""The port's halo accounting and weak-scaling harness
(``ocean_model_arch_torch/diag/scaling.py``; counterpart of
tests/test_scaling_diag.py), on the CPU: the bytes one margin exchange
moves against the port's own analytic formula (its layout is its own, so
the formula is, not the JAX package's numbers), chaining, the overlap
report at a caller's link bandwidth, and the harness on both paths."""

import pytest
import torch

from ocean_model_arch_torch.config import (ModelConfig, Precision, SWConfig,
                                           basinpar_flat)
from ocean_model_arch_torch.core.grid import build_grid
from ocean_model_arch_torch.core.masks import frame_of_land_mask
from ocean_model_arch_torch.diag.scaling import (
    cross_process_bytes_per_step, expected_halo_bytes_per_step,
    halo_bytes_per_step, halo_overlap_report, time_stepper, weak_scaling)
from ocean_model_arch_torch.model.fused_sharded2d import FusedSharded2DModel
from ocean_model_arch_torch.model.init import init_ocean_state

torch.set_num_threads(1)


def _model(px, py, nx=64, ny=160, spc=2, tracers=0, periodic_x=0):
    basin = basinpar_flat(nx, ny, curve_grid=1, rlon=27.5, rlat=41.0)
    if periodic_x:
        import dataclasses
        basin = dataclasses.replace(basin, periodicity_x=1)
    cfg = ModelConfig(
        basin=basin,
        sw=SWConfig(use_tracers=int(tracers > 0), tracer_num=tracers),
        precision=Precision.f32())
    grid = build_grid(basin, frame_of_land_mask(nx, ny),
                      precision=cfg.precision, device="cpu")
    return FusedSharded2DModel(grid, cfg, 1.0, px, py, steps_per_call=spc)


def test_halo_bytes_match_analytic_2d_mesh():
    fs = _model(2, 2)
    got = halo_bytes_per_step(fs)
    assert got == expected_halo_bytes_per_step(fs), \
        (got, expected_halo_bytes_per_step(fs))
    assert got > 0
    # 8 strips an exchange of 6 fields at M = 6, two steps a launch
    M = fs.M
    assert got == 4 * 6 * M * (2 * (160 + 4 * M) + 2 * (64 + 4 * M)) // 2


def test_halo_bytes_match_analytic_x_only_with_tracers():
    fs = _model(4, 1, tracers=2)
    got = halo_bytes_per_step(fs)
    assert got == expected_halo_bytes_per_step(fs)
    assert got == 4 * 10 * fs.M * 6 * (160 + 2 * fs.M) // 2


def test_halo_bytes_with_a_periodic_axis():
    """A periodic axis adds the pair across the seam; unsharded, the
    shard's own far edge (the plan's copies are what it counts)."""
    for px in (1, 2):
        fs = _model(px, 1, periodic_x=1)
        assert halo_bytes_per_step(fs) == expected_halo_bytes_per_step(fs)
        assert halo_bytes_per_step(fs) > 0


def test_halo_bytes_scale_with_chaining():
    b1 = halo_bytes_per_step(_model(2, 2, spc=1))
    b2 = halo_bytes_per_step(_model(2, 2, spc=2))
    # two steps a launch widen the margins (4 -> 6) but halve the
    # exchanges a step: fewer bytes a step
    assert b2 < b1


def test_counting_leaves_the_strip_counters_alone():
    fs = _model(2, 2)
    halo_bytes_per_step(fs)
    assert fs.strip_copies == fs.bytes_copied == fs.strips_sent == 0
    assert cross_process_bytes_per_step(fs) == 0      # one process


def test_halo_overlap_report_fields():
    rep = halo_overlap_report(_model(2, 2), link_GBps=25.0,
                              t_step_sharded=1e-3)
    assert rep["halo_bytes_per_step"] > 0
    assert rep["cross_process_bytes_per_step"] == 0
    assert 0.0 <= rep["comm_fraction_bound"] <= 1.0
    assert rep["comm_seconds_per_step_bound"] == \
        rep["halo_bytes_per_step"] / (rep["link_GBps"] * 1e9)
    with pytest.raises(TypeError):
        halo_overlap_report(_model(2, 2))       # no bandwidth of its own


def test_time_stepper_raises_on_a_tripped_guard():
    fs = _model(1, 1, nx=32, ny=32)
    state = init_ocean_state(fs.grid, fs.cfg)
    run = fs.make_runner(2)
    t = time_stepper(run, fs.pack(state), 2, windows=1)
    assert t > 0
    with pytest.raises(RuntimeError, match="guard"):
        time_stepper(lambda c: (c, False), fs.pack(state), 2, windows=1)


def test_weak_scaling_harness_fused_path():
    # the kernel's plain version on the CPU: the HARNESS is what is held
    # (it runs unchanged on the card); CPU times say nothing of the card
    rep = weak_scaling([(1, 1), (2, 1), (2, 2)], nx_loc=32, ny_loc=64,
                       n_inner=4, windows=1, device="cpu", path="fused")
    assert rep["path"] == "fused"
    assert len(rep["rows"]) == 3
    assert rep["rows"][0]["shards"] == 1
    assert rep["rows"][2]["halo_bytes_per_step"] > 0
    for r in rep["rows"]:
        assert r["step_seconds"] > 0
        assert r["points"] == 32 * r["mesh"][0] * 64 * r["mesh"][1]


def test_weak_scaling_harness_eager_path_on_cpu():
    # 'auto' takes the eager sharded step on the CPU
    rep = weak_scaling([(1, 1), (2, 2)], nx_loc=32, ny_loc=64,
                       n_inner=4, windows=1, device="cpu")
    assert rep["path"] == "eager"
    assert rep["rows"][1]["shards"] == 4
    assert all(r["step_seconds"] > 0 for r in rep["rows"])
