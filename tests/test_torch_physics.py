"""Physics properties of ``tests/test_physics.py`` held on the port's
fused path (``FusedSWModel``, the kernel's plain PyTorch version on the
CPU, f32), at one step a launch and at two chained: the flux-form
continuity conserves the SSH volume, and land keeps its zeros."""

import numpy as np
import pytest
import torch

from ocean_model_arch_torch.config import (ModelConfig, Precision, SWConfig,
                                           basinpar_flat)
from ocean_model_arch_torch.core.grid import build_grid
from ocean_model_arch_torch.core.masks import frame_of_land_mask
from ocean_model_arch_torch.model.fused import FusedSWModel
from ocean_model_arch_torch.model.init import init_ocean_state

torch.set_num_threads(1)


def _flat_model(spc):
    """The 66 x 66 frame basin of tests/test_physics.py with a tracer, f32,
    on the fused path at ``spc`` steps a launch."""
    basin = basinpar_flat(66, 66)
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=1, tracer_num=1),
                      precision=Precision.f32())
    grid = build_grid(basin, frame_of_land_mask(basin.nx, basin.ny),
                      precision=Precision.f32(), device="cpu")
    state = init_ocean_state(grid, cfg)
    return grid, state, FusedSWModel(grid, cfg, 1.0, steps_per_call=spc,
                                     static_rslu=True)


def _run(spc, n):
    grid, state, fm = _flat_model(spc)
    s, ok = fm.run_steps(fm.pack(state), n)
    assert ok
    return grid, state, fm.unpack(s, state)


def wet_sum(field, grid, mask):
    w = mask.numpy() > 0.5
    area = grid.dx.numpy().astype(np.float64) * grid.dy.numpy()
    return float(np.sum(field.numpy().astype(np.float64) * area * w))


@pytest.mark.parametrize("spc", [1, 2])
def test_ssh_volume_conserved(spc):
    """100 steps: the total SSH volume is invariant, as the flux-form
    continuity telescopes; in f32 to 1e-6 of the bump's volume, the
    tolerance of the f64 test (the fused step's f32 rounding stays an
    order below it)."""
    grid, state, st = _run(spc, 100)
    v0 = wet_sum(state.ssh, grid, grid.lu)
    v1 = wet_sum(st.ssh, grid, grid.lu)
    assert abs(v1 - v0) < 1e-6 * max(1.0, abs(v0))
    assert float((st.ssh - state.ssh).abs().max()) > 1e-3   # it moved


@pytest.mark.parametrize("spc", [1, 2])
def test_land_points_untouched(spc):
    """20 steps: ssh is exactly 0 on land and u on the land u-points."""
    grid, _, st = _run(spc, 20)
    land = grid.lu.numpy() < 0.5
    np.testing.assert_array_equal(st.ssh.numpy()[land], 0.0)
    np.testing.assert_array_equal(
        st.ubrtr.numpy()[land & (grid.lcu.numpy() < 0.5)], 0.0)
