"""The eager sharded step over a px x py mesh (counterpart of
``ocean_model_arch_tpu/model/sharded.py``).

The JAX package runs the composition of model/step.py per shard under
``jax.shard_map``, with a ``ShardHalo`` whose ``ppermute`` exchanges
replace the reference's MPI isend/irecv (core/decomposition.f90,
shared/mpp/sync.f90). The composition exchanges fields it computed in
the same step, so the shards must advance in lockstep. The port holds
every shard of the padded domain stacked on one device (parallel/mesh.py)
and runs the *same* composition once a step over all of them; its
``ShardHalo`` (parallel/halo.py) moves the strips along the shard axes.
This is the route of any mesh run outside the fused kernel's envelope
(f64, a spatially varying mu, shards narrower than 8 cells). Across
processes each one steps its own block of shards with the same
composition in the same order, so their exchanges meet (the strips at a
block's edge travel between processes, parallel/halo.py), and the
window's flag is reduced over them.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.grid import Grid
from ..core.state import SWState
from ..host import ModelConfig
from ..ops import sw_kernels as swk
from ..parallel.domain import pad_grid, pad_state
from ..parallel import multihost
from ..parallel.halo import ShardHalo
from ..parallel.mesh import Mesh, shard_tree
from .step import sw_step, tracer_step


def prepare(grid: Grid, state: SWState, mesh: Mesh):
    """Pad grid + state to mesh-divisible extents and lay the shards out
    on the mesh (the stacked layout of parallel/mesh.py: this process's
    block of them)."""
    grid_p = pad_grid(grid, mesh.px, mesh.py)
    state_p = pad_state(state, mesh.px, mesh.py)
    return shard_tree(grid_p, mesh), shard_tree(state_p, mesh)


def make_sharded_step(grid_p: Grid, cfg: ModelConfig, mesh: Mesh,
                      n_inner: int = 1) -> Callable:
    """``fn(state, tau) -> (state, ok)``, advancing ``n_inner`` steps of
    every shard of a stacked state per call. The exchanges of the static
    grid fields are made once here, per runner, not once a step; the
    per-step flags (over every shard: JAX's psum of the flag) are AND-ed
    on the device and read once, at the end of the window, as
    ``run_steps`` does (and reduced over the processes: every process
    calls the runner in the same turn).

    ``grid_p`` must already be prepared (see :func:`prepare`).
    """
    hp = ShardHalo(mesh.px, mesh.py, grid_p.periodic_x, grid_p.periodic_y,
                   mesh=mesh)
    hp.cache_statics(grid_p, grid_p.lu.shape[-2:])

    def stepped(state: SWState, tau):
        okacc = torch.ones((), dtype=torch.bool, device=state.ssh.device)
        for _ in range(n_inner):
            state = sw_step(state, grid_p, cfg, tau, hp)
            state = tracer_step(state, grid_p, cfg, tau, hp)
            okacc = okacc & swk.check_ssh_ok(hp.zp(grid_p.lu),
                                             hp.zp(state.ssh))
            hp.end_step()
        return state, not multihost.any_rank(~okacc)

    stepped.halo = hp
    return stepped
