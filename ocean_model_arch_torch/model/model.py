"""The top-level model (counterpart of
``ocean_model_arch_tpu/model/model.py``) -- the analog of the reference's
program model (model.f90): config loading, mask/grid/state init, the time
loop with output cadence, the per-step stability guard, phase timers, and
checkpoint/resume.

The inner loop runs ``output_every_steps`` model steps per call of a
runner (the guard's flag stays on the device for the whole window and is
read once), then returns to the host for output and the guard --
mirroring the reference's master-thread output block (model.f90:172-197)
at the same cadence.

The compute path follows from the configuration, not from the platform:
f32 with a constant viscosity inside the fused kernel's envelope runs the
fused step (``FusedSWModel`` on a closed basin, ``FusedSharded2DModel``
on a periodic one and on a px x py mesh; on CPU tensors they run the
kernel's plain version), anything else the eager composition of
``model/step.py``: on a px x py mesh, the eager sharded step of
``model/sharded.py`` (every shard stacked on the model's device, in
lockstep). On a mesh, ``debug_level >= 2`` runs the halo self-test and,
on the fused-sharded route, ``dlb_balance_steps > 0`` the dynamic load
balance, as the JAX model does. No run takes another path than the one
it reports.

In a process group (``parallel/multihost.py``) the mesh spans the
processes: each holds its shards on its own device and every process
runs the same loop in lockstep; the outputs are gathered collectively
and written by rank 0, a sharded checkpoint (``checkpoint_format=
"orbax"`` or a directory; the port's own per-shard format, not orbax)
by every process, and rank 0 prints the timer table reduced over the
ranks.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..config import (ModelConfig, load_basinpar, load_parallel,
                      load_runpar, load_sw)
from ..core.grid import Grid, build_grid
from ..core.state import SWState
from ..host import default_device
from ..io import grads
from ..io.checkpoint import (load_checkpoint, load_checkpoint_sharded,
                             save_checkpoint, save_checkpoint_sharded)
from ..io.mask_io import load_mask
from ..parallel import multihost
from ..parallel.domain import crop_state, pad_grid, pad_state
from ..parallel.mesh import make_mesh, shard_tree, unshard_tree
from ..utils.calendar import model_time
from ..utils.timers import PhaseTimers
from .init import init_ocean_state
from .step import make_step, reinit_depth_families, run_steps


def load_config_dir(path: str = ".", argv=None) -> ModelConfig:
    """Load the four reference-format .par files from a directory
    (model.f90:50-56)."""
    return ModelConfig(
        basin=load_basinpar(os.path.join(path, "basin.par")),
        sw=load_sw(os.path.join(path, "sw.par")),
        parallel=load_parallel(os.path.join(path, "parallel.par"), argv),
        run=load_runpar(os.path.join(path, "ocean_run.par")),
    )


def memory_report(state=None, grid=None) -> str:
    """Bytes of the tensors of a state and a grid, per field and in total
    (the reference's memory-profile startup print)."""
    lines = ["================== MEMORY REPORT =================="]
    total = 0
    for label, tree in (("state", state), ("grid", grid)):
        if tree is None:
            continue
        fb = {f.name: v.numel() * v.element_size()
              for f in dataclasses.fields(tree)
              if isinstance(v := getattr(tree, f.name), torch.Tensor)}
        sub = sum(fb.values())
        total += sub
        lines.append(f"-- {label}: {sub / 1e6:.2f} MB over {len(fb)} fields")
        for k, v in sorted(fb.items(), key=lambda kv: -kv[1])[:8]:
            lines.append(f"   {k:<14} {v / 1e6:>9.3f} MB")
    lines.append(f"TOTAL {total / 1e6:.2f} MB "
                 f"({total / 2 ** 30:.3f} GiB)")
    lines.append("===================================================")
    return "\n".join(lines)


class OceanModel:
    """Build + run a configured model on ``device`` (None -> the current
    CUDA device, raising without one; the CPU only when asked for)."""

    def __init__(self, cfg: ModelConfig, base_dir: str = ".",
                 results_dir: Optional[str] = None, device=None):
        self.cfg = cfg
        self.base_dir = base_dir
        self.results_dir = results_dir or os.path.join(base_dir, "RESULTS")
        self.device = torch.device(default_device() if device is None
                                   else device)
        self.timers = PhaseTimers()

        basin = cfg.basin
        with self.timers.phase("init_grid"):
            int_mask = load_mask(basin.mask_file_name, basin.nx, basin.ny,
                                 base_dir)
            hhq_rest = None
            if basin.bottom_topography_file_name != "none":
                hhq_rest = grads.read_record(
                    os.path.join(base_dir,
                                 basin.bottom_topography_file_name),
                    1, basin.nx, basin.ny).astype(cfg.precision.state_dtype)
            self.grid: Grid = build_grid(basin, int_mask, hhq_rest,
                                         cfg.precision, device=self.device)

        with self.timers.phase("init_state"):
            ssh0 = None
            if cfg.sw.ssh_init_file_name != "none":
                ssh0 = grads.read_record(
                    os.path.join(base_dir, "INIT",
                                 cfg.sw.ssh_init_file_name),
                    1, basin.nx, basin.ny)
            self.state: SWState = init_ocean_state(self.grid, cfg, ssh0)
        self.num_step = cfg.run.init_step

        # Mesh selection (parallel.par analog): 1x1 -> single-block path
        px, py = cfg.parallel.mesh_x, cfg.parallel.mesh_y
        if cfg.parallel.mod_decomposition not in (0, 1, 2):
            # parity with abort_model('Unknown decomposition mode!')
            # (decomposition.f90:888-890)
            raise ValueError("Unknown decomposition mode! "
                             f"(mod_decomposition="
                             f"{cfg.parallel.mod_decomposition})")
        self._file_cuts = None
        if cfg.parallel.mod_decomposition == 2:
            # cut lines read back from a decomposition.txt-format file
            # (the format the reference writes at debug_level >= 3,
            # decomposition.f90:895-909, but never reads)
            from ..parallel.decomposition import (cuts_from_decomposition,
                                                  read_decomposition)
            dec = read_decomposition(
                os.path.join(base_dir, cfg.parallel.file_decomposition),
                nx=basin.nx, ny=basin.ny)
            xe, ye = cuts_from_decomposition(dec, px, py)
            # block grids cover the significant interior [2, n-2); shard
            # cuts span the full padded domain (the frame is land)
            xe[0], xe[-1] = 0, basin.nx
            ye[0], ye[-1] = 0, basin.ny
            self._file_cuts = (xe, ye)
        # the mesh: px * py shards on this model's device, or, in a process
        # group, each process's block of them on its own
        self.mesh = None
        if px * py > 1:
            self.mesh = make_mesh(px, py, self.device)
            # The cut-line policy is decided HERE, not at run time.
            # Non-uniform cut lines (weighted / file) are realized by the
            # fused-sharded model alone; the eager sharded step cuts the
            # padded domain uniformly.
            if not self._use_fused_sharded():
                why = self._fused_sharded_blockers()
                if self._file_cuts is not None:
                    raise ValueError(
                        "mod_decomposition=2 (cuts from file) needs the "
                        "fused-sharded path, which this config cannot "
                        f"select ({why}); use mod_decomposition=0, or "
                        "lift the blocker")
                if cfg.parallel.mod_decomposition == 1:
                    print("MODEL: mod_decomposition=1 (weighted cuts) "
                          "needs the fused-sharded path, which this "
                          f"config cannot select ({why}); falling back "
                          "to uniform cuts on the eager sharded path")
                self._prepare_mesh_grid()

    def startup_report(self) -> str:
        """Decomposition + memory diagnostics (the reference's DD INFO /
        SYNC INFO / memory-profile startup prints)."""
        from ..parallel.decomposition import (mesh_split_report,
                                              weighted_x_edges,
                                              x_band_balance)
        px, py = self.cfg.parallel.mesh_x, self.cfg.parallel.mesh_y
        lines = []
        int_mask = (self.grid.lu.cpu().numpy() < 0.5).astype(np.int32)
        rep = mesh_split_report(int_mask, px, py)
        lines.append(f"DD INFO: mesh {px}x{py}, wet fraction "
                     f"{rep['wet_fraction']:.3f}, load-balance ratio "
                     f"(max/mean wet points) {rep['balance_ratio']:.3f}")
        if px > 1:
            try:
                edges = weighted_x_edges(int_mask, px)
                ratio = x_band_balance(int_mask, edges, py)
                tag = ("selected" if self.cfg.parallel.mod_decomposition
                       == 1 else "available via mod_decomposition=1")
                lines.append(
                    f"DD INFO: weighted x-cuts {list(map(int, edges))} "
                    f"balance {ratio:.3f} ({tag})")
            except ValueError:
                pass
        lines.append(memory_report(self.state, self.grid))
        return "\n".join(lines)

    # ------------------------------------------------------------------
    def state_mu_const(self):
        """The state's spatially-constant viscosity, or None if mu varies
        (then only the eager composition applies). The reference's init
        zeroes mu (init_data.f90:76-77), so this is normally 0.0; a
        nonzero constant drives the fused stress/uv_diff2 branch
        (vel_ssh.f90:375-452)."""
        mu = self.state.mu
        if mu.numel() == 0:
            return 0.0
        v = mu.reshape(-1)[0]
        return float(v) if bool((mu == v).all()) else None

    def _f32_const_mu(self) -> bool:
        return (self.cfg.precision.state_dtype == np.float32
                and self.state_mu_const() is not None)

    def _use_fused(self) -> bool:
        """The single-block fused path applies to f32 runs of supported
        configs on closed basins."""
        from .fused import fused_available
        return (self.mesh is None and self._f32_const_mu()
                and fused_available(self.grid, self.cfg))

    def _fused_periodic_tx(self):
        """Periodic runs without a mesh use FusedSharded2DModel on a 1x1
        'mesh' (the margin exchange wraps locally). Returns 1 where that
        route applies, else None. (The TPU package returns the tile size
        that divides nx; the port's cuts need none.)"""
        from .fused import fused_available
        g = self.grid
        if not (g.periodic_x or g.periodic_y) or self.mesh is not None:
            return None
        if not self._f32_const_mu() \
                or not fused_available(g, self.cfg, sharded=True):
            return None
        return 1

    def _use_fused_sharded(self) -> bool:
        return self.mesh is not None and not self._fused_sharded_blockers()

    def _fused_sharded_blockers(self) -> str:
        """The fused-sharded path's selection criteria, as the list of
        reasons it is unavailable (empty string = selectable). The
        SINGLE source of truth: _use_fused_sharded and the cut-line
        policy messages both consume this, so they cannot drift."""
        from .fused import unsupported
        px, py = self.cfg.parallel.mesh_x, self.cfg.parallel.mesh_y
        why = []
        if self.grid.nx // px < 8 or self.grid.ny // py < 8:
            why.append("shards narrower than 8 cells")
        if self.cfg.precision.state_dtype != np.float32:
            why.append("f64 precision")
        if self.state_mu_const() is None:
            why.append("spatially-varying mu")
        why += unsupported(self.grid, self.cfg, sharded=True)
        return ", ".join(why)

    def _shard_devices(self):
        """Each shard's device for ``FusedSharded2DModel``: the mesh's (a
        process's own, or another's rank), None without a mesh."""
        mesh = getattr(self, "mesh", None)
        return None if mesh is None else mesh.shard_devices()

    def _prepare_mesh_grid(self) -> None:
        """The eager sharded step's grid: padded to the mesh, laid out on
        it (``model/sharded.py::prepare``; the state is laid out at run
        time, after a resume)."""
        px, py = self.mesh.shape
        self._grid_s = shard_tree(pad_grid(self.grid, px, py), self.mesh)

    def dynamic_load_balance(self, verbose: bool = True,
                             steps_per_call: int = 2) -> list:
        """Closed-loop dynamic load balancing -- the analog of
        control/preprocess.f90:21-100: build the fused-sharded model with
        the current cut lines, run ``dlb_model_steps`` probe steps (timed),
        MEASURE each shard's work -- the wet tile count, the tiles the
        kernel's guard runs at the port's own tile (``tile_shape``:
        ``CPU_TILE`` on the CPU, the kernel's on the card) -- derive
        per-band compute powers = wet share / work, re-cut the weighted
        edges in BOTH axes (the reference re-packs its full 2D block
        grid, preprocess.f90:71-72 feeding decomposition.f90:532-612),
        and keep the best decomposition. Honors parallel.par's
        dlb_balance_steps / dlb_model_steps. Returns the per-round history
        [(work_balance_ratio, probe_seconds), ...]; the selected model is
        installed as the fused-sharded runner. The JAX method's TPU knobs
        (``interpret``, ``tx``) are not taken (``TypeError``)."""
        import time as _time

        from .fused_sharded2d import FusedSharded2DModel
        p = self.cfg.parallel
        px, py = p.mesh_x, p.mesh_y
        spc = steps_per_call
        n_probe = max(spc, (p.dlb_model_steps // spc) * spc)
        powers = powers_y = None
        best = None
        hist = []
        wet = self.grid.lu.cpu().numpy() > 0.5
        for r in range(p.dlb_balance_steps):
            fs = FusedSharded2DModel(
                self.grid, self.cfg, self.cfg.run.tau, px, py,
                devices=self._shard_devices(),
                weighted=True, mu_const=self.state_mu_const() or 0.0,
                steps_per_call=spc, compute_powers_x=powers,
                compute_powers_y=powers_y)
            # measured per-shard work: tiles the guard actually runs
            tiles = np.array([[float(fs.tile_wet[i][j].sum())
                               for j in range(py)] for i in range(px)])
            ratio = float(tiles.max() / max(tiles.mean(), 1e-12))
            # timed probe pass (the reference's compute_power measure; on
            # the lockstep shards of one card the time is the critical
            # path, the tile counts carry the per-shard signal); reading
            # the window's flag is the barrier
            t0 = _time.perf_counter()
            _, ok = fs.make_runner(n_probe)(fs.pack(self.state))
            bool(ok)
            dt = _time.perf_counter() - t0
            hist.append((ratio, dt))
            if verbose:
                print(f"PREP: DLB round {r}: work balance ratio "
                      f"{ratio:.3f}, probe {n_probe} steps {dt:.2f}s")
            if best is None or ratio < best[0] - 1e-12:
                best = (ratio, fs)
            # feedback: band k's power <- its wet share / its critical
            # work, so bands whose tile quantization makes them slow shed
            # wet points (preprocess.f90:71-72's compute_power =
            # tot_weight / time, with work as the lockstep time proxy)
            shares = np.array([
                wet[int(fs.x_edges[k]):int(fs.x_edges[k + 1])].sum()
                for k in range(px)], float)
            work = tiles.max(axis=1)
            work = np.where(work > 0, work, work.max() or 1.0)
            powers = shares / work
            powers = powers / powers.sum()
            # ... and the symmetric y feedback
            if py > 1:
                shares_y = np.array([
                    wet[:, int(fs.y_edges[k]):int(fs.y_edges[k + 1])].sum()
                    for k in range(py)], float)
                work_y = tiles.max(axis=0)
                work_y = np.where(work_y > 0, work_y, work_y.max() or 1.0)
                powers_y = shares_y / work_y
                powers_y = powers_y / powers_y.sum()
        self._fused_sh = best[1]
        if verbose:
            print(f"PREP: DLB selected cuts "
                  f"{list(map(int, best[1].x_edges))} "
                  f"(work balance {best[0]:.3f})")
        return hist

    def dump_decomposition_txt(self) -> str:
        """Write the active decomposition to RESULTS/decomposition.txt --
        the reference's debug_level >= 3 dump
        (decomposition.f90:895-909), driven by parallel.par's
        parallel_dbg line. Returns the path."""
        from ..parallel.decomposition import (BlockDecomposition,
                                              dump_decomposition,
                                              weighted_x_edges,
                                              weighted_y_edges)
        px, py = self.cfg.parallel.mesh_x, self.cfg.parallel.mesh_y
        nx, ny = self.grid.nx, self.grid.ny
        lu = self.grid.lu.cpu().numpy()
        fs = getattr(self, "_fused_sh", None)
        if fs is not None:
            xe = np.array(fs.x_edges, np.int64)
            ye = np.array(fs.y_edges, np.int64)
        elif self._file_cuts is not None:
            xe, ye = self._file_cuts
        elif self.mesh is not None and not self._use_fused_sharded():
            # the cuts the eager sharded step runs: uniform over the padded
            # extents, the last shard's padding cropped (JAX's dump writes
            # the weighted cuts here under mod_decomposition=1, which that
            # route does not run)
            xe = np.minimum(np.arange(px + 1) * -(-nx // px), nx)
            ye = np.minimum(np.arange(py + 1) * -(-ny // py), ny)
        else:
            xe = ye = None
            if self.cfg.parallel.mod_decomposition == 1 and px * py > 1:
                im = (lu < 0.5).astype(np.int32)
                try:
                    xe = (weighted_x_edges(im, px) if px > 1 else
                          np.array([0, nx], np.int64))
                    ye = (weighted_y_edges(im, py) if py > 1 else
                          np.array([0, ny], np.int64))
                except ValueError:
                    xe = ye = None
            if xe is None:
                xe = np.linspace(0, nx, px + 1).astype(np.int64)
                ye = np.linspace(0, ny, py + 1).astype(np.int64)
        wet = lu > 0.5
        w = np.array([[wet[xe[i]:xe[i + 1], ye[j]:ye[j + 1]].sum()
                       for j in range(py)] for i in range(px)], np.int64)
        owner = (np.asarray(self.mesh.owners) if self.mesh is not None
                 else np.zeros(px * py)).reshape(px, py).astype(np.int64)
        path = os.path.join(self.results_dir, "decomposition.txt")
        if multihost.process_index() == 0:
            os.makedirs(self.results_dir, exist_ok=True)
            dump_decomposition(
                BlockDecomposition(px, py, w, owner, xe, ye), path)
        return path

    def locate_blowup(self, prev_state: SWState, n_batch: int):
        """Re-run a failed window un-fused (the eager composition) from
        the last good state and return (k, m, n, value): the first step k
        (1-based within the window) whose post-step check trips, and the
        offending wet cell -- the information the reference prints before
        aborting ('ERROR!!! In the point m=, n=', vel_ssh.f90:52-58) and
        the fused path's scalar reduction discards. Returns None if the
        re-run stays stable (trajectories differ at roundoff level; the
        window bound still stands)."""
        st = reinit_depth_families(prev_state, self.grid, self.cfg)
        step = make_step(self.grid, self.cfg)
        tau = self.cfg.run.tau
        lu = self.grid.lu.cpu().numpy() > 0.5
        for k in range(n_batch):
            st, ok = step(st, tau)
            if not bool(ok):
                ssh = st.ssh.cpu().numpy()
                bad = np.abs(np.where(lu & np.isfinite(ssh), ssh,
                                      np.where(lu, np.inf, 0.0)))
                m, n = np.unravel_index(int(np.argmax(bad)), bad.shape)
                return k + 1, int(m), int(n), float(ssh[m, n])
        return None

    def _raise_blowup(self, prev_state, n_batch: int, done: int):
        """The stability guard tripped inside the last window: localize
        the blow-up (step + cell + the kernel's tile) before raising --
        the reference aborts with the offending (m, n) every step
        (check_ssh_err_kernel); the fused loop only carries a
        window-level scalar, so the failed window is replayed un-fused
        (in the plain global view: the eager sharded step's state is
        cropped first). Across processes every rank raises the window's
        range alone, as the JAX model does."""
        first = done - n_batch
        if multihost.process_count() > 1:
            raise FloatingPointError(
                "SIGFPRE predict error: |ssh| bound exceeded between "
                f"steps {first + 1} and {done} (multi-process run; "
                "re-run single-process to localize the cell)")
        loc = self.locate_blowup(prev_state, n_batch)
        if loc is not None:
            k, m, n, val = loc
            tile = ""
            fs = getattr(self, "_fused_sh", None) \
                or getattr(self, "_fused_per", None)
            fm = getattr(self, "_fused", None)
            if fs is not None:      # the shard, and the kernel's tile in it
                i = int(np.searchsorted(fs.x_edges, m, "right")) - 1
                j = int(np.searchsorted(fs.y_edges, n, "right")) - 1
                tx, ty = fs.tile
                tile = (f"; shard ({i}, {j}), tile "
                        f"({(m - int(fs.x_edges[i]) + fs.M) // tx}, "
                        f"{(n - int(fs.y_edges[j]) + fs.M) // ty}) of "
                        f"{tx}x{ty} cells")
            elif fm is not None:
                tx, ty = fm.tile
                a, b = (m + fm.lay.margin) // tx, (n + fm.lay.margin) // ty
                tile = (f"; fused tile ({a}, {b}) (layout rows "
                        f"{a * tx}..{(a + 1) * tx - 1}, columns "
                        f"{b * ty}..{(b + 1) * ty - 1})")
            raise FloatingPointError(
                f"SIGFPRE predict error: in the point m={m} n={n} "
                f"ssh={val:.6g} at step {first + k}{tile}")
        raise FloatingPointError(
            "SIGFPRE predict error: |ssh| >= 1e4 "
            f"within steps {first}..{done}")

    @staticmethod
    def _fused_sharded_runner(fs, n_inner: int):
        inner = fs.make_runner(n_inner)

        def runner(st):
            # every process gets the whole basin (collective)
            carry, ok = inner(fs.pack(st))
            return fs.unpack(carry, st, gather=True), ok
        return runner

    def _make_runner(self, n_inner: int):
        tau = self.cfg.run.tau
        if self._use_fused_sharded():
            from .fused_sharded2d import FusedSharded2DModel
            fs = getattr(self, "_fused_sh", None)
            if fs is not None and n_inner % fs.steps_per_call == 0:
                return self._fused_sharded_runner(fs, n_inner)
            # two chained steps a launch halve the exchanges and the
            # launches (on a wider margin); an odd window takes one. A
            # rebuild keeps the cut lines already chosen
            spc = 2 if n_inner % 2 == 0 else 1
            # parallel.par mod_decomposition=1 selects the weighted
            # (equal-wet) cut lines (decomposition.f90:614-669),
            # mod_decomposition=2 the cuts read at init
            xe, ye = self._file_cuts or (None, None)
            if fs is not None:
                xe, ye = fs.x_edges, fs.y_edges
            fs = self._fused_sh = FusedSharded2DModel(
                self.grid, self.cfg, tau, *self.mesh.shape,
                devices=self._shard_devices(),
                mu_const=self.state_mu_const(),
                weighted=self.cfg.parallel.mod_decomposition == 1,
                x_edges=xe, y_edges=ye, steps_per_call=spc)
            return self._fused_sharded_runner(fs, n_inner)
        if self.mesh is not None:
            # the eager sharded step on the padded, stacked state
            from .sharded import make_sharded_step
            if not hasattr(self, "_grid_s"):    # mu made to vary since
                self._prepare_mesh_grid()
            stepn = make_sharded_step(self._grid_s, self.cfg, self.mesh,
                                      n_inner=n_inner)

            def runner(st):
                return stepn(st, tau)
            return runner
        if self._fused_periodic_tx() is not None:
            # periodic, no mesh: the fused kernel on a 1x1 'mesh' whose
            # margin exchange wraps locally, one step a launch
            from .fused_sharded2d import FusedSharded2DModel
            if not hasattr(self, "_fused_per"):
                self._fused_per = FusedSharded2DModel(
                    self.grid, self.cfg, tau, 1, 1,
                    mu_const=self.state_mu_const())
            return self._fused_sharded_runner(self._fused_per, n_inner)
        if self._use_fused():
            from .fused import FusedSWModel
            # two chained steps a launch halve the streamed passes; an odd
            # window takes one step a launch
            spc = 2 if n_inner % 2 == 0 else 1
            if getattr(self, "_fused_spc", None) != spc:
                self._fused = FusedSWModel(self.grid, self.cfg, tau,
                                           static_rslu=True,
                                           mu_const=self.state_mu_const(),
                                           steps_per_call=spc)
                self._fused_spc = spc
            fm = self._fused

            def runner(st):
                # pack refuses a state whose mu is not the kernel's
                s6, ok = fm.run_steps(fm.pack(st), n_inner)
                return fm.unpack(s6, st), ok
            return runner
        step = make_step(self.grid, self.cfg)

        def runner(st):
            return run_steps(step, st, tau, n_inner)
        return runner

    def compute_path(self) -> str:
        """The route ``run`` takes, as its 'compute path' line names it
        (on a mesh across processes, with the transport)."""
        over = (f" ({multihost.transport()})"
                if multihost.process_count() > 1 and self.mesh is not None
                else "")
        if self._use_fused_sharded():
            return "fused CUDA kernel, sharded" + over
        if self.mesh is not None:
            return "eager composition, sharded" + over
        if self._fused_periodic_tx() is not None:
            return "fused CUDA kernel, periodic (1x1 wrap)"
        if self._use_fused():
            return "fused CUDA kernel"
        return "eager composition"

    def _global_state(self, state: SWState) -> SWState:
        """The eager sharded step's stacked, padded state -> the plain
        global view at the basin's extents (gathered from every process:
        collective)."""
        return crop_state(unshard_tree(state, self.mesh), self.cfg.basin.nx,
                          self.cfg.basin.ny)

    def _save(self, path: str, fmt: str, state: SWState,
              plain) -> None:
        """A restart point: the npz file (rank 0 writes the gathered
        state; every process joins the gather) or the sharded directory
        (every process writes its shards)."""
        if fmt == "orbax" or os.path.isdir(path):
            if self.mesh is not None and not self._use_fused_sharded():
                save_checkpoint_sharded(
                    path, state, self.num_step, self.mesh,
                    extents=(self.cfg.basin.nx, self.cfg.basin.ny))
            else:       # the basin, cut as the fused-sharded model cuts it
                fs = getattr(self, "_fused_sh", None) if self.mesh else None
                save_checkpoint_sharded(
                    path, state, self.num_step, self.mesh,
                    *((fs.x_edges, fs.y_edges) if fs else ()))
            return
        whole = plain(state)
        if multihost.process_index() == 0:
            save_checkpoint(path, whole, self.num_step)
        multihost.barrier()

    def _output(self, state: SWState, nrec: int):
        """One GrADS record of the (gathered) state, written by rank 0."""
        if multihost.process_index() != 0:
            return
        basin, run = self.cfg.basin, self.cfg.run
        t = model_time(self.num_step, run.tau, run.init_year)
        lu = self.grid.lu.cpu().numpy()
        common = dict(nx=basin.nx - 4, ny=basin.ny - 4, nt=nrec,
                      x0=basin.rlon, hx=basin.dxst,
                      y0=basin.rlat, hy=basin.dyst,
                      year=t.year, month=t.month, day=t.day,
                      hour=t.hour, minute=t.minute,
                      tstep_sec=run.loc_data_wr_period_min * 60.0)
        if nrec == 1:
            p = os.path.join(self.results_dir, "hhq.dat")
            grads.write_record(p, 1, self.grid.hhq_rest.cpu().numpy(), lu)
            grads.write_ctl(p, title="HHQ, m", varname="hhq", **common)
        p = os.path.join(self.results_dir, "ssh.dat")
        grads.write_record(p, nrec, state.ssh.cpu().numpy(), lu)
        grads.write_ctl(p, title="SSH, m", varname="ssh", **common)
        if self.cfg.sw.use_tracers > 0 and state.ff is not None:
            p = os.path.join(self.results_dir, "ff1.dat")
            grads.write_record(p, nrec, state.ff[-1].cpu().numpy(), lu)
            grads.write_ctl(p, title="ff1 (last)", varname="ff1", **common)

    # ------------------------------------------------------------------
    def run(self, checkpoint_path: Optional[str] = None,
            verbose: bool = True,
            checkpoint_format: str = "npz",
            checkpoint_every: Optional[int] = None) -> SWState:
        """The main time loop (model.f90:132-200).

        ``checkpoint_format``: "npz" (one file, read and written by the
        JAX package too) or "orbax": the port's per-shard directory
        (``io/checkpoint.py::save_checkpoint_sharded``, not the orbax
        format). Resume takes either: a directory is a sharded one.

        ``checkpoint_every``: write a restart point to
        ``checkpoint_path`` every N steps DURING the run (rounded to
        the output-window boundaries the loop already returns to host
        on) -- production restart safety beyond the reference, which
        only writes diagnostics mid-run. Resume (start_type=1) picks
        the run up from the last completed window."""
        cfg = self.cfg
        run = cfg.run
        n_total = run.num_step_max
        n_out = run.output_every_steps or n_total

        if checkpoint_format not in ("npz", "orbax"):
            raise ValueError(f"checkpoint_format={checkpoint_format!r}")
        if run.start_type == 1 and checkpoint_path \
                and os.path.exists(checkpoint_path):
            load = (load_checkpoint_sharded if os.path.isdir(checkpoint_path)
                    else load_checkpoint)
            self.state, self.num_step = load(checkpoint_path,
                                             device=self.device)
            if verbose:
                print(f"MODEL: resumed from {checkpoint_path} "
                      f"at step {self.num_step}")

        # dynamic load balance (model.f90:64-89's dlb branch): probe,
        # measure, re-cut before the production loop -- on the
        # fused-sharded route only, as in the JAX model
        if (cfg.parallel.dlb_balance_steps > 0
                and (cfg.parallel.mesh_x > 1 or cfg.parallel.mesh_y > 1)
                and self._use_fused_sharded()):
            self.dynamic_load_balance(verbose=verbose)

        if cfg.parallel.debug_level >= 2 and self.mesh is not None:
            # the reference's sync_test hook (init_data.f90:41-44,
            # syncborder_block2D_gen_test.fi): verify the halo exchange
            # against the analytic i*j field before the production loop
            from ..parallel.halo import halo_self_test
            px, py = cfg.parallel.mesh_x, cfg.parallel.mesh_y
            nxt = -(-self.grid.nx // px) * px
            nyt = -(-self.grid.ny // py) * py
            halo_self_test(self.mesh, nxt, nyt,
                           self.grid.periodic_x and nxt == self.grid.nx,
                           self.grid.periodic_y and nyt == self.grid.ny)
            if verbose:
                print("SYNC INFO: halo self-test passed "
                      f"({px}x{py} mesh)")
        if cfg.parallel.debug_level >= 3:
            # the reference's debug ladder writes decomposition.txt on
            # every run at this level (decomposition.f90:895-909)
            p = self.dump_decomposition_txt()
            if verbose:
                print(f"DD INFO: Print decomposition in file {p}")

        if verbose:
            print(self.startup_report())
            print(f"MODEL: compute path: {self.compute_path()}")

        # the eager sharded step runs on the padded state laid out on the
        # mesh; output, restart points and the result are its crop
        sharded = self.mesh is not None and not self._use_fused_sharded()
        state = (shard_tree(pad_state(self.state, *self.mesh.shape),
                            self.mesh) if sharded else self.state)
        plain = self._global_state if sharded else (lambda st: st)
        runner = self._make_runner(n_out)

        nrec = 1
        if run.output_every_steps:
            with self.timers.phase("output"):
                self._output(plain(state), nrec)

        done = self.num_step
        while done < n_total:
            n_batch = min(n_out, n_total - done)
            if n_batch != n_out:
                runner = self._make_runner(n_batch)
            prev_state = state
            with self.timers.phase("model_step"):
                # the runner reads the window's flag from the device,
                # which is the barrier the timer needs
                state, ok = runner(state)
                stable = bool(ok)
            done += n_batch
            self.num_step += n_batch
            if not stable:
                self._raise_blowup(plain(prev_state), n_batch, done)
            if run.output_every_steps:
                nrec += 1
                with self.timers.phase("output"):
                    self._output(plain(state), nrec)
            if checkpoint_path and checkpoint_every \
                    and done < n_total \
                    and done % max(checkpoint_every, 1) < n_batch:
                with self.timers.phase("checkpoint"):
                    self._save(checkpoint_path, checkpoint_format, state,
                               plain)
                if verbose:
                    print(f"MODEL: restart point at step "
                          f"{self.num_step} -> {checkpoint_path}")
            if verbose:
                t = model_time(self.num_step, run.tau, run.init_year)
                print(f"MODEL: step {self.num_step}/{n_total}  {t.stamp()}")

        if checkpoint_path:
            with self.timers.phase("checkpoint"):
                self._save(checkpoint_path, checkpoint_format, state, plain)
        state = self.state = plain(state)
        wet = float(self.grid.lu.sum())
        steps_done = self.num_step - run.init_step
        t_step = self.timers.acc.get("model_step", 0.0)
        pts = wet * steps_done / max(t_step, 1e-12)
        # across processes ONE max/min-over-ranks table (mpp_finalize,
        # mpp.f90:272-341): the gather is collective, so every process
        # joins it whatever its verbose flag; rank 0 prints
        rep = self.timers.reduced_report(
            extra={"wet_points_per_sec": f"{pts:.3e}"})
        if verbose and multihost.process_index() == 0:
            print(rep)
        return state
