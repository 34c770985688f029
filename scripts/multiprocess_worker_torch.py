"""One process of a multi-process run of the port (the counterpart of
``scripts/multiprocess_worker.py``): N of them, wired by
``torch.distributed`` (``ocean_model_arch_torch/parallel/multihost.py``),
run one model over a mesh whose shards they share, each on its own
device -- the reference's multi-rank MPI execution (shared/mpp/
mpp.f90:64-93; the inter-rank sends of syncborder_block2D_gen_all.fi:
100-129).

Usage (``tests/test_torch_multiprocess.py`` and ``chip_smoke.py`` start
them; by hand, one command a rank):

  python scripts/multiprocess_worker_torch.py RANK NPROC INIT_METHOD OUTDIR \\
      [eager|fused2d|fused2d_bipolar|azov_mask|transport_probe] \\
      [--device cpu|cuda] [--backend gloo|nccl]

``INIT_METHOD``: ``file:///path`` (a store file no other run uses) or
``tcp://host:port``. ``--device``: the process's device (default: its
card; ``cpu`` only when asked for); ``--backend``: the transport (default
gloo; nccl needs a card a process).

- ``eager``: the halo self-test across the processes (closed and
  periodic), then N1 = 12 steps of the eager sharded step on an (NPROC,
  1) mesh, the x axis across the processes (f64); rank 0 writes the gathered
  state (``mid.npz``); every process writes its shards into a sharded
  checkpoint, reads its own back into place, runs N2 = 8 more steps; the
  timer table reduced over the ranks (``timers.txt``) and the gathered
  end state (``end.npz``); a NaN put into the last rank's block fails the
  next step's guard on every rank.
- ``fused2d`` / ``fused2d_bipolar`` (NPROC = 4): ``FusedSharded2DModel``
  on a 2 x 2 mesh, a shard a process, so both axes and the corners cross
  processes, two chained steps a launch, N1 + N2 steps (the bipolar grid's
  fast2d metric planes in the second); rank 0 writes the gathered fields
  (``fused2d.npz``); a NaN put into the last rank's shard fails the next
  window's guard on every rank.
- ``azov_mask`` (NPROC = 2; the card): the Azov coastline at 1525 x 1115
  (f32, no tracers, tile guard), ``FusedSharded2DModel`` 2 x 1 with two
  steps a launch, AZOV_STEPS steps: rank 0 writes the gathered fields
  (``azov.npz``); then ms/step over windows, K1b's device us a launch
  (torch.profiler) on each rank in turn, and the guard on a NaN put
  into rank 1's shard: each rank writes ``azov-<rank>.json``.

- ``transport_probe`` (NPROC = 2, the card): what the transport does with
  CUDA tensors -- Gloo's send / recv of one, NCCL with both ranks on one
  card -- written to ``probe-<backend>-<rank>.json``.

Each other run ends by writing ``ok`` (rank 0).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N1, N2 = 12, 8          # steps before / after the checkpoint boundary
AZOV_STEPS = 40         # steps of the azov_mask run
TIME_STEPS = 40         # steps of a timed window of the azov_mask run
N_K1B = 50              # K1b launches timed on each rank


def build_workload(nproc: int, curve_grid: int = 1, f64: bool = False,
                   device="cpu"):
    """The JAX worker's deterministic tiny workload (frame basin 8 *
    max(nproc, 2) x 24, one tracer; ``curve_grid=2``: bipolar), f32, or
    f64 with ``f64``, identical on every process and in the one-process
    run it is compared with."""
    from ocean_model_arch_torch.config import (ModelConfig, Precision,
                                               SWConfig, basinpar_flat)
    from ocean_model_arch_torch.core.grid import build_grid
    from ocean_model_arch_torch.core.masks import frame_of_land_mask
    from ocean_model_arch_torch.model.init import init_ocean_state

    nx, ny = 8 * max(nproc, 2), 24
    basin = basinpar_flat(nx, ny, curve_grid=curve_grid,
                          rlon=27.5, rlat=41.0)
    prec = Precision.f64() if f64 else Precision.f32()
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=1, tracer_num=1),
                      precision=prec)
    grid = build_grid(basin, frame_of_land_mask(nx, ny), precision=prec,
                      device=device)
    return grid, cfg, init_ocean_state(grid, cfg)


def azov_workload(device):
    """The Azov coastline at the 250 m extents 1525 x 1115, f32, no
    tracers (``chip_smoke.py``'s ``azov_mask``)."""
    from ocean_model_arch_torch.core.grid import build_grid
    from ocean_model_arch_torch.host import (ModelConfig, Precision,
                                             SWConfig, basinpar_as250m_test,
                                             read_mask)
    from ocean_model_arch_torch.model.init import init_ocean_state

    basin = basinpar_as250m_test()
    prec = Precision.f32()
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=0),
                      precision=prec)
    mask = read_mask(os.path.join(REPO, "data", "AS", "maskAzovCor.txt"),
                     basin.nx, basin.ny)
    grid = build_grid(basin, mask, precision=prec, device=device)
    return grid, cfg, init_ocean_state(grid, cfg)


def _fields_npz(path, fields, names=("ssh", "u", "v", "tr"),
                at=(0, 2, 4, 6)):
    import numpy as np
    np.savez(path, **{n: fields[k].cpu().numpy()
                      for n, k in zip(names, at) if k < len(fields)})


def main_eager(rank: int, nproc: int, outdir: str) -> None:
    import numpy as np
    import torch

    from ocean_model_arch_torch.io.checkpoint import (
        load_checkpoint_sharded, save_checkpoint_sharded)
    from ocean_model_arch_torch.model.sharded import (make_sharded_step,
                                                      prepare)
    from ocean_model_arch_torch.parallel import multihost
    from ocean_model_arch_torch.parallel.domain import crop_state
    from ocean_model_arch_torch.parallel.halo import halo_self_test
    from ocean_model_arch_torch.parallel.mesh import make_mesh, unshard_tree
    from ocean_model_arch_torch.utils.timers import PhaseTimers

    dev = multihost.local_device()
    grid, cfg, state = build_workload(nproc, f64=True, device=dev)
    mesh = make_mesh(nproc, 1, dev)          # the x axis spans the ranks
    assert mesh.block == (1, 1) and mesh.owner(rank, 0) == rank
    # the halo self-test across the ranks, closed and periodic (with 2
    # ranks the low and the high neighbour are one process)
    halo_self_test(mesh, grid.nx, grid.ny)
    halo_self_test(mesh, grid.nx, grid.ny, periodic_x=True, periodic_y=True)
    gs, ss = prepare(grid, state, mesh)
    mid, ok = make_sharded_step(gs, cfg, mesh, n_inner=N1)(ss, 1.0)
    assert ok, "stability guard tripped across processes (eager)"

    def gather(st):                          # collective: every rank
        return crop_state(unshard_tree(st, mesh), grid.nx, grid.ny)

    def write(name, st):
        g = gather(st)
        if rank == 0:
            np.savez(os.path.join(outdir, name), ssh=g.ssh.cpu().numpy(),
                     u=g.ubrtr.cpu().numpy(), v=g.vbrtr.cpu().numpy(),
                     tr=g.ff[0].cpu().numpy())

    write("mid.npz", mid)
    # ---- a sharded checkpoint across the process boundary --------------
    ck = os.path.join(outdir, "ckpt")
    save_checkpoint_sharded(ck, mid, N1, mesh, extents=(grid.nx, grid.ny))
    restored, step0 = load_checkpoint_sharded(ck, mesh)
    assert step0 == N1
    # each rank's own shards, back in place on its device, no gather
    for f in ("ssh", "sshp", "ubrtr", "vbrtr", "ff"):
        a, b = getattr(restored, f), getattr(mid, f)
        assert a.shape == b.shape and a.device == b.device, f
        assert torch.equal(a, b), f
    end, ok2 = make_sharded_step(gs, cfg, mesh, n_inner=N2)(restored, 1.0)
    assert ok2
    # ---- the timer table reduced over the ranks ------------------------
    tm = PhaseTimers()
    tm.add("model_step", 1.0 + rank)
    tm.add(f"only_rank{rank}", 0.5)
    rep = tm.reduced_report()
    if rank == 0:
        with open(os.path.join(outdir, "timers.txt"), "w") as f:
            f.write(rep)
    write("end.npz", end)
    # the guard: a NaN in the last rank's block trips every rank (in
    # sshp, which the step's new ssh inherits, as tests/test_physics.py's
    # guard test pollutes it)
    if rank == nproc - 1:
        end.sshp[0, 0, 4, 4] = float("nan")
    _, ok3 = make_sharded_step(gs, cfg, mesh, n_inner=1)(end, 1.0)
    assert not ok3, "a NaN on one rank did not trip this rank's guard"


def main_fused2d(rank: int, nproc: int, outdir: str,
                 curve_grid: int = 1) -> None:
    from ocean_model_arch_torch.model.fused_sharded2d import \
        FusedSharded2DModel
    from ocean_model_arch_torch.parallel import multihost

    assert nproc == 4
    dev = multihost.local_device()
    grid, cfg, state = build_workload(nproc, curve_grid, device=dev)
    fm = FusedSharded2DModel(grid, cfg, 1.0, 2, 2,
                             devices=multihost.devices(), steps_per_call=2)
    assert fm.owners == [0, 1, 2, 3] and sum(fm.local) == 1
    c, ok = fm.make_runner(N1)(fm.pack(state))
    assert ok, "stability guard tripped across processes (fused2d)"
    c, ok = fm.make_runner(N2)(c)
    assert ok
    # every strip of this rank crossed a process: none copied locally
    assert fm.strip_copies == 0 and fm.strips_sent == fm.strips_received > 0
    fields = fm.extract(c, gather=True)
    if rank == 0:
        _fields_npz(os.path.join(outdir, "fused2d.npz"), fields)
    # the guard: a NaN at a wet cell of the last rank's shard trips every
    # rank's window
    if rank == nproc - 1:
        c[fm.local.index(True)][0, fm.M + 2, fm.M + 2] = float("nan")
    _, ok = fm.make_runner(2)(c)
    assert not ok, "a NaN on one rank did not trip this rank's guard"


def _k1b_us(launch) -> tuple:
    """N_K1B launches after one: (device us a launch of the fused step's
    kernel from torch.profiler, us between launches from CUDA events --
    the wrapper's host time where it exceeds the kernel's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(N_K1B):
            launch()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if "fused_sw" in e.key and e.self_device_time_total > 0]
    device = (sum(e.self_device_time_total for e in kern)
              / max(sum(e.count for e in kern), 1))
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(N_K1B):
        launch()
    e1.record()
    e1.synchronize()
    return device, e0.elapsed_time(e1) / N_K1B * 1e3


def main_azov(rank: int, nproc: int, outdir: str) -> None:
    import torch

    from ocean_model_arch_torch.diag.scaling import (
        cross_process_bytes_per_step, halo_bytes_per_step)
    from ocean_model_arch_torch.model.fused_sharded2d import \
        FusedSharded2DModel
    from ocean_model_arch_torch.ops.fused_step import fused_sw_step_raw
    from ocean_model_arch_torch.parallel import multihost

    assert nproc == 2
    t0 = time.perf_counter()
    dev = multihost.local_device()
    grid, cfg, state = azov_workload(dev)
    fm = FusedSharded2DModel(grid, cfg, cfg.run.tau, 2, 1,
                             devices=multihost.devices(), steps_per_call=2)
    c, ok = fm.make_runner(AZOV_STEPS)(fm.pack(state))
    fields = fm.extract(c, gather=True)
    t_first = time.perf_counter() - t0
    if rank == 0:
        import numpy as np
        np.savez(os.path.join(outdir, "azov.npz"),
                 **{str(k): f.cpu().numpy() for k, f in enumerate(fields)})
    info = {"rank": rank, "ok": bool(ok), "device": str(dev),
            "transport": multihost.transport(),
            "seconds_to_first_result": t_first,
            "halo_bytes_per_step": halo_bytes_per_step(fm),
            "cross_process_bytes_per_step":
                cross_process_bytes_per_step(fm),
            "strips_sent": fm.strips_sent, "bytes_sent": fm.bytes_sent,
            "strip_copies": fm.strip_copies}
    # ms/step: three windows, each ended by its flag (reduced over ranks)
    run = fm.make_runner(TIME_STEPS)
    windows = []
    for _ in range(3):
        multihost.barrier()
        t = time.perf_counter()
        c, ok_w = run(c)
        windows.append((time.perf_counter() - t) / TIME_STEPS * 1e3)
        assert ok_w
    info["ms_per_step"] = sorted(windows)
    # K1b on this rank's shard, each rank in turn (the card is shared):
    # CUDA events over N_K1B launches after one, this rank's raw form
    k = fm.local.index(True)
    i, j = divmod(k, fm.py)
    sw = cfg.sw
    cur = c[k].unbind(0)
    out = tuple(torch.zeros_like(f) for f in cur)
    bmax = torch.zeros((-(-fm.lay.Xs // fm.tile[0]),
                        -(-fm.lay.Ys // fm.tile[1])), device=dev)

    def launch():
        fused_sw_step_raw(cur, out, bmax, fm.met_shards[i][j],
                          fm.plane_shards[i][j], fm.shard_lay[i][j], fm.tau,
                          sw.time_smooth, fm.hr_const, fm.tile_wet[i][j],
                          fm.tile, fm.met_map, fm.mu_const, fm.visc,
                          fm.trans, fm.ffs, fm.steps_per_call, fm.general,
                          fm.folds)
    for r in range(nproc):
        multihost.barrier()
        if r == rank and dev.type == "cuda":
            info["k1b_us"], info["k1b_interval_us"] = _k1b_us(launch)
            info["k1b_shard"] = [i, j, fm.lx[i], fm.ly[j]]
    # the guard: a NaN at a wet cell of rank 1's shard trips every rank
    if rank == 1:
        wet = (grid.lu[fm.x_edges[i]:fm.x_edges[i + 1]] > 0.5).nonzero()
        m, n = wet[len(wet) // 2].tolist()
        c[k][0, fm.M + m, fm.M + n] = float("nan")
        info["nan_at"] = [int(fm.x_edges[i]) + m, n]
    _, ok_nan = fm.make_runner(2)(c)
    info["guard_tripped"] = not ok_nan
    with open(os.path.join(outdir, f"azov-{rank}.json"), "w") as f:
        json.dump(info, f)


def probe_transport(rank: int, nproc: int, init_method: str, outdir: str,
                    backend: str, device) -> None:
    """What a transport does with CUDA tensors: under Gloo each rank
    sends / receives a CUDA tensor, under NCCL (both ranks on one card)
    the process group's first collective; each rank writes
    ``probe-<backend>-<rank>.json`` with the error it met, or None, and
    leaves without tearing the group down."""
    import torch
    import torch.distributed as dist

    from ocean_model_arch_torch.parallel import multihost

    err = None
    try:
        dev = multihost.initialize(init_method, nproc, rank,
                                   backend=backend, device=device)
        t = torch.zeros(4, device=dev)
        if backend == "gloo":
            (dist.send if rank == 0 else dist.recv)(t, 1 - rank)
        else:
            dist.all_reduce(t)
            torch.cuda.synchronize()
    except Exception as e:       # the refusal is what this mode records
        err = f"{type(e).__name__}: {str(e).strip().splitlines()[0]}"
    with open(os.path.join(outdir, f"probe-{backend}-{rank}.json"),
              "w") as f:
        json.dump({"rank": rank, "backend": backend, "error": err}, f)
    sys.stdout.flush()
    os._exit(0)                  # a failed NCCL group is not torn down


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("rank", type=int)
    p.add_argument("nproc", type=int)
    p.add_argument("init_method")
    p.add_argument("outdir")
    p.add_argument("mode", nargs="?", default="eager",
                   choices=("eager", "fused2d", "fused2d_bipolar",
                            "azov_mask", "transport_probe"))
    p.add_argument("--device", default=None)
    p.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = p.parse_args(argv)

    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from ocean_model_arch_torch.parallel import multihost

    if args.mode == "transport_probe":
        probe_transport(args.rank, args.nproc, args.init_method,
                        args.outdir, args.backend, args.device)
    multihost.initialize(args.init_method, args.nproc, args.rank,
                         backend=args.backend, device=args.device)
    try:
        if args.mode == "eager":
            main_eager(args.rank, args.nproc, args.outdir)
        elif args.mode == "azov_mask":
            main_azov(args.rank, args.nproc, args.outdir)
        else:
            main_fused2d(args.rank, args.nproc, args.outdir,
                         curve_grid=2 if args.mode == "fused2d_bipolar"
                         else 1)
        multihost.barrier()
        if args.rank == 0:
            with open(os.path.join(args.outdir, "ok"), "w") as f:
                f.write("ok")
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
