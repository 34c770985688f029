"""Halo-exchange and weak-scaling accounting (counterpart of
``ocean_model_arch_tpu/diag/scaling.py``).

The reference's analog is the sync-phase share of the mpp_finalize timer
table (mpp.f90:272-341: sync total / pack / isend-irecv / wait against
the model step). The JAX package reads its collective bytes from the
lowered HLO; the port's exchange is its own code, so its bytes come from
the exchange itself:

- **halo bytes a step**: every strip of ``FusedSharded2DModel._plan``,
  checked against the bytes one exchange really copies and sends (summed
  over the processes). Divided by a link's bandwidth, the caller's, it
  bounds the time the exchange could take without overlap.
- **weak-scaling efficiency**: t_step(smallest mesh) / t_step(N shards)
  at a fixed shard size.

The port lays its shards out its own way (``Ysp`` rounded up to whole
128-byte rows, strips over a shard's box and margin only, not its pad),
so its byte counts are its own formula's, not the JAX package's numbers.
"""

from __future__ import annotations

import time

import torch

from ..parallel import multihost


def _strip_bytes(fs, entry) -> int:
    """The bytes of one strip of ``fs``'s plan: its fields x rows x
    columns in f32."""
    _, into, _, _, _ = entry
    nf = 6 + 2 * fs.n_tracers
    rows, cols = into[1], into[2]
    return nf * (rows.stop - rows.start) * (cols.stop - cols.start) * 4


def expected_halo_bytes_per_step(fs) -> int:
    """The port's analytic bytes a model step of the margin exchange of a
    ``FusedSharded2DModel`` over all its shards: an exchange moves, for
    each of the 6 + 2 T fields, an (M, ly + 2 M) strip to every x
    neighbour of a shard (both sides; the wrap on a periodic axis, the
    shard's own far edge with one shard along it) and an (lx + 2 M, M)
    strip to every y neighbour, f32. Summed over the shards:

        4 (6 + 2 T) M [cx (ny + 2 M py) + cy (nx + 2 M px)] / spc

    with cx = 2 (px - 1 + periodic_x), cy = 2 (py - 1 + periodic_y)
    strips a band, spc the steps a launch (one exchange for them)."""
    M, nf = fs.M, 6 + 2 * fs.n_tracers
    nx, ny = fs.grid.nx, fs.grid.ny
    cx = 2 * (fs.px - 1 + int(fs.periodic_x))
    cy = 2 * (fs.py - 1 + int(fs.periodic_y))
    return (4 * nf * M * (cx * (ny + 2 * M * fs.py)
                          + cy * (nx + 2 * M * fs.px))
            // fs.steps_per_call)


def halo_bytes_per_step(fs) -> int:
    """Bytes a model step of ``fs``'s margin exchange over all its
    shards: the strips of its plan, held against one exchange run on a
    zero carry (the bytes it copied within each process and sent between
    them, summed over the processes; collective; the model's strip
    counters are left as they were), and against
    :func:`expected_halo_bytes_per_step`."""
    planned = sum(_strip_bytes(fs, e) for e in fs._plan)
    carry = [None if not loc else torch.zeros(
        (6 + 2 * fs.n_tracers, fs.lay.Xs, fs.lay.Ys),
        device=fs.grid.lu.device) for loc in fs.local]
    counts = ("strip_copies", "bytes_copied", "strips_sent", "bytes_sent",
              "strips_received")
    kept = {k: getattr(fs, k) for k in counts}
    fs.exchange(carry)
    moved = sum(multihost.all_objects(fs.bytes_copied + fs.bytes_sent
                                      - kept["bytes_copied"]
                                      - kept["bytes_sent"]))
    for k, v in kept.items():        # the counters keep counting runs only
        setattr(fs, k, v)
    if moved != planned:
        raise RuntimeError(f"the exchange moved {moved} bytes, its plan "
                           f"{planned}")
    per_step = planned // fs.steps_per_call
    if per_step != expected_halo_bytes_per_step(fs):
        raise RuntimeError(f"{per_step} bytes a step against the formula's "
                           f"{expected_halo_bytes_per_step(fs)}")
    return per_step


def cross_process_bytes_per_step(fs) -> int:
    """The part of :func:`halo_bytes_per_step` whose strips travel between
    two processes (0 in one process)."""
    return sum(_strip_bytes(fs, e) for e in fs._plan
               if fs.owners[e[0]] != fs.owners[e[2]]) // fs.steps_per_call


def halo_overlap_report(fs, link_GBps: float,
                        t_step_sharded: float | None = None) -> dict:
    """The exchange's bytes a step and, at the caller's link bandwidth
    ``link_GBps`` (GB/s; the port assumes no figure of its own), the time
    they would take with no overlap, as if every strip crossed the link
    (an upper bound); with a measured seconds a step, that time's share
    of it."""
    bytes_step = halo_bytes_per_step(fs)
    out = {
        "halo_bytes_per_step": bytes_step,
        "cross_process_bytes_per_step": cross_process_bytes_per_step(fs),
        "link_GBps": link_GBps,
        "comm_seconds_per_step_bound": bytes_step / (link_GBps * 1e9),
    }
    if t_step_sharded is not None:
        out["comm_fraction_bound"] = min(
            1.0, out["comm_seconds_per_step_bound"] / t_step_sharded)
    return out


def _on_cuda(carry) -> bool:
    """Whether a carry (a tensor, a sequence of them, or a state) lies on
    a card."""
    if isinstance(carry, torch.Tensor):
        return carry.is_cuda
    if isinstance(carry, (tuple, list)):
        return any(_on_cuda(c) for c in carry if c is not None)
    return _on_cuda(getattr(carry, "ssh", None)) if hasattr(
        carry, "ssh") else False


def time_stepper(stepper, carry, n_inner: int, windows: int = 3) -> float:
    """Best-of-N seconds a step of a ``carry -> (carry, ok)`` stepper of
    ``n_inner`` steps: CUDA events around each window of a carry on a
    card (the host clock on the CPU), after a warm-up window; reading
    ``ok`` ends each window. Raises if the guard trips."""
    carry, ok = stepper(carry)
    if not bool(ok):
        raise RuntimeError("stability guard tripped during warmup")
    cuda = _on_cuda(carry)
    best = float("inf")
    for _ in range(windows):
        if cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            carry, ok = stepper(carry)
            t1.record()
            good = bool(ok)
            t1.synchronize()
            dt = t0.elapsed_time(t1) / 1e3
        else:
            t = time.perf_counter()
            carry, ok = stepper(carry)
            good = bool(ok)
            dt = time.perf_counter() - t
        best = min(best, dt)
        if not good:
            raise RuntimeError("stability guard tripped during timing")
    return best / n_inner


def weak_scaling(mesh_shapes, nx_loc: int, ny_loc: int,
                 n_inner: int = 64, steps_per_call: int = 2,
                 windows: int = 3, device=None, verbose: bool = False,
                 path: str = "auto") -> dict:
    """Weak-scaling harness: a fixed nx_loc x ny_loc shard over growing
    meshes ``[(px, py), ...]`` of a flat f32 basin (frame of land),
    efficiency(N) = t_step(smallest mesh) / t_step(N).

    Every shard runs in this process on ``device`` (None: the current
    CUDA device, raising without one), so the shards share it: the
    work-normalized efficiency N t_step(1) / t_step(N) is what isolates
    the exchange's and the seams' cost here. ``path``: "fused" =
    ``FusedSharded2DModel`` (K1b and the strip exchange), "eager" = the
    eager sharded step (``model/sharded.py``), "auto" = fused on a card,
    eager on the CPU."""
    from ..config import ModelConfig, Precision, SWConfig, basinpar_flat
    from ..core.grid import build_grid
    from ..core.masks import frame_of_land_mask
    from ..host import default_device
    from ..model.fused_sharded2d import FusedSharded2DModel
    from ..model.init import init_ocean_state
    from ..model.sharded import make_sharded_step, prepare
    from ..parallel.mesh import make_mesh

    device = torch.device(default_device() if device is None else device)
    if path == "auto":
        path = "fused" if device.type == "cuda" else "eager"
    if path not in ("fused", "eager"):
        raise ValueError(f"path={path!r}: 'fused', 'eager' or 'auto'")
    rows = []
    for px, py in mesh_shapes:
        nx, ny = nx_loc * px, ny_loc * py
        basin = basinpar_flat(nx, ny, curve_grid=1, rlon=27.5, rlat=41.0)
        cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=0),
                          precision=Precision.f32())
        grid = build_grid(basin, frame_of_land_mask(nx, ny),
                          precision=cfg.precision, device=device)
        state = init_ocean_state(grid, cfg)
        if path == "fused":
            fs = FusedSharded2DModel(grid, cfg, 1.0, px, py,
                                     steps_per_call=steps_per_call)
            t = time_stepper(fs.make_runner(n_inner), fs.pack(state),
                             n_inner, windows)
            hbytes = halo_bytes_per_step(fs)
        else:
            mesh = make_mesh(px, py, device)
            grid_s, state_s = prepare(grid, state, mesh)
            stepped = make_sharded_step(grid_s, cfg, mesh, n_inner=n_inner)
            t = time_stepper(lambda st: stepped(st, 1.0), state_s,
                             n_inner, windows)
            hbytes = 0
        rows.append({"mesh": [px, py], "shards": px * py,
                     "points": nx * ny, "step_seconds": t,
                     "points_per_sec": nx * ny / t,
                     "halo_bytes_per_step": hbytes})
        if verbose:
            print(f"WEAK: {px}x{py}  {t * 1e3:8.3f} ms/step", flush=True)
    t1 = min(rows, key=lambda r: r["shards"])["step_seconds"]
    for r in rows:
        r["efficiency"] = t1 / r["step_seconds"]
        r["efficiency_work_normalized"] = r["shards"] * t1 / r["step_seconds"]
    return {"nx_loc": nx_loc, "ny_loc": ny_loc, "path": path,
            "device": str(device), "shared_device": True, "rows": rows,
            "efficiency_last": rows[-1]["efficiency_work_normalized"]}
