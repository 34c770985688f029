#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port's paths at the Azov 250 m extents 1525 x 1115
(``basinpar_as250m_test``: flat 100 m bathymetry, gaussian SSH bump,
f32) through ``build_grid`` -> ``init_ocean_state`` ->
``FusedSWModel(static_rslu=True, steps_per_call=2)`` -> ``pack`` ->
``run_steps`` -> ``unpack``, in phases:

1. device: the card, its power limit, the toolchain, the kernel build;
2. every form of the fused-step CUDA kernel (no tracers / 2 tracers,
   unguarded / tile guard) against its plain PyTorch version on the card,
   on the 2-cell land frame mask and the shipped Azov coastline: one
   launch (tolerance 1e-5), 50 carried launches (1e-4), land exactly 0
   in all 6 + 2 T fields, all-land tiles exactly 0 with a block max of
   0, guarded and unguarded outputs bit-identical; the 1-tracer
   instantiation likewise on the coastline;
3. the first main path (frame mask, no tracers, unguarded kernel) for
   200 steps: ``ok``, one kernel launch per step, agreement with the
   eager composition at the golden f32 tolerance; ms/step of the kernel
   path, the plain fused version and the eager composition;
4. the stability guard trips on NaN and on |ssh| > 1e4, on the frame
   mask and at a wet cell of the coastline in a tracer-carrying run;
5. the second main path (Azov coastline, 2 tracers, tile guard) for 200
   steps, checked like phase 3 (tracers included) with the tracer mass
   before and after, and its two sub-paths (coastline without tracers,
   frame mask with 2 tracers); then ms/step, points/s and wet points/s
   of seven configurations of the kernel path, and each form's bound
   beside a ``copy_`` of as many bytes.

Every phase prints its lines; any failure raises (exit code != 0). The
line before the last is one JSON object describing the three kernel
forms; the last line is ``{"ok": true, "device": {...}}``. Needs a CUDA
device and nvcc; there is no CPU path.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
N_MAIN = 200            # steps of each main path (phases 3 and 5)
N_CARRY = 50            # carried launches in the kernel comparison
N_TIME = 200            # launches / steps per timing
TOL_ONE, TOL_CARRY = 1e-5, 1e-4
TOL_EAGER = 3e-4        # golden_bs100 f32 tolerance (tests/test_golden.py)
N_TRACERS = 2

# H100 SXM data sheet: HBM bytes/s and f32 FLOP/s outside the tensor cores
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67e12
# what one step needs per computed layout cell: bytes (10 planes read and
# 6 written; 2 + 2 per tracer) and an estimate of the f32 operations
CELL_BYTES, TRACER_BYTES = 64, 16
CELL_FLOPS, TRACER_FLOPS = 100, 25

SOURCE = "ocean_model_arch_torch/ops/csrc/fused_step.cu"
PALLAS = "ocean_model_arch_tpu/ops/pallas/fused_step.py"
REPLACES = {"fused_sw_step": PALLAS + ":1642",
            "fused_sw_step_guarded": PALLAS + ":1106",
            "fused_sw_step_tracers": PALLAS + ":937"}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b| (b the reference); inf if either is not
    finite."""
    if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
        return float("inf")
    scale = max(float(b.abs().max()), 1e-30)
    return float((a - b).abs().max()) / scale


def cuda_ms(fn, n: int) -> float:
    """Device milliseconds per call of ``fn`` over ``n`` calls, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / n


def profile_device_ms(fn, kernel: str):
    """One call of ``fn`` under torch.profiler, after a warm-up call:
    (mean device ms per launch of the CUDA kernel named ``kernel``, device
    ms of everything ``fn`` ran on the card). (None, None) if the profiler
    records no device time for the kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    for e in events:
        if kernel in e.key and e.count and e.self_device_time_total > 0:
            return (e.self_device_time_total / e.count / 1e3,
                    sum(x.self_device_time_total for x in events) / 1e3)
    return None, None


def ptxas_summary(log: str) -> str:
    """``<NT, GUARD>: registers / spill bytes`` per kernel instantiation
    from nvcc's -Xptxas -v output."""
    out, name, spill = [], None, "?"
    for ln in log.splitlines():
        m = re.search(r"fused_sw_step_kernelILi(\d)ELb(\d)E", ln)
        if m:
            name = f"<{m.group(1)},{m.group(2)}>"
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name} {m.group(1)} regs {spill} B spill")
            name = None
    return "; ".join(out) or "(cached build)"


def fmt(es) -> str:
    return "[" + ", ".join(f"{e:.2e}" for e in es) + "]"


def model_args(fm, cfg):
    """The arguments of ``fused_sw_step`` after the fields, as the model
    passes them."""
    return (fm.met, fm.planes, fm.lay, fm.tau, cfg.sw.time_smooth,
            fm.hr_const, fm.tile_wet, fm.tile)


def land_masks(fm, grid, n_tracers):
    """Bool layout masks, True on the land cells of each carried field's
    point set (T, T, u, u, v, v, then T per tracer level)."""
    from ocean_model_arch_torch.ops import fused_layout as fl
    dev = grid.lu.device
    lu_s = np.asarray(fl.embed(fm.lay, grid.lu.cpu()))
    wlcu, wlcv, wlu = (torch.from_numpy(m).to(dev) < 0.5
                       for m in fl.staggered_wet_masks(lu_s))
    return (wlu, wlu, wlcu, wlcu, wlcv, wlcv) + (wlu,) * (2 * n_tracers)


def bound_ms(fm, n_tracers: int):
    """The least time the card could take for one launch of this model's
    kernel form: (ms, "bytes" or "operations", the bytes). Bytes: each
    input plane read once and each output written once over the cells
    the form computes (all cells unguarded; the cells of wet tiles when
    guarded, plus the zero writes of the all-land tiles), the profile
    rows, one flag and one max per block. Operations: an estimate of the f32
    operations of those cells."""
    lay = fm.lay
    cells = lay.Xs * lay.Ys
    blocks = fm.n_tiles[0] + fm.n_tiles[1]
    if fm.tile_wet is None:
        done, skipped = cells, 0
    else:
        tx, ty = fm.tile
        wet = fm.tile_wet.cpu().numpy().repeat(tx, 0).repeat(ty, 1)
        done = int((wet[:lay.Xs, :lay.Ys] > 0).sum())
        skipped = cells - done
    n_out = 6 + 2 * n_tracers
    nbytes = (done * (CELL_BYTES + TRACER_BYTES * n_tracers)
              + skipped * 4 * n_out + fm.met.numel() * 4
              + blocks * (4 + (4 if fm.tile_wet is not None else 0)))
    flops = done * (CELL_FLOPS + TRACER_FLOPS * n_tracers)
    t_b, t_f = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return (t_b, "bytes", nbytes) if t_b >= t_f else (t_f, "operations",
                                                      nbytes)


def copy_floor_ms(nbytes: float, device) -> float:
    """Device ms of one ``copy_`` that moves ``nbytes`` in all (half read,
    half written): what the card's memory system gives a plain stream of
    the bytes of ``bound_ms``."""
    src = torch.empty(int(nbytes) // 8, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    return cuda_ms(lambda: dst.copy_(src), 50)


def compare_forms(mname, grid, cfgs, stats):
    """Phase 2 on one mask: every kernel form against the plain version,
    and guarded against unguarded. ``stats``: form name -> max abs err."""
    from ocean_model_arch_torch.model.fused import FusedSWModel
    from ocean_model_arch_torch.model.init import init_ocean_state
    from ocean_model_arch_torch.ops.fused_step import (
        fused_sw_step, fused_sw_step_blockmax, fused_sw_step_reference)

    carried = {}
    for n_tr, cfg in cfgs.items():
        state = init_ocean_state(grid, cfg)
        for guard in (False, True):
            fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True,
                              steps_per_call=2, tile_guard=guard)
            args = model_args(fm, cfg)
            land = land_masks(fm, grid, n_tr)
            s0 = fm.pack(state)
            form = ("fused_sw_step_tracers" if n_tr else
                    "fused_sw_step_guarded" if guard else "fused_sw_step")
            tag = f"{mname} T={n_tr} guard={'on' if guard else 'off'}"
            if guard:
                tx, ty = fm.tile
                dry = (fm.tile_wet == 0).repeat_interleave(tx, 0) \
                    .repeat_interleave(ty, 1)[:fm.lay.Xs, :fm.lay.Ys]

            def compare(what, ks, rs, tol):
                errs = [rel_err(k, r) for k, r in zip(ks, rs)]
                check(max(errs) < tol, f"{tag} {what}: kernel vs plain "
                      f"rel errors {errs} exceed {tol}")
                for k, lm in zip(ks, land):
                    check(bool((k[lm] == 0).all()), f"{tag} {what}: a "
                          "land cell of the kernel's output is not 0")
                    if guard:
                        check(bool((k[dry] == 0).all()), f"{tag} {what}: "
                              "an all-land tile is not exactly 0")
                stats[form] = max([stats.get(form, 0.0)] + [
                    float((k - r).abs().max()) for k, r in zip(ks, rs)])
                return errs

            for f, lm in zip(s0, land):
                check(bool((f[lm] == 0).all()),
                      f"{tag}: a land cell of the packed state is not 0")
            k1, bmx = fused_sw_step_blockmax(s0, *args)
            r1, rmx = fused_sw_step_reference(s0, *args)
            e1 = compare("1 launch", k1, r1, TOL_ONE)
            kmx = torch.amax(bmx)
            check(abs(float(kmx) - float(rmx)) <= TOL_ONE * float(rmx),
                  f"{tag}: guard max {float(kmx)} vs plain {float(rmx)}")
            if guard:
                check(bool((bmx[fm.tile_wet == 0] == 0).all()),
                      f"{tag}: the block max of an all-land tile is not 0")
            ks, rs = s0, s0
            for _ in range(N_CARRY):
                ks, _ = fused_sw_step(ks, *args)
                rs, _ = fused_sw_step_reference(rs, *args)
            eN = compare(f"{N_CARRY} launches", ks, rs, TOL_CARRY)
            # one launch from the evolved state (advection, Coriolis live)
            k2, _ = fused_sw_step(rs, *args)
            r2, _ = fused_sw_step_reference(rs, *args)
            e2 = compare(f"1 launch after {N_CARRY}", k2, r2, TOL_ONE)
            carried[(n_tr, guard)] = (k1, ks)
            torch.cuda.synchronize()
            print(f"phase 2 kernel vs plain ({tag}, {fm.lay.Xs}x"
                  f"{fm.lay.Ys} layout, {fm.tile[0]}x{fm.tile[1]} tiles: "
                  f"{fm.n_tiles[0]} wet, {fm.n_tiles[1]} land): rel err "
                  f"per field 1 launch {fmt(e1)} < {TOL_ONE}; {N_CARRY} "
                  f"launches {fmt(eN)} < {TOL_CARRY}; 1 launch from step "
                  f"{N_CARRY} {fmt(e2)} < {TOL_ONE}; land exactly 0: yes"
                  + ("; all-land tiles and their block max exactly 0: yes"
                     if guard else ""))
        for which, what in ((0, "1 launch"), (1, f"{N_CARRY} launches")):
            off, on = carried[(n_tr, False)][which], \
                carried[(n_tr, True)][which]
            check(all(torch.equal(a, b) for a, b in zip(off, on)),
                  f"{mname} T={n_tr}: guarded and unguarded kernel outputs "
                  f"differ after {what}")
        print(f"phase 2 guard on vs off ({mname} T={n_tr}): kernel outputs "
              f"bit-identical after 1 and {N_CARRY} launches")


def tracer_mass(state, grid) -> list:
    """sum(ff * hhq * dx * dy) over wet cells, per tracer, in float64."""
    w = (grid.lu > 0.5).double() * grid.dx.double() * grid.dy.double()
    return [float((state.ff[t].double() * state.hhq.double() * w).sum())
            for t in range(state.ff.shape[0])]


def drive_path(tag, grid, cfg, tile_guard):
    """One path end to end: init -> FusedSWModel -> pack -> run_steps ->
    unpack for N_MAIN steps, against the eager composition. The launch
    counts are zeroed just before ``run_steps`` and read just after; the
    path's kernel instantiation (its tracer count, guarded or not) must
    have launched once per step and no other at all. Returns (model,
    state, packed initial fields, launches of that instantiation)."""
    from ocean_model_arch_torch.model.fused import FusedSWModel
    from ocean_model_arch_torch.model.init import init_ocean_state
    from ocean_model_arch_torch.model.step import make_step, run_steps
    from ocean_model_arch_torch.ops.fused_step import (fused_sw_step,
                                                       reset_launch_counts)

    n_tr = cfg.sw.tracer_num if cfg.sw.use_tracers > 0 else 0
    state = init_ocean_state(grid, cfg)
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True, steps_per_call=2,
                      tile_guard=tile_guard)
    s0 = fm.pack(state)
    reset_launch_counts()
    s, ok = fm.run_steps(s0, N_MAIN)
    launches = fused_sw_step.launches
    counts = dict(fused_sw_step.form_launches)
    out = fm.unpack(s, state)
    check(ok, f"{tag}: the stability guard tripped")
    check(launches == N_MAIN, f"{tag}: {launches} kernel launches for "
          f"{N_MAIN} steps")
    check(counts == {(n_tr, fm.tile_guard): N_MAIN}, f"{tag}: launches per "
          f"(tracers, guarded) {counts}, expected {N_MAIN} of "
          f"{(n_tr, fm.tile_guard)}")
    ref, eok = run_steps(make_step(grid, cfg), state, 1.0, N_MAIN)
    check(eok, f"{tag}: the eager composition's guard tripped")
    errs = {}
    for n in ("ssh", "ubrtr", "vbrtr"):
        a, b = getattr(out, n), getattr(ref, n)
        check(tuple(a.shape) == (grid.nx, grid.ny), f"{tag}: {n} shape")
        errs[n] = rel_err(a, b)
    for t in range(n_tr):
        check(tuple(out.ff.shape) == (n_tr, grid.nx, grid.ny),
              f"{tag}: ff shape")
        errs[f"ff[{t}]"] = rel_err(out.ff[t], ref.ff[t])
    check(max(errs.values()) < TOL_EAGER,
          f"{tag} vs eager composition: rel errors {errs}")
    line = (f"{tag}: {N_MAIN} steps ok={ok} launches={launches} "
            f"(guard {'on' if fm.tile_guard else 'off'}, tiles "
            f"{fm.n_tiles[0]} wet / {fm.n_tiles[1]} land); vs eager "
            "composition rel err "
            + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
            + f" < {TOL_EAGER}; max|ssh| {float(out.ssh.abs().max()):.6e}")
    if n_tr:
        m0, m1 = tracer_mass(state, grid), tracer_mass(out, grid)
        line += ("; tracer mass sum(ff*hhq*dx*dy) before "
                 + fmt(m0) + " after " + fmt(m1) + " (kernel path), "
                 + fmt(tracer_mass(ref, grid)) + " (eager)")
    print(line)
    return fm, state, s0, counts[n_tr, fm.tile_guard]


def guard_trips(fm, s0, cell, where: str) -> None:
    """``ok`` must turn False on a NaN ssh and on an sshp spike at
    ``cell`` (layout indices)."""
    for what, field, val in (("ssh = NaN", 0, float("nan")),
                             ("sshp = 2e4", 1, 2.0e4)):
        bad = tuple(f.clone() for f in s0)
        bad[field][cell] = val
        _, gok = fm.run_steps(bad, 2)
        check(not gok, f"guard ({where}): ok stayed True with {what}")


def time_path(fm, cfg, s0, wet_pts: int, pts: int) -> dict:
    """ms/step of the kernel path (``run_steps``, host loop included; the
    median of three windows of N_TIME steps, with the least and the most),
    and from a profiled window of the same loop the kernel's device time
    per launch and the device time of the whole step (kernel, block-max
    reduction, guard accumulation): what the card is busy for."""
    from ocean_model_arch_torch.ops.fused_step import fused_sw_step
    lo, ms_path, hi = sorted(
        cuda_ms(lambda: fm.run_steps(s0, N_TIME), 1) / N_TIME
        for _ in range(3))
    ms_kernel, ms_window = profile_device_ms(
        lambda: fm.run_steps(s0, N_TIME), "fused_sw_step_kernel")
    if ms_kernel is None:
        args = model_args(fm, cfg)
        ms_kernel = cuda_ms(lambda: fused_sw_step(s0, *args), N_TIME)
        busy = f"kernel {ms_kernel:.4f} ms/launch (CUDA events over calls)"
    else:
        ms_dev = ms_window / N_TIME
        busy = (f"kernel {ms_kernel:.4f} ms/launch, device busy "
                f"{ms_dev:.4f} ms/step (torch.profiler over one window), "
                f"device idle {max(0.0, 1 - ms_dev / ms_path):.0%}")
    return {"ms_path": ms_path, "ms_kernel": ms_kernel,
            "text": (f"{ms_path:.4f} ms/step (windows {lo:.4f}-{hi:.4f}; "
                     f"{pts / ms_path * 1e3:.4e} points/s, "
                     f"{wet_pts / ms_path * 1e3:.4e} wet points/s), {busy}, "
                     f"tiles {fm.n_tiles[0]} wet / {fm.n_tiles[1]} land")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "smoke run needs a CUDA device", file=sys.stderr)
        return 1

    from ocean_model_arch_torch.core.grid import build_grid
    from ocean_model_arch_torch.host import (ModelConfig, Precision,
                                             SWConfig, basinpar_as250m_test,
                                             frame_of_land_mask, read_mask)
    from ocean_model_arch_torch.model.fused import FusedSWModel
    from ocean_model_arch_torch.model.init import init_ocean_state
    from ocean_model_arch_torch.model.step import make_step
    from ocean_model_arch_torch.ops import _build
    from ocean_model_arch_torch.ops.fused_step import (
        fused_sw_step, fused_sw_step_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: device and kernel build ------------------------------
    name = torch.cuda.get_device_name(0)
    card = gpu_line()
    nvcc_ver = subprocess.run([_build.nvcc(), "--version"],
                              capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    so = _build.build("fused_step")
    build_s = time.perf_counter() - t0
    log = _build.BUILDS.get("fused_step", {}).get("log", "")
    print(card)
    print(f"phase 1 device: {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {nvcc_ver}; kernel build "
          f"{build_s:.2f} s -> {os.path.relpath(so, REPO)}; ptxas "
          f"<tracers,guard>: {ptxas_summary(log)}")

    basin = basinpar_as250m_test()
    prec = Precision.f32()
    pts = basin.nx * basin.ny
    cfgs = {0: ModelConfig(basin=basin, sw=SWConfig(use_tracers=0),
                           precision=prec),
            N_TRACERS: ModelConfig(
                basin=basin, sw=SWConfig(use_tracers=1,
                                         tracer_num=N_TRACERS),
                precision=prec)}
    masks = {
        "frame": frame_of_land_mask(basin.nx, basin.ny),
        "azov": read_mask(os.path.join(REPO, "data", "AS",
                                       "maskAzovCor.txt"),
                          basin.nx, basin.ny),
    }
    # no device argument: the entry points place their tensors on the card
    grids = {m: build_grid(basin, mask, precision=prec)
             for m, mask in masks.items()}
    check(all(g.lu.is_cuda for g in grids.values()),
          "build_grid without a device did not use the card")
    dev = grids["frame"].lu.device
    wet = {m: int((g.lu > 0.5).sum()) for m, g in grids.items()}

    # ---- phase 2: every kernel form vs its plain version ---------------
    max_abs: dict = {}
    for mname, grid in grids.items():
        compare_forms(mname, grid, cfgs, max_abs)
    # the 1-tracer instantiation, which no path below launches
    compare_forms("azov", grids["azov"], {1: ModelConfig(
        basin=basin, sw=SWConfig(use_tracers=1, tracer_num=1),
        precision=prec)}, max_abs)

    # ---- phase 3: the first main path (frame, no tracers, unguarded) ---
    launches = {}
    fm, state, s0, launches["fused_sw_step"] = drive_path(
        "phase 3 main path (frame mask, no tracers)", grids["frame"],
        cfgs[0], False)
    lay = fm.lay
    t_frame = time_path(fm, cfgs[0], s0, wet["frame"], pts)
    args = model_args(fm, cfgs[0])
    ms_wrapper = cuda_ms(lambda: fused_sw_step(s0, *args), N_TIME)
    plain_ms = {"fused_sw_step": cuda_ms(
        lambda: fused_sw_step_reference(s0, *args), 20)}
    step = make_step(grids["frame"], cfgs[0])
    ms_eager = cuda_ms(lambda: step(state, 1.0), 20)
    kernels = {"fused_sw_step": (fm, 0, t_frame)}
    print(f"phase 3 timing ({name}; {card}): kernel path "
          f"{t_frame['text']}; wrapper call {ms_wrapper:.4f} ms; plain "
          f"fused version {plain_ms['fused_sw_step']:.4f} ms/step; eager "
          f"composition {ms_eager:.4f} ms/step "
          f"({pts / ms_eager * 1e3:.4e} points/s)")

    # ---- phase 4: the guard --------------------------------------------
    mid = (lay.margin + basin.nx // 2, lay.margin + basin.ny // 2)
    guard_trips(fm, s0, mid, "frame mask")

    # ---- phase 5: the second main path and its sub-paths ---------------
    # each entry of the kernels line takes its launches from the path that
    # runs the instantiation its times describe: <2 tracers, guarded> on
    # the main path, <0, guarded> on the coastline sub-path
    fm_t, state_t, s0_t, launches["fused_sw_step_tracers"] = drive_path(
        f"phase 5 main path (azov coastline, {N_TRACERS} tracers)",
        grids["azov"], cfgs[N_TRACERS], None)
    fm_c, _, s0_c, launches["fused_sw_step_guarded"] = drive_path(
        "phase 5 sub-path (azov coastline, no tracers)", grids["azov"],
        cfgs[0], None)
    check(fm_t.tile_guard and fm_c.tile_guard,
          "the coastline did not turn the tile guard on")
    _, _, s0_f, _ = drive_path(
        f"phase 5 sub-path (frame mask, {N_TRACERS} tracers)",
        grids["frame"], cfgs[N_TRACERS], None)

    def model(mname, cfg, guard):
        return FusedSWModel(grids[mname], cfg, 1.0, static_rslu=True,
                            steps_per_call=2, tile_guard=guard)

    cfg1 = ModelConfig(basin=basin, sw=SWConfig(use_tracers=1, tracer_num=1),
                       precision=prec)
    fm_f1 = model("frame", cfg1, False)
    s0_f1 = fm_f1.pack(init_ocean_state(grids["frame"], cfg1))
    t_tr = time_path(fm_t, cfgs[N_TRACERS], s0_t, wet["azov"], pts)
    t_fu = time_path(model("frame", cfgs[N_TRACERS], False),
                     cfgs[N_TRACERS], s0_f, wet["frame"], pts)
    t_f1 = time_path(fm_f1, cfg1, s0_f1, wet["frame"], pts)
    t_on = time_path(fm_c, cfgs[0], s0_c, wet["azov"], pts)
    t_off = time_path(model("azov", cfgs[0], False), cfgs[0], s0_c,
                      wet["azov"], pts)
    # what FusedSWModel's default gives on the frame mask: the guard on
    t_auto = time_path(model("frame", cfgs[0], None), cfgs[0], s0,
                       wet["frame"], pts)
    kernels["fused_sw_step_guarded"] = (fm_c, 0, t_on)
    kernels["fused_sw_step_tracers"] = (fm_t, N_TRACERS, t_tr)
    plain_ms["fused_sw_step_guarded"] = cuda_ms(
        lambda: fused_sw_step_reference(s0_c, *model_args(fm_c, cfgs[0])),
        20)
    plain_ms["fused_sw_step_tracers"] = cuda_ms(
        lambda: fused_sw_step_reference(
            s0_t, *model_args(fm_t, cfgs[N_TRACERS])), 20)
    step_t = make_step(grids["azov"], cfgs[N_TRACERS])
    ms_eager_t = cuda_ms(lambda: step_t(state_t, 1.0), 20)
    print(f"phase 5 timing ({name}; {card}), wet points frame "
          f"{wet['frame']} azov {wet['azov']} of {pts}: "
          f"frame/no tracers/guard off {t_frame['text']} | "
          f"frame/no tracers/guard auto (on) {t_auto['text']} | "
          f"azov/no tracers/guard on {t_on['text']} | "
          f"azov/no tracers/guard off {t_off['text']} | "
          f"azov/{N_TRACERS} tracers/guard on {t_tr['text']} | "
          f"frame/{N_TRACERS} tracers/guard off {t_fu['text']} | "
          f"frame/1 tracer/guard off {t_f1['text']}; plain fused "
          f"version {plain_ms['fused_sw_step_tracers']:.4f} ms/step, eager "
          f"composition with tracers {ms_eager_t:.4f} ms/step")

    # the guard at a wet cell of the coastline, tracers carried
    lu = grids["azov"].lu
    ij = torch.nonzero(lu > 0.5).double()
    centre = torch.tensor([basin.nx / 2, basin.ny / 2], dtype=ij.dtype,
                          device=ij.device)
    i, j = (int(v) for v in
            ij[((ij - centre) ** 2).sum(1).argmin()].tolist())
    check(bool(lu[i, j] > 0.5), "the injection cell is not wet")
    guard_trips(fm_t, s0_t, (lay.margin + i, lay.margin + j),
                "azov coastline with tracers")
    print("phase 4 guard: ok=False on an injected NaN ssh and on an sshp "
          "spike of 2e4 (|ssh| > 1e4 at the next step), on the frame mask "
          f"and at wet cell ({i}, {j}) of the azov coastline with "
          f"{N_TRACERS} tracers carried")

    entries, floors = [], []
    for form, (m, n_tr, t) in kernels.items():
        b_ms, b_by, nbytes = bound_ms(m, n_tr)
        floors.append(f"{form} {nbytes / 1e6:.1f} MB, bound {b_ms:.4f} ms "
                      f"({b_by}), copy_ of as many bytes "
                      f"{copy_floor_ms(nbytes, dev):.4f} ms")
        check(launches[form] > 0, f"{form} was never launched on its path")
        entries.append({
            "name": form, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[form], "launches": launches[form],
            "max_abs_err": max_abs[form], "ms": t["ms_kernel"],
            "plain_ms": plain_ms[form], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None})
    print(f"bounds ({card}): " + "; ".join(floors))
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
