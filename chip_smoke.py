#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port's main path -- the Azov 1525x1115 configuration
(``basinpar_as250m_test``: 2-cell land frame, flat 100 m bathymetry,
gaussian SSH bump, f32, no tracers) through ``build_grid`` ->
``init_ocean_state`` -> ``FusedSWModel(static_rslu=True,
steps_per_call=2)`` -> ``run_steps`` -> ``unpack`` -- in phases:

1. device: the card, its power limit, the toolchain, the kernel build;
2. the fused-step CUDA kernel against its plain PyTorch version on the
   card, on the frame mask and the shipped Azov coastline: one launch
   (tolerance 1e-5) and 50 carried launches (1e-4), land exactly 0;
3. the main path for 200 steps: ``ok``, one kernel launch per step, and
   agreement with the eager composition at the golden f32 tolerance;
   ms/step of the kernel path, the plain fused version and the eager
   composition, timed with CUDA events after a warm-up;
4. the stability guard trips on NaN and on |ssh| > 1e4.

Every phase prints one line; any failure raises (exit code != 0). The
last line is ``{"ok": true, "device": {...}}``. Needs a CUDA device and
nvcc; there is no CPU path.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
N_MAIN = 200            # main-path steps (phase 3)
N_CARRY = 50            # carried launches in the kernel comparison
TOL_ONE, TOL_CARRY = 1e-5, 1e-4
TOL_EAGER = 3e-4        # golden_bs100 f32 tolerance (tests/test_golden.py)


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


def kernel_device_ms(fn, n: int, kernel: str):
    """Mean device time in ms of the CUDA kernel named ``kernel`` over
    ``n`` calls of ``fn``, from torch.profiler; None if the profiler
    records no device time for it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if kernel in e.key and e.count and e.self_device_time_total > 0:
            return e.self_device_time_total / e.count / 1e3
    return None


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
    from ocean_model_arch_torch.model.step import make_step, run_steps
    from ocean_model_arch_torch.ops import _build
    from ocean_model_arch_torch.ops import fused_layout as fl
    from ocean_model_arch_torch.ops.fused_step import (
        fused_sw_step, fused_sw_step_reference)

    dev = torch.device("cuda", 0)
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
    log = _build.BUILDS.get("fused_step", {}).get("log", "(cached build)")
    ptxas = " | ".join(ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln)
    print(card)
    print(f"phase 1 device: {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {nvcc_ver}; kernel build "
          f"{build_s:.2f} s -> {os.path.relpath(so, REPO)}; ptxas: {ptxas}")

    basin = basinpar_as250m_test()
    prec = Precision.f32()
    cfg = ModelConfig(basin=basin, sw=SWConfig(use_tracers=0),
                      precision=prec)
    masks = {
        "frame": frame_of_land_mask(basin.nx, basin.ny),
        "azov": read_mask(os.path.join(REPO, "data", "AS",
                                       "maskAzovCor.txt"),
                          basin.nx, basin.ny),
    }

    # ---- phase 2: kernel vs plain version on the card ------------------
    max_abs = 0.0
    for mname, mask in masks.items():
        grid = build_grid(basin, mask, precision=prec, device=dev)
        state = init_ocean_state(grid, cfg)
        fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True,
                          steps_per_call=2)
        lay = fm.lay
        args = (fm.met, fm.planes, lay, fm.tau, cfg.sw.time_smooth,
                fm.hr_const)
        lu_s = np.asarray(fl.embed(lay, grid.lu.cpu()))
        wlcu, wlcv, wlu = (torch.from_numpy(m).to(dev) < 0.5
                           for m in fl.staggered_wet_masks(lu_s))
        land = (wlu, wlu, wlcu, wlcu, wlcv, wlcv)
        s0 = fm.pack(state)

        def compare(tag, ks, rs, tol):
            nonlocal max_abs
            errs = [rel_err(k, r) for k, r in zip(ks, rs)]
            check(max(errs) < tol, f"{mname} {tag}: kernel vs plain rel "
                  f"errors {errs} exceed {tol}")
            for k, lm in zip(ks, land):
                check(bool((k[lm] == 0).all()), f"{mname} {tag}: a land "
                      "cell of the kernel's output is not exactly 0")
            return errs

        k1, kmx = fused_sw_step(s0, *args)
        r1, rmx = fused_sw_step_reference(s0, *args)
        e1 = compare("1 launch", k1, r1, TOL_ONE)
        max_abs = max([max_abs] + [float((k - r).abs().max())
                                   for k, r in zip(k1, r1)])
        check(abs(float(kmx) - float(rmx)) <= TOL_ONE * float(rmx),
              f"{mname}: guard max {float(kmx)} vs plain {float(rmx)}")
        ks, rs = s0, s0
        for _ in range(N_CARRY):
            ks, _ = fused_sw_step(ks, *args)
            rs, _ = fused_sw_step_reference(rs, *args)
        eN = compare(f"{N_CARRY} launches", ks, rs, TOL_CARRY)
        # one launch from the evolved state (advection and Coriolis live)
        k2, _ = fused_sw_step(rs, *args)
        r2, _ = fused_sw_step_reference(rs, *args)
        e2 = compare(f"1 launch after {N_CARRY}", k2, r2, TOL_ONE)
        max_abs = max([max_abs] + [float((k - r).abs().max())
                                   for k, r in zip(k2, r2)])
        torch.cuda.synchronize()
        fmt = lambda es: "[" + ", ".join(f"{e:.2e}" for e in es) + "]"
        print(f"phase 2 kernel vs plain ({mname} mask, {lay.Xs}x{lay.Ys} "
              f"layout): rel err per field (ssh sshp u up v vp) 1 launch "
              f"{fmt(e1)} < {TOL_ONE}; {N_CARRY} launches {fmt(eN)} < "
              f"{TOL_CARRY}; 1 launch from step {N_CARRY} {fmt(e2)} < "
              f"{TOL_ONE}; land exactly 0: yes")
        del grid, state, fm, s0, ks, rs, k1, r1, k2, r2

    # ---- phase 3: the main path ----------------------------------------
    grid = build_grid(basin, masks["frame"], precision=prec, device=dev)
    state = init_ocean_state(grid, cfg)
    fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True, steps_per_call=2)
    s6 = fm.pack(state)
    fused_sw_step.launches = 0
    s6, ok = fm.run_steps(s6, N_MAIN)
    launches = fused_sw_step.launches
    out = fm.unpack(s6, state)
    check(ok, "main path: the stability guard tripped")
    check(launches == N_MAIN, f"main path: {launches} kernel launches "
          f"for {N_MAIN} steps")
    step = make_step(grid, cfg)
    ref, eok = run_steps(step, state, 1.0, N_MAIN)
    check(eok, "eager composition: the stability guard tripped")
    errs = {}
    for n in ("ssh", "ubrtr", "vbrtr"):
        a, b = getattr(out, n), getattr(ref, n)
        check(tuple(a.shape) == (basin.nx, basin.ny), f"{n} shape")
        errs[n] = rel_err(a, b)
    check(max(errs.values()) < TOL_EAGER,
          f"main path vs eager composition: rel errors {errs}")
    print(f"phase 3 main path: {N_MAIN} steps ok={ok} launches={launches}; "
          "vs eager composition rel err "
          + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
          + f" < {TOL_EAGER}; max|ssh| {float(out.ssh.abs().max()):.6e}")

    pts = basin.nx * basin.ny
    lay = fm.lay
    args = (fm.met, fm.planes, lay, fm.tau, cfg.sw.time_smooth, fm.hr_const)
    s0 = fm.pack(state)
    n_t = 200
    ms_path = cuda_ms(lambda: fm.run_steps(s0, n_t), 1) / n_t
    ms_wrapper = cuda_ms(lambda: fused_sw_step(s0, *args), n_t)
    ms_kernel = kernel_device_ms(lambda: fused_sw_step(s0, *args), n_t,
                                 "fused_sw_step_kernel")
    kernel_src = "torch.profiler device time"
    if ms_kernel is None:
        ms_kernel, kernel_src = ms_wrapper, "CUDA events over wrapper calls"
    ms_plain = cuda_ms(lambda: fused_sw_step_reference(s0, *args), 20)
    ms_eager = cuda_ms(lambda: step(state, 1.0), 20)
    print(f"phase 3 timing ({name}; {card}): kernel path "
          f"{ms_path:.4f} ms/step ({pts / ms_path * 1e3:.4e} points/s); "
          f"kernel {ms_kernel:.4f} ms/launch ({kernel_src}); wrapper call "
          f"{ms_wrapper:.4f} ms; plain fused version {ms_plain:.4f} ms/step "
          f"({pts / ms_plain * 1e3:.4e} points/s); eager composition "
          f"{ms_eager:.4f} ms/step ({pts / ms_eager * 1e3:.4e} points/s)")

    # ---- phase 4: the guard --------------------------------------------
    mid = (lay.margin + basin.nx // 2, lay.margin + basin.ny // 2)
    for what, field, val in (("ssh = NaN", 0, float("nan")),
                             ("sshp = 2e4", 1, 2.0e4)):
        bad = tuple(f.clone() for f in s0)
        bad[field][mid] = val
        _, gok = fm.run_steps(bad, 2)
        check(not gok, f"guard: ok stayed True with {what}")
    print("phase 4 guard: ok=False on an injected NaN ssh and on an "
          "sshp spike of 2e4 (|ssh| > 1e4 at the next step)")

    print(json.dumps({"kernels": [{
        "name": "fused_sw_step", "route": "cuda",
        "source": "ocean_model_arch_torch/ops/csrc/fused_step.cu",
        "replaces": "ocean_model_arch_tpu/ops/pallas/fused_step.py:1642",
        "launches": launches, "max_abs_err": max_abs,
        "ms": ms_kernel, "plain_ms": ms_plain}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
