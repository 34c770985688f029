#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port's paths at the Azov 250 m extents 1525 x 1115
(``basinpar_as250m_test``: flat 100 m bathymetry, gaussian SSH bump,
f32; on its spherical grid and, with ``curve_grid=2``, on the bipolar
grid whose metrics vary along x) through ``build_grid`` ->
``init_ocean_state`` -> ``FusedSWModel(static_rslu=True,
steps_per_call=1)`` (one step a launch, phases 2-10) or ``steps_per_call
=2`` (two chained steps a launch, as the JAX ``OceanModel`` runs even
windows: phase 11, and ``main`` in phases 9b and 10c), the fast form
without its folds (``elide_sel=q4=share_prev=False``) in those phases,
with them, as the drivers default them, in phase 15 and through the
entry points (``main`` in phases 9b, 10c and 12c; ``OceanModel`` in
9c), or the general
form, ``FusedSWModel(grid, cfg, tau)`` with the JAX defaults (phase 13),
or the persistent step, ``FusedSWModel(persistent=True)``, a whole
window in one launch (phase 14) -> ``pack`` -> ``run_steps`` ->
``unpack``, in phases:

1. device: the card, its power limit, the toolchain, the build of the
   kernel libraries (the fused step's forms with 0, 1 and 2 tracers and
   with any count from 3 up, raw or not, with and without momentum
   advection, with a full or a linear free surface, one step or two
   chained a launch; the general form's, every advection and free-surface
   form in one library of each tracer count, raw or not and steps a
   launch; the persistent form's, fast and general, one library of each
   tracer count; the copy step and the persistent walk: 90 libraries
   started together) with ptxas's registers and spills, which must stay
   at 42 registers (64, the chained forms' launch bound) and 0 bytes; the
   persistent libraries' non-coherent loads (none may be); the chained
   form's shared memory at 3-10 tracers; the op-cost probes' three
   libraries (K = 16, 48, 64); the fast form's 96 fold libraries
   (``fold_targets``) start building right after, in the background at a
   lower priority, while phases 2-14 run on the card;
2. every form of the fused-step CUDA kernel (no tracers / 2 tracers,
   unguarded / tile guard, profile / plane metrics) against its plain
   PyTorch version on the card, on the 2-cell land frame mask, the
   shipped Azov coastline and the coastline on the bipolar grid: one
   launch (tolerance 1e-5), 50 carried launches (1e-4), land exactly 0
   in all 6 + 2 T fields, all-land tiles exactly 0 with a block max of
   0, guarded and unguarded outputs bit-identical; the 1-tracer
   instantiation likewise on the coastline; the plane-metric kernel,
   fed the profile rows repeated along x, against the profile kernel
   bit for bit; then the same checks on the forms with lateral
   viscosity (mu = 1000), with varying bathymetry (15-100 m) and with
   both, and on the tracers' diffusive fluxes alone;
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
   of seven configurations of the kernel path;
6. the third main path (``bipolar_azov``: the coastline on the bipolar
   grid, metric planes, tile guard) for 200 steps, checked like phase 3,
   and its two sub-paths (the same with 2 tracers; ``bipolar``, the
   289 x 163 frame-mask basin); their timing line; the stability guard
   at a wet cell of the bipolar coastline;
7. the copy step (the fused step's loads and stores without its
   arithmetic) against its plain version, exactly, on each form's own
   inputs; then us/launch of every form through the probe script
   ``scripts/roofline_probe_torch.py``, and each timed configuration's
   byte bound beside the copy step of its form; the stacked copy step
   (one stacked input, one stacked output) exactly against its plain
   version and timed against the separate one;
8. (printed before phase 7) the fourth main path ``azov_visc``: the
   coastline over varying bathymetry with lateral viscosity (the shipped
   ``lvisc_2 = 1000``) and 2 diffusing tracers, 200 steps, checked like
   phase 5 against the eager composition with the same mu and
   bathymetry; its sub-paths (a) viscosity alone on flat bathymetry, (b)
   bathymetry alone, (c) both on the bipolar grid's plane metrics; what
   the viscosity did to max |u|; the stability guard at a wet cell;
   their timing line;
9. the model's own entry point and the raw (margined-shard) form of the
   kernel: (a) the raw form against its plain version on a shard of each
   path below, one launch and 50, with the output buffers' margins and
   pad untouched; (b) ``python -m ocean_model_arch_torch`` in-process
   (``main``) on a copy of ``examples/05_azov_hires`` in a temporary
   directory: 604 steps at 1525 x 1115 in windows of 60 on the fused CUDA
   kernel, 302 chained launches, a GrADS record per window, the final
   state and ``ssh.dat``'s last record against ``FusedSWModel(
   steps_per_call=2).run_steps`` by hand bit for bit,
   then the same run to half way with ``--checkpoint``, resumed, equal
   to the straight run bit for bit; (c) a zonal channel 1536 x 1115,
   periodic in x, 2 tracers, through ``OceanModel`` on
   ``FusedSharded2DModel(1, 1)`` for 200 steps against the eager
   composition, with a bump beside the seam that must cross it (and must
   not in the closed basin); (d) ``azov_visc`` and ``bipolar_azov`` cut
   into 2 x 2 shards on the one card, uniform and weighted cuts, 200
   steps, bit-identical to the single block on all 6 + 2 T fields, the
   guard tripping on a NaN in a shard's interior and not on one in its
   pad; their timing lines (kernel, strip copies, device busy, path);
10. (printed before phase 7) the forms without momentum advection
   (``trans_terms = 0``), with a linear free surface
   (``full_free_surface = 0``) and both: (a) every instantiation against
   the plain version as in phases 2 and 9a; (b) their main paths at
   1525 x 1115 (``azov_notrans``, ``bipolar_azov_notrans``,
   ``azov_linear`` and its viscous sub-path over the 15-100 m
   bathymetry), 200 steps each against the eager composition, and their
   timing line; (c) every shipped run directory ``examples/0*`` through
   ``main --f32`` on the fused CUDA kernel against the eager composition
   by hand (124 of their 604 steps: 62 chained launches each; the windows
   of 60, 60 and 4 keep the even last window), ``04_black_sea`` as shipped in
   f64 on the eager route, and ``01_flat_basin --mesh 2x2`` == its 1 x 1
   run bit for bit (its raw forms at two steps a launch and at one);
11. (printed before phase 7) two chained model steps a launch: (a)
   every chained instantiation of phases 2 and 10a against the plain
   version (one launch 1e-5, 25 carried launches of 2 steps 1e-4, land
   and all-land tiles 0, guarded == unguarded), and the chained raw
   forms on 2 x 2 shards; (b) the chained paths ``azov_mask``,
   ``azov_tracers``, ``bipolar_azov`` and ``azov_visc``, 200 steps in
   100 launches each against the eager composition, the guard on an
   sshp spike that only the first step of a launch holds above the
   bound, their timing beside the same form's single-step kernel, byte
   bound and the chained copy step; (c) ``azov_visc`` and
   ``bipolar_azov`` on 2 x 2 shards at two steps a launch (margins 8 and
   6), uniform and weighted cuts, == the chained single block bit for
   bit, 4 strip copies a step;
12. (printed before phase 7) any number of tracers, the kernel's
   run-time tracer family: (a) its forms at 3 and 4 tracers against the
   plain version as in phases 2, 9a and 11a (profile and plane metrics,
   guard off and on, viscosity and bathymetry planes, the diffusive
   fluxes alone, without advection, with a linear free surface, one step
   and two a launch, raw on 2 x 2 shards), and the chained form past its
   shared-memory fit (9 tracers; 8 viscous); (b) the Azov coastline with
   4 tracers, guarded, 200 steps chained and at one step a launch, its
   sub-paths (3 tracers; ``azov_visc`` with 4; ``bipolar_azov`` with 3)
   against the eager composition, the tracer mass before and after, and
   2 x 2 shards at 4 tracers == the chained block bit for bit; (c)
   ``examples/05_azov_hires`` with 4 tracers through ``main`` on the block
   and on a 2 x 2 mesh == the hand-driven chained run bit for bit; (d)
   T = 0..4 on the guarded coastline at one step and two a launch:
   kernel, byte bound, copy step of the form, path, idle; 9 tracers;
13. (printed before phase 7) the general form (the TPU kernel's non-fast
   branch: ``static_rslu=False``, the JAX default, or metric planes
   without ``fast2d``): (a) every one of its 704 instantiations against
   the plain version as in phases 2, 9a, 11a and 12a (profile and plane
   metrics, T = 0, 1, 2 and the run-time family, each mu mode, with and
   without advection, full and linear free surface, one step and two a
   launch, guard off and on, the single block and the raw form on 2 x 2
   shards), the static reciprocal planes == the selects bit for bit, and
   the chained family past its shared-memory fit; (b) its paths, 200
   steps each against the eager composition: ``azov_general``
   (``FusedSWModel(grid, cfg, tau)``), ``bipolar_azov_general`` (16
   metric planes) and its ``static_rslu=True, fast2d=False`` twin, bit
   for bit, ``azov_visc_general``, ``azov_general`` chained, and
   ``azov_visc_general`` on 2 x 2 shards == the single general block bit
   for bit; the guard on a NaN at a wet cell; (c) a timing line per path
   beside the fast form of the same configuration in the same run
   (kernel, byte bound, copy step of each form, path, idle);
14. (printed before phase 7) the persistent step (K2) and its probe (K5):
   (a) the persistent walk through ``scripts/persistent_probe_torch.py``
   at the TPU probe's 6 x 1552 x 1152 f32: its three forms (in place,
   ping-pong, one launch a step) bit for bit against each other and
   within one unit in the last place of the plain version (its float64
   ties named), timed at 64- and 256-row tiles, the barrier's cost, the
   grid, the L2 hit rate where ncu exists; (b) ``FusedSWModel(
   persistent=True)`` on six runs (``default``, ``azov_mask``,
   ``azov_tracers``, ``azov_general``, ``azov_tracers3``, ``azov_visc``):
   the kernel against the plain version after 1 and 50 steps (1e-5,
   1e-4), 200 steps in one launch of the run's own instantiation ==
   ``run_steps`` at one step a launch bit for bit, the guard on a NaN
   and an sshp spike; (c) each timed beside ``run_steps`` (guarded as the
   model defaults, and unguarded) and the chained form of the same run:
   kernel us a step, path, idle, the grid;
15. (printed before phase 7) K1's arithmetic folds as the drivers
   default them: (a) the fold libraries' registers (42 one step, 64
   chained, no spill); (b) six folded main paths (``azov_mask`` one
   step and chained, ``azov_tracers``, ``azov_tracers4`` (the run-time
   tracer count of phase 12c's entry point), ``bipolar_azov`` and
   ``azov_visc`` chained): 200 steps of their own folded instantiation
   only against the eager composition, the kernel against the plain
   version with the same folds after 1 and 50 launches (25 chained), the
   folded kernel against the unfolded one after 30 steps (1e-6 for
   elide_sel and q4; with share_prev 1e-4, and 1e-6 against share_prev
   alone), land exactly 0 in the velocity carriers and tracer levels,
   the guard; (c) the folded raw form of ``azov_visc`` on 2 x 2 shards
   against its plain version and == the folded block bit for bit, one
   step and two a launch, and of ``azov_tracers4`` chained likewise;
   (d) each folded kernel timed beside the
   unfolded one of the same configuration; (e) tests/test_fused.py's
   round-5 cases on the card (70 x 52 islands; also with 2 and 4
   tracers): elide_sel + q4 within 1e-6, share_prev within 1e-5;
16. (printed before phase 7) the op-cost probes K6 and K7: (a) every
   kind at both Ks of its probe against the plain version after 1 and 3
   carried calls (1e-6), the SASS instructions an iteration of each
   kind; (b) ``scripts/vpu_op_probe_torch.py`` and
   ``scripts/vpu_shift_probe_torch.py``'s timing at their own n (2000,
   500), each kind's launches counted;
17. (printed before phase 7) ``OceanModel`` on a 4 x 2 mesh off the fused
   path, and the dynamic load balance: (a) ``main`` on
   ``examples/05_azov_hires`` in f64 (the CLI's default) with ``--mesh
   4x2``, 20 steps on the eager sharded step (every shard of the padded
   1528 x 1116 domain stacked on the card, in lockstep; no fused
   launch), its cropped final state == the 1 x 1 eager f64 run bit for
   bit, ms/step of both; (b) the halo self-test on the padded extents
   (that run at parallel.par's debug level 2, and by hand, timed); (c)
   ``OceanModel.run`` in f32 on 4 x 2 with 3 balance rounds of 2 probe
   steps: the rounds' ratios and the selected cuts, K1b's launches (the
   probes' and the window's), the installed runner's 20 steps against
   the eager composition on one block (3e-4), K1b on those cuts against
   its plain version and timed beside uniform cuts;
18. (printed before phase 7) the mesh across processes on the card: (a)
   ``FusedSharded2DModel`` 2 x 1 in this process on the Azov coastline
   (f32, two steps a launch, the folds as the model defaults them), 40
   steps, K1b's launches counted, == the chained block bit for bit, K1b
   against its plain version; (b) the same over two processes of
   ``scripts/multiprocess_worker_torch.py azov_mask`` sharing the card
   (Gloo, each strip staged through pinned host buffers), a shard each:
   == (a) bit for bit, a NaN in rank 1's shard trips the guard on both
   ranks; (c) NCCL where the host has two cards, else a line saying it
   was not run, and what Gloo does with a CUDA tensor (and, on one card,
   NCCL with two processes on it: ``transport_probe``); (d) ``python -m
   ocean_model_arch_torch
   examples/05_azov_hires --mesh 2x1 --ckpt-format orbax`` in f64 over two
   processes: 10 steps straight, and 4 with a sharded checkpoint resumed
   to 10, == bit for bit, rank 0 printing the timer table reduced over
   both; its timing line: strip bytes a step, ms/step in one process and
   in two, K1b us a launch on each shard in one process and on each rank.

Every phase prints its lines; any failure raises (exit code != 0). The
line before the last is one JSON object describing the kernels: forty-
seven unfolded ones
(the fused step's plain, guarded, tracer, plane-metric, viscous,
bathymetry-plane, viscous + bathymetry + tracer and viscous plane-metric
forms, its raw form on the three paths of phase 9, the four forms of the
paths of phase 10b, the raw forms of ``01_flat_basin --mesh 2x2``, the
chained forms of phase 11's four paths and two 2 x 2 splits, the six
forms of phase 12b's paths, the six general forms of phase 13b's paths,
the copy step, the chained copy step and the stacked copy step, the
persistent step on phase 14's six runs and the walk's three forms, these
nine per model step), the folded instantiations launched on the entry
points' and phase 15's paths, the probes' 26 (K6: ten kinds at two
Ks; K7: three at two), K1b on phase 17's balanced cuts and on phase
18a's 2 x 1 shards;
the last line is ``{"ok": true, "device": {...}}``. With ``--parent
DIR`` (the root of another checkout of this repository) it instead holds
every one-step instantiation that checkout has against this one's, bit
for bit and in kernel time, and every instantiation's registers, and
stops; ``--parent DIR --bathymetry`` only the fast forms over bathymetry
planes and the main path's chained and folded ones. Needs a CUDA device and nvcc; there is no
CPU path.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import importlib.util
import inspect
import io
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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

MU = 1.0e3              # the shipped lvisc_2 (every sw.par)
MAX_REGS = 42           # above it only two 512-thread blocks fit an SM
# the fast form without its folds (elide_sel, q4, share_prev), which the
# drivers turn on by default: the phases that hold the unfolded
# instantiations build their models with it; the entry points (phases
# 9b, 9c, 10c, 12c) and phase 15 run the folded ones
UNFOLDED = {"elide_sel": False, "q4": False, "share_prev": False}
# the kernels' names in torch.profiler's events: unfolded, folded
FUSED_KERNELS = ("fused_sw_step_kernel", "fused_sw_fold_kernel")
# the copy step's forms (tracers, plane metrics, viscous, bathymetry
# planes) whose fused step keeps the threads' loader: phase 7 times the
# threads' copy step on these only
THREADS_FORMS = ((0, True, True, True),)

# H100 SXM data sheet: HBM bytes/s and f32 FLOP/s outside the tensor cores
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67e12
# an estimate of the f32 operations one step needs per computed layout
# cell: the step, each tracer, the viscosity
CELL_FLOPS, TRACER_FLOPS, VISC_FLOPS = 100, 25, 60

CSRC = "ocean_model_arch_torch/ops/csrc/"
PALLAS = "ocean_model_arch_tpu/ops/pallas/fused_step.py"
REPLACES = {"fused_sw_step": PALLAS + ":1642",
            "fused_sw_step_guarded": PALLAS + ":1106",
            "fused_sw_step_tracers": PALLAS + ":937",
            "fused_sw_step_fast2d": PALLAS + ":351",
            "fused_sw_step_visc": PALLAS + ":711",
            "fused_sw_step_bathy": PALLAS + ":467",
            "fused_sw_step_visc_bathy_tracers": PALLAS + ":967",
            "fused_sw_step_visc_bathy_fast2d": PALLAS + ":716",
            "fused_sw_step_raw_visc_bathy_tracers": PALLAS + ":1652",
            "fused_sw_step_raw_fast2d": PALLAS + ":1652",
            "fused_sw_step_notrans_guarded": PALLAS + ":798",
            "fused_sw_step_notrans_fast2d": PALLAS + ":798",
            "fused_sw_step_linear_tracers": PALLAS + ":954",
            "fused_sw_step_linear_visc_bathy_tracers": PALLAS + ":764",
            "fused_sw_step_chain_guarded": PALLAS + ":1061",
            "fused_sw_step_chain_tracers": PALLAS + ":1061",
            "fused_sw_step_chain_fast2d": PALLAS + ":1061",
            "fused_sw_step_chain_visc_bathy_tracers": PALLAS + ":1061",
            "fused_sw_step_raw_chain_visc_bathy_tracers": PALLAS + ":1061",
            "fused_sw_step_raw_chain_fast2d": PALLAS + ":1061",
            "fused_sw_step_raw_chain_notrans_guarded": PALLAS + ":1061",
            "fused_sw_step_tracers4": PALLAS + ":937",
            "fused_sw_step_chain_tracers4": PALLAS + ":937",
            "fused_sw_step_chain_tracers3": PALLAS + ":937",
            "fused_sw_step_chain_visc_bathy_tracers4": PALLAS + ":937",
            "fused_sw_step_chain_tracers3_fast2d": PALLAS + ":937",
            "fused_sw_step_raw_chain_tracers4": PALLAS + ":1652",
            "fused_sw_step_general_guarded": PALLAS + ":241",
            "fused_sw_step_general_planes": PALLAS + ":351",
            "fused_sw_step_general_planes_static": PALLAS + ":400",
            "fused_sw_step_general_visc_tracers": PALLAS + ":744",
            "fused_sw_step_general_chain_guarded": PALLAS + ":1061",
            "fused_sw_step_raw_general_visc_tracers": PALLAS + ":1667",
            "copy_step": "scripts/roofline_probe.py:71",
            "copy_step_chain": "scripts/roofline_probe.py:71",
            "copy_step_stacked": "scripts/roofline_probe.py:103"}


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


def profiled_kernels(fn) -> str:
    """The kernels torch.profiler records device time for in one call of
    ``fn`` (after a warm-up call), with their device us: what it saw."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    seen = [f"{e.key[:60]} {e.self_device_time_total:.0f} us"
            for e in prof.key_averages() if e.self_device_time_total > 0]
    return "; ".join(seen) or "nothing"


def ptxas_table(log: str) -> list:
    """(template arguments, registers, spill bytes) per kernel
    instantiation from nvcc's -Xptxas -v output."""
    out, name, spill = [], None, -1
    for ln in log.splitlines():
        m = re.search(r"_kernelI((?:L[bi]n?\d+E)+)E", ln)
        if m:
            name = "<" + ",".join(
                v.replace("n", "-") for v in
                re.findall(r"L[bi](n?\d+)E", m.group(1))) + ">"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def vpu_ptxas(log: str) -> list:
    """(kernel, registers, spill bytes) of the probe library's kernels
    from nvcc's -Xptxas -v output: the elementwise kinds by their names."""
    from ocean_model_arch_torch.ops.vpu_probe import KINDS
    out, name, spill = [], None, -1
    for ln in log.splitlines():
        m = re.search(r"entry function '\S*?(elem|bf16|rollx|rolly)_kernel"
                      r"(?:ILi(\d+)E)?", ln)
        if m:
            name = KINDS[int(m.group(2))] if m.group(2) else m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def ptxas_summary(table: list) -> str:
    """The table grouped: ``registers / spill bytes: instantiations``."""
    groups: dict = {}
    for name, regs, spill in table:
        groups.setdefault((regs, spill), []).append(name)
    return "; ".join(f"{r} regs {sp} B spill: " + " ".join(ns)
                     for (r, sp), ns in sorted(groups.items())) \
        or "(cached build)"


def nc_loads(targets) -> str:
    """The global loads of the libraries of ``targets`` in their SASS, and
    how many of them go through the non-coherent path (LDG .CONSTANT or
    .NC), which a block of a persistent launch must not use for what other
    blocks wrote before a grid barrier: "n of m", or why not known."""
    from ocean_model_arch_torch.ops import _build
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return "not measured (no cuobjdump)"
    ldg = nc = 0

    def sass(t):
        return subprocess.run([cuobjdump, "-sass", _build.build(t)],
                              capture_output=True, text=True,
                              check=True).stdout
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 8) as ex:
        listings = list(ex.map(sass, targets))
    for listing in listings:
        for ln in listing.splitlines():
            if re.search(r"\bLDG\b", ln):
                ldg += 1
                nc += "CONSTANT" in ln or ".NC" in ln
    check(nc == 0, f"{nc} non-coherent loads in the persistent libraries")
    return f"{nc} of {ldg}"


def general_loads_by_tma(target: str) -> bool:
    """Whether the general forms of a general library's ``target`` load by
    TMA (``general_geometry``): every form of a library is alike, all but
    the chained ones without tracers."""
    from ocean_model_arch_torch.ops.fused_step import general_geometry
    n_tr = int(re.search(r"NT=(\d)", target).group(1))
    return general_geometry(n_tr, 2 if "FUSED_STEPS=2" in target else 1).tma


def tma_loads(fast, other) -> str:
    """The TMA box loads (UTMALDG) in the SASS of each library: every one
    of ``fast`` (the fast forms', the copy step's, the persistent walk's
    and the general forms' that load by TMA) must have them, none of
    ``other`` (the general forms that keep the loads of threads); "n in m
    libraries", or why not known."""
    from ocean_model_arch_torch.ops import _build
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return "not measured (no cuobjdump)"

    def count(t):
        return subprocess.run([cuobjdump, "-sass", _build.build(t)],
                              capture_output=True, text=True,
                              check=True).stdout.count("UTMALDG")
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 8) as ex:
        n_fast = list(ex.map(count, fast))
        n_other = list(ex.map(count, other))
    check(all(n_fast) and not any(n_other), "UTMALDG missing from "
          f"{[t for t, n in zip(fast, n_fast) if not n]} or present in "
          f"{[t for t, n in zip(other, n_other) if n]}")
    return (f"{sum(n_fast)} in the {len(fast)} libraries of the fast form, "
            "the copy step, the persistent walk and the general forms by TMA "
            f"(each has them), {sum(n_other)} in the {len(other)} general "
            "ones that load by threads")


def persistent_grids() -> str:
    """Phase 1: each K2 instantiation's registers (ptxas) and co-resident
    grid (the occupancy query of ``persistent_grid``): blocks an SM, and
    the rounds a step of the walk over the 1533 x 1152 layout's tiles with
    the last round's fill; three blocks an SM for every one (the plans'
    promise)."""
    from ocean_model_arch_torch.ops import _build
    from ocean_model_arch_torch.ops import fused_layout as fl
    from ocean_model_arch_torch.ops.fused_step import (
        persist_targets, persistent_grid, persistent_rounds)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lay = fl.make_layout(1525, 1115)
    groups: dict = {}
    n = 0
    for t in persist_targets():
        general = "FUSED_GEN" in t
        for name, regs, spill in ptxas_table(
                _build.BUILDS.get(t, {}).get("log", "")):
            nt, mode, hrp, trans, ffs = (int(v) for v in name[1:-1].split(","))
            n_tr = 3 if nt < 0 else nt
            grid = persistent_grid(n_tr, None if hrp else 1.0,
                                   1.0 if mode else 0.0, mode == 2, trans,
                                   ffs, general)
            tiles, rounds, fill = persistent_rounds(lay, grid)
            check(grid == 3 * sms and spill == 0, f"persistent {name} "
                  f"({'general' if general else 'fast'}): grid {grid} on "
                  f"{sms} SMs, spill {spill} B")
            groups.setdefault((regs, grid // sms, rounds, round(fill, 3)),
                              []).append(("g" if general else "f") + name)
            n += 1
    return (f"{n} instantiations (f: fast, g: general <tracers,mu mode,"
            "bathymetry planes,advection,full free surface>) by registers, "
            "blocks an SM, rounds a step over the 96 x 36 tiles of 1533 x "
            "1152 and the last round's fill: " + "; ".join(
                f"{r} regs, {b} blocks an SM ({b * sms} co-resident), {k} "
                f"rounds, last {f:.0%} full: {len(ns)} (" + " ".join(ns) + ")"
                for (r, b, k, f), ns in sorted(groups.items()))
            if n else "(cached build)")


def sass_loops(so: str, kernel: str) -> list:
    """The loops of one kernel of the library ``so`` in its SASS
    (cuobjdump -sass; ``kernel``: a pattern of the mangled name): for each
    backward branch, (instructions in its body, global loads LDG, TMA box
    loads UTMALDG, shared stores STS), innermost first; [] without
    cuobjdump."""
    from ocean_model_arch_torch.ops import _build
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return []
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        if not re.search(kernel, part.split("\n", 1)[0]):
            continue
        ins = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", part)]
        out = []
        for addr, op in ins:
            m = re.search(r"\bBRA(?:\.U\.ANY)?\s+0x([0-9a-f]+)", op)
            if m and int(m.group(1), 16) < addr:
                body = [o for a, o in ins if int(m.group(1), 16) <= a <= addr]
                out.append((len(body),
                            sum(re.search(r"\bLDG\b", o) is not None
                                for o in body),
                            sum("UTMALDG" in o for o in body),
                            sum(re.search(r"\bSTS\b", o) is not None
                                for o in body)))
        return sorted(out)
    return []


def loader_sass(label: str, so: str, kernel: str) -> str:
    """The first loop that loads window cells (LDG and STS, or UTMALDG):
    its instructions a loaded cell, or the box loads a TMA issue."""
    for n, ldg, tma, sts in sass_loops(so, kernel):
        if tma:
            return f"{label}: {n} instructions a box issued by one thread"
        if ldg and sts:
            return (f"{label}: {n} instructions for {ldg} loaded cells "
                    f"({n / ldg:.1f} a cell)")
    return f"{label}: not measured"


def geometry_mirror() -> str:
    """Phase 1: ``ops/fused_step.py::window_geometry`` against the
    libraries' own getter (``fused_sw_step_geometry``) for every fast form
    (0-4 tracers, viscous or not, bathymetry planes or not, full or linear
    free surface, one step and two a launch), and the copy step's window
    (``copy_step_window``) against it."""
    import ctypes
    from ocean_model_arch_torch.ops import copy_step as cs
    from ocean_model_arch_torch.ops.fused_step import (
        _library, _persist_library, general_geometry, window_geometry)

    def held(lib, t, visc, hrp, ffs, g, what):
        out = (ctypes.c_longlong * 12)()
        lib.fused_sw_step_geometry(t, visc, hrp, ffs, out)
        want = (*g.tile, g.halo, g.rows, g.cols, g.plane, g.extra, g.blocks,
                g.smem, g.boxes, int(g.tma), g.carveout)
        check(tuple(out) == want, f"window geometry ({what} T={t}, visc="
              f"{visc}, hrp={hrp}, ffs={ffs}): the library's {tuple(out)}, "
              f"the mirror's {want}")
        check(not g.tma or ((g.cols * 4) % 16 == 0 and g.plane % 32 == 0),
              f"window geometry {want}: alignment")

    n = 0
    for steps in (1, 2):
        lib = _library(steps=steps)
        gen = _library(steps=steps, general=True)
        for t, visc, hrp, ffs in itertools.product(range(5), (0, 1), (0, 1),
                                                   (0, 1)):
            g = window_geometry(t, steps, bool(visc), bool(hrp), bool(ffs))
            held(lib, t, visc, hrp, ffs, g, f"fast, steps={steps}")
            check(g.blocks == (3 if steps == 1 else 2 if t == 0 and not visc
                               else 1), f"window geometry {g}: blocks an SM")
            held(gen, t, visc, hrp, ffs, general_geometry(t, steps,
                                                          bool(visc)),
                 f"general, steps={steps}")
            n += 2
    for t, visc, hrp, ffs in itertools.product(range(4), (0, 1), (0, 1),
                                               (0, 1)):
        held(_persist_library(t), t, visc, hrp, ffs, window_geometry(
            t, 1, bool(visc), bool(hrp), bool(ffs), persistent=True),
            "persistent fast")
        held(_persist_library(t, True), t, visc, hrp, ffs,
             general_geometry(t, 1, bool(visc)), "persistent general")
        n += 2
    gen_text = "; ".join(
        f"{'chained' if steps == 2 else 'one step'} T={t}"
        + " viscous" * visc + f": {'TMA' if g.tma else 'threads'}, "
        f"{g.blocks} blocks an SM, {g.smem / 1e3:.1f} KB, hr plane "
        f"{g.extra}, carveout {g.carveout} KB"
        for steps, t, visc in itertools.product((1, 2), (0, 1, 2, 3),
                                                (False, True))
        for g in [general_geometry(t, steps, visc)])
    for steps in (1, 2):
        for t in (0, 1):
            win = (ctypes.c_int * 3)()
            cs._library().copy_step_window(t, steps, win)
            g = window_geometry(t, steps)
            check(tuple(win) == (g.rows, g.cols, g.plane),
                  f"copy step window {tuple(win)} != {g[2:5]}")
    g1, g2 = window_geometry(0, 1), window_geometry(0, 2)
    return (f"window geometry of {n} fast, general and persistent forms == "
            "the mirror (ops/fused_step.py::window_geometry, "
            f"general_geometry); the general forms: {gen_text}; fast one "
            "step T=0: "
            f"{g1.rows} x {g1.cols} window, {g1.extra} planes of its own, "
            f"{g1.smem / 1e3:.1f} KB, {g1.blocks} blocks an SM, {g1.boxes} "
            f"boxes; chained T=0: {g2.rows} x {g2.cols}, {g2.extra}, "
            f"{g2.smem / 1e3:.1f} KB, {g2.blocks} blocks, {g2.boxes} boxes")


def fmt(es) -> str:
    return "[" + ", ".join(f"{e:.2e}" for e in es) + "]"


def model_args(fm, cfg):
    """The arguments of ``fused_sw_step`` after the fields, as the model
    passes them."""
    return (fm.met, fm.planes, fm.lay, fm.tau, cfg.sw.time_smooth,
            fm.hr_const, fm.tile_wet, fm.tile, fm.met_map, fm.mu_const,
            fm.visc, fm.trans, fm.ffs, fm.steps_per_call, fm.general,
            fm.folds)


def form_key(fm) -> tuple:
    """The kernel instantiation a model launches, as the wrapper counts
    it: (tracers, guarded, plane metrics, mu mode, bathymetry planes,
    raw, advection, full free surface, steps a launch, general form,
    folds). The sharded model launches the raw form; the general form's
    bathymetry is always a plane and counts as not; folds: the kernel's
    FOLD code (0 none, 3 elide_sel + q4, 7 with share_prev, 4
    share_prev)."""
    from ocean_model_arch_torch.ops.fused_step import (fold_code,
                                                       kernel_folds, mu_mode)
    return (fm.n_tracers, fm.tile_guard, fm.metrics_2d,
            mu_mode(fm.n_tracers, fm.mu_const, fm.visc),
            fm.hr_const is None and not fm.general,
            hasattr(fm, "shard_lay"), fm.trans, fm.ffs, fm.steps_per_call,
            fm.general, fold_code(kernel_folds(fm.folds, fm.steps_per_call,
                                               fm.ffs)))


def kernel_name(fm) -> str:
    """The CUDA kernel a model's launches run, as torch.profiler names
    it."""
    return FUSED_KERNELS[bool(form_key(fm)[10])]


# the kernels line's suffix of each fold code
FOLD_SUFFIX = {0: "", 3: "_folds", 7: "_folds_share", 4: "_share",
               1: "_elide", 2: "_q4", 5: "_elide_share", 6: "_q4_share"}


def key_text(key) -> str:
    return "<" + ",".join(str(int(k)) for k in key) + ">"


def form_name(fm) -> str:
    """The entry of the kernels line a model's instantiation counts
    under: the four names of the inviscid flat-bathymetry forms, else
    the features spelt out (``tracersT`` for the run-time tracer forms,
    T >= 3), after ``chain`` (two steps a launch), ``notrans`` (no
    momentum advection) and ``linear`` (a linear free surface) where the
    form has them."""
    forms = ("_chain" * (fm.steps_per_call == 2) + "_notrans" * (not fm.trans)
             + "_linear" * (not fm.ffs))
    many = fm.n_tracers > N_TRACERS
    new = form_key(fm)[3] or fm.hr_const is None or many
    folds = FOLD_SUFFIX[form_key(fm)[10]]
    if not new:
        return ("fused_sw_step" + forms
                + ("_fast2d" if fm.metrics_2d else
                   "_tracers" if fm.n_tracers else
                   "_guarded" if fm.tile_guard else "") + folds)
    feats = "".join(
        "_" + w for w, on in (("visc", fm.visc),
                              ("diff", form_key(fm)[3] == 1),
                              ("bathy", fm.hr_const is None),
                              ("tracers" + f"{fm.n_tracers}" * many,
                               fm.n_tracers > 0),
                              ("fast2d", fm.metrics_2d)) if on)
    return ("fused_sw_step" + forms
            + (feats or "_guarded" * bool(fm.tile_guard)) + folds)


def replaces(form: str) -> str:
    """The TPU kernel a kernels-line entry replaces: its form's line, or
    for a folded instantiation the folds' flags of ``_make_kernel``."""
    for suffix in sorted(FOLD_SUFFIX.values(), key=len, reverse=True):
        if suffix and form.endswith(suffix):
            return PALLAS + ":246"
    return REPLACES[form]


def with_mu(state, mu: float):
    """The state with its viscosity field filled with ``mu`` (the init
    quirk zeroes it)."""
    return dataclasses.replace(state, mu=torch.full_like(state.mu, mu))


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
    kernel form (``steps_per_call`` model steps): (ms, "bytes" or
    "operations", the bytes). Bytes: each input plane (the carried fields
    and the form's static planes) read once and each output written once
    over the cells the form computes
    (all cells unguarded; the cells of wet tiles when guarded, plus the
    zero writes of the all-land tiles), the profile rows or, per
    computed cell, the metric planes, one flag and one max per block.
    Operations: an estimate of the f32 operations of those cells."""
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
    met_bytes = (done * 4 * fm.met.shape[0] if fm.metrics_2d
                 else fm.met.numel() * 4)
    nbytes = (done * 4 * (2 * n_out + fm.planes.shape[0])
              + skipped * 4 * n_out + met_bytes
              + blocks * (4 + (4 if fm.tile_wet is not None else 0)))
    flops = done * (CELL_FLOPS + TRACER_FLOPS * n_tracers
                    + VISC_FLOPS * fm.visc) * fm.steps_per_call
    t_b, t_f = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return (t_b, "bytes", nbytes) if t_b >= t_f else (t_f, "operations",
                                                      nbytes)


def broadcast_planes(fm, n_tr):
    """The profile rows a step reads, repeated along x as (n, Xs, Ys)
    planes, with their row -> plane map."""
    from ocean_model_arch_torch.ops import fused_layout as fl
    rows = fl.fast2d_met_rows(n_tr, fm.visc, fm.trans)
    planes = fm.met[list(rows)][:, None, :].expand(
        len(rows), fm.lay.Xs, fm.lay.Ys).contiguous()
    return planes, {r: i for i, r in enumerate(rows)}


def compare_forms(mname, grid, cfgs, stats, mu=0.0, spc=1, phase=None):
    """Phase 2 on one mask: every kernel form against the plain version,
    and guarded against unguarded, with the state's viscosity ``mu``, at
    ``spc`` model steps a launch (phase 11: 2, chained, with half the
    carried launches, the same model steps). ``stats``: form name -> max
    abs err. ``phase``: the lines' tag, if not that of phase 2 or 11a."""
    from ocean_model_arch_torch.model.fused import FusedSWModel
    from ocean_model_arch_torch.model.init import init_ocean_state
    from ocean_model_arch_torch.ops.fused_step import (
        fused_sw_step, fused_sw_step_blockmax, fused_sw_step_reference)

    carried = {}
    n_carry = N_CARRY // spc
    phase = phase or ("phase 2" if spc == 1 else "phase 11a")
    for n_tr, cfg in cfgs.items():
        state = with_mu(init_ocean_state(grid, cfg), mu)
        for guard in (False, True):
            fm = FusedSWModel(grid, cfg, 1.0, mu_const=mu, static_rslu=True,
                              **UNFOLDED,
                              steps_per_call=spc, tile_guard=guard)
            args = model_args(fm, cfg)
            land = land_masks(fm, grid, n_tr)
            s0 = fm.pack(state)
            form = form_name(fm)
            tag = (f"{mname} T={n_tr} guard={'on' if guard else 'off'} "
                   f"{key_text(form_key(fm))}")
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
            for _ in range(n_carry):
                ks, _ = fused_sw_step(ks, *args)
                rs, _ = fused_sw_step_reference(rs, *args)
            eN = compare(f"{n_carry} launches", ks, rs, TOL_CARRY)
            # one launch from the evolved state (advection, Coriolis live)
            k2, _ = fused_sw_step(rs, *args)
            r2, _ = fused_sw_step_reference(rs, *args)
            e2 = compare(f"1 launch after {n_carry}", k2, r2, TOL_ONE)
            carried[(n_tr, guard)] = (k1, ks)
            same = ""
            if not fm.metrics_2d:
                # the plane-metric kernel on this x-uniform grid's profile
                # rows repeated along x: the same f32 operations in the
                # same order, so the same bits, from both states
                met_b, map_b = broadcast_planes(fm, n_tr)
                for what, start in (("the initial state", s0),
                                    (f"launch {n_carry}", rs)):
                    kp, bp = fused_sw_step_blockmax(start, *args)
                    kb, bb = fused_sw_step_blockmax(
                        start, met_b, *args[1:8], map_b, *args[9:])
                    check(all(torch.equal(a, b) for a, b in zip(kp, kb))
                          and torch.equal(bp, bb), f"{tag}: the plane-"
                          "metric kernel on repeated profile rows differs "
                          f"from the profile kernel, from {what}")
                same = ("; plane-metric kernel on repeated profile rows == "
                        "profile kernel bit for bit: yes")
            torch.cuda.synchronize()
            print(f"{phase} kernel vs plain ({tag}, {fm.lay.Xs}x"
                  f"{fm.lay.Ys} layout, {fm.tile[0]}x{fm.tile[1]} tiles: "
                  f"{fm.n_tiles[0]} wet, {fm.n_tiles[1]} land): rel err "
                  f"per field 1 launch {fmt(e1)} < {TOL_ONE}; {n_carry} "
                  f"launches {fmt(eN)} < {TOL_CARRY}; 1 launch from launch "
                  f"{n_carry} {fmt(e2)} < {TOL_ONE}; land exactly 0: yes"
                  + ("; all-land tiles and their block max exactly 0: yes"
                     if guard else "") + same)
        for which, what in ((0, "1 launch"), (1, f"{n_carry} launches")):
            off, on = carried[(n_tr, False)][which], \
                carried[(n_tr, True)][which]
            check(all(torch.equal(a, b) for a, b in zip(off, on)),
                  f"{mname} T={n_tr}: guarded and unguarded kernel outputs "
                  f"differ after {what}")
        print(f"{phase} guard on vs off ({mname} T={n_tr}): kernel outputs "
              f"bit-identical after 1 and {n_carry} launches")


def tracer_mass(state, grid) -> list:
    """sum(ff * hhq * dx * dy) over wet cells, per tracer, in float64."""
    w = (grid.lu > 0.5).double() * grid.dx.double() * grid.dy.double()
    return [float((state.ff[t].double() * state.hhq.double() * w).sum())
            for t in range(state.ff.shape[0])]


# the eager composition's N_MAIN steps a path is held against, by (grid,
# config, mu): the forms of one configuration (one step, chained, general,
# folded, persistent) share it
EAGER_REFS = {}


def eager_reference(tag, grid, cfg, state, mu):
    """The eager composition's state after N_MAIN steps from ``state`` (the
    initial state of ``grid`` and ``cfg`` with viscosity ``mu``), computed
    once a configuration; the entry holds the grid, so a recycled id
    cannot hit."""
    from ocean_model_arch_torch.model.step import make_step, run_steps
    key = (id(grid), repr(cfg), float(mu))
    hit = EAGER_REFS.get(key)
    if hit is None or hit[0] is not grid:
        ref, eok = run_steps(make_step(grid, cfg), state, 1.0, N_MAIN)
        check(eok, f"{tag}: the eager composition's guard tripped")
        hit = EAGER_REFS[key] = (grid, ref)
    return hit[1]


def drive_path(tag, grid, cfg, tile_guard, mu=0.0, spc=1, model_kw=None):
    """One path end to end: init -> FusedSWModel -> pack -> run_steps ->
    unpack for N_MAIN steps at ``spc`` steps a launch, against the eager
    composition, with the viscosity ``mu`` in the state and the model.
    ``model_kw``: FusedSWModel's form arguments (the fast form's
    ``static_rslu=True`` when None; {} takes the model's defaults, the
    general form).
    The launch counts are zeroed just before ``run_steps`` and read just
    after; the path's kernel instantiation (``form_key``) must have
    launched once per ``spc`` steps and no other at all. Returns (model,
    state, packed initial fields, launches of that instantiation, the
    final state)."""
    from ocean_model_arch_torch.model.fused import FusedSWModel
    from ocean_model_arch_torch.model.init import init_ocean_state
    from ocean_model_arch_torch.ops.fused_step import (fused_sw_step,
                                                       reset_launch_counts)

    n_tr = cfg.sw.tracer_num if cfg.sw.use_tracers > 0 else 0
    state = with_mu(init_ocean_state(grid, cfg), mu)
    fm = FusedSWModel(grid, cfg, 1.0, mu_const=mu, steps_per_call=spc,
                      tile_guard=tile_guard,
                      **({"static_rslu": True, **UNFOLDED} if model_kw is None
                         else model_kw))
    s0 = fm.pack(state)
    reset_launch_counts()
    s, ok = fm.run_steps(s0, N_MAIN)
    launches = fused_sw_step.launches
    counts = dict(fused_sw_step.form_launches)
    out = fm.unpack(s, state)
    n = N_MAIN // spc
    check(ok, f"{tag}: the stability guard tripped")
    check(launches == n, f"{tag}: {launches} kernel launches for "
          f"{N_MAIN} steps at {spc} a launch")
    key = form_key(fm)
    check(counts == {key: n}, f"{tag}: launches per (tracers, guarded, "
          f"plane metrics, mu mode, bathymetry planes, raw, advection, "
          f"full free surface, steps, general) {counts}, expected {n} of "
          f"{key}")
    ref = eager_reference(tag, grid, cfg, state, mu)
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
            f"of {key_text(key)} "
            f"({'general' if fm.general else 'fast'} form, "
            f"guard {'on' if fm.tile_guard else 'off'}, "
            f"{'plane' if fm.metrics_2d else 'profile'} metrics, mu "
            f"{fm.mu_const:g}, bathymetry "
            f"{'planes' if fm.hr_const is None else 'flat'}, tiles "
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
    return fm, state, s0, counts[key], out


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
        lambda: fm.run_steps(s0, N_TIME), kernel_name(fm))
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


def copy_step_inputs(fm, s0):
    """What the fused step of model ``fm`` loads, as the copy step takes
    it: (the carried fields then the static planes, the metric rows the
    step reads: the general form's rows 0-15)."""
    from ocean_model_arch_torch.ops import fused_layout as fl
    rows = (range(fl.N_GENERAL) if fm.general
            else fl.fast2d_met_rows(fm.n_tracers, fm.visc, fm.trans))
    met = fm.met if fm.metrics_2d else fm.met[list(rows)].contiguous()
    return tuple(s0) + tuple(fm.planes), met


def load_script(name: str):
    """scripts/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bathymetry(nx: int, ny: int) -> np.ndarray:
    """A rest bathymetry of 15-100 m, float32: deepest in the middle of
    the array, 15 m along its edges."""
    i = np.arange(nx, dtype=np.float64)[:, None]
    j = np.arange(ny, dtype=np.float64)[None, :]
    return (15.0 + 85.0 * np.sin(np.pi * i / (nx - 1))
            * np.sin(np.pi * j / (ny - 1))).astype(np.float32)


def against_parent(parent: str, card: str, chain_regs: int,
                   subset: str | None = None) -> int:
    """Every one-step instantiation the checkout at ``parent`` has, on the
    Azov coastline at full size, against this checkout's: profile and
    plane metrics, 0 / 1 / 2 tracers and the run-time family at 3, guard
    off / on, mu = 0, the tracers' diffusive fluxes alone, viscosity,
    flat bathymetry and bathymetry planes, with and without momentum
    advection, with a full and a linear free surface, the fast and the
    general form (the general one on flat bathymetry at mu = 0 and over
    the 15-100 m one at mu = 1000: its bathymetry is a plane either way),
    each in its single-block and its raw form (the raw form on the single
    block's layout, whose box is its interior), as far as the parent's
    wrappers take arguments for them; forms whose further arguments are
    not at their defaults (the switches of an older parent) have no
    parent; the general form also two steps a launch (chained, and its
    raw form chained on the same layout). Then the main path's chained
    and folded fast instantiations (``PARENT_MAIN``: T = 0 and 2, guarded,
    profile and plane metrics, one step and two a launch, unfolded and
    with the drivers' folds), and the six K2 runs of ``PERSIST_RUNS`` (one
    launch of ``N_TIME`` steps each). First the parent's libraries of
    those forms are built, all at once; where this process built its own
    (phase 1), a redesigned form's instantiations (those on the TMA
    loader: the fast body's, the general body's by TMA, the persistent
    walk's) must be as many, within the launch bound (42 registers one step,
    ``chain_regs`` chained) with no spill, a form left on the threads'
    loader must have the parent's registers and spills. Outputs and block
    maxima from a state 20 steps in (K2: from the initial state, the
    fields and the max over the blocks): bit for bit, or for a fast
    instantiation each difference listed (and within 1e-5 of the
    parent's). Kernel device us/launch over three windows a side in the
    order parent, this, this, parent, parent, this (torch.profiler; K2:
    CUDA events around its launch): a redesigned form's this / parent at
    most 1.02, one-sided; a form on the threads' loader within 2 % (where
    a form is off its rule, over up to nine windows a side). ``subset``:
    ``--bathymetry``, of the one-step instantiations only the fast ones
    over bathymetry planes with 0 or ``N_TRACERS`` tracers (those whose
    plane plan places the bathymetry planes), and only their libraries and
    ``PARENT_MAIN``'s are built; ``--general``, only the general form's
    instantiations and the K2 runs, and only their libraries."""
    from ocean_model_arch_torch.core.grid import build_grid
    from ocean_model_arch_torch.host import (Precision, basinpar_as250m_test,
                                             frame_of_land_mask, read_mask)
    from ocean_model_arch_torch.model.fused import FusedSWModel
    from ocean_model_arch_torch.model.fused_sharded2d import \
        FusedSharded2DModel
    from ocean_model_arch_torch.model.init import init_ocean_state
    from ocean_model_arch_torch.ops import fused_step as mine
    from ocean_model_arch_torch.ops.fused_step import general_geometry

    pkg = os.path.join(os.path.abspath(parent), "ocean_model_arch_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_port", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    sys.modules["parent_port"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules["parent_port"])
    theirs = importlib.import_module("parent_port.ops.fused_step")
    theirs_build = importlib.import_module("parent_port.ops._build")
    probe = load_script("roofline_probe_torch")
    from ocean_model_arch_torch.ops import _build
    bathymetry_only, general_only = (subset == "--bathymetry",
                                     subset == "--general")
    fast_targets = () if general_only else theirs.library_targets()
    gen_targets = (theirs.library_targets(general=True)
                   if "general" in inspect.signature(
                       theirs.library_targets).parameters else ())
    persist = (theirs.persist_targets()
               if hasattr(theirs, "persist_targets") and not bathymetry_only
               else ())
    if bathymetry_only:
        fast_targets = tuple(sorted(
            {theirs.library_target(t, raw, trans, ffs) for t in (0, N_TRACERS)
             for raw in (False, True) for trans, ffs in mine.FORMS}
            | {theirs.library_target(t, False, 1, 1, 2) for t in (0, 2)}))
        gen_targets = ()
    # the parent's fold libraries of PARENT_MAIN's folded forms
    fold_targets = tuple(sorted({
        theirs.library_target(t, False, 1, 1, spc, folds=3 + 4 * (spc > 1))
        for _, _, t, spc, kw in PARENT_MAIN if not kw}
        | {theirs.library_target(N_TRACERS, True, 1, 1, spc,
                                 folds=3 + 4 * (spc > 1))
           for spc in (1, 2)})) if hasattr(
            theirs, "fold_targets") and not general_only else ()
    old_targets = fast_targets + gen_targets + fold_targets + persist
    t0 = time.perf_counter()
    theirs_build.build_all(old_targets)
    if fold_targets:            # this checkout's twins, at once too
        _build.build_all(fold_targets)
    regs = ""
    if all(t in _build.BUILDS for t in fast_targets + gen_targets + persist):
        n_old = n_new = 0
        for t in fast_targets + gen_targets + persist:
            a = sorted(ptxas_table(_build.BUILDS[t]["log"]))
            b = sorted(ptxas_table(theirs_build.BUILDS.get(t, {}).get(
                "log", "")))
            if t in gen_targets and not general_loads_by_tma(t):
                check(a == b, f"{t}: registers or spills differ from the "
                      f"parent's: {sorted(set(a) ^ set(b))[:6]}")
                n_old += len(a)
                continue
            lim = chain_regs if "FUSED_STEPS=2" in t else MAX_REGS
            over = [r for r in a if r[1] > lim or r[2] != 0]
            check(not over and len(a) == len(b), f"{t}: {len(a)} "
                  f"instantiations ({len(b)} in the parent's), above "
                  f"{lim} registers or spilling: {over[:6]}")
            n_new += len(a)
        regs = (f"; registers and spills of the {n_old} instantiations on "
                "the threads' loader == the parent's: yes; the "
                f"{n_new} on the TMA loader (fast, general, persistent) "
                "within the launch bound, no spill: yes")
    print(f"against parent: the parent's {len(old_targets)} libraries built "
          f"in {time.perf_counter() - t0:.1f} s{regs}", flush=True)
    print("against parent: the parent's window loads in SASS: " + "; ".join(
        loader_sass(label, theirs_build.build(t), kern)
        for label, t, kern in (
            ("copy step <0,1,0>", "copy_step",
             "copy_step_kernelILi0ELi1ELb0E"),
            ("fused step T=0 one step <0,0,0,0,0,0,1,1,1,0>",
             theirs.library_target(0), "fused_sw_step_kernelILi0ELb0ELb0E"
             "Li0ELb0ELb0ELb1ELb1ELi1ELb0E"))), flush=True)
    print("against parent: " + launcher_host_us(mine, theirs), flush=True)
    # the arguments the parent's wrapper takes after the fields, and the
    # defaults of the ones only this checkout's takes
    n_old = len(inspect.signature(theirs.fused_sw_step).parameters) - 1
    defaults = [v.default for v in list(inspect.signature(
        mine.fused_sw_step).parameters.values())[1:]]
    raws = (False, True) if hasattr(theirs, "fused_sw_step_raw") else (False,)

    basin = basinpar_as250m_test()
    prec = Precision.f32()
    mask = read_mask(os.path.join(REPO, "data", "AS", "maskAzovCor.txt"),
                     basin.nx, basin.ny)
    hr = bathymetry(basin.nx, basin.ny)
    # redesigned: this / parent; on the threads' loader: |1 - it|
    worst = {True: 0.0, False: 0.0}
    n_forms, exceptions = 0, []

    def compare(fm, cfg, state, raw, fast, tag, shard=None):
        """``shard``: (sharded model, its first shard's fields): that
        shard's raw launch instead of ``fm``'s. ``fast``: the fast body
        (its differences listed); a general form by TMA is judged as
        redesigned too, bit for bit."""
        nonlocal n_forms
        redesigned = fast or general_geometry(
            fm.n_tracers, fm.steps_per_call, fm.visc).tma
        args = model_args(fm, cfg) if shard is None else \
            shard_args(shard[0], cfg, 0, 0)
        old_args = args[:n_old]
        if any(a != d for a, d in zip(args[n_old:], defaults[n_old:])):
            return              # a form the parent does not have
        if shard is None:
            s, _ = fm.run_steps(fm.pack(state), 20)
        else:
            s = shard[1]
        if raw:
            lay, tile = args[2], args[7] or fm.tile
            bm_shape = tuple(-(-n // t) for n, t in zip(
                (lay.Xs, lay.Ys), tile))
            bufs = {k: (tuple(torch.zeros_like(a) for a in s),
                        torch.zeros(bm_shape, device=s[0].device))
                    for k in "PT"}
            mine.fused_sw_step_raw(s, *bufs["T"], *args)
            theirs.fused_sw_step_raw(s, *bufs["P"], *old_args)
            (new, nb), (old, ob) = bufs["T"], bufs["P"]

            def old_call():
                theirs.fused_sw_step_raw(s, *bufs["P"], *old_args)

            def new_call():
                mine.fused_sw_step_raw(s, *bufs["T"], *args)
        else:
            new, nb = mine.fused_sw_step_blockmax(s, *args)
            old, ob = theirs.fused_sw_step_blockmax(s, *old_args)

            def old_call():
                theirs.fused_sw_step(s, *old_args)

            def new_call():
                mine.fused_sw_step(s, *args)
        same = (all(torch.equal(x, y) for x, y in zip(new, old))
                and torch.equal(nb, ob))
        if not same:
            diff = max([float((x - y).abs().max()) for x, y in zip(new, old)]
                       + [float((nb - ob).abs().max())])
            rel = max(rel_err(x, y) for x, y in zip(new, old))
            check(fast and rel <= TOL_ONE, f"{tag}: outputs differ from "
                  f"the parent's (max |diff| {diff:.3e}, rel {rel:.2e})")
            exceptions.append(f"{tag} max |diff| {diff:.3e}")
        # three windows a side, compared by their medians: one window in a
        # dozen reads 2-6 % off on either library. Medians off the rule
        # (general: more than 2 % apart; fast: this above 1.02 x parent)
        # get more windows (up to nine a side) before they count.
        order, us = "", []
        for _ in range(3):
            order += "PTTPPT"
            us += [probe.kernel_us(
                old_call if c == "P" else new_call, N_TIME, kernel_name(fm))
                for c in "PTTPPT"]
            med = {c: float(np.median([u for u, o in zip(us, order)
                                       if o == c])) for c in "PT"}
            ratio = med["T"] / med["P"]
            if (ratio <= 1.02) if redesigned else abs(ratio - 1.0) < 0.02:
                break
        worst[redesigned] = max(worst[redesigned], ratio if redesigned
                                else abs(ratio - 1.0))
        n_forms += 1
        print(f"against parent {tag}: outputs and block max bit-identical: "
              + ("yes" if same else "no (" + exceptions[-1] + ")")
              + "; kernel us/launch "
              + ", ".join(f"{'parent' if c == 'P' else 'this'} {u:.2f}"
                          for u, c in zip(us, order))
              + f" (medians this / parent {ratio:.4f})", flush=True)

    for (trans, ffs), cg in [(f, c) for f in mine.FORMS for c in (0, 2)]:
        b = dataclasses.replace(basin, curve_grid=cg)
        for hr_planes in (False, True):
            grid = build_grid(b, mask, hhq_rest=hr if hr_planes else None,
                              precision=prec)
            # (tracers, mu, ksw_lat): mu modes 0, 1 (tracers only), 2; the
            # general form (fast = False) on flat bathymetry at mu = 0 and
            # over the 15-100 m one at mu = 1000
            for n_tr, mu, ksw, fast in [
                    (t, m, k, f) for f in (True, False)
                    for t in (0, 1, 2, T_LOOP[0])
                    for m, k in ((0.0, 1), (MU, 0), (MU, 1))
                    if (t or k) and (f or bool(m) == hr_planes)
                    and (not bathymetry_only or f and hr_planes
                         and t in (0, N_TRACERS))
                    and not (general_only and f)]:
                cfg = form_cfg(b, prec, n_tr, trans, ffs, ksw)
                state = with_mu(init_ocean_state(grid, cfg), mu)
                for guard, raw, spc in [(g, r, c) for r in raws
                                        for g in (False, True)
                                        for c in ((1,) if fast else (1, 2))]:
                    fm = FusedSWModel(grid, cfg, 1.0, mu_const=mu,
                                      tile_guard=guard, static_rslu=fast,
                                      steps_per_call=spc, **UNFOLDED)
                    compare(fm, cfg, state, raw, fast,
                            key_text(form_key(fm)[:5] + (
                                raw,) + form_key(fm)[6:])
                            + f" (curve_grid={cg})")
    # the main path's chained and folded forms, where the parent has them:
    # on the coastline guarded, on the frame unguarded (``default``), and
    # azov_visc's first shard of the 2 x 2 split
    if hasattr(theirs, "fold_targets") and not general_only:
        frame = frame_of_land_mask(basin.nx, basin.ny)
        for where, cg, n_tr, spc, kw in PARENT_MAIN:
            b = dataclasses.replace(basin, curve_grid=cg)
            grid = build_grid(b, mask if where == "azov" else frame,
                              precision=prec)
            cfg = form_cfg(b, prec, n_tr, 1, 1)
            fm = FusedSWModel(grid, cfg, 1.0, tile_guard=where == "azov",
                              static_rslu=True, steps_per_call=spc, **kw)
            compare(fm, cfg, init_ocean_state(grid, cfg), False, True,
                    key_text(form_key(fm)) + f" ({where}, curve_grid={cg})")
        grid = build_grid(basin, mask, hhq_rest=hr, precision=prec)
        cfg = form_cfg(basin, prec, N_TRACERS, 1, 1)
        state = with_mu(init_ocean_state(grid, cfg), MU)
        for spc in (1, 2):
            fs = FusedSharded2DModel(grid, cfg, 1.0, 2, 2, mu_const=MU,
                                     steps_per_call=spc)
            run = fs.make_runner(20)
            c, _ = run(fs.pack(state))
            compare(fs, cfg, state, True, True, key_text(form_key(fs))
                    + " (azov_visc 2 x 2, shard (0, 0))",
                    (fs, c[0].unbind(0)))
    if persist:
        n_forms += parent_persistent(theirs, basin, prec, mask, hr, worst)
    check(worst[True] <= 1.02 and worst[False] < 0.02, "a redesigned "
          f"instantiation's time rose by {worst[True] - 1:.1%} or one on the "
          f"threads' loader moved by {worst[False]:.1%}")
    print(f"against parent ({card}): {n_forms} instantiations, "
          f"{n_forms - len(exceptions)} bit-identical"
          + (f" (not: {'; '.join(exceptions)})" if exceptions else "")
          + f"; redesigned forms (the TMA loader) this / parent at most "
          f"{worst[True]:.4f}, forms on the threads' loader within "
          f"{worst[False]:.2%}")
    return 0


def parent_persistent(theirs, basin, prec, mask, hr, worst) -> int:
    """``against_parent``'s K2 runs: each of ``PERSIST_RUNS`` at full size,
    one launch of ``N_TIME`` steps of this checkout's persistent kernel and
    of the parent's (``theirs``: its ``ops.fused_step``) from the same
    initial state, fields and max bit for bit, then CUDA events around
    one launch a window (torch.profiler misses cooperative launches) in
    the order parent, this, this, parent, parent, this, three windows a
    side (up to nine where this / parent is above 1.02). Folds the ratio
    into ``worst[True]``; returns the runs held."""
    from ocean_model_arch_torch.core.grid import build_grid
    from ocean_model_arch_torch.host import frame_of_land_mask
    from ocean_model_arch_torch.model.fused import FusedSWModel
    from ocean_model_arch_torch.model.init import init_ocean_state
    from ocean_model_arch_torch.ops import fused_step as mine
    masks = {"frame": frame_of_land_mask(basin.nx, basin.ny), "azov": mask,
             "azov_hr": mask}
    for label, _, gname, n_tr, mu, fast, _ in PERSIST_RUNS:
        grid = build_grid(basin, masks[gname], precision=prec,
                          hhq_rest=hr if gname == "azov_hr" else None)
        cfg = form_cfg(basin, prec, n_tr, 1, 1)
        kw = {"static_rslu": True, **UNFOLDED} if fast else {}
        fp = FusedSWModel(grid, cfg, 1.0, mu_const=mu, persistent=True, **kw)
        s0 = fp.pack(with_mu(init_ocean_state(grid, cfg), mu))
        args = (fp.met, fp.planes, fp.lay, fp.tau, cfg.sw.time_smooth,
                fp.hr_const, fp.mu_const, fp.visc, fp.trans, fp.ffs)
        bufs = {c: (tuple(f.clone() for f in s0),
                    tuple(torch.zeros_like(f) for f in s0)) for c in "PT"}
        outs = {c: (mine if c == "T" else theirs).fused_sw_persistent(
            *bufs[c][:1], *args, n_steps=N_TIME, general=fp.general,
            spare=bufs[c][1]) for c in "PT"}
        same = (all(torch.equal(a, b) for a, b in zip(outs["T"][0],
                                                      outs["P"][0]))
                and torch.equal(outs["T"][1], outs["P"][1]))
        check(same, f"K2 {label}: {N_TIME} steps differ from the parent's")

        def call(c):
            return lambda: (mine if c == "T" else theirs).fused_sw_persistent(
                *bufs[c][:1], *args, n_steps=N_TIME, general=fp.general,
                spare=bufs[c][1])
        order, us = "", []
        for _ in range(3):
            order += "PTTPPT"
            us += [cuda_ms(call(c), 1) * 1e3 / N_TIME for c in "PTTPPT"]
            med = {c: float(np.median([u for u, o in zip(us, order)
                                       if o == c])) for c in "PT"}
            ratio = med["T"] / med["P"]
            if ratio <= 1.02:
                break
        worst[True] = max(worst[True], ratio)
        key = (n_tr, mine.mu_mode(n_tr, mu, fp.visc),
               fp.hr_const is None and not fp.general, fp.trans, fp.ffs,
               fp.general)
        print(f"against parent K2 {label} {key_text(key)}: "
              f"{N_TIME} steps in one launch bit-identical to the parent's: "
              "yes; us a step "
              + ", ".join(f"{'parent' if c == 'P' else 'this'} {u:.2f}"
                          for u, c in zip(us, order))
              + f" (medians this / parent {ratio:.4f})", flush=True)
    return len(PERSIST_RUNS)


# ---- phase 9: the entry point and the raw form ------------------------------

def shard_args(fs, cfg, i, j):
    """The arguments of ``fused_sw_step_raw`` after (fields, outs,
    blockmax) for shard (i, j), as the sharded model passes them."""
    return (fs.met_shards[i][j], fs.plane_shards[i][j], fs.shard_lay[i][j],
            fs.tau, cfg.sw.time_smooth, fs.hr_const, fs.tile_wet[i][j],
            fs.tile, fs.met_map, fs.mu_const, fs.visc, fs.trans, fs.ffs,
            fs.steps_per_call, fs.general, fs.folds)


def n_blocks(fs) -> tuple:
    tx, ty = fs.tile
    return (-(-fs.lay.Xs // tx), -(-fs.lay.Ys // ty))


def compare_raw(tag, fs, cfg, state, stats, form, phase=None,
                same_as=None) -> tuple:
    """Phase 9a on one sharded model: after one margin exchange, the raw
    form of the kernel against its plain version on every shard (one
    launch), then ``N_CARRY`` carried launches (half as many of the
    chained form, the same model steps) on the shard with the most wet
    tiles, its margin frozen; the margins and the pad of the output
    buffers must stay what they were, bit for bit. ``stats[form]`` takes
    the largest absolute difference. ``phase``: the line's tag, if not
    that of phase 9a or 11c. ``same_as``: what an earlier call returned
    for the same form with the guard on; the carried launches then run on
    its shard and must give its fields bit for bit (guarded ==
    unguarded), in place of a second plain run. Returns (the shard of the
    carried launches, its fields after them)."""
    from ocean_model_arch_torch.ops.fused_step import (
        fused_sw_step_raw, fused_sw_step_reference)
    carry = list(fs.pack(state))
    fs.exchange(carry)
    M = fs.M
    worst1, busiest, most = 0.0, 0, -1
    for k, c in enumerate(carry):
        i, j = divmod(k, fs.py)
        args = shard_args(fs, cfg, i, j)
        lay = fs.shard_lay[i][j]
        f = c.unbind(0)
        ko = tuple(torch.full_like(a, 7.0) for a in f)
        ro = tuple(torch.full_like(a, 7.0) for a in f)
        bm = torch.zeros(n_blocks(fs), device=c.device)
        fused_sw_step_raw(f, ko, bm, *args)
        _, rmx = fused_sw_step_reference(f, *args, outs=ro)
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(ko, ro)]
        check(max(errs) < TOL_ONE, f"{tag} shard ({i}, {j}) 1 launch: raw "
              f"kernel vs plain rel errors {errs} exceed {TOL_ONE}")
        outside = torch.ones_like(f[0], dtype=torch.bool)
        outside[M:M + lay.nx, M:M + lay.ny] = False
        check(all(bool((a[outside] == 7.0).all()) for a in ko),
              f"{tag} shard ({i}, {j}): the raw kernel wrote outside the "
              "shard's box")
        check(abs(float(bm.max()) - float(rmx)) <= TOL_ONE * float(rmx),
              f"{tag} shard ({i}, {j}): block max {float(bm.max())} vs "
              f"plain {float(rmx)}")
        worst1 = max([worst1] + errs)
        stats[form] = max([stats.get(form, 0.0)] + [
            float((a - b).abs().max()) for a, b in zip(ko, ro)])
        wet = n_blocks(fs)[0] * n_blocks(fs)[1] if fs.tile_wet[i][j] is None \
            else int(fs.tile_wet[i][j].sum())
        if wet > most:
            busiest, most = k, wet
    if same_as is not None:
        busiest = same_as[0]
    # carried launches on one shard, two buffers a side, the margin frozen
    n_carry = N_CARRY // fs.steps_per_call
    i, j = divmod(busiest, fs.py)
    args = shard_args(fs, cfg, i, j)
    lay = fs.shard_lay[i][j]
    start = carry[busiest]
    kb = [start.clone(), start.clone()]
    rb = [start.clone(), start.clone()]
    bm = torch.zeros(n_blocks(fs), device=start.device)
    for n in range(n_carry):
        fused_sw_step_raw(kb[n % 2].unbind(0), kb[1 - n % 2].unbind(0), bm,
                          *args)
        if same_as is None:
            fused_sw_step_reference(rb[n % 2].unbind(0), *args,
                                    outs=rb[1 - n % 2].unbind(0))
    torch.cuda.synchronize()
    got = kb[n_carry % 2]
    if same_as is None:
        want = rb[n_carry % 2]
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        check(max(errs) < TOL_CARRY, f"{tag} shard ({i}, {j}) {n_carry} "
              f"launches: rel errors {errs} exceed {TOL_CARRY}")
        stats[form] = max([stats[form]] + [
            float((a - b).abs().max()) for a, b in zip(got, want)])
        carried = f"{fmt(errs)} < {TOL_CARRY}"
    else:
        check(torch.equal(got, same_as[1]), f"{tag} shard ({i}, {j}) "
              f"{n_carry} launches: not the guarded run's fields bit for bit")
        carried = "== the guarded run bit for bit"
    outside = torch.ones_like(start[0], dtype=torch.bool)
    outside[M:M + lay.nx, M:M + lay.ny] = False
    check(all(torch.equal(b[:, outside], start[:, outside]) for b in kb),
          f"{tag} shard ({i}, {j}): margins or pad changed in {n_carry} "
          "launches")
    phase = phase or ("phase 9a" if fs.steps_per_call == 1 else "phase 11c")
    print(f"{phase} raw kernel vs plain ({tag}, {fs.px} x {fs.py} shards of "
          f"{fs.lay.Xs}x{fs.lay.Ys}, margin {M}, form "
          f"{key_text(form_key(fs))}): 1 launch on every shard rel err <= "
          f"{worst1:.2e} < {TOL_ONE}; {n_carry} launches on shard ({i}, "
          f"{j}) {carried}; margins and pad of the output buffers "
          "untouched bit for bit: yes")
    return busiest, got


def run_sharded(tag, fs, state, n_steps):
    """``n_steps`` steps of a sharded model from ``state``, the launch
    counts set to 0 just before and read just after: the model's raw
    instantiation must have launched once per shard and launch (every
    ``steps_per_call`` steps) and no other, after one exchange each.
    Returns (the 6 + 2 T physical fields, ok, launches)."""
    from ocean_model_arch_torch.ops.fused_step import (fused_sw_step,
                                                       reset_launch_counts)
    run = fs.make_runner(n_steps)
    carry = fs.pack(state)
    reset_launch_counts()
    before = fs.strip_copies
    carry, ok = run(carry)
    counts = dict(fused_sw_step.form_launches)
    key = form_key(fs)
    turns = n_steps // fs.steps_per_call
    n = turns * fs.px * fs.py
    check(counts == {key: n}, f"{tag}: launches {counts}, expected {n} of "
          f"{key}")
    check(fs.strip_copies - before == len(fs._plan) * turns,
          f"{tag}: {fs.strip_copies - before} strip copies")
    return fs.extract(carry), ok, n


def profile_events(fn) -> dict:
    """One call of ``fn`` under torch.profiler, after a warm-up call:
    device kernel name -> (launches, device us in all). A window with no
    device activity recorded is taken again, as in
    ``roofline_probe_torch.kernel_us``, three at most."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = {e.key: (e.count, e.self_device_time_total)
                  for e in prof.key_averages()
                  if e.self_device_time_total > 0}
        if events:
            return events
    return events


def sharded_bound_ms(fs):
    """The least time the card could take for one launch on every shard
    of a sharded model (``steps_per_call`` model steps): (ms, the bytes).
    Each input
    plane (fields, static planes, metric planes) read once over the cells
    of the tiles a launch computes, each output written once over the
    shard's box, the profile rows, one flag and one max per block."""
    nbytes = sum(shard_bytes(fs, i, j) for i in range(fs.px)
                 for j in range(fs.py))
    return nbytes / PEAK_BYTES * 1e3, nbytes


def shard_bytes(fs, i, j) -> int:
    """The bytes one launch of the raw form moves on shard (i, j) (see
    :func:`sharded_bound_ms`)."""
    n_out = 6 + 2 * fs.n_tracers
    tx, ty = fs.tile
    lay = fs.shard_lay[i][j]
    if fs.tile_wet[i][j] is None:
        done = lay.Xs * lay.Ys
    else:
        wet = fs.tile_wet[i][j].cpu().numpy().repeat(tx, 0).repeat(ty, 1)
        done = int((wet[:lay.Xs, :lay.Ys] > 0).sum())
    met = fs.met_shards[i][j]
    return (done * 4 * (n_out + fs.plane_shards[i][j].shape[0]
                        + (met.shape[0] if fs.metrics_2d else 0))
            + lay.nx * lay.ny * 4 * n_out
            + (0 if fs.metrics_2d else met.numel() * 4)
            + n_blocks(fs)[0] * n_blocks(fs)[1] * 8)


def time_sharded(fs, state, wet_pts: int, pts: int) -> dict:
    """ms/step of a sharded model's runner (exchange, one launch per
    shard, guard accumulation; median of three windows of N_TIME steps),
    and from a profiled window the raw kernel's device us per launch, the
    strip copies' device us per step and the device's busy time per
    step."""
    run = fs.make_runner(N_TIME)
    carry = fs.pack(state)
    lo, ms_path, hi = sorted(cuda_ms(lambda: run(carry), 1) / N_TIME
                             for _ in range(3))
    ev = profile_events(lambda: run(carry))
    kern = [(c, us) for k, (c, us) in ev.items()
            if any(n in k for n in FUSED_KERNELS)]
    check(bool(kern), "torch.profiler recorded no device time for the raw "
          "kernel")
    n_launch = sum(c for c, _ in kern)
    us_kernel = sum(us for _, us in kern) / n_launch
    copies = [(c, us) for k, (c, us) in ev.items()
              if "copy" in k.lower() or "memcpy" in k.lower()]
    us_copies = sum(us for _, us in copies) / N_TIME
    ms_dev = sum(us for _, us in ev.values()) / N_TIME / 1e3
    b_ms, nbytes = sharded_bound_ms(fs)
    return {"ms_path": ms_path, "ms_kernel": us_kernel / 1e3,
            "bound_ms": b_ms / (fs.px * fs.py),
            "text": (f"{ms_path:.4f} ms/step (windows {lo:.4f}-{hi:.4f}; "
                     f"{pts / ms_path * 1e3:.4e} points/s, "
                     f"{wet_pts / ms_path * 1e3:.4e} wet points/s), raw "
                     f"kernel {us_kernel:.2f} us/launch x "
                     f"{round(n_launch / N_TIME)} launches/step, strip copies "
                     f"{round(sum(c for c, _ in copies) / N_TIME)}/step "
                     f"{us_copies:.2f} us/step, device busy "
                     f"{ms_dev * 1e3:.1f} us/step (torch.profiler over one "
                     f"window), device idle "
                     f"{max(0.0, 1 - ms_dev / ms_path):.0%}, byte bound "
                     f"{b_ms * 1e3:.1f} us a turn of {fs.steps_per_call} "
                     f"step(s) ({nbytes / 1e6:.1f} MB), "
                     f"tiles {fs.n_tiles[0]} wet / {fs.n_tiles[1]} dry")}


def example_dir(tmp: str, example: str, name: str, sw_edits=None,
                parallel_edits=None, **edits) -> str:
    """A copy of ``examples/<example>`` under ``tmp`` whose data paths
    are absolute; ``edits``: 'old text' -> 'new text' in ocean_run.par,
    ``sw_edits`` the same in sw.par, ``parallel_edits`` in parallel.par."""
    src = os.path.join(REPO, "examples", example)
    dst = os.path.join(tmp, name)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("RESULTS",
                                                            "CHECKPOINTS"))
    path = os.path.join(dst, "basin.par")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace("../../data/", os.path.join(REPO, "data", "")))
    for par, changes in (("ocean_run.par", edits), ("sw.par", sw_edits),
                         ("parallel.par", parallel_edits)):
        path = os.path.join(dst, par)
        with open(path) as f:
            text = f.read()
        for old, new in (changes or {}).items():
            check(old in text, f"{par} has no line {old!r}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
    return dst


def run_main(argv) -> str:
    """``python -m ocean_model_arch_torch`` in-process; its output."""
    from ocean_model_arch_torch.__main__ import main as model_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = model_main(argv)
    check(rc == 0, f"main({argv}) returned {rc}")
    return buf.getvalue()


def timer_row(report: str, phase: str) -> tuple:
    """(total seconds, calls) of a phase in a TIMER REPORT."""
    m = re.search(rf"^{phase}\s+([0-9.]+)\s+(\d+)\s", report, re.M)
    check(m is not None, f"no {phase} row in the timer report")
    return float(m.group(1)), int(m.group(2))


def entry_point(card: str, name: str) -> None:
    """Phase 9b: the model's own entry point on examples/05_azov_hires."""
    from ocean_model_arch_torch.config import Precision
    from ocean_model_arch_torch.io import grads
    from ocean_model_arch_torch.io.checkpoint import load_checkpoint
    from ocean_model_arch_torch.model.fused import CARRIED, FusedSWModel
    from ocean_model_arch_torch.model.model import (OceanModel,
                                                    load_config_dir)
    from ocean_model_arch_torch.ops.fused_step import (fused_sw_step,
                                                       reset_launch_counts)
    with tempfile.TemporaryDirectory() as tmp:
        d = example_dir(tmp, "05_azov_hires", "full")
        full_ck = os.path.join(tmp, "full.npz")
        reset_launch_counts()
        out = run_main([d, "--f32", "--checkpoint", full_ck])
        counts = dict(fused_sw_step.form_launches)
        cfg = dataclasses.replace(load_config_dir(d),
                                  precision=Precision.f32())
        n_total, n_out = cfg.run.num_step_max, cfg.run.output_every_steps
        check((cfg.basin.nx, cfg.basin.ny) == (1525, 1115)
              and n_total == 604 and n_out == 60,
              f"examples/05_azov_hires is {cfg.basin.nx} x {cfg.basin.ny}, "
              f"{n_total} steps in windows of {n_out}")
        check("MODEL: compute path: fused CUDA kernel\n" in out,
              "the entry point did not take the fused CUDA kernel:\n"
              + "\n".join(ln for ln in out.splitlines() if "MODEL" in ln))
        # every window is even: two chained steps a launch, as JAX runs it
        key = (0, True, False, 0, False, False, 1, 1, 2, False, 7)
        n_launch = n_total // 2
        check(counts == {key: n_launch}, f"phase 9b: launches {counts}, "
              f"expected {n_launch} of {key}")
        final, step = load_checkpoint(full_ck)
        check(step == n_total and final.ssh.is_cuda,
              f"the checkpoint holds step {step} on {final.ssh.device}")
        # the same steps by hand
        model = OceanModel(cfg, base_dir=d)
        check(model.compute_path() == "fused CUDA kernel"
              and model.grid.lu.is_cuda, "OceanModel chose another route")
        fm = FusedSWModel(model.grid, cfg, cfg.run.tau, mu_const=0.0,
                          steps_per_call=2, static_rslu=True)
        s, ok = fm.run_steps(fm.pack(model.state), n_total)
        want = fm.unpack(s, model.state)
        check(ok, "phase 9b: the hand-driven run's guard tripped")
        for n in CARRIED + ("hhq", "hhu", "hhv", "hhh"):
            check(torch.equal(getattr(final, n), getattr(want, n)),
                  f"phase 9b: {n} of the entry point's final state differs "
                  "from FusedSWModel(steps_per_call=2).run_steps of the "
                  "same steps")
        n_rec = 1 + -(-n_total // n_out)
        res = os.path.join(d, "RESULTS")
        nx, ny = cfg.basin.nx, cfg.basin.ny
        check(os.path.getsize(os.path.join(res, "ssh.dat"))
              == n_rec * (nx - 4) * (ny - 4) * 4,
              "ssh.dat does not hold one record per window")
        last = torch.from_numpy(grads.read_record(
            os.path.join(res, "ssh.dat"), n_rec, nx, ny)).to(want.ssh.device)
        wet = model.grid.lu[2:-2, 2:-2] > 0.5
        check(torch.equal(last[2:-2, 2:-2][wet], want.ssh[2:-2, 2:-2][wet]),
              "the last record of ssh.dat differs from the final ssh")
        meta = grads.read_ctl(os.path.join(res, "ssh.ctl"))
        check((meta["nx"], meta["ny"], meta["nt"]) == (nx - 4, ny - 4, n_rec)
              and os.path.exists(os.path.join(res, "hhq.dat")),
              f"ssh.ctl says {meta}")
        t_step, n_win = timer_row(out, "model_step")
        t_out, n_outs = timer_row(out, "output")
        t_ck, _ = timer_row(out, "checkpoint")
        check(n_win == n_rec - 1 and n_outs == n_rec, "window counts")

        # half way with --checkpoint, then resumed
        half = example_dir(tmp, "05_azov_hires", "half", **{
            "0.007   : duration days": "0.003473 : duration days"})
        ck = os.path.join(tmp, "half.npz")
        run_main([half, "--f32", "--quiet", "--checkpoint", ck])
        _, at = load_checkpoint(ck)
        check(at == 300, f"the half-way checkpoint holds step {at}")
        resume = example_dir(tmp, "05_azov_hires", "resume", **{
            "0       : cold start": "1       : resume"})
        out_r = run_main([resume, "--f32", "--checkpoint", ck])
        check(f"MODEL: resumed from {ck} at step 300" in out_r,
              "the resumed run did not start from the checkpoint")
        resumed, step = load_checkpoint(ck)
        check(step == n_total, f"the resumed run ended at step {step}")
        for f in dataclasses.fields(final):
            a, b = getattr(final, f.name), getattr(resumed, f.name)
            check((a is None and b is None) or torch.equal(a, b),
                  f"phase 9b: {f.name} differs between the resumed and the "
                  "straight run")
    print(f"phase 9b entry point (python -m ocean_model_arch_torch "
          f"examples/05_azov_hires --f32, {nx} x {ny}): {n_total} steps in "
          f"windows of {n_out} on the fused CUDA kernel, two chained a "
          f"launch, launches={n_launch} of {key_text(key)}; {n_rec} GrADS "
          "records of ssh; final state == FusedSWModel(steps_per_call=2)"
          ".run_steps by hand bit for bit (6 fields and the depths): yes; "
          "ssh.dat's last record == final ssh on wet cells: "
          "yes; run to step 300 with --checkpoint, resumed to "
          f"{n_total} == the straight run bit for bit (every field of the "
          "checkpoint): yes")
    text = (f"model_step {t_step / n_total * 1e3:.4f} ms/step "
            f"({t_step:.4f} s in {n_win} windows of {n_launch} chained "
            "launches, pack and unpack "
            f"included), output {t_out:.4f} s in {n_outs} calls "
            f"({t_out / n_outs * 1e3:.1f} ms each), checkpoint {t_ck:.4f} s")
    print(f"phase 9b timing ({name}; {card}): {text}")


# phase 17: 20 steps of examples/05_azov_hires (its 604 cut), on a 4 x 2 mesh
MESH_EXAMPLE = "05_azov_hires"
MESH_STEPS = 20
PROFILE_STEPS = 5       # the steps of a profiled window of the f64 routes
MESH_DAYS = {"0.007   : duration days": "0.0002315 : duration days"}


def mesh_route(card: str, name: str, stats: dict) -> list:
    """Phase 17: ``OceanModel`` on a 4 x 2 mesh on the card. (a) ``main``
    on examples/05_azov_hires in f64 (the CLI's default) with ``--mesh
    4x2``: the eager sharded step (all 8 shards stacked on the card, in
    lockstep; no fused kernel launched), its cropped final state == the
    1 x 1 eager f64 run of the same steps bit for bit, ms/step of both;
    (b) the halo self-test on the padded extents (the same run at
    parallel.par's debug level 2, and once more by hand, timed); (c) the
    dynamic load balance through ``OceanModel.run`` in f32 (3 rounds of 2
    probe steps; the fused-sharded route, K1b's raw form), the rounds'
    ratios and the cuts it selects, the installed runner's 20 steps
    against the eager f32 composition on one block, K1b on those cuts
    against its plain version and timed beside uniform cuts. Returns the
    kernels line's entry of K1b on this path."""
    from ocean_model_arch_torch.config import Precision
    from ocean_model_arch_torch.io.checkpoint import load_checkpoint
    from ocean_model_arch_torch.model.fused_sharded2d import \
        FusedSharded2DModel
    from ocean_model_arch_torch.model.model import (OceanModel,
                                                    load_config_dir)
    from ocean_model_arch_torch.model.step import make_step, run_steps
    from ocean_model_arch_torch.ops.fused_step import (
        fused_sw_step, fused_sw_step_reference, reset_launch_counts)
    from ocean_model_arch_torch.parallel.domain import (pad_state,
                                                        padded_extents)
    from ocean_model_arch_torch.parallel.halo import halo_self_test
    from ocean_model_arch_torch.parallel.mesh import make_mesh, shard_tree
    with tempfile.TemporaryDirectory() as tmp:
        # ---- (a) + (b): f64 through main, 4 x 2 at debug level 2 -------
        d = example_dir(tmp, MESH_EXAMPLE, "mesh", parallel_edits={
            "0       : debug": "2       : debug"}, **MESH_DAYS)
        ck = os.path.join(tmp, "mesh.npz")
        reset_launch_counts()
        out = run_main([d, "--mesh", "4x2", "--checkpoint", ck])
        check(not fused_sw_step.form_launches, "phase 17a: the eager mesh "
              f"launched the fused kernel {dict(fused_sw_step.form_launches)}")
        check("MODEL: compute path: eager composition, sharded\n" in out,
              "phase 17a: main --mesh 4x2 (f64) took another route:\n"
              + "\n".join(ln for ln in out.splitlines() if "MODEL" in ln))
        check("SYNC INFO: halo self-test passed (4x2 mesh)" in out,
              "phase 17b: no halo self-test line at debug level 2")
        t_mesh, _ = timer_row(out, "model_step")
        d1 = example_dir(tmp, MESH_EXAMPLE, "block", **MESH_DAYS)
        ck1 = os.path.join(tmp, "block.npz")
        out1 = run_main([d1, "--checkpoint", ck1])
        check("MODEL: compute path: eager composition\n" in out1,
              "phase 17a: the 1 x 1 f64 run took another route")
        t_block, _ = timer_row(out1, "model_step")
        a, n_a = load_checkpoint(ck)
        b, n_b = load_checkpoint(ck1)
        check(n_a == n_b == MESH_STEPS, f"phase 17a: the runs ended at steps "
              f"{n_a} and {n_b}, not {MESH_STEPS}")
        nx, ny = a.ssh.shape
        basin = load_config_dir(d).basin
        check(a.ssh.is_cuda and a.ssh.dtype == torch.float64
              and (nx, ny) == (basin.nx, basin.ny)
              and bool(torch.isfinite(a.ssh).all())
              and float(a.ssh.abs().max()) > 0, "phase 17a: the mesh run's "
              f"ssh is {a.ssh.dtype} {tuple(a.ssh.shape)} on {a.ssh.device}")
        diffs = {f.name: float((getattr(a, f.name)
                                - getattr(b, f.name)).abs().max())
                 for f in dataclasses.fields(a)
                 if getattr(a, f.name) is not None}
        same = all(torch.equal(getattr(a, f), getattr(b, f)) for f in diffs)
        worst = max(diffs, key=diffs.get)
        print(f"phase 17a mesh route (python -m ocean_model_arch_torch "
              f"examples/{MESH_EXAMPLE} --mesh 4x2, f64, {nx} x {ny} padded "
              f"to {padded_extents(nx, ny, 4, 2)}): {MESH_STEPS} steps on the "
              "eager sharded step (8 shards stacked on the card, lockstep), "
              "no fused launch; the cropped final state == the 1 x 1 eager "
              f"f64 run bit for bit on all {len(diffs)} fields: "
              f"{'yes' if same else 'NO'}; largest difference "
              f"{diffs[worst]:.3e} ({worst})", flush=True)
        check(same, "phase 17a: the 4 x 2 mesh differs from the 1 x 1 run "
              f"(largest {diffs[worst]:.3e} in {worst})")
        # where a step's time goes on each route: one profiled window
        split = {}
        for px, py in ((4, 2), (1, 1)):
            cfg64 = load_config_dir(d1)
            cfg64 = dataclasses.replace(cfg64, parallel=dataclasses.replace(
                cfg64.parallel, mesh_x=px, mesh_y=py))
            m = OceanModel(cfg64, base_dir=d1)
            st = (shard_tree(pad_state(m.state, px, py), m.mesh)
                  if m.mesh is not None else m.state)
            runner = m._make_runner(PROFILE_STEPS)
            ev = profile_events(lambda: runner(st))
            busy = sum(us for _, us in ev.values()) / PROFILE_STEPS
            halo = sum(us for k, (_, us) in ev.items()
                       if "cat" in k.lower() or "pad" in k.lower())
            wall = cuda_ms(lambda: runner(st), 1) / PROFILE_STEPS
            split[px, py] = (
                f"{wall:.3f} ms/step (one window of {PROFILE_STEPS}), "
                f"device busy {busy / 1e3:.3f} ms/step, idle "
                f"{max(0.0, 1 - busy / 1e3 / wall):.0%}, "
                f"{sum(c for c, _ in ev.values()) / PROFILE_STEPS:.0f} "
                f"kernels/step, halo copies (cat, pad) "
                f"{halo / PROFILE_STEPS / 1e3:.3f} ms/step "
                f"({halo / PROFILE_STEPS / max(busy, 1e-9):.0%} of busy)")
            del m, st, runner
        tx, ty = padded_extents(nx, ny, 4, 2)
        t0 = time.perf_counter()
        halo_self_test(make_mesh(4, 2), tx, ty)
        t_halo = time.perf_counter() - t0
        print(f"phase 17b halo self-test: 4 x 2 shards of the padded "
              f"{tx} x {ty} extents on the card, every cell of every "
              "shard's exchanged block == the analytic i*j: yes (the main "
              f"run's own at debug level 2 passed too); {t_halo:.3f} s, the "
              "exchange and the host's check", flush=True)

        # ---- (c): the dynamic load balance through OceanModel.run -------
        dd = example_dir(tmp, MESH_EXAMPLE, "dlb", parallel_edits={
            "0       : dlb balance steps": "3       : dlb balance steps",
            "0       : dlb model steps": "2       : dlb model steps"},
            **MESH_DAYS)
        cfg = load_config_dir(dd)
        cfg = dataclasses.replace(
            cfg, precision=Precision.f32(), parallel=dataclasses.replace(
                cfg.parallel, mesh_x=4, mesh_y=2))
        model = OceanModel(cfg, base_dir=dd)
        s0 = model.state
        reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            final = model.run(verbose=True)
        text = buf.getvalue()
        counts = dict(fused_sw_step.form_launches)
        rounds = [ln for ln in text.splitlines() if ln.startswith("PREP:")]
        check(len(rounds) == 4 and "PREP: DLB selected cuts" in rounds[-1],
              f"phase 17c: the DLB lines are {rounds}")
        check(model.compute_path() == "fused CUDA kernel, sharded",
              f"phase 17c: the route is {model.compute_path()}")
        fs = model._fused_sh
        key = form_key(fs)
        # 3 rounds of one chained launch a shard, then the window's 10
        n_launch = (3 + MESH_STEPS // 2) * 8
        check(counts == {key: n_launch}, f"phase 17c: launches {counts}, "
              f"expected {n_launch} of {key}")
        ref, ok = run_steps(make_step(model.grid, cfg), s0, cfg.run.tau,
                            MESH_STEPS)
        check(ok, "phase 17c: the eager composition's guard tripped")
        errs = [rel_err(getattr(final, n), getattr(ref, n))
                for n in ("ssh", "ubrtr", "vbrtr")]
        check(max(errs) < TOL_EAGER, f"phase 17c: the DLB cuts' run vs the "
              f"eager composition rel errors {errs} exceed {TOL_EAGER}")
        print("phase 17c dynamic load balance (OceanModel.run, "
              f"examples/{MESH_EXAMPLE} --f32 --mesh 4x2, dlb 3 rounds of 2 "
              "probe steps): " + "; ".join(rounds) + f"; cuts x "
              f"{fs.x_edges.tolist()} y {fs.y_edges.tolist()}, tile "
              f"{fs.tile}, tiles {fs.n_tiles[0]} wet / {fs.n_tiles[1]} dry; "
              f"launches={n_launch} of {key_text(key)} (the probes' and the "
              f"window's); {MESH_STEPS} steps on the installed runner vs "
              f"the eager f32 composition on one block: rel {fmt(errs)} < "
              f"{TOL_EAGER}", flush=True)
        form = "fused_sw_step_raw_chain_dlb" + FOLD_SUFFIX[key[-1]]
        compare_raw("DLB cuts 4 x 2", fs, cfg, s0, stats, form,
                    phase="phase 17c")
        wet = int(model.grid.lu.sum())
        pts = nx * ny
        t = time_sharded(fs, s0, wet, pts)
        uni = FusedSharded2DModel(model.grid, cfg, cfg.run.tau, 4, 2,
                                  steps_per_call=2)
        t_uni = time_sharded(uni, s0, wet, pts)
        f_in = fs.pack(s0)[0].unbind(0)
        f_out = tuple(torch.zeros_like(v) for v in f_in)
        plain = cuda_ms(lambda: fused_sw_step_reference(
            f_in, *shard_args(fs, cfg, 0, 0), outs=f_out), 10)
    print(f"phase 17 timing ({name}; {card}): {MESH_EXAMPLE} f64 "
          f"model_step {t_mesh / MESH_STEPS * 1e3:.4f} ms/step on the 4 x 2 "
          f"eager mesh, {t_block / MESH_STEPS * 1e3:.4f} ms/step on the "
          f"1 x 1 eager block (the run's own timer, {MESH_STEPS} steps, one "
          f"window); profiled: 4 x 2 mesh {split[4, 2]} | 1 x 1 block "
          f"{split[1, 1]}; f32 4 x 2 chained, DLB cuts {t['text']} | uniform cuts "
          f"x {uni.x_edges.tolist()} y {uni.y_edges.tolist()} "
          f"{t_uni['text']}; plain version of the raw form on shard (0, 0) "
          f"{plain:.4f} ms/launch", flush=True)
    return [{"name": form, "route": "cuda", "source": CSRC + "fused_step.cu",
             "replaces": PALLAS + ":1652", "launches": n_launch,
             "max_abs_err": stats[form], "ms": t["ms_kernel"],
             "plain_ms": plain, "bound_ms": t["bound_ms"],
             "bound_by": "bytes", "library_ms": None,
             "loader": "tma" if not (fs.metrics_2d and fs.visc) else
             "threads"}]


# phase 18: the mesh across two processes on the card
PROC_TIMEOUT = 240      # seconds a group of processes may take, then killed
EAGER_STEPS, EAGER_HALF = 10, 4
EAGER_DAYS = {"0.007   : duration days": "0.00011575 : duration days"}
HALF_DAYS = {"0.007   : duration days": "0.0000463 : duration days"}


def spawn(cmds, what: str, timeout: int = PROC_TIMEOUT) -> list:
    """Start the commands together, wait for all of them (all killed past
    ``timeout`` seconds) and return their outputs; fails on a non-zero
    exit."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise SmokeFailure(f"{what}: a process did not end within "
                           f"{timeout} s")
    for k, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{what}: process {k} exited "
              f"{p.returncode}:\n{out[-3000:]}")
    return outs


def k1b_us(fs, cfg, carry, k: int, n: int) -> tuple:
    """The raw form on shard k of ``fs``, from ``carry``'s fields into
    scratch, n launches after one: (device us a launch from
    torch.profiler, us between launches from CUDA events, which the
    wrapper's host time sets when it exceeds the kernel's)."""
    from ocean_model_arch_torch.ops.fused_step import fused_sw_step_raw
    i, j = divmod(k, fs.py)
    f = carry[k].unbind(0)
    out = tuple(torch.zeros_like(a) for a in f)
    bm = torch.zeros(n_blocks(fs), device=carry[k].device)
    args = shard_args(fs, cfg, i, j)

    def launches():
        for _ in range(n):
            fused_sw_step_raw(f, out, bm, *args)
    dev = next(ms for name in FUSED_KERNELS
               if (ms := profile_device_ms(launches, name)[0]) is not None)
    return dev * 1e3, cuda_ms(launches, 1) / n * 1e3


def process_route(card: str, name: str, stats: dict) -> list:
    """Phase 18: the mesh across two processes on the card (Gloo, each
    strip staged through pinned host buffers; two processes cannot share
    a card under NCCL). (a) one process: ``FusedSharded2DModel`` 2 x 1 on
    the Azov coastline at 1525 x 1115 (f32, two steps a launch, the folds
    as the model defaults them) for the worker's 40 steps, K1b's launches
    counted, == the chained block bit for bit, K1b against its plain
    version; (b) the same over two processes of
    ``scripts/multiprocess_worker_torch.py azov_mask``, a shard each: ==
    (a) bit for bit, the guard tripping on both ranks on a NaN in rank
    1's shard; (c) NCCL where the host has two cards, and what Gloo (and,
    on one card, NCCL) does with CUDA tensors; (d) ``python -m
    ocean_model_arch_torch`` on ``examples/05_azov_hires`` in f64 on 2 x
    1 over two processes: 10 steps straight, and 4 with a sharded
    checkpoint then resumed to 10, == bit for bit, rank 0 printing the
    timer table reduced over both; the timing line: strip bytes a step,
    ms/step of one process and two, K1b us a launch in each. Returns the
    kernels line's entry of K1b on (a)'s path."""
    from ocean_model_arch_torch.diag.scaling import (
        cross_process_bytes_per_step, halo_bytes_per_step)
    from ocean_model_arch_torch.io.checkpoint import load_checkpoint_sharded
    from ocean_model_arch_torch.model.fused import FusedSWModel
    from ocean_model_arch_torch.model.fused_sharded2d import \
        FusedSharded2DModel
    from ocean_model_arch_torch.ops import fused_layout as fl
    from ocean_model_arch_torch.ops.fused_step import (
        fused_sw_step, fused_sw_step_reference, reset_launch_counts)
    mw = load_script("multiprocess_worker_torch")
    worker = os.path.join(REPO, "scripts", "multiprocess_worker_torch.py")
    t_phase = time.perf_counter()
    # ---- (a) one process ------------------------------------------------
    grid, cfg, state = mw.azov_workload("cuda")
    fs = FusedSharded2DModel(grid, cfg, cfg.run.tau, 2, 1, steps_per_call=2)
    key = form_key(fs)
    form = "fused_sw_step_raw_chain_2x1" + FOLD_SUFFIX[key[-1]]
    reset_launch_counts()
    c, ok = fs.make_runner(mw.AZOV_STEPS)(fs.pack(state))
    torch.cuda.synchronize()
    counts = dict(fused_sw_step.form_launches)
    n_launch = mw.AZOV_STEPS // 2 * 2
    check(ok and counts == {key: n_launch}, f"phase 18a: ok={ok}, launches "
          f"{counts}, expected {n_launch} of {key}")
    one = [f.clone() for f in fs.extract(c)]
    fm = FusedSWModel(grid, cfg, cfg.run.tau, static_rslu=True,
                      steps_per_call=2)
    s6, ok_b = fm.run_steps(fm.pack(state), mw.AZOV_STEPS)
    check(ok_b and all(torch.equal(a, fl.extract(fm.lay, b))
                       for a, b in zip(one, s6)),
          "phase 18a: the one-process 2 x 1 run differs from the block")
    compare_raw("azov_mask 2 x 1", fs, cfg, state, stats, form,
                phase="phase 18a")
    run = fs.make_runner(mw.TIME_STEPS)
    win1 = []
    for _ in range(3):
        t = time.perf_counter()
        c, ok_w = run(c)
        win1.append((time.perf_counter() - t) / mw.TIME_STEPS * 1e3)
        check(ok_w, "phase 18a: the guard tripped in a timed window")
    us1 = [k1b_us(fs, cfg, c, k, mw.N_K1B) for k in range(2)]
    bound = [shard_bytes(fs, i, 0) for i in range(2)]
    f_in = c[0].unbind(0)
    f_out = tuple(torch.zeros_like(v) for v in f_in)
    plain = cuda_ms(lambda: fused_sw_step_reference(
        f_in, *shard_args(fs, cfg, 0, 0), outs=f_out), 5)
    hbytes = halo_bytes_per_step(fs)
    del fm, s6, c, run
    with tempfile.TemporaryDirectory() as tmp:
        # ---- (b) two processes over Gloo, a shard each -----------------
        def group(tag, backend):
            out = os.path.join(tmp, tag)
            os.makedirs(out)
            t = time.perf_counter()
            outs = spawn([[sys.executable, worker, str(r), "2",
                           f"file://{out}/store", out, "azov_mask",
                           "--device", "cuda" if backend == "gloo" else
                           f"cuda:{r}", "--backend", backend]
                          for r in range(2)], f"phase 18 {tag}")
            wall = time.perf_counter() - t
            got = np.load(os.path.join(out, "azov.npz"))
            same = all(np.array_equal(got[str(k)], f.cpu().numpy())
                       for k, f in enumerate(one))
            infos = []
            for r in range(2):
                with open(os.path.join(out, f"azov-{r}.json")) as f:
                    infos.append(json.load(f))
            check(same, f"phase 18 {tag}: two processes differ from one")
            check(all(i["ok"] for i in infos), f"phase 18 {tag}: the guard "
                  "tripped in the run")
            check(all(i["guard_tripped"] for i in infos), f"phase 18 {tag}: "
                  "a NaN in rank 1's shard did not trip every rank")
            check(all(i["halo_bytes_per_step"] == hbytes for i in infos),
                  f"phase 18 {tag}: strip bytes differ from one process")
            return infos, wall, outs
        infos, wall, _ = group("gloo", "gloo")
        cross = infos[0]["cross_process_bytes_per_step"]
        print(f"phase 18b mesh across processes ({name}; {card}): "
              f"FusedSharded2DModel 2 x 1 on azov_mask 1525 x 1115, a shard "
              f"each of 2 processes of scripts/multiprocess_worker_torch.py "
              f"({infos[0]['transport']}): {mw.AZOV_STEPS} steps == one "
              f"process bit for bit on all {len(one)} fields: yes; a NaN at "
              f"cell {infos[1]['nan_at']} of rank 1's shard tripped the "
              "guard on both ranks: yes; spawn to exit "
              f"{wall:.1f} s (to the first result "
              + ", ".join(f"{i['seconds_to_first_result']:.1f}"
                          for i in infos) + " s a rank)", flush=True)
        # ---- (c) NCCL only where the host has two cards ----------------
        if torch.cuda.device_count() >= 2:
            infos_n, wall_n, _ = group("nccl", "nccl")
            nccl = (f"NCCL ({infos_n[0]['transport']}, a card a process, "
                    f"{', '.join(i['device'] for i in infos_n)}): == one "
                    "process bit for bit, guard on both ranks: yes; ms/step "
                    "(min/median/max) rank 0 "
                    f"{fmt(infos_n[0]['ms_per_step'])}, rank 1 "
                    f"{fmt(infos_n[1]['ms_per_step'])}; K1b us a launch "
                    "(device; between launches) "
                    + ", ".join(f"rank {r} {i['k1b_us']:.2f} "
                                f"({i['k1b_interval_us']:.2f})"
                                for r, i in enumerate(infos_n))
                    + f"; spawn to exit {wall_n:.1f} s")
        else:
            nccl = ("NCCL not run: the host has one card "
                    f"(torch.cuda.device_count() = "
                    f"{torch.cuda.device_count()})")
        # why the one card takes Gloo, staged: what each transport does
        # with CUDA tensors (NCCL with both processes on the one card)
        probe = os.path.join(tmp, "probe")
        os.makedirs(probe)
        met = {}
        for backend in ("gloo", "nccl") if torch.cuda.device_count() < 2 \
                else ("gloo",):
            try:
                spawn([[sys.executable, worker, str(r), "2",
                        f"file://{probe}/{backend}_store", probe,
                        "transport_probe", "--device", "cuda:0",
                        "--backend", backend] for r in range(2)],
                      f"phase 18c {backend} probe", timeout=90)
            except SmokeFailure as e:       # a hang is an answer too
                met[backend, "both"] = str(e).splitlines()[0]
                continue
            for r in range(2):
                with open(os.path.join(probe,
                                       f"probe-{backend}-{r}.json")) as f:
                    met[backend, r] = json.load(f)["error"]
        print(f"phase 18c {nccl}; what the transports do with CUDA tensors "
              "(two processes on cuda:0): " + "; ".join(
                  f"{b} rank {r}: " + (e if e else "no error")
                  for (b, r), e in met.items()), flush=True)
        # ---- (d) the eager route through main over two processes --------
        def main_cmds(d, ck, store):
            return [[sys.executable, "-m", "ocean_model_arch_torch", d,
                     "--mesh", "2x1", "--checkpoint", ck, "--ckpt-format",
                     "orbax", "--rank", str(r), "--world-size", "2",
                     "--init-method", f"file://{store}", "--backend",
                     "gloo"] for r in range(2)]
        d_s = example_dir(tmp, MESH_EXAMPLE, "straight", **EAGER_DAYS)
        d_h = example_dir(tmp, MESH_EXAMPLE, "half", **HALF_DAYS)
        d_r = example_dir(tmp, MESH_EXAMPLE, "resume", **{
            "0       : cold start": "1       : cold start", **EAGER_DAYS})
        ck_s, ck_h = os.path.join(tmp, "ck_straight"), os.path.join(
            tmp, "ck_half")
        t = time.perf_counter()
        outs = spawn(main_cmds(d_s, ck_s, os.path.join(tmp, "s_store"))
                     + main_cmds(d_h, ck_h, os.path.join(tmp, "h_store")),
                     "phase 18d straight and half")
        outs_r = spawn(main_cmds(d_r, ck_h, os.path.join(tmp, "r_store")),
                       "phase 18d resumed")
        wall_e = time.perf_counter() - t
        a, n_a = load_checkpoint_sharded(ck_s, device="cuda")
        b, n_b = load_checkpoint_sharded(ck_h, device="cuda")
        check(n_a == n_b == EAGER_STEPS, f"phase 18d: steps {n_a}, {n_b}")
        fields = [f.name for f in dataclasses.fields(a)
                  if getattr(a, f.name) is not None]
        same = all(torch.equal(getattr(a, n), getattr(b, n)) for n in fields)
        check(same and a.ssh.dtype == torch.float64
              and float(a.ssh.abs().max()) > 0, "phase 18d: the resumed "
              "run differs from the straight run")
        path = ("MODEL: compute path: eager composition, sharded (2 "
                "processes, gloo, staged through pinned host buffers)")
        check(all(path in o for o in outs + outs_r),
              "phase 18d: a process took another route:\n" + "\n".join(
                  ln for o in outs for ln in o.splitlines() if "MODEL" in ln))
        check(all("TIMER REPORT (2 processes, max/min over ranks)" in o
                  for o in (outs[0], outs[2], outs_r[0]))
              and "resumed from" in outs_r[0], "phase 18d: rank 0 printed no "
              "reduced timer table, or did not resume")
        step_row = re.search(r"^model_step\s+([0-9.]+)\s+([0-9.]+)",
                             outs[0], re.M)
        print(f"phase 18d eager route across processes (python -m "
              f"ocean_model_arch_torch examples/{MESH_EXAMPLE} --mesh 2x1 "
              "--ckpt-format orbax, f64, 2 processes each, Gloo): "
              f"{EAGER_STEPS} steps straight, and {EAGER_HALF} steps with a "
              f"sharded checkpoint resumed to {EAGER_STEPS}: == bit for bit "
              f"on all {len(fields)} fields: yes; rank 0 printed the timer "
              "table reduced over 2 processes (model_step max "
              f"{step_row.group(1)} s, min {step_row.group(2)} s, "
              f"straight run); 6 processes in {wall_e:.1f} s", flush=True)
    print(f"phase 18 timing ({name}; {card}): transport "
          f"{infos[0]['transport']}; margin strips {hbytes} bytes a model "
          f"step (diag/scaling.py::halo_bytes_per_step, "
          f"{cross} of them between the processes, "
          f"{infos[0]['strips_sent']} strips / {infos[0]['bytes_sent']} "
          f"bytes sent by rank 0 in its {mw.AZOV_STEPS} steps); ms/step "
          f"(windows of {mw.TIME_STEPS} steps, min/median/max): one process "
          f"{fmt(sorted(win1))}, two processes rank 0 "
          f"{fmt(infos[0]['ms_per_step'])}, rank 1 "
          f"{fmt(infos[1]['ms_per_step'])}; K1b us a launch of 2 steps "
          f"(device time, torch.profiler over {mw.N_K1B} launches; between "
          f"launches, CUDA events: the wrapper's host time; byte bound): "
          f"one process shard (0, 0) {us1[0][0]:.2f} ({us1[0][1]:.2f}), "
          f"(1, 0) {us1[1][0]:.2f} ({us1[1][1]:.2f}); two processes rank 0 "
          f"{infos[0]['k1b_us']:.2f} ({infos[0]['k1b_interval_us']:.2f}), "
          f"rank 1 {infos[1]['k1b_us']:.2f} "
          f"({infos[1]['k1b_interval_us']:.2f}) (each rank in turn); bound "
          f"{bound[0] / PEAK_BYTES * 1e6:.2f} / "
          f"{bound[1] / PEAK_BYTES * 1e6:.2f} us ({bound[0] / 1e6:.1f} / "
          f"{bound[1] / 1e6:.1f} MB); shards {fs.lx[0]} / {fs.lx[1]} x "
          f"{fs.ly[0]} rows, layout {fs.lay.Xs}x{fs.lay.Ys}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return [{"name": form, "route": "cuda", "source": CSRC + "fused_step.cu",
             "replaces": PALLAS + ":1652", "launches": n_launch,
             "max_abs_err": stats[form], "ms": sum(u for u, _ in us1) / 2e3,
             "plain_ms": plain, "bound_ms": sum(bound) / 2 / PEAK_BYTES * 1e3,
             "bound_by": "bytes", "library_ms": None, "loader": "tma"}]


def channel_mask(nx: int, ny: int) -> np.ndarray:
    """A zonal channel: 2-cell walls in y, open in x."""
    mask = np.zeros((nx, ny), np.int32)
    mask[:, :2] = mask[:, -2:] = 1
    return mask


def periodic_channel(card: str, name: str, stats: dict):
    """Phase 9c. Returns (the sharded model, its config, the initial
    state, launches on the path, the grid's wet points, the kernels-line
    name of its instantiation: OceanModel's, with the drivers' default
    folds)."""
    from ocean_model_arch_torch.host import (ModelConfig, Precision,
                                             SWConfig, basinpar_as250m_test)
    from ocean_model_arch_torch.config import RunConfig
    from ocean_model_arch_torch.io.mask_io import write_mask
    from ocean_model_arch_torch.model.init import init_ocean_state
    from ocean_model_arch_torch.model.model import OceanModel
    from ocean_model_arch_torch.model.step import make_step, run_steps
    from ocean_model_arch_torch.ops.fused_step import (fused_sw_step,
                                                       reset_launch_counts)
    nx, ny = 1536, 1115
    prec = Precision.f32()
    sw = SWConfig(use_tracers=1, tracer_num=N_TRACERS)
    run = RunConfig(run_duration_days=(N_MAIN + 0.5) / 86400.0,
                    loc_data_wr_period_min=-1.0)
    seam_max = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_mask(os.path.join(tmp, "channel.txt"), channel_mask(nx, ny),
                   "zonal channel")
        for periodic in (1, 0):
            basin = dataclasses.replace(
                basinpar_as250m_test(), nx=nx, periodicity_x=periodic,
                mask_file_name="channel.txt")
            cfg = ModelConfig(basin=basin, sw=sw, run=run, precision=prec)
            check(cfg.run.num_step_max == N_MAIN, "channel run length")
            model = OceanModel(cfg, base_dir=tmp)
            grid = model.grid
            # a bump beside the seam, its edge 6 cells from it, exactly 0
            # in the low columns
            i = torch.arange(nx, device=grid.lu.device)[:, None]
            j = torch.arange(ny, device=grid.lu.device)[None, :]
            r2 = ((i - (nx - 30)) ** 2 + (j - ny // 2) ** 2).float()
            ssh0 = torch.where(r2 < 24.0 ** 2,
                               0.5 * torch.exp(-r2 / (2 * 8.0 ** 2)), 0.0)
            model.state = state = init_ocean_state(grid, cfg, ssh0 * grid.lu)
            check(float(state.ssh[:8].abs().max()) == 0.0
                  and float(state.ssh[-60:].abs().max()) > 0.4,
                  "the bump is not beside the seam")
            want_path = ("fused CUDA kernel, periodic (1x1 wrap)" if periodic
                         else "fused CUDA kernel")
            check(model.compute_path() == want_path,
                  f"phase 9c: route {model.compute_path()!r}")
            reset_launch_counts()
            final = model.run(verbose=False)
            counts = dict(fused_sw_step.form_launches)
            seam_max[periodic] = float(final.ssh[:8].abs().max())
            if not periodic:
                continue
            fs = model._fused_per
            key = form_key(fs)
            check((fs.px, fs.py) == (1, 1) and key[5]
                  and counts == {key: N_MAIN},
                  f"phase 9c: launches {counts}, expected {N_MAIN} of {key}")
            ref, eok = run_steps(make_step(grid, cfg), state, 1.0, N_MAIN)
            check(eok, "phase 9c: the eager composition's guard tripped")
            errs = {n: rel_err(getattr(final, n), getattr(ref, n))
                    for n in ("ssh", "ubrtr", "vbrtr")}
            for t in range(N_TRACERS):
                errs[f"ff[{t}]"] = rel_err(final.ff[t], ref.ff[t])
            check(max(errs.values()) < TOL_EAGER,
                  f"phase 9c vs eager composition: rel errors {errs}")
            form = "fused_sw_step_raw_" + form_name(fs)[14:]
            check(form == "fused_sw_step_raw_tracers_folds",
                  f"phase 9c: the channel runs {form}")
            keep = (fs, cfg, state, sum(counts.values()),
                    int((grid.lu > 0.5).sum()), form)
            compare_raw("channel 1536 x 1115 periodic x, T=2", fs, cfg,
                        state, stats, form)
    check(seam_max[1] > 0.0 and seam_max[0] == 0.0,
          f"phase 9c: max |ssh| in the first 8 columns {seam_max}")
    print(f"phase 9c periodic channel ({nx} x {ny}, periodic in x, walls "
          f"in y, {N_TRACERS} tracers) through OceanModel on "
          f"FusedSharded2DModel(1, 1): {N_MAIN} steps ok, launches="
          f"{keep[3]} of {key_text(form_key(keep[0]))} (one step a launch, "
          "as JAX runs the periodic 1 x 1 route); vs eager composition "
          "rel err "
          + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
          + f" < {TOL_EAGER}; max |ssh| in the first 8 columns "
          f"{seam_max[1]:.3e} (periodic), {seam_max[0]:.1e} (closed: the "
          "signal crossed the seam only when it is one)")
    return keep


def launcher_host_us(mine, theirs, n: int = 10000) -> str:
    """Host us a call of the fused step's C launcher alone (the TMA maps'
    encoding and cache, the launch), with the arguments one wrapper call
    passes it, on the 70 x 52 island basin (kernels of a few us, so the
    host sets the pace), against the parent's: ``n`` calls a window, two
    windows a side in the order parent, this, this, parent; forms T = 0
    one step unguarded and T = 2 chained guarded."""
    from ocean_model_arch_torch.config import basinpar_flat
    from ocean_model_arch_torch.core.grid import build_grid
    from ocean_model_arch_torch.host import Precision, frame_of_land_mask
    from ocean_model_arch_torch.model.fused import FusedSWModel
    from ocean_model_arch_torch.model.init import init_ocean_state
    basin = basinpar_flat(70, 52, curve_grid=1, rlon=27.5, rlat=41.0)
    grid = build_grid(basin, frame_of_land_mask(70, 52),
                      precision=Precision.f32())
    out = []
    for n_tr, spc, guard in ((0, 1, False), (2, 2, True)):
        cfg = form_cfg(basin, Precision.f32(), n_tr, 1, 1)
        fm = FusedSWModel(grid, cfg, 1.0, static_rslu=True,
                          steps_per_call=spc, tile_guard=guard)
        s = fm.pack(init_ocean_state(grid, cfg))
        args = model_args(fm, cfg)
        code = mine.fold_code(mine.kernel_folds(fm.folds, spc, fm.ffs))
        calls = {}
        for side, mod in (("P", theirs), ("T", mine)):
            lib = mod._library(n_tr, False, 1, 1, spc, None, False, code)
            real, seen = lib.fused_sw_step_launch, []
            lib.fused_sw_step_launch = lambda *a: (seen.append(a),
                                                   real(*a))[1]
            try:
                mod.fused_sw_step_blockmax(s, *args)
            finally:
                lib.fused_sw_step_launch = real
            calls[side] = (real, seen[0])
        us = {"P": [], "T": []}
        for side in "PTTP":
            fn, a = calls[side]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn(*a)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            us[side].append((t1 - t0) / n * 1e6)
        out.append(f"{key_text(form_key(fm))} this {min(us['T']):.3f} us a "
                   f"call, parent {min(us['P']):.3f} (windows "
                   f"{', '.join(f'{u:.3f}' for u in us['T'] + us['P'])})")
    return ("the C launcher alone on the host (the fastest of two windows "
            f"of {n} calls a side): " + "; ".join(out))


def sharded_2x2(tag, grid, cfg, mu, stats, form, spc=1, phase=None,
                static_rslu=True):
    """Phase 9d on one configuration: 2 x 2 shards on the one card, with
    uniform and with weighted cuts, against the single block, bit for
    bit, both at ``spc`` steps a launch (phase 11c: 2, chained, on margins
    of 6 or 8); the guard on a NaN in each shard's interior and in its
    pad. Returns {cuts: (model, launches)} and the initial state.
    ``phase``: the lines' tag, if not that of phase 9d or 11c.
    ``static_rslu``: both models' (False: the general form)."""
    from ocean_model_arch_torch.model.fused import FusedSWModel
    from ocean_model_arch_torch.model.fused_sharded2d import \
        FusedSharded2DModel
    from ocean_model_arch_torch.model.init import init_ocean_state
    state = with_mu(init_ocean_state(grid, cfg), mu)
    phase = phase or ("phase 9d" if spc == 1 else "phase 11c")
    fm = FusedSWModel(grid, cfg, 1.0, mu_const=mu, steps_per_call=spc,
                      static_rslu=static_rslu, **UNFOLDED)
    s, ok1 = fm.run_steps(fm.pack(state), N_MAIN)
    from ocean_model_arch_torch.ops import fused_layout as fl
    want = [fl.extract(fm.lay, a) for a in s]
    out = {}
    for cuts in ("uniform", "weighted"):
        fs = FusedSharded2DModel(grid, cfg, 1.0, 2, 2, mu_const=mu,
                                 weighted=cuts == "weighted",
                                 steps_per_call=spc, static_rslu=static_rslu,
                                 **UNFOLDED)
        check(fs.general == fm.general, f"{phase} {tag}: the shards run "
              "another form than the single block")
        compare_raw(f"{tag}, {cuts} cuts", fs, cfg, state, stats, form, phase)
        got, ok, n = run_sharded(f"{phase} {tag} {cuts}", fs, state, N_MAIN)
        check(ok == ok1 and ok, f"{phase} {tag} {cuts}: ok={ok}, single "
              f"block {ok1}")
        diffs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        rels = [rel_err(a, b) for a, b in zip(got, want)]
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        if not same:
            print(f"{phase} {tag} {cuts}: NOT bit-identical; max abs "
                  f"difference per field {diffs}, relative {rels}")
        check(same, f"{phase} {tag} {cuts}: the shards differ from the "
              f"single block (max abs {max(diffs):.3e})")
        # the guard: a NaN inside each shard trips it, one in a pad not
        run2 = fs.make_runner(2)
        for k in range(4):
            i, j = divmod(k, 2)
            lu = grid.lu[fs.x_edges[i]:fs.x_edges[i + 1],
                         fs.y_edges[j]:fs.y_edges[j + 1]]
            check(bool(lu.sum() > 0), f"shard ({i}, {j}) has no wet cell")
            cell = torch.nonzero(lu > 0.5)[int(lu.sum()) // 2]
            bad = list(fs.pack(state))
            bad[k][0, fs.M + int(cell[0]), fs.M + int(cell[1])] = \
                float("nan")
            check(not run2(bad)[1], f"{phase} {tag} {cuts}: ok stayed "
                  f"True with a NaN inside shard ({i}, {j})")
            bad = list(fs.pack(state))
            bad[k][0, -1, -1] = float("nan")
            check(run2(bad)[1], f"{phase} {tag} {cuts}: a NaN in the pad "
                  f"of shard ({i}, {j}) tripped the guard")
        out[cuts] = (fs, n)
        print(f"{phase} {tag}, 2 x 2 shards, {cuts} cuts x "
              f"{fs.x_edges.tolist()} y {fs.y_edges.tolist()} (shards of "
              f"{fs.lay.Xs}x{fs.lay.Ys}, tiles {fs.n_tiles[0]} wet / "
              f"{fs.n_tiles[1]} dry): {N_MAIN} steps ok={ok} launches={n} "
              f"of {key_text(form_key(fs))}, {len(fs._plan)} strip copies "
              f"an exchange, {N_MAIN // fs.steps_per_call} exchanges; all "
              f"{len(got)} fields == the single-block FusedSWModel run bit "
              "for bit: yes; guard trips on a NaN inside each shard and "
              "not on one in its pad: yes")
    return out, state


# ---- phase 10: the forms without advection and with a linear free surface

# (trans_terms, full_free_surface) of each new form, and its name
NEW_FORMS = {"notrans": (0, 1), "linear": (1, 0), "notrans_linear": (0, 0)}


def form_cfg(basin, prec, n_tracers: int, trans: int, ffs: int,
             ksw_lat: int = 1):
    from ocean_model_arch_torch.host import ModelConfig, SWConfig
    return ModelConfig(basin=basin, sw=SWConfig(
        use_tracers=int(n_tracers > 0), tracer_num=max(n_tracers, 1),
        trans_terms=trans, full_free_surface=ffs, ksw_lat=ksw_lat),
        precision=prec)


def compare_new_forms(grids, basin, basin_b, prec, stats) -> int:
    """Phase 10a: every instantiation of the three new (advection, free
    surface) forms against the plain version, as phase 2 holds the old
    ones (T = 0 and 2, guard off and on: profile metrics on the coastline,
    plane metrics on ``bipolar_azov``, each inviscid on flat bathymetry
    and with mu = 1000 over the 15-100 m planes), and its raw form on 2 x
    2 shards (``azov_visc`` with 2 tracers, ``bipolar_azov`` without) as
    phase 9a does. Returns the number of forms compared."""
    from ocean_model_arch_torch.model.fused_sharded2d import \
        FusedSharded2DModel
    from ocean_model_arch_torch.model.init import init_ocean_state
    n = 0
    for form, (trans, ffs) in NEW_FORMS.items():
        def cfgs(b):
            return {t: form_cfg(b, prec, t, trans, ffs)
                    for t in (0, N_TRACERS)}
        for mname, gname, b, mu in (
                (f"azov {form}", "azov", basin, 0.0),
                (f"bipolar_azov {form}", "bipolar_azov", basin_b, 0.0),
                (f"azov {form} mu=1000 15-100 m", "azov_hr", basin, MU),
                (f"bipolar_azov {form} mu=1000 15-100 m", "bipolar_azov_hr",
                 basin_b, MU)):
            compare_forms(mname, grids[gname], cfgs(b), stats, mu)
            n += 4
        for gname, b, n_tr, mu in (("azov_hr", basin, N_TRACERS, MU),
                                   ("bipolar_azov", basin_b, 0, 0.0)):
            cfg = form_cfg(b, prec, n_tr, trans, ffs)
            fs = FusedSharded2DModel(grids[gname], cfg, 1.0, 2, 2,
                                     mu_const=mu, **UNFOLDED)
            state = with_mu(init_ocean_state(grids[gname], cfg), mu)
            compare_raw(f"{gname} {form} T={n_tr} mu={mu:g}", fs, cfg, state,
                        stats, "fused_sw_step_raw_" + form_name(fs)[14:])
            n += 1
    return n


def new_form_paths(grids, basin, basin_b, prec, wet, pts, card, name, run):
    """Phase 10b: the new forms' main paths at 1525 x 1115, each driven
    like phase 5 (``drive_path``: 200 steps, its own instantiation only,
    against the eager composition), then timed: the kernel path, the
    kernel's device time, the byte bound and the copy step of the form.
    ``run``: the dicts the kernels line is made from (launches, kernels,
    plain_ms) and the list of ``bounds`` entries, filled here."""
    from ocean_model_arch_torch.ops import copy_step as cs
    from ocean_model_arch_torch.ops.fused_step import (
        fused_sw_step_reference, general_geometry)
    probe = load_script("roofline_probe_torch")
    paths = (
        ("main path azov_notrans", "azov coastline, trans_terms = 0, "
         "ksw_lat = 0, no tracers", "azov",
         form_cfg(basin, prec, 0, 0, 1, ksw_lat=0), 0.0,
         "fused_sw_step_notrans_guarded"),
        ("main path bipolar_azov_notrans", "the same on the bipolar grid's "
         "metric planes", "bipolar_azov",
         form_cfg(basin_b, prec, 0, 0, 1, ksw_lat=0), 0.0,
         "fused_sw_step_notrans_fast2d"),
        ("main path azov_linear", f"azov coastline, full_free_surface = 0, "
         f"{N_TRACERS} tracers", "azov",
         form_cfg(basin, prec, N_TRACERS, 1, 0), 0.0,
         "fused_sw_step_linear_tracers"),
        ("sub-path azov_linear_visc", "azov_linear over 15-100 m bathymetry "
         f"with mu = {MU:g}", "azov_hr",
         form_cfg(basin, prec, N_TRACERS, 1, 0), MU,
         "fused_sw_step_linear_visc_bathy_tracers"))
    texts = []
    for label, what, gname, cfg, mu, want in paths:
        fm, _, s0, n, _ = drive_path(f"phase 10b {label} ({what})",
                                     grids[gname], cfg, None, mu)
        form = form_name(fm)
        check(form == want and fm.tile_guard, f"{label} ran {form}, "
              f"guard {fm.tile_guard}, not {want} guarded")
        if fm.metrics_2d:
            check(fm.met.shape[0] == 4, f"{label} streams "
                  f"{fm.met.shape[0]} metric planes, not 4")
        run["launches"][form] = n
        t = time_path(fm, cfg, s0, wet[gname], pts)
        windows, met = copy_step_inputs(fm, s0)
        us_copy = probe.kernel_us(lambda: cs.copy_step(
            windows, met, len(s0), fm.lay, tracer_form=fm.n_tracers > 0,
            tile_wet=fm.tile_wet, tile=fm.tile, visc_form=fm.visc), N_TIME)
        b_ms, b_by, nbytes = bound_ms(fm, fm.n_tracers)
        run["plain_ms"][form] = cuda_ms(
            lambda: fused_sw_step_reference(s0, *model_args(fm, cfg)), 10)
        run["kernels"][form] = (fm, fm.n_tracers, t)
        run["bounds"].append(
            f"{label.split()[-1]}/T={fm.n_tracers}/guard on: "
            f"kernel {t['ms_kernel'] * 1e3:.1f} us, {nbytes / 1e6:.1f} MB, "
            f"bound {b_ms * 1e3:.1f} us ({b_by}), copy step of its form "
            f"{us_copy:.1f} us")
        texts.append(f"{label.split()[-1]} <"
                     + ",".join(str(int(k)) for k in form_key(fm)) + "> "
                     + t["text"] + f"; byte bound {b_ms * 1e3:.1f} us "
                     f"({nbytes / 1e6:.1f} MB); copy step of its form "
                     f"{us_copy:.1f} us/launch; plain fused version "
                     f"{run['plain_ms'][form]:.4f} ms/step")
    print(f"phase 10b timing ({name}; {card}), wet points {wet['azov']} of "
          f"{pts}: " + " | ".join(texts))


def grads_records(d: str, nx: int, ny: int, n_rec: int) -> int:
    """Every GrADS record under ``d``/RESULTS holds finite float32 values
    (land is the finite undef), ``n_rec`` records a field; returns the
    number of fields."""
    res = os.path.join(d, "RESULTS")
    dats = sorted(f for f in os.listdir(res) if f.endswith(".dat"))
    check("ssh.dat" in dats, f"no ssh.dat in {res}")
    for f in dats:
        a = np.fromfile(os.path.join(res, f), np.float32)
        check(a.size % ((nx - 4) * (ny - 4)) == 0
              and a.size // ((nx - 4) * (ny - 4)) in (1, n_rec),
              f"{f}: {a.size} values, not records of {nx - 4} x {ny - 4}")
        check(bool(np.isfinite(a).all()), f"{f} holds a value that is not "
              "finite")
    return len(dats)


def only_form(tag: str, counts: dict) -> tuple:
    """(the one instantiation in a run's launch counts, its launches)."""
    check(len(counts) == 1, f"{tag}: launches {counts}, not of one "
          "instantiation")
    return next(iter(counts.items()))


# phase 10c runs each shipped directory's first 124 of its 604 steps (its
# windows of 60 steps and a last of 4, cut to 60, 60, 4): the eager
# composition by hand at full size is most of the phase
SHIPPED_STEPS = 124
SHIPPED_DAYS = {"0.007   : duration days": "0.001436 : duration days"}


def shipped_examples(card, name, stats, run) -> None:
    """Phase 10c: every shipped run directory ``examples/0*`` through
    ``main`` with ``--f32`` on a copy in a temporary directory: the route
    (the fused CUDA kernel for all six), one launch a step of the run's
    instantiation and no other, finite GrADS records, the final state
    against the eager composition run by hand on the card;
    ``04_black_sea`` also as shipped (f64, the eager route) against the
    same by hand; ``01_flat_basin --mesh 2x2`` (the raw form without
    advection) == the 1 x 1 run bit for bit, its raw kernel against the
    plain version and timed."""
    from ocean_model_arch_torch.config import Precision
    from ocean_model_arch_torch.io.checkpoint import load_checkpoint
    from ocean_model_arch_torch.model.fused import CARRIED
    from ocean_model_arch_torch.model.model import (OceanModel,
                                                    load_config_dir)
    from ocean_model_arch_torch.model.step import make_step, run_steps
    from ocean_model_arch_torch.ops.fused_step import (
        fused_sw_step, fused_sw_step_reference, reset_launch_counts)

    examples = sorted(e for e in os.listdir(os.path.join(REPO, "examples"))
                      if e[:2].isdigit())
    check(len(examples) == 6, f"shipped run directories {examples}")
    fields = CARRIED + ("hhq", "hhu", "hhv", "hhh")

    def through_main(tmp, ex, dst, *flags):
        """main on a copy of ``ex`` cut to SHIPPED_STEPS: (run directory,
        output, launch counts, config as run, final state, steps)."""
        d = example_dir(tmp, ex, dst, **SHIPPED_DAYS)
        ck = os.path.join(tmp, dst + ".npz")
        reset_launch_counts()
        out = run_main([d, *flags, "--checkpoint", ck])
        counts = dict(fused_sw_step.form_launches)
        cfg = load_config_dir(d)
        if "--f32" in flags:
            cfg = dataclasses.replace(cfg, precision=Precision.f32())
        final, step = load_checkpoint(ck)
        check(step == cfg.run.num_step_max == SHIPPED_STEPS
              and final.ssh.is_cuda,
              f"{dst}: the checkpoint holds step {step} on "
              f"{final.ssh.device}")
        return d, out, counts, cfg, final, step

    def against_eager(tag, d, cfg, final, step, tol):
        model = OceanModel(cfg, base_dir=d)
        ref, eok = run_steps(make_step(model.grid, cfg), model.state,
                             cfg.run.tau, step)
        check(bool(eok), f"{tag}: the eager composition's guard tripped")
        names = ("ssh", "ubrtr", "vbrtr") + (("ff",) if cfg.sw.use_tracers
                                             else ())
        errs = {n: rel_err(getattr(final, n), getattr(ref, n))
                for n in names}
        check(max(errs.values()) <= tol, f"{tag} vs eager composition: "
              f"rel errors {errs}")
        return model, ref, errs

    lines, finals = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for ex in examples:
            d, out, counts, cfg, final, step = through_main(
                tmp, ex, ex, "--f32")
            nx, ny = cfg.basin.nx, cfg.basin.ny
            check("MODEL: compute path: fused CUDA kernel\n" in out,
                  f"{ex} did not take the fused CUDA kernel:\n" + "\n".join(
                      ln for ln in out.splitlines() if "compute path" in ln))
            key, n = only_form(ex, counts)
            # windows of 60 and a last of 4: two chained steps a launch
            check(n == step // 2 and key[6:] == (
                cfg.sw.trans_terms, cfg.sw.full_free_surface, 2, False,
                7 if cfg.sw.full_free_surface else 3),
                f"{ex}: launches {counts} for {step} steps")
            n_out = cfg.run.output_every_steps
            n_rec = 1 + -(-step // n_out)
            n_dat = grads_records(d, nx, ny, n_rec)
            _, _, errs = against_eager(ex, d, cfg, final, step, TOL_EAGER)
            finals[ex] = final
            lines.append(f"{ex} ({nx} x {ny}, trans_terms "
                         f"{cfg.sw.trans_terms}, tracers "
                         f"{cfg.sw.tracer_num if cfg.sw.use_tracers else 0}"
                         f"): {step} steps, launches={n} of "
                         f"{key_text(key)}, {n_dat} "
                         f"GrADS fields x {n_rec} records finite; vs eager "
                         "composition rel err " + ", ".join(
                             f"{k} {e:.2e}" for k, e in errs.items()))
        print("phase 10c shipped run directories (main --f32, compute path: "
              "fused CUDA kernel for all six): " + " | ".join(lines)
              + f"; every error < {TOL_EAGER}")

        # 04_black_sea as shipped: f64, the eager composition
        d, out, counts, cfg, final, step = through_main(
            tmp, "04_black_sea", "04_black_sea_f64")
        check("MODEL: compute path: eager composition\n" in out
              and not counts and final.ssh.dtype == torch.float64,
              f"04_black_sea f64: route or launches {counts}")
        grads_records(d, cfg.basin.nx, cfg.basin.ny,
                      1 + -(-step // cfg.run.output_every_steps))
        _, _, errs = against_eager("04_black_sea f64", d, cfg, final, step,
                                   1e-12)
        f32 = finals["04_black_sea"]
        gap = {n: rel_err(getattr(f32, n).double(), getattr(final, n))
               for n in ("ssh", "ubrtr", "vbrtr", "ff")}
        print(f"phase 10c 04_black_sea as shipped (f64, compute path: eager "
              f"composition, no kernel launch): {step} steps, GrADS records "
              "finite; vs the eager composition by hand rel err "
              + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
              + " <= 1e-12; the f32 fused run against it: rel err "
              + ", ".join(f"{k} {e:.2e}" for k, e in gap.items()))

        # 01_flat_basin on 2 x 2 shards: the raw form without advection
        d, out, counts, cfg, final, step = through_main(
            tmp, "01_flat_basin", "01_flat_basin_2x2", "--f32", "--mesh",
            "2x2")
        check("MODEL: compute path: fused CUDA kernel, sharded\n" in out,
              "01_flat_basin --mesh 2x2 did not take the sharded kernel")
        key, n = only_form("01_flat_basin 2x2", counts)
        check(n == 4 * (step // 2) and key[5] and key[6] == 0
              and key[8] == 2,
              f"01_flat_basin 2x2: launches {counts} for {step} steps")
        one = finals["01_flat_basin"]
        same = [f for f in fields if torch.equal(getattr(final, f),
                                                 getattr(one, f))]
        check(len(same) == len(fields), "01_flat_basin 2x2: "
              f"{sorted(set(fields) - set(same))} differ from the 1 x 1 run")
        model = OceanModel(dataclasses.replace(cfg, parallel=dataclasses
                                               .replace(cfg.parallel,
                                                        mesh_x=2, mesh_y=2)),
                           base_dir=d)
        wet_pts = int((model.grid.lu > 0.5).sum())
        texts = []
        # the runner main built (two chained steps a launch), then the
        # rebuild an odd window makes (one step a launch, the same cuts)
        for n_inner in (2, 1):
            model._make_runner(n_inner)
            fs = model._fused_sh
            form = "fused_sw_step_raw_" + form_name(fs)[14:]
            check(form == ("fused_sw_step_raw_notrans_guarded_folds"
                           if n_inner == 1 else
                           "fused_sw_step_raw_chain_notrans_guarded_folds_share"),
                  f"the 2 x 2 runner is {form}")
            if n_inner == 2:
                check(tuple(key) == form_key(fs),
                      f"the 2 x 2 run launched {key}, not {form_key(fs)}")
                launched = n
            else:
                _, _, launched = run_sharded(
                    "01_flat_basin 2 x 2, one step a launch", fs,
                    model.state, 20)
            compare_raw("01_flat_basin 2 x 2", fs, cfg, model.state, stats,
                        form)
            t = time_sharded(fs, model.state, wet_pts,
                             cfg.basin.nx * cfg.basin.ny)
            f_in = fs.pack(model.state)[0].unbind(0)
            f_out = tuple(torch.zeros_like(a) for a in f_in)
            run["plain_ms"][form] = cuda_ms(lambda: fused_sw_step_reference(
                f_in, *shard_args(fs, cfg, 0, 0), outs=f_out), 10)
            run["launches"][form] = launched
            run["kernels"][form] = (fs, 0, t)
            run["bounds"].append(
                f"01_flat_basin 2 x 2, raw form, {fs.steps_per_call} "
                f"step(s) a launch: kernel {t['ms_kernel'] * 1e3:.1f} "
                f"us/launch, bound {t['bound_ms'] * 1e3:.1f} us/launch "
                "(bytes), copy step not measured")
            texts.append(f"{key_text(form_key(fs))} {t['text']}")
    print(f"phase 10c 01_flat_basin --f32 --mesh 2x2 (main, compute path: "
          f"fused CUDA kernel, sharded): {step} steps, launches={n} of "
          f"{key_text(key)}; final state == the 1 x 1 run bit for bit "
          f"({len(fields)} fields): yes; timing ({name}; {card}): "
          + " | ".join(texts))


# ---- phase 11: two chained model steps a launch ---------------------------

def guard_sees_step_a(fm, s0, cell, where: str) -> None:
    """Phase 11's guard on a chained model: an sshp spike of 1.5e4 at the
    wet ``cell`` puts |ssh| above the 1e4 bound after the first step of a
    launch and below it after the second (checked on two single-step
    launches of the plain version), and the chained ``run_steps`` of one
    launch trips; so does a NaN there."""
    from ocean_model_arch_torch.ops import sw_kernels as swk
    from ocean_model_arch_torch.ops.fused_step import fused_sw_step_reference
    args1 = model_args(fm, fm.cfg)[:13] + (1, fm.general, fm.folds)
    for val in (1.5e4, float("nan")):
        bad = tuple(f.clone() for f in s0)
        bad[1][cell] = val
        if val == val:
            a, ma = fused_sw_step_reference(bad, *args1)
            _, mb = fused_sw_step_reference(a, *args1)
            check(float(ma) >= swk.SSH_ERR_BOUND > float(mb),
                  f"guard ({where}): the spike gives max |ssh| {float(ma)} "
                  f"after the first step, {float(mb)} after the second")
        _, gok = fm.run_steps(bad, 2)
        check(not gok, f"guard ({where}): ok stayed True with sshp = {val} "
              "in the first step of a chained launch")


def chained_paths(grids, cfgs, cfgs_b, basin, basin_b, prec, wet, pts, card,
                  name, run, stats, single):
    """Phase 11: the chained forms (two model steps a launch). (a) every
    chained instantiation phases 2 and 10a hold, against its plain
    version: one launch within 1e-5, 25 carried launches (50 steps)
    within 1e-4, land and all-land tiles exactly 0, guarded == unguarded
    bit for bit; and its raw forms on 2 x 2 shards; (b) the chained paths
    ``azov_mask``, ``azov_tracers``, ``bipolar_azov`` and ``azov_visc``,
    200 steps each in 100 launches of their own instantiation, against
    the eager composition < 3e-4, the guard on a value that only the
    first step of a launch holds, and their timing beside the same form's
    single-step kernel of this run (``single``: form -> (model, timing));
    (c) ``azov_visc`` and ``bipolar_azov`` on 2 x 2 shards at two steps a
    launch == the chained single block bit for bit, half the strip
    copies a step; (d) the chained copy step exactly against its plain
    version, and timed. ``run`` collects the kernels line's entries."""
    from ocean_model_arch_torch.model.fused_sharded2d import \
        FusedSharded2DModel
    from ocean_model_arch_torch.model.init import init_ocean_state
    from ocean_model_arch_torch.ops import copy_step as cs
    from ocean_model_arch_torch.ops.fused_step import fused_sw_step_reference
    probe = load_script("roofline_probe_torch")
    # (a) every chained instantiation phases 2 and 10a hold
    n_forms = 0
    for mname, gname, c, mu in (
            ("frame", "frame", cfgs, 0.0), ("azov", "azov", cfgs, 0.0),
            ("bipolar_azov", "bipolar_azov", cfgs_b, 0.0),
            ("azov mu=1000", "azov", cfgs, MU),
            ("azov 15-100 m", "azov_hr", cfgs, 0.0),
            ("azov mu=1000 15-100 m", "azov_hr", cfgs, MU),
            ("bipolar_azov mu=1000 15-100 m", "bipolar_azov_hr", cfgs_b,
             MU)):
        compare_forms(mname, grids[gname], c, stats, mu, spc=2)
        n_forms += 2 * len(c)
    cfg1 = {1: dataclasses.replace(cfgs[N_TRACERS], sw=dataclasses.replace(
        cfgs[N_TRACERS].sw, tracer_num=1))}
    cfg_diff = {N_TRACERS: dataclasses.replace(
        cfgs[N_TRACERS], sw=dataclasses.replace(cfgs[N_TRACERS].sw,
                                                ksw_lat=0))}
    for mname, gname, c, mu in (
            ("azov", "azov", cfg1, 0.0),
            ("azov mu=1000 ksw_lat=0", "azov", cfg_diff, MU),
            ("bipolar_azov mu=1000", "bipolar_azov", {0: cfgs_b[0]}, MU)):
        compare_forms(mname, grids[gname], c, stats, mu, spc=2)
        n_forms += 2
    for form, (trans, ffs) in NEW_FORMS.items():
        def new_cfgs(b):
            return {t: form_cfg(b, prec, t, trans, ffs)
                    for t in (0, N_TRACERS)}
        for mname, gname, b, mu in (
                (f"azov {form}", "azov", basin, 0.0),
                (f"bipolar_azov {form}", "bipolar_azov", basin_b, 0.0),
                (f"azov {form} mu=1000 15-100 m", "azov_hr", basin, MU),
                (f"bipolar_azov {form} mu=1000 15-100 m", "bipolar_azov_hr",
                 basin_b, MU)):
            compare_forms(mname, grids[gname], new_cfgs(b), stats, mu, spc=2)
            n_forms += 4
        for gname, b, n_tr, mu in (("azov_hr", basin, N_TRACERS, MU),
                                   ("bipolar_azov", basin_b, 0, 0.0)):
            cfg = form_cfg(b, prec, n_tr, trans, ffs)
            fs = FusedSharded2DModel(grids[gname], cfg, 1.0, 2, 2,
                                     mu_const=mu, steps_per_call=2,
                                     **UNFOLDED)
            state = with_mu(init_ocean_state(grids[gname], cfg), mu)
            compare_raw(f"{gname} {form} T={n_tr} mu={mu:g}", fs, cfg, state,
                        stats, "fused_sw_step_raw_" + form_name(fs)[14:])
            n_forms += 1
    print(f"phase 11a kernel vs plain: {n_forms} chained forms (profile and "
          "plane metrics, T = 0, 1, 2, guard off and on, mu 0 and 1000 over "
          "flat and 15-100 m bathymetry, with and without advection, full "
          "and linear free surface, raw on 2 x 2 shards) within "
          f"{TOL_ONE} after 1 launch and {TOL_CARRY} after "
          f"{N_CARRY // 2} launches ({N_CARRY} steps); land and all-land "
          "tiles exactly 0; guarded == unguarded bit for bit")

    # (b) the chained paths at full width
    paths = (("azov_mask", "azov coastline, no tracers", "azov", cfgs[0],
              0.0, "fused_sw_step_chain_guarded"),
             ("azov_tracers", f"azov coastline, {N_TRACERS} tracers",
              "azov", cfgs[N_TRACERS], 0.0, "fused_sw_step_chain_tracers"),
             ("bipolar_azov", "the coastline on the bipolar grid",
              "bipolar_azov", cfgs_b[0], 0.0, "fused_sw_step_chain_fast2d"),
             ("azov_visc", f"15-100 m, mu = {MU:g}, {N_TRACERS} tracers",
              "azov_hr", cfgs[N_TRACERS], MU,
              "fused_sw_step_chain_visc_bathy_tracers"))
    lu = grids["azov"].lu
    ij = torch.nonzero(lu > 0.5).double()
    centre = torch.tensor([basin.nx / 2, basin.ny / 2], dtype=ij.dtype,
                          device=ij.device)
    ci, cj = (int(v) for v in ij[((ij - centre) ** 2).sum(1).argmin()])
    texts = []
    for label, what, gname, cfg, mu, want in paths:
        fm, _, s0, n, _ = drive_path(f"phase 11b main path {label} "
                                     f"chained ({what})", grids[gname], cfg,
                                     None, mu, spc=2)
        form = form_name(fm)
        check(form == want and fm.tile_guard and n == N_MAIN // 2,
              f"{label} ran {form} {n} times, guard {fm.tile_guard}")
        cell = (fm.lay.margin + ci, fm.lay.margin + cj)
        guard_sees_step_a(fm, s0, cell, f"{label} chained")
        t = time_path(fm, cfg, s0, wet[gname], pts)
        windows, met = copy_step_inputs(fm, s0)
        flags = fm.tile_wet
        for tw in (None, flags):
            got = cs.copy_step(windows, met, len(s0), fm.lay,
                               fm.n_tracers > 0, tw, fm.tile, fm.visc, 2)
            ref = cs.copy_step_reference(windows, met, len(s0), fm.lay, tw,
                                         fm.tile)
            torch.cuda.synchronize()
            stats["copy_step_chain"] = max(
                [stats.get("copy_step_chain", 0.0)]
                + [float((a - b).abs().max()) for a, b in zip(got, ref)])
            check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                  f"chained copy step ({label}): kernel and plain differ")
        if label == "azov_mask":
            run["plain_ms"]["copy_step_chain"] = cuda_ms(
                lambda: cs.copy_step_reference(windows, met, len(s0), fm.lay,
                                               flags, fm.tile), 20)
        us_copy = probe.kernel_us(
            lambda: cs.copy_step(windows, met, len(s0), fm.lay,
                                 fm.n_tracers > 0, flags, fm.tile, fm.visc,
                                 2), N_TIME)
        b_ms, b_by, nbytes = bound_ms(fm, fm.n_tracers)
        run["launches"][form] = n
        run["kernels"][form] = (fm, fm.n_tracers, t)
        run["plain_ms"][form] = cuda_ms(
            lambda: fused_sw_step_reference(s0, *model_args(fm, cfg)), 10)
        run["copy_chain"][label] = us_copy
        one_m, one_t = single[label]
        b1_ms, _, _ = bound_ms(one_m, one_m.n_tracers)
        run["bounds"].append(
            f"{label} chained: kernel {t['ms_kernel'] * 1e3:.1f} us a launch "
            f"of 2 steps, {nbytes / 1e6:.1f} MB, bound {b_ms * 1e3:.1f} us "
            f"({b_by}), chained copy step {us_copy:.1f} us; one step a "
            f"launch {one_t['ms_kernel'] * 1e3:.1f} us, bound "
            f"{b1_ms * 1e3:.1f} us")
        texts.append(
            f"{label} {key_text(form_key(fm))} {t['text']}; kernel "
            f"{t['ms_kernel'] * 5e2:.2f} us a model step (one step a launch "
            f"{one_t['ms_kernel'] * 1e3:.2f}, path {one_t['ms_path']:.4f} "
            f"ms/step); byte bound {b_ms * 1e3:.1f} us a launch "
            f"({nbytes / 1e6:.1f} MB; one step a launch {b1_ms * 1e3:.1f}); "
            f"chained copy step {us_copy:.1f} us/launch; plain chained "
            f"version {run['plain_ms'][form]:.4f} ms/launch")
    print(f"phase 11b guard: ok=False on an sshp spike of 1.5e4 that only "
          f"the first step of a launch holds above 1e4, and on a NaN, at "
          f"wet cell ({ci}, {cj}) of each chained path")
    print(f"phase 11b timing ({name}; {card}), wet points {wet['azov']} of "
          f"{pts}: " + " | ".join(texts))

    # (c) 2 x 2 shards at two steps a launch
    sh_v, st_v = sharded_2x2(
        f"azov_visc chained (mu = {MU:g}, 15-100 m, {N_TRACERS} tracers)",
        grids["azov_hr"], cfgs[N_TRACERS], MU, stats,
        "fused_sw_step_raw_chain_visc_bathy_tracers", spc=2)
    sh_b, st_b = sharded_2x2(
        "bipolar_azov chained (plane metrics, no tracers)",
        grids["bipolar_azov"], cfgs_b[0], 0.0, stats,
        "fused_sw_step_raw_chain_fast2d", spc=2)
    texts = []
    for label, sh, st, cfg, form in (
            ("azov_visc", sh_v, st_v, cfgs[N_TRACERS],
             "fused_sw_step_raw_chain_visc_bathy_tracers"),
            ("bipolar_azov", sh_b, st_b, cfgs_b[0],
             "fused_sw_step_raw_chain_fast2d")):
        check(len(sh["uniform"][0]._plan) == 8
              and sh["uniform"][0].M == fl_margin(2, sh["uniform"][0]),
              f"{label}: {len(sh['uniform'][0]._plan)} strips, margin "
              f"{sh['uniform'][0].M}")
        for cuts in ("uniform", "weighted"):
            fs, n = sh[cuts]
            t = time_sharded(fs, st, wet["azov"], pts)
            texts.append(f"{label}/2 x 2/{cuts} cuts {t['text']}")
            if cuts == "uniform":
                check(form == "fused_sw_step_raw_" + form_name(fs)[14:],
                      f"{label}: the shards ran {form_name(fs)}")
                run["launches"][form] = n
                run["kernels"][form] = (fs, fs.n_tracers, t)
                f_in = fs.pack(st)[0].unbind(0)
                f_out = tuple(torch.zeros_like(a) for a in f_in)
                run["plain_ms"][form] = cuda_ms(
                    lambda: fused_sw_step_reference(
                        f_in, *shard_args(fs, cfg, 0, 0), outs=f_out), 10)
                run["bounds"].append(
                    f"{label} 2 x 2 uniform, raw form chained: kernel "
                    f"{t['ms_kernel'] * 1e3:.1f} us/launch, bound "
                    f"{t['bound_ms'] * 1e3:.1f} us/launch (bytes)")
    print(f"phase 11c timing ({name}; {card}): " + " | ".join(texts))


# ---- phase 12: any number of tracers ---------------------------------------

T_LOOP = (3, 4)        # counts of the run-time tracer family held everywhere
T_PATH = 4             # phase 12's main path
# past the chained form's shared-memory fit (8 tracers, 7 viscous): some
# of step A's tracer levels in device scratch
T_PAST, T_PAST_VISC = 9, 8


def many_tracer_forms(grids, basin, basin_b, prec, stats) -> int:
    """Phase 12a: the run-time tracer family (T >= 3) against its plain
    version as phase 2 holds the others, at one step and two chained a
    launch: profile and plane metrics, guard off and on, mu 0 and 1000
    over flat and 15-100 m bathymetry, the diffusive fluxes alone,
    without advection and with a linear free surface; the chained form
    past its shared-memory fit; and raw forms on 2 x 2 shards. Returns the
    number of forms compared."""
    from ocean_model_arch_torch.model.fused_sharded2d import \
        FusedSharded2DModel
    from ocean_model_arch_torch.model.init import init_ocean_state
    n = 0
    for spc in (1, 2):
        for mname, gname, b, mu, trans, ffs, ksw, counts in (
                ("azov", "azov", basin, 0.0, 1, 1, 1, T_LOOP),
                ("bipolar_azov", "bipolar_azov", basin_b, 0.0, 1, 1, 1,
                 T_LOOP),
                ("azov mu=1000 15-100 m", "azov_hr", basin, MU, 1, 1, 1,
                 T_LOOP),
                ("bipolar_azov mu=1000 15-100 m", "bipolar_azov_hr",
                 basin_b, MU, 1, 1, 1, (3,)),
                ("azov mu=1000 ksw_lat=0", "azov", basin, MU, 1, 1, 0, (3,)),
                ("azov notrans", "azov", basin, 0.0, 0, 1, 1, (3,)),
                ("azov linear", "azov", basin, 0.0, 1, 0, 1, (4,))):
            compare_forms(mname, grids[gname], {
                t: form_cfg(b, prec, t, trans, ffs, ksw) for t in counts},
                stats, mu, spc, "phase 12a")
            n += 2 * len(counts)
    compare_forms("azov", grids["azov"], {T_PAST: form_cfg(
        basin, prec, T_PAST, 1, 1)}, stats, 0.0, 2, "phase 12a")
    compare_forms("azov mu=1000 15-100 m", grids["azov_hr"], {
        T_PAST_VISC: form_cfg(basin, prec, T_PAST_VISC, 1, 1)}, stats, MU, 2,
        "phase 12a")
    n += 4
    for gname, b, n_tr, mu, trans, ffs, spc in (
            ("azov_hr", basin, 4, MU, 1, 1, 1),
            ("azov_hr", basin, 4, MU, 1, 1, 2),
            ("bipolar_azov", basin_b, 3, 0.0, 1, 1, 2),
            ("azov", basin, 3, 0.0, 0, 1, 2),
            ("azov", basin, 4, 0.0, 1, 0, 1)):
        cfg = form_cfg(b, prec, n_tr, trans, ffs)
        fs = FusedSharded2DModel(grids[gname], cfg, 1.0, 2, 2, mu_const=mu,
                                 steps_per_call=spc, **UNFOLDED)
        state = with_mu(init_ocean_state(grids[gname], cfg), mu)
        compare_raw(f"{gname} T={n_tr} mu={mu:g} trans={trans} ffs={ffs}",
                    fs, cfg, state, stats,
                    "fused_sw_step_raw_" + form_name(fs)[14:], "phase 12a")
        n += 1
    return n


def many_tracer_entry_point(card: str, name: str) -> None:
    """Phase 12c: ``main`` on a copy of ``examples/05_azov_hires`` with
    ``T_PATH`` tracers (its sw.par edited), on the single block and on a
    2 x 2 mesh: the route, the launches (of the folded chained form, the
    drivers' default; phase 15 holds it against its plain version), finite
    GrADS records, and the
    final state of each == ``FusedSWModel(steps_per_call=2).run_steps`` by
    hand, bit for bit."""
    from ocean_model_arch_torch.config import Precision
    from ocean_model_arch_torch.io.checkpoint import load_checkpoint
    from ocean_model_arch_torch.model.fused import CARRIED, FusedSWModel
    from ocean_model_arch_torch.model.model import (OceanModel,
                                                    load_config_dir)
    from ocean_model_arch_torch.ops.fused_step import (
        Folds, fold_code, fused_sw_step, reset_launch_counts)
    sw = {"0       : tracers": "1       : tracers",
          "1       : tracer_num": f"{T_PATH}       : tracer_num"}
    fields = CARRIED + ("ff", "ffp", "hhq", "hhu", "hhv", "hhh")
    texts = []
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for mesh in ("", "2x2"):
            d = example_dir(tmp, "05_azov_hires", "tracers" + mesh,
                            sw_edits=sw)
            ck = os.path.join(tmp, f"tracers{mesh}.npz")
            reset_launch_counts()
            out = run_main([d, "--f32", "--checkpoint", ck]
                           + (["--mesh", mesh] if mesh else []))
            counts = dict(fused_sw_step.form_launches)
            route = "fused CUDA kernel" + (", sharded" if mesh else "")
            check(f"MODEL: compute path: {route}\n" in out,
                  f"phase 12c ({mesh or 'block'}) did not take the {route}:"
                  "\n" + "\n".join(ln for ln in out.splitlines()
                                    if "compute path" in ln))
            final, step = load_checkpoint(ck)
            key, n = only_form(f"phase 12c {mesh or 'block'}", counts)
            check(key[0] == T_PATH and key[8] == 2
                  and bool(key[5]) == bool(mesh)
                  and key[10] == fold_code(Folds(True, True, True))
                  and n == (4 if mesh else 1) * step // 2,
                  f"phase 12c ({mesh or 'block'}): launches {counts} for "
                  f"{step} steps")
            runs[mesh] = (d, out, final, step, key, n)
        d, out, final, n_total, key, n = runs[""]
        cfg = dataclasses.replace(load_config_dir(d),
                                  precision=Precision.f32())
        nx, ny = cfg.basin.nx, cfg.basin.ny
        check((nx, ny, n_total) == (1525, 1115, 604)
              and cfg.sw.use_tracers == 1 and cfg.sw.tracer_num == T_PATH,
              f"phase 12c: {nx} x {ny}, {n_total} steps, tracers "
              f"{cfg.sw.use_tracers} x {cfg.sw.tracer_num}")
        n_rec = 1 + -(-n_total // cfg.run.output_every_steps)
        n_dat = grads_records(d, nx, ny, n_rec)
        model = OceanModel(cfg, base_dir=d)
        fm = FusedSWModel(model.grid, cfg, cfg.run.tau, mu_const=0.0,
                          steps_per_call=2, static_rslu=True)
        s, ok = fm.run_steps(fm.pack(model.state), n_total)
        want = fm.unpack(s, model.state)
        check(ok and fm.n_tracers == T_PATH, "phase 12c: the hand-driven "
              "run's guard tripped")
        for mesh, (_, out_m, got, _, key_m, n_m) in runs.items():
            for f in fields:
                check(torch.equal(getattr(got, f), getattr(want, f)),
                      f"phase 12c ({mesh or 'block'}): {f} differs from "
                      "FusedSWModel(steps_per_call=2).run_steps by hand")
            t_step, _ = timer_row(out_m, "model_step")
            texts.append(f"{'2 x 2 mesh' if mesh else 'block'}: launches="
                         f"{n_m} of {key_text(key_m)}, model_step "
                         f"{t_step / n_total * 1e3:.4f} ms/step")
    print(f"phase 12c entry point (python -m ocean_model_arch_torch "
          f"examples/05_azov_hires --f32 with '1 : tracers', '{T_PATH} : "
          f"tracer_num' in sw.par, {nx} x {ny}, {n_total} steps; {card}): "
          f"compute path 'fused CUDA kernel' (', sharded' with --mesh 2x2); "
          f"{n_dat} GrADS fields x {n_rec} records finite; the final state "
          f"({len(fields)} fields, {T_PATH} tracers) of each == "
          "FusedSWModel(steps_per_call=2).run_steps by hand bit for bit: "
          "yes; " + " | ".join(texts))


def many_tracer_paths(grids, basin, basin_b, prec, wet, pts, card, name,
                      run, stats) -> dict:
    """Phase 12b: the paths at full width with ``T_PATH`` tracers and their
    sub-paths, each 200 steps against the eager composition on its own
    instantiation, and timed; 2 x 2 shards at ``T_PATH``, chained, == the
    block bit for bit. ``run`` collects the kernels line's entries.
    Returns (grid, tracers, steps a launch) -> (model, packed initial
    fields, timing) of the paths."""
    from ocean_model_arch_torch.model.fused import FusedSWModel
    from ocean_model_arch_torch.model.init import init_ocean_state
    from ocean_model_arch_torch.ops import copy_step as cs
    from ocean_model_arch_torch.ops.fused_step import (
        fused_sw_step_reference, general_geometry)
    probe = load_script("roofline_probe_torch")
    paths = (
        ("main path azov_tracers4 chained", f"azov coastline, {T_PATH} "
         "tracers, two steps a launch", "azov", basin, T_PATH, 0.0, 2),
        ("main path azov_tracers4", f"azov coastline, {T_PATH} tracers, "
         "one step a launch", "azov", basin, T_PATH, 0.0, 1),
        ("sub-path azov_tracers3 chained", "azov coastline, 3 tracers",
         "azov", basin, 3, 0.0, 2),
        ("sub-path azov_visc4 chained", f"15-100 m, mu = {MU:g}, {T_PATH} "
         "tracers", "azov_hr", basin, T_PATH, MU, 2),
        ("sub-path bipolar_azov_tracers3 chained", "the coastline on the "
         "bipolar grid, 3 tracers", "bipolar_azov", basin_b, 3, 0.0, 2))
    models, texts = {}, []
    for label, what, gname, b, n_tr, mu, spc in paths:
        cfg = form_cfg(b, prec, n_tr, 1, 1)
        fm, _, s0, n, _ = drive_path(f"phase 12b {label} ({what})",
                                     grids[gname], cfg, None, mu, spc)
        check(fm.tile_guard and fm.n_tracers == n_tr,
              f"{label}: guard {fm.tile_guard}, {fm.n_tracers} tracers")
        form = form_name(fm)
        t = time_path(fm, cfg, s0, wet[gname], pts)
        run["launches"][form] = n
        run["kernels"][form] = (fm, n_tr, t)
        run["plain_ms"][form] = cuda_ms(
            lambda: fused_sw_step_reference(s0, *model_args(fm, cfg)), 10)
        models[gname, n_tr, spc] = (fm, s0, t)
        texts.append(f"{label} {key_text(form_key(fm))} "
                     f"{t['text']}; plain version "
                     f"{run['plain_ms'][form]:.4f} ms/launch")

    # 2 x 2 shards at T_PATH, chained
    cfg4 = form_cfg(basin, prec, T_PATH, 1, 1)
    form_r = f"fused_sw_step_raw_chain_tracers{T_PATH}"
    sh, st = sharded_2x2(f"azov_tracers4 chained ({T_PATH} tracers)",
                         grids["azov"], cfg4, 0.0, stats, form_r, spc=2,
                         phase="phase 12b")
    fs, n = sh["uniform"]
    check(form_r == "fused_sw_step_raw_" + form_name(fs)[14:],
          f"the shards ran {form_name(fs)}")
    t_sh = {c: time_sharded(sh[c][0], st, wet["azov"], pts)
            for c in ("uniform", "weighted")}
    run["launches"][form_r] = n
    run["kernels"][form_r] = (fs, T_PATH, t_sh["uniform"])
    f_in = fs.pack(st)[0].unbind(0)
    f_out = tuple(torch.zeros_like(a) for a in f_in)
    run["plain_ms"][form_r] = cuda_ms(lambda: fused_sw_step_reference(
        f_in, *shard_args(fs, cfg4, 0, 0), outs=f_out), 10)
    print(f"phase 12b timing ({name}; {card}), wet points {wet['azov']} of "
          f"{pts}: " + " | ".join(texts + [f"2 x 2 {c} cuts {t['text']}"
                                          for c, t in t_sh.items()]))
    return models


def many_tracer_timing(grids, basin, prec, wet, pts, card, name, run,
                       models) -> None:
    """Phase 12d: T = 0..4 on the guarded coastline at one step and two
    chained a launch (the paths of phase 12b where they ran), each kernel
    beside its byte bound and the copy step of its form, and the path;
    then T_PAST, whose chained form keeps some tracer levels in device
    scratch."""
    from ocean_model_arch_torch.model.fused import FusedSWModel
    from ocean_model_arch_torch.model.init import init_ocean_state
    from ocean_model_arch_torch.ops import copy_step as cs
    from ocean_model_arch_torch.ops.fused_step import chain_smem
    probe = load_script("roofline_probe_torch")
    texts = []
    for n_tr in range(T_PATH + 1):
        cfg = form_cfg(basin, prec, n_tr, 1, 1)
        for spc in (1, 2):
            if ("azov", n_tr, spc) in models:
                fm, s0, t = models["azov", n_tr, spc]
            else:
                fm = FusedSWModel(grids["azov"], cfg, 1.0, steps_per_call=spc,
                                  static_rslu=True, **UNFOLDED)
                s0 = fm.pack(init_ocean_state(grids["azov"], cfg))
                t = time_path(fm, cfg, s0, wet["azov"], pts)
            windows, met = copy_step_inputs(fm, s0)
            us_copy = probe.kernel_us(lambda: cs.copy_step(
                windows, met, len(s0), fm.lay, n_tr, fm.tile_wet, fm.tile,
                fm.visc, spc), N_TIME)
            b_ms, b_by, nbytes = bound_ms(fm, n_tr)
            head = (f"kernel {t['ms_kernel'] * 1e3:.1f} us a launch, byte "
                    f"bound {b_ms * 1e3:.1f} us ({nbytes / 1e6:.1f} MB, "
                    f"{b_by}), copy step of its form {us_copy:.1f} us")
            texts.append(f"T={n_tr}/{spc} step(s) a launch "
                         f"{key_text(form_key(fm))}: {head}; path "
                         + t["text"])
            run["bounds"].append(f"azov T={n_tr} {spc} step(s) a launch: "
                                 + head)
    # past the fit: the chained form with levels in device scratch
    cfg = form_cfg(basin, prec, T_PAST, 1, 1)
    for spc in (1, 2):
        fm = FusedSWModel(grids["azov"], cfg, 1.0, steps_per_call=spc,
                          static_rslu=True, **UNFOLDED)
        s0 = fm.pack(init_ocean_state(grids["azov"], cfg))
        us = probe.kernel_us(lambda: fm.run_steps(s0, spc), N_TIME // 4,
                             "fused_sw_step_kernel")
        b_ms, _, nbytes = bound_ms(fm, T_PAST)
        smem, levels = chain_smem(T_PAST)
        texts.append(f"T={T_PAST}/{spc} step(s) a launch "
                     f"{key_text(form_key(fm))}: kernel {us:.1f} us a "
                     f"launch, byte bound {b_ms * 1e3:.1f} us "
                     f"({nbytes / 1e6:.1f} MB)" + (
                         "" if spc == 1 else
                         f", {levels} of {2 * T_PAST} tracer levels in "
                         f"{smem / 1024:.1f} KB of shared memory"))
    print(f"phase 12d timing ({name}; {card}), azov coastline, guard on, "
          f"wet points {wet['azov']} of {pts}: " + " | ".join(texts))


# ---- phase 13: the general form ---------------------------------------------

# the general form's (tracers, mu, ksw_lat) of each mu mode: 0 none, 1 the
# tracers' diffusive fluxes alone, 2 the stress stages; T_LOOP[0] stands
# for the run-time tracer family
GEN_MODES = tuple((t, m, k) for t in (0, 1, 2, T_LOOP[0])
                  for m, k in ((0.0, 1), (MU, 0), (MU, 1)) if t or k)


def general_name(fm) -> str:
    """The entry of the kernels line a general-form model's instantiation
    counts under: ``fused_sw_step[_raw]_general`` and the features of
    ``form_name`` (``planes`` for metric planes, ``static`` for their
    static reciprocal counts)."""
    forms = ("_chain" * (fm.steps_per_call == 2) + "_notrans" * (not fm.trans)
             + "_linear" * (not fm.ffs))
    mode = form_key(fm)[3]
    feats = "".join("_" + w for w, on in (
        ("visc", fm.visc), ("diff", mode == 1),
        ("tracers" + f"{fm.n_tracers}" * (fm.n_tracers > N_TRACERS),
         fm.n_tracers > 0),
        ("planes", fm.metrics_2d),
        ("static", fm.metrics_2d and fm.static_rslu)) if on)
    return ("fused_sw_step" + "_raw" * hasattr(fm, "shard_lay") + "_general"
            + forms + (feats or "_guarded" * bool(fm.tile_guard)))


def with_form(model, cfg, mu: float):
    """A shallow copy of a general-form model (single block or shards)
    that runs the form of ``cfg`` with the viscosity ``mu``, as its
    constructor would set it: the general form's statics depend on the
    grid, the tracer count and the steps a launch only, so one build
    serves every (advection, free surface, mu) form of them."""
    m = copy.copy(model)
    m.cfg, m.mu_const = cfg, float(mu)
    m.visc = bool(cfg.sw.ksw_lat and m.mu_const != 0.0)
    m.trans = int(cfg.sw.trans_terms > 0)
    m.ffs = int(cfg.sw.full_free_surface > 0)
    return m


def general_models(grid, cfg, mu: float, spc: int, one=None) -> dict:
    """Phase 13a's models of one (grid, tracer count, steps a launch),
    built by their constructors: the single general block and, on metric
    planes, its static reciprocal twin, guarded; the 2 x 2 general shards;
    the land masks of the carried fields and the all-land tiles' cells.
    ``one``: the same at one step a launch, whose block and twin serve two
    steps a launch too (the chained tile is the same; the shards' margin
    is not)."""
    from ocean_model_arch_torch.model.fused import FusedSWModel
    from ocean_model_arch_torch.model.fused_sharded2d import \
        FusedSharded2DModel
    from ocean_model_arch_torch.ops.fused_step import tile_shape
    fs = FusedSharded2DModel(grid, cfg, 1.0, 2, 2, mu_const=mu,
                             steps_per_call=spc, static_rslu=False)
    if one is not None:
        out = dict(one, shards=fs)
        for k in ("block", "static"):
            if one[k] is not None:
                out[k] = copy.copy(one[k])
                out[k].steps_per_call = spc
                check(out[k].tile == tile_shape(grid.lu.device, spc),
                      "phase 13a: the chained tile is not the one-step tile")
        return out
    fm = FusedSWModel(grid, cfg, 1.0, mu_const=mu, steps_per_call=spc,
                      tile_guard=True)
    check(fm.general and fm.n_tiles[1] > 0,
          "phase 13a: not the general form, or no all-land tile")
    fst = (FusedSWModel(grid, cfg, 1.0, mu_const=mu, steps_per_call=spc,
                        tile_guard=True, static_rslu=True, fast2d=False)
           if fm.metrics_2d else None)
    check((fst is None or fst.general) and fs.general,
          "phase 13a: a twin or the shards are not the general form")
    tx, ty = fm.tile
    dry = (fm.tile_wet == 0).repeat_interleave(tx, 0) \
        .repeat_interleave(ty, 1)[:fm.lay.Xs, :fm.lay.Ys]
    return {"block": fm, "static": fst, "shards": fs, "dry": dry,
            "land": land_masks(fm, grid, fm.n_tracers)}


def compare_general(tag, grid, models, cfg, mu, stats, plain) -> int:
    """Phase 13a on one configuration (``models`` from
    :func:`general_models`): the general form's instantiation with the
    guard off and on against its plain version, as phase 2 holds the fast
    forms (one launch < 1e-5, N_CARRY steps < 1e-4, land and all-land
    tiles exactly 0, the block max, guarded == unguarded bit for bit); on
    metric planes the static reciprocal planes == the selects bit for
    bit; and the raw form, guard off and on, on 2 x 2 shards as phase 9a
    holds it. ``plain``: the plain version's N_CARRY single steps from
    the configuration's initial state, which its one-step and chained
    forms share (a chained plain launch is two single steps: filled by the
    first call). Returns the number of instantiations compared."""
    from ocean_model_arch_torch.model.init import init_ocean_state
    from ocean_model_arch_torch.ops.fused_step import (
        fused_sw_step, fused_sw_step_blockmax, fused_sw_step_reference)
    state = with_mu(init_ocean_state(grid, cfg), mu)
    fm = with_form(models["block"], cfg, mu)
    spc, form = fm.steps_per_call, general_name(fm)
    on = model_args(fm, cfg)
    off = on[:6] + (None,) + on[7:]
    land, dry = models["land"], models["dry"]
    s0 = fm.pack(state)
    n_carry = N_CARRY // spc

    def compare(what, ks, rs, tol, guard):
        errs = [rel_err(k, r) for k, r in zip(ks, rs)]
        check(max(errs) < tol, f"{tag} guard={guard} {what}: kernel vs "
              f"plain rel errors {errs} exceed {tol}")
        for k, lm in zip(ks, land):
            check(bool((k[lm] == 0).all()), f"{tag} {what}: a land cell of "
                  "the kernel's output is not 0")
            if guard:
                check(bool((k[dry] == 0).all()), f"{tag} {what}: an "
                      "all-land tile is not exactly 0")
        stats[form] = max([stats.get(form, 0.0)] + [
            float((k - r).abs().max()) for k, r in zip(ks, rs)])
        return max(errs)

    # the plain version: its guard zeroes only all-land tiles, whose cells
    # hold land's 0 either way, so one carried run serves both forms
    if not plain:
        one, f = off[:13] + (1,) + off[14:], s0
        for n in range(1, N_CARRY + 1):
            f, m = fused_sw_step_reference(f, *one)
            if n <= 2:
                plain[n] = (f, max(float(m), plain.get(n - 1, (0, 0.0))[1]))
        plain[N_CARRY] = (f, None)
    (r1, rmx), rs = plain[spc], plain[N_CARRY][0]
    check(all(torch.equal(a, b) for a, b in zip(
        r1, fused_sw_step_reference(s0, *on)[0])),
          f"{tag}: the guarded plain version differs from the unguarded")
    errs, outs = [], {}
    for guard, args in ((False, off), (True, on)):
        k1, bmx = fused_sw_step_blockmax(s0, *args)
        e1 = compare("1 launch", k1, r1, TOL_ONE, guard)
        check(abs(float(torch.amax(bmx)) - rmx) <= TOL_ONE * rmx,
              f"{tag}: block max {float(bmx.max())} vs plain {rmx}")
        if guard:
            check(bool((bmx[fm.tile_wet == 0] == 0).all()),
                  f"{tag}: the block max of an all-land tile is not 0")
        ks = s0
        for _ in range(n_carry):
            ks, _ = fused_sw_step(ks, *args)
        errs += [e1, compare(f"{n_carry} launches", ks, rs, TOL_CARRY, guard)]
        outs[guard] = (k1, ks)
    for which in (0, 1):
        check(all(torch.equal(a, b) for a, b in zip(outs[False][which],
                                                    outs[True][which])),
              f"{tag}: guarded and unguarded kernel outputs differ")
    static = ""
    if models["static"] is not None:
        fst = with_form(models["static"], cfg, mu)
        a = model_args(fst, cfg)
        k1, _ = fused_sw_step_blockmax(s0, *a)
        ks = s0
        for _ in range(n_carry):
            ks, _ = fused_sw_step(ks, *a)
        check(all(torch.equal(x, y) for x, y in zip(
            k1 + ks, outs[True][0] + outs[True][1])),
              f"{tag}: the static reciprocal planes differ from the selects")
        name_s = general_name(fst)
        stats[name_s] = max(stats.get(name_s, 0.0), stats[form])
        static = "; static reciprocal planes == selects bit for bit: yes"
    torch.cuda.synchronize()
    print(f"phase 13a kernel vs plain ({tag}, {key_text(form_key(fm))}, "
          f"guard off and on): max rel err 1 launch {max(errs[0::2]):.2e} < "
          f"{TOL_ONE}, {n_carry} launches {max(errs[1::2]):.2e} < "
          f"{TOL_CARRY}; land and all-land tiles exactly 0, guarded == "
          f"unguarded bit for bit: yes" + static)
    fs = with_form(models["shards"], cfg, mu)
    guarded = compare_raw(tag, fs, cfg, state, stats, general_name(fs),
                          "phase 13a")
    fs.tile_guard = False
    fs.tile_wet = [[None] * fs.py for _ in range(fs.px)]
    compare_raw(tag + " guard off", fs, cfg, state, stats, general_name(fs),
                "phase 13a", same_as=guarded)
    return 4


def general_forms(grids, basin, basin_b, prec, stats) -> int:
    """Phase 13a: every instantiation of the general form (profile and
    plane metrics, T = 0, 1, 2 and the run-time family at 3, each mu
    mode, with and without advection, full and linear free surface, one
    step and two chained a launch, guard off and on, single block and raw)
    against its plain version on the Azov coastline, the viscous modes
    over the 15-100 m bathymetry; and the chained run-time family past
    its shared-memory fit. Returns the number of instantiations
    compared."""
    from ocean_model_arch_torch.ops.fused_step import FORMS
    n = 0
    for g, b in (("azov", basin), ("azov_hr", basin),
                 ("bipolar_azov", basin_b), ("bipolar_azov_hr", basin_b)):
        for n_tr in (0, 1, 2, T_LOOP[0]):
            # mu = 0 on flat bathymetry, mu = 1000 over 15-100 m
            modes = [(m, k) for t, m, k in GEN_MODES
                     if t == n_tr and bool(m) == g.endswith("_hr")]
            cfg0 = form_cfg(b, prec, n_tr, 1, 1, modes[0][1])
            one = general_models(grids[g], cfg0, modes[0][0], 1)
            two = general_models(grids[g], cfg0, modes[0][0], 2, one)
            for (trans, ffs), (mu, ksw) in [(f, m) for f in FORMS
                                            for m in modes]:
                cfg, plain = form_cfg(b, prec, n_tr, trans, ffs, ksw), {}
                for spc, models in ((1, one), (2, two)):
                    n += compare_general(
                        f"{g} T={n_tr} mu={mu:g} ksw_lat={ksw} trans={trans} "
                        f"ffs={ffs} steps={spc}", grids[g], models, cfg, mu,
                        stats, plain)
    for n_tr, mu, g in ((T_PAST, 0.0, "azov"), (T_PAST_VISC, MU, "azov_hr")):
        cfg = form_cfg(basin, prec, n_tr, 1, 1)
        compare_general(f"{g} T={n_tr} mu={mu:g} steps=2 (tracer levels in "
                        "device scratch)", grids[g],
                        general_models(grids[g], cfg, mu, 2), cfg, mu, stats,
                        {})
    return n


def general_paths(grids, cfgs, cfgs_b, prec, wet, pts, card, name, run,
                  stats, fast, cell):
    """Phase 13b and 13c: the general form's paths at 1525 x 1115, each
    200 steps against the eager composition on its own instantiation
    only (``drive_path``): ``azov_general`` (``FusedSWModel(grid, cfg,
    tau)`` with the JAX defaults), ``bipolar_azov_general`` and its static
    reciprocal twin (bit for bit), ``azov_visc_general``, ``azov_general``
    chained, and ``azov_visc_general`` on 2 x 2 shards (uniform and
    weighted cuts, == the single general block bit for bit); the guard at
    a wet ``cell``; then a timing line per path beside the fast form of
    the same configuration (``fast``: path -> (model, timing) of this
    run): kernel, byte bound, the copy step of each form, path, idle."""
    from ocean_model_arch_torch.ops import copy_step as cs
    from ocean_model_arch_torch.ops.fused_step import (
        fused_sw_step_reference, general_geometry)
    probe = load_script("roofline_probe_torch")
    paths = (
        ("azov_general", "azov coastline, no tracers, "
         "FusedSWModel(grid, cfg, tau)", "azov", cfgs[0], 0.0, 1, {},
         "fused_sw_step_general_guarded"),
        ("bipolar_azov_general", "the coastline on the bipolar grid, 16 "
         "metric planes", "bipolar_azov", cfgs_b[0], 0.0, 1, {},
         "fused_sw_step_general_planes"),
        ("bipolar_azov_general static", "its static reciprocal planes, "
         "static_rslu=True, fast2d=False", "bipolar_azov", cfgs_b[0], 0.0, 1,
         {"static_rslu": True, "fast2d": False},
         "fused_sw_step_general_planes_static"),
        ("azov_visc_general", f"15-100 m, mu = {MU:g}, {N_TRACERS} tracers",
         "azov_hr", cfgs[N_TRACERS], MU, 1, {},
         "fused_sw_step_general_visc_tracers"),
        ("azov_general chained", "steps_per_call=2", "azov", cfgs[0], 0.0, 2,
         {}, "fused_sw_step_general_chain_guarded"))
    texts, models = [], {}
    for label, what, gname, cfg, mu, spc, kw, want in paths:
        fm, _, s0, n, out = drive_path(
            f"phase 13b main path {label} ({what})", grids[gname], cfg, None,
            mu, spc, kw)
        form = general_name(fm)
        check(form == want and fm.general and fm.tile_guard
              and n == N_MAIN // spc, f"{label} ran {form} {n} times, guard "
              f"{fm.tile_guard}, not {want}")
        models[label] = (fm, s0, out)
        run["launches"][form] = n
        run["plain_ms"][form] = cuda_ms(
            lambda: fused_sw_step_reference(s0, *model_args(fm, cfg)), 10)
    a, b = (models[k][2] for k in ("bipolar_azov_general",
                                   "bipolar_azov_general static"))
    check(all(torch.equal(getattr(a, f), getattr(b, f))
              for f in ("ssh", "sshp", "ubrtr", "ubrtrp", "vbrtr", "vbrtrp")),
          "bipolar_azov_general: the static reciprocal planes' run differs "
          "from the selects' run")
    print(f"phase 13b bipolar_azov_general: {N_MAIN} steps with the static "
          "reciprocal planes == with the selects bit for bit: yes")
    sh, state_sh = sharded_2x2(
        f"azov_visc_general (mu = {MU:g}, 15-100 m, {N_TRACERS} tracers)",
        grids["azov_hr"], cfgs[N_TRACERS], MU, stats,
        "fused_sw_step_raw_general_visc_tracers", phase="phase 13b",
        static_rslu=False)
    run["launches"]["fused_sw_step_raw_general_visc_tracers"] = \
        sh["uniform"][1]
    fm_g, s0_g, _ = models["azov_general"]
    guard_trips(fm_g, s0_g, cell, "azov_general")
    fm_c, s0_c, _ = models["azov_general chained"]
    guard_trips(fm_c, s0_c, cell, "azov_general chained")
    print("phase 13b guard: ok=False on an injected NaN ssh and on an sshp "
          f"spike of 2e4 at wet cell {cell} of azov_general, one step and "
          "two chained a launch")

    # (c) the timing of each path beside the fast form of this run
    def copy_us(m, s, loader="tma"):
        windows, met = copy_step_inputs(m, s)
        return probe.kernel_us(lambda: cs.copy_step(
            windows, met, len(s), m.lay, tracer_form=m.n_tracers,
            tile_wet=m.tile_wet, tile=m.tile, visc_form=m.visc,
            steps=m.steps_per_call, loader=loader), N_TIME)

    for label, _, gname, cfg, _, _, _, _ in paths:
        fm, s0, _ = models[label]
        form = general_name(fm)
        t = time_path(fm, cfg, s0, wet[gname], pts)
        run["kernels"][form] = (fm, fm.n_tracers, t)
        b_ms, b_by, nbytes = bound_ms(fm, fm.n_tracers)
        by_tma = general_geometry(fm.n_tracers, fm.steps_per_call,
                                  fm.visc).tma
        head = (f"kernel by {'TMA' if by_tma else 'threads'} "
                f"{t['ms_kernel'] * 1e3:.1f} us a launch, "
                f"{nbytes / 1e6:.1f} MB, bound {b_ms * 1e3:.1f} us ({b_by}), "
                f"copy step of its form {copy_us(fm, s0):.1f} us"
                + ("" if by_tma else
                   f" (by threads {copy_us(fm, s0, 'threads'):.1f} us)"))
        fm_f, t_f = fast[label.split()[0] + " chained" * (
            fm.steps_per_call == 2)]
        bf_ms, _, bf_bytes = bound_ms(fm_f, fm_f.n_tracers)
        fast_head = (f"kernel {t_f['ms_kernel'] * 1e3:.1f} us, "
                     f"{bf_bytes / 1e6:.1f} MB, bound {bf_ms * 1e3:.1f} us, "
                     "copy step of its form "
                     f"{copy_us(fm_f, s0[:len(s0)]):.1f} us")
        run["bounds"].append(f"{label}/T={fm.n_tracers}/guard on: {head}; "
                             f"the fast form: {fast_head}")
        texts.append(f"{label} {key_text(form_key(fm))}: {head}; path "
                     f"{t['text']}; plain version "
                     f"{run['plain_ms'][form]:.4f} ms/launch | the fast form "
                     f"{key_text(form_key(fm_f))}: {fast_head}; path "
                     f"{t_f['text']}")
    for cuts in ("uniform", "weighted"):
        fs = sh[cuts][0]
        t = time_sharded(fs, state_sh, wet["azov"], pts)
        if cuts == "uniform":
            form = general_name(fs)
            run["kernels"][form] = (fs, fs.n_tracers, t)
            f_in = fs.pack(state_sh)[0].unbind(0)
            f_out = tuple(torch.zeros_like(a) for a in f_in)
            run["plain_ms"][form] = cuda_ms(lambda: fused_sw_step_reference(
                f_in, *shard_args(fs, cfgs[N_TRACERS], 0, 0), outs=f_out), 10)
            run["bounds"].append(
                f"azov_visc_general 2 x 2 uniform, raw form: kernel "
                f"{t['ms_kernel'] * 1e3:.1f} us/launch, bound "
                f"{t['bound_ms'] * 1e3:.1f} us/launch (bytes)")
        texts.append(f"azov_visc_general 2 x 2 {cuts} cuts "
                     f"{key_text(form_key(fs))}: {t['text']}")
    print(f"phase 13c timing ({name}; {card}), wet points {wet['azov']} of "
          f"{pts}: " + " | ".join(texts))


# ---- phase 14: the persistent step (K2) and its probe (K5) ------------------

N_WALK = 500            # steps of a window of the walk (the TPU probe's)
# the persistent runs: (label, what, grid, tracers, mu, fast form, entry)
PERSIST_RUNS = (
    ("default", "frame mask, no tracers", "frame", 0, 0.0, True,
     "fused_sw_persistent"),
    ("azov_mask", "azov coastline, no tracers", "azov", 0, 0.0, True,
     "fused_sw_persistent_azov_mask"),
    ("azov_tracers", f"azov coastline, {N_TRACERS} tracers", "azov",
     N_TRACERS, 0.0, True, "fused_sw_persistent_tracers"),
    ("azov_general", "azov coastline, no tracers, FusedSWModel(grid, cfg, "
     "tau, persistent=True): the general form", "azov", 0, 0.0, False,
     "fused_sw_persistent_general"),
    ("azov_tracers3", "azov coastline, 3 tracers (run-time tracer family)",
     "azov", 3, 0.0, True, "fused_sw_persistent_tracers3"),
    ("azov_visc", f"azov coastline, 15-100 m bathymetry, mu = {MU:g}, "
     f"{N_TRACERS} tracers", "azov_hr", N_TRACERS, MU, True,
     "fused_sw_persistent_visc_bathy_tracers"))
# the design of K2's walk this checkout keeps (the kernels line names it)
WALK_DESIGN = ("tma, design A: three blocks an SM, one set of planes, each "
               "tile's boxes issued after the last tile's final barrier")
# the other K2 instantiations run on this cut of the azov coastline's
# mask (rows, columns: 60 % wet), with two land cells around it
PERSIST_CUT = ((750, 1150), (300, 600))
N_PERSIST_TWICE = 200    # steps of each of the two launches held bit for bit


def persist_keys() -> list:
    """Every K2 instantiation as the wrapper counts it: (tracers, mu mode,
    bathymetry planes, advection, full free surface, general), 132 of them
    (the fast form's 88, the general form's 44, which has no bathymetry
    planes of its own)."""
    return [(t, m, h, tr, fs, g) for g in (False, True) for t in (0, 1, 2, 3)
            for m in ((0, 2) if t == 0 else (0, 1, 2))
            for h in ((False,) if g else (False, True))
            for tr in (1, 0) for fs in (1, 0)]


def persistent_forms(basin, prec, mask, done) -> tuple:
    """Phase 14d: every K2 instantiation but the keys in ``done`` (the six
    runs of ``PERSIST_RUNS``, held at full size), on ``PERSIST_CUT`` of
    the coastline: the kernel against the plain version after 1 step
    (``TOL_ONE``) and after ``N_CARRY`` (``TOL_CARRY``), land exactly 0,
    each its own instantiation once. Mu mode 1 is the tracers' diffusive
    fluxes alone (``ksw_lat = 0``); the bathymetry is 15-100 m where the
    fast form reads its planes and for the general form's viscous ones.
    Returns (instantiations held, worst relative error, seconds)."""
    from ocean_model_arch_torch.core.grid import build_grid
    from ocean_model_arch_torch.model.fused import FusedSWModel
    from ocean_model_arch_torch.model.init import init_ocean_state
    from ocean_model_arch_torch.ops import fused_step as fstep
    t0 = time.perf_counter()
    (x0, x1), (y0, y1) = PERSIST_CUT
    cut = np.array(mask[x0:x1, y0:y1], copy=True)
    cut[:2] = cut[-2:] = 1
    cut[:, :2] = cut[:, -2:] = 1
    b = dataclasses.replace(basin, nx=x1 - x0, ny=y1 - y0)
    grids = {hrp: build_grid(b, cut, hhq_rest=bathymetry(b.nx, b.ny)
                             if hrp else None, precision=prec)
             for hrp in (False, True)}
    worst, n = 0.0, 0
    for key in persist_keys():
        if key in done:
            continue
        n_tr, mode, hrp, trans, ffs, general = key
        mu = MU if mode else 0.0
        cfg = form_cfg(b, prec, n_tr, trans, ffs, 0 if mode == 1 else 1)
        grid = grids[hrp or (general and mode == 2)]
        kw = {} if general else {"static_rslu": True, **UNFOLDED}
        fp = FusedSWModel(grid, cfg, 1.0, mu_const=mu, persistent=True, **kw)
        s0 = fp.pack(with_mu(init_ocean_state(grid, cfg), mu))
        args = (fp.met, fp.planes, fp.lay, fp.tau, cfg.sw.time_smooth,
                fp.hr_const, fp.mu_const, fp.visc, fp.trans, fp.ffs)
        land = land_masks(fp, grid, n_tr)
        spare = tuple(torch.zeros_like(f) for f in s0)
        r1, m1 = fstep.fused_sw_persistent_reference(
            s0, *args, n_steps=1, general=general)
        rn, _ = fstep.fused_sw_persistent_reference(
            r1, *args, n_steps=N_CARRY - 1, general=general)
        fstep.reset_launch_counts()
        for n_steps, want, tol in ((1, r1, TOL_ONE), (N_CARRY, rn, TOL_CARRY)):
            got, _ = fstep.fused_sw_persistent(
                tuple(f.clone() for f in s0), *args, n_steps=n_steps,
                general=general, spare=spare)
            e = max(rel_err(a, w) for a, w in zip(got, want))
            check(e <= tol, f"persistent {key_text(key)} on the cut: kernel "
                  f"vs plain after {n_steps} steps, rel error {e:.2e}")
            check(all(bool((a[lm] == 0).all()) for a, lm in zip(got, land)),
                  f"persistent {key_text(key)}: a land cell is not 0")
            worst = max(worst, e)
        counts = dict(fstep.fused_sw_persistent.form_launches)
        check(counts == {key: 2}, f"persistent {key_text(key)} launched "
              f"{counts}")
        n += 1
    return n, worst, time.perf_counter() - t0


WALK_REPLACES = {"inplace": "scripts/persistent_probe.py:102",
                 "pingpong": "scripts/persistent_probe.py:187",
                 "launches": "scripts/persistent_probe.py:187"}


def walk_phase(card: str, name: str) -> list:
    """Phase 14a: the persistent walk (K5) through its entry point,
    ``scripts/persistent_probe_torch.py``: the three forms against each
    other (bit for bit) and the plain version on the card, each timed at
    the TPU probe's extents, the barrier's cost, the grid, the L2 hit rate
    where ncu exists. Returns the kernels line's entries, per model step;
    the launches are those of this run of the probe."""
    from ocean_model_arch_torch.ops import persistent_probe as pp
    probe = load_script("persistent_probe_torch")
    pp.reset_launch_counts()
    rows = probe.probe(N_WALK, 3)
    counts = dict(pp.persistent_walk.form_launches)
    fields = probe.fields_from_seed(probe.X, probe.YS)
    plain_ms = cuda_ms(lambda: pp.persistent_walk_reference(fields, 1), 5)
    l2 = {f: probe.l2_hit_rate(f, pp.TILE_ROWS)
          for f in ("inplace", "pingpong")}
    torch.cuda.synchronize()
    r0 = rows[0]
    print(f"phase 14a persistent walk (K5; {name}; {card}): "
          f"{pp.N_FIELDS} fields of {probe.X + 2 * pp.MARGIN} x {probe.YS} "
          f"f32, M = {pp.MARGIN}, {N_WALK} steps a window (CUDA events, best "
          f"of 3); the three forms bit-identical after {probe.N_CHECK} "
          f"steps: yes; against the plain version at most {r0['ulps']} ulp"
          + (f" (float64 ties at {r0['tie_cells']})" if r0["tie_cells"]
             else " (no tie)")
          + f"; byte bound {r0['bytes'] / 1e6:.1f} MB a step = "
          f"{r0['bound_us']:.2f} us; us/step: "
          + "; ".join(f"{r['form']} tile rows {r['tile_rows']} "
                      f"{r['us']:.2f} (grid {r['grid']} of {r['tiles']} "
                      f"tiles, {r['us'] / r['bound_us']:.2f} x bound)"
                      for r in rows)
          + "; barrier a step: " + "; ".join(
              "tile rows {}: {:.2f} us (pingpong less the same launch "
              "without it), {:.2f} us (less one launch a step)".format(
                  tr, *probe.barrier_us(rows, tr))
              for tr in probe.TILE_ROWS)
          + f"; L2 hit rate (tile rows {pp.TILE_ROWS}): inplace "
          f"{l2['inplace']}, pingpong {l2['pingpong']}; plain version "
          f"{plain_ms:.4f} ms a step; launches {counts}")
    entries = []
    for form in pp.FORMS:
        r = next(x for x in rows if x["form"] == form
                 and x["tile_rows"] == pp.TILE_ROWS)
        check(counts.get(form, 0) > 0, f"walk form {form} never launched")
        entries.append({
            "name": f"persistent_walk_{form}", "route": "cuda",
            "source": CSRC + "persistent_probe.cu",
            "replaces": WALK_REPLACES[form], "launches": counts[form],
            "max_abs_err": r["max_abs"], "ms": r["us"] / 1e3,
            "plain_ms": plain_ms, "bound_ms": r["bound_us"] / 1e3,
            "bound_by": "bytes", "library_ms": None})
    return entries


def persistent_paths(grids, basin, prec, wet, pts, card, name, stats, cell,
                     mask):
    """Phase 14b and 14c: ``FusedSWModel(persistent=True)`` at 1525 x 1115
    on the runs of ``PERSIST_RUNS``: the kernel against the plain version
    after 1 and N_CARRY steps (1e-5, 1e-4), land exactly 0; the main path,
    N_MAIN steps in ONE launch of its own instantiation and no other
    kernel, against ``run_steps`` at one step a launch (N_MAIN launches)
    bit for bit; the guard at a wet ``cell``; then the timing beside
    ``run_steps`` (the model's default guard, and unguarded as the walk
    runs) and the chained form of the same run: kernel us a step
    (torch.profiler), path, idle, the grid. Returns the kernels line's
    entries, per model step."""
    from ocean_model_arch_torch.model.fused import FusedSWModel
    from ocean_model_arch_torch.model.init import init_ocean_state
    from ocean_model_arch_torch.ops import fused_step as fstep
    texts, entries, done_keys = [], [], set()
    for label, what, gname, n_tr, mu, fast, entry in PERSIST_RUNS:
        grid = grids[gname]
        cfg = form_cfg(basin, prec, n_tr, 1, 1)
        state = with_mu(init_ocean_state(grid, cfg), mu)
        kw = {"static_rslu": True, **UNFOLDED} if fast else {}
        fp = FusedSWModel(grid, cfg, 1.0, mu_const=mu, persistent=True, **kw)
        check(fp.persistent and fp.general != fast and not fp.metrics_2d,
              f"{label}: not the persistent {'fast' if fast else 'general'} "
              "form on profile metrics")
        s0 = fp.pack(state)
        args = (fp.met, fp.planes, fp.lay, fp.tau, cfg.sw.time_smooth,
                fp.hr_const, fp.mu_const, fp.visc, fp.trans, fp.ffs)
        land = land_masks(fp, grid, n_tr)
        spare = tuple(torch.zeros_like(f) for f in s0)
        # (b) the kernel against the plain version after 1 and N_CARRY steps
        r1, m1 = fstep.fused_sw_persistent_reference(
            s0, *args, n_steps=1, general=fp.general)
        rN, mN = fstep.fused_sw_persistent_reference(
            r1, *args, n_steps=N_CARRY - 1, general=fp.general)
        errs = {}
        for n, (r, rmx), tol in ((1, (r1, m1), TOL_ONE),
                                 (N_CARRY, (rN, torch.maximum(m1, mN)),
                                  TOL_CARRY)):
            k, kmx = fstep.fused_sw_persistent(
                tuple(f.clone() for f in s0), *args, n_steps=n,
                general=fp.general, spare=spare)
            e = [rel_err(a, b) for a, b in zip(k, r)]
            check(max(e) <= tol, f"{label}: persistent kernel vs plain after "
                  f"{n} steps, rel errors {e} above {tol}")
            check(abs(float(kmx) - float(rmx)) <= tol * float(rmx),
                  f"{label}: max {float(kmx)} vs plain {float(rmx)}")
            check(all(bool((a[lm] == 0).all()) for a, lm in zip(k, land)),
                  f"{label}: a land cell of the kernel's output is not 0")
            stats[entry] = max([stats.get(entry, 0.0)] + [
                float((a - b).abs().max()) for a, b in zip(k, r)])
            errs[n] = max(e)
        # the main path: one launch, its own instantiation only
        key = (n_tr, fstep.mu_mode(n_tr, mu, fp.visc),
               fp.hr_const is None and not fp.general, fp.trans, fp.ffs,
               fp.general)
        fstep.reset_launch_counts()
        s, ok = fp.run_steps(tuple(f.clone() for f in s0), N_MAIN)
        launches = fstep.fused_sw_persistent.launches
        counts = dict(fstep.fused_sw_persistent.form_launches)
        check(ok and launches == 1 and counts == {key: 1}
              and fstep.fused_sw_step.launches == 0,
              f"{label}: ok={ok}, {launches} persistent launches {counts} and "
              f"{fstep.fused_sw_step.launches} one-step launches for "
              f"{N_MAIN} steps, expected one of {key}")
        f1 = FusedSWModel(grid, cfg, 1.0, mu_const=mu, tile_guard=False, **kw)
        want, wok = f1.run_steps(s0, N_MAIN)
        # bit for bit, in this launch and in another: a box that read a
        # cell before the fences let it would show now and then
        s2, _ = fp.run_steps(tuple(f.clone() for f in s0), N_MAIN)
        same = wok and all(torch.equal(a, b) and torch.equal(c, b)
                           for a, c, b in zip(s, s2, want))
        e200 = max(rel_err(a, b) for a, b in zip(s, want))
        check(same, f"{label}: {N_MAIN} steps in one launch, twice, vs "
              f"run_steps: not bit for bit (rel error {e200})")
        done_keys.add(key)
        guard_trips(fp, s0, cell, f"{label} persistent")
        print(f"phase 14b main path {label} ({what}): {N_MAIN} steps in "
              f"{launches} launch of <{','.join(str(int(k)) for k in key)}> "
              f"(tracers, mu mode, bathymetry planes, advection, full free "
              f"surface, general), no one-step launch, ok={ok}; == run_steps "
              f"at one step a launch ({N_MAIN} launches) bit for bit, in two "
              "launches: yes; "
              f"kernel vs plain version rel err 1 step {errs[1]:.2e} <= "
              f"{TOL_ONE}, {N_CARRY} steps {errs[N_CARRY]:.2e} <= "
              f"{TOL_CARRY}; land exactly 0: yes; guard: ok=False on an "
              f"injected NaN ssh and on an sshp spike of 2e4 at wet cell "
              f"{cell}: yes; max|ssh| {float(s[0].abs().max()):.6e}")

        # (c) timing beside run_steps and the chained form of the same run
        cur = {"s": tuple(f.clone() for f in s0)}

        def window():
            cur["s"], _ = fp.run_steps(cur["s"], N_TIME)

        lo, ms_path, hi = sorted(cuda_ms(window, 1) / N_TIME
                                 for _ in range(3))
        ms_launch, ms_dev = profile_device_ms(window,
                                              "fused_sw_persist_kernel")
        how = f"torch.profiler over one launch of {N_TIME} steps"
        if ms_launch is None:
            # CUDA events around the launch alone (and its amax), no host
            # synchronisation between them
            pair = (tuple(f.clone() for f in s0), spare)
            ms_launch = ms_dev = cuda_ms(lambda: fstep.fused_sw_persistent(
                pair[0], *args, n_steps=N_TIME, general=fp.general,
                spare=pair[1]), 3)
            how = (f"CUDA events around one launch of {N_TIME} steps: "
                   "torch.profiler recorded no device time for it (it saw: "
                   f"{profiled_kernels(window)})")
        us_step = ms_launch / N_TIME * 1e3
        idle = max(0.0, 1 - ms_dev / N_TIME / ms_path)
        n_grid = fstep.persistent_grid(n_tr, fp.hr_const, mu, fp.visc,
                                       fp.trans, fp.ffs, fp.general)
        b_ms, b_by, nbytes = bound_ms(f1, n_tr)
        plain_ms = cuda_ms(lambda: fstep.fused_sw_persistent_reference(
            s0, *args, n_steps=1, general=fp.general), 5)
        fd = FusedSWModel(grid, cfg, 1.0, mu_const=mu, **kw)
        fc = FusedSWModel(grid, cfg, 1.0, mu_const=mu, steps_per_call=2, **kw)
        t_d = time_path(fd, cfg, s0, wet[gname], pts)
        t_1 = time_path(f1, cfg, s0, wet[gname], pts) if fd.tile_guard \
            else t_d
        t_c = time_path(fc, cfg, s0, wet[gname], pts)
        texts.append(
            f"{label} <{','.join(str(int(k)) for k in key)}>: persistent "
            f"kernel {us_step:.2f} us a step ({how}; grid {n_grid} blocks "
            f"co-resident), bound "
            f"{b_ms * 1e3:.1f} us ({b_by}, {nbytes / 1e6:.1f} MB a step), "
            f"device busy {ms_dev / N_TIME * 1e3:.2f} us a step, path "
            f"{ms_path * 1e3:.2f} us a step (windows {lo * 1e3:.2f}-"
            f"{hi * 1e3:.2f}), device idle {idle:.0%}, plain version "
            f"{plain_ms:.4f} ms a step | run_steps one step a launch, guard "
            f"{'on' if fd.tile_guard else 'off'}: {t_d['text']}"
            + (f" | unguarded: {t_1['text']}" if fd.tile_guard else "")
            + f" | chained: {t_c['text']}")
        entries.append({
            "name": entry, "route": "cuda", "source": CSRC + "fused_step.cu",
            "replaces": PALLAS + ":1355", "launches": launches,
            "max_abs_err": stats[entry], "ms": us_step / 1e3,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "loader": WALK_DESIGN})
    print(f"phase 14c timing ({name}; {card}), a model step each: "
          + " || ".join(texts))
    n_cut, worst, secs = persistent_forms(basin, prec, mask, done_keys)
    (x0, x1), (y0, y1) = PERSIST_CUT
    check(n_cut + len(done_keys) == len(persist_keys()) == 132,
          f"{n_cut} + {len(done_keys)} of {len(persist_keys())} persistent "
          "instantiations held")
    print(f"phase 14d every persistent instantiation: the {len(done_keys)} "
          f"above at full size, the other {n_cut} on rows {x0}-{x1}, columns "
          f"{y0}-{y1} of the coastline ({x1 - x0} x {y1 - y0}): kernel vs "
          f"plain version within {TOL_ONE} after 1 step and {TOL_CARRY} "
          f"after {N_CARRY} (worst {worst:.2e}), land exactly 0, each its "
          f"own instantiation; {secs:.1f} s")
    return entries


# ---- phase 15: K1's arithmetic folds ------------------------------------------

# the folded main paths: (label, what, grid, tracers, mu, steps a launch)
FOLD_PATHS = (
    ("azov_mask", "azov coastline, no tracers", "azov", 0, 0.0, 1),
    ("azov_mask chained", "azov coastline, no tracers", "azov", 0, 0.0, 2),
    ("azov_tracers chained", f"azov coastline, {N_TRACERS} tracers", "azov",
     N_TRACERS, 0.0, 2),
    ("azov_tracers4 chained", f"azov coastline, {T_PATH} tracers (the "
     "run-time tracer count, phase 12c's form)", "azov", T_PATH, 0.0, 2),
    ("bipolar_azov chained", "azov coastline on the bipolar grid, plane "
     "metrics (fast2d)", "bipolar_azov", 0, 0.0, 2),
    ("azov_visc chained", f"15-100 m bathymetry, mu = {MU:g}, {N_TRACERS} "
     "tracers", "azov_hr", N_TRACERS, MU, 2),
)
# elide_sel without q4 and q4 without elide_sel (fold codes 1, 2; 5, 6
# chained, with share_prev), on the guarded coastline: (label, steps a
# launch, elide_sel, q4)
ONE_FOLD_PATHS = (("azov_mask elide_sel", 1, True, False),
                  ("azov_mask q4", 1, False, True),
                  ("azov_mask chained elide_sel", 2, True, False),
                  ("azov_mask chained q4", 2, False, True))
N_ONE_FOLD_CARRY = 25    # launches of their kernel-vs-plain comparison
N_FOLD_CMP = 30          # steps of the folded-against-unfolded comparison
# --parent: the main path's chained and folded fast forms, each guarded on
# the coastline: (curve_grid, tracers, steps a launch, fold arguments)
PARENT_MAIN = tuple(("azov", cg, t, spc, kw) for cg in (0, 2)
                    for t in (0, 2) for spc in (1, 2)
                    for kw in ({}, {"elide_sel": False, "q4": False,
                                    "share_prev": False})
                    if spc == 2 or kw == {}) + (
    ("frame", 0, 0, 1, {}), ("frame", 0, 0, 2, {}))
# tests/test_fused.py::_assert_ulp_close: elide_sel and q4 (exact scalings,
# contraction round-off), share_prev (a regrouping) on its 70 x 52 basin
TOL_FOLD, TOL_SHARE = 1e-6, 1e-5


def one_fold_targets() -> tuple:
    """The libraries of ONE_FOLD_PATHS' instantiations (fold codes 1, 2,
    5, 6 without tracers, the block's and the raw form's), which build at
    first use, not among fold_targets()."""
    from ocean_model_arch_torch.ops.fused_step import library_target
    return tuple(library_target(0, raw, steps=spc,
                                folds=int(e) + 2 * int(q) + 4 * (spc > 1))
                 for _, spc, e, q in ONE_FOLD_PATHS for raw in (False, True))


def entry_fold_targets() -> tuple:
    """The folded libraries the entry points launch (``main`` and
    ``OceanModel`` in phases 9b, 9c, 10c, 12c and 17c): (tracers, raw,
    advection, steps a launch, fold code), every one with a full free
    surface."""
    from ocean_model_arch_torch.ops.fused_step import library_target
    return tuple(library_target(n, raw, trans, 1, steps, folds=f)
                 for n, raw, trans, steps, f in (
                     (0, False, 1, 2, 7), (2, True, 1, 1, 3),
                     (0, False, 0, 2, 7), (2, False, 1, 2, 7),
                     (1, False, 1, 2, 7), (0, True, 0, 2, 7),
                     (0, True, 0, 1, 3), (4, False, 1, 2, 7),
                     (4, True, 1, 2, 7), (0, True, 1, 2, 7)))


def build_behind(names) -> None:
    """Build ``names`` at niceness 10, as many at once as there are cores,
    below the phases that time the card: on Linux ``os.nice`` lowers the
    calling thread only, and the threads and compilers it starts inherit
    it. (All 96 at once take the host loop's core: the run took 1056 s.)"""
    from ocean_model_arch_torch.ops import _build
    os.nice(10)
    n = os.cpu_count() or 8
    for i in range(0, len(names), n):
        _build.build_all(names[i:i + n])


def fold_registers(fold_build, chain_regs: int) -> str:
    """Phase 15a: wait for the fold libraries' background build; every
    folded instantiation within the launch bound of its steps (42
    registers one step a launch, ``chain_regs`` chained), no spill, and as
    many instantiations in each fold library as in its unfolded twin."""
    from ocean_model_arch_torch.ops import _build
    from ocean_model_arch_torch.ops.fused_step import fold_targets
    t0 = time.perf_counter()
    fold_build.result()
    waited = time.perf_counter() - t0
    rows, built = [], 0
    for t in fold_targets():
        if t not in _build.BUILDS:
            continue                    # cached: no log
        built += 1
        mine = ptxas_table(_build.BUILDS[t]["log"])
        twin = ptxas_table(_build.BUILDS.get(
            t.split("@FUSED_FOLD=")[0], {}).get("log", ""))
        check(not twin or len(mine) == len(twin), f"{t}: {len(mine)} "
              f"instantiations, its unfolded twin {len(twin)}")
        rows += mine
    over = [r for r in rows
            if r[1] > (chain_regs if r[0][1:-1].split(",")[8] == "2"
                       else MAX_REGS) or r[2] != 0]
    check(not over, f"fold instantiations above {MAX_REGS} registers (one "
          f"step a launch) or {chain_regs} (chained), or with spills: "
          f"{over}")
    secs = [_build.BUILDS[t]["seconds"] for t in fold_targets()
            if t in _build.BUILDS]
    return (f"{built} of {len(fold_targets())} fold libraries built here "
            f"(in the background from phase 2 on, nice 10; the longest "
            f"{max(secs, default=0.0):.1f} s), waited {waited:.1f} s for "
            f"the rest; {len(rows)} instantiations of fused_sw_fold_kernel"
            "<tracers,guard,plane metrics,mu mode,bathymetry planes,raw,"
            "advection,full free surface,steps,folds>: "
            + ptxas_summary(rows))


def fold_phase(grids, basin, basin_b, prec, wet, pts, card, name, run,
               stats, cell, fold_build, chain_regs) -> None:
    """Phase 15: the folds (elide_sel, q4, share_prev) as the drivers
    default them. (a) the fold libraries' registers; (b) each folded main
    path (``FOLD_PATHS``: 200 steps through ``FusedSWModel`` with its
    defaults, its own folded instantiation only, against the eager
    composition), its kernel against the plain version with the same
    folds after 1 and 50 launches (25 chained), folded against unfolded
    kernels after 30 steps (rel <= 1e-6 without share_prev, 1e-5 with it:
    tests/test_fused.py::_assert_ulp_close), land exactly 0 in the
    velocity carriers and the tracer levels, the guard on an injected NaN
    and an sshp spike; (c) the folded raw form on 2 x 2 shards against its
    plain version and == the folded block bit for bit, one step and two a
    launch (``azov_visc``), two a launch with ``T_PATH`` tracers (the
    entry point's form of phase 12c); (d) timing, each folded kernel
    beside the unfolded one of the same configuration in the same run."""
    from ocean_model_arch_torch.model.fused import FusedSWModel
    from ocean_model_arch_torch.model.fused_sharded2d import \
        FusedSharded2DModel
    from ocean_model_arch_torch.model.init import init_ocean_state
    from ocean_model_arch_torch.ops import fused_layout as fl
    from ocean_model_arch_torch.ops.fused_step import (
        fused_sw_step_blockmax, fused_sw_step_reference)
    print(f"phase 15a fold registers: "
          + fold_registers(fold_build, chain_regs), flush=True)
    basins = {"azov": basin, "azov_hr": basin, "bipolar_azov": basin_b}
    texts, blocks = [], {}
    for label, what, gname, n_tr, mu, spc in FOLD_PATHS:
        grid = grids[gname]
        cfg = form_cfg(basins[gname], prec, n_tr, 1, 1)
        fm, state, s0, n, _ = drive_path(
            f"phase 15b main path {label} (folds on; {what})", grid, cfg,
            None, mu, spc, {"static_rslu": True})
        folds = tuple(map(int, fm.folds))
        check(folds == (1, 1, int(spc > 1)), f"{label}: folds {folds}")
        form = form_name(fm)
        run["launches"][form] = n
        # (b) kernel against the plain version with the same folds
        args = model_args(fm, cfg)
        k1, bmx = fused_sw_step_blockmax(s0, *args)
        r1, rmx = fused_sw_step_reference(s0, *args)
        e1 = max(rel_err(a, b) for a, b in zip(k1, r1))
        ks, rs = s0, s0
        for _ in range(N_CARRY // spc):
            ks, _ = fused_sw_step_blockmax(ks, *args)
            rs, _ = fused_sw_step_reference(rs, *args)
        torch.cuda.synchronize()
        e50 = max(rel_err(a, b) for a, b in zip(ks, rs))
        check(e1 <= TOL_ONE and e50 <= TOL_CARRY, f"{label}: folded kernel "
              f"vs plain rel err {e1:.2e} (1 launch), {e50:.2e} "
              f"({N_CARRY // spc} launches)")
        check(abs(float(bmx.max()) - float(rmx)) <= TOL_ONE * float(rmx),
              f"{label}: block max {float(bmx.max())} vs plain {float(rmx)}")
        stats[form] = max(float((a - b).abs().max())
                          for a, b in zip(ks + k1, rs + r1))
        # folded against unfolded, the same steps on the card; with
        # share_prev also against share_prev alone (elide_sel and q4 apart)
        fu = FusedSWModel(grid, cfg, 1.0, mu_const=mu, static_rslu=True,
                          steps_per_call=spc, tile_guard=fm.tile_guard,
                          **UNFOLDED)
        a, aok = fu.run_steps(fu.pack(state), N_FOLD_CMP)
        b, bok = fm.run_steps(s0, N_FOLD_CMP)
        ef = max(rel_err(x, y) for x, y in zip(b, a))
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        lim = TOL_CARRY if fm.share_prev else TOL_FOLD
        check(aok and bok and ef <= lim, f"{label}: folded vs unfolded "
              f"after {N_FOLD_CMP} steps rel err {ef:.2e} > {lim}")
        vs_share = ""
        if fm.share_prev:
            fsh = FusedSWModel(grid, cfg, 1.0, mu_const=mu, static_rslu=True,
                               steps_per_call=spc, tile_guard=fm.tile_guard,
                               elide_sel=False, q4=False)
            c, cok = fsh.run_steps(fsh.pack(state), N_FOLD_CMP)
            es = max(rel_err(x, y) for x, y in zip(b, c))
            check(cok and es <= TOL_FOLD, f"{label}: folded vs share_prev "
                  f"alone after {N_FOLD_CMP} steps rel err {es:.2e}")
            vs_share = (f"; against share_prev alone "
                        f"{key_text(form_key(fsh))} rel err {es:.2e} <= "
                        f"{TOL_FOLD} (elide_sel and q4 apart)")
        land = land_masks(fm, grid, n_tr)
        check(all(bool((f[m] == 0).all())
                  for f, m in zip(b[2:] + ks[2:], land[2:] + land[2:])),
              f"{label}: a land cell of a velocity or tracer carrier is "
              "not 0")
        guard_trips(fm, s0, cell, f"phase 15 {label}")
        # (d) timing beside the unfolded twin
        t = time_path(fm, cfg, s0, wet[gname], pts)
        tu = time_path(fu, cfg, fu.pack(state), wet[gname], pts)
        run["kernels"][form] = (fm, n_tr, t)
        run["plain_ms"][form] = cuda_ms(
            lambda: fused_sw_step_reference(s0, *args), 10)
        b_ms, b_by, nbytes = bound_ms(fm, n_tr)
        blocks[gname, n_tr, spc] = (fm, state)
        print(f"phase 15b folds {label} {key_text(form_key(fm))}: kernel "
              f"vs plain (same folds) rel err {e1:.2e} <= {TOL_ONE} after 1 "
              f"launch, {e50:.2e} <= {TOL_CARRY} after {N_CARRY // spc}; "
              f"folded vs unfolded kernel after {N_FOLD_CMP} steps "
              + ("bit for bit" if same else f"rel err {ef:.2e} <= {lim}")
              + vs_share + "; land exactly 0 in the velocity carriers and tracer "
              "levels: yes; guard: ok=False on a NaN ssh and an sshp spike "
              "at a wet cell: yes")
        texts.append(
            f"{label} {key_text(form_key(fm))}: folded kernel "
            f"{t['ms_kernel'] * 1e3:.2f} us a launch against unfolded "
            f"{tu['ms_kernel'] * 1e3:.2f} {key_text(form_key(fu))} "
            f"({t['ms_kernel'] / tu['ms_kernel']:.4f}); byte bound "
            f"{b_ms * 1e3:.1f} us ({nbytes / 1e6:.1f} MB, {b_by}); path "
            f"folded {t['ms_path']:.4f} ms/step, unfolded "
            f"{tu['ms_path']:.4f}")
    # (c) the folded raw form: 2 x 2 shards == the folded block
    for label, gname, n_tr, mu, spc in (
            ("azov_visc", "azov_hr", N_TRACERS, MU, 1),
            ("azov_visc", "azov_hr", N_TRACERS, MU, 2),
            ("azov_tracers4", "azov", T_PATH, 0.0, 2)):
        cfg = form_cfg(basin, prec, n_tr, 1, 1)
        fm, state = blocks.get((gname, n_tr, spc), (None, None))
        if fm is None:
            state = with_mu(init_ocean_state(grids[gname], cfg), mu)
            fm = FusedSWModel(grids[gname], cfg, 1.0, mu_const=mu,
                              static_rslu=True, steps_per_call=spc)
        want, ok1 = fm.run_steps(fm.pack(state), N_MAIN)
        fs = FusedSharded2DModel(grids[gname], cfg, 1.0, 2, 2,
                                 mu_const=mu, steps_per_call=spc)
        check(fs.folds == fm.folds, "the shards' folds are not the block's")
        form = "fused_sw_step_raw_" + form_name(fs)[14:]
        compare_raw(f"{label} folded, T={n_tr}", fs, cfg, state, stats,
                    form, "phase 15c")
        got, ok, n = run_sharded(f"phase 15c {label} folded {spc}", fs,
                                 state, N_MAIN)
        same = all(torch.equal(a, fl.extract(fm.lay, b))
                   for a, b in zip(got, want))
        check(ok and ok1 and same, f"phase 15c: the folded {label} shards "
              f"differ from the folded block ({spc} step(s) a launch)")
        land = land_masks(fm, grids[gname], n_tr)
        check(all(bool((f[m] == 0).all())
                  for f, m in zip(want[2:], land[2:])),
              f"phase 15c {label}: a land cell of a velocity or tracer "
              "carrier is not 0")
        t = time_sharded(fs, state, wet[gname], pts)
        run["launches"][form] = n
        run["kernels"][form] = (fs, n_tr, t)
        f_in = fs.pack(state)[0].unbind(0)
        f_out = tuple(torch.zeros_like(a) for a in f_in)
        run["plain_ms"][form] = cuda_ms(lambda: fused_sw_step_reference(
            f_in, *shard_args(fs, cfg, 0, 0), outs=f_out), 10)
        print(f"phase 15c {label} folded, 2 x 2 shards "
              f"{key_text(form_key(fs))}: {N_MAIN} steps == the folded "
              f"block {key_text(form_key(fm))} bit for bit, land exactly 0 "
              f"in the velocity carriers and tracer levels: yes; "
              f"{t['text']}")
    texts += one_fold_paths(grids["azov"], basin, prec, wet["azov"], pts,
                            run, stats, cell)
    fold_ulp_case(prec)
    print(f"phase 15d timing ({name}; {card}), folds on against off, the "
          "same run: " + " | ".join(texts))


def one_fold_paths(grid, basin, prec, wet, pts, run, stats, cell) -> list:
    """Phase 15f: elide_sel without q4 and q4 without elide_sel, JAX
    arguments whose libraries (fold codes 1, 2, 5, 6) build at first use
    (ONE_FOLD_PATHS): 200 steps through ``FusedSWModel`` on the guarded
    coastline against the eager composition, its own instantiation only;
    the kernel against its plain version with the same folds after 1 and
    ``N_ONE_FOLD_CARRY`` launches (1e-5, 1e-4); land exactly 0 in the
    velocity carriers; after ``N_FOLD_CMP`` steps against elide_sel + q4
    (code 3, 7 chained) and the unfolded kernel, bit for bit where the
    folds are exact, else the difference printed; the guard; the
    raw form with the same folds on 2 x 2 shards against its plain
    version and == the block bit for bit after 200 steps. Returns the
    timing texts."""
    from ocean_model_arch_torch.model.fused import FusedSWModel
    from ocean_model_arch_torch.model.fused_sharded2d import \
        FusedSharded2DModel
    from ocean_model_arch_torch.ops import fused_layout as fl
    from ocean_model_arch_torch.ops.fused_step import (
        fused_sw_step_blockmax, fused_sw_step_reference)
    cfg = form_cfg(basin, prec, 0, 1, 1)
    texts = []
    for label, spc, elide, q4 in ONE_FOLD_PATHS:
        fm, state, s0, n, _ = drive_path(
            f"phase 15f main path {label} (elide_sel={int(elide)}, "
            f"q4={int(q4)})", grid, cfg, True, 0.0, spc,
            {"static_rslu": True, "elide_sel": elide, "q4": q4})
        code = form_key(fm)[10]
        check(code == int(elide) + 2 * int(q4) + 4 * (spc > 1),
              f"{label}: fold code {code}")
        form = form_name(fm)
        run["launches"][form] = n
        args = model_args(fm, cfg)
        k1, bmx = fused_sw_step_blockmax(s0, *args)
        r1, rmx = fused_sw_step_reference(s0, *args)
        e1 = max(rel_err(a, b) for a, b in zip(k1, r1))
        ks, rs = s0, s0
        for _ in range(N_ONE_FOLD_CARRY):
            ks, _ = fused_sw_step_blockmax(ks, *args)
            rs, _ = fused_sw_step_reference(rs, *args)
        torch.cuda.synchronize()
        en = max(rel_err(a, b) for a, b in zip(ks, rs))
        check(e1 <= TOL_ONE and en <= TOL_CARRY, f"{label}: kernel vs plain "
              f"rel err {e1:.2e} (1 launch), {en:.2e} "
              f"({N_ONE_FOLD_CARRY} launches)")
        check(abs(float(bmx.max()) - float(rmx)) <= TOL_ONE * float(rmx),
              f"{label}: block max {float(bmx.max())} vs plain {float(rmx)}")
        stats[form] = max(float((a - b).abs().max())
                          for a, b in zip(ks + k1, rs + r1))
        land = land_masks(fm, grid, 0)
        check(all(bool((f[m] == 0).all())
                  for f, m in zip(ks[2:], land[2:])),
              f"{label}: a land cell of a velocity carrier is not 0")
        b, bok = fm.run_steps(s0, N_FOLD_CMP)
        cmp = []
        for what, kw in (("elide_sel + q4", {}), ("unfolded", UNFOLDED)):
            other = FusedSWModel(grid, cfg, 1.0, static_rslu=True,
                                 steps_per_call=spc, tile_guard=True, **kw)
            a, aok = other.run_steps(other.pack(state), N_FOLD_CMP)
            check(aok and bok, f"{label}: a guard tripped")
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            ef = max(rel_err(x, y) for x, y in zip(b, a))
            lim = TOL_CARRY if other.share_prev != fm.share_prev else TOL_FOLD
            check(ef <= lim, f"{label}: against {what} rel err {ef:.2e}")
            cmp.append(f"against {what} {key_text(form_key(other))} "
                       + ("bit for bit" if same else
                          f"rel err {ef:.2e} <= {lim}"))
        guard_trips(fm, s0, cell, f"phase 15f {label}")
        fs = FusedSharded2DModel(grid, cfg, 1.0, 2, 2, steps_per_call=spc,
                                 elide_sel=elide, q4=q4)
        check(fs.folds == fm.folds, f"{label}: the shards' folds")
        compare_raw(f"{label}, T=0", fs, cfg, state, stats,
                    "fused_sw_step_raw_" + form_name(fs)[14:], "phase 15f")
        got, ok, _ = run_sharded(f"phase 15f {label}", fs, state, N_MAIN)
        want, okb = fm.run_steps(fm.pack(state), N_MAIN)
        check(ok and okb and all(torch.equal(a, fl.extract(fm.lay, b))
                                 for a, b in zip(got, want)),
              f"phase 15f {label}: the 2 x 2 shards differ from the block")
        t = time_path(fm, cfg, s0, wet, pts)
        run["kernels"][form] = (fm, 0, t)
        run["plain_ms"][form] = cuda_ms(
            lambda: fused_sw_step_reference(s0, *args), 10)
        print(f"phase 15f {label} {key_text(form_key(fm))}: kernel vs plain "
              f"(same folds) rel err {e1:.2e} <= {TOL_ONE} after 1 launch, "
              f"{en:.2e} <= {TOL_CARRY} after {N_ONE_FOLD_CARRY}; land "
              f"exactly 0: yes; after {N_FOLD_CMP} steps " + ", ".join(cmp)
              + "; guard: ok=False on a NaN ssh and an sshp spike: yes; "
              f"2 x 2 shards {key_text(form_key(fs))} == the block after "
              f"{N_MAIN} steps: yes; kernel {t['ms_kernel'] * 1e3:.2f} us a "
              "launch")
        texts.append(f"{label} {key_text(form_key(fm))}: kernel "
                     f"{t['ms_kernel'] * 1e3:.2f} us a launch, path "
                     f"{t['ms_path']:.4f} ms/step")
    return texts


def fold_ulp_case(prec) -> None:
    """Phase 15e: tests/test_fused.py's round-5 cases on the card, the
    70 x 52 island basin, 30 steps at two a launch: elide_sel + q4 (with
    share_prev, as the JAX tests run them) against share_prev alone
    within 1e-6, also with 2 tracers and mu = 500 and with ``T_PATH``
    (the run-time tracer count); share_prev against none within 1e-5;
    land exactly 0 in the velocity carriers and tracer levels."""
    from ocean_model_arch_torch.core.grid import build_grid
    from ocean_model_arch_torch.host import frame_of_land_mask
    from ocean_model_arch_torch.config import basinpar_flat
    from ocean_model_arch_torch.model.fused import FusedSWModel
    from ocean_model_arch_torch.model.init import init_ocean_state
    basin = basinpar_flat(70, 52, curve_grid=1, rlon=27.5, rlat=41.0)
    mask = frame_of_land_mask(70, 52)
    rng = np.random.RandomState(3)
    mask[2:-2, 2:-2] |= (rng.rand(66, 48) < 0.15).astype(np.int32)
    grid = build_grid(basin, mask, precision=prec)
    errs = []
    for n_tr, mu in ((0, 0.0), (N_TRACERS, 500.0), (T_PATH, 0.0)):
        cfg = form_cfg(basin, prec, n_tr, 1, 1)
        state = with_mu(init_ocean_state(grid, cfg), mu)
        runs = {}
        for what, kw in (("all", {}), ("share", {"elide_sel": False,
                                                 "q4": False}),
                         ("eq", {"share_prev": False})):
            m = FusedSWModel(grid, cfg, 1.0, mu_const=mu, static_rslu=True,
                             steps_per_call=2, **kw)
            runs[what], ok = m.run_steps(m.pack(state), N_FOLD_CMP)
            check(ok, f"phase 15e T={n_tr}: the guard tripped")
            land = land_masks(m, grid, n_tr)
            check(all(bool((f[w] == 0).all())
                      for f, w in zip(runs[what][2:], land[2:])),
                  f"phase 15e T={n_tr} {what}: a land cell is not 0")
        e_eq = max(rel_err(a, b) for a, b in zip(runs["all"], runs["share"]))
        check(e_eq <= TOL_FOLD, f"phase 15e T={n_tr}: elide_sel + q4 rel "
              f"err {e_eq:.2e} > {TOL_FOLD}")
        errs.append(f"T={n_tr} mu={mu:g}: elide_sel + q4 {e_eq:.2e} <= "
                    f"{TOL_FOLD}")
        if not n_tr:
            e_s = max(rel_err(a, b) for a, b in zip(runs["all"], runs["eq"]))
            check(e_s <= TOL_SHARE, f"phase 15e: share_prev rel err "
                  f"{e_s:.2e} > {TOL_SHARE}")
            errs.append(f"T=0: share_prev {e_s:.2e} <= {TOL_SHARE}")
    print("phase 15e tests/test_fused.py's round-5 cases on the card (70 x "
          f"52 islands, {N_FOLD_CMP} steps, two a launch): "
          + "; ".join(errs) + "; land exactly 0 in the velocity carriers "
          "and tracer levels: yes")


# ---- phase 16: the op-cost probes (K6, K7) ------------------------------------

PROBE_SEED = 7           # the kernel-vs-plain inputs: [0.5, 1.5) from numpy
TOL_PROBE = 1e-6         # max |kernel - plain| / max |plain| over the interior


def probe_phase(card: str, name: str) -> list:
    """Phase 16: K6 and K7. (a) every kind at both Ks of its probe, the
    kernel against the plain version after 1 and 3 carried calls on seeded
    inputs at the scripts' layouts (rel <= 1e-6 over the interior rows,
    the same non-finite cells, margins the input's; the carrier is one
    fused multiply-add on both sides, IEEE division on both; ``rcp`` runs
    rcp.approx, whose plain version is the exact 1 / b, an ulp apart
    before the carrier's 1e-4 weight); the SASS instructions an iteration
    of each kind; (b) the two scripts' own timing at their n, their
    launches counted (zeroed just before each script, read just after).
    Returns the kernels line's entries."""
    from ocean_model_arch_torch.ops import vpu_probe as vp
    n_cmp, worst = 0, {}
    for ks, kinds, ys in ((vp.OP_KS, vp.KINDS, vp.YS_OP),
                          (vp.SHIFT_KS, vp.SHIFT_KINDS, vp.YS_SHIFT)):
        x = vp.probe_input(ys, "cuda", PROBE_SEED)
        for kind in kinds:
            for k in ks:
                for n in (1, 3):
                    got = vp.vpu_probe(x, kind, k, n)
                    want = vp.vpu_probe_reference(x, kind, k, n)
                    torch.cuda.synchronize()
                    a, b = got[vp.M:-vp.M], want[vp.M:-vp.M]
                    fin = torch.isfinite(b)
                    check(torch.equal(torch.isfinite(a), fin)
                          and torch.equal(a[~fin], b[~fin])
                          and torch.equal(got[:vp.M], x[:vp.M])
                          and torch.equal(got[-vp.M:], x[-vp.M:]),
                          f"probe {kind} K={k} n={n}: non-finite cells or "
                          "margins differ")
                    scale = max(float(b[fin].abs().max()), 1e-30)
                    err = float((a[fin] - b[fin]).abs().max()) / scale
                    check(err <= TOL_PROBE, f"probe {kind} K={k} n={n} "
                          f"(YS {ys}): kernel vs plain rel err {err:.2e}")
                    key = (kind, k, ys)
                    worst[key] = max(worst.get(key, 0.0),
                                     float((a[fin] - b[fin]).abs().max()))
                    n_cmp += 1
    sass = vp.sass_per_iteration(*vp.OP_KS)
    check(all(sass.values()), f"SASS: a kind with no instructions an "
          f"iteration: {sass}")
    sass_text = "; ".join(
        f"{kind} {sum(c.values()):.2f} ("
        + ", ".join(f"{op} {v:g}" for op, v in c.items()) + ")"
        for kind, c in sass.items())
    print(f"phase 16a probes (K6, K7) kernel vs plain: {n_cmp} comparisons "
          f"(every kind at K = {vp.OP_KS} on {vp.XS}x{vp.YS_OP}, the shift "
          f"kinds at K = {vp.SHIFT_KS} on {vp.XS}x{vp.YS_SHIFT}; 1 and 3 "
          f"carried calls) rel err <= {max(v for v in worst.values()):.2e} "
          f"(<= {TOL_PROBE}); margins the input's, non-finite cells alike: "
          f"yes; SASS instructions an iteration (K = {vp.OP_KS[1]} less K = "
          f"{vp.OP_KS[0]}, cuobjdump -sass; the rolls: a pass of a thread's "
          f"loop): {sass_text}", flush=True)

    entries = []
    for script, ks, kinds, ys, n, replaces_at in (
            ("vpu_op_probe", vp.OP_KS, vp.KINDS, vp.YS_OP, vp.OP_N,
             "scripts/vpu_op_probe.py:88"),
            ("vpu_shift_probe", vp.SHIFT_KS, vp.SHIFT_KINDS, vp.YS_SHIFT,
             vp.SHIFT_N, "scripts/vpu_shift_probe.py:50")):
        mod = load_script(script + "_torch")
        lines = []
        vp.reset_launch_counts()
        if script == "vpu_op_probe":
            times = mod.probe(kinds, ks, n, ys, True, "cuda", lines.append)
        else:
            times = mod.shift(ks, n, "cuda", lines.append)
        counts = dict(vp.vpu_probe.form_launches)
        print(f"phase 16b {script}_torch (n = {n}; device ms a call, the "
              f"best of three runs; {name}; {card}): " + " | ".join(
                  " ".join(ln.split()) for ln in lines), flush=True)
        x = vp.probe_input(ys, "cuda", PROBE_SEED)
        for kind in kinds:
            for k in ks:
                launches = counts.get((kind, k), 0)
                check(launches == 4 * n, f"{script}: {kind} K={k} launched "
                      f"{launches} times, expected {4 * n}")
                b_ms, b_by, _ = vp.bound(kind, k, ys, PEAK_BYTES, PEAK_FLOPS)
                entries.append({
                    "name": f"{script}_{kind}_K{k}", "route": "cuda",
                    "source": CSRC + "vpu_probe.cu", "replaces": replaces_at,
                    "launches": launches,
                    "max_abs_err": worst[kind, k, ys],
                    "ms": times[kind][k],
                    "plain_ms": cuda_ms(
                        lambda: vp.vpu_probe_reference(x, kind, k), 3),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    return entries


def fl_margin(steps: int, fs) -> int:
    from ocean_model_arch_torch.ops import fused_layout as fl
    return fl.margin_for(steps, fs.n_tracers)


def main(argv=()) -> int:
    if argv and (len(argv) not in (2, 3) or argv[0] != "--parent"
                 or argv[2:] not in ([], ["--bathymetry"], ["--general"])):
        print("usage: chip_smoke.py [--parent DIR [--bathymetry | "
              "--general]]", file=sys.stderr)
        return 2
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
    from ocean_model_arch_torch.ops import _build, copy_step as cs
    from ocean_model_arch_torch.ops.fused_step import (
        TILES, _library as _fused_library, chain_smem, fold_targets,
        fused_sw_step, fused_sw_step_reference, general_geometry,
        library_target, library_targets, persist_targets, tile_shape)
    from ocean_model_arch_torch.ops import vpu_probe as vp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: device and kernel build ------------------------------
    name = torch.cuda.get_device_name(0)
    card = gpu_line()
    nvcc_ver = subprocess.run([_build.nvcc(), "--version"],
                              capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[-1]
    vpu_targets = tuple(vp.target(k) for k in sorted(set(vp.OP_KS
                                                         + vp.SHIFT_KS)))
    targets = (library_targets() + library_targets(general=True)
               + persist_targets() + ("copy_step", "persistent_probe")
               + vpu_targets)
    # the seconds each phase took, printed as each ends and at the end
    marks = [("start", time.perf_counter())]

    def mark(phase: str) -> None:
        marks.append((phase, time.perf_counter()))
        print(f"phase {phase} took {marks[-1][1] - marks[-2][1]:.1f} s "
              f"({marks[-1][1] - marks[0][1]:.1f} s in all)", flush=True)

    # the chained forms' launch bound: 65536 registers over its threads
    # and blocks an SM (phase 1's checks hold it against the library's)
    chain_regs = 65536 // (TILES[2][2] * TILES[2][3])
    gen_tma = tuple(t for t in library_targets(general=True)
                    if general_loads_by_tma(t))
    gen_threads = tuple(t for t in library_targets(general=True)
                        if t not in gen_tma)

    def sass_checks() -> str:
        """Phase 1's look at the libraries' SASS (cuobjdump, minutes of
        CPU for about 100 libraries)."""
        return (
            "phase 1 SASS: the persistent libraries' loads of the carried "
            "fields through the non-coherent path (LDG .CONSTANT / .NC): "
            + nc_loads(persist_targets()) + "; TMA loads (UTMALDG) "
            + tma_loads(library_targets() + ("copy_step",)
                        + persist_targets() + gen_tma, gen_threads)
            + "; window loads in SASS (the innermost loop that loads "
            "window cells): " + "; ".join(
                loader_sass(label, _build.build(t), kern)
                for label, t, kern in (
                    ("copy step by threads <0,1,0,0>", "copy_step",
                     "copy_step_kernelILi0ELi1ELb0ELb0E"),
                    ("copy step by TMA <0,1,0,1>", "copy_step",
                     "copy_step_kernelILi0ELi1ELb0ELb1E"),
                    ("fused step T=0 one step <0,0,0,0,0,0,1,1,1,0>",
                     library_targets()[0],
                     "fused_sw_step_kernelILi0ELb0ELb0ELi0ELb0ELb0ELb1"
                     "ELb1ELi1ELb0E"),
                    ("general step T=0 one step <0,0,0,0,0,0,1,1,1,1>",
                     library_targets(general=True)[0],
                     "fused_sw_step_kernelILi0ELb0ELb0ELi0ELb0ELb0ELb1"
                     "ELb1ELi1ELb1E"),
                    ("persistent walk T=0 <0,0,0,1,1>", persist_targets()[0],
                     "fused_sw_persist_kernelILi0ELi0ELb0ELb1ELb1E"))))

    t0 = time.perf_counter()
    if argv:
        _build.build_all(targets)
        build_s = time.perf_counter() - t0
        build_how = "at once"
    else:
        # Every library builds behind the phases on the card, at nice 10,
        # a core's worth at a time, about in the order the phases need
        # them: the fast one-step forms, the folded ones the entry points
        # launch (phases 9b-17c: built in front as each phase loaded them,
        # they took 90-110 s of a run), the rest of the fast ones, the
        # general and persistent forms, the probes, then the other folded
        # twins (phase 15). A phase that loads a library not
        # built yet builds it itself, or waits for the build under way.
        # In the foreground the 93 took 266 s before phase 2 and the run
        # 1071.5 s of command (H100 host, 8 cores); phase 1's checks of
        # the builds print at the end, its SASS is read behind the phases
        # once the build is done.
        first = tuple(library_target(n) for n in (0, 1, 2))
        queue = tuple(dict.fromkeys(
            first + entry_fold_targets() + library_targets()
            + library_targets(general=True) + persist_targets()
            + ("copy_step", "persistent_probe") + vpu_targets
            + fold_targets() + one_fold_targets()))
        build = concurrent.futures.ThreadPoolExecutor(1).submit(
            build_behind, queue)

        def after_build():
            build.result()
            os.nice(10)
            return time.perf_counter() - t0, sass_checks()
        sass = concurrent.futures.ThreadPoolExecutor(1).submit(after_build)
        build_how = "behind the phases on the card (nice 10)"

    def phase1_checks():
        """Phase 1's lines: the builds' registers and spills, the loader's
        geometry, the walk's grid."""
        libs = [_build.build(t) for t in targets]
        lib2 = _fused_library(steps=2)
        check(chain_regs == 65536 // (lib2.fused_sw_step_threads()
                                      * lib2.fused_sw_step_min_blocks()),
              "the chained library's launch bound is not TILES[2]'s")
        fused_regs = [row for t in library_targets() for row in ptxas_table(
            _build.BUILDS.get(t, {}).get("log", ""))]
        gen_regs = [row for t in library_targets(general=True) for row in
                    ptxas_table(_build.BUILDS.get(t, {}).get("log", ""))]
        copy_regs = ptxas_table(_build.BUILDS.get("copy_step", {}).get(
            "log", ""))
        persist_regs = [row for t in persist_targets() for row in ptxas_table(
            _build.BUILDS.get(t, {}).get("log", ""))]
        walk_regs = [(int(m.group(1)), int(m.group(2))) for m in re.finditer(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads",
            _build.BUILDS.get("persistent_probe", {}).get("log", ""))]
        print(card)
        print(f"phase 1 device: {name}; torch {torch.__version__} cuda "
              f"{torch.version.cuda}; {nvcc_ver}; kernel build "
              f"({len(targets)} libraries {build_how}) {build_s:.2f} s -> "
              + ", ".join(os.path.relpath(so, REPO) for so in libs)
              + f"; ptxas, {len(fused_regs)} instantiations of "
              "fused_sw_step_kernel<tracers,guard,plane metrics,mu mode,"
              "bathymetry planes,raw,advection,full free surface,steps>: "
              + ptxas_summary(fused_regs)
              + f"; the general form (general = 1, {len(gen_regs)} "
              "instantiations): " + ptxas_summary(gen_regs)
              + f"; the persistent form (K2, {len(persist_regs)} "
              "instantiations of fused_sw_persist_kernel<tracers,mu mode,"
              "bathymetry planes,advection,full free surface>, fast then "
              "general libraries): " + ptxas_summary(persist_regs)
              + "; walk_kernel<in place> (K5): spill bytes "
              + (", ".join(f"{a} + {b}" for a, b in walk_regs)
                 or "(cached)")
              + "; copy_step_kernel<tracer window,steps,stacked>: "
              + ptxas_summary(copy_regs) + "; the op-cost probes (K6, K7, "
              + ", ".join(vpu_targets) + "): " + ptxas_summary(
                  [r for t in vpu_targets for r in vpu_ptxas(
                      _build.BUILDS.get(t, {}).get("log", ""))])
              + f"; chained tile "
              f"{tile_shape('cuda', 2)} of {lib2.fused_sw_step_threads()} "
              f"threads, launch bound {lib2.fused_sw_step_min_blocks()} "
              f"blocks an SM ({chain_regs} registers); chained shared memory "
              "a block, T: KB (tracer levels kept / 2 T; viscous) "
              + ", ".join(
                  f"{t}: {a / 1024:.1f} ({la}/{2 * t}; {b / 1024:.1f}, "
                  f"{lb}/{2 * t})" for t in range(3, 11)
                  for (a, la), (b, lb) in [(chain_smem(t),
                                            chain_smem(t, True))]))
        # the steps a launch: the fused kernel's ninth template argument,
        # the copy kernel's second
        over = [r for r in fused_regs + gen_regs + copy_regs
                if r[1] > (chain_regs if r[0][1:-1].split(",")[
                    8 if r in fused_regs or r in gen_regs else 1] == "2"
                           else MAX_REGS)
                or r[2] != 0]
        over += [r for r in persist_regs if r[1] > MAX_REGS or r[2] != 0]
        over += [r for r in walk_regs if r != (0, 0)]
        check(not over, f"instantiations above {MAX_REGS} registers (one "
              f"step a launch) or {chain_regs} (chained), or with spills: "
              f"{over}")
        if all(t in _build.BUILDS for t in targets):     # none was cached
            check(len(fused_regs) == 1408 and len(gen_regs) == 704
                  and len(copy_regs) == 12 and len(persist_regs) == 132
                  and len(walk_regs) == 2,
                  f"{len(fused_regs)} fused, {len(gen_regs)} general, "
                  f"{len(persist_regs)} persistent, {len(copy_regs)} "
                  f"copy-step and {len(walk_regs)} walk instantiations in "
                  "the build logs")
        check(all(cs.tile_shape("cuda", s) == tile_shape("cuda", s)
                  for s in (1, 2)),
              "the copy step and the fused step were built with different "
              "tiles")
        print("phase 1 loader: " + geometry_mirror(), flush=True)
        print("phase 1 persistent grid: " + persistent_grids(), flush=True)

    if argv:
        phase1_checks()
        print(sass_checks(), flush=True)
        return against_parent(argv[1], card, chain_regs,
                              argv[2] if argv[2:] else None)
    print(card)
    mark("1")

    basin = basinpar_as250m_test()
    basin_b = dataclasses.replace(basin, curve_grid=2)
    basin_s = dataclasses.replace(basin, nx=289, ny=163, dxst=0.05,
                                  dyst=0.04, rlon=27.525, rlat=40.94,
                                  curve_grid=2)
    prec = Precision.f32()
    pts = basin.nx * basin.ny

    def configs(b):
        return {0: ModelConfig(basin=b, sw=SWConfig(use_tracers=0),
                               precision=prec),
                N_TRACERS: ModelConfig(
                    basin=b, sw=SWConfig(use_tracers=1,
                                         tracer_num=N_TRACERS),
                    precision=prec)}

    cfgs, cfgs_b, cfgs_s = configs(basin), configs(basin_b), configs(basin_s)
    masks = {
        "frame": frame_of_land_mask(basin.nx, basin.ny),
        "azov": read_mask(os.path.join(REPO, "data", "AS",
                                       "maskAzovCor.txt"),
                          basin.nx, basin.ny),
    }
    # no device argument: the entry points place their tensors on the card
    grids = {m: build_grid(basin, mask, precision=prec)
             for m, mask in masks.items()}
    grids["bipolar_azov"] = build_grid(basin_b, masks["azov"],
                                       precision=prec)
    grids["bipolar"] = build_grid(
        basin_s, frame_of_land_mask(basin_s.nx, basin_s.ny), precision=prec)
    # the same coastline over varying bathymetry (15-100 m)
    hr = bathymetry(basin.nx, basin.ny)
    grids["azov_hr"] = build_grid(basin, masks["azov"], hhq_rest=hr,
                                  precision=prec)
    grids["bipolar_azov_hr"] = build_grid(basin_b, masks["azov"],
                                          hhq_rest=hr, precision=prec)
    check(all(g.lu.is_cuda for g in grids.values()),
          "build_grid without a device did not use the card")
    wet = {m: int((g.lu > 0.5).sum()) for m, g in grids.items()}

    # ---- phase 2: every kernel form vs its plain version ---------------
    max_abs: dict = {}
    for mname in ("frame", "azov"):
        compare_forms(mname, grids[mname], cfgs, max_abs)
    # the 1-tracer instantiation, which no path below launches
    compare_forms("azov", grids["azov"], {1: ModelConfig(
        basin=basin, sw=SWConfig(use_tracers=1, tracer_num=1),
        precision=prec)}, max_abs)
    # the plane-metric instantiations, on the bipolar grid
    compare_forms("bipolar_azov", grids["bipolar_azov"], cfgs_b, max_abs)
    # viscosity, varying bathymetry and both, on profile metrics
    compare_forms("azov mu=1000", grids["azov"], cfgs, max_abs, MU)
    compare_forms("azov 15-100 m", grids["azov_hr"], cfgs, max_abs)
    compare_forms("azov mu=1000 15-100 m", grids["azov_hr"], cfgs, max_abs,
                  MU)
    # the tracers' diffusive fluxes without the viscosity (ksw_lat = 0)
    cfg_diff = ModelConfig(basin=basin, sw=SWConfig(
        use_tracers=1, tracer_num=N_TRACERS, ksw_lat=0), precision=prec)
    compare_forms("azov mu=1000 ksw_lat=0", grids["azov"],
                  {N_TRACERS: cfg_diff}, max_abs, MU)
    # and on plane metrics: viscosity alone, then with the bathymetry
    compare_forms("bipolar_azov mu=1000", grids["bipolar_azov"],
                  {0: cfgs_b[0]}, max_abs, MU)
    compare_forms("bipolar_azov mu=1000 15-100 m", grids["bipolar_azov_hr"],
                  cfgs_b, max_abs, MU)

    mark("2")

    # ---- phase 3: the first main path (frame, no tracers, unguarded) ---
    launches = {}
    fm, state, s0, launches["fused_sw_step"], _ = drive_path(
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
    fm_t, state_t, s0_t, launches["fused_sw_step_tracers"], _ = drive_path(
        f"phase 5 main path (azov coastline, {N_TRACERS} tracers)",
        grids["azov"], cfgs[N_TRACERS], None)
    fm_c, _, s0_c, launches["fused_sw_step_guarded"], _ = drive_path(
        "phase 5 sub-path (azov coastline, no tracers)", grids["azov"],
        cfgs[0], None)
    check(fm_t.tile_guard and fm_c.tile_guard,
          "the coastline did not turn the tile guard on")
    _, _, s0_f, _, _ = drive_path(
        f"phase 5 sub-path (frame mask, {N_TRACERS} tracers)",
        grids["frame"], cfgs[N_TRACERS], None)

    def model(mname, cfg, guard):
        return FusedSWModel(grids[mname], cfg, 1.0, static_rslu=True,
                            tile_guard=guard, **UNFOLDED)

    cfg1 = ModelConfig(basin=basin, sw=SWConfig(use_tracers=1, tracer_num=1),
                       precision=prec)
    fm_f1 = model("frame", cfg1, False)
    s0_f1 = fm_f1.pack(init_ocean_state(grids["frame"], cfg1))
    fm_fu = model("frame", cfgs[N_TRACERS], False)
    fm_off = model("azov", cfgs[0], False)
    # what FusedSWModel's default gives on the frame mask: the guard on
    fm_auto = model("frame", cfgs[0], None)
    t_tr = time_path(fm_t, cfgs[N_TRACERS], s0_t, wet["azov"], pts)
    t_fu = time_path(fm_fu, cfgs[N_TRACERS], s0_f, wet["frame"], pts)
    t_f1 = time_path(fm_f1, cfg1, s0_f1, wet["frame"], pts)
    t_on = time_path(fm_c, cfgs[0], s0_c, wet["azov"], pts)
    t_off = time_path(fm_off, cfgs[0], s0_c, wet["azov"], pts)
    t_auto = time_path(fm_auto, cfgs[0], s0, wet["frame"], pts)
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

    # ---- phase 6: the third main path (2D metrics) and its sub-paths ---
    fm_b, state_b, s0_b, launches["fused_sw_step_fast2d"], _ = drive_path(
        "phase 6 main path bipolar_azov (azov coastline on the bipolar "
        "grid, no tracers)", grids["bipolar_azov"], cfgs_b[0], None)
    check(fm_b.metrics_2d and fm_b.fast2d and fm_b.tile_guard,
          "bipolar_azov did not run guarded on plane metrics")
    fm_bt, _, s0_bt, _, _ = drive_path(
        f"phase 6 sub-path bipolar_azov with {N_TRACERS} tracers",
        grids["bipolar_azov"], cfgs_b[N_TRACERS], None)
    fm_s, _, s0_s, _, _ = drive_path(
        f"phase 6 sub-path bipolar ({basin_s.nx} x {basin_s.ny}, frame "
        "mask, no tracers)", grids["bipolar"], cfgs_s[0], None)
    check(fm_bt.metrics_2d and fm_s.metrics_2d,
          "a bipolar sub-path did not run on plane metrics")
    fm_boff = model("bipolar_azov", cfgs_b[0], False)
    pts_s = basin_s.nx * basin_s.ny
    t_b = time_path(fm_b, cfgs_b[0], s0_b, wet["bipolar_azov"], pts)
    t_boff = time_path(fm_boff, cfgs_b[0], s0_b, wet["bipolar_azov"], pts)
    t_bt = time_path(fm_bt, cfgs_b[N_TRACERS], s0_bt, wet["bipolar_azov"],
                     pts)
    t_s = time_path(fm_s, cfgs_s[0], s0_s, wet["bipolar"], pts_s)
    kernels["fused_sw_step_fast2d"] = (fm_b, 0, t_b)
    plain_ms["fused_sw_step_fast2d"] = cuda_ms(
        lambda: fused_sw_step_reference(s0_b, *model_args(fm_b, cfgs_b[0])),
        20)
    step_b = make_step(grids["bipolar_azov"], cfgs_b[0])
    ms_eager_b = cuda_ms(lambda: step_b(state_b, 1.0), 20)
    print(f"phase 6 timing ({name}; {card}), wet points bipolar_azov "
          f"{wet['bipolar_azov']} of {pts}, bipolar {wet['bipolar']} of "
          f"{pts_s}: bipolar_azov/no tracers/guard on {t_b['text']} | "
          f"bipolar_azov/no tracers/guard off {t_boff['text']} | "
          f"bipolar_azov/{N_TRACERS} tracers/guard on {t_bt['text']} | "
          f"bipolar/no tracers/guard "
          f"{'on' if fm_s.tile_guard else 'off'} {t_s['text']}; plain fused "
          f"version {plain_ms['fused_sw_step_fast2d']:.4f} ms/step, eager "
          f"composition {ms_eager_b:.4f} ms/step (bipolar_azov, no tracers)")

    # the guard at a wet cell of the coastline: tracers carried on the
    # spherical grid, plane metrics on the bipolar grid
    lu = grids["azov"].lu
    ij = torch.nonzero(lu > 0.5).double()
    centre = torch.tensor([basin.nx / 2, basin.ny / 2], dtype=ij.dtype,
                          device=ij.device)
    i, j = (int(v) for v in
            ij[((ij - centre) ** 2).sum(1).argmin()].tolist())
    check(bool(lu[i, j] > 0.5), "the injection cell is not wet")
    cell = (lay.margin + i, lay.margin + j)
    guard_trips(fm_t, s0_t, cell, "azov coastline with tracers")
    guard_trips(fm_b, s0_b, cell, "bipolar_azov")
    print("phase 4 guard: ok=False on an injected NaN ssh and on an sshp "
          "spike of 2e4 (|ssh| > 1e4 at the next step), on the frame mask, "
          f"at wet cell ({i}, {j}) of the azov coastline with "
          f"{N_TRACERS} tracers carried, and at the same cell of "
          "bipolar_azov")

    mark("3-6")

    # ---- phase 8: the fourth main path (viscosity, bathymetry) ---------
    fm_v, state_v, s0_v, launches["fused_sw_step_visc_bathy_tracers"], \
        out_v = drive_path(
            f"phase 8 main path azov_visc (azov coastline, 15-100 m "
            f"bathymetry, mu = {MU:g}, {N_TRACERS} tracers)",
            grids["azov_hr"], cfgs[N_TRACERS], None, MU)
    check(fm_v.visc and fm_v.hr_const is None and fm_v.tile_guard
          and fm_v.planes.shape[0] == 6,
          "azov_visc did not run guarded with viscosity on bathymetry planes")
    fm_va, _, s0_va, launches["fused_sw_step_visc"], _ = drive_path(
        f"phase 8 sub-path a (azov coastline, flat 100 m, mu = {MU:g}, no "
        "tracers)", grids["azov"], cfgs[0], None, MU)
    fm_vb, _, s0_vb, launches["fused_sw_step_bathy"], _ = drive_path(
        "phase 8 sub-path b (azov coastline, 15-100 m bathymetry, mu = 0, "
        "no tracers)", grids["azov_hr"], cfgs[0], None)
    fm_vc, _, s0_vc, launches["fused_sw_step_visc_bathy_fast2d"], _ = \
        drive_path(
            f"phase 8 sub-path c (bipolar_azov, 15-100 m bathymetry, mu = "
            f"{MU:g}, no tracers)", grids["bipolar_azov_hr"], cfgs_b[0],
            None, MU)
    check(fm_va.visc and fm_va.hr_const == 100.0 and not fm_vb.visc
          and fm_vb.hr_const is None and fm_vb.planes.shape[0] == 5
          and fm_vc.visc and fm_vc.metrics_2d and fm_vc.met.shape[0] == 17,
          "a sub-path of azov_visc ran another form than its own")
    # what the viscosity did: the same run with mu = 0
    _, _, _, _, out_0 = drive_path(
        "phase 8 comparison (azov_visc with mu = 0)", grids["azov_hr"],
        cfgs[N_TRACERS], None)
    u_v, u_0 = (float(o.ubrtr.abs().max()) for o in (out_v, out_0))
    du = float((out_v.ubrtr - out_0.ubrtr).abs().max())
    check(du > 0.0, "mu = 1000 changed nothing in u after 200 steps")
    print(f"phase 8 viscosity: max |u| after {N_MAIN} steps {u_v:.6e} with "
          f"mu = {MU:g}, {u_0:.6e} with mu = 0 ({u_v / u_0 - 1:+.3%}); max "
          f"|u(mu) - u(0)| {du:.3e}; max |ff[0](mu) - ff[0](0)| "
          f"{float((out_v.ff[0] - out_0.ff[0]).abs().max()):.3e}")
    guard_trips(fm_v, s0_v, cell, "azov_visc")
    print("phase 8 guard: ok=False on an injected NaN ssh and on an sshp "
          f"spike of 2e4 at wet cell ({i}, {j}) of azov_visc")
    t_v = time_path(fm_v, cfgs[N_TRACERS], s0_v, wet["azov"], pts)
    t_va = time_path(fm_va, cfgs[0], s0_va, wet["azov"], pts)
    t_vb = time_path(fm_vb, cfgs[0], s0_vb, wet["azov"], pts)
    t_vc = time_path(fm_vc, cfgs_b[0], s0_vc, wet["azov"], pts)
    for form, m, cfg_m, f0, t in (
            ("fused_sw_step_visc_bathy_tracers", fm_v, cfgs[N_TRACERS],
             s0_v, t_v),
            ("fused_sw_step_visc", fm_va, cfgs[0], s0_va, t_va),
            ("fused_sw_step_bathy", fm_vb, cfgs[0], s0_vb, t_vb),
            ("fused_sw_step_visc_bathy_fast2d", fm_vc, cfgs_b[0], s0_vc,
             t_vc)):
        check(form == form_name(m), f"{form} is not {form_name(m)}")
        kernels[form] = (m, m.n_tracers, t)
        plain_ms[form] = cuda_ms(
            lambda: fused_sw_step_reference(f0, *model_args(m, cfg_m)), 10)
    step_v = make_step(grids["azov_hr"], cfgs[N_TRACERS])
    ms_eager_v = cuda_ms(lambda: step_v(state_v, 1.0), 10)
    print(f"phase 8 timing ({name}; {card}), wet points {wet['azov']} of "
          f"{pts}: azov_visc/{N_TRACERS} tracers/guard on {t_v['text']} | "
          f"a: viscosity alone/guard on {t_va['text']} | "
          f"b: bathymetry alone/guard on {t_vb['text']} | "
          f"c: bipolar_azov viscous over bathymetry/guard on "
          f"{t_vc['text']}; plain fused version "
          + ", ".join(f"{plain_ms[f]:.4f}" for f in (
              "fused_sw_step_visc_bathy_tracers", "fused_sw_step_visc",
              "fused_sw_step_bathy", "fused_sw_step_visc_bathy_fast2d"))
          + f" ms/step (in that order), eager composition of azov_visc "
          f"{ms_eager_v:.4f} ms/step")
    # the unguarded 2-tracer plane-metric form, which no path launches
    fm_btoff = model("bipolar_azov", cfgs_b[N_TRACERS], False)
    t_btoff = time_path(fm_btoff, cfgs_b[N_TRACERS], s0_bt,
                        wet["bipolar_azov"], pts)

    mark("8")

    # ---- phase 9: the entry point and the raw form ---------------------
    entry_point(card, name)
    fs_ch, cfg_ch, state_ch, n_ch, wet_ch, ch_form = periodic_channel(
        card, name, max_abs)
    launches[ch_form] = n_ch
    sh_v, state_sv = sharded_2x2(
        f"azov_visc (mu = {MU:g}, 15-100 m, {N_TRACERS} tracers)",
        grids["azov_hr"], cfgs[N_TRACERS], MU, max_abs,
        "fused_sw_step_raw_visc_bathy_tracers")
    sh_b, state_sb = sharded_2x2(
        "bipolar_azov (plane metrics, no tracers)", grids["bipolar_azov"],
        cfgs_b[0], 0.0, max_abs, "fused_sw_step_raw_fast2d")
    launches["fused_sw_step_raw_visc_bathy_tracers"] = sh_v["uniform"][1]
    launches["fused_sw_step_raw_fast2d"] = sh_b["uniform"][1]
    pts_ch = cfg_ch.basin.nx * cfg_ch.basin.ny
    t_ch = time_sharded(fs_ch, state_ch, wet_ch, pts_ch)
    t_sh = {(m, c): time_sharded(sh[c][0], st, wet["azov"], pts)
            for m, sh, st in (("azov_visc", sh_v, state_sv),
                              ("bipolar_azov", sh_b, state_sb))
            for c in ("uniform", "weighted")}
    for form, fs_r, cfg_r, st_r, t in (
            (ch_form, fs_ch, cfg_ch, state_ch, t_ch),
            ("fused_sw_step_raw_visc_bathy_tracers", sh_v["uniform"][0],
             cfgs[N_TRACERS], state_sv, t_sh["azov_visc", "uniform"]),
            ("fused_sw_step_raw_fast2d", sh_b["uniform"][0], cfgs_b[0],
             state_sb, t_sh["bipolar_azov", "uniform"])):
        kernels[form] = (fs_r, fs_r.n_tracers, t)
        # the plain version's raw form on the first shard
        f_in = fs_r.pack(st_r)[0].unbind(0)
        f_out = tuple(torch.zeros_like(a) for a in f_in)
        plain_ms[form] = cuda_ms(lambda: fused_sw_step_reference(
            f_in, *shard_args(fs_r, cfg_r, 0, 0), outs=f_out), 10)
    print(f"phase 9c timing ({name}; {card}), wet points {wet_ch} of "
          f"{pts_ch}: channel/{N_TRACERS} tracers/1 x 1 shard "
          f"{t_ch['text']}; plain version of the raw form "
          f"{plain_ms[ch_form]:.4f} ms/launch")
    print(f"phase 9d timing ({name}; {card}), wet points {wet['azov']} of "
          f"{pts}: " + " | ".join(
              f"{m}/2 x 2 shards/{c} cuts {t['text']}"
              for (m, c), t in t_sh.items())
          + f"; the single block of the same configurations: azov_visc "
          f"{t_v['text']} | bipolar_azov {t_b['text']}; plain version of "
          "the raw form on one shard "
          f"{plain_ms['fused_sw_step_raw_visc_bathy_tracers']:.4f} "
          f"(azov_visc), {plain_ms['fused_sw_step_raw_fast2d']:.4f} "
          "(bipolar_azov) ms/launch")

    mark("9")

    # ---- phase 10: no advection, a linear free surface; the examples ---
    n_new = compare_new_forms(grids, basin, basin_b, prec, max_abs)
    print(f"phase 10a kernel vs plain: the {n_new} forms above (without "
          "advection, with a linear free surface, both; profile and plane "
          "metrics, T = 0 and 2, guard off and on, mu 0 and 1000 over flat "
          "and 15-100 m bathymetry, raw on 2 x 2 shards) within "
          f"{TOL_ONE} after 1 launch and {TOL_CARRY} after {N_CARRY}")
    run = {"launches": launches, "kernels": kernels, "plain_ms": plain_ms,
           "bounds": []}
    new_form_paths(grids, basin, basin_b, prec, wet, pts, card, name, run)
    shipped_examples(card, name, max_abs, run)

    mark("10")

    # ---- phase 11: two chained steps a launch --------------------------
    run["copy_chain"] = {}
    cs.copy_step.launches = 0
    cs.copy_step.loader_launches.clear()
    chained_paths(grids, cfgs, cfgs_b, basin, basin_b, prec, wet, pts, card,
                  name, run, max_abs,
                  {"azov_mask": (fm_c, t_on), "azov_tracers": (fm_t, t_tr),
                   "bipolar_azov": (fm_b, t_b), "azov_visc": (fm_v, t_v)})
    launches["copy_step_chain"] = cs.copy_step.loader_launches["tma"]

    mark("11")

    # ---- phase 12: any number of tracers --------------------------------
    n_many = many_tracer_forms(grids, basin, basin_b, prec, max_abs)
    print(f"phase 12a kernel vs plain: {n_many} forms of the run-time "
          f"tracer family (T = {', '.join(map(str, T_LOOP))}; {T_PAST} and, "
          f"viscous, {T_PAST_VISC} past the chained form's shared-memory "
          "fit; profile and plane metrics, guard off and on, mu 0 and 1000 "
          "over flat and 15-100 m bathymetry, the diffusive fluxes alone, "
          "without advection, with a linear free surface, one step and two "
          f"chained a launch, raw on 2 x 2 shards) within {TOL_ONE} after 1 "
          f"launch and {TOL_CARRY} after {N_CARRY} steps; land and all-land "
          "tiles exactly 0 in all 6 + 2 T fields; guarded == unguarded bit "
          "for bit")
    many = many_tracer_paths(grids, basin, basin_b, prec, wet, pts, card,
                             name, run, max_abs)
    many_tracer_entry_point(card, name)
    many_tracer_timing(grids, basin, prec, wet, pts, card, name, run, many)

    mark("12")

    # ---- phase 13: the general form -------------------------------------
    n_gen = general_forms(grids, basin, basin_b, prec, max_abs)
    mark("13a")
    print(f"phase 13a kernel vs plain: the general form's {n_gen} "
          "instantiations (profile and plane metrics, T = 0, 1, 2 and the "
          f"run-time family at {T_LOOP[0]}, each mu mode, with and without "
          "advection, full and linear free surface, one step and two "
          "chained a launch, guard off and on, the single block and the raw "
          "form on 2 x 2 shards) and the chained family past its "
          f"shared-memory fit ({T_PAST}; {T_PAST_VISC} viscous) within "
          f"{TOL_ONE} after 1 launch and {TOL_CARRY} after {N_CARRY} steps; "
          "land and all-land tiles exactly 0; guarded == unguarded and the "
          "static reciprocal planes == the selects bit for bit")
    fm_cc = kernels["fused_sw_step_chain_guarded"][0]
    general_paths(grids, cfgs, cfgs_b, prec, wet, pts, card, name, run,
                  max_abs, {"azov_general": (fm_c, t_on),
                            "bipolar_azov_general": (fm_b, t_b),
                            "azov_visc_general": (fm_v, t_v),
                            "azov_general chained": (
                                fm_cc, kernels["fused_sw_step_chain_guarded"]
                                [2])}, cell)

    mark("13b-c")

    # ---- phase 14: the persistent step (K2) and its probe (K5) -----------
    walk_entries = walk_phase(card, name)
    persist_entries = persistent_paths(grids, basin, prec, wet, pts, card,
                                       name, max_abs, cell, masks["azov"])

    mark("14")

    # ---- phase 15: K1's arithmetic folds ----------------------------------
    fold_phase(grids, basin, basin_b, prec, wet, pts, card, name, run,
               max_abs, cell, build, chain_regs)
    mark("15")

    # ---- phase 16: the op-cost probes (K6, K7) ----------------------------
    probe_entries = probe_phase(card, name)
    mark("16")

    # ---- phase 17: OceanModel on a mesh off the fused path; the DLB -----
    mesh_entries = mesh_route(card, name, max_abs)
    mark("17")

    # ---- phase 18: the mesh across two processes on the card -----------
    mesh_entries += process_route(card, name, max_abs)
    mark("18")

    # ---- phase 7: the copy step ----------------------------------------
    # kernel vs plain version on what each form of the fused step loads:
    # the same float additions in the same order, so exactly equal
    cs_err = 0.0
    cs_cases = (("frame T=0 profile", fm, s0),
                ("azov T=2 profile", fm_t, s0_t),
                ("bipolar_azov T=0 planes", fm_b, s0_b),
                ("bipolar_azov T=2 planes", fm_bt, s0_bt),
                ("azov_visc T=2 profile viscous bathymetry", fm_v, s0_v),
                ("bipolar_azov T=0 planes viscous bathymetry", fm_vc, s0_vc),
                (f"azov T={T_PATH} profile", *many["azov", T_PATH, 1][:2]),
                (f"azov T={T_PATH} profile chained",
                 *many["azov", T_PATH, 2][:2]))
    for tag, m, fields in cs_cases:
        windows, met = copy_step_inputs(m, fields)
        for flags, loader in itertools.product((None, m.tile_wet),
                                               cs.LOADERS):
            got = cs.copy_step(windows, met, len(fields), m.lay,
                               tracer_form=m.n_tracers, tile_wet=flags,
                               tile=m.tile, visc_form=m.visc,
                               steps=m.steps_per_call, loader=loader)
            want = cs.copy_step_reference(windows, met, len(fields), m.lay,
                                          flags, m.tile)
            torch.cuda.synchronize()
            cs_err = max([cs_err] + [float((g - w).abs().max())
                                     for g, w in zip(got, want)])
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"copy step ({tag}, guard "
                  f"{'off' if flags is None else 'on'}, loader {loader}): "
                  "kernel and plain "
                  "version differ")
    windows0, met0 = copy_step_inputs(fm, s0)
    plain_ms["copy_step"] = cuda_ms(
        lambda: cs.copy_step_reference(windows0, met0, 6, lay), 20)
    windows_t, met_t = load_script("roofline_probe_torch").form_inputs(
        lay, 0, True, "cuda", visc=True, hr_varies=True)
    plain_ms["copy_step_threads"] = cuda_ms(
        lambda: cs.copy_step_reference(windows_t, met_t, 6, lay), 20)
    # the probe's entry point: every form, random inputs from a seed
    probe = load_script("roofline_probe_torch")
    cs.copy_step.launches = 0
    cs.copy_step.loader_launches.clear()
    # the threads' loader is the floor only of the forms that keep it:
    # the viscous fast forms on metric planes (every general form the
    # probe's inputs stand for loads by TMA)
    forms = probe.probe(basin.nx, basin.ny, tuple(masks.items()), N_TIME,
                        threads=THREADS_FORMS)
    # the small bipolar basin's own layout: the plane-metric form
    forms_s = probe.probe(basin_s.nx, basin_s.ny, (
        ("frame", frame_of_land_mask(basin_s.nx, basin_s.ny)),), N_TIME,
        forms=((0, True, False, False),), threads=THREADS_FORMS)
    # the layout of one shard of the 2 x 2 uniform split (the raw form's
    # array), guarded by that shard's own part of the coastline
    fs_u = sh_v["uniform"][0]
    forms_r = probe.probe(fs_u.lx[0], fs_u.ly[0], (
        ("azov shard (0, 0)", masks["azov"][:fs_u.lx[0], :fs_u.ly[0]]),),
        N_TIME, forms=((N_TRACERS, False, True, True),
                       (0, True, False, False)), threads=THREADS_FORMS)
    launches["copy_step"] = cs.copy_step.loader_launches["tma"]
    launches["copy_step_threads"] = cs.copy_step.loader_launches["threads"]
    # K4: the stacked copy step, exactly against its plain version on the
    # card, and its us/launch against the separate form on the same planes
    cs.copy_step_stacked.launches = 0
    k4 = probe.stacked(basin.nx, basin.ny, N_TIME)
    launches["copy_step_stacked"] = cs.copy_step_stacked.launches
    check(all(r["equal"] for r in k4) and launches["copy_step_stacked"]
          == len(k4) * (N_TIME + 2), "the stacked copy step differs from its "
          f"plain version or launched {launches['copy_step_stacked']} times")
    stack0 = torch.randn((k4[0]["n_in"], lay.Xs, lay.Ys), device="cuda")
    met_k4 = torch.randn((k4[0]["n_met"], lay.Ys), device="cuda")
    plain_ms["copy_step_stacked"] = cuda_ms(lambda: cs.copy_step_reference(
        stack0.unbind(0), met_k4, k4[0]["n_out"], lay), 20)
    n_forms = len(probe.FORMS) * (1 + len(masks)) + 2 + len(forms_r)
    n_threads = sum(r["us_threads"] is not None
                    for r in forms + forms_s + forms_r)
    # each form timed by TMA, the forms that keep it by threads too
    check(launches["copy_step"] == n_forms * (N_TIME + 1)
          and launches["copy_step_threads"] == n_threads * (N_TIME + 1)
          and n_threads == len(THREADS_FORMS) * (1 + len(masks))
          and len(forms) + len(forms_s) + len(forms_r) == n_forms,
          f"the probe launched the copy step {launches['copy_step']} times "
          f"by TMA and {launches['copy_step_threads']} by threads for "
          f"{len(forms) + len(forms_s) + len(forms_r)} forms")

    def cs_key(r):
        return (r["n_tracers"], r["guard"], r["met2d"], r["visc"],
                r["hr_varies"])

    cs_us = {cs_key(r): r for r in forms}
    cs_us_s = {cs_key(r): r for r in forms_s}
    # the card's own ceiling for the T=0 profile form's bytes
    nbytes0 = probe.bytes_moved(lay, 0, False)
    us_copy_, rate = probe.copy_rate(nbytes0, N_TIME)

    def cs_text(r):
        return (f"{probe.form_name(r)} {r['us']:.2f} ("
                + (f"by threads {r['us_threads']:.2f}; "
                   if r["us_threads"] is not None else "")
                + f"{r['bound_us']:.2f}, "
                f"{r['bytes'] / 1e6:.1f} MB, "
                f"{r['bytes'] / r['us'] / 1e6:.3f} TB/s)")
    print(f"phase 7 copy step ({name}; {card}): kernel == plain version "
          f"exactly on the inputs of {len(cs_cases)} forms, guard off and "
          "on, every loader; layout "
          f"{lay.Xs}x{lay.Ys}, kernel us/launch by TMA (by threads; byte "
          f"bound at {PEAK_BYTES / 1e12:.2f} TB/s, bytes, achieved rate; "
          f"torch.profiler over {N_TIME} launches): "
          + "; ".join(cs_text(r) for r in forms)
          + f"; layout {fm_s.lay.Xs}x{fm_s.lay.Ys}: "
          + "; ".join(cs_text(r) for r in forms_s)
          + f"; layout {fs_u.lay.Xs}x{fs_u.lay.Ys} (one shard of the 2 x 2 "
          "split, the raw form's array): "
          + "; ".join(cs_text(r) for r in forms_r)
          + f"; plain version {plain_ms['copy_step']:.4f} ms (T=0 profile)"
          f"; the card's own copy rate: Tensor.copy_ moving the T=0 "
          f"profile form's {nbytes0 / 1e6:.1f} MB in {us_copy_:.2f} us, "
          f"{rate / 1e12:.3f} TB/s against {PEAK_BYTES / 1e12:.2f} (CUDA "
          f"events over {N_TIME} calls)")
    print(f"phase 7 stacked copy step (K4; {name}; {card}): kernel == plain "
          "version exactly: yes; us/launch stacked against separate "
          "(torch.profiler, the same planes; byte bound): " + "; ".join(
              f"{probe.stacked_name(r)} {r['us_stacked']:.2f} against "
              f"{r['us_separate']:.2f} "
              f"({r['us_stacked'] / r['us_separate']:.3f}; "
              f"{r['bound_us']:.2f}, {r['bytes'] / 1e6:.1f} MB)" for r in k4)
          + f"; plain version {plain_ms['copy_step_stacked']:.4f} ms (8 -> 6)")

    # every timed configuration's byte bound beside the copy step of its
    # own form, guarded by the same mask's flags
    floors = []
    for label, m, t, mask in (
            ("frame/T=0/guard off", fm, t_frame, "frame"),
            ("frame/T=0/guard auto (on)", fm_auto, t_auto, "frame"),
            ("azov/T=0/guard on", fm_c, t_on, "azov"),
            ("azov/T=0/guard off", fm_off, t_off, "azov"),
            (f"azov/T={N_TRACERS}/guard on", fm_t, t_tr, "azov"),
            (f"frame/T={N_TRACERS}/guard off", fm_fu, t_fu, "frame"),
            ("frame/T=1/guard off", fm_f1, t_f1, "frame"),
            ("bipolar_azov/T=0/guard on", fm_b, t_b, "azov"),
            ("bipolar_azov/T=0/guard off", fm_boff, t_boff, "azov"),
            (f"bipolar_azov/T={N_TRACERS}/guard on", fm_bt, t_bt, "azov"),
            (f"bipolar_azov/T={N_TRACERS}/guard off", fm_btoff, t_btoff,
             "azov"),
            (f"bipolar {basin_s.nx}x{basin_s.ny}/T=0/guard "
             f"{'on' if fm_s.tile_guard else 'off'}", fm_s, t_s, "frame"),
            (f"azov_visc/T={N_TRACERS}/guard on", fm_v, t_v, "azov"),
            ("a: viscosity alone/T=0/guard on", fm_va, t_va, "azov"),
            ("b: bathymetry alone/T=0/guard on", fm_vb, t_vb, "azov"),
            ("c: bipolar_azov viscous over bathymetry/T=0/guard on", fm_vc,
             t_vc, "azov")):
        b_ms, b_by, nbytes = bound_ms(m, m.n_tracers)
        row = (cs_us_s if m is fm_s else cs_us).get(
            (m.n_tracers, mask if m.tile_guard else None, m.metrics_2d,
             m.visc, m.hr_const is None))
        floors.append(
            f"{label}: kernel {t['ms_kernel'] * 1e3:.1f} us, "
            f"{nbytes / 1e6:.1f} MB, bound {b_ms * 1e3:.1f} us ({b_by}), "
            "copy step of its form "
            + (f"{row['us']:.1f} us" if row else "not measured"))
    # the raw form: per launch, a quarter of the step's bytes; the copy
    # step on one shard's layout stands beside it (it stores whole tiles,
    # the raw form only the shard's box)
    cs_r = {(r["n_tracers"], r["met2d"]): r for r in forms_r if r["guard"]}
    for label, t, row in (
            ("azov_visc 2 x 2 uniform, raw form", t_sh["azov_visc", "uniform"],
             cs_r[N_TRACERS, False]),
            ("bipolar_azov 2 x 2 uniform, raw form",
             t_sh["bipolar_azov", "uniform"], cs_r[0, True]),
            ("channel 1 x 1, raw form", t_ch, None)):
        floors.append(
            f"{label}: kernel {t['ms_kernel'] * 1e3:.1f} us/launch, bound "
            f"{t['bound_ms'] * 1e3:.1f} us/launch (bytes), copy step of its "
            "form on shard (0, 0)'s layout "
            + (f"{row['us']:.1f} us" if row else "not measured"))
    print(f"bounds ({card}): " + "; ".join(floors + run["bounds"]))
    mark("7")
    build_s, sass_text = sass.result()
    phase1_checks()
    print(sass_text, flush=True)
    mark("1 (its checks)")
    print(f"phase seconds ({card}): " + ", ".join(
        f"{k} {t - t0:.1f}" for (_, t0), (k, t) in zip(marks, marks[1:]))
        + f"; all {marks[-1][1] - marks[0][1]:.1f}")

    entries = []
    for form, (m, n_tr, t) in kernels.items():
        if hasattr(m, "shard_lay"):      # the raw form: one launch a shard
            b_ms, b_by = t["bound_ms"], "bytes"
        else:
            b_ms, b_by, _ = bound_ms(m, n_tr)
        check(launches[form] > 0, f"{form} was never launched on its path")
        by_tma = (general_geometry(m.n_tracers, m.steps_per_call, m.visc).tma
                  if m.general else not (m.metrics_2d and m.visc))
        entries.append({
            "name": form, "route": "cuda", "source": CSRC + "fused_step.cu",
            "replaces": replaces(form), "launches": launches[form],
            "max_abs_err": max_abs[form], "ms": t["ms_kernel"],
            "plain_ms": plain_ms[form], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "loader": "tma" if by_tma else "threads"})
    # the copy step beside the fused step's first form (T=0, profile) by
    # TMA, and by threads beside the form that keeps that loader (the
    # viscous one on metric planes over bathymetry; the phase-7 launches
    # of each)
    row0, row_t = (cs_us[(*f[:1], None, *f[1:])] for f in
                   ((0, False, False, False), THREADS_FORMS[0]))
    for entry, row, key in (("copy_step", row0, "us"),
                            ("copy_step_threads", row_t, "us_threads")):
        entries.append({
            "name": entry, "route": "cuda", "source": CSRC + "copy_step.cu",
            "replaces": REPLACES["copy_step"],
            "launches": launches[entry], "max_abs_err": cs_err,
            "ms": row[key] / 1e3, "plain_ms": plain_ms[entry],
            "bound_ms": row["bound_us"] / 1e3,
            "bound_by": "bytes", "library_ms": None})
    # the chained copy step beside the chained form of azov_mask (T=0,
    # profile, guarded): the same bytes as one step's, for two steps
    fm_cc = kernels["fused_sw_step_chain_guarded"][0]
    entries.append({
        "name": "copy_step_chain", "route": "cuda",
        "source": CSRC + "copy_step.cu",
        "replaces": REPLACES["copy_step_chain"],
        "launches": launches["copy_step_chain"],
        "max_abs_err": max_abs["copy_step_chain"],
        "ms": run["copy_chain"]["azov_mask"] / 1e3,
        "plain_ms": plain_ms["copy_step_chain"],
        "bound_ms": probe.bytes_moved(
            fm_cc.lay, 0, False, fm_cc.tile_wet.cpu().numpy(), fm_cc.tile)
        / PEAK_BYTES * 1e3,
        "bound_by": "bytes", "library_ms": None})
    entries.append({
        "name": "copy_step_stacked", "route": "cuda",
        "source": CSRC + "copy_step.cu",
        "replaces": REPLACES["copy_step_stacked"],
        "launches": launches["copy_step_stacked"],
        "max_abs_err": max(r["max_abs"] for r in k4),
        "ms": k4[0]["us_stacked"] / 1e3,
        "plain_ms": plain_ms["copy_step_stacked"],
        "bound_ms": k4[0]["bound_us"] / 1e3, "bound_by": "bytes",
        "library_ms": None})
    entries += persist_entries + walk_entries + probe_entries + mesh_entries
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
