#!/usr/bin/env python3
"""Speed-of-light probe of the fused step's tiling on one NVIDIA GPU.

The PyTorch + CUDA counterpart of ``scripts/roofline_probe.py``: it runs
the copy step (``ocean_model_arch_torch/ops/copy_step.py``: the fused
step's window loads and tile stores with a sum in place of the
arithmetic) once per form of the fused kernel in ``FORMS`` -- 0 to 4
tracers, profile or plane metrics, with or without the viscous metric
rows and the bathymetry planes, and for each mask named also under its
land-tile guard -- and prints the kernel's device us/launch
(torch.profiler) beside the byte bound of the same traffic. The gap
between a form's copy step and the fused kernel itself is what the
step's arithmetic and barriers cost; the gap between the copy step and
the byte bound is what the tiling costs. Each form is timed with both
loaders: TMA a tile a block (the fused step's, the copy step's default)
and the threads' element by element (the fused step's loader before
it). The card's own ceiling for the same bytes follows: ``Tensor.copy_`` of a
buffer that moves the T = 0 form's bytes (read half, write half).

Usage: python scripts/roofline_probe_torch.py [nx ny [mask ...]]
       python scripts/roofline_probe_torch.py --stacked [nx ny]

Defaults to the Azov 250 m extents 1525 x 1115. Each ``mask`` is the word
``frame`` (a 2-cell land frame) or an ASCII land/sea mask file of those
extents (``data/AS/maskAzovCor.txt``); without one only the unguarded
forms run. The first line printed is the card's name
and power limit. Needs a CUDA device and nvcc; there is no CPU path.

``--stacked`` times the stacked copy step instead (the counterpart of
``scripts/roofline_probe.py --stacked``, ``build_copy_step_stacked``):
ONE (n_in, Xs, Ys) input and ONE (n_out, Xs, Ys) output against the same
sum over n_in separate planes into n_out, at JAX's default 8 -> 6 and at
the stream counts of the T = 0, 2 and 4 forms (``STACKED``), each beside
the byte bound, after checking the stacked kernel against its plain
version exactly.

The raw form of the fused step (one launch per shard of a mesh,
``model/fused_sharded2d.py``) runs on a shard's own array, whose layout
is that of a basin of the shard's extents: probe it with those extents
and the shard's part of the coastline, ``file@NXxNY+x0+y0`` (the file
read at NX x NY, cut at offset x0, y0). One shard of the 2 x 2 uniform
split of the Azov basin is

    python scripts/roofline_probe_torch.py 763 558 \
        data/AS/maskAzovCor.txt@1525x1115+0+0

and its rows ``T=2 profile metrics viscous bathymetry planes`` and ``T=0
plane metrics`` are the copy steps of the forms that split launches
(chip_smoke.py reads them so). The copy step stores whole tiles where
the raw form stores only the shard's box.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ocean_model_arch_torch.core.masks import (  # noqa: E402
    frame_of_land_mask)
from ocean_model_arch_torch.io.mask_io import read_mask  # noqa: E402
from ocean_model_arch_torch.ops import fused_layout as fl  # noqa: E402
from ocean_model_arch_torch.ops.copy_step import (  # noqa: E402
    copy_step, copy_step_reference, copy_step_stacked, tile_shape)
from ocean_model_arch_torch.ops.fused_step import (  # noqa: E402
    kernel_planes)

PEAK_BYTES = 3.35e12     # H100 SXM data sheet, HBM bytes/s
N_LAUNCH = 200
# the forms timed: (tracers, plane metrics, viscous, bathymetry planes)
FORMS = ((0, False, False, False), (0, True, False, False),
         (2, False, False, False), (2, True, False, False),
         (1, False, False, False),
         (0, False, True, False), (0, False, False, True),
         (2, False, True, True), (0, True, True, True),
         (3, False, False, False), (4, False, False, False))
# the stacked probe: (inputs, outputs, metric rows, the tracer form whose
# window and shared memory it takes, what the counts are)
STACKED = ((8, 6, 16, 0, "JAX's default"), (10, 6, 7, 0, "T=0 form"),
           (14, 10, 9, 2, "T=2 form"), (18, 14, 9, 4, "T=4 form"))


def form_counts(n_tracers: int, visc: bool = False,
                hr_varies: bool = False) -> tuple:
    """(windowed inputs, outputs, metric rows) of the fused step's form
    with ``n_tracers`` tracers, with or without viscosity and varying
    bathymetry: the carried fields and the static planes
    (``fused_step.kernel_planes``) are windowed."""
    n_out = 6 + 2 * n_tracers
    return (n_out + len(kernel_planes(n_tracers, visc, hr_varies)), n_out,
            len(fl.fast2d_met_rows(n_tracers, visc)))


def bytes_moved(lay, n_tracers: int, met2d: bool, wet=None,
                tile=None, visc: bool = False,
                hr_varies: bool = False) -> int:
    """The bytes one copy step of this form must move: each windowed
    input and metric plane read once and each output written once over
    the cells of the tiles it computes, the zero writes of the all-land
    tiles (``wet``: the guard's per-tile flags, numpy), the profile rows,
    one flag per block."""
    n_win, n_out, n_met = form_counts(n_tracers, visc, hr_varies)
    cells = lay.Xs * lay.Ys
    done, flags = cells, 0
    if wet is not None:
        full = wet.repeat(tile[0], 0).repeat(tile[1], 1)
        done = int((full[:lay.Xs, :lay.Ys] > 0).sum())
        flags = 4 * wet.size
    per_cell = 4 * (n_win + n_out + (n_met if met2d else 0))
    return (done * per_cell + (cells - done) * 4 * n_out
            + (0 if met2d else 4 * n_met * lay.Ys) + flags)


def form_inputs(lay, n_tracers: int, met2d: bool, device, seed: int = 0,
                visc: bool = False, hr_varies: bool = False):
    """(windowed inputs, metric rows) of one form, random float32 made
    from ``seed`` on ``device``."""
    n_win, _, n_met = form_counts(n_tracers, visc, hr_varies)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    windows = tuple(torch.randn((lay.Xs, lay.Ys), generator=gen)
                    .to(device) for _ in range(n_win))
    shape = (n_met, lay.Xs, lay.Ys) if met2d else (n_met, lay.Ys)
    return windows, torch.randn(shape, generator=gen).to(device)


def kernel_us(fn, n: int, kernel: str = "copy_step_kernel") -> float:
    """Mean device microseconds per launch of the CUDA kernel named
    ``kernel`` over ``n`` calls of ``fn`` under torch.profiler, after one
    warm-up call. The wrapper's Python takes longer than the kernel, so
    CUDA events around the calls would time the host. torch.profiler now
    and then records no device activity in a window (about once in 950
    on an H100): such a window is taken again, three windows at most
    (``kernel_us.retaken`` counts them: ``n`` more calls each)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if kernel in e.key and e.count and e.self_device_time_total > 0:
                return e.self_device_time_total / e.count
        kernel_us.retaken += 1
    raise RuntimeError(f"torch.profiler recorded no device time for {kernel}")


kernel_us.retaken = 0


def probe(nx: int, ny: int, masks=(), n_launch: int = N_LAUNCH,
          forms=FORMS, threads=None) -> list:
    """Time the copy step of every form of ``forms`` on the current CUDA
    device. ``masks``: (name, (nx, ny) int array, 1 = land) pairs, each
    giving the guarded forms their per-tile flags. ``threads``: the forms
    whose copy step is timed with the threads' loader too (None: every
    form). Returns one dict per form and guard: ``n_tracers, met2d, visc,
    hr_varies, guard`` (None or the mask's name), ``us`` (the TMA loader),
    ``us_threads`` (the threads', None where not timed), ``bytes,
    bound_us`` (the bytes over the card's memory rate)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the roofline probe needs a CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    lay = fl.make_layout(nx, ny)
    tile = tile_shape(device)
    guards = [(None, None)]
    for name, mask in masks:
        lu_s = fl.embed(lay, torch.from_numpy(1.0 - np.asarray(mask,
                                                               np.float32)))
        guards.append((name, fl.tile_wet(lu_s.numpy(), lay, *tile)))
    rows = []
    for n_tracers, met2d, visc, hr_varies in forms:
        windows, met = form_inputs(lay, n_tracers, met2d, device,
                                   visc=visc, hr_varies=hr_varies)
        n_out = form_counts(n_tracers)[1]
        for guard, wet in guards:
            flags = None if wet is None else \
                torch.from_numpy(wet).to(device)
            us, us_threads = (kernel_us(lambda: copy_step(
                windows, met, n_out, lay, tracer_form=n_tracers,
                tile_wet=flags, tile=tile, visc_form=visc, loader=loader),
                n_launch) if loader == "tma" or threads is None
                or (n_tracers, met2d, visc, hr_varies) in threads else None
                for loader in ("tma", "threads"))
            nbytes = bytes_moved(lay, n_tracers, met2d, wet, tile, visc,
                                 hr_varies)
            rows.append({"n_tracers": n_tracers, "met2d": met2d,
                         "visc": visc, "hr_varies": hr_varies,
                         "guard": guard, "us": us,
                         "us_threads": us_threads, "bytes": nbytes,
                         "bound_us": nbytes / PEAK_BYTES * 1e6})
    return rows


def copy_rate(nbytes: int, n_launch: int = N_LAUNCH) -> tuple:
    """(device us a call, bytes/s) of ``Tensor.copy_`` between two float32
    buffers that together hold ``nbytes`` (it reads one and writes the
    other) on the current CUDA device, by CUDA events over ``n_launch``
    calls after one: the card's own rate for the copy step's bytes."""
    src = torch.zeros(nbytes // 8, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    dst.copy_(src)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n_launch):
        dst.copy_(src)
    t1.record()
    t1.synchronize()
    us = t0.elapsed_time(t1) * 1e3 / n_launch
    return us, 8 * src.numel() / us * 1e6


def stacked(nx: int, ny: int, n_launch: int = N_LAUNCH,
            counts=STACKED) -> list:
    """The stacked copy step against the separate one, on the current
    CUDA device, for each (inputs, outputs, metric rows, tracer form) of
    ``counts``: random float32 inputs made from a seed, the stacked
    output checked against the plain version on the card (``equal``:
    bit for bit), then both kernels' device us/launch on the same planes
    and the byte bound of that traffic. Returns one dict per count."""
    if not torch.cuda.is_available():
        raise RuntimeError("the roofline probe needs a CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    lay = fl.make_layout(nx, ny)
    rows = []
    for seed, (n_in, n_out, n_met, n_tr, what) in enumerate(counts):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        stack = torch.randn((n_in, lay.Xs, lay.Ys), generator=gen).to(device)
        met = torch.randn((n_met, lay.Ys), generator=gen).to(device)
        planes = tuple(stack.unbind(0))
        got = copy_step_stacked(stack, met, n_out, lay, n_tr)
        want = copy_step_reference(planes, met, n_out, lay)
        equal = all(torch.equal(a, b) for a, b in zip(got.unbind(0), want))
        us_stacked = kernel_us(lambda: copy_step_stacked(
            stack, met, n_out, lay, n_tr), n_launch)
        us_separate = kernel_us(lambda: copy_step(
            planes, met, n_out, lay, n_tr, loader="threads"), n_launch)
        nbytes = 4 * (lay.Xs * lay.Ys * (n_in + n_out) + n_met * lay.Ys)
        rows.append({"n_in": n_in, "n_out": n_out, "n_met": n_met,
                     "n_tracers": n_tr, "what": what, "equal": equal,
                     "max_abs": max(float((a - b).abs().max())
                                    for a, b in zip(got.unbind(0), want)),
                     "us_stacked": us_stacked, "us_separate": us_separate,
                     "bytes": nbytes, "bound_us": nbytes / PEAK_BYTES * 1e6})
    return rows


def stacked_name(row: dict) -> str:
    return (f"{row['n_in']} -> {row['n_out']} ({row['what']}, "
            f"{row['n_met']} metric rows)")


def form_name(row: dict) -> str:
    return (f"T={row['n_tracers']} "
            f"{'plane' if row['met2d'] else 'profile'} metrics"
            + (" viscous" if row["visc"] else "")
            + (" bathymetry planes" if row["hr_varies"] else "")
            + f" guard {row['guard'] or 'off'}")


def mask_argument(arg: str, nx: int, ny: int) -> np.ndarray:
    """The (nx, ny) mask a command-line word names: ``frame``, a mask
    file of those extents, or ``file@NXxNY+x0+y0``, the part of an
    NX x NY file that starts at (x0, y0)."""
    if arg == "frame":
        return frame_of_land_mask(nx, ny)
    path, _, cut = arg.partition("@")
    if not cut:
        return read_mask(path, nx, ny)
    size, x0, y0 = cut.split("+")
    full_x, full_y = (int(v) for v in size.split("x"))
    part = read_mask(path, full_x, full_y)[int(x0):int(x0) + nx,
                                           int(y0):int(y0) + ny]
    if part.shape != (nx, ny):
        raise ValueError(f"{arg}: the cut leaves {part.shape}, not "
                         f"{(nx, ny)}")
    return np.ascontiguousarray(part)


def main(argv) -> int:
    is_stacked = "--stacked" in argv[1:]
    argv = [a for a in argv if a != "--stacked"]
    nx = int(argv[1]) if len(argv) > 1 else 1525
    ny = int(argv[2]) if len(argv) > 2 else 1115
    masks = [(os.path.basename(a), mask_argument(a, nx, ny))
             for a in argv[3:]]
    if not torch.cuda.is_available():
        print("roofline_probe_torch: torch.cuda.is_available() is False; "
              "the probe needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    lay = fl.make_layout(nx, ny)
    if is_stacked:
        print(f"stacked copy step against the separate one, {nx} x {ny} "
              f"points, layout {lay.Xs} x {lay.Ys}, {N_LAUNCH} launches "
              "each (torch.profiler):")
        rows = stacked(nx, ny)
        for row in rows:
            print(f"  {stacked_name(row)}: == plain version "
                  f"{'yes' if row['equal'] else 'NO'}; stacked "
                  f"{row['us_stacked']:.2f} us/launch, separate "
                  f"{row['us_separate']:.2f} us/launch (stacked / separate "
                  f"{row['us_stacked'] / row['us_separate']:.3f}), "
                  f"{row['bytes'] / 1e6:.1f} MB, byte bound "
                  f"{row['bound_us']:.2f} us at {PEAK_BYTES / 1e12:.2f} TB/s")
        return 0 if all(r["equal"] for r in rows) else 1
    print(f"copy step, {nx} x {ny} points, layout {lay.Xs} x {lay.Ys}, "
          f"{N_LAUNCH} launches per form (torch.profiler):")
    for row in probe(nx, ny, masks):
        print(f"  {form_name(row)}: {row['us']:.2f} us/launch by TMA, "
              f"{row['us_threads']:.2f} by threads, "
              f"{row['bytes'] / 1e6:.1f} MB, byte bound "
              f"{row['bound_us']:.2f} us at {PEAK_BYTES / 1e12:.2f} TB/s "
              f"({row['bound_us'] / row['us']:.0%} of it reached, "
              f"{row['bytes'] / row['us'] / 1e6:.3f} TB/s)")
    nbytes = bytes_moved(lay, 0, False)
    us, rate = copy_rate(nbytes)
    print(f"Tensor.copy_ moving {nbytes / 1e6:.1f} MB (the T=0 profile "
          f"form's bytes): {us:.2f} us, {rate / 1e12:.3f} TB/s against "
          f"{PEAK_BYTES / 1e12:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
