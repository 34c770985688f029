#!/usr/bin/env python3
"""Tile sweep of the fused step's chained form on one NVIDIA GPU.

The chained form (``fused_sw_step(..., steps=2)``, csrc/fused_step.cu
with ``-DFUSED_STEPS=2``) runs two model steps a launch on a window of
halo 6 (8 with tracers), its block holding 20 + 2 T shared planes of that
window; how many blocks an SM holds then depends on the tile, the
threads and the registers the launch bound leaves. This script builds
the chained form once per candidate tile (``-DFUSED_CHAIN_TX / TY /
THREADS / MIN_BLOCKS``, all libraries at once), checks that every tile
gives the same bits (the arithmetic of a cell does not depend on the
tile) and agrees with the plain version, and prints per form the
device us/launch of each tile (torch.profiler over 200 launches) beside
the single-step kernel's us/launch in the same run, its shared memory,
the blocks an SM holds by shared memory and by registers, and ptxas's
registers and spills.

Usage: python scripts/chain_tile_sweep_torch.py

At the Azov 250 m extents 1525 x 1115: the coastline
(data/AS/maskAzovCor.txt) guarded without tracers and with 2, and the
2-cell frame unguarded without tracers. The first line printed is the
card's name and power limit. Needs a CUDA device and nvcc; there is no
CPU path.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ocean_model_arch_torch.core.grid import build_grid  # noqa: E402
from ocean_model_arch_torch.host import (  # noqa: E402
    ModelConfig, Precision, SWConfig, basinpar_as250m_test,
    frame_of_land_mask, read_mask)
from ocean_model_arch_torch.model.fused import FusedSWModel  # noqa: E402
from ocean_model_arch_torch.model.init import init_ocean_state  # noqa: E402
from ocean_model_arch_torch.ops import _build  # noqa: E402
from ocean_model_arch_torch.ops import fused_layout as fl  # noqa: E402
from ocean_model_arch_torch.ops import fused_step as fstep  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_LAUNCH = 200
# (rows, columns, threads, blocks an SM the launch bound keeps registers
# for); None is csrc/fused_tile.cuh's default
TILES = (None, (16, 32, 512, 1), (16, 16, 256, 3), (16, 16, 256, 2),
         (8, 32, 256, 3), (8, 32, 256, 2), (32, 16, 512, 1),
         (32, 32, 512, 1))
SM_SMEM, SM_REGS, SM_THREADS = 233472, 65536, 2048   # H100, per SM
BLOCK_RESERVED = 1024      # shared memory the runtime keeps per block


def smem_bytes(tile, n_tracers: int, visc: bool = False) -> int:
    """csrc/fused_tile.cuh's smem_bytes<NT, 2> for a tile."""
    tx, ty = tile[:2]
    halo = 3 + (1 if n_tracers else 0)
    wh = 2 * halo
    planes = 16 + 4 + 2 * n_tracers
    vh = halo + 1 + (1 if n_tracers else 0)
    visc_b = 4 * (tx + 2 * vh) * (ty + 2 * vh) if visc else 0
    return 4 * (planes * (tx + 2 * wh) * (ty + 2 * wh) + visc_b)


def blocks_per_sm(tile, n_tracers: int, regs: int) -> tuple:
    """(by shared memory, by registers, by threads) blocks of one SM."""
    threads = tile[2]
    by_smem = SM_SMEM // (smem_bytes(tile, n_tracers) + BLOCK_RESERVED)
    per_warp = -(-regs * 32 // 256) * 256      # allocated in 256-reg units
    by_regs = SM_REGS // (per_warp * (threads // 32)) if regs else 0
    return by_smem, by_regs, SM_THREADS // threads


def ptxas_regs(log: str, n_tracers: int) -> tuple:
    """(most registers, most spill bytes) over the instantiations with
    ``n_tracers`` tracers in a build log."""
    regs, spill, cur = [0], [0], None
    for ln in log.splitlines():
        m = re.search(r"_kernelILi(\d)E", ln)
        if m:
            cur = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and cur == n_tracers:
            spill.append(int(m.group(1)) + int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur == n_tracers:
            regs.append(int(m.group(1)))
    return max(regs), max(spill)


def kernel_us(fn, n: int) -> float:
    """Mean device us per launch of fused_sw_step_kernel over ``n`` calls
    of ``fn`` (torch.profiler), after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if ("fused_sw_step_kernel" in e.key and e.count
                and e.self_device_time_total > 0):
            return e.self_device_time_total / e.count
    raise RuntimeError("torch.profiler recorded no device time for "
                       "fused_sw_step_kernel")


def sweep(n_launch: int = N_LAUNCH, tiles=TILES) -> list:
    """Build and time every tile of ``tiles``; returns one dict per
    (form, tile)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the tile sweep needs a CUDA device")
    basin = basinpar_as250m_test()
    prec = Precision.f32()
    mask = read_mask(os.path.join(REPO, "data", "AS", "maskAzovCor.txt"),
                     basin.nx, basin.ny)
    grids = {"azov": build_grid(basin, mask, precision=prec),
             "frame": build_grid(basin, frame_of_land_mask(basin.nx,
                                                           basin.ny),
                                 precision=prec)}
    targets = [fstep.library_target(n, steps=2, chain_tile=t)
               for t in tiles for n in (0, 2)]
    _build.build_all(targets + [fstep.library_target(n) for n in (0, 2)])
    rows = []
    for gname, n_tr, guard in (("azov", 0, True), ("azov", 2, True),
                               ("frame", 0, False)):
        cfg = ModelConfig(basin=basin, sw=SWConfig(
            use_tracers=int(n_tr > 0), tracer_num=max(n_tr, 1)),
            precision=prec)
        grid = grids[gname]
        # the unfolded fast form (the drivers default to its folds)
        one = FusedSWModel(grid, cfg, 1.0, tile_guard=guard, static_rslu=True,
                           elide_sel=False, q4=False, share_prev=False)
        s, _ = one.run_steps(one.pack(init_ocean_state(grid, cfg)), 20)
        lu_s = np.asarray(fl.embed(one.lay, grid.lu.cpu()))

        def args(tw, tile, steps):
            return (one.met, one.planes, one.lay, one.tau,
                    cfg.sw.time_smooth, one.hr_const, tw, tile,
                    one.met_map, one.mu_const, one.visc, one.trans,
                    one.ffs, steps)

        a1 = args(one.tile_wet, one.tile, 1)
        us_one = kernel_us(lambda: fstep.fused_sw_step_blockmax(s, *a1),
                           n_launch)
        ref, _ = fstep.fused_sw_step_reference(s, *args(None, None, 2))
        first = None
        for t in tiles:
            tile = fstep.tile_shape("cuda", 2, t)
            tw = (torch.from_numpy(fl.tile_wet(lu_s, one.lay, *tile))
                  .to(s[0].device) if guard else None)
            a2 = args(tw, tile, 2)
            out, _ = fstep.fused_sw_step_blockmax(s, *a2, chain_tile=t)
            if first is None:
                first = out
            same = all(torch.equal(a, b) for a, b in zip(out, first))
            err = max(float((a - b).abs().max())
                      / max(float(b.abs().max()), 1e-30)
                      for a, b in zip(out, ref))
            us = kernel_us(lambda: fstep.fused_sw_step_blockmax(
                s, *a2, chain_tile=t), n_launch)
            lib = fstep._library(n_tr, False, 1, 1, 2, t)
            shape = (lib.fused_sw_step_tile_x(), lib.fused_sw_step_tile_y(),
                     lib.fused_sw_step_threads(),
                     lib.fused_sw_step_min_blocks())
            log = _build.BUILDS.get(fstep.library_target(
                n_tr, steps=2, chain_tile=t), {}).get("log", "")
            regs, spill = ptxas_regs(log, n_tr)
            rows.append({"form": f"{gname} T={n_tr} guard "
                                 f"{'on' if guard else 'off'}",
                         "tile": shape, "default": t is None,
                         "smem": smem_bytes(shape, n_tr),
                         "blocks": blocks_per_sm(shape, n_tr, regs),
                         "regs": regs, "spill": spill, "us": us,
                         "us_one": us_one, "same": same, "err": err})
    return rows


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card.splitlines()[0])
    rows = sweep()
    for r in rows:
        tx, ty, th, mb = r["tile"]
        print(f"{r['form']}: tile {tx}x{ty}/{th} launch bound {mb}"
              + (" (default)" if r["default"] else "")
              + f": {r['us']:.2f} us/launch = {r['us'] / 2:.2f} us/step "
              f"(one step a launch {r['us_one']:.2f}); smem "
              f"{r['smem'] / 1024:.1f} KB, blocks/SM by smem / regs / "
              f"threads {r['blocks']}, {r['regs']} regs, {r['spill']} B "
              f"spill; == default tile bit for bit: {r['same']}; vs plain "
              f"{r['err']:.2e}")
    bad = [r for r in rows if not r["same"] or r["err"] > 1e-5]
    if bad:
        print(f"FAILED: {len(bad)} tiles differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
