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

Usage: python scripts/chain_tile_sweep_torch.py [--general]
       [--loader threads,tma] [--rounds N] [--folds CODE]
       [--tracers N,...] [TXxTYxTHREADSxBLOCKS ...]

Each argument ``16x32x512x2`` is a candidate tile (rows, columns,
threads, launch bound in blocks an SM) in place of the default list;
``default`` is csrc/fused_tile.cuh's own. ``--folds 7`` times the folded
kernel (``fused_sw_fold_kernel``, elide_sel + q4 + share_prev, what the
drivers run) instead of the unfolded one; ``--tracers 2`` sweeps only
the forms with that many tracers. ``--general`` sweeps the general body's
chained forms instead (``FusedSWModel(grid, cfg, tau, steps_per_call=2)``
with the JAX defaults; no folds), on profile metrics and, without
tracers, on the bipolar grid's metric planes; ``--loader threads,tma``
builds each tile of a general form without tracers on each loader
(``FUSED_CHAIN_GEN_TMA``; the forms with tracers take the header's).
``--rounds 3`` times every (tile, loader) of a form three times in
turns and reports the median. At the Azov 250 m extents 1525 x 1115: the
coastline (data/AS/maskAzovCor.txt) guarded without tracers and with 2,
and the 2-cell frame unguarded without tracers. The first line printed
is the card's name and power limit. Needs a CUDA device and nvcc; there
is no CPU path.
"""

from __future__ import annotations

import ctypes
import dataclasses
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


def bathymetry(nx: int, ny: int) -> np.ndarray:
    """chip_smoke.py's rest bathymetry: 15-100 m, deepest in the middle."""
    i = np.arange(nx, dtype=np.float64)[:, None]
    j = np.arange(ny, dtype=np.float64)[None, :]
    return (15.0 + 85.0 * np.sin(np.pi * i / (nx - 1))
            * np.sin(np.pi * j / (ny - 1))).astype(np.float32)
N_LAUNCH = 200
# (rows, columns, threads, blocks an SM the launch bound keeps registers
# for); None is csrc/fused_tile.cuh's default
TILES = (None, (16, 32, 512, 1), (16, 16, 256, 3), (16, 16, 256, 2),
         (8, 32, 256, 3), (8, 32, 256, 2), (32, 16, 512, 1),
         (32, 32, 512, 1))
# (grid, tracers, guard, mu): the coastline without tracers, with 2 and 4
# (the run-time tracer family), the frame without, and azov_visc (2
# tracers over 15-100 m of bathymetry, viscous)
FORMS = (("azov", 0, True, 0.0), ("azov", 2, True, 0.0),
         ("frame", 0, False, 0.0), ("azov_hr", 2, True, 1.0e3),
         ("azov", 4, True, 0.0))
# --general: the coastline without tracers on profile metrics and on the
# bipolar grid's 16 metric planes, the frame without tracers (unguarded),
# the coastline with 1, 2 and 4 tracers, and azov_visc
GENERAL_FORMS = (("azov", 0, True, 0.0), ("bipolar_azov", 0, True, 0.0),
                 ("frame", 0, False, 0.0),
                 ("azov", 1, True, 0.0), ("azov", 2, True, 0.0),
                 ("azov_hr", 2, True, 1.0e3), ("azov", 4, True, 0.0))
SM_SMEM, SM_REGS, SM_THREADS = 233472, 65536, 2048   # H100, per SM
BLOCK_RESERVED = 1024      # shared memory the runtime keeps per block


def smem_bytes(tile, n_tracers: int, visc: bool = False) -> int:
    """csrc/fused_tile.cuh's smem_bytes<NT, 2, TMA, VISC> for a tile (the
    TMA loader's window; a run-time tracer count's levels all counted)."""
    tx, ty = tile[:2]
    halo = 3 + (1 if n_tracers else 0)
    wh = 2 * halo
    shift = -wh % 4
    rows, cols = tx + 2 * wh, -(-(ty + 2 * wh + shift) // 4) * 4
    plane = -(-(rows * cols + shift) // 32) * 32
    planes = 16 + 4 + 2 * n_tracers
    vh = halo + 1 + (1 if n_tracers else 0)
    visc_b = 4 * (tx + 2 * vh) * (ty + 2 * vh) if visc else 0
    return 4 * (planes * plane + visc_b)


def blocks_per_sm(tile, smem: int, regs: int) -> tuple:
    """(by shared memory, by registers, by threads) blocks of one SM of a
    tile's blocks of ``smem`` bytes and ``regs`` registers a thread."""
    threads = tile[2]
    by_smem = SM_SMEM // (smem + BLOCK_RESERVED)
    per_warp = -(-regs * 32 // 256) * 256      # allocated in 256-reg units
    by_regs = SM_REGS // (per_warp * (threads // 32)) if regs else 0
    return by_smem, by_regs, SM_THREADS // threads


def ptxas_regs(log: str, n_tracers: int) -> tuple:
    """(most registers, most spill bytes) over the instantiations with
    ``n_tracers`` tracers in a build log (a general library's: over every
    form it holds)."""
    regs, spill, cur = [0], [0], None
    want = n_tracers if n_tracers <= 2 else -1     # the run-time family
    for ln in log.splitlines():
        # a negative template argument is mangled "n1": Lin1E
        m = re.search(r"_kernelILi(n?\d+)E", ln)
        if m:
            cur = int(m.group(1).replace("n", "-"))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and cur == want:
            spill.append(int(m.group(1)) + int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur == want:
            regs.append(int(m.group(1)))
    return max(regs), max(spill)


def kernel_us(fn, n: int, name: str = "fused_sw_step_kernel") -> float:
    """Mean device us per launch of the kernel ``name`` over ``n`` calls
    of ``fn`` (torch.profiler), after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if (name in e.key and e.count
                and e.self_device_time_total > 0):
            return e.self_device_time_total / e.count
    raise RuntimeError(f"torch.profiler recorded no device time for "
                       f"{name}")


def sweep_tile(tile, n_tracers: int, visc: bool, loader, general: bool):
    """The ``chain_tile`` of the library a sweep builds for ``tile`` (None:
    the header's) and ``loader`` (None: the header's rule, 0 threads, 1
    TMA): the loader's switch only for a general form without tracers."""
    if loader is None or n_tracers or not general:
        return tile
    return (*(tile or fstep.tile_of(2, 0, visc, True)), loader)


def sweep(n_launch: int = N_LAUNCH, tiles=TILES, folds: int = 0,
          tracers=(0, 1, 2, 4), general: bool = False, loaders=(None,),
          rounds: int = 1) -> list:
    """Build and time every tile of ``tiles`` (the kernel with the fold
    code ``folds``, 0 unfolded; the general body's with ``general``, each
    tile of a form without tracers on each of ``loaders``: None the
    header's, 0 threads, 1 TMA) for the forms with ``tracers``, ``rounds``
    times in turns; returns one dict per (form, tile, loader)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the tile sweep needs a CUDA device")
    if general and folds:
        raise ValueError("the general forms have no folds")
    basin = basinpar_as250m_test()
    prec = Precision.f32()
    mask = read_mask(os.path.join(REPO, "data", "AS", "maskAzovCor.txt"),
                     basin.nx, basin.ny)
    basin_b = dataclasses.replace(basin, curve_grid=2)
    grids = {"azov": build_grid(basin, mask, precision=prec),
             "frame": build_grid(basin, frame_of_land_mask(basin.nx,
                                                           basin.ny),
                                 precision=prec),
             "azov_hr": build_grid(basin, mask, hhq_rest=bathymetry(
                 basin.nx, basin.ny), precision=prec)}
    if general:
        grids["bipolar_azov"] = build_grid(basin_b, mask, precision=prec)
    forms = GENERAL_FORMS if general else FORMS

    variants = [(t, ld) for t in tiles for ld in loaders]
    targets = sorted({fstep.library_target(
        n, steps=2, chain_tile=sweep_tile(t, n, visc, ld, general),
        folds=folds,
        general=general) for t, ld in variants
        for _, n, _, mu in forms if n in tracers for visc in {mu != 0.0}})
    _build.build_all(targets + [fstep.library_target(
        n, folds=folds & 3, general=general)
        for n in sorted({n for _, n, _, _ in forms if n in tracers})])
    name = "fused_sw_fold_kernel" if folds else "fused_sw_step_kernel"
    kfolds = fstep.Folds(bool(folds & 1), bool(folds & 2), bool(folds & 4))
    rows = []
    for gname, n_tr, guard, mu in forms:
        if n_tr not in tracers:
            continue
        cfg = ModelConfig(basin=basin_b if gname.startswith("bipolar")
                          else basin, sw=SWConfig(
            use_tracers=int(n_tr > 0), tracer_num=max(n_tr, 1)),
            precision=prec)
        grid = grids[gname]
        # the fast form with the swept folds (its planes and state packed
        # for them; the drivers default to 7), or the general form
        kw = {} if general else dict(
            static_rslu=True, elide_sel=kfolds.elide_sel, q4=kfolds.q4,
            share_prev=False)
        one = FusedSWModel(grid, cfg, 1.0, tile_guard=guard, mu_const=mu,
                           **kw)
        if one.general != general:
            raise RuntimeError(f"{gname}: not the "
                               f"{'general' if general else 'fast'} form")
        s0 = init_ocean_state(grid, cfg)
        s0 = dataclasses.replace(s0, mu=torch.full_like(s0.mu, mu))
        s, _ = one.run_steps(one.pack(s0), 20)
        lu_s = np.asarray(fl.embed(one.lay, grid.lu.cpu()))

        def args(tw, tile, steps):
            return (one.met, one.planes, one.lay, one.tau,
                    cfg.sw.time_smooth, one.hr_const, tw, tile,
                    one.met_map, one.mu_const, one.visc, one.trans,
                    one.ffs, steps, general)

        a1 = args(one.tile_wet, one.tile, 1)
        f1 = kfolds._replace(share_prev=False)
        us_one = kernel_us(lambda: fstep.fused_sw_step_blockmax(
            s, *a1, folds=f1), n_launch, name if any(f1) else
            "fused_sw_step_kernel")
        ref, _ = fstep.fused_sw_step_reference(s, *args(None, None, 2),
                                               folds=kfolds)
        form = (f"{gname} T={n_tr} guard {'on' if guard else 'off'}"
                + (f" mu={mu:g}" if mu else "") + " general" * general)
        first, runs = None, []
        for t, ld in variants:
            if ld is not None and n_tr and t in [v[0] for v in runs]:
                continue                # one loader: the header's
            ct = sweep_tile(t, n_tr, one.visc, ld, general)
            tile = fstep.tile_shape("cuda", 2, ct, n_tr, one.visc, general)
            tw = (torch.from_numpy(fl.tile_wet(lu_s, one.lay, *tile))
                  .to(s[0].device) if guard else None)
            a2 = args(tw, tile, 2)
            try:
                out, _ = fstep.fused_sw_step_blockmax(s, *a2, chain_tile=ct,
                                                      folds=kfolds)
            except RuntimeError as e:     # a block the card cannot hold
                rows.append({"form": form, "tile": t, "default": t is None,
                             "loader": ld, "refused": str(e)})
                continue
            if first is None:
                first = out
            same = all(torch.equal(a, b) for a, b in zip(out, first))
            err = max(float((a - b).abs().max())
                      / max(float(b.abs().max()), 1e-30)
                      for a, b in zip(out, ref))
            lib = fstep._library(n_tr, False, 1, 1, 2, ct, general, folds)
            v = int(one.visc)
            shape = (lib.fused_sw_step_tile_x(v), lib.fused_sw_step_tile_y(v),
                     lib.fused_sw_step_threads(v),
                     lib.fused_sw_step_min_blocks(v))
            geo = (ctypes.c_longlong * 12)()
            lib.fused_sw_step_geometry(n_tr, v, int(one.hr_const is None),
                                       one.ffs, int(one.metrics_2d), geo)
            log = _build.BUILDS.get(fstep.library_target(
                n_tr, steps=2, chain_tile=ct, folds=folds, general=general),
                {}).get("log", "")
            regs, spill = ptxas_regs(log, n_tr)
            smem = geo[8] if general else smem_bytes(shape, n_tr, one.visc)
            runs.append((t, ld, a2, ct, {
                "form": form, "tile": shape, "default": t is None,
                "loader": ("TMA" if geo[10] else "threads"),
                "smem": smem, "carveout": geo[11],
                "blocks": blocks_per_sm(shape, smem, regs),
                "regs": regs, "spill": spill, "us": [],
                "us_one": us_one, "same": same, "err": err}))
        for _ in range(rounds):             # in turns
            for t, ld, a2, ct, r in runs:
                r["us"].append(kernel_us(lambda: fstep.fused_sw_step_blockmax(
                    s, *a2, chain_tile=ct, folds=kfolds), n_launch, name))
        for *_, r in runs:
            r["us"] = float(np.median(r["us"]))
            rows.append(r)
    return rows


def parse(argv) -> dict:
    """sweep()'s arguments from the command line (see the usage)."""
    kw, tiles = {}, []
    it = iter(argv)
    for a in it:
        if a == "--folds":
            kw["folds"] = int(next(it))
        elif a == "--tracers":
            kw["tracers"] = tuple(int(n) for n in next(it).split(","))
        elif a == "--general":
            kw["general"] = True
        elif a == "--loader":
            kw["loaders"] = tuple({"threads": 0, "tma": 1}[n]
                                  for n in next(it).split(","))
        elif a == "--rounds":
            kw["rounds"] = int(next(it))
        elif a == "default":
            tiles.append(None)
        else:
            tiles.append(tuple(int(n) for n in a.split("x")))
    if tiles:
        kw["tiles"] = tuple(tiles)
    return kw


def main(argv=()) -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card.splitlines()[0])
    rows = sweep(**parse(argv))
    for r in rows:
        if "refused" in r:
            print(f"{r['form']}: tile {r['tile'] or 'default'}, loader "
                  f"{r['loader']}: {r['refused']}")
            continue
        tx, ty, th, mb = r["tile"]
        print(f"{r['form']}: tile {tx}x{ty}/{th} launch bound {mb}"
              + (" (default)" if r["default"] else "")
              + f", {r['loader']} loader: {r['us']:.2f} us/launch = "
              f"{r['us'] / 2:.2f} us/step (one step a launch "
              f"{r['us_one']:.2f}); smem {r['smem'] / 1024:.1f} KB, carveout "
              f"{r['carveout']} KB, blocks/SM by smem / regs / "
              f"threads {r['blocks']}, {r['regs']} regs, {r['spill']} B "
              f"spill; == default tile bit for bit: {r['same']}; vs plain "
              f"{r['err']:.2e}")
    bad = [r for r in rows if "refused" not in r
           and (not r["same"] or r["err"] > 1e-5)]
    if bad:
        print(f"FAILED: {len(bad)} tiles differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
