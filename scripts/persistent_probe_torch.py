#!/usr/bin/env python3
"""Mechanism probe of the persistent fused step on one NVIDIA GPU.

The PyTorch + CUDA counterpart of ``scripts/persistent_probe.py``: it
walks the probe's trivial stencil (``ocean_model_arch_torch/ops/
persistent_probe.py``: 6 f32 fields of X + 2 M rows by YS columns, each
interior row updated from itself and the row M above it) for ``nsteps``
model steps in the kernel's three forms -- ``inplace`` (one cooperative
launch, the state updated in place with a stash of each tile's last rows:
the TPU design), ``pingpong`` (one cooperative launch between two state
buffers: the design of the persistent fused step) and ``launches`` (one
ordinary launch a step) -- and prints for each the device us/step (CUDA
events over a window of ``nsteps`` steps, the best of ``windows``), beside
the byte bound of a step read from and written to HBM, and the grid. It
answers two questions before the step's arithmetic goes in: what one
grid barrier costs a step (``pingpong`` less the same launch without its
barrier, and less one launch a step), and whether a carried state stays
in the 50 MB L2 (``inplace``, 42.9 MB of state, faster a step than
``pingpong``, 85.8 MB, only if it does; both at the TPU probe's 64-row
tiles and at 256 rows, whose stash is a quarter as large). Where ``ncu``
is on the host it also prints the L2 hit rate of both; otherwise it says
that ``ncu`` is missing. Before timing it holds the three forms against
each other (bit for bit) and against the plain version on the card
(equal but for float64 rounding ties, at most one unit in the last
place, which it names).

Usage: python scripts/persistent_probe_torch.py [nsteps [windows]]

Defaults to the TPU script's X = 1536, YS = 1152, M = 8, 500 steps, 3
windows. The first line printed is the card's name and power limit.
Needs a CUDA device and nvcc; there is no CPU path.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ocean_model_arch_torch.ops import persistent_probe as pp  # noqa: E402

X, YS = 1536, 1152          # the TPU probe's extents
N_STEPS, WINDOWS = 500, 3
N_CHECK = 51                # steps of the comparison (odd: the parity swap)
TILE_ROWS = (pp.TILE_ROWS, 256)
PEAK_BYTES = 3.35e12        # H100 SXM data sheet, HBM bytes/s
SEED = 0


def fields_from_seed(X: int, YS: int, seed: int = SEED) -> tuple:
    """6 (X + 2 M, YS) f32 fields on the card, margins included, from a
    seed: values in [0.5, 1.5)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.rand((X + 2 * pp.MARGIN, YS), generator=gen,
                            device="cuda") + 0.5 for _ in range(pp.N_FIELDS))


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units in the last place of f32 (same-sign values)."""
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def window_us(fn, n_steps: int, windows: int) -> float:
    """Device us a step: CUDA events around ``fn`` (one window of n_steps
    steps), the best of ``windows`` after a warm-up window."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(windows):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        best = min(best, t0.elapsed_time(t1) * 1e3 / n_steps)
    return best


def check_forms(X: int, YS: int, tile_rows: int, n_steps: int = N_CHECK):
    """The three forms from the same seeded state, against each other and
    the plain version on the card: (most ulps from the plain version, the
    cells that differ from it as (field, row, column), max |error|)."""
    start = fields_from_seed(X, YS)
    got = {}
    for form in pp.FORMS:
        got[form] = pp.persistent_walk(tuple(f.clone() for f in start),
                                       n_steps, form, tile_rows=tile_rows)
    torch.cuda.synchronize()
    for form in pp.FORMS[1:]:
        if not all(torch.equal(a, b) for a, b in zip(got["inplace"],
                                                      got[form])):
            raise RuntimeError(f"tile rows {tile_rows}: {form} differs from "
                               "inplace")
    want = pp.persistent_walk_reference(start, n_steps)
    worst, cells, err = 0, [], 0.0
    for k, (a, b) in enumerate(zip(got["inplace"], want)):
        u = ulps(a, b)
        worst = max(worst, int(u.max()))
        err = max(err, float((a - b).abs().max()))
        cells += [(k, *map(int, ij)) for ij in torch.nonzero(u)[:8]]
    if worst > 1:
        raise RuntimeError(f"tile rows {tile_rows}: {worst} ulps from the "
                           "plain version")
    return worst, cells, err


def l2_hit_rate(form: str, tile_rows: int) -> str:
    """lts__t_sector_hit_rate.pct of one launch of ``form`` under ncu, or
    why there is none."""
    ncu = shutil.which("ncu") or ("/usr/local/cuda/bin/ncu" if os.path.exists(
        "/usr/local/cuda/bin/ncu") else None)
    if ncu is None:
        return "ncu missing"
    res = subprocess.run(
        [ncu, "--metrics", "lts__t_sector_hit_rate.pct", "-k",
         "regex:walk_kernel", "-c", "1", sys.executable,
         os.path.abspath(__file__), "--one", form, str(tile_rows)],
        capture_output=True, text=True, timeout=600)
    m = re.search(r"lts__t_sector_hit_rate\.pct\s+\S+\s+([\d.]+)", res.stdout)
    if res.returncode != 0 or m is None:
        tail = (res.stderr or res.stdout).strip().splitlines()[-1:]
        return f"ncu failed ({tail[0] if tail else res.returncode})"
    return f"{m.group(1)} %"


def probe(n_steps: int = N_STEPS, windows: int = WINDOWS, X: int = X,
          YS: int = YS, tile_rows=TILE_ROWS) -> list:
    """Every form at each tile height: one dict a (form, tile rows) with
    its us/step, grid and the checks of :func:`check_forms`, plus
    ``pingpong`` without its barrier."""
    nbytes = pp.step_bytes(X, YS)
    rows = []
    for tr in tile_rows:
        worst, cells, err = check_forms(X, YS, tr)
        state = fields_from_seed(X, YS)
        spare = tuple(f.clone() for f in state)
        cur = {"set": state, "spare": spare}

        def run(form, sync=True):
            def fn():
                out = pp.persistent_walk(cur["set"], n_steps, form,
                                         spare=cur["spare"], tile_rows=tr,
                                         sync=sync)
                if out[0] is not cur["set"][0]:
                    cur["set"], cur["spare"] = out, cur["set"]
            return fn

        tiles = pp.n_tiles(X, YS, tr)
        for form, sync in (("inplace", True), ("pingpong", True),
                           ("pingpong", False), ("launches", True)):
            grid = (tiles if form == "launches"
                    else min(tiles, pp.coresident_grid(form)))
            rows.append({
                "form": form + ("" if sync else " (no barrier)"),
                "tile_rows": tr, "grid": grid, "tiles": tiles,
                "coresident": (None if form == "launches"
                               else pp.coresident_grid(form)),
                "us": window_us(run(form, sync), n_steps, windows),
                "bytes": nbytes, "bound_us": nbytes / PEAK_BYTES * 1e6,
                "ulps": worst, "tie_cells": cells, "max_abs": err})
    return rows


def barrier_us(rows: list, tile_rows: int) -> tuple:
    """The barrier's cost a step at one tile height: (pingpong less the
    same launch without its barrier, pingpong less one launch a step)."""
    us = {r["form"]: r["us"] for r in rows if r["tile_rows"] == tile_rows}
    return (us["pingpong"] - us["pingpong (no barrier)"],
            us["pingpong"] - us["launches"])


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("persistent_probe_torch: torch.cuda.is_available() is False; "
              "the probe needs a CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["--one"]:         # one launch, for ncu
        fields = fields_from_seed(X, YS)
        pp.persistent_walk(fields, 20, argv[1], tile_rows=int(argv[2]))
        torch.cuda.synchronize()
        return 0
    n_steps = int(argv[0]) if argv else N_STEPS
    windows = int(argv[1]) if len(argv) > 1 else WINDOWS
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    rows = probe(n_steps, windows)
    nbytes = rows[0]["bytes"]
    print(f"persistent walk ({torch.cuda.get_device_name(0)}; {card}): "
          f"{pp.N_FIELDS} fields of {X + 2 * pp.MARGIN} x {YS} f32, M = "
          f"{pp.MARGIN}, {n_steps} steps a window, best of {windows}; byte "
          f"bound of a step {nbytes / 1e6:.1f} MB = "
          f"{rows[0]['bound_us']:.1f} us at {PEAK_BYTES / 1e12:.2f} TB/s")
    for r in rows:
        print(f"  {r['form']:<22} tile rows {r['tile_rows']:>3}: "
              f"{r['us']:8.2f} us/step, grid {r['grid']} of {r['tiles']} "
              f"tiles (co-resident {r['coresident']}), "
              f"{r['us'] / r['bound_us']:.2f} x the bound")
    for tr in TILE_ROWS:
        b, c = barrier_us(rows, tr)
        r0 = next(r for r in rows if r["tile_rows"] == tr)
        print(f"  tile rows {tr}: barrier {b:.2f} us/step (pingpong less "
              f"the same launch without it), {c:.2f} us/step (pingpong less "
              "one launch a step); forms bit-identical: yes; against the "
              f"plain version at most {r0['ulps']} ulp"
              + (f" at {r0['tie_cells']}" if r0["tie_cells"] else "")
              + "; L2 hit rate inplace "
              + l2_hit_rate("inplace", tr) + ", pingpong "
              + l2_hit_rate("pingpong", tr))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
