"""The general generator of a run's inputs from a traffic mix.

A mix is ``port_bench/traffic/<name>.json``:

- ``window_steps``: model steps between the host's returns (the entry
  point's output window);
- ``warmup_windows``: windows run before the measured window;
- ``restart_windows`` (optional): after this many windows from the cold
  start (warm-up included) the run takes its cold start up again, so no
  run steps a basin for longer than that, however fast the program;
- ``ssh_bumps``: the seeded initial sea surface: ``count`` Gaussian bumps
  centred on wet cells drawn from the seed, with amplitudes (m, either
  sign) and widths (cells) drawn uniformly from ``amp_m`` and
  ``sigma_cells``. Every seed gets the same number of bumps and the same
  steps: the work does not depend on the seed.

Each window is one call of the entry point's loop, and no mix writes an
output record yet: a mix with ``output_minutes`` above 0 is refused
until the harness has an output path (a call over several windows, the
states taken where they are written, a restart that splits that call).
"""

from __future__ import annotations

import json
import os

import numpy as np

UNDEF = np.float32(-1.0e32)
REQUIRED = ("window_steps", "warmup_windows", "ssh_bumps")


def load(path: str) -> dict:
    with open(path) as f:
        mix = json.load(f)
    missing = [k for k in REQUIRED if k not in mix]
    if missing:
        raise ValueError(f"traffic {path}: missing {missing}")
    if int(mix["window_steps"]) < 1 or int(mix["warmup_windows"]) < 1:
        raise ValueError(f"traffic {path}: window_steps and warmup_windows "
                         "must be at least 1")
    if float(mix.get("output_minutes", 0)) > 0:
        raise ValueError(f"traffic {path}: output records are not "
                         "supported (output_minutes must be 0 or less)")
    return mix


def ssh_field(wet: np.ndarray, seed: int, bumps: dict) -> np.ndarray:
    """The seeded initial ssh on the (nx, ny) wet set, float32, 0 on
    land."""
    rng = np.random.default_rng(int(seed))
    nx, ny = wet.shape
    cells = np.flatnonzero(wet)
    centres = rng.choice(cells, size=int(bumps["count"]), replace=False)
    amps = rng.uniform(*bumps["amp_m"], size=len(centres))
    amps *= rng.choice([-1.0, 1.0], size=len(centres))
    sigmas = rng.uniform(*bumps["sigma_cells"], size=len(centres))
    m = np.arange(nx, dtype=np.float64)[:, None]
    n = np.arange(ny, dtype=np.float64)[None, :]
    out = np.zeros((nx, ny), np.float64)
    for c, a, s in zip(centres, amps, sigmas):
        cm, cn = divmod(int(c), ny)
        out += a * np.exp(-((m - cm) ** 2 + (n - cn) ** 2) / (2.0 * s * s))
    return np.where(wet, out, 0.0).astype(np.float32)


def write_record(path: str, field: np.ndarray, wet: np.ndarray) -> None:
    """One GrADS record: the (nx - 4) x (ny - 4) interior as float32 in
    Fortran order, -1e32 on land (the reference model's ssh init file)."""
    inner = np.where(wet[2:-2, 2:-2], field[2:-2, 2:-2], UNDEF)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    inner.astype(np.float32).flatten(order="F").tofile(path)
