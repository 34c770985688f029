"""Whether a run's results are correct: the program's states held against
the plain reference (``reference/``), which works out the grid, the
initial state and every step again from the same run directory.

Numbers compared, each against its limit from the configuration's
``config.json`` (``limits``):

- ``init``: the program's initial state (the carried fields and the
  depths hu, hv, hh) against the reference's, from the run directory and
  the seeded ssh record;
- ``ssh``, ``uv``, ``ff``: after a window of the mix's steps, the carried
  fields (ssh and sshp; u, up, v, vp; every tracer's ff and ffp) against
  the reference's after the same steps, the worst of two windows: the
  first warm-up window, which the reference runs from its own initial
  state, and a window of the measured ones drawn from the seed, which it
  runs from the program's state at that window's start;
- ``guard``: windows whose stability flag differs between the two.

A gap is max |program - reference| over the field's wet cells, over max
|reference| there (the field's scale).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from port_bench.reference import grid as ref_grid
from port_bench.reference.sw import Reference

# the wet set of each compared field
WET = dict(ssh="lu", sshp="lu", u="lcu", up="lcu", v="lcv", vp="lcv",
           ff="lu", ffp="lu", hu="llu", hv="llv", hh="luh")
GROUPS = dict(ssh=("ssh", "sshp"), uv=("u", "up", "v", "vp"),
              ff=("ff", "ffp"))


def limits_of(cfg_dir: str) -> dict:
    with open(os.path.join(cfg_dir, "config.json")) as f:
        return json.load(f)["limits"]


def gap(prog, ref, wet) -> float:
    """max |prog - ref| over wet cells / max |ref| there (the absolute
    gap where the reference is zero there); NaN reads as infinite."""
    import torch
    p = prog.double().to(ref.device)
    r = ref.double()
    w = wet.expand_as(r)
    d = torch.where(w, (p - r).abs(), 0.0).max()
    scale = torch.where(w, r.abs(), 0.0).max()
    d, scale = float(d), float(scale)
    if not np.isfinite(d) or bool(torch.isnan(p[w]).any()):
        return float("inf")
    return d / scale if scale > 0 else d


class Check:
    def __init__(self, cfg_dir: str, run_dir: str, settings: dict, device):
        import torch
        self.limits = limits_of(cfg_dir)
        t0 = time.perf_counter()
        g = ref_grid.build(settings, run_dir)
        b = settings["basin"]
        self.ssh0 = ref_grid.read_record(
            os.path.join(run_dir, "INIT", settings["sw"]["ssh_init"]),
            b["nx"], b["ny"])
        self.ref = Reference(g, settings, device, torch.float32)
        self.wet = {k: torch.as_tensor(g[k] > 0.5, device=device)
                    for k in set(WET.values())}
        self.values: dict = {}
        self.guard_mismatch = 0
        self.ref_s = time.perf_counter() - t0

    def _take(self, name: str, v: float) -> None:
        self.values[name] = max(self.values.get(name, 0.0), v)

    def initial(self, prog: dict) -> None:
        """The program's initial carried fields and depths."""
        r = self.ref.initial_state(self.ssh0)
        hu, hv, hh = (self.ref.full(a) for a in self.ref.depths(r["ssh"]))
        r.update(hu=hu, hv=hv, hh=hh)
        self._take("init", max(gap(prog[k], r[k], self.wet[WET[k]])
                               for k in prog))

    def window(self, pre, post: dict, steps: int, prog_ok: bool = True):
        """``steps`` reference steps from ``pre`` (the program's state; None:
        the reference's own initial state) held against ``post``."""
        import torch
        t0 = time.perf_counter()
        ref = self.ref
        start = (ref.initial_state(self.ssh0) if pre is None else
                 {k: v.to(ref.device, torch.float32) for k, v in pre.items()})
        r, ok = ref.run(start, steps)
        self.ref_s += time.perf_counter() - t0
        if ok != prog_ok:
            self.guard_mismatch += 1
        for group, names in GROUPS.items():
            if names[0] in post:
                self._take(group, max(gap(post[k], r[k], self.wet[WET[k]])
                                      for k in names))

    def missing(self) -> None:
        """A compared window the run did not reach."""
        self.guard_mismatch += 1

    def checks(self) -> dict:
        """Every number compared beside its limit, in a fixed order."""
        vals = dict(self.values, guard=float(self.guard_mismatch))
        return {k: {"value": vals[k], "limit": self.limits[k]}
                for k in ("init", "ssh", "uv", "ff", "guard") if k in vals}

    def correct(self) -> bool:
        return all(c["value"] <= c["limit"] for c in self.checks().values())
