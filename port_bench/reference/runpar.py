"""Reads the positional ``.par`` files of a run directory.

Each line holds one value before a ``:``; the position of the line names
the value (the reference model's readpar). Only the values the
barotropic run uses are taken.
"""

from __future__ import annotations

import os


def _values(path: str) -> list:
    with open(path) as f:
        return [(line.split(":", 1)[0].split() or [""])[0] for line in f]


def _float(tok: str) -> float:
    return float(tok.lower().replace("d", "e"))


def read_run_dir(run_dir: str) -> dict:
    """The run's settings: ``basin``, ``sw`` and ``run`` dicts."""
    b = _values(os.path.join(run_dir, "basin.par"))
    s = _values(os.path.join(run_dir, "sw.par"))
    r = _values(os.path.join(run_dir, "ocean_run.par"))
    basin = dict(nx=int(b[0]), ny=int(b[1]), periodic_x=int(b[3]),
                 periodic_y=int(b[4]), dxst=_float(b[5]), dyst=_float(b[6]),
                 rlon=_float(b[7]), rlat=_float(b[8]), xgr_type=int(b[9]),
                 ygr_type=int(b[10]), curve_grid=int(b[11]),
                 rotation_on_lon=_float(b[12]), rotation_on_lat=_float(b[13]),
                 mask=b[18], topo=b[19])
    sw = dict(full_free_surface=int(s[0]), trans_terms=int(s[1]),
              ksw_lat=int(s[2]), time_smooth=_float(s[3]),
              lvisc_2=_float(s[4]), use_tracers=int(s[5]),
              tracer_num=int(s[6]), ssh_init=s[7])
    run = dict(tau=_float(r[1]))
    return dict(basin=basin, sw=sw, run=run)


def n_tracers(settings: dict) -> int:
    sw = settings["sw"]
    return sw["tracer_num"] if sw["use_tracers"] > 0 else 0
