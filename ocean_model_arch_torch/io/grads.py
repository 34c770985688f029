"""GrADS-compatible field output / input (the port's own copy of
``ocean_model_arch_tpu/io/grads.py``).

Re-implements the reference's output path (control/output.f90 +
tools/io.f90 write_data + legacy/service/rw_ctl_file.f90) in Python:
real4 direct-access records of the (nx-4)x(ny-4) significant interior in
Fortran (column-major, m fastest) order, ``undef = -1e32`` on land, plus a
standard GrADS .ctl metadata file — so reference users' GrADS tooling
reads our results unchanged, and our reader ingests reference-written
.dat files (ssh init, bathymetry).
"""

from __future__ import annotations

import os

import numpy as np

UNDEF = np.float32(-1.0e32)   # legacy/service/input_output_data.f90 undef

_MONTHS = ["JAN", "FEB", "MAR", "APR", "MAY", "JUN",
           "JUL", "AUG", "SEP", "OCT", "NOV", "DEC"]


def interior(field: np.ndarray) -> np.ndarray:
    """The significant area [mmm..mm]x[nnn..nn] -> 0-based [2:-2, 2:-2]."""
    return field[2:-2, 2:-2]


def write_record(path: str, nrec: int, field: np.ndarray,
                 lu: np.ndarray) -> None:
    """Write record ``nrec`` (1-based) of the interior of ``field`` as raw
    float32, undef on land. Creates/extends the file as needed.

    Uses the native C++ pack+pwrite path (io/native.py) when available."""
    from . import native
    if native.write_record(path, nrec, np.asarray(field),
                           np.asarray(lu), float(UNDEF)):
        return
    data = interior(np.asarray(field)).astype(np.float32)
    wet = interior(np.asarray(lu)) > 0.5
    data = np.where(wet, data, UNDEF)
    rec = data.flatten(order="F").tobytes()
    recl = len(rec)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    mode = "r+b" if os.path.exists(path) else "wb"
    with open(path, mode) as f:
        end = f.seek(0, 2)
        offset = (nrec - 1) * recl
        if end < offset:    # pre-fill missing records with undef
            f.write(np.full((offset - end) // 4, UNDEF,
                            np.float32).tobytes())
        f.seek(offset)
        f.write(rec)


def read_record(path: str, nrec: int, nx: int, ny: int) -> np.ndarray:
    """Read record ``nrec`` (1-based) into a full (nx, ny) float32 array
    (interior filled, frame zero, undef -> 0)."""
    inx, iny = nx - 4, ny - 4
    recl = inx * iny * 4
    with open(path, "rb") as f:
        f.seek((nrec - 1) * recl)
        buf = f.read(recl)
    data = np.frombuffer(buf, np.float32).reshape((inx, iny), order="F")
    out = np.zeros((nx, ny), np.float32)
    out[2:-2, 2:-2] = np.where(data <= UNDEF / 2, 0.0, data)
    return out


def read_ctl(ctl_path: str) -> dict:
    """Parse a GrADS .ctl companion (ctl_file_read analog,
    rw_ctl_file.f90:193-572): returns dset/undef/nx/ny/nz/nt/x0/hx/y0/hy/
    varname — enough to locate and read the .dat records."""
    out: dict = {}
    with open(ctl_path) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        t = lines[i].split()
        i += 1
        if not t:
            continue
        key = t[0].upper()
        if key == "DSET":
            out["dset"] = t[1].lstrip("^")
        elif key == "TITLE":
            out["title"] = " ".join(t[1:])
        elif key == "UNDEF":
            out["undef"] = float(t[1])
        elif key in ("XDEF", "YDEF", "ZDEF", "TDEF"):
            axis = key[0].lower()
            out[f"n{axis}"] = int(t[1])
            kind = t[2].upper()
            if kind == "LINEAR" and axis in "xy":
                out[f"{axis}0"] = float(t[3])
                out[f"h{axis}"] = float(t[4])
            elif kind == "LEVELS":
                levels = [float(v) for v in t[3:]]
                while len(levels) < out[f"n{axis}"] and i < len(lines):
                    levels += [float(v) for v in lines[i].split()]
                    i += 1
                out[f"{axis}_levels"] = levels
        elif key == "VARS":
            nvars = int(t[1])
            out["vars"] = []
            for k in range(nvars):
                vt = lines[i].split()
                i += 1
                out["vars"].append(vt[0])
            out["varname"] = out["vars"][0] if out["vars"] else None
    return out


def write_ctl(dat_path: str, *, nx: int, ny: int, nz: int = 1, nt: int = 1,
              x0: float = 0.0, hx: float = 1.0,
              y0: float = 0.0, hy: float = 1.0,
              x_levels=None, y_levels=None,
              year: int = 2012, month: int = 1, day: int = 1,
              hour: int = 0, minute: int = 0, tstep_sec: float = 60.0,
              title: str = "field", varname: str = "var") -> str:
    """Write the .ctl companion of a .dat file (ctl_file_write analog)."""
    ctl_path = os.path.splitext(dat_path)[0] + ".ctl"
    dset = os.path.basename(dat_path)

    # GrADS time increment: round the step to minutes (>=1mn)
    inc_min = max(1, int(round(tstep_sec / 60.0)))
    tdef_inc = f"{inc_min}mn" if inc_min < 60 else f"{inc_min // 60}hr"

    lines = [f"DSET    ^{dset}",
             f"TITLE    {title}",
             f"UNDEF   {float(UNDEF):.5E}  ! gap value"]
    if x_levels is None:
        lines.append(f"XDEF  {nx}  LINEAR   {x0:.8g}     {hx:.8g}")
    else:
        lv = " ".join(f"{v:.8g}" for v in x_levels)
        lines.append(f"XDEF  {nx}  LEVELS  {lv}")
    if y_levels is None:
        lines.append(f"YDEF  {ny}  LINEAR   {y0:.8g}     {hy:.8g}")
    else:
        lv = " ".join(f"{v:.8g}" for v in y_levels)
        lines.append(f"YDEF  {ny}  LEVELS  {lv}")
    lines.append(f"ZDEF  {nz}  LINEAR   0     1")
    t0 = f"{hour:02d}:{minute:02d}Z{day:02d}{_MONTHS[month - 1]}{year:04d}"
    lines.append(f"TDEF  {nt}  LINEAR   {t0}   {tdef_inc}")
    lines.append("VARS 1")
    lines.append(f"{varname}  {nz}  99  {title}")
    lines.append("ENDVARS")
    with open(ctl_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return ctl_path
