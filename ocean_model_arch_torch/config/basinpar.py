"""Basin / grid geometry configuration (the port's own copy of
``ocean_model_arch_tpu/config/basinpar.py``).

Mirrors configs/basinpar.f90 (fields, presets, and the
basin.par file layout). ``mmm/nnn/mm/nn`` follow the reference convention of
1-based Fortran indices of the significant area: mmm=nnn=3, mm=nx-2,
nn=ny-2 (basinpar.f90:86-89); in this package 0-based array indices are
used everywhere, so the interior wet-candidate region is
``[mmm-1 .. mm-1] x [nnn-1 .. nn-1]`` inclusive.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from .parfile import first_lexeme, parse_fortran_float, read_par_lines


@dataclasses.dataclass(frozen=True)
class BasinConfig:
    nx: int                   # total points in x (including 2-cell land frame each side)
    ny: int                   # total points in y
    nz: int = 1               # vertical s-levels (barotropic core uses 1)
    periodicity_x: int = 0    # 0 non-periodic / 1 periodic
    periodicity_y: int = 0
    dxst: float = 0.1         # lon step in degrees (regular grid)
    dyst: float = 0.1         # lat step in degrees (regular grid)
    rlon: float = 0.0         # lon of first significant t-point (m=mmm)
    rlat: float = 0.0         # lat of first significant t-point (n=nnn)
    xgr_type: int = 0         # 0 regular / 1 explicit levels
    ygr_type: int = 0
    curve_grid: int = 0       # 0 cartesian / 1 rotated sphere / 2 bipolar curvilinear
    rotation_on_lon: float = 0.0
    rotation_on_lat: float = 0.0
    x_pole: float = 90.0      # bipolar grid pole placement (curve_grid == 2)
    y_pole: float = 60.0
    p_pole: float = 90.0
    q_pole: float = -90.0
    mask_file_name: str = "none"
    bottom_topography_file_name: str = "none"
    x_levels: Optional[Sequence[float]] = None  # irregular grid levels (len nx)
    y_levels: Optional[Sequence[float]] = None

    # --- derived significant-area bounds (reference basinpar.f90:86-89) ---
    @property
    def mmm(self) -> int:
        return 3

    @property
    def nnn(self) -> int:
        return 3

    @property
    def mm(self) -> int:
        return self.nx - 2

    @property
    def nn(self) -> int:
        return self.ny - 2


def load_basinpar(path: str) -> BasinConfig:
    """Load from a reference-format basin.par (basinpar.f90:53-94)."""
    c = read_par_lines(path)
    return BasinConfig(
        nx=int(first_lexeme(c[0])),
        ny=int(first_lexeme(c[1])),
        nz=int(first_lexeme(c[2])),
        periodicity_x=int(first_lexeme(c[3])),
        periodicity_y=int(first_lexeme(c[4])),
        dxst=parse_fortran_float(first_lexeme(c[5])),
        dyst=parse_fortran_float(first_lexeme(c[6])),
        rlon=parse_fortran_float(first_lexeme(c[7])),
        rlat=parse_fortran_float(first_lexeme(c[8])),
        xgr_type=int(first_lexeme(c[9])),
        ygr_type=int(first_lexeme(c[10])),
        curve_grid=int(first_lexeme(c[11])),
        rotation_on_lon=parse_fortran_float(first_lexeme(c[12])),
        rotation_on_lat=parse_fortran_float(first_lexeme(c[13])),
        x_pole=parse_fortran_float(first_lexeme(c[14])),
        y_pole=parse_fortran_float(first_lexeme(c[15])),
        p_pole=parse_fortran_float(first_lexeme(c[16])),
        q_pole=parse_fortran_float(first_lexeme(c[17])),
        mask_file_name=first_lexeme(c[18]),
        bottom_topography_file_name=first_lexeme(c[19]),
    )


def basinpar_bs4km() -> BasinConfig:
    """Black Sea 4 km preset (basinpar.f90:96-130)."""
    return BasinConfig(
        nx=289, ny=163, nz=1,
        rlon=27.525, rlat=40.940, dxst=0.05, dyst=0.04,
        curve_grid=1,
        x_pole=90.0, y_pole=60.0, p_pole=90.0, q_pole=-90.0,
        mask_file_name="data/BS/mask_bs4km.txt",
        bottom_topography_file_name="none",
    )


def basinpar_as250m() -> BasinConfig:
    """Azov Sea 250 m preset — the shipped default basin.par
    (basinpar.f90:132-166)."""
    return BasinConfig(
        nx=1525, ny=1115, nz=1,
        rlon=34.751560, rlat=44.801125, dxst=0.00312, dyst=0.00225,
        curve_grid=1,
        x_pole=90.0, y_pole=60.0, p_pole=90.0, q_pole=-90.0,
        mask_file_name="data/AS/maskAzovCor.txt",
        bottom_topography_file_name="none",
    )


def basinpar_as250m_test() -> BasinConfig:
    """Azov-size synthetic test: no mask/topography files
    (basinpar.f90:168-202) — frame-of-land mask + flat 100 m depth."""
    return dataclasses.replace(
        basinpar_as250m(), mask_file_name="none",
        bottom_topography_file_name="none")


def basinpar_flat(nx: int, ny: int, dxst: float = 0.05, dyst: float = 0.05,
                  rlon: float = 0.0, rlat: float = 0.0,
                  curve_grid: int = 0) -> BasinConfig:
    """Synthetic flat basin of arbitrary size (benchmark config 1)."""
    return BasinConfig(nx=nx, ny=ny, dxst=dxst, dyst=dyst,
                       rlon=rlon, rlat=rlat, curve_grid=curve_grid)
