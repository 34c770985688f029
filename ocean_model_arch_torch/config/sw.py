"""Shallow-water physics switches (the port's own copy of
``ocean_model_arch_tpu/config/sw.py``).

Mirrors configs/sw.f90 (fields + sw.par layout + presets).
"""

from __future__ import annotations

import dataclasses

from .parfile import first_lexeme, parse_fortran_float, read_par_lines


@dataclasses.dataclass(frozen=True)
class SWConfig:
    full_free_surface: int = 1   # depths evolve with ssh
    trans_terms: int = 1         # advection (momentum transport) terms
    ksw_lat: int = 1             # lateral viscosity terms
    time_smooth: float = 0.5     # Robert-Asselin filter coefficient
    lvisc_2: float = 1.0e3       # lateral viscosity coefficient
    use_tracers: int = 0
    tracer_num: int = 1
    ssh_init_file_name: str = "none"  # 'none' -> gaussian bump initial ssh


def load_sw(path: str) -> SWConfig:
    """Load from a reference-format sw.par (sw.f90:23-50)."""
    c = read_par_lines(path)
    return SWConfig(
        full_free_surface=int(first_lexeme(c[0])),
        trans_terms=int(first_lexeme(c[1])),
        ksw_lat=int(first_lexeme(c[2])),
        time_smooth=parse_fortran_float(first_lexeme(c[3])),
        lvisc_2=parse_fortran_float(first_lexeme(c[4])),
        use_tracers=int(first_lexeme(c[5])),
        tracer_num=int(first_lexeme(c[6])),
        ssh_init_file_name=first_lexeme(c[7]),
    )


def sw_test() -> SWConfig:
    """Test preset with one tracer (sw.f90:65-76)."""
    return SWConfig(full_free_surface=1, time_smooth=0.5, trans_terms=1,
                    ksw_lat=1, lvisc_2=1.0e3, use_tracers=1, tracer_num=1,
                    ssh_init_file_name="none")
