"""Run / time-manager configuration (the port's own copy of
``ocean_model_arch_tpu/config/runpar.py``).

Mirrors the consumed subset of ocean_run.par (parsed by
tools/time_manager.f90:124-179): start type, timestep,
duration, initial step/year, local output cadence, and the results path.
The long tail of forcing-file names in ocean_run.par is accepted and
retained verbatim for config-file compatibility.
"""

from __future__ import annotations

import dataclasses

from .parfile import first_lexeme, parse_fortran_float, read_par_lines


@dataclasses.dataclass(frozen=True)
class RunConfig:
    start_type: int = 0           # 0 cold start / 1 resume from checkpoint
    tau: float = 1.0              # model timestep [s]
    run_duration_days: float = 0.007
    init_step: int = 0            # starting step number
    init_year: int = 2012
    loc_data_wr_period_min: float = 1.0   # local output period [minutes]; <=0 disables
    points_output_period_min: float = -1.0
    results_path: str = "RESULTS"
    checkpoint_path: str = "CHECKPOINTS"
    forcing_files: tuple = ()

    @property
    def num_step_max(self) -> int:
        # time_manager.f90:266: run_duration*86400/tau
        return int(self.run_duration_days * 86400.0 / self.tau)

    @property
    def output_every_steps(self) -> int:
        """Steps between local outputs; 0 disables output.

        time_manager.f90:320-331: output when the step lands on a whole
        multiple of the write period; a period > 1440 minutes means once
        per day (time_manager.f90 comment on loc_data_wr_period)."""
        if self.loc_data_wr_period_min <= 0:
            return 0
        period_min = self.loc_data_wr_period_min
        if period_min > 1440.0:
            period_min = 1440.0
        return max(1, int(round(period_min * 60.0 / self.tau)))


def load_runpar(path: str) -> RunConfig:
    """Load from a reference-format ocean_run.par."""
    c = read_par_lines(path)
    return RunConfig(
        start_type=int(first_lexeme(c[0])),
        tau=parse_fortran_float(first_lexeme(c[1])),
        run_duration_days=parse_fortran_float(first_lexeme(c[2])),
        init_step=int(first_lexeme(c[3])),
        init_year=int(first_lexeme(c[4])),
        loc_data_wr_period_min=parse_fortran_float(first_lexeme(c[5])),
        points_output_period_min=parse_fortran_float(first_lexeme(c[6])),
        results_path=first_lexeme(c[9]) if len(c) > 9 else "RESULTS",
        forcing_files=tuple(first_lexeme(x) for x in c[10:]),
    )
