"""Typed configuration for the framework (the port's own copy of
``ocean_model_arch_tpu/config/__init__.py``).

Four groups, mirroring the reference's four .par files plus a precision
policy (the reference's compile-time macros become trace-time config
fields — free under jit):

- BasinConfig  <- basin.par      (grid geometry)
- SWConfig     <- sw.par         (physics switches)
- ParallelConfig <- parallel.par (mesh / decomposition)
- RunConfig    <- ocean_run.par  (timestep, duration, output cadence)
- Precision    — f64 validation mode vs f32 production mode
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .basinpar import (BasinConfig, basinpar_as250m, basinpar_as250m_test,
                       basinpar_bs4km, basinpar_flat, load_basinpar)
from .parallel import ParallelConfig, load_parallel
from .runpar import RunConfig, load_runpar
from .sw import SWConfig, load_sw, sw_test


@dataclasses.dataclass(frozen=True)
class Precision:
    """Dtype policy.

    The reference keeps prognostic state in real8 and grid metrics in real4
    (e.g. vel_ssh.f90:76-90 mixes wp8 state with wp4 metrics). ``f64()``
    reproduces exactly that for validation; ``f32()`` is the TPU production
    mode (float32 state AND metrics — double precision is emulated and slow
    on TPU).
    """
    state_dtype: np.dtype = np.dtype(np.float64)
    metric_dtype: np.dtype = np.dtype(np.float32)
    mask_dtype: np.dtype = np.dtype(np.float32)

    @staticmethod
    def f64() -> "Precision":
        return Precision(np.dtype(np.float64), np.dtype(np.float32))

    @staticmethod
    def f32() -> "Precision":
        return Precision(np.dtype(np.float32), np.dtype(np.float32))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The full model configuration bundle."""
    basin: BasinConfig
    sw: SWConfig = SWConfig()
    parallel: ParallelConfig = ParallelConfig()
    run: RunConfig = RunConfig()
    precision: Precision = Precision.f64()


__all__ = [
    "BasinConfig", "SWConfig", "ParallelConfig", "RunConfig", "Precision",
    "ModelConfig",
    "load_basinpar", "load_sw", "load_parallel", "load_runpar",
    "basinpar_bs4km", "basinpar_as250m", "basinpar_as250m_test",
    "basinpar_flat", "sw_test",
]
