"""Prognostic + diagnostic model state as a dataclass of tensors
(counterpart of ``ocean_model_arch_tpu/core/state.py``).

The same fields as the JAX SWState: three-time-level ssh/velocity
families, RHS accumulators, mixing fields, Rayleigh dissipation, the
prognostic depth families and the (optional) stacked tracers. All start
at zero, as the reference's allocation path zero-fills every block.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..host import Precision, default_device, torch_dtype

TRACER_FIELDS = ("ff", "ffp", "ffn", "flux_x", "flux_y")


@dataclasses.dataclass
class SWState:
    # Sea surface height, three time levels (ocean.f90:15-17)
    ssh: torch.Tensor
    sshn: torch.Tensor
    sshp: torch.Tensor
    # Barotropic velocities (ocean.f90:18-23)
    ubrtr: torch.Tensor
    ubrtrn: torch.Tensor
    ubrtrp: torch.Tensor
    vbrtr: torch.Tensor
    vbrtrn: torch.Tensor
    vbrtrp: torch.Tensor
    # RHS accumulators (ocean.f90:24-31)
    rhsx: torch.Tensor
    rhsy: torch.Tensor
    rhsx_adv: torch.Tensor
    rhsy_adv: torch.Tensor
    rhsx_dif: torch.Tensor
    rhsy_dif: torch.Tensor
    # Mixing fields (ocean.f90:33-36)
    mu: torch.Tensor
    str_t: torch.Tensor
    str_s: torch.Tensor
    vort: torch.Tensor
    # Rayleigh friction scale, float32 (ocean.f90:32)
    r_diss: torch.Tensor
    # Depth families (grid.f90:40-50), prognostic under full_free_surface
    hhq: torch.Tensor
    hhq_p: torch.Tensor
    hhq_n: torch.Tensor
    hhu: torch.Tensor
    hhu_p: torch.Tensor
    hhu_n: torch.Tensor
    hhv: torch.Tensor
    hhv_p: torch.Tensor
    hhv_n: torch.Tensor
    hhh: torch.Tensor
    hhh_p: torch.Tensor
    hhh_n: torch.Tensor
    # Tracers, stacked (tracer_num, nx, ny) (ocean.f90:38-44); None if off
    ff: Optional[torch.Tensor] = None
    ffp: Optional[torch.Tensor] = None
    ffn: Optional[torch.Tensor] = None
    flux_x: Optional[torch.Tensor] = None
    flux_y: Optional[torch.Tensor] = None


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(SWState))


def zero_state(nx: int, ny: int, tracer_num: int = 0,
               precision: Precision = Precision.f64(),
               device=None) -> SWState:
    """An all-zero state (ocean_type%init, ocean.f90:56-117) on ``device``
    (None -> the current CUDA device; raises without one)."""
    if device is None:
        device = default_device()
    sd = torch_dtype(precision.state_dtype)
    d = {n: torch.zeros((nx, ny), dtype=sd, device=device)
         for n in STATE_FIELDS if n not in TRACER_FIELDS}
    d["r_diss"] = torch.zeros((nx, ny), dtype=torch.float32, device=device)
    if tracer_num:
        for n in ("ff", "ffp", "ffn"):
            d[n] = torch.zeros((tracer_num, nx, ny), dtype=sd, device=device)
        for n in ("flux_x", "flux_y"):
            d[n] = torch.zeros((nx, ny), dtype=sd, device=device)
    return SWState(**d)


def state_from_numpy(d: dict, device=None,
                     dtype: torch.dtype = torch.float64) -> SWState:
    """An SWState from numpy arrays named as the JAX SWState's fields
    (e.g. ``{n: np.asarray(getattr(jax_state, n)) for n in STATE_FIELDS}``;
    absent or None tracer fields stay None). Every field becomes
    ``dtype`` except ``r_diss``, which is float32 in both packages.
    ``device``: None -> the current CUDA device (raises without one)."""
    if device is None:
        device = default_device()
    out = {}
    for n in STATE_FIELDS:
        a = d.get(n)
        if a is None:
            continue
        dt = torch.float32 if n == "r_diss" else dtype
        out[n] = torch.tensor(np.asarray(a), dtype=dt, device=device)
    return SWState(**out)
