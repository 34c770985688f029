"""Stencil access on halo-padded tensors (counterpart of
``ocean_model_arch_tpu/ops/stencil.py``).

Every eager physics kernel takes 2D tensors carrying a ``HALO``-cell
ghost frame on all sides (shape ``(nx + 2*HALO, ny + 2*HALO)``), reads
neighbours through :func:`sh` (plain slices, no copies) and returns
unpadded ``(nx, ny)`` tensors. On a single device :func:`pad` fills the
frame with zeros (closed boundaries; the 2-cell land frame keeps it away
from every wet point) or wraps it (periodic axes).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

HALO = 2


def _pad_axis(f: torch.Tensor, dim: int, h: int, periodic: bool):
    if periodic:
        lo = f.narrow(dim, f.shape[dim] - h, h)
        hi = f.narrow(dim, 0, h)
        return torch.cat([lo, f, hi], dim=dim)
    pads = [0, 0] * (f.ndim - 1 - dim % f.ndim) + [h, h]
    return F.pad(f, pads)


def pad(f: torch.Tensor, periodic_x: bool = False, periodic_y: bool = False,
        h: int = HALO) -> torch.Tensor:
    """Pad the spatial (last two) axes with an h-cell ghost frame; leading
    axes pass through. Closed edges get zeros, periodic edges wrap (x is
    padded before y, as the JAX package does)."""
    f = _pad_axis(f, -2, h, periodic_x)
    return _pad_axis(f, -1, h, periodic_y)


def sh(fp: torch.Tensor, dm: int, dn: int, h: int = HALO) -> torch.Tensor:
    """Shifted view: result[..., m, n] = f[..., m + dm, n + dn].

    ``fp`` is padded on its last two axes; the result drops the padding.
    ``|dm|, |dn| <= h``.
    """
    nx = fp.shape[-2] - 2 * h
    ny = fp.shape[-1] - 2 * h
    return fp[..., h + dm:h + dm + nx, h + dn:h + dn + ny]


def C(fp: torch.Tensor, h: int = HALO) -> torch.Tensor:
    """Center view (the unpadded field)."""
    return sh(fp, 0, 0, h)


def wet(mask_c: torch.Tensor) -> torch.Tensor:
    """Boolean wet-point predicate from a real-valued Arakawa mask (the
    reference tests ``mask > 0.5``). ``mask_c`` is a center view."""
    return mask_c > 0.5
