"""The port's host side in one place: re-exports of its numpy-only
modules (``config/*``, ``core/{masks,metrics,constants}.py``,
``io/mask_io.py`` -- the port's own copies of the JAX package's, which it
never imports), the numpy -> torch dtype map, and the default device.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import (BasinConfig, ModelConfig, Precision,  # noqa: F401
                     SWConfig, basinpar_as250m_test)
from .core import masks, metrics  # noqa: F401
from .core.constants import DPI, FREE_FALL_ACC  # noqa: F401
from .core.masks import frame_of_land_mask  # noqa: F401
from .io.mask_io import read_mask  # noqa: F401

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a :class:`Precision` numpy dtype."""
    return _TORCH_DTYPES[np.dtype(dtype)]


def default_device() -> torch.device:
    """The current CUDA device: where every entry point places its
    tensors unless the caller names a device. Raises without one -- the
    CPU is used only when asked for (``device="cpu"``)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "False); pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
