"""Host-side modules shared with the JAX package, in one place.

``config/*``, ``core/{masks,metrics,constants}.py`` and ``io/mask_io.py``
of ``ocean_model_arch_tpu`` import only numpy (its package ``__init__``
imports nothing), so the port reuses them instead of keeping copies:
one source of truth for the configs, the mask rules and the metric
construction. ``tests/test_torch_imports.py`` checks that importing the
port leaves ``jax`` out of ``sys.modules``.
"""

from __future__ import annotations

import numpy as np
import torch

from ocean_model_arch_tpu.config import (BasinConfig, ModelConfig,  # noqa: F401
                                         Precision, SWConfig,
                                         basinpar_as250m_test)
from ocean_model_arch_tpu.core import masks, metrics  # noqa: F401
from ocean_model_arch_tpu.core.constants import (DPI,  # noqa: F401
                                                 FREE_FALL_ACC)
from ocean_model_arch_tpu.core.masks import frame_of_land_mask  # noqa: F401
from ocean_model_arch_tpu.io.mask_io import read_mask  # noqa: F401

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a :class:`Precision` numpy dtype."""
    return _TORCH_DTYPES[np.dtype(dtype)]
