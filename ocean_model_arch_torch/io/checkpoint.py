"""Checkpoint / resume of the full prognostic state (counterpart of
``ocean_model_arch_tpu/io/checkpoint.py::save_checkpoint, load_checkpoint``).

The same plain .npz container: one array per SWState field that is not
None, under the field's name, plus the step counter ``__step__`` (int64),
so either package reads what the other wrote and a run restarts
bit-exactly. The per-shard orbax format of the JAX package needs a
package of its own and joins with the multi-process runs.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..core.state import SWState
from ..host import default_device


def save_checkpoint(path: str, state: SWState, step: int) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is not None:
            arrays[f.name] = v.detach().cpu().numpy()
    arrays["__step__"] = np.asarray(step, np.int64)
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)


def load_checkpoint(path: str, device=None) -> tuple[SWState, int]:
    """(state, step) of the checkpoint at ``path``, each field in the
    dtype it was saved in. ``device``: None -> the current CUDA device
    (raises without one); tests pass "cpu"."""
    if device is None:
        device = default_device()
    with np.load(path) as z:
        step = int(z["__step__"])
        kwargs = {}
        for f in dataclasses.fields(SWState):
            kwargs[f.name] = (torch.tensor(z[f.name], device=device)
                              if f.name in z.files else None)
    return SWState(**kwargs), step
