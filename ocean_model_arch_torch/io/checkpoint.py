"""Checkpoint / resume of the full prognostic state (counterpart of
``ocean_model_arch_tpu/io/checkpoint.py::save_checkpoint, load_checkpoint``).

The same plain .npz container: one array per SWState field that is not
None, under the field's name, plus the step counter ``__step__`` (int64),
so either package reads what the other wrote and a run restarts
bit-exactly.

``save_checkpoint_sharded`` / ``load_checkpoint_sharded`` keep the JAX
package's names for its per-shard checkpoint, but the format is the
port's own and **not** orbax (the card host has no orbax): a directory
where every process writes one ``.npz`` of the shards it holds and rank
0 an index (``index.json``: the mesh, its cut lines, each shard's rank,
the step, and each field's dtype and leading shape). A shard is the
basin's cells inside its cut lines, so a checkpoint of the eager sharded
step (padded, stacked) and one of the fused-sharded model (the basin,
cut by its own lines) read back alike.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..core.state import SWState
from ..host import default_device
from ..parallel import multihost

INDEX = "index.json"
FORMAT = "ocean_model_arch_torch sharded npz (not orbax)"


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


# ---------------------------------------------------------------------
# Sharded checkpoints across processes: each process writes its own
# shards -- the analog of the reference's collective MPI-IO
# (tools/io.f90:276-498), where every rank writes its block subarrays.

def _shard_file(path: str, rank: int) -> str:
    return os.path.join(path, f"shards-{rank:05d}.npz")


def _uniform(n: int, parts: int) -> np.ndarray:
    return np.minimum(np.arange(parts + 1, dtype=np.int64)
                      * -(-n // parts), n)


def save_checkpoint_sharded(path: str, state: SWState, step: int,
                            mesh=None, x_edges=None, y_edges=None,
                            extents=None) -> None:
    """Write ``state`` and the step counter into the directory ``path``
    (see the module): every process its own shards, rank 0 the index.
    Collective: every process of the group calls it.

    ``state`` is either the stacked, padded block of the eager sharded
    step on ``mesh`` (``parallel/mesh.py``; ``extents``: the basin's (nx,
    ny), which the padding is cropped to; the cut lines are the mesh's
    uniform ones) or the whole basin, cut by ``x_edges`` / ``y_edges``
    (default: ``ceil(n / p)`` cells a shard) over ``mesh``'s shards, each
    written by its owner (no mesh: one shard, this process's)."""
    fields = {f.name: v for f in dataclasses.fields(state)
              if (v := getattr(state, f.name)) is not None}
    stacked = state.ssh.ndim == 4
    if stacked and mesh is None:
        raise ValueError("a stacked (sharded) state needs its mesh")
    px, py = (mesh.px, mesh.py) if mesh is not None else (1, 1)
    rank, world = multihost.process_index(), multihost.process_count()
    owners = (list(mesh.owners) if mesh is not None else [rank])
    if stacked:
        bx, by = mesh.block
        lx, ly = state.ssh.shape[-2:]
        nx, ny = extents or (px * lx, py * ly)
        xe = np.minimum(np.arange(px + 1, dtype=np.int64) * lx, nx)
        ye = np.minimum(np.arange(py + 1, dtype=np.int64) * ly, ny)
        i0, j0 = mesh.origin()
    else:
        nx, ny = state.ssh.shape
        xe = (np.asarray(x_edges, np.int64) if x_edges is not None
              else _uniform(nx, px))
        ye = (np.asarray(y_edges, np.int64) if y_edges is not None
              else _uniform(ny, py))
    arrays = {}
    for i in range(px):
        for j in range(py):
            if owners[i * py + j] != rank:
                continue
            w, h = int(xe[i + 1] - xe[i]), int(ye[j + 1] - ye[j])
            for name, v in fields.items():
                if stacked:
                    box = v[..., i - i0, j - j0, :w, :h]
                else:
                    box = v[..., xe[i]:xe[i + 1], ye[j]:ye[j + 1]]
                arrays[f"{name}@{i},{j}"] = box.detach().cpu().numpy()
    if rank == 0:
        os.makedirs(path, exist_ok=True)
        for n in os.listdir(path):
            if n.startswith("shards-") or n == INDEX:
                os.remove(os.path.join(path, n))
    multihost.barrier()
    tmp = _shard_file(path, rank) + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, _shard_file(path, rank))
    multihost.barrier()
    if rank == 0:
        lead = {n: list(v.shape[:-4] if stacked else v.shape[:-2])
                for n, v in fields.items()}
        index = {"format": FORMAT, "step": int(step), "px": px, "py": py,
                 "world": world, "owners": owners, "nx": int(nx),
                 "ny": int(ny), "x_edges": xe.tolist(),
                 "y_edges": ye.tolist(),
                 "fields": {n: {"dtype": str(np.dtype(
                     str(v.dtype).replace("torch.", ""))),
                     "lead": lead[n]} for n, v in fields.items()}}
        with open(os.path.join(path, INDEX + ".tmp"), "w") as f:
            json.dump(index, f, indent=1)
        os.replace(os.path.join(path, INDEX + ".tmp"),
                   os.path.join(path, INDEX))
    multihost.barrier()


def load_checkpoint_sharded(path: str, mesh=None,
                            device=None) -> tuple[SWState, int]:
    """(state, step) of the sharded checkpoint in ``path``.

    Without ``mesh``: the whole basin, read from every process's file
    (one process assembles what N wrote, as the JAX package restores
    unlisted fields to host arrays). With ``mesh``: it must be the mesh
    that wrote the checkpoint (its shape, its process count and its
    uniform cut lines); each process reads only its own file and gets its
    stacked, padded block of the eager sharded step, in place. ``device``:
    None -> the mesh's, else the current CUDA device (raises without
    one); tests pass "cpu"."""
    with open(os.path.join(path, INDEX)) as f:
        index = json.load(f)
    if index.get("format") != FORMAT:
        raise ValueError(f"{path}: not a sharded checkpoint of this package")
    px, py, nx, ny = index["px"], index["py"], index["nx"], index["ny"]
    xe, ye, owners = index["x_edges"], index["y_edges"], index["owners"]
    if device is None:
        device = mesh.device if mesh is not None else default_device()
    kwargs = {f.name: None for f in dataclasses.fields(SWState)}
    if mesh is None:
        zs = {r: np.load(_shard_file(path, r)) for r in set(owners)}
        for name, meta in index["fields"].items():
            out = np.zeros(tuple(meta["lead"]) + (nx, ny), meta["dtype"])
            for i in range(px):
                for j in range(py):
                    out[..., xe[i]:xe[i + 1], ye[j]:ye[j + 1]] = \
                        zs[owners[i * py + j]][f"{name}@{i},{j}"]
            kwargs[name] = torch.from_numpy(out).to(device)
        for z in zs.values():
            z.close()
        return SWState(**kwargs), int(index["step"])
    lx, ly = -(-nx // px), -(-ny // py)
    if ((px, py, index["world"]) != (mesh.px, mesh.py, mesh.world)
            or owners != list(mesh.owners)
            or xe != np.minimum(np.arange(px + 1) * lx, nx).tolist()
            or ye != np.minimum(np.arange(py + 1) * ly, ny).tolist()):
        raise ValueError(
            f"{path} was written by a {px} x {py} mesh over "
            f"{index['world']} processes with cuts x {xe} y {ye}; it loads "
            f"into that mesh only (this one: {mesh.px} x {mesh.py} over "
            f"{mesh.world}); load it without a mesh for the whole basin")
    (bx, by), (i0, j0) = mesh.block, mesh.origin()
    with np.load(_shard_file(path, mesh.rank)) as z:
        for name, meta in index["fields"].items():
            out = np.zeros(tuple(meta["lead"]) + (bx, by, lx, ly),
                           meta["dtype"])
            for a in range(bx):
                for b in range(by):
                    box = z[f"{name}@{i0 + a},{j0 + b}"]
                    out[..., a, b, :box.shape[-2], :box.shape[-1]] = box
            kwargs[name] = torch.from_numpy(out).to(device)
    return SWState(**kwargs), int(index["step"])
