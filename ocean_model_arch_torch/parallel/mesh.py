"""The shard mesh (counterpart of ``ocean_model_arch_tpu/parallel/mesh.py``).

The JAX package shards every 2D field P("x", "y") over a jax device mesh,
the replacement of the reference's 2D MPI Cartesian communicator
(shared/mpp/mpp.f90:83-93). The port holds all px * py shards of the
eager sharded step on one torch device, stacked: a padded ``(..., nx,
ny)`` field becomes ``(..., px, py, lx, ly)`` (the shard axes just before
the spatial ones), so one tensor op steps every shard in lockstep, and
the halo exchange (parallel/halo.py) moves strips along the shard axes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..host import default_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """px x py shards, all on ``device``."""
    px: int
    py: int
    device: torch.device

    @property
    def shape(self) -> tuple:
        return (self.px, self.py)


def make_mesh(px: int, py: int, device=None) -> Mesh:
    """A px x py mesh on ``device`` (None -> the current CUDA device,
    raising without one; the CPU only when asked for)."""
    if px < 1 or py < 1:
        raise ValueError(f"a {px} x {py} mesh")
    return Mesh(int(px), int(py),
                torch.device(default_device() if device is None else device))


def auto_dims(n: int) -> tuple[int, int]:
    """Closest-to-square factorization, like mpi_dims_create."""
    best = (n, 1)
    for px in range(1, int(np.sqrt(n)) + 1):
        if n % px == 0:
            best = (n // px, px)
    return best


def field_spec(ndim: int) -> str:
    """How a padded field of ``ndim`` dims is laid out on the mesh: 2D
    fields and 3D tracer stacks split their last two (spatial) axes
    ("shard"), anything else is kept whole ("replicate")."""
    return "shard" if ndim in (2, 3) else "replicate"


def _tensors(tree):
    return {f.name: v for f in dataclasses.fields(tree)
            if isinstance(v := getattr(tree, f.name), torch.Tensor)}


def tree_specs(tree) -> dict:
    """``field_spec`` of every tensor field of a state or grid."""
    return {k: field_spec(v.ndim) for k, v in _tensors(tree).items()}


def shard_field(a: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A padded ``(..., nx, ny)`` field -> ``(..., px, py, nx // px,
    ny // py)`` on the mesh's device: shard (i, j) holds rows ``i lx ..
    (i + 1) lx - 1`` and columns ``j ly .. (j + 1) ly - 1``."""
    nx, ny = a.shape[-2:]
    if nx % mesh.px or ny % mesh.py:
        raise ValueError(f"a {nx} x {ny} field does not divide into a "
                         f"{mesh.px} x {mesh.py} mesh (pad it first)")
    b = a.unflatten(-2, (mesh.px, nx // mesh.px))
    b = b.unflatten(-1, (mesh.py, ny // mesh.py))
    return b.transpose(-3, -2).contiguous().to(mesh.device)


def unshard_field(a: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`shard_field`: ``(..., px, py, lx, ly)`` ->
    ``(..., px lx, py ly)``."""
    return a.transpose(-3, -2).flatten(-2, -1).flatten(-3, -2)


def shard_tree(tree, mesh: Mesh):
    """A state or grid whose padded fields (``field_spec`` "shard") are
    in the mesh's stacked layout."""
    fields = _tensors(tree)
    return dataclasses.replace(tree, **{
        k: shard_field(fields[k], mesh)
        for k, spec in tree_specs(tree).items() if spec == "shard"})


def unshard_tree(tree):
    """The inverse of :func:`shard_tree` (the padded global view)."""
    return dataclasses.replace(tree, **{
        k: unshard_field(v) for k, v in _tensors(tree).items()
        if v.ndim >= 4})
