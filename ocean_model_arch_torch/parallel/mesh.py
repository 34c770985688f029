"""The shard mesh (counterpart of ``ocean_model_arch_tpu/parallel/mesh.py``).

The JAX package shards every 2D field P("x", "y") over a jax device mesh,
the replacement of the reference's 2D MPI Cartesian communicator
(shared/mpp/mpp.f90:83-93). The port holds the px * py shards of the
eager sharded step stacked: a padded ``(..., nx, ny)`` field becomes
``(..., px, py, lx, ly)`` (the shard axes just before the spatial ones),
so one tensor op steps every shard in lockstep, and the halo exchange
(parallel/halo.py) moves strips along the shard axes.

Across processes (``parallel/multihost.py``) the ranks form an rx x ry
grid over the mesh and each holds a block of ``px / rx`` x ``py / ry``
shards, stacked the same way: ``(..., px / rx, py / ry, lx, ly)`` on its
own device; with one shard a process, shard (i, j) is rank ``i * py +
j``. The exchange sends the strips at a block's edges to the neighbouring
ranks. One process holds every shard (rx = ry = 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..host import default_device
from . import multihost


@dataclasses.dataclass(frozen=True)
class Mesh:
    """px x py shards; this process (``rank`` of ``world``, laid out as an
    rx x ry grid of ranks) holds its block of them on ``device``."""
    px: int
    py: int
    device: torch.device
    rank: int = 0
    world: int = 1
    rx: int = 1
    ry: int = 1

    @property
    def shape(self) -> tuple:
        return (self.px, self.py)

    @property
    def block(self) -> tuple:
        """The shards a rank holds along x and y."""
        return (self.px // self.rx, self.py // self.ry)

    def coords(self, rank: int | None = None) -> tuple:
        """A rank's place (cx, cy) in the grid of ranks."""
        r = self.rank if rank is None else rank
        return (r // self.ry, r % self.ry)

    def origin(self, rank: int | None = None) -> tuple:
        """The first shard (i, j) of a rank's block."""
        cx, cy = self.coords(rank)
        bx, by = self.block
        return (cx * bx, cy * by)

    def owner(self, i: int, j: int) -> int:
        """The rank that holds shard (i, j)."""
        bx, by = self.block
        return (i // bx) * self.ry + j // by

    @property
    def owners(self) -> tuple:
        """Every shard's rank, row-major over (x, y)."""
        return tuple(self.owner(i, j) for i in range(self.px)
                     for j in range(self.py))

    def shard_devices(self) -> list:
        """One entry a shard, row-major, as ``FusedSharded2DModel`` takes
        them: this process's device for its own shards, the owner's rank
        for the others."""
        return [self.device if r == self.rank
                else multihost.RankDevice(r, self.device)
                for r in self.owners]

    def neighbour(self, axis: int, step: int, periodic: bool):
        """The rank ``step`` (+1 or -1) places along ``axis`` (0: x, 1: y)
        in the grid of ranks, or None past a closed edge."""
        c = list(self.coords())
        n = (self.rx, self.ry)[axis]
        c[axis] += step
        if not 0 <= c[axis] < n:
            if not periodic:
                return None
            c[axis] %= n
        return c[0] * self.ry + c[1]


def process_grid(px: int, py: int, world: int) -> tuple:
    """The rx x ry grid of ``world`` ranks over a px x py mesh: rx divides
    px, ry divides py, as many ranks along x as can be."""
    for rx in range(min(px, world), 0, -1):
        if px % rx == 0 and world % rx == 0 and py % (world // rx) == 0:
            return rx, world // rx
    raise ValueError(f"{world} processes cannot hold equal blocks of a "
                     f"{px} x {py} mesh")


def make_mesh(px: int, py: int, device=None) -> Mesh:
    """A px x py mesh over every process (one process: every shard on
    ``device``; in a process group the ranks' blocks, see the module).
    ``device``: None -> this process's device (the current CUDA device,
    raising without one); the CPU only when asked for."""
    if px < 1 or py < 1:
        raise ValueError(f"a {px} x {py} mesh")
    if device is None:
        device = (multihost.local_device() if multihost.process_count() > 1
                  else default_device())
    world = multihost.process_count()
    rx, ry = process_grid(int(px), int(py), world)
    return Mesh(int(px), int(py), torch.device(device),
                multihost.process_index(), world, rx, ry)


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
    """A padded ``(..., nx, ny)`` field -> this process's block ``(...,
    bx, by, nx // px, ny // py)`` on the mesh's device: shard (i, j) holds
    rows ``i lx .. (i + 1) lx - 1`` and columns ``j ly .. (j + 1) ly -
    1``; one process holds all of them, ``(..., px, py, lx, ly)``."""
    nx, ny = a.shape[-2:]
    if nx % mesh.px or ny % mesh.py:
        raise ValueError(f"a {nx} x {ny} field does not divide into a "
                         f"{mesh.px} x {mesh.py} mesh (pad it first)")
    b = a.unflatten(-2, (mesh.px, nx // mesh.px))
    b = b.unflatten(-1, (mesh.py, ny // mesh.py)).transpose(-3, -2)
    if mesh.world > 1:
        (i0, j0), (bx, by) = mesh.origin(), mesh.block
        b = b[..., i0:i0 + bx, j0:j0 + by, :, :]
    return b.contiguous().to(mesh.device)


def gather_field(a: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's block ``(..., bx, by, lx, ly)`` -> all shards ``(...,
    px, py, lx, ly)`` on every process. Collective."""
    if mesh.world == 1:
        return a
    parts = multihost.all_gather(a)
    (bx, by) = mesh.block
    out = a.new_empty(a.shape[:-4] + (mesh.px, mesh.py) + a.shape[-2:])
    for r, part in enumerate(parts):
        i0, j0 = mesh.origin(r)
        out[..., i0:i0 + bx, j0:j0 + by, :, :] = part
    return out


def unshard_field(a: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """The inverse of :func:`shard_field`: ``(..., px, py, lx, ly)`` ->
    ``(..., px lx, py ly)``; given a mesh across processes, every rank's
    block is gathered first (collective)."""
    if mesh is not None:
        a = gather_field(a, mesh)
    return a.transpose(-3, -2).flatten(-2, -1).flatten(-3, -2)


def shard_tree(tree, mesh: Mesh):
    """A state or grid whose padded fields (``field_spec`` "shard") are
    in the mesh's stacked layout: this process's block of shards."""
    fields = _tensors(tree)
    return dataclasses.replace(tree, **{
        k: shard_field(fields[k], mesh)
        for k, spec in tree_specs(tree).items() if spec == "shard"})


def unshard_tree(tree, mesh: Mesh | None = None):
    """The inverse of :func:`shard_tree` (the padded global view); given a
    mesh across processes it gathers every rank's shards (collective:
    every process calls it)."""
    return dataclasses.replace(tree, **{
        k: unshard_field(v, mesh) for k, v in _tensors(tree).items()
        if v.ndim >= 4})
