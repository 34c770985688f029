"""Halo exchange between the shards of a mesh (counterpart of
``ocean_model_arch_tpu/parallel/halo.py``).

The JAX package replaces the reference's hand-packed MPI halo sync
(shared/mpp/sync.f90 + syncborder_block2D_gen_all.fi) by two passes of
``lax.ppermute`` edge-strip shifts inside ``jax.shard_map``, x then y.
The port holds the shards stacked on one device (parallel/mesh.py:
``(..., px, py, lx, ly)``), so a pass is ``ppermute``'s semantics as
tensor ops: each shard's last and first ``h`` rows, shifted one shard
along the shard axis (zeros where no shard sends: a closed edge; the
wrap on a periodic axis), concatenated onto the field. The second pass
runs on the x-padded tensor, so corner halos come from the diagonal
neighbour exactly like the reference's explicit corner strips (dirs 5-8,
_gen_all.fi:49-52).

Across processes (parallel/mesh.py: each rank a block of the shards) a
pass keeps its ``narrow`` + ``cat`` between the shards of a block and
sends the block's edge strips to the neighbouring ranks, as the
``ppermute`` pair of ``ocean_model_arch_tpu/parallel/halo.py:28-53``
does: both strips of a pass go out as one ``batch_isend_irecv``
(parallel/multihost.py), zeros arrive at a closed edge, the wrap on a
periodic one, and the x pass ends before the y pass begins.

``ShardHalo`` is the halo provider of model/step.py's composition on the
stacked layout (the interface of ``GlobalHalo``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.stencil import HALO
from . import multihost


def _exchange_axis(f: torch.Tensor, axis: int, n: int, periodic: bool,
                   h: int = HALO, ranks=None, strips=None) -> torch.Tensor:
    """Pad ``f`` along its spatial ``axis`` (-2: x, -1: y; negative, so
    nlev stacks work) with h cells from the neighbouring shards along the
    shard axis two places before it (n shards there). ``ranks``: the
    ranks (low, high) beside this process's block along the axis when
    the axis spans processes (None past a closed edge), whose strips
    travel through ``strips`` (a ``multihost.Strips``); None when this
    process holds the whole axis."""
    axis = axis % f.ndim
    sa = axis - 2
    size = f.shape[axis]
    last = f.narrow(axis, size - h, h)
    first = f.narrow(axis, 0, h)
    if ranks is not None:
        # the block's edge strips to and from the neighbouring ranks (the
        # strip sent up is tagged 0, the one sent down 1)
        lo, hi = ranks
        from_lo = torch.zeros_like(last.narrow(sa, 0, 1))
        from_hi = torch.zeros_like(from_lo)
        if hi is not None:
            strips.send(hi, last.narrow(sa, n - 1, 1), 0)
        if lo is not None:
            strips.send(lo, first.narrow(sa, 0, 1), 1)
        if lo is not None:
            strips.recv(lo, from_lo, 0)
        if hi is not None:
            strips.recv(hi, from_hi, 1)
        strips.run()
        low = torch.cat([from_lo, last.narrow(sa, 0, n - 1)], dim=sa)
        high = torch.cat([first.narrow(sa, 1, n - 1), from_hi], dim=sa)
    elif periodic:
        # shard i's low halo = shard (i - 1) % n's last strip, its high
        # halo = shard (i + 1) % n's first strip (n == 1: its own wrap)
        low = torch.cat([last.narrow(sa, n - 1, 1),
                         last.narrow(sa, 0, n - 1)], dim=sa)
        high = torch.cat([first.narrow(sa, 1, n - 1),
                          first.narrow(sa, 0, 1)], dim=sa)
    else:
        zero = torch.zeros_like(last.narrow(sa, 0, 1))
        low = torch.cat([zero, last.narrow(sa, 0, n - 1)], dim=sa)
        high = torch.cat([first.narrow(sa, 1, n - 1), zero], dim=sa)
    return torch.cat([low, f, high], dim=axis)


class ShardHalo:
    """Halo provider for the eager composition on stacked shards.

    ``ex``: two-pass neighbour exchange (valid halos incl. corners).
    ``zp``: local zero-pad (for pointwise-read args -- no exchange).
    ``exchanges`` counts the two-pass exchanges made (a batch is one).
    """

    def __init__(self, px: int, py: int,
                 periodic_x: bool = False, periodic_y: bool = False,
                 h: int = HALO, mesh=None):
        # across processes: this rank's block, and the neighbouring ranks
        # along each axis the ranks split
        self._ranks = (None, None)
        self._strips = multihost.Strips()
        if mesh is not None and mesh.world > 1:
            px, py = mesh.block
            self._ranks = tuple(
                (mesh.neighbour(a, -1, per), mesh.neighbour(a, 1, per))
                if n > 1 else None
                for a, n, per in ((0, mesh.rx, periodic_x),
                                  (1, mesh.ry, periodic_y)))
        self.px = px
        self.py = py
        self.periodic_x = periodic_x
        self.periodic_y = periodic_y
        self.h = h
        self.exchanges = 0
        # identity-keyed exchange memo: ex() is a pure function of the
        # tensor's value, so two calls on the SAME object within one step
        # are identical -- memoizing dedupes repeated per-step exchanges
        # (the composer calls ex(s.ubrtr) etc. several times per step)
        # the way the reference's sync lists exchange each field once
        # (sw_interface.f90:330-381). Entries hold the key object, so a
        # recycled id can never false-hit (identity check below).
        self._memo = {}
        self._statics = {}

    def cache_statics(self, tree, spatial_shape) -> None:
        """Pre-exchange every tensor field of ``tree`` whose trailing dims
        are ``spatial_shape`` (the shards' (lx, ly)) and memoize it. Call
        OUTSIDE the time loop: later ``ex(f)`` calls on the same objects
        return the precomputed padded tensors, hoisting all static-field
        exchanges out of the steps. Also resets the memo."""
        self._memo = {}
        spatial = tuple(spatial_shape)
        for f in dataclasses.fields(tree):
            leaf = getattr(tree, f.name)
            if (isinstance(leaf, torch.Tensor) and leaf.ndim >= 4
                    and tuple(leaf.shape[-2:]) == spatial):
                self._memo[id(leaf)] = (leaf, self._ex(leaf))
        self._statics = dict(self._memo)

    def end_step(self) -> None:
        """Forget the memo entries of the step just taken (they hold its
        tensors); the static ones of :meth:`cache_statics` stay."""
        self._memo = dict(self._statics)

    def ex(self, f):
        hit = self._memo.get(id(f))
        if hit is not None and hit[0] is f:
            return hit[1]
        out = self._ex(f)
        self._memo[id(f)] = (f, out)
        return out

    def ex_batch(self, fields) -> None:
        """Exchange several same-shape fields in ONE stacked exchange
        instead of one per field -- the batched form of the reference's
        per-kernel sync LISTS (sw_interface.f90:330-381). Results are
        memoized, so subsequent ``ex(f)`` calls on the same objects are
        free; unmemoized singles stay correct either way. One stack per
        dtype: a mixed stack would promote the f32 ``r_diss`` of an f64
        run, whose stencil sums then round unlike the single block's."""
        groups = {}
        for f in fields:
            if not (self._memo.get(id(f)) and self._memo[id(f)][0] is f):
                groups.setdefault((f.dtype, f.shape), []).append(f)
        for group in groups.values():
            if len(group) == 1:
                self.ex(group[0])
                continue
            out = self._ex(torch.stack(group))
            for i, f in enumerate(group):
                self._memo[id(f)] = (f, out[i])

    def _ex(self, f):
        self.exchanges += 1
        rx, ry = self._ranks
        f = (_exchange_axis(f, -2, self.px, self.periodic_x, self.h)
             if rx is None else
             _exchange_axis(f, -2, self.px, self.periodic_x, self.h, rx,
                            self._strips))
        return (_exchange_axis(f, -1, self.py, self.periodic_y, self.h)
                if ry is None else
                _exchange_axis(f, -1, self.py, self.periodic_y, self.h, ry,
                               self._strips))

    def zp(self, f):
        h = self.h
        return F.pad(f, (h, h, h, h))


def halo_self_test(mesh, nx: int, ny: int,
                   periodic_x: bool = False, periodic_y: bool = False,
                   h: int = HALO) -> None:
    """Run-time halo-exchange verification -- the reference's sync_test
    (shared/mpp/syncborder_block2D_gen_test.fi): fill the global field
    with the analytic f(i, j) = i*j (1-based), exchange on ``mesh``'s
    device, and assert every cell of every shard's padded block equals the
    analytic value (zero / wrapped outside the domain). Raises
    AssertionError naming the shard and the cell on a mismatch.

    Call it at startup with the production mesh, like the reference's
    commented-in `call sync_test(domain, ocean_data%ssh)`
    (init_data.f90:41-44). On a mesh across processes every process
    exchanges its block and the blocks are gathered before the check, as
    the JAX package's process_allgather does (collective).
    """
    from .mesh import gather_field, shard_field

    px, py = mesh.px, mesh.py
    if nx % px or ny % py:
        raise ValueError("extents must divide the mesh for the self-test")
    i = np.arange(1, nx + 1)[:, None].astype(np.float64)
    j = np.arange(1, ny + 1)[None, :].astype(np.float64)
    f = shard_field(torch.from_numpy(i * j), mesh)

    hp = ShardHalo(px, py, periodic_x, periodic_y, h=h, mesh=mesh)
    # (px, py, lx + 2h, ly + 2h)
    blocks = gather_field(hp.ex(f), mesh).cpu().numpy()
    lx, ly = nx // px, ny // py
    gi = np.arange(-h, lx + h)
    gj = np.arange(-h, ly + h)
    for bi in range(px):
        for bj in range(py):
            gm = bi * lx + gi
            gn = bj * ly + gj
            if periodic_x:
                gm = gm % nx
            if periodic_y:
                gn = gn % ny
            want = np.where(
                (gm[:, None] >= 0) & (gm[:, None] < nx)
                & (gn[None, :] >= 0) & (gn[None, :] < ny),
                (gm[:, None] + 1.0) * (gn[None, :] + 1.0), 0.0)
            got = blocks[bi, bj]
            if not np.array_equal(got, want):
                bad = tuple(int(v) for v in np.argwhere(got != want)[0])
                raise AssertionError(
                    f"halo self-test failed at shard ({bi},{bj}) "
                    f"cell {bad}: got {got[bad]}, want {want[bad]}")
