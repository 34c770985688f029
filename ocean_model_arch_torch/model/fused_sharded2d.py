"""The fused step over a px x py mesh of margined shards (counterpart of
``ocean_model_arch_tpu/model/fused_sharded2d.py::FusedSharded2DModel``).

The basin is cut into px x py shards. Every shard carries its 6 + 2 T
fields as one ``(6 + 2 T, Xs, Ysp)`` float32 tensor: the shard's valid
box ``[M, M + lx) x [M, M + ly)`` inside a margin of M cells that holds
the neighbouring shards' cells, and pad beyond it up to the extents all
shards share (``Xs = max lx + 2 M``, ``Ysp`` the same for y, rounded up
to whole 128-byte rows). M is the reach of the steps one launch runs
(``fused_layout.margin_for``): 4 for one step a launch; for two chained
steps (``steps_per_call = 2``, as in the JAX package) 6, or 8 with
tracers. Each turn of the runner's loop refreshes the margins once and
then runs the raw form of the fused kernel
(``ops/fused_step.py::fused_sw_step_raw``) once per shard, which
advances ``steps_per_call`` model steps: chaining halves the exchanges
and the launches a model step, and widens the strips.

One process may run all shards, each its own set of tensors on the
grid's device; or the shards belong to N processes
(``parallel/multihost.py``), each holding its own on its own device (a
card, or the CPU when asked for) and building only their statics. The
margin exchange is ``Tensor.copy_`` of strips between the shards of one
process and a point-to-point strip between shards of two (the JAX
package exchanges outside its kernel too, with ``ppermute``): x strips
first, as one ``batch_isend_irecv`` that ends before the y strips are
posted over all rows including the fresh x strips, so a corner arrives
through the orthogonal neighbour. A shard at the edge of a closed axis
keeps the land zeros it was packed with; a periodic axis adds the pair
across the seam, and with one shard along it the shard's own far edge.
An axis that is closed and unsharded needs no margin work at all.

The kernel cannot run in place (a block's halo is another block's
output), so a runner keeps two buffers per shard and the exchange writes
into the one the next launch reads. Only a shard's box is ever written
by the kernel and only its margin by the exchange: the pad stays at the
zeros of ``pack``, with no re-grounding between steps.

Statics are cut per shard from the margined *global* arrays, so seams
are exact: the land mask and the bathymetry wrap-padded on a periodic
axis and land-padded on a closed one, the static planes built on those
(a shifted mask at a seam sees the cell across it), metric rows extended
by their edge values (by the values across the seam on a periodic axis,
where row 17's ``dxt(n + 1)`` wraps too). Beyond a shard's valid box and
margin the mask-like planes are land and the metric rows copies of their
edge, so the pad holds no infinite reciprocal and nothing wet. The guard
flags use the kernel's own tile; a tile without a wet cell of the
shard's own box (pad tiles too) is skipped.

Cut lines: uniform (``ceil(n / p)`` cells a shard, the last one shorter),
weighted by wet points (``parallel/decomposition.py``), or given
(``x_edges``, ``y_edges``). The port's rule for them is its own: they
span ``[0, nx]`` and ``[0, ny]`` exactly, which on a periodic axis puts
the seam neighbours side by side, and every shard is at least M cells
wide. The TPU package instead needs tile multiples (``nx`` divisible by
``px * tx`` on a periodic axis), a Mosaic constraint.

Every process runs the same turns in lockstep: each launches the kernel
on its own shards, and the window's guard flag ("not finite, or over the
bound", so a NaN on any rank trips every rank) is reduced over the
processes at the end of a window.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.grid import Grid
from ..core.state import SWState
from ..host import ModelConfig
from ..ops import fused_layout as fl
from ..ops import sw_kernels as swk
from ..ops.fused_step import fused_sw_step_raw, kernel_planes, tile_shape
from ..parallel import multihost
from ..parallel.decomposition import weighted_x_edges, weighted_y_edges
from .fused import (CARRIED, flat_bathymetry, fold_flags, general_inputs,
                    mask_carriers, quarter, state_from_fields, unsupported)


def _cuts(n: int, parts: int, given, weighted: bool, int_mask, margin: int,
          powers, axis: str) -> np.ndarray:
    """The ``parts + 1`` cut lines of one axis, spanning [0, n]."""
    if given is not None:
        edges = np.asarray(given, np.int64)
        if len(edges) != parts + 1:
            raise ValueError(f"{axis}_edges has {len(edges)} entries for a "
                             f"p{axis}={parts} mesh (need p{axis}+1)")
    elif weighted and parts > 1:
        cut = weighted_x_edges if axis == "x" else weighted_y_edges
        edges = np.asarray(cut(int_mask, parts, min_width=margin,
                               compute_powers=powers), np.int64)
    else:
        edges = np.minimum(np.arange(parts + 1, dtype=np.int64)
                           * -(-n // parts), n)
    if int(edges[0]) != 0 or int(edges[-1]) != n:
        raise ValueError(f"the {axis} cuts must span [0, {n}] exactly (on a "
                         "periodic axis the seam neighbours lie side by "
                         f"side), got {edges.tolist()}")
    return edges


class FusedSharded2DModel:
    """The fused model on a px x py mesh of shards. ``devices``: one a
    shard, row-major over (x, y): a torch device (a shard of this
    process, which must be the grid's device) or a
    ``multihost.RankDevice`` (a shard of that rank: of this process when
    the rank is its own, then on the grid's device); None puts every shard
    on the grid's device, in this process (``parallel/mesh.py::Mesh.
    shard_devices`` gives a mesh's list). A carry (``pack``) holds a
    tensor for each shard of this process and None for the others.
    ``mu_const``, ``static_rslu``, ``fast2d``, ``tile_guard`` as in
    ``FusedSWModel``, but ``static_rslu`` is on by default, as in the JAX
    model, whose ``fast2d=True`` also needs metric planes (the guard is on
    by default: pad tiles are always dry). ``steps_per_call``: model
    steps per turn of the runner's loop, which makes one exchange and one
    launch per shard: 1, or 2 chained in the launch on a margin wide
    enough for both; windows must be multiples of it. ``weighted``: cut lines
    by wet points, with ``compute_powers_x / _y`` as the bands' relative
    shares; ``x_edges`` / ``y_edges``: the cut lines themselves.
    ``elide_sel``, ``q4``, ``share_prev``: the fast form's folds, as in
    ``FusedSWModel`` and the JAX model (None: on wherever the fast form
    runs, ``share_prev`` at two steps a launch); ``pack`` masks the
    carried velocities and tracer levels with the wet masks of their
    points, which on a periodic axis see the cell across the seam."""

    def __init__(self, grid: Grid, cfg: ModelConfig, tau: float,
                 px: int, py: int, devices=None, mu_const: float = 0.0,
                 static_rslu: bool = True, steps_per_call: int = 1,
                 weighted: bool = False, tile_guard: bool = True,
                 compute_powers_x=None, compute_powers_y=None,
                 x_edges=None, y_edges=None, fast2d: bool | None = None,
                 elide_sel: bool | None = None, q4: bool | None = None,
                 share_prev: bool | None = None):
        mu_const = float(mu_const or 0.0)
        bad = unsupported(grid, cfg, mu_const, sharded=True)
        if bad:
            raise ValueError("fused path unsupported: " + "; ".join(bad))
        if steps_per_call not in (1, 2):
            raise ValueError(f"steps_per_call={steps_per_call}: the kernel "
                             "runs 1 or 2 steps a launch")
        dev = grid.lu.device
        if devices is None:
            devices = [dev] * (px * py)
        if len(devices) != px * py:
            raise ValueError(f"{len(devices)} devices for a {px} x {py} mesh")
        rank = multihost.process_index()
        self.owners = [d.rank if isinstance(d, multihost.RankDevice)
                       else rank for d in devices]
        devices = [torch.device(d.device if isinstance(
            d, multihost.RankDevice) else d) for d in devices]
        self.local = [r == rank for r in self.owners]
        if any(loc and d != dev for loc, d in zip(self.local, devices)):
            raise NotImplementedError(
                "one device a process: this process's shards lie on the "
                f"grid's device ({dev}), not on the devices "
                f"{sorted({str(d) for d in devices})}; the shards of "
                "another device belong to another process "
                "(multihost.RankDevice)")
        world = multihost.process_count()
        if not all(self.local) and (
                sorted(set(self.owners)) != list(range(world))
                or len({self.owners.count(r) for r in range(world)}) != 1):
            raise ValueError(
                f"shard owners {self.owners}: every rank of the process "
                f"group ({world}) must hold as many shards as the others")
        self.grid, self.cfg = grid, cfg
        self.tau = float(tau)
        self.px, self.py = px, py
        self.devices = devices
        self.mu_const = mu_const
        self.static_rslu = bool(static_rslu)
        self.steps_per_call = int(steps_per_call)
        self.n_tracers = (cfg.sw.tracer_num if cfg.sw.use_tracers > 0
                          else 0)
        self.visc = bool(cfg.sw.ksw_lat and mu_const != 0.0)
        self.trans = int(cfg.sw.trans_terms > 0)
        self.ffs = int(cfg.sw.full_free_surface > 0)
        self.periodic_x = bool(grid.periodic_x)
        self.periodic_y = bool(grid.periodic_y)
        M = self.M = fl.margin_for(self.steps_per_call, self.n_tracers)
        nx, ny = grid.nx, grid.ny

        # ---- cut lines ---------------------------------------------------
        lu = grid.lu.cpu().numpy()
        int_mask = (lu < 0.5).astype(np.int32)
        self.x_edges = _cuts(nx, px, x_edges, weighted, int_mask, M,
                             compute_powers_x, "x")
        self.y_edges = _cuts(ny, py, y_edges, weighted, int_mask, M,
                             compute_powers_y, "y")
        self.lx = [int(v) for v in np.diff(self.x_edges)]
        self.ly = [int(v) for v in np.diff(self.y_edges)]
        if min(self.lx) < M or min(self.ly) < M:
            raise ValueError(
                f"shards must be at least {M} cells wide for the margin "
                f"exchange (got {min(self.lx)}x{min(self.ly)}); use a "
                "smaller mesh")
        self.Xpad, self.Ymax = max(self.lx), max(self.ly)
        Xs = self.Xpad + 2 * M
        Ysp = -(-(self.Ymax + 2 * M) // fl.ROW_ALIGN) * fl.ROW_ALIGN
        self.lay = fl.FusedLayout(nx, ny, Xs, Ysp, M)
        # what the kernel is given: the shard's own box in the shared extents
        self.shard_lay = [[fl.FusedLayout(self.lx[i], self.ly[j], Xs, Ysp, M)
                           for j in range(py)] for i in range(px)]

        # ---- margined global statics -> per-shard blocks -----------------
        glay = fl.FusedLayout(nx, ny, nx + 2 * M, ny + 2 * M, M)

        def pad2(g):
            """(nx, ny) -> (nx + 2 M, ny + 2 M): wrapped on a periodic
            axis, land zeros on a closed one."""
            g = np.pad(np.asarray(g, np.float32), ((M, M), (0, 0)),
                       mode="wrap" if self.periodic_x else "constant")
            return np.pad(g, ((0, 0), (M, M)),
                          mode="wrap" if self.periodic_y else "constant")

        def cut(gp, i, j, mode):
            """Shard (i, j)'s valid box and margin of a margined global
            (..., nx + 2 M, ny + 2 M) array, in the shards' (..., Xs,
            Ysp) extents: zeros (land) beyond it, or copies of its edge."""
            w, h = self.lx[i] + 2 * M, self.ly[j] + 2 * M
            x0, y0 = int(self.x_edges[i]), int(self.y_edges[j])
            box = gp[..., x0:x0 + w, y0:y0 + h]
            pad = [(0, 0)] * (gp.ndim - 2) + [(0, Xs - w), (0, Ysp - h)]
            return np.ascontiguousarray(np.pad(box, pad, mode=mode))

        self.hr_const = flat_bathymetry(grid)
        lu_gp = pad2(lu)
        hr_gp = pad2(grid.hhq_rest.cpu().numpy())
        try:
            gprof = fl.metrics_profile_from_grid(grid, glay, self.periodic_y)
            self.metrics_2d = False
        except ValueError:
            gprof = None
            self.metrics_2d = True
        self.fast2d = (self.static_rslu and self.metrics_2d if fast2d is None
                       else bool(fast2d))
        if self.fast2d and not (self.static_rslu and self.metrics_2d):
            raise ValueError("fast2d requires static_rslu and 2D metrics")
        self.general = not (self.static_rslu
                            and (not self.metrics_2d or self.fast2d))
        self.folds = fold_flags(not self.general, not self.general,
                                self.steps_per_call, elide_sel, q4,
                                share_prev, "elide_sel/q4/share_prev "
                                "require fast mode")
        self.elide_sel, self.q4, self.share_prev = self.folds
        # elide_sel: the wet masks of the u, v and T points on the
        # physical grid, from the margined mask (across a periodic seam)
        self._wet = (tuple(torch.from_numpy(np.ascontiguousarray(
            m[M:M + nx, M:M + ny])) for m in fl.staggered_wet_masks(lu_gp))
            if self.elide_sel else None)
        if self.general:
            met_g = (fl.metrics_full_from_grid(
                grid, glay, self.periodic_x, self.periodic_y, derived=False)
                if self.metrics_2d else None)
            planes_g, self.met_map = general_inputs(
                lu_gp, hr_gp, self.metrics_2d, self.static_rslu)
        else:
            names = kernel_planes(self.n_tracers, self.visc,
                                  self.hr_const is None)
            if self.metrics_2d:
                met22 = fl.metrics_full_from_grid(grid, glay, self.periodic_x,
                                                  self.periodic_y)
                rows = fl.fast2d_met_rows(self.n_tracers, self.visc,
                                          self.trans)
                self.met_map = {r: k for k, r in enumerate(rows)}
                dxdy = met22[0] * met22[1]
                recips = quarter((met22[10], met22[11],
                                  met22[14] * met22[15]), self.q4)
                met_g = met22[list(rows)]
            else:
                self.met_map = None
                dxdy = (gprof[0] * gprof[1])[None, :]
                recips = quarter((gprof[10:11], gprof[11:12],
                                  (gprof[14] * gprof[15])[None]), self.q4)
            planes_g = fl.static_planes(lu_gp, hr_gp, dxdy, names,
                                        interp_recips=recips)
        def mine(i, j):
            return self.local[i * py + j]

        if self.metrics_2d:
            self.met_shards = [[torch.from_numpy(cut(met_g, i, j, "edge"))
                                .to(dev) if mine(i, j) else None
                                for j in range(py)] for i in range(px)]
        else:
            # one profile per y band, shared by the shards of the band
            mets = []
            for j in range(py):
                y0, h = int(self.y_edges[j]), self.ly[j] + 2 * M
                mets.append(torch.from_numpy(np.ascontiguousarray(np.pad(
                    gprof[:, y0:y0 + h], ((0, 0), (0, Ysp - h)),
                    mode="edge"))).to(dev))
            self.met_shards = [[mets[j] if mine(i, j) else None
                                for j in range(py)] for i in range(px)]
        self.lu_shards = [[cut(lu_gp, i, j, "constant") if mine(i, j)
                           else None for j in range(py)] for i in range(px)]
        self.hr_shards = [[cut(hr_gp, i, j, "constant") if mine(i, j)
                           else None for j in range(py)] for i in range(px)]
        self.plane_shards = [[torch.from_numpy(cut(planes_g, i, j,
                                                   "constant")).to(dev)
                              if mine(i, j) else None
                              for j in range(py)] for i in range(px)]

        # ---- the guard's flags: wet cells of the shard's own box ---------
        # (the kernel's tile: the chained form's for two steps a launch);
        # a chained launch's first step still computes a dry-flagged
        # tile's margin cells in its wet neighbour's window
        self.tile = tile_shape(dev, self.steps_per_call)
        self.tile_guard = bool(tile_guard)
        self.tile_wet = [[None] * py for _ in range(px)]
        wet_tiles = all_tiles = 0
        for i in range(px):
            for j in range(py):
                own = np.zeros((Xs, Ysp), np.float32)
                own[M:M + self.lx[i], M:M + self.ly[j]] = \
                    lu[self.x_edges[i]:self.x_edges[i + 1],
                       self.y_edges[j]:self.y_edges[j + 1]]
                wet = fl.tile_wet(own, self.lay, *self.tile)
                wet_tiles += int(wet.sum())
                all_tiles += wet.size
                if self.tile_guard:
                    self.tile_wet[i][j] = torch.from_numpy(wet).to(dev)
        self.n_tiles = (wet_tiles, all_tiles - wet_tiles)
        self._plan = self._exchange_plan()
        self._n_x = sum(1 for e in self._plan if e[4] == "x")
        self._strips = multihost.Strips()
        # strips (and their bytes) copied within this process, sent to
        # and received from other processes
        self.strip_copies = self.bytes_copied = 0
        self.strips_sent = self.bytes_sent = 0
        self.strips_received = 0

    # ------------------------------------------------------------------
    def _exchange_plan(self):
        """The strips of one margin exchange, x pass then y pass:
        ``(receiving shard, its index, sending shard, its index, pass)``,
        the indices over a shard's (fields, rows, columns)."""
        M, px, py = self.M, self.px, self.py

        def neighbours(k, n, periodic):
            low = k - 1 if k > 0 else (n - 1 if periodic else None)
            high = k + 1 if k < n - 1 else (0 if periodic else None)
            return low, high

        every = slice(None)
        x_pass, y_pass = [], []
        for i in range(px):
            for j in range(py):
                k, lx, ly = i * py + j, self.lx[i], self.ly[j]
                cols = slice(0, ly + 2 * M)
                low, high = neighbours(i, px, self.periodic_x)
                if low is not None:       # its last M valid rows
                    x_pass.append((k, (every, slice(0, M), cols),
                                   low * py + j,
                                   (every, slice(self.lx[low],
                                                 self.lx[low] + M), cols),
                                   "x"))
                if high is not None:      # its first M valid rows
                    x_pass.append((k, (every, slice(M + lx, 2 * M + lx),
                                       cols), high * py + j,
                                   (every, slice(M, 2 * M), cols), "x"))
                rows = slice(0, lx + 2 * M)   # the fresh x strips too
                low, high = neighbours(j, py, self.periodic_y)
                if low is not None:
                    y_pass.append((k, (every, rows, slice(0, M)),
                                   i * py + low,
                                   (every, rows, slice(self.ly[low],
                                                       self.ly[low] + M)),
                                   "y"))
                if high is not None:
                    y_pass.append((k, (every, rows,
                                       slice(M + ly, 2 * M + ly)),
                                   i * py + high,
                                   (every, rows, slice(M, 2 * M)), "y"))
        return x_pass + y_pass

    def exchange(self, carry) -> None:
        """Refresh the margins of this process's shards of ``carry`` in
        place from their neighbours' valid cells: ``copy_`` between two
        shards of this process (counted in ``strip_copies``,
        ``bytes_copied``), a strip sent to or received from another
        (``strips_sent``, ``bytes_sent``, ``strips_received``), each
        pass's strips posted together and waited on before the next
        pass. Every process of the group calls it in the same turn."""
        strips = self._strips
        for part in (self._plan[:self._n_x], self._plan[self._n_x:]):
            for tag, (dst, into, src, what, _) in enumerate(part):
                here, there = self.local[dst], self.local[src]
                if here and there:
                    piece = carry[src][what]
                    carry[dst][into].copy_(piece)
                    self.strip_copies += 1
                    self.bytes_copied += piece.numel() * piece.element_size()
                elif there:
                    self.bytes_sent += strips.send(
                        self.owners[dst], carry[src][what], tag)
                    self.strips_sent += 1
                elif here:
                    strips.recv(self.owners[src], carry[dst][into], tag)
                    self.strips_received += 1
            strips.run()

    # ------------------------------------------------------------------
    def pack(self, state: SWState) -> tuple:
        """SWState (the whole basin) -> one ``(6 + 2 T, Xs, Ysp)`` float32
        tensor per shard of this process, None for the others, row-major
        over the mesh: the 6 SW fields, then ff_0, ffp_0, ..., each
        shard's own cells at offset (M, M), margins and pad zero (the
        first exchange fills the margins). A state whose mu is not
        ``mu_const`` everywhere is refused. With ``elide_sel`` the
        velocities and tracer levels are masked (see the class)."""
        if not bool((state.mu == self.mu_const).all()):
            raise ValueError("fused path requires state.mu == mu_const "
                             f"({self.mu_const}) everywhere")
        fields = [getattr(state, n) for n in CARRIED]
        for t in range(self.n_tracers):
            fields += [state.ff[t], state.ffp[t]]
        fields = [f.to(torch.float32) for f in fields]
        if self._wet is not None:
            fields = mask_carriers(fields, self._wet)
        whole = torch.stack(fields)
        M, carry = self.M, []
        for i in range(self.px):
            for j in range(self.py):
                if not self.local[i * self.py + j]:
                    carry.append(None)
                    continue
                c = torch.zeros((len(fields), self.lay.Xs, self.lay.Ys),
                                dtype=torch.float32, device=whole.device)
                c[:, M:M + self.lx[i], M:M + self.ly[j]] = \
                    whole[:, self.x_edges[i]:self.x_edges[i + 1],
                          self.y_edges[j]:self.y_edges[j + 1]]
                carry.append(c)
        return tuple(carry)

    def gather(self, carry) -> tuple:
        """Every shard's tensor, on every process: this process's own and
        the others' (collective: every process calls it). One process:
        ``carry`` itself."""
        if all(self.local):
            return tuple(carry)
        mine = [k for k, loc in enumerate(self.local) if loc]
        parts = multihost.all_gather(torch.stack([carry[k] for k in mine]))
        whole = list(carry)
        seen = {}
        for k, r in enumerate(self.owners):
            if not self.local[k]:
                whole[k] = parts[r][seen.get(r, 0)]
            seen[r] = seen.get(r, 0) + 1
        return tuple(whole)

    def extract(self, carry, gather: bool = False) -> tuple:
        """The shards' own cells -> the 6 + 2 T physical (nx, ny) fields:
        every shard's with ``gather`` (collective), else this process's,
        the cells of the others' zero."""
        if gather:
            carry = self.gather(carry)
        M = self.M
        c0 = next(c for c in carry if c is not None)
        out = torch.zeros((c0.shape[0], self.grid.nx, self.grid.ny),
                          dtype=torch.float32, device=c0.device)
        for i in range(self.px):
            for j in range(self.py):
                c = carry[i * self.py + j]
                if c is not None:
                    out[:, self.x_edges[i]:self.x_edges[i + 1],
                        self.y_edges[j]:self.y_edges[j + 1]] = \
                        c[:, M:M + self.lx[i], M:M + self.ly[j]]
        return out.unbind(0)

    def unpack(self, carry, template: SWState,
               gather: bool = False) -> SWState:
        """The carry -> a full SWState in ``template``'s dtype, as
        ``FusedSWModel.unpack`` gives it (``gather`` as in
        :meth:`extract`)."""
        return state_from_fields(self.extract(carry, gather), template,
                                 self.grid, self.cfg, self.n_tracers)

    # ------------------------------------------------------------------
    def make_runner(self, n_inner: int):
        """``runner(carry) -> (carry', ok)``: ``n_inner`` steps in turns of
        ``steps_per_call``, each one margin exchange and one launch per
        shard. The runner owns the
        carry it is given (the exchange writes its margins) and a second
        set of buffers; the carry it returns is one of the two. The
        per-step max |ssh| over all shards accumulates on the device
        (``torch.maximum``, which propagates NaN) and is read once at the
        end of the window; across processes every one of them runs its
        own shards, and the window's flag ("not finite, or over the
        bound") is reduced over them, so a NaN on any rank fails the
        window on every rank."""
        spc = self.steps_per_call
        if n_inner % spc:
            raise ValueError(f"n_inner={n_inner} not a multiple of "
                             f"steps_per_call={spc}")
        sw = self.cfg.sw
        shards = [(k, i, j) for i in range(self.px) for j in range(self.py)
                  if self.local[k := i * self.py + j]]
        tx, ty = self.tile
        n_blocks = (-(-self.lay.Xs // tx), -(-self.lay.Ys // ty))

        def runner(carry):
            cur = list(carry)
            # both buffers' margins and pad start at zero; only the
            # exchange (margins) and the kernel (boxes) write afterwards
            nxt = [None if c is None else torch.zeros_like(c) for c in cur]
            cur_f = [None if c is None else c.unbind(0) for c in cur]
            nxt_f = [None if c is None else c.unbind(0) for c in nxt]
            dev = cur[shards[0][0]].device
            blockmax = torch.zeros((len(shards),) + n_blocks,
                                   dtype=torch.float32, device=dev)
            mx = torch.zeros((), dtype=torch.float32, device=dev)
            for _ in range(n_inner // spc):
                self.exchange(cur)
                for b, (k, i, j) in enumerate(shards):
                    fused_sw_step_raw(
                        cur_f[k], nxt_f[k], blockmax[b],
                        self.met_shards[i][j], self.plane_shards[i][j],
                        self.shard_lay[i][j], self.tau, sw.time_smooth,
                        self.hr_const, self.tile_wet[i][j], self.tile,
                        self.met_map, self.mu_const, self.visc, self.trans,
                        self.ffs, spc, self.general, self.folds)
                mx = torch.maximum(mx, torch.amax(blockmax))
                cur, nxt, cur_f, nxt_f = nxt, cur, nxt_f, cur_f
            # NaN compares False: "not below the bound" trips the guard
            return tuple(cur), not multihost.any_rank(
                ~(mx < swk.SSH_ERR_BOUND))

        return runner
