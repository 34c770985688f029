"""Weighted block decomposition + load-balance diagnostics (the port's own
copy of ``ocean_model_arch_tpu/parallel/decomposition.py``).

On homogeneous TPU meshes XLA owns intra-chip parallelism, so the
reference's block machinery (core/decomposition.f90) survives here as the
*accounting* layer it always implicitly was:

- wet-point block weights from the land mask (bglob_weight,
  decomposition.f90:505-515), land-block elision (rank -1, :578);
- uniform block->device tiling (create_uniform_decomposition, :614-669)
  and Hilbert-curve greedy weighted packing
  (create_hilbert_curve_decomposition, :532-612) with per-device
  compute-power scaling — used to choose shard cut lines and to report
  the balance quality of any mesh split;
- the load-balance ratio max/mean weight printed by the reference
  (decomposition.f90:938-940) and the decomposition.txt dump (:895-909).

The dynamic-load-balance loop (control/preprocess.f90) appears as
:func:`rebalance_powers`: measured per-device throughputs feed back into
the weighted packing exactly like the reference's compute_power pass.
"""

from __future__ import annotations

import dataclasses

import numpy as np


# --------------------------------------------------------------------------
# Hilbert curve (shared/mpp/hilbert_curve.f90) — standard d<->(x,y) walk
# --------------------------------------------------------------------------

def hilbert_d2xy(order: int, d: int) -> tuple[int, int]:
    """Distance along the order-n Hilbert curve -> (x, y); n = 2**order."""
    n = 1 << order
    x = y = 0
    t = d
    s = 1
    while s < n:
        rx = 1 & (t // 2)
        ry = 1 & (t ^ rx)
        # rotate quadrant
        if ry == 0:
            if rx == 1:
                x, y = s - 1 - x, s - 1 - y
            x, y = y, x
        x += s * rx
        y += s * ry
        t //= 4
        s *= 2
    return x, y


def hilbert_xy2d(order: int, x: int, y: int) -> int:
    """(x, y) -> distance along the order-n Hilbert curve."""
    n = 1 << order
    d = 0
    s = n // 2
    while s > 0:
        rx = 1 if (x & s) > 0 else 0
        ry = 1 if (y & s) > 0 else 0
        d += s * s * ((3 * rx) ^ ry)
        if ry == 0:
            if rx == 1:
                x, y = s - 1 - x, s - 1 - y
            x, y = y, x
        s //= 2
    return d


# --------------------------------------------------------------------------
# Block weights
# --------------------------------------------------------------------------

@dataclasses.dataclass
class BlockDecomposition:
    bnx: int
    bny: int
    weights: np.ndarray        # (bnx, bny) wet-point counts
    owner: np.ndarray          # (bnx, bny) device id, -1 for land blocks
    x_edges: np.ndarray        # block boundaries in x (len bnx+1)
    y_edges: np.ndarray

    @property
    def n_land_blocks(self) -> int:
        return int((self.weights == 0).sum())

    def device_weights(self, n_dev: int) -> np.ndarray:
        w = np.zeros(n_dev)
        for b in range(self.bnx * self.bny):
            o = self.owner.flat[b]
            if o >= 0:
                w[o] += self.weights.flat[b]
        return w

    def balance_ratio(self, n_dev: int,
                      compute_powers=None) -> float:
        """max device weight / mean device weight (decomposition.f90:938);
        with compute powers, weights are scaled by 1/power first."""
        w = self.device_weights(n_dev)
        if compute_powers is not None:
            w = w / np.asarray(compute_powers)
        m = w.mean()
        return float(w.max() / m) if m > 0 else float("inf")


def block_weights(int_mask: np.ndarray, bnx: int, bny: int,
                  binary: bool = False) -> BlockDecomposition:
    """Split the significant interior into bnx x bny blocks and count
    wet points per block (block_uniform_decomposition,
    decomposition.f90:427-531). ``binary``: weight 1 for any-wet blocks
    (_DD_BINARY_BLOCK_WEIGHTS_, :508-512)."""
    nx, ny = int_mask.shape
    ix = np.linspace(2, nx - 2, bnx + 1).astype(int)   # interior [2, nx-2)
    iy = np.linspace(2, ny - 2, bny + 1).astype(int)
    wet = (int_mask == 0)
    w = np.zeros((bnx, bny), np.int64)
    for i in range(bnx):
        for j in range(bny):
            w[i, j] = wet[ix[i]:ix[i + 1], iy[j]:iy[j + 1]].sum()
    if binary:
        w = (w > 0).astype(np.int64)
    return BlockDecomposition(bnx, bny, w, -np.ones((bnx, bny), np.int64),
                              ix, iy)


# --------------------------------------------------------------------------
# Assignments
# --------------------------------------------------------------------------

def assign_uniform(dec: BlockDecomposition, pnx: int, pny: int
                   ) -> BlockDecomposition:
    """Tile the block grid uniformly over a pnx x pny device grid
    (create_uniform_decomposition, :614-669). Land blocks keep owner -1."""
    if dec.bnx % pnx or dec.bny % pny:
        raise ValueError("block grid not divisible by device grid")
    fx, fy = dec.bnx // pnx, dec.bny // pny
    owner = -np.ones((dec.bnx, dec.bny), np.int64)
    for i in range(dec.bnx):
        for j in range(dec.bny):
            if dec.weights[i, j] > 0:
                owner[i, j] = (i // fx) * pny + (j // fy)
    return dataclasses.replace(dec, owner=owner)


def assign_hilbert(dec: BlockDecomposition, n_dev: int,
                   compute_powers=None) -> BlockDecomposition:
    """Walk wet blocks in Hilbert order, greedily packing approximately
    equal weight per device scaled by compute power
    (create_hilbert_curve_decomposition, :532-612). Requires
    bnx == bny == 2**k."""
    if dec.bnx != dec.bny or (dec.bnx & (dec.bnx - 1)):
        raise ValueError("hilbert assignment needs bnx == bny == 2**k")
    order = int(np.log2(dec.bnx))
    if compute_powers is None:
        compute_powers = np.ones(n_dev)
    powers = np.asarray(compute_powers, np.float64)
    powers = powers / powers.sum()

    total = float(dec.weights.sum())
    owner = -np.ones((dec.bnx, dec.bny), np.int64)
    dev = 0
    acc = 0.0
    target = total * powers[0]
    for d in range(dec.bnx * dec.bny):
        x, y = hilbert_d2xy(order, d)
        w = float(dec.weights[x, y])
        if w == 0:
            continue
        if acc + w > target * 1.0 + 1e-9 and dev < n_dev - 1 \
                and acc > 0:
            dev += 1
            acc = 0.0
            target = total * powers[dev]
        owner[x, y] = dev
        acc += w
    return dataclasses.replace(dec, owner=owner)


def rebalance_powers(dec: BlockDecomposition, n_dev: int,
                     measured_times: np.ndarray) -> BlockDecomposition:
    """DLB analog (control/preprocess.f90:21-100): measured per-device
    times for the current assignment -> compute powers = weight/time,
    normalized -> re-pack Hilbert-weighted."""
    w = dec.device_weights(n_dev)
    powers = np.where(np.asarray(measured_times) > 0,
                      w / np.asarray(measured_times), 1.0)
    powers = powers / powers.sum()
    return assign_hilbert(dec, n_dev, powers)


# --------------------------------------------------------------------------
# Weighted shard cuts (the applied form of the block weights)
# --------------------------------------------------------------------------

def weighted_x_edges(int_mask: np.ndarray, px: int,
                     min_width: int = 8,
                     compute_powers=None) -> np.ndarray:
    """Non-uniform x cut lines with ~equal WET points per x-band — the
    shard-level application of the reference's weighted block assignment
    (decomposition.f90:614-669): instead of assigning weighted blocks to
    ranks, the SPMD mesh's cut lines themselves follow the wet-point
    cumulative distribution. Bands are at least ``min_width`` rows (the
    margin-exchange minimum). Returns edges of length px+1 with
    edges[0] = 0, edges[-1] = nx.

    ``compute_powers``: optional per-band relative throughputs (the DLB
    loop's measured compute_power, control/preprocess.f90:21-100): band k
    targets a wet share proportional to its power instead of 1/px."""
    nx = int_mask.shape[0]
    wet_per_row = (int_mask == 0).sum(axis=1).astype(np.float64)
    cum = np.concatenate([[0.0], np.cumsum(wet_per_row)])
    total = cum[-1]
    if compute_powers is None:
        targets = np.arange(1, px) / px
    else:
        p = np.asarray(compute_powers, np.float64)
        targets = np.cumsum(p / p.sum())[:-1]
    edges = np.zeros(px + 1, np.int64)
    edges[-1] = nx
    for k in range(1, px):
        edges[k] = int(np.searchsorted(cum, total * targets[k - 1]))
    # enforce monotonicity + minimum band width
    for k in range(1, px + 1):
        edges[k] = max(edges[k], edges[k - 1] + min_width)
    edges[-1] = nx
    for k in range(px, 0, -1):
        edges[k - 1] = min(edges[k - 1], edges[k] - min_width)
    if edges[0] != 0:
        raise ValueError(f"cannot fit {px} bands of >= {min_width} rows "
                         f"into nx={nx}")
    edges[0] = 0
    return edges


def weighted_y_edges(int_mask: np.ndarray, py: int,
                     min_width: int = 8,
                     compute_powers=None) -> np.ndarray:
    """Non-uniform y cut lines with ~equal WET points per y-band —
    symmetric to :func:`weighted_x_edges` (the reference balances its
    block grid in BOTH axes, decomposition.f90:532-612)."""
    return weighted_x_edges(int_mask.T, py, min_width=min_width,
                            compute_powers=compute_powers)


def x_band_balance(int_mask: np.ndarray, edges: np.ndarray,
                   py: int) -> float:
    """max/mean wet points per shard for x-bands ``edges`` x uniform
    y-split (the balance figure the weighted cuts minimize)."""
    ny = int_mask.shape[1]
    iy = np.linspace(0, ny, py + 1).astype(int)
    return xy_balance(int_mask, edges, iy)


def xy_balance(int_mask: np.ndarray, x_edges: np.ndarray,
               y_edges: np.ndarray) -> float:
    """max/mean wet points per shard for the full 2D cut grid
    (decomposition.f90:938's ratio over the mesh cells)."""
    wet = (int_mask == 0)
    w = np.array(
        [[wet[x_edges[i]:x_edges[i + 1],
              y_edges[j]:y_edges[j + 1]].sum()
          for j in range(len(y_edges) - 1)]
         for i in range(len(x_edges) - 1)], np.float64)
    m = w.mean()
    return float(w.max() / m) if m > 0 else float("inf")


def choose_mesh_dims(int_mask: np.ndarray, n_dev: int,
                     min_width: int = 8,
                     weighted_y: bool = True) -> tuple[int, int]:
    """Pick the (px, py) factorization of n_dev minimizing the weighted
    wet-point balance ratio (mpi_dims_create + weights), with weighted
    cuts in BOTH axes. Ties break toward square-ish meshes."""
    nx, ny = int_mask.shape
    best = None
    for px in range(1, n_dev + 1):
        if n_dev % px:
            continue
        py = n_dev // px
        if nx // px < min_width or ny // py < min_width:
            continue
        try:
            xe = weighted_x_edges(int_mask, px, min_width)
            ye = (weighted_y_edges(int_mask, py, min_width)
                  if weighted_y
                  else np.linspace(0, ny, py + 1).astype(np.int64))
        except ValueError:
            continue
        ratio = xy_balance(int_mask, xe, ye)
        key = (ratio, abs(px - py))
        if best is None or key < best[0]:
            best = (key, (px, py))
    if best is None:
        raise ValueError(f"no feasible mesh for {n_dev} devices")
    return best[1]


# --------------------------------------------------------------------------
# Diagnostics
# --------------------------------------------------------------------------

def mesh_split_report(int_mask: np.ndarray, px: int, py: int) -> dict:
    """Wet-point balance of the plain SPMD mesh split used by the sharded
    runners — the 'effective wet-point throughput' accounting of
    SURVEY.md §7."""
    nx, ny = int_mask.shape
    wet = (int_mask == 0)
    ix = np.linspace(0, nx, px + 1).astype(int)
    iy = np.linspace(0, ny, py + 1).astype(int)
    w = np.array([[wet[ix[i]:ix[i + 1], iy[j]:iy[j + 1]].sum()
                   for j in range(py)] for i in range(px)], np.float64)
    mean = w.mean()
    return {
        "device_wet_points": w,
        "balance_ratio": float(w.max() / mean) if mean > 0 else float("inf"),
        "wet_fraction": float(wet.sum()) / (nx * ny),
        "idle_fraction": 1.0 - float(w.sum()) / (w.size * w.max())
        if w.max() > 0 else 0.0,
    }


def dump_decomposition(dec: BlockDecomposition, path: str) -> None:
    """decomposition.txt-style dump (decomposition.f90:895-909): one line
    per block: i j x0 x1 y0 y1 weight owner."""
    with open(path, "w") as f:
        f.write(f"{dec.bnx} {dec.bny}\n")
        for i in range(dec.bnx):
            for j in range(dec.bny):
                f.write(f"{i} {j} {dec.x_edges[i]} {dec.x_edges[i + 1]} "
                        f"{dec.y_edges[j]} {dec.y_edges[j + 1]} "
                        f"{dec.weights[i, j]} {dec.owner[i, j]}\n")


def read_decomposition(path: str, nx: int | None = None,
                       ny: int | None = None) -> BlockDecomposition:
    """Read a decomposition file back — either format:

    - this repo's 8-column dump (:func:`dump_decomposition`: header
      ``bnx bny``, rows ``i j x0 x1 y0 y1 weight owner``, 0-based, with
      explicit block edges), or
    - the reference's own ``decomposition.txt`` (decomposition.f90:
      898-904: header ``bnx bny pnx pny``, rows ``m n proc weight`` with
      1-based block indices and NO edges). For this format the block
      edges are reconstructed from the reference's uniform split of the
      significant interior (block_uniform_decomposition: iterated
      ``floor(remaining/blocks_left)`` over ``nx-4`` points starting at
      the 2-cell frame — NOT a linspace split: the iteration puts the
      larger blocks last, e.g. 10 points over 4 blocks = 2,2,3,3), so
      ``nx``/``ny`` must be passed.

    Unrecognized row shapes raise instead of being skipped — a silently
    half-parsed file would surface later as a misleading shard error.
    """
    with open(path) as f:
        header = f.readline().split()
        bnx, bny = int(header[0]), int(header[1])
        ref_format = len(header) >= 4
        xe = np.zeros(bnx + 1, np.int64)
        ye = np.zeros(bny + 1, np.int64)
        # float64: the reference's weights are compute-power-scaled
        # real8 (recompute_weights_by_compute_powers) — truncating to
        # int would collapse fractional weights to 0
        w = np.zeros((bnx, bny), np.float64)
        owner = -np.ones((bnx, bny), np.int64)
        if ref_format:
            if nx is None or ny is None:
                raise ValueError(
                    f"{path} is a reference-format decomposition.txt "
                    "(header 'bnx bny pnx pny', rows 'm n proc weight' "
                    "carry no block edges); pass nx/ny so the uniform "
                    "block edges can be reconstructed")

            def ref_edges(n_sig: int, nb: int) -> np.ndarray:
                # the reference's exact iteration
                # (block_uniform_decomposition): size_m =
                # floor(remaining / blocks_left)
                e = np.zeros(nb + 1, np.int64)
                total = 0
                for m in range(nb):
                    size = (n_sig - total) // (nb - m)
                    if size <= 0:
                        raise ValueError(
                            f"{path}: block grid {nb} too fine for "
                            f"{n_sig} interior points")
                    total += size
                    e[m + 1] = total
                return e + 2          # interior starts at the 2-cell frame

            xe[:] = ref_edges(nx - 4, bnx)
            ye[:] = ref_edges(ny - 4, bny)
        for lineno, line in enumerate(f, start=2):
            parts = line.split()
            if not parts:
                continue
            if ref_format:
                if len(parts) != 4:
                    raise ValueError(
                        f"{path}:{lineno}: expected 4 columns "
                        f"'m n proc weight', got {len(parts)}")
                i, j = int(parts[0]) - 1, int(parts[1]) - 1
                if not (0 <= i < bnx and 0 <= j < bny):
                    raise ValueError(
                        f"{path}:{lineno}: block index ({parts[0]}, "
                        f"{parts[1]}) outside the 1-based "
                        f"{bnx}x{bny} grid")
                owner[i, j] = int(parts[2])
                w[i, j] = float(parts[3])
            else:
                if len(parts) != 8:
                    raise ValueError(
                        f"{path}:{lineno}: expected 8 columns "
                        f"'i j x0 x1 y0 y1 weight owner', got "
                        f"{len(parts)}")
                i, j, x0, x1, y0, y1 = map(int, parts[:6])
                xe[i], xe[i + 1] = x0, x1
                ye[j], ye[j + 1] = y0, y1
                w[i, j] = float(parts[6])
                owner[i, j] = int(parts[7])
    return BlockDecomposition(bnx, bny, w, owner, xe, ye)


def cuts_from_decomposition(dec: BlockDecomposition, px: int, py: int
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Shard cut lines (x_edges, y_edges) from a block decomposition,
    when its owner grid is a regular px x py rectangle tiling (each
    device owns a contiguous block sub-grid — the only layout an SPMD
    mesh of rectangular shards can realize). Raises ValueError for
    irregular (e.g. Hilbert-packed) assignments."""
    if dec.bnx % px or dec.bny % py:
        raise ValueError(
            f"decomposition block grid {dec.bnx}x{dec.bny} not divisible "
            f"by the device mesh {px}x{py}")
    fx, fy = dec.bnx // px, dec.bny // py
    expect = (np.arange(dec.bnx)[:, None] // fx) * py \
        + (np.arange(dec.bny)[None, :] // fy)
    mism = (dec.owner >= 0) & (dec.owner != expect)
    if mism.any():
        raise ValueError(
            "decomposition file does not describe a regular grid split "
            f"({int(mism.sum())} blocks owned off-grid); TPU SPMD shards "
            "are contiguous rectangles — re-dump with a uniform "
            "assignment or use mod_decomposition=0/1")
    return dec.x_edges[::fx].copy(), dec.y_edges[::fy].copy()
