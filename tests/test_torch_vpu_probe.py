"""The op-cost probes K6 and K7 (``ocean_model_arch_torch/ops/vpu_probe.py``)
on the CPU, where ``vpu_probe`` runs its plain PyTorch version: against
``scripts/vpu_op_probe.py::make`` and ``scripts/vpu_shift_probe.py::make``
in interpret mode (the scripts loaded as modules, their extents set to a
small case and their ``pl`` given a ``pallas_call`` that interprets;
nothing of the scripts changes), one call and three carried calls; the
layouts, margins, bounds and build targets. The CUDA kernel itself is held
against the plain version on the card by chip_smoke.py."""

import functools
import importlib.util
import os
import types

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ocean_model_arch_torch.ops import vpu_probe as vp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the small case: 3 tiles of 16 rows between margins of 8, 24 columns (23
# for the shift probe, whose YS is not rounded)
NX, TX, M, YS = 40, 16, 8, 24
XS = -(-NX // TX) * TX + 2 * M
K = 16
# interpret mode's XLA on the CPU rounds the chain otherwise (up to 1.4e-6
# absolute at K = 16; the rolls 1.2e-7): relative to the largest value
TOL = 1e-5


def _interpreting_pl():
    """``pl`` with a ``pallas_call`` that passes ``interpret=True``."""
    ns = types.SimpleNamespace(**{n: getattr(pl, n) for n in dir(pl)
                                  if not n.startswith("__")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    return ns


@functools.lru_cache(maxsize=None)
def _script(name, ys):
    """scripts/<name>.py as a module, at the small case's extents."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = _interpreting_pl()
    mod.NX, mod.TX, mod.M, mod.XS, mod.YS = NX, TX, M, XS, ys
    return mod


def _input(ys, seed=11):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 1.5, (XS, ys)).astype(np.float32)


def _jax(name, kind, ys, x, n):
    """``n`` carried calls of the script's kernel, the margin rows set back
    to ``x``'s between calls (what the port defines them to be)."""
    f = _script(name, ys).make(kind, K)
    y = x
    for _ in range(n):
        y = np.array(f(jax.numpy.asarray(y), 1))
        y[:M], y[-M:] = x[:M], x[-M:]
    return y


def _rel_interior(got, want):
    a, b = got[M:-M], want[M:-M]
    finite = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), finite)
    assert np.array_equal(a[~finite], b[~finite])
    scale = max(np.abs(b[finite]).max(), 1e-30)
    return np.abs(a[finite] - b[finite]).max() / scale


@pytest.mark.parametrize("n", [1, 3], ids=["one_call", "three_carried"])
@pytest.mark.parametrize("kind", vp.KINDS)
def test_op_probe_matches_jax(kind, n):
    """K6: every kind at K = 16 against the TPU kernel in interpret mode,
    one call and three carried calls: interior rows within 1e-5 of the
    largest value, the same non-finite cells (the squaring chains
    overflow), margins the input's."""
    x = _input(YS)
    want = _jax("vpu_op_probe", kind, YS, x, n)
    got = vp.vpu_probe_reference(torch.from_numpy(x), kind, K, n,
                                 tx=TX, m=M).numpy()
    assert _rel_interior(got, want) < TOL
    np.testing.assert_array_equal(got[:M], x[:M])
    np.testing.assert_array_equal(got[-M:], x[-M:])


@pytest.mark.parametrize("n", [1, 3], ids=["one_call", "three_carried"])
@pytest.mark.parametrize("kind", vp.SHIFT_KINDS)
def test_shift_probe_matches_jax(kind, n):
    """K7: its three kinds on an odd column count (YS = NY + 4, not
    rounded) against the TPU kernel in interpret mode."""
    x = _input(YS - 1, seed=12)
    want = _jax("vpu_shift_probe", kind, YS - 1, x, n)
    got = vp.vpu_probe_reference(torch.from_numpy(x), kind, K, n,
                                 tx=TX, m=M).numpy()
    assert _rel_interior(got, want) < TOL


def test_rolls_are_circular_within_the_window():
    """rollx wraps over the window's TX + 2 M rows, rolly over all YS
    columns: on zeros, a one in tile 0's window's last row reaches the
    window's first output row after M + 1 <= K hops (and no other column),
    and a one in the last column reaches the first column."""
    x = np.zeros((XS, YS), np.float32)
    x[TX + 2 * M - 1, 3] = 1.0          # tile 0's window, last row
    got = vp.vpu_probe_reference(torch.from_numpy(x), "rollx", K, tx=TX,
                                 m=M).numpy()
    assert got[M, 3] > 0 and not got[M, 2] and not got[M, 4]
    x = np.zeros((XS, YS), np.float32)
    x[M + 5, YS - 1] = 1.0
    got = vp.vpu_probe_reference(torch.from_numpy(x), "rolly", K, tx=TX,
                                 m=M).numpy()
    assert got[M + 5, 0] > 0 and not got[M + 4, 0]


def test_bmul_reads_each_tiles_own_row_zero():
    """bmul's row is each window's row 0, global row i TX, not row 0: with
    3 in row TX alone, tile 1's outputs (rows M + TX ...) differ from tile
    0's where both read 1."""
    x = np.ones((XS, YS), np.float32)
    x[TX, :] = 3.0                      # tile 1's window row 0
    got = vp.vpu_probe_reference(torch.from_numpy(x), "bmul", K, tx=TX,
                                 m=M).numpy()
    tile1 = got[M + TX:M + 2 * TX]
    assert (tile1 == tile1[0, 0]).all() and tile1[0, 0] != got[M, 0]


def test_cpu_dispatch_and_layout():
    """On a CPU tensor ``vpu_probe`` is the plain version and launches
    nothing; the layouts are the scripts' (K6: 1552 x 1152, K7: 1552 x
    1119, 24 tiles)."""
    vp.reset_launch_counts()
    lay = torch.from_numpy(np.ones((2 * vp.M + 2 * vp.TX, 8), np.float32))
    got = vp.vpu_probe(lay, "div", 4, 2)
    assert torch.equal(got, vp.vpu_probe_reference(lay, "div", 4, 2))
    assert vp.vpu_probe.launches == 0 and not vp.vpu_probe.form_launches
    assert (vp.XS, vp.YS_OP, vp.YS_SHIFT) == (1552, 1152, 1119)
    assert (vp.XS - 2 * vp.M) // vp.TX == 24
    for name, ys in (("vpu_op_probe", vp.YS_OP),
                     ("vpu_shift_probe", vp.YS_SHIFT)):
        spec = importlib.util.spec_from_file_location(
            name + "_layout", os.path.join(REPO, "scripts", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert (mod.NX, mod.NY, mod.TX, mod.M, mod.XS, mod.YS) == (
            vp.NX, vp.NY, vp.TX, vp.M, vp.XS, ys)


def test_refusals():
    """An unknown kind, a layout whose interior is not whole tiles, and a
    non-float32 tensor are refused."""
    x = torch.ones((2 * vp.M + 2 * vp.TX, 8))
    with pytest.raises(ValueError):
        vp.vpu_probe(x, "fma", 4)
    with pytest.raises(ValueError):
        vp.vpu_probe(torch.ones((2 * vp.M + 5, 8)), "plain", 4)
    with pytest.raises(ValueError):
        vp.vpu_probe(x.double(), "plain", 4)


def test_bounds_and_targets():
    """A call of K6 moves 14.16 MB (the interior rows read and written;
    rollx reads the margin rows too): 4.23 us at 3.35 TB/s, bound by bytes
    at K = 16; the plain kind's 2 FP32 instructions a cell at K = 64 take
    6.77 us at 67 TFLOP/s (33.5 G instructions/s): bound by operations.
    One library a K."""
    t, by, nbytes = vp.bound("plain", 16, vp.YS_OP, 3.35e12, 67e12)
    assert (by, nbytes) == ("bytes", 2 * 1536 * 1152 * 4)
    assert abs(t - nbytes / 3.35e12 * 1e3) < 1e-12
    t, by, _ = vp.bound("plain", 64, vp.YS_OP, 3.35e12, 67e12)
    assert by == "operations" and abs(t * 1e3 - 6.762) < 0.01
    assert vp.bound("rollx", 16, vp.YS_OP, 3.35e12, 67e12)[2] == \
        (1552 + 1536) * 1152 * 4
    assert vp.target(16) == "vpu_probe@VPU_K=16"
    assert set(vp.FP32_OPS) == set(vp.KINDS)


def _entry(name):
    spec = importlib.util.spec_from_file_location(
        name + "_entry", os.path.join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_points_need_the_card_unless_asked(capsys):
    """Without a card both scripts raise unless ``--device cpu`` asks for
    the plain version, whose host times they label as such."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    op, shift = _entry("vpu_op_probe_torch"), _entry("vpu_shift_probe_torch")
    for mod, argv in ((op, ["plain"]), (shift, ["4", "8"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(argv)
    op.main(["plain", "sel", "--n", "1", "--device", "cpu"])
    shift.main(["2", "4", "--n", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "not the card" in out and "sel     marginal" in out
    assert "rolly   slope" in out and "nvidia" not in out.lower()


# ---- the kernels' thread maps, modelled on the CPU --------------------------
# csrc/vpu_probe.cu cannot run here; these models walk the cells in the
# order its threads do, with the module's own carrier, and must give the
# plain version's bits.

def _rollx_model(x, k, tx, m):
    """rollx as ``rollx_kernel`` runs it: two threads hold one column of
    one tile's window, the lower its rows ``[0, H)``, the upper ``[H, W)``
    (here the tiles and columns side by side); an iteration first takes
    the other half's last row as it stands (the lower half's row 0 reads
    row ``W - 1`` across the wrap), then updates rows ``H - 1`` down to 1
    of each half in place from the row above (not yet updated), then the
    half's first row from the value taken."""
    xs, ys = x.shape
    w, tiles = tx + 2 * m, (xs - 2 * m) // tx
    h = w // 2
    b = torch.stack([x[t * tx:t * tx + w] for t in range(tiles)])
    halves = b.view(tiles, 2, h, ys)
    for _ in range(k):
        before = halves[:, :, h - 1].flip(1).clone()   # the other half's
        for r in range(h - 1, 0, -1):
            halves[:, :, r] = vp._carrier(halves[:, :, r], halves[:, :, r - 1])
        halves[:, :, 0] = vp._carrier(halves[:, :, 0], before)
    out = x.clone()
    out[m:xs - m] = b[:, m:m + tx].reshape(-1, ys)
    return out


def _rolly_model(x, k, m):
    """rolly as ``rolly_kernel<C, LAST>`` runs it: a warp a row, lane l
    holding columns ``[l C, l C + C)`` (lane 31 the LAST left, its other
    slots idle); an iteration first takes from lane l - 1 (lane 0: lane
    31) the value of the column before its first, the sender's last
    column before this iteration's update, then updates its columns in
    place from the last down to 1, and column 0 from the value taken."""
    xs, ys = x.shape
    c, last = vp.lane_split(ys)
    flat = torch.zeros((xs - 2 * m, 32 * c))
    flat[:, :ys] = x[m:xs - m]
    b = flat.view(xs - 2 * m, 32, c)
    for _ in range(k):
        send = b[:, :, c - 1].clone()
        send[:, 31] = b[:, 31, last - 1]
        taken = send.roll(1, dims=1)
        for j in range(c - 1, 0, -1):
            b[:, :, j] = vp._carrier(b[:, :, j], b[:, :, j - 1])
        b[:, :, 0] = vp._carrier(b[:, :, 0], taken)
    out = x.clone()
    out[m:xs - m] = flat[:, :ys]
    return out


def _spikes(ys, cells):
    """Zeros but ones at ``cells``: a roll's neighbour then differs from
    its own value by orders of magnitude, so reading a neighbour after its
    update (1e-3 off) shows in the bits; on the seeded inputs the
    carrier's 1e-4 weight rounds such a slip away."""
    x = np.zeros((XS, ys), np.float32)
    for r, c in cells:
        x[r, c] = 1.0
    return x


@pytest.mark.parametrize("inp", ["uniform", "spikes"])
@pytest.mark.parametrize("ys", [YS - 1, YS])
@pytest.mark.parametrize("k", [3, K])
def test_rollx_thread_map_gives_the_plain_versions_bits(k, ys, inp):
    """rollx's column a pair of threads, each half descending in place
    after taking the other half's last row, == ``vpu_probe_reference`` bit
    for bit (3 tiles of 16 rows), on seeded inputs and on ones in each
    window's last row (which row 0 reads across the wrap) and in the
    lower half's last (which the upper half's first reads)."""
    x = torch.from_numpy(
        _input(ys, seed=21) if inp == "uniform" else
        _spikes(ys, [(t * TX + TX + 2 * M - 1, 3 + t) for t in range(3)]
                + [(t * TX + (TX + 2 * M) // 2 - 1, 9 + t)
                   for t in range(3)]))
    want = vp.vpu_probe_reference(x, "rollx", k, tx=TX, m=M)
    got = _rollx_model(x, k, TX, M)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("inp", ["uniform", "spikes"])
@pytest.mark.parametrize("ys", [95, 96], ids=["ragged_lane31", "even"])
@pytest.mark.parametrize("k", [3, K])
def test_rolly_thread_map_gives_the_plain_versions_bits(k, ys, inp):
    """rolly's row a warp at C = 3 columns a lane (ys = 95: lane 31 holds
    2; 96: all 3), the carried value taken before the update, == the
    plain version bit for bit, on seeded inputs and on ones in the last
    column and at lane seams."""
    x = torch.from_numpy(
        _input(ys, seed=22) if inp == "uniform" else
        _spikes(ys, [(M + 5, ys - 1), (M + 6, 2), (M + 7, 32)]))
    want = vp.vpu_probe_reference(x, "rolly", k, tx=TX, m=M)
    got = _rolly_model(x, k, M)
    assert vp.lane_split(ys) == (3, ys - 93)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("ys,split", [(1152, (36, 36)), (1119, (35, 34)),
                                      (95, (3, 2)), (96, (3, 3))])
def test_lane_split(ys, split):
    """rolly's lane split, ceil(ys / 32) columns a lane and lane 31's
    count: K6's 1152 -> (36, 36), K7's 1119 -> (35, 34)."""
    assert vp.lane_split(ys) == split
    c, last = split
    assert 31 * c + last == ys and 1 <= last <= c


@pytest.mark.parametrize("ys", [1000, 1120, 1151, 96])
def test_rolly_refuses_an_uninstantiated_width(ys):
    """The kernel is instantiated for the probes' two widths: another is
    refused by name (the wrapper checks before the launcher, which
    returns cudaErrorInvalidValue), and a split whose lanes before the
    last would be ragged does not exist."""
    with pytest.raises(ValueError, match=str(ys)):
        vp.check_rolly_width(ys)
    for ok in vp.ROLLY_WIDTHS:
        vp.check_rolly_width(ok)
    assert vp.ROLLY_WIDTHS == (vp.YS_OP, vp.YS_SHIFT)
    with pytest.raises(ValueError):
        vp.lane_split(33)          # lanes 17-31 would hold nothing


def _interior_quads(xs, ys, m):
    """(the interior's first byte, its quads) on an (xs, ys) float32
    layout, as the elementwise kernels load the rows ``[m, xs - m)``: one
    float4 a quad from a 16-byte aligned buffer, so both must be whole."""
    first, cells = 4 * m * ys, (xs - 2 * m) * ys
    if first % 16 or cells % 4:
        raise ValueError(f"{xs} x {ys}, margin {m}: not whole quads")
    return first, cells // 4


@pytest.mark.parametrize("ys", [vp.YS_OP, vp.YS_SHIFT, YS, YS - 1])
def test_interior_is_whole_quads(ys):
    """The elementwise kernels load and store the interior as float4s:
    its first byte (M YS floats in) and its cell count are multiples of
    16 bytes on both probes' layouts (and the small one), and mulbf16's
    pairs (2 j, 2 j + 1) lie in one quad and one row at K6's YS."""
    for xs, m in ((vp.XS, vp.M), (XS, M)):
        first, quads = _interior_quads(xs, ys, m)
        assert first == 4 * m * ys and first % 16 == 0
        assert quads * 4 == (xs - 2 * m) * ys
    assert vp.YS_OP % 2 == 0 and vp.CELLS["mulbf16"] == 4
    with pytest.raises(ValueError):
        _interior_quads(2 * 3 + 16, 7, 3)   # the interior at byte 84


@pytest.mark.parametrize("kind", vp.KINDS)
def test_cells_a_thread_and_kernel_names(kind):
    """The cells a thread holds (the SASS line's divisor): quads for the
    elementwise kinds (mulbf16 always; bmul never, its row being one a
    cell), or the first port's one cell for those that keep its map, half
    the window's 80 rows for rollx, C for rolly; the
    kernels' mangled names map to their kinds (rolly at K7's width apart),
    the first port's names too."""
    if kind == "rollx":
        assert vp.cells_a_thread(kind, vp.YS_OP) == 40
    elif kind == "rolly":
        assert [vp.cells_a_thread(kind, ys) for ys in vp.ROLLY_WIDTHS] == [
            36, 35]
    else:
        cells = vp.cells_a_thread(kind, vp.YS_OP)
        want = {"mulbf16": (4,), "bmul": (1,)}.get(kind, (1, 4))
        assert cells == vp.CELLS[kind] and cells in want
    names = {"rollx": ("rollx_kernel", ()), "rolly": ("rolly_kernel",
                                                      (36, 36)),
             "mulbf16": ("bf16_kernel", ())}
    name, args = names.get(kind, ("elem_kernel",
                                  (vp.KINDS.index(kind),
                                   vp.CELLS.get(kind, 1))))
    assert vp.kernel_kind(name, args) == kind
    assert vp.kernel_kind("rolly_kernel", (35, 34)) == "rolly@1119"
    assert vp.kernel_kind("rolly_kernel", ()) == "rolly"
    if name == "elem_kernel":
        assert vp.kernel_kind(name, args[:1]) == kind
