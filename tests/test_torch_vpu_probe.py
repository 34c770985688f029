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
