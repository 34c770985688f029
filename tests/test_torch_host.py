"""The port's own numpy host modules (``config/*``,
``core/{constants,masks,metrics}.py``, ``io/{mask_io,grads,native}.py``,
``parallel/decomposition.py``, ``utils/calendar.py``) against the
modules of the JAX package they were copied from: same inputs, identical
outputs (bit for bit: both are the same numpy code), and the same source
after the docstring's first lines; ``utils/timers.py``, a port, against
the original's report text."""

import dataclasses
import glob
import os

import numpy as np
import pytest

from ocean_model_arch_tpu import config as jcfg
from ocean_model_arch_tpu.core import constants as jconst
from ocean_model_arch_tpu.core import masks as jmasks
from ocean_model_arch_tpu.core import metrics as jmetrics
from ocean_model_arch_tpu.io import grads as jgrads
from ocean_model_arch_tpu.io import mask_io as jmask_io
from ocean_model_arch_tpu.io import native as jnative
from ocean_model_arch_tpu.parallel import decomposition as jdd
from ocean_model_arch_tpu.utils import calendar as jcalendar
from ocean_model_arch_tpu.utils import timers as jtimers

from ocean_model_arch_torch import config as tcfg
from ocean_model_arch_torch import host
from ocean_model_arch_torch.core import constants as tconst
from ocean_model_arch_torch.core import masks as tmasks
from ocean_model_arch_torch.core import metrics as tmetrics
from ocean_model_arch_torch.io import grads as tgrads
from ocean_model_arch_torch.io import mask_io as tmask_io
from ocean_model_arch_torch.io import native as tnative
from ocean_model_arch_torch.parallel import decomposition as tdd
from ocean_model_arch_torch.utils import calendar as tcalendar
from ocean_model_arch_torch.utils import timers as ttimers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(d for d in glob.glob(os.path.join(REPO, "examples", "*"))
                  if os.path.exists(os.path.join(d, "basin.par")))


def _same_arrays(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


PRESETS = {
    "basinpar_bs4km": lambda m: m.basinpar_bs4km(),
    "basinpar_as250m": lambda m: m.basinpar_as250m(),
    "basinpar_as250m_test": lambda m: m.basinpar_as250m_test(),
    "basinpar_flat": lambda m: m.basinpar_flat(70, 52, curve_grid=1,
                                               rlon=27.5, rlat=41.0),
    "sw_test": lambda m: m.sw_test(),
    "SWConfig": lambda m: m.SWConfig(use_tracers=1, tracer_num=2),
    "ParallelConfig": lambda m: m.ParallelConfig(),
    "RunConfig": lambda m: m.RunConfig(),
    "Precision_f32": lambda m: m.Precision.f32(),
    "Precision_f64": lambda m: m.Precision.f64(),
    "ModelConfig": lambda m: m.ModelConfig(
        basin=m.basinpar_as250m_test(), sw=m.SWConfig(use_tracers=0),
        precision=m.Precision.f32()),
}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_config_presets_equal(name):
    got, want = PRESETS[name](tcfg), PRESETS[name](jcfg)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]


def test_config_exports_equal():
    assert sorted(tcfg.__all__) == sorted(jcfg.__all__)


@pytest.mark.parametrize("example", EXAMPLES, ids=os.path.basename)
def test_par_readers_equal(example):
    """basin.par, sw.par, parallel.par and ocean_run.par of every example
    configuration parse to equal configs."""
    assert EXAMPLES, "no example configurations found"
    for fname, loader in (("basin.par", "load_basinpar"),
                          ("sw.par", "load_sw"),
                          ("parallel.par", "load_parallel"),
                          ("ocean_run.par", "load_runpar")):
        path = os.path.join(example, fname)
        if not os.path.exists(path):
            continue
        kw = {"argv": []} if loader == "load_parallel" else {}
        got = getattr(tcfg, loader)(path, **kw)
        want = getattr(jcfg, loader)(path, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), fname


def test_constants_equal():
    names = [n for n in dir(jconst) if n.isupper()]
    assert len(names) >= 15
    assert names == [n for n in dir(tconst) if n.isupper()]
    for n in names:
        a, b = getattr(tconst, n), getattr(jconst, n)
        assert type(a) is type(b) and a == b, n
    assert host.FREE_FALL_ACC == jconst.FREE_FALL_ACC
    assert host.DPI == jconst.DPI


@pytest.mark.parametrize("curve_grid", [0, 1, 2])
def test_metrics_bit_identical(curve_grid):
    """Coordinates, base metrics and the GeoMetrics arrays for the
    cartesian, rotated-spherical and bipolar grids."""
    def basin(m):
        return m.basinpar_flat(40, 36, curve_grid=curve_grid, rlon=27.5,
                               rlat=41.0)
    got = tmetrics.build_geo_metrics(basin(tcfg))
    want = jmetrics.build_geo_metrics(basin(jcfg))
    assert len(got) == len(want) == 5
    for i in range(4):
        _same_arrays(got[i], want[i], f"coordinate {i}")
    fields = [f.name for f in dataclasses.fields(want[4])]
    assert fields == [f.name for f in dataclasses.fields(got[4])]
    for n in fields:
        _same_arrays(getattr(got[4], n), getattr(want[4], n), n)


@pytest.mark.parametrize("px,py", [(False, False), (True, False),
                                   (False, True)])
def test_masks_identical_on_a_random_mask(px, py):
    rng = np.random.RandomState(5)
    nx, ny = 31, 27
    _same_arrays(tmasks.frame_of_land_mask(nx, ny),
                 jmasks.frame_of_land_mask(nx, ny), "frame")
    mask = jmasks.frame_of_land_mask(nx, ny)
    mask[2:-2, 2:-2] = (rng.rand(nx - 4, ny - 4) < 0.3).astype(np.int32)
    lu_t = tmasks.lu_from_int_mask(mask)
    lu_j = jmasks.lu_from_int_mask(mask)
    _same_arrays(lu_t, lu_j, "lu")
    got = tmasks.derive_staggered_masks(lu_t, periodic_x=px, periodic_y=py)
    want = jmasks.derive_staggered_masks(lu_j, periodic_x=px, periodic_y=py)
    assert len(got) == len(want) == 6
    for i, (a, b) in enumerate(zip(got, want)):
        _same_arrays(a, b, f"staggered mask {i}")


def test_read_mask_identical_on_the_azov_coastline(tmp_path):
    basin = tcfg.basinpar_as250m_test()
    path = os.path.join(REPO, "data", "AS", "maskAzovCor.txt")
    got = tmask_io.read_mask(path, basin.nx, basin.ny)
    want = jmask_io.read_mask(path, basin.nx, basin.ny)
    assert got.shape == (basin.nx, basin.ny)
    _same_arrays(got, want.astype(got.dtype), "azov mask")
    assert 0.35 < float((got == 0).mean()) < 0.45      # 41 % wet
    # round trip through the port's writer and the JAX reader
    small = got[700:760, 500:540]
    out = str(tmp_path / "mask.txt")
    tmask_io.write_mask(out, small)
    _same_arrays(jmask_io.read_mask(out, *small.shape).astype(small.dtype),
                 small, "round trip")
    _same_arrays(tmask_io.load_mask("none", 12, 9),
                 jmask_io.load_mask("none", 12, 9), "load_mask none")
    assert host.read_mask is tmask_io.read_mask


def test_torch_dtype_map():
    import torch
    assert host.torch_dtype(tcfg.Precision.f32().state_dtype) == torch.float32
    assert host.torch_dtype(tcfg.Precision.f64().state_dtype) == torch.float64
    assert host.torch_dtype(np.float32) == torch.float32


COPIES = ["parallel/decomposition.py", "io/grads.py", "io/native.py",
          "io/mask_io.py", "utils/calendar.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_verbatim_after_the_docstrings_first_line(rel):
    """A copied module is its original apart from the docstring's first
    line, which names what it was copied from."""
    with open(os.path.join(REPO, "ocean_model_arch_tpu", rel)) as f:
        want = f.read().splitlines()
    with open(os.path.join(REPO, "ocean_model_arch_torch", rel)) as f:
        got = f.read().splitlines()
    assert "the port's" in " ".join(got[:2]) and f"ocean_model_arch_tpu/{rel}" \
        in " ".join(got[:2])
    assert got[2:] == want[1:]


def _random_mask(nx=61, ny=47, seed=7):
    rng = np.random.RandomState(seed)
    mask = tmasks.frame_of_land_mask(nx, ny)
    land = rng.rand(nx - 4, ny - 4)
    land[:20] *= 0.4                   # more land on one side
    mask[2:-2, 2:-2] |= (land < 0.2).astype(np.int32)
    return mask


@pytest.mark.parametrize("px,py", [(2, 2), (3, 1), (1, 4)])
def test_decomposition_cuts_identical(px, py):
    mask = _random_mask()
    for name, args in (("weighted_x_edges", (px,)),
                       ("weighted_y_edges", (py,))):
        if args[0] > 1:
            _same_arrays(getattr(tdd, name)(mask, *args, min_width=4),
                         getattr(jdd, name)(mask, *args, min_width=4), name)
    if px > 1:
        powers = np.linspace(1.0, 2.0, px)
        _same_arrays(tdd.weighted_x_edges(mask, px, compute_powers=powers),
                     jdd.weighted_x_edges(mask, px, compute_powers=powers),
                     "powers")
        edges = tdd.weighted_x_edges(mask, px)
        assert tdd.x_band_balance(mask, edges, py) == \
            jdd.x_band_balance(mask, edges, py)
    got, want = tdd.mesh_split_report(mask, px, py), \
        jdd.mesh_split_report(mask, px, py)
    assert sorted(got) == sorted(want)
    for k in want:
        _same_arrays(got[k], want[k], k)
    assert tdd.choose_mesh_dims(mask, px * py) == \
        jdd.choose_mesh_dims(mask, px * py)


def test_decomposition_dump_and_read_identical(tmp_path):
    """The block decomposition, its dump and what either package reads
    back from the other's file."""
    mask = _random_mask()
    decs = [m.assign_hilbert(m.block_weights(mask, 4, 4), 3)
            for m in (tdd, jdd)]
    for f in dataclasses.fields(decs[1]):
        a, b = getattr(decs[0], f.name), getattr(decs[1], f.name)
        if isinstance(b, np.ndarray):
            _same_arrays(a, b, f.name)
        else:
            assert a == b, f.name
    paths = [str(tmp_path / n) for n in ("torch.txt", "jax.txt")]
    tdd.dump_decomposition(decs[0], paths[0])
    jdd.dump_decomposition(decs[1], paths[1])
    assert open(paths[0]).read() == open(paths[1]).read()
    back_t = tdd.read_decomposition(paths[1], nx=61, ny=47)
    back_j = jdd.read_decomposition(paths[0], nx=61, ny=47)
    _same_arrays(back_t.weights, back_j.weights, "weights")
    _same_arrays(back_t.owner, back_j.owner, "owner")
    dec2 = tdd.assign_uniform(tdd.block_weights(mask, 4, 2), 2, 2)
    for a, b in zip(tdd.cuts_from_decomposition(dec2, 2, 2),
                    jdd.cuts_from_decomposition(
                        jdd.assign_uniform(jdd.block_weights(mask, 4, 2), 2,
                                           2), 2, 2)):
        _same_arrays(a, b, "cuts")


@pytest.mark.parametrize("native_on", [True, False])
def test_grads_records_identical(tmp_path, monkeypatch, native_on):
    """Records and .ctl files written by either package are the same
    bytes, and each reads the other's; with the native helper and with
    its pure-Python fallback."""
    if not native_on:
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
    elif tnative.get_lib() is None:
        assert jnative.get_lib() is None       # no toolchain for either
    nx, ny = 20, 14
    rng = np.random.RandomState(1)
    lu = np.zeros((nx, ny), np.float32)
    lu[2:-2, 2:-2] = rng.rand(nx - 4, ny - 4) < 0.7
    fields = [rng.randn(nx, ny) for _ in range(2)]
    pt, pj = str(tmp_path / "t" / "ssh.dat"), str(tmp_path / "j" / "ssh.dat")
    for m, p in ((tgrads, pt), (jgrads, pj)):
        os.makedirs(os.path.dirname(p))
        for r, f in enumerate(fields):
            m.write_record(p, r + 1, f, lu)
        m.write_ctl(p, nx=nx - 4, ny=ny - 4, nt=2, x0=27.5, hx=0.05,
                    y0=41.0, hy=0.04, title="SSH, m", varname="ssh")
    assert open(pt, "rb").read() == open(pj, "rb").read()
    assert open(pt[:-4] + ".ctl").read() == open(pj[:-4] + ".ctl").read()
    for r in (1, 2):
        _same_arrays(tgrads.read_record(pj, r, nx, ny),
                     jgrads.read_record(pt, r, nx, ny), f"record {r}")
    assert tgrads.read_ctl(pj[:-4] + ".ctl") == \
        jgrads.read_ctl(pt[:-4] + ".ctl")
    assert tgrads.UNDEF == jgrads.UNDEF


def test_native_helper_identical():
    """The native mask parser of the port's ``io/native.py`` (built from
    ``cpp/fastio.cpp`` as the original's) against the original's and
    against the pure-Python reader; both or neither have a toolchain."""
    path = os.path.join(REPO, "data", "BS", "mask_bs4km.txt")
    got, want = tnative.read_mask(path, 289, 163), \
        jnative.read_mask(path, 289, 163)
    assert (got is None) == (want is None)
    assert tnative._SO == jnative._SO and tnative._SRC == jnative._SRC
    if got is not None:
        _same_arrays(got, want, "native mask")
    _same_arrays(tmask_io.read_mask(path, 289, 163),
                 jmask_io.read_mask(path, 289, 163), "mask")


def test_calendar_identical():
    for step, tau, year, yr_type in ((0, 1.0, 2012, 0), (604, 1.0, 2012, 1),
                                     (86400 * 59, 1.0, 2012, 1),
                                     (123456, 300.0, 2011, 0),
                                     (400 * 288, 300.0, 2013, 1)):
        a = tcalendar.model_time(step, tau, year, yr_type)
        b = jcalendar.model_time(step, tau, year, yr_type)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.stamp() == b.stamp()
        assert tcalendar.days_in_year(year, yr_type) == \
            jcalendar.days_in_year(year, yr_type)


def test_timers_report_text_equals_the_originals():
    """The same phases and times give the same table in both packages
    (one process: the reduced report is the plain one)."""
    a, b = ttimers.PhaseTimers(), jtimers.PhaseTimers()
    for t in (a, b):
        t.add("model_step", 12.5)
        t.add("model_step", 0.25)
        t.add("output", 0.03125)
        t.add("init_grid", 1.0)
    extra = {"wet_points_per_sec": "3.262e+06"}
    assert a.report(extra) == b.report(extra)
    assert a.reduced_report(extra) == b.reduced_report(extra)
    assert a.gather() == b.gather() == [{"acc": a.acc, "count": a.count}]
    with a.phase("checkpoint"):
        pass
    assert a.count["checkpoint"] == 1 and a.acc["checkpoint"] >= 0.0
