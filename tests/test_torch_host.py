"""The port's own numpy host modules (``config/*``,
``core/{constants,masks,metrics}.py``, ``io/mask_io.py``) against the
modules of the JAX package they were copied from: same inputs, identical
outputs (bit for bit: both are the same numpy code)."""

import dataclasses
import glob
import os

import numpy as np
import pytest

from ocean_model_arch_tpu import config as jcfg
from ocean_model_arch_tpu.core import constants as jconst
from ocean_model_arch_tpu.core import masks as jmasks
from ocean_model_arch_tpu.core import metrics as jmetrics
from ocean_model_arch_tpu.io import mask_io as jmask_io

from ocean_model_arch_torch import config as tcfg
from ocean_model_arch_torch import host
from ocean_model_arch_torch.core import constants as tconst
from ocean_model_arch_torch.core import masks as tmasks
from ocean_model_arch_torch.core import metrics as tmetrics
from ocean_model_arch_torch.io import mask_io as tmask_io

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
