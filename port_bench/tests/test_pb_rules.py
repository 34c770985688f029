"""The import rule, the least-bytes arithmetic, and the plain reference
against the port's eager composition."""

import ast
import dataclasses
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

import tiny
from conftest import ROOT

BENCH = os.path.join(ROOT, "port_bench")
JAX_STACK = {"jax", "jaxlib", "flax", "ocean_model_arch_tpu"}


def _tops_after(code: str, cwd: str) -> set:
    p = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] "
        "for m in list(sys.modules)})))")], cwd=cwd, capture_output=True,
        text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(p.stdout.split())


def test_a_run_loads_no_jax(tmp_path):
    """After a whole run of a small cell, traced, no module's top-level
    name (compared whole) is the JAX stack's or the JAX package's; the
    harness's own test of that agrees."""
    root = tiny.make(str(tmp_path))
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            f"sys.path.insert(0, {root!r})\n"
            "from port_bench import harness\n"
            f"out = harness.run_cell('tiny_t2.t', 5, 0.2, True, 'cpu', {root!r})\n"
            "assert out['correct'], out\n"
            "assert harness.forbidden_modules() == []")
    tops = _tops_after(code, root)
    assert "ocean_model_arch_torch" in tops
    assert not tops & JAX_STACK


def test_forbidden_names_are_whole():
    """The port's name begins with the JAX package's: only a whole
    top-level name counts."""
    from port_bench import harness
    sys.modules.setdefault("ocean_model_arch_tpux", sys)
    try:
        assert "ocean_model_arch_tpux" not in harness.forbidden_modules()
        sys.modules["ocean_model_arch_tpu.fake"] = sys
        assert "ocean_model_arch_tpu" in harness.forbidden_modules()
    finally:
        sys.modules.pop("ocean_model_arch_tpux", None)
        sys.modules.pop("ocean_model_arch_tpu.fake", None)


def test_reference_imports_nothing_of_the_program():
    """The reference's sources import neither the program nor the JAX
    stack, and loading and stepping it loads none of them."""
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                top = n.split(".")[0]
                assert top not in JAX_STACK | {"ocean_model_arch_torch"}, \
                    (path, n)
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
            "import torch\n"
            "from port_bench.reference import grid, runpar, sw\n"
            "s = runpar.read_run_dir('port_bench/configs/azov250m_t2')\n"
            "s['basin'].update(nx=40, ny=36, mask='none')\n"
            "g = grid.build(s, '.')\n"
            "r = sw.Reference(g, s, 'cpu', torch.float32)\n"
            "st, ok = r.run(r.initial_state(g['lu']), 3)\n"
            "assert ok")
    tops = _tops_after(code, ROOT)
    assert not tops & (JAX_STACK | {"ocean_model_arch_torch"})


def test_least_bytes_on_the_azov_mask():
    """Each carried field read and written once over the wet cells."""
    from port_bench import roofline
    from port_bench.reference import grid
    m = grid.read_mask(os.path.join(BENCH, "data", "AS", "maskAzovCor.txt"),
                       1525, 1115)
    wet = int((m == 0).sum())
    assert wet == 698455 and m.size == 1700375
    assert roofline.least_bytes_per_launch(wet, 0) == 33525840
    assert roofline.least_bytes_per_launch(wet, 2) == 55876400
    assert roofline.least_seconds_per_launch(wet, 0) == pytest.approx(
        33525840 / 3.35e12)


@pytest.mark.parametrize("name", ["azov250m", "azov250m_t2"])
def test_config_json_states_the_run_directory(name):
    """config.json's settings are those of the .par files beside it."""
    import json
    from port_bench.reference import runpar
    d = os.path.join(BENCH, "configs", name)
    c = json.load(open(os.path.join(d, "config.json")))
    s = runpar.read_run_dir(d)
    st = c["settings"]
    assert (s["basin"]["nx"], s["basin"]["ny"]) == (st["nx"], st["ny"])
    assert s["basin"]["mask"] == st["mask"].split()[0]
    assert s["basin"]["curve_grid"] == 1 and s["basin"]["topo"] == "none"
    assert s["run"]["tau"] == st["tau_s"]
    for k in ("full_free_surface", "trans_terms", "ksw_lat", "time_smooth",
              "lvisc_2", "use_tracers", "tracer_num"):
        assert s["sw"][k] == st[k], k
    assert c["reduced"] == [] and c["name"] == name
    assert os.path.exists(os.path.join(d, s["basin"]["mask"]))


@pytest.mark.parametrize("tracers,trans,ffs", [
    (0, 1, 1), (2, 1, 1), (1, 0, 1), (2, 1, 0)])
def test_reference_against_the_eager_composition(tmp_path, tracers, trans,
                                                 ffs):
    """In float64 the reference follows the port's eager composition
    (model/step.py) on a coastline to rounding, 20 steps, from a seeded
    sea surface."""
    import torch
    from ocean_model_arch_torch.config import Precision
    from ocean_model_arch_torch.model.model import (OceanModel,
                                                    load_config_dir)
    from ocean_model_arch_torch.model.step import make_step
    from port_bench import harness, traffic
    from port_bench.reference import grid, runpar, sw
    root = tiny.make(str(tmp_path / "b"))
    cfg_dir = os.path.join(root, "port_bench", "configs", "tiny_t2")
    mix = traffic.load(os.path.join(root, "port_bench", "traffic", "t.json"))
    run_dir, s, _ = harness.prepare_run_dir(cfg_dir, str(tmp_path), 7, mix)
    cfg = load_config_dir(run_dir)
    cfg = dataclasses.replace(cfg, precision=Precision.f64(), sw=(
        dataclasses.replace(cfg.sw, use_tracers=int(tracers > 0),
                            tracer_num=max(tracers, 1), trans_terms=trans,
                            full_free_surface=ffs)))
    s["sw"].update(use_tracers=int(tracers > 0), tracer_num=max(tracers, 1),
                   trans_terms=trans, full_free_surface=ffs)
    m = OceanModel(cfg, base_dir=run_dir, device="cpu")
    step = make_step(m.grid, cfg)
    st = m.state
    for _ in range(20):
        st, ok = step(st, cfg.run.tau)
        assert bool(ok)
    g = grid.build(s, run_dir)
    ref = sw.Reference(g, s, "cpu", torch.float64)
    ssh0 = grid.read_record(os.path.join(run_dir, "INIT",
                                         s["sw"]["ssh_init"]), *g["lu"].shape)
    r, ok = ref.run(ref.initial_state(ssh0), 20)
    assert ok
    got = harness.carried(st, tracers)
    for k, v in r.items():
        scale = float(v.abs().max())
        assert scale > 0, k
        err = float((got[k].double() - v).abs().max()) / scale
        assert err < 1e-12, (k, err)
    # the grid the reference works out is the program's
    for k in ("lu", "lcu", "lcv", "luu", "luh", "llu", "llv", "dx", "dy",
              "dxt", "dyt", "dxh", "dyh", "dxb", "dyb", "rlh_s"):
        np.testing.assert_array_equal(getattr(m.grid, k).numpy(), g[k],
                                      err_msg=k)
