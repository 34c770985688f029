"""The port's scripts on the CPU: ``scripts/balance_gap_torch.py`` prints
``scripts/balance_gap.py``'s rows; ``scripts/drift_curve_torch.py``'s f64
side reproduces ``tests/golden_bs100.json`` at the JAX test's tolerance
and its f32 fused side runs the kernel's plain version;
``scripts/validate_bs10k_torch.py``'s check of the records and digests,
``scripts/cpu_exp_check_torch.py`` at one thread, and (marked slow, deselected by the tier-1 command) the whole 10000-step
f64 run of ``examples/validation_bs10k`` through the entry point against
``RESULTS_TPU`` and ``tests/golden_bs10k.json`` at the 1e-9 gate. The
card runs are in README.md."""

import contextlib
import importlib.util
import io
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().splitlines()


def test_balance_gap_prints_the_originals_rows(monkeypatch):
    monkeypatch.chdir(REPO)     # the original reads its masks from the cwd
    got = _printed(_script("balance_gap_torch").main)
    want = _printed(_script("balance_gap").main)
    assert got == want and len(got) == 9


GOLDEN = json.load(open(os.path.join(REPO, "tests", "golden_bs100.json")))


def test_drift_golden_side_matches_golden_bs100():
    """The f64 eager composition after 100 steps: the committed digests
    at tests/test_golden.py's tolerance (rtol 1e-9, points atol 1e-12)."""
    dc = _script("drift_curve_torch")
    gold = dc.golden([100], "cpu")[100]
    points = [tuple(p) for p in GOLDEN["points"]]
    want = GOLDEN["steps"]["100"]
    for fld in ("ssh", "u", "v", "tracer"):
        a = gold[fld]
        assert a.dtype == np.float64
        got = {"sum": float(a.sum()), "l2": float(np.sqrt((a * a).sum())),
               "absmax": float(np.abs(a).max()),
               "points": [float(a[i, j]) for i, j in points]}
        for k in ("sum", "l2", "absmax"):
            np.testing.assert_allclose(got[k], want[fld][k], rtol=1e-9,
                                       err_msg=f"{fld}.{k}")
        np.testing.assert_allclose(got["points"], want[fld]["points"],
                                   rtol=1e-9, atol=1e-12, err_msg=fld)


def test_drift_curve_rows_on_the_cpu():
    """The fused f32 side (the plain version here) against the golden at
    a short checkpoint list: the original's row keys, small errors, each
    row printed as it is reached."""
    dc = _script("drift_curve_torch")
    checks = [2, 4]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = dc.drift(checks, dc.golden(checks, "cpu"), "cpu")
    assert [json.loads(ln) for ln in buf.getvalue().splitlines()] == rows
    assert [r["steps"] for r in rows] == checks
    for r in rows:
        for k in ("ssh_rel_l2", "ssh_rel_linf", "tracer_rel_l2",
                  "tracer_rel_linf"):
            assert math.isfinite(r[k]) and 0 <= r[k] < 1e-5, (k, r)
        assert "wall_s" in r


def test_validation_copy_runs_the_asked_steps(tmp_path):
    from ocean_model_arch_torch.model.model import load_config_dir
    vb = _script("validate_bs10k_torch")
    for steps in (1000, 10000):
        d = vb.run_copy(str(tmp_path / str(steps)), steps)
        cfg = load_config_dir(d)
        assert cfg.run.num_step_max == steps
        assert cfg.run.output_every_steps == vb.EVERY
        assert os.path.isabs(cfg.basin.mask_file_name)
        assert os.path.exists(cfg.basin.mask_file_name)
        assert cfg.precision.state_dtype == np.float64


def test_validation_check_holds_records_and_digests(tmp_path):
    """The committed records pass their own check; the last ssh record
    with one wet value a part in 1e6 off fails it, at that record alone."""
    vb = _script("validate_bs10k_torch")
    ref = os.path.join(vb.RUN_DIR, "RESULTS_TPU")
    out = vb.check(ref, vb.STEPS, None)
    assert out["ok"] and out["worst"] == 0.0 and len(out["rows"]) == 23
    bad = tmp_path / "bad"
    shutil.copytree(ref, bad)
    n = (vb.NX - 4) * (vb.NY - 4)
    a = np.memmap(bad / "ssh.dat", np.float32, "r+")
    rec = np.abs(a[10 * n:11 * n])
    k = 10 * n + int(np.argmax(np.where(rec < 1e30, rec, 0)))   # wet
    a[k] *= np.float32(1 + 1e-6)
    a.flush()
    del a
    out = vb.check(str(bad), vb.STEPS, None)
    assert not out["ok"] and 1e-8 < out["worst"] < 1e-5
    assert [r["what"] for r in out["rows"] if not r["ok"]] == ["ssh rec 11"]
    assert vb.check(str(bad), vb.STEPS - vb.EVERY, None)["ok"]


def test_cpu_exp_check_at_one_thread_differs_in_no_process():
    """``scripts/cpu_exp_check_torch.py``: a line a fresh process and the
    count last; at one intra-op thread torch's exp of the Black Sea
    bump's exponent equals numpy's in every process."""
    ce = _script("cpu_exp_check_torch")
    lines = _printed(ce.main, ["--runs", "2", "--threads", "1"])
    assert lines[:2] == ["process 0: 0 cells differ",
                         "process 1: 0 cells differ"]
    assert json.loads(lines[-1]) == {
        "metric": "cpu_exp_processes_differing", "threads": 1, "runs": 2,
        "differed": 0}


@pytest.mark.slow
def test_validation_bs10k_through_main_on_the_cpu():
    """The whole check: 10000 f64 steps through ``python -m
    ocean_model_arch_torch``, every record and the final state at the
    1e-9 gate (several minutes)."""
    vb = _script("validate_bs10k_torch")
    lines = _printed(vb.main, ["--device", "cpu"])
    last = json.loads(lines[-1])
    assert last["steps"] == 10000 and last["n_checks"] == 27
    assert last["ok"], "\n".join(lines)


def test_chain_tile_sweep_command_line():
    """``scripts/chain_tile_sweep_torch.py``'s arguments: tiles, folds,
    tracers, the general forms, the loaders and the rounds; a general form
    without tracers gets each loader's library (``FUSED_CHAIN_GEN_TMA``,
    after the tile's macros), any other form the tile's alone; with no
    card the sweep refuses to run."""
    mod = _script("chain_tile_sweep_torch")
    from ocean_model_arch_torch.ops import fused_step as fstep
    assert mod.parse(["--general", "--loader", "threads,tma", "--rounds",
                      "3", "--tracers", "0,2", "default", "32x32x1024x1"]) \
        == {"general": True, "loaders": (0, 1), "rounds": 3,
            "tracers": (0, 2), "tiles": (None, (32, 32, 1024, 1))}
    assert mod.parse(["--folds", "7"]) == {"folds": 7}
    assert mod.sweep_tile(None, 0, False, 1, True) == (16, 32, 512, 2, 1)
    assert mod.sweep_tile((32, 32, 1024, 1), 0, False, 0, True) == (
        32, 32, 1024, 1, 0)
    assert mod.sweep_tile((32, 32, 1024, 1), 2, False, 0, True) == (
        32, 32, 1024, 1)
    assert mod.sweep_tile(None, 0, False, 1, False) is None
    assert fstep.library_target(
        0, steps=2, chain_tile=mod.sweep_tile(None, 0, False, 0, True),
        general=True) == ("fused_step@FUSED_NT=0@FUSED_GEN=1@FUSED_STEPS=2"
                          "@FUSED_CHAIN_TX=16@FUSED_CHAIN_TY=32"
                          "@FUSED_CHAIN_THREADS=512@FUSED_CHAIN_MIN_BLOCKS=2"
                          "@FUSED_CHAIN_GEN_TMA=0")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            mod.sweep(general=True)


def test_roofline_probe_counts_the_windows_it_takes_again(monkeypatch):
    """``scripts/roofline_probe_torch.py::kernel_us`` takes a window again
    where torch.profiler recorded no device time for the kernel, and
    counts it in ``kernel_us.retaken`` (``n`` more calls; chip_smoke.py's
    phase 7 holds the copy step's launches against it); three windows
    without one raise."""
    import types
    import torch.profiler as tp
    mod = _script("roofline_probe_torch")
    seen = types.SimpleNamespace(key="copy_step_kernel<0>", count=4,
                                 self_device_time_total=8.0)
    windows = iter([[], [seen], [], [], []])

    class Window:
        def __enter__(self):
            self.events = next(windows)
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self.events

    monkeypatch.setattr(tp, "profile", lambda **kw: Window())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    calls = []
    assert mod.kernel_us(lambda: calls.append(1), 4) == 2.0
    assert mod.kernel_us.retaken == 1 and len(calls) == 1 + 2 * 4
    with pytest.raises(RuntimeError, match="no device time"):
        mod.kernel_us(lambda: calls.append(1), 4)
    assert mod.kernel_us.retaken == 4
