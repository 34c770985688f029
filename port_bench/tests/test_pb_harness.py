"""The harness on the CPU: a run of a small cell end to end, the shape of
its result line, and cells, mixes and metrics found by their names."""

import json
import os
import subprocess
import sys

import pytest

import tiny
from conftest import ROOT

SEED = 2**31 + 977      # wider than 32 signed bits


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("bench")))


def run(copy, cell, traced, seconds=0.3):
    from port_bench import harness
    return harness.run_cell(cell, SEED, seconds, traced, device="cpu",
                            root=copy)


@pytest.mark.parametrize("cell", ["tiny.t", "tiny_t2.t"])
@pytest.mark.parametrize("traced", [False, True])
def test_result_line_shape(copy, cell, traced):
    out = run(copy, cell, traced)
    assert list(out)[:3] == ["correct", "attempted", "failed"]
    assert list(out)[-1] == "checks"        # the numbers compared, last
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    d = out["device"]
    assert set(d) >= {"platform", "kind", "count", "memory_peak_bytes"}
    names = set(out["metrics"])
    if traced:
        # on the CPU nothing runs on a card: the device readers find
        # nothing to read and are left out
        assert names == {"grid_init_s", "enqueue_us"}
    else:
        assert names == {"sypd", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    checks = out["checks"]
    want = {"init", "ssh", "uv", "guard"} | ({"ff"} if "t2" in cell else set())
    assert set(checks) == want
    for c in checks.values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(out)


def test_new_files_are_found_by_name(copy):
    """A configuration, a mix and a metric added as files, and a cell and
    a metric added to BENCHMARK.json, run without an edit of the
    harness."""
    import shutil
    bench = os.path.join(copy, "port_bench")
    shutil.copytree(os.path.join(bench, "configs", "tiny"),
                    os.path.join(bench, "configs", "tiny_new"))
    with open(os.path.join(bench, "traffic", "t.json")) as f:
        mix = json.load(f)
    mix["window_steps"] = 6
    with open(os.path.join(bench, "traffic", "t6.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench, "metrics", "model_step_s.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx['timers'].get('model_step')\n")
    path = os.path.join(copy, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["configs"].append(dict(b["configs"][0], name="tiny_new",
                             file="port_bench/configs/tiny_new/config.json"))
    b["workloads"].append(dict(b["workloads"][0], name="tiny_new.t6",
                               config="tiny_new", traffic="t6"))
    b["per_layer"].append(dict(b["per_layer"][0], name="model_step_s",
                               workloads=["tiny_new.t6"]))
    with open(path, "w") as f:
        json.dump(b, f)
    out = run(copy, "tiny_new.t6", True)
    assert out["correct"] is True
    assert out["metrics"]["model_step_s"]["value"] > 0
    # a metric listed for other cells only is not asked for here
    out = run(copy, "tiny.t", True)
    assert "model_step_s" not in out["metrics"]


def test_output_mix_is_refused(copy):
    """A mix that writes output records is refused before any run: the
    harness has no output path yet."""
    from port_bench import traffic
    bench = os.path.join(copy, "port_bench")
    with open(os.path.join(bench, "traffic", "t.json")) as f:
        mix = json.load(f)
    path = os.path.join(bench, "traffic", "out1.json")
    for minutes, refused in ((1.0, True), (0, False), (-1.0, False)):
        with open(path, "w") as f:
            json.dump(dict(mix, output_minutes=minutes), f)
        if refused:
            with pytest.raises(ValueError, match="output records"):
                traffic.load(path)
        else:
            traffic.load(path)
    os.remove(path)


def test_restart_takes_up_the_cold_start(copy, tmp_path):
    """With ``restart_windows`` the run starts again from the program's
    initial state, at its first step, after that many windows."""
    from port_bench import harness, traffic
    bench = os.path.join(copy, "port_bench")
    mix = traffic.load(os.path.join(bench, "traffic", "t.json"))
    run_dir, _, _ = harness.prepare_run_dir(
        os.path.join(bench, "configs", "tiny"), str(tmp_path), SEED, mix)
    r = harness.Runner(run_dir, "cpu", mix)
    cold = r.model.state
    steps = []
    for _ in range(7):
        r.run(1)
        steps.append(r.model.num_step)
    assert steps == [4, 8, 12, 4, 8, 12, 4]
    r.run(2)
    r.take_up_cold_start()
    assert r.model.state is cold and r.model.num_step == 0


def test_without_a_card_no_result():
    """run.py without a CUDA card exits with 2 and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        "azov250m.spinup", "--seed", str(SEED), "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_without_the_program_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files
    the run fails before any result."""
    import shutil
    shutil.copytree(os.path.join(ROOT, "port_bench"),
                    tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "data"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys; sys.path.insert(0, '.');"
            "from port_bench import harness;"
            "harness.run_cell('azov250m.spinup', 1, 1, False, 'cpu', '.')")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", ["azov250m.spinup", "azov250m_t2.spinup"])
def test_cell_on_the_card(card, cell):
    """A short run of each cell on the card: correct, and its result line
    last on standard output."""
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        cell, "--seed", str(SEED), "--seconds", "3",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["busy_s"] > 0
