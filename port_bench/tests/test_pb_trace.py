"""The reduction of a profiler trace and the per-layer readers on a
synthetic trace (on the CPU no kernel runs, so the readers of device
metrics find nothing there)."""

import json

import pytest

from port_bench import harness, roofline, trace

BENCH = harness.BENCH_DIR


def span(name, ts, dur, cat="user_annotation"):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "ph": "X"}


def synthetic(path):
    """A window of 1000 us: run_steps over [100, 900] with four launches
    enqueued at 100, 200, 300, 400 (20 us each); the fused kernel runs
    [150, 250), [250, 350), [350, 450), [450, 550); a max kernel
    [560, 570) and another [905, 915); unpack [920, 960) with a copy
    [940, 950)."""
    ev = [span("pb.window", 0, 1000), span("pb.run_steps", 100, 800),
          span("pb.unpack", 920, 40)]
    ev += [span("pb.enqueue", t, 20) for t in (100, 200, 300, 400)]
    ev += [span("void fused_sw_fold_kernel<0>(...)", t, 100, "kernel")
           for t in (150, 250, 350, 450)]
    ev += [span("reduce_kernel<MaxNan>", 560, 10, "kernel"),
           span("reduce_kernel<MaxNan>", 905, 10, "kernel"),
           span("Memcpy DtoD", 940, 10, "gpu_memcpy")]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_reduce_and_readers(tmp_path):
    path = str(tmp_path / "t.json")
    synthetic(path)
    p = trace.reduce(path)
    assert p["window_s"] == pytest.approx(1e-3)
    assert p["busy_s"] == pytest.approx(430e-6)
    # each gap is named by what the host did at its middle: [0, 150) and
    # [950, 1000) the window outside the program's spans, [550, 560) and
    # [570, 905) run_steps after its last launch, [915, 940) unpack
    assert p["gaps"] == [["guard_read", pytest.approx(345e-6)],
                         ["model.run", pytest.approx(200e-6)],
                         ["unpack", pytest.approx(25e-6)]]
    p["steps"] = 8
    # a measured window of 80 steps in 10 ms, unprofiled: 4.3 ms busy
    ctx = dict(profile=p, wet_cells=698455, n_tracers=0, timers={},
               spans={"seconds": {}, "calls": {}},
               window={"seconds": 10e-3, "steps": 80})
    read = {n: harness.load_reader(BENCH, n) for n in (
        "launches_per_step", "kernel_us_per_step", "kernel_roofline_pct",
        "device_idle_pct")}
    assert read["launches_per_step"](ctx) == pytest.approx(6 / 8)
    assert read["kernel_us_per_step"](ctx) == pytest.approx(400 / 8)
    assert read["kernel_roofline_pct"](ctx) == pytest.approx(
        100 * 4 * roofline.least_seconds_per_launch(698455, 0) / 400e-6)
    assert read["device_idle_pct"](ctx) == pytest.approx(57.0)
    ctx["window"] = {"seconds": 8.6e-3, "steps": 80}
    assert read["device_idle_pct"](ctx) == pytest.approx(50.0)
    # nothing to read: nothing returned
    ctx["profile"] = None
    assert all(r(ctx) is None for r in read.values())


def test_no_device_activity(tmp_path):
    path = str(tmp_path / "t.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": [span("pb.window", 0, 10)]}, f)
    assert trace.reduce(path) is None
