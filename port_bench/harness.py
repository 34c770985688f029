"""One run of one cell of the benchmark.

A cell ``<config>.<mix>`` of ``BENCHMARK.json`` names a configuration,
``port_bench/configs/<config>/`` (a run directory of ``.par`` files and a
``config.json``), and a traffic mix, ``port_bench/traffic/<mix>.json``
(``traffic.py``). A run:

1. copies the run directory into a fresh directory under ``TMPDIR``,
   names the mask by its path in the checkout and writes the seeded
   initial sea surface as the run's ``ssh init`` record;
2. builds ``OceanModel(cfg, device)`` from it as the entry point does with
   ``--f32``;
3. runs the mix's warm-up windows through ``OceanModel.run``; set-up ends
   here;
4. measures: windows through ``OceanModel.run``, one call each, until
   ``seconds`` have passed, each call continuing from the step the last
   one reached; what the host did meanwhile goes to standard error
   (``HostUse``);
5. with ``trace``, measures the host spans in that window and profiles one
   more window (``trace.py``, ``metrics/``);
6. frees the program and holds its results against the plain reference
   (``check.py``).

Everything of one configuration, mix or per-layer metric is a file found
by its name: a new cell needs no edit here.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from port_bench import check, trace, traffic
from port_bench.reference import grid as ref_grid
from port_bench.reference import runpar

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "ocean_model_arch_tpu")
CARRIED = ("ssh", "sshp", "ubrtr", "ubrtrp", "vbrtr", "vbrtrp")
SSH_INIT = "ssh_seeded.dat"


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_of(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: dict, workload: str, traced: bool) -> list:
    """The cell's metrics: end to end untraced, per layer traced; a metric
    with ``workloads`` only in those cells."""
    key = "per_layer" if traced else "end_to_end"
    return [m for m in bench[key]
            if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's (whole names: the port's name begins with the JAX
    package's)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def duration_days(steps: int, tau: float) -> float:
    """A ``run_duration_days`` whose step count is exactly ``steps``."""
    d = steps * tau / 86400.0
    while int(d * 86400.0 / tau) < steps:
        d = math.nextafter(d, math.inf)
    return d


def prepare_run_dir(cfg_dir: str, tmp: str, seed: int, mix: dict) -> tuple:
    """The run directory under ``tmp``: the configuration's files, the
    mask by its absolute path, the seeded ssh record, no output record.
    Returns (directory, settings, the (nx, ny) wet set)."""
    run_dir = os.path.join(tmp, "run")
    shutil.copytree(cfg_dir, run_dir,
                    ignore=shutil.ignore_patterns("config.json"))
    settings = runpar.read_run_dir(run_dir)
    b = settings["basin"]
    if b["mask"] != "none":
        mask_path = os.path.abspath(os.path.join(cfg_dir, b["mask"]))
        _set_line(os.path.join(run_dir, "basin.par"), 18, mask_path)
        im = ref_grid.read_mask(mask_path, b["nx"], b["ny"])
    else:
        im = ref_grid.frame_mask(b["nx"], b["ny"])
    wet = im == 0
    ssh = traffic.ssh_field(wet, seed, mix["ssh_bumps"])
    traffic.write_record(os.path.join(run_dir, "INIT", SSH_INIT), ssh, wet)
    _set_line(os.path.join(run_dir, "sw.par"), 7, SSH_INIT)
    _set_line(os.path.join(run_dir, "ocean_run.par"), 5, "-1.0")
    return run_dir, runpar.read_run_dir(run_dir), wet


def _set_line(path: str, index: int, value: str) -> None:
    with open(path) as f:
        lines = f.read().split("\n")
    comment = lines[index].split(":", 1)[1] if ":" in lines[index] else ""
    lines[index] = f"{value} :{comment}"
    with open(path, "w") as f:
        f.write("\n".join(lines))


def load_reader(bench_dir: str, name: str):
    """The ``read`` of ``<bench_dir>/metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "port_bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def carried(state, n_tracers: int) -> dict:
    """The program's carried fields of a state, by the reference's names
    (references to its tensors, no copy)."""
    out = {k: getattr(state, n) for k, n in zip(
        ("ssh", "sshp", "u", "up", "v", "vp"), CARRIED)}
    if n_tracers:
        out["ff"], out["ffp"] = state.ff, state.ffp
    return out


class Runner:
    """The program under test on one run directory."""

    def __init__(self, run_dir: str, device, mix: dict):
        from ocean_model_arch_torch.config import Precision
        from ocean_model_arch_torch.model.model import (OceanModel,
                                                        load_config_dir)
        cfg = load_config_dir(run_dir)
        cfg = dataclasses.replace(cfg, precision=Precision.f32())
        self.model = OceanModel(cfg, base_dir=run_dir, device=device)
        self.window = int(mix["window_steps"])
        # the cold start, which the run takes up again after
        # ``restart_windows`` windows (the program never changes a state
        # in place, so its initial state can be handed back)
        self.restart = int(mix.get("restart_windows", 0))
        self.cold = (self.model.state, self.model.num_step)
        self.since_cold = 0

    def take_up_cold_start(self) -> None:
        """Before a window: back to the cold start where it is due."""
        if self.restart and self.since_cold == self.restart:
            self.model.state, self.model.num_step = self.cold
            self.since_cold = 0

    def run(self, windows: int) -> None:
        """``windows`` windows through the entry point's loop, one call
        each, from the step the model has reached."""
        m = self.model
        for _ in range(windows):
            self.take_up_cold_start()
            run = dataclasses.replace(m.cfg.run, run_duration_days=(
                duration_days(m.num_step + self.window, m.cfg.run.tau)))
            m.cfg = dataclasses.replace(m.cfg, run=run)
            m.run(verbose=False)
            self.since_cold += 1


class HostUse:
    """What the host did over a stretch, from ``/proc`` (where the system
    has it) and the interpreter: the process's CPU seconds, the share of
    the machine's CPU time its hypervisor took (steal), the process's
    involuntary context switches, the CPUs its thread ran on, and the
    garbage collector's passes and seconds."""

    def __init__(self):
        self.gc_s = 0.0
        self.gc_n = 0
        self._t = None

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n += 1
            self._t = None

    @staticmethod
    def _read(path):
        try:
            with open(path) as f:
                return f.read()
        except OSError:
            return ""

    def _snap(self):
        cpu = self._read("/proc/stat").split("\n", 1)[0].split()[1:]
        cpu = [int(x) for x in cpu] if cpu else []
        nvcs = None
        for line in self._read("/proc/self/status").splitlines():
            if line.startswith("nonvoluntary_ctxt_switches"):
                nvcs = int(line.split()[1])
        stat = self._read("/proc/self/stat").rsplit(")", 1)[-1].split()
        where = int(stat[36]) if len(stat) > 36 else None
        return dict(cpu=cpu, nvcs=nvcs, where=where,
                    proc=time.process_time(), wall=time.perf_counter())

    def __enter__(self):
        self.a = self._snap()
        gc.callbacks.append(self._gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)
        self.b = self._snap()

    def line(self) -> str:
        a, b = self.a, self.b
        wall = b["wall"] - a["wall"]
        out = [f"cpu/wall {(b['proc'] - a['proc']) / wall:.3f}"]
        if a["cpu"] and b["cpu"]:
            d = [y - x for x, y in zip(a["cpu"], b["cpu"])]
            steal = d[7] if len(d) > 7 else 0
            out.append(f"steal {100.0 * steal / max(1, sum(d[:8])):.2f} %")
        if a["nvcs"] is not None and b["nvcs"] is not None:
            out.append(f"involuntary switches {b['nvcs'] - a['nvcs']}")
        out.append(f"on CPU {a['where']} -> {b['where']}")
        out.append(f"gc {self.gc_n} passes {self.gc_s:.4f} s")
        return "host: " + ", ".join(out)


def synchronize(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def profile_window(runner: Runner, spans: trace.Spans, device,
                   tmp: str) -> dict | None:
    """One more window under torch.profiler, its spans as ranges; retaken
    (up to three times) when the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    path = os.path.join(tmp, "window.pt.trace.json")
    for _ in range(3):
        spans.ranges = True
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(trace.WINDOW_SPAN):
                runner.run(1)
                synchronize(device)
        spans.ranges = False
        prof.export_chrome_trace(path)
        red = trace.reduce(path)
        os.remove(path)
        if red is not None:
            red["steps"] = runner.window
            return red
    return None


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device="cuda", root: str = ROOT, t_start: float | None = None,
             log=sys.stderr) -> dict:
    """One run; returns the result line's object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, with ``traced``
    ``breakdown``, and ``checks`` last)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_benchmark(root)
    cell = cell_of(bench, workload)
    bench_dir = os.path.join(root, "port_bench")
    cfg_dir = os.path.join(bench_dir, "configs", cell["config"])
    mix = traffic.load(os.path.join(bench_dir, "traffic",
                                    cell["traffic"] + ".json"))
    dev = torch.device(device)
    tmp = tempfile.mkdtemp(prefix="port_bench_")
    try:
        return _run(bench, cell, mix, bench_dir, cfg_dir, seed, seconds,
                    traced, dev, tmp, t_start, log)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(bench, cell, mix, bench_dir, cfg_dir, seed, seconds, traced, dev, tmp,
         t_start, log) -> dict:
    import torch
    cuda = dev.type == "cuda"
    run_dir, settings, wet = prepare_run_dir(cfg_dir, tmp, seed, mix)
    nt = runpar.n_tracers(settings)
    rng = np.random.default_rng([int(seed), 1])
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    # -- set-up: the model, its initial state, the warm-up windows --------
    runner = Runner(run_dir, dev, mix)
    m = runner.model
    init = {k: v.clone() for k, v in carried(m.state, nt).items()}
    init.update(hu=m.state.hhu.clone(), hv=m.state.hhv.clone(),
                hh=m.state.hhh.clone())
    first_post = pre = post = profile = None
    setup_s = None
    failed = 0
    error = None
    n_win = 0
    timed_spans = {"seconds": {}, "calls": {}}
    spans = trace.Spans()
    try:
        for k in range(int(mix["warmup_windows"])):
            runner.run(1)
            if k == 0:
                synchronize(dev)
                first_post = {k2: v.clone()
                              for k2, v in carried(m.state, nt).items()}
        synchronize(dev)
        setup_s = time.perf_counter() - t_start

        # -- the measured window: windows until ``seconds`` have passed;
        # the first to start past a point drawn from the seed is held
        # against the reference ------------------------------------------
        sample_at = float(rng.random()) * seconds
        if traced:
            spans.install()
        host = HostUse()
        t0 = last = time.perf_counter()
        marks = []
        with host:
            while pre is None or last - t0 < seconds:
                sampled = pre is None and last - t0 >= sample_at
                if sampled:
                    runner.take_up_cold_start()
                    pre = carried(m.state, nt)
                n_win += 1
                runner.run(1)
                last = time.perf_counter()
                marks.append(last)
                if sampled:
                    post = carried(m.state, nt)
            synchronize(dev)
            window_s = time.perf_counter() - t0
        per = np.diff([t0] + marks)
        q1, q2, q3 = np.percentile(per, [25, 50, 75])
        print(f"windows: {n_win} of {q2:.4f} s (quartiles {q1:.4f}, "
              f"{q3:.4f}; min {per.min():.4f}, max {per.max():.4f})",
              file=log)
        print(host.line(), file=log)
        if traced:
            timed_spans = {"seconds": dict(spans.seconds),
                           "calls": dict(spans.calls)}
            profile = profile_window(runner, spans, dev, tmp)
    except FloatingPointError as e:     # the stability guard tripped
        failed, error = 1, str(e)
        if setup_s is None:
            setup_s = time.perf_counter() - t_start
        window_s = float("nan")
    finally:
        spans.uninstall()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    timers = dict(m.timers.acc)
    runner_window = runner.window
    steps = n_win * runner_window
    tau = m.cfg.run.tau

    # -- free the program, then the reference ---------------------------
    del runner, m
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    res = check.Check(cfg_dir, run_dir, settings, dev)
    res.initial(init)
    if first_post is not None:
        res.window(None, first_post, runner_window)
    if pre is not None and post is not None:
        res.window(pre, post, runner_window)
    else:
        res.missing()
    checks = res.checks()
    correct = res.correct() and not failed
    print(f"reference: {res.ref_s:.2f} s", file=log)

    out = {"correct": bool(correct), "attempted": int(n_win),
           "failed": int(failed)}
    ctx = dict(timers=timers, wet_cells=int(wet.sum()), n_tracers=nt,
               spans=timed_spans, profile=profile,
               window=dict(seconds=window_s, steps=steps))
    metrics = {}
    for spec in metrics_of(bench, cell["name"], traced):
        name = spec["name"]
        if name == "setup_s":
            v = setup_s
        elif name == "sypd":
            v = steps * tau / window_s / 365.0 if not failed else None
        elif traced:
            v = load_reader(bench_dir, name)(ctx)
        else:
            v = None
        if v is not None and math.isfinite(v):
            metrics[name] = {"value": float(v), "unit": spec["unit"]}
    out["metrics"] = metrics
    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"),
               "count": 1, "memory_peak_bytes": int(peak)}
    if traced and ctx["profile"]:
        devinfo["busy_s"] = ctx["profile"]["busy_s"]
        devinfo["window_s"] = ctx["profile"]["window_s"]
        out["breakdown"] = {
            "device_ops": trace.top_ops(ctx["profile"]["kernels"]),
            "idle_gaps": ctx["profile"]["gaps"][:10]}
    out["device"] = devinfo
    if error:
        out["error"] = error[:300]
    out["checks"] = checks
    return out
