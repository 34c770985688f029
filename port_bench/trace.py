"""Spans the benchmark puts around the program's calls, and the reduction
of a torch.profiler trace to device activity, idle gaps and kernel
times.

The spans are wrappers installed in traced runs only, around the names
the program calls: ``fused_sw_step`` as ``model/fused.py`` calls it (one
launch: the enqueue), ``FusedSWModel.pack`` / ``unpack`` /
``run_steps``. Each wrapper times its call on
the host clock and, inside a profiled stretch, opens a
``record_function`` range of its name, so an idle gap of the card can be
named by what the host was doing.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import time

SPAN_PREFIX = "pb."
WINDOW_SPAN = "pb.window"


class Spans:
    """Host time and calls of each wrapped name; ranges for the profiler
    while ``ranges`` is set."""

    def __init__(self):
        self.seconds: dict = {}
        self.calls: dict = {}
        self.ranges = False
        self._undo = []

    def wrap(self, owner, attr: str, name: str) -> None:
        import torch
        orig = getattr(owner, attr)
        spans = self

        def wrapped(*a, **k):
            rng = (torch.profiler.record_function(SPAN_PREFIX + name)
                   if spans.ranges else contextlib.nullcontext())
            t0 = time.perf_counter()
            with rng:
                out = orig(*a, **k)
            spans.seconds[name] = spans.seconds.get(name, 0.0) + (
                time.perf_counter() - t0)
            spans.calls[name] = spans.calls.get(name, 0) + 1
            return out
        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, orig))

    def install(self) -> None:
        """Wrap the program's step loop and pack/unpack (no mix writes
        output records yet, so ``OceanModel._output`` is not wrapped)."""
        from ocean_model_arch_torch.model import fused
        self.wrap(fused, "fused_sw_step", "enqueue")
        self.wrap(fused.FusedSWModel, "pack", "pack")
        self.wrap(fused.FusedSWModel, "unpack", "unpack")
        self.wrap(fused.FusedSWModel, "run_steps", "run_steps")

    def uninstall(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Host:
    """What the host was doing at a time: the innermost benchmark span
    holding it; inside run_steps after its last launch, the guard read."""

    def __init__(self, spans: list):
        enq = SPAN_PREFIX + "enqueue"
        self.enqueue = sorted((a, b) for n, a, b in spans if n == enq)
        self.starts = [a for a, _ in self.enqueue]
        self.other = [s for s in spans if s[0] != enq]
        # the end of the last launch inside each run_steps span
        self.last = {}
        for n, a, b in self.other:
            if n == SPAN_PREFIX + "run_steps":
                i = bisect.bisect_right(self.starts, b) - 1
                self.last[a] = (self.enqueue[i][1]
                                if i >= 0 and self.starts[i] >= a else a)

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.enqueue[i][1]:
            return "enqueue"
        inner = None
        for n, a, b in self.other:
            if a <= t <= b and (inner is None or b - a < inner[2] - inner[1]):
                inner = (n, a, b)
        if inner is None:
            return "harness"
        name = inner[0][len(SPAN_PREFIX):]
        if name == "run_steps":
            return "guard_read" if t >= self.last[inner[1]] else "step_loop"
        return "model.run" if name == "window" else name


def reduce(path: str) -> dict | None:
    """The profiled stretch from a Chrome trace: its length and the
    device's busy time inside it (s), every kernel (name, seconds), and
    the card's idle time by what the host was doing (label, seconds), the
    most first. None without a ``pb.window`` range or without device
    activity."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    win = [e for e in events if e.get("name") == WINDOW_SPAN
           and e.get("cat") == "user_annotation" and "dur" in e]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
           and w0 <= float(e["ts"]) <= w1]
    if not dev:
        return None
    busy = _union([(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), w1))
                   for e in dev])
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(SPAN_PREFIX) and "dur" in e]
    host = _Host(spans)
    idle: dict = {}
    t = w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            label = host.at((t + a) / 2.0)
            idle[label] = idle.get(label, 0.0) + (a - t) * 1e-6
        t = max(t, b)
    kernels = [(str(e["name"]), float(e["dur"]) * 1e-6)
               for e in dev if e.get("cat") == "kernel"]
    return dict(window_s=(w1 - w0) * 1e-6,
                busy_s=sum(b - a for a, b in busy) * 1e-6,
                kernels=kernels,
                gaps=sorted(([k, v] for k, v in idle.items()),
                            key=lambda g: -g[1]))


def top_ops(kernels, n: int = 10):
    """The device operations that took most time: [[name, seconds]]."""
    tot: dict = {}
    for name, s in kernels:
        tot[name] = tot.get(name, 0.0) + s
    return [[k[:160], v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
