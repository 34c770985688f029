"""A copy of the benchmark with small cells the CPU can run: the
configurations ``tiny`` (a 48 x 40 spherical basin with a coastline and
an island, no tracers) and ``tiny_t2`` (two tracers), the mix ``t``
(windows of 4 steps) and the cells ``tiny.t``, ``tiny_t2.t``; the
program is the checkout's."""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

from conftest import ROOT

NX, NY = 48, 40


def tiny_mask() -> np.ndarray:
    m = np.zeros((NX, NY), int)
    m[:2], m[-2:], m[:, :2], m[:, -2:] = 1, 1, 1, 1
    m[20:26, 15:22] = 1
    m[2:10, 2:6] = 1
    return m


def make(root: str) -> str:
    """The copy under ``root``; returns ``root``."""
    shutil.copytree(os.path.join(ROOT, "port_bench"),
                    os.path.join(root, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "data",
                                                  "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    names = ("tiny", "tiny_t2")
    for name, src in zip(names, ("azov250m", "azov250m_t2")):
        d = os.path.join(root, "port_bench", "configs", name)
        shutil.copytree(os.path.join(root, "port_bench", "configs", src), d)
        path = os.path.join(d, "basin.par")
        with open(path) as f:
            lines = f.read().split("\n")
        lines[0], lines[1] = f"{NX} : nx", f"{NY} : ny"
        lines[5], lines[6] = "0.05d0 : dxst", "0.04d0 : dyst"
        lines[18] = "mask.txt : mask"
        with open(path, "w") as f:
            f.write("\n".join(lines))
        m = tiny_mask()
        with open(os.path.join(d, "mask.txt"), "w") as f:
            f.write("tiny mask\n")
            for n in range(NY - 1, -1, -1):
                f.write("".join(str(v) for v in m[:, n]) + "\n")
    b["configs"] = [dict(c, name=n, file=f"port_bench/configs/{n}/config.json")
                    for c, n in zip(b["configs"], names)]
    b["workloads"] = [dict(w, name=f"{n}.t", config=n, traffic="t")
                      for w, n in zip(b["workloads"], names)]
    for m in b["per_layer"]:
        m["workloads"] = [f"{n}.t" for n in names]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f, indent=1)
    with open(os.path.join(root, "port_bench", "traffic", "t.json"),
              "w") as f:
        json.dump({"window_steps": 4, "warmup_windows": 2,
                   "restart_windows": 3,
                   "ssh_bumps": {"count": 2, "amp_m": [0.05, 0.5],
                                 "sigma_cells": [2, 4]}}, f)
    return root
