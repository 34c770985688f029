"""The control of the correctness check: the plain reference put in the
program's place and computed in bfloat16, the next precision below the
configuration's float32, held against the float32 reference by the same
numbers as a run (``check.py``). It has to read above the limits; its
readings set their upper end.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 [--device cpu]

prints, for each seed, the numbers beside their limits as one JSON line.
The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def readings(workload: str, seed: int, device="cuda", root: str = ROOT,
             dtype=None) -> dict:
    """The control's numbers for one seed at the cell's own size."""
    import torch

    from port_bench import check, harness, traffic
    from port_bench.reference import grid as ref_grid
    from port_bench.reference.sw import Reference
    dtype = dtype or torch.bfloat16
    bench = harness.load_benchmark(root)
    cell = harness.cell_of(bench, workload)
    bench_dir = os.path.join(root, "port_bench")
    cfg_dir = os.path.join(bench_dir, "configs", cell["config"])
    mix = traffic.load(os.path.join(bench_dir, "traffic",
                                    cell["traffic"] + ".json"))
    steps = int(mix["window_steps"])
    tmp = tempfile.mkdtemp(prefix="port_bench_control_")
    try:
        run_dir, settings, _ = harness.prepare_run_dir(cfg_dir, tmp, seed,
                                                       mix)
        res = check.Check(cfg_dir, run_dir, settings, torch.device(device))
        ctl = Reference(ref_grid.build(settings, run_dir), settings,
                        torch.device(device), dtype)
        start = ctl.initial_state(res.ssh0)
        init = dict(start)
        init.update(zip(("hu", "hv", "hh"),
                        (ctl.full(a) for a in ctl.depths(start["ssh"]))))
        res.initial(init)
        first, ok = ctl.run(start, steps)
        res.window(None, first, steps, ok)
        # a later window from the float32 reference's state after the first
        pre, _ = res.ref.run(res.ref.initial_state(res.ssh0), steps)
        later, ok = ctl.run({k: v.to(dtype) for k, v in pre.items()}, steps)
        res.window(pre, later, steps, ok)
        return res.checks()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="port_bench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "checks": readings(args.workload, seed,
                                             args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
