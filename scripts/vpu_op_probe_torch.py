#!/usr/bin/env python3
"""Op-cost probe on one NVIDIA GPU: what each operation the fused step
buys costs the card, in slope form.

The PyTorch + CUDA counterpart of ``scripts/vpu_op_probe.py`` (K6): every
kind chains K dependent iterations of ``b = b*0.999 + 1e-4 * op(b)`` over
each tile's (TX + 16, YS) window on the bench layout (1552 x 1152 f32, 24
tiles; ``ocean_model_arch_torch/ops/vpu_probe.py``), so the ms-vs-K slope
differences against ``plain`` (the carrier alone: one FMUL and one FFMA)
isolate each op's marginal cost:

  plain  carrier only          div    a / b (IEEE)
  rcp    rcp.approx(b)         rcpn   rcp.approx + one Newton step
  sel    where(b > 0.5, b, a)  bmul   b * row (the window's row 0)
  rollx  +1 row, circular      rolly  +1 column, circular
  mulf32 / mulbf16  dependent squaring chains in f32 / packed bf16

For each kind it prints the device ms a call at K = 16 and 64 (CUDA events
around n = 2000 calls carried from call to call, the best of three runs
after a warm-up run, each run starting from the last one's output), the
slope in us an op, each op's marginal cost in carriers, and the least
time a call could take at each K (bytes or FP32 instructions, whichever
bounds it). The first line printed is the card's name and power limit.

Usage: python scripts/vpu_op_probe_torch.py [kind ...] [--n N]
       [--device cpu]     (default: every kind, n = 2000, the card)

Without a card it raises unless ``--device cpu`` is given; then it runs
the plain PyTorch version and prints host ms (not the card's): give it a
small ``--n``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ocean_model_arch_torch.ops import vpu_probe as vp  # noqa: E402

# H100 SXM data sheet: HBM bytes/s and f32 FLOP/s outside the tensor cores
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67e12


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def host_ms(x, kind: str, k: int, n: int) -> float:
    """The plain version's host ms a call, the best of three runs."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        vp.vpu_probe(x, kind, k, n)
        best = min(best, time.perf_counter() - t0)
    return best / n * 1e3


def probe(kinds, ks, n: int, ys: int, carry: bool, device: str,
          out=print) -> dict:
    """ms a call for each kind and K: {kind: {k: ms}}, printed with the
    slope (``carry``: each run starts from the last one's output)."""
    x = vp.probe_input(ys, device)
    times = {}
    for kind in kinds:
        times[kind] = {}
        for k in ks:
            times[kind][k] = (vp.time_calls(x, kind, k, n, carry)
                              if device != "cpu" else
                              host_ms(x, kind, k, n))
        k0, k1 = ks[0], ks[-1]
        slope = (times[kind][k1] - times[kind][k0]) / (k1 - k0)
        bounds = "  ".join(
            "bound K{} {:.6f} ({})".format(
                k, *vp.bound(kind, k, ys, PEAK_BYTES, PEAK_FLOPS)[:2])
            for k in ks)
        out(f"{kind:7s} " + "  ".join(f"K{k} {times[kind][k]:.6f}"
                                      for k in ks)
            + f"  slope {slope * 1e3:.4f} us/op  {bounds}")
        times[kind]["slope"] = slope
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kinds", nargs="*", default=list(vp.KINDS))
    ap.add_argument("--n", type=int, default=vp.OP_N)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.device != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the probe times the card "
                               "(--device cpu runs the plain version)")
        print(card_line())
        where = f"device ms a call ({torch.cuda.get_device_name(0)})"
    else:
        where = "host ms a call of the plain version (CPU, not the card)"
    print(f"vpu op probe (K6): {vp.XS} x {vp.YS_OP}, n = {a.n} carried "
          f"calls, {where}")
    t = probe(a.kinds, vp.OP_KS, a.n, vp.YS_OP, True, a.device)
    if "plain" in t:
        base = t["plain"]["slope"]
        for kind in a.kinds:
            if kind != "plain":
                print(f"{kind:7s} marginal = "
                      f"{(t[kind]['slope'] - base) / base:+.2f} "
                      "plain-carriers (carrier = 1 FFMA + 1 FMUL)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
