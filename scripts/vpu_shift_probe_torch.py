#!/usr/bin/env python3
"""Shift probe on one NVIDIA GPU: what a shifted operand costs the card.

The PyTorch + CUDA counterpart of ``scripts/vpu_shift_probe.py`` (K7):
three kernel families on the bench layout (1552 x 1119 f32: YS = NY + 4,
not rounded up), each a chain of K dependent ``b*0.999 + 1e-4*op``
iterations over each tile's (TX + 16, YS) window
(``ocean_model_arch_torch/ops/vpu_probe.py``):
  plain  op = b, unshifted (the carrier alone)
  rollx  op = b of the row above, circular over the window's rows
  rolly  op = b of the column before, circular over the YS columns
(rollx holds a window column a thread, rolly a row a warp, in registers:
a shifted operand is a register of the same thread, or one shuffle a lane
across a warp's lanes). The ms-vs-K slope difference is a shifted
operand's cost in carrier-equivalents.

For each kind and K it prints the device ms a call (CUDA events around
n = 500 carried calls from the same input each run, the best of three
after a warm-up run) and the slope in us an op. The first line printed is
the card's name and power limit.

Usage: python scripts/vpu_shift_probe_torch.py [K ...] [--n N]
       [--device cpu]     (default: K = 16 48, n = 500, the card)

Without a card it raises unless ``--device cpu`` is given; then it runs
the plain PyTorch version and prints host ms (not the card's).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ocean_model_arch_torch.ops import vpu_probe as vp  # noqa: E402
from scripts.vpu_op_probe_torch import card_line, host_ms  # noqa: E402


def shift(ks, n: int, device: str, out=print) -> dict:
    """ms a call of each kind at each K, printed with the slopes:
    {kind: {k: ms}}."""
    x = vp.probe_input(vp.YS_SHIFT, device)
    times = {}
    for kind in vp.SHIFT_KINDS:
        times[kind] = {}
        for k in ks:
            times[kind][k] = (vp.time_calls(x, kind, k, n, False)
                              if device != "cpu" else host_ms(x, kind, k, n))
            out(f"{kind:7s} K={k:3d}  {times[kind][k]:.6f} ms/iter")
        if len(ks) >= 2:
            k0, k1 = ks[0], ks[-1]
            slope = (times[kind][k1] - times[kind][k0]) / (k1 - k0)
            out(f"{kind:7s} slope {slope * 1e3:.4f} us/op")
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ks", nargs="*", type=int, default=list(vp.SHIFT_KS))
    ap.add_argument("--n", type=int, default=vp.SHIFT_N)
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
    print(f"vpu shift probe (K7): {vp.XS} x {vp.YS_SHIFT}, n = {a.n} "
          f"calls a run, {where}")
    shift(a.ks, a.n, a.device, lambda t: print(t, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
