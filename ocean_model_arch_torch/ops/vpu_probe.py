"""The op-cost probes K6 and K7: what an operation, or a shifted operand,
costs the card inside a dependent chain.

Counterpart of ``scripts/vpu_op_probe.py::make`` (K6) and
``scripts/vpu_shift_probe.py::make`` (K7), the TPU's probes of the fused
step's op costs. On an (XS, YS) float32 layout of 24 tiles of ``TX`` rows
between margins of ``M`` rows, tile i reads the window of rows
``[i TX, i TX + TX + 2 M)``, all YS columns, runs K dependent iterations
of ``b = b * 0.999 + 1e-4 * op(b)`` (``b`` = the window ``a`` at first)
and writes the window's rows ``[M, M + TX)`` to the output's rows
``[i TX + M, i TX + M + TX)``; ``KINDS`` names the ops (their meaning,
and the kernels' thread maps: ``csrc/vpu_probe.cu``). ``bmul``'s row is
the window's row 0 (global row ``i TX``), ``rollx`` and ``rolly`` are
circular rolls by one within the window (over its ``TX + 2 M`` rows, or
over all YS columns), and
``mulf32`` / ``mulbf16`` are dependent squaring chains without the
carrier. K7 is the kinds ``plain``, ``rollx``, ``rolly`` on its own
layout (YS = NY + 4, not rounded up).

The output's margin rows ``[0, M)`` and ``[XS - M, XS)`` are the input's:
the TPU kernel leaves them unwritten, the port defines them so, and a
carried call (the output of one call the input of the next) reads them
again. The kernel cannot run in place (neighbouring windows overlap by
``2 M`` rows): the carried calls step between two buffers.

:func:`vpu_probe` takes CPU tensors to :func:`vpu_probe_reference` and
CUDA tensors to the kernel (``csrc/vpu_probe.cu``, one library a K,
``vpu_probe@VPU_K=<K>``), which it builds on first use; a kernel that
does not build or launch raises. The plain version evaluates the
carrier as the kernel's fused multiply-add, ``b * 0.999`` and the
rounded ``1e-4 * op`` summed in float64 and rounded once (the same bits
but for a rare double-rounding tie), and ``rcp`` as the exact reciprocal
where the kernel runs ``rcp.approx`` (within an ulp; the carrier weighs
it by 1e-4). The scripts ``scripts/vpu_op_probe_torch.py`` and
``scripts/vpu_shift_probe_torch.py`` are the entry points; nothing on
the model's path calls this module.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os
import re
import subprocess

import numpy as np
import torch

from ._build import build, load, nvcc

# the layout of both TPU scripts (their module constants)
NX, NY = 1525, 1115
TX, M = 64, 8
XS = -(-NX // TX) * TX + 2 * M
YS_OP = -(-(NY + 4) // 128) * 128      # K6: rounded up to the TPU's lanes
YS_SHIFT = NY + 4                      # K7
KINDS = ("plain", "div", "rcp", "rcpn", "sel", "bmul", "rollx", "rolly",
         "mulf32", "mulbf16")
SHIFT_KINDS = ("plain", "rollx", "rolly")
OP_KS, OP_N = (16, 64), 2000           # K6: chain lengths, calls a run
SHIFT_KS, SHIFT_N = (16, 48), 500      # K7
# the chain's constants as float32 values
C1, C2, SQ = np.float32(0.999), np.float32(1e-4), np.float32(0.9999)
# the interior cells a thread of each elementwise kind holds in the kernel
# (4: a quad, one 16-byte load and store; 1: the first port's map, which
# the kinds whose quads measured slower keep); mirror of
# csrc/vpu_probe.cu's CELLS
CELLS = {"plain": 4, "div": 1, "rcp": 1, "rcpn": 1, "sel": 4, "bmul": 1,
         "mulf32": 4, "mulbf16": 4}
# the widths rolly_kernel<C, LAST> is instantiated for (K6's and K7's)
ROLLY_WIDTHS = (YS_OP, YS_SHIFT)
# lower bounds of the FP32-pipe instructions an output cell an iteration
# (the carrier's FMUL + FFMA, and the op's own), for the operations bound
FP32_OPS = {"plain": 2, "div": 3, "rcp": 3, "rcpn": 5, "sel": 3, "bmul": 3,
            "rollx": 2, "rolly": 2, "mulf32": 1, "mulbf16": 0.5}


def _carrier(b: torch.Tensor, op: torch.Tensor) -> torch.Tensor:
    """fma(b, 0.999, f32(op * 1e-4)) in float32 (summed in float64)."""
    t = (op * float(C2)).double()
    return (b.double() * float(C1) + t).float()


def _call(x: torch.Tensor, kind: str, k: int, tx: int, m: int):
    """One call of the plain version: a new tensor, margins copied."""
    xs, ys = x.shape
    a = x[m:xs - m]
    out = x.clone()
    if kind == "mulf32":
        b = a * float(SQ)
        for _ in range(k):
            b = b * b
    elif kind == "mulbf16":
        bb = (a * float(SQ)).to(torch.bfloat16)
        for _ in range(k):
            bb = bb * bb
        b = bb.float()
    elif kind == "rollx":
        # the windows of the tiles, (tiles, tx + 2 m, ys), rolled by one row
        b = x.unfold(0, tx + 2 * m, tx).permute(0, 2, 1)
        for _ in range(k):
            b = _carrier(b, b.roll(1, dims=1))
        b = b[:, m:m + tx].reshape(-1, ys)
    else:
        row = None
        if kind == "bmul":
            rows = (torch.arange(xs - 2 * m) // tx) * tx
            row = x[rows]
        b = a
        for _ in range(k):
            if kind == "plain":
                op = b
            elif kind == "div":
                op = a / b
            elif kind == "rcp":
                op = 1.0 / b
            elif kind == "rcpn":
                r = 1.0 / b
                op = r * (2.0 - b * r)
            elif kind == "sel":
                op = torch.where(b > 0.5, b, a)
            elif kind == "bmul":
                op = b * row
            elif kind == "rolly":
                op = b.roll(1, dims=1)
            else:
                raise ValueError(f"kind {kind!r}: one of {KINDS}")
            b = _carrier(b, op)
    out[m:xs - m] = b
    return out


def vpu_probe_reference(x: torch.Tensor, kind: str, k: int, n: int = 1,
                        tx: int = TX, m: int = M) -> torch.Tensor:
    """``n`` carried calls of kind ``kind`` with a chain of ``k`` in plain
    PyTorch on an (XS, YS) float32 tensor whose ``XS - 2 m`` interior rows
    are tiles of ``tx``: a new tensor, its margin rows ``x``'s."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: one of {KINDS}")
    _check_layout(x, tx, m)
    for _ in range(n):
        x = _call(x, kind, k, tx, m)
    return x


def lane_split(ys: int) -> tuple:
    """rolly's warp a row: (C, LAST), the C = ceil(ys / 32) contiguous
    columns each lane holds and the LAST = ys - 31 C that lane 31 holds.
    Raises where lanes before the last would be ragged or empty."""
    c = -(-ys // 32)
    last = ys - 31 * c
    if ys < 1 or not 1 <= last <= c:
        raise ValueError(f"YS = {ys}: lane 31 would hold {last} of {c} "
                         "columns (lanes 0-30 hold C = ceil(YS / 32) each)")
    return c, last


def check_rolly_width(ys: int) -> None:
    """Raise unless rolly's kernel is instantiated for width ``ys``."""
    if ys not in ROLLY_WIDTHS:
        raise ValueError(f"rolly holds a row in a warp's registers, C = "
                         f"ceil(YS / 32) columns a lane, a template "
                         f"instantiated for YS in {ROLLY_WIDTHS}: YS = {ys} "
                         "is not")


def cells_a_thread(kind: str, ys: int) -> int:
    """The cells a thread of ``kind``'s kernel holds on width ``ys``:
    ``CELLS`` for the elementwise kinds, half the window's ``TX + 2 M``
    rows for rollx (two threads a column), C of :func:`lane_split` for
    rolly."""
    if kind == "rollx":
        return (TX + 2 * M) // 2
    if kind == "rolly":
        return lane_split(ys)[0]
    return CELLS[kind]


def _check_layout(x: torch.Tensor, tx: int, m: int) -> None:
    if (x.dim() != 2 or x.dtype != torch.float32 or x.shape[0] - 2 * m <= 0
            or (x.shape[0] - 2 * m) % tx):
        raise ValueError(f"need a float32 (XS, YS) tensor with XS - {2 * m} "
                         f"a positive multiple of {tx}, got {x.dtype} "
                         f"{tuple(x.shape)}")


def vpu_probe(x: torch.Tensor, kind: str, k: int, n: int = 1) -> torch.Tensor:
    """``n`` carried calls of kind ``kind`` with a chain of ``k`` on an
    (XS, YS) float32 tensor of the probe's tiles (``TX`` rows between
    margins of ``M``): the plain version for a CPU tensor, the kernel for a
    CUDA tensor (counted in ``vpu_probe.launches`` and, by ``(kind, k)``,
    ``.form_launches``, one a call), into new buffers whose margin rows
    are ``x``'s. Returns the last call's output. On the card ``x`` must
    begin on 16 bytes, and rolly runs only on ``ROLLY_WIDTHS``."""
    if x.device.type == "cpu":
        return vpu_probe_reference(x, kind, k, n)
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: one of {KINDS}")
    if n < 1:
        raise ValueError(f"n={n}: at least one call")
    _check_layout(x, TX, M)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError(f"need a contiguous CUDA tensor, got {x.device}")
    if kind == "mulbf16" and x.shape[1] % 2:
        raise ValueError("mulbf16 runs two columns a thread: YS must be even")
    if kind == "rolly":
        check_rolly_width(x.shape[1])
    if x.data_ptr() % 16:
        raise ValueError("the kernels load quads: x must begin on 16 bytes")
    lib = _library(k)
    bufs = [torch.empty_like(x) for _ in range(min(n, 2))]
    for b in bufs:
        b[:M] = x[:M]
        b[-M:] = x[-M:]
    with torch.cuda.device(x.device):
        rc = lib.vpu_run(x.data_ptr(), bufs[0].data_ptr(),
                         bufs[1].data_ptr() if n > 1 else None,
                         KINDS.index(kind), n, x.shape[0], x.shape[1],
                         torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"vpu_probe ({kind}, K={k}) launch failed: "
                           + lib.vpu_error_string(rc).decode())
    vpu_probe.launches += n
    vpu_probe.form_launches[kind, k] += n
    return bufs[(n - 1) % 2]


def reset_launch_counts() -> None:
    """Zero ``vpu_probe.launches`` and ``.form_launches``."""
    vpu_probe.launches = 0
    vpu_probe.form_launches = collections.Counter()


reset_launch_counts()


def probe_input(ys: int, device, seed: int | None = None) -> torch.Tensor:
    """The probe's (XS, ys) input on ``device``: ones, as the TPU scripts
    time it, or with ``seed`` values in [0.5, 1.5) from numpy."""
    if seed is None:
        return torch.ones((XS, ys), dtype=torch.float32, device=device)
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.5, 1.5, (XS, ys)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def time_calls(x: torch.Tensor, kind: str, k: int, n: int,
               carry: bool) -> float:
    """Device ms a call of the kernel, the best of three runs of ``n``
    carried calls (CUDA events around each run), after one warm-up run
    from ``x``; ``carry``: each run starts from the last one's output (K6),
    else from ``x`` (K7)."""
    y = vpu_probe(x, kind, k, n)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        y = vpu_probe(y if carry else x, kind, k, n)
        t1.record()
        t1.synchronize()
        best = min(best, t0.elapsed_time(t1) / n)
    return best


def bound(kind: str, k: int, ys: int, peak_bytes: float,
          peak_flops: float) -> tuple:
    """The least time one call could take on a card of those peak rates
    (bytes/s, f32 FLOP/s): (ms, "bytes" or "operations", bytes). Bytes:
    the output rows written once and the input rows they depend on read
    once (every row for rollx, whose windows wrap; the interior for the
    others, bmul's rows among them). Operations: ``FP32_OPS`` an output
    cell an iteration, FP32-pipe instructions at half the FLOP rate (an
    FFMA's two)."""
    interior = XS - 2 * M
    nbytes = 4 * ys * ((XS if kind == "rollx" else interior) + interior)
    instr = FP32_OPS[kind] * k * interior * ys
    t_b, t_o = nbytes / peak_bytes * 1e3, instr / (peak_flops / 2) * 1e3
    return (t_b, "bytes", nbytes) if t_b >= t_o else (t_o, "operations",
                                                      nbytes)


# the kernels' names in the SASS and their template arguments
_SASS_KERNEL = re.compile(r"Function : \S*?(elem_kernel|bf16_kernel|"
                          r"rollx_kernel|rolly_kernel)(?:I((?:Li\d+E)+)E)?")


def kernel_kind(name: str, args: tuple) -> str:
    """The kind of a kernel of csrc/vpu_probe.cu from its name and
    template arguments: ``elem_kernel<kind, cells>`` by its first,
    ``rolly_kernel<C, LAST>`` as ``rolly`` at K6's width (``rolly@<YS>``
    at another; an older source's ``rolly_kernel`` has none)."""
    if name == "elem_kernel":
        return KINDS[args[0]]
    if name == "rolly_kernel" and args:
        ys = 31 * args[0] + args[1]
        return "rolly" if ys == YS_OP else f"rolly@{ys}"
    return {"bf16_kernel": "mulbf16", "rollx_kernel": "rollx",
            "rolly_kernel": "rolly"}[name]


_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)")


def sass_opcodes(k: int) -> dict:
    """kind -> Counter of the SASS opcodes of its kernel in the library of
    chain length ``k`` (``cuobjdump -sass``), building it if needed."""
    cuobjdump = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", build(target(k))],
                          capture_output=True, text=True,
                          check=True).stdout
    out, kind = {}, None
    for ln in sass.splitlines():
        f = _SASS_KERNEL.search(ln)
        if f:
            name, args = f.groups()
            kind = kernel_kind(name, tuple(
                int(a) for a in re.findall(r"\d+", args or "")))
            out[kind] = collections.Counter()
            continue
        op = _SASS_OP.search(ln)
        if op and kind:
            out[kind][op.group(1).split(".")[0]] += 1
    return out


def sass_per_iteration(k0: int, k1: int) -> dict:
    """kind -> {opcode: instructions a cell and iteration}, the SASS of
    the libraries of chain lengths ``k1`` and ``k0`` apart over ``k1 -
    k0`` and the cells a thread holds at K6's width
    (:func:`cells_a_thread`)."""
    a, b = sass_opcodes(k0), sass_opcodes(k1)
    out = {}
    for kind in KINDS:
        d = b.get(kind, collections.Counter())
        d.subtract(a.get(kind, collections.Counter()))
        per = (k1 - k0) * cells_a_thread(kind, YS_OP)
        out[kind] = {op: c / per for op, c in sorted(d.items()) if c}
    return out


def target(k: int) -> str:
    """The build target of the kernels with a chain of ``k``."""
    return f"vpu_probe@VPU_K={int(k)}"


@functools.lru_cache(maxsize=None)
def _library(k: int) -> ctypes.CDLL:
    """csrc/vpu_probe.cu with a chain of ``k``, built on first use, with
    its C signatures."""
    lib = load(target(k))
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.vpu_k, lib.vpu_tile_rows, lib.vpu_margin,
               lib.vpu_n_kinds):
        fn.argtypes = []
        fn.restype = i
    built = (lib.vpu_k(), lib.vpu_tile_rows(), lib.vpu_margin(),
             lib.vpu_n_kinds())
    if built != (k, TX, M, len(KINDS)):
        raise RuntimeError("csrc/vpu_probe.cu was built for (K, tile rows, "
                           f"margin, kinds) = {built}, not "
                           f"{(k, TX, M, len(KINDS))}")
    lib.vpu_error_string.argtypes = [i]
    lib.vpu_error_string.restype = ctypes.c_char_p
    lib.vpu_run.argtypes = [p, p, p, i, i, i, i, p]
    lib.vpu_run.restype = i
    return lib
