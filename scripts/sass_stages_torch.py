#!/usr/bin/env python3
"""Stage-by-stage SASS count of one kernel of the port.

Reads ``cuobjdump -sass`` text (a file, or a built library, which it
dumps with the CUDA toolkit's ``cuobjdump``) and, for the first kernel
whose mangled name matches a pattern, splits its instructions at the
block barriers (``BAR.SYNC``): each piece is one stage of the fused step
(the first piece is the set-up before the first barrier, where the TMA
boxes are issued). For each piece it prints the instructions it holds by
class -- FP32 arithmetic, MUFU, integer and address, shared loads and
stores, global loads and stores, TMA box loads, mbarrier waits -- and
the body of each loop in it (a backward branch): what a thread issues
for each cell of the stage's region, and the FP32 instructions among
them. A stage's cost a tile is about its loop bodies times the cells of
its region over the block's threads.

Usage: python scripts/sass_stages_torch.py SASS_TEXT_OR_LIBRARY KERNEL_REGEX
       [--cells N,N+N,...] [--tile TXxTY]

With ``--cells`` (one entry a piece, in order: the cells of the region of
each stage the piece holds, ``+`` between two stages of one piece, 0 for
a piece that walks no region) it also prints the instructions a tile of
the stage loops: each stage's cell loop body (a loop, less the unrolled
twin nvcc puts after it, which a thread runs only with four cells or more
left, never at the one to three cells a stage gives it) times the cells
of its region, summed over the kernel. With ``--tile TXxTY`` a stage may
be given by its region's halo instead, ``hN``: the (TX + 2 N) x (TY + 2
N) cells N beyond the tile, as the fused step's stages walk them (the
fast and the general body alike). An entry ``.../K`` is a loop that
nvcc unrolled K times, K cells an iteration (its stores a cell times K
in its body): its cells over K.

e.g. the chained guarded form without tracers, folded (elide_sel, q4,
share_prev), from its library in ``build/torch_kernels/`` (the general
form's is ``fused_sw_step_kernelILi0ELb1ELb0ELi0ELb0ELb0ELb1ELb1ELi2ELb1E``
in ``libfused_step-FUSED_NT0-FUSED_GEN1-FUSED_STEPS2-*.so``):
  python scripts/sass_stages_torch.py \\
      build/torch_kernels/libfused_step-FUSED_NT0-FUSED_STEPS2-FUSED_FOLD7-*.so \\
      'fold_kernelILi0ELb1ELb0ELi0ELb0ELb0ELb1ELb1ELi2ELi7E'
Needs nothing but Python for a text file; a library needs cuobjdump
(``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``).
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys

# instruction classes, by opcode (predicates stripped)
CLASSES = {
    "fp32": r"(FFMA|FADD|FMUL|FMNMX|FSETP|FSEL|FCHK|FSET)",
    "mufu": r"MUFU",
    "int": r"(IMAD|IADD3|LEA|ISETP|SHF|LOP3|IABS|I2F|F2I|SEL|MOV|IMNMX|PRMT)",
    "lds": r"LDS", "sts": r"STS", "ldg": r"LDG", "stg": r"STG",
    "tma": r"UTMALDG", "wait": r"SYNCS",
}
_CLASS_RE = {k: re.compile(r"^" + v + r"\b") for k, v in CLASSES.items()}


def functions(sass: str) -> dict:
    """Mangled kernel name -> [(address, instruction)] of cuobjdump -sass
    text."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0].strip()
        out[name] = [(int(m.group(1), 16), m.group(2).strip())
                     for m in re.finditer(
                         r"/\*([0-9a-f]{4,})\*/\s+([^;\n]*?)\s*;", part)]
    return out


def opcode(ins: str) -> str:
    """The opcode of one instruction, without its predicate guard."""
    words = re.sub(r"^@!?U?P\w+\s+", "", ins).split()
    return words[0] if words else ""


def stages(ins: list) -> list:
    """The kernel's instructions split after each block barrier: one dict
    a piece with its start ``address``, ``counts`` (a Counter by class,
    ``all`` for every instruction) and ``loops`` ((body instructions,
    FP32 among them) for each backward branch inside the piece)."""
    pieces = [[]]
    for addr, op in ins:
        pieces[-1].append((addr, op))
        if opcode(op).startswith(("BAR.SYNC", "BAR.RED")):
            pieces.append([])
    out = []
    for piece in (p for p in pieces if p):
        counts = collections.Counter(all=len(piece))
        for _, op in piece:
            counts.update(k for k, r in _CLASS_RE.items()
                          if r.match(opcode(op)))
        lo = piece[0][0]
        loops = []
        for addr, op in piece:
            m = re.search(r"\bBRA(?:\.\S+)?\s+(?:\S+,\s*)?0x([0-9a-f]+)", op)
            if m and lo <= int(m.group(1), 16) < addr:
                body = [o for a, o in piece
                        if int(m.group(1), 16) <= a <= addr]
                loops.append((len(body), sum(
                    bool(_CLASS_RE["fp32"].match(opcode(o))) for o in body)))
        out.append({"address": lo, "counts": counts, "loops": loops})
    return out


def cell_loops(loops: list) -> list:
    """The loops of a piece that run once a cell of a stage: every loop
    but the unrolled twin nvcc puts right after a loop (its FP32
    instructions k >= 2 times the loop's, its body at most k times the
    loop's and a few more)."""
    out, kept = [], False        # kept: the loop before was a cell loop
    for i, (body, fp) in enumerate(loops):
        b0, f0 = loops[i - 1] if i else (0, 0)
        if kept and f0 and fp >= 2 * f0 and fp % f0 == 0 \
                and body <= fp // f0 * b0 + 8:
            kept = False
            continue
        out.append((body, fp))
        kept = True
    return out


def per_tile(pieces: list, cells: list) -> list:
    """Instructions a tile of each piece's stage loops: its cell loops'
    bodies (:func:`cell_loops`), the i-th times ``cells[piece][i]`` (0
    where the piece has fewer stages than loops, e.g. the set-up's box
    loops)."""
    out = []
    for st, cs in zip(pieces, cells):
        loops = cell_loops(st["loops"])
        out.append(sum(b * (cs[i] if i < len(cs) else 0)
                       for i, (b, _) in enumerate(loops)))
    return out


def read_sass(path: str) -> str:
    """cuobjdump -sass text from a text file or a built library."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head != b"\x7fELF":
        with open(path) as f:
            return f.read()
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout


def parse_cells(spec: str, tile=None) -> list:
    """``--cells``'s pieces: a list a piece of each stage's cells (its
    loop's iterations), an entry ``N`` or, with ``tile`` (rows, columns),
    ``hN`` for the region N cells beyond it, either over ``/K`` for a loop
    of K cells an iteration."""
    def one(e):
        e, _, k = e.partition("/")
        if e.startswith("h"):
            if tile is None:
                raise ValueError(f"{e}: a region's halo needs --tile")
            h = int(e[1:])
            n = (tile[0] + 2 * h) * (tile[1] + 2 * h)
        else:
            n = int(e)
        return n / int(k) if k else n
    return [[one(e) for e in piece.split("+")] for piece in spec.split(",")]


def main(argv) -> int:
    opts = dict(zip(argv[3::2], argv[4::2]))
    if (len(argv) < 3 or len(argv) % 2 == 0
            or set(opts) - {"--cells", "--tile"}
            or ("--tile" in opts and "--cells" not in opts)):
        print(__doc__.split("\n\n")[2], file=sys.stderr)
        return 2
    tile = (tuple(int(n) for n in opts["--tile"].split("x"))
            if "--tile" in opts else None)
    try:
        cells = (parse_cells(opts["--cells"], tile) if "--cells" in opts
                 else None)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2
    for name, ins in functions(read_sass(argv[1])).items():
        if not re.search(argv[2], name):
            continue
        print(f"{name}: {len(ins)} instructions")
        pieces = stages(ins)
        for k, st in enumerate(pieces):
            c = st["counts"]
            print(f"  piece {k} @{st['address']:#x}: " + " ".join(
                f"{x} {c[x]}" for x in ("all",) + tuple(CLASSES))
                + (f"; loop bodies (instructions, fp32) {st['loops']}"
                   if st["loops"] else ""))
        if cells is not None:
            if len(cells) != len(pieces):
                print(f"--cells has {len(cells)} pieces, the kernel "
                      f"{len(pieces)}", file=sys.stderr)
                return 2
            tile = per_tile(pieces, cells)
            print("  stage loops a tile, by piece: " + ", ".join(
                f"{n / 1e3:.1f}k" for n in tile)
                + f"; all {sum(tile) / 1e3:.1f}k instructions a tile")
        return 0
    print(f"no kernel matches {argv[2]!r}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
