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

e.g. the chained guarded form without tracers, folded (elide_sel, q4,
share_prev), from its library in ``build/torch_kernels/``:
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


def main(argv) -> int:
    if len(argv) != 3:
        print(__doc__.split("\n\n")[2], file=sys.stderr)
        return 2
    for name, ins in functions(read_sass(argv[1])).items():
        if not re.search(argv[2], name):
            continue
        print(f"{name}: {len(ins)} instructions")
        for k, st in enumerate(stages(ins)):
            c = st["counts"]
            print(f"  piece {k} @{st['address']:#x}: " + " ".join(
                f"{x} {c[x]}" for x in ("all",) + tuple(CLASSES))
                + (f"; loop bodies (instructions, fp32) {st['loops']}"
                   if st["loops"] else ""))
        return 0
    print(f"no kernel matches {argv[2]!r}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
