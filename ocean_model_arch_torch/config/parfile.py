"""Reference-compatible `.par` file parsing (the port's own copy of
``ocean_model_arch_tpu/config/parfile.py``).

The reference configures itself from positional, line-oriented files in a
``value : comment`` format (one value per line, ``:`` starts the comment),
parsed by legacy/service/read_write_parameters.f90 (readpar /
get_first_lexeme). We accept the exact same files (basin.par, sw.par,
parallel.par, ocean_run.par) so a reference user can bring their configs
unchanged.
"""

from __future__ import annotations


def read_par_lines(path: str) -> list[str]:
    """Return the value part of every line, comments stripped.

    Mirrors readpar (read_write_parameters.f90:7-42): each line is split at
    the first ``:``; the left side is the value field. Blank lines are kept
    as empty strings so the positional line numbering matches the reference.
    """
    lines: list[str] = []
    with open(path, "r") as f:
        for raw in f:
            raw = raw.rstrip("\n")
            value = raw.split(":", 1)[0]
            lines.append(value.strip())
    return lines


def first_lexeme(value: str) -> str:
    """First whitespace-delimited token (get_first_lexeme, :84-93)."""
    parts = value.split()
    return parts[0] if parts else ""


def parse_fortran_float(tok: str) -> float:
    """Parse a Fortran-style literal like ``1.0d+03`` or ``0.5d0``."""
    return float(tok.lower().replace("d", "e"))


def parse_int(tok: str) -> int:
    return int(first_lexeme(tok))
