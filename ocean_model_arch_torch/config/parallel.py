"""Parallelism / decomposition configuration (the port's own copy of
``ocean_model_arch_tpu/config/parallel.py``).

Mirrors configs/parallel.f90 + configs/cmd.f90. On TPU the
device mesh replaces the MPI rank grid: ``mesh_x``/``mesh_y`` play the role
of pnx/pny. Block-per-proc factors (bppnx/bppny) survive as the logical
*tile* factors used by the weighted decomposition diagnostics
(parallel/decomposition.py); XLA owns intra-shard parallelism so they do
not select a code path.
"""

from __future__ import annotations

import dataclasses

from .parfile import first_lexeme, read_par_lines


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    mod_decomposition: int = 0  # 0 uniform / 1 weighted / 2 from file
    file_decomposition: str = "none"  # decomposition.txt for mode 2
    bppnx: int = 1              # logical blocks per device in x
    bppny: int = 1              # logical blocks per device in y
    debug_level: int = 0        # parallel_dbg; >=3 dumps decomposition.txt
    dlb_balance_steps: int = 0  # dynamic load balance rounds (reference DLB)
    dlb_model_steps: int = 0    # probe steps per DLB round
    mesh_x: int = 1             # device mesh extent along x
    mesh_y: int = 1             # device mesh extent along y


def load_parallel(path: str, argv: list[str] | None = None) -> ParallelConfig:
    """Load from a reference-format parallel.par (parallel.f90:34-42), with
    the reference's CLI override convention (cmd.f90:15-38): argv[0..2]
    override mod_decomposition, bppnx, bppny.

    ``mod_decomposition``: 0 uniform, 1 weighted (the reference's Hilbert-
    weighted assignment; here weighted cut lines), 2 cut lines read back
    from a decomposition.txt-format ``file_decomposition`` — the file the
    reference only ever WRITES at debug_level >= 3
    (decomposition.f90:895-909; its parser keeps the file name but marks
    it '(ignore this)', parallel.f90:47). ``debug_level`` is the
    reference's parallel_dbg line."""
    c = read_par_lines(path)
    cfg = ParallelConfig(
        mod_decomposition=int(first_lexeme(c[0])),
        file_decomposition=first_lexeme(c[1]),
        bppnx=int(first_lexeme(c[2])),
        bppny=int(first_lexeme(c[3])),
        debug_level=int(first_lexeme(c[4])),
        dlb_balance_steps=int(first_lexeme(c[7])),
        dlb_model_steps=int(first_lexeme(c[8])),
    )
    if argv:
        over = {}
        if len(argv) >= 1:
            over["mod_decomposition"] = int(argv[0])
        if len(argv) >= 2:
            over["bppnx"] = int(argv[1])
        if len(argv) >= 3:
            over["bppny"] = int(argv[2])
        cfg = dataclasses.replace(cfg, **over)
    return cfg
