"""Phase timers + exit report (counterpart of
``ocean_model_arch_tpu/utils/timers.py``).

The functional analog of the reference's named phase timers
(shared/mpp/mpp.f90:37-52 and the max/min profile table printed by
mpp_finalize, :272-341). Phases carry the same taxonomy (model_step, sw,
tracers, sync/collectives, output, init); the table reports host wall
times per phase plus derived throughput. A phase that ends by reading a
value from the device (the step loop reads its ``ok`` flag) includes
the device's work.

Across processes (``parallel/multihost.py``) :meth:`PhaseTimers.gather`
collects every process's table and :meth:`PhaseTimers.reduced_report`
prints the max/min over the ranks; in one process they give this
process's row and the plain table.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class PhaseTimers:
    def __init__(self):
        self.acc: dict[str, float] = {}
        self.count: dict[str, int] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.acc[name] = self.acc.get(name, 0.0) + dt
            self.count[name] = self.count.get(name, 0) + 1

    def add(self, name: str, dt: float):
        self.acc[name] = self.acc.get(name, 0.0) + dt
        self.count[name] = self.count.get(name, 0) + 1

    def report(self, extra: dict | None = None) -> str:
        lines = ["===================== TIMER REPORT =====================",
                 f"{'phase':<24} {'total s':>12} {'calls':>8} {'s/call':>12}"]
        for name in sorted(self.acc):
            t, c = self.acc[name], self.count[name]
            lines.append(f"{name:<24} {t:>12.4f} {c:>8d} {t / max(c, 1):>12.6f}")
        for k, v in (extra or {}).items():
            lines.append(f"{k:<24} {v}")
        lines.append("========================================================")
        return "\n".join(lines)

    def gather(self) -> list[dict]:
        """Every process's timer state, [{"acc": ..., "count": ...}, ...]
        indexed by process (collective: every process calls it). One
        process: one element, this process's, with no collective."""
        from ..parallel.multihost import all_objects
        return all_objects({"acc": dict(self.acc),
                            "count": dict(self.count)})

    def reduced_report(self, extra: dict | None = None) -> str:
        """One table with the max/min totals over all processes -- the
        analog of mpp_finalize's reduced profile (shared/mpp/mpp.f90:
        272-341: mpi_allreduce MPI_MAX/MPI_MIN of every phase timer,
        master-rank print); a phase that only some ranks ran appears, at 0
        on the others. One process: the plain report."""
        tables = self.gather()
        if len(tables) == 1:
            return self.report(extra)
        names = sorted({n for t in tables for n in t["acc"]})
        lines = [f"============ TIMER REPORT ({len(tables)} processes, "
                 "max/min over ranks) ============",
                 f"{'phase':<24} {'max s':>12} {'min s':>12} {'calls':>8}"]
        for n in names:
            vals = [t["acc"].get(n, 0.0) for t in tables]
            calls = max(t["count"].get(n, 0) for t in tables)
            lines.append(f"{n:<24} {max(vals):>12.4f} {min(vals):>12.4f} "
                         f"{calls:>8d}")
        for k, v in (extra or {}).items():
            lines.append(f"{k:<24} {v}")
        lines.append("=" * 68)
        return "\n".join(lines)
