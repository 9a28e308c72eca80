"""Phase timing / flop statistics.

Analog of ``SuperLUStat_t`` (SRC/util_dist.h:83-96) with the per-phase
``utime[]``/``ops[]`` arrays over the PhaseType enum
(SRC/superlu_enum_consts.h:65-89), and of ``PStatPrint`` (SRC/util.c:484-534)
which reports phase seconds plus factor/solve flop rates.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

#: Phases, mirroring the reference's PhaseType (superlu_enum_consts.h:65-89).
PHASES = (
    "EQUIL", "ROWPERM", "COLPERM", "ETREE", "SYMBFACT", "DIST",
    "FACT", "SOLVE", "REFINE",
)


@dataclass
class RungRecord:
    """One escalation-ladder action (drivers/gssvx.py): what was tried,
    why, and what it bought.  berr values are max-over-RHS componentwise
    backward errors before/after the rung."""

    name: str                     # "residual-precision" | "gemm-precision"
                                  # | "hiprec-factors" | "refactor-rescale"
    detail: str = ""              # e.g. the dtype escalated to
    berr_before: float = float("inf")
    berr_after: float = float("inf")
    seconds: float = 0.0


@dataclass
class SolveReport:
    """What the solve did to earn trust — the rcond/ferr/berr outputs of
    the reference driver (pdgssvx.c's pdgscon + pdgsrfs reporting) plus
    the recovery ladder's actions.  Attached to Stats.solve_report by
    drivers/gssvx.gssvx."""

    rcond: float | None = None    # Hager–Higham 1-norm estimate (pdgscon)
    ferr: list | None = None      # per-RHS normwise forward-error bounds
    berr: float | None = None     # final max-over-RHS backward error
    berr_history: list = field(default_factory=list)
    rungs: list = field(default_factory=list)     # RungRecord per escalation
    tiny_pivots: int = 0          # ReplaceTinyPivot count for THIS solve
    refine_steps: int = 0
    target: float | None = None   # the berr convergence target applied
    converged: bool = True        # final berr <= target (True w/o refine)
    finite: bool = True           # solution passed the isfinite sentinel
    factor_dtype: str = ""        # dtype of the factors the answer rests on
    gemm_precision: str = ""      # GEMM tier those factors ran at
    solve_route: str = ""         # "device", or "host" for factors the
                                  # executor offloaded to host memory
    residual_route: str = ""      # "device" (csr_spmv on the card) or
                                  # "host" (the refinement residual)
    latency_ms: float | None = None  # driver solve latency (SOLVE + refine
                                  # + ladder + condest), host clock

    def summary(self) -> str:
        parts = [f"factor dtype {self.factor_dtype}" if self.factor_dtype
                 else ""]
        if self.gemm_precision:
            parts.append(f"gemm {self.gemm_precision}")
        if self.solve_route:
            parts.append(f"solve on {self.solve_route}")
        if self.rcond is not None:
            parts.append(f"rcond {self.rcond:.3e}")
        if self.berr is not None:
            parts.append(f"berr {self.berr:.3e}")
        if self.ferr:
            parts.append(f"ferr {max(self.ferr):.3e}")
        if self.latency_ms is not None:
            parts.append(f"latency {self.latency_ms:.3f} ms")
        if self.tiny_pivots:
            parts.append(f"{self.tiny_pivots} tiny pivots replaced")
        for r in self.rungs:
            parts.append(f"rung {r.name}[{r.detail}] "
                         f"berr {r.berr_before:.2e}->{r.berr_after:.2e}")
        if not self.finite:
            parts.append("NON-FINITE")
        if not self.converged:
            parts.append("NOT CONVERGED to target")
        return "; ".join(p for p in parts if p)


@dataclass
class Stats:
    utime: dict = field(default_factory=lambda: {p: 0.0 for p in PHASES})
    ops: dict = field(default_factory=lambda: {p: 0.0 for p in PHASES})
    tiny_pivots: int = 0          # reference: stat->TinyPivots (pdgstrf2.c:226)
    refine_steps: int = 0         # reference: stat->RefineSteps
    solve_report: object = None   # SolveReport of the last driver solve
    sched: dict = field(default_factory=dict)   # FactorPlan.schedule_stats
                                  # of the last factorization
    resume: dict = field(default_factory=dict)  # {"groups", "of", "path"}
                                  # when FACT resumed from a checkpoint
    for_lu_bytes: int = 0         # packed L+U fronts (query_space)
    pool_bytes: int = 0           # the Schur update pool
    current_memory_bytes: int = 0
    peak_memory_bytes: int = 0    # on the card: torch.cuda.max_memory_
                                  # allocated after FACT
    executor: dict = field(default_factory=dict)   # the executor's report
                                  # of the last factorization (numeric/
                                  # factor.get_executor)

    @contextlib.contextmanager
    def timer(self, phase: str):
        """TIC/TOC analog (util_dist.h:135-141).  The caller synchronizes
        the device inside the timed region where the phase ends in
        device work.  Every enter also opens a ``phase`` span on the
        process tracer (obs/trace.py; a no-op when tracing is off)."""
        from superlu_dist_tpu_torch.obs.trace import get_tracer
        t0 = time.perf_counter()
        try:
            with get_tracer().span(phase, cat="phase"):
                yield
        finally:
            self.utime[phase] = (self.utime.get(phase, 0.0)
                                 + time.perf_counter() - t0)

    def log_memory(self, nbytes: int):
        """Analog of log_memory (SRC/util.c:914): delta accounting
        (allocations positive, frees negative) with a running peak."""
        self.current_memory_bytes += nbytes
        self.peak_memory_bytes = max(self.peak_memory_bytes,
                                     self.current_memory_bytes)

    def observe_memory(self, nbytes: int):
        """Replace the current gauge (a new factorization supersedes the
        previous one's), keeping the peak across refactorizations on one
        Stats."""
        self.current_memory_bytes = nbytes
        self.peak_memory_bytes = max(self.peak_memory_bytes, nbytes)

    def gflops(self, phase: str) -> float:
        t = self.utime.get(phase, 0.0)
        return (self.ops.get(phase, 0.0) / t / 1e9) if t > 0 else 0.0

    def report(self) -> str:
        """PStatPrint analog (SRC/util.c:484-534): phase times + Mflops,
        the dispatch schedule, resume, memory and solve-health blocks."""
        lines = ["**************************************************",
                 "**** Time (seconds) ****"]
        for p in PHASES:
            if self.utime.get(p, 0.0) > 0 or self.ops.get(p, 0.0) > 0:
                lines.append(f"    {p:<10s} time {self.utime.get(p, 0.0):10.4f}")
        for p in ("FACT", "SOLVE"):
            if self.ops.get(p, 0.0) > 0:
                lines.append(f"    {p} flops {self.ops[p]:.6e}\t"
                             f"Mflops {self.gflops(p) * 1e3:10.2f}")
        if self.sched:
            # group count vs the level-lockstep partition, mean fronts per
            # dispatch, padding, serial depth (numeric/plan.py)
            s = self.sched
            lines.append(
                f"    schedule {s.get('schedule', '?'):<9s} "
                f"groups {s.get('n_groups', 0):4d} "
                f"(level {s.get('n_level_groups', 0)})  "
                f"occupancy {s.get('occupancy', 0.0):6.2f}  "
                f"padding {s.get('padding_factor', 0.0):5.2f}x  "
                f"critical path {s.get('critical_path', 0)}"
                + (f"  moved {s['bytes_moved'] / 1e6:8.1f} MB"
                   if s.get("bytes_moved") else ""))
        if self.executor:
            e = self.executor
            line = (f"    executor {e.get('executor', '?')}"
                    f"  offload {e.get('offload', 'none')}"
                    f" (wait {e.get('offload_wait_s', 0.0):.3f} s)"
                    f"  host levels {e.get('host_levels', 0)}")
            if e.get("graphs"):
                line += (f"  graphs {e['graphs']}"
                         f" (capture {e.get('capture_s', 0.0):.3f} s)")
            lines.append(line)
        if self.resume:
            lines.append(
                f"    resumed  {self.resume.get('groups', 0)}/"
                f"{self.resume.get('of', 0)} groups from checkpoint "
                f"{self.resume.get('path', '?')}")
        if self.tiny_pivots:
            lines.append(f"    tiny pivots replaced: {self.tiny_pivots}")
        if self.refine_steps:
            lines.append(f"    refinement steps: {self.refine_steps}")
        if self.solve_report is not None:
            lines.append(f"    solve health: {self.solve_report.summary()}")
        if self.for_lu_bytes:
            # dQuerySpace_dist-style report (SRC/dmemory_dist.c:73)
            lines.append(f"    L\\U storage {self.for_lu_bytes / 1e6:10.2f} MB"
                         f"\tupdate pool {self.pool_bytes / 1e6:10.2f} MB")
        if self.peak_memory_bytes:
            lines.append(f"    peak device memory "
                         f"{self.peak_memory_bytes / 1e6:10.2f} MB")
        lines.append("**************************************************")
        return "\n".join(lines)

    def print(self):
        print(self.report())
