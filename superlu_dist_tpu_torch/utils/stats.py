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

import numpy as np

#: Phases, mirroring the reference's PhaseType (superlu_enum_consts.h:65-89).
PHASES = (
    "EQUIL", "ROWPERM", "COLPERM", "ETREE", "SYMBFACT", "DIST",
    "FACT", "SOLVE", "REFINE",
)

#: Comm-op kinds tracked by CommStats — the PROFlevel≥1 split
#: (the reference's COMM_DIAG/COMM_RIGHT/COMM_DOWN direction split,
#: SRC/util.c:538-630, re-expressed for the tree-collective transport).
COMM_OPS = ("bcast", "reduce", "allreduce", "bcast_bytes")


class CommStats:
    """Per-op communication counters: calls, bytes, seconds.

    Attached to every TreeComm (``tc.comm_stats``); each collective leg
    accounts at the native-call site, so chunked payloads count one call
    per chunk — the message-count analog of the reference's
    ``MSG_COUNT``/``BYTES`` gauges (superlu_defs.h SuperLUStat_t at
    PROFlevel≥1)."""

    __slots__ = ("calls", "bytes", "seconds")

    def __init__(self):
        self.calls = {op: 0 for op in COMM_OPS}
        self.bytes = {op: 0 for op in COMM_OPS}
        self.seconds = {op: 0.0 for op in COMM_OPS}

    def add(self, op: str, nbytes: int, seconds: float):
        if op not in self.calls:          # tolerate future op kinds
            self.calls[op] = 0
            self.bytes[op] = 0
            self.seconds[op] = 0.0
        self.calls[op] += 1
        self.bytes[op] += int(nbytes)
        self.seconds[op] += float(seconds)

    def totals(self) -> dict:
        """{op: {"calls": n, "bytes": b, "seconds": s}} snapshot."""
        return {op: {"calls": self.calls[op], "bytes": self.bytes[op],
                     "seconds": self.seconds[op]}
                for op in self.calls if self.calls[op]}

    def report(self) -> str:
        lines = []
        for op in self.calls:
            if not self.calls[op]:
                continue
            lines.append(
                f"    comm {op:<12s} calls {self.calls[op]:6d}  "
                f"{self.bytes[op] / 1e6:10.3f} MB  "
                f"{self.seconds[op]:8.4f} s")
        return "\n".join(lines)



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
    retraces: int = 0             # CUDA graphs a warmed executor or solver
                                  # captured again, flagged by the retrace
                                  # sentinel (runtime SLU106)
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
    comm: dict = field(default_factory=dict)   # CommStats.totals()
                                  # snapshot (attach_comm; the distributed
                                  # driver's collectives)
    compile: dict = field(default_factory=dict)   # build-census block of
                                  # the last factorization (obs/
                                  # compilestats.COMPILE_STATS.block:
                                  # builds, seconds, fresh seconds, disk
                                  # hits, top keys; program_audit)

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

    # ---- cross-rank reduction (the sum-over-ranks PStatPrint) -----------
    def _pack(self) -> np.ndarray:
        """Fixed-layout stat vector for the collective reduction: every
        rank packs the same columns in the same order (phase times, phase
        ops, scalar counters, comm counters per COMM_OPS op)."""
        vals = [self.utime.get(p, 0.0) for p in PHASES]
        vals += [self.ops.get(p, 0.0) for p in PHASES]
        vals += [float(self.tiny_pivots), float(self.refine_steps),
                 float(self.peak_memory_bytes)]
        for op in COMM_OPS:
            d = self.comm.get(op, {})
            vals += [float(d.get("calls", 0)), float(d.get("bytes", 0)),
                     float(d.get("seconds", 0.0))]
        return np.asarray(vals, dtype=np.float64)

    def reduce(self, comm) -> "StatsSummary":
        """Cross-rank stat reduction — the PROFlevel PStatPrint the
        reference computes with MPI_Reduce over ranks (SRC/util.c:538-630):
        per-phase min/max/avg plus a load-balance factor (max/avg).

        ``comm`` is anything with ``n_ranks``, ``rank`` and an
        ``allreduce_sum_any(arr)`` collective (a TreeComm in production).
        COLLECTIVE: every rank must call this at the same point.  Each
        rank contributes its packed vector into its own row of an
        (n_ranks, k) matrix; one sum-allreduce gives every rank the full
        per-rank table, from which min/max/avg are exact (the tree
        transport only sums, so gather-then-reduce locally)."""
        vec = self._pack()
        mat = np.zeros((comm.n_ranks, vec.size))
        mat[comm.rank] = vec
        mat = np.asarray(comm.allreduce_sum_any(mat)).reshape(
            comm.n_ranks, vec.size)
        return StatsSummary._from_matrix(mat)

    def attach_comm(self, comm_stats: CommStats):
        """Snapshot a CommStats into this Stats (call BEFORE reduce —
        the reduction itself is comm traffic)."""
        self.comm = comm_stats.totals()
        return self

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
        the dispatch schedule, the executor, the build census, resume,
        retraces, memory and solve-health blocks."""
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
        if self.compile and self.compile.get("builds"):
            # the build census (obs/compilestats.py): what the kernel
            # builds and graph captures of the last factorization cost,
            # and which keys dominated
            c = self.compile
            lines.append(
                f"    compile  builds {c['builds']:4d}  "
                f"{c.get('seconds', 0.0):10.4f} s  "
                f"persistent hits {c.get('persistent_hits', 0)}")
            for row in c.get("census", [])[:3]:
                lines.append(
                    f"      {row['site']:<18s} {row['key']:<26s} "
                    f"x{row['n']:<3d} {row['seconds']:9.4f} s")
        if self.resume:
            lines.append(
                f"    resumed  {self.resume.get('groups', 0)}/"
                f"{self.resume.get('of', 0)} groups from checkpoint "
                f"{self.resume.get('path', '?')}")
        if self.tiny_pivots:
            lines.append(f"    tiny pivots replaced: {self.tiny_pivots}")
        if self.retraces:
            lines.append(f"    UNEXPECTED graph recaptures: {self.retraces} "
                         "(cache-key input changed mid-run — SLU106)")
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
        for op, d in self.comm.items():
            # the PROFlevel≥1 comm split: per-op message count / MB / time
            lines.append(f"    comm {op:<12s} calls {d['calls']:6d}  "
                         f"{d['bytes'] / 1e6:10.3f} MB  "
                         f"{d['seconds']:8.4f} s")
        lines.append("**************************************************")
        return "\n".join(lines)

    def print(self):
        print(self.report())


@dataclass
class RankStat:
    """One quantity reduced over ranks: min/max/avg/total and the
    load-balance factor max/avg (1.0 = perfectly balanced — the
    reference's PROFlevel prints the same factor per comm direction)."""

    min: float
    max: float
    avg: float
    total: float

    @property
    def balance(self) -> float:
        return self.max / self.avg if self.avg > 0 else 1.0

    @classmethod
    def of(cls, col: np.ndarray) -> "RankStat":
        return cls(min=float(col.min()), max=float(col.max()),
                   avg=float(col.mean()), total=float(col.sum()))


@dataclass
class StatsSummary:
    """Cross-rank reduction of Stats (built by Stats.reduce; identical on
    every rank, so callers may branch on it collectively)."""

    n_ranks: int
    utime: dict                   # phase -> RankStat (seconds)
    ops: dict                     # phase -> RankStat (flops)
    tiny_pivots: int              # sum over ranks
    refine_steps: int
    peak_memory_bytes: RankStat
    comm: dict                    # op -> {"calls","bytes": totals,
                                  #        "seconds": RankStat}

    @classmethod
    def _from_matrix(cls, mat: np.ndarray) -> "StatsSummary":
        n_phases = len(PHASES)
        utime = {p: RankStat.of(mat[:, i]) for i, p in enumerate(PHASES)}
        ops = {p: RankStat.of(mat[:, n_phases + i])
               for i, p in enumerate(PHASES)}
        base = 2 * n_phases
        comm = {}
        for j, op in enumerate(COMM_OPS):
            c = base + 3 + 3 * j
            if mat[:, c].sum() > 0:
                comm[op] = {"calls": int(mat[:, c].sum()),
                            "bytes": int(mat[:, c + 1].sum()),
                            "seconds": RankStat.of(mat[:, c + 2])}
        return cls(n_ranks=mat.shape[0], utime=utime, ops=ops,
                   tiny_pivots=int(mat[:, base].sum()),
                   refine_steps=int(mat[:, base + 1].sum()),
                   peak_memory_bytes=RankStat.of(mat[:, base + 2]),
                   comm=comm)

    def balance(self, phase: str) -> float:
        """Load-balance factor max/avg for one phase."""
        return self.utime[phase].balance

    def report(self) -> str:
        """The sum-over-ranks PStatPrint (SRC/util.c:538-630 at
        PROFlevel≥1): per-phase min/max/avg seconds + balance factor."""
        lines = ["**************************************************",
                 f"**** Cross-rank statistics over {self.n_ranks} "
                 "ranks ****",
                 f"    {'phase':<10s} {'min':>10s} {'max':>10s} "
                 f"{'avg':>10s} {'balance':>8s}"]
        for p in PHASES:
            s = self.utime[p]
            if s.max > 0 or self.ops[p].max > 0:
                lines.append(f"    {p:<10s} {s.min:10.4f} {s.max:10.4f} "
                             f"{s.avg:10.4f} {s.balance:8.2f}")
        for p in ("FACT", "SOLVE"):
            o = self.ops[p]
            t = self.utime[p]
            if o.total > 0 and t.max > 0:
                lines.append(f"    {p} flops {o.total:.6e}\t"
                             f"Mflops {o.total / t.max / 1e6:10.2f}")
        if self.tiny_pivots:
            lines.append(f"    tiny pivots replaced: {self.tiny_pivots}")
        if self.refine_steps:
            lines.append(f"    refinement steps: {self.refine_steps}")
        if self.peak_memory_bytes.max > 0:
            m = self.peak_memory_bytes
            lines.append(f"    peak device memory max {m.max / 1e6:.2f} MB"
                         f"  avg {m.avg / 1e6:.2f} MB")
        for op, d in self.comm.items():
            s = d["seconds"]
            lines.append(f"    comm {op:<12s} calls {d['calls']:6d}  "
                         f"{d['bytes'] / 1e6:10.3f} MB  "
                         f"max {s.max:8.4f} s  balance {s.balance:5.2f}")
        lines.append("**************************************************")
        return "\n".join(lines)
