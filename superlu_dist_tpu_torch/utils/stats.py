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
class Stats:
    utime: dict = field(default_factory=lambda: {p: 0.0 for p in PHASES})
    ops: dict = field(default_factory=lambda: {p: 0.0 for p in PHASES})
    tiny_pivots: int = 0          # reference: stat->TinyPivots (pdgstrf2.c:226)
    refine_steps: int = 0         # reference: stat->RefineSteps

    @contextlib.contextmanager
    def timer(self, phase: str):
        """TIC/TOC analog (util_dist.h:135-141).  The caller synchronizes
        the device inside the timed region where the phase ends in
        device work."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.utime[phase] = (self.utime.get(phase, 0.0)
                                 + time.perf_counter() - t0)

    def gflops(self, phase: str) -> float:
        t = self.utime.get(phase, 0.0)
        return (self.ops.get(phase, 0.0) / t / 1e9) if t > 0 else 0.0

    def report(self) -> str:
        """PStatPrint analog (SRC/util.c:484-534): phase times + Mflops."""
        lines = ["**** Time (seconds) ****"]
        for p in PHASES:
            if self.utime.get(p, 0.0) > 0 or self.ops.get(p, 0.0) > 0:
                lines.append(f"    {p:<10s} time {self.utime.get(p, 0.0):10.4f}")
        for p in ("FACT", "SOLVE"):
            if self.ops.get(p, 0.0) > 0:
                lines.append(f"    {p} flops {self.ops[p]:.6e}\t"
                             f"Mflops {self.gflops(p) * 1e3:10.2f}")
        if self.tiny_pivots:
            lines.append(f"    tiny pivots replaced: {self.tiny_pivots}")
        if self.refine_steps:
            lines.append(f"    refinement steps: {self.refine_steps}")
        return "\n".join(lines)
