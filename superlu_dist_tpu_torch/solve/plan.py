"""Solve plan: the sweep schedule of the device triangular solve.

A :class:`SolvePlan` lists the sweep batches of one factorization.  The
port builds it with the ``factor`` schedule only: each sweep batch is one
factor group, 1:1, so the solver reads the factor's panel stacks as they
are (``reuse``).  The JAX package's dataflow and level solve schedules,
its second shape-key alignment pass and its closed nrhs buckets are not
ported yet (ROADMAP.md).

Like the factor plan, everything here is host-side numpy, computed once
per factorization and reused across every subsequent solve (the
SolveInitialized discipline, pdgssvx.c:1330-1337).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from superlu_dist_tpu_torch.numeric.plan import FactorPlan


@dataclasses.dataclass
class SolveGroup:
    """One sweep batch: supernodes sharing a padded (W, U) solve shape;
    ``reuse`` names the factor group whose front arrays serve this batch
    as-is."""

    w: int                  # padded pivot width
    u: int                  # padded below-diagonal row count
    batch: int
    sns: np.ndarray         # supernode ids, slot order (ascending)
    ws: np.ndarray          # (batch,) real pivot widths
    reuse: int              # factor group to alias


@dataclasses.dataclass
class SolvePlan:
    """Sweep schedule for one factorization."""

    n: int
    sf: object                     # SymbolicFact (shared with the plan)
    groups: list                   # SolveGroups, forward-sweep order
    schedule: str                  # "factor"


def build_solve_plan(plan: FactorPlan,
                     schedule: str = "factor") -> SolvePlan:
    """Build the sweep schedule for a factor plan.  Pure numpy.
    ``schedule="factor"`` mirrors the factor grouping 1:1; the other
    schedules of the JAX package raise NotImplementedError."""
    if schedule != "factor":
        raise NotImplementedError(
            f"solve schedule {schedule!r} is not ported yet; the port "
            "solves with schedule='factor' (ROADMAP.md)")
    widths = np.diff(plan.sf.sn_start).astype(np.int64)
    groups = [SolveGroup(w=fg.w, u=fg.u, batch=len(fg.sns),
                         sns=np.asarray(fg.sns), ws=widths[fg.sns], reuse=g)
              for g, fg in enumerate(plan.groups)]
    return SolvePlan(n=plan.n, sf=plan.sf, groups=groups, schedule=schedule)
