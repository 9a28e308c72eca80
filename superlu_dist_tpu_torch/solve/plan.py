"""Solve plan: the sweep schedule of the device triangular solve.

Port of the JAX package's ``solve/plan.py``.  A :class:`SolvePlan` is built
on a finished :class:`~superlu_dist_tpu_torch.numeric.plan.FactorPlan`:

* **Cross-level batching** — the factor scheduler's own
  ``_dataflow_batches`` (dependency = the supernode etree) regroups
  supernodes into maximal same-shape sweep batches, unconstrained by the
  factor window: the solve holds no Schur pool, so the look-ahead window
  defaults to unbounded (``window=0``).
* **Shape-key alignment** — ``_align_shape_keys`` runs again on top of
  the factor keys (``align``, 1.25): the solve executes O(w² + wu) per
  front where the factor executes O(w²·m), so it can coalesce more.
  Members promoted to a larger key get identity/zero padding when the
  solver gathers their panels (solve/device.py).
* **Bounded nrhs buckets** — a CLOSED bucket set: power-of-two rungs up
  to 64, then geometric growth (``nrhs_growth``) rounded to multiples of
  32, up to ``nrhs_max``.  Wider right-hand sides are column-chunked at
  the cap (:func:`chunk_nrhs`), so the set of sweep programs — on the
  card, captured CUDA graphs — is bounded whatever the traffic.

Schedules: ``dataflow`` (default) | ``level`` (strict level lockstep) |
``factor`` (mirror the factor grouping 1:1).  The JAX package's
environment knobs (SLU_TPU_SOLVE_SCHEDULE, _WINDOW, _ALIGN, _NRHS_MAX,
_NRHS_GROWTH) are keyword arguments here, with the same defaults.

Like the factor plan, everything here is host-side numpy, computed once
per factorization and reused across every subsequent solve (the
SolveInitialized discipline, pdgssvx.c:1330-1337).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from superlu_dist_tpu_torch.numeric.plan import (
    FactorPlan, _align_shape_keys, _dataflow_batches, _level_batches)

#: nrhs values below the geometric regime get exact power-of-two rungs —
#: single-vector and small-batch solves are the latency-critical serving
#: shapes and must not pad at all.
_POW2_RUNGS = (1, 2, 4, 8, 16, 32, 64)


def nrhs_buckets(max_bucket: int, growth: float) -> tuple:
    """The closed nrhs bucket set: power-of-two up to 64, then geometric
    (factor ``growth``, rounded up to a multiple of 32), capped at
    ``max_bucket`` which is always the largest member."""
    max_bucket = max(int(max_bucket), 1)
    growth = max(float(growth), 1.01)
    sizes = {b for b in _POW2_RUNGS if b <= max_bucket}
    s = 64
    while s < max_bucket:
        s = int(np.ceil(s * growth / 32.0) * 32)
        sizes.add(min(s, max_bucket))
    sizes.add(max_bucket)
    return tuple(sorted(sizes))


def bucket_nrhs(k: int, buckets: tuple) -> int:
    """Smallest bucket >= k (k must be <= the cap — see chunk_nrhs)."""
    for b in buckets:
        if b >= k:
            return b
    raise ValueError(f"nrhs {k} exceeds the bucket cap {buckets[-1]} — "
                     "chunk_nrhs() the columns first")


def chunk_nrhs(k: int, buckets: tuple) -> list:
    """Split k right-hand-side columns into ``[(lo, hi, bucket), ...]``
    chunks: full chunks of the cap bucket, then one bucketed remainder.
    The compiled-kernel set stays bounded by the bucket set regardless
    of the request width."""
    cap = buckets[-1]
    out = []
    lo = 0
    while k - lo > cap:
        out.append((lo, lo + cap, cap))
        lo += cap
    if k - lo > 0 or not out:
        out.append((lo, k, bucket_nrhs(max(k - lo, 1), buckets)))
    return out


@dataclasses.dataclass
class SolveGroup:
    """One sweep batch: supernodes sharing a padded (W, U) solve shape.

    ``src_group``/``src_slot`` locate each member's factored panels
    inside the FACTOR plan's front arrays; ``reuse`` names the factor
    group whose front arrays can serve this batch as-is (same members,
    same order, same shape — the zero-copy fast path), or -1 when the
    solver must gather (and possibly pad) a fresh panel stack."""

    level: int
    m: int                  # padded front size (w + u)
    w: int                  # padded pivot width
    u: int                  # padded below-diagonal row count
    batch: int
    sns: np.ndarray         # supernode ids, slot order (ascending)
    ws: np.ndarray          # (batch,) real pivot widths
    src_group: np.ndarray   # (batch,) factor group of each member
    src_slot: np.ndarray    # (batch,) slot within that factor group
    reuse: int = -1         # factor group to alias, or -1 => gather


@dataclasses.dataclass
class SolvePlan:
    """Sweep schedule + nrhs bucket geometry for one factorization."""

    n: int
    sf: object                     # SymbolicFact (shared with the plan)
    groups: list                   # SolveGroups, forward-sweep order
    schedule: str                  # "dataflow" | "level" | "factor"
    window: int
    align: float
    nrhs_bucket_set: tuple
    n_factor_groups: int           # the factor grouping's dispatch count
    critical_path: int             # longest dependent-group chain
    flops_per_rhs: float           # structural sweep flops per rhs column
    executed_flops_per_rhs: float  # shape-padded flops per PADDED column

    @property
    def mean_occupancy(self) -> float:
        return (self.sf.n_supernodes / len(self.groups)
                if self.groups else 0.0)

    def solve_flops(self, nrhs: int) -> float:
        """Structural flops of one solve with nrhs columns (the honest
        numerator for solve GFLOP/s)."""
        return self.flops_per_rhs * nrhs

    def executed_flops(self, nrhs: int) -> float:
        """Executed flops including BOTH paddings: shape padding (every
        front runs at its bucket (W, U)) and nrhs padding (every chunk
        runs at its bucket width), as the factor path reports executed
        beside structural flops."""
        kb = sum(b for _, _, b in chunk_nrhs(int(nrhs),
                                             self.nrhs_bucket_set))
        return self.executed_flops_per_rhs * kb

    def padding_factor(self, nrhs: int) -> float:
        return self.executed_flops(nrhs) / max(self.solve_flops(nrhs), 1.0)

    def schedule_stats(self, nrhs: int | None = None) -> dict:
        """Telemetry block (the FactorPlan.schedule_stats twin): group
        count vs the factor grouping, occupancy, critical path, shape
        padding — plus, when ``nrhs`` is given, the full nrhs-inclusive
        padding factor and the chunked bucket widths."""
        out = {
            "schedule": self.schedule,
            "n_groups": len(self.groups),
            "n_factor_groups": self.n_factor_groups,
            "occupancy": round(self.mean_occupancy, 2),
            "window": self.window,
            "align": self.align,
            "critical_path": self.critical_path,
            "nrhs_buckets": list(self.nrhs_bucket_set),
            "shape_padding": round(
                self.executed_flops_per_rhs / max(self.flops_per_rhs, 1.0),
                4),
            "reused_groups": sum(1 for g in self.groups if g.reuse >= 0),
        }
        if nrhs is not None:
            out["nrhs"] = int(nrhs)
            out["padded_nrhs"] = sum(
                b for _, _, b in chunk_nrhs(int(nrhs),
                                            self.nrhs_bucket_set))
            out["padding_factor"] = round(self.padding_factor(nrhs), 4)
        return out


def _factor_keys(plan: FactorPlan):
    """Per-supernode (W, U) padded shape keys as the factor plan
    assigned them (bucketing and alignment already folded in)."""
    ns = plan.sf.n_supernodes
    gw = np.array([g.w for g in plan.groups], dtype=np.int64)
    gu = np.array([g.u for g in plan.groups], dtype=np.int64)
    return gw[plan.sn_group[:ns]], gu[plan.sn_group[:ns]]


def build_solve_plan(plan: FactorPlan, schedule: str = "dataflow",
                     window: int = 0, align: float = 1.25,
                     nrhs_max: int = 1024,
                     nrhs_growth: float = 1.5) -> SolvePlan:
    """Build the sweep schedule for a factor plan.  Pure numpy.

    ``schedule``: "dataflow" (cross-level batches, look-ahead ``window``
    levels, 0 = unbounded), "level" (level lockstep) or "factor" (the
    factor grouping 1:1; alignment is then a no-op by construction — the
    panels are served from the factor fronts unchanged).  ``align`` is
    the solve-side shape-key coalescing tolerance (<= 1 disables);
    ``nrhs_max``/``nrhs_growth`` set the bucket geometry."""
    if schedule not in ("dataflow", "level", "factor"):
        raise ValueError(
            f"solve schedule must be 'dataflow', 'level' or 'factor', got "
            f"{schedule!r}")
    buckets = nrhs_buckets(nrhs_max, nrhs_growth)

    sf = plan.sf
    ns = sf.n_supernodes
    widths = np.diff(sf.sn_start).astype(np.int64)
    us = np.array([len(r) for r in sf.sn_rows], dtype=np.int64)

    if schedule == "factor":
        batches = [(g.level, g.sns) for g in plan.groups]
        sn_W, sn_U = _factor_keys(plan)
    else:
        sn_W, sn_U = _factor_keys(plan)
        sn_W, sn_U = _align_shape_keys(sn_W, sn_U, float(align))
        if schedule == "dataflow":
            batches = _dataflow_batches(sf, sn_W, sn_U, int(window))
        else:
            batches = _level_batches(sf, sn_W, sn_U)

    groups: list[SolveGroup] = []
    for lvl, sns in batches:
        s0 = int(sns[0])
        W, U = int(sn_W[s0]), int(sn_U[s0])
        src_group = plan.sn_group[sns]
        src_slot = plan.sn_slot[sns]
        # zero-copy aliasing: this batch IS a factor group, same member
        # order, same padded shape — the common case whenever the solve
        # schedule reproduces the factor one (and always under "factor")
        reuse = -1
        g0 = int(src_group[0])
        fg = plan.groups[g0]
        if ((fg.w, fg.u) == (W, U) and len(fg.sns) == len(sns)
                and np.array_equal(fg.sns, sns)):
            reuse = g0
        groups.append(SolveGroup(
            level=int(lvl), m=W + U, w=W, u=U, batch=len(sns), sns=sns,
            ws=widths[sns], src_group=src_group, src_slot=src_slot,
            reuse=reuse))

    # dependent-group critical path — the serial depth of one sweep
    # (same recurrence as FactorPlan's)
    pdepth = np.zeros(ns, dtype=np.int64)
    critical_path = 0
    for grp in groups:
        d = int(pdepth[grp.sns].max(initial=0)) + 1
        critical_path = max(critical_path, d)
        pg = sf.sn_parent[grp.sns]
        valid = pg >= 0
        if valid.any():
            np.maximum.at(pdepth, pg[valid], d)

    # flops per rhs column: one triangular solve (w²) + one gemv (2wu)
    # per front per sweep, forward (L) and backward (U) — structural at
    # real (w, u), executed at the padded batch shapes
    structural = float(np.sum(2.0 * widths * widths
                              + 4.0 * widths * us))
    executed = float(sum(g.batch * (2.0 * g.w * g.w + 4.0 * g.w * g.u)
                         for g in groups))
    return SolvePlan(
        n=plan.n, sf=sf, groups=groups, schedule=schedule,
        window=int(window), align=float(align), nrhs_bucket_set=buckets,
        n_factor_groups=len(plan.groups), critical_path=critical_path,
        flops_per_rhs=structural, executed_flops_per_rhs=executed)
