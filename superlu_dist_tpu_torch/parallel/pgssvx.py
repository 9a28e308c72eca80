"""Multi-process expert driver over block-row distributed input.

Capability analog of pdgssvx with NR_loc input (SRC/pdgssvx.c:505): every
process holds a block of rows of A and of B (`DistributedCSR` — the
NRformat_loc analog), and all of them receive the solution.  Covers the
reference driver surface: multiple right-hand sides (nrhs ≥ 1, X returned
in B's shape), transpose solves (options.trans, pdgssvx.c's Trans
dispatch), and complex matrices (the pzgssvx twin — complex payloads ride
the f64 tree as re/im passes).

Port of the host-collective tier of the JAX package's
``parallel/pgssvx.py``: the analysis and the factorization run where the
card is — on the root rank, through the single-process ``gssvx`` — so the
distributed input is first assembled there, exactly like the reference's
pdCompRow_loc_to_CompCol_global gather before serial preprocessing
(pdgssvx.c:775).  The gather and the broadcasts ride the shared-memory
tree collectives (parallel/treecomm.py); refinement then runs distributed
(parallel/pgsrfs.py) so the residual work stays with the row owners —
the reference's pdgsrfs/pdgsmv shape.  ``device`` (None: the card)
matters only on the root: a rank that is not the root never touches
``torch.cuda``.  The mesh tier (``grid=``, ``replicate_analysis``,
``Options.par_symb_fact``: factors sharded over several devices) is not
ported (ROADMAP.md Queue 1 item 8) and raises NotImplementedError.

Payloads larger than the tree domain's max_len stream through in chunks
(TreeComm.bcast_any/reduce_sum_any); integer index arrays travel on the
f64 mantissa (exact below 2^53 — dimensions and nnz counts are far
below).

Collective discipline: every rank must reach the same TreeComm
collective sequence, and SLU_TPU_VERIFY_COLLECTIVES=1 verifies it at run
time: each collective then cross-checks a (call-site, op, shape/dtype,
seq) digest across ranks and raises CollectiveMismatchError naming the
divergent sites instead of deadlocking.  Every root-serial section runs
through :func:`bcast_result`, so an exception on the root is raised on
every rank instead of stranding the peers in a broadcast.
"""

from __future__ import annotations

import dataclasses
import pickle
import time

import numpy as np

from superlu_dist_tpu_torch.parallel.dist import DistributedCSR
from superlu_dist_tpu_torch.parallel.treecomm import TreeComm
from superlu_dist_tpu_torch.sparse.formats import SparseCSR
from superlu_dist_tpu_torch.utils.errors import SuperLUError

#: the escalation rung's factor precision (a real name: complex values
#: take complex128, utils/options.resolve_factor_dtype)
HIPREC = "float64"

_MESH_TIER = ("belongs to the mesh tier (factors sharded over several "
              "devices), which is not ported (ROADMAP.md Queue 1 item 8)")


def gather_distributed(tc: TreeComm, a_loc: DistributedCSR,
                       root: int = 0) -> SparseCSR | None:
    """Assemble the global CSR on `root` from every rank's block rows —
    the pdCompRow_loc_to_CompCol_global analog over tree collectives.
    Returns the matrix on root, None elsewhere."""
    n = a_loc.n
    # global nnz offsets: every rank's count, allreduced
    counts = np.zeros(tc.n_ranks)
    counts[tc.rank] = a_loc.nnz_loc
    counts = tc.allreduce_sum_any(counts, root=root)
    offs = np.zeros(tc.n_ranks + 1, dtype=np.int64)
    offs[1:] = np.cumsum(counts).astype(np.int64)
    total = int(offs[-1])
    lo = int(offs[tc.rank])

    # row counts (for indptr) and flat index/value arrays, disjoint slots
    rowcnt = np.zeros(n)
    rowcnt[a_loc.fst_row:a_loc.fst_row + a_loc.m_loc] = \
        np.diff(a_loc.indptr)
    rowcnt = tc.reduce_sum_any(rowcnt, root=root)
    idx = np.zeros(total)
    idx[lo:lo + a_loc.nnz_loc] = a_loc.indices
    idx = tc.reduce_sum_any(idx, root=root)
    vdtype = (np.complex128 if np.issubdtype(np.asarray(a_loc.data).dtype,
                                             np.complexfloating)
              else np.float64)
    vals = np.zeros(total, dtype=vdtype)
    vals[lo:lo + a_loc.nnz_loc] = a_loc.data
    vals = tc.reduce_sum_any(vals, root=root)

    if tc.rank != root:
        return None
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(rowcnt).astype(np.int64)
    # ranks hold contiguous ascending row blocks, so the flat order by
    # rank offset IS row order
    return SparseCSR(n, n, indptr, idx.astype(np.int64), vals)


def _finish_stats(tc: TreeComm, lu_out):
    """Cross-rank stat epilogue — COLLECTIVE: every rank calls it at the
    same point, with NO dependence on per-rank ``lu_out`` presence (which
    may legitimately diverge across ranks).  Snapshots this rank's comm
    counters into its Stats, allreduces the fixed-layout stat vectors,
    and hands every rank the same StatsSummary: per-phase min/max/avg +
    load-balance factor — the sum-over-ranks PStatPrint the reference
    prints at PROFlevel≥1 (SRC/util.c:538-630).  ``SLU_TPU_STATS=1``
    prints the reduced report once, on rank 0."""
    from superlu_dist_tpu_torch.obs.metrics import get_metrics
    from superlu_dist_tpu_torch.utils.options import env_flag
    from superlu_dist_tpu_torch.utils.stats import Stats

    stats = (lu_out or {}).get("stats")
    if stats is None:
        stats = Stats()
    stats.attach_comm(tc.comm_stats)
    summary = stats.reduce(tc)
    if lu_out is not None:
        lu_out["stats_summary"] = summary
    # serving metrics: cross-rank aggregation rides the same epilogue
    # (SLU_TPU_METRICS is env-driven, hence identical on every rank —
    # the branch is collective-safe)
    m = get_metrics()
    if m.enabled:
        reduced = m.reduce(tc)
        if lu_out is not None:
            lu_out["metrics_summary"] = reduced
    if env_flag("SLU_TPU_STATS") and tc.rank == 0:
        print(summary.report())
    return summary


class RootError(SuperLUError):
    """An exception raised on the root inside :func:`bcast_result` that
    does not survive a pickle round trip (a structured error whose
    constructor takes its evidence positionally): the peers raise this,
    naming the root's error type and message."""


def _shippable(exc: Exception) -> Exception:
    try:
        pickle.loads(pickle.dumps(exc, protocol=pickle.HIGHEST_PROTOCOL))
        return exc
    except Exception:
        return RootError(f"{type(exc).__name__} on the root: {exc}")


def bcast_result(tc: TreeComm, fn, root: int = 0):
    """Run `fn()` on `root` and broadcast its result; a root-side
    exception is SHIPPED and re-raised on every rank (the root raises
    its own, traceback and all) instead of leaving the peers deadlocked
    in the broadcast (every root-serial section of the distributed tier
    routes through this)."""
    payload = None
    root_exc = None
    if tc.rank == root:
        try:
            payload = (None, fn())
        except Exception as exc:
            root_exc = exc
            payload = (_shippable(exc), None)
    err, result = tc.bcast_obj(payload, root=root)
    if root_exc is not None:
        raise root_exc
    if err is not None:
        raise err
    return result


def root_analyze_bcast(tc: TreeComm, options, a_loc: DistributedCSR,
                       stats, lu=None, device=None):
    """Gather the distributed rows on root, run the serial analysis
    there (honoring `lu` Fact-reuse), and broadcast the analyzed
    skeleton STRIPPED of the global matrix and the symmetrized-pattern
    copies (restored on root afterwards — they only serve future
    SamePattern reuse checks there).  Returns (lu, bvals) on every
    rank; the skeleton records the root's ``device`` (None: the card),
    and no rank touches it here."""
    from superlu_dist_tpu_torch.drivers.gssvx import analyze

    a_root = gather_distributed(tc, a_loc, root=0)
    box = {}

    def _analyze():
        lu2, bvals, _ = analyze(options, a_root,
                                device="cuda" if device is None else device,
                                lu=lu, stats=stats)
        lu2.a = None
        box["sym"] = (lu2.a_sym_indptr, lu2.a_sym_indices)
        lu2.a_sym_indptr = lu2.a_sym_indices = None
        return lu2, bvals

    lu2, bvals = bcast_result(tc, _analyze)
    if tc.rank == 0:
        lu2.a_sym_indptr, lu2.a_sym_indices = box["sym"]
    return lu2, bvals


def pgssvx(tc: TreeComm, options, a_loc: DistributedCSR,
           b_loc: np.ndarray, root: int = 0, grid=None, lu=None,
           lu_out=None, replicate_analysis: bool = False,
           resume_from: str | None = None, device=None):
    """Collectively solve op(A)·X = B from block-row distributed input.

    b_loc: (m_loc,) or (m_loc, nrhs) — this rank's block rows of B.
    Returns (x, info) on every rank, x of shape (n,) or (n, nrhs)
    matching b_loc, the same on every rank.  options.trans selects op(A)
    (NOTRANS/TRANS/CONJ, the reference's pdgssvx trans dispatch);
    complex A/b take the pzgssvx path.

    The root gathers the rows, runs ``gssvx`` with NOREFINE on
    ``device`` (None: the card; ignored on the other ranks) and
    broadcasts x0; every rank then refines with ``pgsrfs``, its residual
    computed over its own rows.  `grid`, `replicate_analysis` and
    ``options.par_symb_fact`` select the mesh tier, which is not ported:
    NotImplementedError on every rank, before any collective.

    `lu_out`: optional dict; on return, lu_out["lu"] holds the root's
    LUFactorization handle (the reference's caller-owned LUstruct; only
    the root has one) and lu_out["stats"] its Stats; on every rank
    lu_out["stats_summary"] (the cross-rank StatsSummary),
    lu_out["solve_report"] (the distributed refinement's SolveReport)
    and lu_out["timings"] (this rank's gather and refinement seconds).

    `lu`: the root's prior handle (its lu_out["lu"] from an earlier
    call; None elsewhere) activating options.fact's reuse tiers on the
    distributed input, the reference's time-stepping loop over NR_loc
    (EXAMPLE/pddrive1.c, pdgssvx.c Fact dispatch): SamePattern /
    SamePattern_SameRowPerm reuse the analysis products and refactor
    with the new values; FACTORED skips straight to the solve on the
    existing factors.

    `resume_from` names a durable factor-checkpoint frontier
    (persist/checkpoint.py) for the root factorization — the
    rank-failure recovery path (parallel/recover.py,
    Options.ft="shrink"/"respawn") threads the previous epoch's
    checkpoint directory through here so the surviving ranks complete
    the factorization instead of redoing it.  Rank failure itself
    surfaces here as RankFailureError on EVERY surviving rank (the
    bounded-wait collectives + failure detector in parallel/treecomm.py)
    once SLU_TPU_COMM_TIMEOUT_S is armed; this driver never retries on
    its own: recovery policy lives in parallel/recover.pgssvx_ft.

    Solve health: when refinement ran, lu_out["solve_report"] carries
    berr (+ history) from the distributed loop; if it stagnated above
    the recovery target and options.recovery is enabled, ONE escalated
    retry at float64 factors runs collectively (the decision is taken
    from allreduced quantities and the root's broadcast, so every rank
    agrees) and is recorded as the ``distributed-hiprec`` rung.
    """
    from superlu_dist_tpu_torch.drivers.gssvx import (_escalation_dtype,
                                                      gssvx)
    from superlu_dist_tpu_torch.utils.errors import CheckpointError
    from superlu_dist_tpu_torch.utils.options import (IterRefine, Trans,
                                                      check_ft)

    if grid is not None or replicate_analysis or \
            getattr(options, "par_symb_fact", False):
        raise NotImplementedError(f"pgssvx's grid=, replicate_analysis and "
                                  f"Options.par_symb_fact: {_MESH_TIER}")
    check_ft(options)
    n = a_loc.n
    b_loc = np.asarray(b_loc)
    one_d = b_loc.ndim == 1
    # NOT reshape(m_loc, -1): on an empty trailing block (m_loc == 0,
    # legitimate from distribute_rows' ceil stepping) reshape(0, -1)
    # raises and the surviving ranks would deadlock in the collectives
    b2 = b_loc[:, None] if one_d else b_loc
    nrhs = b2.shape[1]
    complex_in = (np.issubdtype(np.asarray(a_loc.data).dtype,
                                np.complexfloating)
                  or np.issubdtype(b2.dtype, np.complexfloating))
    wdtype = np.complex128 if complex_in else np.float64

    t0 = time.perf_counter()
    a_root = gather_distributed(tc, a_loc, root=root)
    b_full = np.zeros((n, nrhs), dtype=wdtype)
    b_full[a_loc.fst_row:a_loc.fst_row + a_loc.m_loc] = b2
    b_full = tc.reduce_sum_any(b_full, root=root)
    gather_s = time.perf_counter() - t0

    # refinement happens distributed below — the root factors and solves
    # only.  While it follows, the root's single-process ladder is off:
    # the distributed loop is the gate, and _maybe_escalate_distributed
    # its rung (on the card the root's NOREFINE probe would otherwise
    # refactor at the next GEMM tier and refine on the root alone)
    opts0 = dataclasses.replace(options, iter_refine=IterRefine.NOREFINE)
    if options.iter_refine != IterRefine.NOREFINE:
        opts0 = dataclasses.replace(
            opts0, recovery=dataclasses.replace(options.recovery,
                                                enabled=False))
    box = {}

    def _root_solve():
        rhs = b_full if nrhs > 1 else b_full[:, 0]
        try:
            x_r, lu_r, stats, info_r = gssvx(opts0, a_root, rhs,
                                             device=device, lu=lu,
                                             resume_from=resume_from)
        except CheckpointError:
            # an unusable recovery frontier (corrupt / wrong plan) must
            # degrade to a from-scratch factorization, not strand the
            # peers: the retry is root-LOCAL and leaves the collective
            # sequence untouched
            x_r, lu_r, stats, info_r = gssvx(opts0, a_root, rhs,
                                             device=device, lu=lu)
        box.update(lu=lu_r, stats=stats)
        if info_r != 0:
            return int(info_r), False
        box["x0"] = np.asarray(x_r, dtype=wdtype).reshape(n, nrhs)
        return 0, _escalation_dtype(lu_r.numeric.dtype) is not None

    info, can_escalate = bcast_result(tc, _root_solve, root=root)
    solve_fn = None
    if tc.rank == root:
        if lu_out is not None:
            lu_out["lu"] = box["lu"]
            lu_out["stats"] = box["stats"]
        if info == 0:
            lu_r = box["lu"]
            trans = getattr(options, "trans", Trans.NOTRANS)
            if trans == Trans.NOTRANS:
                solve_fn = lu_r.solve_factored
            else:
                conj = trans == Trans.CONJ
                solve_fn = (lambda r:
                            lu_r.solve_factored_trans(r, conj=conj))
    if info != 0:
        return None, info
    x0 = box["x0"] if tc.rank == root else np.zeros((n, nrhs), dtype=wdtype)
    x0 = tc.bcast_any(x0, root=root)
    t0 = time.perf_counter()
    x, info_out, rep = _refine_tail(tc, options, a_loc, b2, x0, solve_fn,
                                    root, one_d, nrhs, lu_out=lu_out)
    if lu_out is not None:
        lu_out["timings"] = {"gather_s": gather_s,
                             "refine_s": time.perf_counter() - t0}
    x, info_out = _maybe_escalate_distributed(
        tc, options, a_loc, b_loc, x, info_out, rep, lu_out, root=root,
        can_escalate=can_escalate, device=device)
    _finish_stats(tc, lu_out)
    return x, info_out


def _refine_tail(tc, options, a_loc, b2, x0, solve_fn, root, one_d, nrhs,
                 lu_out=None):
    """Distributed refinement over the RHS columns; returns
    (x, info, SolveReport-or-None).  The report is identical on every
    rank (built from allreduced berr values), so callers may branch on
    it collectively."""
    from superlu_dist_tpu_torch.parallel.pgsrfs import pgsrfs
    from superlu_dist_tpu_torch.utils.options import IterRefine, Trans
    rep = None
    if options.iter_refine == IterRefine.NOREFINE:
        x = x0
    else:
        # per-RHS distributed refinement (the reference's pdgsrfs loops
        # RHS columns with per-RHS berr, pdgsrfs.c:205-235)
        trans = getattr(options, "trans", Trans.NOTRANS)
        cols = []
        rhs_stats = []
        for j in range(nrhs):
            so = {}
            cols.append(pgsrfs(tc, a_loc, b2[:, j], x0[:, j], solve_fn,
                               root=root, trans=trans, stats_out=so))
            rhs_stats.append(so)
        x = np.stack(cols, axis=1)
        rep = _attach_distributed_report(options, rhs_stats, x,
                                         lu_out=lu_out)
    return (x[:, 0] if one_d else x), 0, rep


def _attach_distributed_report(options, rhs_stats, x, lu_out=None):
    """Build the SolveReport of a distributed refinement (every rank sees
    the same allreduced berr values, so every rank builds the same
    report) and attach it to the Stats handed back via lu_out."""
    from superlu_dist_tpu_torch.utils.stats import SolveReport
    berrs = [s["berr"] for s in rhs_stats if s.get("berr") is not None]
    target = (options.recovery.berr_target
              or 10.0 * float(np.finfo(np.float64).eps))
    rep = SolveReport(
        berr=max(berrs) if berrs else None,
        berr_history=[b for s in rhs_stats for b in s.get("berrs", [])],
        target=target,
        finite=bool(np.all(np.isfinite(x))),
        residual_route="host")
    rep.refine_steps = sum(s.get("iters", 0) for s in rhs_stats)
    rep.converged = rep.berr is not None and rep.berr <= target
    stats = lu_out.get("stats") if lu_out is not None else None
    if stats is not None:
        # the root factorization's NOREFINE report carries the
        # factorization facts; the distributed refinement supersedes it
        # but inherits them
        prev = stats.solve_report
        if prev is not None:
            rep.tiny_pivots = prev.tiny_pivots
            rep.factor_dtype = prev.factor_dtype
            rep.gemm_precision = prev.gemm_precision
            rep.solve_route = prev.solve_route
            rep.rcond = prev.rcond
        stats.solve_report = rep
    if lu_out is not None:
        lu_out["solve_report"] = rep
    return rep


def _maybe_escalate_distributed(tc, options, a_loc, b_loc, x, info, rep,
                                lu_out, root=0, can_escalate=False,
                                device=None):
    """One collective escalation rung for the distributed driver: when
    the distributed refinement stagnated above the recovery target,
    rerun the whole flow at float64 factors.  Every input to the
    decision (the report's berr/target, the shared options, the root's
    broadcast ``can_escalate``: its factors were below float64) is
    replicated, so all ranks take the same branch — rank-divergent
    control flow here would strand peers in the collectives (which is
    also why the decision must NOT depend on per-rank lu_out presence)."""
    from superlu_dist_tpu_torch.utils.options import Fact, IterRefine
    from superlu_dist_tpu_torch.utils.stats import RungRecord

    recovery = options.recovery
    if (info != 0 or rep is None or rep.converged
            or not recovery.enabled
            or options.iter_refine == IterRefine.NOREFINE
            or not can_escalate):
        return x, info
    opts2 = dataclasses.replace(
        options, fact=Fact.DOFACT, factor_dtype=HIPREC,
        recovery=dataclasses.replace(recovery, enabled=False))
    lu_out2 = {}
    x2, info2 = pgssvx(tc, opts2, a_loc, b_loc, root=root, lu_out=lu_out2,
                       device=device)
    rep2 = lu_out2.get("solve_report")
    berr2 = rep2.berr if rep2 is not None and rep2.berr is not None \
        else float("inf")
    rung = RungRecord(name="distributed-hiprec", detail=HIPREC,
                      berr_before=rep.berr, berr_after=berr2)
    rep.rungs.append(rung)
    if info2 == 0 and berr2 < rep.berr:
        rep.berr = berr2
        rep.berr_history.extend(rep2.berr_history if rep2 else [])
        rep.converged = berr2 <= rep.target
        rep.finite = bool(np.all(np.isfinite(x2)))
        if lu_out is not None:
            # the answer now rests on the escalated factors/handle
            lu_out.update(lu_out2)
            lu_out["solve_report"] = rep
        return x2, info2
    return x, info
