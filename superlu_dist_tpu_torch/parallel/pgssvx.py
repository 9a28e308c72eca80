"""Multi-process expert driver over block-row distributed input.

Capability analog of pdgssvx with NR_loc input (SRC/pdgssvx.c:505): every
process holds a block of rows of A and of B (`DistributedCSR` — the
NRformat_loc analog), and all of them receive the solution.  Covers the
reference driver surface: multiple right-hand sides (nrhs ≥ 1, X returned
in B's shape), transpose solves (options.trans, pdgssvx.c's Trans
dispatch), and complex matrices (the pzgssvx twin — complex payloads ride
the f64 tree as re/im passes).

Port of the JAX package's ``parallel/pgssvx.py``.  Without a grid (the
host-collective tier) the analysis and the factorization run where the
card is — on the root rank, through the single-process ``gssvx`` — so the
distributed input is first assembled there, exactly like the reference's
pdCompRow_loc_to_CompCol_global gather before serial preprocessing
(pdgssvx.c:775).  The gather and the broadcasts ride the shared-memory
tree collectives (parallel/treecomm.py); refinement then runs distributed
(parallel/pgsrfs.py) so the residual work stays with the row owners —
the reference's pdgsrfs/pdgsmv shape.  ``device`` (None: the card)
matters only on the root: a rank that is not the root never touches
``torch.cuda``.

With ``grid=`` (parallel/grid.ProcessGrid over the same processes) the
mesh tier runs instead (``_pgssvx_mesh``): the root analyzes once and
broadcasts the skeleton (or every rank analyzes, ``replicate_analysis``,
or the ordering and symbolic run distributed, ``Options.par_symb_fact``:
parallel/panalysis.py), then every rank factors its own slots on its
device (parallel/spmd.py) and the solves and the refinement's corrections
run collectively on the sharded factors: no rank ever holds them whole.

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

from superlu_dist_tpu_torch.parallel.dist import DistributedCSR, ShardedSpMV
from superlu_dist_tpu_torch.parallel.treecomm import TreeComm
from superlu_dist_tpu_torch.sparse.formats import SparseCSR
from superlu_dist_tpu_torch.utils.errors import SuperLUError

#: the escalation rung's factor precision (a real name: complex values
#: take complex128, utils/options.resolve_factor_dtype)
HIPREC = "float64"

def gather_distributed(tc: TreeComm, a_loc: DistributedCSR,
                       root: int = 0,
                       all_ranks: bool = False) -> SparseCSR | None:
    """Assemble the global CSR on `root` from every rank's block rows —
    the pdCompRow_loc_to_CompCol_global analog over tree collectives.
    Returns the matrix on root, None elsewhere.  all_ranks=True assembles
    on EVERY rank (all-reduce instead of reduce): the analysis input of
    the mesh tier's replicate_analysis."""
    n = a_loc.n
    # global nnz offsets: every rank's count, allreduced
    counts = np.zeros(tc.n_ranks)
    counts[tc.rank] = a_loc.nnz_loc
    counts = tc.allreduce_sum_any(counts, root=root)
    offs = np.zeros(tc.n_ranks + 1, dtype=np.int64)
    offs[1:] = np.cumsum(counts).astype(np.int64)
    total = int(offs[-1])
    lo = int(offs[tc.rank])
    _reduce = tc.allreduce_sum_any if all_ranks else tc.reduce_sum_any

    # row counts (for indptr) and flat index/value arrays, disjoint slots
    rowcnt = np.zeros(n)
    rowcnt[a_loc.fst_row:a_loc.fst_row + a_loc.m_loc] = \
        np.diff(a_loc.indptr)
    rowcnt = _reduce(rowcnt, root=root)
    idx = np.zeros(total)
    idx[lo:lo + a_loc.nnz_loc] = a_loc.indices
    idx = _reduce(idx, root=root)
    vdtype = (np.complex128 if np.issubdtype(np.asarray(a_loc.data).dtype,
                                             np.complexfloating)
              else np.float64)
    vals = np.zeros(total, dtype=vdtype)
    vals[lo:lo + a_loc.nnz_loc] = a_loc.data
    vals = _reduce(vals, root=root)

    if not all_ranks and tc.rank != root:
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
    and no rank touches it here.  Where the root's analysis reused the
    prior handle's plan (the SamePattern tiers), a rank with its own
    prior handle keeps that handle's plan and symbolic structure."""
    from superlu_dist_tpu_torch.drivers.gssvx import analyze

    a_root = gather_distributed(tc, a_loc, root=0)
    box = {}

    def _analyze():
        lu2, bvals, _ = analyze(options, a_root,
                                device="cuda" if device is None else device,
                                lu=lu, stats=stats)
        reused = lu is not None and lu2.plan is lu.plan
        lu2.a = None
        box["sym"] = (lu2.a_sym_indptr, lu2.a_sym_indices)
        lu2.a_sym_indptr = lu2.a_sym_indices = None
        return lu2, bvals, reused

    lu2, bvals, reused = bcast_result(tc, _analyze)
    if tc.rank == 0:
        lu2.a_sym_indptr, lu2.a_sym_indices = box["sym"]
    elif reused and lu is not None:
        # the root reused its structure: so does this rank, keeping its
        # own plan object — the executors cached on it (a grid graph
        # executor's captured segments) serve the refactor
        lu2.plan, lu2.sf = lu.plan, lu.sf
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
    computed over its own rows.

    `grid` (a parallel.grid.ProcessGrid whose ranks are this TreeComm's,
    each on its own device, ``grid.device``) selects the mesh tier, the
    distributed-factors tier: rank 0 gathers the rows and runs the host
    analysis once, and broadcasts the analyzed skeleton (plan + symbolic
    index maps + permuted values, O(nnz) data) — no other rank assembles
    the matrix; ``replicate_analysis=True`` has every rank assemble and
    analyze instead (the A/B reference), ``options.par_symb_fact`` runs
    the ordering and symbolic distributed (parallel/panalysis.py).  Every
    rank then factors its own block-cyclic slots of each group
    (parallel/spmd.py), keeps them, and the solves and refinement
    corrections run collectively on the sharded factors (the reference's
    NR_loc-in, distributed-factors-out property, SRC/pdgssvx.c:505 /
    pddistribute.c:322).  On that tier every rank has a handle, and
    FACTORED needs every rank's.

    `lu_out`: optional dict; on return, lu_out["lu"] holds the root's
    LUFactorization handle (the reference's caller-owned LUstruct; only
    the root has one — on the mesh tier every rank's own) and
    lu_out["stats"] its Stats; on every rank
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

    check_ft(options)
    if grid is None and (replicate_analysis
                         or getattr(options, "par_symb_fact", False)):
        raise SuperLUError("replicate_analysis and Options.par_symb_fact "
                           "choose the mesh tier's analysis: pass grid=")
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

    if grid is not None:
        x, info, rep, can_escalate = _pgssvx_mesh(
            tc, options, a_loc, b2, grid, one_d, wdtype, lu=lu,
            lu_out=lu_out, replicate_analysis=replicate_analysis,
            device=device)
        x, info = _maybe_escalate_distributed(
            tc, options, a_loc, b_loc, x, info, rep, lu_out,
            can_escalate=can_escalate, grid=grid,
            replicate_analysis=replicate_analysis)
        # cross-rank stat reduction (collective; the escalation decision
        # above is replicated, so every rank reaches this together)
        _finish_stats(tc, lu_out)
        return x, info

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
            # sequence untouched (gssvx without grid= runs no
            # collective; the linter sees the grid path's)
            x_r, lu_r, stats, info_r = gssvx(  # slulint: disable=SLU101
                opts0, a_root, rhs, device=device, lu=lu)
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
                 lu_out=None, collective_solve=False, spmv=None, stats=None):
    """Distributed refinement over the RHS columns; returns
    (x, info, SolveReport-or-None).  The report is identical on every
    rank (built from allreduced berr values), so callers may branch on
    it collectively.  ``spmv``: the mesh tier's residual operator
    (``pgsrfs``)."""
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
                               root=root, trans=trans,
                               collective_solve=collective_solve,
                               spmv=spmv, stats_out=so))
            rhs_stats.append(so)
        x = np.stack(cols, axis=1)
        rep = _attach_distributed_report(
            options, rhs_stats, x, lu_out=lu_out, stats=stats,
            residual_route="host" if spmv is None else "device")
    return (x[:, 0] if one_d else x), 0, rep


def _attach_distributed_report(options, rhs_stats, x, lu_out=None,
                               stats=None, residual_route="host"):
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
        residual_route=residual_route)
    rep.refine_steps = sum(s.get("iters", 0) for s in rhs_stats)
    rep.converged = rep.berr is not None and rep.berr <= target
    if stats is None and lu_out is not None:
        stats = lu_out.get("stats")
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
                                device=None, grid=None,
                                replicate_analysis=False):
    """One collective escalation rung for the distributed driver: when
    the distributed refinement stagnated above the recovery target,
    rerun the whole flow at float64 factors.  Every input to the
    decision (the report's berr/target, the shared options, the root's
    broadcast ``can_escalate``: its factors were below float64) is
    replicated, so all ranks take the same branch — rank-divergent
    control flow here would strand peers in the collectives (which is
    also why the decision must NOT depend on per-rank lu_out presence).
    On the mesh tier (``grid``) the retry runs on the grid too."""
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
                       device=device, grid=grid,
                       replicate_analysis=replicate_analysis)
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


def _gathered(grid) -> tuple:
    """(bytes, seconds) the grid's data collectives (gathers, and on the
    2-D tier the exchanges, the row broadcasts and row sums) have moved
    so far."""
    ops = [grid.comm.get(op, {}) for op in (
        "gather_rows", "all_gather", "all_gather_col", "exchange",
        "bcast_row", "all_reduce_row")]
    return (sum(o.get("bytes", 0) for o in ops),
            sum(o.get("seconds", 0.0) for o in ops))


def _check_mesh_ranks(tc, grid, device) -> None:
    """The mesh tier's entry check, COLLECTIVE: each rank checks that its
    TreeComm rank and size are its grid rank and size and that
    ``device`` (None: the grid's) is its grid rank's device, then one
    all-reduce over the tree tells every rank which ranks failed, so a
    mismatch on one rank raises SuperLUError on all of them instead of
    leaving the others blocked in the tier's first collective."""
    from superlu_dist_tpu_torch.utils.options import resolve_device
    why = None
    if tc.rank != grid.rank or tc.n_ranks != grid.nproc:
        why = (f"TreeComm rank {tc.rank}/{tc.n_ranks} is not grid rank "
               f"{grid.rank}/{grid.nproc}: both must order the same "
               "processes")
    elif device is not None:
        try:
            if resolve_device(device) != grid.device:
                why = (f"device {device} is not the grid rank's "
                       f"{grid.device}")
        except (RuntimeError, ValueError) as exc:
            why = f"device {device!r}: {exc}"
    bad = np.zeros(tc.n_ranks)
    bad[tc.rank] = 1.0 if why else 0.0
    bad = tc.allreduce_sum_any(bad)
    failed = [r for r in range(tc.n_ranks) if bad[r]]
    if failed:
        raise SuperLUError(
            f"mesh entry check failed on rank(s) {failed}"
            + (f": {why}" if why else " (see their errors)"))


def _pgssvx_mesh(tc, options, a_loc, b2, grid, one_d, wdtype, lu=None,
                 lu_out=None, replicate_analysis=False, device=None):
    """The distributed-factors tier (``pgssvx`` with a grid): rank 0
    assembles the global analysis input and runs the host analysis ONCE,
    then broadcasts the analyzed skeleton (symbolic + plan + transforms +
    permuted values) over the tree — O(nnz) transfer instead of O(nnz)
    redundant analysis work and graph memory on every rank, the wall the
    reference's distributed symbolic was built to break
    (SRC/psymbfact.c:140,228-242).  Every rank then factors its own slots
    on its device and the solves run collectively
    (parallel/spmd.py), so the off-diagonal factor panels stay sharded
    over the ranks for their whole lifetime; the collective correction
    solve also serves the distributed refinement (every rank calls it —
    the pdgsrfs shape where pdgstrs is itself parallel,
    SRC/pdgsrfs.c:205).

    ``Options(executor="stream")`` or ``Options(pool_partition=True)``
    runs the 2-D mesh executor (parallel/mesh_stream.py) on an nprow ×
    npcol grid: slots over the process rows, each front's columns over
    the process columns, and with pool_partition each Schur element kept
    only on the rank that extend-adds it.

    Returns (x, info, SolveReport or None, can_escalate) on every rank.
    ``lu_out["timings"]`` holds this rank's seconds: the analysis and its
    broadcast, FACT, the grid's data collectives (bytes and seconds),
    SOLVE and REFINE, and its device memory: allocated before the
    factorization (``base_bytes``) and the peak from there, at the end
    of FACT (``fact_peak_bytes``) and of the call (``peak_bytes``); on
    the 2-D tier also its pool bytes and its
    exchange and row-broadcast bytes, seconds and counts; the offload's
    mode, wait seconds and this rank's host bytes; and on the segment
    graphs (``Options(executor="fused"/"mega")``) their count, capture
    seconds and device bytes and the front_assemble launches of the
    call's warm-up (at the capture)."""
    import torch
    from superlu_dist_tpu_torch.drivers.gssvx import (_escalation_dtype,
                                                      analyze,
                                                      factorize_numeric)
    from superlu_dist_tpu_torch.utils.options import (Fact, IterRefine,
                                                      Trans)
    from superlu_dist_tpu_torch.utils.stats import Stats

    _check_mesh_ranks(tc, grid, device)
    dev = grid.device
    n = a_loc.n
    nrhs = b2.shape[1]
    timings = {}
    t0 = time.perf_counter()
    b_full = np.zeros((n, nrhs), dtype=wdtype)
    b_full[a_loc.fst_row:a_loc.fst_row + a_loc.m_loc] = b2
    b_full = tc.allreduce_sum_any(b_full, root=0)

    # refinement runs distributed below (block rows stay with their
    # owners), so the skeleton travels WITHOUT the global matrix: a
    # non-root rank never materializes A, only the analysis products
    opts0 = dataclasses.replace(options, iter_refine=IterRefine.NOREFINE)
    stats = Stats()
    fact = getattr(options, "fact", Fact.DOFACT)
    if fact == Fact.FACTORED:
        # solve-only on the existing sharded factors (every rank holds
        # ITS handle from a prior call's lu_out — pdgssvx's Fact=
        # FACTORED over the grid); the solves below are collective, so a
        # missing handle must fail on EVERY rank, not strand the others
        ok = np.zeros(1)
        ok[0] = 1.0 if (lu is not None and lu.numeric is not None) else 0.0
        ok = tc.allreduce_sum_any(ok)
        if int(ok[0]) != tc.n_ranks:
            raise SuperLUError(
                "Fact=FACTORED requires EVERY rank's prior lu handle "
                f"({int(ok[0])}/{tc.n_ranks} ranks have one)")
        info_r = 0
    elif replicate_analysis:
        a_all = gather_distributed(tc, a_loc, all_ranks=True)
        lu, bvals, _ = analyze(opts0, a_all, device=dev, stats=stats)
        lu.a = None
    elif getattr(opts0, "par_symb_fact", False):
        # ParSymbFact: ordering + symbolic partitioned across the ranks
        # themselves (the ParMETIS + psymbfact shape); root only
        # assembles and plans
        from superlu_dist_tpu_torch.parallel.panalysis import panalyze
        lu, bvals = panalyze(tc, opts0, a_loc, stats=stats, device=dev)
    else:
        # `lu` (the root's prior handle) activates the SamePattern reuse
        # tiers inside analyze
        lu, bvals = root_analyze_bcast(tc, opts0, a_loc, stats, lu=lu,
                                       device=dev)
    timings["analysis_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        timings["base_bytes"] = torch.cuda.memory_allocated(dev)
    gather0 = _gathered(grid)
    if fact != Fact.FACTORED:
        # deadline_comm=tc: Options.deadline_s expiry becomes a collective
        # decision (a flag allreduce per poll inside the factor loop), so
        # DeadlineExceededError raises on every rank together
        lu.device = dev
        info_r = factorize_numeric(lu, bvals, stats, grid=grid,
                                   deadline_comm=tc)
        timings["fact_s"] = stats.utime["FACT"]
        if dev.type == "cuda":
            timings["fact_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        # the 2-D executor's pool and its exchange and broadcast traffic,
        # the offload (its mode, wait and this rank's host bytes) and the
        # segment graphs (their count, capture seconds and device bytes)
        rep = lu.numeric.executor
        for k in ("pool_bytes", "exchange_bytes", "exchange_s", "exchanges",
                  "bcast_bytes", "bcast_s", "bcasts", "offload",
                  "offload_wait_s", "host_bytes", "segments", "capture_s",
                  "graph_device_bytes", "closed_keys", "warm_up_launches"):
            if k in rep:
                timings[k] = rep[k]
    if lu_out is not None:
        lu_out["lu"] = lu
        lu_out["stats"] = stats
        lu_out["timings"] = timings
    if info_r != 0:
        return None, int(info_r), None, False
    trans = getattr(options, "trans", Trans.NOTRANS)
    if trans == Trans.NOTRANS:
        solve_fn = lu.solve_factored
    else:
        solve_fn = (lambda r: lu.solve_factored_trans(
            r, conj=trans == Trans.CONJ))
    with stats.timer("SOLVE"):
        x_r = solve_fn(b_full if nrhs > 1 else b_full[:, 0])
    timings["solve_s"] = stats.utime["SOLVE"]
    x0 = np.asarray(x_r, dtype=wdtype).reshape(n, nrhs)
    t0 = time.perf_counter()
    # collective_solve=True: every rank calls solve_fn (the sharded solve
    # is a collective all ranks must enter), so no dx broadcast; the
    # residuals run on the ranks' devices over their own block rows
    spmv = (None if options.iter_refine == IterRefine.NOREFINE
            else ShardedSpMV.from_rows(a_loc, grid))
    x, info, rep = _refine_tail(tc, options, a_loc, b2, x0, solve_fn, 0,
                                one_d, nrhs, lu_out=lu_out,
                                collective_solve=True, spmv=spmv,
                                stats=stats)
    if rep is not None:
        # where the collective solves ran: host memory for offloaded
        # factors (parallel/spmd.SpmdSolver on the grid's host view)
        rep.solve_route = lu.solve_route
    timings["refine_s"] = time.perf_counter() - t0
    gather1 = _gathered(grid)
    timings["gather_bytes"] = gather1[0] - gather0[0]
    timings["gather_s"] = gather1[1] - gather0[1]
    timings["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else None)
    return x, info, rep, _escalation_dtype(lu.numeric.dtype) is not None
