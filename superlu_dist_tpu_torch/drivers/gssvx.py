"""Expert driver: the full solve pipeline on the device, with the reuse
tiers, transposed solves and the recovery ladder.

Port of the JAX package's single-process ``drivers/gssvx.py`` (the
pdgssvx analog, SRC/pdgssvx.c:505): equilibrate → row-permute (maximum
product matching with scalings) → column-order → symbolic → plan
("distribute") → numeric factor on the device → device triangular solve
(dataflow sweep schedule) → iterative refinement (its residual SpMV on
the card for a large matrix) → escalation ladder, with the
reference's Fact reuse tiers (superlu_defs.h:489-510):

  DOFACT                  — everything from scratch
  SamePattern             — reuse the column order (and symbolic + plan
                            when the fresh matching gives the same rows)
  SamePattern_SameRowPerm — also reuse scalings + row order: only the
                            numeric factorization runs
  FACTORED                — reuse the numeric factors: solve + refine

and ``refactor``, the values-only refactorization with a shadow handle,
a canary and atomic adoption.  ``Options.trans`` solves Aᵀ·X = B or
Aᴴ·X = B through the same factors.  Every solve runs on the factors'
device: there is no host-solve fallback, and a failure raises.

Permutation algebra (as in the JAX package): with equilibration scalings
Dr, Dc, matching scalings r1, c1 and row order ρ, the factored matrix is
    M = Pπ · (diag(R) A diag(C))[ρ] · Pπᵀ,  R = r1·dr, C = dc·c1
where π is the fill-reducing + postorder column permutation.  Then
A·x = b is solved as
    d = (R ⊙ b)[ρ][π] ;  M·ẑ = d ;  z[π] = ẑ ;  x = C ⊙ z.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from superlu_dist_tpu_torch.numeric.factor import (NumericFactorization,
                                                   numeric_factorize,
                                                   query_space)
from superlu_dist_tpu_torch.numeric.plan import FactorPlan, build_plan
from superlu_dist_tpu_torch.obs.flightrec import get_flightrec
from superlu_dist_tpu_torch.obs.metrics import get_metrics
from superlu_dist_tpu_torch.ops.dense import next_gemm_precision
from superlu_dist_tpu_torch.ordering.dispatch import get_perm_c
from superlu_dist_tpu_torch.parallel.dist import DeviceSpMV, gather_rows
from superlu_dist_tpu_torch.persist.serial import (pattern_digest,
                                                   plan_fingerprint)
from superlu_dist_tpu_torch.refine.condest import (ESTIMATE_ERRORS,
                                                   condition_estimate,
                                                   ferr_estimate)
from superlu_dist_tpu_torch.refine.ir import (iterative_refinement,
                                              request_berrs)
from superlu_dist_tpu_torch.rowperm.equil import gsequ, laqgs
from superlu_dist_tpu_torch.rowperm.matching import (
    approximate_weight_matching, maximum_product_matching)
from superlu_dist_tpu_torch.solve.device import DeviceSolver
from superlu_dist_tpu_torch.solve.trisolve import lu_solve, lu_solve_trans
from superlu_dist_tpu_torch.sparse.formats import SparseCSR, symmetrize_pattern
from superlu_dist_tpu_torch.symbolic.symbfact import (SymbolicFact,
                                                      symbolic_factorize)
from superlu_dist_tpu_torch.testing.chaos import get_refactor_chaos
from superlu_dist_tpu_torch.utils import tols
from superlu_dist_tpu_torch.utils.errors import (DeadlineExceededError,
                                                 NumericBreakdownError,
                                                 PatternMismatchError,
                                                 RefactorRollbackError,
                                                 SingularMatrixError,
                                                 SuperLUError)
from superlu_dist_tpu_torch.utils.deadline import Deadline
from superlu_dist_tpu_torch.utils.options import (Fact, IterRefine, Options,
                                                  RowPerm, Trans, check_ft,
                                                  env_int, print_options,
                                                  resolve_device,
                                                  resolve_factor_dtype)
from superlu_dist_tpu_torch.utils.stats import RungRecord, SolveReport, Stats


#: guards the lazy build of a handle's DeviceSolver
_SOLVER_LOCK = threading.Lock()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass
class LUFactorization:
    """Factorization handle — the {ScalePermstruct, LUstruct, SOLVEstruct}
    bundle of the reference API (superlu_ddefs.h:76-82,186-228)."""

    n: int
    options: Options
    device: torch.device
    equed: str
    dr: np.ndarray            # equilibration row scaling (or ones)
    dc: np.ndarray
    r1: np.ndarray            # matching scalings (or ones)
    c1: np.ndarray
    row_order: np.ndarray     # ρ: position j <- original row ρ[j]
    col_order: np.ndarray     # fill-reducing order fed to symbolic
    sf: SymbolicFact = None
    plan: FactorPlan = None
    numeric: NumericFactorization = None
    anorm: float = 0.0
    a: SparseCSR = None       # the matrix (refinement SpMV, refactor)
    berrs: list = None        # backward errors of the last refinement
    a_sym_indptr: np.ndarray = None    # symmetrized permuted pattern the
    a_sym_indices: np.ndarray = None   # symbolic factorization was built on
    dev_solver: DeviceSolver = None    # built at the first solve
    dev_spmv: dict = None              # DeviceSpMV per (trans, residual
                                       # dtype): (a.data it was built on,
                                       # operator)
    pattern_digest: str = None         # identity latch of refactor
    plan_fp: str = None
    grid: object = None                # the process grid the factors are
                                       # sharded over (parallel/grid.py;
                                       # None off-grid): every solve is
                                       # then collective

    def identity(self) -> tuple:
        """Latch and return ``(pattern_digest, plan_fingerprint)``: a
        values-only refactor reuses symbolic + plan by object identity, so
        the handle carries a fingerprint of both and drift raises
        :class:`PatternMismatchError`."""
        if self.pattern_digest is None and self.a_sym_indptr is not None:
            self.pattern_digest = pattern_digest(self.a_sym_indptr,
                                                 self.a_sym_indices)
        if self.plan_fp is None and self.plan is not None:
            self.plan_fp = plan_fingerprint(self.plan)
        return self.pattern_digest, self.plan_fp

    @property
    def R(self):
        return self.r1 * self.dr

    @property
    def C(self):
        return self.dc * self.c1

    @property
    def sigma(self):
        """Composite row order: M rows <- original rows sigma[k]."""
        return self.row_order[self.sf.perm]

    def solve_factored(self, b: np.ndarray) -> np.ndarray:
        """Solve A·x = b through the factored M on the factors' device (no
        refinement)."""
        b = np.asarray(b)
        d = b * (self.R[:, None] if b.ndim > 1 else self.R)
        z_hat = self._solve_permuted(d[self.sigma])
        z = np.empty_like(z_hat)
        z[self.sf.perm] = z_hat
        return z * (self.C[:, None] if b.ndim > 1 else self.C)

    def solve_factored_trans(self, b: np.ndarray,
                             conj: bool = False) -> np.ndarray:
        """Solve Aᵀ·x = b (or Aᴴ·x = b with conj) through the same factors:
        Mᵀ·(P_σ (x ⊘ R)) = P_π (C ⊙ b) — the same transforms in mirrored
        order, solved by the Uᵀ then Lᵀ sweeps."""
        b = np.asarray(b)
        C = self.C[:, None] if b.ndim > 1 else self.C
        R = self.R[:, None] if b.ndim > 1 else self.R
        w_hat = self._solve_permuted_trans((b * C)[self.sf.perm], conj)
        w = np.empty_like(w_hat)
        w[self.sigma] = w_hat
        return w * R

    def _solver(self) -> DeviceSolver:
        if not self.numeric.finite:
            raise SingularMatrixError(self.numeric.info_col)
        with _SOLVER_LOCK:      # two threads' first solves build one
            if self.dev_solver is None and self.numeric.shard is not None:
                # a sharded handle solves collectively on its grid (the
                # reference's pdgstrs over the process grid,
                # SRC/pdgstrs.c:838): no rank can solve alone
                from superlu_dist_tpu_torch.parallel.spmd import SpmdSolver
                opts = self.options
                self.dev_solver = SpmdSolver(
                    self.numeric, schedule=opts.solve_schedule,
                    window=opts.solve_window, align=opts.solve_align,
                    gemm_prec=self.numeric.gemm_prec)
            elif self.dev_solver is None:
                opts = self.options
                self.dev_solver = DeviceSolver(
                    self.numeric, diag_inv=opts.diag_inv, fused="auto",
                    schedule=opts.solve_schedule, window=opts.solve_window,
                    align=opts.solve_align, gemm_prec=self.numeric.gemm_prec)
            return self.dev_solver

    @property
    def solve_route(self) -> str:
        """Where the solves run: "device" for factors on the card (or the
        CPU device), "host" for factors the executor offloaded to host
        memory (solve/trisolve.py, as the JAX driver routes them,
        drivers/gssvx.py:180-187).  Placement, not a fallback: factors on
        the card never take the host path."""
        return "host" if self.numeric.on_host else "device"

    def _solve_permuted(self, d: np.ndarray) -> np.ndarray:
        if self.solve_route == "host":
            if not self.numeric.finite:
                raise SingularMatrixError(self.numeric.info_col)
            return lu_solve(self.numeric, d)
        return self._solver().solve(d)

    def _solve_permuted_trans(self, d: np.ndarray,
                              conj: bool = False) -> np.ndarray:
        if self.solve_route == "host":
            if not self.numeric.finite:
                raise SingularMatrixError(self.numeric.info_col)
            return lu_solve_trans(self.numeric, d, conj=conj)
        return self._solver().solve_trans(d, conj=conj)


def analyze(options: Options, a: SparseCSR, device="cuda",
            stats: Stats | None = None, lu: LUFactorization | None = None):
    """The host analysis phases: EQUIL → ROWPERM → COLPERM → SYMBFACT →
    DIST/plan (pdgssvx.c:647-1166 before pdgstrf).  Returns
    ``(lu, bvals, stats)``: an LUFactorization skeleton (numeric=None) and
    the structurally-permuted values ready for factorize_numeric.

    With ``lu`` (a prior handle) the reuse tiers apply: SamePattern reuses
    its column order, and its symbolic structure and plan when the fresh
    matching reproduces its row order; SamePattern_SameRowPerm also reuses
    its scalings and row order.  A reused structure is checked against the
    new matrix's symmetrized permuted pattern, entry for entry."""
    device = resolve_device(device)
    if stats is None:
        stats = Stats()
    n = a.n_rows
    if a.n_cols != n:
        raise SuperLUError("A must be square")
    fact = options.fact
    reuse_rowperm = fact == Fact.SamePattern_SameRowPerm and lu is not None
    reuse_colperm = (fact in (Fact.SamePattern, Fact.SamePattern_SameRowPerm)
                     and lu is not None)
    # the symbolic structure is built on the row-permuted pattern, so it
    # carries over iff the row order does: always under
    # SamePattern_SameRowPerm, and under SamePattern when the fresh
    # matching gives the prior order (checked below)
    reuse_symbolic = reuse_rowperm

    with stats.timer("EQUIL"):
        if reuse_rowperm:
            dr, dc, equed = lu.dr, lu.dc, lu.equed
            a1 = a.row_scale(dr).col_scale(dc) if equed != "N" else a
        elif options.equil:
            r, c, rowcnd, colcnd, amax = gsequ(a)
            a1, equed = laqgs(a, r, c, rowcnd, colcnd, amax)
            dr = r if equed in ("R", "B") else np.ones(n)
            dc = c if equed in ("C", "B") else np.ones(n)
        else:
            a1, equed = a, "N"
            dr = dc = np.ones(n)

    with stats.timer("ROWPERM"):
        if reuse_rowperm:
            row_order, r1, c1 = lu.row_order, lu.r1, lu.c1
            a2 = a1.row_scale(r1).col_scale(c1).permute(perm_r=row_order)
        elif options.row_perm == RowPerm.LargeDiag_MC64:
            row_order, r1, c1 = maximum_product_matching(
                a1, native=options.native)
            a2 = a1.row_scale(r1).col_scale(c1).permute(perm_r=row_order)
        elif options.row_perm == RowPerm.LargeDiag_AWPM:
            # permutation only: AWPM gives no duals, so unit scalings
            row_order = approximate_weight_matching(a1, native=options.native)
            r1 = c1 = np.ones(n)
            a2 = a1.permute(perm_r=row_order)
        elif options.row_perm == RowPerm.MY_PERMR:
            row_order = np.asarray(options.user_perm_r, dtype=np.int64)
            r1 = c1 = np.ones(n)
            a2 = a1.permute(perm_r=row_order)
        elif options.row_perm == RowPerm.NOROWPERM:
            row_order = np.arange(n, dtype=np.int64)
            r1 = c1 = np.ones(n)
            a2 = a1
        else:
            raise SuperLUError(f"unsupported RowPerm {options.row_perm}")

    if (reuse_colperm and not reuse_symbolic and lu.sf is not None
            and np.array_equal(row_order, lu.row_order)):
        reuse_symbolic = True

    anorm = a2.norm_max()
    sym = symmetrize_pattern(a2)

    with stats.timer("COLPERM"):
        col_order = lu.col_order if reuse_colperm else get_perm_c(options, a2,
                                                                  sym)

    et0 = stats.utime["ETREE"]
    with stats.timer("SYMBFACT"):
        if reuse_symbolic:
            sf = lu.sf
        else:
            sf = symbolic_factorize(sym, col_order, relax=options.relax,
                                    max_supernode=options.max_supernode,
                                    stats=stats, amalg_tol=options.amalg_tol,
                                    native=options.native,
                                    nthreads=options.symb_threads)
    # phases are disjoint like the reference's PhaseType: the etree part
    # timed inside symbolic_factorize is carved out of SYMBFACT
    stats.utime["SYMBFACT"] -= stats.utime["ETREE"] - et0

    with stats.timer("DIST"):
        if reuse_symbolic:
            plan = lu.plan
        else:
            plan = build_plan(sf, min_bucket=options.min_bucket,
                              growth=options.bucket_growth,
                              schedule=options.schedule,
                              window=options.sched_window,
                              align=options.sched_align,
                              closed=options.bucket_closed,
                              max_keys=options.bucket_keys,
                              native=options.native)
        # nnz equality is not enough: a moved entry with an equal count
        # would gather values into wrong structural slots
        if sym.nnz != len(sf.value_perm) or (reuse_symbolic and not (
                np.array_equal(sym.indptr, lu.a_sym_indptr)
                and np.array_equal(sym.indices, lu.a_sym_indices))):
            raise SuperLUError(
                f"Fact={fact.name} reuse requires the same sparsity pattern "
                "as the factorization being reused")
        bvals = sym.data[sf.value_perm]

    lu = LUFactorization(n=n, options=options, device=device, equed=equed,
                         dr=dr, dc=dc, r1=r1, c1=c1, row_order=row_order,
                         col_order=col_order, sf=sf, plan=plan, anorm=anorm,
                         a=a, a_sym_indptr=sym.indptr,
                         a_sym_indices=sym.indices)
    return lu, bvals, stats


def factorize_numeric(lu: LUFactorization, bvals: np.ndarray,
                      stats: Stats | None = None,
                      resume_from: str | None = None,
                      deadline_comm=None, grid=None) -> int:
    """Numeric factorization (pdgssvx.c:1176 → pdgstrf) of an analyzed
    skeleton on its device, in ``options.factor_dtype`` (complex values
    take the complex type of that width).  Fills lu.numeric; returns info
    (0, or the 1-based first zero-pivot column).

    Crash consistency (persist/): ``Options.ckpt_every`` or
    ``Options.ckpt_dir`` arm mid-factor frontier checkpoints;
    ``resume_from`` restarts from a durable checkpoint instead of from
    scratch (recorded on ``stats.resume`` and as a SolveReport rung by the
    solve tail); ``Options.deadline_s`` bounds the factor loop
    (DeadlineExceededError, after the frontier is flushed), with
    ``deadline_comm`` (a TreeComm whose every rank runs this same group
    loop) making the expiry a collective decision, one flag allreduce per
    ``SLU_TPU_DEADLINE_POLL`` polls.
    ``Options.executor`` and the stream knobs (``host_flops``,
    ``front_bytes_limit``, ``offload_lag``) choose the executor
    (numeric/factor.get_executor); what ran lands on ``stats.executor``.

    ``grid`` (parallel/grid.ProcessGrid; default: the handle's own) of
    several ranks makes this a COLLECTIVE: every rank enters it with the
    same skeleton and values and keeps its own share of the panels (the
    spmd executor, parallel/spmd.py, or with ``Options.executor="stream"``
    or ``Options.pool_partition`` the 2-D mesh stream,
    parallel/mesh_stream.py — the JAX driver passes pool_partition on
    alike, drivers/gssvx.py:443); the handle keeps the grid, so its
    solves are collective too.  Checkpoints are off under a grid (the JAX
    driver's rule, drivers/gssvx.py:425: the pool is the ranks' joint
    state); the deadline stays, polled through ``deadline_comm`` or else
    the grid itself, so every rank raises together."""
    if stats is None:
        stats = Stats()
    options = lu.options
    if grid is None:
        grid = lu.grid
    if grid is not None:
        if resume_from:
            raise SuperLUError("resume_from has no place on a grid: the "
                               "factor pool is the ranks' joint state")
        lu.grid = grid
        lu.device = grid.device
        if deadline_comm is None and grid.nproc > 1:
            deadline_comm = grid
    dtype = resolve_factor_dtype(options.factor_dtype, lu.device,
                                 np.iscomplexobj(bvals))
    deadline = (Deadline(options.deadline_s, comm=deadline_comm,
                         poll_every=env_int("SLU_TPU_DEADLINE_POLL"))
                if options.deadline_s else None)
    with stats.timer("FACT"):
        numeric = numeric_factorize(
            lu.plan, bvals, lu.anorm, dtype=dtype, device=lu.device,
            replace_tiny=options.replace_tiny_pivot,
            check_finite=options.recovery.sentinels,
            gemm_prec=options.gemm_prec,
            ckpt_dir=(options.ckpt_dir or None) if grid is None else None,
            ckpt_every=options.ckpt_every if grid is None else 0,
            resume_from=resume_from,
            deadline=deadline, executor=options.executor,
            host_flops=options.host_flops,
            front_bytes_limit=options.front_bytes_limit,
            offload_lag=options.offload_lag, grid=grid,
            pool_partition=getattr(options, "pool_partition", False))
        if lu.device.type == "cuda":
            torch.cuda.synchronize(lu.device)
    stats.ops["FACT"] += lu.plan.flops
    stats.tiny_pivots += numeric.tiny_pivots
    stats.sched = lu.plan.schedule_stats(
        itemsize=torch.empty((), dtype=dtype).element_size())
    m = get_metrics()
    if m.enabled:
        sched = stats.sched
        m.inc("slu_factorizations_total", 1.0,
              schedule=sched.get("schedule", "?"))
        # which GEMM tier the factors ran at (a ladder rung or a refactor
        # escalation increments it again)
        m.inc("slu_gemm_precision_total", 1.0, tier=numeric.gemm_prec)
        m.set("slu_schedule_groups", sched.get("n_groups", 0))
        m.set("slu_schedule_occupancy", sched.get("occupancy", 0.0))
        m.set("slu_schedule_critical_path", sched.get("critical_path", 0))
    # memory (the dQuerySpace_dist analog); on the card the peak is the
    # allocator's own
    space = query_space(numeric)
    stats.for_lu_bytes = space["for_lu_bytes"]
    stats.pool_bytes = space["pool_bytes"]
    stats.observe_memory(torch.cuda.max_memory_allocated(lu.device)
                         if lu.device.type == "cuda"
                         else space["total_bytes"])
    if numeric.resumed_groups:
        stats.resume = {"groups": int(numeric.resumed_groups),
                        "of": len(lu.plan.groups), "path": str(resume_from)}
    stats.executor = dict(numeric.executor)
    lu.numeric = numeric
    lu.dev_solver = None
    if not numeric.finite:
        return numeric.info_col + 1
    return 0


# per-process refactor counter: the chaos harness's `kill_refactor@step=K`
# spec is scoped to the Kth refactor of the victim process (0-based)
_REFACTOR_SEQ = [0]


def refactor(lu: LUFactorization, new_values, stats: Stats | None = None,
             canary_b: np.ndarray = None, berr_max: float = 0.0,
             escalate: bool = True, resume_from: str | None = None) -> Stats:
    """Values-only refactorization: the SamePattern_SameRowPerm tier as a
    verb on a handle.

    ``new_values`` is a :class:`SparseCSR` with the pattern the handle was
    analyzed on, or a raw data array replacing ``lu.a.data`` entry for
    entry.  The handle's scalings, row order, symbolic structure and plan
    (with its device maps) are reused by object identity: no ROWPERM,
    COLPERM or SYMBFACT work.  A matrix whose symmetrized permuted pattern
    differs from the handle's raises :class:`PatternMismatchError`.

    The factorization runs on a shadow copy of the handle and is adopted
    only after (a) it finished finite and non-singular and (b) the canary
    passed: one unrefined solve of ``canary_b`` (default: ones) is finite
    and, when ``berr_max`` > 0, has componentwise backward error at most
    ``berr_max``.  A canary miss climbs the GEMM ladder one tier per rung
    when ``escalate`` (at most ``options.recovery.max_rungs`` tries);
    otherwise the refactor raises :class:`RefactorRollbackError` and ``lu``
    is untouched.  On success ``lu`` serves the new factors (its
    ``numeric``/``a``/``anorm`` rebound, its solver rebuilt at the next
    solve).  ``resume_from`` names a factor checkpoint of these values on
    this plan, from which the first factorization restarts; the options'
    deadline bounds each factorization.  Returns ``stats``.

    The chaos harness's refactor specs (testing/chaos.py,
    ``SLU_TPU_CHAOS``) act here: ``poison_values=S`` NaNs the new value
    that assembles into supernode S, ``kill_refactor@step=K`` kills the
    process mid-refactor on its Kth refactor; the metrics registry counts
    refactors, rollbacks by stage and adoptions."""
    if stats is None:
        stats = Stats()
    step = _REFACTOR_SEQ[0]
    _REFACTOR_SEQ[0] += 1
    m = get_metrics()
    if m.enabled:
        m.inc("slu_refactor_total", 1.0)
    if lu.sf is None or lu.plan is None or lu.numeric is None:
        raise SuperLUError(
            "refactor requires a factored handle (run gssvx, or analyze and "
            "factorize_numeric, first)")
    if lu.a_sym_indptr is None:
        raise SuperLUError(
            "refactor requires the handle's analyzed pattern "
            "(a_sym_indptr is None); re-analyze with Fact=DOFACT")
    expected_digest, _ = lu.identity()

    a_new = new_values
    if not isinstance(a_new, SparseCSR):
        vals = np.asarray(new_values)
        if lu.a is None:
            raise SuperLUError(
                "refactor from a raw value array needs the handle's matrix "
                "for its pattern (lu.a is None); pass a SparseCSR instead")
        if vals.ndim != 1 or vals.shape[0] != lu.a.nnz:
            raise PatternMismatchError(
                f"value array has {vals.shape} entries, the handle's "
                f"pattern has {lu.a.nnz} nonzeros",
                expected_digest=expected_digest, n=lu.n, nnz=lu.a.nnz)
        a_new = SparseCSR(lu.a.n_rows, lu.a.n_cols, lu.a.indptr,
                          lu.a.indices, vals)
    if a_new.n_rows != lu.n or a_new.n_cols != lu.n:
        raise PatternMismatchError(
            f"matrix is {a_new.n_rows}x{a_new.n_cols}, the handle was "
            f"analyzed at n={lu.n}", expected_digest=expected_digest, n=lu.n)
    a1 = (a_new.row_scale(lu.dr).col_scale(lu.dc)
          if lu.equed != "N" else a_new)
    a2 = a1.row_scale(lu.r1).col_scale(lu.c1).permute(perm_r=lu.row_order)
    sym = symmetrize_pattern(a2)
    if sym.nnz != len(lu.sf.value_perm) or not (
            np.array_equal(sym.indptr, lu.a_sym_indptr)
            and np.array_equal(sym.indices, lu.a_sym_indices)):
        raise PatternMismatchError(
            "the matrix's symmetrized permuted pattern differs from the "
            "one the handle's symbolic structure was built on",
            expected_digest=expected_digest,
            got_digest=pattern_digest(sym.indptr, sym.indices),
            n=lu.n, nnz=sym.nnz)
    bvals = sym.data[lu.sf.value_perm]
    anorm = a2.norm_max()
    # chaos hooks, consulted once per refactor
    monkey = get_refactor_chaos()
    if monkey is not None:
        bvals = monkey.poison_refactor_values(lu.plan, bvals)
        if monkey.refactor_kill_due(step):
            # mid-refactor: the new values are staged, nothing adopted —
            # the previous handle (and any bundle on disk) must survive
            monkey.kill_now()
    if canary_b is None:
        canary_b = np.ones(lu.n, dtype=np.asarray(a_new.data).dtype)

    def rollback(stage, cause="", berr=-1.0):
        if m.enabled:
            m.inc("slu_refactor_rollbacks_total", 1.0, stage=stage)
        return RefactorRollbackError(
            "handle", stage=stage, cause=cause, berr=berr,
            berr_target=berr_max if berr_max > 0 else -1.0)

    options = lu.options
    rungs = max(int(options.recovery.max_rungs), 1)
    for rung in range(rungs):
        shadow = dataclasses.replace(lu, numeric=None, dev_solver=None,
                                     dev_spmv=None, berrs=None, a=a_new,
                                     anorm=anorm, options=options)
        try:
            info = factorize_numeric(shadow, bvals, stats,
                                     resume_from=resume_from if rung == 0
                                     else None)
        except DeadlineExceededError:
            raise
        except SuperLUError as e:
            raise rollback("factor", f"{type(e).__name__}: {e}") from e
        if info != 0:
            raise rollback("factor", f"singular: info={info}")
        try:
            x = shadow.solve_factored(canary_b)
            finite = bool(np.all(np.isfinite(x)))
            berr = (float(request_berrs(a_new, canary_b, x).max())
                    if finite else float("inf"))
        except SuperLUError as e:
            raise rollback("canary", f"{type(e).__name__}: {e}") from e
        if finite and (berr_max <= 0 or berr <= berr_max):
            break
        nxt = next_gemm_precision(shadow.numeric.gemm_prec, lu.device)
        if not escalate or nxt is None or rung == rungs - 1:
            raise rollback(
                "canary", "non-finite canary X" if not finite else
                "canary backward error above the gate", berr=berr)
        options = dataclasses.replace(options, gemm_prec=nxt)
        if m.enabled:
            m.inc("slu_recovery_rungs_total", 1.0,
                  rung="refactor-gemm-precision", improved="pending")

    # adoption: single-field rebinds, so a solve holds either the whole old
    # numeric or the whole new one
    lu.numeric = shadow.numeric
    lu.dev_solver = None
    lu.dev_spmv = None
    lu.berrs = None
    lu.a = a_new
    lu.anorm = anorm
    lu.options = shadow.options
    if m.enabled:
        m.inc("slu_refactor_adopted_total", 1.0)
    get_flightrec().event(
        "refactor-adopted", cat="refactor", step=step,
        pattern=expected_digest[:12] if expected_digest else "")
    return stats


def gssvx(options: Options, a: SparseCSR, b: np.ndarray, device=None,
          stats: Stats | None = None, lu: LUFactorization | None = None,
          resume_from: str | None = None, grid=None):
    """Solve A·X = B (or Aᵀ·X = B, Aᴴ·X = B under ``options.trans``).
    Returns (x, lu, stats, info).

    ``device``: where the analysis and factorization run — the card by
    default, the prior handle's device when ``lu`` is given; "cuda"
    without a card raises, only device="cpu" runs on the CPU.  ``lu`` is
    the handle the reuse tiers (``options.fact``) reuse; Fact.FACTORED
    solves through its factors.  The returned lu is the handle the answer
    rests on (an escalated one after a ladder rung).

    info = 0 on success, or the 1-based first zero-pivot column when
    ReplaceTinyPivot is off and U is exactly singular (x is None then).
    ``stats.solve_report`` tells what the solve did: BERR, rungs, rcond,
    ferr.

    ``resume_from`` names a factor checkpoint (persist/checkpoint.py),
    written by a run that stopped mid-factorization under a deadline,
    ``Options.ckpt_every`` or SIGTERM: the analysis re-runs (cheap,
    deterministic), the checkpoint's plan fingerprint and value digest are
    verified against it, and the factorization restarts from the durable
    frontier — factors bit for bit equal to an uninterrupted run, recorded
    on ``stats.resume`` and as a 'resume-from-checkpoint' rung.
    ``options.print_stat`` prints the options banner first and the Stats
    report last.

    ``grid`` (parallel/grid.ProcessGrid, the reference's gridinfo_t
    argument) makes the call COLLECTIVE over the grid's ranks — one
    process per device, so every rank calls gssvx with the same A and B:
    each analyzes (deterministic host work), the factorization runs
    sharded over the ranks (each keeps its own slots' panels) and every
    solve, refinement and ladder rung runs on every rank on the same data,
    with the same x everywhere.  ``device`` is then the grid's; a prior
    handle ``lu`` brings its own grid."""
    if grid is None and lu is not None:
        grid = lu.grid
    if grid is not None:
        if device is not None and resolve_device(device) != grid.device:
            raise SuperLUError(f"device {device} is not the grid rank's "
                               f"{grid.device}")
        device = grid.device
    if device is None:
        device = lu.device if lu is not None else "cuda"
    device = resolve_device(device)
    if stats is None:
        stats = Stats()
    if options.print_stat:
        print(print_options(options))
    check_ft(options)
    n = a.n_rows
    if a.n_cols != n:
        raise SuperLUError("A must be square")
    b = np.asarray(b)
    if b.shape[0] != n:
        raise SuperLUError("B leading dimension must match A")
    if options.fact == Fact.FACTORED:
        if lu is None or lu.numeric is None:
            raise SuperLUError("Fact=FACTORED requires a prior factorization")
        out = _solve_and_refine(options, a, b, lu, stats)
    else:
        lu, bvals, stats = analyze(options, a, device=device, stats=stats,
                                   lu=lu)
        info = factorize_numeric(lu, bvals, stats, resume_from=resume_from,
                                 grid=grid)
        out = ((None, lu, stats, info) if info != 0
               else _solve_and_refine(options, a, b, lu, stats))
    if options.print_stat:
        stats.print()
    return out


def gssvx_ABglobal(options: Options, a: SparseCSR, b: np.ndarray,
                   lu: LUFactorization | None = None,
                   stats: Stats | None = None, device=None):
    """pdgssvx_ABglobal analog (SRC/pdgssvx_ABglobal.c:472).  The
    reference keeps two pipelines because its main driver takes a
    distributed matrix and ABglobal a replicated one; here the host
    analysis always sees the global matrix (the distributed input is
    :func:`gssvx_dist`), so ABglobal is gssvx, kept as a named entry point
    for API parity."""
    return gssvx(options, a, b, device=device, stats=stats, lu=lu)


def gssvx_dist(options: Options, parts, b: np.ndarray,
               lu: LUFactorization | None = None,
               stats: Stats | None = None, device=None):
    """Solve from a distributed row-block matrix (the reference's primary
    pdgssvx signature, NRformat_loc input, SRC/pdgssvx.c:505).  ``parts``
    is a list of :class:`~superlu_dist_tpu_torch.parallel.dist.
    DistributedCSR` row blocks; they are assembled on the host (the
    dReDistribute_A role, SRC/pddistribute.c:61: one gather, since the
    analysis is single-address-space) and solved by :func:`gssvx`."""
    return gssvx(options, gather_rows(parts), b, device=device, stats=stats,
                 lu=lu)


def _adjoint_solver(lu: LUFactorization, trans: Trans, cplx: bool):
    """op⁻ᴴ through the stored factors (for the FERR estimator); None when
    the trans/complex combination has no clean adjoint through them."""
    if trans == Trans.NOTRANS:
        return lambda r: lu.solve_factored_trans(r, conj=cplx)
    if not cplx:
        return lu.solve_factored     # real: (Aᵀ)ᴴ = A
    return None


def _trans_solver(lu: LUFactorization, trans: Trans, a_dtype):
    """The op(A)⁻¹ apply matching options.trans, on any handle."""
    if trans == Trans.NOTRANS:
        return lu.solve_factored
    conj = trans == Trans.CONJ and np.issubdtype(a_dtype, np.complexfloating)
    return lambda rhs: lu.solve_factored_trans(rhs, conj=conj)


def _escalation_dtype(cur: torch.dtype) -> str | None:
    """The next factor precision above ``cur``, or None at the top.  The
    card has native float64, so the JAX package's rule for such a backend
    applies (float32 → float64, complex64 → complex128); its emulated
    double (df64) is not needed."""
    return {torch.float32: "float64",
            torch.complex64: "complex128"}.get(cur)


def _permuted_values(lu: LUFactorization):
    """analyze()'s structurally-permuted values recomputed from the stored
    transforms, so a rung can refactor on the same skeleton; None when the
    handle cannot reproduce them (no matrix, or pattern drift)."""
    if lu.a is None or lu.sf is None:
        return None
    a1 = (lu.a.row_scale(lu.dr).col_scale(lu.dc)
          if lu.equed != "N" else lu.a)
    a2 = a1.row_scale(lu.r1).col_scale(lu.c1).permute(perm_r=lu.row_order)
    sym = symmetrize_pattern(a2)
    if sym.nnz != len(lu.sf.value_perm):
        return None
    if (lu.a_sym_indptr is not None
            and not (np.array_equal(sym.indptr, lu.a_sym_indptr)
                     and np.array_equal(sym.indices, lu.a_sym_indices))):
        return None
    return sym.data[lu.sf.value_perm]


def _escalate(options: Options, a: SparseCSR, op, b: np.ndarray,
              lu: LUFactorization, stats: Stats, trans: Trans, solve_fn,
              x: np.ndarray, residual_dtype, report: SolveReport,
              target: float):
    """The escalation ladder.  Runs when refinement stagnated above
    ``target`` or produced non-finite values:

      1. residual-precision — same factors, float64 residual;
      1.5 gemm-precision    — refactor the same skeleton one GEMM tier up
                              per rung (ops/dense.next_gemm_precision);
      2. hiprec-factors     — refactor the same skeleton at the next
                              factor precision and refine through it;
      3. refactor-rescale   — full re-analysis with equilibration + MC64
                              forced on, at the escalated precision.

    Every rung is recorded in report.rungs; a rung's result is adopted
    only when it strictly improved berr.  Returns (x, lu_effective,
    solve_fn, residual_dtype)."""
    recovery = options.recovery
    cur_x = np.asarray(x)
    cur_berr = report.berr if report.berr is not None else float("inf")
    if not np.all(np.isfinite(cur_x)):
        cur_berr = float("inf")
    lu_eff = lu
    a_dtype = np.asarray(a.data).dtype
    rungs0 = len(report.rungs)

    def attempt(name, detail, solve2, res_dtype, start_x):
        """Refine with ``solve2`` corrections; record; adopt on
        improvement.  Returns True when the target is reached."""
        nonlocal cur_x, cur_berr, solve_fn, residual_dtype
        t0 = time.perf_counter()
        try:
            x0 = (start_x if np.all(np.isfinite(start_x))
                  else np.asarray(solve2(b)))
            x2, errs = iterative_refinement(op, b, x0, solve2,
                                            residual_dtype=res_dtype)
        except SuperLUError as e:
            report.rungs.append(RungRecord(
                name=name, detail=f"{detail}: {type(e).__name__}",
                berr_before=cur_berr, seconds=time.perf_counter() - t0))
            return False
        berr2 = errs[-1] if errs else float("inf")
        if not np.all(np.isfinite(x2)):
            berr2 = float("inf")
        report.rungs.append(RungRecord(
            name=name, detail=detail, berr_before=cur_berr,
            berr_after=berr2, seconds=time.perf_counter() - t0))
        report.berr_history.extend(errs)
        stats.refine_steps += len(errs)
        if berr2 < cur_berr:
            cur_x, cur_berr = np.asarray(x2), berr2
            solve_fn, residual_dtype = solve2, res_dtype
            report.berr = berr2
        return cur_berr <= target

    done = False
    # rung 1: SLU_SINGLE's f32 residual cannot see below single eps; the
    # same factors with an exact residual are the cheapest repair
    if (np.dtype(residual_dtype) != np.float64
            and len(report.rungs) < recovery.max_rungs):
        done = attempt("residual-precision", "float64 residual",
                       solve_fn, np.float64, cur_x)

    # rung 1.5: a reduced GEMM tier that missed the gate refactors the
    # same skeleton one tier up per rung
    tier = lu.numeric.gemm_prec
    while not done and len(report.rungs) < recovery.max_rungs:
        nxt = next_gemm_precision(tier, lu.device)
        if nxt is None:
            break
        bvals = _permuted_values(lu)
        if bvals is None:
            break
        t0 = time.perf_counter()
        lu_prec = dataclasses.replace(
            lu, numeric=None, dev_solver=None, dev_spmv=None, berrs=None,
            options=dataclasses.replace(options, gemm_prec=nxt))
        try:
            info_p = factorize_numeric(lu_prec, bvals, stats)
        except SuperLUError as e:
            info_p = f"{type(e).__name__}"
        if info_p != 0:
            report.rungs.append(RungRecord(
                name="gemm-precision", detail=f"{nxt}: info={info_p}",
                berr_before=cur_berr, seconds=time.perf_counter() - t0))
            break
        solve_p = _trans_solver(lu_prec, trans, a_dtype)
        done = attempt("gemm-precision", nxt, solve_p, np.float64, cur_x)
        adopted = solve_fn is solve_p
        if adopted:
            lu_eff = lu_prec
        tier = nxt
        if not done and not adopted:
            # the GEMM tier is not the binding error source: leave the
            # remaining rungs to the dtype escalation
            break

    # rung 2: higher-precision factors on the same skeleton
    esc = _escalation_dtype(lu.numeric.dtype)
    if (not done and esc is not None
            and len(report.rungs) < recovery.max_rungs):
        bvals = _permuted_values(lu)
        if bvals is not None:
            lu_esc = dataclasses.replace(
                lu, numeric=None, dev_solver=None, dev_spmv=None, berrs=None,
                options=dataclasses.replace(options, factor_dtype=esc,
                                            gemm_prec="highest"))
            try:
                info2 = factorize_numeric(lu_esc, bvals, stats)
            except SuperLUError:
                info2 = -1
            if info2 == 0:
                solve2 = _trans_solver(lu_esc, trans, a_dtype)
                done = attempt("hiprec-factors", esc, solve2, np.float64,
                               cur_x)
                if solve_fn is solve2:
                    lu_eff = lu_esc

    # rung 3: refactor with re-scaling / re-ordering, only when it would
    # change something the first pass did not do
    would_change = (not options.equil
                    or options.row_perm != RowPerm.LargeDiag_MC64
                    or not options.replace_tiny_pivot
                    or esc is not None)
    if not done and would_change and len(report.rungs) < recovery.max_rungs:
        t0 = time.perf_counter()
        opts3 = dataclasses.replace(
            options, fact=Fact.DOFACT, equil=True,
            row_perm=RowPerm.LargeDiag_MC64, replace_tiny_pivot=True,
            factor_dtype=esc if esc is not None else options.factor_dtype,
            gemm_prec="highest", iter_refine=IterRefine.SLU_DOUBLE,
            print_stat=False, user_perm_r=None,
            # no recursion: the ladder itself reads this sub-solve's report
            recovery=dataclasses.replace(recovery, enabled=False,
                                         condest="never", sentinels=False))
        err3 = ""
        try:
            x3, lu3, stats3, info3 = gssvx(opts3, a, b, device=lu.device,
                                           grid=lu.grid)
        except SuperLUError as e:
            x3, lu3, stats3, info3 = None, None, None, -1
            err3 = f" ({type(e).__name__})"
        if info3 == 0 and x3 is not None:
            rep3 = stats3.solve_report
            berr3 = (rep3.berr if rep3.berr is not None else float("inf"))
            if not np.all(np.isfinite(x3)):
                berr3 = float("inf")
            report.rungs.append(RungRecord(
                name="refactor-rescale", detail=str(opts3.factor_dtype),
                berr_before=cur_berr, berr_after=berr3,
                seconds=time.perf_counter() - t0))
            report.berr_history.extend(rep3.berr_history)
            if berr3 < cur_berr:
                cur_x, cur_berr, lu_eff = np.asarray(x3), berr3, lu3
                solve_fn = _trans_solver(lu3, trans, a_dtype)
                residual_dtype = np.float64
                report.berr = berr3
                report.tiny_pivots = rep3.tiny_pivots
        else:
            report.rungs.append(RungRecord(
                name="refactor-rescale",
                detail=f"failed: info={info3}{err3}", berr_before=cur_berr,
                seconds=time.perf_counter() - t0))

    # the factors the delivered answer rests on
    report.gemm_precision = lu_eff.numeric.gemm_prec
    report.factor_dtype = _dtype_name(lu_eff.numeric.dtype)
    # serving metrics: one rung-transition counter per ladder action
    # this solve took (labeled by rung and whether it was adopted)
    m = get_metrics()
    if m.enabled:
        for r in report.rungs[rungs0:]:
            m.inc("slu_recovery_rungs_total", 1.0, rung=r.name,
                  improved=str(r.berr_after < r.berr_before).lower())
            m.observe("slu_recovery_rung_seconds", r.seconds, rung=r.name)
    return cur_x, lu_eff, solve_fn, residual_dtype


#: the least nnz for which refinement's residual runs on the card (the JAX
#: package's rule, drivers/gssvx.py:1116-1145)
DEVICE_SPMV_MIN_NNZ = 100_000


def refine_operator(lu: LUFactorization, a: SparseCSR, op: SparseCSR,
                    trans: Trans, residual_dtype):
    """The operator refinement takes its residual with: on the card, for
    ``op.nnz >= DEVICE_SPMV_MIN_NNZ``, a :class:`DeviceSpMV` cached on the
    handle per (trans, residual dtype) — a hit only while ``a.data`` is
    the array it was built from, so FACTORED reuse with new values does
    not refine against a stale upload; otherwise — and for factors
    offloaded to host memory, which solve on the host (the JAX driver's
    rule, drivers/gssvx.py:1122) — the host ``op``.  A failed upload
    raises: there is no host fallback."""
    if (lu.device.type != "cuda" or op.nnz < DEVICE_SPMV_MIN_NNZ
            or lu.numeric.on_host):
        return op
    key = (trans, str(np.dtype(residual_dtype)))
    cache = lu.dev_spmv if lu.dev_spmv is not None else {}
    hit = cache.get(key)
    if hit is not None and hit[0] is a.data:
        return hit[1]
    spmv = DeviceSpMV(op, dtype=np.result_type(op.data.dtype, residual_dtype),
                      device=lu.device)
    cache[key] = (a.data, spmv)
    lu.dev_spmv = cache
    return spmv


def _solve_and_refine(options: Options, a: SparseCSR, b: np.ndarray,
                      lu: LUFactorization, stats: Stats):
    """Solve through the factors, refine with a float64 residual (on the
    card through ``refine_operator`` for a large matrix, else on the
    host), run the ladder when refinement missed its target, estimate
    rcond/ferr under ``options.recovery.condest``; the SolveReport lands
    on stats.solve_report."""
    t_req0 = time.perf_counter()
    # TRANS and CONJ solve AᵀX=B / AᴴX=B through the same factors; the
    # refinement's residual then needs the transposed operator
    trans = options.trans
    if trans == Trans.NOTRANS:
        solve_fn, op = lu.solve_factored, a
    else:
        conj = trans == Trans.CONJ and np.iscomplexobj(a.data)
        solve_fn = _trans_solver(lu, trans, a.data.dtype)
        op = a.transpose()
        if conj:
            op = SparseCSR(op.n_rows, op.n_cols, op.indptr, op.indices,
                           op.data.conj())
    with stats.timer("SOLVE"):
        x = solve_fn(b)
    nrhs = 1 if b.ndim == 1 else b.shape[1]
    stats.ops["SOLVE"] += 4.0 * lu.sf.nnz_L * nrhs  # fwd+back L,U sweeps

    report = SolveReport(factor_dtype=_dtype_name(lu.numeric.dtype),
                         tiny_pivots=lu.numeric.tiny_pivots,
                         gemm_precision=lu.numeric.gemm_prec,
                         solve_route=lu.solve_route)
    if stats.resume:
        # a factorization resumed from a durable checkpoint is a ladder
        # action in its own right: the answer rests partly on restored
        # state, and the report says where it came from
        report.rungs.append(RungRecord(
            name="resume-from-checkpoint",
            detail=f"{stats.resume['groups']}/{stats.resume['of']} groups "
                   f"from {stats.resume['path']}"))
    stats.solve_report = report
    recovery = options.recovery
    lu_final = lu
    if options.iter_refine != IterRefine.NOREFINE:
        residual_dtype = (np.float32
                          if options.iter_refine == IterRefine.SLU_SINGLE
                          else np.dtype(options.ir_dtype))
        with stats.timer("REFINE"):
            ir_op = refine_operator(lu, a, op, trans, residual_dtype)
            report.residual_route = "host" if ir_op is op else "device"
            x, berrs = iterative_refinement(ir_op, b, x, solve_fn,
                                            residual_dtype=residual_dtype)
        stats.refine_steps += len(berrs)
        lu.berrs = berrs
        report.berr_history = list(berrs)
        report.berr = berrs[-1] if berrs else None
        target = (recovery.berr_target if recovery.berr_target
                  else float(tols.berr_target(residual_dtype)))
        report.target = target
        bad = (report.berr is None or report.berr > target
               or not np.all(np.isfinite(x)))
        if recovery.enabled and bad:
            x, lu_final, solve_fn, residual_dtype = _escalate(
                options, a, op, b, lu, stats, trans, solve_fn, x,
                residual_dtype, report, target)
        report.refine_steps = len(report.berr_history)
        report.converged = (report.berr is not None
                            and report.berr <= target)
    elif recovery.enabled and next_gemm_precision(lu.numeric.gemm_prec,
                                                  lu.device):
        # NOREFINE at a reduced GEMM tier still owes a gated answer: one
        # BERR probe, and the ladder on a miss (armed only where the tier
        # is a real gamble on this device: not the CPU's default tier)
        target = (recovery.berr_target if recovery.berr_target
                  else float(tols.berr_target(np.float64)))
        report.target = target
        try:
            report.berr = float(request_berrs(op, b, x).max())
        except ESTIMATE_ERRORS:
            report.berr = None
        if (report.berr is None or report.berr > target
                or not np.all(np.isfinite(x))):
            x, lu_final, solve_fn, _ = _escalate(
                options, a, op, b, lu, stats, trans, solve_fn, x,
                np.float64, report, target)
        report.converged = (report.berr is not None
                            and report.berr <= target)

    # rcond/ferr (the pdgscon + dgsrfs-FERR reporting): "always", or on
    # "auto" when the answer needs defending
    want_cond = (recovery.condest == "always"
                 or (recovery.condest == "auto"
                     and (report.rungs or report.tiny_pivots
                          or not report.converged)))
    if want_cond:
        report.rcond = condition_estimate(lu_final)
        adj_fn = _adjoint_solver(lu_final, trans, np.iscomplexobj(a.data))
        if adj_fn is not None and options.iter_refine != IterRefine.NOREFINE:
            try:
                report.ferr = ferr_estimate(op, b, x, solve_fn, adj_fn)
            except ESTIMATE_ERRORS:
                report.ferr = None

    # final non-finite sentinel: a silent NaN/Inf solution is the one
    # outcome the recovery policy exists to prevent
    report.finite = bool(np.all(np.isfinite(x)))
    if not report.finite and recovery.sentinels:
        raise NumericBreakdownError(where="solve")
    report.latency_ms = (time.perf_counter() - t_req0) * 1e3
    return x, lu_final, stats, 0
