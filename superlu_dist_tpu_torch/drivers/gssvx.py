"""Expert driver: the full solve pipeline, on the device.

Port of the JAX package's ``drivers/gssvx.py`` (the pdgssvx analog,
SRC/pdgssvx.c:505) for Fact=DOFACT and the non-transposed system:
equilibrate → row-permute (maximum product matching with scalings) →
column-order → symbolic → plan ("distribute") → numeric factor on the
device → device triangular solve → float64 iterative refinement on the
host.  There is no escalation ladder and no host-solve fallback: a
failure raises.

Permutation algebra (as in the JAX package): with equilibration scalings
Dr, Dc, matching scalings r1, c1 and row order ρ, the factored matrix is
    M = Pπ · (diag(R) A diag(C))[ρ] · Pπᵀ,  R = r1·dr, C = dc·c1
where π is the fill-reducing + postorder column permutation.  Then
A·x = b is solved as
    d = (R ⊙ b)[ρ][π] ;  M·ẑ = d ;  z[π] = ẑ ;  x = C ⊙ z.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from superlu_dist_tpu_torch.numeric.factor import (NumericFactorization,
                                                   numeric_factorize)
from superlu_dist_tpu_torch.numeric.plan import FactorPlan, build_plan
from superlu_dist_tpu_torch.ordering.dispatch import get_perm_c
from superlu_dist_tpu_torch.refine.ir import iterative_refinement
from superlu_dist_tpu_torch.rowperm.equil import gsequ, laqgs
from superlu_dist_tpu_torch.rowperm.matching import maximum_product_matching
from superlu_dist_tpu_torch.solve.device import DeviceSolver
from superlu_dist_tpu_torch.sparse.formats import SparseCSR, symmetrize_pattern
from superlu_dist_tpu_torch.symbolic.symbfact import (SymbolicFact,
                                                      symbolic_factorize)
from superlu_dist_tpu_torch.utils.errors import (SingularMatrixError,
                                                 SuperLUError)
from superlu_dist_tpu_torch.utils.options import (Fact, IterRefine, Options,
                                                  RowPerm,
                                                  default_factor_dtype,
                                                  resolve_device)
from superlu_dist_tpu_torch.utils.stats import Stats


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
    berrs: list = None        # backward errors of the last refinement
    dev_solver: DeviceSolver = None

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
        """Solve A·x = b through the factored M on the device (no
        refinement)."""
        if not self.numeric.finite:
            raise SingularMatrixError(self.numeric.info_col)
        b = np.asarray(b)
        d = b * (self.R[:, None] if b.ndim > 1 else self.R)
        d = d[self.sigma]
        if self.dev_solver is None:
            self.dev_solver = DeviceSolver(self.numeric)
        z_hat = self.dev_solver.solve(d)
        z = np.empty_like(z_hat)
        z[self.sf.perm] = z_hat
        return z * (self.C[:, None] if b.ndim > 1 else self.C)


def analyze(options: Options, a: SparseCSR, device="cuda",
            stats: Stats | None = None):
    """The host analysis phases: EQUIL → ROWPERM → COLPERM → SYMBFACT →
    DIST/plan (pdgssvx.c:647-1166 before pdgstrf).  Returns
    ``(lu, bvals, stats)``: an LUFactorization skeleton (numeric=None) and
    the structurally-permuted values ready for factorize_numeric."""
    device = resolve_device(device)
    if stats is None:
        stats = Stats()
    n = a.n_rows
    if a.n_cols != n:
        raise SuperLUError("A must be square")
    if options.fact != Fact.DOFACT:
        raise NotImplementedError(
            f"Fact.{options.fact.name} is not ported yet; the port runs "
            "Fact.DOFACT (ROADMAP.md)")

    with stats.timer("EQUIL"):
        if options.equil:
            r, c, rowcnd, colcnd, amax = gsequ(a)
            a1, equed = laqgs(a, r, c, rowcnd, colcnd, amax)
            dr = r if equed in ("R", "B") else np.ones(n)
            dc = c if equed in ("C", "B") else np.ones(n)
        else:
            a1, equed = a, "N"
            dr = dc = np.ones(n)

    with stats.timer("ROWPERM"):
        if options.row_perm == RowPerm.LargeDiag_MC64:
            row_order, r1, c1 = maximum_product_matching(a1)
            a2 = a1.row_scale(r1).col_scale(c1).permute(perm_r=row_order)
        elif options.row_perm == RowPerm.MY_PERMR:
            row_order = np.asarray(options.user_perm_r, dtype=np.int64)
            r1 = c1 = np.ones(n)
            a2 = a1.permute(perm_r=row_order)
        elif options.row_perm == RowPerm.NOROWPERM:
            row_order = np.arange(n, dtype=np.int64)
            r1 = c1 = np.ones(n)
            a2 = a1
        else:
            raise NotImplementedError(
                f"RowPerm.{options.row_perm.name} is not ported yet "
                "(ROADMAP.md)")

    anorm = a2.norm_max()
    sym = symmetrize_pattern(a2)

    with stats.timer("COLPERM"):
        col_order = get_perm_c(options, a2, sym)

    et0 = stats.utime["ETREE"]
    with stats.timer("SYMBFACT"):
        sf = symbolic_factorize(sym, col_order, relax=options.relax,
                                max_supernode=options.max_supernode,
                                stats=stats, amalg_tol=options.amalg_tol)
    # phases are disjoint like the reference's PhaseType: the etree part
    # timed inside symbolic_factorize is carved out of SYMBFACT
    stats.utime["SYMBFACT"] -= stats.utime["ETREE"] - et0

    with stats.timer("DIST"):
        plan = build_plan(sf, min_bucket=options.min_bucket,
                          growth=options.bucket_growth,
                          schedule=options.schedule,
                          window=options.sched_window,
                          align=options.sched_align)
        bvals = sym.data[sf.value_perm]

    lu = LUFactorization(n=n, options=options, device=device, equed=equed,
                         dr=dr, dc=dc, r1=r1, c1=c1, row_order=row_order,
                         col_order=col_order, sf=sf, plan=plan, anorm=anorm)
    return lu, bvals, stats


def factorize_numeric(lu: LUFactorization, bvals: np.ndarray,
                      stats: Stats | None = None) -> int:
    """Numeric factorization (pdgssvx.c:1176 → pdgstrf) of an analyzed
    skeleton on its device.  Fills lu.numeric; returns info (0, or the
    1-based first zero-pivot column)."""
    if stats is None:
        stats = Stats()
    options = lu.options
    dtype = (getattr(torch, options.factor_dtype) if options.factor_dtype
             else default_factor_dtype(lu.device))
    with stats.timer("FACT"):
        numeric = numeric_factorize(
            lu.plan, bvals, lu.anorm, dtype=dtype, device=lu.device,
            replace_tiny=options.replace_tiny_pivot,
            gemm_prec=options.gemm_prec)
        if lu.device.type == "cuda":
            torch.cuda.synchronize(lu.device)
    stats.ops["FACT"] += lu.plan.flops
    stats.tiny_pivots += numeric.tiny_pivots
    lu.numeric = numeric
    lu.dev_solver = None
    if not numeric.finite:
        return numeric.info_col + 1
    return 0


def _solve_and_refine(options: Options, a: SparseCSR, b: np.ndarray,
                      lu: LUFactorization, stats: Stats):
    """Solve through the factors, then refine with a float64 residual on
    the host; lu.berrs holds the componentwise backward errors."""
    with stats.timer("SOLVE"):
        x = lu.solve_factored(b)
    nrhs = 1 if b.ndim == 1 else b.shape[1]
    stats.ops["SOLVE"] += 4.0 * lu.sf.nnz_L * nrhs  # fwd+back L,U sweeps
    if options.iter_refine != IterRefine.NOREFINE:
        residual_dtype = (np.float32
                          if options.iter_refine == IterRefine.SLU_SINGLE
                          else np.dtype(options.ir_dtype))
        with stats.timer("REFINE"):
            x, berrs = iterative_refinement(a, b, x, lu.solve_factored,
                                            residual_dtype=residual_dtype)
        stats.refine_steps += len(berrs)
        lu.berrs = berrs
    return x, lu, stats, 0


def gssvx(options: Options, a: SparseCSR, b: np.ndarray, device="cuda",
          stats: Stats | None = None):
    """Solve A·X = B on ``device``.  Returns (x, lu, stats, info).

    info = 0 on success, or the 1-based first zero-pivot column when
    ReplaceTinyPivot is off and U is exactly singular (x is None then).
    device="cuda" without a card raises; only device="cpu" runs on the
    CPU."""
    device = resolve_device(device)
    if stats is None:
        stats = Stats()
    b = np.asarray(b)
    if b.shape[0] != a.n_rows:
        raise SuperLUError("B leading dimension must match A")
    lu, bvals, stats = analyze(options, a, device=device, stats=stats)
    info = factorize_numeric(lu, bvals, stats)
    if info != 0:
        return None, lu, stats, info
    return _solve_and_refine(options, a, b, lu, stats)
