"""Condition estimation and forward-error bounds on the computed factors.

Port of the JAX package's ``refine/condest.py``, the analog of ``pdgscon``
(SRC/pdgscon.c:95): estimate the reciprocal condition number
rcond = 1 / (‖A‖₁·‖A⁻¹‖₁) with the Hager–Higham 1-norm estimator
(LAPACK's dlacon/dlacn2 algorithm), with the device solves through the
factors as the black-box A⁻¹·v / A⁻ᴴ·v apply.  Also the ``ferr`` half of
the reference's expert-driver reporting (sequential dgsrfs.f:363-414): a
normwise forward-error bound per right-hand side, estimated through the
same machinery.

A failure of the estimate itself (a singular or non-finite solve) gives
rcond 0 / ferr inf; only the solver's own errors are caught, so a fault
of the card propagates.
"""

from __future__ import annotations

import numpy as np

from superlu_dist_tpu_torch.utils import tols
from superlu_dist_tpu_torch.utils.errors import SuperLUError

#: what a failed estimate may raise without being a fault of the card
ESTIMATE_ERRORS = (SuperLUError, FloatingPointError, np.linalg.LinAlgError)


def onenormest(n: int, apply, apply_adj, dtype=np.float64,
               itmax: int = 5) -> float:
    """Hager–Higham estimate of ‖Op‖₁ for a linear operator given only
    v ↦ Op·v (`apply`) and v ↦ Opᴴ·v (`apply_adj`).

    The dlacon iteration (Higham TOMS 1988): start from the uniform
    vector, follow the subgradient of ‖Op·x‖₁ uphill through adjoint
    applies, stop on repetition or stagnation; finish with the alternating
    lower bound that protects against adversarial cancellation
    (dlacon.f:160-176).  Never overestimates the true norm.
    """
    if n == 0:
        return 0.0
    cplx = np.issubdtype(np.dtype(dtype), np.complexfloating)
    x = np.full(n, 1.0 / n, dtype=dtype)
    est = 0.0
    j_old = -1
    for _ in range(itmax):
        y = np.asarray(apply(x))
        cur = float(np.abs(y).sum())
        if cur <= est:      # no growth — keep the best estimate seen
            break
        est = cur
        # subgradient: sign(y) (complex: y/|y|, 1 where y == 0)
        if cplx:
            ay = np.abs(y)
            xi = np.where(ay == 0, 1.0 + 0.0j, y / np.where(ay == 0, 1, ay))
        else:
            xi = np.where(y >= 0, 1.0, -1.0)
        z = np.asarray(apply_adj(xi.astype(dtype)))
        j = int(np.argmax(np.abs(z)))
        if np.abs(z[j]) <= np.real(z @ np.conj(x)) * (
                1 + float(tols.ONENORMEST_SLACK)):
            break           # converged: the subgradient test (dlacon.f:130)
        if j == j_old:
            break           # 2-cycle: e_j would repeat the last iterate
        j_old = j
        x = np.zeros(n, dtype=dtype)
        x[j] = 1.0
    # alternating-vector lower bound (dlacon.f:160-176)
    alt = ((-1.0) ** np.arange(n)) * (1.0 + np.arange(n) / max(n - 1, 1))
    y = np.asarray(apply(alt.astype(dtype)))
    est_alt = 2.0 * float(np.abs(y).sum()) / (3.0 * n)
    return max(est, est_alt)


def scaled_onenorm(a, R: np.ndarray, C: np.ndarray) -> float:
    """‖diag(R)·A·diag(C)‖₁ computed from the original matrix and the
    combined scalings (permutations do not change the 1-norm, so this is
    the norm of the factored matrix M without materializing it)."""
    rows = np.repeat(np.arange(a.n_rows), np.diff(a.indptr))
    colsum = np.zeros(a.n_cols)
    np.add.at(colsum, a.indices, np.abs(a.data) * np.abs(R)[rows])
    return float(np.max(colsum * np.abs(C))) if a.n_cols else 0.0


def condition_estimate(lu) -> float:
    """rcond of the factored (equilibrated/permuted) matrix M — the
    pdgscon analog (SRC/pdgscon.c:95).  Returns 1/(‖M‖₁·est(‖M⁻¹‖₁)),
    0.0 when the factorization is singular/non-finite, 1.0 for n == 0.

    The apply is the handle's permuted-domain device solve
    (LUFactorization._solve_permuted), the adjoint apply the transposed
    solve through the same factors (pdgscon's kase=2 branch)."""
    if lu.numeric is None or not lu.numeric.finite:
        return 0.0
    n = lu.n
    if n == 0:
        return 1.0
    anorm = scaled_onenorm(lu.a, lu.R, lu.C) if lu.a is not None else 0.0
    if anorm == 0.0:
        return 0.0
    cplx = lu.numeric.dtype.is_complex
    dtype = np.complex128 if cplx else np.float64

    def apply(v):
        return lu._solve_permuted(np.asarray(v, dtype=dtype))

    def apply_adj(v):
        return lu._solve_permuted_trans(np.asarray(v, dtype=dtype),
                                        conj=cplx)

    try:
        inv_norm = onenormest(n, apply, apply_adj, dtype=dtype)
    except ESTIMATE_ERRORS:
        return 0.0              # the solve blew up: treat as singular
    if not np.isfinite(inv_norm) or inv_norm == 0.0:
        return 0.0
    return float(min(1.0, 1.0 / (anorm * inv_norm)))


def ferr_estimate(op, b: np.ndarray, x: np.ndarray, solve_fn,
                  solve_trans_fn, residual_dtype=np.float64) -> list:
    """Normwise forward-error bounds per RHS (dgsrfs.f:363-414).

    For each column: ferr_k bounds ‖x_k − x*_k‖∞/‖x_k‖∞ by estimating
    ‖A⁻¹·diag(f)‖∞ with f = |r| + nz·eps·(|A|·|x| + |b|) — the residual
    plus the rounding cloud of computing it — via the 1-norm estimator on
    the adjoint operator (‖B‖∞ = ‖Bᴴ‖₁).  `op` is the (possibly
    transposed) operator the system was solved with; solve_fn/
    solve_trans_fn apply op⁻¹ and op⁻ᴴ through the factors.
    """
    b = np.asarray(b)
    squeeze = b.ndim == 1
    b2 = b[:, None] if squeeze else b
    x2 = np.asarray(x)
    x2 = x2[:, None] if squeeze else x2
    n, nrhs = b2.shape
    eps = float(np.finfo(np.dtype(residual_dtype)).eps)
    nz = max(int(np.diff(op.indptr).max()) if op.n_rows else 0, 1) + 1
    cplx = (np.issubdtype(b2.dtype, np.complexfloating)
            or np.issubdtype(x2.dtype, np.complexfloating))
    dtype = np.complex128 if cplx else np.float64
    ferrs = []
    for k in range(nrhs):
        xk = x2[:, k].astype(dtype)
        rk = b2[:, k].astype(dtype) - op.matvec(xk)
        f = np.abs(rk) + nz * eps * (op.abs_matvec(np.abs(xk))
                                     + np.abs(b2[:, k]))
        xnorm = float(np.max(np.abs(xk))) if n else 0.0
        if xnorm == 0.0 or not np.all(np.isfinite(f)):
            ferrs.append(float("inf"))
            continue

        # ‖A⁻¹ D_f‖∞ = ‖(A⁻¹ D_f)ᴴ‖₁ = ‖D_f A⁻ᴴ‖₁
        def apply(v, f=f):
            return f * np.asarray(solve_trans_fn(np.asarray(v, dtype=dtype)))

        def apply_adj(v, f=f):
            return np.asarray(solve_fn(f * np.asarray(v, dtype=dtype)))

        try:
            est = onenormest(n, apply, apply_adj, dtype=dtype)
        except ESTIMATE_ERRORS:
            ferrs.append(float("inf"))
            continue
        ferrs.append(float(min(est / xnorm, 1.0 / eps)))
    return ferrs
