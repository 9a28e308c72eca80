"""Iterative refinement.

Analog of pdgsrfs (SRC/pdgsrfs.c:120): classical IR with componentwise
backward error.  r = b − A·x is computed in float64 (the analog of the
reference's double-precision residual in IterRefine=SLU_DOUBLE), the
correction solves reuse the factors, and iteration stops when
berr = max_i |r|_i / (|A|·|x| + |b|)_i reaches eps, stops improving by 2×
(reference :232), or after ITMAX=20 steps (reference :126).

On the card this is the half of the mixed-precision design that recovers
f64 accuracy from f32 factors: the factorization runs in float32 on the
device, the cheap SpMV residual is float64 — on the host, or, for a large
matrix, on the card through ``parallel/dist.DeviceSpMV`` (the driver
picks the operator ``a``; both present matvec/abs_matvec/nnz).  Complex
systems refine with a complex residual (complex128 under a float64
residual dtype, complex64 under SLU_SINGLE).
"""

from __future__ import annotations

import numpy as np

from superlu_dist_tpu_torch.sparse.formats import SparseCSR
from superlu_dist_tpu_torch.utils import tols

ITMAX = 20


def componentwise_berr(r: np.ndarray, den: np.ndarray, nnz: int,
                       residual_dtype=np.float64):
    """max_i |r_i| / den_i with the reference's underflow guard
    (pdgsrfs.c:225 / dgsrfs.f:214): denominators at or below
    safe1·safmin = (nnz+1)·safmin are bumped by that amount, so an
    exactly-zero row reports berr 0 instead of 0/0 while a *tiny*
    denominator is not rounded up to 1 (which understates berr).  For
    (n, k) arrays: the k per-column values."""
    safmin = tols.safmin(residual_dtype)
    bump = (nnz + 1) * safmin
    den = np.where(den <= bump, den + bump, den)
    out = np.max(np.abs(r) / den, axis=0)
    return float(out) if np.ndim(out) == 0 else out


def _normalize_correction(dx, n: int, ncols: int) -> np.ndarray:
    """Normalize a correction-solve result to (n, ncols).

    solve_fn implementations legitimately squeeze a single remaining
    column to (n,) (the host/device solvers mirror b's ndim); anything
    else that doesn't match is a real contract violation and must fail
    loudly here rather than broadcast garbage into the iterate."""
    dx = np.asarray(dx)
    if dx.ndim == 1:
        dx = dx[:, None]
    if dx.shape != (n, ncols):
        raise ValueError(
            f"correction solve returned shape {np.asarray(dx).shape}, "
            f"expected ({n}, {ncols})")
    return dx


def request_berrs(a: SparseCSR, b: np.ndarray, x: np.ndarray,
                  residual_dtype=np.float64) -> np.ndarray:
    """Per-column componentwise backward errors of x against A·x = b: one
    SpMV pair for all columns (the refactor canary's and the NOREFINE
    gate's probe).  The residual is complex for complex data."""
    b2 = b[:, None] if b.ndim == 1 else b
    x2 = x[:, None] if x.ndim == 1 else x
    r = (b2 - a.matvec(x2)).astype(np.promote_types(b2.dtype,
                                                    residual_dtype))
    out = np.empty(b2.shape[1])
    for k in range(b2.shape[1]):
        den = a.abs_matvec(np.abs(x2[:, k])) + np.abs(b2[:, k])
        out[k] = componentwise_berr(r[:, k], den.real, a.nnz,
                                    residual_dtype)
    return out


def refine_ticket(a, b: np.ndarray, x: np.ndarray, solve_fn,
                  berr_target: float, itmax: int = ITMAX,
                  residual_dtype=np.float64):
    """Per-ticket IR rung for the serving tier: refine ONE request's
    columns through the factored solve until its componentwise berr
    meets ``berr_target`` (or IR's own stopping rules fire), without
    touching any other ticket of the micro-batch.  ``a`` is a
    :class:`SparseCSR` or anything with its ``matvec`` / ``abs_matvec``
    / ``nnz`` surface — on the card the server passes a
    ``parallel.dist.DeviceSpMV``, so the residuals run through
    ``csr_spmv``.

    Returns ``(x_out, berr_before, berr_after, adopted)``.  The ladder's
    adoption discipline applies: the refined iterate is returned only
    when it strictly improved the worst column's berr; otherwise the
    original x comes back unchanged (``adopted=False``) so a
    non-converging refinement can never make a served answer worse."""
    from superlu_dist_tpu_torch.obs.trace import get_tracer
    with get_tracer().span("refine-ticket", cat="request",
                           berr_target=berr_target) as sp:
        berr_before = float(
            request_berrs(a, b, x, residual_dtype=residual_dtype).max())
        if berr_before <= berr_target:
            sp.set(berr_before=berr_before, adopted=False)
            return x, berr_before, berr_before, False
        x_ref, _hist = iterative_refinement(
            a, b, x, solve_fn, itmax=itmax,
            residual_dtype=residual_dtype)
        x_ref = np.asarray(x_ref).astype(np.asarray(x).dtype, copy=False)
        berr_after = float(
            request_berrs(a, b, x_ref,
                          residual_dtype=residual_dtype).max())
        adopted = berr_after < berr_before
        sp.set(berr_before=berr_before, berr_after=berr_after,
               adopted=adopted, iters=len(_hist))
    if adopted:
        return x_ref, berr_before, berr_after, True
    return x, berr_before, berr_before, False


def iterative_refinement(a: SparseCSR, b: np.ndarray, x: np.ndarray,
                         solve_fn, itmax: int = ITMAX,
                         residual_dtype=np.float64):
    """Refine solve_fn-based solution x of A·x = b.

    solve_fn(r) must solve A·dx = r using the existing factorization
    (including all scalings/permutations).  residual_dtype picks the
    precision of the residual/accumulation (the reference's
    SLU_SINGLE/SLU_DOUBLE tiers).  Returns (x, berr_history).
    """
    residual_dtype = np.dtype(residual_dtype)
    b = np.asarray(b)
    squeeze = b.ndim == 1
    b2 = b[:, None] if squeeze else b
    work = np.promote_types(b.dtype, residual_dtype)
    if residual_dtype == np.float32:
        # SLU_SINGLE caps the working precision at single even for f64 input
        work = (np.complex64 if np.issubdtype(work, np.complexfloating)
                else np.float32)
    x2 = (x[:, None] if squeeze else x).astype(work, copy=True)
    eps = tols.eps(residual_dtype)
    nrhs = b2.shape[1]
    berrs = []
    # per-RHS stopping state, like the reference's outer loop over RHS
    # columns (pdgsrfs.c:126): one stagnating column must not halt others
    lstres = np.full(nrhs, np.inf)
    active = np.ones(nrhs, dtype=bool)
    for _ in range(itmax):
        # the residual is rounded to the working precision (SLU_SINGLE
        # => f32): the refinement then cannot see — and so cannot correct —
        # anything below single eps, the reference's tier semantics
        r = (b2 - a.matvec(x2)).astype(work)
        # componentwise backward error per rhs (pdgsrfs.c:213-231), all
        # columns in one |A|·|x| product (each column's sums as its own)
        den = (a.abs_matvec(np.abs(x2)) + np.abs(b2)).astype(x2.real.dtype)
        berr = np.asarray(componentwise_berr(r, den, a.nnz, residual_dtype),
                          dtype=np.float64)
        berrs.append(berr.copy())
        active &= (berr > eps) & (berr < lstres / 2.0)
        if not active.any():
            break
        lstres = np.where(active, berr, lstres)
        dx = _normalize_correction(solve_fn(r[:, active]), len(x2),
                                   int(active.sum()))
        x2[:, active] = x2[:, active] + dx
    berrs = [float(b.max()) for b in berrs]
    return (x2[:, 0] if squeeze else x2), berrs
