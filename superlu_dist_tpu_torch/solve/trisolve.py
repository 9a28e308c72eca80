"""Supernodal triangular solves on the host, for offloaded factors.

Port of the JAX package's ``solve/trisolve.py``.  The port solves factors
that lie on the card there (solve/device.py); factors that the streamed
executor moved to host memory (``NumericFactorization.on_host``) are
solved here, where they lie, as the JAX driver does
(drivers/gssvx.py:180-187).

The forward solve L·y = d visits the supernodes in column order (children
first), the backward solve U·x = y in reverse — the capability analog of
pdgstrs (SRC/pdgstrs.c:838) and its lsum kernels, one dense triangular
solve and one GEMM per supernode.

Solves run in float64 on the host regardless of factor dtype: factors are
promoted on pull, which costs nothing extra at solve time and keeps
iterative refinement's correction solves stable.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import solve_triangular

from superlu_dist_tpu_torch.numeric.factor import NumericFactorization


def _promote(fact, rhs):
    return np.array(rhs, dtype=np.promote_types(
        np.asarray(rhs).dtype,
        np.complex128 if fact.dtype.is_complex else np.float64))


def lu_solve_trans(fact: NumericFactorization, rhs: np.ndarray,
                   conj: bool = False) -> np.ndarray:
    """Solve (L·U)ᵀ x = rhs (or (L·U)ᴴ x with conj=True), permuted labeling.

    The reference solves AᵀX = B through the same factors (trans_t,
    superlu_defs.h:628-657): Mᵀ = Uᵀ·Lᵀ, so the forward sweep is with Uᵀ
    (lower triangular) walking supernodes ascending, the backward sweep
    with Lᵀ (unit upper) descending — the mirror of lu_solve using the U12
    blocks on the way down and L21 on the way up.
    """
    plan = fact.plan
    sf = plan.sf
    hosts = fact.pull_to_host()
    y = _promote(fact, rhs)
    squeeze = y.ndim == 1
    if squeeze:
        y = y[:, None]
    ns = sf.n_supernodes
    first = sf.sn_start[:-1]
    last = sf.sn_start[1:] - 1

    def blocks(s):
        grp = plan.groups[plan.sn_group[s]]
        lp, up = hosts[plan.sn_group[s]]
        lp, up = lp[plan.sn_slot[s]], up[plan.sn_slot[s]]
        w = int(last[s] - first[s] + 1)
        u = len(sf.sn_rows[s])
        W = grp.w
        f11 = lp[:w, :w]
        l21 = lp[W:W + u, :w]
        u12 = up[:w, :u]
        if conj:
            f11, l21, u12 = f11.conj(), l21.conj(), u12.conj()
        return f11, l21, u12, w, u

    # forward: Uᵀ y = d, supernodes ascending (Uᵀ is lower triangular)
    for s in range(ns):
        f11, l21, u12, w, u = blocks(s)
        cols = slice(int(first[s]), int(last[s]) + 1)
        # triangular solve, not LAPACK getrf (np.linalg.solve): the
        # per-supernode blocks make this loop the whole solve cost
        yj = solve_triangular(f11, y[cols], trans=1, lower=False,
                              check_finite=False)
        y[cols] = yj
        if u:
            y[sf.sn_rows[s]] -= u12.astype(yj.dtype).T @ yj

    # backward: Lᵀ x = y, descending (Lᵀ is unit upper triangular)
    for s in range(ns - 1, -1, -1):
        f11, l21, u12, w, u = blocks(s)
        cols = slice(int(first[s]), int(last[s]) + 1)
        t = y[cols]
        if u:
            t = t - l21.astype(t.dtype).T @ y[sf.sn_rows[s]]
        y[cols] = solve_triangular(f11, t, trans=1, lower=True,
                                   unit_diagonal=True, check_finite=False)

    return y[:, 0] if squeeze else y


def lu_solve(fact: NumericFactorization, rhs: np.ndarray) -> np.ndarray:
    """Solve (L·U) x = rhs for rhs (n,) or (n, k), in the factor's permuted
    labeling."""
    plan = fact.plan
    sf = plan.sf
    hosts = fact.pull_to_host()
    y = _promote(fact, rhs)
    squeeze = y.ndim == 1
    if squeeze:
        y = y[:, None]
    ns = sf.n_supernodes
    first = sf.sn_start[:-1]
    last = sf.sn_start[1:] - 1

    def blocks(s):
        grp = plan.groups[plan.sn_group[s]]
        lp, up = hosts[plan.sn_group[s]]
        lp, up = lp[plan.sn_slot[s]], up[plan.sn_slot[s]]
        w = int(last[s] - first[s] + 1)
        u = len(sf.sn_rows[s])
        W = grp.w
        f11 = lp[:w, :w]
        l21 = lp[W:W + u, :w]
        u12 = up[:w, :u]
        return f11, l21, u12, w, u

    # forward: supernodes in column order = topological (children first)
    for s in range(ns):
        f11, l21, u12, w, u = blocks(s)
        cols = slice(int(first[s]), int(last[s]) + 1)
        yj = solve_triangular(f11, y[cols], lower=True,
                              unit_diagonal=True, check_finite=False)
        y[cols] = yj
        if u:
            y[sf.sn_rows[s]] -= l21.astype(yj.dtype) @ yj

    # backward: reverse order (parents before children)
    for s in range(ns - 1, -1, -1):
        f11, l21, u12, w, u = blocks(s)
        cols = slice(int(first[s]), int(last[s]) + 1)
        t = y[cols]
        if u:
            t = t - u12.astype(t.dtype) @ y[sf.sn_rows[s]]
        y[cols] = solve_triangular(f11, t, lower=False,
                                   check_finite=False)

    return y[:, 0] if squeeze else y
