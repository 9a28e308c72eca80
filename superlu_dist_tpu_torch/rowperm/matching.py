"""Maximum-product bipartite matching for static pivoting ("MC64 job=5").

Capability analog of dldperm_dist + the f2c'd HSL kernel mc64ad_dist
(SRC/dldperm_dist.c:95, SRC/mc64ad_dist.c:121), used for
RowPerm=LargeDiag_MC64: find a row permutation maximizing the product of
diagonal magnitudes, plus row/col scalings (from the LP duals) that make the
matched entries ±1 and all others ≤ 1 in magnitude.  This is
successive-shortest-augmenting-path matching (sparse Hungarian/LAPJV with
potentials) on costs c_ij = log(colmax_j / |a_ij|), in Python.

Like the reference (which runs MC64 serially on rank 0 and broadcasts,
pdgssvx.c:812-833), this runs on the host.
"""

from __future__ import annotations

import heapq

import numpy as np

from superlu_dist_tpu_torch.sparse.formats import SparseCSC
from superlu_dist_tpu_torch.utils.errors import SuperLUError


def maximum_product_matching(a, want_scalings: bool = True):
    """Return (row_order, r, c).

    ``row_order[j]`` is the original row to place at position j, so that
    ``A[row_order, :]`` has the matched (maximum-product) entries on its
    diagonal.  ``r``/``c`` are the MC64 job=5 scaling vectors: with
    B = diag(r) · A · diag(c), every matched entry of B is ±1 (or unit
    modulus, complex) and all entries have magnitude ≤ 1.
    """
    csc = a if isinstance(a, SparseCSC) else a.tocsc()
    n, m = csc.shape
    if n != m:
        raise SuperLUError("matching requires a square matrix")
    indptr, indices = csc.indptr, csc.indices
    absval = np.abs(csc.data).astype(np.float64)

    colmax = np.zeros(n)
    cols = np.repeat(np.arange(n), np.diff(indptr))
    np.maximum.at(colmax, cols, absval)
    if np.any(colmax == 0):
        raise SuperLUError("structurally singular: empty column")

    # costs: c_k = log(colmax_j) - log|a_k| >= 0; explicit zeros excluded
    with np.errstate(divide="ignore"):
        cost = np.log(colmax[cols]) - np.log(absval)   # +inf for zeros

    INF = np.inf
    u = np.zeros(n)            # column duals
    v = np.zeros(n)            # row duals
    row_match = np.full(n, -1, dtype=np.int64)   # row -> col
    col_match = np.full(n, -1, dtype=np.int64)   # col -> row

    dist = np.empty(n)
    pred = np.empty(n, dtype=np.int64)
    done = np.empty(n, dtype=bool)

    for j0 in range(n):
        dist.fill(INF)
        pred.fill(-1)
        done.fill(False)
        tree_cols = [j0]
        d_col = {j0: 0.0}
        heap = []

        def relax(j, base):
            for k in range(indptr[j], indptr[j + 1]):
                if not np.isfinite(cost[k]):
                    continue
                i = indices[k]
                if done[i]:
                    continue
                nd = base + cost[k] - u[j] - v[i]
                if nd < dist[i] - 1e-30:
                    dist[i] = nd
                    pred[i] = j
                    heapq.heappush(heap, (nd, int(i)))

        relax(j0, 0.0)
        found = -1
        while heap:
            d, i = heapq.heappop(heap)
            if done[i] or d > dist[i]:
                continue
            done[i] = True
            if row_match[i] == -1:
                found = i
                break
            jnext = int(row_match[i])
            tree_cols.append(jnext)
            d_col[jnext] = d
            relax(jnext, d)
        if found == -1:
            raise SuperLUError("structurally singular: no perfect matching")
        mind = dist[found]
        # dual updates keep reduced costs >= 0 with matched edges tight
        scanned = done & (dist <= mind)
        v[scanned] += dist[scanned] - mind
        for j in tree_cols:
            u[j] += mind - d_col[j]
        # augment along the alternating path
        i = found
        while i != -1:
            j = int(pred[i])
            inext = col_match[j]
            row_match[i] = j
            col_match[j] = i
            i = int(inext)
            if j == j0:
                break

    row_order = col_match.copy()      # position j <- original row matched to col j
    if not want_scalings:
        return row_order, None, None
    return (row_order,) + _scalings_from_duals(u, v, colmax)


def _scalings_from_duals(u: np.ndarray, v: np.ndarray, colmax: np.ndarray):
    """r_i = exp(v_i), c_j = exp(u_j)/colmax_j => matched |r_i a_ij c_j| = 1
    (the MC64 job=5 scaling recovery)."""
    cap = 700.0                       # keep exp() finite
    r = np.exp(np.clip(v, -cap, cap))
    c = np.exp(np.clip(u - np.log(colmax), -cap, cap))
    return r, c
