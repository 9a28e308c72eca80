"""Equilibration: row/column scaling so that max |row| and |col| are ~1.

Analogs of pdgsequ (SRC/pdgsequ.c:86) and pdlaqgs (SRC/pdlaqgs.c), which
follow LAPACK dgeequ/dlaqgs semantics: R_i = 1/max_j|a_ij|,
C_j = 1/max_i(R_i |a_ij|); scaling is applied only when the row/col
condition estimates or the matrix magnitude warrant it (THRESH=0.1).
"""

from __future__ import annotations

import numpy as np

from superlu_dist_tpu_torch.sparse.formats import SparseCSR
from superlu_dist_tpu_torch.utils.errors import SuperLUError

_THRESH = 0.1


def gsequ(a: SparseCSR):
    """Compute scalings (r, c, rowcnd, colcnd, amax).  pdgsequ analog."""
    n, m = a.shape
    rows = np.repeat(np.arange(n), np.diff(a.indptr))
    absa = np.abs(a.data)
    rowmax = np.zeros(n)
    np.maximum.at(rowmax, rows, absa)
    if np.any(rowmax == 0):
        raise SuperLUError(f"row {int(np.argmin(rowmax != 0))} of A is exactly zero")
    r = 1.0 / rowmax
    colmax = np.zeros(m)
    np.maximum.at(colmax, a.indices, absa * r[rows])
    if np.any(colmax == 0):
        raise SuperLUError(f"column {int(np.argmin(colmax != 0))} of A is exactly zero")
    c = 1.0 / colmax
    smlnum = np.finfo(np.float64).tiny
    bignum = 1.0 / smlnum
    rowcnd = max(r.min(), smlnum) / min(r.max(), bignum)
    colcnd = max(c.min(), smlnum) / min(c.max(), bignum)
    amax = float(absa.max(initial=0.0))
    return r, c, float(rowcnd), float(colcnd), amax


def laqgs(a: SparseCSR, r, c, rowcnd, colcnd, amax):
    """Decide + apply scaling; returns (A_scaled, equed) with equed in
    {'N','R','C','B'} — pdlaqgs analog (LAPACK dlaqgs decision rule)."""
    small = np.finfo(np.float64).tiny / np.finfo(np.float64).eps
    large = 1.0 / small
    do_row = rowcnd < _THRESH
    do_col = colcnd < _THRESH or amax < small or amax > large
    if not do_row and not do_col:
        return a, "N"
    out = a
    if do_row:
        out = out.row_scale(r)
    if do_col:
        out = out.col_scale(c)
    equed = {(True, False): "R", (False, True): "C", (True, True): "B"}[(do_row, do_col)]
    return out, equed
