"""Sparse matrix storage formats (host side, numpy).

Analog of the reference's SuperMatrix storage types (SRC/supermatrix.h):
``NCformat`` (compressed column) -> :class:`SparseCSC`, ``NRformat``
(compressed row) -> :class:`SparseCSR`.  The distributed row-block format
``NRformat_loc`` (supermatrix.h:175-188) is not ported yet.

scipy is deliberately not a dependency; conversions are implemented with
numpy counting sorts.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# analog of int_t (superlu_defs.h:80-93) at its default 32-bit width.  Pattern
# INDICES only — each one is bounded by n.  Anything that ACCUMULATES
# (indptr prefix sums, nnz totals) is unconditionally int64 via
# counts_to_indptr: nnz(A) exceeds int32 long before n does, and an
# int32 indptr wraps silently.
INT = np.int32


def counts_to_indptr(counts: np.ndarray) -> np.ndarray:
    """(n,) or (n+1,) leading-zero per-row/col counts -> int64 indptr.

    The one prefix-sum accumulator for every CSR/CSC build: int64
    regardless of the INT index width, so nnz > 2^31 structures keep
    exact offsets with int32 indices."""
    return np.cumsum(np.asarray(counts), dtype=np.int64)


def _aggregate_coo(n_rows, n_cols, rows, cols, vals):
    """Sum duplicate (row, col) entries; return sorted-by-(major) arrays."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    if rows.size == 0:
        return rows.astype(INT), cols.astype(INT), vals
    key = rows * n_cols + cols
    order = np.argsort(key, kind="stable")
    key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
    uniq_mask = np.empty(key.shape, dtype=bool)
    uniq_mask[0] = True
    np.not_equal(key[1:], key[:-1], out=uniq_mask[1:])
    group = np.cumsum(uniq_mask) - 1
    out_vals = np.zeros(int(group[-1]) + 1, dtype=vals.dtype)
    np.add.at(out_vals, group, vals)
    return rows[uniq_mask].astype(INT), cols[uniq_mask].astype(INT), out_vals


@dataclasses.dataclass
class SparseCSR:
    """Compressed sparse row (reference NRformat / NRformat_loc local part)."""

    n_rows: int
    n_cols: int
    indptr: np.ndarray   # (n_rows+1,)
    indices: np.ndarray  # column indices, sorted within each row
    data: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self):
        return self.data.dtype

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n_rows, self.n_cols), dtype=self.data.dtype)
        rows = np.repeat(np.arange(self.n_rows), np.diff(self.indptr))
        out[rows, self.indices] = self.data
        return out

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """y = A @ x (supports (n,) and (n, k)).  Host SpMV — the analog of
        pdgsmv (SRC/pdgsmv.c:234) used by iterative refinement."""
        x = np.asarray(x)
        rows = np.repeat(np.arange(self.n_rows), np.diff(self.indptr))
        contrib = (self.data[:, None] * x[self.indices].reshape(len(self.indices), -1)
                   if x.ndim > 1 else self.data * x[self.indices])
        out_shape = (self.n_rows,) + x.shape[1:]
        out = np.zeros((self.n_rows,) + ((contrib.shape[1],) if x.ndim > 1 else ()),
                       dtype=np.result_type(self.data, x))
        np.add.at(out, rows, contrib)
        return out.reshape(out_shape)

    def abs_matvec(self, x: np.ndarray) -> np.ndarray:
        """|A| @ x (supports (n,) and (n, k)), used for the backward-error
        bound (pdgsrfs.c:213-231)."""
        x = np.asarray(x)
        rows = np.repeat(np.arange(self.n_rows), np.diff(self.indptr))
        absa = np.abs(self.data)
        contrib = (absa[:, None] * x[self.indices] if x.ndim > 1
                   else absa * x[self.indices])
        out = np.zeros((self.n_rows,) + x.shape[1:],
                       dtype=np.result_type(self.data.real, x))
        np.add.at(out, rows, contrib)
        return out

    def tocsc(self) -> "SparseCSC":
        rows = np.repeat(np.arange(self.n_rows), np.diff(self.indptr)).astype(np.int64)
        return coo_to_csc(self.n_rows, self.n_cols, rows, self.indices, self.data,
                          aggregate=False)

    def transpose(self) -> "SparseCSR":
        c = self.tocsc()
        return SparseCSR(self.n_cols, self.n_rows, c.indptr, c.indices, c.data)

    def row_scale(self, r: np.ndarray) -> "SparseCSR":
        rows = np.repeat(np.arange(self.n_rows), np.diff(self.indptr))
        return SparseCSR(self.n_rows, self.n_cols, self.indptr, self.indices,
                         self.data * np.asarray(r)[rows])

    def col_scale(self, c: np.ndarray) -> "SparseCSR":
        return SparseCSR(self.n_rows, self.n_cols, self.indptr, self.indices,
                         self.data * np.asarray(c)[self.indices])

    def permute(self, perm_r=None, perm_c=None) -> "SparseCSR":
        """Return A[perm_r, :][:, perm_c] (rows/cols of the result are the
        listed rows/cols of self)."""
        rows = np.repeat(np.arange(self.n_rows), np.diff(self.indptr)).astype(np.int64)
        cols = self.indices.astype(np.int64)
        if perm_r is not None:
            inv_r = invert_perm(perm_r)
            rows = inv_r[rows]
        if perm_c is not None:
            inv_c = invert_perm(perm_c)
            cols = inv_c[cols]
        return coo_to_csr(self.n_rows, self.n_cols, rows, cols, self.data,
                          aggregate=False)

    def norm_inf(self) -> float:
        """max row sum of |A| — 'I' norm of pdlangs (SRC/pdlangs.c)."""
        rows = np.repeat(np.arange(self.n_rows), np.diff(self.indptr))
        sums = np.zeros(self.n_rows, dtype=np.float64)
        np.add.at(sums, rows, np.abs(self.data))
        return float(sums.max(initial=0.0))

    def norm_1(self) -> float:
        """max col sum of |A| — '1' norm of pdlangs."""
        sums = np.zeros(self.n_cols, dtype=np.float64)
        np.add.at(sums, self.indices, np.abs(self.data))
        return float(sums.max(initial=0.0))

    def norm_max(self) -> float:
        return float(np.abs(self.data).max(initial=0.0))


@dataclasses.dataclass
class SparseCSC:
    """Compressed sparse column (reference NCformat, supermatrix.h)."""

    n_rows: int
    n_cols: int
    indptr: np.ndarray   # (n_cols+1,)
    indices: np.ndarray  # row indices, sorted within each column
    data: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self):
        return self.data.dtype

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n_rows, self.n_cols), dtype=self.data.dtype)
        cols = np.repeat(np.arange(self.n_cols), np.diff(self.indptr))
        out[self.indices, cols] = self.data
        return out

    def tocsr(self) -> SparseCSR:
        cols = np.repeat(np.arange(self.n_cols), np.diff(self.indptr)).astype(np.int64)
        return coo_to_csr(self.n_rows, self.n_cols, self.indices, cols, self.data,
                          aggregate=False)


def invert_perm(perm: np.ndarray) -> np.ndarray:
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    return inv


def coo_to_csr(n_rows, n_cols, rows, cols, vals, aggregate=True) -> SparseCSR:
    if aggregate:
        rows, cols, vals = _aggregate_coo(n_rows, n_cols, rows, cols, vals)
    else:
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        key = rows * n_cols + cols
        order = np.argsort(key, kind="stable")
        rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.zeros(n_rows + 1, dtype=np.int64)
    np.add.at(counts, rows + 1, 1)
    return SparseCSR(int(n_rows), int(n_cols), counts_to_indptr(counts),
                     cols.astype(INT), vals)


def coo_to_csc(n_rows, n_cols, rows, cols, vals, aggregate=True) -> SparseCSC:
    if aggregate:
        rows, cols, vals = _aggregate_coo(n_rows, n_cols, rows, cols, vals)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    key = cols * n_rows + rows
    order = np.argsort(key, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.zeros(n_cols + 1, dtype=np.int64)
    np.add.at(counts, cols + 1, 1)
    return SparseCSC(int(n_rows), int(n_cols), counts_to_indptr(counts),
                     rows.astype(INT), vals)


def symmetrize_pattern(a: SparseCSR) -> SparseCSR:
    """Pattern of A + Aᵀ with A's values (explicit zeros where only Aᵀ has an
    entry).

    Analog of at_plus_a_dist (SRC/get_perm_c.c:301), which the reference uses
    to build the graph for fill-reducing orderings.  We additionally *factor*
    on this symmetrized pattern: with static pivoting (GESP) the LU fill of a
    structurally-symmetric pattern equals the Cholesky fill of that pattern,
    which makes the symbolic phase and the multifrontal batching exact.
    """
    n = a.n_rows
    assert n == a.n_cols, "symmetrize_pattern requires a square matrix"
    rows = np.repeat(np.arange(n), np.diff(a.indptr)).astype(np.int64)
    cols = a.indices.astype(np.int64)
    all_rows = np.concatenate([rows, cols])
    all_cols = np.concatenate([cols, rows])
    all_vals = np.concatenate([a.data, np.zeros(len(rows), dtype=a.data.dtype)])
    # _aggregate_coo sums duplicates; transpose-added zeros do not perturb
    # values, and diagonal duplicates collapse (0 added once per mirror).
    return coo_to_csr(n, n, all_rows, all_cols, all_vals)
