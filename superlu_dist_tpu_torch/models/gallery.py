"""Model-problem generators (the framework's benchmark "model family").

The reference ships small Harwell-Boeing fixtures (EXAMPLE/g20.rua etc.,
EXAMPLE/README:31-34) and BASELINE.md targets a 5-pt 3D Poisson with n≈1M.
These generators produce the same class of matrices directly, with grid
coordinates attached so the geometric nested-dissection ordering can be used.
"""

from __future__ import annotations

import numpy as np

from superlu_dist_tpu_torch.sparse.formats import SparseCSR, coo_to_csr


class _Stencil:
    """Shared COO assembly for the grid generators: collect stamped
    slices, then build the CSR once (one definition of the add/concat/
    coo_to_csr pattern for every generator)."""

    def __init__(self, dtype):
        self.dtype = dtype
        self.rows, self.cols, self.vals = [], [], []

    def add(self, r, c, v):
        self.rows.append(r.ravel())
        self.cols.append(c.ravel())
        self.vals.append(np.full(r.size, v, dtype=self.dtype))

    def build(self, n, grid_shape):
        a = coo_to_csr(n, n, np.concatenate(self.rows),
                       np.concatenate(self.cols),
                       np.concatenate(self.vals))
        a.grid_shape = grid_shape
        return a


def poisson2d(nx: int, ny: int | None = None, dtype=np.float64) -> SparseCSR:
    """5-point 2D Laplacian on an nx×ny grid (n = nx*ny), Dirichlet."""
    ny = nx if ny is None else ny
    idx = np.arange(nx * ny).reshape(nx, ny)
    st = _Stencil(dtype)
    st.add(idx, idx, 4.0)
    st.add(idx[1:, :], idx[:-1, :], -1.0)
    st.add(idx[:-1, :], idx[1:, :], -1.0)
    st.add(idx[:, 1:], idx[:, :-1], -1.0)
    st.add(idx[:, :-1], idx[:, 1:], -1.0)
    # grid_shape is consumed by geometric nested dissection
    return st.build(nx * ny, (nx, ny))


def poisson3d(nx: int, ny: int | None = None, nz: int | None = None,
              dtype=np.float64) -> SparseCSR:
    """7-point 3D Laplacian (the BASELINE.md config-4 matrix class)."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    idx = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    st = _Stencil(dtype)
    st.add(idx, idx, 6.0)
    for axis in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(1, None)
        hi[axis] = slice(None, -1)
        st.add(idx[tuple(lo)], idx[tuple(hi)], -1.0)
        st.add(idx[tuple(hi)], idx[tuple(lo)], -1.0)
    return st.build(nx * ny * nz, (nx, ny, nz))


def convection_diffusion_2d(nx: int, ny: int | None = None, beta: float = 10.0,
                            dtype=np.float64) -> SparseCSR:
    """Unsymmetric 2D convection-diffusion (upwind), exercises the
    unsymmetric-value path (pattern stays structurally symmetric)."""
    ny = nx if ny is None else ny
    h = 1.0 / (nx + 1)
    idx = np.arange(nx * ny).reshape(nx, ny)
    st = _Stencil(dtype)
    st.add(idx, idx, 4.0 + beta * h)
    st.add(idx[1:, :], idx[:-1, :], -1.0 - beta * h)   # upwind in x
    st.add(idx[:-1, :], idx[1:, :], -1.0)
    st.add(idx[:, 1:], idx[:, :-1], -1.0)
    st.add(idx[:, :-1], idx[:, 1:], -1.0)
    return st.build(nx * ny, (nx, ny))


def random_sparse(n: int, density: float = 0.01, seed: int = 0,
                  diag_dominant: bool = True, dtype=np.float64,
                  pattern_symmetric: bool = False) -> SparseCSR:
    """Random square sparse matrix with a guaranteed nonzero diagonal.

    With diag_dominant=True the matrix is safe to factor without pivoting,
    which isolates structure bugs from numerics in tests.  Complex dtypes
    give the z-path (reference z-twin files) coverage.
    """
    rng = np.random.default_rng(seed)
    nnz_target = max(n, int(density * n * n))
    rows = rng.integers(0, n, size=nnz_target)
    cols = rng.integers(0, n, size=nnz_target)
    if pattern_symmetric:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])

    def rand(size):
        if np.issubdtype(np.dtype(dtype), np.complexfloating):
            return (rng.standard_normal(size) + 1j * rng.standard_normal(size)).astype(dtype)
        return rng.standard_normal(size).astype(dtype)

    vals = rand(len(rows))
    # ensure full diagonal
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    dval = rand(n)
    if diag_dominant:
        dval = dval + np.sign(dval.real + (dval.real == 0)) * (4.0 * n * density + 4.0)
    vals = np.concatenate([vals, dval])
    return coo_to_csr(n, n, rows, cols, vals)


def helmholtz_2d(nx: int, k: float = 5.0, dtype=np.complex128) -> SparseCSR:
    """2-D Helmholtz operator −Δ − k² with a complex absorbing shift — an
    indefinite complex test class (the z-path stressor).  dtype must be
    complex (the absorbing shift is imaginary)."""
    dtype = np.dtype(dtype)
    if not np.issubdtype(dtype, np.complexfloating):
        raise ValueError("helmholtz_2d needs a complex dtype "
                         f"(absorbing shift), got {dtype}")
    a = poisson2d(nx, dtype=np.float64)
    vals = a.data.astype(dtype)
    diag = a.indices == np.repeat(np.arange(a.n_rows), np.diff(a.indptr))
    h2 = 1.0 / (nx + 1) ** 2
    vals[diag] -= (k * k - 0.5j * k) * h2
    out = SparseCSR(a.n_rows, a.n_cols, a.indptr, a.indices, vals)
    out.grid_shape = a.grid_shape     # keep geometric-ND eligibility
    return out


def hilbert(n: int, dtype=np.float64) -> SparseCSR:
    """Hilbert matrix H[i,j] = 1/(i+j+1) stored sparse — the classic
    ill-conditioned class (κ₂ ~ e^{3.5n}): at n=8 already ~1.5e10, past
    f32+IR's reach but inside f64's.  Escalation-ladder fodder."""
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    vals = (1.0 / (i + j + 1.0)).astype(dtype)
    return coo_to_csr(n, n, i.ravel(), j.ravel(), vals.ravel())


def rank_deficient_arrowhead(n: int, delta: float = 0.0, seed: int = 0,
                             dtype=np.float64) -> SparseCSR:
    """Arrowhead matrix whose last row is an exact linear combination of
    rows 1 and 2 (delta=0: exactly singular, rank n−1) or a near one
    (delta>0: smallest pivot ~delta, κ ~ ‖A‖/delta).  The dependence is a
    row relation, so no diagonal re-scaling repairs it — the near-singular
    stressor for the recovery ladder."""
    if n < 4:
        raise ValueError("rank_deficient_arrowhead needs n >= 4")
    rng = np.random.default_rng(seed)
    m = np.zeros((n, n), dtype=np.float64)
    np.fill_diagonal(m, 1.0 + rng.random(n))
    m[0, 1:] = 0.25 * (1.0 + rng.random(n - 1))   # arrow row
    m[1:, 0] = 0.25 * (1.0 + rng.random(n - 1))   # arrow column
    m[n - 1] = m[1] + m[2]                        # exact row dependence
    m[n - 1, n - 1] += delta                      # near-singular escape
    r, c = np.nonzero(m)
    return coo_to_csr(n, n, r, c, m[r, c].astype(dtype))


def zero_row_col(nx: int = 8, k: int | None = None, which: str = "row",
                 dtype=np.float64) -> SparseCSR:
    """2-D Poisson matrix with row (or column, or both) k numerically
    zeroed — exactly singular with a structurally present but zero-valued
    slice, the reference's dgsequ/pdgstrf info>0 test class."""
    a = poisson2d(nx, dtype=dtype)
    n = a.n_rows
    if k is None:
        k = n // 2
    data = a.data.copy()
    rows = np.repeat(np.arange(n), np.diff(a.indptr))
    if which in ("row", "both"):
        data[rows == k] = 0.0
    if which in ("col", "both"):
        data[a.indices == k] = 0.0
    out = SparseCSR(a.n_rows, a.n_cols, a.indptr, a.indices, data)
    out.grid_shape = a.grid_shape
    return out


def anisotropic_poisson_2d(nx: int, eps: float = 1e-3,
                           dtype=np.float64) -> SparseCSR:
    """Anisotropic diffusion −u_xx − eps·u_yy: strong directional
    coupling makes the ordering/fill behavior very different from the
    isotropic Laplacian (a standard stress class for fill-reducing
    orderings)."""
    idx = np.arange(nx * nx).reshape(nx, nx)
    st = _Stencil(dtype)
    st.add(idx, idx, 2.0 + 2.0 * eps)
    st.add(idx[:, 1:], idx[:, :-1], -1.0)     # u_xx along rows
    st.add(idx[:, :-1], idx[:, 1:], -1.0)
    st.add(idx[1:, :], idx[:-1, :], -eps)     # eps * u_yy across rows
    st.add(idx[:-1, :], idx[1:, :], -eps)
    return st.build(nx * nx, (nx, nx))


def random_geometric_3d(n: int, k: int = 12, seed: int = 0,
                        dtype=np.float64) -> SparseCSR:
    """Irregular FEM-like matrix: n points in the unit cube, each coupled
    to its k nearest neighbors, SPD-shifted values.  The audikw_1-class
    surrogate (BASELINE config 5): no grid structure, irregular degree
    distribution — the stress class for general-graph nested dissection."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 3))
    # k-NN via cell binning (no scipy dependency): ~O(n·k)
    ncell = max(1, int(round(n ** (1.0 / 3.0) / 2)))
    cell = np.minimum((pts * ncell).astype(np.int64), ncell - 1)
    rows_l, cols_l = [], []
    # search own + neighbor cells
    from collections import defaultdict
    buckets = defaultdict(list)
    for i in range(n):
        buckets[(int(cell[i, 0]), int(cell[i, 1]), int(cell[i, 2]))].append(i)
    for i in range(n):
        cx, cy, cz = (int(cell[i, 0]), int(cell[i, 1]), int(cell[i, 2]))
        cand = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    cand.extend(buckets.get((cx + dx, cy + dy, cz + dz),
                                            ()))
        cand = np.asarray([c for c in cand if c != i])
        if len(cand) == 0:
            continue
        d = np.sum((pts[cand] - pts[i]) ** 2, axis=1)
        near = cand[np.argsort(d)[:k]]
        rows_l.append(np.full(len(near), i))
        cols_l.append(near)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    # symmetrize pattern, SPD-ish values: off-diag -1, diag = degree + 1
    rows, cols = (np.concatenate([rows, cols, np.arange(n)]),
                  np.concatenate([cols, rows, np.arange(n)]))
    vals = np.full(len(rows), -1.0, dtype=dtype)
    vals[-n:] = 0.0
    a = coo_to_csr(n, n, rows, cols, vals)    # dedups, sums dups
    # clamp duplicate-summed off-diagonals back to -1, then set the
    # diagonal to (number of off-diagonal entries + 1): strictly
    # diagonally dominant, hence nonsingular
    deg = np.diff(a.indptr)
    diag_mask = a.indices == np.repeat(np.arange(n), deg)
    a.data[~diag_mask] = np.maximum(a.data[~diag_mask], -1.0)
    a.data[diag_mask] = deg.astype(a.data.dtype)  # deg includes the diag
    return a
