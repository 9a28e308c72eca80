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
