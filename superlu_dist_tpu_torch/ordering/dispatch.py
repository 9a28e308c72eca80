"""Column-ordering dispatch — analog of get_perm_c_dist (SRC/get_perm_c.c:463).

All orderings but COLAMD and MMD_ATA operate on the symmetrized pattern
A + Aᵀ (at_plus_a_dist analog) of the row-permuted matrix, and return an
*order* array: order[k] = old index of the k-th pivot column.  Each runs
in the native library unless ``options.native`` is False, which selects
the Python twins.
"""

from __future__ import annotations

import numpy as np

from superlu_dist_tpu_torch import native as slu_host
from superlu_dist_tpu_torch.sparse.formats import SparseCSR, symmetrize_pattern
from superlu_dist_tpu_torch.utils.options import ColPerm, Options
from superlu_dist_tpu_torch.utils.errors import SuperLUError
from superlu_dist_tpu_torch.ordering.colamd import (ata_adjacency,
                                                    colamd_order,
                                                    dense_row_threshold)
from superlu_dist_tpu_torch.ordering.minimum_degree import minimum_degree
from superlu_dist_tpu_torch.ordering.dissection import geometric_nd, bfs_nd


def get_perm_c(options: Options, a: SparseCSR,
               sym: SparseCSR | None = None) -> np.ndarray:
    n = a.n_rows
    cp = options.col_perm
    native = options.native
    if cp == ColPerm.NATURAL:
        return np.arange(n, dtype=np.int64)
    if cp == ColPerm.MY_PERMC:
        if options.user_perm_c is None:
            raise SuperLUError("ColPerm=MY_PERMC but user_perm_c is None")
        return np.asarray(options.user_perm_c, dtype=np.int64)
    if cp == ColPerm.COLAMD:
        # approximate column MD directly on A — no AᵀA, no symmetrization
        return colamd_order(a.n_rows, a.n_cols, a.indptr, a.indices,
                            native=native)
    if cp == ColPerm.MMD_ATA:
        # exact MD on the explicit AᵀA pattern (getata_dist analog)
        ptr, idx = ata_adjacency(a.n_rows, a.n_cols, a.indptr, a.indices,
                                 dense_row=dense_row_threshold(a.n_cols),
                                 native=native)
        return minimum_degree(n, ptr, idx, native=native)
    if sym is None:
        sym = symmetrize_pattern(a)
    if cp == ColPerm.MMD_AT_PLUS_A:
        return minimum_degree(n, sym.indptr, sym.indices, native=native)
    if cp == ColPerm.ND_AT_PLUS_A:
        grid_shape = getattr(a, "grid_shape", None)
        if grid_shape is not None:
            return geometric_nd(grid_shape)
        if n <= 400:
            # MD beats any ND on small irregular graphs, and is cheap there
            return minimum_degree(n, sym.indptr, sym.indices, native=native)
        if not native:
            return bfs_nd(n, sym.indptr, sym.indices)
        # multilevel ND (the METIS_AT_PLUS_A-quality path): coarsen →
        # bisect → FM-refine → vertex separator
        return slu_host.mlnd(n, sym.indptr, sym.indices, leaf_size=96, seed=1,
                             nthreads=options.nd_threads)
    raise SuperLUError(f"unsupported ColPerm {cp}")
