"""Column-ordering dispatch — analog of get_perm_c_dist (SRC/get_perm_c.c:463).

All orderings operate on the symmetrized pattern A + Aᵀ (at_plus_a_dist
analog) of the row-permuted matrix, and return an *order* array:
order[k] = old index of the k-th pivot column.  Only the Python orderings
are here: COLAMD and MMD_ATA, and multilevel ND on irregular graphs, need a
native host library that is not ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import numpy as np

from superlu_dist_tpu_torch.sparse.formats import SparseCSR, symmetrize_pattern
from superlu_dist_tpu_torch.utils.options import ColPerm, Options
from superlu_dist_tpu_torch.utils.errors import SuperLUError
from superlu_dist_tpu_torch.ordering.minimum_degree import minimum_degree
from superlu_dist_tpu_torch.ordering.dissection import geometric_nd, bfs_nd


def get_perm_c(options: Options, a: SparseCSR,
               sym: SparseCSR | None = None) -> np.ndarray:
    n = a.n_rows
    cp = options.col_perm
    if cp == ColPerm.NATURAL:
        return np.arange(n, dtype=np.int64)
    if cp == ColPerm.MY_PERMC:
        if options.user_perm_c is None:
            raise SuperLUError("ColPerm=MY_PERMC but user_perm_c is None")
        return np.asarray(options.user_perm_c, dtype=np.int64)
    if cp in (ColPerm.COLAMD, ColPerm.MMD_ATA):
        raise NotImplementedError(
            f"ColPerm.{cp.name} needs the native host library, which the "
            "port does not have yet (ROADMAP.md, queue 1)")
    if sym is None:
        sym = symmetrize_pattern(a)
    if cp == ColPerm.MMD_AT_PLUS_A:
        return minimum_degree(n, sym.indptr, sym.indices)
    if cp == ColPerm.ND_AT_PLUS_A:
        grid_shape = getattr(a, "grid_shape", None)
        if grid_shape is not None:
            return geometric_nd(grid_shape)
        if n <= 400:
            # MD beats any ND on small irregular graphs, and is cheap there
            return minimum_degree(n, sym.indptr, sym.indices)
        return bfs_nd(n, sym.indptr, sym.indices)
    raise SuperLUError(f"unsupported ColPerm {cp}")
