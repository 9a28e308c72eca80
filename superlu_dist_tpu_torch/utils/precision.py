"""Precision / verification utilities.

Port of the JAX package's ``utils/precision.py``: library versions of the
reference's dutil_dist.c helpers — fabricated solutions (dGenXtrue_dist),
right-hand sides (dFillRHS_dist), the infinity-norm error check
(pdinf_norm_error, EXAMPLE/pddrive.c:235) and the U-diagonal gather
(pdGetDiagU, SRC/pdGetDiagU.c), here over the port's torch fronts.
"""

from __future__ import annotations

import numpy as np
import torch

from superlu_dist_tpu_torch.sparse.formats import SparseCSR


def gen_xtrue(n: int, nrhs: int = 1, dtype=np.float64, seed: int = 0):
    """dGenXtrue_dist analog: a reproducible fabricated solution."""
    rng = np.random.default_rng(seed)
    shape = (n,) if nrhs == 1 else (n, nrhs)
    x = rng.standard_normal(shape)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def fill_rhs(a: SparseCSR, xtrue: np.ndarray, trans: bool = False):
    """dFillRHS_dist analog: b = A·xtrue (or Aᵀ·xtrue)."""
    op = a.transpose() if trans else a
    return op.matvec(xtrue)


def inf_norm_error(x: np.ndarray, xtrue: np.ndarray) -> float:
    """pdinf_norm_error analog: ‖x − xtrue‖∞ / ‖x‖∞."""
    num = float(np.linalg.norm(np.ravel(x - xtrue), np.inf))
    den = float(np.linalg.norm(np.ravel(x), np.inf))
    return num / max(den, 1e-300)


def get_diag_u(numeric) -> np.ndarray:
    """pdGetDiagU analog (SRC/pdGetDiagU.c): the U diagonal in the
    factorization's (permuted) column order, gathered from the fronts on
    their device (one copy to the host per group)."""
    plan = numeric.plan
    sf = plan.sf
    out = np.empty(sf.n, dtype=str(numeric.dtype).replace("torch.", ""))
    diags = [torch.diagonal(lp[:, :grp.w, :grp.w], dim1=1, dim2=2).cpu()
             .numpy() for grp, (lp, _) in zip(plan.groups, numeric.fronts)]
    for s in range(sf.n_supernodes):
        w = sf.sn_width(s)
        d = diags[int(plan.sn_group[s])][int(plan.sn_slot[s])]
        out[sf.sn_start[s]:sf.sn_start[s] + w] = d[:w]
    return out
