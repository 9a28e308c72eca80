"""Multi-process iterative refinement over block-row distributed A.

Capability analog of pdgsrfs + pdgsmv (SRC/pdgsrfs.c:120, pdgsmv.c:234):
the reference computes the residual r = b − A·x with each rank holding a
block of rows (NRformat_loc) and exchanging the needed x entries, then
solves the correction on the distributed factors.  Here each process owns
a `DistributedCSR` block row; the x exchange that the reference does with
per-rank index lists becomes one tree all-reduce of the zero-padded
block vectors (parallel/treecomm.py — the same collective engine the
reference builds from its Bc/Rd trees), and the correction solve runs on
the factor-owning root and is tree-broadcast back.

Port of the JAX package's ``parallel/pgsrfs.py``.  This is the host
multi-process tier of the refinement stack: the residual of each rank's
rows is numpy on that rank's host (``DistributedCSR.matvec_local``), not
the card's ``csr_spmv`` of the single-process driver, and only the
root's correction solve touches the card.  Every rank calls `pgsrfs`
collectively and receives the full refined solution.  The per-iteration
collective sequence (allreduce residual -> allreduce denominator ->
[bcast dx]) must stay identical on every rank — the convergence test
uses the allreduced berr, never per-rank values, so all ranks break the
loop together; SLU_TPU_VERIFY_COLLECTIVES=1 checks exactly this lockstep
at run time and names divergent call sites instead of deadlocking.

At NOTRANS every slot of the residual allreduce has exactly one nonzero
contributor (block rows are disjoint), so x is the same bit for bit at
any rank count; at TRANS / CONJ the ranks' partial sums add in tree
order.
"""

from __future__ import annotations

import numpy as np

from superlu_dist_tpu_torch.parallel.dist import DistributedCSR
from superlu_dist_tpu_torch.parallel.treecomm import TreeComm
from superlu_dist_tpu_torch.refine.ir import ITMAX, componentwise_berr


def _pad_full(local: np.ndarray, fst_row: int, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=np.result_type(local, np.float64))
    out[fst_row:fst_row + len(local)] = local
    return out


def pgsrfs(tc: TreeComm, a_loc: DistributedCSR, b_loc: np.ndarray,
           x0: np.ndarray | None, solve_fn, itmax: int = ITMAX,
           root: int = 0, trans=None,
           stats_out: dict | None = None) -> np.ndarray:
    """Collectively refine op(A)·x = b (single RHS; op per `trans` —
    NOTRANS/TRANS/CONJ like pdgssvx's trans dispatch; complex payloads
    ride the f64 tree as re/im passes via TreeComm.*_any).

    tc       — this rank's TreeComm attachment.
    a_loc    — this rank's block rows of A (global column indices).
    b_loc    — this rank's block of b.
    x0       — initial solution (significant on the root; may be None on
               the others).
    solve_fn — correction solver dx = op(A)⁻¹ r; significant on the root
               only (the factor owner — the reference's analog is that
               every rank participates in pdgstrs, here the factors live
               with the root process; the JAX package's mesh tier, not
               ported, runs it on every rank's device instead).
    stats_out — optional dict filled with {"iters", "berr", "berrs"}:
               the iteration count and componentwise backward-error
               history (every rank gets the same values — they are
               computed from allreduced quantities).

    Returns the full refined x on every rank.
    """
    from superlu_dist_tpu_torch.utils.options import Trans
    if trans is None:
        trans = Trans.NOTRANS
    n = a_loc.n
    eps = float(np.finfo(np.float64).eps)
    cplx = np.iscomplexobj(a_loc.data) or np.iscomplexobj(b_loc)
    wdtype = np.complex128 if cplx else np.float64

    # x lives replicated (root broadcasts), like pdgsrfs's x updates
    x = (np.zeros(n, dtype=wdtype) if x0 is None
         else np.asarray(x0, dtype=wdtype))
    x = tc.bcast_any(x, root=root)

    # global nnz for the shared BERR underflow guard (refine/ir.py's
    # componentwise_berr — the safe1·safmin bump, NOT a den>0 -> 1.0
    # rewrite, which understates berr on tiny denominators)
    cnt = np.zeros(1)
    cnt[0] = float(a_loc.nnz_loc)
    nnz_glob = int(tc.allreduce_sum_any(cnt, root=root)[0])

    berrs = []
    lstres = np.inf
    for _ in range(itmax):
        # r = b − op(A)·x as one all-reduce of per-rank contributions
        # (the pdgsmv exchange analog).  NOTRANS: block rows are disjoint
        # slots; TRANS/CONJ: block rows of A are block columns of op(A),
        # so every rank contributes a full-length partial sum.
        if trans == Trans.NOTRANS:
            r_c = _pad_full(b_loc - a_loc.matvec_local(x),
                            a_loc.fst_row, n)
            den_c = _pad_full(a_loc.abs_matvec_local(np.abs(x))
                              + np.abs(b_loc), a_loc.fst_row, n)
        else:
            conj = trans == Trans.CONJ
            r_c = (_pad_full(b_loc, a_loc.fst_row, n)
                   - a_loc.matvec_trans_local(x, conj=conj))
            den_c = (a_loc.abs_matvec_trans_local(np.abs(x))
                     + _pad_full(np.abs(b_loc), a_loc.fst_row, n))
        r = tc.allreduce_sum_any(r_c, root=root)
        # componentwise backward error denominator |op(A)|·|x| + |b|
        den = tc.allreduce_sum_any(den_c, root=root)
        berr = componentwise_berr(r, den, nnz_glob, np.float64)
        berrs.append(berr)
        if berr <= eps or berr >= lstres / 2.0:
            break
        lstres = berr
        # correction on the factor owner, broadcast to all
        dx = np.zeros(n, dtype=wdtype)
        if tc.rank == root:
            dx = np.asarray(solve_fn(r), dtype=wdtype)
        dx = tc.bcast_any(dx, root=root)
        x = x + dx
    if stats_out is not None:
        stats_out["iters"] = len(berrs)
        stats_out["berr"] = berrs[-1] if berrs else None
        stats_out["berrs"] = berrs
    return x
