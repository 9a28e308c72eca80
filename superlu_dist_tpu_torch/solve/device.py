"""Device-resident supernodal triangular solves.

Port of the JAX package's ``solve/device.py`` (the pdgstrs analog,
SRC/pdgstrs.c:838, with the lsum kernels of SRC/pdgstrs_lsum.c): the
forward solve L·y = d walks the sweep batches bottom-up, the backward
solve U·x = y walks them back down.  Each batch gathers its RHS segments,
solves its diagonal triangles (``torch.linalg.solve_triangular``) and
scatter-adds the L21·y contributions into the lsum vector
(``index_add_``); the factors never leave the device, only the
right-hand side crosses.

The transposed system (L·U)ᵀ·x = d (conjugated under ``conj``) runs
through the same factors: Uᵀ leads, walking the batches bottom-up, then
Lᵀ walks them back down (``solve_trans``).  Only the factor schedule is
ported: no diagonal inverses, no recursive TRSM, no nrhs buckets
(ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from superlu_dist_tpu_torch.numeric.factor import NumericFactorization
from superlu_dist_tpu_torch.ops.dense import full_precision_matmul
from superlu_dist_tpu_torch.solve.plan import build_solve_plan


def _fwd_body(lpanel, x, lsum, cols, rows, w, u):
    """x[cols] <- L11⁻¹(x[cols] − lsum[cols]); lsum[rows] += L21·x[cols]."""
    rhs = x[cols] - lsum[cols]                          # (B, w, k)
    y = torch.linalg.solve_triangular(lpanel[:, :w, :w], rhs, upper=False,
                                      unitriangular=True)
    x[cols] = y
    if u:
        contrib = torch.matmul(lpanel[:, w:, :], y)     # (B, u, k)
        lsum.index_add_(0, rows.reshape(-1),
                        contrib.reshape(-1, contrib.shape[-1]))


def _bwd_body(lpanel, upanel, x, cols, rows, w, u):
    """x[cols] <- U11⁻¹(x[cols] − U12·x[rows])."""
    rhs = x[cols]
    if u:
        rhs = rhs - torch.matmul(upanel, x[rows])
    x[cols] = torch.linalg.solve_triangular(lpanel[:, :w, :w], rhs,
                                            upper=True)


def _t(a, conj):
    """aᵀ, or aᴴ under conj (views)."""
    return a.mH if conj else a.mT


def _fwd_body_trans(lpanel, upanel, x, lsum, cols, rows, w, u, conj):
    """Transposed forward sweep: x[cols] <- U11⁻ᵀ(x[cols] − lsum[cols]);
    lsum[rows] += U12ᵀ·x[cols].  Mᵀ = UᵀLᵀ, so Uᵀ (lower) leads."""
    rhs = x[cols] - lsum[cols]
    y = torch.linalg.solve_triangular(_t(lpanel[:, :w, :w], conj), rhs,
                                      upper=False)
    x[cols] = y
    if u:
        contrib = torch.matmul(_t(upanel, conj), y)     # (B, u, k)
        lsum.index_add_(0, rows.reshape(-1),
                        contrib.reshape(-1, contrib.shape[-1]))


def _bwd_body_trans(lpanel, x, cols, rows, w, u, conj):
    """Transposed backward sweep: x[cols] <- L11⁻ᵀ(x[cols] − L21ᵀ·x[rows])."""
    rhs = x[cols]
    if u:
        rhs = rhs - torch.matmul(_t(lpanel[:, w:, :], conj), x[rows])
    x[cols] = torch.linalg.solve_triangular(_t(lpanel[:, :w, :w], conj), rhs,
                                            upper=True, unitriangular=True)


class DeviceSolver:
    """Solve (L·U)x = d on the factors' device, in the factor's permuted
    labeling.  The index maps of every sweep batch are built once and
    reused across solves (the SolveInitialized discipline,
    pdgssvx.c:1330-1337).

    Row ``n`` of the work vectors is a dump row: padded pivot columns
    read and write it and padded below-diagonal rows add into it; the
    factor entries there are exactly identity/zero, so what it holds
    never reaches a real unknown."""

    def __init__(self, fact: NumericFactorization):
        full_precision_matmul()
        self.fact = fact
        plan = fact.plan
        self.splan = build_solve_plan(plan, schedule="factor")
        self.n = plan.n
        self.device = fact.device
        sf = plan.sf
        first = np.asarray(sf.sn_start[:-1])
        self._groups = []
        for sg in self.splan.groups:
            k = np.arange(sg.w)
            cols = np.where(k[None, :] < sg.ws[:, None],
                            first[sg.sns][:, None] + k, self.n)
            rows = np.full((sg.batch, sg.u), self.n, dtype=np.int64)
            for slot, s in enumerate(sg.sns):
                r = sf.sn_rows[s]
                rows[slot, :len(r)] = r
            self._groups.append(
                (sg, torch.as_tensor(cols, dtype=torch.int64,
                                     device=self.device),
                 torch.as_tensor(rows, device=self.device)))
        self.fronts = [fact.fronts[sg.reuse] for sg in self.splan.groups]

    def _run(self, rhs: np.ndarray, sweeps) -> np.ndarray:
        """Shared scaffolding of the plain and transposed solves: pad the
        right-hand sides into an (n+1, k) work vector (row n is the dump
        row), run ``sweeps(x, lsum)`` in place, return the first n rows in
        rhs's shape.  Complex right-hand sides with real factors are
        solved as their real and imaginary parts."""
        r2 = rhs[:, None] if rhs.ndim == 1 else rhs
        dt = self.fact.dtype
        split = np.iscomplexobj(r2) and not dt.is_complex
        if split:
            r2 = np.concatenate([r2.real, r2.imag], axis=1)
        x = torch.zeros((self.n + 1, r2.shape[1]), dtype=dt,
                        device=self.device)
        x[:self.n] = torch.as_tensor(np.ascontiguousarray(r2)).to(
            device=self.device, dtype=dt)
        sweeps(x, torch.zeros_like(x))
        out = x[:self.n].cpu().numpy()
        if split:
            k = out.shape[1] // 2
            out = out[:, :k] + 1j * out[:, k:]
        return out[:, 0] if rhs.ndim == 1 else out

    def solve(self, rhs: np.ndarray) -> np.ndarray:
        """rhs (n,) or (n, k) in permuted labeling -> solution of
        (L·U)·x = rhs, same shape, in the factor dtype (complex for a
        complex rhs)."""
        def sweeps(x, lsum):
            for (sg, cols, rows), (lp, _) in zip(self._groups, self.fronts):
                _fwd_body(lp, x, lsum, cols, rows, sg.w, sg.u)
            for (sg, cols, rows), (lp, up) in zip(reversed(self._groups),
                                                  reversed(self.fronts)):
                _bwd_body(lp, up, x, cols, rows, sg.w, sg.u)
        return self._run(rhs, sweeps)

    def solve_trans(self, rhs: np.ndarray, conj: bool = False) -> np.ndarray:
        """Solve (L·U)ᵀ·x = rhs, or (L·U)ᴴ·x = rhs with conj, through the
        same factors (the reference's trans_t, superlu_defs.h:628-657):
        Uᵀ ascending, then Lᵀ descending, on the factor schedule."""
        conj = bool(conj)

        def sweeps(x, lsum):
            for (sg, cols, rows), (lp, up) in zip(self._groups, self.fronts):
                _fwd_body_trans(lp, up, x, lsum, cols, rows, sg.w, sg.u,
                                conj)
            for (sg, cols, rows), (lp, _) in zip(reversed(self._groups),
                                                 reversed(self.fronts)):
                _bwd_body_trans(lp, x, cols, rows, sg.w, sg.u, conj)
        return self._run(rhs, sweeps)
