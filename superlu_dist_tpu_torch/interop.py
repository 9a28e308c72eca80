"""Carrying state across from the JAX package.

The solver has no weights: its state is the plan and the factors.  These
two functions read a JAX-package ``FactorPlan`` and
``NumericFactorization`` by duck typing — every field is taken as a numpy
array, so this module imports nothing of that package — and return the
port's own objects.  The tests use them so that both packages compute on
one plan and one set of factors.
"""

from __future__ import annotations

import numpy as np
import torch

from superlu_dist_tpu_torch.numeric.factor import NumericFactorization
from superlu_dist_tpu_torch.numeric.plan import ChildSet, FactorPlan, Group
from superlu_dist_tpu_torch.symbolic.symbfact import SymbolicFact
from superlu_dist_tpu_torch.utils.options import resolve_device

_I64 = np.int64


def _i64(x):
    return np.asarray(x, dtype=_I64)


def _symbolic_from_reference(sf) -> SymbolicFact:
    def opt(x):
        return None if x is None else np.asarray(x)
    return SymbolicFact(
        n=int(sf.n), perm=_i64(sf.perm), parent=_i64(sf.parent),
        sn_start=_i64(sf.sn_start), col_to_sn=_i64(sf.col_to_sn),
        sn_rows=[_i64(r) for r in sf.sn_rows], sn_parent=_i64(sf.sn_parent),
        sn_level=_i64(sf.sn_level), nnz_L=int(sf.nnz_L),
        nnz_U=int(sf.nnz_U), flops=float(sf.flops),
        pattern_indptr=opt(sf.pattern_indptr),
        pattern_indices=opt(sf.pattern_indices),
        value_perm=opt(sf.value_perm))


def plan_from_reference(plan) -> FactorPlan:
    """A JAX-package FactorPlan as the port's FactorPlan (same groups,
    child sets, pool size and symbolic fields; index maps int64)."""
    groups = []
    for g in plan.groups:
        children = [ChildSet(ub=int(cs.ub), child_off=_i64(cs.child_off),
                             child_slot=_i64(cs.child_slot),
                             rel=_i64(cs.rel))
                    for cs in g.children]
        groups.append(Group(level=int(g.level), m=int(g.m), w=int(g.w),
                            u=int(g.u), batch=int(g.batch), sns=_i64(g.sns),
                            ws=_i64(g.ws), off=_i64(g.off),
                            a_slot=_i64(g.a_slot), a_flat=_i64(g.a_flat),
                            a_src=_i64(g.a_src), children=children))
    return FactorPlan(
        n=int(plan.n), sf=_symbolic_from_reference(plan.sf),
        pattern_indptr=np.asarray(plan.pattern_indptr),
        pattern_indices=np.asarray(plan.pattern_indices), groups=groups,
        pool_size=int(plan.pool_size), sn_group=_i64(plan.sn_group),
        sn_slot=_i64(plan.sn_slot), flops=float(plan.flops),
        front_bytes=int(plan.front_bytes), schedule=str(plan.schedule),
        sched_window=int(plan.sched_window),
        n_level_groups=int(plan.n_level_groups),
        critical_path=int(plan.critical_path), closed=bool(plan.closed),
        bucket_set=tuple(plan.bucket_set))


def factors_from_reference(numeric, device="cuda") -> NumericFactorization:
    """A JAX-package NumericFactorization as the port's, with the fronts
    copied onto ``device`` (the card unless the caller asks for the CPU;
    CUDA without a card raises)."""
    device = resolve_device(device)
    fronts = [(torch.as_tensor(np.array(lp), device=device),
               torch.as_tensor(np.array(up), device=device))
              for lp, up in numeric.fronts]
    dtype = fronts[0][0].dtype if fronts else torch.float64
    return NumericFactorization(
        plan=plan_from_reference(numeric.plan), fronts=fronts,
        tiny_pivots=int(numeric.tiny_pivots), dtype=dtype,
        finite=bool(numeric.finite), info_col=int(numeric.info_col),
        gemm_prec=str(numeric.gemm_prec))
