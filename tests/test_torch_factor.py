"""The port's host analysis and numeric factorization against the JAX
package.

* Analysis: with the JAX package's native host library switched off, its
  Python twins and the port's copies must give the same symbolic
  structure and the same plan, array for array.
* Factorization: on a plan carried over with ``plan_from_reference``, the
  port's L/U panels of every group agree in float64 with the JAX
  package's fused executor at the cross-schedule drift gate, with equal
  tiny-pivot counts; the sentinels report what the JAX package reports.
"""

import numpy as np
import pytest
import torch

import superlu_dist_tpu.native as jax_native
from superlu_dist_tpu.drivers.gssvx import analyze as jax_analyze
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.numeric.factor import numeric_factorize as jax_factorize
from superlu_dist_tpu.utils.options import Options as JaxOptions
from superlu_dist_tpu.utils.options import RowPerm as JaxRowPerm

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.interop import plan_from_reference
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.numeric.factor import numeric_factorize
from superlu_dist_tpu_torch.utils import tols
from superlu_dist_tpu_torch.utils.errors import NumericBreakdownError

RTOL, ATOL = tols.SCHEDULE_DRIFT_RTOL, tols.SCHEDULE_DRIFT_ATOL

MATRICES = {
    "poisson2d_14": lambda g: g.poisson2d(14),
    "poisson3d_6": lambda g: g.poisson3d(6),
    "random_80": lambda g: g.random_sparse(80, density=0.05, seed=3),
}


def _reference(name):
    """JAX analysis of one gallery matrix: (plan, permuted values, anorm)."""
    lu, bvals, _ = jax_analyze(JaxOptions(), MATRICES[name](jgal))
    return lu.plan, bvals, lu.anorm


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_analysis_matches_python_twins(name, monkeypatch):
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", True)
    assert not jax_native.available()
    ref_lu, ref_vals, _ = jax_analyze(JaxOptions(), MATRICES[name](jgal))
    lu, vals, _ = slt.analyze(slt.Options(), MATRICES[name](gallery),
                              device="cpu")
    assert np.array_equal(vals, ref_vals)
    for field in ("perm", "sn_start", "sn_parent", "sn_level", "value_perm"):
        assert np.array_equal(getattr(lu.sf, field),
                              getattr(ref_lu.sf, field)), field
    assert lu.plan.pool_size == ref_lu.plan.pool_size
    assert len(lu.plan.groups) == len(ref_lu.plan.groups)
    for g, rg in zip(lu.plan.groups, ref_lu.plan.groups):
        assert (g.m, g.w, g.u, g.batch) == (rg.m, rg.w, rg.u, rg.batch)
        for field in ("sns", "ws", "off", "a_slot", "a_flat", "a_src"):
            assert np.array_equal(getattr(g, field), getattr(rg, field))
        assert len(g.children) == len(rg.children)
        for cs, rcs in zip(g.children, rg.children):
            assert cs.ub == rcs.ub
            for field in ("child_off", "child_slot", "rel"):
                assert np.array_equal(getattr(cs, field), getattr(rcs, field))


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("anorm_scale", [1.0, 1e18])
def test_factors_match_jax_fused(name, anorm_scale):
    """anorm_scale=1e18 lifts the GESP threshold above every pivot, so
    each real pivot is replaced — the tiny-pivot path end to end."""
    plan, vals, anorm = _reference(name)
    anorm *= anorm_scale
    ref = jax_factorize(plan, vals, anorm, dtype="float64",
                        executor="fused")
    out = numeric_factorize(plan_from_reference(plan), vals, anorm,
                            dtype=torch.float64, device="cpu")
    assert out.tiny_pivots == ref.tiny_pivots
    if anorm_scale > 1:
        assert out.tiny_pivots == plan.n
    for (lp, up), (rlp, rup) in zip(out.fronts, ref.fronts):
        np.testing.assert_allclose(lp.numpy(), np.asarray(rlp), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(up.numpy(), np.asarray(rup), rtol=RTOL,
                                   atol=ATOL)


def test_nonfinite_input_raises_at_the_jax_supernode():
    plan, vals, anorm = _reference("poisson3d_6")
    vals = vals.copy()
    vals[len(vals) // 3] = np.nan
    with pytest.raises(Exception) as ref_err:
        jax_factorize(plan, vals, anorm, dtype="float64", executor="fused")
    with pytest.raises(NumericBreakdownError) as err:
        numeric_factorize(plan_from_reference(plan), vals, anorm,
                          device="cpu")
    assert err.value.supernode == ref_err.value.supernode >= 0


def test_zero_pivot_without_replacement_reports_its_column():
    """replace_tiny=False on an exactly singular matrix (row and column k
    zeroed): info_col is the zeroed column's final label.  The JAX
    package reports column 0 here: its masked write-back multiplies the
    NaN column by a one-hot vector, which smears it over the whole panel
    (ROADMAP.md records this)."""
    a = jgal.zero_row_col(6, which="both")
    k = a.n_rows // 2
    lu, vals, _ = jax_analyze(
        JaxOptions(equil=False, row_perm=JaxRowPerm.NOROWPERM), a)
    out = numeric_factorize(plan_from_reference(lu.plan), vals, lu.anorm,
                            device="cpu", replace_tiny=False)
    ref = jax_factorize(lu.plan, vals, lu.anorm, dtype="float64",
                        executor="fused", replace_tiny=False)
    assert not out.finite and not ref.finite
    assert out.info_col == int(np.argsort(lu.sf.perm)[k])
    assert ref.info_col <= out.info_col
