"""The port's factorization reuse against the JAX package: the Fact tiers
(FACTORED, SamePattern, SamePattern_SameRowPerm) and the values-only
``refactor`` — factors equal, bit for bit, to a fresh factorization of the
same values on the same plan; a raw values array; the identity latch;
pattern drift refused with ``PatternMismatchError``; NaN values and a
missed BERR gate rolled back with the handle untouched; an unfactored
handle refused.  X agrees with the JAX package's at the device-vs-host
gate."""

import dataclasses

import numpy as np
import pytest
import torch

import superlu_dist_tpu as jslu
from superlu_dist_tpu.drivers.gssvx import refactor as jax_refactor
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.persist.serial import pattern_digest as jax_digest
from superlu_dist_tpu.persist.serial import plan_fingerprint as jax_fp

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.drivers.gssvx import pattern_digest
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.numeric.factor import numeric_factorize
from superlu_dist_tpu_torch.utils import tols

RTOL, ATOL = tols.DEVICE_VS_HOST_RTOL, tols.DEVICE_VS_HOST_ATOL


def _drift(a, scale=2.0, shift=0.01):
    return type(a)(a.n_rows, a.n_cols, a.indptr, a.indices,
                   a.data * scale + shift)


def _fronts_equal(f1, f2):
    return all(torch.equal(l1, l2) and torch.equal(u1, u2)
               for (l1, u1), (l2, u2) in zip(f1.fronts, f2.fronts))


def test_fact_reuse_tiers_match_jax():
    """FACTORED (new b, no factorization), SamePattern_SameRowPerm (new
    values, symbolic + plan reused) and SamePattern (column order reused),
    each against the same tier of the JAX package."""
    a, ja = gallery.poisson2d(9), jgal.poisson2d(9)
    n = a.n_rows
    b1, b2 = np.ones(n), np.arange(n, dtype=np.float64)
    _, lu, _, _ = slt.gssvx(slt.Options(), a, b1, device="cpu")
    _, jlu, _, _ = jslu.gssvx(jslu.Options(), ja, b1)

    x2, lu2, st2, _ = slt.gssvx(slt.Options(fact=slt.Fact.FACTORED), a, b2,
                                lu=lu)
    jx2, _, _, _ = jslu.gssvx(jslu.Options(fact=jslu.Fact.FACTORED), ja, b2,
                              lu=jlu)
    assert st2.utime["FACT"] == 0 and lu2 is lu
    np.testing.assert_allclose(x2, jx2, rtol=RTOL, atol=ATOL)

    a3, ja3 = _drift(a, 2.0, 0.0), _drift(ja, 2.0, 0.0)
    x3, lu3, _, _ = slt.gssvx(
        slt.Options(fact=slt.Fact.SamePattern_SameRowPerm), a3, b1, lu=lu)
    jx3, _, _, _ = jslu.gssvx(
        jslu.Options(fact=jslu.Fact.SamePattern_SameRowPerm), ja3, b1,
        lu=jlu)
    assert lu3.sf is lu.sf and lu3.plan is lu.plan
    assert lu3.row_order is lu.row_order and lu3.col_order is lu.col_order
    np.testing.assert_allclose(x3, jx3, rtol=RTOL, atol=ATOL)

    x4, lu4, _, _ = slt.gssvx(slt.Options(fact=slt.Fact.SamePattern), a3,
                              b2, lu=lu)
    jx4, _, _, _ = jslu.gssvx(jslu.Options(fact=jslu.Fact.SamePattern), ja3,
                              b2, lu=jlu)
    assert lu4.col_order is lu.col_order
    # the fresh matching gives the same rows here: symbolic + plan reused
    assert lu4.plan is lu.plan
    np.testing.assert_allclose(x4, jx4, rtol=RTOL, atol=ATOL)


def test_reuse_tiers_refuse_another_pattern():
    a = gallery.poisson2d(6)
    _, lu, _, _ = slt.gssvx(slt.Options(), a, np.ones(a.n_rows),
                            device="cpu")
    other = gallery.random_sparse(a.n_rows, density=0.1, seed=1)
    with pytest.raises(slt.SuperLUError, match="pattern"):
        slt.gssvx(slt.Options(fact=slt.Fact.SamePattern_SameRowPerm), other,
                  np.ones(a.n_rows), lu=lu)
    with pytest.raises(slt.SuperLUError, match="FACTORED"):
        slt.gssvx(slt.Options(fact=slt.Fact.FACTORED), a, np.ones(a.n_rows),
                  device="cpu")


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_refactor_equals_fresh_factorization(dtype):
    """refactor's factors are bit for bit a fresh numeric_factorize of the
    same values on the same plan; no ROWPERM/COLPERM/SYMBFACT work; X
    agrees with the JAX package's refactor."""
    a, ja = gallery.poisson2d(7), jgal.poisson2d(7)
    if dtype == "complex128":
        a, ja = (type(m)(m.n_rows, m.n_cols, m.indptr, m.indices,
                         m.data.astype(np.complex128) * (1 + 0.25j))
                 for m in (a, ja))
    b = np.arange(1, a.n_rows + 1, dtype=np.float64)
    opts = slt.Options(iter_refine=slt.IterRefine.NOREFINE)
    _, lu, _, _ = slt.gssvx(opts, a, b, device="cpu")
    plan, sf = lu.plan, lu.sf
    st = slt.refactor(lu, _drift(a))
    assert lu.plan is plan and lu.sf is sf
    for phase in ("ROWPERM", "COLPERM", "SYMBFACT", "DIST"):
        assert st.utime[phase] == 0.0
    lu2, bvals, _ = slt.analyze(
        slt.Options(fact=slt.Fact.SamePattern_SameRowPerm), _drift(a),
        device="cpu", lu=lu)
    fresh = numeric_factorize(plan, bvals, lu2.anorm,
                              dtype=lu.numeric.dtype, device="cpu")
    assert _fronts_equal(lu.numeric, fresh)
    _, jlu, _, _ = jslu.gssvx(
        jslu.Options(iter_refine=jslu.IterRefine.NOREFINE), ja, b)
    jax_refactor(jlu, _drift(ja))
    np.testing.assert_allclose(lu.solve_factored(b),
                               np.asarray(jlu.solve_factored(b)),
                               rtol=RTOL, atol=ATOL)


def test_refactor_raw_values_array():
    a = gallery.poisson2d(7)
    b = np.ones(a.n_rows)
    _, lu, _, _ = slt.gssvx(slt.Options(), a, b, device="cpu")
    _, base, _, _ = slt.gssvx(slt.Options(), a, b, device="cpu")
    vals = a.data * 0.5
    slt.refactor(lu, vals)
    slt.refactor(base, type(a)(a.n_rows, a.n_cols, a.indptr, a.indices,
                               vals))
    assert _fronts_equal(lu.numeric, base.numeric)
    with pytest.raises(slt.PatternMismatchError):
        slt.refactor(lu, vals[:-1])          # wrong nnz


def test_refactor_identity_latch():
    """The latch is stable and is the JAX package's digest and plan
    fingerprint, computed by the port's copies."""
    a = gallery.poisson2d(6)
    _, lu, _, _ = slt.gssvx(slt.Options(), a, np.ones(a.n_rows),
                            device="cpu")
    dig, fp = lu.identity()
    assert dig and fp
    assert dig == pattern_digest(lu.a_sym_indptr, lu.a_sym_indices)
    assert dig == jax_digest(lu.a_sym_indptr, lu.a_sym_indices)
    assert fp == jax_fp(lu.plan)
    assert lu.identity() == (dig, fp)


def test_pattern_drift_refused_structured():
    a = gallery.poisson2d(6)
    _, lu, _, _ = slt.gssvx(slt.Options(), a, np.ones(a.n_rows),
                            device="cpu")
    sf, plan, numeric = lu.sf, lu.plan, lu.numeric
    with pytest.raises(slt.PatternMismatchError) as ei:
        slt.refactor(lu, gallery.hilbert(a.n_rows))
    assert ei.value.expected_digest and ei.value.got_digest
    assert "DOFACT" in str(ei.value)
    assert lu.sf is sf and lu.plan is plan and lu.numeric is numeric
    assert np.isfinite(lu.solve_factored(np.ones(a.n_rows))).all()


def test_nan_values_roll_back_adopting_nothing():
    a = gallery.poisson2d(7)
    b = np.arange(1, a.n_rows + 1, dtype=np.float64)
    _, lu, _, _ = slt.gssvx(slt.Options(), a, b, device="cpu")
    x_before = lu.solve_factored(b)
    old_numeric, old_a = lu.numeric, lu.a
    bad = a.data.copy()
    bad[len(bad) // 2] = np.nan
    with pytest.raises(slt.RefactorRollbackError) as ei:
        slt.refactor(lu, bad)
    assert ei.value.stage in ("factor", "canary")
    assert lu.numeric is old_numeric and lu.a is old_a
    assert np.array_equal(lu.solve_factored(b), x_before)
    slt.refactor(lu, _drift(a))              # a clean refactor still adopts
    assert lu.numeric is not old_numeric


def test_berr_gate_rejects_without_adoption():
    a = gallery.poisson2d(7)
    _, lu, _, _ = slt.gssvx(slt.Options(), a, np.ones(a.n_rows),
                            device="cpu")
    old_numeric = lu.numeric
    with pytest.raises(slt.RefactorRollbackError) as ei:
        slt.refactor(lu, _drift(a), berr_max=1e-300, escalate=False)
    assert ei.value.stage == "canary"
    assert ei.value.berr > ei.value.berr_target >= 0
    assert lu.numeric is old_numeric
    # the GEMM ladder has no step above the port's tiers: escalating
    # cannot meet the gate either
    with pytest.raises(slt.RefactorRollbackError):
        slt.refactor(lu, _drift(a), berr_max=1e-300)
    slt.refactor(lu, _drift(a), berr_max=1e-8)    # a meetable gate adopts
    assert lu.numeric is not old_numeric


def test_refactor_requires_factored_handle():
    a = gallery.poisson2d(5)
    _, lu, _, _ = slt.gssvx(slt.Options(), a, np.ones(a.n_rows),
                            device="cpu")
    for field in ("sf", "plan", "numeric", "a_sym_indptr"):
        with pytest.raises(slt.SuperLUError):
            slt.refactor(dataclasses.replace(lu, **{field: None}), a)
