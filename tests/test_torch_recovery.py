"""Solver health and recovery in the port against the JAX package: the
Hager–Higham estimate (``refine/condest.onenormest``, the same iterates as
the JAX package's on the same operator), rcond against the true
condition, the SolveReport fields, the escalation ladder on the
near-singular arrowhead and on ``hilbert(8)`` with float32 factors
(the same rungs as the JAX package's, BERR within 10·eps64), recovery
disabled, the escalated handle reused by FACTORED, the residual-precision
rung, and the sentinels."""

import numpy as np
import pytest
import torch

import superlu_dist_tpu as jslu
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.refine.condest import onenormest as jax_onenormest

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.refine.condest import onenormest
from superlu_dist_tpu_torch.utils import tols

EPS64 = float(np.finfo(np.float64).eps)
NEAR_SINGULAR = dict(n=60, delta=1e-6, seed=0)


def test_onenormest_never_overestimates_and_matches_jax():
    rng = np.random.default_rng(1)
    for n in (5, 23, 64):
        m = rng.standard_normal((n, n)) * np.exp(
            2 * rng.standard_normal(n))[:, None]
        true = float(np.abs(m).sum(axis=0).max())
        est = onenormest(n, lambda v: m @ v, lambda v: m.T @ v)
        assert est <= true * (1 + 1e-10)
        assert est >= 0.25 * true
        assert est == jax_onenormest(n, lambda v: m @ v, lambda v: m.T @ v)


def test_rcond_matches_true_condition():
    a = gallery.poisson2d(10)
    opts = slt.Options(recovery=slt.RecoveryPolicy(condest="always"))
    _, _, stats, info = slt.gssvx(opts, a, np.ones(a.n_rows), device="cpu")
    assert info == 0
    rep = stats.solve_report
    _, _, jstats, _ = jslu.gssvx(
        jslu.Options(recovery=jslu.RecoveryPolicy(condest="always")),
        jgal.poisson2d(10), np.ones(a.n_rows))
    true_rcond = 1.0 / np.linalg.cond(a.to_dense(), 1)
    assert true_rcond <= rep.rcond <= 4 * true_rcond
    # the same estimator on the same operator: solves that agree to the
    # device-vs-host gate give the same estimate to that gate
    np.testing.assert_allclose(rep.rcond, jstats.solve_report.rcond,
                               rtol=tols.DEVICE_VS_HOST_RTOL)
    assert rep.ferr is not None and all(f < 1e-8 for f in rep.ferr)


@pytest.mark.parametrize("trans", ["NOTRANS", "TRANS", "CONJ"])
def test_condest_through_transposed_and_complex_solves(trans):
    """rcond on a complex system solved in each direction; ferr where
    the adjoint solve exists."""
    a = gallery.helmholtz_2d(8)
    b = np.ones(a.n_rows, dtype=np.complex128)
    opts = slt.Options(trans=getattr(slt.Trans, trans),
                       recovery=slt.RecoveryPolicy(condest="always"))
    x, _, stats, _ = slt.gssvx(opts, a, b, device="cpu")
    rep = stats.solve_report
    true_rcond = 1.0 / np.linalg.cond(a.to_dense(), 1)
    assert 0.25 * true_rcond <= rep.rcond <= 4 * true_rcond
    if trans == "NOTRANS":
        assert rep.ferr and all(f < 1e-10 for f in rep.ferr)
    else:
        # as in the JAX package (drivers/gssvx._adjoint_solver): ferr is
        # estimated for a transposed complex system only when its adjoint
        # is the plain solve of a real matrix
        assert rep.ferr is None


def test_report_fields_well_conditioned_defaults():
    a = gallery.poisson2d(8)
    xt = np.random.default_rng(0).standard_normal(a.n_rows)
    _, _, stats, _ = slt.gssvx(slt.Options(), a, a.matvec(xt), device="cpu")
    rep = stats.solve_report
    assert isinstance(rep, slt.SolveReport)
    assert rep.converged and rep.finite
    assert rep.berr is not None and rep.berr <= rep.target
    assert rep.rungs == [] and rep.berr_history
    assert rep.rcond is None            # "auto": nothing to defend
    assert rep.factor_dtype == "float64" and rep.gemm_precision == "highest"
    assert "berr" in rep.summary()
    assert "solve health" in stats.report()


def test_escalation_ladder_recovers_near_singular_f32():
    """float32 factors of the near-singular arrowhead: the ladder records
    the same rungs as the JAX package's, adopts an improving one, and
    delivers BERR ≤ 10·eps64 with rcond populated."""
    a = gallery.rank_deficient_arrowhead(**NEAR_SINGULAR)
    b = a.matvec(np.random.default_rng(1).standard_normal(a.n_rows))
    x, lu, stats, info = slt.gssvx(slt.Options(factor_dtype="float32"), a,
                                   b, device="cpu")
    _, _, jstats, _ = jslu.gssvx(jslu.Options(factor_dtype="float32"),
                                 jgal.rank_deficient_arrowhead(
                                     **NEAR_SINGULAR), b)
    assert info == 0 and np.all(np.isfinite(x))
    rep = stats.solve_report
    names = [r.name for r in rep.rungs]
    assert names == [r.name for r in jstats.solve_report.rungs]
    assert "hiprec-factors" in names or "refactor-rescale" in names
    assert rep.berr <= 10 * EPS64, rep.summary()
    assert rep.converged and rep.rcond is not None and rep.rcond > 0
    assert [r for r in rep.rungs if r.berr_after < r.berr_before]
    assert lu.numeric.dtype == torch.float64 and rep.factor_dtype == "float64"


def test_recovery_disabled_flags_stagnation():
    a = gallery.rank_deficient_arrowhead(**NEAR_SINGULAR)
    b = a.matvec(np.random.default_rng(1).standard_normal(a.n_rows))
    opts = slt.Options(factor_dtype="float32",
                       recovery=slt.RecoveryPolicy(enabled=False))
    _, _, stats, _ = slt.gssvx(opts, a, b, device="cpu")
    rep = stats.solve_report
    assert rep.rungs == [] and not rep.converged
    assert rep.berr > rep.target
    assert rep.rcond is not None        # "auto" diagnoses non-convergence


def test_ladder_returns_escalated_handle():
    """After a hiprec-factors rung, FACTORED solves reuse the escalated
    factors and stay accurate."""
    a = gallery.rank_deficient_arrowhead(**NEAR_SINGULAR)
    rng = np.random.default_rng(2)
    b1 = a.matvec(rng.standard_normal(a.n_rows))
    _, lu, stats, info = slt.gssvx(slt.Options(factor_dtype="float32"), a,
                                   b1, device="cpu")
    assert info == 0 and stats.solve_report.rungs
    assert lu.numeric.dtype == torch.float64
    b2 = a.matvec(rng.standard_normal(a.n_rows))
    x2, lu2, stats2, info2 = slt.gssvx(slt.Options(fact=slt.Fact.FACTORED),
                                       a, b2, lu=lu)
    assert info2 == 0 and lu2 is lu and stats2.solve_report.rungs == []
    assert np.linalg.norm(b2 - a.matvec(x2)) / np.linalg.norm(b2) < 1e-12


def test_hilbert_f32_ladder():
    a = gallery.hilbert(8)
    b = a.matvec(np.ones(a.n_rows))
    _, _, stats, info = slt.gssvx(slt.Options(factor_dtype="float32"), a, b,
                                  device="cpu")
    rep = stats.solve_report
    assert info == 0 and rep.converged and rep.berr <= rep.target, \
        rep.summary()


def test_residual_precision_rung_slu_single():
    """SLU_SINGLE meets its own tier target with no ladder; against an
    explicit float64-class target its first rung escalates the residual
    to float64 on the same factors and reaches it."""
    a = gallery.poisson2d(10)
    b = a.matvec(np.random.default_rng(3).standard_normal(a.n_rows))
    opts = slt.Options(iter_refine=slt.IterRefine.SLU_SINGLE)
    _, _, stats, _ = slt.gssvx(opts, a, b, device="cpu")
    assert stats.solve_report.converged and stats.solve_report.rungs == []
    opts = slt.Options(iter_refine=slt.IterRefine.SLU_SINGLE,
                       recovery=slt.RecoveryPolicy(berr_target=1e-14))
    _, lu, stats, _ = slt.gssvx(opts, a, b, device="cpu")
    rep = stats.solve_report
    assert [r.name for r in rep.rungs][:1] == ["residual-precision"]
    assert rep.berr < float(np.finfo(np.float32).eps)
    assert rep.berr <= 1e-14 and rep.converged


def test_nan_input_trips_the_sentinel():
    a = gallery.poisson2d(8)
    a.data = a.data.copy()
    a.data[len(a.data) // 2] = np.nan
    opts = slt.Options(equil=False, row_perm=slt.RowPerm.NOROWPERM)
    with pytest.raises(slt.NumericBreakdownError):
        slt.gssvx(opts, a, np.ones(a.n_rows), device="cpu")
    opts = slt.Options(equil=False, row_perm=slt.RowPerm.NOROWPERM,
                       iter_refine=slt.IterRefine.NOREFINE,
                       recovery=slt.RecoveryPolicy(enabled=False,
                                                   sentinels=False,
                                                   condest="never"))
    x, _, stats, _ = slt.gssvx(opts, a, np.ones(a.n_rows), device="cpu")
    assert not np.all(np.isfinite(x))
    assert stats.solve_report.finite is False


def test_singular_without_replacement_reports_info():
    a = gallery.zero_row_col(6, which="row")
    opts = slt.Options(replace_tiny_pivot=False, equil=False,
                       row_perm=slt.RowPerm.NOROWPERM,
                       iter_refine=slt.IterRefine.NOREFINE)
    x, lu, _, info = slt.gssvx(opts, a, np.ones(a.n_rows), device="cpu")
    assert info > 0 and x is None and not lu.numeric.finite
    with pytest.raises(slt.SingularMatrixError) as exc:
        lu.solve_factored(np.ones(a.n_rows))
    assert exc.value.info == info
