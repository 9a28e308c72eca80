"""The port's GEMM precision ladder (superlu_dist_tpu_torch/ops/dense.py),
its escalation rung in the driver, and the refinement's device residual
(parallel/dist.DeviceSpMV with its plain twin ``csr_spmv_plain``), against
the JAX package's counterparts on the CPU.

On the CPU the default, f32 and highest tiers are one arithmetic (bitwise
equal); bf16 rounds the inputs.  The twin's sums run in CSR order, the
JAX scatter-add and scipy in their own, so they agree to a small multiple
of eps, stated per check."""

import numpy as np
import pytest
import torch

from superlu_dist_tpu.drivers.gssvx import gssvx as jax_gssvx
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.ops import dense as jdense
from superlu_dist_tpu.parallel.dist import DeviceSpMV as JaxDeviceSpMV
from superlu_dist_tpu.sparse.formats import SparseCSR as JaxCSR
from superlu_dist_tpu.utils.options import Options as JaxOptions

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.ops import dense
from superlu_dist_tpu_torch.parallel.dist import (DeviceSpMV, csr_spmv,
                                                  csr_spmv_plain)
from superlu_dist_tpu_torch.utils import tols


# ---------------------------------------------------------------------------
# tiers and the step rule
# ---------------------------------------------------------------------------

def test_tier_resolution_and_ladder_order(monkeypatch):
    monkeypatch.delenv("SLU_TPU_GEMM_PREC", raising=False)
    monkeypatch.delenv("SLU_TPU_PRECISION", raising=False)
    assert dense.GEMM_PREC_LADDER == jdense.GEMM_PREC_LADDER
    assert dense.gemm_precision() == jdense.gemm_precision() == "default"
    for name in ("bf16", "default", "f32", "highest", " F32 "):
        assert dense.gemm_precision(name) == jdense.gemm_precision(name)
    with pytest.raises(ValueError):
        dense.gemm_precision("tf16")


@pytest.mark.parametrize("tier", ["bf16", "default", "f32", "highest"])
def test_step_rule(tier):
    """CPU: the JAX rule on its CPU backend (bf16 → default, then None).
    Card: bf16 → default → f32, then None — f32 and highest are the same
    IEEE products there (the JAX rule on a TPU goes on to highest)."""
    assert (dense.next_gemm_precision(tier, "cpu")
            == jdense.next_gemm_precision(tier, backend="cpu"))
    card = {"bf16": "default", "default": "f32", "f32": None,
            "highest": None}
    assert dense.next_gemm_precision(tier, "cuda") == card[tier]
    assert dense.next_gemm_precision(tier, torch.device("cuda")) == card[tier]


def test_complex_bf16_resolves_to_default():
    for dt in (torch.complex64, torch.complex128):
        assert dense.resolve_gemm_tier("bf16", dt) == "default"
        assert (jdense.resolve_gemm_tier("bf16", np.dtype(str(dt)[6:]))
                == "default")
    assert dense.resolve_gemm_tier("bf16", torch.float32) == "bf16"
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((2, 5, 7))
                         + 1j * rng.standard_normal((2, 5, 7)))
    b = torch.from_numpy(rng.standard_normal((2, 7, 3))
                         + 1j * rng.standard_normal((2, 7, 3)))
    assert torch.equal(dense.gemm(a, b, "bf16"), dense.gemm(a, b, "default"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_tiers_bitwise_and_bf16_rounds(dtype):
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((3, 40, 24))).to(dtype)
    b = torch.from_numpy(rng.standard_normal((3, 24, 17))).to(dtype)
    top = dense.gemm(a, b, "highest")
    for tier in ("default", "f32"):
        assert torch.equal(dense.gemm(a, b, tier), top)
    low = dense.gemm(a, b, "bf16")
    assert low.dtype == dtype and not torch.equal(low, top)
    # bf16 inputs (8 mantissa bits): relative error ~ 2^-8 per product
    assert torch.allclose(low, top, rtol=0.05, atol=0.05 * 24 ** 0.5)
    ref = np.asarray(jdense.gemm(a.numpy(), b.numpy(), "bf16"))
    np.testing.assert_allclose(low.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_options_defaults_match_jax(monkeypatch):
    for knob in ("SLU_TPU_GEMM_PREC", "SLU_TPU_PRECISION",
                 "SLU_TPU_SOLVE_SCHEDULE", "SLU_TPU_SOLVE_WINDOW",
                 "SLU_TPU_SOLVE_ALIGN"):
        monkeypatch.delenv(knob, raising=False)
    o, j = slt.Options(), JaxOptions()
    assert o.gemm_prec == jdense.gemm_precision(j.gemm_prec) == "default"
    assert (o.solve_schedule, o.solve_window, o.solve_align, o.diag_inv) \
        == (j.solve_schedule, j.solve_window, j.solve_align, j.diag_inv) \
        == ("dataflow", 0, 1.25, False)


# ---------------------------------------------------------------------------
# the gemm-precision rung (the JAX package's tests/test_precision_ladder.py)
# ---------------------------------------------------------------------------

def test_escalation_rung_fires_on_hilbert_bf16():
    a = gallery.hilbert(8)
    b = a.matvec(np.ones(a.n_rows))
    x, lu, stats, info = slt.gssvx(slt.Options(gemm_prec="bf16",
                                               factor_dtype="float32"), a, b,
                                   device="cpu")
    assert info == 0
    rep = stats.solve_report
    names = [r.name for r in rep.rungs]
    assert "gemm-precision" in names, rep.summary()
    assert rep.converged and rep.berr <= rep.target, rep.summary()
    assert (rep.gemm_precision != "bf16"
            or rep.factor_dtype != "float32"), rep.summary()
    _, _, jstats, _ = jax_gssvx(JaxOptions(gemm_prec="bf16",
                                           factor_dtype="float32"),
                                jgal.hilbert(8), b)
    assert names == [r.name for r in jstats.solve_report.rungs]


def test_norefine_still_gated_on_reduced_tier():
    a = gallery.hilbert(8)
    b = a.matvec(np.ones(a.n_rows))
    _, _, stats, info = slt.gssvx(
        slt.Options(gemm_prec="bf16", factor_dtype="float32",
                    iter_refine=slt.IterRefine.NOREFINE), a, b, device="cpu")
    rep = stats.solve_report
    assert info == 0 and rep.target is not None and rep.rungs
    assert rep.converged and rep.berr <= rep.target, rep.summary()


def test_well_conditioned_fast_tier_no_rungs():
    a = gallery.poisson2d(12)
    _, lu, stats, info = slt.gssvx(slt.Options(), a,
                                   a.matvec(np.ones(a.n_rows)), device="cpu")
    rep = stats.solve_report
    assert info == 0 and rep.converged and rep.rungs == []
    assert rep.gemm_precision == lu.numeric.gemm_prec == "default"


def test_refactor_canary_climbs_the_ladder():
    """A canary miss at bf16 refactors one tier up (the CPU's only step):
    poisson3d(8) with float32 factors gives a canary BERR near 1e-3 at bf16
    and near 2e-7 at default."""
    a = gallery.poisson3d(8)
    _, lu, _, _ = slt.gssvx(slt.Options(gemm_prec="bf16",
                                        factor_dtype="float32",
                                        recovery=slt.RecoveryPolicy(
                                            enabled=False)), a,
                            np.ones(a.n_rows), device="cpu")
    slt.refactor(lu, a.data * 1.0, berr_max=1e-5)
    assert lu.numeric.gemm_prec == lu.options.gemm_prec == "default"
    with pytest.raises(slt.RefactorRollbackError):
        slt.refactor(lu, a.data * 1.0, berr_max=1e-12)


def test_gssvx_defaults_match_jax():
    """gssvx(Options()) on the CPU with the new defaults against the JAX
    package's gssvx(Options())."""
    a = gallery.convection_diffusion_2d(20)
    xt = np.random.default_rng(3).standard_normal(a.n_rows)
    b = a.matvec(xt)
    x, lu, stats, info = slt.gssvx(slt.Options(), a, b, device="cpu")
    xj, _, jstats, infoj = jax_gssvx(JaxOptions(),
                                     jgal.convection_diffusion_2d(20), b)
    assert info == infoj == 0
    np.testing.assert_allclose(x, xj, rtol=tols.DEVICE_VS_HOST_RTOL,
                               atol=tols.DEVICE_VS_HOST_ATOL)
    assert stats.solve_report.berr <= tols.berr_target(np.float64)
    assert stats.solve_report.gemm_precision == "default"
    assert lu.dev_solver.splan.schedule == "dataflow"
    assert lu.dev_spmv is None           # the CPU refines on the host


# ---------------------------------------------------------------------------
# DeviceSpMV and the csr_spmv twin
# ---------------------------------------------------------------------------

def _with_empty_rows(a, rows):
    """a with the entries of ``rows`` removed (CSR kept valid)."""
    keep = ~np.isin(np.repeat(np.arange(a.n_rows), np.diff(a.indptr)), rows)
    counts = np.bincount(np.repeat(np.arange(a.n_rows), np.diff(a.indptr))[keep],
                         minlength=a.n_rows)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return slt.SparseCSR(a.n_rows, a.n_cols, indptr, a.indices[keep],
                         a.data[keep])


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
@pytest.mark.parametrize("ncols", [1, 3])
def test_device_spmv_twin_matches_jax_and_host(dtype, ncols):
    a = gallery.random_sparse(300, density=0.02, seed=4,
                              dtype=np.dtype(dtype))
    a = _with_empty_rows(a, [0, 17, 299])
    rng = np.random.default_rng(5)
    x = rng.standard_normal((a.n_cols, ncols))
    if dtype == "complex128":
        x = x + 1j * rng.standard_normal(x.shape)
    x = x[:, 0] if ncols == 1 else x
    port = DeviceSpMV(a, device="cpu")
    jax_op = JaxDeviceSpMV(JaxCSR(a.n_rows, a.n_cols, a.indptr, a.indices,
                                  a.data))
    eps = np.finfo(np.float64).eps
    x2 = x[:, None] if ncols == 1 else x
    scale = np.stack([a.abs_matvec(np.abs(c)) for c in x2.T], axis=1)
    scale = scale[:, 0] if ncols == 1 else scale
    cases = [(port.matvec(x), a.matvec(x), jax_op.matvec(x), scale)]
    for c in np.abs(x2.T):        # |A|·x takes one real column at a time
        s1 = a.abs_matvec(c)
        cases.append((port.abs_matvec(c), s1, jax_op.abs_matvec(c), s1))
    for got, host, ref, sc in cases:
        assert got.shape == host.shape and got.dtype == host.dtype
        assert np.all(np.abs(got - host) <= 16 * eps * sc)
        assert np.all(np.abs(got - np.asarray(ref)) <= 16 * eps * sc)
    assert port.nnz == a.nnz
    empty = port.matvec(x)[[0, 17, 299]]
    assert not np.any(empty)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
def test_csr_spmv_plain_order_and_rows(dtype):
    """The twin walks each row in CSR order: for a row of length 1 the
    product itself, for an empty row zero, and in general the left-to-right
    sum of the rounded products (checked against a Python loop)."""
    rng = np.random.default_rng(9)
    indptr = np.array([0, 0, 1, 4, 4, 9])
    indices = rng.integers(0, 6, 9)
    vals = rng.standard_normal(9)
    x = rng.standard_normal((6, 2))
    if dtype.is_complex:
        vals = vals + 1j * rng.standard_normal(9)
        x = x + 1j * rng.standard_normal((6, 2))
    tv = torch.as_tensor(vals).to(dtype)
    tx = torch.as_tensor(x).to(dtype)
    y = csr_spmv(torch.as_tensor(indptr), torch.as_tensor(indices), tv, tx)
    assert y.dtype == dtype and y.shape == (5, 2)
    want = torch.zeros((5, 2), dtype=dtype)
    for r in range(5):
        for e in range(indptr[r], indptr[r + 1]):
            if dtype.is_complex:
                ar, ai = tv[e].real, tv[e].imag
                xr, xi = tx[indices[e]].real, tx[indices[e]].imag
                want[r] = want[r] + torch.complex(ar * xr - ai * xi,
                                                  ar * xi + ai * xr)
            else:
                want[r] = want[r] + tv[e] * tx[indices[e]]
    assert torch.equal(y, want)
    assert torch.equal(y[0], torch.zeros(2, dtype=dtype))
    assert torch.equal(csr_spmv_plain(torch.as_tensor(indptr),
                                      torch.as_tensor(indices), tv, tx), y)
    with pytest.raises(TypeError):
        csr_spmv(torch.as_tensor(indptr, dtype=torch.int32),
                 torch.as_tensor(indices), tv, tx)


def test_abs_matvec_takes_columns_at_once():
    """Refinement takes |A|·|x| of all columns in one call: each column's
    sums equal the one-column call bit for bit, on the host and through
    DeviceSpMV's twin."""
    a = gallery.random_sparse(300, density=0.02, seed=4, dtype=np.complex128)
    x = np.abs(np.random.default_rng(0).standard_normal((300, 4)))
    for op in (a, DeviceSpMV(a, device="cpu")):
        cols = np.stack([op.abs_matvec(x[:, k]) for k in range(4)], axis=1)
        assert np.array_equal(op.abs_matvec(x), cols)
