"""Transposed and conjugate-transposed solves in the port against the JAX
package:

* ``DeviceSolver.solve_trans`` (TRANS and CONJ, one and three right-hand
  sides) on factors carried over with ``factors_from_reference``, against
  the JAX ``DeviceSolver.solve_trans`` and the host supernodal
  ``solve/trisolve.lu_solve_trans``, at the device-vs-host gate;
* ``gssvx`` with ``Options(trans=...)`` against the JAX ``gssvx`` with
  the same option, at the device-vs-host gate, its BERR (taken against
  Aᵀ or Aᴴ) within ``berr_target(float64)``."""

import numpy as np
import pytest

import superlu_dist_tpu as jslu
from superlu_dist_tpu.drivers.gssvx import analyze as jax_analyze
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.numeric.factor import numeric_factorize as jax_factorize
from superlu_dist_tpu.solve.device import DeviceSolver as JaxDeviceSolver
from superlu_dist_tpu.solve.trisolve import lu_solve_trans
from superlu_dist_tpu.utils.options import Options as JaxOptions

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.interop import factors_from_reference
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.solve.device import DeviceSolver
from superlu_dist_tpu_torch.utils import tols

RTOL, ATOL = tols.DEVICE_VS_HOST_RTOL, tols.DEVICE_VS_HOST_ATOL

MATRICES = {
    "convdiff_12": (lambda g: g.convection_diffusion_2d(12), "float64"),
    "random_80c": (lambda g: g.random_sparse(80, density=0.05, seed=3,
                                             dtype=np.complex128),
                   "complex128"),
    "helmholtz_10": (lambda g: g.helmholtz_2d(10), "complex128"),
}


def _rhs(n, nrhs, cplx, seed=7):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, nrhs))
    if cplx:
        d = d + 1j * rng.standard_normal((n, nrhs))
    return d[:, 0] if nrhs == 1 else d


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_solve_trans_matches_jax(name, conj, nrhs):
    make, dtype = MATRICES[name]
    lu, vals, _ = jax_analyze(JaxOptions(), make(jgal))
    ref = jax_factorize(lu.plan, vals, lu.anorm, dtype=dtype,
                        executor="fused")
    d = _rhs(lu.n, nrhs, dtype.startswith("complex"))
    x = DeviceSolver(factors_from_reference(ref, device="cpu")).solve_trans(
        d, conj=conj)
    assert x.shape == d.shape
    np.testing.assert_allclose(x, lu_solve_trans(ref, d, conj=conj),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        x, np.asarray(JaxDeviceSolver(ref).solve_trans(d, conj=conj)),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("trans", ["TRANS", "CONJ"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_gssvx_trans_matches_jax(name, trans):
    make, dtype = MATRICES[name]
    a = make(gallery)
    cplx = dtype.startswith("complex")
    b = _rhs(a.n_rows, 2, cplx, seed=4)
    x, lu, stats, info = slt.gssvx(slt.Options(trans=getattr(slt.Trans,
                                                             trans)),
                                   a, b, device="cpu")
    x_ref, _, _, info_ref = jslu.gssvx(
        jslu.Options(trans=getattr(jslu.Trans, trans)), make(jgal), b)
    assert info == info_ref == 0
    np.testing.assert_allclose(x, x_ref, rtol=RTOL, atol=ATOL)
    op = a.to_dense().T
    if trans == "CONJ":
        op = op.conj()
    assert np.linalg.norm(op @ x - b) <= tols.RESID_GATE * np.linalg.norm(b)
    assert stats.solve_report.berr <= tols.berr_target(np.float64)


def test_complex_rhs_with_real_factors_solves_both_parts():
    """A complex right-hand side through real factors is solved as its
    real and imaginary parts, in both directions (to the drift gate: the
    parts are solved as four columns at once, the references as two)."""
    a = gallery.convection_diffusion_2d(9)
    _, lu, _, _ = slt.gssvx(slt.Options(), a, np.ones(a.n_rows),
                            device="cpu")
    d = _rhs(a.n_rows, 2, True, seed=5)
    for solve in (lu.solve_factored,
                  lambda r: lu.solve_factored_trans(r, conj=True)):
        x = solve(d)
        assert np.iscomplexobj(x)
        for part, got in ((d.real, x.real), (d.imag, x.imag)):
            np.testing.assert_allclose(got, solve(part),
                                       rtol=tols.SCHEDULE_DRIFT_RTOL,
                                       atol=tols.SCHEDULE_DRIFT_ATOL)
