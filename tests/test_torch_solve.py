"""The port's device triangular solve (superlu_dist_tpu_torch/solve/device.py)
on factors carried over from the JAX package with
``factors_from_reference``, against the JAX host supernodal solve
(solve/trisolve.lu_solve), at the device-vs-host gate of utils/tols."""

import numpy as np
import pytest

from superlu_dist_tpu.drivers.gssvx import analyze as jax_analyze
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.numeric.factor import numeric_factorize as jax_factorize
from superlu_dist_tpu.solve.trisolve import lu_solve
from superlu_dist_tpu.utils.options import Options as JaxOptions

from superlu_dist_tpu_torch.interop import factors_from_reference
from superlu_dist_tpu_torch.solve.device import DeviceSolver
from superlu_dist_tpu_torch.utils import tols

MATRICES = {
    "poisson3d_6": lambda: jgal.poisson3d(6),
    "convdiff_12": lambda: jgal.convection_diffusion_2d(12),
    "random_80": lambda: jgal.random_sparse(80, density=0.05, seed=3),
}


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_device_solver_matches_jax_lu_solve(name, nrhs):
    lu, vals, _ = jax_analyze(JaxOptions(), MATRICES[name]())
    ref = jax_factorize(lu.plan, vals, lu.anorm, dtype="float64",
                        executor="fused")
    rng = np.random.default_rng(7)
    d = rng.standard_normal((lu.n, nrhs))
    if nrhs == 1:
        d = d[:, 0]
    x = DeviceSolver(factors_from_reference(ref, device="cpu")).solve(d)
    x_ref = lu_solve(ref, d)
    assert x.shape == d.shape
    np.testing.assert_allclose(x, x_ref, rtol=tols.DEVICE_VS_HOST_RTOL,
                               atol=tols.DEVICE_VS_HOST_ATOL)
