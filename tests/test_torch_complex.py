"""Complex factors in the port (complex64 / complex128) against the JAX
package, on the same seeded inputs:

* the host path on complex values — transpose, SpMVs, equilibration, MC64
  on the moduli — gives the JAX package's arrays exactly;
* the plain front assembly (``front_assemble_plain``) on every group of
  three plans equals, bit for bit, the JAX composition — ``jnp.zeros``,
  the identity ``.at[].add``, ``assemble_avals_pallas`` in interpret mode,
  then numeric/factor.py ``extend_add_set`` per child set (the JAX
  package's Pallas extend-add raises on complex in interpret mode, and
  its CPU path is this ``.at[]`` lowering);
* complex factors agree with the JAX fused executor at the
  cross-schedule drift gate (complex128; complex64 at the same ulp
  budget of float32);
* ``gssvx`` on complex matrices with complex64 and complex128 factors
  agrees with the JAX ``gssvx`` at the device-vs-host gate, and its BERR
  meets ``berr_target(float64)``.
On CPU tensors the wrapper takes the plain version; the CUDA kernel is
held against it on a card (tests/test_torch_cuda.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import superlu_dist_tpu as jslu
import superlu_dist_tpu.native as jax_native
from superlu_dist_tpu.drivers.gssvx import analyze as jax_analyze
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.numeric.factor import extend_add_set
from superlu_dist_tpu.numeric.factor import numeric_factorize as jax_factorize
from superlu_dist_tpu.numeric.pallas_kernels import assemble_avals_pallas
from superlu_dist_tpu.rowperm import equil as jax_equil
from superlu_dist_tpu.rowperm import matching as jax_matching
from superlu_dist_tpu.utils.options import Options as JaxOptions

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.interop import (factors_from_reference,
                                           plan_from_reference)
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.numeric import kernels
from superlu_dist_tpu_torch.numeric.factor import (numeric_factorize,
                                                   upload_maps)
from superlu_dist_tpu_torch.rowperm import equil, matching
from superlu_dist_tpu_torch.utils import tols

PLANS = {
    "helmholtz_12": lambda g: g.helmholtz_2d(12),
    "poisson3d_6": lambda g: g.poisson3d(6),
    "random_80": lambda g: g.random_sparse(80, density=0.05, seed=3,
                                           dtype=np.complex128),
}
CDTYPES = [np.complex64, np.complex128]


def _crandn(rng, n, dtype):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(dtype)


def _jax_fronts(grp, avals, pool):
    """One group's assembled fronts through the JAX package on the CPU."""
    batch, m, w = grp.batch, grp.m, grp.w
    dt = pool.dtype
    f = jnp.zeros((batch, m * m), dtype=dt)
    k = jnp.arange(m)
    ws = jnp.asarray(grp.ws)
    diag_mask = (k[None, :] >= ws[:, None]) & (k[None, :] < w)
    f = f.at[:, k * m + k].add(diag_mask.astype(dt))
    if len(grp.a_src):
        f = assemble_avals_pallas(f, avals, jnp.asarray(grp.a_slot),
                                  jnp.asarray(grp.a_flat),
                                  jnp.asarray(grp.a_src), mode="interpret")
    for cs in grp.children:
        f = extend_add_set(f, pool, m, cs.ub, jnp.asarray(cs.child_off),
                           jnp.asarray(cs.child_slot), jnp.asarray(cs.rel))
    return np.asarray(f)


@pytest.mark.parametrize("name,native", [
    pytest.param(name, native, id=name + ("-native" if native else ""))
    for native in (False, True) for name in ("helmholtz_12", "random_80")])
def test_complex_host_path_matches_jax(name, native, monkeypatch):
    """On complex values the port's transpose, SpMVs, equilibration and
    MC64 (on the moduli) give the JAX package's results exactly: the
    Python MC64 against the JAX package with its native library off, the
    native MC64 against the JAX package's native one."""
    if not native:
        monkeypatch.setattr(jax_native, "_lib", None)
        monkeypatch.setattr(jax_native, "_tried", True)
    assert jax_native.available() == native
    a, ja = PLANS[name](gallery), PLANS[name](jgal)
    assert a.data.dtype == ja.data.dtype == np.complex128
    t, jt = a.transpose(), ja.transpose()
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(t, f), getattr(jt, f))
    rng = np.random.default_rng(4)
    x = _crandn(rng, a.n_rows, np.complex128)
    assert np.array_equal(a.matvec(x), ja.matvec(x))
    assert np.array_equal(a.abs_matvec(np.abs(x)), ja.abs_matvec(np.abs(x)))
    scal = equil.gsequ(a)
    for got, want in zip(scal, jax_equil.gsequ(ja)):
        assert np.array_equal(got, want)
    a1, equed = equil.laqgs(a, *scal)
    ja1, jequed = jax_equil.laqgs(ja, *scal)
    assert equed == jequed and np.array_equal(a1.data, ja1.data)
    for got, want in zip(matching.maximum_product_matching(a1, native=native),
                         jax_matching.maximum_product_matching(ja1)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("name", sorted(PLANS))
def test_front_assemble_plain_equals_jax(name, dtype):
    lu, vals, _ = jax_analyze(JaxOptions(), PLANS[name](jgal))
    plan = lu.plan
    rng = np.random.default_rng(21)
    avals = _crandn(rng, len(vals), dtype)
    pool = _crandn(rng, plan.pool_size, dtype)
    port = plan_from_reference(plan)
    maps = upload_maps(port, torch.device("cpu"))
    kernels.reset_launches()
    for grp, pgrp, gm in zip(plan.groups, port.groups, maps):
        out = kernels.front_assemble_(torch.from_numpy(avals),
                                      torch.from_numpy(pool), pgrp.m, pgrp.w,
                                      gm).numpy()
        ref = _jax_fronts(grp, jnp.asarray(avals), jnp.asarray(pool))
        assert out.dtype == dtype and out.shape == ref.shape
        assert np.array_equal(out.view(np.uint8), ref.view(np.uint8))
    assert not any(kernels.LAUNCHES.values())     # CPU: the plain version


#: complex64 factors agree to the drift gate's ulp budget of float32
C64_RTOL = tols.tol("float32", 2 ** 16, "cross-schedule drift, complex64")
C64_ATOL = tols.tol("float32", 2 ** 9, "cross-schedule floor, complex64")


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
@pytest.mark.parametrize("name", ["helmholtz_12", "random_80"])
@pytest.mark.parametrize("anorm_scale", [1.0, 1e18])
def test_complex_factors_match_jax_fused(name, dtype, anorm_scale):
    """anorm_scale=1e18 replaces every pivot: the phase-keeping GESP
    replacement on complex pivots, end to end."""
    lu, vals, _ = jax_analyze(JaxOptions(), PLANS[name](jgal))
    anorm = lu.anorm * anorm_scale
    ref = jax_factorize(lu.plan, vals, anorm, dtype=dtype, executor="fused")
    out = numeric_factorize(plan_from_reference(lu.plan), vals, anorm,
                            dtype=getattr(torch, dtype), device="cpu")
    assert out.dtype == getattr(torch, dtype)
    assert out.tiny_pivots == ref.tiny_pivots
    if anorm_scale > 1:
        assert out.tiny_pivots == lu.n
    rtol, atol = ((tols.SCHEDULE_DRIFT_RTOL, tols.SCHEDULE_DRIFT_ATOL)
                  if dtype == "complex128" else (C64_RTOL, C64_ATOL))
    for (lp, up), (rlp, rup) in zip(out.fronts, ref.fronts):
        np.testing.assert_allclose(lp.numpy(), np.asarray(rlp), rtol=rtol,
                                   atol=atol)
        np.testing.assert_allclose(up.numpy(), np.asarray(rup), rtol=rtol,
                                   atol=atol)


def test_factors_from_reference_carry_complex():
    lu, vals, _ = jax_analyze(JaxOptions(), PLANS["helmholtz_12"](jgal))
    ref = jax_factorize(lu.plan, vals, lu.anorm, dtype="complex128",
                        executor="fused")
    out = factors_from_reference(ref, device="cpu")
    assert out.dtype == torch.complex128
    for (lp, up), (rlp, rup) in zip(out.fronts, ref.fronts):
        assert np.array_equal(lp.numpy(), np.asarray(rlp))
        assert np.array_equal(up.numpy(), np.asarray(rup))


GSSVX = {
    "helmholtz_20": lambda g: g.helmholtz_2d(20),
    "random_120c": lambda g: g.random_sparse(120, density=0.04, seed=5,
                                             dtype=np.complex128),
}


@pytest.mark.parametrize("factor_dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(GSSVX))
def test_complex_gssvx_matches_jax(name, factor_dtype):
    """factor_dtype float32/float64 on complex values gives complex64 /
    complex128 factors (the JAX promotion rule), refined with a
    complex128 residual."""
    a = GSSVX[name](gallery)
    rng = np.random.default_rng(8)
    b = _crandn(rng, a.n_rows, np.complex128)
    x, lu, stats, info = slt.gssvx(slt.Options(factor_dtype=factor_dtype),
                                   a, b, device="cpu")
    x_ref, lu_ref, _, info_ref = jslu.gssvx(
        jslu.Options(factor_dtype=factor_dtype), GSSVX[name](jgal), b)
    assert info == info_ref == 0
    want = {"float32": torch.complex64, "float64": torch.complex128}
    assert lu.numeric.dtype == want[factor_dtype]
    assert str(lu_ref.numeric.dtype) == str(want[factor_dtype]).split(".")[1]
    assert x.dtype == np.complex128
    np.testing.assert_allclose(x, x_ref, rtol=tols.DEVICE_VS_HOST_RTOL,
                               atol=tols.DEVICE_VS_HOST_ATOL)
    assert stats.solve_report.berr <= tols.berr_target(np.float64)
    assert stats.solve_report.factor_dtype == str(want[factor_dtype]).split(
        ".")[1]
