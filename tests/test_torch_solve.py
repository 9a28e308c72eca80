"""The port's device triangular solve (superlu_dist_tpu_torch/solve/device.py)
on factors carried over from the JAX package with
``factors_from_reference``, against the JAX host supernodal solve
(solve/trisolve.lu_solve) and the JAX ``DeviceSolver`` on the same
factors — every solve schedule, with and without DiagInv, chunked
right-hand sides, TRANS and CONJ — at the device-vs-host gate of
utils/tols (the two packages order the sweeps' sums differently)."""

import numpy as np
import pytest

from superlu_dist_tpu.drivers.gssvx import analyze as jax_analyze
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.numeric.factor import numeric_factorize as jax_factorize
from superlu_dist_tpu.solve.device import DeviceSolver as JaxDeviceSolver
from superlu_dist_tpu.solve.trisolve import lu_solve, lu_solve_trans
from superlu_dist_tpu.utils.options import Options as JaxOptions

from superlu_dist_tpu_torch.interop import factors_from_reference
from superlu_dist_tpu_torch.solve.device import DeviceSolver
from superlu_dist_tpu_torch.solve.plan import bucket_nrhs
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


# ---------------------------------------------------------------------------
# the port's DeviceSolver against the JAX DeviceSolver on the same factors
# (every schedule, DiagInv, chunked right-hand sides, TRANS and CONJ)
# ---------------------------------------------------------------------------

_REFS = {}


def _reference(name, complex_values=False):
    """JAX-package float64 (complex128) factors of one matrix, factored by
    its fused executor, and the same factors carried over to the port."""
    key = (name, complex_values)
    if key not in _REFS:
        a = MATRICES[name]()
        if complex_values:
            vals = a.data + 1j * np.random.default_rng(4).standard_normal(
                a.nnz)
            a = type(a)(a.n_rows, a.n_cols, a.indptr, a.indices, vals)
        lu, vals, _ = jax_analyze(JaxOptions(), a)
        ref = jax_factorize(lu.plan, vals, lu.anorm,
                            dtype="complex128" if complex_values
                            else "float64", executor="fused")
        _REFS[key] = (ref, factors_from_reference(ref, device="cpu"))
    return _REFS[key]


def _rhs(n, nrhs, complex_values=False, seed=7):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, nrhs))
    if complex_values:
        d = d + 1j * rng.standard_normal((n, nrhs))
    return d[:, 0] if nrhs == 1 else d


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want),
                               rtol=tols.DEVICE_VS_HOST_RTOL,
                               atol=tols.DEVICE_VS_HOST_ATOL)


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("diag_inv", [False, True])
@pytest.mark.parametrize("schedule", ["dataflow", "level", "factor"])
def test_device_solver_matches_jax_device_solver(schedule, diag_inv, nrhs):
    ref, fact = _reference("convdiff_12")
    d = _rhs(fact.plan.n, nrhs)
    port = DeviceSolver(fact, schedule=schedule, diag_inv=diag_inv)
    want = JaxDeviceSolver(ref, schedule=schedule, diag_inv=diag_inv).solve(d)
    got = port.solve(d)
    assert got.shape == d.shape
    _close(got, want)
    st = port.last_solve_stats
    assert st["nrhs"] == nrhs and st["chunks"] == 1 and st["finite"]
    assert st["padded_nrhs"] == bucket_nrhs(nrhs, port.splan.nrhs_bucket_set)
    assert st["executed_flops"] >= st["solve_flops"] > 0
    assert not st["fused"]                     # the CPU always runs eagerly
    _close(port.solve_trans(d), JaxDeviceSolver(
        ref, schedule=schedule).solve_trans(d))


def test_device_solver_chunked_past_bucket_cap():
    """nrhs past the cap (4) column-chunks: 4 + 4 + 1, reassembled exactly
    like the JAX solver's chunks."""
    ref, fact = _reference("random_80")
    d = _rhs(fact.plan.n, 9, seed=6)
    port = DeviceSolver(fact, nrhs_max=4)
    got = port.solve(d)
    assert port.last_solve_stats["chunks"] == 3
    assert port.last_solve_stats["padded_nrhs"] == 4 + 4 + 1
    _close(got, JaxDeviceSolver(ref, nrhs_max=4).solve(d))
    _close(got, lu_solve(ref, d))


@pytest.mark.parametrize("conj", [False, True])
def test_device_solver_trans_complex128_matches_jax(conj):
    ref, fact = _reference("random_80", complex_values=True)
    d = _rhs(fact.plan.n, 2, complex_values=True, seed=17)
    got = DeviceSolver(fact).solve_trans(d, conj=conj)
    _close(got, JaxDeviceSolver(ref).solve_trans(d, conj=conj))
    _close(got, lu_solve_trans(ref, d, conj=conj))
    _close(DeviceSolver(fact, diag_inv=True).solve(d), lu_solve(ref, d))


def test_device_solver_wide_rhs_batch():
    """40 columns: one padded bucket (64) of the closed set."""
    ref, fact = _reference("poisson3d_6")
    d = _rhs(fact.plan.n, 40, seed=31)
    port = DeviceSolver(fact)
    _close(port.solve(d), lu_solve(ref, d))
    assert port.last_solve_stats["padded_nrhs"] == 64


@pytest.mark.parametrize("options", [
    dict(diag_inv=True),
    dict(trans="TRANS"),
    dict(solve_schedule="factor", trans="CONJ"),
])
def test_device_solve_through_the_driver(options):
    """gssvx on the CPU through the device solver built from Options: the
    JAX package's gssvx answer with the same options, and BERR at its
    target."""
    from superlu_dist_tpu.drivers.gssvx import gssvx as jax_gssvx
    from superlu_dist_tpu.utils.options import Trans as JaxTrans

    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.models import gallery
    a = gallery.helmholtz_2d(14)
    b = a.matvec(_rhs(a.n_rows, 1, complex_values=True, seed=2))
    trans = options.pop("trans", "NOTRANS")
    x, lu, stats, info = slt.gssvx(
        slt.Options(trans=getattr(slt.Trans, trans), **options), a, b,
        device="cpu")
    xj, _, _, infoj = jax_gssvx(
        JaxOptions(trans=getattr(JaxTrans, trans), **options),
        jgal.helmholtz_2d(14), b)
    assert info == infoj == 0
    _close(x, xj)
    assert stats.solve_report.berr <= tols.berr_target(np.float64)
    assert lu.dev_solver.diag_inv == options.get("diag_inv", False)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_lsum_scatter_layers_add_in_slot_order(name):
    """Every sweep batch's lsum scatter: each contribution lands in
    exactly one layer, no real row repeats within a layer (so the card's
    index_add_ never has two atomics meet on an address), and the layered
    scatter equals the JAX package's ``lsum.at[rows].add`` bit for bit on
    the CPU (both add each row's hits in slot order)."""
    import jax.numpy as jnp
    import torch
    from superlu_dist_tpu_torch.solve.device import (_scatter_add,
                                                     scatter_layers)
    lu, vals, _ = jax_analyze(JaxOptions(), MATRICES[name]())
    ref = jax_factorize(lu.plan, vals, lu.anorm, dtype="float64",
                        executor="fused")
    solver = DeviceSolver(factors_from_reference(ref, device="cpu"))
    rng = np.random.default_rng(5)
    repeats = 0
    for sg, _, rows, layers in solver._groups:
        flat = rows.numpy().reshape(-1)
        again = scatter_layers(rows.numpy(), solver.n)
        assert (layers is None) == (again is None)
        if layers is not None:
            repeats += 1
            perm, parts = again
            assert np.array_equal(np.sort(perm), np.arange(len(flat)))
            for lo, hi, targets in parts:
                real = targets[targets < solver.n]
                assert len(np.unique(real)) == len(real)
                assert np.array_equal(targets, flat[perm[lo:hi]])
        contrib = rng.standard_normal((sg.batch, sg.u, 3))
        lsum = torch.as_tensor(rng.standard_normal((solver.n + 1, 3)))
        want = jnp.asarray(lsum.numpy()).at[flat].add(
            contrib.reshape(-1, 3))
        _scatter_add(lsum, rows, torch.as_tensor(contrib), layers)
        assert np.array_equal(lsum.numpy(), np.asarray(want))
    assert repeats > 0 or name == "random_80"
