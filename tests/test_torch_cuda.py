"""The port's CUDA kernel on a card: the front assembly and the two
standalone wrappers (K1, K2) against their plain PyTorch versions (bit
for bit) in float32, float64, complex64 and complex128, the factorization
through the kernel against the one through the plain version (real and
complex), gssvx on the card, transposed and conjugate solves on the card
against the same solves on the CPU, and refactor on the card.

These tests need an NVIDIA GPU and skip without one.  The JAX package is
not installed beside the card, so run them without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.models.gallery import (helmholtz_2d, poisson3d,
                                                  random_sparse)
from superlu_dist_tpu_torch.numeric import factor, kernels
from superlu_dist_tpu_torch.utils import tols

pytestmark = pytest.mark.cuda

ROOT = pathlib.Path(__file__).resolve().parents[1]


DTYPES = [torch.float32, torch.float64, torch.complex64, torch.complex128]


def _rand(rng, shape, dtype, device):
    """Seeded numpy values as a tensor of ``dtype`` (complex: both parts)."""
    x = rng.standard_normal(shape)
    if dtype.is_complex:
        x = x + 1j * rng.standard_normal(shape)
    return torch.as_tensor(x, device=device).to(dtype)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", DTYPES)
def test_extend_add_kernel_equals_plain(cuda, dtype):
    rng = np.random.default_rng(0)
    m, ub, batch, nc = 70, 24, 5, 40
    pool_len = nc * ub * ub + 10
    off = rng.integers(0, pool_len - ub * ub, nc)
    off[3] = pool_len                                # dropped child
    slot = rng.integers(0, batch, nc)
    slot[5] = batch                                  # dropped child
    rel = np.full((nc, ub), m, dtype=np.int64)
    for c in range(nc):
        k = rng.integers(1, ub + 1)
        rel[c, :k] = np.sort(rng.choice(m, size=k, replace=False))
    args = [torch.as_tensor(x, device=cuda) for x in (off, slot, rel)]
    pool = _rand(rng, pool_len, dtype, cuda)
    f = _rand(rng, (batch, m * m), dtype, cuda)
    kernels.reset_launches()
    a, b = f.clone(), f.clone()
    kernels.extend_add_(a, pool, m, ub, *args)
    kernels.extend_add_plain(b, pool, m, ub, *args)
    assert kernels.LAUNCHES["extend_add"] == 1
    assert torch.equal(a, b) and not torch.equal(a, f)


@pytest.mark.parametrize("dtype", DTYPES)
def test_assemble_kernel_equals_plain(cuda, dtype):
    rng = np.random.default_rng(1)
    batch, m2, n_avals, n = 6, 900, 500, 3000
    tgt = rng.choice(batch * m2, size=n, replace=False)
    slot, flat = tgt // m2, tgt % m2
    slot[:7] = batch                                 # dropped entries
    src = rng.integers(0, n_avals + 20, n)           # some read 0
    idx = [torch.as_tensor(x, device=cuda) for x in (slot, flat, src)]
    avals = _rand(rng, n_avals, dtype, cuda)
    f = _rand(rng, (batch, m2), dtype, cuda)
    kernels.reset_launches()
    a, b = f.clone(), f.clone()
    kernels.assemble_(a, avals, *idx)
    kernels.assemble_plain(b, avals, *idx)
    assert kernels.LAUNCHES["assemble"] == 1
    assert torch.equal(a, b)


def _sentinel_group(rng, device, m=150, batch=3, pool_len=6000,
                    n_avals=400):
    """A group with every sentinel, in build mode: A entries dropped by
    slot and by flat target and reading past avals; children dropped by
    slot and by offset, reading past the pool, with unsorted rel and
    m padding, in two sets whose children share slots and positions; m
    not a multiple of 4, so the scalar path runs over several tiles."""
    tgt = rng.choice(batch * m * m, size=300, replace=False)
    a_slot = np.concatenate([tgt // (m * m), [batch, 0]])
    a_flat = np.concatenate([tgt % (m * m), [0, m * m]])
    a_src = np.concatenate([rng.integers(0, n_avals + 20, 300), [0, 0]])
    children = []
    for ub, nc in ((20, 7), (7, 6)):
        off = rng.integers(0, pool_len - ub * ub, nc)
        off[0] = pool_len                            # dropped child
        off[1] = pool_len - 30                       # reads past the pool
        slot = rng.integers(0, batch, nc)
        slot[2] = batch                              # dropped child
        rel = np.full((nc, ub), m, dtype=np.int64)
        for c in range(nc):
            k = rng.integers(1, ub + 1)
            rel[c, :k] = rng.choice(m, size=k, replace=False)   # unsorted
            rng.shuffle(rel[c])
        children.append((ub, off, slot, rel))

    def put(x):
        return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)
    ws = np.array([m // 3, 0, m - 5])
    maps = kernels.GroupMaps(
        ws=put(ws), off=put(np.zeros(batch)), a_slot=put(a_slot),
        a_flat=put(a_flat), a_src=put(a_src),
        children=[(ub, put(o), put(s), put(r)) for ub, o, s, r in children],
        front=kernels.build_front_maps(batch, m, pool_len,
                                       a=(a_slot, a_flat, a_src),
                                       children=children, device=device))
    return maps, m, m - 2, pool_len, n_avals


@pytest.mark.parametrize("dtype", DTYPES)
def test_front_assemble_kernel_equals_plain(cuda, dtype):
    """Every group of a plan with fronts over several tiles, and the
    sentinel group: the kernel's front batch equals the plain one."""
    rng = np.random.default_rng(3)
    lu, bvals, _ = slt.analyze(slt.Options(), poisson3d(14), device=cuda)
    plan = lu.plan
    pool = _rand(rng, plan.pool_size, dtype, cuda)
    avals = _rand(rng, len(bvals), dtype, cuda)
    cases = [(gm, g.m, g.w, pool, avals)
             for g, gm in zip(plan.groups, factor.upload_maps(plan, cuda))]
    maps, m, w, pool_len, n_avals = _sentinel_group(rng, cuda)
    cases.append((maps, m, w, _rand(rng, pool_len, dtype, cuda),
                  _rand(rng, n_avals, dtype, cuda)))
    assert max(g.m for g in plan.groups) > 128
    kernels.reset_launches()
    for gm, m, w, pool, avals in cases:
        a = kernels.front_assemble_(avals, pool, m, w, gm)
        b = kernels.front_assemble_plain(avals, pool, m, w, gm)
        assert torch.equal(a, b)
    assert kernels.LAUNCHES["front_assemble"] == len(cases)


@pytest.mark.parametrize("dtype,make", [
    (torch.float32, lambda: poisson3d(10)),
    (torch.float32, lambda: random_sparse(300, 0.02, seed=4)),
    (torch.complex64, lambda: helmholtz_2d(20)),
    (torch.complex128, lambda: random_sparse(300, 0.02, seed=4,
                                             dtype=np.complex128)),
])
def test_factor_through_kernels_equals_plain(cuda, dtype, make):
    lu, bvals, _ = slt.analyze(slt.Options(), make(), device=cuda)
    fk = factor.numeric_factorize(lu.plan, bvals, lu.anorm, dtype=dtype,
                                  device=cuda)
    fp = factor.numeric_factorize(lu.plan, bvals, lu.anorm, dtype=dtype,
                                  device=cuda, scatter=factor.PLAIN)
    for (lk, uk), (lp, up) in zip(fk.fronts, fp.fronts):
        assert torch.equal(lk, lp) and torch.equal(uk, up)


def test_gssvx_on_the_card(cuda):
    a = poisson3d(12)
    b = a.matvec(np.random.default_rng(2).standard_normal(a.n_rows))
    kernels.reset_launches()
    x, lu, _, info = slt.gssvx(slt.Options(), a, b, device=cuda)
    assert info == 0 and lu.numeric.dtype == torch.float32
    assert lu.numeric.device.type == "cuda"
    assert kernels.LAUNCHES == {"front_assemble": len(lu.plan.groups),
                                "extend_add": 0, "assemble": 0,
                                "csr_spmv": 0}
    assert lu.berrs[-1] <= tols.berr_target(np.float64)


@pytest.mark.parametrize("dtype,m", [("float32", 112), ("complex128", 52),
                                     ("complex64", 82)])
def test_first_launch_of_a_process_under_a_full_tile(cuda, dtype, m):
    """A fresh process whose first launch has a tile that passes 48 KB
    only with the kernel's static shared memory, at the smallest such m
    (float32: 112 x 112 of a 128 x 128 tile, 49 KB; complex128: 52 x 52
    of a 64 x 64 tile; complex64: 64 x 82 of a 64 x 128 tile), must raise
    the kernel's shared-memory limit itself."""
    code = f"""
import numpy as np, torch
from superlu_dist_tpu_torch.numeric import kernels
m, dev, dt = {m}, torch.device("cuda"), torch.{dtype}
rel = np.arange(0, m, 3)[None, :]
maps = kernels.build_front_maps(2, m, 2000, a=([1], [5], [0]),
                                children=[(rel.shape[1], [0], [1], rel)],
                                device=dev)
gm = kernels.GroupMaps(
    ws=torch.tensor([0, 3], device=dev), off=torch.zeros(2, device=dev),
    a_slot=torch.tensor([1], device=dev), a_flat=torch.tensor([5], device=dev),
    a_src=torch.tensor([0], device=dev),
    children=[(rel.shape[1], torch.tensor([0], device=dev),
               torch.tensor([1], device=dev), torch.as_tensor(rel, device=dev))],
    front=maps)
pool = torch.randn(2000, device=dev, dtype=dt)
avals = torch.ones(1, device=dev, dtype=dt)
a = kernels.front_assemble_(avals, pool, m, 40, gm)
b = kernels.front_assemble_plain(avals, pool, m, 40, gm)
torch.cuda.synchronize()
assert torch.equal(a, b) and kernels.LAUNCHES["front_assemble"] == 1
"""
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)


@pytest.mark.parametrize("trans", ["TRANS", "CONJ"])
def test_transposed_solve_on_the_card_matches_the_cpu(cuda, trans):
    """The same complex64 factors, moved to the CPU, solve the transposed
    system to the device-vs-host gate (the card's sums run in another
    order)."""
    a = helmholtz_2d(24)
    rng = np.random.default_rng(5)
    b = rng.standard_normal((a.n_rows, 2)) + 1j * rng.standard_normal(
        (a.n_rows, 2))
    opts = slt.Options(trans=getattr(slt.Trans, trans), factor_dtype="float32",
                       iter_refine=slt.IterRefine.NOREFINE)
    x, lu, _, info = slt.gssvx(opts, a, b, device=cuda)
    assert info == 0 and lu.numeric.dtype == torch.complex64
    lu_cpu, _, _ = slt.analyze(slt.Options(
        fact=slt.Fact.SamePattern_SameRowPerm), a, device="cpu", lu=lu)
    lu_cpu.numeric = dataclasses.replace(
        lu.numeric, fronts=[(lp.cpu(), up.cpu()) for lp, up in
                            lu.numeric.fronts])
    conj = trans == "CONJ"
    x_cpu = lu_cpu.solve_factored_trans(b, conj=conj)
    np.testing.assert_allclose(lu.solve_factored_trans(b, conj=conj), x_cpu,
                               rtol=tols.tol("float32", 2 ** 10),
                               atol=tols.tol("float32", 2 ** 4))
    x, _, stats, _ = slt.gssvx(slt.Options(trans=getattr(slt.Trans, trans),
                                           fact=slt.Fact.FACTORED),
                               a, b, lu=lu)
    assert stats.solve_report.berr <= tols.berr_target(np.float64)


def test_refactor_on_the_card(cuda):
    a = poisson3d(12)
    b = np.ones(a.n_rows)
    _, lu, _, _ = slt.gssvx(slt.Options(), a, b, device=cuda)
    u = np.random.default_rng(0).uniform(-1.0, 1.0, a.nnz)
    vals = a.data * (1.0 + 0.05 * u)
    kernels.reset_launches()
    st = slt.refactor(lu, vals)
    assert kernels.LAUNCHES["front_assemble"] == len(lu.plan.groups)
    assert st.utime["SYMBFACT"] == st.utime["COLPERM"] == 0.0
    lu2, bvals, _ = slt.analyze(slt.Options(
        fact=slt.Fact.SamePattern_SameRowPerm), type(a)(
            a.n_rows, a.n_cols, a.indptr, a.indices, vals), device=cuda,
        lu=lu)
    fresh = factor.numeric_factorize(lu.plan, bvals, lu2.anorm,
                                     dtype=lu.numeric.dtype, device=cuda)
    for (lk, uk), (lp, up) in zip(lu.numeric.fronts, fresh.fronts):
        assert torch.equal(lk, lp) and torch.equal(uk, up)


# ---------------------------------------------------------------------------
# the residual SpMV kernel, the fused (CUDA graph) solve, the GEMM tiers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_csr_spmv_kernel_equals_plain(cuda, dtype):
    """Bit for bit, on a random matrix with empty rows (first and last)
    and a row of length 1, for one and for five columns."""
    from superlu_dist_tpu_torch.parallel import dist
    rng = np.random.default_rng(11)
    n = 300
    counts = rng.integers(0, 9, n)
    counts[0] = counts[-1] = 0
    counts[7] = 1
    indptr = np.concatenate([[0], np.cumsum(counts)])
    indices = rng.integers(0, n, indptr[-1])
    ip, ix = (torch.as_tensor(x, device=cuda) for x in (indptr, indices))
    vals = _rand(rng, indptr[-1], dtype, cuda)
    kernels.reset_launches()
    for k in (1, 5):
        x = _rand(rng, (n, k), dtype, cuda)
        y = dist.csr_spmv(ip, ix, vals, x)
        assert torch.equal(y, dist.csr_spmv_plain(ip, ix, vals, x))
        assert not y[0].any() and not y[-1].any()
        if not dtype.is_complex:    # one rounded product, as the kernel's
            assert torch.equal(y[7], vals[indptr[7]] * x[indices[indptr[7]]])
    assert kernels.LAUNCHES["csr_spmv"] == 2


def _helmholtz3d(a, k=5.0):
    nx = a.grid_shape[0]
    vals = a.data.astype(np.complex128)
    diag = a.indices == np.repeat(np.arange(a.n_rows), np.diff(a.indptr))
    vals[diag] -= (k * k - 0.5j * k) / (nx + 1) ** 2
    return slt.SparseCSR(a.n_rows, a.n_cols, a.indptr, a.indices, vals)


@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("nrhs", [1, 16])
def test_fused_and_eager_sweeps_agree(cuda, nrhs, conj):
    """poisson3d(16) (complex values for CONJ): the CUDA-graph sweeps and
    the eager ones agree to the device-vs-host gate (lsum's atomics make
    neither bitwise reproducible), in both directions, and a second
    replay agrees with the first."""
    from superlu_dist_tpu_torch.solve.device import DeviceSolver
    a = poisson3d(16)
    if conj:
        a = _helmholtz3d(a)
    lu, bvals, _ = slt.analyze(slt.Options(), a, device=cuda)
    num = factor.numeric_factorize(lu.plan, bvals, lu.anorm,
                                   dtype=torch.complex128 if conj
                                   else torch.float64, device=cuda)
    rng = np.random.default_rng(3)
    d = rng.standard_normal((lu.n, nrhs))
    if conj:
        d = d + 1j * rng.standard_normal(d.shape)
    fused = DeviceSolver(num, fused=True)
    eager = DeviceSolver(num, fused=False)
    assert fused.fused and not eager.fused
    tol = dict(rtol=tols.DEVICE_VS_HOST_RTOL, atol=tols.DEVICE_VS_HOST_ATOL)
    for solve in ((lambda s: s.solve(d)),
                  (lambda s: s.solve_trans(d, conj=conj))):
        want = solve(eager)
        np.testing.assert_allclose(solve(fused), want, **tol)
        np.testing.assert_allclose(solve(fused), want, **tol)   # replay
    assert fused.memory_stats()["graphs"] == 4
    assert fused.last_solve_stats["fused"]


def test_gemm_default_tier_is_tf32_and_restores_the_switch(cuda):
    from superlu_dist_tpu_torch.ops import dense
    m = torch.backends.cuda.matmul
    attr = "fp32_precision" if hasattr(m, "fp32_precision") else "allow_tf32"
    before = getattr(m, attr)
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((4, 256, 256), generator=g, device=cuda)
    b = torch.randn((4, 256, 256), generator=g, device=cuda)
    top = dense.gemm(a, b, "highest")
    assert torch.equal(dense.gemm(a, b, "f32"), top)
    assert getattr(m, attr) == before
    low = dense.gemm(a, b, "default")
    assert getattr(m, attr) == before
    assert not torch.equal(low, top)
    # TF32 keeps 10 mantissa bits of each input: ~1e-3 relative per product
    assert torch.allclose(low, top, rtol=1e-2, atol=0.05)
    bf = dense.gemm(a, b, "bf16")
    assert bf.dtype == torch.float32 and not torch.equal(bf, low)
    ab, bb = (t.to(torch.bfloat16).float() for t in (a, b))
    torch.testing.assert_close(bf, dense.gemm(ab, bb, "highest"),
                               rtol=1e-5, atol=1e-4)


def test_gssvx_refines_through_the_device_spmv(cuda):
    """poisson3d(25): nnz >= 100,000, so the residual runs through
    csr_spmv; the operator is cached on the handle and reused by a
    FACTORED solve on the same matrix data."""
    a = poisson3d(25)
    assert a.nnz >= 100_000
    b = a.matvec(np.random.default_rng(4).standard_normal(a.n_rows))
    kernels.reset_launches()
    x, lu, stats, info = slt.gssvx(slt.Options(), a, b, device=cuda)
    assert info == 0 and stats.solve_report.berr <= tols.berr_target(
        np.float64)
    assert kernels.LAUNCHES["csr_spmv"] == 2 * stats.refine_steps
    (op,) = [v[1] for v in lu.dev_spmv.values()]
    assert lu.dev_solver.fused and lu.dev_solver.splan.schedule == "dataflow"
    slt.gssvx(slt.Options(fact=slt.Fact.FACTORED), a, b, lu=lu)
    assert [v[1] for v in lu.dev_spmv.values()] == [op]
